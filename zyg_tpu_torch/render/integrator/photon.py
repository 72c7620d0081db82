"""Photon mapping: the bake, the hashed grid and the gather (counterpart of
zyg_tpu/render/integrator/photon.py).

- `bake`: one light path per lane from sample_light_from
  (render/integrator/lighttracer.py), a host loop of bounces over the
  scene's intersection (the isect kernel, and the BVH walk on mesh
  scenes), the fragment, the material gather, the enclosing medium's
  Beer absorption, russian roulette and the BSDF sample, depositing up to
  max_bounces photons a lane into [N, B] slots at vertices that can
  evaluate a BSDF reached through a specular chain (every such vertex
  with full_light_path), as the JAX wavefront does.
- `build_map`: the photons' cells (edge 2r) hashed into 2^18 buckets
  (ops/photon.py::cell_hash), a stable sort by bucket with the invalid
  photons last, the buckets' ranges by one searchsorted, the invalid
  photons' power zeroed.
- `gather`: the density estimate at shading points, through the
  photon_gather kernel (ops/photon.py).

The Sobol' draws keep the JAX order: the light's selection and side (2-D),
its emission sample (4-D), then per bounce the roulette's 1-D and the
BSDF's 3-D draw, each bounce after a padding step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import vecmath as vm
from ...core.sobol import SobolSampler
from ...ops.isect import prop_table
from ...ops.photon import MAX_PER_CELL, TABLE_BITS, TABLE_SIZE, photon_gather
from ...ops.photon import cell_hash as _cell_hash
from ...scene import light_sampling as ls
from ...scene import shapes
from ...scene.types import RAY_MAX_T
from .. import materials as M
from . import volume as vol_mod
from .lighttracer import _offset_rows, _side, sample_light_from

__all__ = ["TABLE_BITS", "TABLE_SIZE", "MAX_PER_CELL", "PhotonMap", "bake", "build_map",
           "gather", "_cell_hash"]


@dataclass
class PhotonMap:
    """The photons sorted by bucket, the buckets' ranges and the gather's
    scan bound."""

    p: torch.Tensor  # [M, 3]
    wi: torch.Tensor  # [M, 3] toward the light (incoming)
    alpha: torch.Tensor  # [M, 3] power, 0 on invalid photons
    cell_start: torch.Tensor  # int32[TABLE_SIZE + 1]
    radius: float
    num_paths: int
    inv_cell: float  # 1 / (2 radius)
    # photons scanned a bucket (capped at MAX_PER_CELL): the fullest
    # bucket's next power of two, as the JAX Driver sets it
    max_per_cell: int = MAX_PER_CELL


def bake(scene, ray_keys: torch.Tensor, settings, max_depth: int = 8):
    """Trace one photon path per lane of ray_keys (int64[N], u32 values):
    (p, wi, alpha [N*B, 3], valid bool[N*B]), with the take's settings
    (io/take.py::PhotonSettings; B = settings.max_bounces).
    Each bounce runs on the lanes still alive, compacted (a dead lane
    changes nothing in the JAX loop; ~12 % of the caustics take's paths
    outlive their first hit)."""
    n = ray_keys.shape[0]
    nb = settings.max_bounces
    dev = ray_keys.device
    smp = SobolSampler.start_pixel(ray_keys, torch.zeros_like(ray_keys))
    s2 = smp.sample_2d()
    light_idx, sel_pdf = ls.select_light(scene, s2[:, 0])
    xi4 = smp.sample_4d()
    smp.increment_padding()
    p0, n0, d0, weight, finite = sample_light_from(scene, light_idx, xi4, u_side=s2[:, 1])
    throughput = weight / torch.clamp(sel_pdf, min=1e-12)[:, None]

    refl = prop_table(scene, "reflection")
    ph = torch.zeros((3, n, nb, 3), dtype=torch.float32, device=dev)  # p, wi, alpha
    n_dep_all = torch.zeros(n, dtype=torch.int32, device=dev)
    feats = set(scene.mat_features)
    # the live lanes' state, compacted; lane: their index in the batch
    lane = torch.nonzero(finite).squeeze(1)
    o, d, throughput = _offset_rows(p0, n0)[lane], d0[lane], throughput[lane]
    smp = SobolSampler(smp.arrays.index(lane), smp.dim)
    medium = torch.full(lane.shape, -1, dtype=torch.int32, device=dev)
    specular_chain = torch.zeros(lane.shape, dtype=torch.bool, device=dev)
    n_dep = torch.zeros(lane.shape, dtype=torch.int32, device=dev)
    depth = 0
    while lane.shape[0] > 0:
        hit = shapes.intersect_scene(scene, refl, o, d, 0.0, RAY_MAX_T)
        frag = shapes.build_fragment(scene, hit, o, d)
        med_mat = vol_mod.medium_material(scene, medium)
        medium_ior = torch.where(medium >= 0,
                                 scene.materials.ior[torch.clamp(med_mat, min=0).long()], 1.0)
        params = M.gather(scene.materials, frag.material, medium_ior=medium_ior, features=feats)
        wo = -d
        throughput = throughput * M.medium_absorption(scene.materials, med_mat, hit.t)
        cont = hit.valid() & (hit.t < RAY_MAX_T) & (depth < max_depth)

        # ---- deposit (ref tracePhoton: canEvaluate after a specular chain)
        deposit = cont & M.can_evaluate(params) & (n_dep < nb)
        if not settings.full_light_path:
            deposit = deposit & specular_chain
        slot = torch.clamp(n_dep, max=nb - 1).long()
        dep = deposit[:, None]
        for k, v in enumerate((frag.p, wo, throughput)):
            ph[k, lane, slot] = torch.where(dep, v, ph[k, lane, slot])
        n_dep = n_dep + deposit.to(torch.int32)
        n_dep_all[lane] = n_dep

        # ---- bounce
        throughput, kill = M.russian_roulette(throughput, smp.sample_1d())
        cont = cont & ~kill & (n_dep < nb)
        bs = M.sample_bsdf(params, wo, frag.n, frag.geo_n, smp.sample_3d())
        cont = cont & bs.valid
        throughput = throughput * bs.weight
        entering = vm.dot(wo, frag.geo_n) > 0.0
        medium = torch.where(bs.transmission & cont,
                             torch.where(entering, hit.prop, -1).to(torch.int32), medium)
        o = _offset_rows(frag.p, _side(bs.wi, frag.geo_n))
        d = bs.wi
        smp.increment_padding()
        depth += 1
        specular_chain = specular_chain | (cont & bs.singular & ~bs.passthrough)
        keep = torch.nonzero(cont).squeeze(1)
        lane, o, d, throughput = lane[keep], o[keep], d[keep], throughput[keep]
        medium, specular_chain, n_dep = medium[keep], specular_chain[keep], n_dep[keep]
        smp = SobolSampler(smp.arrays.index(keep), smp.dim)
    valid = torch.arange(nb, device=dev)[None, :] < n_dep_all[:, None]
    return (ph[0].reshape(n * nb, 3), ph[1].reshape(n * nb, 3), ph[2].reshape(n * nb, 3),
            valid.reshape(n * nb))


def build_map(p, wi, alpha, valid, search_radius: float, num_paths: int) -> PhotonMap:
    """Sort the photons into the hashed grid, and set the scan bound from
    the fullest bucket (one host read)."""
    inv_cell = 1.0 / (2.0 * search_radius)
    ip = torch.floor(p * inv_cell).to(torch.int32)
    cell = _cell_hash(ip[:, 0], ip[:, 1], ip[:, 2])
    cell = torch.where(valid, cell, TABLE_SIZE)  # invalid photons sort last
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order].contiguous()
    buckets = torch.arange(TABLE_SIZE + 1, dtype=torch.int32, device=p.device)
    starts = torch.searchsorted(cell_sorted, buckets).to(torch.int32)
    fullest = int(torch.diff(starts).max())
    return PhotonMap(
        p=p[order].contiguous(),
        wi=wi[order].contiguous(),
        alpha=torch.where(valid[order][:, None], alpha[order], 0.0).contiguous(),
        cell_start=starts,
        radius=float(search_radius),
        num_paths=int(num_paths),
        inv_cell=float(inv_cell),
        max_per_cell=1 << max(fullest - 1, 0).bit_length(),
    )


def gather(pmap: PhotonMap, params, pos, wo, ns, geo_n, active):
    """[N, 3] photon radiance at the shading points (ref photon_grid.zig
    li, one-sided): the photon_gather kernel or its plain version."""
    return photon_gather(pmap.p, pmap.wi, pmap.alpha, pmap.cell_start, params, pos, wo, ns, geo_n,
                         active, pmap.radius, pmap.num_paths, pmap.max_per_cell)

