"""Wavefront PT: the naive BSDF-sampling path tracer, no NEE and no MIS
(counterpart of zyg_tpu/render/integrator/pt.py; ref
src/core/rendering/integrator/surface/pathtracer.zig).

A whole batch of camera rays bounces together with masked (alive) lanes.
The medium is one entry a lane, the prop whose interior the ray is in
(-1: air), with Beer-Lambert absorption through it on every segment. The
JAX `lax.while_loop` becomes a host loop of bounces; its condition,
any(alive) and depth <= max_depth, is read on the host every
`_check_every` bounces (every bounce on the CPU): a bounce after the last
lane died adds nothing.

The Sobol' draws keep the JAX order: the roulette's r, then the 3-D BSDF
sample, then padding. Kernels on this path: isect (closest hit),
traverse (mesh scenes) and sobol_block (every draw).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import vecmath as vm
from ...core.sobol import SobolSampler
from ...ops.isect import prop_table
from ...scene import shapes
from ...scene.types import RAY_MAX_T
from .. import materials as M
from . import volume as vol_mod
from .ptmis import _check_every
from .ptmis_general import _offset_rows, _side


@dataclass(frozen=True)
class PtSettings:
    max_depth: int = 16


def integrate(scene, o, d, sobol: SobolSampler, settings: PtSettings):
    """Trace a batch of rays to completion. Returns (radiance [N, 3], the
    sampler, rays traced (int64 scalar tensor), bounces run)."""
    n, dev = o.shape[0], o.device
    refl = prop_table(scene, "reflection")
    mats = scene.materials
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    medium = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    arrays = sobol.arrays
    check_every = _check_every(dev)
    depth = 0
    while depth <= settings.max_depth:
        if depth % check_every == 0 and not bool(alive.any()):
            break
        smp = SobolSampler(arrays, dim=5)
        primary = torch.full((n,), depth == 0, dtype=torch.bool, device=dev)
        # dead lanes get tmax 0: they fall out of the walks at once
        hit = shapes.intersect_scene(scene, refl, o, d, 0.0,
                                     torch.where(alive, RAY_MAX_T, 0.0), primary=primary)
        frag = shapes.build_fragment(scene, hit, o, d)
        valid = hit.valid()
        med_mat = vol_mod.medium_material(scene, medium)
        medium_ior = torch.where(medium >= 0, mats.ior[torch.clamp(med_mat, min=0).long()], 1.0)
        params = M.gather(mats, frag.material, scene.textures, frag.uv, medium_ior=medium_ior,
                          features=scene.mat_features)
        wo = -d

        # Beer-Lambert absorption through the current medium
        throughput = throughput * M.medium_absorption(mats, med_mat, hit.t)
        emission = torch.where(valid[:, None], M.eval_radiance(params, wo, frag.geo_n), 0.0)
        radiance = radiance + torch.where(alive[:, None], throughput * emission, 0.0)

        cont = alive & valid & (hit.t < RAY_MAX_T) & (depth < settings.max_depth)
        # russian roulette (ref pathtracer.zig:58 -> helper.zig)
        throughput, kill = M.russian_roulette(throughput, smp.sample_1d())
        cont = cont & ~kill
        bs = M.sample_bsdf(params, wo, frag.n, frag.geo_n, smp.sample_3d())
        cont = cont & bs.valid
        throughput = throughput * bs.weight
        # the medium changes where a transmission crosses the surface
        # (ref vertex.zig interfaceChange)
        entering = vm.dot(wo, frag.geo_n) > 0.0
        medium = torch.where(bs.transmission & cont,
                             torch.where(entering, frag.prop, -1).to(torch.int32), medium)
        new_o = _offset_rows(frag.p, _side(bs.wi, frag.geo_n))
        smp.increment_padding()

        o = torch.where(cont[:, None], new_o, o)
        d = torch.where(cont[:, None], bs.wi, d)
        rays = rays + alive.sum(dtype=torch.int64)
        alive = cont
        arrays = smp.arrays
        depth += 1
    return radiance, SobolSampler(arrays, dim=5), rays, depth
