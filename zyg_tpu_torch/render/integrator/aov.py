"""AOV (debug and analysis) surface integrator (counterpart of
zyg_tpu/render/integrator/aov.py; ref
src/core/rendering/integrator/surface/aov.zig): one camera hit a sample
and one value of it, as RGB.

Values: AO (ambient occlusion over num_samples cosine rays of length
radius), Tangent, Bitangent, GeometricNormal and ShadingNormal (mapped
to 0.5 * (v + 1)), Side (front or back face), Depth (the hit distance)
and LightSampleCount on its no-split branch (one light sample a vertex:
the port samples one light a vertex, and the Driver refuses NEE
splitting). Photon is refused at the take: the photon map is not ported.
Lanes that miss give 0. Kernels on this path: isect (closest and any
hit), traverse (mesh scenes) and sobol_block (the AO and selection draws).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core import vecmath as vm
from ...core.sobol import SobolSampler
from ...ops.isect import prop_table
from ...scene import shapes
from ...scene.types import RAY_MAX_T
from .ptmis_general import _offset_rows

VALUES = ("AO", "Tangent", "Bitangent", "GeometricNormal", "ShadingNormal", "Side", "Depth",
          "LightSampleCount")


@dataclass(frozen=True)
class AovSettings:
    value: str = "AO"
    num_samples: int = 1
    radius: float = 1.0


def integrate(scene, o, d, sobol: SobolSampler, settings: AovSettings):
    """Returns (value [N, 3], the sampler, rays traced (int64 scalar tensor))."""
    v = settings.value
    if v not in VALUES:
        raise ValueError(f"AOV value {v!r} (the port renders {', '.join(VALUES)})")
    n, dev = o.shape[0], o.device
    hit = shapes.intersect_scene(scene, prop_table(scene, "camera"), o, d, 0.0, RAY_MAX_T)
    frag = shapes.build_fragment(scene, hit, o, d, need_uv=True, need_tangents=True)
    valid = hit.valid() & (hit.t < RAY_MAX_T)
    rays = torch.tensor(n, dtype=torch.int64, device=dev)

    if v in ("Tangent", "Bitangent", "GeometricNormal", "ShadingNormal"):
        vec = {"Tangent": frag.t, "Bitangent": frag.b, "GeometricNormal": frag.geo_n,
               "ShadingNormal": frag.n}[v]
        out = 0.5 * (vec + 1.0)
    elif v == "Side":
        front = (vm.dot(-d, frag.geo_n) > 0.0)[:, None]
        out = torch.where(front, torch.tensor([0.2, 1.0, 0.1], device=dev),
                          torch.tensor([1.0, 0.1, 0.2], device=dev))
    elif v == "Depth":
        out = hit.t[:, None].expand(n, 3)
    elif v == "LightSampleCount":
        # ref aov.zig lightSampleCount: the samples drawn over the most the
        # selection could draw; without splitting one of one
        sobol.sample_1d()
        out = torch.ones((n, 3), dtype=torch.float32, device=dev)
    else:  # AO
        ns = torch.where((vm.dot(-d, frag.geo_n) > 0.0)[:, None], frag.geo_n, -frag.geo_n)
        t, b = vm.orthonormal_basis(ns)
        origin = _offset_rows(frag.p, ns)
        shadow = prop_table(scene, "shadow")
        # lanes that missed test no occluder: their value is 0 anyway
        tmax = torch.where(valid, settings.radius, 0.0)
        occ = torch.zeros((n,), dtype=torch.float32, device=dev)
        k = max(settings.num_samples, 1)
        for _ in range(k):
            wi = vm.frame_to_world(t, b, ns, vm.sample_hemisphere_cosine(sobol.sample_2d()))
            occ = occ + shapes.occluded(scene, shadow, origin, wi, 0.0, tmax).to(torch.float32)
            rays = rays + n
        out = (1.0 - occ / k)[:, None].expand(n, 3)

    return torch.where(valid[:, None], out, 0.0), sobol, rays
