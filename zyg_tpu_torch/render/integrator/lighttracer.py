"""Light emission sampling: the start of a light path (counterpart of
zyg_tpu/render/integrator/lighttracer.py:37-216, `sample_light_from`; the
lighttracer's particle pass itself is not ported).

A finite light emits from a uniform point of its surface in a cosine
distribution about its normal: a Rectangle (two-sided ones pick a side by
u_side and double the weight, as the power CDF doubles their area), a
Sphere (never two-sided: a point on the sphere, its outward normal) or a
Disk. A uniform Dome emits inward from a disk on the world bounding
sphere (scene.world_center, scene.world_radius). The weight is Le times
the emitting area times pi (the cosine cancels against the direction's
pdf), or the dome's Le times 4 pi^2 R^2.

The branches are those of the lights the general body renders, on which
a photon map always runs (render/integrator/ptmis.py::_make_body): every
other light shape (Distant, Canopy, env-mapped domes, portals, IES
profiles, emissive meshes) raises UnsupportedScene naming it.

Arithmetic follows the jitted JAX function on the CPU: a single-use
product feeding an add is one fused multiply-add (core/fmath.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import vecmath as vm
from ...core.fmath import fma
from ...scene import light_sampling as ls
from ...scene.types import ShapeType, UnsupportedScene

_RECT = int(ShapeType.RECTANGLE)
_SPHERE = int(ShapeType.SPHERE)
_DISK = int(ShapeType.DISK)
_DOME = int(ShapeType.DOME)
_EMITTERS = {_RECT, _SPHERE, _DISK, _DOME}


def check_emitters(scene) -> None:
    """Raise UnsupportedScene naming a light that sample_light_from does
    not sample."""
    present = ls.light_shapes(scene) if scene.lights.count else set()
    extra = present - _EMITTERS
    if extra:
        names = sorted(str(s) if isinstance(s, str) else ShapeType(s).name.capitalize()
                       for s in extra)
        raise UnsupportedScene(f"light paths from {names} lights (sample_light_from)")
    if scene.env is not None or "ies" in scene.mat_features:
        raise UnsupportedScene("light paths from env-mapped domes or IES profiles")


def sample_light_from(scene, light_idx, xi4, u_side=None):
    """Emission samples of the lights light_idx (int32[N]) from the
    uniforms xi4 [N, 4] (and u_side [N], the side of a two-sided emitter):
    (p [N, 3], n [N, 3], d [N, 3], weight [N, 3], finite bool[N]); finite
    is False on lanes whose light emits nothing this way."""
    check_emitters(scene)
    li = torch.clamp(light_idx, 0, scene.lights.count - 1).long()
    prop = scene.lights.prop[li].long()
    shape = scene.prop_shape[prop]
    rot, pos, scale = scene.prop_rot[prop], scene.prop_pos[prop], scene.prop_scale[prop]
    r0, r1, r2 = rot[:, 0], rot[:, 1], rot[:, 2]
    s0 = scale[:, 0]

    # rectangle: a uniform point
    u = xi4[:, 0] - 0.5
    v = xi4[:, 1] - 0.5
    p = fma((v * scale[:, 1])[:, None], r1, fma((u * s0)[:, None], r0, pos))
    geo_n = r2
    area = s0 * scale[:, 1]

    is_sphere = shape == _SPHERE
    is_disk = shape == _DISK
    finite = (shape == _RECT) | is_sphere | is_disk
    present = ls.light_shapes(scene)
    if _SPHERE in present:
        sp_dir, _ = vm.sample_sphere_uniform(xi4[:, 0:2])
        sp_r = 0.5 * s0
        sm = is_sphere[:, None]
        p = torch.where(sm, fma(sp_r[:, None], sp_dir, pos), p)
        geo_n = torch.where(sm, sp_dir, geo_n)
        area = torch.where(is_sphere, (4.0 * math.pi) * sp_r * sp_r, area)
    if _DISK in present:
        dxy = vm.sample_disk_concentric(xi4[:, 0:2])
        dk_r = 0.5 * s0
        dk_p = fma(dk_r[:, None], fma(dxy[:, 0:1], r0, dxy[:, 1:2] * r1), pos)
        p = torch.where(is_disk[:, None], dk_p, p)
        area = torch.where(is_disk, math.pi * dk_r * dk_r, area)

    m = scene.prop_material[prop].long()
    radiance = scene.materials.emission[m]
    two_sided = scene.materials.two_sided[m] & ~is_sphere
    flip = two_sided & (u_side < 0.5) if u_side is not None else torch.zeros_like(two_sided)
    n = torch.where(flip[:, None], -geo_n, geo_n)

    # a cosine-distributed direction about n: weight = Le * area * pi
    t, b = vm.orthonormal_basis(n)
    d = vm.frame_to_world(t, b, n, vm.sample_hemisphere_cosine(xi4[:, 2:4]))
    weight = radiance * (area * math.pi)[:, None]
    weight = torch.where(two_sided[:, None], 2.0 * weight, weight)
    weight = torch.where(finite[:, None], weight, 0.0)

    if _DOME in present:
        # a uniform dome: inward from a disk on the world bounding sphere
        is_env = shape == _DOME
        wc = torch.tensor(scene.world_center, dtype=torch.float32, device=pos.device)
        wr = float(np.float32(scene.world_radius))  # a float32 scene constant, as in JAX
        dxy2 = vm.sample_disk_concentric(xi4[:, 2:4])
        env_dir, _ = vm.sample_sphere_uniform(xi4[:, 0:2])
        et, eb = vm.orthonormal_basis(env_dir)
        env_p = fma(wr, dxy2[:, 0:1] * et + dxy2[:, 1:2] * eb, fma(wr, env_dir, wc))
        env_rad = ls.light_radiance(scene, light_idx, env_dir, -env_dir,
                                    torch.zeros_like(env_dir[:, :2]))
        env_w = env_rad * ((4.0 * math.pi * math.pi) * wr * wr)
        em = is_env[:, None]
        p = torch.where(em, env_p, p)
        d = torch.where(em, -env_dir, d)
        n = torch.where(em, d, n)
        weight = torch.where(em, env_w, weight)
        finite = finite | is_env
    return p, n, d, weight, finite
