"""The lighttracer: light emission sampling and the particle pass
(counterpart of zyg_tpu/render/integrator/lighttracer.py).

`sample_light_from` (JAX :37-216) starts a light path. A finite light
emits from a uniform point of its surface in a cosine distribution about
its normal: a Rectangle (two-sided ones pick a side by u_side and double
the weight, as the power CDF doubles their area; a portal's weight is
modulated by its linked dome's map in the emitted direction), a Sphere
(never two-sided: a point on the sphere, its outward normal), a Disk,
or an emissive mesh (a triangle by the light's area CDF, as NEE picks it
without the primitive tree, then a uniform point on it from the CDF
draw's fraction times 64 and the second uniform, JAX :88-125).
The weight is Le times the emitting area times pi (the cosine cancels
against the direction's pdf), times the IES profile at the emitted
angle from the unflipped normal where the material has one. The infinite
lights emit from the world bounding sphere (scene.world_center,
scene.world_radius): a Distant light along its axis from the disk
upstream of the scene, weight Le times its cone's solid angle times pi
R^2; a Dome or Canopy (uniform or mapped) inward from a disk about a
uniform direction, weight its radiance in that direction
(light_sampling.light_radiance) times 4 pi^2 R^2. Volume lights raise
UnsupportedScene naming them (`check_emitters`).

`trace` (JAX :218-341) is the particle pass: one light path per lane,
each vertex connected to the camera (render/camera.py::camera_sample_to)
through a shadow ray and splatted into the [W*H] image by the lt_splat
kernel (ops/lt_splat.py), then russian roulette and a BSDF sample. Its
loop is a host loop over the live lanes, compacted (a dead lane changes
nothing in the JAX loop), as the photon bake's (photon.py::bake). The
Sobol' draws keep the JAX order: the light's selection and side (2-D),
its emission sample (4-D), then per bounce the roulette's 1-D and the
BSDF's 3-D draw, each bounce after a padding step.

Arithmetic follows the jitted JAX functions on the CPU: a single-use
product feeding an add is one fused multiply-add (core/fmath.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ...core import vecmath as vm
from ...core.fmath import fma, sqrt
from ...core.sobol import SobolSampler
from ...ops.isect import prop_table
from ...ops.lt_splat import lt_splat
from ...ops.shade import _offset_ray
from ...scene import light_sampling as ls
from ...scene import portal as portal_mod
from ...scene import shapes
from ...scene.textures import sample_bilinear
from ...scene.types import RAY_MAX_T, ShapeType, UnsupportedScene
from .. import materials as M
from ..camera import camera_sample_to
from . import volume as vol_mod

_RECT = int(ShapeType.RECTANGLE)
_SPHERE = int(ShapeType.SPHERE)
_DISK = int(ShapeType.DISK)
_DIST = int(ShapeType.DISTANT)
_DOME = int(ShapeType.DOME)
_CANOPY = int(ShapeType.CANOPY)
_MESH = int(ShapeType.TRIANGLE_MESH)
_EMITTERS = {_RECT, _SPHERE, _DISK, _DIST, _DOME, _CANOPY, _MESH, ls.PORTAL}


@dataclass(frozen=True)
class LighttracerSettings:
    """The particle pass's settings (zyg_tpu/render/integrator/
    lighttracer.py:33-35): the bounce cap, and whether every vertex
    splats (False: only vertices reached through a specular chain, the
    caustics the forward pass leaves out)."""

    max_depth: int = 8
    full_light_path: bool = True


def check_emitters(scene) -> None:
    """Raise UnsupportedScene naming a light that sample_light_from does
    not sample."""
    present = ls.light_shapes(scene) if scene.lights.count else set()
    extra = present - _EMITTERS
    if extra:
        names = sorted(str(s) if isinstance(s, str) else ShapeType(s).name.capitalize()
                       for s in extra)
        raise UnsupportedScene(f"light paths from {names} lights (sample_light_from)")


def check_lighttracer(scene) -> None:
    """Raise UnsupportedScene naming what the particle pass does not
    trace: the lights of check_emitters, and rough glass, whose BSDF the
    camera splat's kernel does not evaluate (ops/lt_splat.py)."""
    check_emitters(scene)
    if "rough_glass" in scene.mat_features:
        raise UnsupportedScene("light paths through rough glass (the camera splat evaluates "
                               "the substitute BSDF only)")


def sample_light_from(scene, light_idx, xi4, u_side=None):
    """Emission samples of the lights light_idx (int32[N]) from the
    uniforms xi4 [N, 4] (and u_side [N], the side of a two-sided emitter):
    (p [N, 3], n [N, 3], d [N, 3], weight [N, 3], finite bool[N]); finite
    is False on lanes whose light emits nothing this way."""
    check_emitters(scene)
    feats = scene.mat_features
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
    is_mesh = shape == _MESH
    finite = (shape == _RECT) | is_sphere | is_disk | is_mesh
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
    if _MESH in present:
        u_tri = xi4[:, 0]
        tri, mesh_area, _ = ls.pick_triangle(scene, light_idx, u_tri)
        row = scene.meshes.attr_rows[tri]
        p0 = vm.object_to_world_point(rot, scale, pos, row[:, 0:3])
        e1 = vm.object_to_world_vector(rot, scale, row[:, 3:6])
        e2 = vm.object_to_world_vector(rot, scale, row[:, 6:9])
        # a fresh 2-D point: the CDF pick spent xi4[0], so its fraction x 64
        bc = vm.sample_triangle_uniform(
            torch.stack([torch.remainder(u_tri * 64.0, 1.0), xi4[:, 1]], dim=-1))
        mm = is_mesh[:, None]
        p = torch.where(mm, fma(bc[:, 1:2], e2, fma(bc[:, 0:1], e1, p0)), p)
        geo_n = torch.where(mm, vm.safe_normalize(vm.cross(e1, e2)), geo_n)
        area = torch.where(is_mesh, mesh_area, area)

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
    if "ies" in feats:
        # the forward path's eval_ies at the UNflipped geometric normal
        weight = weight * M.eval_ies(scene.materials.ies[m], vm.dot(d, geo_n))[:, None]
    weight = torch.where(finite[:, None], weight, 0.0)

    if ls.PORTAL in present and scene.textures is not None:
        # a portal emits its dome's map through the rectangle: the uniform
        # emission modulated by the map in the outward direction
        et = scene.materials.emission_tex[m]
        for (l_const, _), pd in sorted(scene.portals.items()):
            uvp = portal_mod.dome_uv_of_dir(pd.dome_rot, -d)
            tex = sample_bilinear(scene.textures, torch.clamp(et, min=0), uvp)[:, :3]
            weight = torch.where(((light_idx == l_const) & (et >= 0))[:, None], weight * tex,
                                 weight)

    infinite = present & {_DIST, _DOME, _CANOPY}
    if infinite:
        # the infinite lights emit from the world bounding sphere
        wc = torch.tensor(scene.world_center, dtype=torch.float32, device=pos.device)
        wr = float(np.float32(scene.world_radius))  # a float32 scene constant, as in JAX
        dxy2 = vm.sample_disk_concentric(xi4[:, 2:4])
    if _DIST in infinite:
        # the light travels along its axis r2, from the disk upstream of
        # the scene; Le over the sun's cone: the flux through the disk is
        # Le * Omega * pi R^2
        is_dist = shape == _DIST
        dt, db = vm.orthonormal_basis(r2)
        dist_p = fma(wr, dxy2[:, 0:1] * dt + dxy2[:, 1:2] * db, fma(-wr, r2, wc))
        omega = (2.0 * math.pi) * (1.0 - sqrt(torch.ones_like(s0) / fma(s0, s0, 1.0)))
        dist_w = radiance * (((omega * math.pi) * wr) * wr)[:, None]
        dm = is_dist[:, None]
        p = torch.where(dm, dist_p, p)
        d = torch.where(dm, r2, d)
        n = torch.where(dm, r2, n)
        weight = torch.where(dm, dist_w, weight)
        finite = finite | is_dist
    if infinite & {_DOME, _CANOPY}:
        # a dome or canopy: inward from a disk about a uniform direction,
        # weighted by its radiance in that direction (emission maps apply)
        is_env = (shape == _DOME) | (shape == _CANOPY)
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


def _offset_rows(p, n):
    return torch.stack(_offset_ray(p.unbind(1), n.unbind(1)), dim=-1)


def _side(v, geo_n):
    """geo_n flipped to v's side (the JAX `dot(v, geo_n) >= 0` rule)."""
    return torch.where((vm.dot(v, geo_n) >= 0.0)[:, None], geo_n, -geo_n)


def trace(scene, cam_arrays, resolution, ray_keys: torch.Tensor,
          settings: LighttracerSettings = LighttracerSettings()):
    """Trace one light path per lane of ray_keys (int64[N], u32 Sobol'
    sample indices) and splat its camera connections: (splat [W*H, 3],
    rays: the live lanes of every bounce plus the connections, an int64
    tensor). The loop runs on the live lanes, compacted; at the depth cap
    the JAX loop's last trip counts the live lanes and ends them."""
    check_lighttracer(scene)
    w, h = resolution
    dev = ray_keys.device
    smp = SobolSampler.start_pixel(ray_keys, torch.zeros_like(ray_keys))
    s2 = smp.sample_2d()
    light_idx, sel_pdf = ls.select_light(scene, s2[:, 0])
    xi4 = smp.sample_4d()
    smp.increment_padding()
    p0, n0, d0, weight, finite = sample_light_from(scene, light_idx, xi4, u_side=s2[:, 1])
    throughput = weight / torch.clamp(sel_pdf, min=1e-12)[:, None]

    refl, shadow = prop_table(scene, "reflection"), prop_table(scene, "shadow")
    feats = set(scene.mat_features)
    splat = torch.zeros((w * h, 4), dtype=torch.float32, device=dev)
    connections = torch.zeros(1, dtype=torch.int64, device=dev)
    live_rays = 0
    # the live lanes' state, compacted
    lane = torch.nonzero(finite).squeeze(1)
    o, d, throughput = _offset_rows(p0, n0)[lane], d0[lane], throughput[lane]
    smp = SobolSampler(smp.arrays.index(lane), smp.dim)
    medium = torch.full(lane.shape, -1, dtype=torch.int32, device=dev)
    specular_chain = torch.zeros(lane.shape, dtype=torch.bool, device=dev)
    depth = 0
    while lane.shape[0] > 0:
        live_rays += lane.shape[0]
        if depth >= settings.max_depth:
            break
        hit = shapes.intersect_scene(scene, refl, o, d, 0.0, RAY_MAX_T)
        frag = shapes.build_fragment(scene, hit, o, d)
        med_mat = vol_mod.medium_material(scene, medium)
        medium_ior = torch.where(medium >= 0,
                                 scene.materials.ior[torch.clamp(med_mat, min=0).long()], 1.0)
        params = M.gather(scene.materials, frag.material, scene.textures, frag.uv,
                          medium_ior=medium_ior, features=feats)
        wo = -d
        throughput = throughput * M.medium_absorption(scene.materials, med_mat, hit.t)
        cont = hit.valid() & (hit.t < RAY_MAX_T)

        # ---- connect to the camera (ref directCamera)
        pix, dir_cam, t_cam, cam_pdf, cam_ok = camera_sample_to(cam_arrays, resolution, frag.p)
        vis_cam = scene.prop_visible_camera[torch.clamp(hit.prop, min=0).long()]
        connect = cont & cam_ok & vis_cam & (cam_pdf > 0.0)
        if not settings.full_light_path:
            connect = connect & specular_chain
        blocked = shapes.occluded(scene, shadow, _offset_rows(frag.p, _side(dir_cam, frag.geo_n)),
                                  dir_cam, 0.0, t_cam * 0.999)
        ids = (torch.clamp(pix[:, 1], 0, h - 1) * w + torch.clamp(pix[:, 0], 0, w - 1)).long()
        lt_splat(params, wo, dir_cam, frag.n, frag.geo_n, throughput, cam_pdf, ids, connect,
                 blocked, splat, connections)

        # ---- russian roulette + bounce
        throughput, kill = M.russian_roulette(throughput, smp.sample_1d())
        cont = cont & ~kill
        bs = M.sample_bsdf(params, wo, frag.n, frag.geo_n, smp.sample_3d())
        cont = cont & bs.valid
        throughput = throughput * bs.weight
        entering = vm.dot(wo, frag.geo_n) > 0.0
        medium = torch.where(bs.transmission & cont,
                             torch.where(entering, frag.prop, -1).to(torch.int32), medium)
        o = _offset_rows(frag.p, _side(bs.wi, frag.geo_n))
        d = bs.wi
        smp.increment_padding()
        depth += 1
        specular_chain = specular_chain | (cont & bs.singular)
        keep = torch.nonzero(cont).squeeze(1)
        lane, o, d, throughput = lane[keep], o[keep], d[keep], throughput[keep]
        medium, specular_chain = medium[keep], specular_chain[keep]
        smp = SobolSampler(smp.arrays.index(keep), smp.dim)
    return splat[:, :3], connections[0] + live_rays
