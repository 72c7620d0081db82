"""Next-event estimation for rectangle, sphere, disk, canopy, dome,
distant, mesh, volume and portal lights: light selection, per-shape sampling,
emitted radiance and the hit-side pdfs for MIS (counterpart of
zyg_tpu/scene/light_sampling.py: 62-98 selection by the power CDF or the
light tree, :248-271 rectangle, :273-312 sphere, :314-334 disk, :336-352
distant, :353-358 canopy, :360-369 dome, :472-488 env map,
:490-541 volume, :543-566 portal, :580-636 light_radiance with the IES
profile, :660-692, :731-752 light_hit_pdf).

A scene with a light tree (two or more lights, one of them finite;
scene/light_tree.py) selects by the tree's descent at the shading point
and evaluates the matching pdf at the previous vertex; every other scene
selects by the power CDF. The loader refuses Cube lights, and the
Driver refuses scenes whose light tree would split NEE (the JAX
package's select_split / pdf_split, not ported).

An emissive mesh (:366-440, :694-730) picks a triangle by its area CDF
(a binary search in the light's slice), or, where the mesh has a
primitive light tree (scene/loader.py, 512 triangles or more), by the
tree's descent at the shading point; the tree's selection pdf folds into
an effective area, the triangle's over that pdf, on both sides of MIS.

Only the light shapes present in the scene are evaluated: `present` is the
set of their ShapeType codes, with "volume" for the volume lights and
"portal" for the portal lights, whose Rectangle is keyed apart
(`light_shapes`, read once per render, the JAX package's static
`scene.light_shapes`). Rectangles use the Urena spherical-rectangle
helpers of ops/shade.py; a sphere samples the cone it subtends, a disk a
concentric point on its face (pdf by the distance and the cosine); a dome
samples the hemisphere around the normal uniformly and a canopy the
hemisphere around its axis, or either its emission map through the scene's
env sampler when it has one; a distant light (the sun) samples its cone by
a concentric disk; a volume light (an emissive Volumetric Cube) samples a
point inside it, by its density grid's Distribution3D where it has one (a
third uniform, xi3), and radiates mu_a * e * density there toward every
direction; a portal samples the dome seen through its rectangle by its
windowed distribution (scene/portal.py). A material with an IES profile
scales its emission by the profile at the angle from the light's normal,
on both sides of MIS.

Arithmetic follows the JAX package's jitted bounces on the CPU: a multiply
feeding an add is one fused multiply-add (core/fmath.py, core/vecmath.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from ..core.fmath import fma, sqrt
from ..ops.shade import _onb, _sphquad_init, _sphquad_pdf, _sphquad_sample
from ..render.materials import eval_ies, medium_coefficients
from . import env_sampling
from . import light_tree as lt
from . import portal as portal_mod
from .grids import sample_density_trilinear
from .shapes import prop_transform_at
from .shapes import select_by_shape as _sel
from .textures import sample_bilinear
from .types import RAY_MAX_T, ShapeType

_RECT = int(ShapeType.RECTANGLE)
_SPHERE = int(ShapeType.SPHERE)
_DISK = int(ShapeType.DISK)
_DIST = int(ShapeType.DISTANT)
_DOME = int(ShapeType.DOME)
_CANOPY = int(ShapeType.CANOPY)
_MESH = int(ShapeType.TRIANGLE_MESH)
_TRI_SEARCH_STEPS = 24  # the binary search in a mesh light's CDF slice (2^24 triangles)


VOLUME = "volume"  # light_shapes' key of the volume lights
PORTAL = "portal"  # light_shapes' key of the portal lights


def light_shapes(scene) -> set:
    """ShapeType codes of the scene's surface lights, VOLUME when it has
    volume lights and PORTAL when it has portal lights (each keyed apart
    from its Cube or Rectangle shape)."""
    vol = scene.lights.volume.tolist()
    shapes = scene.prop_shape[scene.lights.prop.long()].tolist()
    portal_lis = {li for li, _ in (scene.portals or {})}
    out = {int(s) for li, (s, v) in enumerate(zip(shapes, vol)) if not v and li not in portal_lis}
    return out | ({VOLUME} if any(vol) else set()) | ({PORTAL} if portal_lis else set())


def _portals(scene, present: set):
    """((light index, portal prop), PortalDist) of the portal lights in key
    order, where present names them."""
    return sorted((scene.portals or {}).items()) if PORTAL in present else []


def _hemisphere(xi):
    """Uniform directions [N, 3] on the hemisphere about +z."""
    z = 1.0 - xi[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * xi[:, 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


@dataclass
class LightSample:
    wi: torch.Tensor  # [N, 3] direction from the shading point to the light
    pdf: torch.Tensor  # [N] solid-angle pdf, 0 = invalid
    light_p: torch.Tensor  # [N, 3] point on the light (shadow ray target)
    light_n: torch.Tensor  # [N, 3] light surface normal
    t_max: torch.Tensor  # [N] distance to the light (RAY_MAX_T if infinite)
    infinite: torch.Tensor  # bool[N]
    uv: torch.Tensor  # [N, 2] texture uv of the sampled point
    # volume lights: the lanes whose light is one, and the radiance
    # mu_a * e * density at the sampled interior point (light_radiance's
    # `vol`); None without volume lights
    vol_mask: torch.Tensor = None  # bool[N]
    vol_radiance: torch.Tensor = None  # [N, 3]


def select_light(scene, u, p=None, n=None, total_sphere=None):
    """u in [0, 1) -> (light index int32[N], selection pdf [N]): through
    the light tree at the shading points p with normals n where the scene
    has a tree and p is given, else by the power CDF. total_sphere
    (bool[N] or None): lanes at a volume scatter vertex, which weigh the
    tree's clusters over the whole sphere."""
    if scene.light_tree is not None and p is not None:
        return lt.select(scene.light_tree, p, n, u, total_sphere)
    cdf = scene.lights.cdf
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1, 0,
                      scene.lights.count - 1)
    return idx.to(torch.int32), cdf[idx + 1] - cdf[idx]


def light_select_pdf(scene, light_idx, p=None, n=None, total_sphere=None):
    """Selection pdf of light_idx under select_light from (p, n)."""
    if scene.light_tree is not None and p is not None:
        return lt.pdf(scene.light_tree, p, n, light_idx, total_sphere)
    cdf = scene.lights.cdf
    i = torch.clamp(light_idx, 0, scene.lights.count - 1).long()
    return cdf[i + 1] - cdf[i]


def _light_prop(scene, light_idx):
    li = torch.clamp(light_idx, 0, scene.lights.count - 1).long()
    return scene.lights.prop[li].long()


def _cone_pdf(radius):
    """Uniform solid-angle pdf over a distant light's cone of half-angle
    atan(radius)."""
    solid_angle = (2.0 * math.pi) * (1.0 - sqrt(1.0 / fma(radius, radius, 1.0)))
    return 1.0 / torch.clamp(solid_angle, min=1e-20)


def _animated_transforms(scene, prop, rot, pos, scale, time):
    """(rot, pos, scale) with the lanes whose prop is a moving analytic
    light at its transform at their shutter time
    (zyg_tpu/scene/light_sampling.py:200-214); unchanged without moving
    lights or without time."""
    if not scene.animated_lights or time is None:
        return rot, pos, scale
    for pk in scene.animated_lights:
        rk, pp, ss = prop_transform_at(scene, pk, time)
        m = (prop == pk)[:, None]
        rot = torch.where(m[:, :, None], rk, rot)
        pos = torch.where(m, pp, pos)
        scale = torch.where(m, ss, scale)
    return rot, pos, scale


def _rect_local(p, pos, rot):
    dp = p - pos
    return (vm.dot(dp, rot[:, 0]), vm.dot(dp, rot[:, 1]), vm.dot(dp, rot[:, 2]))


def _volume_sample(scene, light_idx, prop, rot, pos, scale, p, xi, xi3):
    """A volume light's interior point seen from p: (wi, pdf, point,
    distance, radiance mu_a * e * density at the point); the point by the
    light's Distribution3D where it has one, else uniform in the cube,
    pdf = dist^2 / volume x the distribution's density."""
    uvw = torch.stack([xi[:, 0], xi[:, 1], xi3], dim=-1)
    xyz, p3 = uvw, torch.ones_like(xi3)
    for li, dist in sorted((scene.vol_light_dist or {}).items()):
        x2, pd = dist.sample_continuous(uvw)
        m_l = light_idx == li
        xyz = torch.where(m_l[:, None], x2, xyz)
        p3 = torch.where(m_l, pd, p3)
    vs = (xyz - 0.5) * scale
    wp = fma(vs[:, 2:3], rot[:, 2], fma(vs[:, 0:1], rot[:, 0], vs[:, 1:2] * rot[:, 1])) + pos
    axis = wp - p
    sl = torch.clamp(vm.dot(axis, axis), min=1e-12)
    dist_t = sqrt(sl)
    vol = torch.clamp(scale[:, 0] * scale[:, 1] * scale[:, 2], min=1e-20)
    m = scene.prop_material[prop]
    mu_t, mu_s, _ = medium_coefficients(scene.materials, m)
    e = scene.materials.emission[m.long()]
    dens = torch.ones_like(xi3)
    if scene.grids is not None:
        g = scene.materials.density_grid[m.long()]
        dens = torch.where(g >= 0, sample_density_trilinear(scene.grids, g, xyz), 1.0)
    radiance = torch.clamp(mu_t - mu_s, min=0.0) * e * dens[:, None]
    return axis / dist_t[:, None], sl / vol * p3, wp, dist_t, radiance


def pick_triangle(scene, light_idx, u):
    """Each lane's triangle of its mesh light by the light's area CDF:
    (padded arena triangle id, the light's world area, its tri_offset);
    the 24-step binary search for the first CDF entry >= u in the light's
    slice (zyg_tpu/scene/light_sampling.py:372-388). Lanes of other lights
    read the slice at 0 (tri_offset < 0 marks them)."""
    lights = scene.lights
    li = torch.clamp(light_idx, 0, lights.count - 1).long()
    t_off = lights.tri_offset[li].long()
    t_cnt = lights.tri_count[li].long()
    last = lights.tri_cdf.shape[0] - 1
    lo = torch.clamp(t_off, min=0)
    hi = lo + torch.clamp(t_cnt, min=1)
    for _ in range(_TRI_SEARCH_STEPS):
        mid = (lo + hi) // 2
        below = lights.tri_cdf[torch.clamp(mid, 0, last)] < u
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(below, hi, mid)
    tri = lights.tri_idx[torch.clamp(lo, 0, lights.tri_idx.shape[0] - 1)].long()
    return tri, lights.area[li], t_off


def _mesh_tree_pick(scene, light_idx, tri, area, p, n, u, total_sphere):
    """On the lanes of a mesh light with a primitive light tree, the
    tree's triangle at (p, n) and its effective area, the triangle's area
    over its selection pdf, so that the pdf sl / (cos * area) holds for
    both picks (zyg_tpu/scene/light_sampling.py:389-402)."""
    for (l_const, _), (tree, aux) in sorted((scene.mesh_light_trees or {}).items()):
        m_l = light_idx == l_const
        loc, psel = lt.select(tree, p, n, u, total_sphere)
        loc = loc.long()
        tri = torch.where(m_l, aux["arena"][loc].long(), tri)
        area = torch.where(m_l, aux["area"][loc] / torch.clamp(psel, min=1e-20), area)
    return tri, area


def _mesh_sample(scene, light_idx, rot, pos, scale, p, n, xi, total_sphere):
    """A point on each lane's mesh light seen from p: (wi, pdf, point,
    normal, distance, valid, uv), the triangle by the area CDF or the
    primitive tree, the point uniform on it (zyg_tpu/scene/
    light_sampling.py:366-440)."""
    tri, area, t_off = pick_triangle(scene, light_idx, xi[:, 0])
    tri, area = _mesh_tree_pick(scene, light_idx, tri, area, p, n, xi[:, 0], total_sphere)
    row = scene.meshes.attr_rows[tri]
    p0 = vm.object_to_world_point(rot, scale, pos, row[:, 0:3])
    e1 = vm.object_to_world_vector(rot, scale, row[:, 3:6])
    e2 = vm.object_to_world_vector(rot, scale, row[:, 6:9])
    bc = vm.sample_triangle_uniform(xi)
    mp = fma(bc[:, 1:2], e2, fma(bc[:, 0:1], e1, p0))
    mn = vm.safe_normalize(vm.cross(e1, e2))
    axis = mp - p
    sl = torch.clamp(vm.dot(axis, axis), min=1e-20)
    mt = sqrt(sl)
    wi = axis / mt[:, None]
    cosl = torch.abs(vm.dot(mn, wi))
    pdf = sl / torch.clamp(cosl * area, min=1e-20)
    valid = (t_off >= 0) & (cosl > 1e-5) & (area > 0.0)
    w0 = (1.0 - bc[:, 0] - bc[:, 1])[:, None]
    uv = fma(bc[:, 1:2], row[:, 16:18], fma(bc[:, 0:1], row[:, 14:16], w0 * row[:, 12:14]))
    return wi, pdf, mp, mn, mt, valid, uv


def sample_light(scene, present: set, light_idx, p, n, xi, total_sphere=None,
                 xi3=None, time=None, ns=None) -> LightSample:
    """Sample a direction toward light light_idx from the shading points p
    with geometric normals n; xi [N, 2] uniforms, and xi3 [N] a third one
    where the scene has volume lights. total_sphere (bool[N] or None):
    lanes at a volume scatter vertex, where a dome samples the whole
    sphere and no light is below a horizon. time (float32[N] or None):
    the lanes' shutter times, at which a moving light is sampled. ns: the
    shading normals, at which a mesh light's primitive tree picks (the
    normal the hit side's pdf reads, mis_n), n where None. A mesh light
    is sampled at its shutter-start transform."""
    prop = _light_prop(scene, light_idx)
    shape = scene.prop_shape[prop]
    rot, pos, scale = _animated_transforms(scene, prop, scene.prop_rot[prop],
                                           scene.prop_pos[prop], scene.prop_scale[prop], time)
    r0, r1, r2 = rot[:, 0], rot[:, 1], rot[:, 2]
    nlanes = p.shape[0]
    far_t = torch.full((nlanes,), RAY_MAX_T, dtype=torch.float32, device=p.device)
    ones_b = torch.ones((nlanes,), dtype=torch.bool, device=p.device)
    wi_v, pdf_v, lp_v, ln_v, valid_v, t_v, uv_v = {}, {}, {}, {}, {}, {}, {}

    if _RECT in present:
        sx, sy = scale[:, 0], scale[:, 1]
        ol = _rect_local(p, pos, rot)
        q = _sphquad_init(sx, sy, ol)
        xu, yv = _sphquad_sample(q, xi[:, 0], xi[:, 1])
        ax, ay = ol[0] + xu, ol[1] + yv
        rect_p = fma(ay[:, None], r1, fma(ax[:, None], r0, pos))
        axis = rect_p - p
        rect_t = vm.length(axis)
        wi_v[_RECT] = axis / torch.clamp(rect_t, min=1e-20)[:, None]
        pdf_v[_RECT] = _sphquad_pdf(q, ol, sx, sy)
        lp_v[_RECT] = rect_p
        ln_v[_RECT] = r2
        valid_v[_RECT] = q["S"] > 1e-7
        t_v[_RECT] = rect_t
        # the rectangle's own uv (ops/isect.py prop_hit): u = dot(-r0, k) / (sx/2)
        ru = -ax / (0.5 * sx)
        rv = -ay / (0.5 * sy)
        uv_v[_RECT] = torch.stack([0.5 * (ru + 1.0), 0.5 * (rv + 1.0)], dim=-1)

    if _SPHERE in present:
        # the cone the sphere subtends from p, uniformly (a small-angle
        # branch keeps 1 - cos accurate); the point's normal faces p
        v = pos - p
        l2 = torch.clamp(vm.dot(v, v), min=1e-20)
        el = sqrt(l2)
        sp_r = 0.5 * scale[:, 0]
        z_axis = v / el[:, None]
        tx, ty = vm.orthonormal_basis(z_axis)
        sin2_max = torch.clamp((sp_r * sp_r) / l2, 0.0, 0.9999)
        cos_max = sqrt(1.0 - sin2_max)
        small = sin2_max < 0.00068523
        cos_theta = fma(cos_max - 1.0, xi[:, 0], 1.0)
        sin2_theta = torch.where(small, sin2_max * xi[:, 0], fma(-cos_theta, cos_theta, 1.0))
        cos_theta = torch.where(small, sqrt(1.0 - sin2_theta), cos_theta)
        one_minus_cos_max = torch.where(small, 0.5 * sin2_max, 1.0 - cos_max)
        sin_max = sqrt(torch.clamp(sin2_max, min=1e-20))
        ratio = torch.clamp(sin2_theta / torch.clamp(sin2_max, min=1e-20), max=1.0)
        cos_alpha = torch.clamp(
            fma(cos_theta, sqrt(torch.clamp(1.0 - ratio, min=0.0)), sin2_theta / sin_max), max=1.0)
        sin_alpha = sqrt(torch.clamp(fma(-cos_alpha, cos_alpha, 1.0), min=0.0))
        phi = xi[:, 1] * (2.0 * math.pi)
        w_local = torch.stack([sin_alpha * torch.cos(phi), sin_alpha * torch.sin(phi), cos_alpha],
                              dim=-1)
        sph_n = -vm.frame_to_world(tx, ty, z_axis, w_local)
        sph_p = fma(sp_r[:, None], sph_n, pos)
        axis = sph_p - p
        sph_t = vm.length(axis)
        wi_v[_SPHERE] = axis / torch.clamp(sph_t, min=1e-20)[:, None]
        pdf_v[_SPHERE] = 1.0 / torch.clamp((2.0 * math.pi) * one_minus_cos_max, min=1e-20)
        lp_v[_SPHERE] = sph_p
        ln_v[_SPHERE] = sph_n
        valid_v[_SPHERE] = el > sp_r + 1e-7
        t_v[_SPHERE] = sph_t
        # the lat-long uv of the sampled normal (shapes.build_fragment's)
        sxyz = vm.safe_normalize(vm.world_to_object_normal(rot, sph_n))
        sphi = -torch.atan2(sxyz[:, 0], sxyz[:, 2]) + math.pi
        stheta = torch.acos(torch.clamp(sxyz[:, 1], -1.0, 1.0))
        uv_v[_SPHERE] = torch.stack([sphi * (0.5 / math.pi), stheta * (1.0 / math.pi)], dim=-1)

    if _DISK in present:
        # a concentric point on the disk, pdf = dist^2 / (|cos| area)
        dk_r = 0.5 * scale[:, 0]
        dxy = vm.sample_disk_concentric(xi)
        dk_p = fma(dk_r[:, None], fma(dxy[:, 0:1], r0, dxy[:, 1:2] * r1), pos)
        axis = dk_p - p
        dk_sl = torch.clamp(vm.dot(axis, axis), min=1e-20)
        dk_t = sqrt(dk_sl)
        dk_wi = axis / dk_t[:, None]
        dk_c = torch.abs(-vm.dot(r2, dk_wi))
        wi_v[_DISK] = dk_wi
        pdf_v[_DISK] = dk_sl / torch.clamp(dk_c * (math.pi * dk_r * dk_r), min=1e-20)
        lp_v[_DISK] = dk_p
        ln_v[_DISK] = r2
        valid_v[_DISK] = dk_c > 1e-5
        t_v[_DISK] = dk_t
        # disk_intersect's uv: u = dot(-r0, k / r) for k = r (dxy . axes)
        uv_v[_DISK] = torch.stack([0.5 * (1.0 - dxy[:, 0]), 0.5 * (1.0 - dxy[:, 1])], dim=-1)

    if _DIST in present:
        # the sun's cone: a concentric disk of radius tan(angular radius)
        # around the light's direction
        radius = scale[:, 0]
        xy = vm.sample_disk_concentric(xi)
        ws = radius[:, None] * fma(xy[:, 0:1], r0, xy[:, 1:2] * r1)
        wi_d = vm.safe_normalize(ws - r2)
        wi_v[_DIST] = wi_d
        pdf_v[_DIST] = _cone_pdf(radius)
        ln_v[_DIST] = r2
        valid_v[_DIST] = radius > 0.0
        # distant_intersect's uv: k = d - n, u = dot(r0, k / radius)
        k = (wi_d - r2) / torch.clamp(radius, min=1e-20)[:, None]
        uv_v[_DIST] = torch.stack([0.5 * (vm.dot(r0, k) + 1.0), 0.5 * (vm.dot(r1, k) + 1.0)],
                                  dim=-1)

    if _CANOPY in present:
        # the hemisphere around the canopy's axis, uniformly (map-less canopies)
        wi_v[_CANOPY] = vm.frame_to_world(r0, r1, r2, _hemisphere(xi))
        pdf_v[_CANOPY] = torch.full((nlanes,), 1.0 / (2.0 * math.pi), dtype=torch.float32,
                                    device=p.device)
        valid_v[_CANOPY] = ones_b

    if _DOME in present:
        # the hemisphere around n, uniformly (map-less domes)
        t, b = (torch.stack(v, dim=-1) for v in _onb(n.unbind(1)))
        wi_v[_DOME] = vm.object_to_world_normal(torch.stack([t, b, n], dim=1), _hemisphere(xi))
        pdf_v[_DOME] = torch.full((nlanes,), 1.0 / (2.0 * math.pi), dtype=torch.float32,
                                  device=p.device)
        if total_sphere is not None:
            # the whole sphere, uniformly
            phi = (2.0 * math.pi) * xi[:, 1]
            zs = 1.0 - 2.0 * xi[:, 0]
            rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
            full = torch.stack([rs * torch.cos(phi), rs * torch.sin(phi), zs], dim=-1)
            wi_v[_DOME] = torch.where(total_sphere[:, None], full, wi_v[_DOME])
            pdf_v[_DOME] = torch.where(total_sphere, 1.0 / (4.0 * math.pi), pdf_v[_DOME])
        valid_v[_DOME] = ones_b

    if _MESH in present:
        (wi_v[_MESH], pdf_v[_MESH], lp_v[_MESH], ln_v[_MESH], t_v[_MESH], valid_v[_MESH],
         uv_v[_MESH]) = _mesh_sample(scene, light_idx, rot, pos, scale, p,
                                     ns if ns is not None else n, xi, total_sphere)

    wi = _sel(shape, wi_v, torch.zeros_like(p))
    pdf = _sel(shape, pdf_v, torch.zeros_like(far_t))
    light_p = _sel(shape, lp_v, fma(wi, RAY_MAX_T, p))
    light_n = _sel(shape, ln_v, -wi)
    valid = _sel(shape, valid_v, torch.zeros_like(ones_b))
    t_max = _sel(shape, t_v, far_t)
    uv = _sel(shape, uv_v, torch.zeros_like(p[:, :2]))
    infinite = torch.zeros_like(ones_b)
    if present & {_CANOPY, _DOME, _DIST}:
        # infinite lights: a point at RAY_MAX_T; a canopy's or dome's
        # normal faces the shading point, the sun keeps its axis
        infinite = (shape == _CANOPY) | (shape == _DOME) | (shape == _DIST)
        light_p = torch.where(infinite[:, None], fma(wi, RAY_MAX_T, p), light_p)
        light_n = torch.where(((shape == _CANOPY) | (shape == _DOME))[:, None], -wi, light_n)
        t_max = torch.where(infinite, far_t, t_max)

    # mapped domes: importance-sample the emission map instead
    is_env = torch.zeros_like(ones_b)
    if scene.env is not None:
        li = torch.clamp(light_idx, 0, scene.lights.count - 1)
        entry = env_sampling.entry_of_light(scene.env, li)
        is_env = entry >= 0
        wi_env, pdf_env, uv_env = env_sampling.sample(scene.env, entry, rot, xi)
        e3 = is_env[:, None]
        wi = torch.where(e3, wi_env, wi)
        pdf = torch.where(is_env, pdf_env, pdf)
        uv = torch.where(e3, uv_env, uv)
        light_p = torch.where(e3, fma(wi, RAY_MAX_T, p), light_p)
        light_n = torch.where(e3, -wi, light_n)
        t_max = torch.where(is_env, far_t, t_max)
        infinite = infinite | is_env

    # volume lights: an interior point, which has no normal (light_n 0)
    vol_mask = vol_radiance = None
    if VOLUME in present and xi3 is not None:
        vol_mask = scene.lights.volume[torch.clamp(light_idx, 0, scene.lights.count - 1).long()]
        v_wi, v_pdf, v_p, v_t, vol_radiance = _volume_sample(scene, light_idx, prop, rot, pos,
                                                             scale, p, xi, xi3)
        v3 = vol_mask[:, None]
        wi = torch.where(v3, v_wi, wi)
        pdf = torch.where(vol_mask, v_pdf, pdf)
        light_p = torch.where(v3, v_p, light_p)
        light_n = torch.where(v3, 0.0, light_n)
        t_max = torch.where(vol_mask, v_t, t_max)
        infinite = infinite & ~vol_mask
        valid = torch.where(vol_mask, v_pdf > 0.0, valid)

    # portal lights: the windowed sample of the dome seen through the
    # rectangle; its radiance is the dome's map at the direction's uv
    for (li, pp), pd in _portals(scene, present):
        res = portal_mod.sample_to(pd, scene.prop_rot[pp], scene.prop_pos[pp],
                                   scene.prop_scale[pp], p, xi)
        m_l = light_idx == li
        ok = m_l & res["ok"]
        ok3 = ok[:, None]
        wi = torch.where(ok3, res["wi"], wi)
        pdf = torch.where(m_l, torch.where(res["ok"], res["pdf"], 0.0), pdf)
        light_p = torch.where(ok3, fma(res["t"][:, None], res["wi"], p), light_p)
        light_n = torch.where(ok3, scene.prop_rot[pp][2].expand_as(p), light_n)
        t_max = torch.where(ok, res["t"], t_max)
        uv = torch.where(ok3, res["uv"], uv)
        valid = torch.where(m_l, res["ok"] & (res["pdf"] > 0.0), valid)
        infinite = infinite & ~m_l

    # facing the shading hemisphere; env-sampled lanes sample the whole map
    # and rely on f = 0 below the horizon (the NEE density then equals the
    # pdf the BSDF-hit MIS weight uses)
    front = vm.dot(wi, n) > 0.0
    if total_sphere is not None:
        front = front | total_sphere
    valid = valid & (front | is_env) & (pdf > 0.0)
    return LightSample(wi, torch.where(valid, pdf, 0.0), light_p, light_n, t_max, infinite, uv,
                       vol_mask, vol_radiance)


def light_radiance(scene, light_idx, wi, light_n, uv, vol=None):
    """Radiance light_idx emits toward the shading point along -wi: its
    emission where it faces the point or is two-sided, scaled by its IES
    profile at the angle from light_n and by its emission map at the
    sampled uv (a dome's at the direction's lat-long uv, a canopy's at its
    equidistant-disk uv) exactly as eval_radiance scales it on the BSDF-hit
    side. vol: the sample's (vol_mask, vol_radiance), which a volume
    light's lanes take instead (an interior point faces every way)."""
    prop = _light_prop(scene, light_idx)
    m = scene.prop_material[prop].long()
    emission = scene.materials.emission[m]
    two_sided = scene.materials.two_sided[m]
    if "ies" in scene.mat_features:
        emission = emission * eval_ies(scene.materials.ies[m], vm.dot(-wi, light_n))[:, None]
    if scene.textures is not None:
        et = scene.materials.emission_tex[m]
        shape = scene.prop_shape[prop]
        ldir = vm.safe_normalize(vm.world_to_object_normal(scene.prop_rot[prop], wi))
        env_uv = env_sampling.dome_uv(ldir)
        if _CANOPY in scene.prop_groups:
            env_uv = torch.where((shape == _CANOPY)[:, None], env_sampling.canopy_uv(ldir), env_uv)
        tex_uv = torch.where(((shape == _DOME) | (shape == _CANOPY))[:, None], env_uv, uv)
        tex = sample_bilinear(scene.textures, et, tex_uv)[:, :3]
        emission = torch.where((et >= 0)[:, None], emission * tex, emission)
    facing = vm.dot(-wi, light_n) > 0.0
    out = torch.where((facing | two_sided)[:, None], emission, 0.0)
    if vol is not None and vol[0] is not None:
        out = torch.where(vol[0][:, None], vol[1], out)
    return out


def mis_hit(present: set, hit_t, frag, mis_o) -> tuple:
    """(hit_t, hit_n) for light_hit_pdf: the hit's distance from the last
    real vertex mis_o (null boundaries in between leave the line as it
    is) and its geometric normal, as the JAX bodies pass them
    (zyg_tpu/render/integrator/ptmis.py:568-572); (None, None) where no
    Disk or mesh light reads them."""
    if _DISK not in present and _MESH not in present:
        return None, None
    eff_t = torch.where(hit_t >= RAY_MAX_T, hit_t, vm.length(frag.p - mis_o))
    return eff_t, frag.geo_n


def light_hit_pdf(scene, present: set, prop, ray_o, ray_d, hit_t=None, hit_n=None,
                  total_sphere=None, time=None, hit_prim=None, n_at_origin=None):
    """Solid-angle pdf with which NEE from ray_o would have sampled the hit
    on prop along ray_d: the light side of the BSDF-hit MIS weight. hit_t
    and hit_n, the hit's distance from ray_o and its geometric normal, are
    read by the Disk's and the mesh lights' pdfs, so a scene with such
    lights needs them. total_sphere (bool[N] or None): the ray left a
    volume scatter vertex, whose NEE samples a dome over the whole sphere.
    time: the lanes' shutter times, at which a moving light's pdf is
    evaluated. hit_prim and n_at_origin (the hit's arena triangle and the
    normal at ray_o, mis_n): a mesh light with a primitive tree folds the
    tree's pdf of that triangle from (ray_o, n_at_origin) into its area,
    as the sample side does (zyg_tpu/scene/light_sampling.py:694-730)."""
    pm = torch.clamp(prop, min=0).long()
    shape = scene.prop_shape[pm]
    rot, pos, scale = _animated_transforms(scene, pm, scene.prop_rot[pm], scene.prop_pos[pm],
                                           scene.prop_scale[pm], time)
    vals = {}
    if _RECT in present:
        ol = _rect_local(ray_o, pos, rot)
        q = _sphquad_init(scale[:, 0], scale[:, 1], ol)
        vals[_RECT] = _sphquad_pdf(q, ol, scale[:, 0], scale[:, 1])
    if _SPHERE in present:
        v = pos - ray_o
        l2 = torch.clamp(vm.dot(v, v), min=1e-20)
        r = 0.5 * scale[:, 0]
        sin2_max = torch.clamp((r * r) / l2, 0.0, 0.9999)
        one_minus_cos = torch.where(sin2_max < 0.00068523, 0.5 * sin2_max,
                                    1.0 - sqrt(1.0 - sin2_max))
        vals[_SPHERE] = 1.0 / torch.clamp((2.0 * math.pi) * one_minus_cos, min=1e-20)
    if _DISK in present:
        if hit_t is None or hit_n is None:
            raise ValueError("light_hit_pdf: a Disk light's pdf reads hit_t and hit_n")
        sl = torch.clamp(hit_t * hit_t, min=1e-20)
        c = torch.abs(vm.dot(hit_n, ray_d))
        r = 0.5 * scale[:, 0]
        vals[_DISK] = sl / torch.clamp(c * (math.pi * (r * r)), min=1e-20)
    if _DIST in present:
        vals[_DIST] = _cone_pdf(scale[:, 0])
    if _CANOPY in present:
        vals[_CANOPY] = torch.full(shape.shape, 1.0 / (2.0 * math.pi), dtype=torch.float32,
                                   device=ray_o.device)
    if _DOME in present:
        vals[_DOME] = torch.full(shape.shape, 1.0 / (2.0 * math.pi), dtype=torch.float32,
                                 device=ray_o.device)
        if total_sphere is not None:
            vals[_DOME] = torch.where(total_sphere, 1.0 / (4.0 * math.pi), vals[_DOME])
    if _MESH in present:
        if hit_t is None or hit_n is None:
            raise ValueError("light_hit_pdf: a mesh light's pdf reads hit_t and hit_n")
        li = scene.prop_light[pm]
        area = scene.lights.area[torch.clamp(li, 0, scene.lights.count - 1).long()]
        sl = torch.clamp(hit_t * hit_t, min=1e-20)
        c = torch.abs(vm.dot(hit_n, ray_d))
        if scene.mesh_light_trees and hit_prim is not None:
            for (l_const, base), (tree, aux) in sorted(scene.mesh_light_trees.items()):
                lof = aux["local_of"]
                loc = lof[torch.clamp(hit_prim.long() - base, 0, lof.shape[0] - 1)].long()
                okl = (li == l_const) & (hit_prim >= base) & (loc >= 0)
                psel = lt.pdf(tree, ray_o, n_at_origin, torch.clamp(loc, min=0), total_sphere)
                area = torch.where(okl, aux["area"][torch.clamp(loc, min=0)]
                                   / torch.clamp(psel, min=1e-20), area)
        vals[_MESH] = torch.where(area > 0.0, sl / torch.clamp(c * area, min=1e-20), 0.0)
    out = _sel(shape, vals, torch.zeros(shape.shape, dtype=torch.float32, device=ray_o.device))
    if scene.env is not None:
        # mapped domes: NEE samples the map, so MIS needs the map's density
        li = scene.prop_light[pm]
        entry = env_sampling.entry_of_light(scene.env, li)
        out = torch.where(entry >= 0, env_sampling.pdf(scene.env, li, rot, ray_d), out)
    # portal lights: NEE samples the windowed distribution, so MIS needs
    # its density (ref light.zig propPortalPdf)
    for (_, pp), pd in _portals(scene, present):
        p_port = portal_mod.pdf_to(pd, scene.prop_rot[pp], scene.prop_pos[pp],
                                   scene.prop_scale[pp], ray_o, ray_d)
        out = torch.where(prop == pp, p_port, out)
    # a Cube's surface is never sampled (a volume light samples its
    # interior, which a BSDF ray does not hit): pdf 0, MIS weight 1
    return torch.where(shape == int(ShapeType.CUBE), 0.0, out)
