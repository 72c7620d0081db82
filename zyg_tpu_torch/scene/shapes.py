"""Scene intersection, shadow visibility and the shading fragment for the
mesh paths (counterpart of zyg_tpu/scene/shapes.py:197 prop_transform_at,
:232 intersect_scene, :504 occluded, :616 build_fragment; moving props
at each lane's shutter time, tangent frames on request). The ray
offsets of the bounces are in ops/surface.py's and ops/surface_v2.py's
kernels and plain versions.

A closest hit tests the analytic props first (ops/isect.py, kernel 2),
then walks the mesh instances bounded by that hit (ops/traverse.py),
then each curve prop's and each point prop's segments or spheres in
object space (ops/curves.py, ops/points.py), static props in prop order
before the moving ones, as zyg_tpu/scene/shapes.py:354-465 does; a
shadow ray tests the analytic props, then walks the meshes, curves and
points only where nothing blocked it yet.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from ..core.encoding import oct_normal_unpack
from ..core.fmath import fma
from ..ops import curves as curve_walk
from ..ops import isect, traverse
from ..ops import points as point_walk
from . import env_sampling, portal
from .curves import segment_fields
from .points import point_center
from .types import RAY_MAX_T, ShapeType


@dataclass
class Hit:
    t: torch.Tensor  # float32[N] (isect.FAR on a miss)
    prop: torch.Tensor  # int32[N] prop id, -1 on a miss
    u: torch.Tensor  # float32[N]
    v: torch.Tensor  # float32[N]
    prim: torch.Tensor  # int32[N] padded arena triangle, segment or point id, -1 elsewhere

    def valid(self) -> torch.Tensor:
        return self.prop >= 0


@dataclass
class Fragment:
    p: torch.Tensor  # [N, 3] hit point
    geo_n: torch.Tensor  # [N, 3] geometric normal
    n: torch.Tensor  # [N, 3] shading normal
    material: torch.Tensor  # int32[N] material id of the hit prop
    uv: torch.Tensor = None  # [N, 2] texture coordinates (need_uv), else None
    t: torch.Tensor = None  # [N, 3] tangent (need_tangents), else None
    b: torch.Tensor = None  # [N, 3] bitangent (need_tangents), else None
    prop: torch.Tensor = None  # int32[N] the hit prop, -1 on a miss


def select_by_shape(shape, vals: dict, default):
    """Each lane's value for its shape type among vals {ShapeType code:
    [N] or [N, k] value}, in the dict's order: the first entry is the value
    of every lane whose shape has none (the JAX package's `sel`); default
    when vals is empty."""
    out = default
    for i, (st, val) in enumerate(vals.items()):
        cond = shape == st
        out = val if i == 0 else torch.where(cond[:, None] if val.dim() > 1 else cond, val, out)
    return out


def prop_transform_at(scene, k, time):
    """(rot [N, 3, 3], pos [N, 3], scale [N, 3]) of animated prop k (an int,
    or int[N] a lane) at the lanes' shutter times in [0, 1]: the slerp and
    lerps between the two of scene.prop_keys' K+1 uniform keyframes that
    enclose the time (zyg_tpu/scene/shapes.py:197-229)."""
    keys = scene.prop_keys[k] if isinstance(k, int) else scene.prop_keys[k.long()]
    K = keys.shape[-2] - 1
    if K == 1:
        row0, row1 = keys[..., 0, :], keys[..., 1, :]
        f = time[:, None]
    else:
        u = torch.clamp(time, 0.0, 1.0) * K
        i = torch.clamp(u.to(torch.int64), 0, K - 1)
        f = (u - i.to(torch.float32))[:, None]
        if isinstance(k, int):
            row0, row1 = keys[i], keys[i + 1]
        else:
            lanes = torch.arange(time.shape[0], device=time.device)
            row0, row1 = keys[lanes, i], keys[lanes, i + 1]
    q = vm.quat_slerp(row0[..., 0:4], row1[..., 0:4], f)
    return (vm.quat_to_mat3(q), vm.lerp(row0[..., 4:7], row1[..., 4:7], f),
            vm.lerp(row0[..., 7:10], row1[..., 7:10], f))


def _walk_time(scene, o, time):
    """The shutter times the mesh walk takes: time, or the shutter's start
    where a moving instance needs one and none is given (the JAX walk's
    default)."""
    if time is None and scene.mesh_instances.has_anim:
        return torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    return time


def _animated_hits(scene, o, d, tmin: float, tmax, time):
    """(prop, (t, u, v, hit)) of each moving analytic prop in key order,
    tested at the lanes' shutter times (time None: 0)."""
    tl = torch.zeros(o.shape[0], device=o.device) if time is None else time
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(o.shape[0])
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    for pk, st in scene.animated_props or {}:
        if int(st) not in isect.SUPPORTED:
            continue  # moving meshes are walked by the traversal
        rot, pos, scale = prop_transform_at(scene, pk, tl)
        # the lanes' transforms as the 15 [N] rows of an isect table row
        r = torch.cat([rot.reshape(-1, 9), pos, scale], dim=1).T
        yield pk, isect.prop_hit(int(st), r, ox, oy, oz, dx, dy, dz, tmin, tmax)


def _walked_props(scene) -> list[tuple[int, bool, bool]]:
    """(prop, moves, is_curve) of the curve props, then of the point props,
    each kind's static props in prop order before its moving ones."""
    out = []
    for static, moving, is_curve in ((scene.curve_props, scene.animated_curves, True),
                                     (scene.point_props, scene.animated_points, False)):
        if static is not None:
            out += [(int(k), False, is_curve) for k in static.tolist()]
        out += [(int(k), True, is_curve) for k in (moving or {})]
    return out


def _walk(scene, k: int, moves: bool, is_curve: bool, o, d, time, walks, tmin: float, tmax,
          any_hit: bool = False):
    """(t, u, prim) of prop k's curve or point walk for rays o, d [N, 3] in
    its object space (a moving prop's transform, and a moving cloud's
    centers, at the lanes' shutter times `time`; None: the shutter's start)
    over the lanes where `walks` (bool [N]); u is a curve hit's axial
    parameter, 0 on points."""
    tl = torch.zeros(o.shape[0], device=o.device) if time is None else time
    if moves:
        rot, pos, scale = prop_transform_at(scene, k, tl)
    else:
        rot, pos, scale = scene.prop_rot[k], scene.prop_pos[k], scene.prop_scale[k]
    o_l = vm.world_to_object_point(rot, scale, pos, o)
    d_l = vm.world_to_object_vector(rot, scale, d)
    arena = scene.curves if is_curve else scene.points
    root = (arena.curve_root[scene.prop_curve[k]] if is_curve
            else arena.cloud_root[scene.prop_cloud[k]])
    root = torch.where(walks, root.to(torch.int32), -1).expand(o.shape[0]).contiguous()
    if is_curve:
        return curve_walk.walk(arena, root, o_l, d_l, tmin, tmax, any_hit=any_hit)
    t, prim = point_walk.walk(arena, root, o_l, d_l, tmin, tmax, time=tl, any_hit=any_hit)
    return t, torch.zeros_like(t), prim


def intersect_scene(scene, table: isect.PropTable, o, d, tmin: float, tmax, primary=None,
                    time=None) -> Hit:
    """Closest hit over all props for the ray class of table (the scene's
    isect.prop_table); `primary` lanes use camera visibility. Moving props
    are tested at the lanes' shutter times `time` (float32[N]; None: the
    shutter's start), one torch pass each after the isect kernel's static
    props, as the JAX package tests them in XLA after its Pallas pass."""
    t_b, p_b, u_b, v_b = isect.closest_props(table, o, d, tmin, tmax, primary)
    if scene.animated_props:
        vis = {"camera": scene.prop_visible_camera, "reflection": scene.prop_visible_reflection,
               "shadow": scene.prop_visible_shadow}[table.ray_class]
        for pk, (t, u, v, hit) in _animated_hits(scene, o, d, tmin, tmax, time):
            lane_vis = vis[pk]
            if primary is not None:
                lane_vis = torch.where(primary, scene.prop_visible_camera[pk], lane_vis)
            closer = hit & lane_vis & (t < t_b)
            t_b = torch.where(closer, t, t_b)
            p_b = torch.where(closer, pk, p_b)
            u_b = torch.where(closer, u, u_b)
            v_b = torch.where(closer, v, v_b)
    prim = torch.full_like(p_b, -1)
    if scene.meshes is not None:
        tmax_t = torch.as_tensor(tmax, dtype=torch.float32, device=o.device)
        th, tp, tu, tv, tprop = traverse.intersect_instances(
            scene.meshes, scene.mesh_instances, o, d, tmin, torch.minimum(tmax_t, t_b),
            table.ray_class, primary=primary, time=_walk_time(scene, o, time),
        )
        closer = tp >= 0  # the walk was bounded by the analytic hit
        t_b = torch.where(closer, th, t_b)
        p_b = torch.where(closer, tprop, p_b)
        u_b = torch.where(closer, tu, u_b)
        v_b = torch.where(closer, tv, v_b)
        prim = torch.where(closer, tp, prim)
    if scene.curves is not None or scene.points is not None:
        vis = {"camera": scene.prop_visible_camera, "reflection": scene.prop_visible_reflection,
               "shadow": scene.prop_visible_shadow}[table.ray_class]
        tmax_t = torch.as_tensor(tmax, dtype=torch.float32, device=o.device)
        for k, moves, is_curve in _walked_props(scene):
            lane_vis = vis[k].expand(o.shape[0])
            if primary is not None:
                lane_vis = torch.where(primary, scene.prop_visible_camera[k], lane_vis)
            t, u, pr = _walk(scene, k, moves, is_curve, o, d, time, lane_vis, tmin,
                             torch.minimum(tmax_t, t_b))
            closer = (pr >= 0) & (t < t_b) & lane_vis
            t_b = torch.where(closer, t, t_b)
            p_b = torch.where(closer, k, p_b)
            u_b = torch.where(closer, u, u_b)
            v_b = torch.where(closer, 0.0, v_b)
            prim = torch.where(closer, pr, prim)
    return Hit(t_b, p_b, u_b, v_b, prim)


def occluded(scene, table: isect.PropTable, o, d, tmin: float, tmax, time=None) -> torch.Tensor:
    """Any-hit visibility of shadow rays: True = blocked. table: the
    scene's isect.prop_table("shadow"); moving props at the lanes' shutter
    times `time` (None: the shutter's start)."""
    blocked = isect.anyhit_props(table, o, d, tmin, tmax)
    for pk, (_, _, _, hit) in _animated_hits(scene, o, d, tmin, tmax, time):
        blocked = blocked | (hit & scene.prop_visible_shadow[pk])
    if scene.meshes is not None:
        tmax_t = torch.as_tensor(tmax, dtype=torch.float32, device=o.device)
        blocked = blocked | traverse.intersect_instances(
            scene.meshes, scene.mesh_instances, o, d, tmin,
            torch.where(blocked, tmin, tmax_t),  # already blocked: skip the walk
            "shadow", any_hit=True, time=_walk_time(scene, o, time),
        )
    for k, moves, is_curve in _walked_props(scene):
        _, _, pr = _walk(scene, k, moves, is_curve, o, d, time,
                         ~blocked & scene.prop_visible_shadow[k], tmin, tmax, any_hit=True)
        blocked = blocked | (pr >= 0)
    return blocked


def build_fragment(scene, hit: Hit, o, d, need_uv: bool | None = None,
                   need_tangents: bool = False, time=None) -> Fragment:
    """Hit point, geometric and shading normals, material and (where
    need_uv, by default for textured scenes) uv of the closest hit, over
    the shape branches present in the scene. Lanes on an infinite shape
    get the point RAY_MAX_T * d; a canopy's and the dome's normal is -d,
    the sun's (a Distant prop) its axis; a portal's rectangle gets the
    linked dome's uv of d. With need_tangents, the shading frame's
    tangent and bitangent too: a rectangle's or disk's -x and -y axes, a
    sphere's direction of increasing u, the infinite shapes' x and y axes,
    and the orthonormal basis about the normal on cubes and meshes (and on
    every lane when no present shape has a frame of its own). Lanes on a
    moving prop take its transform at their shutter time `time` (None:
    the shutter's start). As in the JAX package, the present shape types
    are the static groups' (a moving prop leaves them): a moving prop whose
    shape no static prop shares takes the first present type's normal
    rule (zyg_tpu/scene/shapes.py:626-654). A curve hit's frame is the
    strand's tangent, the bitangent across it and the cylinder's normal,
    its uv (the strand parameter, (h + 1) / 2 of the offset h across the
    strand seen from the ray), which the hair BSDF reads, so scenes with
    a Hair material get uv by default; a point hit's normal is the
    sphere's at its center at the lane's shutter time
    (zyg_tpu/scene/shapes.py:820-866). On a deforming mesh the geometric
    normal is the triangle's at the lane's shutter time where time is
    given (:780-786), the shading normal frame 0's."""
    if need_uv is None:
        need_uv = scene.textures is not None or "hair" in scene.mat_features
    present = {int(k) for k in scene.prop_groups}
    prop = torch.clamp(hit.prop, min=0).long()
    shape = scene.prop_shape[prop]
    rot = scene.prop_rot[prop]
    pos = scene.prop_pos[prop]
    scale = scene.prop_scale[prop]
    anim_ids = ({pk for pk, _ in scene.animated_props or ()} | set(scene.animated_curves or ())
                | set(scene.animated_points or ()))
    if anim_ids:
        tl = torch.zeros_like(hit.t) if time is None else time
        for pk in sorted(anim_ids):
            rk, pk_pos, pk_scale = prop_transform_at(scene, pk, tl)
            m1 = (prop == pk)[:, None]
            rot = torch.where(m1[:, :, None], rk, rot)
            pos = torch.where(m1, pk_pos, pos)
            scale = torch.where(m1, pk_scale, scale)
    p = fma(hit.t[:, None], d, o)
    r0, r1, r2 = rot[:, 0], rot[:, 1], rot[:, 2]

    # value per present shape type, selected by the lane's shape in the
    # JAX package's key order (the first present type is the default)
    n_vals, uv_vals, t_vals, b_vals = {}, {}, {}, {}
    for st in (ShapeType.RECTANGLE, ShapeType.DISK):
        if int(st) in present:
            n_vals[int(st)] = r2
            t_vals[int(st)], b_vals[int(st)] = -r0, -r1
            uv_vals[int(st)] = torch.stack([0.5 * (hit.u + 1.0), 0.5 * (hit.v + 1.0)], dim=-1)
    if int(ShapeType.SPHERE) in present:
        sph_n = vm.safe_normalize(p - pos)
        n_vals[int(ShapeType.SPHERE)] = sph_n
        if need_uv or need_tangents:
            xyz = vm.safe_normalize(vm.world_to_object_normal(rot, sph_n))
            phi = -torch.atan2(xyz[:, 0], xyz[:, 2]) + math.pi
            theta = torch.acos(torch.clamp(xyz[:, 1], -1.0, 1.0))
            uv_vals[int(ShapeType.SPHERE)] = torch.stack(
                [phi * (0.5 / math.pi), theta * (1.0 / math.pi)], dim=-1)
        if need_tangents:
            sin_theta = torch.clamp(torch.sin(theta), min=1e-5)
            t_l = torch.stack([sin_theta * torch.cos(phi), torch.zeros_like(phi),
                               sin_theta * torch.sin(phi)], dim=-1)
            sph_t = vm.safe_normalize(vm.object_to_world_normal(rot, t_l))
            t_vals[int(ShapeType.SPHERE)] = sph_t
            b_vals[int(ShapeType.SPHERE)] = -vm.cross(sph_t, sph_n)
    if int(ShapeType.CUBE) in present:
        lp = vm.world_to_object_point(rot, scale, pos, p)
        ax, ay, az = (0.5 - torch.abs(lp[:, k]) for k in range(3))
        use_x = (ax <= ay) & (ax <= az)
        use_y = (~use_x) & (ay <= az)
        face_n = torch.where(use_x[:, None], r0, torch.where(use_y[:, None], r1, r2))
        comp = torch.where(use_x, lp[:, 0], torch.where(use_y, lp[:, 1], lp[:, 2]))
        cube_n = torch.sign(comp)[:, None] * face_n
        n_vals[int(ShapeType.CUBE)] = cube_n
        if need_tangents:
            t_vals[int(ShapeType.CUBE)], b_vals[int(ShapeType.CUBE)] = vm.orthonormal_basis(cube_n)
    # infinite shapes: a canopy's and the dome's normal faces the ray, the
    # sun's is its axis; uv in the JAX package's key order (the sun's
    # before the canopy's and the dome's)
    if int(ShapeType.CANOPY) in present:
        n_vals[int(ShapeType.CANOPY)] = -d
        t_vals[int(ShapeType.CANOPY)], b_vals[int(ShapeType.CANOPY)] = r0, r1
    if int(ShapeType.DOME) in present:
        n_vals[int(ShapeType.DOME)] = -d
        t_vals[int(ShapeType.DOME)], b_vals[int(ShapeType.DOME)] = r0, r1
    if int(ShapeType.DISTANT) in present:
        n_vals[int(ShapeType.DISTANT)] = r2
        t_vals[int(ShapeType.DISTANT)], b_vals[int(ShapeType.DISTANT)] = r0, r1
        uv_vals[int(ShapeType.DISTANT)] = torch.stack([(hit.u + 1.0) * 0.5, (hit.v + 1.0) * 0.5],
                                                      dim=-1)
    if need_uv and present & {int(ShapeType.CANOPY), int(ShapeType.DOME)}:
        ldir = vm.safe_normalize(vm.world_to_object_normal(rot, d))
        if int(ShapeType.CANOPY) in present:
            uv_vals[int(ShapeType.CANOPY)] = env_sampling.canopy_uv(ldir)
        if int(ShapeType.DOME) in present:
            uv_vals[int(ShapeType.DOME)] = env_sampling.dome_uv(ldir)

    n = select_by_shape(shape, n_vals, -d)
    uv = select_by_shape(shape, uv_vals, torch.zeros_like(p[:, :2])) if need_uv else None
    tangent = bitangent = None
    if need_tangents:
        if t_vals:
            tangent = select_by_shape(shape, t_vals, None)
            bitangent = select_by_shape(shape, b_vals, None)
        else:
            tangent, bitangent = vm.orthonormal_basis(n)
    inf_types = present & {int(ShapeType.CANOPY), int(ShapeType.DOME), int(ShapeType.DISTANT)}
    if inf_types:
        is_inf = functools.reduce(torch.logical_or, [shape == st for st in sorted(inf_types)])
        p = torch.where(is_inf[:, None], RAY_MAX_T * d, p)
    geo_n = n

    if scene.meshes is not None:
        is_mesh = ((shape == int(ShapeType.TRIANGLE_MESH)) & (hit.prim >= 0))[:, None]
        # a curve's or point's prim indexes its own arena: read row 0 there
        ri = torch.where(is_mesh[:, 0], hit.prim, 0).long()
        row = scene.meshes.attr_rows[ri]
        e1, e2 = row[:, 3:6], row[:, 6:9]
        if scene.meshes.attr_rows_d is not None and time is not None:
            # a deforming mesh: the edges at the lane's shutter time (the
            # geometric normal follows; the shading normals stay frame 0's)
            row_d = scene.meshes.attr_rows_d[ri]
            e1 = fma(time[:, None], row_d[:, 3:6], e1)
            e2 = fma(time[:, None], row_d[:, 6:9], e2)
        gn_l = vm.safe_normalize(vm.cross(e1, e2))
        u, v = hit.u[:, None], hit.v[:, None]
        w0 = (1.0 - hit.u - hit.v)[:, None]
        tn = oct_normal_unpack(row[:, 9:12].contiguous().view(torch.int32))  # [N, 3, 3]
        ns_l = fma(v, tn[:, 2], fma(w0, tn[:, 0], u * tn[:, 1]))
        # normals turn by the rotation only (the reference's uniform-scale
        # assumption, composed_transformation.zig objectToWorldNormal)
        geo_n = torch.where(is_mesh, vm.safe_normalize(vm.object_to_world_normal(rot, gn_l)), geo_n)
        ns_w = vm.safe_normalize(vm.object_to_world_normal(rot, ns_l))
        n = torch.where(is_mesh, ns_w, n)
        if need_uv:
            uv_m = fma(v, row[:, 16:18], fma(w0, row[:, 12:14], u * row[:, 14:16]))
            uv = torch.where(is_mesh, uv_m, uv)
        if need_tangents:
            mt, mb = vm.orthonormal_basis(ns_w)
            tangent = torch.where(is_mesh, mt, tangent)
            bitangent = torch.where(is_mesh, mb, bitangent)
    if scene.curves is not None:
        is_curve = ((shape == int(ShapeType.CURVES)) & (hit.prim >= 0))[:, None]
        seg = segment_fields(scene.curves, torch.where(is_curve[:, 0], hit.prim, 0))
        s_ax = hit.u
        o_l = vm.world_to_object_point(rot, scale, pos, o)
        d_l = vm.world_to_object_vector(rot, scale, d)
        p_l = fma(hit.t[:, None], d_l, o_l)
        c_l = fma(s_ax[:, None], seg["pb"] - seg["pa"], seg["pa"])
        r_l = torch.clamp(fma(s_ax, seg["rb"] - seg["ra"], seg["ra"]), min=1e-9)
        t_l = vm.safe_normalize(seg["pb"] - seg["pa"])
        # the offset across the strand, in the plane seen from the ray
        b_view = vm.safe_normalize(vm.cross(t_l, -d_l))
        hh = torch.clamp(vm.dot(p_l - c_l, b_view) / r_l, -1.0, 1.0)
        cn_w = vm.safe_normalize(vm.object_to_world_normal(rot, vm.safe_normalize(p_l - c_l)))
        geo_n = torch.where(is_curve, cn_w, geo_n)
        n = torch.where(is_curve, cn_w, n)
        if need_tangents:
            ct_w = vm.safe_normalize(vm.object_to_world_normal(rot, t_l))
            tangent = torch.where(is_curve, ct_w, tangent)
            bitangent = torch.where(is_curve, vm.safe_normalize(vm.cross(cn_w, ct_w)), bitangent)
        if need_uv:
            cu = fma(s_ax, seg["u1"] - seg["u0"], seg["u0"])
            uv = torch.where(is_curve, torch.stack([cu, 0.5 * (hh + 1.0)], dim=-1), uv)
    if scene.points is not None:
        is_point = ((shape == int(ShapeType.POINTS)) & (hit.prim >= 0))[:, None]
        tlp = torch.zeros_like(hit.t) if time is None else time
        pc, _ = point_center(scene.points, torch.where(is_point[:, 0], hit.prim, 0), tlp)
        o_l = vm.world_to_object_point(rot, scale, pos, o)
        p_l = fma(hit.t[:, None], vm.world_to_object_vector(rot, scale, d), o_l)
        pn_w = vm.safe_normalize(vm.object_to_world_normal(rot, vm.safe_normalize(p_l - pc)))
        geo_n = torch.where(is_point, pn_w, geo_n)
        n = torch.where(is_point, pn_w, n)
        if need_tangents:
            pt_t, pt_b = vm.orthonormal_basis(pn_w)
            tangent = torch.where(is_point, pt_t, tangent)
            bitangent = torch.where(is_point, pt_b, bitangent)
    # a portal's rectangle emits the linked dome's map, read at the ray
    # direction's dome uv (ref scene.zig lightPortalUvw)
    if uv is not None:
        for (_, pp), pd in sorted((scene.portals or {}).items()):
            uv = torch.where((hit.prop == pp)[:, None], portal.dome_uv_of_dir(pd.dome_rot, d), uv)
    return Fragment(p=p, geo_n=geo_n, n=n, material=scene.prop_material[prop], uv=uv,
                    t=tangent, b=bitangent, prop=hit.prop)
