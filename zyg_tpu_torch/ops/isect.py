"""Closest-hit / any-hit over the static analytic props (counterpart of
zyg_tpu/ops/isect.py). Kernel: csrc/isect.cu; `prop_hit` (csrc/prop_hit.cuh)
is shared with the fused bounce (ops/shade.py). The mesh path
(scene/shapes.py) runs it over the analytic props before the mesh
traversal, with tables packed once per render (`prop_table`).

Formulas are the JAX package's, in the same operation order, written in
component form so the plain version and the kernel round alike.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import check_cuda, register, stream_handle
from ..core.fmath import dot3
from ..scene.types import RAY_MAX_T, ShapeType

FAR = 3.0e37
MAX_PROPS = 64

_KERNEL = register(
    "isect",
    "zyg_isect",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int64,
     ctypes.c_void_p],
)

SUPPORTED = {int(s) for s in (ShapeType.CANOPY, ShapeType.CUBE, ShapeType.DISK,
                               ShapeType.DISTANT, ShapeType.DOME, ShapeType.RECTANGLE,
                               ShapeType.SPHERE)}


def prop_hit(kind: int, r, ox, oy, oz, dx, dy, dz, tmin, tmax):
    """One prop's (t, u, v, hit); r is its table row (float32 tensor,
    rot row-major [0:9], pos [9:12], scale [12:15]).

    Dot products are fused accumulations and divisions by the prop's
    scale are multiplications by its reciprocal: the rounding XLA gives
    the JAX package's shapes.py (which folds the scene's constants)."""
    r = [r[k] for k in range(15)]
    px, py, pz = r[9], r[10], r[11]
    sx, sy, sz = r[12], r[13], r[14]
    zero = torch.zeros_like(ox)
    if kind in (ShapeType.RECTANGLE, ShapeType.DISK):
        dd = dot3(r[6], dx, r[7], dy, r[8], dz)
        dist = dot3(r[6], px, r[7], py, r[8], pz)
        no = dot3(r[6], ox, r[7], oy, r[8], oz)
        t = -(no - dist) / torch.where(torch.abs(dd) < 1e-20, 1e-20, dd)
        kx = ox + t * dx - px
        ky = oy + t * dy - py
        kz = oz + t * dz - pz
        if kind == ShapeType.RECTANGLE:
            u = -dot3(r[0], kx, r[1], ky, r[2], kz) * (1.0 / (0.5 * sx))
            v = -dot3(r[3], kx, r[4], ky, r[5], kz) * (1.0 / (0.5 * sy))
            hit = (t >= tmin) & (t <= tmax) & (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0)
        else:
            l2 = dot3(kx, kx, ky, ky, kz, kz)
            rr = 0.5 * sx
            hit = (t >= tmin) & (t <= tmax) & (l2 <= rr * rr)
            inv_r = 1.0 / torch.clamp(rr, min=1e-20)
            u = -dot3(r[0], kx, r[1], ky, r[2], kz) * inv_r
            v = -dot3(r[3], kx, r[4], ky, r[5], kz) * inv_r
        return torch.where(hit, t, FAR), u, v, hit
    if kind == ShapeType.SPHERE:
        vx, vy, vz = px - ox, py - oy, pz - oz
        b = dot3(dx, vx, dy, vy, dz, vz)
        rx, ry, rz = vx - b * dx, vy - b * dy, vz - b * dz
        rr = 0.5 * sx
        disc = rr * rr - dot3(rx, rx, ry, ry, rz, rz)
        ok = disc > 0.0
        dist = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = b - dist
        t1 = b + dist
        sel0 = ok & (t0 >= tmin) & (t0 <= tmax)
        sel1 = ok & ~sel0 & (t1 >= tmin) & (t1 <= tmax)
        t = torch.where(sel0, t0, torch.where(sel1, t1, FAR))
        return t, zero, zero, sel0 | sel1
    if kind == ShapeType.CUBE:
        wx, wy, wz = ox - px, oy - py, oz - pz
        inv_s = (1.0 / sx, 1.0 / sy, 1.0 / sz)
        near, far = [], []
        for a in range(3):
            lo_a = dot3(wx, r[3 * a], wy, r[3 * a + 1], wz, r[3 * a + 2]) * inv_s[a]
            ld_a = dot3(dx, r[3 * a], dy, r[3 * a + 1], dz, r[3 * a + 2]) * inv_s[a]
            inv = 1.0 / torch.where(
                torch.abs(ld_a) < 1e-20, torch.where(ld_a < 0, -1e-20, 1e-20), ld_a
            )
            t_a = (-0.5 - lo_a) * inv
            t_b = (0.5 - lo_a) * inv
            near.append(torch.minimum(t_a, t_b))
            far.append(torch.maximum(t_a, t_b))
        tn = torch.maximum(torch.maximum(near[0], near[1]), near[2])
        tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
        hit_near = (tn <= tf) & (tn >= tmin) & (tn <= tmax)
        hit_far = (tn <= tf) & ~hit_near & (tf >= tmin) & (tf <= tmax)
        t = torch.where(hit_near, tn, torch.where(hit_far, tf, FAR))
        return t, zero, zero, hit_near | hit_far
    if kind == ShapeType.DISTANT:
        b = dot3(r[6], dx, r[7], dy, r[8], dz)
        nn = dot3(r[6], r[6], r[7], r[7], r[8], r[8])
        radius = sx
        det = b * b - nn + radius * radius
        hit = (b <= 0.0) & (tmax >= RAY_MAX_T) & (radius > 0.0) & (det >= 0.0)
        kx, ky, kz = dx - r[6], dy - r[7], dz - r[8]
        inv_r = 1.0 / torch.clamp(radius, min=1e-20)
        u = dot3(r[0], kx, r[1], ky, r[2], kz) * inv_r
        v = dot3(r[3], kx, r[4], ky, r[5], kz) * inv_r
        return torch.where(hit, RAY_MAX_T, FAR), u, v, hit
    cz = dot3(r[6], dx, r[7], dy, r[8], dz)
    if kind == ShapeType.CANOPY:
        hit = (tmax >= RAY_MAX_T) & (cz >= -0.0005)
    else:  # dome
        hit = (cz > -2.0) & (tmax >= RAY_MAX_T)
    return torch.where(hit, RAY_MAX_T, FAR), zero, zero, hit


def static_layout(scene):
    """(kind codes, concatenated prop ids) over the shape groups in
    ascending shape order — the row order of every prop table."""
    kinds, idx = [], []
    for st, ids in sorted(scene.prop_groups.items()):
        if int(st) not in SUPPORTED:
            raise ValueError(f"shape type {int(st)} has no analytic hit test")
        kinds.extend([int(st)] * int(ids.shape[0]))
        idx.append(ids.to(torch.int64))
    if not kinds or len(kinds) > MAX_PROPS:
        raise ValueError(f"{len(kinds)} analytic props (1..{MAX_PROPS} supported)")
    return kinds, torch.cat(idx)


def pack_table(scene, ids: torch.Tensor, ray_class: str) -> torch.Tensor:
    """[P, 17]: rot 9 | pos 3 | scale 3 | visible to camera | visible to ray_class."""
    vis = {
        "camera": scene.prop_visible_camera,
        "reflection": scene.prop_visible_reflection,
        "shadow": scene.prop_visible_shadow,
    }[ray_class]
    p = ids.shape[0]
    return torch.cat([
        scene.prop_rot[ids].reshape(p, 9),
        scene.prop_pos[ids],
        scene.prop_scale[ids],
        scene.prop_visible_camera[ids].to(torch.float32)[:, None],
        vis[ids].to(torch.float32)[:, None],
    ], dim=1).contiguous()


@dataclass
class PropTable:
    """A scene's analytic props packed for one ray class."""

    ray_class: str  # "camera", "reflection" or "shadow"
    kinds: list  # ShapeType codes in table order
    kinds_t: torch.Tensor  # int32[P] the same codes, on the table's device
    ids: torch.Tensor  # int32[P] prop id of each row
    table: torch.Tensor  # float32[P, 17] (pack_table)


def prop_table(scene, ray_class: str) -> PropTable:
    """The scene's analytic props for ray_class, packed once per render."""
    kinds, ids = static_layout(scene)
    table = pack_table(scene, ids, ray_class)
    kinds_t = torch.tensor(kinds, dtype=torch.int32, device=table.device)
    return PropTable(ray_class, kinds, kinds_t, ids.to(torch.int32), table)


def _lanes(o, d, tmax):
    n = o.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(n).contiguous()
    return n, tmax


def isect_plain(kinds, table, ids, o, d, tmin, tmax, primary, any_hit: bool):
    """Plain torch version: a loop over the props with the kernel's formulas."""
    n, tmax = _lanes(o, d, tmax)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    t_b = torch.full((n,), FAR, dtype=torch.float32, device=o.device)
    slot_b = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    u_b = torch.zeros_like(t_b)
    v_b = torch.zeros_like(t_b)
    blocked = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for p, kind in enumerate(kinds):
        row = table[p]
        t, u, v, hit = prop_hit(kind, row, ox, oy, oz, dx, dy, dz, tmin, tmax)
        if primary is not None:
            vis = torch.where(primary, row[15], row[16]) > 0.5
        else:
            vis = row[16] > 0.5
        hit = hit & vis
        if any_hit:
            blocked = blocked | hit
            continue
        closer = hit & (t < t_b)
        t_b = torch.where(closer, t, t_b)
        slot_b = torch.where(closer, p, slot_b)
        u_b = torch.where(closer, u, u_b)
        v_b = torch.where(closer, v, v_b)
    if any_hit:
        return blocked
    pid = torch.where(slot_b >= 0, ids[slot_b.clamp(min=0)], -1).to(torch.int32)
    return t_b, pid, u_b, v_b


def _isect_cuda(pt: PropTable, o, d, tmin, tmax, primary, any_hit: bool):
    dev = o.device
    n, tmax = _lanes(o, d, tmax)
    p = len(pt.kinds)
    check_cuda("isect.table", pt.table, torch.float32, dev, (p, 17))
    check_cuda("isect.kinds", pt.kinds_t, torch.int32, dev, (p,))
    check_cuda("isect.ids", pt.ids, torch.int32, dev, (p,))
    check_cuda("isect.o", o, torch.float32, dev, (n, 3))
    check_cuda("isect.d", d, torch.float32, dev, (n, 3))
    if primary is not None:
        check_cuda("isect.primary", primary, torch.bool, dev, (n,))
    if any_hit:
        outs = [torch.empty((n,), dtype=torch.bool, device=dev)]
    else:
        outs = [torch.empty((n,), dtype=torch.float32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((n,), dtype=torch.float32, device=dev),
                torch.empty((n,), dtype=torch.float32, device=dev)]
    ptrs = [pt.table.data_ptr(), pt.kinds_t.data_ptr(), pt.ids.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmax.data_ptr(), primary.data_ptr() if primary is not None else None]
    ptrs += [x.data_ptr() for x in outs]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    if n > 0:
        _KERNEL(arr, int(any_hit), float(tmin), p, n, stream_handle(dev))
    return outs[0] if any_hit else tuple(outs)


def _isect(pt: PropTable, o, d, tmin, tmax, primary, any_hit):
    if o.device.type == "cpu":
        return isect_plain(pt.kinds, pt.table, pt.ids, o, d, tmin, tmax, primary, any_hit)
    return _isect_cuda(pt, o, d, tmin, tmax, primary, any_hit)


def closest_props(table: PropTable, o, d, tmin, tmax, primary=None):
    """Closest hit over the props of table (a prop_table of the scene):
    (t, prop id or -1, u, v). primary: bool[N] lanes that test camera
    visibility instead of the table's ray class's."""
    return _isect(table, o, d, tmin, tmax, primary, False)


def anyhit_props(table: PropTable, o, d, tmin, tmax):
    """Any-hit over the props of table (the scene's prop_table("shadow")):
    blocked bool[N]."""
    return _isect(table, o, d, tmin, tmax, None, True)
