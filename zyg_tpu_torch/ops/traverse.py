"""Closest-hit and any-hit over the mesh instances: the instance walk and
the 8-wide BLAS traversal (counterpart of zyg_tpu/scene/trimesh.py:544-935
`_tri_test`, `traverse`, `_traverse_stage` and :1053 `intersect_instances`).
Kernel: csrc/traverse.cu. The JAX package walks the BVH in XLA; on the
card it is this port's own kernel: persistent warps that take rays from a
counter, one ray per lane at a time, reading the arena rows as 16-byte
loads (the wrapper checks the arena's alignment). On a table of 8
instances or more a warp serves the instance picks of its lanes one ray
at a time with all of its threads over the instance arrays (a lane alone
where more of its lanes pick at once than that pays for); on a smaller
table each lane picks alone (csrc/traverse.cu tells why).

The walk, per ray (the JAX package's, so both pick the same triangle):
- instances in strict (entry t, index) order: the nearest world AABB
  entry not yet visited and before the best hit so far; the ray goes to
  object space by the instance's quaternion, position and scale (its
  direction is not renormalized, so t stays in world units) and walks
  that instance's BLAS bounded by the best t;
- at a wide node: slab-test the 8 children, key each eligible child by
  (entry-t bits & ~7) | slot, descend into the smallest key and push the
  rest as ONE continuation: a direct child ref (2*ref + 1) when one child
  remains, else (node*256 + remaining mask)*2, whose resume re-tests the
  node against the shrunken best t. The stack never holds more than the
  tree depth + 1 entries;
- at a leaf: Moller-Trumbore over its 12 triangles; the lowest slot wins
  a tie inside the leaf, and a hit replaces the best only if strictly
  closer (the first leaf visited wins a tie across leaves); then pop.
Any-hit stops at the first hit. The hit record is (t, u, v, padded arena
triangle id group*12 + j, prop id).

Rounding follows XLA's on the JAX package's jitted traversal (probed):
dot products are fused chains, cross products fuse their first product
(core/vecmath.py); the slab tests and the leaf's barycentric scales are
plain multiplies.

The plain version below walks all rays together in torch, keeping only
the rays still walking (no compaction cascade: that exists for XLA's
while loop).

Motion blur: a table with a moving instance (InstanceTable.has_anim)
takes each ray's shutter time, and the ray enters an instance by its
transform at that time, the start and end rows slerped and lerped
(core/vecmath.py quat_slerp, lerp; zyg_tpu/scene/trimesh.py:1145-1155).
On the card that is the kernel's kAnim variant (traverse_anim). A moving
table without times raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..core import vecmath as vm
from ..scene.trimesh import BRANCH, LEAF_SIZE

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int64, ctypes.c_void_p]
_KERNEL = register("traverse", "zyg_traverse", _ARGS)
_KERNEL_ANIM = register("traverse_anim", "zyg_traverse_anim", _ARGS)

MAX_STACK = 32  # csrc/traverse.cu TRAV_MAX_STACK: arenas up to depth 31
_MISS_KEY = 0x7F800000  # +inf bits: sorts after every hit key
_BIG = 3.4e38
_VIS = {"camera": 0, "reflection": 1, "shadow": 2}
_MAX_ITERS = 65536  # the JAX walk's iteration fuse (NaN rays)

_errors: dict = {}  # device -> int32[1] error flags of launched walks


def _inv_dir(d):
    return 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)


def _tri_test(o, d, p0, e1, e2, tmin, tmax):
    """Moller-Trumbore on precomputed (p0, e1, e2). Returns (t, u, v, hit)."""
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = o - p0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin) & (t <= tmax)
           & (det.abs() > 1e-12))
    return t, u, v, hit


def _blas_plain(arena, root, o, d, tmin, tmax, any_hit: bool, counts: dict | None):
    """Walk each ray's BLAS from root (int64[N], all >= 0) in object space.
    Returns (t, prim, u, v); t starts at tmax and only shrinks. counts, if
    given, accumulates the node and leaf rows visited."""
    dev = o.device
    n = root.shape[0]
    B = BRANCH
    stack_d = arena.max_depth + 1
    rows_all, trows = arena.node_rows, arena.tri_rows
    out_t = tmax.clone()
    out_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(n, device=dev)
    out_v = torch.zeros(n, device=dev)
    inv = _inv_dir(d)
    iota = torch.arange(B, device=dev)
    full = (1 << B) - 1
    # state of the rays still walking; lane k walks ray ids[k]
    ids = torch.arange(n, device=dev)
    node, mask = root.clone(), torch.full((n,), full, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, stack_d), dtype=torch.int64, device=dev)
    t, prim, u, v = out_t.clone(), out_prim.clone(), out_u.clone(), out_v.clone()
    for _ in range(_MAX_ITERS):
        if ids.numel() == 0:
            break
        oo, dd, ii = o[ids], d[ids], inv[ids]
        need_pop = torch.zeros_like(ids, dtype=torch.bool)
        done = torch.zeros_like(need_pop)

        # ---- node phase: nearest eligible child, push the rest
        a = torch.nonzero(node >= 0).squeeze(1)
        if counts is not None:
            counts["nodes"] += a.numel()
        if a.numel():
            row = rows_all[node[a]]
            oa, ia = oo[a], ii[a]
            lox = (row[:, 0 * B : 1 * B] - oa[:, 0:1]) * ia[:, 0:1]
            loy = (row[:, 1 * B : 2 * B] - oa[:, 1:2]) * ia[:, 1:2]
            loz = (row[:, 2 * B : 3 * B] - oa[:, 2:3]) * ia[:, 2:3]
            hix = (row[:, 3 * B : 4 * B] - oa[:, 0:1]) * ia[:, 0:1]
            hiy = (row[:, 4 * B : 5 * B] - oa[:, 1:2]) * ia[:, 1:2]
            hiz = (row[:, 5 * B : 6 * B] - oa[:, 2:3]) * ia[:, 2:3]
            near = torch.maximum(torch.maximum(torch.minimum(lox, hix), torch.minimum(loy, hiy)),
                                 torch.minimum(loz, hiz))
            far = torch.minimum(torch.minimum(torch.maximum(lox, hix), torch.maximum(loy, hiy)),
                                torch.maximum(loz, hiz))
            refs = row[:, 6 * B : 7 * B]
            nearc = torch.clamp(torch.clamp(near, min=tmin), min=0.0)
            hit = (nearc <= far) & (refs != -1.0) & (nearc < t[a, None])
            elig = hit & (((mask[a, None] >> iota) & 1) != 0)
            tbits = (nearc.view(torch.int32) & ~(B - 1)).to(torch.int64)
            keys = torch.where(elig, tbits | iota, _MISS_KEY | iota)
            key_min = keys.min(dim=1).values
            valid = key_min < _MISS_KEY
            slot = key_min & (B - 1)
            cref = refs.gather(1, slot[:, None]).squeeze(1).to(torch.int64)
            keys2 = keys.scatter(1, slot[:, None], (_MISS_KEY | slot)[:, None])
            slot2 = keys2.min(dim=1).values & (B - 1)
            cref2 = refs.gather(1, slot2[:, None]).squeeze(1).to(torch.int64)
            remb = keys2 < _MISS_KEY
            rem = (remb.to(torch.int64) << iota).sum(dim=1)
            nrem = remb.sum(dim=1)
            push = valid & (nrem > 0)
            ent = torch.where(nrem == 1, cref2 * 2 + 1, (node[a] * 256 + rem) * 2)
            pa = a[push]
            if (sp[pa] >= stack_d).any():
                raise RuntimeError("traverse: continuation stack overflow")
            stack[pa, sp[pa]] = ent[push]
            sp[pa] += 1
            node[a] = torch.where(valid, cref, node[a])
            mask[a] = torch.where(valid, full, mask[a])
            need_pop[a] = ~valid

        # ---- leaf phase (rays that just descended into a leaf included):
        # test its 12 triangles, then pop
        lf = torch.nonzero(node <= -2).squeeze(1)
        if counts is not None:
            counts["leaves"] += lf.numel()
        if lf.numel():
            g = -node[lf] - 2
            tr = trows[g].reshape(-1, LEAF_SIZE, 9)
            tt, uu, vv, th = _tri_test(oo[lf, None, :], dd[lf, None, :], tr[..., 0:3],
                                       tr[..., 3:6], tr[..., 6:9], tmin, t[lf, None])
            tmask = torch.where(th, tt, _BIG)
            t16, jj = tmask.min(dim=1)
            found = t16 < t[lf]
            pick = jj[:, None]
            t[lf] = torch.where(found, t16, t[lf])
            prim[lf] = torch.where(found, g * LEAF_SIZE + jj, prim[lf])
            u[lf] = torch.where(found, uu.gather(1, pick).squeeze(1), u[lf])
            v[lf] = torch.where(found, vv.gather(1, pick).squeeze(1), v[lf])
            if any_hit:
                done[lf] = found
                need_pop[lf] = ~found
            else:
                need_pop[lf] = True

        # ---- pop: resume the innermost continuation, or finish
        p = torch.nonzero(need_pop).squeeze(1)
        can = sp[p] > 0
        done[p[~can]] = True
        p = p[can]
        sp[p] -= 1
        top = stack[p, sp[p]]
        direct = (top & 1) == 1
        even = top >> 1
        node[p] = torch.where(direct, (top - 1) >> 1, even // 256)
        mask[p] = torch.where(direct, full, even % 256)

        if done.any():
            fin = ids[done]
            out_t[fin], out_prim[fin] = t[done], prim[done]
            out_u[fin], out_v[fin] = u[done], v[done]
            keep = ~done
            ids, node, mask, sp, stack = ids[keep], node[keep], mask[keep], sp[keep], stack[keep]
            t, prim, u, v = t[keep], prim[keep], u[keep], v[keep]
    if ids.numel():
        raise RuntimeError(f"traverse: {ids.numel()} walks did not end in {_MAX_ITERS} steps")
    return out_t, out_prim, out_u, out_v


def traverse_plain(arena, itab, o, d, tmin: float, tmax, vis_col: int, primary, any_hit: bool,
                   counts: dict | None = None, time=None):
    """Plain torch version: the instance walk over per-round BLAS walks.
    Returns (t, prim, u, v, prop) for closest hit, blocked bool[N] for
    any-hit. counts ({"nodes": 0, "leaves": 0}), if given, accumulates the
    node and leaf rows the walks visited, and under "picks" the instance
    picks (each tests every instance box) and under "entries" the
    instances entered: the work a bound on the kernel's time counts.
    time: float32[N] shutter times, read where the table moves."""
    dev = o.device
    n = o.shape[0]
    ninst = itab.trafo.shape[0]
    inv = _inv_dir(d)
    t = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    prop = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last_t = torch.full((n,), -1.0, device=dev)
    last_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cont = torch.ones(n, dtype=torch.bool, device=dev)
    idx_i = torch.arange(ninst, device=dev)[:, None]
    vis = itab.vis[:, vis_col][:, None]
    if primary is not None:
        vis = torch.where(primary[None], itab.vis[:, 0][:, None], vis)
    for _ in range(ninst + 1):
        if not bool(cont.any()):
            break
        # nearest eligible instance strictly after (last_t, last_i)
        lo = (itab.wmin[:, None, :] - o[None]) * inv[None]
        hi = (itab.wmax[:, None, :] - o[None]) * inv[None]
        near = torch.minimum(lo, hi).amax(dim=-1)
        far = torch.maximum(lo, hi).amin(dim=-1)
        nearc = torch.clamp(torch.clamp(near, min=tmin), min=0.0)
        elig = ((nearc <= far) & vis & (nearc < t[None])
                & ((nearc > last_t[None]) | ((nearc == last_t[None]) & (idx_i > last_i[None]))))
        bt, bi = torch.where(elig, nearc, _BIG).min(dim=0)
        bi = torch.where(bt < _BIG, bi, -1)
        active = cont & (bi >= 0)
        if any_hit:
            active = active & (prim < 0)
        a = torch.nonzero(active).squeeze(1)
        if counts is not None:
            counts["picks"] = counts.get("picks", 0) + int(cont.sum())
            counts["entries"] = counts.get("entries", 0) + a.numel()
        if a.numel():
            row = itab.trafo[bi[a]]
            q, pos, scale = row[:, 0:4], row[:, 4:7], row[:, 7:10]
            if itab.has_anim:
                ta = time[a][:, None]
                q = vm.quat_slerp(q, row[:, 10:14], ta)
                pos = vm.lerp(pos, row[:, 14:17], ta)
                scale = vm.lerp(scale, row[:, 17:20], ta)
            rot = vm.quat_to_mat3(q)
            o_l = vm.world_to_object_point(rot, scale, pos, o[a])
            d_l = vm.world_to_object_vector(rot, scale, d[a])
            mt, mp, mu, mv = _blas_plain(arena, row[:, 20].to(torch.int64), o_l, d_l, tmin,
                                         t[a], any_hit, counts)
            closer = mp >= 0
            ca = a[closer]
            t[ca], prim[ca], u[ca], v[ca] = mt[closer], mp[closer], mu[closer], mv[closer]
            prop[ca] = row[closer, 21].to(torch.int64)
        last_t = torch.where(active, bt, last_t)
        last_i = torch.where(active, bi, last_i)
        cont = active
    if any_hit:
        return prim >= 0
    return t, prim.to(torch.int32), u, v, prop.to(torch.int32)


def _traverse_cuda(arena, itab, o, d, tmin: float, tmax, vis_col: int, primary, any_hit: bool,
                   time=None):
    dev = o.device
    n = o.shape[0]
    ninst = itab.trafo.shape[0]
    stack_d = arena.max_depth + 1
    if stack_d > MAX_STACK:
        raise ValueError(f"traverse: arena depth {arena.max_depth} needs a stack over {MAX_STACK}")
    check_cuda("traverse.node_rows", arena.node_rows, torch.float32, dev)
    check_cuda("traverse.tri_rows", arena.tri_rows, torch.float32, dev)
    check_cuda("traverse.wmin", itab.wmin, torch.float32, dev, (ninst, 3))
    check_cuda("traverse.wmax", itab.wmax, torch.float32, dev, (ninst, 3))
    check_cuda("traverse.trafo", itab.trafo, torch.float32, dev, (ninst, 24))
    check_cuda("traverse.vis", itab.vis, torch.bool, dev, (ninst, 3))
    check_cuda("traverse.o", o, torch.float32, dev, (n, 3))
    check_cuda("traverse.d", d, torch.float32, dev, (n, 3))
    check_cuda("traverse.tmax", tmax, torch.float32, dev, (n,))
    if primary is not None:
        check_cuda("traverse.primary", primary, torch.bool, dev, (n,))
    if itab.has_anim:
        check_cuda("traverse.time", time, torch.float32, dev, (n,))
    for name, rows in (("node_rows", arena.node_rows), ("tri_rows", arena.tri_rows)):
        if rows.data_ptr() % 16:
            raise ValueError(f"traverse.{name}: the kernel reads rows as 16-byte loads and needs "
                             "a 16-byte aligned tensor")
    if dev not in _errors:
        _errors[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    # the ray counter the kernel's warps take ray ids from (the entry point
    # zeroes it on the stream before the launch)
    next_ray = torch.empty(1, dtype=torch.int64, device=dev)
    if any_hit:
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]
    else:
        outs = [torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev)]
    ptrs = [arena.node_rows.data_ptr(), arena.tri_rows.data_ptr(), itab.wmin.data_ptr(),
            itab.wmax.data_ptr(), itab.trafo.data_ptr(), itab.vis.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmax.data_ptr(), primary.data_ptr() if primary is not None else None,
            _errors[dev].data_ptr(), next_ray.data_ptr()]
    ptrs += [x.data_ptr() for x in outs]
    if itab.has_anim:
        ptrs.append(time.data_ptr())
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    if n > 0:
        kernel = _KERNEL_ANIM if itab.has_anim else _KERNEL
        kernel(arr, ninst, vis_col, int(any_hit), stack_d, float(tmin), n, stream_handle(dev))
    return outs[0] if any_hit else tuple(outs)


def check_errors(device) -> None:
    """Raise if a walk launched on `device` stopped early: a stack
    overflow or a runaway walk (reads the device's error flag: a
    synchronizing read)."""
    flag = _errors.get(torch.device(device))
    if flag is not None and int(flag.item()) != 0:
        code = int(flag.item())
        flag.zero_()
        raise RuntimeError(f"traverse: a walk on the card stopped early (flags {code}: "
                           "1 = continuation stack overflow, 2 = runaway walk)")


def intersect_instances(arena, itab, o, d, tmin: float, tmax, ray_class: str = "reflection",
                        primary=None, any_hit: bool = False, time=None):
    """Closest hit (t, prim, u, v, prop; prim and prop -1 on a miss, t =
    tmax) or any-hit blocked bool[N] over the mesh instances; time
    (float32[N]): the rays' shutter times, which a table with a moving
    instance needs. The plain version for CPU tensors, the CUDA kernel
    for CUDA tensors; a kernel walk that stopped early is reported by
    check_errors(), which the caller runs where it synchronizes anyway."""
    n = o.shape[0]
    if itab.has_anim and time is None:
        raise ValueError("traverse: a table with moving instances needs the rays' shutter times")
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(n).contiguous()
    if o.device.type == "cpu":
        return traverse_plain(arena, itab, o, d, float(tmin), tmax, _VIS[ray_class], primary,
                              any_hit, time=time)
    return _traverse_cuda(arena, itab, o, d, float(tmin), tmax, _VIS[ray_class], primary,
                          any_hit, time=time)
