"""Point clouds: sphere particles over a binary threaded BVH (counterpart
of zyg_tpu/scene/points.py; ref shape/point/).

Host side, numpy: a cloud is its points' shutter-open centers and radii,
and for a moving cloud its shutter-close centers; a particle exporter's
frame stack (ref point_motion_data.zig) is sampled at the frame's shutter
by `resolve_motion`. `build_arena` packs every cloud of the scene into
one arena, the JAX package's arrays element for element:

- node_rows[M, 12]: min(3) max(3) hit link, miss link, leaf group (-1
  for an inner node), point count, pad(2), in the threaded layout of
  scene/bvh.py (LEAF_SIZE points a leaf);
- point_rows[G, 32]: a leaf's 4 points, each p0(3) radius p1(3) pad;
  padding points have radius -1 and never hit;
- cloud_root[K]: each cloud's root node.

The walk (`traverse`) follows the hit and miss links from a cloud's root
in object space, tests a leaf's points in slot order with the stable
quadratic (`sphere_test`), bounded by the running best t, and lerps a
moving point's center by the ray's shutter time. Here is its plain torch
version; ops/points.py launches the CUDA kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma, sqrt
from .bvh import build_bvh
from .types import to_device

LEAF_SIZE = 4  # zyg_tpu/scene/bvh.py LEAF_SIZE: points a leaf
POINT_F = 8  # floats a packed point: p0(3) r p1(3) pad


class HostPoints(NamedTuple):
    positions: np.ndarray  # [P, 3] shutter-open centers
    radii: np.ndarray  # [P]
    positions_end: np.ndarray | None = None  # [P, 3] shutter-close centers
    # a particle exporter's frame stack, sampled by resolve_motion
    position_frames: np.ndarray | None = None  # [F, P, 3]
    radius_frames: np.ndarray | None = None  # [F, P]
    fps: float = 0.0  # simulation frames a second
    start_frame: int = 0


def resolve_motion(cloud: HostPoints, t0: float, t1: float) -> HostPoints:
    """A frame-stack cloud sampled at the shutter [t0, t1] seconds (ref
    point_motion_data.zig positionAndRadiusAt; zyg_tpu/scene/points.py:42):
    time t is simulation frame x = t * fps - start_frame, centers lerp
    between the two frames around it (in float32, in the JAX package's
    order), radii take the shutter-open frame's (a radius 0 hides a dead
    particle). A cloud without a stack is returned as it is."""
    if cloud.position_frames is None:
        return cloud
    pf = np.asarray(cloud.position_frames, np.float32)
    F = pf.shape[0]

    def sample(t):
        x = t * cloud.fps - cloud.start_frame
        i = int(np.clip(np.floor(x), 0, max(F - 2, 0)))
        frac = np.float32(np.clip(x - i, 0.0, 1.0))
        if F == 1:
            return pf[0], 0
        return (1.0 - frac) * pf[i] + frac * pf[min(i + 1, F - 1)], i

    p0, i0 = sample(t0)
    p1, _ = sample(t1)
    radii = (np.asarray(cloud.radius_frames, np.float32)[i0] if cloud.radius_frames is not None
             else cloud.radii)
    return HostPoints(positions=p0, radii=radii, positions_end=p1 if t1 > t0 else None)


@dataclass
class PointArena:
    """Every point cloud of a scene (layouts in the module docstring)."""

    node_rows: torch.Tensor  # float32[M, 12]
    point_rows: torch.Tensor  # float32[G, 32]
    cloud_root: torch.Tensor  # int32[K]
    has_motion: bool = False  # a cloud has shutter-close centers

    def to(self, device) -> "PointArena":
        return to_device(self, device)


def leaf_scatter(bvh, rows: np.ndarray, pad: np.ndarray, group_off: int):
    """(packed leaf rows [G, LEAF_SIZE * F], node rows [M, 12], padded
    source index [G * LEAF_SIZE] (-1 on padding)) of one shape's binary
    tree: each leaf's primitive rows (rows[prim_order], [P, F]) moved to
    LEAF_SIZE-aligned slots of its group, the rest `pad`; leaf groups
    numbered from group_off (zyg_tpu/scene/points.py:121-155, shared by
    scene/curves.py)."""
    first, cnt = bvh.first_prim, bvh.prim_count
    leaf_nodes = np.flatnonzero(first >= 0)
    g_first = first[leaf_nodes].astype(np.int64)
    g_cnt = cnt[leaf_nodes].astype(np.int64)
    num_groups = len(leaf_nodes)
    total = int(g_cnt.sum())
    within = np.arange(total) - np.repeat(np.cumsum(g_cnt) - g_cnt, g_cnt)
    src = np.repeat(g_first, g_cnt) + within
    dst = np.repeat(np.arange(num_groups) * LEAF_SIZE, g_cnt) + within
    packed = np.tile(pad.astype(np.float32), (num_groups * LEAF_SIZE, 1))
    packed[dst] = rows[src]
    src_of = np.full(num_groups * LEAF_SIZE, -1, np.int64)
    src_of[dst] = src
    m = bvh.nodes_min.shape[0]
    group_of_node = np.full(m, -1.0, np.float32)
    group_of_node[leaf_nodes] = np.arange(num_groups) + group_off
    node = np.zeros((m, 12), np.float32)
    node[:, 0:3] = bvh.nodes_min
    node[:, 3:6] = bvh.nodes_max
    node[:, 8] = group_of_node
    node[:, 9] = cnt
    return packed.reshape(num_groups, -1), node, src_of


def link_rows(node: np.ndarray, bvh, node_off: int) -> np.ndarray:
    """node rows with the hit and miss links offset into the arena."""
    node[:, 6] = np.where(bvh.hit_link >= 0, bvh.hit_link + node_off, -1)
    node[:, 7] = np.where(bvh.miss_link >= 0, bvh.miss_link + node_off, -1)
    return node


def build_arena(clouds: list[HostPoints], device: torch.device | str = "cpu") -> PointArena:
    """One arena over every cloud (zyg_tpu/scene/points.py:103): a binary
    SAH tree per cloud over the points' boxes across the shutter."""
    all_rows, all_pt = [], []
    roots = []
    node_off = group_off = 0
    pad = np.zeros(POINT_F, np.float32)
    pad[3] = -1.0  # padding: a negative radius never hits
    for cloud in clouds:
        p0 = np.asarray(cloud.positions, np.float32)
        r = np.asarray(cloud.radii, np.float32)
        p1 = np.asarray(cloud.positions_end, np.float32) if cloud.positions_end is not None else p0
        bvh = build_bvh(np.minimum(p0, p1) - r[:, None], np.maximum(p0, p1) + r[:, None],
                        LEAF_SIZE)
        order = bvh.prim_order
        rows = np.concatenate([p0[order], r[order, None], p1[order],
                               np.zeros((len(order), 1), np.float32)], axis=1).astype(np.float32)
        packed, node, _ = leaf_scatter(bvh, rows, pad, group_off)
        all_rows.append(link_rows(node, bvh, node_off))
        all_pt.append(packed)
        roots.append(node_off)
        node_off += node.shape[0]
        group_off += packed.shape[0]
    return PointArena(
        node_rows=torch.as_tensor(np.concatenate(all_rows), device=device),
        point_rows=torch.as_tensor(np.concatenate(all_pt), device=device),
        cloud_root=torch.as_tensor(np.array(roots, np.int32), device=device),
        has_motion=any(c.positions_end is not None for c in clouds),
    )


def inv_dir(d):
    """1 / d with |d| < 1e-20 clamped to +-1e-20 (the walks' slab test)."""
    return 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)


def slab(row, o, inv, tmin, tb):
    """The node rows' AABB test of the walks: entered, bounded by tb."""
    t0 = (row[:, 0:3] - o) * inv
    t1 = (row[:, 3:6] - o) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf >= tmin) & (tn <= tb)


def sphere_test(o, d, c, r, tmin, tmax):
    """Stable ray-sphere (t, hit) (zyg_tpu/scene/points.py:179), rounded as
    XLA rounds the JAX walk: the dot products are fused chains, and each
    product feeding a sum is fused into it."""
    L = c - o
    b = vm.dot(L, d)
    d2 = vm.dot(d, d)
    det = fma(b, b, -(d2 * fma(-r, r, vm.dot(L, L))))
    ok = (det >= 0.0) & (r > 0.0)
    sq = sqrt(torch.clamp(det, min=0.0))
    den = torch.clamp(d2, min=1e-20)
    t0 = (b - sq) / den
    t1 = (b + sq) / den
    t = torch.where((t0 >= tmin) & (t0 <= tmax), t0, t1)
    return t, ok & (t >= tmin) & (t <= tmax)


def count_steps(counts: dict, ids, ptr, leaf, group) -> None:
    """One step of a plain walk (this module's and scene/curves.py's
    traverse) into counts: lanes ids at node rows ptr, of which the ones
    at positions leaf test leaf groups group[leaf]. The plain loop steps
    every walking lane once an iteration, as a thread a lane would, so the
    groups of 32 lane ids with a lane in leaf are the warp-steps of that
    mapping that run the leaf branch."""
    counts["nodes"] += ids.numel()
    counts["leaves"] += leaf.numel()
    if "node_seen" in counts:
        counts["node_seen"][ptr] = True
    if "leaf_seen" in counts:
        counts["leaf_seen"][group[leaf]] = True
    if "lane_steps" in counts:
        counts["lane_steps"][ids] += 1
        counts["leaf_warp_steps"] = (counts.get("leaf_warp_steps", 0)
                                     + torch.unique(ids[leaf] // 32).numel())


def traverse(arena: PointArena, root, o, d, tmin: float, tmax, time=None, any_hit: bool = False,
             counts: dict | None = None):
    """(t [N], prim [N] int32: padded arena point group*4 + slot, -1 on a
    miss) of rays o, d [N, 3] (object space) walking from root [N]
    (int32, -1: the lane does not walk) over [tmin, tmax [N]]; t starts at
    tmax. time [N]: the rays' shutter times, read where the arena moves.
    Any-hit stops a ray at its first hit. The lanes still walking step
    together; counts ({"nodes": 0, "leaves": 0}), if given, accumulates
    the node rows visited and the leaf rows tested, and marks the rows in
    bool tensors under "node_seen" [M] and "leaf_seen" [G] where it holds
    them. Where it holds "lane_steps" (int64 [N]) it adds each lane's node
    steps there, and under "leaf_warp_steps" the warp-steps of a thread a
    lane (lanes in groups of 32) in which a lane of the group tests a leaf
    (count_steps)."""
    dev = o.device
    n = o.shape[0]
    t = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    inv = inv_dir(d)
    ids = torch.nonzero(root >= 0).squeeze(1)
    ptr = root[ids].long()
    motion = arena.has_motion
    while ids.numel():
        oo, ii = o[ids], inv[ids]
        row = arena.node_rows[ptr]
        hit = slab(row, oo, ii, tmin, t[ids])
        group = row[:, 8].long()
        leaf = torch.nonzero(hit & (group >= 0)).squeeze(1)
        if counts is not None:
            count_steps(counts, ids, ptr, leaf, group)
        if leaf.numel():
            lid = ids[leaf]
            g = group[leaf]
            pt = arena.point_rows[g].reshape(-1, LEAF_SIZE, POINT_F)
            cnt = row[leaf, 9].long()
            tb, pb = t[lid], prim[lid]
            c = pt[..., 0:3]
            if motion:
                c = fma(time[lid][:, None, None], pt[..., 4:7] - c, c)
            # the leaf's points at once, bounded by the best t on entry: a
            # slot then takes the hit where it is within the running best,
            # which is what testing the slots in turn gives
            tt, h = sphere_test(oo[leaf, None], d[lid, None], c, pt[..., 3], tmin, tb[:, None])
            for j in range(LEAF_SIZE):
                hj = h[:, j] & (tt[:, j] <= tb) & (j < cnt)
                tb = torch.where(hj, tt[:, j], tb)
                pb = torch.where(hj, g * LEAF_SIZE + j, pb)
            t[lid], prim[lid] = tb, pb
        nxt = torch.where(hit, row[:, 6], row[:, 7]).long()
        keep = nxt >= 0
        if any_hit:
            keep = keep & (prim[ids] < 0)
        ids, ptr = ids[keep], nxt[keep]
    return t, prim.to(torch.int32)


def point_center(arena: PointArena, prim, time=None):
    """(center [N, 3], radius [N]) of arena point prim (>= 0) at the
    shutter times time [N] (zyg_tpu/scene/points.py:306)."""
    pr = prim.long()
    pt = arena.point_rows.reshape(-1, POINT_F)[pr]
    c = pt[:, 0:3]
    if arena.has_motion and time is not None:
        c = fma(time[:, None], pt[:, 4:7] - c, c)
    return c, pt[:, 3]
