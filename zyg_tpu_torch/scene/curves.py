"""Curves (hair): cubic Beziers flattened into round-cone segments over a
binary threaded BVH (counterpart of zyg_tpu/scene/curves.py; ref
shape/curve/).

Host side, numpy: each Bezier of a curve set is cut into 2-16 segments by
how far its control polygon strays from its chord (`flatten_curves`),
and `build_arena` packs every curve set of the scene into one arena, the
JAX package's arrays element for element:

- node_rows[M, 12]: the threaded node rows of scene/points.py;
- seg_rows[G, 40]: a leaf's 4 segments, each pa(3) ra pb(3) rb u0 u1
  (the strand parameter at both ends); padding segments have radii -1
  and never hit;
- seg_strand[G * 4]: each padded segment's strand;
- curve_root[K]: each curve set's root node.

The walk (`traverse`) is the point walk's (scene/points.py) with the
rounded-cone test (`cone_test`: a cone body of linearly varying radius
and spherical caps, closed form) on the normalized direction, t rescaled
to the direction's length. Here is its plain torch version;
ops/curves.py launches the CUDA kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma, sqrt
from .bvh import build_bvh
from .points import LEAF_SIZE, inv_dir, leaf_scatter, link_rows, slab
from .types import to_device

SEG_F = 10  # floats a packed segment: pa(3) ra pb(3) rb u0 u1
_FAR = 3.0e38


class HostCurves(NamedTuple):
    """A curve set: consecutive groups of 4 control points form cubic
    Beziers (ref curve_buffer.zig)."""

    points: np.ndarray  # [P, 3] control points
    widths: np.ndarray  # [P] widths (a curve's radius at an end is half its end point's)
    curve_starts: np.ndarray  # [C] first control point of each curve
    strand_ids: np.ndarray  # [C] the strand each curve belongs to
    strand_u: np.ndarray  # [C, 2] each curve's parameter range on its strand


@dataclass
class CurveArena:
    """Every curve set of a scene (layouts in the module docstring)."""

    node_rows: torch.Tensor  # float32[M, 12]
    seg_rows: torch.Tensor  # float32[G, 40]
    seg_strand: torch.Tensor  # int32[G * 4]
    curve_root: torch.Tensor  # int32[K]

    def to(self, device) -> "CurveArena":
        return to_device(self, device)


def _bezier_eval(cp: np.ndarray, t: np.ndarray) -> np.ndarray:
    """cp [C, 4, 3], t [S] -> [C, S, 3]."""
    t = t[None, :, None]
    u = 1.0 - t
    return (u * u * u * cp[:, None, 0] + 3.0 * u * u * t * cp[:, None, 1]
            + 3.0 * u * t * t * cp[:, None, 2] + t * t * t * cp[:, None, 3])


def flatten_curves(curves: HostCurves, max_segments: int = 16):
    """Beziers -> round-cone segments (zyg_tpu/scene/curves.py:79): (pa [S,
    3], ra [S], pb [S, 3], rb [S], u0 [S], u1 [S], strand [S]). A curve
    gets ceil(sqrt(deviation / (width / 4))) segments, 2 to max_segments,
    its radius lerped between its ends' half widths."""
    pts = np.asarray(curves.points, np.float32)
    wid = np.asarray(curves.widths, np.float32)
    starts = np.asarray(curves.curve_starts, np.int64)
    C = len(starts)
    cp = np.stack([pts[starts + k] for k in range(4)], axis=1)  # [C, 4, 3]
    r0 = 0.5 * wid[starts]
    r1 = 0.5 * wid[np.minimum(starts + 3, len(wid) - 1)]
    # flatness: the control polygon's distance from the chord
    chord = cp[:, 3] - cp[:, 0]
    cl = np.maximum(np.linalg.norm(chord, axis=-1), 1e-12)
    cn = chord / cl[:, None]
    dev = np.zeros(C, np.float32)
    for k in (1, 2):
        v = cp[:, k] - cp[:, 0]
        perp = v - (v * cn).sum(-1, keepdims=True) * cn
        dev = np.maximum(dev, np.linalg.norm(perp, axis=-1))
    w_ref = np.maximum(np.maximum(r0, r1), 1e-6)
    nseg = np.clip(np.ceil(np.sqrt(np.maximum(dev / (0.25 * w_ref), 1.0))).astype(np.int64),
                   2, max_segments)
    pa, ra, pb, rb, u0s, u1s, sid = [], [], [], [], [], [], []
    su = np.asarray(curves.strand_u, np.float32)
    strands = np.asarray(curves.strand_ids, np.int32)
    for n in np.unique(nseg):
        sel = np.flatnonzero(nseg == n)
        t = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
        p = _bezier_eval(cp[sel], t)  # [c, n + 1, 3]
        r = r0[sel, None] * (1.0 - t)[None] + r1[sel, None] * t[None]
        uu = su[sel, 0:1] * (1.0 - t)[None] + su[sel, 1:2] * t[None]
        pa.append(p[:, :-1].reshape(-1, 3))
        pb.append(p[:, 1:].reshape(-1, 3))
        ra.append(r[:, :-1].reshape(-1))
        rb.append(r[:, 1:].reshape(-1))
        u0s.append(uu[:, :-1].reshape(-1))
        u1s.append(uu[:, 1:].reshape(-1))
        sid.append(np.repeat(strands[sel], n))
    return tuple(np.concatenate(x) for x in (pa, ra, pb, rb, u0s, u1s, sid))


def build_arena(shapes: list[HostCurves], device: torch.device | str = "cpu") -> CurveArena:
    """One arena over every curve set (zyg_tpu/scene/curves.py:148): a
    binary SAH tree per set over its segments' boxes."""
    all_rows, all_seg, all_strand = [], [], []
    roots = []
    node_off = group_off = 0
    pad = np.zeros(SEG_F, np.float32)
    pad[3] = pad[7] = -1.0  # padding: negative radii never hit
    for curves in shapes:
        pa, ra, pb, rb, u0, u1, sid = flatten_curves(curves)
        bvh = build_bvh(np.minimum(pa - ra[:, None], pb - rb[:, None]),
                        np.maximum(pa + ra[:, None], pb + rb[:, None]), LEAF_SIZE)
        order = bvh.prim_order
        seg = np.concatenate([pa[order], ra[order, None], pb[order], rb[order, None],
                              u0[order, None], u1[order, None]], axis=1).astype(np.float32)
        packed, node, src = leaf_scatter(bvh, seg, pad, group_off)
        strand = np.where(src >= 0, sid[order][np.maximum(src, 0)], 0).astype(np.int32)
        all_rows.append(link_rows(node, bvh, node_off))
        all_seg.append(packed)
        all_strand.append(strand)
        roots.append(node_off)
        node_off += node.shape[0]
        group_off += packed.shape[0]
    return CurveArena(
        node_rows=torch.as_tensor(np.concatenate(all_rows), device=device),
        seg_rows=torch.as_tensor(np.concatenate(all_seg), device=device),
        seg_strand=torch.as_tensor(np.concatenate(all_strand), device=device),
        curve_root=torch.as_tensor(np.array(roots, np.int32), device=device),
    )


def cone_test(o, dn, pa, ra, pb, rb, tmin, tmax):
    """Ray against a rounded cone (zyg_tpu/scene/curves.py:225, after
    Quilez): (t, axial parameter s in [0, 1], hit) along the unit
    direction dn. Rounded as XLA rounds the JAX walk: dot products are
    fused chains, and in a sum or difference of products the first
    product is fused into the rest, each further product term onto that."""
    ba = pb - pa
    oa = o - pa
    ob = o - pb
    rr = ra - rb
    m0 = vm.dot(ba, ba)
    m1 = vm.dot(ba, oa)
    m2 = vm.dot(ba, dn)
    m3 = vm.dot(dn, oa)
    m5 = vm.dot(oa, oa)
    m6 = vm.dot(ob, dn)
    m7 = vm.dot(ob, ob)
    d2 = fma(-rr, rr, m0)
    k2 = fma(-m2, m2, d2)
    k1 = fma(m2 * rr, ra, fma(d2, m3, -(m1 * m2)))
    k0 = fma(-(m0 * ra), ra, fma(2.0 * m1 * rr, ra, fma(d2, m5, -(m1 * m1))))
    h = fma(k1, k1, -(k0 * k2))
    k2s = torch.where(k2.abs() < 1e-12, 1e-12, k2)
    t_body = (-sqrt(torch.clamp(h, min=0.0)) - k1) / k2s
    y = fma(t_body, m2, fma(-ra, rr, m1))
    body_ok = (h > 0.0) & (y > 0.0) & (y < d2) & (ra > 0.0)
    # the spherical caps
    h1 = fma(ra, ra, fma(m3, m3, -m5))
    h2 = fma(rb, rb, fma(m6, m6, -m7))
    t_a = -m3 - sqrt(torch.clamp(h1, min=0.0))
    t_cb = -m6 - sqrt(torch.clamp(h2, min=0.0))
    a_ok = (h1 > 0.0) & (ra > 0.0)
    b_ok = (h2 > 0.0) & (rb > 0.0)

    def rng(t, ok):
        return torch.where(ok & (t >= tmin) & (t <= tmax), t, _FAR)

    tb = rng(t_body, body_ok)
    ta = rng(t_a, a_ok)
    tbb = rng(t_cb, b_ok)
    t = torch.minimum(tb, torch.minimum(ta, tbb))
    s_body = torch.clamp(y / torch.clamp(d2, min=1e-20), 0.0, 1.0)
    s = torch.where(t == tb, s_body, torch.where(t == ta, 0.0, 1.0))
    return t, s, t < _FAR


def traverse(arena: CurveArena, root, o, d, tmin: float, tmax, any_hit: bool = False,
             counts: dict | None = None):
    """(t [N], s [N] the axial parameter of the hit segment, prim [N] int32:
    padded arena segment group*4 + slot, -1 on a miss) of rays o, d [N, 3]
    (object space; d need not be unit) walking from root [N] (int32, -1:
    the lane does not walk) over [tmin, tmax [N]]; t starts at tmax. Any-
    hit stops a ray at its first hit. counts, if given, accumulates the
    node rows visited and the leaf rows tested, and marks them as
    scene/points.py traverse does."""
    dev = o.device
    n = o.shape[0]
    t = tmax.clone()
    s = torch.zeros(n, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    dlen = torch.clamp(vm.length(d), min=1e-20)
    dn = d / dlen[:, None]
    inv = inv_dir(d)
    ids = torch.nonzero(root >= 0).squeeze(1)
    ptr = root[ids].long()
    while ids.numel():
        oo, ii = o[ids], inv[ids]
        row = arena.node_rows[ptr]
        hit = slab(row, oo, ii, tmin, t[ids])
        group = row[:, 8].long()
        if counts is not None:
            counts["nodes"] += ids.numel()
            if "node_seen" in counts:
                counts["node_seen"][ptr] = True
        leaf = torch.nonzero(hit & (group >= 0)).squeeze(1)
        if leaf.numel():
            if counts is not None:
                counts["leaves"] += leaf.numel()
                if "leaf_seen" in counts:
                    counts["leaf_seen"][group[leaf]] = True
            lid = ids[leaf]
            g = group[leaf]
            seg = arena.seg_rows[g].reshape(-1, LEAF_SIZE, SEG_F)
            cnt = row[leaf, 9].long()
            dl = dlen[lid]
            tb, sb, pb = t[lid], s[lid], prim[lid]
            # the leaf's segments at once, bounded by the best t on entry: a
            # slot then takes the hit where it is in range of the running
            # best, which is what testing the slots in turn gives
            tt_u, ss, h = cone_test(oo[leaf, None], dn[lid, None], seg[..., 0:3], seg[..., 3],
                                    seg[..., 4:7], seg[..., 7], (tmin * dl)[:, None],
                                    (tb * dl)[:, None])
            for j in range(LEAF_SIZE):
                hj = h[:, j] & (tt_u[:, j] <= tb * dl) & (j < cnt)
                tb = torch.where(hj, tt_u[:, j] / dl, tb)
                pb = torch.where(hj, g * LEAF_SIZE + j, pb)
                sb = torch.where(hj, ss[:, j], sb)
            t[lid], s[lid], prim[lid] = tb, sb, pb
        nxt = torch.where(hit, row[:, 6], row[:, 7]).long()
        keep = nxt >= 0
        if any_hit:
            keep = keep & (prim[ids] < 0)
        ids, ptr = ids[keep], nxt[keep]
    return t, s, prim.to(torch.int32)


def segment_fields(arena: CurveArena, prim) -> dict:
    """One padded segment's fields (pa, ra, pb, rb, u0, u1, strand) by its
    arena index prim (>= 0) (zyg_tpu/scene/curves.py:407)."""
    pr = prim.long()
    seg = arena.seg_rows.reshape(-1, SEG_F)[pr]
    return {"pa": seg[:, 0:3], "ra": seg[:, 3], "pb": seg[:, 4:7], "rb": seg[:, 7],
            "u0": seg[:, 8], "u1": seg[:, 9], "strand": arena.seg_strand[pr]}
