"""Many-light selection tree (counterpart of zyg_tpu/scene/light_tree.py:
the LightTree arrays, the host SAOH build and the single-pick descent and
pdf walk; ref light_tree.zig, light_tree_builder.zig).

The host builds a binary BVH over the finite lights with the reference's
SAOH (surface-area orientation heuristic: axis sweeps plus normal-cone
splits scored by power x cone cost x surface area) and flattens it to
node arrays. On the device each lane

* `select`s a light by a stochastic root-to-leaf descent that picks a
  child by its estimated importance at the shading point (power / d^2,
  attenuated by the cluster's normal cone and the receiver's cosine
  bound), after mixing in the infinite lights by their power CDF with
  probability `inf_weight`;
* evaluates the same selection's `pdf` of a given light by the upward
  parent walk, for the MIS weight of a BSDF hit.

Both loops run `depth` levels, as the JAX package's unrolled loops do, so
both packages multiply the same factors. The reference's adaptive NEE
splitting (the JAX package's select_split / pdf_split) is not ported:
render/driver.py refuses a scene that would split.

Arithmetic follows XLA's rounding of the JAX functions on the CPU: a
multiply feeding an add is one fused multiply-add (core/fmath.py), and a
division by a scene constant is a multiplication by its float32
reciprocal.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma, sqrt
from .types import to_device

ARRAY_FIELDS = (
    "center", "radius", "cone", "power", "variance", "two_sided", "child0",
    "light", "parent", "sibling", "light_leaf", "inf_lights", "inf_cdf",
)


@dataclass
class LightTree:
    """Flattened binary light BVH with singleton leaves (2F - 1 nodes over
    F finite lights; children in adjacent slots) and the infinite lights'
    CDF."""

    center: torch.Tensor  # float32[Nn, 3]
    radius: torch.Tensor  # float32[Nn]
    cone: torch.Tensor  # float32[Nn, 4] axis + cos half-angle
    power: torch.Tensor  # float32[Nn]
    variance: torch.Tensor  # float32[Nn] power variance of the member lights
    two_sided: torch.Tensor  # bool[Nn]
    child0: torch.Tensor  # int32[Nn] first child (-1 at leaves)
    light: torch.Tensor  # int32[Nn] light index at leaves (-1 inside)
    parent: torch.Tensor  # int32[Nn] (-1 at the root)
    sibling: torch.Tensor  # int32[Nn] (-1 at the root)
    light_leaf: torch.Tensor  # int32[L] leaf node of each light (-1 if infinite)
    inf_lights: torch.Tensor  # int32[I] infinite light indices ([0] when none)
    inf_cdf: torch.Tensor  # float32[I + 1]
    depth: int  # levels of the descent and of the pdf walk
    inf_weight: float  # probability of picking an infinite light
    num_finite: int

    def to(self, device) -> "LightTree":
        return to_device(self, device)


# ---------------------------------------------------------------------------
# Host build (SAOH, ref light_tree_builder.zig)
# ---------------------------------------------------------------------------


def _cone_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact pairwise bounding-cone union (ref base/math/cone.zig merge)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if np.allclose(a, b):
        return a.astype(np.float32)
    a_angle = math.acos(float(np.clip(a[3], -1.0, 1.0)))
    b_angle = math.acos(float(np.clip(b[3], -1.0, 1.0)))
    if b_angle > a_angle:
        a, b = b, a
        a_angle, b_angle = b_angle, a_angle
    d_angle = math.acos(float(np.clip(np.dot(a[:3], b[:3]), -1.0, 1.0)))
    if min(d_angle + b_angle, math.pi) <= a_angle:
        return a.astype(np.float32)
    o_angle = (a_angle + d_angle + b_angle) / 2.0
    if o_angle >= math.pi:
        return np.array([a[0], a[1], a[2], -1.0], np.float32)
    r_angle = o_angle - a_angle
    axis = np.cross(a[:3], b[:3])
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([a[0], a[1], a[2], math.cos(o_angle)], np.float32)
    axis /= n
    # Rodrigues rotation of a's axis by r_angle around `axis`
    c, s = math.cos(r_angle), math.sin(r_angle)
    v = a[:3]
    rot = v * c + np.cross(axis, v) * s + axis * float(np.dot(axis, v)) * (1.0 - c)
    rot /= max(np.linalg.norm(rot), 1e-12)
    return np.array([rot[0], rot[1], rot[2], math.cos(o_angle)], np.float32)


def _cone_cost_vec(cos: np.ndarray, two_sided: np.ndarray) -> np.ndarray:
    """_cone_cost over arrays."""
    cos = np.clip(np.asarray(cos, np.float64), -1.0, 1.0)
    o = np.where(two_sided, np.pi, np.arccos(cos))
    w = np.minimum(o + np.pi / 2.0, np.pi)
    sin_o = np.sin(o)
    b = (np.pi / 2.0) * (
        2.0 * w * sin_o - np.cos(o - 2.0 * w) - 2.0 * o * sin_o + np.cos(o)
    )
    return (2.0 * np.pi) * (1.0 - cos) + b


def _bound_cone(cones: np.ndarray) -> tuple[np.ndarray, float]:
    """Cheap conservative bounding cone (axis, cos) of many cones: axis =
    normalized mean direction, aperture = max(angle(axis, d_i) + ap_i).
    Used only for SAOH split scoring; the stored node cones are exact
    pairwise merges."""
    c = np.asarray(cones, np.float64)
    axis = c[:, :3].sum(axis=0)
    nrm = np.linalg.norm(axis)
    if nrm < 1e-9:
        axis = c[0, :3]
    else:
        axis = axis / nrm
    ang = np.arccos(np.clip(c[:, :3] @ axis, -1.0, 1.0)) + np.arccos(
        np.clip(c[:, 3], -1.0, 1.0)
    )
    return axis, float(np.cos(min(float(ang.max()), np.pi)))


def _prefix_cone_cos(cones: np.ndarray) -> np.ndarray:
    """Inclusive prefix bounding-cone cosine, [n, 4] -> [n]: every prefix
    cone anchored at the first element's axis, aperture = max over the
    prefix of angle(d0, d_i) + aperture_i."""
    c = np.asarray(cones, np.float64)
    d0 = c[0, :3]
    ang = np.arccos(np.clip(c[:, :3] @ d0, -1.0, 1.0)) + np.arccos(
        np.clip(c[:, 3], -1.0, 1.0)
    )
    return np.cos(np.minimum(np.maximum.accumulate(ang), np.pi))


def _cone_cost(cos: float, two_sided: bool) -> float:
    """ref light_tree_builder.zig coneCost: orientation measure of a cone."""
    o = math.pi if two_sided else math.acos(float(np.clip(cos, -1.0, 1.0)))
    w = min(o + math.pi / 2.0, math.pi)
    sin_o = math.sin(o)
    b = (math.pi / 2.0) * (
        2.0 * w * sin_o - math.cos(o - 2.0 * w) - 2.0 * o * sin_o + math.cos(o)
    )
    return (2.0 * math.pi) * (1.0 - float(np.clip(cos, -1.0, 1.0))) + b


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> float:
    e = np.maximum(hi - lo, 0.0)
    return float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0]))


class _Lights:
    """Per-light SAOH attributes (AABB from the bounding sphere)."""

    def __init__(self, centers, radii, cones, powers, two_sided):
        self.centers = np.asarray(centers, np.float32)
        self.radii = np.asarray(radii, np.float32)
        self.cones = np.asarray(cones, np.float32)
        self.powers = np.asarray(powers, np.float32)
        self.two_sided = np.asarray(two_sided, bool)
        self.lo = self.centers - self.radii[:, None]
        self.hi = self.centers + self.radii[:, None]


def _variance(powers: np.ndarray) -> float:
    """Power variance of a cluster (ref light_tree_builder.zig variance())."""
    p = powers[powers > 0.0]
    if len(p) == 0:
        return 0.0
    return float(abs(np.mean(p.astype(np.float64) ** 2) - np.mean(p.astype(np.float64)) ** 2))


def _best_split(L: _Lights, members) -> tuple[list[int], list[int]]:
    """SAOH candidate sweep (ref evaluateSplits): explicit partitions of
    up to 4 lights; above that axis sweeps over every sorted boundary
    (prefix/suffix scans) and three normal-cone half-space splits. Falls
    back to a spatial median when no candidate splits the set."""
    idx = np.asarray(members, np.int64)
    n = len(idx)
    if n == 2:  # only one real partition
        return [int(idx[0])], [int(idx[1])]
    lo = L.lo[idx].min(axis=0)
    hi = L.hi[idx].max(axis=0)
    extent = np.maximum(hi - lo, 1e-20)
    bounds_sa = max(_surface_area(lo, hi), 1e-20)
    cone_axis, cone_cos = _bound_cone(L.cones[idx])
    two = bool(L.two_sided[idx].any())
    cone_weight = max(_cone_cost(cone_cos, two), 1e-20)
    maxe, mine = float(extent.max()), float(extent.min())

    norm = 1.0 / max(bounds_sa * cone_weight, 1e-20)
    best_mask, best_cost = None, None

    def consider(m: np.ndarray, cost: float):
        nonlocal best_mask, best_cost
        if best_cost is None or cost < best_cost:
            best_cost, best_mask = cost, m

    def side_cost(part_idx: np.ndarray) -> float:
        plo = L.lo[part_idx].min(axis=0)
        phi = L.hi[part_idx].max(axis=0)
        _, pcos = _bound_cone(L.cones[part_idx])
        ptwo = bool(L.two_sided[part_idx].any())
        return (
            float(L.powers[part_idx].sum())
            * _cone_cost(pcos, ptwo)
            * _surface_area(plo, phi)
        )

    if n <= 4:
        # explicit partitions (ref evaluateSplits 2/3/4-light cases)
        reg = maxe / mine
        for k in range(1, n // 2 + 1):
            for combo in itertools.combinations(range(n), k):
                m = np.zeros(n, bool)
                m[list(combo)] = True
                consider(m, reg * (side_cost(idx[m]) + side_cost(idx[~m])) * norm)
    else:
        his = L.hi[idx]
        for a in range(3):
            order = np.argsort(his[:, a], kind="stable")
            oi = idx[order]
            pw = L.powers[oi].astype(np.float64)
            lo_o, hi_o = L.lo[oi], L.hi[oi]
            two_o = L.two_sided[oi]
            cn_o = L.cones[oi]

            p_pw = np.cumsum(pw)
            p_lo = np.minimum.accumulate(lo_o, axis=0)
            p_hi = np.maximum.accumulate(hi_o, axis=0)
            p_two = np.maximum.accumulate(two_o)
            p_cos = _prefix_cone_cos(cn_o)
            s_pw = np.cumsum(pw[::-1])[::-1]
            s_lo = np.minimum.accumulate(lo_o[::-1], axis=0)[::-1]
            s_hi = np.maximum.accumulate(hi_o[::-1], axis=0)[::-1]
            s_two = np.maximum.accumulate(two_o[::-1])[::-1]
            s_cos = _prefix_cone_cos(cn_o[::-1])[::-1]

            def sa(lo_b, hi_b):
                e = np.maximum(hi_b - lo_b, 0.0)
                return 2.0 * (
                    e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]
                )

            # split before element k (left = first k), where the sort key
            # strictly increases
            ks = np.arange(1, n)
            valid = his[order][1:, a] > his[order][:-1, a]
            left_c = (
                p_pw[:-1]
                * _cone_cost_vec(p_cos[:-1], p_two[:-1])
                * sa(p_lo[:-1], p_hi[:-1])
            )
            right_c = (
                s_pw[1:]
                * _cone_cost_vec(s_cos[1:], s_two[1:])
                * sa(s_lo[1:], s_hi[1:])
            )
            reg = maxe / float(extent[a])
            costs = np.where(valid, reg * (left_c + right_c) * norm, np.inf)
            k_best = int(np.argmin(costs))
            if np.isfinite(costs[k_best]):
                m = np.zeros(n, bool)
                m[order[: ks[k_best]]] = True
                consider(m, float(costs[k_best]))
        # normal-cone half-space splits around the cluster cone's basis
        t, b = _onb(cone_axis)
        dirs = L.cones[idx][:, :3].astype(np.float64)
        reg = maxe / mine
        for axis_v in (t, b, cone_axis):
            m = dirs @ np.asarray(axis_v, np.float64) < 0.0
            nl = int(m.sum())
            if nl == 0 or nl == n:
                continue
            consider(m, reg * (side_cost(idx[m]) + side_cost(idx[~m])) * norm)

    if best_mask is not None:
        return list(idx[best_mask]), list(idx[~best_mask])
    # every candidate exhausted: spatial median on the longest axis
    a = int(np.argmax(extent))
    order = idx[np.argsort(L.centers[idx, a])]
    half = n // 2
    return list(order[:half]), list(order[half:])


def _onb(n):
    n = np.asarray(n, np.float64)
    a = np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.9 else np.array([1.0, 0.0, 0.0])
    t = np.cross(a, n)
    t /= max(np.linalg.norm(t), 1e-12)
    return t, np.cross(n, t)


def build_light_tree(centers, radii, cones, powers, two_sided, finite_mask) -> LightTree | None:
    """The tree over the lights (centers [L, 3], radii [L], cones [L, 4],
    powers [L], two_sided bool[L], finite_mask bool[L]): finite lights of
    positive power go into the BVH, infinite ones into the CDF. None when
    no light is finite."""
    L = len(powers)
    fin = [i for i in range(L) if finite_mask[i] and powers[i] > 0.0]
    inf = [i for i in range(L) if not finite_mask[i] and powers[i] > 0.0]
    if not fin:
        return None

    lights = _Lights(centers, radii, cones, powers, two_sided)
    nodes = []  # dicts
    light_leaf = np.full(L, -1, np.int32)

    def fill(idx_list, ni, parent, depth):
        """Fill node slot ni for idx_list; children get adjacent slots
        (child1 = child0 + 1, the reference's node layout)."""
        if len(idx_list) == 1:
            li = idx_list[0]
            nodes[ni] = dict(
                center=centers[li], radius=float(radii[li]), cone=cones[li],
                power=float(powers[li]), variance=0.0,
                two_sided=bool(two_sided[li]),
                child0=-1, light=li, parent=parent, depth=depth,
            )
            light_leaf[li] = ni
            return
        left, right = _best_split(lights, idx_list)
        c0 = len(nodes)
        nodes.append({})
        nodes.append({})
        fill(left, c0, ni, depth + 1)
        fill(right, c0 + 1, ni, depth + 1)
        c1 = c0 + 1
        lo = lights.lo[idx_list].min(axis=0)
        hi = lights.hi[idx_list].max(axis=0)
        ctr = 0.5 * (lo + hi)
        r = 0.5 * float(np.linalg.norm(hi - lo))
        cn = _cone_merge(np.asarray(nodes[c0]["cone"]), np.asarray(nodes[c1]["cone"]))
        nodes[ni] = dict(
            center=ctr.astype(np.float32), radius=r, cone=cn,
            power=nodes[c0]["power"] + nodes[c1]["power"],
            variance=_variance(lights.powers[idx_list]),
            two_sided=nodes[c0]["two_sided"] or nodes[c1]["two_sided"],
            child0=c0, light=-1, parent=parent, depth=depth,
        )

    nodes.append({})
    fill(fin, 0, -1, 0)
    nn = len(nodes)
    sibling = np.full(nn, -1, np.int32)
    for n_ in nodes:
        if n_["child0"] >= 0:
            sibling[n_["child0"]] = n_["child0"] + 1
            sibling[n_["child0"] + 1] = n_["child0"]

    inf_p = np.asarray([powers[i] for i in inf], np.float32)
    total_inf = float(inf_p.sum())
    total = total_inf + nodes[0]["power"]
    inf_cdf = np.concatenate([[0.0], np.cumsum(inf_p) / max(total_inf, 1e-20)]).astype(np.float32)
    if len(inf):
        inf_cdf[-1] = 1.0

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype))

    return LightTree(
        center=t(np.stack([n_["center"] for n_ in nodes]), np.float32),
        radius=t([n_["radius"] for n_ in nodes], np.float32),
        cone=t(np.stack([n_["cone"] for n_ in nodes]), np.float32),
        power=t([n_["power"] for n_ in nodes], np.float32),
        variance=t([n_["variance"] for n_ in nodes], np.float32),
        two_sided=t([n_["two_sided"] for n_ in nodes], bool),
        child0=t([n_["child0"] for n_ in nodes], np.int32),
        light=t([n_["light"] for n_ in nodes], np.int32),
        parent=t([n_["parent"] for n_ in nodes], np.int32),
        sibling=t(sibling, np.int32),
        light_leaf=t(light_leaf, np.int32),
        inf_lights=t(inf if inf else [0], np.int32),
        inf_cdf=t(inf_cdf if len(inf) else [0.0, 1.0], np.float32),
        depth=max(n_["depth"] for n_ in nodes),
        inf_weight=(total_inf / total) if total > 0 else 0.0,
        num_finite=len(fin),
    )


# ---------------------------------------------------------------------------
# Device traversal, on [N] lanes
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    """A host constant as XLA converts a weakly typed Python float."""
    return float(np.float32(x))


def _recip(x: float) -> float:
    """The float32 reciprocal a division by the constant x becomes."""
    return float(np.float32(1.0) / np.float32(x))


def _sin_of(c):
    return sqrt(torch.clamp(fma(-c, c, 1.0), min=0.0))


def _cos_sub(ca, cb, sa, sb):
    """clampedCosSub: cos(a - b), 1 where a < b."""
    return torch.where(ca > cb, 1.0, fma(sa, sb, ca * cb))


def _sin_sub(ca, cb, sa, sb):
    """clampedSinSub: sin(a - b), 0 where a < b."""
    return torch.where(ca > cb, 0.0, fma(sa, cb, -(sb * ca)))


def _node_importance(tree: LightTree, node, p, n, total_sphere=None):
    """ref light_tree.zig importance(): power / d^2 x the cluster's cone
    visibility x the receiver's cosine bound, with the angle-sum clamping
    of Conty and Kulla. node int64[N]; p, n [N, 3]; total_sphere bool[N]
    (or None): lanes at a volume scatter vertex, which receive over the
    whole sphere and drop the cosine bound."""
    center = tree.center[node]
    radius = tree.radius[node]
    cone = tree.cone[node]
    power = tree.power[node]
    two = tree.two_sided[node]

    axis = p - center
    length = torch.clamp(vm.length(axis), min=1e-9)
    na = axis / length[:, None]
    cos_cone = cone[:, 3]

    sin_cu = torch.clamp(radius / length, max=1.0)
    cos_a0 = vm.dot(cone[:, :3], na)
    cos_a = torch.where(two, torch.abs(cos_a0), cos_a0)
    cos_n = torch.clamp(-vm.dot(n, na), min=0.0)

    cos_cu = _sin_of(sin_cu)
    sin_cone = _sin_of(cos_cone)
    sin_a = _sin_of(cos_a)
    sin_n = _sin_of(cos_n)

    ta = _cos_sub(cos_a, cos_cone, sin_a, sin_cone)
    tb = _sin_sub(cos_a, cos_cone, sin_a, sin_cone)
    tc = _cos_sub(ta, cos_cu, tb, sin_cu)
    tn = _cos_sub(cos_n, cos_cu, sin_n, sin_cu)

    ra = tn if total_sphere is None else torch.where(total_sphere, 1.0, tn)
    rb = torch.clamp(tc, min=0.0)
    clamped = torch.maximum(length, 0.5 * radius)
    return torch.clamp(ra * rb * power / (clamped * clamped), min=0.0)


def _descend(tree: LightTree, node, pdf_, r, p, n, total_sphere=None):
    """The stochastic descent: `tree.depth` levels, each choosing a child
    by relative importance and rescaling r into the chosen interval."""
    for _ in range(tree.depth):
        c0 = tree.child0[node].long()
        leaf = c0 < 0
        c0c = torch.clamp(c0, min=0)
        w0 = _node_importance(tree, c0c, p, n, total_sphere)
        w1 = _node_importance(tree, c0c + 1, p, n, total_sphere)
        wt = w0 + w1
        p0 = torch.where(wt > 0.0, w0 / torch.clamp(wt, min=1e-20), 0.5)
        go0 = r < p0
        psel = torch.where(go0, p0, 1.0 - p0)
        r_new = torch.where(go0, r / torch.clamp(p0, min=1e-12),
                            (r - p0) / torch.clamp(1.0 - p0, min=1e-12))
        node = torch.where(leaf, node, torch.where(go0, c0c, c0c + 1))
        pdf_ = torch.where(leaf, pdf_, pdf_ * psel)
        r = torch.where(leaf, r, torch.clamp(r_new, 0.0, 1.0))
    return node, pdf_, r


def select(tree: LightTree, p, n, u, total_sphere=None):
    """u in [0, 1) at shading points p with normals n -> (light index
    int32[N], selection pdf [N]); total_sphere as _node_importance."""
    w = tree.inf_weight
    use_inf = u < _f32(w)
    # infinite branch: the CDF pick
    ui = torch.clamp(u * _recip(max(w, 1e-12)), 0.0, 1.0) if w > 0 else u
    k = torch.clamp(torch.searchsorted(tree.inf_cdf, ui.contiguous(), right=True) - 1, 0,
                    tree.inf_lights.shape[0] - 1)
    inf_light = tree.inf_lights[k]
    inf_pdf = (tree.inf_cdf[k + 1] - tree.inf_cdf[k]) * _f32(w)

    # finite branch: the masked descent
    node = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    pdf_ = torch.full(u.shape, _f32(1.0 - w), dtype=torch.float32, device=u.device)
    r = torch.clamp((u - _f32(w)) * _recip(max(1.0 - w, 1e-12)), 0.0, 1.0)
    node, pdf_, _ = _descend(tree, node, pdf_, r, p, n, total_sphere)
    fin_light = tree.light[node]
    return torch.where(use_inf, inf_light, fin_light), torch.where(use_inf, inf_pdf, pdf_)


def pdf(tree: LightTree, p, n, light_idx, total_sphere=None):
    """Selection pdf of light_idx (int32[N]) from (p, n): the upward
    parent walk, `tree.depth` levels; total_sphere as _node_importance."""
    li = torch.clamp(light_idx, 0, tree.light_leaf.shape[0] - 1).long()
    leaf = tree.light_leaf[li].long()
    is_inf = leaf < 0
    inf_pdf = torch.zeros(light_idx.shape, dtype=torch.float32, device=light_idx.device)
    if tree.inf_weight > 0.0:
        for j in range(tree.inf_lights.shape[0]):
            mass = (tree.inf_cdf[j + 1] - tree.inf_cdf[j]) * _f32(tree.inf_weight)
            inf_pdf = torch.where(light_idx == tree.inf_lights[j], mass, inf_pdf)

    node = torch.clamp(leaf, min=0)
    acc = torch.full(light_idx.shape, _f32(1.0 - tree.inf_weight), dtype=torch.float32,
                     device=light_idx.device)
    for _ in range(tree.depth):
        at_root = node == 0
        sib = tree.sibling[node].long()
        w_self = _node_importance(tree, node, p, n, total_sphere)
        w_sib = _node_importance(tree, torch.clamp(sib, min=0), p, n, total_sphere)
        wt = w_self + w_sib
        psel = torch.where(wt > 0.0, w_self / torch.clamp(wt, min=1e-20), 0.5)
        acc = torch.where(at_root, acc, acc * psel)
        node = torch.where(at_root, node, tree.parent[node].long())
    return torch.where(is_inf, inf_pdf, acc)
