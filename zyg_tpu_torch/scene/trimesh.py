"""Triangle meshes: the 8-wide BVH arena and the mesh instance table
(counterpart of zyg_tpu/scene/trimesh.py, static meshes).

Host side, numpy: per mesh a binary SAH tree (scene/bvh.py, C++) is
collapsed into 8-wide node rows whose leaves are groups of up to 12
triangles, and all meshes are packed into one arena. The arrays are the
JAX package's, element for element, so a hit record (t, u, v, padded arena
triangle id group*12 + j) means the same in both packages:

- node_rows[W, 64]: one 8-wide node per row, structure of arrays within
  the row: [0:8] min.x [8:16] min.y [16:24] min.z [24:32] max.x
  [32:40] max.y [40:48] max.z [48:56] child refs [56:64] pad. A child ref
  (float32, exact below 2^24) >= 0 is a wide node, <= -2 the leaf
  triangle group -(ref + 2), -1 an empty slot.
- tri_rows[G, 108]: a leaf's 12 triangles as (p0, e1, e2); padding
  triangles are degenerate (never hit).
- attr_rows[G*12, 20]: per padded triangle [0:3] p0 [3:6] e1 [6:9] e2
  [9:12] oct-snorm16x2 vertex normal words (bit patterns in float32)
  [12:18] uv [18] part [19] pad.

Mesh props are instances over the arena (InstanceTable): world AABB,
quaternion, position, scale, root node, prop id and visibility. The
traversal over both is ops/traverse.py.

An animated mesh prop is an instance with a shutter-end transform: the
walk slerps and lerps the two per ray at the ray's shutter time. A
deforming mesh (a HostMesh with shutter-end positions, as a SUB file's
last position frame gives it) is bounded over both endpoints, and the
arena then also holds the end-minus-start deltas of its leaf rows
(tri_rows_d [G, 108]) and of p0, e1 and e2 (attr_rows_d [G*12, 12]; zero
rows for the meshes that do not deform), which the walk and the fragment
lerp to each ray's shutter time (zyg_tpu/scene/trimesh.py:471-514).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .bvh import FlatBVH, build_bvh
from .types import to_device

LEAF_SIZE = 12  # triangles per leaf row (padded)
COLLAPSE_GRAN = 4  # binary leaf size before the wide collapse
BRANCH = 8  # wide-BVH branching factor
# a wide slot whose subtree holds <= LEAF_COLLECT triangles becomes
# ceil(cnt / LEAF_SIZE) evenly chunked leaf groups
LEAF_COLLECT = LEAF_SIZE
ROW_FLOATS = 8 * BRANCH


@dataclass
class MeshArena:
    """All meshes of a scene, concatenated (layouts in the module docstring)."""

    node_rows: torch.Tensor  # float32[W, 64]
    tri_rows: torch.Tensor  # float32[G, 108]
    attr_rows: torch.Tensor  # float32[G*12, 20]
    mesh_root: torch.Tensor  # int32[K] root wide node per mesh
    max_depth: int  # wide-tree depth (the traversal stack needs max_depth + 1)
    # deforming meshes: the shutter-end minus shutter-start deltas of
    # tri_rows and of attr_rows' p0, e1, e2 ([9:12] pad); None when no
    # mesh deforms
    tri_rows_d: torch.Tensor = None  # float32[G, 108]
    attr_rows_d: torch.Tensor = None  # float32[G*12, 12]

    def to(self, device) -> "MeshArena":
        return to_device(self, device)


@dataclass
class InstanceTable:
    """Mesh instances (ref prop_tree.zig): one row per mesh prop.

    trafo[I, 24]: q(4) pos(3) scale(3), the same again for the shutter end
    (a static instance repeats the start), root node, prop id, pad(2).
    has_anim: some instance moves (the JAX table's static `meta`), so the
    walk interpolates the two ends at each ray's shutter time.
    """

    wmin: torch.Tensor  # float32[I, 3] world AABB (the shutter's union when moving)
    wmax: torch.Tensor  # float32[I, 3]
    trafo: torch.Tensor  # float32[I, 24]
    vis: torch.Tensor  # bool[I, 3] camera / reflection / shadow
    has_anim: bool = False

    def to(self, device) -> "InstanceTable":
        return to_device(self, device)


class HostMesh(NamedTuple):
    """Host-side mesh description before arena packing."""

    positions: np.ndarray  # [V, 3]
    indices: np.ndarray  # [F, 3]
    normals: np.ndarray | None = None  # [V, 3]
    uvs: np.ndarray | None = None  # [V, 2]
    parts: np.ndarray | None = None  # [F] part id
    positions_end: np.ndarray | None = None  # [V, 3] shutter-end positions (deforming)


def _subtree_ranges(bvh: FlatBVH):
    """Per-node [lo, hi) range over leaf-order primitive positions: the
    builder partitions prim_order, so every subtree owns a contiguous
    range, and DFS numbering lets one reverse sweep fill them bottom-up."""
    fp = bvh.first_prim
    hl = bvh.hit_link
    ml = bvh.miss_link
    lo = np.where(fp >= 0, fp, 0).astype(np.int64)
    hi = np.where(fp >= 0, fp + bvh.prim_count, 0).astype(np.int64)
    for i in range(fp.shape[0] - 1, -1, -1):
        if fp[i] < 0:
            left = hl[i]
            right = ml[left]
            lo[i] = min(lo[left], lo[right])
            hi[i] = max(hi[left], hi[right])
    return lo, hi


def _pack_wide(bvh: FlatBVH, group_off: int, node_off: int, tri_min, tri_max):
    """Collapse the binary tree into BRANCH-wide rows, forming the
    LEAF_SIZE-triangle leaf groups during the collapse (Ylitie et al.
    2017 style): a slot whose subtree fits in LEAF_COLLECT triangles
    becomes evenly chunked leaf groups over its contiguous prim range; the
    largest-area slot still too big is expanded into its children while
    the row's slot budget allows.

    tri_min/tri_max: [P, 3] per-triangle AABBs in leaf order.
    Returns (rows [W, 64] float32, depth, leaf group ranges [(lo, hi)])
    with child refs offset by node_off (wide) and group_off (groups)."""
    fp = bvh.first_prim
    hl = bvh.hit_link
    B = BRANCH
    is_leaf = fp >= 0
    slo, shi = _subtree_ranges(bvh)
    cnt = shi - slo
    ext = np.maximum(bvh.nodes_max - bvh.nodes_min, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def children(i):
        left = int(hl[i])
        return left, int(bvh.miss_link[left])

    def n_chunks(s):
        return max(1, -(-int(cnt[s]) // LEAF_SIZE))

    def chunks(s):
        lo, hi = int(slo[s]), int(shi[s])
        k = n_chunks(s)
        bounds = [lo + ((hi - lo) * j) // k for j in range(k + 1)]
        return [(bounds[j], bounds[j + 1]) for j in range(k)]

    def wide(s, demoted):
        return s in demoted or (cnt[s] > LEAF_COLLECT and not is_leaf[s])

    # breadth first over wide rows; each queue entry is one binary node
    order = [0]
    depths = [0]
    wide_of = {0: 0}
    slot_lists = []  # (slots, demoted) per wide row
    qi = 0
    while qi < len(order):
        b = order[qi]
        dep = depths[qi]
        qi += 1
        demoted: set = set()
        if cnt[b] <= LEAF_COLLECT or is_leaf[b]:
            S = [b]  # pure leaf row
        else:
            S = list(children(b))

            def slot_cost(s):
                return 1 if wide(s, demoted) else n_chunks(s)

            total = sum(slot_cost(s) for s in S)
            # two leaf-destined children can overflow the row: demote the
            # costliest to its own pure-leaf row
            while total > B:
                x = max((s for s in S if slot_cost(s) > 1), key=slot_cost)
                total -= slot_cost(x) - 1
                demoted.add(x)
            while True:
                cand = [s for s in S if cnt[s] > LEAF_COLLECT and not is_leaf[s]
                        and s not in demoted]
                cand.sort(key=lambda s: -area[s])
                for x in cand:
                    c0, c1 = children(x)
                    nt = total - 1 + slot_cost(c0) + slot_cost(c1)
                    if nt <= B:
                        S.remove(x)
                        S.extend((c0, c1))
                        total = nt
                        break
                else:
                    break
        for s in S:
            if wide(s, demoted):
                wide_of[s] = len(order)
                order.append(s)
                depths.append(dep + 1)
        slot_lists.append((S, demoted))

    rows = np.zeros((len(slot_lists), ROW_FLOATS), np.float32)
    rows[:, 6 * B : 7 * B] = -1.0
    granges: list[tuple[int, int]] = []
    for wi, (S, demoted) in enumerate(slot_lists):
        k = 0
        for s in S:
            if wide(s, demoted):
                boxes = [(bvh.nodes_min[s], bvh.nodes_max[s], float(wide_of[s] + node_off))]
            else:
                boxes = []
                for lo, hi in chunks(s):
                    boxes.append((tri_min[lo:hi].min(axis=0), tri_max[lo:hi].max(axis=0),
                                  -float(len(granges) + group_off + 2)))
                    granges.append((lo, hi))
            for bmin, bmax, ref in boxes:
                for a in range(3):
                    rows[wi, a * B + k] = bmin[a]
                    rows[wi, (3 + a) * B + k] = bmax[a]
                rows[wi, 6 * B + k] = ref
                k += 1
        assert k <= B
    return rows, max(depths) + 1, granges


def _mesh_bounds(mesh: HostMesh):
    """Per-triangle AABBs; a deforming mesh's bound both shutter endpoints
    (ref triangle_motion_tree.zig interval bounds)."""
    pos = np.asarray(mesh.positions, np.float32)
    idx = np.asarray(mesh.indices, np.int32)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    if mesh.positions_end is not None:
        pe = np.asarray(mesh.positions_end, np.float32)
        w0, w1, w2 = pe[idx[:, 0]], pe[idx[:, 1]], pe[idx[:, 2]]
        pmin = np.minimum(pmin, np.minimum(np.minimum(w0, w1), w2))
        pmax = np.maximum(pmax, np.maximum(np.maximum(w0, w1), w2))
    return pmin, pmax


def build_blas(mesh: HostMesh) -> FlatBVH:
    """The binary SAH tree of one mesh (over both endpoints if it deforms)."""
    return build_bvh(*_mesh_bounds(mesh), leaf_size=COLLAPSE_GRAN)


def build_arena(meshes: list[HostMesh], prebuilt: list | None = None) -> tuple[MeshArena, dict]:
    """Build per-mesh wide BVHs and pack them into one arena (CPU tensors).
    prebuilt: each mesh's binary tree (build_blas) or None to build it.
    Also returns host copies {"node_rows", "mesh_root"} for the instance
    table build, and "info": per mesh {"order": the leaf-order triangle
    permutation, "arena_ids": the padded arena triangle id of each
    leaf-order position} for the emissive meshes' triangle tables."""
    from ..core.encoding import oct_normal_pack

    all_rows, all_trirows, all_attr, roots = [], [], [], []
    all_trirows_d, all_attr_d, host_info = [], [], []
    any_motion = any(m.positions_end is not None for m in meshes)
    node_off = group_off = 0
    max_depth = 1
    for mi, mesh in enumerate(meshes):
        pos = np.asarray(mesh.positions, np.float32)
        idx = np.asarray(mesh.indices, np.int32)
        bvh = prebuilt[mi] if prebuilt is not None and prebuilt[mi] is not None \
            else build_blas(mesh)
        order = bvh.prim_order
        p0 = pos[idx[order, 0]]
        e1 = pos[idx[order, 1]] - p0
        e2 = pos[idx[order, 2]] - p0
        if any_motion:
            if mesh.positions_end is not None:
                pe = np.asarray(mesh.positions_end, np.float32)
                p0e = pe[idx[order, 0]]
                dp0, de1, de2 = p0e - p0, (pe[idx[order, 1]] - p0e) - e1, \
                    (pe[idx[order, 2]] - p0e) - e2
            else:
                dp0, de1, de2 = np.zeros_like(p0), np.zeros_like(e1), np.zeros_like(e2)
        if mesh.normals is not None:
            nrm = np.asarray(mesh.normals, np.float32)
            tn = np.stack([nrm[idx[order, k]] for k in range(3)], axis=1)
        else:
            gn = np.cross(e1, e2)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            tn = np.repeat(gn[:, None, :], 3, axis=1)
        if mesh.uvs is not None:
            uv = np.asarray(mesh.uvs, np.float32)
            tuv = np.stack([uv[idx[order, k]] for k in range(3)], axis=1)
        else:
            tuv = np.zeros((len(order), 3, 2), np.float32)
        part = (np.asarray(mesh.parts, np.int32)[order] if mesh.parts is not None
                else np.zeros(len(order), np.int32))

        # per-triangle AABBs in leaf order for the collapse's chunk boxes
        # (a deforming mesh's over both endpoints)
        t_lo = np.minimum(np.minimum(p0, p0 + e1), p0 + e2)
        t_hi = np.maximum(np.maximum(p0, p0 + e1), p0 + e2)
        if any_motion and mesh.positions_end is not None:
            q0, q1, q2 = p0 + dp0, p0 + dp0 + e1 + de1, p0 + dp0 + e2 + de2
            t_lo = np.minimum(t_lo, np.minimum(np.minimum(q0, q1), q2))
            t_hi = np.maximum(t_hi, np.maximum(np.maximum(q0, q1), q2))
        rows, depth, granges = _pack_wide(bvh, group_off, node_off, t_lo, t_hi)
        max_depth = max(max_depth, depth)

        # scatter the leaf-order triangles into LEAF_SIZE-aligned groups
        g_first = np.array([g[0] for g in granges], np.int64)
        g_cnt = np.array([g[1] - g[0] for g in granges], np.int64)
        num_groups = len(granges)
        total = int(g_cnt.sum())
        within = np.arange(total) - np.repeat(np.cumsum(g_cnt) - g_cnt, g_cnt)
        src = np.repeat(g_first, g_cnt) + within
        dst = np.repeat(np.arange(num_groups) * LEAF_SIZE, g_cnt) + within
        tp = num_groups * LEAF_SIZE

        def padded(a):
            out = np.zeros((tp,) + a.shape[1:], a.dtype)
            out[dst] = a[src]
            return out

        def rows_of(a, b, c):  # [G, LEAF_SIZE, 9]: (p0, e1, e2) a triangle
            return np.concatenate([a.reshape(num_groups, -1, 3), b.reshape(num_groups, -1, 3),
                                   c.reshape(num_groups, -1, 3)],
                                  axis=2).reshape(num_groups, LEAF_SIZE * 9)

        pp0, pe1, pe2 = padded(p0), padded(e1), padded(e2)
        all_trirows.append(rows_of(pp0, pe1, pe2))
        attr = np.zeros((tp, 20), np.float32)
        attr[:, 0:3] = pp0
        attr[:, 3:6] = pe1
        attr[:, 6:9] = pe2
        attr[:, 9:12] = np.ascontiguousarray(
            oct_normal_pack(padded(tn)).astype(np.uint32)).view(np.float32)
        attr[:, 12:18] = padded(tuv).reshape(tp, 6)
        attr[:, 18] = padded(part).astype(np.float32)
        all_attr.append(attr)
        if any_motion:
            pd0, pd1, pd2 = padded(dp0), padded(de1), padded(de2)
            all_trirows_d.append(rows_of(pd0, pd1, pd2))
            attr_d = np.zeros((tp, 12), np.float32)
            attr_d[:, 0:3], attr_d[:, 3:6], attr_d[:, 6:9] = pd0, pd1, pd2
            all_attr_d.append(attr_d)
        arena_ids = np.empty(total, np.int64)
        arena_ids[src] = dst + group_off * LEAF_SIZE
        host_info.append({"order": order, "arena_ids": arena_ids.astype(np.int32)})
        all_rows.append(rows)
        roots.append(node_off)
        node_off += rows.shape[0]
        group_off += num_groups

    def cat(xs):
        return torch.from_numpy(np.concatenate(xs, axis=0))

    host_nodes = np.concatenate(all_rows, axis=0)
    host_roots = np.array(roots, np.int32)
    arena = MeshArena(
        node_rows=torch.from_numpy(host_nodes),
        tri_rows=cat(all_trirows),
        attr_rows=cat(all_attr),
        mesh_root=torch.from_numpy(host_roots),
        max_depth=int(max_depth),
        tri_rows_d=cat(all_trirows_d) if any_motion else None,
        attr_rows_d=cat(all_attr_d) if any_motion else None,
    )
    return arena, {"node_rows": host_nodes, "mesh_root": host_roots, "info": host_info}


def _np_quat(rot) -> np.ndarray:
    """Rotation rows -> quaternion (x, y, z, w), w >= 0, in the convention
    core/vecmath.quat_to_mat3 inverts."""
    m = np.asarray(rot, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([0.25 * s, (m[0, 1] + m[1, 0]) / s,
                      (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 1] + m[1, 0]) / s, 0.25 * s,
                      (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
                      0.25 * s, (m[1, 0] - m[0, 1]) / s])
    if q[3] < 0.0:
        q = -q
    return q.astype(np.float32)


def _np_quat_to_mat(q) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation rows, float64 (the inverse of
    _np_quat)."""
    x, y, z, w = q
    d = 2.0
    return np.array([
        [1 - d * (y * y + z * z), d * (x * y - w * z), d * (x * z + w * y)],
        [d * (x * y + w * z), 1 - d * (x * x + z * z), d * (y * z - w * x)],
        [d * (x * z - w * y), d * (y * z + w * x), 1 - d * (x * x + y * y)],
    ], np.float64)


def build_instance_table(host: dict, instances: list[dict]) -> InstanceTable:
    """Instance table on the host. host: build_arena's numpy copies;
    instances: per mesh prop {"prop", "mesh", "rot" [3, 3], "pos" [3],
    "scale" [3], "vis" (3 bools)}, and "rot1", "pos1", "scale1" for the
    shutter end of a moving prop. A moving instance's world box is the
    union over its transforms at t = 0, 0.25, 0.5, 0.75 and 1 (the
    quaternions' normalized lerp), grown by 5 % about its centre for the
    slerp's bulge (zyg_tpu/scene/trimesh.py:995-1024)."""
    node_rows = host["node_rows"]
    mesh_root = host["mesh_root"]
    ninst = len(instances)
    wmin = np.empty((ninst, 3), np.float32)
    wmax = np.empty((ninst, 3), np.float32)
    trafo = np.zeros((ninst, 24), np.float32)
    vis = np.zeros((ninst, 3), bool)
    B = BRANCH
    for i, ins in enumerate(instances):
        root = int(mesh_root[ins["mesh"]])
        # root box = union of the root row's child slots
        row = node_rows[root]
        filled = row[6 * B : 7 * B] != -1.0
        bmin = np.array([row[k * B : (k + 1) * B][filled].min() for k in range(3)])
        bmax = np.array([row[k * B : (k + 1) * B][filled].max() for k in range(3, 6)])
        corners = np.array([[bmin[k] if (j >> k) & 1 == 0 else bmax[k] for k in range(3)]
                            for j in range(8)], np.float64)
        moving = "rot1" in ins
        keys = [(ins["rot"], ins["pos"], ins["scale"])]
        if moving:
            q0, q1 = _np_quat(ins["rot"]), _np_quat(ins["rot1"])
            if np.dot(q0, q1) < 0.0:
                q1 = -q1
            for t in (0.25, 0.5, 0.75, 1.0):
                q = q0 * (1 - t) + q1 * t
                q /= np.linalg.norm(q)
                keys.append((_np_quat_to_mat(q),
                             np.asarray(ins["pos"]) * (1 - t) + np.asarray(ins["pos1"]) * t,
                             np.asarray(ins["scale"]) * (1 - t) + np.asarray(ins["scale1"]) * t))
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for rot, pos, scale in keys:
            w = ((corners * np.asarray(scale, np.float64)) @ np.asarray(rot, np.float64)
                 + np.asarray(pos, np.float64))
            lo = np.minimum(lo, w.min(axis=0))
            hi = np.maximum(hi, w.max(axis=0))
        if moving:
            c = 0.5 * (lo + hi)
            lo = c + (lo - c) * 1.05
            hi = c + (hi - c) * 1.05
        wmin[i] = lo
        wmax[i] = hi
        trafo[i, 0:4] = _np_quat(ins["rot"])
        trafo[i, 4:7] = ins["pos"]
        trafo[i, 7:10] = ins["scale"]
        if moving:
            trafo[i, 10:14] = _np_quat(ins["rot1"])
            trafo[i, 14:17] = ins["pos1"]
            trafo[i, 17:20] = ins["scale1"]
        else:
            trafo[i, 10:20] = trafo[i, 0:10]
        trafo[i, 20] = float(root)
        trafo[i, 21] = float(ins["prop"])
        vis[i] = ins.get("vis", (True, True, True))
    return InstanceTable(wmin=torch.from_numpy(wmin), wmax=torch.from_numpy(wmax),
                         trafo=torch.from_numpy(trafo), vis=torch.from_numpy(vis),
                         has_anim=any("rot1" in ins for ins in instances))


# ---------------------------------------------------------------------------
# procedural meshes (the `proc:` shapes of io/mesh.py)
# ---------------------------------------------------------------------------


def make_cube_mesh() -> HostMesh:
    """Unit cube [-0.5, 0.5]^3, 12 triangles, outward winding."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)],
                 np.float32)
    # vertex index = x*4 + y*2 + z
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return HostMesh(positions=v, indices=np.array(faces, np.int32))


def make_trefoil_mesh(n_seg: int = 512, n_ring: int = 256, tube_r: float = 0.35,
                      bumps: float = 0.12) -> HostMesh:
    """A trefoil-knot tube with a bumpy displacement, 2*n_seg*n_ring
    triangles (the bench's 512x480 is 491,520)."""
    t = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    c = np.stack([np.sin(t) + 2.0 * np.sin(2 * t), np.cos(t) - 2.0 * np.cos(2 * t),
                  -np.sin(3 * t)], -1)
    # frame along the centerline by finite differences
    tang = np.roll(c, -1, axis=0) - np.roll(c, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    n1 = np.cross(tang, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(n1, axis=-1) < 1e-6
    n1[bad] = np.cross(tang[bad], np.array([1.0, 0.0, 0.0]))
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 = np.cross(tang, n1)

    ph = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    cosp, sinp = np.cos(ph), np.sin(ph)
    T, P = np.meshgrid(t, ph, indexing="ij")
    r = tube_r * (1.0 + bumps * np.sin(9 * T) * np.cos(7 * P)
                  + 0.5 * bumps * np.sin(23 * T + 3 * P))
    pos = (
        c[:, None, :]
        + (r * cosp[None, :])[..., None] * n1[:, None, :]
        + (r * sinp[None, :])[..., None] * n2[:, None, :]
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack([T / (2 * np.pi), P / (2 * np.pi)], -1).reshape(-1, 2).astype(np.float32)

    def vid(i, j):
        return (i % n_seg) * n_ring + (j % n_ring)

    i = np.arange(n_seg)[:, None]
    j = np.arange(n_ring)[None, :]
    a, b, cc, dd = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
    faces = np.concatenate([np.stack([a, cc, b], -1).reshape(-1, 3),
                            np.stack([a, dd, cc], -1).reshape(-1, 3)]).astype(np.int32)
    # smooth vertex normals by area-weighted face accumulation
    v0, v1, v2 = pos[faces[:, 0]], pos[faces[:, 1]], pos[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, faces[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return HostMesh(positions=pos, indices=faces, normals=nrm.astype(np.float32), uvs=uv)


def make_sphere_mesh(n_theta: int = 32, n_phi: int = 64, radius: float = 0.5) -> HostMesh:
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([np.sin(TH) * np.cos(PH), np.cos(TH), np.sin(TH) * np.sin(PH)],
                   -1).reshape(-1, 3).astype(np.float32)
    nrm = pos.copy()
    pos = pos * radius
    uv = np.stack([PH / (2 * np.pi), TH / np.pi], -1).reshape(-1, 2).astype(np.float32)

    def vid(i, j):
        return i * n_phi + (j % n_phi)

    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append((a, b, c))
            if i < n_theta - 1:
                faces.append((a, c, d))
    return HostMesh(positions=pos, indices=np.array(faces, np.int32), normals=nrm, uvs=uv)
