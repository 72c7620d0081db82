"""Shapes given by "file" (counterpart of zyg_tpu/io/mesh.py): Wavefront
OBJ (`load_obj`), zyg JSON geometry (`load_json_mesh`), SUB meshes
(io/sub_mesh.py, deforming ones too), the procedural 'proc:' meshes
(`load_mesh_file` dispatches on the name as zyg_tpu/io/mesh.py:104-134
does) and point clouds (JSON geometry with point_list topology). glTF
files expand into props of their own (io/gltf.py, scene/loader.py)."""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from ..scene.points import HostPoints
from ..scene.trimesh import HostMesh, make_cube_mesh, make_sphere_mesh, make_trefoil_mesh
from ..scene.types import UnsupportedScene


def load_obj(path: str) -> HostMesh:
    """A Wavefront OBJ mesh: each distinct v/vt/vn corner becomes one vertex
    (corners keyed by their text), polygons fan-triangulated, negative
    indices counted from the end, each `usemtl` name a part (numbered in
    order of first use)."""
    positions: list = []
    normals: list = []
    uvs: list = []
    corner_map: dict = {}
    out_pos: list = []
    out_n: list = []
    out_uv: list = []
    faces: list = []
    parts: list = []
    part = 0
    seen_usemtl: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("usemtl"):
                name = line.split(maxsplit=1)[1].strip() if " " in line else ""
                part = seen_usemtl.setdefault(name, len(seen_usemtl))
            elif line.startswith("f "):
                ids = []
                for c in line.split()[1:]:
                    if c not in corner_map:
                        vi, ti, ni = (c.split("/") + ["", ""])[:3]
                        vi = int(vi)
                        out_pos.append(positions[vi - 1 if vi > 0 else len(positions) + vi])
                        if ni:
                            k = int(ni)
                            out_n.append(normals[k - 1 if k > 0 else len(normals) + k])
                        if ti:
                            k = int(ti)
                            out_uv.append(uvs[k - 1 if k > 0 else len(uvs) + k])
                        corner_map[c] = len(out_pos) - 1
                    ids.append(corner_map[c])
                for k in range(1, len(ids) - 1):
                    faces.append([ids[0], ids[k], ids[k + 1]])
                    parts.append(part)
    return HostMesh(
        positions=np.asarray(out_pos, np.float32),
        indices=np.asarray(faces, np.int32),
        normals=np.asarray(out_n, np.float32) if len(out_n) == len(out_pos) else None,
        uvs=np.asarray(out_uv, np.float32) if len(out_uv) == len(out_pos) else None,
        parts=np.asarray(parts, np.int32),
    )


def load_json_mesh(path: str) -> HostMesh | None:
    """zyg JSON geometry (ref shape_provider.zig loadData): "geometry" (or
    the root) with positions (or vertices), indices, optional normals,
    texture_coordinates_0 (or uvs) and parts ({start_index, num_indices}
    each, numbered in order). None without positions."""
    with open(path) as f:
        root = json.load(f)
    geo = root.get("geometry", root)
    if "positions" not in geo and "vertices" not in geo:
        return None
    pos = np.asarray(geo.get("positions", geo.get("vertices")), np.float32).reshape(-1, 3)
    idx = np.asarray(geo["indices"], np.int32).reshape(-1, 3)
    nrm = geo.get("normals")
    uv = geo.get("texture_coordinates_0", geo.get("uvs"))
    parts = None
    if "parts" in geo:
        parts = np.zeros(len(idx), np.int32)
        for pi, p in enumerate(geo["parts"]):
            start = int(p.get("start_index", 0)) // 3
            count = int(p.get("num_indices", 0)) // 3
            parts[start:start + count] = pi
    return HostMesh(
        positions=pos,
        indices=idx,
        normals=np.asarray(nrm, np.float32).reshape(-1, 3) if nrm is not None else None,
        uvs=np.asarray(uv, np.float32).reshape(-1, 2) if uv is not None else None,
        parts=parts,
    )


def _proc_mesh(path: str) -> HostMesh:
    """`proc:cube`, `proc:sphere`, `proc:trefoil` or `proc:trefoil-SEGxRING`
    (e.g. trefoil-512x480, 491,520 triangles)."""
    kind = path.split(":", 1)[1]
    if kind == "cube":
        return make_cube_mesh()
    if kind.startswith("sphere"):
        return make_sphere_mesh()
    if kind.startswith("trefoil"):
        if "-" in kind:
            seg, ring = (int(x) for x in kind.split("-", 1)[1].split("x"))
            return make_trefoil_mesh(seg, ring)
        return make_trefoil_mesh(512, 480)
    raise UnsupportedScene(f"procedural mesh {path!r}")


def load_mesh_file(path: str) -> HostMesh | None:
    """The mesh at path (already resolved against the scene's directory):
    a 'proc:' name, or by extension .obj, .sub (gzip too) or .json/.mesh.
    A file that cannot be read, or another extension, gives None with a
    warning, and the loader then drops the prop, as the JAX loader does;
    an unknown procedural name raises UnsupportedScene."""
    if path.startswith("proc:"):
        return _proc_mesh(path)
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".obj":
            return load_obj(path)
        if ext == ".sub":
            from .fs import open_stream
            from .sub_mesh import read_sub_mesh

            with open_stream(path) as f:
                return read_sub_mesh(f)
        if ext in (".json", ".mesh"):
            return load_json_mesh(path)
    except (OSError, ValueError, KeyError) as e:
        warnings.warn(f"mesh load failed {path}: {e}; the prop is dropped", stacklevel=2)
        return None
    warnings.warn(f"mesh file {path!r}: unknown format; the prop is dropped", stacklevel=2)
    return None


def is_point_cloud_file(path: str) -> bool:
    """A JSON geometry file whose first 4 KiB name the point_list topology
    (zyg_tpu/scene/loader.py:1572 _is_point_cloud_file)."""
    if not path.endswith((".json", ".mesh")):
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
    except OSError:
        return False
    return b"point_list" in head


def load_point_cloud_file(path: str) -> HostPoints:
    """JSON point-list geometry -> HostPoints (ref shape_provider.zig
    PointList), in either layout:
    - the particle exporter's (ref particle_exporter.zig): "vertices":
      {"positions": [[frame 0 xyz...], [frame 1 ...], ...],
      "radius_samples": [...]} with "frames_per_second" (default 120) and
      "start_frame": a simulation stack that scene/points.py
      resolve_motion samples at a frame's shutter;
    - flat "positions" with optional "radii" and "positions_end".
    A missing radius is "point_radius" (default 0.01)."""
    with open(path, encoding="utf-8") as f:
        root = json.load(f)
    geo = root.get("geometry", root)
    verts = geo.get("vertices")
    radius = float(geo.get("point_radius", 0.01))
    if (isinstance(verts, dict) and isinstance(verts.get("positions"), list)
            and verts["positions"] and isinstance(verts["positions"][0], list)):
        pf = np.asarray(verts["positions"], np.float32)
        pf = pf.reshape(pf.shape[0], -1, 3)  # [F, P, 3]
        rs = verts.get("radius_samples")
        rf = np.asarray(rs, np.float32).reshape(pf.shape[0], -1) if rs else None
        return HostPoints(
            positions=pf[0],
            radii=rf[0] if rf is not None else np.full(pf.shape[1], radius, np.float32),
            position_frames=pf,
            radius_frames=rf,
            fps=float(geo.get("frames_per_second", 0.0)) or 120.0,
            start_frame=int(geo.get("start_frame", 0)),
        )
    pos = np.asarray(geo.get("positions", verts), np.float32).reshape(-1, 3)
    r = geo.get("radii")
    pe = geo.get("positions_end")
    return HostPoints(
        positions=pos,
        radii=(np.asarray(r, np.float32).reshape(-1) if r is not None
               else np.full(len(pos), radius, np.float32)),
        positions_end=np.asarray(pe, np.float32).reshape(-1, 3) if pe is not None else None,
    )
