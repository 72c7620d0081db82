"""Shapes given by "file" (counterpart of zyg_tpu/io/mesh.py:104
load_mesh_file and :139 load_point_cloud_file): the procedural meshes
and point clouds (JSON geometry with point_list topology). Mesh files
(.obj, .json, .mesh, .sub) and glTF are refused."""

from __future__ import annotations

import json

import numpy as np

from ..scene.points import HostPoints
from ..scene.trimesh import HostMesh, make_cube_mesh, make_sphere_mesh, make_trefoil_mesh
from ..scene.types import UnsupportedScene


def load_mesh_file(path: str) -> HostMesh:
    """`proc:cube`, `proc:sphere`, `proc:trefoil` or `proc:trefoil-SEGxRING`
    (e.g. trefoil-512x480, 491,520 triangles)."""
    if not path.startswith("proc:"):
        raise UnsupportedScene(f"mesh file {path!r} (the port builds procedural meshes only)")
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
