"""Mesh shapes given by "file" (counterpart of zyg_tpu/io/mesh.py:104
load_mesh_file): the procedural kinds only. Mesh files (.obj, .json,
.mesh, .sub) and glTF are refused."""

from __future__ import annotations

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
