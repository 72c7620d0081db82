"""glTF 2.0 import (counterpart of zyg_tpu/io/gltf.py; ref
util/gltf_loader.zig): meshes, node transforms and PBR materials into a
SceneBuilder.

Reads .gltf (buffers as data URIs or external files beside it) and .glb
(the binary container); triangle primitives with POSITION, NORMAL and
TEXCOORD_0; u8/u16/u32 indices; node TRS or matrix transforms, composed
down the default scene's node tree and baked into the vertices (normals
by the inverse transpose); pbrMetallicRoughness materials (base colour,
metallic and roughness factors, the base-colour texture through the
builder's `load_texture`), and an emissive factor (times
KHR_materials_emissive_strength) makes the material a light and its
primitives emissive meshes.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from ..scene.trimesh import HostMesh
from ..scene.types import MaterialKind

_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
              5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_glb(data: bytes):
    """(JSON document, BIN chunk or None) of a GLB container."""
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    doc, bin_chunk = None, None
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        if ctype == 0x4E4F534A:  # JSON
            doc = json.loads(chunk.decode())
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
        off += 8 + clen
    return doc, bin_chunk


class GltfFile:
    """A glTF document and its buffers, read on demand."""

    def __init__(self, path: str):
        self.base_dir = os.path.dirname(path)
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".glb") or data[:4] == b"glTF":
            self.doc, bin_chunk = _load_glb(data)
            self._buffers = [bin_chunk]
        else:
            self.doc = json.loads(data.decode())
            self._buffers = [None] * len(self.doc.get("buffers", []))

    def buffer(self, i: int) -> bytes:
        if self._buffers[i] is None:
            uri = self.doc["buffers"][i].get("uri", "")
            if uri.startswith("data:"):
                self._buffers[i] = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.base_dir, uri), "rb") as f:
                    self._buffers[i] = f.read()
        return self._buffers[i]

    def accessor(self, idx: int) -> np.ndarray:
        """Accessor idx as a [count, components] array (strided views
        gathered row by row)."""
        acc = self.doc["accessors"][idx]
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffer(view.get("buffer", 0))
        dtype = _COMPONENT[acc["componentType"]]
        ncomp = _NCOMP[acc["type"]]
        count = acc["count"]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", 0)
        if stride and stride != np.dtype(dtype).itemsize * ncomp:
            out = np.stack([np.frombuffer(buf, dtype, count=ncomp, offset=offset + k * stride)
                            for k in range(count)])
        else:
            out = np.frombuffer(buf, dtype, count=count * ncomp, offset=offset).reshape(count,
                                                                                      ncomp)
        return np.array(out)


def _node_matrix(node: dict) -> np.ndarray:
    """A node's local transform as a float32 4x4 acting on columns."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    rot = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m[:3, :3] = rot @ np.diag(s)
    m[:3, 3] = t
    return m


def load_gltf_into(builder, path: str, parent_trafo=None) -> list[int]:
    """Load the glTF file at path into builder (scene/loader.py's
    SceneBuilder): its materials, then one mesh prop a triangle primitive
    under parent_trafo, the node transforms baked into the vertices.
    Returns the new prop ids."""
    from ..scene.loader import MaterialDesc, Transformation

    g = GltfFile(path)
    doc = g.doc
    parent = parent_trafo or Transformation()

    mat_ids = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        desc = MaterialDesc()
        desc.color = np.asarray(pbr.get("baseColorFactor", [0.8, 0.8, 0.8, 1.0])[:3], np.float32)
        desc.metallic = float(pbr.get("metallicFactor", 1.0))
        desc.roughness = float(pbr.get("roughnessFactor", 1.0))
        tex_idx = pbr.get("baseColorTexture", {}).get("index", -1)
        if tex_idx >= 0:
            img_idx = doc["textures"][tex_idx].get("source", -1)
            if img_idx >= 0:
                uri = doc["images"][img_idx].get("uri", "")
                if uri and not uri.startswith("data:"):
                    t = builder.load_texture(os.path.join(g.base_dir, uri), srgb=True)
                    if t >= 0:
                        desc.color_tex = t
                        desc.color = np.ones(3, np.float32)
        em = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = m.get("extensions", {}).get("KHR_materials_emissive_strength", {})
        em = em * float(strength.get("emissiveStrength", 1.0))
        if em.max() > 0.0:
            desc.kind = int(MaterialKind.LIGHT)
            desc.emission = em
        mat_ids.append(builder.add_material(desc, name=m.get("name")))

    roots = doc.get("scenes", [{}])[doc.get("scene", 0)].get("nodes", [])
    created: list[int] = []

    def walk(node_idx: int, acc: np.ndarray):
        node = doc["nodes"][node_idx]
        world = acc @ _node_matrix(node)
        for prim_i, prim in enumerate(doc["meshes"][node["mesh"]].get("primitives", [])
                                      if "mesh" in node else []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).reshape(-1, 3).astype(np.int32)
            else:
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            nrm = g.accessor(attrs["NORMAL"]).astype(np.float32) if "NORMAL" in attrs else None
            uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32) if "TEXCOORD_0" in attrs
                  else None)
            pw = pos @ world[:3, :3].T + world[:3, 3]
            nw = None
            if nrm is not None:
                inv_t = np.linalg.inv(world[:3, :3]).T  # normals by the inverse transpose
                nw = nrm @ inv_t.T
                nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-9)
            mid = builder.add_mesh(HostMesh(positions=pw, indices=idx, normals=nw, uvs=uv),
                                   name=f"{path}#{node_idx}.{prim_i}")
            mat = prim.get("material", -1)
            own = 0 <= mat < len(mat_ids)
            created.append(builder.add_mesh_prop(
                mid, Transformation(parent.position.copy(), parent.rotation.copy(),
                                    parent.scale.copy()),
                mat_ids[mat] if own else builder._fallback,
                is_light=own and builder.materials[mat_ids[mat]].kind == int(MaterialKind.LIGHT)))
        for child in node.get("children", []):
            walk(child, world)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    return created
