"""SUB binary triangle meshes (counterpart of zyg_tpu/io/sub_mesh.py; ref
shape_provider.zig loadBinary).

Layout: ``b"SUB\\x00"``, a little-endian u64 JSON header size, the JSON
header ({"geometry": {parts, vertices {binary {offset, size},
num_vertices, layout [...]}, indices {binary {offset, size},
num_indices, encoding}}}), then the binary section, offsets relative to
its start:

- positions float32[num_frames][V][3] (the "Position" layout entry's
  num_frames; a deforming mesh has more than one);
- normals float32[V][3], or tangent-space quaternions float32[V][4]
  ("Tangent_space"), from which the normals are derived;
- tangents float32[V][3] (optional, skipped);
- uvs float32[V][2] (optional);
- indices u16/u32 as given, or Int16/Int32 deltas (each index the running
  sum of the values up to it).

A deforming mesh keeps its first frame as the positions and its LAST
frame as `positions_end`, the shutter-close endpoint; the frames between
are not read (the two-endpoint motion model of keyframed transforms).
gzip files are unwrapped by io/fs.py's open_stream.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..scene.trimesh import HostMesh


def read_sub_mesh(stream) -> HostMesh:
    """A HostMesh from a binary stream of a SUB file (ValueError if the
    magic is not SUB's)."""
    data = stream.read()
    if data[:3] != b"SUB":
        raise ValueError("not a SUB file")
    (json_size,) = struct.unpack_from("<Q", data, 4)
    root = json.loads(data[12:12 + json_size].rstrip(b"\x00"))
    geo = root["geometry"]
    binary_start = 12 + json_size

    vnode = geo["vertices"]
    num_vertices = int(vnode.get("num_vertices", 0))
    v_off = int(vnode.get("binary", {}).get("offset", 0))
    v_size = int(vnode.get("binary", {}).get("size", 0))
    num_pos_frames = 1
    has_uvs = has_tangents = quat_ts = False
    for entry in vnode.get("layout", []):
        sem = entry.get("semantic_name", "")
        if sem == "Position":
            num_pos_frames = int(entry.get("num_frames", 1))
        elif sem == "Tangent_space":
            quat_ts = True
        elif sem == "Tangent":
            has_tangents = True
        elif sem in ("TextureCoordinate", "Texture_coordinate"):
            has_uvs = True
    if num_vertices == 0:
        num_vertices = v_size // 48  # the legacy interleaved sizing

    inode = geo["indices"]
    i_off = int(inode.get("binary", {}).get("offset", 0))
    i_size = int(inode.get("binary", {}).get("size", 0))
    num_indices = int(inode.get("num_indices", 0))
    enc = inode.get("encoding", "UInt32")
    delta = enc in ("Int16", "Int32")
    if num_indices == 0:
        num_indices = i_size // (2 if enc in ("Int16", "UInt16") else 4)

    off = binary_start + v_off
    pos = np.frombuffer(data, "<f4", num_vertices * 3, off).reshape(-1, 3)
    pos_end = None
    if num_pos_frames > 1:
        last = off + 12 * num_vertices * (num_pos_frames - 1)
        pos_end = np.frombuffer(data, "<f4", num_vertices * 3, last).reshape(-1, 3)
    off += 12 * num_vertices * num_pos_frames
    if quat_ts:
        qs = np.frombuffer(data, "<f4", num_vertices * 4, off).reshape(-1, 4)
        off += 16 * num_vertices
        # the normal is +z turned by the tangent frame's quaternion
        x, y, z, w = qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3]
        nrm = np.stack([2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
                       axis=-1).astype(np.float32)
        uv = np.frombuffer(data, "<f4", num_vertices * 2, off).reshape(-1, 2)
    else:
        nrm = np.frombuffer(data, "<f4", num_vertices * 3, off).reshape(-1, 3)
        off += 12 * num_vertices
        if has_uvs and has_tangents:
            off += 12 * num_vertices
        uv = np.frombuffer(data, "<f4", num_vertices * 2, off).reshape(-1, 2) if has_uvs else None

    dt = {"Int16": "<i2", "UInt16": "<u2", "Int32": "<i4"}.get(enc, "<u4")
    raw = np.frombuffer(data, dt, num_indices, binary_start + i_off).astype(np.int64)
    if delta:
        raw = np.cumsum(raw)
    idx = raw.reshape(-1, 3).astype(np.int32)

    parts = None
    if "parts" in geo:
        parts = np.zeros(len(idx), np.int32)
        for pi, p in enumerate(geo["parts"]):
            start = int(p.get("start_index", 0)) // 3
            count = int(p.get("num_indices", 0)) // 3
            parts[start:start + count] = int(p.get("material_index", pi))

    return HostMesh(
        positions=np.ascontiguousarray(pos),
        indices=idx,
        normals=np.ascontiguousarray(nrm),
        uvs=np.ascontiguousarray(uv) if uv is not None else None,
        parts=parts,
        positions_end=np.ascontiguousarray(pos_end) if pos_end is not None else None,
    )


def write_sub_mesh(path: str, mesh: HostMesh, position_frames=None) -> None:
    """Write mesh as a separate-stream SUB file (the reference exporters'
    form). position_frames: a deforming mesh's per-frame [V, 3] vertex
    buffers (frame 0 first), written as one Position stream of
    num_frames frames. A mesh without normals gets area-weighted vertex
    normals (the format always carries them)."""
    pos = np.asarray(mesh.positions, "<f4")
    if mesh.normals is not None:
        nrm = np.asarray(mesh.normals, "<f4")
    else:
        idx3 = np.asarray(mesh.indices, np.int64)
        fn = np.cross(pos[idx3[:, 1]] - pos[idx3[:, 0]], pos[idx3[:, 2]] - pos[idx3[:, 0]])
        acc = np.zeros_like(pos, np.float64)
        for k in range(3):
            np.add.at(acc, idx3[:, k], fn)
        acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
        nrm = acc.astype("<f4")
    uv = np.asarray(mesh.uvs, "<f4") if mesh.uvs is not None else None
    idx = np.asarray(mesh.indices, "<u4").reshape(-1)

    if position_frames is not None and len(position_frames) > 1:
        num_frames = len(position_frames)
        pos_blob = b"".join(np.asarray(f, "<f4").tobytes() for f in position_frames)
    else:
        num_frames = 1
        pos_blob = pos.tobytes()
    layout = [{"semantic_name": "Position", "encoding": "Float32x3", "num_frames": num_frames},
              {"semantic_name": "Normal", "encoding": "Float32x3"}]
    v_blob = pos_blob + nrm.tobytes()
    if uv is not None:
        layout.append({"semantic_name": "Texture_coordinate", "encoding": "Float32x2"})
        v_blob += uv.tobytes()
    i_blob = idx.tobytes()

    if mesh.parts is not None:
        p = np.asarray(mesh.parts)
        parts = []
        for pi in np.unique(p):
            sel = np.flatnonzero(p == pi)
            parts.append({"start_index": int(sel[0]) * 3, "num_indices": int(len(sel)) * 3,
                          "material_index": int(pi)})
    else:
        parts = [{"start_index": 0, "num_indices": int(len(idx)), "material_index": 0}]
    header = {"geometry": {
        "parts": parts,
        "vertices": {"binary": {"offset": 0, "size": len(v_blob)}, "num_vertices": len(pos),
                     "layout": layout},
        "indices": {"binary": {"offset": len(v_blob), "size": len(i_blob)},
                    "num_indices": int(len(idx)), "encoding": "UInt32"},
    }}
    js = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(b"SUB\x00")
        f.write(struct.pack("<Q", len(js)))
        f.write(js)
        f.write(v_blob)
        f.write(i_blob)
