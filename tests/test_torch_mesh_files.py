"""Mesh files and deforming meshes in the port (zyg_tpu_torch/io/mesh.py,
io/sub_mesh.py, io/gltf.py, scene/trimesh.py, ops/traverse.py,
scene/shapes.py) against the JAX package on the CPU: each reader on files
the tests write, the deforming arena bit for bit, the plain deforming
walk and the fragment at shutter times, and a deforming SUB mesh
rendered by both packages' Drivers."""

import base64
import json
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _same(a, b, name=""):
    """Equal arrays; float32 arrays bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _same_mesh(jm, tm):
    for k in ("positions", "indices", "normals", "uvs", "parts", "positions_end"):
        a, b = getattr(jm, k), getattr(tm, k)
        assert (a is None) == (b is None), k
        if a is not None:
            _same(a, b, k)


def _same_scene(js, ts):
    from zyg_tpu_torch.scene.loader import scene_arrays

    a, b = scene_arrays(js), scene_arrays(ts)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=k)
    return b


# ---------------------------------------------------------------------------
# files the tests write
# ---------------------------------------------------------------------------

OBJ_TEXT = """# two parts, negative and positive indices, a quad and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 -1
vn 0 0.7071 0.7071
usemtl wall
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl roof
f -5/1/2 -4/2/2 -1/3/2
usemtl wall
f 3/3/1 -2/4/2 -1/1/2
"""


def _write_sub(path, frames, quats, uvs, idx, enc):
    """A SUB file in the layout the reference's exporters write for
    deforming meshes: F position frames, tangent-space quaternions, uvs,
    and indices as enc ("Int16"/"Int32" deltas or "UInt16"/"UInt32")."""
    nv = frames[0].shape[0]
    v_blob = b"".join(np.asarray(f, "<f4").tobytes() for f in frames)
    v_blob += np.asarray(quats, "<f4").tobytes() + np.asarray(uvs, "<f4").tobytes()
    flat = np.asarray(idx, np.int64).reshape(-1)
    if enc in ("Int16", "Int32"):
        flat = np.diff(flat, prepend=0)
    dt = {"Int16": "<i2", "Int32": "<i4", "UInt16": "<u2", "UInt32": "<u4"}[enc]
    i_blob = flat.astype(dt).tobytes()
    header = {"geometry": {
        "parts": [{"start_index": 0, "num_indices": 6, "material_index": 1},
                  {"start_index": 6, "num_indices": len(flat) - 6, "material_index": 0}],
        "vertices": {"binary": {"offset": 0, "size": len(v_blob)}, "num_vertices": nv,
                     "layout": [{"semantic_name": "Position", "encoding": "Float32x3",
                                 "num_frames": len(frames)},
                                {"semantic_name": "Tangent_space", "encoding": "Float32x4"},
                                {"semantic_name": "Texture_coordinate",
                                 "encoding": "Float32x2"}]},
        "indices": {"binary": {"offset": len(v_blob), "size": len(i_blob)},
                    "num_indices": len(flat), "encoding": enc}}}
    js = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(b"SUB\x00" + struct.pack("<Q", len(js)) + js + v_blob + i_blob)


def _grid(nx, ny, seed):
    """A bumpy grid mesh: positions [V, 3], indices [F, 3], uvs [V, 2]."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(-1, 1, ny), indexing="ij")
    pos = np.stack([x, y, 0.1 * rng.standard_normal(x.shape)], -1).reshape(-1, 3).astype(
        np.float32)
    uv = np.stack([x, y], -1).reshape(-1, 2).astype(np.float32) * 0.5 + 0.5
    i = np.arange(nx - 1)[:, None] * ny + np.arange(ny - 1)[None]
    idx = np.concatenate([np.stack([i, i + ny, i + ny + 1], -1).reshape(-1, 3),
                          np.stack([i, i + ny + 1, i + 1], -1).reshape(-1, 3)]).astype(np.int32)
    return pos, idx, uv


def _gltf_doc(pos, idx, nrm, uv, emissive):
    """A glTF document (buffers to be filled) with a node tree: a root with
    TRS, a child by matrix holding a two-primitive mesh (the second with an
    emissive material), and a non-uniformly scaled child holding the
    first primitive again. Returns (doc, the buffer's bytes)."""
    blobs, views, accs = [], [], []

    def add(arr, ctype, atype, target):
        data = np.ascontiguousarray(arr).tobytes()
        off = sum(len(b) for b in blobs)
        blobs.append(data + b"\x00" * (-len(data) % 4))
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(data),
                      "target": target})
        accs.append({"bufferView": len(views) - 1, "componentType": ctype,
                     "count": int(arr.shape[0]), "type": atype})
        return len(accs) - 1

    p = add(pos, 5126, "VEC3", 34962)
    n = add(nrm, 5126, "VEC3", 34962)
    t = add(uv, 5126, "VEC2", 34962)
    i16 = add(idx.reshape(-1).astype(np.uint16), 5123, "SCALAR", 34963)
    i32 = add(idx[: len(idx) // 2].reshape(-1).astype(np.uint32), 5125, "SCALAR", 34963)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"children": [1, 2], "translation": [0.2, -0.1, 0.3],
             "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [1.5, 1.5, 1.5]},
            {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0.5, 0.4, 0, 1]},
            {"mesh": 1, "scale": [2.0, 0.5, 1.0], "translation": [0, 0, -0.6]},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": p, "NORMAL": n, "TEXCOORD_0": t},
                             "indices": i16, "material": 0},
                            {"attributes": {"POSITION": p}, "indices": i32, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": p, "NORMAL": n}, "indices": i16,
                             "material": 0}]},
        ],
        "materials": [
            {"name": "paint", "pbrMetallicRoughness": {
                "baseColorFactor": [0.7, 0.3, 0.2, 1.0], "metallicFactor": 0.0,
                "roughnessFactor": 0.6}},
            {"name": "glow", "emissiveFactor": list(emissive),
             "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 4.0}}},
        ],
        "accessors": accs,
        "bufferViews": views,
    }
    return doc, b"".join(blobs)


def write_gltf(path, doc, blob, external: bool):
    """doc with its buffer as a data URI (or an external .bin beside it)."""
    doc = json.loads(json.dumps(doc))
    if external:
        name = os.path.splitext(os.path.basename(path))[0] + ".bin"
        with open(os.path.join(os.path.dirname(path), name), "wb") as f:
            f.write(blob)
        doc["buffers"] = [{"byteLength": len(blob), "uri": name}]
    else:
        doc["buffers"] = [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                           + base64.b64encode(blob).decode()}]
    with open(path, "w") as f:
        json.dump(doc, f)


def write_glb(path, doc, blob):
    doc = dict(doc, buffers=[{"byteLength": len(blob)}])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def gltf_files(tmp_path, emissive=(1.0, 0.9, 0.7), nx=6, ny=5):
    """A .gltf (external .bin), a .gltf (data URI) and a .glb of one
    document; returns their paths."""
    pos, idx, uv = _grid(nx, ny, 5)
    nrm = np.tile(np.float32([[0.0, 0.0, 1.0]]), (len(pos), 1))
    nrm[::3] = [0.6, 0.0, 0.8]
    doc, blob = _gltf_doc(pos, idx, nrm.astype(np.float32), uv, emissive)
    paths = [str(tmp_path / "ext.gltf"), str(tmp_path / "uri.gltf"), str(tmp_path / "bin.glb")]
    write_gltf(paths[0], doc, blob, external=True)
    write_gltf(paths[1], doc, blob, external=False)
    write_glb(paths[2], doc, blob)
    return paths


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def test_obj_reader_matches_jax(tmp_path):
    from zyg_tpu.io.mesh import load_obj as jload
    from zyg_tpu_torch.io.mesh import load_obj, load_mesh_file

    path = tmp_path / "house.obj"
    path.write_text(OBJ_TEXT)
    jm, tm = jload(str(path)), load_obj(str(path))
    _same_mesh(jm, tm)
    assert tm.indices.shape == (4, 3) and tm.parts.tolist() == [0, 0, 1, 0]
    _same_mesh(jm, load_mesh_file(str(path)))


def test_json_mesh_reader_matches_jax(tmp_path):
    from zyg_tpu.io.mesh import load_json_mesh as jload
    from zyg_tpu_torch.io.mesh import load_json_mesh, load_mesh_file

    pos, idx, uv = _grid(4, 3, 1)
    geo = {"positions": pos.reshape(-1).tolist(), "indices": idx.reshape(-1).tolist(),
           "normals": np.tile([0.0, 0.0, 1.0], len(pos)).tolist(),
           "texture_coordinates_0": uv.reshape(-1).tolist(),
           "parts": [{"start_index": 0, "num_indices": 9}, {"start_index": 9,
                                                            "num_indices": 3 * len(idx) - 9}]}
    for name, root in (("a.json", {"geometry": geo}), ("b.mesh", geo)):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            json.dump(root, f)
        jm, tm = jload(path), load_json_mesh(path)
        _same_mesh(jm, tm)
        _same_mesh(jm, load_mesh_file(path))
        assert tm.parts.tolist() == [0, 0, 0] + [1] * (len(idx) - 3)
    path = str(tmp_path / "empty.json")
    with open(path, "w") as f:
        json.dump({"geometry": {"indices": []}}, f)
    assert jload(path) is None and load_json_mesh(path) is None


@pytest.mark.parametrize("enc", ["Int16", "Int32", "UInt16"])
def test_sub_reader_matches_jax(tmp_path, enc):
    """Delta (or plain) indices, quaternion tangent frames, uvs and three
    position frames: the last frame is the shutter-close endpoint."""
    from zyg_tpu.io.sub_mesh import read_sub_mesh as jread
    from zyg_tpu_torch.io.mesh import load_mesh_file
    from zyg_tpu_torch.io.sub_mesh import read_sub_mesh

    pos, idx, uv = _grid(5, 4, 2)
    rng = np.random.default_rng(7)
    frames = [pos + rng.normal(0, 0.05, pos.shape).astype(np.float32) * k for k in range(3)]
    q = rng.standard_normal((len(pos), 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    path = str(tmp_path / f"m_{enc}.sub")
    _write_sub(path, frames, q, uv, idx, enc)
    with open(path, "rb") as f:
        jm = jread(f)
    with open(path, "rb") as f:
        tm = read_sub_mesh(f)
    _same_mesh(jm, tm)
    _same(tm.indices, idx)
    _same(tm.positions_end, frames[2])
    _same_mesh(jm, load_mesh_file(path))
    assert tm.parts.tolist()[:2] == [1, 1]


def test_sub_writer_writes_the_jax_bytes(tmp_path):
    from zyg_tpu.io.sub_mesh import write_sub_mesh as jwrite
    from zyg_tpu.scene.trimesh import HostMesh as JMesh
    from zyg_tpu_torch.io.mesh import load_mesh_file
    from zyg_tpu_torch.io.sub_mesh import write_sub_mesh
    from zyg_tpu_torch.scene.trimesh import HostMesh

    pos, idx, uv = _grid(4, 4, 3)
    frames = [pos, pos + np.float32([0.3, 0.0, 0.1])]
    for kw in ({}, {"uvs": uv, "parts": (np.arange(len(idx)) % 2).astype(np.int32)}):
        a, b = str(tmp_path / "j.sub"), str(tmp_path / "t.sub")
        jwrite(a, JMesh(positions=pos, indices=idx, **kw), position_frames=frames)
        write_sub_mesh(b, HostMesh(positions=pos, indices=idx, **kw), position_frames=frames)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        m = load_mesh_file(b)
        _same(m.positions_end, frames[1])
    # a missing or malformed file drops the prop with a warning, as the JAX
    # reader returns None
    bad = tmp_path / "bad.sub"
    bad.write_bytes(b"NOPE")
    with pytest.warns(UserWarning, match="mesh load failed"):
        assert load_mesh_file(str(bad)) is None


def test_gltf_and_glb_load_like_jax(tmp_path):
    """Each file as a Prop entity under a transform: the props (baked node
    transforms, inverse-transpose normals), the materials (the emissive
    one a light) and the mesh-light arrays equal the JAX loader's."""
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict

    for path in gltf_files(tmp_path):
        root = {"entities": [{"type": "Prop", "shape": {"file": os.path.basename(path)},
                              "transformation": {"position": [0, 1, 0], "scale": [2, 2, 2]},
                              "entities": [{"type": "Prop", "shape": {"type": "Sphere"}}]}]}
        arrays = _same_scene(jload(root, base_dir=str(tmp_path)),
                             load_scene_dict(root, base_dir=str(tmp_path)))
        assert arrays["prop_shape"].tolist() == [7, 7, 7, 6]
        assert arrays["lights.tri_offset"].tolist() == [0]
        assert arrays["materials.kind"].tolist()[1:] == [0, 2]


def test_mesh_files_through_the_loader(tmp_path):
    """OBJ, JSON and SUB props load as the JAX loader loads them; one file
    named twice is one mesh; an unreadable file drops its prop with a
    warning, as the JAX loader drops it."""
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict

    (tmp_path / "house.obj").write_text(OBJ_TEXT)
    pos, idx, uv = _grid(5, 4, 2)
    rng = np.random.default_rng(7)
    frames = [pos, pos + rng.normal(0, 0.05, pos.shape).astype(np.float32)]
    q = np.tile(np.float32([[0, 0, 0, 1]]), (len(pos), 1))
    _write_sub(str(tmp_path / "sheet.sub"), frames, q, uv, idx, "Int32")
    with open(tmp_path / "geo.json", "w") as f:
        json.dump({"geometry": {"positions": pos.reshape(-1).tolist(),
                                "indices": idx.reshape(-1).tolist()}}, f)
    mats = [{"name": "lamp", "rendering": {"Light": {"emittance": {"value": 5}}}}]
    ents = [{"type": "Prop", "shape": {"file": f},
             "transformation": {"position": [k, 0, 0]}}
            for k, f in enumerate(["house.obj", "sheet.sub", "geo.json", "house.obj",
                                   "missing.obj"])]
    ents.append({"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"]})
    root = {"materials": mats, "entities": ents}
    with pytest.warns(UserWarning, match="dropped"):
        ts = load_scene_dict(root, base_dir=str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = jload(root, base_dir=str(tmp_path))
    arrays = _same_scene(js, ts)
    assert arrays["prop_shape"].tolist() == [7, 7, 7, 7, 5]
    assert ts.mesh_instances.trafo[:, 20].tolist()[0] == ts.mesh_instances.trafo[:, 20].tolist()[3]
    assert "meshes.tri_rows_d" in arrays


# ---------------------------------------------------------------------------
# the deforming arena, walk and fragment
# ---------------------------------------------------------------------------


def _deformed(M, seg=48, ring=32):
    m = M.make_trefoil_mesh(seg, ring)
    rng = np.random.default_rng(3)
    pe = m.positions + 0.15 * np.sin(3 * m.positions[:, [1, 2, 0]]) \
        + rng.normal(0, 0.01, m.positions.shape)
    return m._replace(positions_end=pe.astype(np.float32))


@pytest.fixture(scope="module")
def deforming():
    """Both packages' arenas over a deforming trefoil and a static sphere,
    and instance tables: a static one, and one whose deforming instance
    also moves."""
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.scene import trimesh as T
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    aj = J.build_arena([_deformed(J), J.make_sphere_mesh(8, 12)])
    at, ht = T.build_arena([_deformed(T), T.make_sphere_mesh(8, 12)])
    hj = {"node_rows": np.asarray(aj.node_rows), "mesh_root": np.asarray(aj.mesh_root)}
    still = [dict(prop=0, mesh=0, rot=np.eye(3, dtype=np.float32),
                  pos=np.zeros(3, np.float32), scale=np.full(3, 0.8, np.float32)),
             dict(prop=1, mesh=1, rot=np.eye(3, dtype=np.float32),
                  pos=np.float32([1.5, 0.2, 0.0]), scale=np.full(3, 0.7, np.float32))]
    moving = [dict(still[0], rot1=rot([0, 35, 10]), pos1=np.float32([0.4, 0.1, -0.2]),
                   scale1=np.full(3, 0.9, np.float32)), still[1]]
    tabs = {k: (J.build_instance_table(hj, v), T.build_instance_table(ht, v))
            for k, v in (("still", still), ("moving", moving))}
    return aj, at, tabs


def test_deforming_arena_matches_jax(deforming):
    aj, at, tabs = deforming
    for k in ("node_rows", "tri_rows", "attr_rows", "mesh_root", "tri_rows_d", "attr_rows_d"):
        _same(np.asarray(getattr(aj, k)), getattr(at, k).numpy(), k)
    assert at.max_depth == next(iter(aj.meta))[0]
    # the sphere does not deform: its delta rows are zero
    assert float(at.tri_rows_d.abs().sum()) > 0.0
    for k in ("wmin", "wmax", "trafo", "vis"):
        for jt, tt in tabs.values():
            _same(np.asarray(getattr(jt, k)), getattr(tt, k).numpy(), k)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = ((tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)).astype(np.float32)
    t = rng.random(n).astype(np.float32)
    t[:64], t[64:128] = 0.0, 1.0
    return o, d, tgt, t


@pytest.mark.parametrize("table", ["still", "moving"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_deforming_walk_matches_jax(deforming, table, any_hit):
    """The plain walk at seeded shutter times (0 and 1 on some lanes)
    against J.intersect_instances(time=t); without times a deforming
    arena walks at the shutter's start."""
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.ops import traverse

    aj, at, tabs = deforming
    ij, it = tabs[table]
    n = 4096
    o, d, tgt, tm = _rays(n, 31)
    to, td, tt = (torch.from_numpy(x) for x in (o, d, tm))
    if any_hit:
        tmax = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
        ref = np.asarray(jax.jit(lambda o, d, tm, t: J.intersect_instances(
            aj, ij, o, d, jnp.float32(0.0), tm, "shadow", time=t, any_hit=True).prim >= 0)(
                o, d, tmax, tm))
        out = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax), "shadow",
                                           any_hit=True, time=tt).numpy()
        assert 0 < ref.sum() < n and (out == ref).mean() >= 0.999
        return
    tmax = np.full(n, 1e9, np.float32)
    r = jax.jit(lambda o, d, t: J.intersect_instances(aj, ij, o, d, jnp.float32(0.0),
                                                      jnp.asarray(tmax), "reflection",
                                                      time=t))(o, d, tm)
    t, prim, u, v, prop = (x.numpy() for x in traverse.intersect_instances(
        at, it, to, td, 0.0, torch.from_numpy(tmax), "reflection", time=tt))
    rprim, rprop = np.asarray(r.prim), np.asarray(r.prop)
    assert (rprim >= 0).sum() > n // 5 and {0, 1} <= set(rprop.tolist())
    same = (prim == rprim) & (prop == rprop)
    assert same.mean() >= 0.999
    hit = same & (rprim >= 0)
    np.testing.assert_allclose(t[hit], np.asarray(r.t)[hit], rtol=1e-5)
    # the deformation shows: at the shutter's start the rays hit elsewhere
    if table == "still":
        t0 = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax),
                                          "reflection")
        tz = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax),
                                          "reflection", time=torch.zeros(n))
        assert all(torch.equal(a, b) for a, b in zip(t0, tz))
        assert (t0[1].numpy() != prim).mean() > 0.02
    else:
        with pytest.raises(ValueError, match="shutter times"):
            traverse.intersect_instances(at, it, to, td, 0.0, 1e9)


def test_deforming_fragment_matches_jax(tmp_path):
    """The fragment of a deforming SUB mesh's hits: the geometric normal
    at each lane's shutter time (and frame 0's shading normal) within
    1e-6 of the JAX fragment."""
    from zyg_tpu.scene import shapes as J
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.io.sub_mesh import write_sub_mesh
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.scene import shapes as T
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import load_scene_dict

    m = _deformed(trimesh, 32, 24)
    write_sub_mesh(str(tmp_path / "knot.sub"), m, position_frames=[m.positions, m.positions_end])
    root = {"materials": [{"name": "lamp", "rendering": {"Light": {"emittance": {"value": 3}}}}],
            "entities": [{"type": "Prop", "shape": {"file": "knot.sub"},
                          "transformation": {"rotation": [20, 30, 0], "scale": [0.6, 0.6, 0.6]}},
                         {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"],
                          "transformation": {"position": [0, 3, 0], "rotation": [-90, 0, 0]}}]}
    js, ts = jload(root, base_dir=str(tmp_path)), load_scene_dict(root, base_dir=str(tmp_path))
    _same_scene(js, ts)
    n = 2048
    o, d, _, tm = _rays(n, 17)
    to, td, tt = (torch.from_numpy(x) for x in (o, d, tm))
    hit = T.intersect_scene(ts, prop_table(ts, "reflection"), to, td, 0.0, 1e9, time=tt)
    assert int((hit.prim >= 0).sum()) > n // 8
    frag = T.build_fragment(ts, hit, to, td, time=tt)
    jhit = J.Hit(t=jnp.asarray(hit.t.numpy()), prop=jnp.asarray(hit.prop.numpy()),
                 u=jnp.asarray(hit.u.numpy()), v=jnp.asarray(hit.v.numpy()),
                 prim=jnp.asarray(hit.prim.numpy()))
    jf = J.build_fragment(js, jhit, jnp.asarray(o), jnp.asarray(d), time=jnp.asarray(tm))
    on = (hit.prim >= 0).numpy()
    for name, a, b in (("geo_n", frag.geo_n, jf.geo_n), ("n", frag.n, jf.n), ("p", frag.p, jf.p)):
        np.testing.assert_allclose(a.numpy()[on], np.asarray(b)[on], atol=1e-6, err_msg=name)
    # the geometric normal follows the deformation; at time 0 it is frame 0's
    f0 = T.build_fragment(ts, hit, to, td, time=torch.zeros(n))
    assert float((f0.geo_n - frag.geo_n).abs().amax(dim=1)[hit.prim >= 0].mean()) > 1e-3
    assert torch.equal(f0.n, frag.n)


# ---------------------------------------------------------------------------
# a render
# ---------------------------------------------------------------------------


def test_sliding_quad_sub_renders_like_jax(tmp_path):
    """tests/test_motion.py's sliding quad (a quad whose second position
    frame moves it 2 along x over the shutter, under a uniform dome),
    loaded from its .sub by a scene file: the port's Driver against the
    JAX Driver at the golden gate, and the smear is there."""
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.scene.loader import load_scene_file as jscene
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.io.sub_mesh import write_sub_mesh
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.trimesh import HostMesh

    pos = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    write_sub_mesh(str(tmp_path / "slide.sub"), HostMesh(positions=pos, indices=idx),
                   position_frames=[pos, pos + np.array([2.0, 0, 0], np.float32)])
    scene = {"materials": [
        {"name": "white", "rendering": {"Substitute": {"color": [0.9, 0.9, 0.9]}}},
        {"name": "sky", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
        "entities": [
            {"type": "Prop", "shape": {"file": "slide.sub"}, "materials": ["white"]},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"],
             "visibility": {"in_shadow": False}}]}
    (tmp_path / "slide.scene").write_text(json.dumps(scene))
    take = {"scene": "slide.scene",
            "camera": {"Perspective": {"parameters": {"fov": 60},
                                       "transformation": {"position": [1.0, 0, -3.0]},
                                       "resolution": [48, 16]}},
            "sampler": {"Sobol": {"samples_per_pixel": 32}},
            "integrator": {"surface": {"PTMIS": {"depth": {"surface": 2}}}}}
    tpath = tmp_path / "slide.take"
    tpath.write_text(json.dumps(take))
    jt, tt = jtake.load_take_file(str(tpath)), ttake.load_take_file(str(tpath))
    jd = JDriver(take=jt, scene=jscene(jt.scene_filename))
    ref = jd.render_frame()
    ts = load_scene_file(tt.scene_filename)
    assert ts.meshes.tri_rows_d is not None
    d = Driver(tt, ts, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (16, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    row = img[8, :, 0]
    sky = np.median(row[:4])
    assert ((row > sky * 1.05) | (row < sky * 0.95)).sum() > 16
