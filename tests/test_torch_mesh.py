"""The port's mesh host side and plain traversal against the JAX package:

- octahedral normal words: packing equal, unpacking bit-exact against the
  jitted JAX decode;
- the procedural meshes equal, array for array;
- the 8-wide BVH arena equal array for array (the same C++ builder, the
  same collapse), and the instance table equal for a rotated, non-
  uniformly scaled, translated instance;
- the plain closest-hit and any-hit walks against the jitted JAX
  `intersect_instances` on 4,096 seeded rays over that instance (the JAX
  arena handed across): hit ids exact except at exact-t ties, t/u/v
  within rtol 2e-5, any-hit exact;
- the plain walks against a brute-force loop over every triangle of two
  instances in float64, an oracle independent of both BVHs;
- the scene loader on a `proc:` trefoil scene against the JAX loader.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

RAY_MAX_T = np.float32(2.14748313e9)
# a rotated, non-uniformly scaled, translated instance: the quaternion
# convention of the instance table and the traversal must agree
EULER = [30.0, -50.0, 70.0]
POS = np.array([0.3, -0.2, 0.5], np.float32)
SCALE = np.array([0.35, 0.5, 0.3], np.float32)


def _rotated_scene(pkg):
    """The 48x32 trefoil as one rotated instance under a rectangle light,
    through either package's SceneBuilder (pkg: its scene.loader module)."""
    if pkg == "jax":
        from zyg_tpu.scene import loader, trimesh
    else:
        from zyg_tpu_torch.scene import loader, trimesh
    b = loader.SceneBuilder()
    grey = b.add_material(loader.MaterialDesc(color=np.full(3, 0.6, np.float32), roughness=0.5))
    lamp = b.add_material(loader.MaterialDesc(kind=2, emission=np.full(3, 30.0, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(48, 32))
    trafo = loader.Transformation(position=POS, rotation=loader.rotation_matrix_from_euler_degrees(EULER),
                                  scale=SCALE)
    b.add_mesh_prop(mid, trafo, grey)
    b.add_prop(loader.PropDesc(
        shape=5, trafo=loader.Transformation(position=np.array([0, 4.0, 0], np.float32),
                                             rotation=np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]],
                                                               np.float32),
                                             scale=np.array([3.0, 3.0, 1], np.float32)),
        material=lamp, is_light=True, visible_shadow=False,
    ))
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene built alike, port scene from the JAX arrays)."""
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    jscene = _rotated_scene("jax")
    return jscene, _rotated_scene("port"), scene_from_jax_arrays(scene_arrays(jscene))


def _rays(n, seed, aim=1.0):
    """Rays from [-3, 3]^3 aimed at points in [-aim, aim]^3."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-aim, aim, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32), tgt, rng


def test_oct_normal_words_match_jax():
    from zyg_tpu.core import encoding as je
    from zyg_tpu_torch.core import encoding as te

    rng = np.random.default_rng(1)
    n = rng.normal(size=(20000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    words = te.oct_normal_pack(n)
    np.testing.assert_array_equal(words, je.oct_normal_pack(n))
    # every packed word plus arbitrary bit patterns
    words = np.concatenate([words, rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)])
    ref = np.asarray(jax.jit(je.oct_normal_unpack)(jnp.asarray(words)))
    out = te.oct_normal_unpack(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kind", ["trefoil", "sphere", "cube"])
def test_procedural_meshes_match_jax(kind):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.scene import trimesh as T

    make = {"trefoil": lambda m: m.make_trefoil_mesh(48, 32),
            "sphere": lambda m: m.make_sphere_mesh(), "cube": lambda m: m.make_cube_mesh()}[kind]
    for a, b in zip(make(J), make(T)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _assert_same_arena(aj, at):
    for k in ("node_rows", "tri_rows", "attr_rows", "mesh_root"):
        x, y = np.asarray(getattr(aj, k)), getattr(at, k).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        # attr_rows hold normal words as float32 bit patterns (NaNs among them)
        np.testing.assert_array_equal(x.view(np.uint32) if x.dtype == np.float32 else x,
                                      y.view(np.uint32) if y.dtype == np.float32 else y, err_msg=k)
    assert next(iter(aj.meta))[0] == at.max_depth


@pytest.mark.parametrize("kind", ["trefoil", "sphere_and_cube"])
def test_build_arena_matches_jax(kind):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.scene import trimesh as T

    def make(m):
        if kind == "trefoil":
            return [m.make_trefoil_mesh(64, 40)]
        return [m.make_sphere_mesh(), m.make_cube_mesh()]

    _assert_same_arena(J.build_arena(make(J)), T.build_arena(make(T))[0])


def test_instance_table_matches_jax(scenes):
    jscene, port, _ = scenes
    _assert_same_arena(jscene.meshes, port.meshes)
    for k in ("wmin", "wmax", "trafo", "vis"):
        np.testing.assert_array_equal(np.asarray(getattr(jscene.mesh_instances, k)),
                                      getattr(port.mesh_instances, k).numpy(), err_msg=k)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_traversal_matches_jax(scenes, any_hit):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.ops import traverse

    jscene, _, port = scenes  # the port walks the JAX package's own arena
    aj, ij = jscene.meshes, jscene.mesh_instances
    n = 4096
    o, dirs, tgt, rng = _rays(n, 5)
    if any_hit:
        tmax = np.linalg.norm(tgt - o, axis=-1).astype(np.float32)
        tmax[rng.random(n) < 0.1] = 0.0
        ref = jax.jit(lambda o, d, t: J.intersect_instances(
            aj, ij, o, d, jnp.float32(0.0), t, "shadow", any_hit=True).prim >= 0)(o, dirs, tmax)
        out = traverse.intersect_instances(port.meshes, port.mesh_instances, torch.from_numpy(o),
                                           torch.from_numpy(dirs), 0.0, torch.from_numpy(tmax),
                                           "shadow", any_hit=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert 0 < int(out.sum()) < n
        return
    tmax = np.where(rng.random(n) < 0.1, 0.0, RAY_MAX_T).astype(np.float32)
    primary = rng.random(n) < 0.5
    r = jax.jit(lambda o, d, t, p: J.intersect_instances(
        aj, ij, o, d, jnp.float32(0.0), t, "reflection", primary=p))(o, dirs, tmax, primary)
    t, prim, u, v, prop = (x.numpy() for x in traverse.intersect_instances(
        port.meshes, port.mesh_instances, torch.from_numpy(o), torch.from_numpy(dirs), 0.0,
        torch.from_numpy(tmax), "reflection", torch.from_numpy(primary)))
    rt, rprim, ru, rv, rprop = (np.asarray(x) for x in (r.t, r.prim, r.u, r.v, r.prop))
    assert (rprim >= 0).sum() > n // 5
    differ = ((prim != rprim) | (prop != rprop)) & (t != rt)  # ids differ only at exact ties
    assert not differ.any(), np.nonzero(differ)[0][:8]
    for a, b in ((t, rt), (u, ru), (v, rv)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=0)


def _brute_force(mesh_list, instances, o, d, tmax):
    """float64 closest hit over every triangle of every instance: (t, the
    smallest barycentric margin of the hit)."""
    n = o.shape[0]
    best_t = np.full(n, np.inf)
    margin = np.zeros(n)
    for ins in instances:
        m = mesh_list[ins["mesh"]]
        rot = np.asarray(ins["rot"], np.float64)
        ol = ((o - ins["pos"]) @ rot.T) / ins["scale"]
        dl = (d @ rot.T) / ins["scale"]
        pos = m.positions.astype(np.float64)
        p0, p1, p2 = (pos[m.indices[:, k]] for k in range(3))
        e1, e2 = p1 - p0, p2 - p0
        for i in range(n):
            pvec = np.cross(dl[i], e2)
            det = np.einsum("ij,ij->i", e1, pvec)
            ok = np.abs(det) > 1e-12
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            tvec = ol[i] - p0
            u = np.einsum("ij,ij->i", tvec, pvec) * inv
            q = np.cross(tvec, e1)
            v = (q @ dl[i]) * inv
            t = np.einsum("ij,ij->i", e2, q) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0) & (t <= tmax[i])
            if hit.any():
                j = np.argmin(np.where(hit, t, np.inf))
                if t[j] < best_t[i]:
                    best_t[i] = t[j]
                    margin[i] = min(u[j], v[j], 1 - u[j] - v[j])
    return best_t, margin


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_traversal_matches_brute_force(any_hit):
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene import trimesh as T
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as trot

    mesh_list = [T.make_sphere_mesh(8, 12), T.make_cube_mesh()]
    arena, host = T.build_arena(mesh_list)
    instances = [dict(prop=1, mesh=0, rot=trot(EULER), pos=POS, scale=SCALE),
                 dict(prop=2, mesh=1, rot=trot([10.0, 20.0, -35.0]),
                      pos=np.array([-0.6, 0.3, -0.2], np.float32),
                      scale=np.array([0.5, 0.8, 0.6], np.float32), vis=(True, True, True))]
    itab = T.build_instance_table(host, instances)
    n = 512
    o, d, tgt, _ = _rays(n, 9, aim=0.5)
    tmax = (np.linalg.norm(tgt - o, axis=-1) if any_hit else np.full(n, RAY_MAX_T)).astype(np.float32)
    ref_t, margin = _brute_force(mesh_list, instances, o.astype(np.float64), d.astype(np.float64),
                                 tmax.astype(np.float64))
    ref_hit = np.isfinite(ref_t)
    robust = ~ref_hit | (margin > 1e-4)  # not grazing an edge
    assert ref_hit.sum() > n // 5
    out = traverse.intersect_instances(arena, itab, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                                       torch.from_numpy(tmax), "shadow" if any_hit else "reflection",
                                       any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(out.numpy()[robust], ref_hit[robust])
        return
    t, prim = out[0].numpy(), out[1].numpy()
    hit = prim >= 0
    np.testing.assert_array_equal(hit[robust], ref_hit[robust])
    both = hit & ref_hit
    np.testing.assert_allclose(t[both], ref_t[both], rtol=1e-4)


def test_loader_builds_mesh_scenes_like_jax(tmp_path):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict, scene_arrays

    with open("examples/scenes/trefoil.scene") as f:
        root = json.load(f)
    root["entities"][0]["shape"]["file"] = "proc:trefoil-64x40"
    a, b = scene_arrays(jload(root)), scene_arrays(load_scene_dict(root))
    assert sorted(a) == sorted(b)
    assert "meshes.node_rows" in b and "prop_groups.7" not in b
    for k in a:
        x, y = np.asarray(a[k]), b[k]
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("shape", [{"file": "proc:torus"}], ids=["unknown_proc"])
def test_loader_refuses_mesh_files(shape):
    from zyg_tpu_torch.scene.loader import UnsupportedScene, load_scene_dict

    with open("examples/scenes/trefoil.scene") as f:
        root = json.load(f)
    root["entities"][0]["shape"] = shape
    with pytest.raises(UnsupportedScene):
        load_scene_dict(root)
