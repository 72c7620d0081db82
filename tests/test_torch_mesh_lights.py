"""Emissive meshes in the port (scene/loader.py's triangle tables and
primitive light trees, scene/light_sampling.py's triangle pick and hit
pdf, render/integrator/lighttracer.py's emission) against the JAX package
on the CPU, on a scene the test writes: a small trefoil over a floor, lit
by an emissive glTF panel of 512 triangles (a primitive light tree, by
zyg_tpu/scene/loader.py:194's _PRIM_TREE_MIN) and a 12-triangle emissive
proc:cube (the flat area CDF).

- The scene arrays are equal: lights.area, tri_offset, tri_count,
  tri_cdf, tri_idx, the primitive tree's arrays and its aux tables, and
  the scene's light tree over the two mesh lights.
- sample_light per lane on either light (the CDF's 24-step binary search
  and the tree's descent at the shading normal): the picked point within
  2e-6 on at least 99.95 % of the lanes (a descent that parts from XLA's
  near a split picks another triangle), and there pdfs within rtol 2e-5
  (the light tree test's select tolerance).
- light_hit_pdf on real hits of either light: within rtol 2e-5 with the
  tree's pdf folded on the panel, on all but 0.05 % of the lanes, where a
  tree node's importance rests on a cancellation (those within 1e-2).
- sample_light_from on the mesh lights: points within 5e-6, weights equal.
- The scene rendered by both Drivers at 48x32, 8 spp, PTMIS depth 4
  through kernel 6's plain bounce passes the golden gate (mean within
  1.5 %, 4x4 RMSE within 6 % of the mean).
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

N = 8192


def _panel(nx):
    """A flat nx x nx grid in the xz plane facing -y: positions, uint16
    indices, 2 (nx - 1)^2 triangles."""
    x, z = np.meshgrid(np.linspace(-0.5, 0.5, nx), np.linspace(-0.5, 0.5, nx), indexing="ij")
    pos = np.stack([x, np.zeros_like(x), z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(nx - 1)[:, None] * nx + np.arange(nx - 1)[None]
    idx = np.concatenate([np.stack([i, i + nx + 1, i + 1], -1).reshape(-1, 3),
                          np.stack([i, i + nx, i + nx + 1], -1).reshape(-1, 3)])
    return pos, idx.astype(np.uint16)


def write_emissive_glb(path, nx=17, emission=(1.0, 0.85, 0.6), strength=6.0):
    """A .glb of one emissive panel under a node that tilts and lifts it."""
    pos, idx = _panel(nx)
    blob = pos.tobytes() + idx.reshape(-1).tobytes()
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0, "translation": [0.0, 2.2, 0.3],
                      "rotation": [0.13052619, 0.0, 0.0, 0.99144486], "scale": [2.0, 1.0, 1.5]}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                       "material": 0}]}],
           "materials": [{"name": "panel", "emissiveFactor": list(emission),
                          "extensions": {"KHR_materials_emissive_strength":
                                         {"emissiveStrength": strength}}}],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(pos),
                          "type": "VEC3"},
                         {"bufferView": 1, "componentType": 5123, "count": idx.size,
                          "type": "SCALAR"}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
                           {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": idx.nbytes}],
           "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def mesh_light_root(glb: str, trefoil: str = "proc:trefoil-32x16") -> dict:
    return {
        "materials": [
            {"name": "grey", "rendering": {"Substitute": {"color": [0.6, 0.6, 0.6],
                                                          "roughness": 0.5}}},
            {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.45, 0.4]}}},
            {"name": "ember", "rendering": {"Light": {"emittance": {
                "spectrum": [1.0, 0.4, 0.2], "value": 3.0}}}},
        ],
        "entities": [
            {"type": "Prop", "shape": {"file": trefoil}, "materials": ["grey"],
             "transformation": {"position": [0, 0.6, 0], "scale": [0.3, 0.3, 0.3]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"position": [0, -0.3, 0], "rotation": [90, 0, 0],
                                "scale": [6, 6, 1]}},
            {"type": "Prop", "shape": {"file": glb}},
            {"type": "Light", "shape": {"file": "proc:cube"}, "materials": ["ember"],
             "transformation": {"position": [1.6, 0.1, -0.8], "rotation": [10, 30, 0],
                                "scale": [0.3, 0.4, 0.3]}},
        ],
    }


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict

    tmp = tmp_path_factory.mktemp("mesh_lights")
    write_emissive_glb(str(tmp / "panel.glb"))
    root = mesh_light_root("panel.glb")
    return jload(root, base_dir=str(tmp)), load_scene_dict(root, base_dir=str(tmp)), tmp


def test_mesh_light_arrays_match_jax(lit):
    from zyg_tpu_torch.scene import light_sampling as ls
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    js, ts, _ = lit
    a, b = scene_arrays(js), scene_arrays(ts)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert ls.light_shapes(ts) == {int(ShapeType.TRIANGLE_MESH)}
    assert b["lights.tri_count"].tolist() == [512, 12]
    # one primitive tree, the panel's (light 0)
    assert {k.split(".")[1] for k in b if k.startswith("mesh_light_trees.")} == {"0"}
    assert ts.light_tree is not None and ts.light_tree.num_finite == 2
    # the area: the panel's 2 x 1.5 world rectangle
    assert float(ts.lights.area[0]) == pytest.approx(3.0, rel=1e-5)


def _points(seed, n=N):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(-0.3, 1.2, n)
    ng = rng.normal(size=(n, 3)).astype(np.float32)
    ng[:, 1] = np.abs(ng[:, 1]) + 0.3
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    ns = ng + rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    return p, ng, ns.astype(np.float32), rng.random((n, 2)).astype(np.float32)


@pytest.mark.parametrize("light", [0, 1], ids=["tree_panel", "cdf_cube"])
def test_sample_light_on_mesh_lights_matches_jax(lit, light):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    js, ts, _ = lit
    p, ng, ns, xi = _points(4 + light)
    li = np.full(N, light, np.int32)

    @jax.jit
    def ref(li, p, n, ns, xi):
        s = jls.sample_light(js, li, p, n, xi, total_sphere=jnp.zeros(li.shape, bool), ns=ns)
        return s, jls.light_radiance(js, li, s.wi, s.light_n, s.uv)

    want, wrad = ref(*(jnp.asarray(x) for x in (li, p, ng, ns, xi)))
    t = torch.from_numpy
    got = tls.sample_light(ts, tls.light_shapes(ts), t(li), t(p), t(ng), t(xi), ns=t(ns))
    grad = tls.light_radiance(ts, t(li), got.wi, got.light_n, got.uv)
    jpdf, gpdf = np.asarray(want.pdf), got.pdf.numpy()
    same_point = np.abs(got.light_p.numpy() - np.asarray(want.light_p)).max(axis=1) < 2e-6
    # lanes whose tree descent parts from XLA's within 1e-6 of a split
    assert same_point.mean() >= 0.9995, same_point.mean()
    ok = same_point & (jpdf > 0)
    assert ok.mean() > 0.4
    np.testing.assert_array_equal(gpdf[same_point] > 0, jpdf[same_point] > 0)
    np.testing.assert_allclose(gpdf[ok], jpdf[ok], rtol=2e-5, atol=0)
    for name, a, b, tol in (("wi", got.wi, want.wi, 2e-6), ("light_n", got.light_n, want.light_n,
                                                             1e-6),
                            ("uv", got.uv, want.uv, 1e-6)):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=0, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(got.t_max.numpy()[ok], np.asarray(want.t_max)[ok], rtol=2e-6)
    np.testing.assert_array_equal(grad.numpy()[ok], np.asarray(wrad)[ok])
    # the tree picks by position: from one side of the panel its near
    # triangles are picked more often than the flat CDF would pick them
    if light == 0:
        cdf_pick = tls.pick_triangle(ts, t(li), t(xi[:, 0]))[0]
        assert not torch.equal(cdf_pick, tls._mesh_tree_pick(ts, t(li), cdf_pick,
                                                              ts.lights.area[t(li).long()],
                                                              t(p), t(ns), t(xi[:, 0]),
                                                              None)[0])


def test_light_hit_pdf_on_mesh_lights_matches_jax(lit):
    """Rays from the shading points toward sampled points of both lights,
    intersected by the port; the pdf of each hit on an emitter (the
    panel's with its tree pdf folded in) against the JAX light_hit_pdf."""
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.scene import light_sampling as tls
    from zyg_tpu_torch.scene import shapes

    js, ts, _ = lit
    p, ng, ns, xi = _points(7)
    li = (np.arange(N) % 2).astype(np.int32)
    t = torch.from_numpy
    s = tls.sample_light(ts, tls.light_shapes(ts), t(li), t(p), t(ng), t(xi), ns=t(ns))
    o = t(p) + 1e-3 * s.wi
    hit = shapes.intersect_scene(ts, prop_table(ts, "reflection"), o, s.wi, 0.0, 1e9)
    frag = shapes.build_fragment(ts, hit, o, s.wi)
    on = (ts.prop_light[hit.prop.clamp(min=0).long()] >= 0) & (hit.prop >= 0)
    assert float(on.float().mean()) > 0.3
    args = (hit.prop, t(p), s.wi, hit.t, frag.p, frag.geo_n, t(ns))
    ref = jax.jit(lambda prop, ro, rd, ht, hp, hn, no, pr: jls.light_hit_pdf(
        js, prop, ro, rd, ht, hp, hn, no, total_sphere=jnp.zeros(ro.shape[:1], bool),
        hit_prim=pr))(*(jnp.asarray(x.numpy()) for x in args + (hit.prim,)))
    got = tls.light_hit_pdf(ts, tls.light_shapes(ts), hit.prop, t(p), s.wi, hit.t, frag.geo_n,
                            hit_prim=hit.prim, n_at_origin=t(ns))
    want = np.asarray(ref)[on.numpy()]
    assert (want > 0).mean() > 0.99
    # the panel's pdf folds the tree's pdf of the hit triangle, a product
    # of ~10 levels' importance ratios: where a node's cone term rests on
    # a cancellation (rb ~1e-6 of its scale) the two packages' roundings
    # part by up to 1e-2 relative on rare lanes (the tree's pdf alone on
    # 65,536 seeded lanes: 7 beyond 2e-5, the largest 6.8e-3)
    rel = np.abs(got.numpy()[on.numpy()] - want) / want
    assert (rel <= 2e-5).mean() >= 0.9995 and rel.max() < 1e-2
    with pytest.raises(ValueError, match="hit_t and hit_n"):
        tls.light_hit_pdf(ts, tls.light_shapes(ts), hit.prop, t(p), s.wi)


def test_sample_light_from_on_mesh_lights_matches_jax(lit):
    from zyg_tpu.render.integrator.lighttracer import sample_light_from as jslf
    from zyg_tpu_torch.render.integrator.lighttracer import sample_light_from

    js, ts, _ = lit
    rng = np.random.default_rng(9)
    li = rng.integers(0, 2, N).astype(np.int32)
    xi = rng.random((N, 4)).astype(np.float32)
    side = rng.random(N).astype(np.float32)
    want = jax.jit(lambda li, xi, us: jslf(js, li, xi, u_side=us))(
        jnp.asarray(li), jnp.asarray(xi), jnp.asarray(side))
    got = sample_light_from(ts, torch.from_numpy(li), torch.from_numpy(xi),
                            torch.from_numpy(side))
    p, n, d, w, fin = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[4].numpy(), fin)
    assert fin.all()
    np.testing.assert_array_equal(got[3].numpy(), w)
    np.testing.assert_allclose(got[0].numpy(), p, rtol=0, atol=5e-6)
    np.testing.assert_allclose(got[1].numpy(), n, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[2].numpy(), d, rtol=0, atol=2e-6)


def test_mesh_light_scene_renders_like_jax(lit):
    """A small trefoil lit by the emissive glTF panel and the cube, through
    the loader's scene file: both Drivers at 48x32, 8 spp, PTMIS depth 4."""
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.scene.loader import load_scene_file as jscene
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    _, _, tmp = lit
    (tmp / "lit.scene").write_text(json.dumps(mesh_light_root("panel.glb")))
    take = {"scene": "lit.scene",
            "camera": {"Perspective": {"parameters": {"fov": 50},
                                       "transformation": {"position": [0, 1.4, -4.0],
                                                          "look_at": [0, 0.5, 0],
                                                          "up": [0, 1, 0]},
                                       "resolution": [48, 32]}},
            "sampler": {"Sobol": {"samples_per_pixel": 8}},
            "integrator": {"surface": {"PTMIS": {"depth": {"surface": 4}}}}}
    path = tmp / "lit.take"
    path.write_text(json.dumps(take))
    jt, tt = jtake.load_take_file(str(path)), ttake.load_take_file(str(path))
    jd = JDriver(take=jt, scene=jscene(jt.scene_filename))
    ref = jd.render_frame()
    ts = load_scene_file(tt.scene_filename)
    assert structural_ok_mesh_v2(ts) and ts.mesh_light_trees
    d = Driver(tt, ts, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (32, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
