"""The port's light tree (scene/light_tree.py) against the JAX package's
(zyg_tpu/scene/light_tree.py), in the manner of tests/test_light_tree.py's
many_light_scene but with rectangle lamps only: numpy-seeded scenes of two
to six downward-facing rectangle lamps of different powers under a
constant Dome, over a floor with a sphere and a metal cube, loaded by each
package's own loader.

- The scene arrays through scene_arrays are equal: the tree's node
  arrays, depth, infinite weight and finite count, and the power CDF.
- select on 20,000 seeded shading points: light indices exact, except on
  lanes within 1e-6 of a split point (the count is asserted: none on
  these lanes), pdfs within rtol 2e-5; pdf of given light indices
  (finite, the dome, none) within rtol 1e-5 plus 1e-6 absolute; and the
  port's own identity pdf(select(u)) = select(u).pdf within rtol 1e-5
  (the descent takes 1 - w0 / wt where the walk takes w1 / wt). XLA
  fuses the importance's products differently inside select and inside
  pdf, and the port rounds as XLA's pdf does: select's pdf reaches
  1.27e-5 relative on 2 of the 3-lamp scene's 20,000 lanes, and pdf
  2.3e-5 relative (1.5e-7 absolute) on one lane of 0.0039 of the
  6-lamp scene's; over six seeds no pdf differs by more than 8.2e-7.
- The gates: the fused Cornell bounce (kernel 3) and the mesh bounce
  (kernel 5) refuse a scene with a tree, as the JAX gates do, and take it
  without one; the general bounce (kernel 6) takes it.
- The four-lamp scene rendered by both Drivers at 64x64, 8 spp, PTMIS
  depth 4 passes the golden gate (mean within 1.5 %, 4x4 RMSE within 6 %
  of the mean), with rays within 1e-3 and iterations within 2.
- A tree of 16 finite lights with a positive split threshold, where the
  JAX Driver splits NEE, is refused by the port's Driver.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

N = 20000
RES = (64, 64)
SPP = 8


def tree_scene(num, seed=None, mesh=False):
    """Scene dict: num rectangle lamps facing down (seeded positions,
    tilts, sizes and powers), a constant dome, a floor, a sphere (a
    proc:sphere mesh with mesh=True, else analytic) and a metal cube."""
    rng = np.random.default_rng(num if seed is None else seed)
    mats = [{"name": f"l{i}", "rendering": {"Light": {"emittance": {
        "value": float(rng.uniform(4, 20))}}}} for i in range(num)]
    ents = [{"type": "Light", "shape": {"type": "Rectangle"}, "materials": [f"l{i}"],
             "transformation": {
                 "position": [float(x) for x in rng.uniform([-2.5, 2.0, -2.5], [2.5, 3.5, 2.5])],
                 "rotation": [float(rng.uniform(-110, -70)), float(rng.uniform(0, 360)), 0],
                 "scale": [float(x) for x in rng.uniform(0.4, 1.2, 2)] + [1]}}
            for i in range(num)]
    mats += [{"name": "sky", "rendering": {"Light": {"emittance": {"value": 0.2}}}},
             {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5],
                                                            "roughness": 0.7}}},
             {"name": "ball", "rendering": {"Substitute": {"color": [0.7, 0.3, 0.2],
                                                           "roughness": 0.3}}},
             {"name": "box", "rendering": {"Substitute": {"color": [0.9, 0.8, 0.5],
                                                          "roughness": 0.2, "metallic": 1.0}}}]
    ball = {"file": "proc:sphere"} if mesh else {"type": "Sphere"}
    ents += [{"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
             {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
              "transformation": {"rotation": [90, 0, 0], "scale": [12, 12, 1]}},
             {"type": "Prop", "shape": ball, "materials": ["ball"],
              "transformation": {"position": [-0.8, 0.7, 0.3], "scale": [1.4, 1.4, 1.4]}},
             {"type": "Prop", "shape": {"type": "Cube"}, "materials": ["box"],
              "transformation": {"position": [1.0, 0.5, -0.4], "rotation": [0, 25, 0],
                                 "scale": [1, 1, 1]}}]
    return {"materials": mats, "entities": ents}


def _lamps_only(d):
    """The scene without its dome: rectangle lamps only (Cornell-class)."""
    d = dict(d)
    d["entities"] = [e for e in d["entities"] if e.get("shape", {}).get("type") != "Dome"]
    return d


def _load(d):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    return jload(d), tload(d)


@pytest.fixture(scope="module", params=[2, 3, 6], ids=lambda n: f"{n}lamps")
def scenes(request):
    return _load(tree_scene(request.param))


def _lanes(seed=1):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return p, n, rng.random(N).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(a), 1e-30)


def test_tree_scene_arrays_match_jax(scenes):
    from zyg_tpu_torch.scene.loader import scene_arrays

    js, ps = scenes
    a, b = scene_arrays(js), scene_arrays(ps)
    assert sorted(a) == sorted(b)
    assert {"light_tree.center", "light_tree.depth", "light_tree.inf_weight",
            "light_tree.num_finite", "lights.cdf"} <= set(a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ps.light_tree.inf_weight == js.light_tree.inf_weight > 0.0


def _split_margin(tree, p, n, u):
    """The smallest distance of each lane's descent variable to a split
    point it compares against (the infinite split, then each level's p0),
    replaying the port's descent."""
    from zyg_tpu_torch.scene import light_tree as lt

    w = np.float32(tree.inf_weight)
    margin = torch.abs(u - float(w))
    node = torch.zeros(u.shape, dtype=torch.int64)
    r = torch.clamp((u - float(w)) * lt._recip(max(1.0 - tree.inf_weight, 1e-12)), 0.0, 1.0)
    fin = u >= float(w)
    for _ in range(tree.depth):
        c0 = tree.child0[node].long()
        leaf = c0 < 0
        c0c = torch.clamp(c0, min=0)
        w0 = lt._node_importance(tree, c0c, p, n)
        w1 = lt._node_importance(tree, c0c + 1, p, n)
        wt = w0 + w1
        p0 = torch.where(wt > 0.0, w0 / torch.clamp(wt, min=1e-20), 0.5)
        margin = torch.where(fin & ~leaf, torch.minimum(margin, torch.abs(r - p0)), margin)
        go0 = r < p0
        r_new = torch.where(go0, r / torch.clamp(p0, min=1e-12),
                            (r - p0) / torch.clamp(1.0 - p0, min=1e-12))
        node = torch.where(leaf, node, torch.where(go0, c0c, c0c + 1))
        r = torch.where(leaf, r, torch.clamp(r_new, 0.0, 1.0))
    return margin


def test_select_matches_jax(scenes):
    from zyg_tpu.scene import light_tree as jlt
    from zyg_tpu_torch.scene import light_tree as tlt

    js, ps = scenes
    p, n, u = _lanes()
    jtree = js.light_tree
    ji, jp = jax.jit(lambda p, n, u: jlt.select(jtree, p, n, False, u))(p, n, u)
    t = torch.from_numpy
    ti, tp = tlt.select(ps.light_tree, t(p), t(n), t(u))
    ji, jp = np.asarray(ji), np.asarray(jp)
    near = _split_margin(ps.light_tree, t(p), t(n), t(u)).numpy() < 1e-6
    differ = ji != ti.numpy()
    print(f"select: {int(differ.sum())} indices differ, {int(near.sum())} lanes within 1e-6 "
          "of a split point")
    assert not (differ & ~near).any()
    assert int(near.sum()) == 0  # none on these lanes
    same = ~differ
    assert _rel(jp[same], tp.numpy()[same]).max() < 2e-5
    # every light is picked, the dome among them
    assert set(np.unique(ji)) == set(range(ps.lights.count))


def test_pdf_matches_jax(scenes):
    from zyg_tpu.scene import light_tree as jlt
    from zyg_tpu_torch.scene import light_tree as tlt

    js, ps = scenes
    p, n, _ = _lanes(2)
    li = np.random.default_rng(3).integers(-1, ps.lights.count, N).astype(np.int32)
    jtree = js.light_tree
    ref = np.asarray(jax.jit(lambda p, n, li: jlt.pdf(jtree, p, n, False, li))(p, n, li))
    t = torch.from_numpy
    got = tlt.pdf(ps.light_tree, t(p), t(n), t(li)).numpy()
    assert (ref > 0).mean() > 0.9
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_pdf_of_select_is_select_pdf(scenes):
    from zyg_tpu_torch.scene import light_tree as tlt

    _, ps = scenes
    p, n, u = (torch.from_numpy(x) for x in _lanes(4))
    li, sel_pdf = tlt.select(ps.light_tree, p, n, u)
    walk = tlt.pdf(ps.light_tree, p, n, li)
    assert bool((sel_pdf > 0).all())
    assert float(((walk - sel_pdf).abs() / sel_pdf).max()) < 1e-5


def test_light_selection_goes_through_the_tree(scenes):
    """light_sampling.select_light / light_select_pdf take the tree where
    a shading point is given and the power CDF where none is, as the JAX
    package's do."""
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls
    from zyg_tpu_torch.scene import light_tree as tlt

    js, ps = scenes
    p, n, u = _lanes(5)
    t = torch.from_numpy
    ti, tp = tls.select_light(ps, t(u), p=t(p), n=t(n))
    ri, rp = tlt.select(ps.light_tree, t(p), t(n), t(u))
    assert torch.equal(ti, ri) and torch.equal(tp, rp)
    np.testing.assert_array_equal(tls.light_select_pdf(ps, ti, p=t(p), n=t(n)).numpy(),
                                  tlt.pdf(ps.light_tree, t(p), t(n), ti).numpy())
    ci, cp = tls.select_light(ps, t(u))
    ji, jp = jax.jit(lambda u: jls.select_light(js, u))(jnp.asarray(u))
    np.testing.assert_array_equal(np.asarray(ji), ci.numpy())
    np.testing.assert_array_equal(np.asarray(jp), cp.numpy())


def test_gates_refuse_a_tree_as_jax_does():
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import shade, surface, surface_v2

    settings = jptmis.PtmisSettings(max_depth=4)
    # two rectangle lamps, analytic props: the fused bounce's light set
    js, ps = _load(_lamps_only(tree_scene(2)))
    assert js.light_tree is not None and ps.light_tree is not None
    assert not jshade.structural_ok(js, settings, None)
    assert not shade.structural_ok(ps)
    assert shade.structural_ok(dataclasses.replace(ps, light_tree=None))
    assert surface_v2.structural_ok_mesh_v2(ps)
    # the same with the sphere as a mesh: the mesh bounce's light set
    jm, pm = _load(_lamps_only(tree_scene(2, mesh=True)))
    assert not jshade.structural_ok_mesh(jm, settings, None)
    assert not surface.structural_ok_mesh(pm)
    assert surface.structural_ok_mesh(dataclasses.replace(pm, light_tree=None))
    assert surface_v2.structural_ok_mesh_v2(pm)
    assert jshade.structural_ok_mesh_v2(jm, settings, None)


def test_nee_splitting_is_refused():
    """16 finite lamps: the JAX Driver splits NEE over 4 picks a vertex at
    the default split threshold; the port refuses the scene rather than
    render it unsplit, and renders it with split_threshold 0."""
    from zyg_tpu.io.take import IntegratorSettings as JSettings
    from zyg_tpu.io.take import Take as JTake
    from zyg_tpu.render.camera import PerspectiveCamera as JCamera
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.types import UnsupportedScene

    js, ps = _load(tree_scene(16, seed=9))
    assert ps.light_tree.num_finite == 16
    jt = JTake()
    jt.cameras = [JCamera(resolution=(8, 8))]
    assert JDriver(take=jt, scene=js)._light_split_depth > 0
    take = Take()
    take.cameras = [PerspectiveCamera(resolution=(8, 8))]
    with pytest.raises(UnsupportedScene, match="splitting"):
        Driver(take, ps, device="cpu")
    take.integrator = IntegratorSettings(light_split_threshold=0.0)
    jt.integrator = JSettings(light_split_threshold=0.0)
    assert JDriver(take=jt, scene=js)._light_split_depth == 0
    Driver(take, ps, device="cpu")


def _camera(camera_cls):
    from zyg_tpu_torch.scene.loader import read_transformation

    cam = camera_cls(resolution=RES, fov=np.deg2rad(55))
    tr = read_transformation({"position": [0, 3.0, -6.5], "look_at": [0, 0.6, 0]})
    cam.position, cam.rotation = tr.position, tr.rotation
    return cam


@pytest.fixture(scope="module")
def renders():
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.camera import PerspectiveCamera as JCamera
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.render.driver import Driver

    js, ps = _load(tree_scene(4))
    out = []
    for mod, cam, drive in ((jtake, JCamera, lambda t: JDriver(take=t, scene=js)),
                            (ttake, PerspectiveCamera, lambda t: Driver(t, ps, device="cpu"))):
        take = mod.Take()
        take.num_samples_per_pixel = SPP
        take.integrator = mod.IntegratorSettings(kind="PTMIS", max_depth_surface=4)
        take.cameras = [_camera(cam)]
        d = drive(take)
        out.append((d.render_frame(), d.rays_traced, d.last_iterations))
    return out


def test_tree_render_matches_jax_at_golden_gate(renders):
    from zyg_tpu.tools.it import op_downsample

    (ref, jrays, jiters), (img, rays, iters) = renders
    assert img.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(rays - jrays) <= 1e-3 * jrays
    assert abs(iters - jiters) <= 2
