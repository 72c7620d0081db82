"""The point-cloud slice: examples/takes/sparks.take (600 particles from a
56-frame exporter stack, lerped over the take's 1/24 s shutter, under a
Light material on a Prop, over a floor under a Rectangle light; PTMIS
depth 4 through kernel 6) against the JAX package.

- The loaded cloud (the exporter layout and a flat written one), the
  point-list sniff, resolve_motion at the take's shutter and the point
  arena array-equal; the scene's arrays equal through scene_arrays (the
  point props stay out of prop_groups, as in the JAX arrays).
- The plain point walk per lane against zyg_tpu.scene.points.traverse on
  8,192 rays, half aimed at live particles and a quarter at dead ones
  (radius 0), closest and any-hit, over the moving arena at seeded
  shutter times and over the same arena held at shutter open: prim
  exact, t within rtol 1e-6 (measured: equal bit for bit, the dot
  products and sums of products fused as XLA fuses them).
- The point fragment on rays aimed at live particles: hit props and
  prims exact, points, normals and tangent frames within 2e-6 absolute.
- The body gates: kernels 3 and 5 refuse the scene, kernel 6 takes it,
  as the JAX gates decide; the Driver's chunk and tile plans equal the
  JAX Driver's (8 samples a chunk, 2^18-pixel tiles).
- One kernel-6 bounce on 2,048 sparks lanes at seeded shutter times
  against make_mesh_fused_body_v2(force_interpret=True), with
  test_torch_surface_v2.py's rules, except d and mis_n within 2e-4
  (measured 9.9e-5: a particle's normal is (p - c) / r with r = 6 mm,
  where an ulp of p = o + t d at 1.5 m is ~2e-5 of r, and the port and
  XLA round the object-space ray an ulp apart); the sparks' emission on primary rays
  aimed at live particles lane by lane (a Light material on a Prop: no
  light of the light list, MIS weight 1), within rtol 1e-5.
- The sparks image at 64x36, 8 spp against the JAX Driver under the
  golden gate (mean within 1.5 %, 4x4 RMSE within 6 % of the mean).
- The CLI renders a small copy of the take.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_surface import _arrays, _jax_state, _port_state
from test_torch_surface_v2 import _compare_bounce

torch.set_num_threads(2)

TAKE = "examples/takes/sparks.take"
SCENE = "examples/scenes/sparks.scene"
CLOUD = "examples/assets/sparks.json"
EYE = np.array([0.0, 0.35, -1.5], np.float32)


def _shutter():
    from zyg_tpu_torch.io.take import load_take_file

    return load_take_file(TAKE).cameras[0].frame_interval(0)


@pytest.fixture(scope="module")
def scenes():
    """sparks.scene over the take's frame-0 shutter: (JAX, port)."""
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file as tload

    t0, t1 = _shutter()
    return jload(SCENE, time0=t0, time1=t1), tload(SCENE, "cpu", t0, t1)


def test_point_cloud_file_and_arena_match_jax(tmp_path):
    from zyg_tpu.io.mesh import load_point_cloud_file as jload
    from zyg_tpu.scene import loader as jloader
    from zyg_tpu.scene import points as jpts
    from zyg_tpu_torch.io import mesh as tmesh
    from zyg_tpu_torch.scene import points as tpts

    jc, tc = jload(CLOUD), tmesh.load_point_cloud_file(CLOUD)
    assert tc.position_frames.shape == (56, 600, 3) and tc.fps == 120.0 and tc.start_frame == -50
    for f in jc._fields:
        a, b = getattr(jc, f), getattr(tc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    t0, t1 = _shutter()
    jr, tr = jpts.resolve_motion(jc, t0, t1), tpts.resolve_motion(tc, t0, t1)
    for f in ("positions", "radii", "positions_end"):
        a, b = getattr(jr, f), getattr(tr, f)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tr.radii == 0.0).sum() > 20  # dead sparks hide at radius 0
    # a flat cloud: positions, radii and shutter-close positions
    rng = np.random.default_rng(4)
    flat = tmp_path / "flat.json"
    p = rng.uniform(-1, 1, (37, 3)).round(4)
    flat.write_text(json.dumps({"geometry": {
        "primitive_topology": "point_list", "positions": p.ravel().tolist(),
        "radii": rng.uniform(0.01, 0.05, 37).round(4).tolist(),
        "positions_end": (p + 0.1).ravel().tolist()}}))
    mesh = tmp_path / "mesh.json"
    mesh.write_text(json.dumps({"geometry": {"positions": [0, 0, 0], "indices": [0, 0, 0]}}))
    for path in (CLOUD, str(flat), str(mesh), str(tmp_path / "missing.json")):
        assert tmesh.is_point_cloud_file(path) == jloader._is_point_cloud_file(path), path
    jf, tf = jload(str(flat)), tmesh.load_point_cloud_file(str(flat))
    clouds = ([jr, jf], [tr, tf])
    ja, ta = jpts.build_arena(clouds[0]), tpts.build_arena(clouds[1])
    assert ja.has_motion and ta.has_motion
    for f in ("node_rows", "point_rows", "cloud_root"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)), getattr(ta, f).numpy(),
                                      err_msg=f)


def test_sparks_scene_matches_jax_arrays(scenes):
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    jscene, pscene = scenes
    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    assert {"points.node_rows", "points.point_rows", "point_props", "prop_cloud"} <= set(a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert bool(b["points.has_motion"])
    # the sparks Prop stays out of prop_groups and out of the light list
    assert b["point_props"].tolist() == [0] and 0 not in b["lights.prop"].tolist()
    assert int(ShapeType.POINTS) not in {int(k) for k in pscene.prop_groups}


def _rays(cloud, n, seed, time):
    """n rays from around the take's camera: the first half aimed at live
    particles' centers at their lanes' shutter times, the next quarter at
    dead ones, the rest anywhere over the floor."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(cloud.radii > 0)
    dead = np.flatnonzero(cloud.radii == 0)
    idx = np.concatenate([rng.choice(live, n // 2), rng.choice(dead, n // 4)])
    c = cloud.positions[idx] + time[:len(idx), None] * (cloud.positions_end[idx]
                                                        - cloud.positions[idx])
    tgt = np.concatenate([c, rng.uniform([-0.8, 0.0, -0.2], [0.8, 0.8, 1.2], (n - len(idx), 3))])
    tgt += rng.normal(0, 0.003, tgt.shape)
    o = EYE + rng.normal(0, 0.03, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7] *= 1.3  # non-unit directions (a scaled prop's object space)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def walk_inputs():
    from zyg_tpu_torch.io.mesh import load_point_cloud_file
    from zyg_tpu_torch.scene import points as tpts

    cloud = tpts.resolve_motion(load_point_cloud_file(CLOUD), *_shutter())
    arena = tpts.build_arena([cloud])
    n = 8192
    rng = np.random.default_rng(11)
    time = rng.random(n).astype(np.float32)
    time[:32] = 0.0
    time[32:64] = 1.0
    o, d = _rays(cloud, n, 12, time)
    root = np.zeros(n, np.int32)
    root[64:96] = -1  # lanes that do not walk
    tmax = np.full(n, 1e9, np.float32)
    tmax[96:160] = 1.3  # bounded short of some particles
    return arena, o, d, time, root, tmax


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("moving", [True, False], ids=["moving", "still"])
def test_point_walk_matches_jax(walk_inputs, moving, any_hit):
    from zyg_tpu.scene import points as jpts
    from zyg_tpu_torch.ops import points as ops_points

    arena, o, d, time, root, tmax = walk_inputs
    arena = dataclasses.replace(arena, has_motion=moving)
    jarena = jpts.PointArena(jnp.asarray(arena.node_rows.numpy()),
                             jnp.asarray(arena.point_rows.numpy()),
                             jnp.asarray(arena.cloud_root.numpy()), has_motion=moving)

    @jax.jit
    def ref(o, d, tmax, time):
        return jpts.traverse(jarena, jnp.asarray(root), o, d, jnp.float32(0.0), tmax, time=time,
                             any_hit=any_hit)

    h = ref(o, d, tmax, time)
    t = torch.from_numpy
    tt, tp = ops_points.walk(arena, t(root), t(o), t(d), 0.0, t(tmax), time=t(time),
                             any_hit=any_hit)
    jp, jt = np.asarray(h.prim), np.asarray(h.t)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=1e-6, atol=0)
    live = slice(0, 4096)
    assert (jp[live] >= 0).mean() > (0.6 if moving else 0.2)
    if moving:  # aimed at dead sparks where they are at the lane's time: mostly through
        assert (jp[4096:6144] >= 0).mean() < 0.2
    assert (jp[64:96] < 0).all()


def _point_frags(scene, o, d, time, pkg):
    if pkg == "jax":
        from zyg_tpu.scene import shapes as js

        @jax.jit
        def f(o, d, time):
            tmax = jnp.full(o.shape[0], js.RAY_MAX_T, jnp.float32)
            hit = js.intersect_scene(scene, o, d, jnp.float32(0.0), tmax, "reflection",
                                     time=time)
            return hit, js.build_fragment(scene, hit, o, d, need_tangents=True, time=time)

        hit, frag = f(o, d, time)
        return {"prop": hit.prop, "prim": hit.prim, "t": hit.t, "p": frag.p, "n": frag.n,
                "geo_n": frag.geo_n, "tan": frag.t, "bit": frag.b}
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    t = torch.from_numpy
    table = isect.prop_table(scene, "reflection")
    hit = shapes.intersect_scene(scene, table, t(o), t(d), 0.0,
                                 torch.full((o.shape[0],), RAY_MAX_T), time=t(time))
    frag = shapes.build_fragment(scene, hit, t(o), t(d), need_tangents=True, time=t(time))
    return {"prop": hit.prop, "prim": hit.prim, "t": hit.t, "p": frag.p, "n": frag.n,
            "geo_n": frag.geo_n, "tan": frag.t, "bit": frag.b}


def test_point_fragment_matches_jax(scenes):
    from zyg_tpu_torch.io.mesh import load_point_cloud_file
    from zyg_tpu_torch.scene import points as tpts

    jscene, pscene = scenes
    cloud = tpts.resolve_motion(load_point_cloud_file(CLOUD), *_shutter())
    n = 2048
    time = np.random.default_rng(2).random(n).astype(np.float32)
    o, d = _rays(cloud, n, 3, time)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j = {k: np.asarray(v) for k, v in _point_frags(jscene, o, d, time, "jax").items()}
    p = {k: v.numpy() for k, v in _point_frags(pscene, o, d, time, "port").items()}
    np.testing.assert_array_equal(p["prop"], j["prop"])
    np.testing.assert_array_equal(p["prim"], j["prim"])
    on_points = p["prop"] == 0
    assert on_points.sum() > 700
    np.testing.assert_allclose(p["t"], j["t"], rtol=1e-6)
    for k in ("p", "n", "geo_n", "tan", "bit"):
        np.testing.assert_allclose(p[k][on_points], j[k][on_points], rtol=0, atol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(p["n"], j["n"], rtol=0, atol=2e-6)


def test_body_gates_and_plans_match_jax(scenes):
    from test_torch_driver import _jax_plan
    from test_torch_render_smoke import _jax_tile_plan
    from zyg_tpu.io.take import load_take_file as jtake
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.ops import shade, surface, surface_v2
    from zyg_tpu_torch.render.driver import Driver

    jscene, pscene = scenes
    settings = jptmis.PtmisSettings(max_depth=4)
    assert not jshade.structural_ok(jscene, settings, None)
    assert not shade.structural_ok(pscene) and not surface.structural_ok_mesh(pscene)
    assert jshade.structural_ok_mesh_v2(jscene, settings, None)
    assert surface_v2.structural_ok_mesh_v2(pscene)
    for res, spp in (((640, 360), 32), ((960, 540), 12), ((64, 36), 8)):
        jt, pt = jtake(TAKE), load_take_file(TAKE)
        for t in (jt, pt):
            t.cameras[0].resolution = res
            t.num_samples_per_pixel = spp
        jd, pd = JDriver(take=jt, scene=jscene, use_mesh=False), Driver(pt, pscene, device="cpu")
        assert jd._heavy_loops and pd.chunk_size == jd.chunk_size == 8
        assert pd.chunk_plan(spp) == _jax_plan(jd, spp)
        assert pd.tile_plan() == _jax_tile_plan(jd)
    assert pd.tile_plan() == [(0, 64 * 36)]


def _bounce_lanes(n=2048):
    """test_torch_surface.py's lane state over sparks' rays: depth, flags
    and throughputs as there, the rays of _rays, seeded shutter times."""
    from zyg_tpu_torch.io.mesh import load_point_cloud_file
    from zyg_tpu_torch.scene import points as tpts

    a = _arrays(n)
    time = np.random.default_rng(21).random(n).astype(np.float32)
    cloud = tpts.resolve_motion(load_point_cloud_file(CLOUD), *_shutter())
    a["o"], a["d"] = _rays(cloud, n, 22, time)
    a["d"] = (a["d"] / np.linalg.norm(a["d"], axis=1, keepdims=True)).astype(np.float32)
    a["depth"][: n // 4] = 0  # primary lanes among those aimed at live sparks
    a["alive"][: n // 4] = True
    return a, time


@pytest.fixture(scope="module")
def v2_bounce(scenes):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    jscene, pscene = scenes
    a, time = _bounce_lanes()
    body_ref = jshade.make_mesh_fused_body_v2(jscene, jptmis.PtmisSettings(max_depth=4),
                                              force_interpret=True)
    r1 = jax.jit(body_ref)(_jax_state(a)._replace(time=jnp.asarray(time)))
    body = surface_v2.make_mesh_fused_body_v2(pscene, PtmisSettings(max_depth=4))
    s = dataclasses.replace(_port_state(a), time=torch.from_numpy(time))
    return a, r1, body.inputs(s)[0], body(s)


def test_v2_bounce_on_sparks_matches_jax(v2_bounce):
    a, r1, st, r2 = v2_bounce
    # lanes on the sparks' emission (not a light: no MIS weight) and with NEE
    on_sparks = st["alive"] & (st["em"].amax(dim=1) > 1.0)
    assert int(on_sparks.sum()) > 300 and not bool(st["is_light"][on_sparks].any())
    assert int(st["nee_pre"].sum()) > 500
    _compare_bounce(r1, r2, tols=(("o", 1e-4), ("d", 2e-4), ("bxdf_pdf", 1e-2), ("mis_n", 2e-4),
                                  ("throughput", 5e-3)))


def test_spark_emission_on_primary_rays_matches_jax(v2_bounce):
    """The emission a primary ray picks up on a live spark, lane by lane:
    too small a share of the image for the golden gate to see."""
    a, r1, st, r2 = v2_bounce
    n = a["o"].shape[0] // 4
    em_j = np.asarray(r1.result.emission)[:n]
    em_p = r2.result.emission.numpy()[:n]
    hit = em_j.max(axis=1) > 0.0
    assert hit.sum() > 300
    np.testing.assert_array_equal(em_p.max(axis=1) > 0.0, hit)
    np.testing.assert_allclose(em_p, em_j, rtol=1e-5, atol=0)
    # the spark material's radiance, 120 * (1, 0.45, 0.12), times the lane's throughput
    ratio = em_p[hit] / a["thr"][:n][hit]
    np.testing.assert_allclose(ratio, np.broadcast_to([120.0, 54.0, 14.4], ratio.shape),
                               rtol=1e-5)


def _take(module, res, spp):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    return take


def test_sparks_render_matches_jax_at_golden_gate(scenes):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    jscene, pscene = scenes
    jd = JDriver(take=_take(jtake, (64, 36), 8), scene=jscene)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (64, 36), 8), pscene, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (36, 64, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced


def test_cli_renders_sparks(tmp_path):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.png import read_png

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [32, 18]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "sparks_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3) and img.mean() > 5


def _moving_root():
    """sparks' cloud and the furball's strands as two props that move over
    the shutter (a keyframe inside it: eight shutter keys), over a floor
    under a lamp."""
    def anim(p1, r1):
        return {"keyframes": [{"time": 0.0, "transformation": {"position": [0, 0, 0]}},
                              {"time": 0.02, "transformation": {"position": p1, "rotation": r1}},
                              {"time": 0.05, "transformation": {"position": [0.1, 0, 0]}}]}

    return {
        "materials": [
            {"name": "spark", "rendering": {"Light": {"emittance": {"value": 20.0}}}},
            {"name": "fur", "rendering": {"Hair": {"color": [0.4, 0.3, 0.2]}}},
            {"name": "floor", "rendering": {"Substitute": {"color": 0.5}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 4.0}}}}],
        "entities": [
            {"type": "Prop", "shape": {"file": "../assets/sparks.json"}, "materials": ["spark"],
             "animation": anim([0.2, 0.05, 0.0], [0, 30, 0])},
            {"type": "Prop", "shape": {"file": "../assets/furball.hair"}, "materials": ["fur"],
             "transformation": {"scale": [0.5, 0.5, 0.5]},
             "animation": anim([-0.2, 0.1, 0.1], [10, 0, 20])},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"position": [0, -0.3, 0], "rotation": [90, 0, 0],
                                "scale": [4, 4, 1]}},
            {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"],
             "transformation": {"position": [0, 2, -1], "rotation": [-60, 0, 0]}}],
    }


def test_moving_point_and_curve_props_match_jax():
    """Moving point and curve props (keyframes, eight shutter keys) walked
    at each lane's shutter time: the scene arrays equal (animated_points,
    animated_curves, prop_keys; no static point or curve prop left), and on
    4,096 rays at seeded times the closest hit's prop and prim equal on
    99.5 % of the lanes (measured 99.85 %); where they agree t within rtol
    5e-4 on the moving props (measured 1.6e-4 on the hair, 6.7e-5 on the
    sparks: torch and XLA round the lanes' slerped transforms an ulp
    apart, which a grazing hit on a 0.25 mm strand magnifies) and equal on
    the floor; the fragment's normal within 1e-4 where t agrees exactly too
    (88 % of the lanes on the sparks, 95 % on the hair; elsewhere the t
    difference moves the hit point by up to a third of a strand's radius,
    the normal by up to 0.1); shadow rays blocked alike on 99.5 %."""
    from zyg_tpu.scene import shapes as js
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    base = os.path.abspath("examples/scenes")
    t0, t1 = _shutter()
    jscene = jload(_moving_root(), base_dir=base, time0=t0, time1=t1)
    pscene = tload(_moving_root(), "cpu", base_dir=base, time0=t0, time1=t1)
    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["animated_points"].tolist() == [0] and b["animated_curves"].tolist() == [1]
    assert b["point_props"].size == 0 and b["curve_props"].size == 0
    assert b["prop_keys"].shape == (4, 9, 10)

    n = 4096
    rng = np.random.default_rng(31)
    time = rng.random(n).astype(np.float32)
    o = (EYE + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    tgt = rng.normal(0, 0.25, (n, 3)) + np.array([0.0, 0.15, 0.0])
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    sd = np.broadcast_to(np.float32([0.0, 0.8, -0.6]), (n, 3)).copy()

    @jax.jit
    def ref(o, d, time, so, sd):
        tmax = jnp.full(o.shape[0], js.RAY_MAX_T, jnp.float32)
        hit = js.intersect_scene(jscene, o, d, jnp.float32(0.0), tmax, "reflection", time=time)
        frag = js.build_fragment(jscene, hit, o, d, need_tangents=True, time=time)
        blocked = js.occluded(jscene, so, sd, jnp.float32(0.0), tmax, time=time)
        return hit, frag, blocked

    so = (tgt - 0.5 * sd).astype(np.float32)  # through the props toward the lamp
    jh, jf, jb = ref(o, d, time, so, sd)
    t = torch.from_numpy
    hit = shapes.intersect_scene(pscene, isect.prop_table(pscene, "reflection"), t(o), t(d), 0.0,
                                 torch.full((n,), RAY_MAX_T), time=t(time))
    frag = shapes.build_fragment(pscene, hit, t(o), t(d), need_tangents=True, time=t(time))
    blocked = shapes.occluded(pscene, isect.prop_table(pscene, "shadow"), t(so), t(sd), 0.0,
                              RAY_MAX_T, time=t(time))
    same = (hit.prop.numpy() == np.asarray(jh.prop)) & (hit.prim.numpy() == np.asarray(jh.prim))
    assert same.mean() >= 0.995, same.mean()
    on = same & (hit.prop.numpy() <= 1) & (hit.prop.numpy() >= 0)
    assert (hit.prop.numpy()[on] == 0).sum() > 100 and (hit.prop.numpy()[on] == 1).sum() > 100
    np.testing.assert_allclose(hit.t.numpy()[on], np.asarray(jh.t)[on], rtol=5e-4)
    floor = same & (hit.prop.numpy() == 2)
    np.testing.assert_array_equal(hit.t.numpy()[floor], np.asarray(jh.t)[floor])
    t_same = on & (hit.t.numpy() == np.asarray(jh.t))
    assert t_same.sum() > 0.85 * on.sum()
    np.testing.assert_allclose(frag.n.numpy()[t_same], np.asarray(jf.n)[t_same], rtol=0, atol=1e-4)
    assert (blocked.numpy() == np.asarray(jb)).mean() >= 0.995 and blocked.numpy().mean() > 0.05


def cluster_rays(root: int):
    """40 rays down -z, in two groups of 32 lanes, over a tree of a root
    and two leaves, one over x = -5 and one over x = +5: lanes 0-9 pass
    through the first, 10-19 above every box, 20-31 do not walk (root -1),
    32-35 pass through the second, 36-39 do not walk. (o, d, root [40],
    each lane's node steps counted by hand: the root, the first leaf and
    the second for a lane that enters the root's box, the root alone for
    one that does not.)"""
    x = np.zeros(40, np.float32)
    x[0:10] = -5.0 + 0.01 * np.arange(-5, 5)
    x[32:36] = 5.0 + 0.01 * np.arange(-2, 2)
    y = np.zeros(40, np.float32)
    y[10:20] = 20.0
    o = torch.as_tensor(np.stack([x, y, np.full(40, 10.0, np.float32)], axis=-1))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(40, 3).contiguous()
    roots = torch.full((40,), root, dtype=torch.int32)
    roots[20:32] = -1
    roots[36:40] = -1
    steps = torch.zeros(40, dtype=torch.int64)
    steps[0:10] = 3
    steps[10:20] = 1
    steps[32:36] = 3
    return o, d, roots, steps


def check_step_counts(arena_rows, traverse, root):
    """The plain walk's diagnosis counts (scene/points.py count_steps) on
    cluster_rays against the hand count: each lane's node steps, their sum
    equal to the node visits (52), the leaf tests (the 14 lanes through a
    cluster, once each) and the warp-steps of a thread a lane that run the
    leaf branch (2: lanes 0-9 at the first leaf in the walk's second step,
    lanes 32-35 at the second leaf in its third). Returns the walk's
    prims."""
    assert arena_rows.shape[0] == 3 and float(arena_rows[0, 8]) == -1.0
    assert bool((arena_rows[1:, 8] >= 0).all())
    o, d, roots, steps = cluster_rays(root)
    counts = {"nodes": 0, "leaves": 0, "lane_steps": torch.zeros(40, dtype=torch.int64)}
    out = traverse(roots, o, d, torch.full((40,), 1e30), counts)
    assert torch.equal(counts["lane_steps"], steps)
    assert int(counts["lane_steps"].sum()) == counts["nodes"] == 52
    assert counts["leaves"] == 14
    assert counts["leaf_warp_steps"] == 2
    prim = out[-1]
    assert bool((prim[0:10] >= 0).all()) and bool((prim[32:36] >= 0).all())
    assert not bool((prim[10:32] >= 0).any()) and not bool((prim[36:] >= 0).any())
    return prim


def test_point_walk_step_counts_by_hand():
    """The plain point walk's lane steps and leaf warp-steps on a port-only
    arena of two clusters of 4 points (a root and two leaves): the hand
    count of check_step_counts, and each cluster's lanes hit its points."""
    from zyg_tpu_torch.scene import points as pts

    cluster = np.array([[0.0, 0.0, 0.0], [0.0, 0.6, 0.0], [0.0, 0.0, 0.6], [0.0, -0.6, 0.0]],
                       np.float32)
    pos = np.concatenate([cluster + [-5.0, 0.0, 0.0], cluster + [5.0, 0.0, 0.0]])
    arena = pts.build_arena([pts.HostPoints(positions=pos, radii=np.full(8, 0.3, np.float32))])
    prim = check_step_counts(
        arena.node_rows,
        lambda root, o, d, tmax, counts: pts.traverse(arena, root, o, d, 0.0, tmax,
                                                      counts=counts),
        int(arena.cloud_root[0]))
    # the nearest point of each cluster along -z is its z = 0.6 point
    packed = arena.point_rows.reshape(-1, pts.POINT_F)[prim[prim >= 0].long()]
    assert torch.equal(packed[:, 2], torch.full((14,), 0.6))
