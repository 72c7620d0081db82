"""The port's distance sampling and shadow transmittance through media
(zyg_tpu_torch/render/integrator/volume.py, with the plain tracking walks
of zyg_tpu_torch/ops/track.py) against the JAX package's
(zyg_tpu/render/integrator/volume.py), on 4,096 seeded lanes: origins in
smoke.scene's Cube, random directions, 10 % of the lanes in vacuum,
segments of 0.1-6, Sobol'-like uniforms, keys and volume depths 0-39.
4,096 is below 4 * _TRACK_MIN, so the JAX walks run without their
compaction cascade (which only relocates lanes,
tests/test_hetero_volumes.py::test_cascade_matches_full_width).

Tolerances, on each of: smoke's grey medium (dense arena), a non-grey
copy of it (attenuation 0.5/0.6/0.7: the spectral estimator), and a grey
medium over a mostly empty grid (sparse arena):
- scatter and absorb equal on all but at most 0.5 % of the lanes: a walk
  draws its free flights by -log(1 - u), and XLA's log differs from the
  correctly rounded one on ~14 % of inputs, torch's on ~0.1 %, so t can
  move an ulp and in principle flip a collision decision (none flipped
  on these lanes);
- on the lanes whose decisions agree, the event's distance t = (p - o).d
  within rtol 1e-5 and its weight within rtol 1e-5 (measured: 1.7e-5 on
  p near the origin under the |x| + 1e-3 floor, 6.6e-7 on the spectral
  weights);
- transmittance through the grid prop (residual-ratio tracking, exp(-mu_t
  tau) * trv) within rtol 1e-5 (measured 1.6e-7 grey, 1.9e-7 spectral);
- homogeneous media (volumes.scene's Cube): the closed form's decisions
  exact, its weights and Beer transmittance within rtol 1e-6 (torch's
  and XLA's exp and log an ulp apart).
Also the chord of a Sphere and a Cube prop (_prop_interval) within rtol
1e-6, a Volumetric material on a mesh prop refused at load, and the
emission of fire.scene's emissive medium (grey and spectral walks, the
homogeneous closed form) within rtol 1e-5.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

N = 4096
FLIP_SHARE = 0.005


def _smoke_root(variant):
    with open("examples/scenes/smoke.scene") as f:
        root = json.load(f)
    if variant == "spectral":
        root["materials"][1]["rendering"]["Volumetric"]["attenuation_color"] = [0.5, 0.6, 0.7]
    return root


def _scenes(variant):
    from zyg_tpu.scene.grids import build_grid_arena as jbuild
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.grids import build_grid_arena as tbuild
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    root = _smoke_root(variant)
    js, ps = jload(root), tload(root)
    if variant == "sparse":
        blob = np.zeros((40, 48, 56), np.float32)
        blob[5:20, 10:30, 30:50] = np.random.default_rng(2).random((15, 20, 20)) * 2.0
        js = js._replace(grids=jbuild([blob]))
        ps.grids = tbuild([blob])
        assert ps.grids.sparse
    return js, ps


@pytest.fixture(scope="module", params=["grey", "spectral", "sparse"])
def scenes(request):
    js, ps = _scenes(request.param)
    assert ("spectral_media" in ps.mat_features) == (request.param == "spectral")
    return request.param, js, ps


def _lanes(ps, prop_id, seed=1):
    rng = np.random.default_rng(seed)
    rot, pos, scl = (x[prop_id].numpy().astype(np.float64)
                     for x in (ps.prop_rot, ps.prop_pos, ps.prop_scale))
    o = (pos + (rng.uniform(-0.5, 0.5, (N, 3)) * scl) @ rot).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    prop = np.where(rng.random(N) < 0.9, prop_id, -1).astype(np.int32)
    seg = rng.uniform(0.1, 6.0, N).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    key = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    depth = rng.integers(0, 40, N).astype(np.int32)
    o2 = (o + rng.normal(size=(N, 3))).astype(np.float32)
    tmax = rng.uniform(0.5, 8.0, N).astype(np.float32)
    return o, d, prop, seg, u, key, depth, o2, tmax


def _t(x):
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _interactions(js, ps, lanes):
    from zyg_tpu.render.integrator import volume as jv
    from zyg_tpu_torch.render.integrator import volume as tv

    o, d, prop, seg, u, key, depth = lanes[:7]
    ev = jax.jit(lambda p, o, d, s, u, k, dep: jv.sample_interaction(
        js, p, o, d, s, u, k, vol_depth=dep))(*map(jnp.asarray, (prop, o, d, seg, u, key, depth)))
    pe = tv.sample_interaction(ps, *map(_t, (prop, o, d, seg, u, key)), vol_depth=_t(depth))
    return ev, pe


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(a) + 1e-30)


def test_sample_interaction_matches_jax(scenes):
    variant, js, ps = scenes
    lanes = _lanes(ps, 1)
    ev, pe = _interactions(js, ps, lanes)
    o, d = lanes[0].astype(np.float64), lanes[1].astype(np.float64)
    js_s, js_a = np.asarray(ev.scatter), np.asarray(ev.absorb)
    ps_s, ps_a = pe.scatter.numpy(), pe.absorb.numpy()
    agree = (js_s == ps_s) & (js_a == ps_a)
    assert (~agree).mean() <= FLIP_SHARE, (~agree).sum()
    walking = lanes[2] >= 0
    assert js_s[walking].mean() > 0.05  # the lanes scatter
    if variant != "sparse":
        assert js_a[walking].any()  # and some are absorbed
    t_j = ((np.asarray(ev.p, np.float64) - o) * d).sum(-1)
    t_p = ((pe.p.numpy().astype(np.float64) - o) * d).sum(-1)
    ev_lanes = agree & walking & js_s
    assert _rel(t_j[ev_lanes], t_p[ev_lanes]).max() < 1e-5
    np.testing.assert_allclose(pe.weight.numpy()[agree], np.asarray(ev.weight)[agree],
                               rtol=1e-5, atol=0)
    if variant == "spectral":  # the null and scatter weights ride along
        w = np.asarray(ev.weight)[walking & agree]
        assert (np.abs(w - 1.0) > 1e-3).any()


def test_transmittance_matches_jax(scenes):
    from zyg_tpu.render.integrator import volume as jv
    from zyg_tpu_torch.render.integrator import volume as tv

    _, js, ps = scenes
    o, d, _, _, _, key, _, o2, tmax = _lanes(ps, 1)
    ref = np.asarray(jax.jit(lambda o, d, tm, k: jv.transmittance(js, o, d, tm, k))(
        *map(jnp.asarray, (o2, d, tmax, key))))
    got = tv.transmittance(ps, _t(o2), _t(d), _t(tmax), _t(key)).numpy()
    assert (ref < 0.999).mean() > 0.05  # rays cross the medium
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_homogeneous_medium_matches_closed_form():
    """volumes.scene: a homogeneous scattering Cube (no grid) beside glass."""
    from zyg_tpu.render.integrator import volume as jv
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.render.integrator import volume as tv
    from zyg_tpu_torch.scene.loader import load_scene_file as tload

    js, ps = jload("examples/scenes/volumes.scene"), tload("examples/scenes/volumes.scene")
    assert ps.grids is None and ps.volume_props == ((2, 3, -1, 1),)
    lanes = _lanes(ps, 2, seed=4)
    ev, pe = _interactions(js, ps, lanes)
    np.testing.assert_array_equal(pe.scatter.numpy(), np.asarray(ev.scatter))
    assert not pe.absorb.any() and np.asarray(ev.scatter).mean() > 0.2
    np.testing.assert_allclose(pe.weight.numpy(), np.asarray(ev.weight), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pe.p.numpy(), np.asarray(ev.p), rtol=1e-5, atol=1e-5)
    o, d, _, _, _, key, _, o2, tmax = lanes
    ref = np.asarray(jax.jit(lambda o, d, tm, k: jv.transmittance(js, o, d, tm, k))(
        *map(jnp.asarray, (o2, d, tmax, key))))
    got = tv.transmittance(ps, _t(o2), _t(d), _t(tmax), _t(key)).numpy()
    assert (ref < 0.999).mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", ["Sphere", "Cube"])
def test_prop_interval_matches_jax(shape):
    from zyg_tpu.render.integrator import volume as jv
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.render.integrator import volume as tv
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    root = {
        "materials": [{"name": "v", "rendering": {"Volumetric": {"attenuation_distance": 0.5}}},
                      {"name": "sky", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
        "entities": [
            {"type": "Prop", "shape": {"type": shape}, "materials": ["v"],
             "transformation": {"position": [0.3, 1.0, -0.2], "rotation": [10, 35, 0],
                                "scale": [1.5, 2.0, 1.2] if shape == "Cube" else [2, 2, 2]}},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
        ],
    }
    js, ps = jload(root), tload(root)
    rng = np.random.default_rng(7)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32) + np.float32([0.3, 1.0, -0.2])
    tgt = rng.uniform(-0.8, 0.8, (N, 3)) + np.array([0.3, 1.0, -0.2])
    d = tgt - o
    d = np.where((np.arange(N) % 4 == 0)[:, None], rng.normal(size=(N, 3)), d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.5, 10.0, N).astype(np.float32)
    st = int(ps.prop_shape[0])
    ref = jax.jit(lambda o, d, tm: jv._prop_interval(js, 0, st, o, d, tm))(
        *map(jnp.asarray, (o, d, tmax)))
    got = tv._prop_interval(ps, 0, st, *map(torch.from_numpy, (o, d, tmax)))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    assert (np.asarray(ref[1]) > np.asarray(ref[0])).mean() > 0.5


def test_mesh_volume_prop_is_refused():
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match="Volumetric material on a mesh prop"):
        load_scene_dict({
            "materials": [{"name": "v", "rendering": {"Volumetric": {
                "attenuation_distance": 0.5}}},
                {"name": "sky", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
            "entities": [
                {"type": "Prop", "shape": {"file": "proc:sphere"}, "materials": ["v"]},
                {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
            ],
        })


def _fire_root(variant):
    with open("examples/scenes/fire.scene") as f:
        root = json.load(f)
    vol = root["materials"][1]["rendering"]["Volumetric"]
    if variant == "spectral":
        vol["attenuation_color"] = [0.5, 0.6, 0.7]
    if variant == "homogeneous":
        del vol["density_map"]
    return root


@pytest.mark.parametrize("variant", ["grey", "spectral", "homogeneous"])
def test_emissive_sample_interaction_matches_jax(variant):
    """fire.scene's emissive Volumetric Cube (grey, e = 14 x (1, 0.45,
    0.12)), a non-grey copy of it (the spectral estimator's emission
    w mu_a(x) / (mu_maj pa) e with the weight from before the kill) and a
    copy without its density grid (the homogeneous closed form
    e mu_a (1 - exp(-mu_t seg)) / mu_t): decisions as above, and the
    emission on the lanes whose decisions agree within rtol 1e-5 (the grey
    walk copies e: exact; measured 4.5e-7 spectral, 4.7e-7 homogeneous:
    torch's and XLA's log and exp an ulp apart); vacuum lanes emit
    nothing."""
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    root = _fire_root(variant)
    js, ps = jload(root), tload(root)
    assert "vol_emission" in ps.mat_features
    assert ("spectral_media" in ps.mat_features) == (variant == "spectral")
    assert (ps.grids is None) == (variant == "homogeneous")
    lanes = _lanes(ps, 1, seed=5)
    ev, pe = _interactions(js, ps, lanes)
    js_s, js_a = np.asarray(ev.scatter), np.asarray(ev.absorb)
    agree = (js_s == pe.scatter.numpy()) & (js_a == pe.absorb.numpy())
    assert (~agree).mean() <= FLIP_SHARE, (~agree).sum()
    e_j, e_p = np.asarray(ev.emission), pe.emission.numpy()
    assert e_p.shape == (N, 3)
    np.testing.assert_allclose(e_p[agree], e_j[agree], rtol=1e-5, atol=0)
    vacuum = lanes[2] < 0
    assert not e_p[vacuum].any()
    if variant == "homogeneous":
        assert (e_p[~vacuum] > 0).all()
    else:
        # the walks collect emission exactly at their absorptions
        assert js_a.sum() > 30
        assert ((e_p.max(-1) > 0) == pe.absorb.numpy()).all()
        if variant == "grey":
            e = ps.materials.emission[int(ps.prop_material[1])].numpy()
            absorbed = pe.absorb.numpy()
            np.testing.assert_array_equal(e_p[absorbed], np.broadcast_to(e, (absorbed.sum(), 3)))


def test_walk_lane_steps_warp_efficiency_and_rows_on_chip():
    """What the kernels' lane mapping acts on, counted by the plain walks
    on every fourth lane of the smoke path's own glue inputs
    (chip_smoke._smoke_walk_inputs, 518,400 lanes; the cut keeps the test
    under 10 s): each lane's steps ("lane_steps") sum to the lane-steps
    and their largest is the longest walk; chip_smoke.warp_efficiency (the
    share of thread-steps that walk with one thread a lane) on a
    hand-made case and on these lanes; and the choice of the kernels'
    row form: smoke's 512 supergrid rows fit on chip, three 64^3 fbm
    grids' 1,536 rows do not."""
    import chip_smoke
    from zyg_tpu_torch.ops import track
    from zyg_tpu_torch.scene.grids import build_grid_arena, make_fbm_grid

    # two warps of 4 lanes: 12 lane-steps in 4 x (4 + 2) thread-steps; a
    # padded last warp; no lane walking
    eff, longest = chip_smoke.warp_efficiency(torch.tensor([1, 2, 3, 4, 0, 0, 0, 2]), warp=4)
    assert eff == 12 / 24 and longest == 3.0
    eff, longest = chip_smoke.warp_efficiency(torch.tensor([2, 2, 2, 2, 5]), warp=4)
    assert eff == 13 / 28 and longest == 3.5
    assert chip_smoke.warp_efficiency(torch.zeros(64, dtype=torch.int64)) == (1.0, 0.0)

    ia, ta = chip_smoke._smoke_walk_inputs("cpu")
    ia = ia[:2] + tuple({k: v[::4].contiguous() for k, v in x.items()} for x in ia[2:4]) + ia[4:]
    ta = ta[:5] + ({k: v[::4].contiguous() for k, v in ta[5].items()},) + ta[6:]
    shares = {}
    for name, fn, args, walking in (
            ("interaction", track.track_interaction_plain, ia, ia[2]["grid"] >= 0),
            ("transmittance", track.track_transmittance_plain, ta, ta[5]["inside"])):
        stats = {}
        fn(*args, stats=stats)
        steps = stats["lane_steps"]
        assert steps.dtype == torch.int64 and steps.shape == walking.shape
        assert int(steps.sum()) == stats["steps"]
        assert int(steps.max()) == stats["iterations"]
        assert bool((steps[walking] > 0).all()) and not bool(steps[~walking].any())
        shares[name] = chip_smoke.warp_efficiency(steps)[0]
    # the shadow rays come in no order: most of a warp's thread-steps idle
    assert shares["transmittance"] < 0.35 < shares["interaction"]

    assert track.rows_on_chip(ia[0]) and ia[0].sdata.shape[0] == 512
    multi = build_grid_arena([make_fbm_grid(64, seed=s) for s in (1, 2, 3)])
    assert multi.sdata.shape[0] == 3 * 512 > track.ROWS_ON_CHIP
    assert not track.rows_on_chip(multi)
