"""The motion slice: camera shutters, animation keyframes, moving analytic
props and lights, moving mesh instances in the traversal, and
examples/takes/motion.take (an animated Sphere that translates, an
animated Cube that turns, a floor and a uniform Dome; 24 fps, shutter
[0, 1/24 s]) against the JAX package.

- The take's shutter keys and frame_interval equal the JAX take's; the
  shutter's inverse CDF with 4 and 8 slope handles within 1e-6, and
  sample_shutter_time on seeded draws within 1e-6.
- parse_animation and eval_animation equal (both schemas).
- The scene arrays equal, prop_keys bit for bit, for K = 1 (motion.scene,
  whose second keyframe lies outside the shutter) and K = 8 (three
  keyframes inside the shutter).
- prop_transform_at on seeded lanes within 2e-6 (torch and XLA round acos
  and sin an ulp apart).
- intersect_scene and occluded over the moving props at seeded times:
  props equal on at least 99.9 % of the lanes, t within rtol 1e-5.
- A moving Rectangle light: its NEE sample and hit pdf against the JAX
  package's on seeded lanes.
- The plain traversal over moving mesh instances against the JAX
  intersect_instances(..., time=): the instance table exactly, hit ids
  equal on 99.9 % of the lanes and t within rtol 1e-5; a moving table
  without times raises.
- One general-body bounce with a moving sphere beside glass, on lanes
  with seeded times, against the JAX body.
- motion.take at 48x32, 8 spp against the JAX Driver through the golden
  gate; the CLI writes a frame sequence's names.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/motion.take"
SCENE = "examples/scenes/motion.scene"


def _shutter_root(shutter, where="parameters"):
    body = {"parameters": {"fov": 50}, "resolution": [8, 8]}
    if where == "parameters":
        body["parameters"]["shutter"] = shutter
    else:
        body["shutter"] = shutter
    return {"scene": "x.scene", "camera": {"Perspective": body}}


@pytest.mark.parametrize("shutter, where", [
    ({"frames_per_second": 24, "open": 0.25, "close": 0.75}, "parameters"),
    ({"frame_step": 0.02, "motion_blur": False}, "parameters"),
    ({"frames_per_second": 30, "open": 0.1, "close": 0.8, "slope": [0.02, 0.3, 0.05, 0.9]},
     "body"),
], ids=["fps_open_close", "frame_step_no_blur", "slope_beside_parameters"])
def test_take_shutter_keys_match_jax(shutter, where):
    from zyg_tpu.io.take import load_take_dict as jload
    from zyg_tpu_torch.io.take import load_take_dict as tload

    jc = jload(_shutter_root(shutter, where)).cameras[0]
    tc = tload(_shutter_root(shutter, where)).cameras[0]
    for k in ("frame_step", "shutter_open", "shutter_close", "motion_blur", "shutter_slope"):
        assert getattr(tc, k) == getattr(jc, k), k
    for frame in (0, 3, 17):
        assert tc.frame_interval(frame) == jc.frame_interval(frame)


def test_take_refuses_other_shutter_keys():
    from zyg_tpu_torch.io.take import UnsupportedTake, load_take_dict

    with pytest.raises(UnsupportedTake, match="shutter keys"):
        load_take_dict(_shutter_root({"frames_per_second": 24, "rolling": True}))


@pytest.mark.parametrize("open_, close, slope", [
    (0.3, 0.7, ()), (0.25, 0.8, (0.05, 0.2, 0.2, 0.95)),
    (0.2, 0.6, (0.02, 0.4, 0.1, 0.9, 0.7, 0.9, 0.9, 0.1)),
], ids=["trapezoid", "slope4", "slope8"])
def test_shutter_icdf_and_time_match_jax(open_, close, slope):
    from zyg_tpu.render import camera as jcam
    from zyg_tpu_torch.render import camera as tcam

    kw = dict(shutter_open=open_, shutter_close=close, shutter_slope=slope)
    jc, tc = jcam.PerspectiveCamera(**kw), tcam.PerspectiveCamera(**kw)
    ref = jc._shutter_icdf()
    out = tc._shutter_icdf()
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape == (33,)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    u = np.random.default_rng(3).random(4096).astype(np.float32)
    u[:3] = (0.0, 1.0, 0.9999999)
    t_ref = np.asarray(jax.jit(jcam.sample_shutter_time)(jc.arrays(), jnp.asarray(u)))
    t_out = tcam.sample_shutter_time(tc.arrays(), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(t_out, t_ref, atol=1e-6, rtol=0)
    assert 0.0 <= t_out.min() and t_out.max() <= 1.0


def test_uniform_shutter_is_the_identity():
    from zyg_tpu_torch.render import camera as tcam

    cam = tcam.PerspectiveCamera()
    assert cam._shutter_icdf() is None and cam.arrays().shutter_icdf is None
    u = torch.rand(64)
    assert torch.equal(tcam.sample_shutter_time(cam.arrays(), u), u)


_ANIM_NODES = [
    {"frames_per_second": 24, "keyframes": [
        {"time": 0.0, "transformation": {"position": [-1.4, 0.0, 0.6]}},
        {"time": 0.0833, "transformation": {"position": [1.4, 0.3, 0.6], "rotation": [0, 60, 10]}},
        {"transformation": {"position": [2.0, 0.3, 0.0], "scale": [2, 1, 1]}}]},
    {"frames_per_second": 10, "transformations": [
        {"position": [0, 1, 0]}, {"rotation": [90, 0, 0]}, {"rotation": [0, 0, 170]}],
     "times": [0.0, 0.25]},
]


@pytest.mark.parametrize("node", _ANIM_NODES, ids=["keyframes", "transformations"])
def test_parse_and_eval_animation_match_jax(node):
    from zyg_tpu.scene import loader as J
    from zyg_tpu_torch.scene import loader as T

    def track(m):
        parent = m.Transformation(position=np.array([0.5, 0, 0], np.float32),
                                  rotation=m.rotation_matrix_from_euler_degrees([0, 30, 0]),
                                  scale=np.full(3, 2.0, np.float32))
        default = m.read_transformation({"position": [0, 0.2, 0], "scale": [0.7, 0.7, 0.7]})
        return m.parse_animation(node, parent, default)

    ja, ta = track(J), track(T)
    assert len(ja) == len(ta) >= 3
    for (jt, jx), (tt, tx) in zip(ja, ta):
        assert jt == tt
        for k in ("position", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(tx, k), getattr(jx, k), err_msg=k)
    for t in (-1.0, 0.0, 0.01, 0.041, 0.05, 0.1, 0.124, 0.3, 9.0):
        jx, tx = J.eval_animation(ja, t), T.eval_animation(ta, t)
        for k in ("position", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(tx, k), getattr(jx, k), err_msg=(k, t))
    assert T.parse_animation("not a node", T.Transformation(), T.Transformation()) is None


# ---------------------------------------------------------------------------
# scenes with moving props
# ---------------------------------------------------------------------------


def arc_root():
    """tests/test_motion.py's TestMultiKeyframe scene: three keyframes
    inside a shutter of [0, 1] s (K = 8), the sphere turning as it arcs,
    beside a moving Rectangle light over a floor (K = 8 for every prop)."""
    return {
        "materials": [
            {"name": "m", "rendering": {"Substitute": {"color": [0.9, 0.05, 0.05],
                                                       "roughness": 0.9}}},
            {"name": "l", "rendering": {"Light": {"emittance": {"value": 20.0}}}},
            {"name": "env", "rendering": {"Light": {"emittance": {"value": 1.0}}}},
        ],
        "entities": [
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["m"],
             "transformation": {"scale": [0.5, 0.5, 0.5]},
             "animation": {"keyframes": [
                 {"time": 0.0, "transformation": {"position": [-1.0, 0, 0]}},
                 {"time": 0.5, "transformation": {"position": [0.0, 1.0, 0],
                                                  "rotation": [0, 120, 0]}},
                 {"time": 1.0, "transformation": {"position": [1.0, 0, 0],
                                                  "rotation": [0, 250, 0]}}]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["m"],
             "transformation": {"position": [0, -0.5, 0], "rotation": [90, 0, 0],
                                "scale": [8, 8, 1]}},
            {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["l"],
             "transformation": {"position": [-2.0, 2.0, 0], "rotation": [-90, 0, 0],
                                "scale": [0.5, 0.5, 1]},
             "animation": {"keyframes": [
                 {"time": 0.0, "transformation": {"position": [-2.0, 2.0, 0],
                                                  "rotation": [-90, 0, 0]}},
                 {"time": 1.0, "transformation": {"position": [2.0, 2.0, 0],
                                                  "rotation": [-90, 0, 30]}}]}},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["env"]},
        ],
    }


def _load_both(root, time0, time1):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    return jload(root, time0=time0, time1=time1), tload(root, "cpu", time0=time0, time1=time1)


@pytest.fixture(scope="module")
def motion_scenes():
    """motion.scene over the take's shutter of frame 0: (JAX, port)."""
    from zyg_tpu.io.take import load_take_file

    with open(SCENE, encoding="utf-8") as f:
        root = json.load(f)
    return _load_both(root, *load_take_file(TAKE).cameras[0].frame_interval(0))


@pytest.fixture(scope="module")
def arc_scenes():
    return _load_both(arc_root(), 0.0, 1.0)


def _same_arrays(jscene, pscene):
    from zyg_tpu_torch.scene.loader import scene_arrays

    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return b


def test_motion_scene_arrays_and_keys_match_jax(motion_scenes):
    """K = 1: motion.take's second keyframes lie at 0.0833 s, past the
    shutter's 1/24 s: the endpoint slerp of half the Cube's 60 degree
    turn and half the Sphere's translation."""
    b = _same_arrays(*motion_scenes)
    assert b["prop_keys"].shape == (4, 2, 10)
    assert b["animated_props"].tolist() == [[1, 6], [2, 1]]
    assert b["animated_lights"].size == 0
    # the moving props left the static groups
    assert b["prop_groups.4"].tolist() == [3] and b["prop_groups.5"].tolist() == [0]
    f = (1.0 / 24.0) / 0.0833  # the shutter's end between the keyframes
    np.testing.assert_allclose(b["prop_keys"][2, 1, 1], np.sin(np.deg2rad(30.0 * f)), atol=1e-6)


def test_multikeyframe_arrays_and_keys_match_jax(arc_scenes):
    b = _same_arrays(*arc_scenes)
    assert b["prop_keys"].shape == (4, 9, 10)
    np.testing.assert_allclose(b["prop_keys"][0, 4, 4:7], [0.0, 1.0, 0.0], atol=1e-6)
    assert b["animated_props"].tolist() == [[0, 6], [2, 5]]
    assert b["animated_lights"].tolist() == [2]
    # consecutive quaternions are sign-aligned
    q = b["prop_keys"][0, :, 0:4]
    assert ((q[1:] * q[:-1]).sum(axis=1) >= 0.0).all()


def test_static_build_has_no_motion():
    from zyg_tpu_torch.scene.loader import load_scene_file

    s = load_scene_file(SCENE)
    assert s.animated_props is None and s.prop_keys is None
    assert sorted(s.prop_groups) == [1, 4, 5, 6]


@pytest.mark.parametrize("which", ["motion", "arc"])
def test_prop_transform_at_matches_jax(which, motion_scenes, arc_scenes):
    from zyg_tpu.scene import shapes as J
    from zyg_tpu_torch.scene import shapes as T

    js, ts = motion_scenes if which == "motion" else arc_scenes
    rng = np.random.default_rng(4)
    n = 2048
    time = rng.random(n).astype(np.float32)
    time[:4] = (0.0, 1.0, 0.5, 0.125)
    tt = torch.from_numpy(time)
    props = sorted({pk for pk, _ in ts.animated_props})
    lane_props = rng.choice(props, n).astype(np.int32)
    cases = [(pk, pk) for pk in props] + [(jnp.asarray(lane_props), torch.from_numpy(lane_props))]
    for jk, tk in cases:
        ref = jax.jit(lambda t, k=jk: J.prop_transform_at(js, k, t))(jnp.asarray(time))
        out = T.prop_transform_at(ts, tk, tt)
        for a, b, name in zip(ref, out, ("rot", "pos", "scale")):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6, rtol=0, err_msg=name)


def _rays_at(targets, n, seed, spread=0.5):
    """Rays from around (0, 0.6, -4.2) toward targets jittered by
    `spread`, with seeded shutter times."""
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.6, -4.2]) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    tgt = np.asarray(targets)[rng.integers(0, len(targets), n)] + rng.normal(0, spread, (n, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rng.random(n).astype(np.float32), rng


@pytest.mark.parametrize("which", ["motion", "arc"])
def test_intersect_and_occluded_on_moving_props_match_jax(which, motion_scenes, arc_scenes):
    from zyg_tpu.scene import shapes as J
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.scene import shapes as T

    js, ts = motion_scenes if which == "motion" else arc_scenes
    targets = ([[-1.4, 0, 0.6], [1.4, 0.3, 0.6], [0, 0.2, -0.9], [0, -0.6, 0]] if which == "motion"
               else [[-1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 2, 0]])
    n = 8192
    o, d, time, rng = _rays_at(targets, n, 9, 0.5 if which == "motion" else 0.2)
    primary = rng.random(n) < 0.5
    ref = jax.jit(lambda o, d, t, p: J.intersect_scene(js, o, d, jnp.float32(0.0),
                                                       jnp.float32(1e9), "reflection", p,
                                                       time=t))(o, d, time, primary)
    out = T.intersect_scene(ts, prop_table(ts, "reflection"), torch.from_numpy(o),
                            torch.from_numpy(d), 0.0, 1e9, primary=torch.from_numpy(primary),
                            time=torch.from_numpy(time))
    rp, pp = np.asarray(ref.prop), out.prop.numpy()
    moving = {pk for pk, _ in ts.animated_props}
    assert np.isin(rp, list(moving)).sum() > n // 16  # the moving props are hit
    assert (rp == pp).mean() >= 0.999
    same = (rp == pp) & (rp >= 0)
    np.testing.assert_allclose(out.t.numpy()[same], np.asarray(ref.t)[same], rtol=1e-5)
    # the same rays at shutter start hit elsewhere: the motion shows
    still = T.intersect_scene(ts, prop_table(ts, "reflection"), torch.from_numpy(o),
                              torch.from_numpy(d), 0.0, 1e9, primary=torch.from_numpy(primary))
    assert (still.prop.numpy() != pp).mean() > 0.05
    # shadow rays toward the targets, any-hit
    tmax = np.linalg.norm(np.asarray(targets)[rng.integers(0, len(targets), n)] - o,
                          axis=1).astype(np.float32)
    bref = np.asarray(jax.jit(lambda o, d, tm, t: J.occluded(js, o, d, jnp.float32(0.0), tm,
                                                             time=t))(o, d, tmax, time))
    bout = T.occluded(ts, prop_table(ts, "shadow"), torch.from_numpy(o), torch.from_numpy(d),
                      0.0, torch.from_numpy(tmax), time=torch.from_numpy(time)).numpy()
    assert 0 < bref.sum() < n and (bref == bout).mean() >= 0.999


def test_moving_light_nee_and_hit_pdf_match_jax(arc_scenes):
    """tests/test_motion.py's TestAnimatedLight, lane by lane: the moving
    Rectangle lamp (prop 2, light 0) is sampled and its hit pdf evaluated
    at each lane's shutter time."""
    from zyg_tpu.scene import light_sampling as JL
    from zyg_tpu.scene import shapes as J
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.scene import light_sampling as TL
    from zyg_tpu_torch.scene import shapes as T

    js, ts = arc_scenes
    rng = np.random.default_rng(12)
    n = 2048
    p = np.stack([rng.uniform(-3, 3, n), np.full(n, -0.49), rng.uniform(-2, 2, n)], 1)
    p = p.astype(np.float32)
    nrm = np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1))
    xi = rng.random((n, 2)).astype(np.float32)
    time = rng.random(n).astype(np.float32)
    time[:2] = (0.0, 1.0)
    li = np.zeros(n, np.int32)  # the lamp is the first light
    assert int(ts.lights.prop[0]) == 2
    ref = jax.jit(lambda p, x, t: JL.sample_light(js, jnp.asarray(li), p, jnp.asarray(nrm), x,
                                                  time=t))(p, xi, time)
    out = TL.sample_light(ts, TL.light_shapes(ts), torch.from_numpy(li), torch.from_numpy(p),
                          torch.from_numpy(nrm), torch.from_numpy(xi), time=torch.from_numpy(time))
    lp = out.light_p.numpy()
    assert abs(lp[0, 0] + 2.0) < 0.5 and abs(lp[1, 0] - 2.0) < 0.5  # follows the shutter
    # an ulp of the slerped rotation moves a point sampled through the
    # spherical rectangle's inversion by up to ~4e-5 (measured 3.6e-5)
    np.testing.assert_allclose(lp, np.asarray(ref.light_p), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.wi.numpy(), np.asarray(ref.wi), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.pdf.numpy(), np.asarray(ref.pdf), rtol=2e-4, atol=1e-6)
    # hit pdf: rays from the floor toward the lamp where it stands at each time
    tgt = lp + rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    d = tgt - p
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = p + np.float32(1e-3) * nrm
    hit = T.intersect_scene(ts, prop_table(ts, "reflection"), torch.from_numpy(o),
                            torch.from_numpy(d), 0.0, 1e9, time=torch.from_numpy(time))
    on = hit.prop.numpy() == 2
    assert on.mean() > 0.5
    def ref_pdf(o, d, t):
        jh = J.intersect_scene(js, o, d, jnp.float32(0.0), jnp.float32(1e9), time=t)
        jf = J.build_fragment(js, jh, o, d, time=t)
        return jh, JL.light_hit_pdf(js, jh.prop, o, d, jh.t, jf.p, jf.geo_n, jnp.asarray(nrm),
                                    time=t)

    jh, lref = jax.jit(ref_pdf)(o, d, time)
    lref = np.asarray(lref)
    lout = TL.light_hit_pdf(ts, TL.light_shapes(ts), hit.prop, torch.from_numpy(o),
                            torch.from_numpy(d), time=torch.from_numpy(time)).numpy()
    both = on & (np.asarray(jh.prop) == 2)
    assert (lout[both] > 0).all()
    np.testing.assert_allclose(lout[both], lref[both], rtol=2e-4)


# ---------------------------------------------------------------------------
# moving mesh instances
# ---------------------------------------------------------------------------


def _moving_instances():
    """Three trefoil instances: one that moves, turns and scales, one
    static, one that turns 179 degrees about y."""
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    return [
        dict(prop=1, mesh=0, rot=rot([30, -50, 70]), pos=np.float32([0.3, -0.2, 0.5]),
             scale=np.float32([0.35, 0.5, 0.3]), rot1=rot([10, 40, 75]),
             pos1=np.float32([0.9, 0.3, 0.2]), scale1=np.float32([0.45, 0.4, 0.3])),
        dict(prop=2, mesh=0, rot=np.eye(3, dtype=np.float32), pos=np.float32([-0.5, 0.4, 0.1]),
             scale=np.full(3, 0.3, np.float32)),
        dict(prop=3, mesh=0, rot=rot([0, 0, 0]), pos=np.float32([-0.8, -0.6, -0.2]),
             scale=np.full(3, 0.25, np.float32), rot1=rot([0, 179, 0]),
             pos1=np.float32([-0.8, -0.6, -0.2]), scale1=np.full(3, 0.25, np.float32)),
    ]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_traversal_over_moving_instances_matches_jax(any_hit):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene import trimesh as T

    aj = J.build_arena([J.make_trefoil_mesh(48, 32)])
    at, ht = T.build_arena([T.make_trefoil_mesh(48, 32)])
    ij = J.build_instance_table({"node_rows": np.asarray(aj.node_rows),
                                 "mesh_root": np.asarray(aj.mesh_root)}, _moving_instances())
    it = T.build_instance_table(ht, _moving_instances())
    assert it.has_anim and next(iter(ij.meta))[0]
    for k in ("wmin", "wmax", "trafo", "vis"):
        np.testing.assert_array_equal(getattr(it, k).numpy(), np.asarray(getattr(ij, k)),
                                      err_msg=k)
    rng = np.random.default_rng(21)
    n = 4096
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = ((tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)).astype(np.float32)
    time = rng.random(n).astype(np.float32)
    to, td, tt = (torch.from_numpy(x) for x in (o, d, time))
    with pytest.raises(ValueError, match="shutter times"):
        traverse.intersect_instances(at, it, to, td, 0.0, 1e9)
    if any_hit:
        tmax = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
        ref = np.asarray(jax.jit(lambda o, d, tm, t: J.intersect_instances(
            aj, ij, o, d, jnp.float32(0.0), tm, "shadow", time=t, any_hit=True).prim >= 0)(
                o, d, tmax, time))
        out = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax), "shadow",
                                           any_hit=True, time=tt).numpy()
        assert 0 < ref.sum() < n and (out == ref).mean() >= 0.999
        return
    tmax = np.full(n, 1e9, np.float32)
    r = jax.jit(lambda o, d, t: J.intersect_instances(aj, ij, o, d, jnp.float32(0.0),
                                                      jnp.asarray(tmax), "reflection",
                                                      time=t))(o, d, time)
    t, prim, u, v, prop = (x.numpy() for x in traverse.intersect_instances(
        at, it, to, td, 0.0, torch.from_numpy(tmax), "reflection", time=tt))
    rprim, rprop = np.asarray(r.prim), np.asarray(r.prop)
    assert (rprim >= 0).sum() > n // 5 and {1, 3} <= set(rprop.tolist())
    same = (prim == rprim) & (prop == rprop)
    assert same.mean() >= 0.999
    hit = same & (rprim >= 0)
    np.testing.assert_allclose(t[hit], np.asarray(r.t)[hit], rtol=1e-5)
    # at another time the moving instances are hit elsewhere
    t2 = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax), "reflection",
                                      time=1.0 - tt)[1].numpy()
    assert (t2 != prim).mean() > 0.02


def test_moving_mesh_prop_through_the_loader_matches_jax():
    """An animated proc:sphere prop: its instance row's shutter end, its
    fragment at seeded times, and the kernel 3/5 dispatch gates."""
    from zyg_tpu.scene import shapes as J
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.ops.shade import structural_ok
    from zyg_tpu_torch.ops.surface import structural_ok_mesh
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2
    from zyg_tpu_torch.scene import shapes as T

    root = arc_root()
    root["entities"][0]["shape"] = {"file": "proc:sphere"}
    js, ts = _load_both(root, 0.0, 1.0)
    b = _same_arrays(js, ts)
    assert b["mesh_instances.has_anim"] and b["prop_keys"].shape == (4, 9, 10)
    assert not structural_ok(ts) and not structural_ok_mesh(ts) and structural_ok_mesh_v2(ts)
    n = 4096
    o, d, time, _ = _rays_at([[-1, 0, 0], [-0.5, 0.8, 0], [0, 1, 0], [0.5, 0.8, 0], [1, 0, 0]],
                             n, 17, 0.1)
    def ref(o, d, t):
        jh = J.intersect_scene(js, o, d, jnp.float32(0.0), jnp.float32(1e9), time=t)
        return jh, J.build_fragment(js, jh, o, d, time=t)

    jh, jf = jax.jit(ref)(o, d, time)
    th = T.intersect_scene(ts, prop_table(ts, "reflection"), torch.from_numpy(o),
                           torch.from_numpy(d), 0.0, 1e9, time=torch.from_numpy(time))
    rp, pp = np.asarray(jh.prop), th.prop.numpy()
    assert (rp == 0).sum() > n // 32 and (rp == pp).mean() >= 0.999
    tf = T.build_fragment(ts, th, torch.from_numpy(o), torch.from_numpy(d),
                          time=torch.from_numpy(time))
    mesh = (rp == 0) & (pp == 0) & (np.asarray(jh.prim) == th.prim.numpy())
    for name in ("p", "geo_n", "n"):
        np.testing.assert_allclose(getattr(tf, name).numpy()[mesh],
                                   np.asarray(getattr(jf, name))[mesh], atol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the general body: a moving sphere beside glass
# ---------------------------------------------------------------------------


def _glass_root():
    root = arc_root()
    root["materials"].append({"name": "glass", "rendering": {"Glass": {"ior": 1.5}}})
    root["entities"].insert(1, {"type": "Prop", "shape": {"type": "Sphere"},
                                "materials": ["glass"],
                                "transformation": {"position": [0.2, 0.3, 0.6],
                                                   "scale": [0.9, 0.9, 0.9]}})
    # the general body's lights: a Rectangle and a Dome
    return root


def test_general_bounce_with_moving_sphere_beside_glass_matches_jax():
    from test_torch_render_material import _exact, _jax_state, _rel
    from zyg_tpu.render.integrator import ptmis as jp
    from zyg_tpu_torch.render.integrator import ptmis as tp

    import chip_smoke

    js, ts = _load_both(_glass_root(), 0.0, 1.0)
    n = 4096
    rng = np.random.default_rng(31)
    o = np.array([0, 0.6, -4.2]) + rng.uniform(-0.3, 0.3, (n, 3))
    tgt = rng.uniform([-1.5, -0.4, -0.6], [1.5, 1.5, 1.2], (n, 3))
    s = chip_smoke.general_state(ts, o, tgt, 0, 6, split=True)
    s = dataclasses.replace(s, time=torch.from_numpy(rng.random(n).astype(np.float32)))
    body = tp._make_body(ts, tp.PtmisSettings(max_depth=6, bsdf_split=True))
    assert getattr(body, "general", False)
    for _ in range(2):
        s = body(tp.resume_split(s))
    s = dataclasses.replace(s, rays=torch.zeros((), dtype=torch.int64))
    js0 = _jax_state(s)._replace(time=jnp.asarray(s.time.numpy()))
    jbody = jp._make_body(js, jp.PtmisSettings(max_depth=6, bsdf_split=True))
    r1 = jax.jit(lambda x: jbody(jp.resume_split(x)))(js0)
    r2 = body(tp.resume_split(s))
    # the lanes keep their times, and the moving sphere is hit
    np.testing.assert_array_equal(np.asarray(r1.time), r2.time.numpy())
    assert torch.equal(r2.time, s.time)
    for name in ("alive", "depth", "medium", "singular", "vol_key"):
        _exact(getattr(r1, name), getattr(r2, name), name)
    assert int(r1.rays) == int(r2.rays)
    _exact(r1.split["pending"], r2.split["pending"], "split.pending")
    live = np.asarray(r1.alive)
    for name, tol in (("o", 1e-5), ("mis_o", 1e-5), ("d", 2e-4), ("throughput", 5e-3)):
        _rel(getattr(r1, name), getattr(r2, name), live, tol, name)
    for c in ("emission", "direct", "indirect"):
        _rel(getattr(r1.result, c), getattr(r2.result, c), np.ones_like(live), 5e-3, c)
    assert int(r2.split["pending"].sum()) > 20 and int((r2.medium[:, 0] >= 0).sum()) > 20


def test_drain_compaction_and_split_resume_keep_time():
    from zyg_tpu_torch.render.integrator import ptmis as tp

    import chip_smoke

    rng = np.random.default_rng(2)
    n = 64
    s = chip_smoke.general_state(_load_both(_glass_root(), 0.0, 1.0)[1],
                                 rng.uniform(-1, 1, (n, 3)) + [0, 0.6, -4.2],
                                 rng.uniform(-1, 1, (n, 3)), 0, 6, split=True)
    time = torch.from_numpy(rng.random(n).astype(np.float32))
    s = dataclasses.replace(s, time=time, alive=torch.arange(n) % 2 == 0)
    s.split["pending"] = torch.ones(n, dtype=torch.bool)
    assert torch.equal(tp.resume_split(s).time, time)
    idx = torch.from_numpy(rng.permutation(n)[:16])
    assert torch.equal(s.index(idx).time, time[idx])


# ---------------------------------------------------------------------------
# the take as a whole
# ---------------------------------------------------------------------------


def _take(module, res, spp):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    return take


def test_motion_render_matches_jax_at_golden_gate(motion_scenes):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    js, ts = motion_scenes
    jd = JDriver(take=_take(jtake, (48, 32), 8), scene=js)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (48, 32), 8), ts, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (32, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced


def test_cli_writes_a_frame_sequence(tmp_path):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.png import read_png

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [24, 16]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "motion_small.take"
    path.write_text(json.dumps(take))
    assert cli.main(["-i", str(path), "-o", str(tmp_path / "m.png"), "-f", "3", "-n", "2",
                     "--device", "cpu"]) == 0
    frames = [read_png(str(tmp_path / f"m_{f:06d}.png")) for f in (3, 4)]
    assert all(f.shape == (16, 24, 3) for f in frames) and not (tmp_path / "m.png").exists()
    # the keyframes end at 0.0833 s: frames 3 and 4 both hold the last one
    assert np.array_equal(*frames)
    assert cli.main(["-i", str(path), "-o", str(tmp_path / "seq_###.png"), "-n", "2",
                     "--device", "cpu"]) == 0
    frames = [read_png(str(tmp_path / f"seq_{f:03d}.png")) for f in (0, 1)]
    assert not np.array_equal(*frames)  # frame 1's shutter moves the props on
    assert cli.frame_output("a_##.exr", 123) == "a_123.exr"


def test_texture_sequences_are_refused_by_name(tmp_path):
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    root = arc_root()
    root["materials"][0]["rendering"]["Substitute"]["color"] = {"file": "tex_####.png"}
    with pytest.raises(UnsupportedScene, match="texture file sequences"):
        load_scene_dict(root, base_dir=str(tmp_path))
