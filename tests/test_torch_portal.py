"""The portal slice as a whole: examples/takes/portal.take (a Sky seen
through a 1.4x1.4 Rectangle portal in a closed room of nine walls and a
sphere; PTMIS depth 8) against the JAX package.

- The loaded scene's arrays equal through scene_arrays: props with the
  dome's and the portal's visibility flags, the light CDF, the two-light
  tree (sun and portal) and the portal's tables (portals.<light>.<prop>.*);
  the light shape keys equal, the portal not sampled as a Rectangle.
- build_portal_dist's grid and prefix sums byte-equal, on the scene's sky
  and on seeded env images under seeded rotations.
- sample_to / pdf_to per lane against zyg_tpu/scene/portal.py: ok and the
  cell indices (yc, xc) exact away from cell boundaries, wi and uv within
  1e-4, t within rtol 1e-4, pdf within rtol 2e-2 (torch and XLA round
  atan2, tan and acos an ulp apart; PR 3's dome tolerances); the
  sample <-> pdf round trip as tests/test_portal.py:147 holds it.
- The fragment's portal uv (the dome's map at the ray direction) and the
  any-hit of shadow rays through the shadow-invisible window.
- One kernel-6 bounce (its plain version) on 2,048 portal lanes against
  JAX's v2 body in interpret mode, under test_torch_surface_v2.py's rules.
- A 48x36x8 image against the JAX Driver at the golden gate (mean within
  1.5 %, 4x4 RMSE within 6 % of the mean), rays within 1e-3.
- The CLI on a small copy of the take.
"""

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

TAKE = "examples/takes/portal.take"
SCENE = "examples/scenes/portal.scene"


@pytest.fixture(scope="module")
def jax_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file(SCENE)


@pytest.fixture(scope="module")
def port_scene():
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(SCENE)


@pytest.fixture(scope="module")
def handed(jax_scene):
    """The port's scene built from the JAX scene's tables."""
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    return scene_from_jax_arrays(scene_arrays(jax_scene), "cpu")


def _portal(scene):
    ((li, pp), pd), = scene.portals.items()
    return li, pp, pd


def test_portal_scene_matches_jax_arrays(jax_scene, port_scene):
    from zyg_tpu_torch.scene import light_sampling as ls
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    a, b = scene_arrays(jax_scene), scene_arrays(port_scene)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    li, pp, _ = _portal(port_scene)
    assert {f"portals.{li}.{pp}.{f}" for f in ("pfx", "pfx_t", "dome_rot")} <= set(b)
    assert "light_tree.center" in b and "env.table" not in b
    # the dome is no light and hidden from every ray; the portal, the
    # last prop, is a light that no shadow ray sees
    dome = 0
    assert int(port_scene.prop_shape[dome]) == int(ShapeType.DOME)
    for vis in ("camera", "reflection", "shadow"):
        assert not bool(getattr(port_scene, f"prop_visible_{vis}")[dome]), vis
    assert pp == port_scene.prop_shape.shape[0] - 1 == 12
    assert int(port_scene.prop_shape[pp]) == int(ShapeType.RECTANGLE)
    assert not bool(port_scene.prop_visible_shadow[pp])
    assert bool(port_scene.prop_visible_camera[pp] & port_scene.prop_visible_reflection[pp])
    assert port_scene.lights.prop.tolist() == [1, pp] and li == 1
    assert int(port_scene.prop_light[dome]) == -1
    # the sun and the portal: a tree with one finite light, as on sunsky
    assert port_scene.light_tree.num_finite == 1
    shapes = ls.light_shapes(port_scene)
    assert shapes == {int(ShapeType.DISTANT), ls.PORTAL}
    assert {str(k) for k in shapes} == set(jax_scene.light_shapes)


def test_portal_bake_is_byte_equal(port_scene):
    from zyg_tpu.scene import portal as jp
    from zyg_tpu_torch.scene import portal as tp
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    rng = np.random.default_rng(31)
    _, pp, pd = _portal(port_scene)
    tex = port_scene.textures  # the Sky's bake is texture 0
    sky = tex.data[: int(tex.height[0]) * int(tex.width[0])].numpy().reshape(
        int(tex.height[0]), int(tex.width[0]), 4)
    cases = [(sky, pd.dome_rot.numpy().astype(np.float64),
              port_scene.prop_rot[pp].numpy().astype(np.float64))]
    for _ in range(3):
        img = (rng.random((24, 48, 4)) ** 3 * 8.0).astype(np.float32)
        cases.append((img, rot(rng.uniform(-180, 180, 3)).astype(np.float64),
                      rot(rng.uniform(-180, 180, 3)).astype(np.float64)))
    for img, dr, pr in cases:
        (la, ma), (lb, mb) = jp.build_portal_dist(img, dr, pr), tp.build_portal_dist(img, dr, pr)
        assert la.dtype == lb.dtype == np.float32 and la.tobytes() == lb.tobytes() and ma == mb
        ja, tb = jp.make_portal_dist(la, dr), tp.make_portal_dist(lb, dr)
        for k in ("pfx", "pfx_t", "dome_rot"):
            assert np.asarray(getattr(ja, k)).tobytes() == getattr(tb, k).numpy().tobytes(), k
    assert pd.pfx.shape == (64, 65) and pd.pfx_t.shape == (65, 64)


def _room_points(n, seed):
    """Points inside the room, short of its walls."""
    rng = np.random.default_rng(seed)
    return rng.uniform([-1.8, 0.1, -1.8], [1.8, 2.9, 1.8], (n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def samples(jax_scene, handed):
    """(JAX sample_to, port sample_to, points, uniforms) at 20,000 room
    points over the same portal tables."""
    from zyg_tpu.scene import portal as jp
    from zyg_tpu_torch.scene import portal as tp

    li, pp, pd = _portal(handed)
    n = 20000
    p = _room_points(n, 11)
    r2 = np.random.default_rng(12).random((n, 2)).astype(np.float32)
    geo = [np.asarray(x)[pp] for x in (jax_scene.prop_rot, jax_scene.prop_pos,
                                       jax_scene.prop_scale)]
    ref = jax.jit(jp.sample_to)(jax_scene.portals[(li, pp)], *geo, p, r2)
    t = torch.from_numpy
    got = tp.sample_to(pd, handed.prop_rot[pp], handed.prop_pos[pp], handed.prop_scale[pp], t(p),
                       t(r2))
    return {k: np.asarray(v) for k, v in ref.items()}, got, p, r2


def test_sample_to_matches_jax(samples):
    ref, got, _, _ = samples
    ok = ref["ok"]
    np.testing.assert_array_equal(got["ok"].numpy(), ok)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(got["wi"].numpy()[ok], ref["wi"][ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["uv"].numpy()[ok], ref["uv"][ok], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy()[ok], ref["t"][ok], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["pdf"].numpy()[ok], ref["pdf"][ok], rtol=2e-2, atol=0)


def test_windowed_cells_match_jax(jax_scene, handed):
    """The sampled cell (yc, xc) exactly, on the JAX window, away from
    cell boundaries; the share of lanes within 1e-4 cells of a boundary
    (where an ulp may flip the cell) is reported and small."""
    from zyg_tpu.scene import portal as jp
    from zyg_tpu_torch.scene import portal as tp

    li, pp, pd = _portal(handed)
    n = 20000
    p = _room_points(n, 13)
    r2 = np.random.default_rng(14).random((n, 2)).astype(np.float32)
    geo = [np.asarray(x)[pp] for x in (jax_scene.prop_rot, jax_scene.prop_pos,
                                       jax_scene.prop_scale)]
    lo, hi, _ = jax.jit(jp.image_bounds)(p, *geo)
    uv_ref, pdf_ref = (np.asarray(x) for x in jax.jit(jp.sample_windowed)(
        jax_scene.portals[(li, pp)], lo, hi, r2))
    t = torch.from_numpy
    uv, pdf = tp.sample_windowed(pd, t(np.array(lo)), t(np.array(hi)), t(r2))
    cells_ref, cells = np.floor(uv_ref * 64), np.floor(uv.numpy() * 64)
    frac = uv_ref * 64 - cells_ref
    inner = ((frac > 1e-4) & (frac < 1 - 1e-4)).all(axis=1)
    np.testing.assert_array_equal(cells[inner], cells_ref[inner])
    assert (~inner).mean() < 5e-3, (~inner).mean()
    np.testing.assert_allclose(pdf.numpy()[inner], pdf_ref[inner], rtol=1e-5, atol=0)


def test_sample_pdf_roundtrip(samples, handed):
    """pdf_to of each sampled direction is the sample's pdf (MIS), as
    tests/test_portal.py:147 holds the JAX functions."""
    from zyg_tpu_torch.scene import portal as tp

    _, got, p, _ = samples
    _, pp, pd = _portal(handed)
    pq = tp.pdf_to(pd, handed.prop_rot[pp], handed.prop_pos[pp], handed.prop_scale[pp],
                   torch.from_numpy(p), got["wi"]).numpy()
    ok, pdf = got["ok"].numpy(), got["pdf"].numpy()
    rel = np.abs(pq - pdf) / np.maximum(pdf, 1e-6)
    assert np.median(rel[ok]) < 1e-4
    assert (rel[ok] > 1e-2).mean() < 5e-3


def test_pdf_to_matches_jax(jax_scene, handed, samples):
    """pdf_to at the JAX sample's directions and at random ones (most
    outside the window: pdf 0) within rtol 2e-2."""
    from zyg_tpu.scene import portal as jp
    from zyg_tpu_torch.scene import portal as tp

    ref, _, p, _ = samples
    li, pp, pd = _portal(handed)
    rnd = np.random.default_rng(15).normal(size=p.shape).astype(np.float32)
    wi = np.concatenate([ref["wi"], rnd / np.linalg.norm(rnd, axis=1, keepdims=True)])
    pts = np.concatenate([p, p])
    geo = [np.asarray(x)[pp] for x in (jax_scene.prop_rot, jax_scene.prop_pos,
                                       jax_scene.prop_scale)]
    want = np.asarray(jax.jit(jp.pdf_to)(jax_scene.portals[(li, pp)], *geo, pts, wi))
    t = torch.from_numpy
    got = tp.pdf_to(pd, handed.prop_rot[pp], handed.prop_pos[pp], handed.prop_scale[pp],
                    t(pts), t(wi)).numpy()
    assert (want > 0).sum() > 20000 and (want == 0).sum() > 1000
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)


def _window_rays(scene, n, seed):
    """Rays from room points: every third toward a point of the window,
    every third toward the sun (through the window where the sun lies
    beyond it), the rest random."""
    rng = np.random.default_rng(seed)
    o = _room_points(n, seed)
    tgt = np.array([0.0, 1.5, 2.0]) + rng.uniform([-0.65, -0.65, 0.0], [0.65, 0.65, 0.0], (n, 3))
    d = rng.normal(size=(n, 3))
    d = np.where((np.arange(n) % 3 == 0)[:, None], tgt - o, d)
    sun = -scene.prop_rot[int(scene.lights.prop[0])][2].numpy()
    d = np.where((np.arange(n) % 3 == 1)[:, None], sun, d)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_fragment_portal_uv_and_window_shadows_match_jax(jax_scene, handed):
    """Closest hits through the window land on the portal, whose uv is the
    dome's lat-long uv of the ray direction; shadow rays pass the window
    (and the hidden dome) and stop at the walls: hit props and any-hits
    exact, points, normals and uv within 2e-5."""
    from zyg_tpu.scene import shapes as jshapes
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    _, pp, pd = _portal(handed)
    o, d = _window_rays(handed, 4096, 21)
    tmax = np.full(4096, RAY_MAX_T, np.float32)

    @jax.jit
    def ref(o, d, tmax):
        hit = jshapes.intersect_scene(jax_scene, o, d, jnp.float32(0.0), tmax, "reflection")
        blocked = jshapes.occluded(jax_scene, o, d, jnp.float32(0.0), tmax)
        return hit.prop, jshapes.build_fragment(jax_scene, hit, o, d), blocked

    jprop, jf, jblocked = ref(o, d, tmax)
    t = torch.from_numpy
    hit = shapes.intersect_scene(handed, isect.prop_table(handed, "reflection"), t(o), t(d), 0.0,
                                 t(tmax))
    f = shapes.build_fragment(handed, hit, t(o), t(d))
    blocked = shapes.occluded(handed, isect.prop_table(handed, "shadow"), t(o), t(d), 0.0, t(tmax))
    prop = hit.prop.numpy()
    np.testing.assert_array_equal(prop, np.asarray(jprop))
    on = prop == pp
    assert on.sum() > 1000 and (prop == -1).sum() == 0  # a closed room: nothing escapes
    np.testing.assert_allclose(f.p.numpy(), np.asarray(jf.p), rtol=1e-6, atol=1e-5)
    for k in ("n", "uv"):
        np.testing.assert_allclose(getattr(f, k).numpy(), np.asarray(getattr(jf, k)), rtol=0,
                                   atol=2e-5, err_msg=k)
    from zyg_tpu_torch.scene.portal import dome_uv_of_dir

    np.testing.assert_array_equal(f.uv.numpy()[on], dome_uv_of_dir(pd.dome_rot, t(d))[on].numpy())
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(jblocked))
    # the rays toward the window that reach it are not blocked
    assert not blocked.numpy()[on].any() and blocked.numpy()[~on].all()


def test_v2_body_on_portal_lanes_matches_jax(jax_scene, handed):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    a = _arrays(2048)
    a["o"], a["d"] = _window_rays(handed, 2048, 23)
    body_ref = jshade.make_mesh_fused_body_v2(jax_scene, jptmis.PtmisSettings(max_depth=8),
                                              force_interpret=True)
    r1 = jax.jit(body_ref)(_jax_state(a))
    body = surface_v2.make_mesh_fused_body_v2(handed, PtmisSettings(max_depth=8))
    s = _port_state(a)
    st = body.inputs(s)[0]
    _, pp, _ = _portal(handed)
    # lanes on the portal's emission with its MIS weight, and NEE candidates
    # through the window
    assert int((st["is_light"] & (st["hit_lp"] > 0.0)).sum()) > 300
    assert int((st["nee_pre"] & (st["nee_lpdf"] > 0.0)).sum()) > 500
    _compare_bounce(r1, body(s))


def _take(module, res, spp):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    return take


def test_portal_render_matches_jax_at_golden_gate(jax_scene, port_scene):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.ops.surface_v2 import GeneralBounce
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.render.integrator import ptmis

    jd = JDriver(take=_take(jtake, (48, 36), 8), scene=jax_scene)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (48, 36), 8), port_scene, device="cpu")
    assert isinstance(ptmis._make_body(d.scene, d.settings), GeneralBounce)
    img = d.render_frame()
    assert img.shape == ref.shape == (36, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    assert abs(d.last_iterations - jd.last_iterations) <= 2


def test_cli_renders_portal(tmp_path):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [32, 24]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    take["integrator"]["surface"]["PTMIS"]["depth"]["surface"] = 3
    path = tmp_path / "portal_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (24, 32, 3) and img.mean() > 5
