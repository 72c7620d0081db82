"""The sunsky slice as a whole: examples/takes/sunsky.take (a Sky entity, a
baked Preetham dome plus a distant sun, over a ground rectangle with a
proc:sphere mesh and a gold cube; PTMIS, AgX) against the JAX package.

- The sun's constants and radiance array-equal; the loaded scene's arrays
  equal through scene_arrays (the sun's material, the baked sky texture,
  the env alias table, the power CDF over the dome and the sun; no light
  tree: both lights are infinite).
- The fragment of closest hits on 4,096 rays, a quarter of them aimed
  into the sun's disc: hit props exact; points within 1e-6 relative; the
  sun's normal exact; uv within 1e-5 (the sun's, whose u and v are
  divided by its radius tan(0.00465), within 2e-4).
- One general bounce (kernel 6's plain version) on 2,048 sunsky lanes, a
  quarter of them aimed at the sun, against make_mesh_fused_body_v2(
  force_interpret=True): test_torch_surface_v2.py's rules (lifecycles,
  rays and Sobol' state exact, its per-lane tolerances).
- The golden gate at the JAX sky test's own size (48x32, 8 spp, depth 4;
  tests/test_sky_textures.py:41): mean within 1.5 %, 4x4 RMSE within 6 %
  of the mean, rays within 1e-3, iterations within 2.
- The CLI renders a small copy of the take to a PNG on the CPU.
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

TAKE = "examples/takes/sunsky.take"
SCENE = "examples/scenes/sunsky.scene"


@pytest.fixture(scope="module")
def jax_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file(SCENE)


@pytest.fixture(scope="module")
def port_scene():
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(SCENE)


def test_sun_matches_jax():
    from zyg_tpu.scene import sky as jsky
    from zyg_tpu_torch.scene import sky as tsky

    assert tsky.SUN_ANGULAR_RADIUS == jsky.SUN_ANGULAR_RADIUS
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(16, 3))
    dirs[:, 1] = -np.abs(dirs[:, 1])
    for d, turbidity in zip(dirs, np.linspace(1.5, 9.0, 16)):
        a, b = jsky.sun_radiance(d, turbidity), tsky.sun_radiance(d, turbidity)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_sunsky_scene_matches_jax_arrays(jax_scene, port_scene):
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    a, b = scene_arrays(jax_scene), scene_arrays(port_scene)
    assert sorted(a) == sorted(b)
    assert {"textures.data", "env.table", "lights.cdf", "meshes.node_rows"} <= set(a)
    assert not any(k.startswith("light_tree.") for k in a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    shapes = port_scene.prop_shape[port_scene.lights.prop.long()].tolist()
    assert shapes == [int(ShapeType.DOME), int(ShapeType.DISTANT)]
    # neither the dome nor the sun blocks a shadow ray
    assert not port_scene.prop_visible_shadow[port_scene.lights.prop.long()].any()


def _sun_frame(scene):
    sun = int(scene.lights.prop[1])
    rot = scene.prop_rot[sun].numpy()
    return rot, float(scene.prop_scale[sun, 0])


def _rays(scene, n, seed):
    """o above the ground; d random, with every 4th lane aimed into the
    sun's disc (offsets up to 0.8 of its radius)."""
    rot, radius = _sun_frame(scene)
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.0, 0.1, -3.0], [3.0, 3.0, 3.0], (n, 3))
    d = rng.normal(size=(n, 3))
    disc = rng.uniform(-0.55, 0.55, (n, 2)) * radius
    sun = -rot[2] + disc[:, 0:1] * rot[0] + disc[:, 1:2] * rot[1]
    d = np.where((np.arange(n) % 4 == 0)[:, None], sun, d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_distant_fragment_matches_jax(jax_scene, port_scene):
    from zyg_tpu.scene import shapes as jshapes
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T, ShapeType

    o, d = _rays(port_scene, 4096, 1)
    tmax = np.full(o.shape[0], RAY_MAX_T, np.float32)

    @jax.jit
    def ref(o, d, tmax):
        hit = jshapes.intersect_scene(jax_scene, o, d, jnp.float32(0.0), tmax, "reflection")
        return hit, jshapes.build_fragment(jax_scene, hit, o, d)

    jhit, jfrag = ref(o, d, tmax)
    t = torch.from_numpy
    table = isect.prop_table(port_scene, "reflection")
    hit = shapes.intersect_scene(port_scene, table, t(o), t(d), 0.0, t(tmax))
    frag = shapes.build_fragment(port_scene, hit, t(o), t(d))
    np.testing.assert_array_equal(np.asarray(jhit.prop), hit.prop.numpy())
    shape = port_scene.prop_shape[torch.clamp(hit.prop, min=0).long()].numpy()
    on_sun = (hit.prop.numpy() >= 0) & (shape == int(ShapeType.DISTANT))
    assert on_sun.sum() > 500 and (shape == int(ShapeType.DOME)).sum() > 500
    np.testing.assert_allclose(frag.p.numpy(), np.asarray(jfrag.p), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(frag.n.numpy()[on_sun], np.asarray(jfrag.n)[on_sun])
    np.testing.assert_array_equal(frag.material.numpy(), np.asarray(jfrag.material))
    juv, tuv = np.asarray(jfrag.uv), frag.uv.numpy()
    np.testing.assert_allclose(tuv[on_sun], juv[on_sun], rtol=0, atol=2e-4)
    np.testing.assert_allclose(tuv[~on_sun], juv[~on_sun], rtol=0, atol=1e-5)
    assert ((tuv[on_sun] > 0.0) & (tuv[on_sun] < 1.0)).all()


def test_v2_body_on_sunsky_matches_jax(jax_scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    port = scene_from_jax_arrays(scene_arrays(jax_scene), "cpu")
    body_ref = jshade.make_mesh_fused_body_v2(jax_scene, jptmis.PtmisSettings(max_depth=4),
                                              force_interpret=True)
    a = _arrays(2048)
    a["o"], a["d"] = _rays(port, 2048, 2)
    a["o"][:, 1] += 0.5  # over the ground, some inside the sphere's reach
    r1 = jax.jit(body_ref)(_jax_state(a))
    body = surface_v2.make_mesh_fused_body_v2(port, PtmisSettings(max_depth=4))
    s = _port_state(a)
    st = body.inputs(s)[0]
    sun = int(port.lights.prop[1])
    # lanes on the sun's emission with its MIS weight, and NEE toward it
    assert int((st["is_light"] & (st["hit_lp"] > 1e3)).sum()) > 100
    assert int(st["nee_pre"].sum()) > 500 and sun >= 0
    r2 = body(s)
    _compare_bounce(r1, r2)


def _take(module, res, spp, depth):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    take.integrator.max_depth_surface = depth
    return take


@pytest.fixture(scope="module")
def renders(jax_scene, port_scene):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    jd = JDriver(take=_take(jtake, (48, 32), 8, 4), scene=jax_scene)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (48, 32), 8, 4), port_scene, device="cpu")
    img = d.render_frame()
    return (ref, jd.rays_traced, jd.last_iterations), (img, d.rays_traced, d.last_iterations)


def test_sunsky_render_matches_jax_at_golden_gate(renders):
    from zyg_tpu.tools.it import op_downsample

    (ref, jrays, jiters), (img, rays, iters) = renders
    assert img.shape == ref.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(rays - jrays) <= 1e-3 * jrays
    assert abs(iters - jiters) <= 2
    # the upper rows see the sky: blue over red, as the JAX test asserts
    sky = img[:6].reshape(-1, 3)
    assert sky[:, 2].mean() > sky[:, 0].mean()


def test_cli_renders_sunsky(tmp_path):
    from zyg_tpu_torch import cli
    from zyg_tpu.io.png import read_png

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [32, 18]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    take["integrator"]["surface"]["PTMIS"]["depth"]["surface"] = 2
    path = tmp_path / "sunsky_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3) and img.mean() > 10
