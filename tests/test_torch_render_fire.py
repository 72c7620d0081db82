"""Emissive media and volume lights as a whole: examples/takes/fire.take
(an emissive Volumetric Cube with a 64^3 fbm density grid over a
Substitute floor, its only light) through the port's general body
(zyg_tpu_torch/render/integrator/ptmis_general.py, with the emission of
render/integrator/volume.py and ops/track.py and the volume lights of
scene/light_sampling.py) against the JAX package.

- Loader: fire.scene's arrays equal the JAX loader's but for the
  volume light's Distribution3D tables (within 8 ulp,
  tests/test_torch_distribution.py): `lights.volume`, the light CDF,
  `light_shapes` {"volume"}, mat_features with "vol_emission"; with a
  Rectangle lamp beside it the light tree (the Cube's bound: centre,
  radius 1/2 |scale|, the full cone) equals the JAX tree; an emissive
  Volumetric Sphere glows but is no light.
- sample_light / light_radiance / light_hit_pdf on 4,096 seeded lanes
  (shading points around the fire, half of them scatter vertices) over
  the hand-off of the JAX scene (its Distribution3D tables, so that the
  sampling and not the tables' rounding is compared): the light index,
  vol_mask and infinite exact; wi, the interior point and its distance
  within 2e-6 (equal on these lanes); pdf (dist^2 / volume x the
  Distribution3D density) within rtol 1e-5 (measured 2.0e-7 on 601
  lanes); the radiance mu_a e density within rtol 1e-5 + 1e-5 absolute
  (the port's trilinear density sums its 8 terms in another order than
  XLA, up to 6e-8 absolute; measured 2.2e-7 relative on 747 lanes); the hit pdf of the Cube 0.
- One general bounce on 4,096 fire lanes after two bounces of the
  port's body, against the JAX `_make_body` on the same JAX scene:
  lifecycle fields, the Sobol' state (xi3_l drawn after xi_l) and the
  ray count exact; o, mis_o, d, mis_n within 1e-5, bxdf_pdf 1e-5,
  throughput 2e-3 (relative, |a - b| / (|a| + 1e-3), on live lanes;
  measured 8.4e-4 on 8 of 4,096 lanes, each a vacuum lane's sample of
  the rough Substitute floor, whose float32 GGX energy fits are
  ill-conditioned; the material bounce holds throughput within 5e-3);
  emission and indirect radiance within 1e-4, direct 1e-2 (NEE through
  the fire multiplies the shadow walk's ratio estimate, test_torch_render_
  smoke.py's tolerance).
- The Driver's tile and chunk plans against the JAX Driver's: fire at
  its own 960x540 is two tiles of 262,144 and 256,256 pixels, 8 samples
  a chunk.
- A purely absorbing emissive Cube seen head-on renders its closed form
  e (1 - exp(-mu_t L)) within 5 % (tests/test_emissive_volumes.py:71-86);
  a zero-density emissive grid renders black (the boundary does not emit).
- fire.take at 48x28, 8 spp against the JAX Driver at the golden gate
  (mean within 1.5 %, 4x4 RMSE within 6 %), and the two-light scene at
  32x24, 8 spp.
- The CLI renders a small copy of fire.take on the CPU.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

FIRE_TAKE = "examples/takes/fire.take"
FIRE = "examples/scenes/fire.scene"
N_LANES = 4096


@pytest.fixture(scope="module")
def fire_scenes():
    """(JAX scene, the port's scene from the JAX arrays)."""
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js = jload(FIRE)
    return js, scene_from_jax_arrays(scene_arrays(js))


def test_fire_scene_arrays_match_jax():
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.render.integrator import ptmis
    from zyg_tpu_torch.render.integrator.ptmis_general import GeneralBody
    from zyg_tpu_torch.scene import light_sampling as tls
    from zyg_tpu_torch.scene.loader import load_scene_file as tload
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js, ps = jload(FIRE), tload(FIRE)
    a, b = scene_arrays(js), scene_arrays(ps)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k.startswith("vol_light_dist."):
            ulp = np.abs(a[k].view(np.int32).astype(np.int64) - b[k].view(np.int32))
            assert ulp.max() <= 8, (k, ulp.max())
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ps.mat_features == {"media", "volumetric", "vol_emission"} == set(js.mat_features)
    assert tls.light_shapes(ps) == {"volume"} and set(js.light_shapes) == {"volume"}
    assert ps.lights.volume.tolist() == [True] and ps.lights.cdf.tolist() == [0.0, 1.0]
    assert ps.light_tree is None and sorted(ps.vol_light_dist) == [0]
    # the hand-off rebuilds the same scene, tables and all
    c = scene_arrays(scene_from_jax_arrays(a))
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    body = ptmis._make_body(ps, ptmis.PtmisSettings())
    assert isinstance(body, GeneralBody) and body.scatters and body.vol_lights


def test_light_tree_with_a_volume_light_matches_jax():
    import chip_smoke
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene import light_sampling as tls
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload
    from zyg_tpu_torch.scene.loader import scene_arrays

    root = chip_smoke.fire_root("lamp")
    js, ps = jload(root), tload(root)
    assert ps.light_tree is not None and js.light_tree is not None
    a, b = scene_arrays(js), scene_arrays(ps)
    for k in a:
        if k.startswith(("light_tree.", "lights.")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tls.light_shapes(ps) == {int(tls.ShapeType.RECTANGLE), "volume"}
    assert ps.lights.volume.tolist() == [True, False]  # the cube comes first
    # an emissive Volumetric Sphere glows along the walks but is no light
    root = chip_smoke.fire_root("lamp")
    next(e for e in root["entities"] if e.get("materials") == ["fire"])["shape"]["type"] = "Sphere"
    js, ps = jload(root), tload(root)
    assert "vol_emission" in ps.mat_features and ps.lights.count == 1
    assert ps.lights.volume.tolist() == [False] and ps.vol_light_dist is None
    np.testing.assert_array_equal(scene_arrays(js)["lights.prop"], ps.lights.prop.numpy())


def _nee_lanes(seed=31):
    rng = np.random.default_rng(seed)
    n = N_LANES
    p = rng.uniform([-4, 0, -4], [4, 4, 4], (n, 3)).astype(np.float32)
    p[: n // 4] = rng.uniform([-1, 0.3, -1], [1, 2.7, 1], (n // 4, 3))  # inside the fire
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    xi = rng.random((n, 2)).astype(np.float32)
    xi3 = rng.random(n).astype(np.float32)
    ts = rng.random(n) < 0.5
    return p, nrm, xi, xi3, ts


def test_volume_light_sampling_matches_jax(fire_scenes):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    js, ps = fire_scenes
    p, nrm, xi, xi3, ts = _nee_lanes()
    n = p.shape[0]

    @jax.jit
    def ref(p, nrm, xi, xi3, ts):
        li = jnp.zeros(p.shape[0], jnp.int32)
        s = jls.sample_light(js, li, p, nrm, xi, total_sphere=ts, xi3=xi3)
        rad = jls.light_radiance(js, li, s.wi, s.light_n, s.uv, vol=(s.vol_mask, s.vol_radiance))
        prop = jnp.full(p.shape[0], 1, jnp.int32)
        hp = jls.light_hit_pdf(js, prop, p, nrm, jnp.ones(p.shape[0]), p, nrm, nrm,
                               total_sphere=ts)
        return s, rad, hp

    s, rad, hp = ref(*map(jnp.asarray, (p, nrm, xi, xi3, ts)))
    t = torch.from_numpy
    present = tls.light_shapes(ps)
    li = torch.zeros(n, dtype=torch.int32)
    q = tls.sample_light(ps, present, li, t(p), t(nrm), t(xi), total_sphere=t(ts), xi3=t(xi3))
    qrad = tls.light_radiance(ps, li, q.wi, q.light_n, q.uv, vol=(q.vol_mask, q.vol_radiance))
    np.testing.assert_array_equal(q.vol_mask.numpy(), np.asarray(s.vol_mask))
    np.testing.assert_array_equal(q.infinite.numpy(), np.asarray(s.infinite))
    np.testing.assert_array_equal(q.light_n.numpy(), np.asarray(s.light_n))
    for name, tol in (("wi", 2e-6), ("light_p", 2e-6), ("t_max", 2e-6)):
        np.testing.assert_allclose(getattr(q, name).numpy(), np.asarray(getattr(s, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(q.pdf.numpy(), np.asarray(s.pdf), rtol=1e-5, atol=0)
    np.testing.assert_allclose(q.vol_radiance.numpy(), np.asarray(s.vol_radiance), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(qrad.numpy(), np.asarray(rad), rtol=1e-5, atol=1e-5)
    hq = tls.light_hit_pdf(ps, present, torch.full((n,), 1, dtype=torch.int32), t(p), t(nrm),
                           total_sphere=t(ts))
    assert not hq.any() and not np.asarray(hp).any()
    # the samples lie inside the cube, follow its density, and the surface
    # lanes see only the half-space in front of their normal
    pdf = q.pdf.numpy()
    assert (pdf > 0).mean() > 0.5 and (qrad.numpy().max(-1) > 0).mean() > 0.3
    front = (q.wi.numpy() * nrm).sum(-1) > 0
    assert not (~ts & ~front & (pdf > 0)).any() and (ts & ~front & (pdf > 0)).any()


def test_general_bounce_on_fire_lanes_matches_jax(fire_scenes):
    from zyg_tpu.render.integrator import ptmis as jp
    from zyg_tpu_torch.render.integrator import ptmis as tp

    import chip_smoke
    from test_torch_render_material import _exact, _jax_state, _rel

    js, ps = fire_scenes
    s = chip_smoke.fire_state(N_LANES, 2, seed=15, scene=ps)
    # the lane classes the test means to cover
    assert int((s.alive & (s.medium[:, 0] >= 0)).sum()) > 250  # inside the fire
    assert int((s.alive & s.from_volume).sum()) > 250  # leaving a scatter vertex
    assert int((~s.alive).sum()) > 500  # ended (absorbed, escaped)
    st = dict(max_depth=16, max_depth_volume=128)
    jbody = jp._make_body(js, jp.PtmisSettings(**st, bsdf_split=False))
    r1 = jax.jit(jbody)(_jax_state(s))
    r2 = tp._make_body(ps, tp.PtmisSettings(**st, bsdf_split=False))(s)
    for name in ("alive", "depth", "vol_depth", "medium", "singular", "primary_chain",
                 "from_volume", "vol_key"):
        _exact(getattr(r1, name), getattr(r2, name), name)
    _exact(r1.sobol.run_seed, r2.sobol.run_seed, "run_seed")
    _exact(r1.sobol.sample, r2.sobol.sample, "sample")
    assert int(r1.rays) == int(r2.rays)
    live = np.asarray(r1.alive)
    for name, tol in (("o", 1e-5), ("mis_o", 1e-5), ("d", 1e-5), ("mis_n", 1e-5),
                      ("throughput", 2e-3), ("bxdf_pdf", 1e-5), ("reg_alpha", 1e-6)):
        _rel(getattr(r1, name), getattr(r2, name), live, tol, name)
    everywhere = np.ones_like(live)
    for c, tol in (("emission", 1e-4), ("indirect", 1e-4), ("direct", 1e-2)):
        _rel(getattr(r1.result, c), getattr(r2.result, c), everywhere, tol, c)
    # the bounce collects volume emission and lights lanes by NEE to the fire
    gained = (r2.result.emission + r2.result.indirect) - (s.result.emission + s.result.indirect)
    assert int((gained.amax(-1) > 0).sum()) > 10
    assert int(((r2.result.direct - s.result.direct).amax(-1) > 0).sum()) > 200


def _drivers(res, spp, root=None):
    """(JAX Driver, port Driver) on fire.take (or its scene replaced by root)."""
    from zyg_tpu.io.take import load_take_file as jtake
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    if root is None:
        with open(FIRE) as f:
            root = json.load(f)
    jt, pt = jtake(FIRE_TAKE), load_take_file(FIRE_TAKE)
    for t in (jt, pt):
        t.cameras[0].resolution = res
        t.num_samples_per_pixel = spp
    return (JaxDriver(take=jt, scene=jload(root), use_mesh=False),
            Driver(pt, tload(root), device="cpu"))


@pytest.mark.parametrize("res, spp", [((960, 540), 64), ((64, 36), 8), ((48, 28), 12)])
def test_tile_and_chunk_plans_match_jax(res, spp):
    from test_torch_driver import _jax_plan
    from test_torch_render_smoke import _jax_tile_plan

    jd, pd = _drivers(res, spp)
    assert jd._heavy_loops and pd.chunk_size == jd.chunk_size == min(spp, 8)
    assert pd.chunk_plan(spp) == _jax_plan(jd, spp)
    assert pd.tile_plan() == _jax_tile_plan(jd)
    if res == (960, 540):
        assert pd.tile_plan() == [(0, 262144), (262144, 518400)]


def _emissive_cube(e, att_dist, grid=None):
    """A purely absorbing emissive Volumetric Cube (2 units, at y = 1.5),
    alone (tests/test_emissive_volumes.py's scene without its floor)."""
    from zyg_tpu_torch.scene.loader import MaterialDesc, PropDesc, SceneBuilder, Transformation
    from zyg_tpu_torch.scene.types import MaterialKind, ShapeType

    b = SceneBuilder()
    fire = MaterialDesc(kind=int(MaterialKind.VOLUMETRIC), color=np.full(3, 0.5, np.float32),
                        subsurface_color=np.zeros(3, np.float32), attenuation_distance=att_dist,
                        emission=np.full(3, e, np.float32))
    if grid is not None:
        fire.density_grid = b.add_density_grid(grid)
    b.add_prop(PropDesc(shape=int(ShapeType.CUBE), material=b.add_material(fire),
                        trafo=Transformation(position=np.array([0, 1.5, 0], np.float32),
                                             scale=np.full(3, 2.0, np.float32))))
    return b.build()


def _head_on_take(res, spp):
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera

    take = Take()
    take.num_samples_per_pixel = spp
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=6, max_depth_volume=64)
    cam = PerspectiveCamera(resolution=res, fov=np.deg2rad(45.0))
    cam.position = np.array([0, 1.5, -6.0], np.float32)  # looking down +z at the cube
    take.cameras = [cam]
    return take


def test_absorbing_slab_matches_closed_form_and_boundary_emits_nothing():
    from zyg_tpu_torch.render.driver import Driver

    e, att = 3.0, 0.5
    img = Driver(_head_on_take((16, 16), 32), _emissive_cube(e, att), device="cpu").render_frame()
    mu_t = -np.log(0.5) / att  # albedo 0: mu_a = mu_t
    expect = e * (1.0 - np.exp(-mu_t * 2.0))
    got = img[6:10, 6:10].mean()
    assert abs(got - expect) / expect < 0.05, (got, expect)
    empty = _emissive_cube(50.0, att, grid=np.zeros((8, 8, 8), np.float32))
    img = Driver(_head_on_take((16, 16), 8), empty, device="cpu").render_frame()
    assert img.max() < 1e-4, img.max()


def _gate(img, ref):
    from zyg_tpu.tools import it as it_mod

    assert img.shape == ref.shape and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015, img.mean() / scale
    d4 = it_mod.op_downsample(ref, 4) - it_mod.op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06


@pytest.mark.parametrize("variant, res", [("fire", (48, 28)), ("lamp", (32, 24))])
def test_fire_render_matches_jax_driver(variant, res):
    import chip_smoke

    jd, pd = _drivers(res, 8, chip_smoke.fire_root(variant))
    ref = np.asarray(jd.render_frame())
    img = pd.render_frame()
    assert ref.mean() > 1e-3
    _gate(img, ref)
    assert abs(pd.rays_traced - jd.rays_traced) <= 0.02 * jd.rays_traced


def test_cli_renders_fire_take(tmp_path, capsys):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(FIRE_TAKE) as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(FIRE)
    take["camera"]["Perspective"]["resolution"] = [24, 16]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "small.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu", "-s"]) == 0
    printed = capsys.readouterr().out
    assert "resolution 24x16, 2 spp" in printed and "M rays" in printed
    img = read_png(str(out))
    assert img.shape == (16, 24, 3) and img.mean() > 3
