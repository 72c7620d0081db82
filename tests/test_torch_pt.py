"""The PT integrator and the per-sample ("scan") render path of the port
against the JAX package:

- `pt.integrate` on 4,096 seeded Cornell camera lanes (cornell.take's
  camera at 64x64, one sample of the seeding law, the camera block drawn
  first as the Driver draws it) against
  zyg_tpu.render.integrator.pt.integrate at depth 6 and 16: rays exactly;
  radiance per lane within rtol 5e-3 of the lane's largest channel, and
  on 99 % of the lanes within 1e-5 (measured: 11 and 16 of the 4,096
  lanes beyond 1e-5, at most 2.9e-3 off: a direction an ulp apart changes
  a glossy lobe's weight there);
- tests/golden_configs.py's cornell_pt (cornell.take at 64x64, 24 spp,
  depth 6) through the port's Driver on the CPU against
  tests/goldens/cornell_pt.exr, read with the port's own EXR reader, by
  tests/test_goldens.py's gate: mean within 1.5 %, 4x4 RMSE within 6 % of
  the mean, raw RMSE within 35 %;
- the scan path's chunk rule (min(spp, 16, 4,000,000 // pixels)) and
  tile rule against the JAX Driver's, and the path choice;
- `materials.medium_absorption` per lane (rtol 2e-6) and PT through
  material_test's glass (the one-entry medium).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKE = os.path.join(REPO, "examples/takes/cornell.take")


def camera_lanes(take_path, res, it=3, nes=16):
    """(port scene, JAX scene, o, d, the port sampler factory, the JAX
    sampler factory) of one sample of every pixel of take_path at res,
    after the camera block (sample_4d, the shutter's sample_1d, padding)."""
    from zyg_tpu.core.sobol import SobolSampler as JaxSobol
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.camera import generate_rays
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(take_path)
    take.cameras[0].resolution = res
    n = res[0] * res[1]
    pid = torch.arange(n)
    si, seed = pid * nes + it, torch.full_like(pid, it // nes)

    def port_sampler():
        s = SobolSampler.start_pixel(si, seed)
        s4 = s.sample_4d()
        s.sample_1d()
        s.increment_padding()
        return s, s4

    def jax_sampler():
        s = JaxSobol.start_pixel(jnp.asarray(si.numpy(), jnp.uint32),
                                 jnp.asarray(seed.numpy(), jnp.uint32))
        s.sample_4d()
        s.sample_1d()
        s.increment_padding()
        return s

    _, s4 = port_sampler()
    xy = torch.stack([pid % res[0], pid // res[0]], -1)
    o, d = generate_rays(take.cameras[0].arrays("cpu"), xy, s4[:, 0:2])
    return (load_scene_file(take.scene_filename), jload_scene(jload_take(take_path).scene_filename),
            o, d, port_sampler, jax_sampler)


@pytest.fixture(scope="module")
def cornell_lanes():
    return camera_lanes(TAKE, (64, 64))


@pytest.mark.parametrize("depth", [6, 16])
def test_pt_lanes_match_jax(cornell_lanes, depth):
    from zyg_tpu.render.integrator import pt as jpt
    from zyg_tpu_torch.render.integrator import pt

    scene, jscene, o, d, port_sampler, jax_sampler = cornell_lanes

    @jax.jit
    def ref(sc, o, d):
        rad, _, rays = jpt.integrate(sc, o, d, jax_sampler(), jpt.PtSettings(max_depth=depth))
        return rad, rays

    jrad, jrays = ref(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    jrad = np.asarray(jrad)
    rad, _, rays, bounces = pt.integrate(scene, o, d, port_sampler()[0], pt.PtSettings(depth))
    assert int(rays) == int(jrays)
    assert bounces <= depth + 1
    rad = rad.numpy()
    scale = np.maximum(np.abs(jrad).max(axis=1), 1e-3)
    err = np.abs(rad - jrad).max(axis=1) / scale
    assert err.max() <= 5e-3, err.max()
    assert (err <= 1e-5).mean() >= 0.99
    assert np.isfinite(rad).all() and rad.mean() > 0.0


def test_pt_dead_lanes_add_nothing(cornell_lanes):
    """Rays aimed away from the box end at once: no radiance, one ray each,
    and the host loop stops at its next poll."""
    from zyg_tpu_torch.render.integrator import pt

    scene, _, o, d, port_sampler, _ = cornell_lanes
    rad, _, rays, bounces = pt.integrate(scene, o, -d, port_sampler()[0], pt.PtSettings(16))
    assert int(rays) == o.shape[0] and bounces == 1
    assert float(rad.abs().max()) == 0.0


def test_cornell_pt_matches_golden():
    import golden_configs as gc
    from zyg_tpu.tools import it as it_mod
    from zyg_tpu_torch.io.exr import read_exr
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(TAKE)
    take.cameras[0].resolution = (64, 64)
    take.num_samples_per_pixel = 24
    take.integrator.max_depth_surface = 6
    d = Driver(take, load_scene_file(take.scene_filename), device="cpu")
    assert not d.persistent and d.chunk_plan(24) == [(16, 0), (8, 0)]
    img = d.render_frame()
    ch = read_exr(gc.golden_path("cornell_pt"))
    ref = np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)
    assert img.shape == ref.shape and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = it_mod.op_downsample(ref, 4) - it_mod.op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert float(np.sqrt(np.mean((img - ref) ** 2))) / scale < 0.35
    assert d.rays_traced > 64 * 64 * 24 and d.iterations > 0


@pytest.mark.parametrize("kind,res,spp,filt", [
    ("PT", (512, 512), 16, False), ("PT", (2048, 2048), 16, False), ("PT", (64, 64), 24, False),
    ("AOV", (512, 512), 1, False), ("PT", (1920, 1080), 64, True), ("PTMIS", (512, 512), 16, True),
    ("PTMIS", (256, 256), 8, False)])
def test_chunk_rule_and_path_match_jax(kind, res, spp, filt):
    """The chunk size, the (samples, slack) plan and the tiles of the scan
    path (and of the persistent path beside it) as the JAX Driver builds
    them: min(spp, 16, 4,000,000 // pixels) samples a chunk, no slack."""
    from test_torch_driver import _jax_plan
    from zyg_tpu.io.take import load_take_dict as jload
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    root = {"scene": os.path.join(REPO, "examples/scenes/cornell.scene"),
            "camera": {"Perspective": {"resolution": list(res)}},
            "sampler": {"Sobol": {"samples_per_pixel": spp}},
            "integrator": {"surface": {kind: {}}}}
    if filt:
        root["sensor"] = {"filter": {"Mitchell": {}}}
    jt, pt_ = jload(root), load_take_dict(root)
    jd = JaxDriver(take=jt, scene=jload_scene(jt.scene_filename), use_mesh=False)
    pd = Driver(pt_, load_scene_file(pt_.scene_filename), device="cpu")
    assert pd.persistent == jd._persistent == (kind == "PTMIS")
    assert pd.chunk_size == jd.chunk_size
    if kind != "PTMIS":
        assert pd.chunk_size == min(spp, 16, max(1, 4_000_000 // (res[0] * res[1])))
    assert pd.chunk_plan(spp) == _jax_plan(jd, spp)
    assert pd.tile_plan() == [(0, res[0] * res[1])]


def test_medium_absorption_matches_jax():
    """Beer-Lambert transmittance through material_test.scene's glass (and
    no medium, and materials without an attenuation distance) per lane."""
    from zyg_tpu.render.materials import medium_absorption as jabs
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.render.materials import medium_absorption
    from zyg_tpu_torch.scene.loader import load_scene_file

    path = os.path.join(REPO, "examples/scenes/material_test.scene")
    scene, jscene = load_scene_file(path), jload_scene(path)
    rng = np.random.default_rng(8)
    nmat = scene.materials.color.shape[0]
    mat = rng.integers(-1, nmat, 4096).astype(np.int32)
    dist = (rng.exponential(1.0, 4096) * np.where(rng.random(4096) < 0.05, 1e14, 1.0))
    dist = dist.astype(np.float32)
    out = medium_absorption(scene.materials, torch.from_numpy(mat), torch.from_numpy(dist))
    ref = np.asarray(jabs(jscene.materials, jnp.asarray(mat), jnp.asarray(dist)))
    assert (ref < 1.0).any() and (ref == 1.0).any()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=1e-30)


def test_pt_lanes_through_glass_match_jax():
    """material_test.take's camera lanes (glass spheres with Beer absorption,
    a lamp and a dome) at 48x32, depth 8: the one-entry medium and its
    absorption; rays exactly, radiance per lane within rtol 1e-3 of the
    lane's largest channel and on 90 % of the lanes within 1e-5 (measured:
    112 of 1,536 lanes beyond 1e-5, at most 2.3e-4, 31 of them already
    after one bounce: the metal and glossy lobes' weights amplify an ulp
    of their directions, as the general body's per-lane tests allow)."""
    from zyg_tpu.render.integrator import pt as jpt
    from zyg_tpu_torch.render.integrator import pt

    scene, jscene, o, d, port_sampler, jax_sampler = camera_lanes(
        os.path.join(REPO, "examples/takes/material_test.take"), (48, 32))

    @jax.jit
    def ref(sc, o, d):
        rad, _, rays = jpt.integrate(sc, o, d, jax_sampler(), jpt.PtSettings(max_depth=8))
        return rad, rays

    jrad, jrays = ref(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    jrad = np.asarray(jrad)
    rad, _, rays, _ = pt.integrate(scene, o, d, port_sampler()[0], pt.PtSettings(8))
    assert int(rays) == int(jrays)
    rad = rad.numpy()
    err = np.abs(rad - jrad).max(axis=1) / np.maximum(np.abs(jrad).max(axis=1), 1e-3)
    assert err.max() <= 1e-3, err.max()
    assert (err <= 1e-5).mean() >= 0.9
