"""The AOV integrator and the sensor AOV planes of the port against the
JAX package:

- each value of the AOV integrator (AO with 2 samples of radius 0.8,
  Tangent, Bitangent, GeometricNormal, ShadingNormal, Side, Depth,
  LightSampleCount) on 4,096 seeded Cornell camera lanes against
  zyg_tpu.render.integrator.aov.integrate: rays exactly, every value
  exactly but Depth, within 2e-6 (measured: 9.5e-7 on 258 lanes, an ulp
  of the hit distance);
- examples/takes/cornell_aovs.take (PTMIS depth 8 with the Albedo, Depth
  and ShadingNormal planes) at 32x32, 8 spp, with alpha_transparency on,
  through the port's Driver (an unshuffled dispatch through the general
  body) against the JAX Driver's: the beauty at the golden gate, the
  albedo and shading normal planes within 1e-4 and the depth plane
  within 1e-5 on all but 1 % of the pixels (a path flip moves a sample's
  hit), alpha coverage equal, rays within 1e-3;
- refusals by name: the Photon AOV value, the `shadow_catcher` entity
  key, sensor AOVs on a scene the general body refuses, an unknown AOV
  class; AOVs outside the persistent path warn and render no plane.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pt import camera_lanes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKE = os.path.join(REPO, "examples/takes/cornell_aovs.take")
VALUES = ["AO", "Tangent", "Bitangent", "GeometricNormal", "ShadingNormal", "Side", "Depth",
          "LightSampleCount"]


@pytest.fixture(scope="module")
def lanes():
    return camera_lanes(os.path.join(REPO, "examples/takes/cornell_ao.take"), (64, 64))


@pytest.mark.parametrize("value", VALUES)
def test_aov_values_match_jax(lanes, value):
    from zyg_tpu.render.integrator import aov as jaov
    from zyg_tpu_torch.render.integrator import aov

    scene, jscene, o, d, port_sampler, jax_sampler = lanes
    st = jaov.AovSettings(value=value, num_samples=2, radius=0.8)

    @jax.jit
    def ref(sc, o, d):
        out, _, rays = jaov.integrate(sc, o, d, jax_sampler(), st)
        return out, rays

    jout, jrays = ref(jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    out, _, rays = aov.integrate(scene, o, d, port_sampler()[0], aov.AovSettings(value, 2, 0.8))
    assert int(rays) == int(jrays)
    if value == "Depth":
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-6)
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert np.asarray(jout).any()


@pytest.fixture(scope="module")
def aov_renders():
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    jt = jload_take(TAKE)
    jt.cameras[0].resolution = (32, 32)
    jt.sensor.alpha_transparency = True
    jd = JaxDriver(take=jt, scene=jload_scene(jt.scene_filename), use_mesh=False)
    ref = jd.render_frame()
    take = load_take_file(TAKE)
    take.cameras[0].resolution = (32, 32)
    take.sensor.alpha_transparency = True
    d = Driver(take, load_scene_file(take.scene_filename), device="cpu")
    img = d.render_frame()
    return jd, ref, d, img


def test_cornell_aovs_beauty_matches_jax_at_golden_gate(aov_renders):
    from zyg_tpu.tools.it import op_downsample

    jd, ref, d, img = aov_renders
    assert d.aov_names == jd._aov_names == ("albedo", "depth", "shading_normal", "alpha")
    assert d._frame_width == jd._frame_width == 0 and d.chunk_plan(8) == [(8, 0)]
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    # unshuffled: every pixel takes exactly its 8 samples
    assert torch.equal(d._fb.weight, torch.full((32 * 32,), 8.0))


@pytest.mark.parametrize("name,atol", [("albedo", 1e-4), ("depth", 1e-5),
                                       ("shading_normal", 1e-4)])
def test_cornell_aovs_planes_match_jax(aov_renders, name, atol):
    jd, _, d, _ = aov_renders
    out, ref = d.resolve_aov(name), jd.resolve_aov(name)
    assert out.shape == ref.shape == (32, 32, 3 if name != "depth" else 1)
    close = np.isclose(out, ref, rtol=0, atol=atol).all(axis=-1)
    assert close.mean() >= 0.99, (name, close.mean())
    if name == "shading_normal":
        # renormalized where the pixel saw geometry
        ln = np.linalg.norm(out, axis=-1)
        assert np.allclose(ln[ln > 0], 1.0, atol=1e-5)


def test_alpha_coverage_matches_jax(aov_renders):
    jd, _, d, _ = aov_renders
    alpha, ref = d.resolve_alpha(), jd.resolve_alpha()
    assert alpha.shape == (32, 32)
    np.testing.assert_array_equal(alpha, ref)
    assert (alpha == 1.0).all()  # the box fills the frame


def test_alpha_is_the_share_of_samples_that_hit(tmp_path):
    """A sphere in empty space at 16x16, 4 spp: each pixel's alpha is the
    share of its samples whose camera ray hits the sphere (the same rays,
    by the seeding law), edge pixels partly covered; the RGBA PNG carries
    it."""
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.io.png import read_png
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.ops.isect import prop_table
    from zyg_tpu_torch.render.camera import generate_rays
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.loader import load_scene_dict

    scene = load_scene_dict({
        "materials": [{"name": "m", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5]}}},
                      {"name": "l", "rendering": {"Light": {"emittance": {"value": 2.0}}}}],
        "entities": [{"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["m"],
                      "transformation": {"position": [0, 0, 3], "scale": [1, 1, 1]}},
                     {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["l"],
                      "transformation": {"position": [0, 3, 3], "rotation": [90, 0, 0]}}]})
    take = load_take_dict({"camera": {"Perspective": {"resolution": [16, 16]}},
                           "sampler": {"Sobol": {"samples_per_pixel": 4}},
                           "sensor": {"alpha_transparency": True}})
    d = Driver(take, scene, device="cpu")
    d.render_frame()
    alpha = d.resolve_alpha()
    pid = torch.arange(256)
    xy = torch.stack([pid % 16, pid // 16], -1)
    hits = torch.zeros(256)
    for it in range(4):
        s4 = SobolSampler.start_pixel(pid * 4 + it, torch.full_like(pid, it // 4)).sample_4d()
        o, dirs = generate_rays(take.cameras[0].arrays("cpu"), xy, s4[:, 0:2])
        hit = shapes.intersect_scene(scene, prop_table(scene, "reflection"), o, dirs, 0.0, 3.0e37,
                                     primary=torch.ones(256, dtype=torch.bool))
        hits += (hit.prop == 0).float()
    np.testing.assert_array_equal(alpha, (hits / 4).reshape(16, 16).numpy())
    assert alpha.max() == 1.0 and alpha.min() == 0.0 and ((alpha > 0) & (alpha < 1)).any()
    d.export_frame(str(tmp_path / "a.png"))
    png = read_png(str(tmp_path / "a.png"))
    assert png.shape == (16, 16, 4)
    np.testing.assert_array_equal(png[..., 3], (alpha * 255.0 + 0.5).astype(np.uint8))


def test_photon_aov_value_refused_by_name():
    from zyg_tpu_torch.io.take import UnsupportedTake, load_take_dict

    with pytest.raises(UnsupportedTake, match="Photon"):
        load_take_dict({"camera": {"Perspective": {}},
                        "integrator": {"surface": {"AOV": {"value": "Photon"}}}})
    with pytest.raises(UnsupportedTake, match="aov keys"):
        load_take_dict({"camera": {"Perspective": {}}, "aov": {"Photons": True}})


def test_shadow_catcher_refused_by_name():
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match="shadow_catcher"):
        load_scene_dict({
            "materials": [{"name": "m", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5]}}}],
            "entities": [{"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["m"],
                          "shadow_catcher": True}]})


def test_aovs_on_a_scene_the_general_body_refuses():
    """A Distant light (sunsky.take's Sky) is kernel 6's; sensor AOVs ride the
    general body, which names what it refuses."""
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.types import UnsupportedScene

    take = load_take_file(os.path.join(REPO, "examples/takes/sunsky.take"))
    scene = load_scene_file(take.scene_filename)
    Driver(take, scene, device="cpu")  # without AOVs kernel 6 takes it
    take.aovs = ("albedo",)
    with pytest.raises(UnsupportedScene, match="sensor AOVs .*general body, which refuses"):
        Driver(take, scene, device="cpu")


def test_aovs_outside_the_persistent_path_warn(caplog):
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_dict({"scene": os.path.join(REPO, "examples/scenes/cornell.scene"),
                           "camera": {"Perspective": {"resolution": [8, 8]}},
                           "integrator": {"surface": {"PT": {}}},
                           "aov": {"Albedo": True}})
    with caplog.at_level(logging.WARNING, logger="zyg_tpu_torch"):
        d = Driver(take, load_scene_file(take.scene_filename), device="cpu")
    assert d.aov_names == () and "AOV planes will not be rendered" in caplog.text
    d.render_frame()
    assert d.resolve_alpha() is None


def test_ivalue_planes_sum_to_the_beauty():
    """cornell_ptmis.take at 16x16, 4 spp with the Emission, Direct and
    Indirect planes: every sample adds its unclamped classes at its flush
    (zyg_tpu/render/integrator/ptmis.py:1380-1389), so without a clamp the
    three resolved planes sum to the beauty; the dispatch rides the general
    body (the JAX gates refuse AOVs for kernels 3, 5 and 6)."""
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.render.integrator import ptmis
    from zyg_tpu_torch.render.integrator.ptmis_general import GeneralBody
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(os.path.join(REPO, "examples/takes/cornell_ptmis.take"))
    take.cameras[0].resolution = (16, 16)
    take.num_samples_per_pixel = 4
    take.aovs = ("emission", "direct", "indirect")
    scene = load_scene_file(take.scene_filename)
    d = Driver(take, scene, device="cpu")
    assert isinstance(ptmis._make_body(d.scene, d.settings), GeneralBody)
    img = d.render_frame()
    total = sum(d.resolve_aov(k) for k in take.aovs)
    np.testing.assert_allclose(total, img, rtol=1e-5, atol=1e-6)
    assert (d.resolve_aov("emission") > 0).any() and (d.resolve_aov("indirect") > 0).any()
