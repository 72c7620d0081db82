"""Sphere and Disk lights, and light emission sampling, against the JAX
package on scenes the test writes: a floor, a Substitute ball, a Sphere
lamp and a two-sided Disk lamp (the light tree over two finite lights);
and a set of every emitter a light path starts from (a Sphere, a Disk, a
one-sided and a two-sided Rectangle and a uniform Dome).

- The scene's arrays equal through scene_arrays (the light CDF by the
  Sphere's and the Disk's areas, the light tree's bounds and cones); the
  loaders' _light_bounds of a Sphere and a Disk equal; the world bounding
  sphere equal.
- sample_light per lane at 20,000 seeded points on the Sphere and on the
  Disk: validity and pdf exact on the Sphere (pdf within rtol 1e-6 on the
  Disk), directions within 2e-6, points within 2e-6, normals within 1e-6,
  distances within rtol 2e-6 and the uv within 1e-5 (XLA's sin, cos, atan2
  and acos round an ulp apart from torch's; acos near the Sphere's poles
  amplifies it to 4.6e-6 on 1 of 40,000 values); light_radiance exact.
- light_hit_pdf per lane on rays that hit either lamp: within rtol 1e-5.
- sample_light_from per lane: finite flags and weights exact, points
  within 5e-6 (the Dome's, on the 14.8-radius world sphere), normals and
  directions within 2e-6; core/vecmath.sample_sphere_uniform within 2e-6.
- The lamp scene at 48x32, 8 spp through kernel 6's plain path against
  the JAX Driver at the golden gate (mean within 1.5 %, 4x4 RMSE within
  6 % of the mean), both packages' gates picking kernel 6.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

N = 20000


def lamp_root() -> dict:
    return {
        "materials": [
            {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.48, 0.45],
                                                           "roughness": 0.7}}},
            {"name": "ball", "rendering": {"Substitute": {"color": [0.7, 0.25, 0.2],
                                                          "roughness": 0.35}}},
            {"name": "warm", "rendering": {"Light": {"emittance": {
                "spectrum": [1.0, 0.85, 0.6], "value": 40.0}}}},
            {"name": "cool", "rendering": {"Light": {"emittance": {
                "spectrum": [0.6, 0.8, 1.0], "value": 12.0}, "two_sided": True}}},
        ],
        "entities": [
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"rotation": [90, 0, 0], "scale": [8, 8, 1]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["ball"],
             "transformation": {"position": [0.2, 0.6, 0.3], "scale": [1.2, 1.2, 1.2]}},
            {"type": "Light", "shape": {"type": "Sphere"}, "materials": ["warm"],
             "transformation": {"position": [1.4, 2.2, -0.4], "scale": [0.3, 0.3, 0.3]}},
            {"type": "Light", "shape": {"type": "Disk"}, "materials": ["cool"],
             "transformation": {"position": [-1.2, 2.6, 0.8], "rotation": [-80, 20, 0],
                                "scale": [0.9, 0.9, 1]}},
        ],
    }


def emitters_root() -> dict:
    """Every emitter sample_light_from starts light paths from."""
    mats = [
        {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5]}}},
        {"name": "one", "rendering": {"Light": {"emittance": {"spectrum": [1.0, 0.9, 0.8],
                                                              "value": 20.0}}}},
        {"name": "two", "rendering": {"Light": {"emittance": {"spectrum": [0.7, 0.9, 1.0],
                                                              "value": 15.0},
                                                "two_sided": True}}},
        {"name": "sky", "rendering": {"Light": {"emittance": {"spectrum": [0.3, 0.4, 0.6],
                                                              "value": 1.0}}}},
    ]
    ents = [
        {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
         "transformation": {"rotation": [90, 0, 0], "scale": [6, 6, 1]}},
        {"type": "Light", "shape": {"type": "Sphere"}, "materials": ["one"],
         "transformation": {"position": [1.2, 2.5, -0.5], "scale": [0.5, 0.5, 0.5]}},
        {"type": "Light", "shape": {"type": "Disk"}, "materials": ["one"],
         "transformation": {"position": [-1.0, 3.0, 0.5], "rotation": [90, 0, 0],
                            "scale": [0.8, 0.8, 1]}},
        {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["one"],
         "transformation": {"position": [0.0, 3.5, 1.5], "rotation": [90, 0, 0],
                            "scale": [1.0, 0.6, 1]}},
        {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["two"],
         "transformation": {"position": [2.0, 1.5, 1.0], "rotation": [0, 30, 0],
                            "scale": [0.7, 0.9, 1]}},
        {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
    ]
    return {"materials": mats, "entities": ents}


@pytest.fixture(scope="module")
def lamps():
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict

    return jload(lamp_root()), load_scene_dict(lamp_root())


def test_lamp_scene_arrays_and_bounds_match_jax(lamps):
    import zyg_tpu.scene.loader as jl
    import zyg_tpu_torch.scene.loader as tl
    from zyg_tpu_torch.scene import light_sampling as ls
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    js, ps = lamps
    a, b = scene_arrays(js), scene_arrays(ps)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ls.light_shapes(ps) == {int(ShapeType.SPHERE), int(ShapeType.DISK)}
    assert ps.light_tree is not None and ps.light_tree.num_finite == 2
    assert "light_tree.center" in b and "lights.cdf" in b
    assert (ps.world_center, ps.world_radius) == (tuple(js.world_center), js.world_radius)
    for shape, rot in (("SPHERE", [0, 0, 0]), ("DISK", [-80, 20, 0])):
        kw = dict(shape=int(getattr(ShapeType, shape)), material=0, is_light=True)
        node = {"position": [1, 2, 3], "rotation": rot, "scale": [0.7, 0.7, 1]}
        jt, tt = jl.read_transformation(node), tl.read_transformation(node)
        want = jl.SceneBuilder()._light_bounds(jl.PropDesc(trafo=jt, **kw))
        got = tl.SceneBuilder._light_bounds(tl.PropDesc(trafo=tt, **kw))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=shape)


def _points(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    p[:, 1] = rng.uniform(0.0, 1.5, N)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n[:, 1] = np.abs(n[:, 1]) + 0.3
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return p, n, rng.random((N, 2)).astype(np.float32)


@pytest.mark.parametrize("light", [0, 1], ids=["sphere", "disk"])
def test_sample_light_and_radiance_match_jax(lamps, light):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    js, ps = lamps
    p, n, xi = _points(4 + light)
    li = np.full(N, light, np.int32)

    @jax.jit
    def ref(li, p, n, xi):
        s = jls.sample_light(js, li, p, n, xi, total_sphere=jnp.zeros(li.shape, bool))
        return s, jls.light_radiance(js, li, s.wi, s.light_n, s.uv)

    want, wrad = ref(*(jnp.asarray(x) for x in (li, p, n, xi)))
    t = torch.from_numpy
    got = tls.sample_light(ps, tls.light_shapes(ps), t(li), t(p), t(n), t(xi))
    grad = tls.light_radiance(ps, t(li), got.wi, got.light_n, got.uv)
    jpdf, gpdf = np.asarray(want.pdf), got.pdf.numpy()
    np.testing.assert_array_equal(gpdf > 0, jpdf > 0)
    assert (jpdf > 0).mean() > 0.5
    if light == 0:
        np.testing.assert_array_equal(gpdf, jpdf)
    else:
        np.testing.assert_allclose(gpdf, jpdf, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.wi.numpy(), np.asarray(want.wi), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.light_p.numpy(), np.asarray(want.light_p), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.light_n.numpy(), np.asarray(want.light_n), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.t_max.numpy(), np.asarray(want.t_max), rtol=2e-6, atol=0)
    # the Sphere's lat-long uv: acos near the poles amplifies XLA's ulp
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.infinite.numpy(), np.asarray(want.infinite))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(wrad))


def test_light_hit_pdf_matches_jax(lamps):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    js, ps = lamps
    p, n, xi = _points(7)
    li = (np.arange(N) % 2).astype(np.int32)
    t = torch.from_numpy
    # rays from p toward sampled points on either lamp, and their hits
    s = tls.sample_light(ps, tls.light_shapes(ps), t(li), t(p), t(n), t(xi))
    ok = s.pdf.numpy() > 0
    prop = ps.lights.prop[t(li).long()].numpy()
    hit_n = s.light_n.numpy()
    ref = jax.jit(lambda prop, ro, rd, ht, hp, hn: jls.light_hit_pdf(js, prop, ro, rd, ht, hp, hn,
                                                                    hn))(
        *(jnp.asarray(x) for x in (prop, p, s.wi.numpy(), s.t_max.numpy(), s.light_p.numpy(),
                                   hit_n)))
    got = tls.light_hit_pdf(ps, tls.light_shapes(ps), t(prop), t(p), s.wi, s.t_max, s.light_n)
    want = np.asarray(ref)[ok]
    assert ok.mean() > 0.5 and (want > 0).all()
    np.testing.assert_allclose(got.numpy()[ok], want, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="hit_t and hit_n"):
        tls.light_hit_pdf(ps, tls.light_shapes(ps), t(prop), t(p), s.wi)


def test_sample_sphere_uniform_matches_jax():
    from zyg_tpu.core import vecmath as jv
    from zyg_tpu_torch.core import vecmath as tv

    uv = np.random.default_rng(8).random((N, 2)).astype(np.float32)
    want, wpdf = jax.jit(jv.sample_sphere_uniform)(jnp.asarray(uv))
    got, gpdf = tv.sample_sphere_uniform(torch.from_numpy(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got.numpy()[:, 2], np.asarray(want)[:, 2])
    assert float(gpdf[0]) == pytest.approx(float(wpdf[0]), rel=1e-7)


def test_sample_light_from_matches_jax():
    from zyg_tpu.render.integrator.lighttracer import sample_light_from as jslf
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.render.integrator.lighttracer import sample_light_from
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import ShapeType

    js, ps = jload(emitters_root()), load_scene_dict(emitters_root())
    assert (ps.world_center, ps.world_radius) == (tuple(js.world_center), js.world_radius)
    rng = np.random.default_rng(9)
    li = rng.integers(0, 5, N).astype(np.int32)
    xi = rng.random((N, 4)).astype(np.float32)
    side = rng.random(N).astype(np.float32)
    want = jax.jit(lambda li, xi, us: jslf(js, li, xi, u_side=us))(
        jnp.asarray(li), jnp.asarray(xi), jnp.asarray(side))
    got = sample_light_from(ps, torch.from_numpy(li), torch.from_numpy(xi),
                            torch.from_numpy(side))
    shape = ps.prop_shape[ps.lights.prop[torch.from_numpy(li).long()].long()].numpy()
    assert set(shape.tolist()) == {int(ShapeType.SPHERE), int(ShapeType.DISK),
                                   int(ShapeType.RECTANGLE), int(ShapeType.DOME)}
    p, n, d, w, fin = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[4].numpy(), fin)
    assert fin.all()
    np.testing.assert_array_equal(got[3].numpy(), w)
    np.testing.assert_allclose(got[0].numpy(), p, rtol=0, atol=5e-6)
    np.testing.assert_allclose(got[1].numpy(), n, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[2].numpy(), d, rtol=0, atol=2e-6)
    # the two-sided rectangle emits on both sides, with its weight doubled
    two = li == 3
    flips = (got[1].numpy()[two] * ps.prop_rot[4, 2].numpy()).sum(1) < 0
    assert 0.4 < flips.mean() < 0.6
    for light, prop, sides in ((2, 3, 1.0), (3, 4, 2.0)):
        le = ps.materials.emission[int(ps.prop_material[prop])].numpy()
        sx, sy = ps.prop_scale[prop, :2].tolist()
        np.testing.assert_allclose(w[li == light][0], sides * le * sx * sy * math.pi, rtol=1e-6)
    # the dome emits inward from the world sphere
    dome = li == 4
    r = np.linalg.norm(got[0].numpy()[dome] - np.asarray(ps.world_center), axis=1)
    assert (r >= ps.world_radius * (1 - 1e-6)).all()
    assert (r <= ps.world_radius * math.sqrt(2) * 1.001).all()


def test_lamp_scene_render_matches_jax_at_golden_gate(lamps):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.render.integrator.ptmis import PtmisSettings
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2
    from zyg_tpu_torch.render.driver import Driver

    def take(module):
        return module.load_take_dict({
            "camera": {"Perspective": {
                "parameters": {"fov": 65},
                "transformation": {"position": [0, 1.6, -3.8], "rotation": [16, 0, 0]},
                "resolution": [48, 32]}},
            "sampler": {"Sobol": {"samples_per_pixel": 8}},
            "integrator": {"surface": {"PTMIS": {"depth": {"surface": 6}}}},
        })

    js, ps = lamps
    assert structural_ok_mesh_v2(ps)
    assert not jshade.structural_ok(js, PtmisSettings(), None)
    assert jshade.structural_ok_mesh_v2(js, PtmisSettings(), None)
    jd = JDriver(take=take(jtake), scene=js)
    ref = np.asarray(jd.render_frame())
    d = Driver(take(ttake), ps, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (32, 48, 3) and np.isfinite(img).all()
    scale = float(ref.mean())
    assert scale > 0.0
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
