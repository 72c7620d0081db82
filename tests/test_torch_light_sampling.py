"""The port's light sampling (scene/light_sampling.py) against the JAX
package's (zyg_tpu/scene/light_sampling.py) on four scenes, through the
JAX -> port scene hand-off: test_shade_kernel.py's textured_env_scene (a
Dome light with a baked sky emission map, importance-sampled through the
env alias table), a Dome of constant emission over a ground (the uniform
hemisphere sample), test_shade_kernel.py's mesh_scene (the CI trefoil's
3x3 rectangle light at y = 4), and examples/scenes/sunsky.scene (a baked
sky dome and a Distant sun: two infinite lights under the power CDF;
sampling goes to the sun). 20,000 seeded shading points, normals,
uniforms and rays:

- select_light and light_select_pdf exact;
- sample_light: the validity (pdf > 0), infinite flags and light normals
  of rectangles exact; the mapped dome's uv and the plain dome's pdf
  (1 / 2 pi) exact; directions within 2e-6, sampled points within 2e-5
  (the domes', at RAY_MAX_T * wi, within 1e-6 relative or 5e3) and
  distances within 2e-6 relative; pdfs within 1e-5 relative (the mapped
  dome's where sin(theta) > 0.2: near the poles torch and XLA round
  cos(theta) apart and 1 - cos^2 amplifies it, 1e-2 down to sin(theta) =
  1e-3, below which the jacobian's 1e-8 clamp rules);
- the sun: its pdf (1 / its cone's solid angle, ~1.5e4), validity and
  normal exact, its directions within 2e-6 (which puts its points at
  RAY_MAX_T within 1e3) and its uv, whose u and v are divided by its
  radius tan(0.00465), within 5e-5;
- light_radiance: the rectangle's, the sun's and the plain dome's exact, the mapped
  dome's within 5e-3 relative (its lat-long uv goes through atan2 and
  acos, which torch and XLA round apart; 3 of 60,000 values differ by
  more than 5e-4, at 2e-3);
- light_hit_pdf on the lanes whose prop is the light: within 1e-5
  relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_surface import mesh_scene  # noqa: F401
from test_torch_surface_v2 import jax_scene  # noqa: F401

torch.set_num_threads(2)

N = 20000


def _plain_dome_scene():
    """A ground rectangle under a Dome light of constant emission (no map:
    NEE samples the hemisphere around the normal uniformly)."""
    import zyg_tpu.scene.loader as jl
    import zyg_tpu.scene.types as jt

    b = jl.SceneBuilder()
    grey = b.add_material(jl.MaterialDesc(color=np.full(3, 0.4, np.float32), roughness=0.9))
    sky = b.add_material(jl.MaterialDesc(kind=2, emission=np.array([0.5, 0.7, 1.0], np.float32)))
    b.add_prop(jl.PropDesc(
        shape=int(jt.ShapeType.RECTANGLE),
        trafo=jl.Transformation(position=np.array([0, -1.6, 0], np.float32),
                                rotation=np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
                                scale=np.array([10.0, 10.0, 1], np.float32)),
        material=grey,
    ))
    b.add_prop(jl.PropDesc(shape=int(jt.ShapeType.DOME), trafo=jl.Transformation(), material=sky,
                           is_light=True))
    return b.build()


def _sunsky_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file("examples/scenes/sunsky.scene")


@pytest.fixture(scope="module", params=["dome", "plain_dome", "rectangle", "sun"])
def scenes(request, jax_scene, mesh_scene):  # noqa: F811
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js = {"dome": jax_scene, "rectangle": mesh_scene}.get(request.param)
    if js is None:
        js = _plain_dome_scene() if request.param == "plain_dome" else _sunsky_scene()
    return request.param, js, scene_from_jax_arrays(scene_arrays(js), "cpu")


def _points(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return p, n, rng.random((N, 2)).astype(np.float32), rng.random(N).astype(np.float32)


def _rel(a, b, floor=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / (np.abs(a) + floor)


def test_select_light_matches_jax(scenes):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    _, js, ps = scenes
    u = _points(0)[3]
    ji, jp = jax.jit(lambda u: jls.select_light(js, u))(jnp.asarray(u))
    ti, tp = tls.select_light(ps, torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    li = np.random.default_rng(1).integers(-1, 2, N).astype(np.int32)
    ref = jax.jit(lambda li: jls.light_select_pdf(js, li))(jnp.asarray(li))
    np.testing.assert_array_equal(np.asarray(ref), tls.light_select_pdf(ps, torch.from_numpy(li)))


def test_sample_light_and_radiance_match_jax(scenes):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    kind, js, ps = scenes
    p, n, xi, _ = _points(2)
    li = np.full(N, 1 if kind == "sun" else 0, np.int32)

    @jax.jit
    def ref(li, p, n, xi):
        s = jls.sample_light(js, li, p, n, xi, total_sphere=jnp.zeros(li.shape, bool))
        return s, jls.light_radiance(js, li, s.wi, s.light_n, s.uv)

    js_, jrad = ref(jnp.asarray(li), jnp.asarray(p), jnp.asarray(n), jnp.asarray(xi))
    t = torch.from_numpy
    ts = tls.sample_light(ps, tls.light_shapes(ps), t(li), t(p), t(n), t(xi))
    trad = tls.light_radiance(ps, t(li), ts.wi, ts.light_n, ts.uv).numpy()
    jpdf = np.asarray(js_.pdf)
    np.testing.assert_array_equal(jpdf > 0, ts.pdf.numpy() > 0)
    np.testing.assert_array_equal(np.asarray(js_.infinite), ts.infinite.numpy())
    assert (jpdf > 0).mean() > 0.4
    np.testing.assert_allclose(ts.wi.numpy(), np.asarray(js_.wi), rtol=0, atol=2e-6)
    rel_pdf = _rel(jpdf, ts.pdf.numpy(), 1e-6)
    if kind == "dome":
        juv = np.asarray(js_.uv)
        np.testing.assert_array_equal(juv, ts.uv.numpy())
        sin_t = np.sin(np.pi * juv[:, 1])
        assert rel_pdf[sin_t > 0.2].max() < 1e-5
        assert rel_pdf[sin_t > 1e-3].max() < 1e-2
        np.testing.assert_allclose(ts.light_p.numpy(), np.asarray(js_.light_p), rtol=1e-6)
        np.testing.assert_allclose(trad, np.asarray(jrad), rtol=5e-3)
    elif kind == "sun":
        np.testing.assert_array_equal(jpdf, ts.pdf.numpy())
        assert jpdf.max() > 1e4
        np.testing.assert_array_equal(np.asarray(js_.light_n), ts.light_n.numpy())
        np.testing.assert_allclose(ts.light_p.numpy(), np.asarray(js_.light_p), rtol=0, atol=1e3)
        np.testing.assert_allclose(ts.uv.numpy(), np.asarray(js_.uv), rtol=0, atol=5e-5)
        np.testing.assert_array_equal(trad, np.asarray(jrad))
    elif kind == "plain_dome":
        np.testing.assert_array_equal(jpdf, ts.pdf.numpy())
        # RAY_MAX_T * wi + p: the directions' 2e-6 at 2.1e9
        np.testing.assert_allclose(ts.light_p.numpy(), np.asarray(js_.light_p), rtol=0, atol=5e3)
        np.testing.assert_array_equal(trad, np.asarray(jrad))
    else:
        assert rel_pdf.max() < 1e-5
        np.testing.assert_array_equal(np.asarray(js_.light_n), ts.light_n.numpy())
        np.testing.assert_allclose(ts.light_p.numpy(), np.asarray(js_.light_p), rtol=0, atol=2e-5)
        np.testing.assert_allclose(ts.uv.numpy(), np.asarray(js_.uv), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(trad, np.asarray(jrad))
    assert _rel(js_.t_max, ts.t_max.numpy()).max() < 2e-6


def test_light_hit_pdf_matches_jax(scenes):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    _, js, ps = scenes
    rng = np.random.default_rng(3)
    nprops = int(ps.prop_shape.shape[0])
    prop = rng.integers(-1, nprops, N).astype(np.int32)
    ro = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ref = jax.jit(lambda prop, ro, rd: jls.light_hit_pdf(
        js, prop, ro, rd, jnp.ones(prop.shape), ro, rd, rd))(
        jnp.asarray(prop), jnp.asarray(ro), jnp.asarray(rd))
    t = torch.from_numpy
    got = tls.light_hit_pdf(ps, tls.light_shapes(ps), t(prop), t(ro), t(rd)).numpy()
    # lanes on other props feed no MIS weight (the bounce masks them)
    on_light = ps.prop_light[torch.clamp(t(prop), min=0).long()].numpy() >= 0
    assert on_light.mean() > 0.2
    assert _rel(np.asarray(ref), got, 1e-6)[on_light].max() < 1e-5
