"""The port's general bounce (ops/surface_v2.py) against the JAX package, on
tests/test_shade_kernel.py's `textured_env_scene` (the 48x32 trefoil with
a checker albedo and a noise roughness texture over a grey ground, under a
baked 32x16 Preetham sky on a Dome light) and its 2,048-lane state:

- kernel 6's plain version against `_run_surface_v2(..., interpret=True)`
  on the same seeded 66 lane rows: alive, depth and NEE lanes exact;
  live-lane o, mis_o, mis_n, reg alpha, the NEE lanes' shadow tmax and the
  radiance sums within 1e-5 relative; what passes through the BSDF's
  transcendentals at alpha down to 2.5e-3 (d, throughput, bxdf pdf, the
  pending NEE values) within 1e-4, 5e-3, 2e-2, 5e-3 per lane and 2e-4
  summed;
- one v2 bounce of the port against `make_mesh_fused_body_v2(
  force_interpret=True)`: lifecycles, ray count and Sobol' state exact;
  live-lane o, d, bxdf pdf, mis_n, throughput within 1e-4, 5e-5, 1e-2,
  5e-5, 5e-3 relative and radiance column sums within rtol 2e-3 (the
  tolerances of test_shade_kernel.py:356-374; torch and XLA round atan2,
  acos and the BSDF's transcendentals apart); the same on the mesh scene
  under its rectangle light, which the general bounce also takes;
- the gates: the fused and mesh bounces refuse the textured scene, the
  general one takes it, and a sphere light is refused.
Both packages get the same scene through scene_from_jax_arrays.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_surface import _arrays, _jax_state, _livecmp, _port_state, mesh_scene  # noqa: F401

torch.set_num_threads(2)

V2_TOLS = (("o", 1e-4), ("d", 5e-5), ("bxdf_pdf", 1e-2), ("mis_n", 5e-5), ("throughput", 5e-3))
SUN = np.array([0.35, -0.65, 0.4], np.float32) / np.linalg.norm([0.35, -0.65, 0.4])


def textured_env_scene(builder_module, trimesh, bake_sky, shape_type):
    """test_shade_kernel.py's textured_env_scene through either package's
    SceneBuilder (same numpy recipes and seeds)."""
    b = builder_module.SceneBuilder()
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    checker = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    albedo = np.stack(
        [0.15 + 0.6 * checker, 0.35 + 0.3 * (1 - checker), 0.25 + 0.1 * checker], -1)
    rough = np.clip(0.4 + 0.3 * np.sin(xx * 0.3) * np.cos(yy * 0.2), 0.05, 1.0
                    ).astype(np.float32)[..., None]
    tex_c = b.add_texture_image(albedo.astype(np.float32))
    tex_r = b.add_texture_image(rough)
    MaterialDesc, PropDesc, Transformation = (
        builder_module.MaterialDesc, builder_module.PropDesc, builder_module.Transformation)
    matd = b.add_material(MaterialDesc(roughness=0.5, color_tex=tex_c, roughness_tex=tex_r))
    grey = b.add_material(MaterialDesc(color=np.full(3, 0.4, np.float32), roughness=0.9))
    sky = bake_sky(SUN, turbidity=2.8, width=32, height=16)
    tex_sky = b.add_texture_image(np.asarray(sky, np.float32))
    skym = b.add_material(MaterialDesc(kind=2, emission_tex=tex_sky, emission=np.ones(3, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(48, 32))
    b.add_mesh_prop(mid, Transformation(scale=np.full(3, 0.35, np.float32)), matd)
    b.add_prop(PropDesc(
        shape=int(shape_type.RECTANGLE),
        trafo=Transformation(position=np.array([0, -1.6, 0], np.float32),
                             rotation=np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
                             scale=np.array([10.0, 10.0, 1], np.float32)),
        material=grey,
    ))
    b.add_prop(PropDesc(shape=int(shape_type.DOME), trafo=Transformation(), material=skym,
                        is_light=True))
    return b.build()


@pytest.fixture(scope="module")
def jax_scene():
    import zyg_tpu.scene.loader as jl
    import zyg_tpu.scene.types as jt
    from zyg_tpu.scene import trimesh
    from zyg_tpu.scene.sky import bake_sky

    return textured_env_scene(jl, trimesh, bake_sky, jt.ShapeType)


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    return scene_from_jax_arrays(scene_arrays(jax_scene), "cpu")


def _lane_rows(n, seed=11):
    """66 seeded lane rows in _run_surface_v2's order: plausible unit
    directions and normals, materials with alpha down to 2.5e-3, lanes
    under and over the russian-roulette threshold, NEE candidates on both
    sides of the geometric normal."""
    rng = np.random.default_rng(seed)

    def unit(k=n):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    def f(x):
        return np.asarray(x, np.float32)

    geo_n = unit()
    d = unit()
    frag_n = geo_n + 0.2 * unit()
    frag_n /= np.linalg.norm(frag_n, axis=1, keepdims=True)
    wi = unit()
    wi = np.where(rng.random((n, 1)) < 0.7, np.where(
        (wi * geo_n).sum(1, keepdims=True) < 0, -wi, wi), wi)
    depth = rng.integers(0, 5, n).astype(np.int32)
    thr = rng.uniform(0.01, 0.9, (n, 3)) * np.where(rng.random((n, 1)) < 0.3, 0.1, 1.0)
    metallic = np.where(rng.random(n) < 0.7, 0.0, rng.random(n))
    albedo_c = rng.random((n, 3))
    rough = rng.uniform(0.05, 1.0, n)
    f0 = 0.04 + (albedo_c - 0.04) * metallic[:, None]
    tmax = np.where(rng.random(n) < 0.5, rng.uniform(0.1, 10.0, n), 2.14748313e9 * 0.9)

    def c3(x):
        return [f(x[:, k]) for k in range(3)]

    return (c3(rng.uniform(-4, 4, (n, 3))) + c3(d) + c3(thr)
            + [f(rng.random(n) < 0.9), f(rng.random(n) * 2.0),
               f((depth == 0) | (rng.random(n) < 0.2)), depth]
            + c3(rng.uniform(-4, 4, (n, 3))) + c3(unit())
            + c3(rng.random((n, 3))) + c3(rng.random((n, 3))) + c3(rng.random((n, 3)))
            + [f(rng.random(n))] + c3(rng.random((n, 3)))
            + [f(rng.random(n) < 0.85)] + c3(rng.uniform(-2, 2, (n, 3))) + c3(geo_n) + c3(frag_n)
            + [f(np.where(rng.random(n) < 0.85, 0.0, 2.0))]
            + c3((1.0 - metallic[:, None]) * albedo_c) + [f(rough * rough), f(metallic)]
            + c3(f0) + [f(np.where(rng.random(n) < 0.8, 1.0, rng.random(n)))]
            + c3(rng.uniform(0, 5, (n, 3)) * (rng.random((n, 1)) < 0.3))
            + [f(rng.random(n) * 2.0), f(rng.random(n) < 0.3)]
            + c3(wi) + c3(rng.uniform(0, 10, (n, 3)))
            + [f(rng.random(n) * 3.0), f(rng.random(n) < 0.8), f(tmax)])


@pytest.mark.parametrize(
    "settings",
    [(4, True, False), (2, False, False), (4, True, True)],
    ids=["ptmis", "depth2_nocaustics", "ptdl"],
)
def test_surface_v2_plain_matches_jax_kernel(settings):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu_torch.ops import surface_v2

    rows = _lane_rows(4096)
    outs = [np.asarray(x) for x in jshade._run_surface_v2(
        [jnp.asarray(x) for x in rows], *settings, interpret=True)]
    t = torch.from_numpy

    def v3(i):
        return t(np.stack(rows[i : i + 3], axis=-1))

    def b(i):
        return t(rows[i] > 0.5)

    st = {
        "o": v3(0), "d": v3(3), "throughput": v3(6), "alive": b(9), "bxdf_pdf": t(rows[10]),
        "singular": b(11), "depth": t(rows[12]), "mis_o": v3(13), "mis_n": v3(16),
        "emission": v3(19), "direct": v3(22), "indirect": v3(25), "finite": b(32), "p": v3(33),
        "geo_n": v3(36), "n": v3(39), "mat_kind": t(rows[42].astype(np.int32)), "albedo": v3(43),
        "alpha": t(rows[46]), "metallic": t(rows[47]), "f0": v3(48), "specular": t(rows[51]),
        "em": v3(52), "hit_lp": t(rows[55]), "is_light": b(56), "nee_wi": v3(57),
        "nee_rad": v3(60), "nee_lpdf": t(rows[63]), "nee_pre": b(64), "nee_pre_tmax": t(rows[65]),
    }
    ua = t(rows[28])[:, None]
    ub = t(np.stack(rows[29:32], axis=-1))
    r = surface_v2.surface_v2_plain(st, ua, ub, *settings)

    def o3(i):
        return np.stack(outs[i : i + 3], axis=-1)

    np.testing.assert_array_equal(r["alive"].numpy(), outs[9] > 0.5)
    np.testing.assert_array_equal(r["depth"].numpy(), outs[11])
    np.testing.assert_array_equal(r["nee_active"].numpy(), outs[28] > 0.5)
    live = outs[9] > 0.5
    nee = outs[28] > 0.5
    assert live.sum() > 900 and nee.sum() > 350
    for name, i in (("o", 0), ("mis_o", 12), ("mis_n", 15)):
        _livecmp(o3(i), r[name].numpy(), live, 1e-5)
    _livecmp(outs[18], r["reg_alpha"].numpy(), live, 1e-5)
    _livecmp(outs[32], r["shadow_tmax"].numpy(), nee, 1e-5)
    for i, name in ((19, "emission"), (22, "direct"), (25, "indirect")):
        np.testing.assert_allclose(o3(i).sum(axis=0), r[name].numpy().sum(axis=0), rtol=1e-5)
    # what goes through the BSDF's transcendentals: torch and XLA round
    # cos, sin and sqrt apart by an ulp, which grazing lanes at alpha down
    # to 2.5e-3 amplify (test_shade_kernel.py:358-363 measured the same)
    _livecmp(o3(3), r["d"].numpy(), live, 1e-4)
    _livecmp(o3(6), r["throughput"].numpy(), live, 5e-3)
    _livecmp(outs[10], r["bxdf_pdf"].numpy(), live, 2e-2)
    _livecmp(o3(29), r["nee"].numpy(), nee, 5e-3)
    np.testing.assert_allclose(o3(29).sum(axis=0), r["nee"].numpy().sum(axis=0), rtol=2e-4)
    assert int(r["rays"]) == int((rows[9] > 0.5).sum() + nee.sum())


def _compare_bounce(r1, r2, tols=V2_TOLS):
    np.testing.assert_array_equal(np.asarray(r1.alive), r2.alive.numpy())
    np.testing.assert_array_equal(np.asarray(r1.depth), r2.depth.numpy())
    np.testing.assert_array_equal(np.asarray(r1.singular), r2.singular.numpy())
    assert int(r1.rays) == int(r2.rays)
    np.testing.assert_array_equal(np.asarray(r1.sobol.run_seed),
                                  r2.sobol.run_seed.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(r1.vol_key), r2.vol_key.numpy().view(np.uint32))
    live = np.asarray(r1.alive)
    for name, tol in tols:
        _livecmp(getattr(r1, name), getattr(r2, name).numpy(), live, tol)
    for f1, f2 in ((r1.result.emission, r2.result.emission), (r1.result.direct, r2.result.direct),
                   (r1.result.indirect, r2.result.indirect)):
        np.testing.assert_allclose(np.asarray(f1).sum(axis=0), f2.numpy().sum(axis=0), rtol=2e-3,
                                   atol=1e-4)


def test_v2_body_matches_jax(jax_scene, port_scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings, _make_body

    body_ref = jshade.make_mesh_fused_body_v2(jax_scene, jptmis.PtmisSettings(max_depth=4),
                                              force_interpret=True)
    a = _arrays(2048)
    r1 = jax.jit(body_ref)(_jax_state(a))
    r2 = _make_body(port_scene, PtmisSettings(max_depth=4))(_port_state(a))
    _compare_bounce(r1, r2)


def test_v2_body_on_rectangle_light_matches_jax(mesh_scene):  # noqa: F811
    """The general bounce on the mesh scene (rectangle light, no textures),
    which the dispatch gives the mesh bounce but the general one takes."""
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    jscene = mesh_scene
    body_ref = jshade.make_mesh_fused_body_v2(jscene, jptmis.PtmisSettings(max_depth=4),
                                              force_interpret=True)
    a = _arrays(2048)
    r1 = jax.jit(body_ref)(_jax_state(a))
    port = scene_from_jax_arrays(scene_arrays(jscene), "cpu")
    r2 = surface_v2.make_mesh_fused_body_v2(port, PtmisSettings(max_depth=4))(_port_state(a))
    _compare_bounce(r1, r2)


def test_v2_bounce_gates(jax_scene, port_scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import shade, surface, surface_v2
    from zyg_tpu_torch.scene.types import ShapeType

    assert jshade.structural_ok_mesh_v2(jax_scene, jptmis.PtmisSettings(max_depth=4), None)
    assert surface_v2.structural_ok_mesh_v2(port_scene)
    # out of scope for the narrower bounces: textures and the env map
    assert not shade.structural_ok(port_scene)
    assert not surface.structural_ok_mesh(port_scene)
    untextured = dataclasses.replace(port_scene, textures=None)
    assert not surface.structural_ok_mesh(untextured)  # the env map and the dome
    # a textured analytic scene (no meshes) leaves the fused bounce too
    analytic = dataclasses.replace(port_scene, meshes=None, mesh_instances=None)
    assert not shade.structural_ok(analytic)
    assert surface_v2.structural_ok_mesh_v2(analytic)
    # light shapes the port does not sample (a Cube's surface: the port
    # samples Sphere and Disk lights since they joined kernel 6's glue)
    cube = dataclasses.replace(port_scene, prop_shape=port_scene.prop_shape.clone())
    cube.prop_shape[2] = int(ShapeType.CUBE)
    assert not surface_v2.structural_ok_mesh_v2(cube)
    with pytest.raises(ValueError):
        surface_v2.make_mesh_fused_body_v2(cube, None)
    for shape in (ShapeType.SPHERE, ShapeType.DISK):
        lamp = dataclasses.replace(port_scene, prop_shape=port_scene.prop_shape.clone())
        lamp.prop_shape[2] = int(shape)
        assert surface_v2.structural_ok_mesh_v2(lamp)
