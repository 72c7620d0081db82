"""The port's mesh bounce (ops/surface.py) against the JAX package, on the
mesh scene and the 2,048-lane state of tests/test_shade_kernel.py
(`mesh_scene`, `_mesh_state`), at that test's mesh tolerances:

- kernel 5's plain version against `_run_surface(..., interpret=True)` on
  identical lane rows (the JAX body's own traversal, fragment and Sobol'
  draws): alive, depth and NEE lanes exact; live-lane o, d, bxdf pdf,
  mis_n, throughput within 1e-4, 5e-5, 5e-5, 5e-5, 5e-3 relative; the
  shadow rays of the NEE lanes within 1e-4 (origin, length) and 1e-3
  (direction, toward the sampled light point); radiance and pending NEE
  column sums within rtol 2e-3 (torch and XLA round acos and sqrt apart);
- the whole mesh body against `make_mesh_fused_body(force_interpret=True)`
  and against the JAX general body: lifecycles and ray count exact, the
  same tolerances.
Both packages get the same scene through scene_from_jax_arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

MESH_TOLS = (("o", 1e-4), ("d", 5e-5), ("bxdf_pdf", 5e-5), ("mis_n", 5e-5), ("throughput", 5e-3))


@pytest.fixture(scope="module")
def mesh_scene():
    """tests/test_shade_kernel.py's mesh_scene: the 48x32 trefoil under a
    rectangle light."""
    from zyg_tpu.scene import trimesh
    from zyg_tpu.scene.loader import MaterialDesc, PropDesc, SceneBuilder, Transformation
    import zyg_tpu.scene.types as st

    b = SceneBuilder()
    grey = b.add_material(MaterialDesc(color=np.full(3, 0.6, np.float32), roughness=0.5))
    lightm = b.add_material(MaterialDesc(kind=2, emission=np.full(3, 30.0, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(48, 32))
    b.add_mesh_prop(mid, Transformation(scale=np.full(3, 0.35, np.float32)), grey)
    rot_down = np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]], np.float32)
    b.add_prop(PropDesc(
        shape=int(st.ShapeType.RECTANGLE),
        trafo=Transformation(position=np.array([0, 4.0, 0], np.float32), rotation=rot_down,
                             scale=np.array([3.0, 3.0, 1], np.float32)),
        material=lightm, is_light=True, visible_shadow=False,
    ))
    return b.build()


@pytest.fixture(scope="module")
def port_scene(mesh_scene):
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    return scene_from_jax_arrays(scene_arrays(mesh_scene), "cpu")


def _arrays(n, seed=3):
    """The lane state of test_shade_kernel.py's _mesh_state, as numpy."""
    rng = np.random.default_rng(seed)
    rng.normal(size=(n, 3))  # the Cornell camera directions _mesh_state replaces
    depth = rng.integers(0, 3, n).astype(np.int32)
    singular = (depth == 0) | (rng.random(n) < 0.2)
    alive = rng.random(n) < 0.9
    thr = rng.random((n, 3)).astype(np.float32) * 0.9 + 0.05
    pdf = rng.random(n).astype(np.float32) * 2.0
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(o=o, d=d, depth=depth, singular=singular, alive=alive, thr=thr, pdf=pdf)


def _jax_state(a):
    from zyg_tpu.core.rng import hash_u32
    from zyg_tpu.core.sobol import SobolSampler
    from zyg_tpu.render.integrator import ptmis
    from zyg_tpu.render.integrator import volume as vol_mod

    n = a["o"].shape[0]
    return ptmis.PathState(
        o=jnp.asarray(a["o"]), d=jnp.asarray(a["d"]), throughput=jnp.asarray(a["thr"]),
        result=ptmis.IValue.zeros(n), alive=jnp.asarray(a["alive"]),
        bxdf_pdf=jnp.asarray(a["pdf"]), singular=jnp.asarray(a["singular"]),
        medium=vol_mod.stack_empty(n), depth=jnp.asarray(a["depth"]),
        vol_depth=jnp.zeros(n, jnp.int32), rays=jnp.int32(0),
        sobol=SobolSampler.start_pixel(jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32)).arrays,
        vol_key=hash_u32(jnp.arange(n, dtype=jnp.uint32)),
        mis_o=jnp.asarray(a["o"]), mis_n=jnp.asarray(a["d"]),
        from_volume=jnp.zeros(n, bool), primary_chain=jnp.ones(n, bool),
        time=jnp.zeros(n, jnp.float32), nee_thr=jnp.zeros(n, jnp.float32),
        reg_alpha=jnp.zeros(n, jnp.float32), aov={}, wavelength=jnp.zeros(n, jnp.float32),
        pid=jnp.arange(n, dtype=jnp.uint32), split={},
    )


def _port_state(a):
    from zyg_tpu_torch.core.rng import hash_u32, to_i32
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.render.integrator.ptmis import IValue, PathState

    n = a["o"].shape[0]
    ids = torch.arange(n, dtype=torch.int64)
    t = torch.from_numpy
    return PathState(
        o=t(a["o"]), d=t(a["d"]), throughput=t(a["thr"]), result=IValue.zeros(n, "cpu"),
        alive=t(a["alive"]), bxdf_pdf=t(a["pdf"]), singular=t(a["singular"]),
        depth=t(a["depth"]), rays=torch.zeros((), dtype=torch.int64),
        sobol=SobolSampler.start_pixel(ids, torch.zeros_like(ids)).arrays,
        vol_key=to_i32(hash_u32(ids)), mis_o=t(a["o"]), mis_n=t(a["d"]), pid=ids,
    )


def _livecmp(x, y, live, tol):
    x = np.asarray(x, np.float64)[live]
    y = np.asarray(y, np.float64)[live]
    rel = np.abs(x - y) / (np.abs(x) + 1e-3)
    assert rel.max() < tol, rel.max()


def _jax_lane_rows(scene, s):
    """The 47 lane rows make_mesh_fused_body hands _run_surface, and the
    JAX mtab/ltab (zyg_tpu/ops/shade.py:1217-1278)."""
    from zyg_tpu.core.gather import small_gather
    from zyg_tpu.core.sobol import SobolSampler
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.scene import shapes

    @jax.jit
    def rows(s):
        smp = SobolSampler(s.sobol, dim=5)
        u_rr, u_sel, xi_l, s3 = smp.sample_1d(), smp.sample_1d(), smp.sample_2d(), smp.sample_3d()
        tmax = jnp.where(s.alive, jnp.float32(shapes.RAY_MAX_T), 0.0)
        hit = shapes.intersect_scene(scene, s.o, s.d, jnp.float32(0.0), tmax, "reflection",
                                     primary=s.depth == 0, time=s.time)
        frag = shapes.build_fragment(scene, hit, s.o, s.d, need_tangents=False, time=s.time)
        finite = hit.valid() & (hit.t < jnp.float32(shapes.RAY_MAX_T))
        light_id = jnp.where(hit.valid(), small_gather(scene.prop_light, jnp.maximum(hit.prop, 0)), -1)
        f = lambda x: x.astype(jnp.float32)  # noqa: E731
        c = lambda x: [x[:, 0], x[:, 1], x[:, 2]]  # noqa: E731
        return (c(s.o) + c(s.d) + c(s.throughput) + [f(s.alive), s.bxdf_pdf, f(s.singular), s.depth]
                + c(s.mis_o) + c(s.mis_n) + c(s.result.emission) + c(s.result.direct)
                + c(s.result.indirect) + [u_rr, u_sel, xi_l[:, 0], xi_l[:, 1], s3[:, 0], s3[:, 1],
                                          s3[:, 2], f(finite)]
                + c(frag.p) + c(frag.geo_n) + c(frag.n)
                + [jnp.maximum(frag.material, 0), light_id.astype(jnp.int32)])

    ltab = jshade._pack_tables(scene)[2]
    return [np.asarray(x) for x in rows(s)], np.asarray(jshade._pack_mtab(scene)), np.asarray(ltab)


@pytest.mark.parametrize(
    "settings",
    [(4, True, False), (2, False, False), (4, True, True)],
    ids=["ptmis", "depth2_nocaustics", "ptdl"],
)
def test_surface_plain_matches_jax_kernel(mesh_scene, port_scene, settings):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu_torch.ops import shade, surface

    rows, mtab, ltab = _jax_lane_rows(mesh_scene, _jax_state(_arrays(2048)))
    np.testing.assert_array_equal(mtab, surface.pack_mtab(port_scene).numpy())
    np.testing.assert_array_equal(ltab, shade.pack_ltab(port_scene).numpy())
    outs = [np.asarray(x) for x in jshade._run_surface(
        jnp.asarray(mtab), jnp.asarray(ltab), [jnp.asarray(x) for x in rows], *settings,
        interpret=True)]

    t = torch.from_numpy

    def v3(i):
        return t(np.stack(rows[i : i + 3], axis=-1))

    rows = [np.array(x) for x in rows]  # writable copies for torch
    st = {
        "o": v3(0), "d": v3(3), "throughput": v3(6), "alive": t(rows[9] > 0.5),
        "bxdf_pdf": t(rows[10]), "singular": t(rows[11] > 0.5), "depth": t(rows[12]),
        "mis_o": v3(13), "mis_n": v3(16), "emission": v3(19), "direct": v3(22),
        "indirect": v3(25), "finite": t(rows[35] > 0.5), "p": v3(36), "geo_n": v3(39),
        "n": v3(42), "mslot": t(rows[45]), "light_id": t(rows[46]),
    }
    ua = t(np.stack(rows[28:32], axis=-1))
    ub = t(np.stack(rows[32:35], axis=-1))
    r = surface.surface_plain(surface.pack_mesh_tables(port_scene), st, ua, ub, *settings)

    def o3(i):
        return np.stack(outs[i : i + 3], axis=-1)

    np.testing.assert_array_equal(r["alive"].numpy(), outs[9] > 0.5)
    np.testing.assert_array_equal(r["depth"].numpy(), outs[11])
    np.testing.assert_array_equal(r["nee_active"].numpy(), outs[28] > 0.5)
    live = outs[9] > 0.5
    ref = {"o": o3(0), "d": o3(3), "throughput": o3(6), "bxdf_pdf": outs[10], "mis_n": o3(15)}
    for name, tol in MESH_TOLS:
        _livecmp(ref[name], r[name].numpy(), live, tol)
    _livecmp(outs[18], r["reg_alpha"].numpy(), live, 5e-5)
    # the NEE lanes' shadow rays: the direction aims at the light sample,
    # which goes through the TPU kernel's acos polynomial (|err| <= 5e-7)
    nee = outs[28] > 0.5
    _livecmp(o3(29), r["shadow_o"].numpy(), nee, 1e-4)
    _livecmp(o3(32), r["shadow_d"].numpy(), nee, 1e-3)
    _livecmp(outs[35], r["shadow_tmax"].numpy(), nee, 1e-4)
    for i, name in ((19, "emission"), (22, "direct"), (25, "indirect"), (36, "nee")):
        np.testing.assert_allclose(o3(i).sum(axis=0), r[name].numpy().sum(axis=0), rtol=2e-3,
                                   atol=1e-4)
    assert int(r["rays"]) == int((rows[9] > 0.5).sum() + nee.sum())


@pytest.mark.parametrize("reference", ["fused_interpret", "general"])
def test_mesh_body_matches_jax(mesh_scene, port_scene, reference):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings, _make_body

    settings = jptmis.PtmisSettings(max_depth=4)
    if reference == "general":
        body_ref = jptmis._make_body(mesh_scene, settings)  # CPU: the general body
    else:
        body_ref = jshade.make_mesh_fused_body(mesh_scene, settings, force_interpret=True)
    a = _arrays(2048)
    r1 = jax.jit(body_ref)(_jax_state(a))
    r2 = _make_body(port_scene, PtmisSettings(max_depth=4))(_port_state(a))

    np.testing.assert_array_equal(np.asarray(r1.alive), r2.alive.numpy())
    np.testing.assert_array_equal(np.asarray(r1.depth), r2.depth.numpy())
    np.testing.assert_array_equal(np.asarray(r1.singular), r2.singular.numpy())
    assert int(r1.rays) == int(r2.rays)
    np.testing.assert_array_equal(np.asarray(r1.sobol.run_seed),
                                  r2.sobol.run_seed.numpy().view(np.uint32))
    live = np.asarray(r1.alive)
    for name, tol in MESH_TOLS:
        _livecmp(getattr(r1, name), getattr(r2, name).numpy(), live, tol)
    for f1, f2 in ((r1.result.emission, r2.result.emission), (r1.result.direct, r2.result.direct),
                   (r1.result.indirect, r2.result.indirect)):
        np.testing.assert_allclose(np.asarray(f1).sum(axis=0), f2.numpy().sum(axis=0), rtol=2e-3,
                                   atol=1e-4)


def test_mesh_bounce_gates(mesh_scene, port_scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import shade, surface
    from zyg_tpu_torch.scene.loader import load_scene_file

    assert jshade.structural_ok_mesh(mesh_scene, jptmis.PtmisSettings(max_depth=4), None)
    assert surface.structural_ok_mesh(port_scene)
    assert not shade.structural_ok(port_scene)  # mesh scenes leave the fused bounce
    cornell = load_scene_file("examples/scenes/cornell.scene")
    assert not surface.structural_ok_mesh(cornell)
    glass = port_scene.to("cpu")
    glass.materials.kind = glass.materials.kind.clone()
    glass.materials.kind[1] = 1  # MaterialKind.GLASS
    assert not surface.structural_ok_mesh(glass)
    with pytest.raises(ValueError):
        surface.make_mesh_fused_body(glass, None)
