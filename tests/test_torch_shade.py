"""The port's fused bounce (plain torch version) against the JAX general
body, on the lane state and with the tolerances of test_shade_kernel.py:

- lane lifecycles EXACT: alive, depth, ray count;
- live-lane o, d, bxdf pdf, mis_n, throughput within 1e-4, 1e-5, 1e-5,
  1e-5, 5e-3 relative;
- radiance column sums within rtol 2e-3 (per-lane NEE values differ at
  float level through the transcendentals; each path stays a consistent
  (sample, pdf) pair).
Both sides get the same scene through scene_from_jax_arrays and the same
Sobol' state, so they draw the same uniforms.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cornell_jax():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file("examples/scenes/cornell.scene")


@pytest.fixture(scope="module")
def cornell_port(cornell_jax):
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    return scene_from_jax_arrays(scene_arrays(cornell_jax), "cpu")


def _arrays(n, seed=7):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -3.9
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.integers(0, 3, n).astype(np.int32)
    singular = (depth == 0) | (rng.random(n) < 0.2)
    alive = rng.random(n) < 0.9
    thr = rng.random((n, 3)).astype(np.float32) * 0.9 + 0.05
    pdf = rng.random(n).astype(np.float32) * 2.0
    return dict(o=o, d=d, depth=depth, singular=singular, alive=alive, thr=thr, pdf=pdf)


def _jax_state(a):
    from zyg_tpu.render.integrator import ptmis
    from zyg_tpu.render.integrator import volume as vol_mod
    from zyg_tpu.core.sobol import SobolSampler
    from zyg_tpu.core.rng import hash_u32

    n = a["o"].shape[0]
    return ptmis.PathState(
        o=jnp.asarray(a["o"]), d=jnp.asarray(a["d"]), throughput=jnp.asarray(a["thr"]),
        result=ptmis.IValue.zeros(n), alive=jnp.asarray(a["alive"]),
        bxdf_pdf=jnp.asarray(a["pdf"]), singular=jnp.asarray(a["singular"]),
        medium=vol_mod.stack_empty(n), depth=jnp.asarray(a["depth"]),
        vol_depth=jnp.zeros(n, jnp.int32), rays=jnp.int32(0),
        sobol=SobolSampler.start_pixel(
            jnp.arange(n, dtype=jnp.uint32), jnp.zeros(n, jnp.uint32)
        ).arrays,
        vol_key=hash_u32(jnp.arange(n, dtype=jnp.uint32)),
        mis_o=jnp.asarray(a["o"]), mis_n=jnp.asarray(a["d"]),
        from_volume=jnp.zeros(n, bool), primary_chain=jnp.ones(n, bool),
        time=jnp.zeros(n, jnp.float32), nee_thr=jnp.zeros(n, jnp.float32),
        reg_alpha=jnp.zeros(n, jnp.float32), aov={},
        wavelength=jnp.zeros(n, jnp.float32),
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


@pytest.mark.parametrize(
    "settings",
    [dict(max_depth=16), dict(max_depth=2, caustics=False), dict(max_depth=16, nee_only=True)],
    ids=["ptmis", "depth2_nocaustics", "ptdl"],
)
def test_fused_bounce_matches_jax_general_body(cornell_jax, cornell_port, settings):
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import shade
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    a = _arrays(2048)
    body_ref = jptmis._make_body(cornell_jax, jptmis.PtmisSettings(**settings))  # CPU: general body
    r1 = jax.jit(body_ref)(_jax_state(a))
    body = shade.make_fused_body(cornell_port, PtmisSettings(**settings))
    r2 = body(_port_state(a))

    np.testing.assert_array_equal(np.asarray(r1.alive), r2.alive.numpy())
    np.testing.assert_array_equal(np.asarray(r1.depth), r2.depth.numpy())
    assert int(r1.rays) == int(r2.rays)
    # both samplers advanced identically
    np.testing.assert_array_equal(
        np.asarray(r1.sobol.run_seed), r2.sobol.run_seed.numpy().view(np.uint32)
    )

    live = np.asarray(r1.alive)

    def livecmp(x, y, tol):
        x = np.asarray(x, np.float64)[live]
        y = y.numpy().astype(np.float64)[live]
        rel = np.abs(x - y) / (np.abs(x) + 1e-3)
        assert rel.max() < tol, rel.max()

    livecmp(r1.o, r2.o, 1e-4)
    livecmp(r1.d, r2.d, 1e-5)
    livecmp(r1.bxdf_pdf, r2.bxdf_pdf, 1e-5)
    livecmp(r1.mis_n, r2.mis_n, 1e-5)
    livecmp(r1.throughput, r2.throughput, 5e-3)
    for f1, f2 in ((r1.result.emission, r2.result.emission),
                   (r1.result.direct, r2.result.direct),
                   (r1.result.indirect, r2.result.indirect)):
        np.testing.assert_allclose(
            np.asarray(f1).sum(axis=0), f2.numpy().sum(axis=0), rtol=2e-3, atol=1e-4
        )


def test_pack_tables_match_jax(cornell_jax, cornell_port):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu_torch.ops import shade

    kinds_j, ptab_j, ltab_j = jshade._pack_tables(cornell_jax)
    t = shade.pack_tables(cornell_port)
    kind_codes = {"rectangle": 5, "cube": 1, "sphere": 6, "disk": 2}
    assert [kind_codes[k] for k in kinds_j] == t.kinds
    np.testing.assert_array_equal(np.asarray(ptab_j), t.ptab.numpy())
    np.testing.assert_array_equal(np.asarray(ltab_j), t.ltab.numpy())


def test_structural_gate(cornell_jax, cornell_port):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import shade

    assert jshade.structural_ok(cornell_jax, jptmis.PtmisSettings(), None)
    assert shade.structural_ok(cornell_port)
    glass = cornell_port.to("cpu")
    glass.materials.kind = glass.materials.kind.clone()
    glass.materials.kind[1] = 1  # MaterialKind.GLASS
    assert not shade.structural_ok(glass)
    with pytest.raises(ValueError):
        shade.make_fused_body(glass, None)
