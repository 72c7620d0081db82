"""The port's plain closest-hit / any-hit against the JAX Pallas kernels
(ops/isect.py) run in interpret mode, as tests/test_pallas_kernels.py
runs them: prop ids and blocked flags exact, t/u/v within rtol 2e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)


@pytest.fixture()
def force_pallas(monkeypatch):
    import zyg_tpu.ops as ops_pkg
    import zyg_tpu.ops.isect as jisect

    monkeypatch.setattr(ops_pkg, "use_pallas", lambda: True)
    monkeypatch.setattr(jisect, "use_pallas", lambda: True)


@pytest.fixture(scope="module")
def scenes():
    from zyg_tpu.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js = load_scene_file("examples/scenes/cornell.scene")
    return js, scene_from_jax_arrays(scene_arrays(js), "cpu")


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    prim = rng.rand(n) < 0.5
    return o, d, prim


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("ray_class", ["reflection", "camera"])
def test_closest_matches_pallas_interpret(force_pallas, scenes, ray_class):
    from zyg_tpu.ops import isect as jisect
    from zyg_tpu_torch.ops import isect

    js, ts = scenes
    o, d, prim = _rays(700, 5)
    with pltpu.force_tpu_interpret_mode():
        jt, jpid, ju, jv = (np.asarray(x) for x in jisect.closest_props(
            js, js.prop_groups, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e-4),
            jnp.float32(3.0e37), ray_class, jnp.asarray(prim)))
    t, pid, u, v = isect.closest_props(
        isect.prop_table(ts, ray_class), torch.from_numpy(o), torch.from_numpy(d), 1e-4, 3.0e37,
        torch.from_numpy(prim))
    np.testing.assert_array_equal(pid.numpy(), jpid)
    _close(t.numpy(), jt)
    _close(u.numpy(), ju)
    _close(v.numpy(), jv)


def test_anyhit_matches_pallas_interpret(force_pallas, scenes):
    from zyg_tpu.ops import isect as jisect
    from zyg_tpu_torch.ops import isect

    js, ts = scenes
    o, d, _ = _rays(700, 6)
    tmax = np.full(700, 2.0, np.float32)
    with pltpu.force_tpu_interpret_mode():
        jb = np.asarray(jisect.anyhit_props(
            js, js.prop_groups, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e-4),
            jnp.asarray(tmax)))
    b = isect.anyhit_props(isect.prop_table(ts, "shadow"), torch.from_numpy(o),
                           torch.from_numpy(d), 1e-4, torch.from_numpy(tmax))
    np.testing.assert_array_equal(b.numpy(), jb)


def test_all_shape_kinds_match_pallas_interpret():
    """Every analytic kind of the kernel (sphere, disk, distant, canopy and
    dome too) on a synthetic table, through the JAX kernel's own runner."""
    from zyg_tpu.ops import isect as jisect
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees

    names = ["sphere", "disk", "rectangle", "cube", "distant", "canopy", "dome"]
    codes = {"canopy": 0, "cube": 1, "disk": 2, "distant": 3, "dome": 4, "rectangle": 5, "sphere": 6}
    rng = np.random.default_rng(12)
    rows = []
    for k in names:
        rot = rotation_matrix_from_euler_degrees(rng.uniform(-90, 90, 3)).reshape(9)
        pos = rng.uniform(-0.8, 0.8, 3) if k not in ("distant", "canopy", "dome") else np.zeros(3)
        scale = rng.uniform(0.3, 1.0, 3)
        rows.append(np.concatenate([rot, pos, scale, [1.0, 1.0]]).astype(np.float32))
    table = np.stack(rows)
    o, d, prim = _rays(700, 8)
    tmax = np.where(rng.random(700) < 0.5, 2.14748313e9, 1.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jt, jslot, ju, jv = (np.asarray(x) for x in jisect._run(
            tuple(names), jnp.asarray(table), jnp.asarray(o), jnp.asarray(d),
            jnp.float32(1e-4), jnp.asarray(tmax), None, False))
        (jb,) = jisect._run(tuple(names), jnp.asarray(table), jnp.asarray(o),
                            jnp.asarray(d), jnp.float32(1e-4), jnp.asarray(tmax), None, True)
    kinds = [codes[k] for k in names]
    ids = torch.arange(len(names))
    tt = torch.from_numpy(table)
    args = (torch.from_numpy(o), torch.from_numpy(d), 1e-4, torch.from_numpy(tmax), None)
    t, slot, u, v = isect.isect_plain(kinds, tt, ids, *args, False)
    b = isect.isect_plain(kinds, tt, ids, *args, True)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    assert len(set(jslot.tolist()) - {-1}) >= 5  # the rays reach most kinds
    _close(t.numpy(), jt)
    _close(u.numpy(), ju)
    _close(v.numpy(), jv)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb) > 0)
