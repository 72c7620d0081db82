"""The port's per-pixel sample flush against the JAX package's flush: the
column flush (_flush_xla, and _flush_pallas in interpret mode) of every
step of a dispatch, then its roll unpermute and the drain stages' indexed
adds, as zyg_tpu/render/integrator/ptmis.py composes them.

Tolerance: the port adds each pixel's samples in the order they finish,
the JAX package in sample-slot order, so RGB agrees within rtol 4e-6
(about kmax float32 epsilons; absolute 4e-6 times the plane's max) and
the sample counts exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

RTOL = 4e-6


def _planes(rng, n):
    """emission, direct, indirect float32[n, 3]; a tenth of the values large,
    so a clamp has something to cut."""
    out = []
    for _ in range(3):
        v = rng.exponential(0.5, (n, 3))
        v = np.where(rng.random((n, 3)) < 0.1, v * 40.0, v)
        out.append(v.astype(np.float32))
    return out


def _dispatch(kmax, n, slack, seed, p_end=0.3):
    """The flush inputs of one shuffled dispatch, step by step: lanes
    regenerate as ptmis.step does (the pixel of lane i's sample k is
    (i + (first + k) * stride) mod n), each live path ends with probability
    p_end a step, and once issuance is over and at most n/4 paths are in
    flight the survivors go to one drain stage of width n/4 that flushes
    once at its end. Returns (main steps, the drain stage, first, stride)."""
    from zyg_tpu_torch.render.integrator.ptmis import _coprime_stride

    rng = np.random.default_rng(seed)
    stride = _coprime_stride(n)
    first = int(rng.integers(0, 100))
    target = n * (kmax - slack)
    lanes = np.arange(n)
    done = np.zeros(n, np.int64)
    alive = np.zeros(n, bool)
    issued = 0
    steps = []
    while issued < target or alive.sum() > n // 4:
        regen = ~alive & (done < kmax) & (issued < target)
        done += regen
        issued += int(regen.sum())
        was_alive = alive | regen
        alive = was_alive & (rng.random(n) >= p_end)
        pid = (lanes + (first + np.maximum(done - 1, 0)) * stride) % n
        col = np.where(was_alive & ~alive, np.clip(done - 1, 0, kmax - 1), -1).astype(np.int32)
        steps.append((pid, was_alive, alive, *_planes(rng, n), col))
    wd = n // 4
    live = np.flatnonzero(alive)
    idx = np.full(wd, n - 1)
    idx[: live.size] = live
    valid = np.arange(wd) < live.size
    d_pid = (lanes + (first + np.maximum(done - 1, 0)) * stride)[idx] % n
    d_alive = valid & (rng.random(wd) < 0.2)  # a few still in flight go on to a next stage
    drain = (d_pid, valid, d_alive, *_planes(rng, wd))
    return steps, drain, first, stride


def _jax_composition(steps, drain, first, stride, kmax, n, clamp, flush):
    from zyg_tpu.render.sensor import clamp_radiance

    def clamp_cur(e, d, x):
        return (clamp_radiance(jnp.asarray(e), clamp[0]) + clamp_radiance(jnp.asarray(d), clamp[1])
                + clamp_radiance(jnp.asarray(x), clamp[2]))

    acc = jnp.zeros((4 * kmax, n), jnp.float32)
    for _, was_alive, alive, e, d, x, col in steps:
        fin = jnp.asarray(was_alive & ~alive)
        add = jnp.where(fin[:, None], clamp_cur(e, d, x), 0.0)
        acc = flush(acc, jnp.asarray(col), [add[:, 0], add[:, 1], add[:, 2], fin.astype(jnp.float32)])
    out = jnp.zeros((4, n), jnp.float32)
    for k in range(kmax):
        out = out + jnp.roll(acc[4 * k : 4 * k + 4], ((first + k) * stride) % n, axis=1)
    rgb, counts = out[0:3].T, out[3]
    pid, valid, alive, e, d, x = drain
    fin = jnp.asarray(valid & ~alive)
    tgt = jnp.where(fin, jnp.asarray(pid, jnp.int32), n)
    rgb = rgb.at[tgt].add(jnp.where(fin[:, None], clamp_cur(e, d, x), 0.0), mode="drop")
    counts = counts.at[tgt].add(fin.astype(jnp.float32), mode="drop")
    return np.asarray(rgb), np.asarray(counts)


def _port(steps, drain, n, clamp):
    from zyg_tpu_torch.ops.accum import flush_pixels

    fb = torch.zeros((n, 4))
    for pid, was_alive, alive, e, d, x, _ in steps + [drain + (None,)]:
        t = [torch.from_numpy(np.ascontiguousarray(v)) for v in (pid, was_alive, alive, e, d, x)]
        out = flush_pixels(fb, *t, clamp)
        assert out is fb
    return fb[:, 0:3].numpy(), fb[:, 3].numpy()


def _assert_flush_close(rgb, counts, ref_rgb, ref_counts):
    np.testing.assert_array_equal(counts, ref_counts)
    np.testing.assert_allclose(rgb, ref_rgb, rtol=RTOL, atol=RTOL * float(np.abs(ref_rgb).max()))


@pytest.mark.parametrize("kmax,n,slack", [(24, 2048, 8), (5, 1000, 2)], ids=["k24n2048", "k5n1000"])
@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_flush_matches_jax_column_flush_and_unpermute(route, kmax, n, slack):
    from zyg_tpu.ops.accum import _flush_pallas, _flush_xla

    steps, drain, first, stride = _dispatch(kmax, n, slack, seed=kmax)
    clamp = (np.inf, 20.0, 8.0)
    if route == "xla":
        ref = _jax_composition(steps, drain, first, stride, kmax, n, clamp, _flush_xla)
    else:
        with pltpu.force_tpu_interpret_mode():
            ref = _jax_composition(steps, drain, first, stride, kmax, n, clamp, _flush_pallas)
    rgb, counts = _port(steps, drain, n, clamp)
    # every sample of the dispatch reached its pixel once
    assert counts.sum() == float(np.sum([(s[1] & ~s[2]).sum() for s in steps]) +
                                 (drain[1] & ~drain[2]).sum())
    _assert_flush_close(rgb, counts, *ref)


def test_flush_several_lanes_one_pixel():
    """Lanes that finish samples of one pixel in the same step all land on
    it; dyadic values make the sums exact in any order."""
    from zyg_tpu_torch.ops.accum import flush_pixels

    fb = torch.full((4, 4), 0.5)
    pid = torch.tensor([2, 2, 0, 2, 3, 2])
    was_alive = torch.tensor([True, True, True, True, False, True])
    alive = torch.tensor([False, False, False, True, False, False])
    e = torch.arange(18, dtype=torch.float32).reshape(6, 3) * 0.25
    d = torch.full((6, 3), 1.0)
    x = torch.full((6, 3), 0.125)
    flush_pixels(fb, pid, was_alive, alive, e, d, x)
    expect = torch.full((4, 4), 0.5)
    for i in (0, 1, 2, 5):
        expect[pid[i], 0:3] += e[i] + d[i] + x[i]
        expect[pid[i], 3] += 1.0
    torch.testing.assert_close(fb, expect, rtol=0, atol=0)


def test_flush_finite_clamp_equals_clamp_cur():
    """A finite limit per class clamps each class before the sum, as the
    JAX integrator's clamp_cur does before its flush."""
    from zyg_tpu.render.sensor import clamp_radiance
    from zyg_tpu_torch.ops.accum import flush_pixels

    rng = np.random.default_rng(5)
    n = 512
    e, d, x = _planes(rng, n)
    e[:4] = [np.nan, 1e30, -2.0]  # a NaN passes the clamp, as through jnp.minimum
    pid = rng.permutation(n)
    was_alive = rng.random(n) < 0.8
    alive = was_alive & (rng.random(n) < 0.3)
    was_alive[:4], alive[:4] = True, False
    fb0 = rng.random((n, 4)).astype(np.float32)
    clamp = (3.0, 1.5, 0.75)
    cur = np.asarray(clamp_radiance(jnp.asarray(e), clamp[0]) + clamp_radiance(jnp.asarray(d), clamp[1])
                     + clamp_radiance(jnp.asarray(x), clamp[2]))
    fin = was_alive & ~alive
    expect = fb0.copy()
    expect[pid[fin], 0:3] += cur[fin]
    expect[pid[fin], 3] += 1.0
    fb = torch.from_numpy(fb0.copy())
    flush_pixels(fb, torch.from_numpy(pid), torch.from_numpy(was_alive), torch.from_numpy(alive),
                 torch.from_numpy(e), torch.from_numpy(d), torch.from_numpy(x), clamp)
    np.testing.assert_array_equal(fb.numpy(), expect)
    assert np.isnan(fb.numpy()[pid[:4], 0]).all()


def test_flush_drain_stage_valid_mask():
    """A drain stage flushes once at its end with was_alive = valid: the
    padded lanes (copies of the last lane, never valid) and the lanes still
    in flight add nothing."""
    from zyg_tpu_torch.ops.accum import flush_pixels

    n, wd = 64, 16
    fb = torch.zeros((n, 4))
    pid = torch.full((wd,), 63)
    pid[:5] = torch.tensor([3, 9, 63, 9, 40])
    valid = torch.arange(wd) < 5
    alive = torch.zeros(wd, dtype=torch.bool)
    alive[1] = True  # still in flight: goes on to the next stage
    alive[7] = True  # padded lanes keep whatever alive says; valid masks them
    rad = torch.ones((wd, 3))
    flush_pixels(fb, pid, valid, alive, rad, rad, rad, (np.inf, np.inf, np.inf))
    expect = torch.zeros((n, 4))
    for p in (3, 63, 9, 40):
        expect[p] += torch.tensor([3.0, 3.0, 3.0, 1.0])
    torch.testing.assert_close(fb, expect, rtol=0, atol=0)


def test_flush_zero_lanes():
    from zyg_tpu_torch.ops.accum import flush_pixels

    fb = torch.ones((8, 4))
    z = torch.zeros((0, 3))
    out = flush_pixels(fb, torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.bool),
                       torch.zeros(0, dtype=torch.bool), z, z, z)
    assert out is fb
    torch.testing.assert_close(fb, torch.ones((8, 4)), rtol=0, atol=0)


def test_flush_non_cpu_tensor_never_falls_back():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel path, which refuses what it cannot launch on instead of computing."""
    from zyg_tpu_torch.ops.accum import flush_pixels

    meta = dict(device="meta")
    fb = torch.zeros((8, 4), **meta)
    r = torch.zeros((4, 3), **meta)
    m = torch.zeros(4, dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flush_pixels(fb, torch.zeros(4, dtype=torch.int64, **meta), m, m, r, r, r)
