"""Reconstruction filters and the filtered flush of the port against the
JAX package, on identical numpy-seeded inputs:

- `blackman`, `mitchell` and `filter_eval` on a float32 grid against the
  jitted JAX functions: Mitchell exactly (the port fuses its products
  where XLA does; eager JAX, which fuses nothing, differs by up to
  6.4e-7), Blackman within
  2.4e-7 (torch's and XLA's cos round an ulp apart on ~5 % of inputs);
- `Framebuffer.splat_filtered` (taps clamped to the frame edge) against
  zyg_tpu.render.sensor.splat_filtered;
- the plain filtered flush (ops/accum.py::flush_filtered) against the JAX
  composition on synthetic dispatches built as test_torch_accum.py builds
  them: the column flush of every step, the filtered unpermute with the
  subpixel offsets recomputed from the seeding law, and the drain stage's
  scatter-splats (zyg_tpu/render/integrator/ptmis.py:1352-1528), for
  Blackman r1 and Mitchell r2, shuffled with slack and a drain stage, and
  unshuffled (the rolled in-loop splat, :1359-1378). The port adds each
  pixel's taps in the order its samples finish, the JAX package sample
  slot by slot: RGB and weights agree within rtol 1e-5 and an absolute
  2e-6 of the plane's largest magnitude (measured: at most 5.7e-7 of it;
  the JAX package's own drain on/off tolerance is rtol 2e-3, atol 1e-3);
- examples/takes/cornell_filtered.take (Mitchell, PTMIS depth 12,
  indirect clamp 8) at 64x64, 4 spp, through the port's Driver against
  the JAX Driver at the golden gate, with the same rays and per-pixel
  weights (at 16 spp the JAX Driver's cold compile takes ~87 s on the
  CPU, ~3 s for each of the 24 sample slots its unpermute unrolls; at 4
  spp, 6 slots, ~29 s);
- a non-CPU tensor never falls back to the plain version.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKE = os.path.join(REPO, "examples/takes/cornell_filtered.take")
INF3 = (np.inf, np.inf, np.inf)
SPP = 4  # cornell_filtered.take's render against the JAX Driver


@pytest.mark.parametrize("name,radius", [("Blackman", 1.0), ("Blackman", 2.0), ("Mitchell", 1.0),
                                         ("Mitchell", 2.0)])
def test_filters_match_jax(name, radius):
    from zyg_tpu.render import sensor as jsensor
    from zyg_tpu_torch.render import sensor

    x = np.linspace(-2.6, 2.6, 200001).astype(np.float32)
    # jitted, as the renders compile them (eager JAX fuses nothing)
    ref = np.asarray(jax.jit(lambda v: jsensor.filter_eval(name, v, radius))(jnp.asarray(x)))
    out = sensor.filter_eval(name, torch.from_numpy(x), radius).numpy()
    if name == "Mitchell":
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(sensor.mitchell(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(jsensor.mitchell)(jnp.asarray(x))))
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=2.4e-7)
        np.testing.assert_allclose(
            sensor.blackman(torch.from_numpy(x), radius).numpy(),
            np.asarray(jax.jit(lambda v: jsensor.blackman(v, radius))(jnp.asarray(x))),
            rtol=0, atol=2.4e-7)
    # the window ends where its support does
    assert out[np.abs(x) > radius].max() == 0.0


@pytest.mark.parametrize("name,radius", [("Blackman", 1), ("Mitchell", 2)])
def test_splat_filtered_clamps_to_edge_like_jax(name, radius):
    from zyg_tpu.render import sensor as jsensor
    from zyg_tpu_torch.render.sensor import Framebuffer

    rng = np.random.default_rng(3)
    w, h = 23, 17
    n = w * h
    rad = rng.exponential(0.5, (n, 3)).astype(np.float32)
    uv = rng.random((n, 2)).astype(np.float32)
    fb0 = rng.random((n, 4)).astype(np.float32)
    ids = np.arange(n)
    xy = np.stack([ids % w, ids // w], -1).astype(np.int32)
    jfb = jsensor.splat_filtered(jsensor.Framebuffer(jnp.asarray(fb0[:, :3]), jnp.asarray(fb0[:, 3])),
                                 jnp.asarray(rad), jnp.asarray(xy), jnp.asarray(uv), w, h, name,
                                 radius)
    fb = Framebuffer(torch.from_numpy(fb0[:, :3]), torch.from_numpy(fb0[:, 3]))
    out = fb.splat_filtered(torch.from_numpy(rad), torch.from_numpy(ids), torch.from_numpy(uv),
                            w, h, name, radius)
    assert out is fb
    np.testing.assert_allclose(fb.value.numpy(), np.asarray(jfb.value), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fb.weight.numpy(), np.asarray(jfb.weight), rtol=1e-5, atol=1e-6)
    # clamped taps keep every weight in the frame: the total added weight is
    # the sum of each sample's full footprint
    assert abs(float((fb.weight - torch.from_numpy(fb0[:, 3])).sum())
               - float(np.asarray(jfb.weight - fb0[:, 3]).sum())) < 1e-3


def _planes(rng, n):
    from test_torch_accum import _planes as planes

    return planes(rng, n)


def _dispatch(kmax, n, slack, seed, shuffled, p_end=0.3):
    """The flush inputs of one dispatch, step by step, as
    test_torch_accum.py::_dispatch builds them (lanes regenerate as
    ptmis.step does, each live path ends with probability p_end a step),
    with each lane's sample slot k. Shuffled: the pixel of lane i's sample
    k is (i + (first + k) * stride) mod n, and once issuance is over with
    at most n/4 paths in flight the survivors go to one drain stage of
    width n/4 that flushes once at its end. Unshuffled: lane i renders
    pixel i, kmax samples, no slack, no drain. Returns (steps, drain or
    None, first, stride)."""
    from zyg_tpu_torch.render.integrator.ptmis import _coprime_stride

    rng = np.random.default_rng(seed)
    stride = _coprime_stride(n) if shuffled else 0
    first = int(rng.integers(0, 100))
    target = n * (kmax - slack)
    lanes = np.arange(n)
    done = np.zeros(n, np.int64)
    alive = np.zeros(n, bool)
    issued = 0
    steps = []
    while issued < target or alive.sum() > (n // 4 if shuffled else 0):
        regen = ~alive & (done < kmax) & (issued < target)
        done += regen
        issued += int(regen.sum())
        was_alive = alive | regen
        alive = was_alive & (rng.random(n) >= p_end)
        k = np.maximum(done - 1, 0)
        pid = (lanes + (first + k) * stride) % n
        col = np.where(was_alive & ~alive, np.clip(done - 1, 0, kmax - 1), -1).astype(np.int32)
        steps.append((pid, was_alive, alive, *_planes(rng, n), col, k))
    if not shuffled:
        return steps, None, first, stride
    wd = n // 4
    live = np.flatnonzero(alive)
    idx = np.full(wd, n - 1)
    idx[: live.size] = live
    valid = np.arange(wd) < live.size
    k = np.maximum(done - 1, 0)[idx]
    d_pid = (lanes[idx] + (first + k) * stride) % n
    d_alive = valid & (rng.random(wd) < 0.2)  # a few still in flight go on to a next stage
    return steps, (d_pid, valid, d_alive, *_planes(rng, wd), k), first, stride


@jax.jit
def _jax_s4(sample_index, seed):
    from zyg_tpu.core.sobol import SobolSampler

    return SobolSampler.start_pixel(sample_index, seed).sample_4d()


def _jax_sub_uv(pid, k, first, nes):
    """The sample's subpixel offset by the seeding law, through the JAX
    sampler (ptmis.py:1483-1487)."""
    it = (first + np.asarray(k)).astype(np.uint32)
    s4 = _jax_s4(jnp.asarray(pid, jnp.uint32) * jnp.uint32(nes) + it,
                 jnp.asarray(it // np.uint32(nes)))
    return s4[:, 0], s4[:, 1]


def _port_sub_uv(pid, k, first, nes):
    """The same offset through the port's sampler, as the lane carries it."""
    from zyg_tpu_torch.core.sobol import SobolSampler

    it = first + torch.from_numpy(np.asarray(k, np.int64))
    s4 = SobolSampler.start_pixel(torch.from_numpy(np.asarray(pid, np.int64)) * nes + it,
                                  it // nes).sample_4d()
    return s4[:, 0:2].contiguous()


def _jax_filtered(steps, drain, first, stride, kmax, n, res, nes, clamp, name, r):
    """zyg_tpu/render/integrator/ptmis.py:1352-1528 on these inputs."""
    from zyg_tpu.ops.accum import _flush_xla
    from zyg_tpu.render.sensor import clamp_radiance, filter_eval

    w_res, h_res = res
    taps = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]

    def tap_w(su, sv, dy, dx):
        return filter_eval(name, su - dx, float(r)) * filter_eval(name, sv - dy, float(r))

    def clamp_cur(e, d, x):
        return (clamp_radiance(jnp.asarray(e), clamp[0]) + clamp_radiance(jnp.asarray(d), clamp[1])
                + clamp_radiance(jnp.asarray(x), clamp[2]))

    li = jnp.arange(n, dtype=jnp.int32)
    gx, gy = li % w_res, li // w_res

    def valid_at(x, y, p, dy, dx):
        toff = dy * w_res + dx
        return ((x + dx >= 0) & (x + dx < w_res) & (y + dy >= 0) & (y + dy < h_res)
                & (p + toff >= 0) & (p + toff < n))

    if drain is None:  # unshuffled: the rolled splat of every step
        @jax.jit
        def splat_step(acc, add, fin, su, sv):
            for dy, dx in taps:
                w = tap_w(su, sv, dy, dx) * fin.astype(jnp.float32)
                w = jnp.where(valid_at(gx, gy, li, dy, dx), w, 0.0)
                c = jnp.concatenate([add * w[:, None], w[:, None]], -1)
                off = dy * w_res + dx
                acc = acc + (jnp.roll(c, off, axis=0) if off else c)
            return acc

        acc = jnp.zeros((n, 4), jnp.float32)
        for pid, was_alive, alive, e, d, x, _, k in steps:
            fin = jnp.asarray(was_alive & ~alive)
            add = jnp.where(fin[:, None], clamp_cur(e, d, x), 0.0)
            su, sv = _jax_sub_uv(pid, k, first, nes)
            acc = splat_step(acc, add, fin, su - 0.5, sv - 0.5)
        return np.asarray(acc[:, 0:3]), np.asarray(acc[:, 3])

    acc = jnp.zeros((4 * kmax, n), jnp.float32)
    for _, was_alive, alive, e, d, x, col, _ in steps:
        fin = jnp.asarray(was_alive & ~alive)
        add = jnp.where(fin[:, None], clamp_cur(e, d, x), 0.0)
        acc = _flush_xla(acc, jnp.asarray(col),
                         [add[:, 0], add[:, 1], add[:, 2], fin.astype(jnp.float32)])
    @jax.jit
    def unpermute_k(out, blk, su, sv):
        for dy, dx in taps:
            w = jnp.where(valid_at(gx, gy, li, dy, dx), tap_w(su, sv, dy, dx) * blk[3], 0.0)
            c = jnp.concatenate([blk[0:3] * w[None], w[None]], 0)
            toff = dy * w_res + dx
            out = out + (jnp.roll(c, toff, axis=1) if toff else c)
        return out

    out = jnp.zeros((4, n), jnp.float32)
    lanes = np.arange(n)
    for k in range(kmax):
        blk = jnp.roll(acc[4 * k: 4 * k + 4], ((first + k) * stride) % n, axis=1)
        su, sv = _jax_sub_uv(lanes, np.full(n, k), first, nes)
        out = unpermute_k(out, blk, su - 0.5, sv - 0.5)
    rgb, counts = out[0:3].T, out[3]
    pid, valid, alive, e, d, x, k = drain
    fin = jnp.asarray(valid & ~alive)
    rgb_s = jnp.where(fin[:, None], clamp_cur(e, d, x), 0.0)
    su, sv = _jax_sub_uv(pid, k, first, nes)
    su, sv = su - 0.5, sv - 0.5
    pl = jnp.asarray(pid, jnp.int32)
    for dy, dx in taps:
        w = tap_w(su, sv, dy, dx) * fin.astype(jnp.float32)
        ok = fin & valid_at(pl % w_res, pl // w_res, pl, dy, dx)
        tgt = jnp.where(ok, pl + dy * w_res + dx, n)
        rgb = rgb.at[tgt].add(rgb_s * w[:, None], mode="drop")
        counts = counts.at[tgt].add(jnp.where(ok, w, 0.0), mode="drop")
    return np.asarray(rgb), np.asarray(counts)


def _port_filtered(steps, drain, first, n, res, nes, clamp, name, r):
    from zyg_tpu_torch.ops.accum import flush_filtered

    fb = torch.zeros((n, 4))
    for pid, was_alive, alive, e, d, x, *rest in steps + ([drain[:6] + (None, drain[6])]
                                                          if drain is not None else []):
        k = rest[-1]
        t = [torch.from_numpy(np.ascontiguousarray(v)) for v in (pid, was_alive, alive, e, d, x)]
        out = flush_filtered(fb, t[0], t[1], t[2], t[3:6], clamp, _port_sub_uv(pid, k, first, nes),
                             res[0], res[1], name, r)
        assert out is fb
    return fb[:, 0:3].numpy(), fb[:, 3].numpy()


@pytest.mark.parametrize("name,r,kmax,res,slack,shuffled", [
    ("Blackman", 1, 24, (64, 32), 8, True),
    ("Mitchell", 2, 5, (40, 25), 2, True),
    ("Blackman", 1, 6, (64, 32), 0, False),
    ("Mitchell", 2, 6, (64, 32), 0, False),
], ids=["blackman_r1_shuffled", "mitchell_r2_shuffled", "blackman_r1_unshuffled",
        "mitchell_r2_unshuffled"])
def test_filtered_flush_matches_jax_composition(name, r, kmax, res, slack, shuffled):
    n = res[0] * res[1]
    steps, drain, first, stride = _dispatch(kmax, n, slack, seed=kmax + r, shuffled=shuffled)
    nes = max(kmax - slack, 2)
    clamp = (np.inf, 20.0, 8.0)
    ref_rgb, ref_w = _jax_filtered(steps, drain, first, stride, kmax, n, res, nes, clamp, name, r)
    rgb, w = _port_filtered(steps, drain, first, n, res, nes, clamp, name, r)
    if drain is not None:  # the drain stage had samples to finish
        assert (drain[1] & ~drain[2]).sum() > 0
    np.testing.assert_allclose(w, ref_w, rtol=1e-5, atol=2e-6 * float(np.abs(ref_w).max()))
    np.testing.assert_allclose(rgb, ref_rgb, rtol=1e-5, atol=2e-6 * float(np.abs(ref_rgb).max()))


def test_filtered_flush_drops_taps_outside_frame_and_dispatch():
    """One sample at each corner of a 4x3 frame with a dispatch of rows
    [4, 12): r = 1 taps past the frame edge and before the dispatch's
    first row add nothing; the rest add the filter's weights."""
    from zyg_tpu_torch.ops.accum import flush_filtered
    from zyg_tpu_torch.render.sensor import filter_eval

    w, h, base = 4, 3, 4
    fb = torch.zeros((8, 4))
    pid = torch.tensor([0, 3, 4, 7])  # global pixels 4, 7, 8, 11
    uv = torch.full((4, 2), 0.5)
    rad = torch.ones((4, 3))
    fin = torch.ones(4, dtype=torch.bool)
    flush_filtered(fb, pid, fin, ~fin, (rad,), (np.inf,), uv, w, h, "Blackman", 1, base=base)
    wt = filter_eval("Blackman", torch.tensor([-1.0, 0.0, 1.0]), 1.0)
    expect = torch.zeros((8, 4))
    for g in (4, 7, 8, 11):
        x, y = g % w, g // w
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                t = (y + dy) * w + (x + dx) - base
                if 0 <= x + dx < w and 0 <= y + dy < h and 0 <= t < 8:
                    expect[t] += wt[dx + 1] * wt[dy + 1]
    torch.testing.assert_close(fb, expect, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def filtered_renders():
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    jt = jload_take(TAKE)
    jt.cameras[0].resolution = (64, 64)
    jt.num_samples_per_pixel = SPP
    jd = JaxDriver(take=jt, scene=jload_scene(jt.scene_filename), use_mesh=False)
    ref = jd.render_frame()
    take = load_take_file(TAKE)
    take.cameras[0].resolution = (64, 64)
    take.num_samples_per_pixel = SPP
    d = Driver(take, load_scene_file(take.scene_filename), device="cpu")
    img = d.render_frame()
    return jd, ref, d, img


def test_cornell_filtered_matches_jax_driver(filtered_renders):
    from zyg_tpu.tools.it import op_downsample

    jd, ref, d, img = filtered_renders
    assert d.persistent and d._frame_width == 64 and d.filter_radius == 2
    assert d.chunk_plan(SPP) == [(SPP, 2)] and d.tile_plan() == [(0, 4096)]
    assert img.shape == ref.shape == (64, 64, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    assert abs(d.last_iterations - jd.last_iterations) <= 2
    # the per-pixel filter weights: the same samples at the same offsets; a
    # lane whose path length flips can move a slack sample (1 pixel of
    # 4,096 at 16 spp, none at 4)
    close = np.isclose(d._fb.weight.numpy(), np.asarray(jd._fb.weight), rtol=1e-5, atol=0)
    assert close.mean() >= 0.995


def test_filtered_flush_non_cpu_tensor_never_falls_back():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel path, which refuses what it cannot launch on instead of computing."""
    from zyg_tpu_torch.ops.accum import flush_filtered

    meta = dict(device="meta")
    fb = torch.zeros((8, 4), **meta)
    r = torch.zeros((4, 3), **meta)
    m = torch.zeros(4, dtype=torch.bool, **meta)
    uv = torch.zeros((4, 2), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        flush_filtered(fb, torch.zeros(4, dtype=torch.int64, **meta), m, m, (r, r, r), INF3, uv,
                       4, 2, "Mitchell", 2)
    with pytest.raises(ValueError, match="CUDA"):
        flush_filtered(fb, torch.zeros(4, dtype=torch.int64, **meta), None, None, (r,), INF3[:1],
                       uv, 4, 2, "Blackman", 1, clamp_edge=True)


def test_framebuffer_splat_and_add_box_match_jax():
    from zyg_tpu.render.sensor import Framebuffer as JaxFramebuffer
    from zyg_tpu_torch.render.sensor import Framebuffer

    rng = np.random.default_rng(6)
    fb0 = rng.random((50, 4)).astype(np.float32)
    ids = rng.integers(0, 50, 200)
    rad = rng.random((200, 3)).astype(np.float32)
    w = rng.random(200).astype(np.float32)
    box = rng.random((50, 3)).astype(np.float32)
    j = JaxFramebuffer(jnp.asarray(fb0[:, :3]), jnp.asarray(fb0[:, 3]))
    j = j.splat(jnp.asarray(ids), jnp.asarray(rad), jnp.asarray(w)).add_box(jnp.asarray(box))
    fb = Framebuffer(torch.from_numpy(fb0[:, :3]), torch.from_numpy(fb0[:, 3]))
    fb.splat(torch.from_numpy(ids), torch.from_numpy(rad), torch.from_numpy(w))
    fb.add_box(torch.from_numpy(box))
    np.testing.assert_allclose(fb.value.numpy(), np.asarray(j.value), rtol=1e-6)
    np.testing.assert_allclose(fb.weight.numpy(), np.asarray(j.weight), rtol=1e-6)
    np.testing.assert_allclose(fb.resolve().numpy(), np.asarray(j.resolve()), rtol=1e-6)


def test_unshuffled_filtered_dispatch_matches_shuffled():
    """cornell_filtered.take's scene at 32x32, 4 samples, Mitchell r2: an
    unshuffled dispatch with an Albedo plane (lane i is pixel i, through
    the general body) and a shuffled one without slack (through the fused
    bounce) give every pixel the same samples at the same offsets, so the
    filter weights agree within rtol 1e-5 (measured 3.9e-7 of the max),
    the rays exactly and the radiance within 1e-3 of the plane's max
    (measured 9.1e-5: the two bodies round apart) and at the golden
    gate."""
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.integrator import ptmis
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(TAKE)
    cam = take.cameras[0]
    cam.resolution = (32, 32)
    scene = load_scene_file(take.scene_filename)
    pids = torch.arange(32 * 32)
    out = {}
    for label, width, aovs in (("unshuffled", 0, ("albedo",)), ("shuffled", 32, ())):
        st = ptmis.PtmisSettings(max_depth=12, collect_aovs=aovs)
        acc, rays, _, w, aov = ptmis.integrate_persistent(
            scene, cam.arrays("cpu"), pids, 0, 4, 4, st, (np.inf, np.inf, 8.0),
            frame_width=width, filter_name="Mitchell", filter_radius=2, resolution=(32, 32))
        out[label] = (acc.numpy(), w.numpy(), aov, int(rays))
    (ua, uw, uaov, urays), (sa, sw, saov, srays) = out["unshuffled"], out["shuffled"]
    assert sorted(uaov) == ["albedo"] and saov == {} and urays == srays
    np.testing.assert_allclose(uw, sw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ua, sa, rtol=0, atol=1e-3 * float(np.abs(sa).max()))
    ui = (ua / uw[:, None]).reshape(32, 32, 3)
    si = (sa / sw[:, None]).reshape(32, 32, 3)
    scale = float(si.mean())
    assert abs(ui.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(si, 4) - op_downsample(ui, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
