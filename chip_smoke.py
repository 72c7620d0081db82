#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero on any failure):
 1. the card: CUDA must be available; prints nvidia-smi's name and power limit
 2. build: compiles zyg_tpu_torch/csrc/*.cu with nvcc (sm_90a) into the
    gitignored zyg_tpu_torch/_build/ and prints the build time, the
    per-kernel register/spill report, each kernel's static SASS
    instruction count (cuobjdump -sass) and the lanes one pass of the
    persistent shade and traverse grids covers
 3. each kernel, called through the wrapper its path calls, against its
    plain torch version on the card, at the main paths' shapes:
    sobol_block bit-exact (also at 0, 1, 31, 129 and one block + 1 lanes,
    with the shared-memory cost of its table reads counted on the data); accum (the per-pixel flush) with RGB within rtol 4e-6 and counts
    exact, at the Cornell path's own finish share and at all lanes; shade (Cornell) with lane
    lifecycles (alive, depth, ray count) exact, live-lane o/d/bxdf_pdf/
    mis_n/throughput within 1e-4/1e-5/1e-5/1e-5/5e-3 relative, and
    radiance column sums within rtol 2e-3; then on the bench trefoil at
    the mesh path's 921,600 lanes: isect over the scene's own reflection
    and shadow prop tables (pid/blocked exact, t/u/v within rtol 2e-5);
    surface with the shade rules plus the shadow rays and NEE values of
    the NEE lanes; traverse (and a rotated two-instance scene) with hit
    ids exact except at exact-t ties, t/u/v within rtol 2e-5 and any-hit
    exact. Times each (median of runs, CUDA events; and its device time
    from the profiler, which leaves out the host's gaps between a short
    kernel's launches) beside its bound and, where one PyTorch call
    computes the same function, that call's time
 4. a 128x128, 64 spp Cornell render on the card against the port's plain
    CPU render: mean energy within 1.5%, 4x4-downsampled RMSE within 6%
    of the mean (the JAX package's golden-gate statistics)
 4b. the same gate for the 30,720-triangle trefoil at 96x56, 16 spp, and
    4c. for the CI textured trefoil under a baked sky dome at 96x56, 16 spp
 5. the Cornell main path: the CLI on examples/takes/cornell_ptmis.take at
    its own 512x512, then the Driver at 1920x1080 and 16 spp; the
    sobol_block, shade and accum kernels must each have launched, the image
    must be finite with a positive mean; one more 1080p render under
    torch.profiler gives the device time by kernel, the glue's launches and
    the device's busy share; one more gives the peak device memory, and one
    more the share of launched lanes each flush finishes
 5b. the mesh main path: the CLI on examples/takes/trefoil.take (640x360,
    8 spp), then the Driver at 1280x720 and 4 spp over the 491,520-triangle
    trefoil; sobol_block, isect, surface, traverse and accum must each have
    launched; the same report and profile
 5c. the textured main path: bench.py's textured trefoil (512^2 checker
    albedo and noise roughness textures, a grey ground, a 256x128 Preetham
    sky on a Dome light) through the Driver at 1280x720, 4 spp, depth 4;
    sobol_block, isect, surface_v2, traverse and accum must each have
    launched; the same report and profile
 6. one bounce of the mesh bounce (kernel 5) against one of the general
    bounce (kernel 6) on the bench trefoil's 921,600 lanes, both built
    directly, timed in turns (CUDA events, medians)
Each main path is driven with the launch counts set to 0 just before it
and read just after. The line before the last is the JSON kernel report;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 1920 * 1080  # lanes of the 1080p Cornell main path
N_CHECK = 1 << 21  # lanes of the Cornell kernels' checks
MESH_RES = (1280, 720)  # the mesh main path: bench_mesh's resolution, spp, depth
MESH_SPP = 4
N_MESH = MESH_RES[0] * MESH_RES[1]  # lanes of the mesh path's first stage and of its checks

REPLACES = {
    "sobol_block": "zyg_tpu/ops/sobol_block.py:26",
    "isect": "zyg_tpu/ops/isect.py:155",
    "shade": "zyg_tpu/ops/shade.py:394",
    "accum": "zyg_tpu/ops/accum.py:31",
    "surface": "zyg_tpu/ops/shade.py:917",
    "surface_v2": "zyg_tpu/ops/shade.py:1362",
    # not a TPU kernel: the JAX package walks the BVH in XLA
    "traverse": "zyg_tpu/scene/trimesh.py:1053",
}
SOURCES = {
    "sobol_block": "zyg_tpu_torch/csrc/sobol_block.cu",
    "isect": "zyg_tpu_torch/csrc/isect.cu",
    "shade": "zyg_tpu_torch/csrc/shade.cu",
    "accum": "zyg_tpu_torch/csrc/accum.cu",
    "surface": "zyg_tpu_torch/csrc/surface.cu",
    "surface_v2": "zyg_tpu_torch/csrc/surface_v2.cu",
    "traverse": "zyg_tpu_torch/csrc/traverse.cu",
}
CORNELL_KERNELS = ("sobol_block", "shade", "accum")
# sobol_block's launch shapes besides the checks' width: 513 is one
# 512-thread block and a lane (each block fills its own table)
SOBOL_SHAPES = (0, 1, 31, 129, 513)
MESH_KERNELS = ("sobol_block", "isect", "surface", "traverse", "accum")
TEXTURED_KERNELS = ("sobol_block", "isect", "surface_v2", "traverse", "accum")

# the least time the card could take: bytes over the memory rate or
# operations over the float32 (non-tensor) peak, NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# integer issue: 64 INT32 lanes a clock on each of 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 16.7e12
# share of a full-width flush launch's lanes whose sample finishes there
# on the Cornell 1080p 16 spp path: 0.2005, measured by phase 5's
# flush_share (NVIDIA H100 80GB HBM3; PERF.md)
CORNELL_FLUSH_SHARE = 0.2005
# operations per item, counted from the kernel sources (each add, multiply,
# compare, select, bit operation or special function counts one)
# sobol_block: 2 + 5 bit reversals, 6 scrambles of 10, 4 table indices and
# loads, 12 XORs, 5 seed combines of 2 (+3 shared), 5 floats of 3, seed hash
OPS_SOBOL_LANE = 127
OPS_PROP_TEST = 45  # one analytic prop hit test
OPS_SHADE_LANE = 2500  # fused bounce without its prop tests
OPS_SURFACE_LANE = 2500  # the mesh bounce between the traversals
# the general shade core: two substitute lobe evaluations (~420 each: six
# energy-fit chains of 49 or 7 fused steps), the VNDF and cosine samples,
# MIS, roulette, merge and the ray offset
OPS_SURFACE_V2_LANE = 1200
OPS_NODE = 8 * 30  # one wide node: 8 slab tests, keys, nearest child, push
OPS_LEAF = 12 * 55  # one leaf: 12 Moller-Trumbore tests and the min
OPS_INSTANCE = 60  # one instance: AABB entry, pick, ray to object space


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by for work of nbytes moved and ops done."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def int_issue_ms(instructions: int, lanes: int) -> float:
    """Time to issue `instructions` per lane at the card's INT32 rate."""
    return instructions * lanes / INT32_OPS_PER_S * 1e3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the `kernel` launches of `reps` calls of fn, from
    torch.profiler's device timestamps: unlike time_ms it does not count the
    device's idle gaps while the host issues a short kernel's launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and f"{kernel}_kernel" in e.name]
    if not us:
        raise AssertionError(f"{kernel}: the profiler recorded no device time")
    return sum(us) / len(us) / 1e3


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(out)
    return out


def sass_counts(so_path: str) -> dict:
    """Static SASS instructions of each kernel in a built library (NOPs not
    counted), from `cuobjdump -sass`."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    cur = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            # mangled names hold the kernel's name after its length
            cur = next((k for k in SOURCES if f"{len(k) + 7}{k}_kernel" in m.group(1)), m.group(1))
            counts[cur] = 0
        elif cur is not None and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", ln):
            counts[cur] += 1
    return counts


def phase_build() -> None:
    from zyg_tpu_torch import ops

    ops.library()
    info = dict(ops.build_info)
    log(f"build: {info['seconds']:.1f} s -> {os.path.relpath(info['path'], REPO)}")
    for ln in info["ptxas"].splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            log(f"  {ln.strip()}")
    sass = sass_counts(info["path"])
    log(f"static SASS instructions (NOPs not counted): {sass}")
    if "sobol_block" in sass:
        log(f"sobol_block: {sass['sobol_block']} static instructions; at one issue a lane each, "
            f"{N_MAIN} lanes take {int_issue_ms(sass['sobol_block'], N_MAIN):.4f} ms of integer "
            f"issue (byte bound {bound(N_MAIN * (8 + 24), 0)['bound_ms']:.4f} ms)")
    for name in ("shade", "traverse"):
        log(f"{name}: one pass of the resident grid covers "
            f"{ops.resident_lanes(f'zyg_{name}_resident_lanes')} lanes")


def _cornell(device):
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(os.path.join(REPO, "examples/scenes/cornell.scene"), device)


def check_sobol(dev) -> dict:
    import torch
    from zyg_tpu_torch.ops.sobol_block import sobol_block, sobol_block_plain

    g = torch.Generator(device="cpu").manual_seed(3)
    sample = torch.randint(-2**31, 2**31, (N_CHECK,), generator=g, dtype=torch.int32).to(dev)
    seed = torch.randint(-2**31, 2**31, (N_CHECK,), generator=g, dtype=torch.int32).to(dev)
    for n in SOBOL_SHAPES + (N_CHECK,):
        buf, ns = sobol_block(sample[:n], seed[:n])
        rbuf, rns = sobol_block_plain(sample[:n], seed[:n])
        torch.cuda.synchronize()
        if not (torch.equal(buf.view(torch.int32), rbuf.view(torch.int32)) and torch.equal(ns, rns)):
            raise AssertionError(f"sobol_block: kernel differs from the plain version at {n} lanes")
    s, r = sample[:N_MAIN], seed[:N_MAIN]
    log(f"sobol_block: bit-exact at {SOBOL_SHAPES} and {N_CHECK} lanes; "
        f"its table reads take {table_wavefronts(s, r):.3f} "
        f"shared-memory wavefronts per warp-wide 16-byte load (4 without bank conflicts)")
    return {
        "max_abs_err": float((buf - rbuf).abs().max()),
        "ms": time_ms(lambda: sobol_block(s, r), 20),
        "device_ms": device_ms(lambda: sobol_block(s, r), "sobol_block"),
        "plain_ms": time_ms(lambda: sobol_block_plain(s, r), 2, runs=3),
        # in: sample, seed; out: 5 floats, next seed
        **bound(N_MAIN * (8 + 24), N_MAIN * OPS_SOBOL_LANE),
        "library_ms": None,
    }


def table_wavefronts(sample, run_seed) -> float:
    """Shared-memory wavefronts of csrc/sobol_block.cu's four byte-table
    loads per warp on these lanes, by the 16-byte load model: each quarter
    warp is one phase, an entry takes 4 banks (bank group = entry mod 8),
    and a phase takes as many wavefronts as the most distinct entries any
    bank group holds. Returns the mean per warp-wide load (4 = no conflicts)."""
    import torch
    from zyg_tpu_torch.core.rng import u32
    from zyg_tpu_torch.core.sobol import bit_reverse32, nested_uniform_scramble

    n = sample.shape[0] // 32 * 32
    y = bit_reverse32(nested_uniform_scramble(sample[:n], u32(run_seed[:n])))
    phase = torch.arange(n, device=y.device) // 8
    total = 0
    for b in range(4):
        entry = (y >> (8 * b)) & 255
        key = torch.unique(phase * 256 + entry)  # distinct entries of each phase
        slot = (key // 256) * 8 + (key % 256) % 8  # (phase, bank group)
        total += int(torch.bincount(slot, minlength=(n // 8) * 8).view(n // 8, 8).amax(1).sum())
    return total / (4 * n // 32)


def _isect_lanes(n, dev, seed=5):
    """Lanes of the trefoil path's analytic hit tests: camera rays of
    trefoil.take on the primary half; on the other half rays leaving the
    trefoil's box, half of them toward the light's plane (y = 4), and
    shadow rays from the box to points on the light. 10 % of the lanes are
    dead (tmax 0). Returns (o, d, tmax, primary, shadow o, shadow d,
    shadow tmax)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    rng = np.random.default_rng(seed)
    prim = rng.random(n) < 0.5
    alive = rng.random(n) < 0.9
    box = rng.uniform(-0.6, 0.6, (n, 3))
    o = np.where(prim[:, None], np.array([0.0, 0.8, -5.5]), box)
    up = rng.random(n) < 0.5
    ceiling = np.stack([rng.uniform(-2, 2, n), np.full(n, 4.0), rng.uniform(-2, 2, n)], axis=1)
    d = np.where(prim[:, None], rng.uniform(-1.5, 1.5, (n, 3)) - o,
                 np.where(up[:, None], ceiling - o, rng.normal(size=(n, 3))))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(alive, RAY_MAX_T, 0.0)
    lamp = np.stack([rng.uniform(-1.5, 1.5, n), np.full(n, 4.0), rng.uniform(-1.5, 1.5, n)], axis=1)
    sd = lamp - box
    slen = np.linalg.norm(sd, axis=-1)
    sd /= slen[:, None]
    smax = np.where(alive, slen, 0.0)

    def t(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x if x.dtype == bool else x.astype(np.float32)).to(dev)

    return tuple(t(x) for x in (o, d, tmax, prim, box, sd, smax))


def check_isect(dev) -> dict:
    import torch
    from zyg_tpu_torch.ops import isect

    scene = _trefoil(dev)
    refl, shadow = isect.prop_table(scene, "reflection"), isect.prop_table(scene, "shadow")
    n = N_MESH
    o, d, tmax, prim, so, sd, smax = _isect_lanes(n, dev)
    k = isect.closest_props(refl, o, d, 0.0, tmax, prim)
    p = isect.isect_plain(refl.kinds, refl.table, refl.ids, o, d, 0.0, tmax, prim, False)
    kb = isect.anyhit_props(shadow, so, sd, 0.0, smax)
    pb = isect.isect_plain(shadow.kinds, shadow.table, shadow.ids, so, sd, 0.0, smax, None, True)
    torch.cuda.synchronize()
    if not torch.equal(k[1], p[1]):
        raise AssertionError(f"isect: {int((k[1] != p[1]).sum())} prop ids differ")
    if not torch.equal(kb, pb):
        raise AssertionError(f"isect: {int((kb != pb).sum())} any-hit results differ")
    err = 0.0
    for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
        err = max(err, float((a - b).abs().max()))
    log(f"isect: {int((p[1] >= 0).sum())} of {n} lanes hit the light, "
        f"{int(pb.sum())} shadow rays blocked by analytic props")
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: isect.closest_props(refl, o, d, 0.0, tmax, prim), 20),
        "device_ms": device_ms(lambda: isect.closest_props(refl, o, d, 0.0, tmax, prim), "isect"),
        "plain_ms": time_ms(lambda: isect.isect_plain(refl.kinds, refl.table, refl.ids, o, d, 0.0,
                                                      tmax, prim, False), 2, runs=3),
        # in: o, d, tmax, primary; out: t, prop id, u, v
        **bound(n * (29 + 16), n * len(refl.kinds) * OPS_PROP_TEST),
        "library_ms": None,
    }


def _flush_lanes(n, share, dev, seed=11):
    """One flush step's inputs at the Cornell path's width: lane i's sample
    k sits on pixel (i + k * stride) mod n with k random in [0, 24) (16 spp
    and 8 slack, so pixels collide), `share` of the lanes finish, 80 % of
    the rest stay alive; radiance in [0, 4)."""
    import torch
    from zyg_tpu_torch.render.integrator.ptmis import _coprime_stride

    g = torch.Generator(device="cpu").manual_seed(seed)
    k = torch.randint(0, 24, (n,), generator=g)
    pid = (torch.arange(n) + k * _coprime_stride(n)) % n
    fin = torch.rand(n, generator=g) < share
    was_alive = fin | (torch.rand(n, generator=g) < 0.8)
    planes = [torch.rand((n, 3), generator=g) * 4.0 for _ in range(3)]
    return [t.to(dev) for t in (pid, was_alive, was_alive & ~fin, *planes)]


def check_accum(dev) -> dict:
    """The per-pixel flush against its plain version (RGB within rtol 4e-6,
    counts exact: the kernel's atomics add in another order) at the Cornell
    path's finish share with no clamp, and at all lanes with a finite
    indirect clamp. Times at the path's share, and at all lanes."""
    import torch
    from zyg_tpu_torch.ops.accum import flush_pixels, flush_plain, flush_rows

    n = N_MAIN
    fb0 = torch.rand((n, 4), generator=torch.Generator(device="cpu").manual_seed(12)).to(dev)
    out = {}
    for tag, share, clamp in (("", CORNELL_FLUSH_SHARE, (float("inf"),) * 3),
                              ("all_lanes_", 1.0, (float("inf"), float("inf"), 8.0))):
        lanes = _flush_lanes(n, share, dev)
        a1 = flush_pixels(fb0.clone(), *lanes, clamp)
        a2 = flush_plain(fb0.clone(), *lanes, clamp)
        torch.cuda.synchronize()
        if not torch.equal(a1[:, 3], a2[:, 3]):
            raise AssertionError("accum: sample counts differ from the plain version")
        torch.testing.assert_close(a1, a2, rtol=4e-6, atol=4e-6 * float(a2[:, 0:3].abs().max()))
        m = int((lanes[1] & ~lanes[2]).sum())
        rows = flush_rows(lanes[1], lanes[2], *lanes[3:], clamp)
        a3 = fb0.clone()
        out.update({
            f"{tag}max_abs_err": float((a1 - a2).abs().max()),
            f"{tag}ms": time_ms(lambda: flush_pixels(a1, *lanes, clamp), 20),
            f"{tag}device_ms": device_ms(lambda: flush_pixels(a1, *lanes, clamp), "accum"),
            f"{tag}plain_ms": time_ms(lambda: flush_plain(a2, *lanes, clamp), 3, runs=3),
            # the one PyTorch call that adds the same rows by pixel
            f"{tag}library_ms": time_ms(lambda: a3.index_add_(0, lanes[0], rows), 20),
        })
        if not tag:
            # pid and the two masks of every lane, the three radiance rows of
            # each finishing lane; the [N, 4] rows stay in L2 (33 MB)
            out.update(bound(n * (8 + 2) + m * 36, m * 16))
            log(f"accum: {m} of {n} lanes finish at the path's share {share}")
        del lanes, rows, a1, a2, a3
    return out


def _shade_state(n, dev, seed=7):
    """The lane state of tests/test_torch_shade.py (Cornell, camera-ish rays)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.core.rng import hash_u32, to_i32
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.render.integrator.ptmis import IValue, PathState

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

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ids = torch.arange(n, dtype=torch.int64, device=dev)
    return PathState(
        o=t(o), d=t(d), throughput=t(thr), result=IValue.zeros(n, dev), alive=t(alive),
        bxdf_pdf=t(pdf), singular=t(singular), depth=t(depth),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        sobol=SobolSampler.start_pixel(ids, torch.zeros_like(ids)).arrays,
        vol_key=to_i32(hash_u32(ids)), mis_o=t(o), mis_n=t(d), pid=ids,
    )


# live-lane relative tolerances of tests/test_shade_kernel.py: the Cornell
# bounce's, and the mesh bounce's (interpolated shading normals: 5e-5)
BOUNCE_TOLS = (("o", 1e-4), ("d", 1e-5), ("bxdf_pdf", 1e-5), ("mis_n", 1e-5), ("throughput", 5e-3))
MESH_BOUNCE_TOLS = (("o", 1e-4), ("d", 5e-5), ("bxdf_pdf", 5e-5), ("mis_n", 5e-5),
                    ("throughput", 5e-3))


def compare_bounce(r1: dict, r2: dict, tols=BOUNCE_TOLS) -> float:
    """The shade test's rules; returns the largest live-lane abs error."""
    import torch

    for name in ("alive", "depth", "rays"):
        if not torch.equal(r1[name], r2[name]):
            raise AssertionError(f"shade: lane lifecycle field {name!r} differs")
    live = r1["alive"]
    err = 0.0
    for name, tol in tols:
        a = r1[name][live].double()
        b = r2[name][live].double()
        rel = float(((a - b).abs() / (a.abs() + 1e-3)).max()) if a.numel() else 0.0
        if rel >= tol:
            raise AssertionError(f"shade: {name} relative error {rel} >= {tol}")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    for name in ("emission", "direct", "indirect"):
        s1 = r1[name].double().sum(dim=0)
        s2 = r2[name].double().sum(dim=0)
        torch.testing.assert_close(s1, s2, rtol=2e-3, atol=1e-4)
    return err


def check_shade(dev) -> dict:
    import torch
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.ops import shade
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    scene = _cornell(dev)
    tables = shade.pack_tables(scene)
    settings = PtmisSettings(max_depth=16)

    def inputs(n):
        s = _shade_state(n, dev)
        smp = SobolSampler(s.sobol, dim=5)
        smp.sample_4d()
        ua = smp.arrays.buffer
        smp.sample_3d()
        return s.fields(), ua, smp.arrays.buffer

    st, ua, ub = inputs(N_CHECK)
    args = (settings.max_depth, settings.caustics, settings.nee_only)
    r1 = shade.fused_bounce(tables, st, ua, ub, *args)
    r2 = shade.bounce_plain(tables, st, ua, ub, *args)
    torch.cuda.synchronize()
    err = compare_bounce(r1, r2)
    del st, ua, ub, r1, r2
    st, ua, ub = inputs(N_MAIN)
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: shade.fused_bounce(tables, st, ua, ub, *args), 10),
        "device_ms": device_ms(lambda: shade.fused_bounce(tables, st, ua, ub, *args), "shade", 10),
        "plain_ms": time_ms(lambda: shade.bounce_plain(tables, st, ua, ub, *args), 1, runs=3),
        # 12 state fields + 7 uniforms in (136 B), 11 state fields out (120 B)
        **bound(N_MAIN * (136 + 120),
                N_MAIN * (OPS_SHADE_LANE + 2 * len(tables.kinds) * OPS_PROP_TEST)),
        "library_ms": None,
    }


@functools.lru_cache(maxsize=1)
def _trefoil(dev):
    """examples/scenes/trefoil.scene (the bench's 491,520-triangle trefoil),
    loaded once for the mesh kernels' checks; prints the load and arena
    build time."""
    from zyg_tpu_torch.scene.loader import load_scene_file

    t0 = time.perf_counter()
    scene = load_scene_file(os.path.join(REPO, "examples/scenes/trefoil.scene"), dev)
    m = scene.meshes
    log(f"trefoil scene load + arena build: {time.perf_counter() - t0:.2f} s "
        f"({m.node_rows.shape[0]} node rows, {m.tri_rows.shape[0]} leaf rows, "
        f"{m.attr_rows.shape[0]} attribute rows, max depth {m.max_depth})")
    return scene


def _mesh_rays(n, dev, seed=3):
    """Rays as tests/test_shade_kernel.py's _mesh_state makes them: origins
    in [-4, 4]^3 aimed at points in [-1.5, 1.5]^3; returns (o, d, target)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (o, d, tgt))


def _compare_walks(k, p, name) -> float:
    """Hit records of kernel and plain: ids exact except at exact-t ties,
    t/u/v within rtol 2e-5. Returns the largest abs error."""
    import torch

    kt, kp, ku, kv, kprop = k
    pt, pp, pu, pv, pprop = p
    bad = ((kp != pp) | (kprop != pprop)) & (kt != pt)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} hit ids differ away from exact ties")
    err = 0.0
    for a, b in ((kt, pt), (ku, pu), (kv, pv)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    return err


def check_traverse(dev) -> dict:
    import numpy as np
    import torch
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    def walks(arena, itab, o, d, tmax, primary, any_hit, vis):
        ray_class = ("camera", "reflection", "shadow")[vis]
        k = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, ray_class, primary, any_hit)
        counts = {"nodes": 0, "leaves": 0}
        p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, vis, primary, any_hit, counts)
        torch.cuda.synchronize()
        traverse.check_errors(dev)
        return k, p, counts

    # a rotated, non-uniformly scaled, translated pair of instances
    arena, host = trimesh.build_arena([trimesh.make_trefoil_mesh(48, 32)])
    itab = trimesh.build_instance_table(host, [
        dict(prop=1, mesh=0, rot=rotation_matrix_from_euler_degrees([30, -50, 70]),
             pos=np.array([0.3, -0.2, 0.5], np.float32), scale=np.array([0.35, 0.5, 0.3], np.float32)),
        dict(prop=2, mesh=0, rot=np.eye(3, dtype=np.float32), pos=np.array([-0.5, 0.4, 0.1], np.float32),
             scale=np.full(3, 0.3, np.float32), vis=(False, True, False)),
    ])
    arena, itab = arena.to(dev), itab.to(dev)
    o, d, _ = _mesh_rays(1 << 16, dev, seed=11)
    tmax = torch.full((o.shape[0],), RAY_MAX_T, device=dev)
    prim = torch.arange(o.shape[0], device=dev) % 2 == 0
    k, p, _ = walks(arena, itab, o, d, tmax, prim, False, 1)
    _compare_walks(k, p, "traverse (rotated instances)")

    # the bench trefoil at the main path's width
    scene = _trefoil(dev)
    arena, itab = scene.meshes, scene.mesh_instances
    n = N_MESH
    o, d, tgt = _mesh_rays(n, dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    alive = torch.rand(n, generator=g).to(dev) < 0.9
    prim = torch.rand(n, generator=g).to(dev) < 0.5
    tmax = torch.where(alive, RAY_MAX_T, 0.0)
    k, p, counts = walks(arena, itab, o, d, tmax, prim, False, 1)
    err = _compare_walks(k, p, "traverse")
    smax = torch.where(alive, (tgt - o).norm(dim=1), 0.0)
    kb, pb, _ = walks(arena, itab, o, d, smax, None, True, 2)
    if not torch.equal(kb, pb):
        raise AssertionError(f"traverse: {int((kb != pb).sum())} any-hit results differ")
    log(f"traverse: {int((p[1] >= 0).sum())} of {n} rays hit, {int(pb.sum())} shadow rays "
        f"blocked; the closest-hit walks visited {counts['nodes']} node rows and "
        f"{counts['leaves']} leaf rows")
    arena_bytes = (arena.node_rows.numel() + arena.tri_rows.numel()) * 4
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection",
                                                           prim), 5),
        "device_ms": device_ms(lambda: traverse.intersect_instances(arena, itab, o, d, 0.0, tmax,
                                                                    "reflection", prim), "traverse", 5),
        "anyhit_ms": time_ms(lambda: traverse.intersect_instances(arena, itab, o, d, 0.0, smax, "shadow",
                                                                  any_hit=True), 5),
        "plain_ms": time_ms(lambda: traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 1, prim, False),
                            1, runs=1),
        # in: o, d, tmax, primary and the arena once; out: t, prim, u, v, prop
        **bound(n * (29 + 20) + arena_bytes,
                counts["nodes"] * OPS_NODE + counts["leaves"] * OPS_LEAF + n * OPS_INSTANCE),
        "library_ms": None,
    }


def compare_surface(r1: dict, r2: dict) -> float:
    """compare_bounce's rules at the mesh tolerances, plus the NEE lanes
    exact and their shadow rays within 1e-4 relative and pending values
    summed within rtol 2e-3."""
    import torch

    err = compare_bounce(r1, r2, MESH_BOUNCE_TOLS)
    if not torch.equal(r1["nee_active"], r2["nee_active"]):
        raise AssertionError("surface: NEE lanes differ")
    nee = r1["nee_active"]
    for name in ("shadow_o", "shadow_d", "shadow_tmax"):
        a, b = r1[name][nee].double(), r2[name][nee].double()
        rel = float(((a - b).abs() / (a.abs() + 1e-3)).max()) if a.numel() else 0.0
        if rel >= 1e-4:
            raise AssertionError(f"surface: {name} relative error {rel} >= 1e-4")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    torch.testing.assert_close(r1["nee"].double().sum(0), r2["nee"].double().sum(0), rtol=2e-3,
                               atol=1e-4)
    return err


def check_surface(dev) -> dict:
    import torch
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.ops import shade, surface
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    scene = _trefoil(dev)
    tables = surface.pack_mesh_tables(scene)
    n = N_MESH
    s = _surface_lanes(n, dev)
    smp = SobolSampler(s.sobol, dim=5)
    smp.sample_4d()
    ua = smp.arrays.buffer
    smp.sample_3d()
    ub = smp.arrays.buffer
    hit = shapes.intersect_scene(scene, tables.refl, s.o, s.d, 0.0,
                                 torch.where(s.alive, RAY_MAX_T, 0.0), primary=s.depth == 0)
    frag = shapes.build_fragment(scene, hit, s.o, s.d)
    st = s.fields()
    st.update(
        finite=hit.valid() & (hit.t < RAY_MAX_T), p=frag.p, geo_n=frag.geo_n, n=frag.n,
        mslot=torch.clamp(frag.material, min=0).to(torch.int32),
        light_id=torch.where(hit.valid(), scene.prop_light[torch.clamp(hit.prop, min=0).long()],
                             -1).to(torch.int32),
    )
    args = (4, True, False)  # the trefoil take: PTMIS at depth 4
    r1 = surface.surface(tables, st, ua, ub, *args)
    r2 = surface.surface_plain(tables, st, ua, ub, *args)
    torch.cuda.synchronize()
    err = compare_surface(r1, r2)

    def nbytes(fields):
        return sum((4 if dt != torch.bool else 1) * max(w, 1) for _, dt, w in fields)

    # the lane's fields in (ua/ub: 7 uniforms), its fields out
    lane_bytes = nbytes(shade._IN_FIELDS + surface.FRAG_FIELDS) + 7 * 4 + nbytes(surface._OUT_FIELDS)
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: surface.surface(tables, st, ua, ub, *args), 10),
        "device_ms": device_ms(lambda: surface.surface(tables, st, ua, ub, *args), "surface", 10),
        "plain_ms": time_ms(lambda: surface.surface_plain(tables, st, ua, ub, *args), 1, runs=3),
        **bound(n * lane_bytes, n * OPS_SURFACE_LANE),
        "library_ms": None,
    }


def _surface_lanes(n, dev):
    """The mesh checks' lane state: rays from [-4, 4]^3 aimed into
    [-1.5, 1.5]^3 (they hit the knot, the ground, a light or the dome)."""
    s = _shade_state(n, dev)
    s.o, s.d, _ = _mesh_rays(n, dev)
    s.mis_o, s.mis_n = s.o.clone(), s.d.clone()
    return s


def check_surface_v2(dev) -> dict:
    """Kernel 6 on the bench textured scene's own lane inputs: the general
    bounce's glue output for one bounce of 921,600 lanes."""
    import torch
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    _, scene = _textured(dev, ci=False)
    body = surface_v2.make_mesh_fused_body_v2(scene, PtmisSettings(max_depth=4))
    n = N_MESH
    st, ua, ub, *_ = body.inputs(_surface_lanes(n, dev))
    args = (4, True, False)  # the bench's PTMIS at depth 4
    r1 = surface_v2.surface_v2(body.fit, st, ua, ub, *args)
    r2 = surface_v2.surface_v2_plain(st, ua, ub, *args)
    torch.cuda.synchronize()
    err = compare_bounce(r1, r2, MESH_BOUNCE_TOLS)
    if not torch.equal(r1["nee_active"], r2["nee_active"]):
        raise AssertionError("surface_v2: NEE lanes differ")
    nee = r1["nee_active"]
    torch.testing.assert_close(r1["shadow_tmax"][nee], r2["shadow_tmax"][nee], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(r1["nee"].double().sum(0), r2["nee"].double().sum(0), rtol=2e-3,
                               atol=1e-4)
    textured = int((st["finite"] & (st["mat_kind"] == 0)).sum())
    log(f"surface_v2: {int(st['alive'].sum())} live lanes, {textured} on surfaces, "
        f"{int(nee.sum())} NEE lanes, {int(st['is_light'].sum())} on the dome")

    def nbytes(fields):
        return sum((4 if dt != torch.bool else 1) * max(w, 1) for _, dt, w in fields)

    # the lane's fields in (u_rr and the 3 BSDF uniforms), its fields out
    lane_bytes = nbytes(surface_v2.IN_FIELDS) + 4 * 4 + nbytes(surface_v2.OUT_FIELDS)
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: surface_v2.surface_v2(body.fit, st, ua, ub, *args), 10),
        "device_ms": device_ms(lambda: surface_v2.surface_v2(body.fit, st, ua, ub, *args), "surface_v2",
                               10),
        "plain_ms": time_ms(lambda: surface_v2.surface_v2_plain(st, ua, ub, *args), 1, runs=3),
        **bound(n * lane_bytes, n * OPS_SURFACE_V2_LANE),
        "library_ms": None,
    }


def _take(name, res, spp):
    from zyg_tpu_torch.io.take import load_take_file

    take = load_take_file(os.path.join(REPO, "examples/takes", name))
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    return take


def _golden_gate(card_img, cpu_img, label: str, times: str) -> None:
    """Mean energy within 1.5 %, 4x4-downsampled RMSE within 6 % of the mean."""
    import numpy as np

    h, w, _ = cpu_img.shape

    def ds(x):
        return x.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))

    scale = float(cpu_img.mean())
    ratio = float(card_img.mean()) / scale
    rmse4 = float(np.sqrt(np.mean((ds(card_img) - ds(cpu_img)) ** 2))) / scale
    log(f"{label}: mean ratio {ratio:.6f}, rmse4/mean {rmse4:.6f} ({times})")
    if not np.isfinite(card_img).all() or abs(ratio - 1.0) >= 0.015 or rmse4 >= 0.06:
        raise AssertionError(f"{label}: card render disagrees with the plain CPU render")


def phase_slice(dev) -> None:
    """128x128, 64 spp on the card (kernels) against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    take = _take("cornell_ptmis.take", (128, 128), 64)
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, "slice 128x128x64", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def _ci_trefoil(res, spp):
    """(take, scene) of the JAX package's CI trefoil (tests/golden_configs.py
    mesh_trefoil: a 30,720-triangle trefoil under one rectangle light,
    PTMIS depth 4), built through the port's SceneBuilder."""
    import numpy as np
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.scene import loader, trimesh
    from zyg_tpu_torch.scene.types import ShapeType

    b = loader.SceneBuilder()
    grey = b.add_material(loader.MaterialDesc(color=np.full(3, 0.6, np.float32), roughness=0.5))
    lamp = b.add_material(loader.MaterialDesc(kind=2, emission=np.full(3, 30.0, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(128, 120))
    b.add_mesh_prop(mid, loader.Transformation(scale=np.full(3, 0.35, np.float32)), grey)
    b.add_prop(loader.PropDesc(
        shape=int(ShapeType.RECTANGLE),
        trafo=loader.Transformation(position=np.array([0, 4.0, 0], np.float32),
                                    rotation=np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]], np.float32),
                                    scale=np.array([3.0, 3.0, 1], np.float32)),
        material=lamp, is_light=True, visible_shadow=False,
    ))
    take = Take()
    take.num_samples_per_pixel = spp
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    cam = PerspectiveCamera(resolution=res, fov=np.deg2rad(50))
    cam.position = np.array([0, 0.8, -5.5], np.float32)
    take.cameras = [cam]
    return take, b.build()


@functools.lru_cache(maxsize=2)
def _textured(dev, ci: bool):
    """(take, scene) of bench.py's textured trefoil (bench_mesh_textured:
    512^2 checker albedo and noise roughness textures on the 491,520-
    triangle trefoil, a grey ground, a 256x128 Preetham sky baked onto a
    Dome light; 1280x720, 4 spp, PTMIS depth 4), or with ci=True the JAX
    package's CI copy (tests/test_shade_kernel.py textured_env_scene: 64^2
    textures, a 32x16 sky, the 48x32 trefoil; 96x56, 16 spp), built through
    the port's SceneBuilder from the same numpy recipes and seeds."""
    import numpy as np
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.scene import loader, trimesh
    from zyg_tpu_torch.scene.sky import bake_sky
    from zyg_tpu_torch.scene.types import ShapeType

    t0 = time.perf_counter()
    size, cell = (64, 8) if ci else (512, 32)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    checker = ((xx // cell + yy // cell) % 2).astype(np.float32)
    albedo = np.stack([0.15 + 0.6 * checker, 0.35 + 0.3 * (1 - checker), 0.25 + 0.1 * checker], -1)
    if ci:
        rough = np.clip(0.4 + 0.3 * np.sin(xx * 0.3) * np.cos(yy * 0.2), 0.05, 1.0)
    else:
        rng = np.random.RandomState(7)
        rough = np.clip(0.35 + 0.3 * np.sin(xx * 0.11) * np.cos(yy * 0.07)
                        + 0.1 * rng.rand(512, 512), 0.05, 1.0)
    b = loader.SceneBuilder()
    tex_c = b.add_texture_image(albedo.astype(np.float32))
    tex_r = b.add_texture_image(rough.astype(np.float32)[..., None])
    mat = b.add_material(loader.MaterialDesc(roughness=0.5, color_tex=tex_c, roughness_tex=tex_r))
    grey = b.add_material(loader.MaterialDesc(color=np.full(3, 0.4, np.float32), roughness=0.9))
    sun_dir = np.array([0.35, -0.65, 0.4], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sky = bake_sky(sun_dir, turbidity=2.8, width=32 if ci else 256, height=16 if ci else 128)
    tex_sky = b.add_texture_image(np.asarray(sky, np.float32))
    skym = b.add_material(loader.MaterialDesc(kind=2, emission_tex=tex_sky,
                                              emission=np.ones(3, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(*((48, 32) if ci else (512, 480))))
    b.add_mesh_prop(mid, loader.Transformation(scale=np.full(3, 0.35, np.float32)), mat)
    b.add_prop(loader.PropDesc(
        shape=int(ShapeType.RECTANGLE),
        trafo=loader.Transformation(position=np.array([0, -1.6, 0], np.float32),
                                    rotation=np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
                                    scale=np.array([10.0, 10.0, 1], np.float32)),
        material=grey,
    ))
    b.add_prop(loader.PropDesc(shape=int(ShapeType.DOME), trafo=loader.Transformation(),
                               material=skym, is_light=True))
    scene = b.build(dev)
    take = Take()
    take.num_samples_per_pixel = 16 if ci else MESH_SPP
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    cam = PerspectiveCamera(resolution=(96, 56) if ci else MESH_RES, fov=np.deg2rad(50))
    cam.position = np.array([0, 0.8, -5.5], np.float32)
    take.cameras = [cam]
    log(f"textured trefoil ({'CI' if ci else 'bench'}) scene build: "
        f"{time.perf_counter() - t0:.2f} s")
    return take, scene


def phase_slice_textured(dev) -> None:
    """The CI textured trefoil at 96x56, 16 spp on the card against the
    plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    take, scene = _textured(dev, ci=True)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, "textured trefoil 96x56x16", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_mesh(dev) -> None:
    """The CI trefoil at 96x56, 16 spp on the card against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    take, scene = _ci_trefoil((96, 56), 16)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, "trefoil 96x56x16", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def profile_render(driver, spp: int, label: str, kernels) -> int:
    """Device kernel time of one warm render by kernel, from a torch.profiler
    trace, and the device's busy share of the profiled wall time. Returns
    the launches of kernels that are not the port's (the torch glue)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        driver.start_frame()
        t0 = time.perf_counter()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us() / 1e6
        row[1] += 1
    busy = sum(v[0] for v in by_name.values())
    groups = {k: [0.0, 0] for k in kernels}
    groups["other"] = [0.0, 0]
    for name, (sec, count) in by_name.items():
        key = next((k for k in kernels if f"{k}_kernel" in name), "other")
        groups[key][0] += sec
        groups[key][1] += count
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"profile {label}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f} %)" if busy > 0 else f"profile {label}: no device time recorded")
    for k, (sec, count) in groups.items():
        log(f"  {k:12s} {sec:.4f} s in {count} launches "
            f"({100 * sec / max(busy, 1e-12):.1f} % of device time)")
    for name, (sec, count) in top:
        log(f"  {sec:.4f} s {count:6d}x {name[:100]}")
    return groups["other"][1]


def flush_share(driver, spp: int) -> tuple[float, float]:
    """The share of a flush launch's lanes whose sample finishes in it, over
    one render: (full-width launches, all launches). Counts the lanes on the
    host around each flush, so the render is not timed."""
    import torch
    from zyg_tpu_torch.render.integrator import ptmis

    calls = []  # (finished, lanes) per flush
    orig = ptmis.flush_pixels

    def counting(fb, pid, was_alive, alive, *rest):
        calls.append((int((was_alive & ~alive).sum()), pid.shape[0]))
        return orig(fb, pid, was_alive, alive, *rest)

    ptmis.flush_pixels = counting
    try:
        driver.start_frame()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
    finally:
        ptmis.flush_pixels = orig
    width = max(w for _, w in calls)
    full = [f for f, w in calls if w == width]
    return sum(full) / (len(full) * width), sum(f for f, _ in calls) / sum(w for _, w in calls)


def _cli_run(take_name: str, kernels) -> dict:
    """The user's entry point at the take's own size; returns its kernel
    launch counts."""
    import torch
    from zyg_tpu_torch import cli, ops

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "out.png")
        rc = cli.main(["-i", os.path.join(REPO, "examples/takes", take_name), "-o", png, "-s"])
        torch.cuda.synchronize()
        if rc != 0 or os.path.getsize(png) < 1000:
            raise AssertionError(f"cli {take_name}: no image written")
    launches = ops.launch_counts()
    log(f"main path (cli {take_name}) launches: {launches}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"main path {take_name} never launched the {name} kernel")
    return launches


def _take_scene(take_name, res, spp, label):
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take(take_name, res, spp)
    t0 = time.perf_counter()
    scene = load_scene_file(take.scene_filename)
    log(f"{label}: scene load (with any mesh arena build) {time.perf_counter() - t0:.2f} s")
    return take, scene


def phase_main_path(dev, card: str, label: str, take, scene, kernels) -> dict:
    """A main path through the Driver at the take's resolution and spp:
    warm-up, best of 3, one profiled render. Returns the kernel launches
    of one render."""
    import numpy as np
    import torch
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.render.driver import Driver

    res, spp = take.cameras[0].resolution, take.num_samples_per_pixel
    driver = Driver(take, scene, device=dev)
    driver.start_frame()
    driver.render_iterations(driver.chunk_size)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    best = None
    for _ in range(3):
        driver.start_frame()
        t0 = time.perf_counter()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if best is None or dt < best["seconds"]:
            best = {"seconds": dt, "rays": driver.rays_traced,
                    "iterations": driver.last_iterations}
    counts = ops.launch_counts()
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label} render never launched the {name} kernel")
    img = driver.resolve()
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        raise AssertionError(f"{label} image is not finite with a positive mean")
    per_render = {k: v // 3 for k, v in counts.items()}
    log(f"{label} {res[0]}x{res[1]} {spp}spp [{card}]: {best['seconds']:.4f} s, {best['rays']} rays, "
        f"{best['iterations']} wavefront iterations, "
        f"{best['rays'] / best['seconds'] / 1e6:.2f} Mrays/s, image mean {float(img.mean()):.6f}, "
        f"launches per render {({k: v for k, v in per_render.items() if v})}")
    glue = profile_render(driver, spp, f"{label} {res[0]}x{res[1]} [{card}]", kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    driver.start_frame()
    driver.render_iterations(spp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    full, mean = flush_share(driver, spp)
    log(f"{label} [{card}]: peak device memory of one render {peak} B ({peak / 2**30:.3f} GiB); "
        f"glue launches per render {glue}; flushes finish {full:.4f} of the lanes of a full-width "
        f"launch, {mean:.4f} over all launches")
    return per_render


def measure_bounces(dev, card: str) -> None:
    """One bounce of the mesh bounce (kernel 5) and of the general bounce
    (kernel 6), each built directly, on the same 921,600-lane state over
    the bench trefoil (rectangle light, no textures), timed in turns
    (v1, v2, v2, v1) with CUDA events; medians."""
    import torch
    from zyg_tpu_torch.ops import surface, surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    scene = _trefoil(dev)
    settings = PtmisSettings(max_depth=4)
    v1 = surface.make_mesh_fused_body(scene, settings)
    v2 = surface_v2.make_mesh_fused_body_v2(scene, settings)
    s = _surface_lanes(N_MESH, dev)
    r1, r2 = v1(s), v2(s)
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(getattr(r1, k), getattr(r2, k))) for k in ("alive", "depth", "rays")}
    times = {"v1": [], "v2": []}
    for name in ("v1", "v2", "v2", "v1"):
        body = v1 if name == "v1" else v2
        times[name].append(time_ms(lambda: body(s), 5))
    t1, t2 = statistics.median(times["v1"]), statistics.median(times["v2"])
    log(f"bounce on the bench trefoil, {N_MESH} lanes [{card}]: mesh bounce (kernel 5) "
        f"{t1:.4f} ms, general bounce (kernel 6) {t2:.4f} ms (runs v1 {times['v1']}, "
        f"v2 {times['v2']}); lifecycles equal {same}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()

    checks = {}
    for name, fn in (("sobol_block", check_sobol), ("isect", check_isect),
                     ("accum", check_accum), ("shade", check_shade),
                     ("surface", check_surface), ("surface_v2", check_surface_v2),
                     ("traverse", check_traverse)):
        checks[name] = fn(dev)
        c = checks[name]
        lib = f", library {c['library_ms']:.4f} ms" if c["library_ms"] is not None else ""
        anyhit = f" (any-hit {c['anyhit_ms']:.4f} ms)" if "anyhit_ms" in c else ""
        if "all_lanes_ms" in c:
            anyhit = (f" (all lanes {c['all_lanes_ms']:.4f} ms, device {c['all_lanes_device_ms']:.4f} ms, "
                      f"plain {c['all_lanes_plain_ms']:.4f} ms, "
                      f"library {c['all_lanes_library_ms']:.4f} ms)")
        log(f"{name}: ok, max_abs_err {c['max_abs_err']:.3g}, kernel {c['ms']:.4f} ms "
            f"(device {c['device_ms']:.4f} ms){anyhit}, "
            f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}){lib} "
            f"[{card}]")
        torch.cuda.empty_cache()
    phase_slice(dev)
    phase_slice_mesh(dev)
    phase_slice_textured(dev)
    # launches: the CLI runs of the Cornell and trefoil paths and one render
    # of the textured path
    launches = {k: 0 for k in SOURCES}
    for take_name, label, res, spp, kernels in (
            ("cornell_ptmis.take", "Cornell PTMIS", (1920, 1080), 16, CORNELL_KERNELS),
            ("trefoil.take", "trefoil PTMIS", MESH_RES, MESH_SPP, MESH_KERNELS)):
        cli_counts = _cli_run(take_name, kernels)
        for k in launches:
            launches[k] += cli_counts[k]
        phase_main_path(dev, card, label, *_take_scene(take_name, res, spp, label), kernels)
    textured = phase_main_path(dev, card, "textured trefoil PTMIS", *_textured(dev, ci=False),
                               TEXTURED_KERNELS)
    for k in launches:
        launches[k] += textured[k]
    measure_bounces(dev, card)

    def entry(name):
        c = checks[name]
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "launches_of": "cli cornell_ptmis.take + cli trefoil.take + one 1280x720 4 spp "
                               "textured-trefoil render",
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "device_ms": c["device_ms"],
                "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}

    print(json.dumps({"kernels": [entry(k) for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
