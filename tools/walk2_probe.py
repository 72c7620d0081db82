#!/usr/bin/env python3
"""Counts of the point and curve walks' warp loop on the card
(csrc/walk2.cuh, run by csrc/points.cu and csrc/curves.cu).

Builds a copy of the two kernels with per-warp counters patched into
walk2_lanes (summed into device memory as each warp leaves), runs each
walk twice on the lanes of chip_smoke.check_points and check_curves
(sparks.take's 640x360 and hairball.take's 384x384 first-bounce lanes,
and as many incoherent lanes in each tree's root box) through the
ops/points.py and ops/curves.py wrappers, and prints for the second run:
the warps, their warp-steps, the share of those thread-steps that hold a
lane (the persistent mapping's warp efficiency), the share of warp-steps
that run the leaf branch, the lanes at a leaf in such a step, the shared
passes, the claims and refills, and the cycles a warp lives on average
and at most. The counters cost time: read the kernels' times from
chip_smoke.py or kernel_ab.py, not from here.

    python3 tools/walk2_probe.py [-DNAME[=VALUE] ...]

The build-time variants of PERF.md §6 (PR 21) were timed by this
script's `--time` mode at the commits whose walk2.cuh read their macros
(00549f0 and da56fcf).

Needs the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "zyg_tpu_torch", "csrc")

# the counters, patched into walk2_lanes: (source text, its replacement);
# q[k]: warp-steps, thread-steps that hold a lane, warp-steps that run the
# leaf branch, lanes at a leaf summed over them, shared passes, claims,
# refills, cycles, warps, and (an atomicMax) the longest-lived warp's cycles
PATCHES = [
    ("namespace walk2 {\n",
     "__device__ unsigned long long g_probe[10];\nnamespace walk2 {\n"),
    ("  Lane r;\n  r.id = -1;\n",
     "  unsigned long long q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 0};\n"
     "  const long long q_t0 = clock64();\n  Lane r;\n  r.id = -1;\n"),
    ("if (lane == 0) b = atomicAdd(next, 32ull);\n",
     "if (lane == 0) b = atomicAdd(next, 32ull);\n++q[5];\n"),
    ("const int take = __popc(idle) < __popc(avail) ? __popc(idle) : __popc(avail);\n",
     "const int take = __popc(idle) < __popc(avail) ? __popc(idle) : __popc(avail);\n++q[6];\n"),
    ("    if (idle == kFull) break;",
     "    if (idle == kFull) {\n      q[7] = q[9] = (unsigned long long)(clock64() - q_t0);\n"
     "      if (lane == 0) {\n        for (int k = 0; k < 9; ++k) atomicAdd(&g_probe[k], q[k]);\n"
     "        atomicMax(&g_probe[9], q[9]);\n"
     "      }\n      break;\n    }\n    ++q[0];\n    q[1] += 32 - __popc(idle);"),
    ("    const unsigned leaves = __ballot_sync(kFull, at_leaf);\n",
     "    const unsigned leaves = __ballot_sync(kFull, at_leaf);\n"
     "    if (leaves != 0) {\n      ++q[2];\n      q[3] += __popc(leaves);\n    }\n"),
    ("for (int pass = 0; pass * kPassLanes < n_leaf; ++pass) {\n",
     "for (int pass = 0; pass * kPassLanes < n_leaf; ++pass) {\n++q[4];\n"),
]
TAIL = """
#include "points.cu"
#include "curves.cu"
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  const unsigned long long z[10] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""


def probe_source(src: str) -> str:
    """csrc/walk2.cuh's text with the counters patched in."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"walk2_probe: walk2_lanes no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build(flags: list[str]) -> ctypes.CDLL:
    """The two walks with the counters patched in, built with flags into
    their own library."""
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import curves, points

    build_dir = os.path.join(REPO, "zyg_tpu_torch", "_build", "walk2_probe")
    os.makedirs(build_dir, exist_ok=True)
    for name in os.listdir(CSRC):
        if name.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(CSRC, name), build_dir)
    path = os.path.join(build_dir, "walk2.cuh")
    with open(path) as f:
        text = probe_source(f.read())
    with open(path, "w") as f:
        f.write(text)
    cu = os.path.join(build_dir, "probe.cu")
    with open(cu, "w") as f:
        f.write('#include "walk2.cuh"\n' + TAIL)
    so = os.path.join(build_dir, "libwalk2_probe.so")
    subprocess.run([ops._nvcc(), *ops.ARCH_FLAGS, *ops.NVCC_FLAGS, *flags, "-shared",
                    f"-I{build_dir}", "-o", so, cu], check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    lib.zyg_points.argtypes = points._KERNEL.argtypes
    lib.zyg_curves.argtypes = curves._KERNEL.argtypes
    lib.probe_read.argtypes = [ctypes.c_void_p]
    for fn in (lib.zyg_points, lib.zyg_curves, lib.probe_read, lib.probe_reset):
        fn.restype = ctypes.c_int
    return lib


def walk_cases(dev) -> list:
    """(case name, the walk) on chip_smoke's lanes: the point walk over
    sparks' moving arena and the curve walk, on the first-bounce and the
    incoherent lanes, closest and any-hit."""
    import chip_smoke
    import torch
    from zyg_tpu_torch.ops import curves, points
    from zyg_tpu_torch.scene.types import RAY_MAX_T, ShapeType

    cases = []
    for kind, take, res, seed, inc_seed, shape in (
            ("points", "sparks.take", chip_smoke.SPARKS_RES, 29, 37, ShapeType.POINTS),
            ("curves", "hairball.take", chip_smoke.HAIRBALL_RES, 31, 41, ShapeType.CURVES)):
        scene, _, root, o, d, tl = chip_smoke._walk_lanes(dev, take, res, seed, shape)
        arena = scene.points if kind == "points" else scene.curves
        inc = chip_smoke._incoherent_lanes(dev, arena.node_rows, int(root[0]), o.shape[0],
                                           inc_seed)
        tmax = torch.full((o.shape[0],), RAY_MAX_T, device=dev)
        for set_name, lanes in (("first-bounce", (root, o, d, tl)), ("incoherent", inc)):
            for any_hit in (False, True):
                if kind == "points":
                    fn = (lambda ar=arena, ln=lanes, ah=any_hit, tm=tmax:
                          points.walk(ar, *ln[:3], 0.0, tm, time=ln[3], any_hit=ah))
                else:
                    fn = (lambda ar=arena, ln=lanes, ah=any_hit, tm=tmax:
                          curves.walk(ar, *ln[:3], 0.0, tm, any_hit=ah))
                cases.append((f"{kind} {set_name} {'any-hit' if any_hit else 'closest'}", fn))
    return cases


def main(argv: list[str]) -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("walk2_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    from zyg_tpu_torch.ops import curves, points

    cases = walk_cases(torch.device("cuda", 0))
    lib = build(argv)
    # the wrappers launch the probe build's entry points
    points._KERNEL._fn = lib.zyg_points
    curves._KERNEL._fn = lib.zyg_curves
    label = " ".join(argv) or "as built"
    for name, fn in cases:
        fn()
        torch.cuda.synchronize()
        if lib.probe_reset() != 0:
            raise RuntimeError("walk2_probe: resetting the counters failed")
        fn()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 10)()
        if lib.probe_read(out) != 0:
            raise RuntimeError("walk2_probe: reading the counters failed")
        (steps, busy, leaf_steps, leaf_lanes, passes, claims, refills, cycles, warps,
         longest) = list(out)
        print(f"PROBE {label} {name}: {warps} warps, {steps} warp-steps ({steps / warps:.1f} a "
              f"warp), warp efficiency {busy / max(32 * steps, 1):.4f}; leaf branch in "
              f"{leaf_steps / max(steps, 1):.4f} of the warp-steps, "
              f"{leaf_lanes / max(leaf_steps, 1):.2f} lanes at a leaf in such a step, {passes} "
              f"shared passes; {claims} claims, "
              f"{refills} refills; cycles a warp {cycles / warps:.0f}, the longest-lived "
              f"{longest}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
