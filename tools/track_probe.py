#!/usr/bin/env python3
"""Counts of the tracking walks' lane loop on the card (csrc/track.cu).

Builds a copy of the kernel source with per-warp counters in walk_lanes
(clock64 around each refill and each step, summed into device memory as
each warp leaves), runs each walk twice on the smoke path's and the fire
path's own glue inputs (chip_smoke._smoke_walk_inputs and
_fire_walk_inputs, 518,400 lanes) through the ops/track.py wrappers, and
prints for the second run: the warps, their warp-steps, the share of
those thread-steps that walk (the persistent mapping's warp efficiency),
the refill iterations and claims, and the cycles a warp spends in its
refills and in its steps. The counters cost time: read the kernels' times
from chip_smoke.py or kernel_ab.py, not from here.

    python3 tools/track_probe.py [-DNAME[=VALUE] ...]

Needs the CUDA toolkit and a card; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the counters, patched into walk_lanes: (source text, its replacement)
PATCHES = [
    ("namespace {\n\nconstexpr unsigned kFull",
     "__device__ unsigned long long g_probe[8];\nnamespace {\n\nconstexpr unsigned kFull"),
    ("  while (true) {\n    unsigned idle = __ballot_sync(kFull, !busy);",
     "  unsigned long long p_steps = 0, p_active = 0, p_refills = 0, p_claims = 0, p_cref = 0,\n"
     "                     p_cstep = 0;\n"
     "  const long long p_t0 = clock64();\n"
     "  while (true) {\n    const long long p_a = clock64();\n"
     "    unsigned idle = __ballot_sync(kFull, !busy);"),
    ("          if (lane == 0) b = atomicAdd(counter, 32ull);",
     "          if (lane == 0) b = atomicAdd(counter, 32ull);\n          ++p_claims;"),
    ("        const int take = __popc(idle)",
     "        ++p_refills;\n        const int take = __popc(idle)"),
    ("    if (busy && step()) busy = false;\n  }\n}",
     "    const long long p_b = clock64();\n    p_cref += p_b - p_a;\n    ++p_steps;\n"
     "    p_active += 32 - __popc(idle);\n    if (busy && step()) busy = false;\n"
     "    __syncwarp();\n    p_cstep += clock64() - p_b;\n  }\n"
     "  if (lane == 0) {\n"
     "    const unsigned long long v[8] = {p_steps, p_active, p_refills, p_claims, p_cref,\n"
     "                                     p_cstep, (unsigned long long)(clock64() - p_t0), 1ull};\n"
     "    for (int k = 0; k < 8; ++k) atomicAdd(&g_probe[k], v[k]);\n  }\n}"),
]
TAIL = """
extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int probe_reset() {
  const unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""


def probe_source(src: str) -> str:
    """csrc/track.cu's text with the counters patched in."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"track_probe: walk_lanes no longer holds {old!r}")
        src = src.replace(old, new)
    return src + TAIL


def main(argv: list[str]) -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("track_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import track

    build = os.path.join(REPO, "zyg_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    cu = os.path.join(build, "track_probe.cu")
    so = os.path.join(build, "libtrack_probe.so")
    with open(os.path.join(REPO, "zyg_tpu_torch", "csrc", "track.cu")) as f:
        text = probe_source(f.read())
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([ops._nvcc(), *ops.ARCH_FLAGS, *ops.NVCC_FLAGS, *argv, "-shared",
                    f"-I{os.path.join(REPO, 'zyg_tpu_torch', 'csrc')}", "-o", so, cu], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    lib.zyg_track_interaction.argtypes = track._INTERACTION.argtypes
    lib.zyg_track_transmittance.argtypes = track._TRANSMITTANCE.argtypes
    lib.probe_read.argtypes = [ctypes.c_void_p]
    for fn in (lib.zyg_track_interaction, lib.zyg_track_transmittance, lib.probe_read,
               lib.probe_reset):
        fn.restype = ctypes.c_int
    # the wrappers launch the probe build's entry points
    track._INTERACTION._fn = lib.zyg_track_interaction
    track._TRANSMITTANCE._fn = lib.zyg_track_transmittance
    dev = torch.device("cuda", 0)
    ia, ta = chip_smoke._smoke_walk_inputs(dev)
    cases = [("interaction smoke", track.track_interaction, ia, {}),
             ("transmittance smoke", track.track_transmittance, ta, {})]
    for variant in ("fire", "spectral"):
        args = chip_smoke._fire_walk_inputs(dev, variant)
        cases.append((f"interaction {variant} (emissive)", track.track_interaction, args[:5],
                      {"e_med": args[5]}))
    label = " ".join(argv) or "as built"
    for name, fn, args, kw in cases:
        fn(*args, **kw)
        torch.cuda.synchronize()
        if lib.probe_reset() != 0:
            raise RuntimeError("track_probe: resetting the counters failed")
        fn(*args, **kw)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        if lib.probe_read(out) != 0:
            raise RuntimeError("track_probe: reading the counters failed")
        steps, active, refills, claims, c_refill, c_step, c_total, warps = list(out)
        print(f"PROBE {label} {name}: {warps} warps, {steps} warp-steps ({steps / warps:.1f} a "
              f"warp), {active} walking thread-steps (warp efficiency "
              f"{active / (32 * steps):.4f}), {refills} refills, {claims} claims; cycles a warp "
              f"{c_total / warps:.0f}, of which refills {c_refill / warps:.0f} and steps "
              f"{c_step / warps:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
