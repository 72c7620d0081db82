#!/usr/bin/env python3
"""Time kernels of one checkout of this repo on the card, through that
checkout's own chip_smoke.py checks, so that two versions of a kernel are
measured by the same yardstick on the same machine:

    git archive HEAD~1 | tar -x -C _archive/parent    # a gitignored directory
    for t in _archive/parent . . _archive/parent; do
        python3 kernel_ab.py $t shade traverse surface surface_v2
    done

The name `cornell` instead times the checkout's Cornell main path (1080p,
16 spp): its own chip_smoke report, then by one yardstick for every
checkout 5 timed renders, the peak device memory of one render and one
profiled render's device time and launches by kernel name, printed as
`RENDER <checkout> <JSON>`.

A `-DNAME[=VALUE]` argument builds the library with that macro defined
(a build-time variant of a kernel); the label of each line then carries
the macros.

Each run builds the checkout's kernel library (its register/spill report
and static SASS instruction counts are printed), runs check_<kernel> of the
checkout's chip_smoke.py for each named kernel (each raises if its kernel
disagrees with the plain version) and prints one line per kernel:
`AB <checkout> <kernel> <the check's result as JSON>`, then
`DEVICE <checkout> <kernel> median ...`: the median device time of the
kernel's launches in a second run of the check, from the profiler (the
check's CUDA-event times also count the device's idle gaps while the host
issues a short kernel's launches). Compare two checkouts only within one
command on one machine, in turns as above.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def render(chip_smoke, dev, label: str) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zyg_tpu_torch.render.driver import Driver

    take, scene = chip_smoke._take_scene("cornell_ptmis.take", (1920, 1080), 16, "Cornell PTMIS")
    chip_smoke.phase_main_path(dev, chip_smoke.phase_card(), "Cornell PTMIS", take, scene,
                               chip_smoke.CORNELL_KERNELS)
    spp = take.num_samples_per_pixel
    drv = Driver(take, scene, device=dev)
    drv.start_frame()
    drv.render_iterations(spp)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        drv.start_frame()
        t0 = time.perf_counter()
        drv.render_iterations(spp)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats(dev)
    drv.start_frame()
    drv.render_iterations(spp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv.start_frame()
        drv.render_iterations(spp)
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e6
            row[1] += 1
    print(f"RENDER {label} " + json.dumps({
        "render_s": times, "median_s": statistics.median(times), "peak_bytes": peak,
        "busy_s": sum(v[0] for v in by_name.values()),
        "launches": sum(v[1] for v in by_name.values()), "by_name": by_name}), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[1])
    defines = [a for a in argv[2:] if a.startswith("-D")]
    kernels = [a for a in argv[2:] if not a.startswith("-D")]
    label = " ".join([os.path.relpath(tree, HERE)] + defines)
    # the checkout's own package and chip_smoke.py
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zyg_tpu_torch import ops

    # this checkout's SASS counter, for checkouts whose chip_smoke lacks one
    spec = importlib.util.spec_from_file_location("_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)

    dev = torch.device("cuda", 0)
    ops.NVCC_FLAGS.extend(defines)  # part of the library's build hash
    chip_smoke.phase_build()
    sass = here.sass_counts(ops.build_info["path"])
    print(f"SASS {label} {json.dumps(sass)}", flush=True)
    if "sobol_block" in sass:
        print(f"INT_ISSUE {label} sobol_block {sass['sobol_block']} instructions, "
              f"{here.int_issue_ms(sass['sobol_block'], here.N_MAIN):.4f} ms at {here.N_MAIN} lanes",
              flush=True)
    for name in kernels:
        if name == "cornell":
            render(chip_smoke, dev, label)
            continue
        check = getattr(chip_smoke, "check_" + name)
        print(f"AB {label} {name} {json.dumps(check(dev))}", flush=True)
        # the same yardstick for every checkout: the check once more under the
        # profiler (its own profiled timing, where it has one, left out: one
        # profiler at a time), and the median device time of the kernel's
        # launches there, most of them at the main path's width
        own = getattr(chip_smoke, "device_ms", None)
        chip_smoke.device_ms = lambda *args, **kwargs: 0.0
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                check(dev)
        finally:
            chip_smoke.device_ms = own
        kernel = {"sobol": "sobol_block"}.get(name, name)
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and f"{kernel}_kernel" in e.name)
        print(f"DEVICE {label} {name} median {us[len(us) // 2] / 1e3:.5f} ms over {len(us)} launches",
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
