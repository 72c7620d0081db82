#!/usr/bin/env python3
"""Time kernels of one checkout of this repo on the card, through that
checkout's own chip_smoke.py checks, so that two versions of a kernel are
measured by the same yardstick on the same machine:

    git archive HEAD~1 | tar -x -C _archive/parent    # a gitignored directory
    for t in _archive/parent . . _archive/parent; do
        python3 kernel_ab.py $t surface surface_v2 trefoil textured
    done

The names `cornell`, `trefoil`, `textured`, `sunsky`, `cornell_filtered`,
`caustics`, `smoke`, `fire`, `forest`, `particles`, `sparks` and
`hairball` instead time one of the checkout's main paths: the Cornell
take at 1920x1080 and 16 spp, the trefoil take and the bench's textured
trefoil under its sky dome at 1280x720 and 4 spp, the sunsky take at its
own 960x540, 32 spp,
cornell_filtered.take (Mitchell, radius 2: the filtered flush) at
1920x1080 and 16 spp, caustics_photons.take (the photon gather) at its
own 480x270 in one chunk of 8 spp over the map baked from its 200,000
paths, smoke.take and fire.take (the tracking walks) at their own
960x540 and 8 spp, forest.take (144 instances: the traversal's instance
pick) at its own 640x360 and 16 spp, and cornell_particles.take (the
camera splat) at its own 512x512 over 8 passes of the Driver's particle
pass, sparks.take (the point walk) at its own 640x360 and 32 spp and
hairball.take (the curve walk) at its own 384x384 and 32 spp. Each but
caustics and particles first runs the checkout's own chip_smoke report
of that path (caustics' takes ~20 s a render, the particles CLI ~20 s),
then by one yardstick for every checkout 10 timed renders (3 of
caustics, smoke and fire, ~5-10 s each, 5 of forest, particles and
sparks, ~1-2 s each; their median and best), the peak device memory of
one render and one profiled render's device time and launches by kernel
name, printed as `RENDER <checkout> <path> <JSON>`. hairball (~13 s a
render) is timed once after a warm-up of SLOW_WARMUP_SPP samples, its
peak read over that render, and profiled over its first SLOW_PROFILE_SPP
samples (`profiled_spp` in its line), as chip_smoke.py treats renders
over 5 s; for the mesh paths
one more render gives the lifecycle shares of kernel 5's or 6's lanes
(dead on entry, missed, ended on a hit, reaching NEE, ...), in its first
bounce and over all its launches: `LANES <checkout> <path> ...`.

A `-DNAME[=VALUE]` argument builds the library with that macro defined
(a build-time variant of a kernel); the label of each line then carries
the macros.

Each run builds the checkout's kernel library (its register/spill report
and static SASS instruction counts are printed), runs check_<kernel> of the
checkout's chip_smoke.py for each named kernel (each raises if its kernel
disagrees with the plain version) and prints one line per kernel:
`AB <checkout> <kernel> <the check's result as JSON>`, then
`DEVICE <checkout> <kernel> median ...`: the median device time of the
kernel's launches in a second run of the check (`track` checks both
tracking walks and prints a line for each, `track_interaction` and
`track_transmittance`), from the profiler (the
check's CUDA-event times also count the device's idle gaps while the host
queues a short kernel's launches), and one `DEVICE <checkout> <kernel>
#k [ints] median ...` line for each run of consecutive launches whose
integer arguments (lane counts, caps, modes) are the same, so that the
check's cases are told apart. Compare two checkouts only within one
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


RENDERS = ("cornell", "trefoil", "textured", "sunsky", "cornell_filtered", "caustics", "smoke",
           "fire", "forest", "particles", "sparks", "hairball")
# the paths timed once, after a short warm-up, and profiled over their
# first samples: their renders take over 5 s
SLOW = ("hairball",)
SLOW_WARMUP_SPP = 2
SLOW_PROFILE_SPP = 2
CAUSTICS_SPP = 8  # one chunk of the caustics path
PARTICLE_PASSES = 8  # the particle passes of one particles render
# the kernels a check launches, by the names of their device events
CHECK_KERNELS = {"sobol": ("sobol_block",), "track": ("track_interaction", "track_transmittance"),
                 "traverse_forest": ("traverse",)}


def render(chip_smoke, here, dev, label: str, path: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from zyg_tpu_torch.render.driver import Driver

    spp, runs = None, 10
    if path == "caustics":
        # a Driver with its map baked; no chip_smoke report first
        kernels = chip_smoke.CAUSTICS_KERNELS
        drv = chip_smoke._caustics_driver(dev, spp=CAUSTICS_SPP)
        spp, runs = CAUSTICS_SPP, 3
    elif path == "particles":
        # the Driver's particle pass; no chip_smoke report first
        take, scene = chip_smoke._take_scene("cornell_particles.take", chip_smoke.PARTICLE_RES, 0,
                                             "cornell_particles")
        take.num_particles_per_pixel = PARTICLE_PASSES
        drv = Driver(take, scene, device=dev)
        spp, runs = PARTICLE_PASSES, 5
    elif path in ("sparks", "hairball"):
        title = f"{path} PTMIS"
        kernels, res, spp_take = ((chip_smoke.SPARKS_KERNELS, chip_smoke.SPARKS_RES,
                                   chip_smoke.SPARKS_SPP) if path == "sparks" else
                                  (chip_smoke.HAIRBALL_KERNELS, chip_smoke.HAIRBALL_RES,
                                   chip_smoke.HAIRBALL_SPP))
        take, scene = chip_smoke._take_scene(f"{path}.take", res, spp_take, title)
        runs = 1 if path in SLOW else 5
    elif path == "forest":
        title, kernels = "forest PTMIS", chip_smoke.FOREST_KERNELS
        take, scene = chip_smoke._take_scene("forest.take", chip_smoke.FOREST_RES,
                                             chip_smoke.FOREST_SPP, title)
        runs = 5
    elif path in ("smoke", "fire"):
        title = f"{path} PTMIS"
        kernels = chip_smoke.SMOKE_KERNELS if path == "smoke" else chip_smoke.FIRE_KERNELS
        res, spp_take = ((chip_smoke.SMOKE_RES, chip_smoke.SMOKE_SPP) if path == "smoke"
                         else (chip_smoke.FIRE_RES, chip_smoke.FIRE_SPP))
        take, scene = chip_smoke._take_scene(f"{path}.take", res, spp_take, title)
        runs = 3
    elif path == "cornell_filtered":
        title, kernels = "cornell_filtered 1080p", chip_smoke.FILTERED_KERNELS
        take, scene = chip_smoke._take_scene("cornell_filtered.take", (1920, 1080), 16, title)
    elif path == "cornell":
        title, kernels = "Cornell PTMIS", chip_smoke.CORNELL_KERNELS
        take, scene = chip_smoke._take_scene("cornell_ptmis.take", (1920, 1080), 16, title)
    elif path == "trefoil":
        title, kernels = "trefoil PTMIS", chip_smoke.MESH_KERNELS
        take, scene = chip_smoke._take_scene("trefoil.take", chip_smoke.MESH_RES,
                                             chip_smoke.MESH_SPP, title)
    elif path == "sunsky":
        title, kernels = "sunsky PTMIS", chip_smoke.TEXTURED_KERNELS
        take, scene = chip_smoke._take_scene("sunsky.take", (960, 540), 32, title)
    else:
        title, kernels = "textured trefoil PTMIS", chip_smoke.TEXTURED_KERNELS
        take, scene = chip_smoke._textured(dev, ci=False)
    if spp is None:
        chip_smoke.phase_main_path(dev, chip_smoke.phase_card(), title, take, scene, kernels)
        spp = take.num_samples_per_pixel
        drv = Driver(take, scene, device=dev)
    run = drv.render_particles if path == "particles" else drv.render_iterations
    slow = path in SLOW
    drv.start_frame()
    run(min(spp, SLOW_WARMUP_SPP) if slow else spp)
    torch.cuda.synchronize()
    times = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(runs):
        drv.start_frame()
        t0 = time.perf_counter()
        run(spp)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not slow:
        torch.cuda.reset_peak_memory_stats(dev)
        drv.start_frame()
        run(spp)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    prof_spp = min(spp, SLOW_PROFILE_SPP) if slow else spp
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv.start_frame()
        run(prof_spp)
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    # the raw device events: prof.events() takes minutes on caustics' ~400,000 launches
    for name, sec in here.device_events(prof):
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += sec
        row[1] += 1
    print(f"RENDER {label} {path} " + json.dumps({
        "render_s": times, "median_s": statistics.median(times), "best_s": min(times),
        "peak_bytes": peak, "profiled_spp": prof_spp,
        "busy_s": sum(v[0] for v in by_name.values()),
        "launches": sum(v[1] for v in by_name.values()), "by_name": by_name}), flush=True)
    if path in ("trefoil", "textured", "sunsky"):
        kernel = "surface" if path == "trefoil" else "surface_v2"
        print(f"LANES {label} {path} {here.lane_shares(drv, spp, kernel)}", flush=True)


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
        if name in RENDERS:
            render(chip_smoke, here, dev, label, name)
            continue
        check = getattr(chip_smoke, "check_" + name)
        print(f"AB {label} {name} {json.dumps(check(dev))}", flush=True)
        # the same yardstick for every checkout: the check once more under the
        # profiler (its own profiled timing, where it has one, left out: one
        # profiler at a time), and the median device time of the kernel's
        # launches there, most of them at the main path's width
        own = getattr(chip_smoke, "device_ms", None)
        # NaN, not 0: a check may divide by its device time
        chip_smoke.device_ms = lambda *args, **kwargs: float("nan")
        # the integer arguments of each launch but pointers, in launch order
        launched = []
        call = ops.Kernel.__call__

        def counted(self, *args):
            launched.append((self.name, tuple(a for a in args
                                              if isinstance(a, int) and abs(a) < 1 << 40)))
            return call(self, *args)

        ops.Kernel.__call__ = counted
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                check(dev)
        finally:
            chip_smoke.device_ms = own
            ops.Kernel.__call__ = call
        device = prof.events()
        for kname in CHECK_KERNELS.get(name, (name,)):
            kernel = f"{kname}_kernel"
            events = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in device
                            if e.device_type == DeviceType.CUDA and kernel in e.name)
            us = sorted(t for _, t in events)
            print(f"DEVICE {label} {kname} median {us[len(us) // 2] / 1e3:.5f} ms over {len(us)} "
                  "launches", flush=True)
            mine = [ints for k, ints in launched if k == kname]
            if len(mine) == len(events):
                runs: list = []
                for ints, (_, t) in zip(mine, events):
                    if not runs or runs[-1][0] != ints:
                        runs.append((ints, []))
                    runs[-1][1].append(t)
                for k, (ints, ts) in enumerate(runs):
                    ts = sorted(ts)
                    print(f"DEVICE {label} {kname} #{k} {list(ints)} median "
                          f"{ts[len(ts) // 2] / 1e3:.5f} ms over {len(ts)} launches", flush=True)
            else:
                print(f"DEVICE {label} {kname}: {len(events)} device events against {len(mine)} "
                      "launches: no runs by argument", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
