#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero on any failure):
 1. the card: CUDA must be available; prints nvidia-smi's name and power limit
 2. build: compiles zyg_tpu_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
    a source, all started together, and links them into one library in the
    gitignored zyg_tpu_torch/_build/; prints the build time, the
    per-kernel register/spill report, each kernel's static SASS
    instruction count (cuobjdump -sass) and the lanes one pass of the
    persistent shade, surface, surface_v2 and traverse grids covers
 3. each kernel, called through the wrapper its path calls, against its
    plain torch version on the card, at the main paths' shapes:
    sobol_block bit-exact (also at 0, 1, 31, 129 and one block + 1 lanes,
    with the shared-memory cost of its table reads counted on the data); accum (the per-pixel flush) with RGB within rtol 4e-6 and counts
    exact, at the Cornell path's own finish share and at all lanes; shade (Cornell) with lane
    lifecycles (alive, depth, ray count) exact, live-lane o/d/bxdf_pdf/
    mis_n/throughput within 1e-4/1e-5/1e-5/1e-5/5e-3 relative, and
    radiance column sums within rtol 2e-3; then on the bench trefoil at
    the mesh path's 921,600 lanes: isect over the scene's own reflection
    and shadow prop tables (pid/blocked exact, t/u/v within rtol 2e-5),
    and again on the sunsky and material_test tables (the latter at the
    material path's 786,432 lanes, its Sphere hits counted) and on
    portal.scene's at the portal path's 196,608 lanes (closest hits on
    the window and none on the hidden dome; shadow rays out through the
    shadow-invisible window to the sky unblocked, those toward the sun,
    which stands behind the room, blocked);
    surface with the shade rules plus the shadow rays and NEE values of
    the NEE lanes, and surface_v2 on the bench textured scene and again
    on the first bounce of a 1280x720 hero.take render (its analytic
    checker albedo and baked roughness per lane) and of a 512x384
    portal.take render (NEE candidates with the portal's windowed pdfs),
    each with
    the shares of its lanes dead on entry, missed, ended on a hit,
    reaching NEE, with an active NEE sample and with a failed BSDF sample,
    and a bound from the bytes each lane's lifecycle needs; traverse (and
    a rotated two-instance scene) with hit ids exact except at exact-t ties, t/u/v within rtol 2e-5 and any-hit
    exact; and both tracking walks (track_interaction, track_transmittance)
    on the smoke path's own glue inputs at its 518,400 lanes, scatter and
    absorb decisions exact and t/w/trv/tau within rtol 1e-5, with the
    lane-steps and collisions the lanes take and the share of thread-steps
    that would walk with one thread a lane (warp_efficiency), and track_interaction's
    emissive variant on the fire path's own glue inputs (518,400 lanes,
    fire.scene's grey medium and a spectral copy), t, w, decisions and
    emission bit-exact; the filtered flush (accum_filtered) on the Cornell
    path's 2,073,600 lanes at its finish share, Mitchell r2 and Blackman
    r1 shuffled and Mitchell r2 unshuffled, and in the scan path's
    clamp-to-edge mode on every lane, weights and RGB within rtol 1e-5 and
    1e-5 of the plane's largest magnitude, with its float4 atomics
    counted, both of its mappings (tap-major, lane-major) held to the same
    tolerance and timed in turns in each mode, beside the 128-byte lines
    one atomic instruction touches under each; traverse again on
    forest.take's 640x360 first-bounce lanes over its 144 static
    proc:sphere instances, hit records bit-exact, with
    the instance picks counted, and its motion-blur variant
    (traverse_anim, kAnim) on a moving copy of the forest the script
    writes (each instance a two-keyframe animation) at seeded shutter
    times: hit records against the plain walk, the share equal bit for
    bit and t's largest difference, any-hit exact; the photon gather
    (photon_gather) on caustics_photons.take's first-bounce lanes at its
    own 480x270 over the map baked on the card from its 200,000 paths, and
    on a seeded dense map whose buckets exceed the 64-photon cap (at caps
    64 and 4), each lane within 2e-3 of its largest channel plus 1e-6 of
    the batch's largest value, with the photon visits counted (and how
    they fall on threads: one lane's most, a thread-a-lane warp's serial
    trips); the
    lighttracer's camera splat (lt_splat) on the first bounce of a
    cornell_particles.take pass at its own 512x512 (every path's first
    vertex), connections exact and RGB within rtol 4e-6, with its
    candidates, connections and float4 atomics counted; the point walk
    (points) on sparks.take's 640x360 first-bounce lanes over its moving
    arena at seeded shutter times and held at shutter open, and the curve
    walk (curves) on hairball.take's 384x384 first-bounce lanes, closest
    and any-hit, bit-exact, with the node and leaf rows the walks visit
    counted; the traversal's deforming forms (traverse_deform,
    traverse_anim_deform) on the 921,600 1280x720 camera lanes of the
    491,520-triangle trefoil written as a two-frame .sub (slice_files) at
    seeded shutter times (0 and 1 on some lanes, a NaN ray), closest and
    any-hit, and over a moving instance of it, every hit record and flag
    bit-exact, timed beside the static form on the same lanes. Times each
    (median of runs, CUDA events; and its device time from the profiler,
    which leaves out the host's gaps between a short kernel's launches)
    beside its bound and, where one PyTorch call computes the same
    function, that call's time
 4. (every gate at GATE_SPP = 4 samples a pixel) a 128x128, 4 spp
    Cornell render on the card against the port's plain
    CPU render: mean energy within 1.5%, 4x4-downsampled RMSE within 6%
    of the mean (the JAX package's golden-gate statistics)
 4b. the same gate for the 30,720-triangle trefoil at 96x56, 4 spp,
    4c. for the CI textured trefoil under a baked sky dome at 96x56, 4 spp,
    4d. for examples/takes/sunsky.take (a Sky: baked dome + distant sun)
    at 96x56, 4 spp, depth 4, 4e. for two rectangle lamps under a
    constant dome (analytic props; NEE through the light tree) at 96x96,
    4 spp, and 4f. for examples/takes/material_test.take (glass through
    the general body, BSDF splitting) at 96x72, 4 spp, depth 6, 4g. for
    examples/takes/smoke.take (a density-grid medium through the tracking
    kernel) and examples/takes/volumes.take (a homogeneous medium beside
    glass) at 96x56, 4 spp, 4h. for examples/takes/fire.take (an emissive
    medium, its own volume light) at 96x56, 4 spp and fire.scene with a
    Rectangle lamp beside the fire (the light tree over a surface and a
    volume light) at 64x48, 4 spp, 4i. for examples/takes/hero.take
    (texture nodes: an analytic Checker albedo and a baked Mix/Noise
    roughness on the 491,520-triangle trefoil under a Sky) at 96x56, 4
    spp, depth 5, 4j. for examples/takes/portal.take (a Sky through a
    portal into a closed room) at 96x72, 4 spp, depth 8, and a canopy +
    IES scene the script writes (a Canopy with a PNG emission map beside
    a Rectangle lamp with an LM-63 profile) at 96x72, 4 spp, depth 6,
    4k. for cornell.take, cornell_filtered.take, cornell_ao.take,
    cornell_aov_normals.take and cornell_aovs.take at 96x96 (4 spp;
    aov_normals 1), with cornell_aovs' Albedo, Depth and
    ShadingNormal planes on 99 % of the pixels within 1e-4, 1e-5, 1e-4,
    4l. for examples/takes/forest.take (an Instancer of 144 proc:sphere
    instances under a Sky) at 96x56, 4 spp, and examples/takes/motion.take
    (a moving Sphere and a turning Cube) at 96x56, 4 spp, with and
    without motion: the card and the CPU agree that the Sphere is smeared
    (a strip across its path at least 2 % darker than without motion on
    both, the card's strip within 1 % of the CPU's), 4m. for
    examples/takes/caustics_photons.take (a glass sphere under a Sphere
    lamp, a photon map) at 96x56, 4 spp with 100,000 photon paths, bake
    and gather on each device, and a Sphere and a Disk lamp over a floor
    and a ball (kernel 6) at 96x64, 4 spp, 4n. for
    examples/takes/cornell_particles.take (the lighttracer alone, 0 spp)
    at 64x64, 4 passes, 4o. for examples/takes/sparks.take (a moving
    point cloud through kernel 6 and the point walk) at 96x56, 4 spp
    over its frame-0 shutter, and examples/takes/hairball.take (hair
    through the general body, the curve walk and the hair BSDF) at 96x96,
    4 spp, depth 4, 4p. for a 30,720-triangle trefoil as a two-frame .sub
    under trefoil.scene's lamp (kernel 5 and the deforming walk) and one
    lit by an emissive .glb panel of 2,048 triangles alone (kernel 6, the
    primitive light tree) at 96x56, 4 spp
 5. the Cornell main path: the CLI on examples/takes/cornell_ptmis.take at
    its own 512x512, then the Driver at 1920x1080 and 16 spp; the
    sobol_block, shade and accum kernels must each have launched, the image
    must be finite with a positive mean; one more 1080p render under
    torch.profiler gives the device time by kernel, the glue's launches and
    the device's busy share; one more gives the peak device memory and the
    share of launched lanes each flush finishes
 5b. the mesh main path: the CLI on examples/takes/trefoil.take (640x360,
    8 spp), then the Driver at 1280x720 and 4 spp over the 491,520-triangle
    trefoil; sobol_block, isect, surface, traverse and accum must each have
    launched; the same report and profile
 5c. the textured main path: bench.py's textured trefoil (512^2 checker
    albedo and noise roughness textures, a grey ground, a 256x128 Preetham
    sky on a Dome light) through the Driver at 1280x720, 4 spp, depth 4;
    sobol_block, isect, surface_v2, traverse and accum must each have
    launched; the same report and profile
 5d. the sunsky main path: the CLI on examples/takes/sunsky.take at its
    own 960x540, 32 spp, PTMIS depth 8, AgX, then the Driver at the same
    size; sobol_block, isect, surface_v2, traverse and accum must each
    have launched; the same report and profile, and the lifecycle shares
    of kernel 6's lanes in the first bounce and over all its launches
 5e. the material main path: the CLI on a copy of
    examples/takes/material_test.take at CLI_CUT_SPP (4; its own
    1024x768), then the Driver at 1024x768, MATERIAL_SPP (8; half of
    bench.py::bench_material's work), depth 10, through the general body
    (torch) around sobol_block, isect and accum, which must each have
    launched; the same report and profile, the iterations over all chunks
    (isect closest launches) and the share of lanes that resume a parked
    split branch
 5f. the smoke main path: the CLI on a copy of examples/takes/smoke.take
    at CLI_CUT_SPP (4; its own 960x540, PTMIS depth 24 / volume 128; the take's 64
    spp took 73-87 s), then the Driver at the same size with 8 spp after
    a warm-up (bench.py::bench_volume's
    work: two tiles of 262,144 and 256,256 pixels, one 8-sample chunk),
    through the general body around sobol_block, isect, track_interaction,
    track_transmittance and accum, which must each have launched; the
    same report and profile, with the iterations over all chunks and tiles
 5g. the fire main path: the CLI on a copy of examples/takes/fire.take at
    CLI_CUT_SPP (4; its own 960x540, PTMIS depth 16 / volume 128; the take's 64 spp
    would take ~70-120 s), then the Driver at the same size with 8 spp
    after a warm-up, through the general body around sobol_block,
    isect, the emissive track_interaction, track_transmittance and accum,
    which must each have launched; the same report and profile
 5h. the hero main path: the CLI on examples/takes/hero.take at its own
    1280x720, 16 spp, PTMIS depth 5, ACES, then the Driver at the same
    size; sobol_block, isect, surface_v2, traverse and accum must each
    have launched; the same report and profile, and kernel 6's lane shares
 5i. the portal main path: the CLI on a copy of examples/takes/portal.take
    at CLI_CUT_SPP (4; its own 512x384, PTMIS depth 8), then the Driver
    at the same size and PORTAL_SPP (16);
    sobol_block, isect, surface_v2 and accum must each have launched; the
    same report and profile, kernel 6's lane shares, and the portal
    sampler's calls in a render of SLOW_PROFILE_SPP (2) spp with its
    device time and launches a call by kernel name
 5j. the integrator and sensor variants on Cornell, each take at its own
    size: the CLI (cornell_filtered.take to .hdr, cornell_aov_normals.take
    and cornell_aovs.take to .exr, whose output and AOV companion files
    are read back with the port's read_exr), then the Driver and the
    same report: cornell.take (PT, 512x512, SCAN_CUT_SPP = 4 spp through
    the CLI and the Driver: the per-sample scan path around sobol_block
    and isect), cornell_filtered.take (Mitchell,
    512x512, 16 spp: the persistent path through shade and the filtered
    flush, accum_filtered), cornell_ao.take and cornell_aov_normals.take
    (the AOV integrator, 512x512 at 16 and 1 spp), cornell_aovs.take
    (256x256, 8 spp: an unshuffled dispatch with sensor AOVs through the
    general body and the box flush); then cornell_filtered at 1920x1080
    and 16 spp beside phase 5's box Cornell figure
 5k. the instancer and motion main paths at their takes' own sizes: the
    CLI on examples/takes/forest.take (640x360, 16 spp, PTMIS depth 8)
    and examples/takes/motion.take (640x360, 32 spp, depth 6, ACES), then
    the Driver at the same sizes; forest through sobol_block, isect,
    surface_v2, traverse and accum, motion through sobol_block, isect,
    surface_v2 and accum, which must each have launched; the same report
    and profile and kernel 6's lane shares; then the CLI on motion.take
    with -f 0 -n 2: both frames written and different
 5l. the photon-map main path: the CLI on a copy of
    examples/takes/caustics_photons.take at CLI_CUT_SPP (4; its own
    480x270, PTMIS depth 16 with its 200,000 photon paths), then the
    Driver at the same size and CAUSTICS_MAIN_SPP (8: one chunk) with the
    bake timed on its own, through the general body
    around sobol_block, isect, photon_gather and accum, which must each
    have launched; the same report and profile
 5m. the lighttracer main path: one pass of
    examples/takes/cornell_particles.take at its own 512x512 timed, the
    CLI on the take (64 particles a pixel; a copy at 16 when one pass
    times 64 would take over PARTICLE_CLI_BUDGET_S = 20 s, said in the
    log), then the Driver's
    particle pass at 512x512 and 8 passes through sobol_block, isect and
    lt_splat, which must each have launched: time, rays, Mrays/s, peak
    memory and launches, the first 2 passes profiled (busy share, glue
    launches a bounce, the kernels' device time)
 5n. the point-cloud and hair main paths, first of the main paths: the
    CLI on examples/takes/sparks.take (640x360, 32 spp, PTMIS depth 4, a
    1/24 s shutter) and examples/takes/hairball.take (384x384, 32 spp,
    depth 8), then the Driver at the same sizes; sparks through
    sobol_block, isect, surface_v2, points and accum (kernel 6's lane
    shares), hairball through the general body around sobol_block,
    isect, curves and accum, which must each have launched; the same
    report and profile
 5o. the mesh-file paths, after 5n: the CLI on trefoil.take over each
    scene slice_files writes (1280x720, 4 spp, depth 4), then the Driver
    at the same size, the load with its BVH build and primitive light
    tree timed: the deforming trefoil-512x480 .sub under the lamp through
    sobol_block, isect, surface, traverse_deform and accum, and the
    trefoil-512x480 over a floor lit by the emissive .glb panel alone
    through sobol_block, isect, surface_v2, traverse and accum, which
    must each have launched; the same report and profile
 6. one bounce of the mesh bounce (kernel 5) against one of the general
    bounce (kernel 6) on the bench trefoil's 921,600 lanes, both built
    directly, timed in turns (CUDA events, medians)
Each main path is driven with the launch counts set to 0 just before it
and read just after. `[clock]` lines give the seconds each phase took.
The line before the last is the JSON kernel report; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import math
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
    # not TPU kernels: the JAX package's tracking walks are XLA while loops
    "track_interaction": "zyg_tpu/render/integrator/volume.py:273",
    "track_transmittance": "zyg_tpu/render/integrator/volume.py:631",
    # the filtered form of kernel 4: the column flush with the filtered
    # unpermute and drain splats (zyg_tpu/render/integrator/ptmis.py:
    # 1465-1528) and the unshuffled rolled splat (:1359-1378)
    "accum_filtered": "zyg_tpu/ops/accum.py:31",
    # the traversal's motion-blur variant: the JAX walk's per-lane slerp of
    # a moving instance's transform (zyg_tpu/scene/trimesh.py:1145-1155)
    "traverse_anim": "zyg_tpu/scene/trimesh.py:1053",
    # not a TPU kernel: the JAX package's photon gather is an XLA fori_loop
    "photon_gather": "zyg_tpu/render/integrator/photon.py:219",
    # not a TPU kernel: the JAX lighttracer's BSDF toward the camera and its
    # scatter-add into the splat image (an XLA scatter)
    "lt_splat": "zyg_tpu/render/integrator/lighttracer.py:287",
    # not TPU kernels: the JAX package's point and curve walks are XLA
    # while loops
    "points": "zyg_tpu/scene/points.py:205",
    "curves": "zyg_tpu/scene/curves.py:290",
    # the deforming leaf of the walk (XLA), static table and moving table
    "traverse_deform": "zyg_tpu/scene/trimesh.py:894",
    "traverse_anim_deform": "zyg_tpu/scene/trimesh.py:894",
}
SOURCES = {
    "sobol_block": "zyg_tpu_torch/csrc/sobol_block.cu",
    "isect": "zyg_tpu_torch/csrc/isect.cu",
    "shade": "zyg_tpu_torch/csrc/shade.cu",
    "accum": "zyg_tpu_torch/csrc/accum.cu",
    "surface": "zyg_tpu_torch/csrc/surface.cu",
    "surface_v2": "zyg_tpu_torch/csrc/surface_v2.cu",
    "traverse": "zyg_tpu_torch/csrc/traverse.cu",
    "track_interaction": "zyg_tpu_torch/csrc/track.cu",
    "track_transmittance": "zyg_tpu_torch/csrc/track.cu",
    "accum_filtered": "zyg_tpu_torch/csrc/accum.cu",
    "traverse_anim": "zyg_tpu_torch/csrc/traverse.cu",
    "photon_gather": "zyg_tpu_torch/csrc/photon.cu",
    "lt_splat": "zyg_tpu_torch/csrc/lt_splat.cu",
    "points": "zyg_tpu_torch/csrc/points.cu",
    "curves": "zyg_tpu_torch/csrc/curves.cu",
    "traverse_deform": "zyg_tpu_torch/csrc/traverse.cu",
    "traverse_anim_deform": "zyg_tpu_torch/csrc/traverse.cu",
}
CORNELL_KERNELS = ("sobol_block", "shade", "accum")
# sobol_block's launch shapes besides the checks' width: 513 is one
# 512-thread block and a lane (each block fills its own table)
SOBOL_SHAPES = (0, 1, 31, 129, 513)
MESH_KERNELS = ("sobol_block", "isect", "surface", "traverse", "accum")
TEXTURED_KERNELS = ("sobol_block", "isect", "surface_v2", "traverse", "accum")
SUNSKY_KERNELS = TEXTURED_KERNELS
SUNSKY_RES = (960, 540)  # sunsky.take's own size: 32 spp, PTMIS depth 8
N_SKY = SUNSKY_RES[0] * SUNSKY_RES[1]
# the material path: the general body (torch) around isect, sobol_block
# and accum, at material_test.take's own 1024x768 with bench_material's 16
# spp and depth 10
MATERIAL_KERNELS = ("sobol_block", "isect", "accum")
MATERIAL_RES = (1024, 768)
MATERIAL_SPP = 8  # the Driver render (bench_material's 16: 4.8-8.0 s a render on an H100)
MATERIAL_DEPTH = 10
N_MATERIAL = MATERIAL_RES[0] * MATERIAL_RES[1]
# the smoke path: the general body around sobol_block, isect, track and
# accum, at smoke.take's own 960x540, PTMIS depth 24 / volume 128, timed as
# bench.py::bench_volume times it (8 spp after a warm-up)
SMOKE_KERNELS = ("sobol_block", "isect", "track_interaction", "track_transmittance", "accum")
SMOKE_RES = (960, 540)
SMOKE_SPP = 8
SMOKE_DEPTH = 24
SMOKE_DEPTH_VOLUME = 128
N_SMOKE = SMOKE_RES[0] * SMOKE_RES[1]
# the fire path: smoke's kernels with the walk's emissive variant and volume
# lights in NEE, at fire.take's own 960x540, PTMIS depth 16 / volume 128,
# timed as smoke is (8 spp after a warm-up)
FIRE_KERNELS = SMOKE_KERNELS
FIRE_RES = (960, 540)
FIRE_SPP = 8
FIRE_DEPTH = 16
N_FIRE = FIRE_RES[0] * FIRE_RES[1]
# the hero path: texture nodes through kernel 6's glue, at hero.take's own
# 1280x720, 16 spp, PTMIS depth 5
HERO_KERNELS = TEXTURED_KERNELS
HERO_RES = (1280, 720)
HERO_SPP = 16
# the portal path: a Sky seen through a portal from a closed room of
# analytic props, through kernel 6's glue (no mesh: no traversal), at
# portal.take's own 512x384, 32 spp, PTMIS depth 8
PORTAL_KERNELS = ("sobol_block", "isect", "surface_v2", "accum")
PORTAL_RES = (512, 384)
PORTAL_SPP = 16  # the Driver render (the take's own 32: 7.7-14.2 s a render on an H100)
N_PORTAL = PORTAL_RES[0] * PORTAL_RES[1]
# the integrator and sensor variants on Cornell, each at its take's own
# size: (resolution, spp, the kernels its main path launches). PT and AOV
# run the per-sample scan path (no flush kernel: box samples add in
# torch); cornell_filtered the persistent path through the filtered flush;
# cornell_aovs an unshuffled persistent dispatch through the general body
SLICE_TAKES = {
    "cornell.take": ((512, 512), 16, ("sobol_block", "isect")),
    "cornell_filtered.take": ((512, 512), 16, ("sobol_block", "shade", "accum_filtered")),
    "cornell_ao.take": ((512, 512), 16, ("sobol_block", "isect")),
    "cornell_aov_normals.take": ((512, 512), 1, ("sobol_block", "isect")),
    "cornell_aovs.take": ((256, 256), 8, ("sobol_block", "isect", "accum")),
}
FILTERED_KERNELS = SLICE_TAKES["cornell_filtered.take"][2]
# the instancer and motion paths, at their takes' own sizes: forest (144
# proc:sphere instances under a Sky; the traversal walks every instance
# box a round) and motion (a moving Sphere and Cube over a floor under a
# Dome; the moving props take the torch pass, so no traversal)
FOREST_KERNELS = ("sobol_block", "isect", "surface_v2", "traverse", "accum")
FOREST_RES = (640, 360)
FOREST_SPP = 16
N_FOREST = FOREST_RES[0] * FOREST_RES[1]
MOTION_KERNELS = ("sobol_block", "isect", "surface_v2", "accum")
MOTION_RES = (640, 360)
MOTION_SPP = 32
# the photon-map path: caustics_photons.take's own 480x270, 32 spp, PTMIS
# depth 16, 200,000 photon paths of up to 4 bounces, search radius 0.05;
# the glass sphere and the map send it to the general body (torch) around
# sobol_block, isect, the photon gather and accum
CAUSTICS_KERNELS = ("sobol_block", "isect", "photon_gather", "accum")
CAUSTICS_RES = (480, 270)
CAUSTICS_SPP = 32
N_CAUSTICS = CAUSTICS_RES[0] * CAUSTICS_RES[1]
# the lighttracer path: cornell_particles.take's own 512x512 and 64
# particles a pixel (W*H light paths a pass, up to 8 bounces, each vertex
# connected to the camera), a host loop around sobol_block, isect and the
# camera splat; the CLI renders a 16-pass copy when one pass times 64
# would take over PARTICLE_CLI_BUDGET_S; the Driver renders 8 passes and
# profiles 2
PARTICLE_KERNELS = ("sobol_block", "isect", "lt_splat")
PARTICLE_RES = (512, 512)
PARTICLE_PPP = 64
PARTICLE_CLI_BUDGET_S = 20.0
PARTICLE_CLI_CUT_PPP = 16
PARTICLE_RENDER_PASSES = 8
PARTICLE_PROFILE_PASSES = 2
# the point-cloud and hair paths at their takes' own sizes: sparks.take
# (640x360, 32 spp, PTMIS depth 4, a 1/24 s shutter with motion blur)
# through kernel 6 with the point walk, hairball.take (384x384, 32 spp,
# depth 8) through the general body with the curve walk
SPARKS_KERNELS = ("sobol_block", "isect", "surface_v2", "points", "accum")
SPARKS_RES = (640, 360)
SPARKS_SPP = 32
HAIRBALL_KERNELS = ("sobol_block", "isect", "curves", "accum")
HAIRBALL_RES = (384, 384)
HAIRBALL_SPP = 32
# the mesh-file paths, at bench_mesh's 1280x720, 4 spp: the deforming
# trefoil from a two-frame .sub under trefoil.scene's lamp (kernel 5) and
# the trefoil lit by an emissive glTF panel alone (kernel 6)
DEFORM_KERNELS = ("sobol_block", "isect", "surface", "traverse_deform", "accum")
GLB_KERNELS = ("sobol_block", "isect", "surface_v2", "traverse", "accum")
GLB_PANEL = 33  # the panel's grid: 2 x 32^2 = 2,048 emissive triangles (a primitive tree)

# the least time the card could take: bytes over the memory rate or
# operations over the float32 (non-tensor) peak, NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# integer issue: 64 INT32 lanes a clock on each of 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 16.7e12
# a main path's render time above which it is timed best of 2, not 3, and
# profiled over its first chunk of at most SLOW_PROFILE_SPP samples
SLOW_RENDER_S = 1.5
SLOW_PROFILE_SPP = 2
# samples of a main path's warm-up render on the persistent path (the same
# code and buffers as a whole chunk; one sample on the scan path)
WARMUP_SPP = 2
# the script's clock past which a main path is timed once, with no
# profile and no further render: a host that runs ~1.3x slower than most
# then still finishes well inside the 1200 s limit
SCRIPT_BUDGET_S = 800.0
# samples a pixel of the card-against-CPU gates (phases 4-4o): the card and
# the CPU trace the same sample sequences, so the gate's statistics hold a
# wrong image at 4 as at 16 (the CPU renders launch no kernel and took a
# quarter of the script's time at 8-16)
GATE_SPP = 4
# a main path's render time above which it is timed once
VERY_SLOW_RENDER_S = 5.0
# samples a pixel of the main paths the script renders at fewer than their
# takes' own: the CLI on copies of portal.take, material_test.take,
# smoke.take, fire.take and caustics_photons.take at CLI_CUT_SPP (their 32
# and 64 spp took 15-87 s through the CLI on an H100), cornell.take's per-sample scan
# path at SCAN_CUT_SPP
CLI_CUT_SPP = 4
SCAN_CUT_SPP = 4
CAUSTICS_MAIN_SPP = 8  # the caustics Driver render: one chunk
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
OPS_SURFACE_LANE = 2500  # the mesh bounce between the traversals, a lane that reaches NEE
OPS_ENDED_LANE = 40  # a hit that ends before NEE: the emission's MIS weight and roulette
# the general shade core: two substitute lobe evaluations (~420 each: six
# energy-fit chains of 49 or 7 fused steps), the VNDF and cosine samples,
# MIS, roulette, merge and the ray offset
OPS_SURFACE_V2_LANE = 1200
OPS_NODE = 8 * 30  # one wide node: 8 slab tests, keys, nearest child, push
OPS_LEAF = 12 * 55  # one leaf: 12 Moller-Trumbore tests and the min
OPS_INSTANCE = 60  # one instance: AABB entry, pick, ray to object space
OPS_BOX = 20  # one instance box of a pick: six slab products, min/max, the order test
# a moving instance's transform: the quaternion dot and flip, acos, three
# sines, two divisions, eight fused steps, the norm, the lerps
OPS_SLERP = 60
# track: a step's two or one counter hashes (~20 integer operations each),
# the key's re-hash, the row index and the three cell walls, the free
# flight's log and division; a tentative collision adds the jitter hash,
# the transform and the voxel index
OPS_TRACK_STEP = 150
OPS_TRACK_COLLISION = 80
# the filtered flush: one filter weight (Blackman's two cosines and its
# sum, or Mitchell's cubic), and one tap (its pixel, the bounds, the
# weights' product, three multiplies and the float4 add)
OPS_FILTER_EVAL = 20
OPS_FILTER_TAP = 12
# the photon gather: an active lane's 8 cells' bounds, repeats and hashes
# (6 floors of 3, 8 cells of 3 selects, 6 hash operations, 2 bounds and the
# cap); a lane with a photon in range, its material and wo terms (three
# 49-step and two 7-step energy-fit chains, the lobe weights); a visit's
# distance and cosine tests (two dot products, the difference, two
# compares); a visit in range adds the cone weight, the substitute lobes
# toward the photon (two 49-step chains, the half vector, GGX, Schlick,
# the sums), the division by the cosine and the sum
OPS_PHOTON_CELLS = 110
OPS_PHOTON_TERMS = 150
OPS_PHOTON_VISIT = 16
OPS_PHOTON_EVAL = 230
# the camera splat: a candidate lane's material and wo terms and one
# substitute evaluation toward the camera (the gather's two counts), the
# max and the test; an adding lane's three products of three
OPS_LT_SPLAT_LANE = OPS_PHOTON_TERMS + OPS_PHOTON_EVAL + 4
OPS_LT_SPLAT_ADD = 6
# the point and curve walks: a binary node's slab test (six differences and
# products, six min/max, four compares); a leaf of 4 points (each: the
# lerp's 9, the offset, two fused dot chains, the discriminant's 4, the
# root, two divisions, the range tests and selects, ~45); a leaf of 4
# round-cone segments (each: 9 differences, 7 fused dot chains, the body's
# 12 fused steps and its root and division, the caps' two roots, the
# range tests, mins and the axial parameter, ~110)
OPS_NODE2 = 25
OPS_POINT_LEAF = 4 * 45
OPS_DEFORM_LEAF = 108  # a deforming leaf's lerp: one fma a float of its row
OPS_CURVE_LEAF = 4 * 110


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


_CLOCK = [time.perf_counter()] * 2  # the script's start, the last mark


def mark(label: str) -> None:
    """Log the seconds since the last mark and since the script started:
    where the script's time limit goes."""
    now = time.perf_counter()
    log(f"[clock] {label}: {now - _CLOCK[1]:.1f} s (script {now - _CLOCK[0]:.1f} s)")
    _CLOCK[1] = now


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
    device's idle gaps while the host issues a short kernel's launches. A
    profiled window without the kernel's events is logged, with the count
    of device events it holds, and profiled again, up to three windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = [e.time_range.elapsed_us() for e in events if f"{kernel}_kernel" in e.name]
        if us:
            return sum(us) / len(us) / 1e3
        log(f"device_ms: {kernel}: profiled window {window} holds {len(events)} device events, "
            f"none of {kernel}_kernel")
    raise AssertionError(f"{kernel}: the profiler recorded no device time in three windows")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(out)
    import torch

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    return out


def sass_counts(so_path: str) -> dict:
    """Static SASS instructions of each kernel in a built library (NOPs not
    counted), from `cuobjdump -sass`; a template's instantiations apart,
    as name<its integer and bool arguments> (accum_filtered<F,R,tap_major>)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    cur = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            # mangled names hold the kernel's name after its length
            cur = next((k for k in SOURCES if f"{len(k) + 7}{k}_kernel" in m.group(1)), m.group(1))
            t = re.search(rf"{len(cur) + 7}{cur}_kernelI((?:L[a-z]\d+E)+)E", m.group(1))
            if t:
                cur += "<" + ",".join(re.findall(r"L[a-z](\d+)E", t.group(1))) + ">"
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
    for name in ("shade", "surface", "surface_v2", "traverse", "traverse_anim", "traverse_deform",
                 "traverse_anim_deform", "points", "curves"):
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
    check_isect_sunsky(dev)
    check_isect_material(dev)
    check_isect_portal(dev)
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


def _sky_lanes(scene, n, dev, seed=6):
    """Lanes of the sunsky path's analytic hit tests: camera rays of
    sunsky.take on the primary half, rays from above the ground in random
    directions on the other, every 8th lane aimed into the sun's disc;
    shadow rays from the ground and the cube's height toward the sun
    (tmax short of RAY_MAX_T, as NEE gives infinite lights) or to a point
    within 4 units. 10 % of the lanes are dead (tmax 0)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.ops.surface_v2 import _INF_SHADOW_TMAX
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    sun = int(scene.lights.prop[1])
    rot = scene.prop_rot[sun].cpu().numpy().astype(np.float64)
    radius = float(scene.prop_scale[sun, 0])
    rng = np.random.default_rng(seed)
    prim = rng.random(n) < 0.5
    alive = rng.random(n) < 0.9
    disc = rng.uniform(-0.55, 0.55, (n, 2)) * radius
    to_sun = -rot[2] + disc[:, 0:1] * rot[0] + disc[:, 1:2] * rot[1]
    up = rng.uniform([-4.0, 0.05, -4.0], [4.0, 2.5, 4.0], (n, 3))
    target = rng.uniform([-3.0, 0.0, -3.0], [3.5, 2.0, 3.0], (n, 3))
    o = np.where(prim[:, None], np.array([-3.5, 2.0, -5.5]), up)
    d = np.where(prim[:, None], target - o, rng.normal(size=(n, 3)))
    d = np.where((np.arange(n) % 8 == 0)[:, None], to_sun, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(alive, RAY_MAX_T, 0.0)
    so = rng.uniform([-4.0, 0.0, -4.0], [4.0, 1.0, 4.0], (n, 3))
    toward = rng.random(n) < 0.5
    sd = np.where(toward[:, None], to_sun, rng.normal(size=(n, 3)))
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    smax = np.where(alive, np.where(toward, _INF_SHADOW_TMAX, rng.uniform(0.1, 4.0, n)), 0.0)

    def t(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x if x.dtype == bool else x.astype(np.float32)).to(dev)

    return tuple(t(x) for x in (o, d, tmax, prim, so, sd, smax))


def check_isect_sunsky(dev) -> None:
    """isect over the sunsky scene's own reflection and shadow prop tables
    (the rules of check_isect) at the path's 518,400 lanes; its Distant,
    Cube, Dome and Rectangle branches must each be hit."""
    import torch
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.types import ShapeType

    scene = load_scene_file(os.path.join(REPO, "examples/scenes/sunsky.scene"), dev)
    refl, shadow = isect.prop_table(scene, "reflection"), isect.prop_table(scene, "shadow")
    o, d, tmax, prim, so, sd, smax = _sky_lanes(scene, N_SKY, dev)
    k = isect.closest_props(refl, o, d, 0.0, tmax, prim)
    p = isect.isect_plain(refl.kinds, refl.table, refl.ids, o, d, 0.0, tmax, prim, False)
    kb = isect.anyhit_props(shadow, so, sd, 0.0, smax)
    pb = isect.isect_plain(shadow.kinds, shadow.table, shadow.ids, so, sd, 0.0, smax, None, True)
    torch.cuda.synchronize()
    if not torch.equal(k[1], p[1]):
        raise AssertionError(f"isect (sunsky): {int((k[1] != p[1]).sum())} prop ids differ")
    if not torch.equal(kb, pb):
        raise AssertionError(f"isect (sunsky): {int((kb != pb).sum())} any-hit results differ")
    for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    kinds = scene.prop_shape[torch.clamp(p[1], min=0).long()]
    hits = {st.name: int(((p[1] >= 0) & (kinds == int(st))).sum())
            for st in (ShapeType.DISTANT, ShapeType.CUBE, ShapeType.DOME, ShapeType.RECTANGLE)}
    if min(hits.values()) <= 0:
        raise AssertionError(f"isect (sunsky): a branch was never hit: {hits}")
    ms = time_ms(lambda: isect.closest_props(refl, o, d, 0.0, tmax, prim), 20)
    log(f"isect (sunsky tables {refl.kinds} / shadow {shadow.kinds}): exact on {N_SKY} lanes; "
        f"hits by shape {hits}; {int(pb.sum())} shadow rays blocked; closest {ms:.4f} ms")


def _portal(dev):
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(os.path.join(REPO, "examples/scenes/portal.scene"), dev)


def _portal_lanes(scene, n, dev, seed=17):
    """Lanes of the portal path's analytic hit tests: camera rays of
    portal.take on the primary half; on the other, rays from points in
    the room, every third toward a point of the window, every third along
    the sun's direction, the rest random; shadow rays from room points, a
    third toward the sun (behind the room: the walls block them), a third
    out through the window toward the sky (both with tmax short of
    RAY_MAX_T, as NEE gives infinite lights), a third in random
    directions up to 4 units. 10 % of the lanes are dead (tmax 0)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.ops.surface_v2 import _INF_SHADOW_TMAX
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    to_sun = -scene.prop_rot[int(scene.lights.prop[0])][2].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    prim = rng.random(n) < 0.5
    alive = rng.random(n) < 0.9
    room = rng.uniform([-1.8, 0.1, -1.8], [1.8, 2.9, 1.8], (n, 3))
    window = np.array([0.0, 1.5, 2.0]) + rng.uniform([-0.65, -0.65, 0.0], [0.65, 0.65, 0.0], (n, 3))
    cam = np.array([-0.6, 1.4, -1.6])
    o = np.where(prim[:, None], cam, room)
    d = rng.normal(size=(n, 3)) + np.where(prim[:, None], [0.3, 0.0, 1.0], 0.0)
    third = np.arange(n) % 3
    d = np.where(((third == 0) & ~prim)[:, None], window - room, d)
    d = np.where(((third == 1) & ~prim)[:, None], to_sun, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(alive, RAY_MAX_T, 0.0)
    so = rng.uniform([-1.8, 0.1, -1.8], [1.8, 2.9, 1.8], (n, 3))
    kind = rng.integers(0, 3, n)
    window = np.array([0.0, 1.5, 2.0]) + rng.uniform([-0.65, -0.65, 0.0], [0.65, 0.65, 0.0], (n, 3))
    sd = np.where((kind == 0)[:, None], to_sun,
                  np.where((kind == 1)[:, None], window - so, rng.normal(size=(n, 3))))
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    smax = np.where(alive, np.where(kind < 2, _INF_SHADOW_TMAX, rng.uniform(0.1, 4.0, n)), 0.0)

    def t(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x if x.dtype == bool else x.astype(np.float32)).to(dev)

    return tuple(t(x) for x in (o, d, tmax, prim, so, sd, smax))


def check_isect_portal(dev) -> dict:
    """isect over portal.scene's own reflection and shadow prop tables (the
    rules of check_isect) at the portal path's 196,608 lanes: closest hits
    land on the portal's window and never on the hidden dome, and shadow
    rays pass the shadow-invisible window (and the hidden dome) toward the
    sky through the window while the walls block the rest (the sun stands
    behind the room); prop ids and any-hits exact."""
    import torch
    from zyg_tpu_torch.ops import isect

    scene = _portal(dev)
    ((_, pp),) = scene.portals.keys()
    refl, shadow = isect.prop_table(scene, "reflection"), isect.prop_table(scene, "shadow")
    o, d, tmax, prim, so, sd, smax = _portal_lanes(scene, N_PORTAL, dev)
    k = isect.closest_props(refl, o, d, 0.0, tmax, prim)
    p = isect.isect_plain(refl.kinds, refl.table, refl.ids, o, d, 0.0, tmax, prim, False)
    kb = isect.anyhit_props(shadow, so, sd, 0.0, smax)
    pb = isect.isect_plain(shadow.kinds, shadow.table, shadow.ids, so, sd, 0.0, smax, None, True)
    torch.cuda.synchronize()
    if not torch.equal(k[1], p[1]):
        raise AssertionError(f"isect (portal): {int((k[1] != p[1]).sum())} prop ids differ")
    if not torch.equal(kb, pb):
        raise AssertionError(f"isect (portal): {int((kb != pb).sum())} any-hit results differ")
    err = 0.0
    for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
        err = max(err, float((a - b).abs().max()))
    on_portal = int((p[1] == pp).sum())
    on_dome = int((p[1] == 0).sum())
    passed = int(((smax > 0.0) & ~pb).sum())
    to_sky = int(((smax > 1e9) & ~pb).sum())  # infinite rays out through the window
    if on_portal <= 0 or on_dome != 0 or to_sky <= 0 or int(pb.sum()) <= 0:
        raise AssertionError(f"isect (portal): {on_portal} hits on the window, {on_dome} on the "
                             f"hidden dome, {to_sky} shadow rays to the sky through the window, "
                             f"{int(pb.sum())} blocked")
    ms = time_ms(lambda: isect.closest_props(refl, o, d, 0.0, tmax, prim), 20)
    anyhit = time_ms(lambda: isect.anyhit_props(shadow, so, sd, 0.0, smax), 20)
    log(f"isect (portal tables {refl.kinds} / shadow {shadow.kinds}): exact on {N_PORTAL} lanes; "
        f"{on_portal} closest hits on the window (prop {pp}), none on the hidden dome; "
        f"{passed} shadow rays unblocked ({to_sky} out through the window to the sky), "
        f"{int(pb.sum())} blocked; closest {ms:.4f} ms, any-hit {anyhit:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "anyhit_ms": anyhit}


def _material(dev):
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(os.path.join(REPO, "examples/scenes/material_test.scene"), dev)


def _smoke(dev):
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(os.path.join(REPO, "examples/scenes/smoke.scene"), dev)


def fire_root(variant: str = "fire") -> dict:
    """examples/scenes/fire.scene as a dict: "fire" as it is (a grey
    emissive Volumetric Cube over a floor, the only light); "spectral" with
    a non-grey attenuation colour (the walk's spectral estimator);
    "lamp" with a Rectangle lamp above the floor beside it (two finite
    lights: the light tree selects between the lamp and the volume)."""
    with open(os.path.join(REPO, "examples/scenes/fire.scene")) as f:
        root = json.load(f)
    if variant == "spectral":
        root["materials"][1]["rendering"]["Volumetric"]["attenuation_color"] = [0.5, 0.6, 0.7]
    elif variant == "lamp":
        root["materials"].append({"name": "lamp", "rendering": {"Light": {
            "emittance": {"value": 6.0}}}})
        root["entities"].append({
            "type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"],
            "transformation": {"position": [-2.5, 3.5, 0.5], "rotation": [-90, 0, 0],
                               "scale": [1.2, 1.2, 1]}})
    return root


def _fire(dev, variant: str = "fire"):
    from zyg_tpu_torch.scene.loader import load_scene_dict

    return load_scene_dict(fire_root(variant), dev)


def _material_lanes(scene, n, dev, seed=8):
    """Lanes of the material path's analytic hit tests: camera rays of
    material_test.take on the primary half, rays from above the floor in
    random directions on the other, every 4th lane aimed at one of the
    five spheres; shadow rays from the floor and the spheres' height to a
    point on the lamp or, on half the lanes, toward the dome (tmax short
    of RAY_MAX_T, as NEE gives infinite lights). 10 % of the lanes are
    dead (tmax 0)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.ops.surface_v2 import _INF_SHADOW_TMAX
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    centers = np.array([[-3.0, 0.75, 0], [-1.5, 0.75, 1.8], [0, 0.75, 0], [1.5, 0.75, 1.8],
                        [3.0, 0.75, 0]])
    lamp = int(scene.lights.prop[0])
    rot = scene.prop_rot[lamp].cpu().numpy().astype(np.float64)
    pos = scene.prop_pos[lamp].cpu().numpy().astype(np.float64)
    scale = scene.prop_scale[lamp].cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(seed)
    prim = rng.random(n) < 0.5
    alive = rng.random(n) < 0.9
    up = rng.uniform([-5.0, 0.05, -3.0], [5.0, 2.5, 4.0], (n, 3))
    target = rng.uniform([-4.5, 0.0, -2.0], [4.5, 2.0, 3.5], (n, 3))
    o = np.where(prim[:, None], np.array([0.0, 2.2, -7.5]), up)
    sphere = centers[rng.integers(0, 5, n)] + rng.normal(size=(n, 3)) * 0.4
    d = np.where(prim[:, None], target - o, rng.normal(size=(n, 3)))
    d = np.where((np.arange(n) % 4 == 0)[:, None], sphere - o, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(alive, RAY_MAX_T, 0.0)
    so = rng.uniform([-5.0, 0.0, -3.0], [5.0, 1.5, 4.0], (n, 3))
    uv = rng.uniform(-0.5, 0.5, (n, 2)) * scale[:2]
    on_lamp = pos + uv[:, 0:1] * rot[0] + uv[:, 1:2] * rot[1]
    toward = rng.random(n) < 0.5
    sd = np.where(toward[:, None], on_lamp - so, rng.normal(size=(n, 3)) + np.array([0, 1.0, 0]))
    slen = np.linalg.norm(sd, axis=-1)
    sd /= slen[:, None]
    smax = np.where(alive, np.where(toward, slen, _INF_SHADOW_TMAX), 0.0)

    def t(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x if x.dtype == bool else x.astype(np.float32)).to(dev)

    return tuple(t(x) for x in (o, d, tmax, prim, so, sd, smax))


def check_isect_material(dev) -> None:
    """isect over the material_test scene's own reflection and shadow prop
    tables (the rules of check_isect) at the material path's 786,432
    lanes; its Sphere, Rectangle and Dome branches must each be hit, and
    the Sphere hits are counted (no earlier check's tables hold a sphere)."""
    import torch
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene.types import ShapeType

    scene = _material(dev)
    refl, shadow = isect.prop_table(scene, "reflection"), isect.prop_table(scene, "shadow")
    o, d, tmax, prim, so, sd, smax = _material_lanes(scene, N_MATERIAL, dev)
    k = isect.closest_props(refl, o, d, 0.0, tmax, prim)
    p = isect.isect_plain(refl.kinds, refl.table, refl.ids, o, d, 0.0, tmax, prim, False)
    kb = isect.anyhit_props(shadow, so, sd, 0.0, smax)
    pb = isect.isect_plain(shadow.kinds, shadow.table, shadow.ids, so, sd, 0.0, smax, None, True)
    torch.cuda.synchronize()
    if not torch.equal(k[1], p[1]):
        raise AssertionError(f"isect (material): {int((k[1] != p[1]).sum())} prop ids differ")
    if not torch.equal(kb, pb):
        raise AssertionError(f"isect (material): {int((kb != pb).sum())} any-hit results differ")
    for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    bitwise = all(torch.equal(a, b) for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])))
    kinds = scene.prop_shape[torch.clamp(p[1], min=0).long()]
    hits = {st.name: int(((p[1] >= 0) & (kinds == int(st))).sum())
            for st in (ShapeType.SPHERE, ShapeType.RECTANGLE, ShapeType.DOME)}
    if min(hits.values()) <= 0:
        raise AssertionError(f"isect (material): a branch was never hit: {hits}")
    ms = time_ms(lambda: isect.closest_props(refl, o, d, 0.0, tmax, prim), 20)
    log(f"isect (material tables {refl.kinds} / shadow {shadow.kinds}): prop ids and any-hit "
        f"exact on {N_MATERIAL} lanes, t/u/v {'bit-exact' if bitwise else 'within rtol 2e-5'}; "
        f"hits by shape {hits}; {int(pb.sum())} shadow rays blocked; closest {ms:.4f} ms")


def _rays_into_cube(scene, take_name, res, rng, dev):
    """The take's camera rays (one a pixel at res, jittered by rng) started
    where they enter the scene's first volume prop, a Cube: (o, d, medium
    prop (-1 for the rays that miss it), a far segment end)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.render.camera import generate_rays
    from zyg_tpu_torch.render.integrator import volume as vol
    from zyg_tpu_torch.scene.types import ShapeType

    take = _take(take_name, res, 1)
    n = res[0] * res[1]
    ids = np.arange(n)
    xy = torch.from_numpy(np.stack([ids % res[0], ids // res[0]], -1)).to(dev)
    uv = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    o, d = generate_rays(take.cameras[0].arrays(dev), xy, uv)
    cube = int(scene.volume_props[0][0])
    far = torch.full((n,), 1e4, device=dev)
    t0, t1 = vol._prop_interval(scene, cube, int(ShapeType.CUBE), o, d, far)
    enters = t1 > t0
    o_in = torch.where(enters[:, None], o + (t0 + 1e-4)[:, None] * d, o)
    return o_in, d, torch.where(enters, cube, -1).to(torch.int32), far


def _smoke_walk_inputs(dev, seed=13):
    """The inputs the smoke path's glue hands each walk, at the smoke
    path's 518,400 lanes, captured from render/integrator/volume.py: the
    camera rays of smoke.take (960x540) started where they enter the smoke
    cube (sample_interaction's lanes; the rays that miss it do not walk),
    and shadow rays from points in the cube and on the floor to points on
    the lamp (transmittance's). Returns ((arena, props, lanes, coef,
    grey), (arena, props, prop, grid, consts, lanes, grey))."""
    import numpy as np
    import torch
    from zyg_tpu_torch.ops import track
    from zyg_tpu_torch.render.integrator import volume as vol

    scene = _smoke(dev)
    n = N_SMOKE
    rng = np.random.default_rng(seed)
    o_in, d, mp, far = _rays_into_cube(scene, "smoke.take", SMOKE_RES, rng, dev)
    cube = int(scene.volume_props[0][0])

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype=dtype, device=dev)

    key = t(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
            torch.int32)
    u = t(rng.random(n).astype(np.float32))
    lamp = int(scene.lights.prop[0])
    rot, pos, scl = (x.cpu().numpy().astype(np.float64) for x in
                     (scene.prop_rot[lamp], scene.prop_pos[lamp], scene.prop_scale[lamp]))
    crot, cpos, cscl = (x.cpu().numpy().astype(np.float64) for x in
                        (scene.prop_rot[cube], scene.prop_pos[cube], scene.prop_scale[cube]))
    in_cube = cpos + (rng.uniform(-0.5, 0.5, (n, 3)) * cscl) @ crot
    on_floor = np.stack([rng.uniform(-5, 5, n), np.full(n, 1e-3), rng.uniform(-4, 5, n)], -1)
    so = np.where((rng.random(n) < 0.5)[:, None], in_cube, on_floor)
    lp = pos + (rng.uniform(-0.5, 0.5, (n, 2)) * scl[:2]) @ rot[:2]
    sd = lp - so
    slen = np.linalg.norm(sd, axis=-1)
    sd /= slen[:, None]
    captured = {}
    inner_i, inner_t = track.track_interaction, track.track_transmittance

    def cap_i(*args, **kw):  # smoke's medium does not emit: no e_med
        captured["i"] = args
        return inner_i(*args, **kw)

    def cap_t(*args):
        captured["t"] = args
        return inner_t(*args)

    track.track_interaction, track.track_transmittance = cap_i, cap_t
    try:
        vol.sample_interaction(scene, mp, o_in, d, far, u, key,
                               vol_depth=torch.zeros(n, dtype=torch.int32, device=dev))
        vol.transmittance(scene, t(so), t(sd), t(slen), key)
    finally:
        track.track_interaction, track.track_transmittance = inner_i, inner_t
    return captured["i"], captured["t"]


def _fire_walk_inputs(dev, variant: str, seed=16):
    """The inputs the fire path's glue hands the emissive walk at its
    518,400 lanes, captured from render/integrator/volume.py: fire.take's
    camera rays (960x540) started where they enter the emissive cube, over
    fire.scene ("fire", grey) or its non-grey copy ("spectral"). Returns
    (arena, props, lanes, coef, grey, e_med)."""
    import numpy as np
    import torch
    from zyg_tpu_torch.ops import track
    from zyg_tpu_torch.render.integrator import volume as vol

    scene = _fire(dev, variant)
    n = N_FIRE
    rng = np.random.default_rng(seed)
    o_in, d, mp, far = _rays_into_cube(scene, "fire.take", FIRE_RES, rng, dev)
    key = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev)
    u = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    captured = {}
    inner = track.track_interaction

    def cap(*args, e_med=None):
        captured["i"] = (*args, e_med)
        return inner(*args, e_med=e_med)

    track.track_interaction = cap
    try:
        vol.sample_interaction(scene, mp, o_in, d, far, u, key,
                               vol_depth=torch.zeros(n, dtype=torch.int32, device=dev))
    finally:
        track.track_interaction = inner
    if captured["i"][5] is None:
        raise AssertionError(f"fire ({variant}): the walk was not handed the medium's emission")
    return captured["i"]


def check_track_emission(dev) -> dict:
    """The emissive variant of track_interaction (the kEmit template flag)
    against its plain version on the fire path's own glue inputs
    (_fire_walk_inputs, 518,400 lanes), grey (fire.scene) and spectral (a
    non-grey copy): t, w, scatter, absorb and the emission bit-exact. Times
    each (events and profiler) beside the plain version and a bound from
    the bytes of its lanes (the 24 bytes a lane of e and emission
    included) and the operations of its steps and collisions. Returns
    {"fire grey": ..., "fire spectral": ...}."""
    import torch
    from zyg_tpu_torch.ops import track

    out = {}
    for variant in ("fire", "spectral"):
        arena, props, lanes, coef, grey, e_med = _fire_walk_inputs(dev, variant)
        if grey != (variant == "fire"):
            raise AssertionError(f"fire ({variant}): grey is {grey}")
        args = (arena, props, lanes, coef, grey)
        k = track.track_interaction(*args, e_med=e_med)
        stats = {}
        t0 = time.perf_counter()
        p = track.track_interaction_plain(*args, stats=stats, e_med=e_med)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for a, b, what in zip(k, p, ("t", "w", "scatter", "absorb", "emission")):
            if not torch.equal(a, b):
                diff = int((a != b).sum())
                raise AssertionError(f"track_interaction (fire {variant}): {what} differs on "
                                     f"{diff} values (max {float((a.float() - b.float()).abs().max()):.3g})")
        walking = lanes["grid"] >= 0
        absorbed = int(p[3].sum())
        if not absorbed or not bool((p[4][p[3]] > 0).any()):
            raise AssertionError(f"track_interaction (fire {variant}): no emission collected")
        arena_bytes = arena.data.numel() * 4 + arena.sdata.numel() * 4
        nbytes = arena_bytes + _track_bytes(list(lanes.values()) + list(coef.values()) + [e_med],
                                            lanes["grid"], k)
        ops = stats["steps"] * OPS_TRACK_STEP + stats["collisions"] * OPS_TRACK_COLLISION
        name = f"fire {'grey' if variant == 'fire' else 'spectral'}"
        eff, warp_longest = warp_efficiency(stats["lane_steps"])
        res = {"warp_efficiency": eff, "longest_walk": stats["iterations"], "max_abs_err": 0.0,
               "ms": time_ms(lambda: track.track_interaction(*args, e_med=e_med), 10),
               "device_ms": device_ms(lambda: track.track_interaction(*args, e_med=e_med),
                                      "track_interaction"),
               "plain_ms": plain_ms, "library_ms": None, **bound(nbytes, ops)}
        log(f"track_interaction ({name}, emissive): t, w, decisions and emission bit-exact on "
            f"{walking.numel()} lanes ({int(p[2].sum())} scatter, {absorbed} absorbed of "
            f"{int(walking.sum())} walking lanes, emission sum {float(p[4].sum()):.6g}); "
            f"{stats['steps']} lane-steps, {stats['collisions']} tentative collisions, "
            f"longest walk {stats['iterations']} steps; with a thread a lane a warp's longest "
            f"walk {warp_longest:.2f} steps on average, warp efficiency {eff:.4f}; "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations; kernel {res['ms']:.4f} ms "
            f"(device {res['device_ms']:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
        out[name] = res
        torch.cuda.empty_cache()
    return out


def warp_efficiency(lane_steps, warp: int = 32) -> tuple[float, float]:
    """The share of thread-steps that walk when one thread walks one lane
    to its end and a warp runs until its longest walk ends, warps taken as
    consecutive groups of `warp` lanes: the lane-steps over `warp` x the
    sum over warps of the warp's longest walk (1 where no lane walks);
    and the mean longest walk of a warp. lane_steps: int64 [N], each
    lane's steps (the plain walks' stats["lane_steps"])."""
    import torch

    pad = (-lane_steps.numel()) % warp
    longest = torch.nn.functional.pad(lane_steps, (0, pad)).view(-1, warp).amax(dim=1)
    slots = int(longest.sum()) * warp
    return (int(lane_steps.sum()) / slots if slots else 1.0), float(longest.double().mean())


def _track_bytes(inputs: list, flag, outputs) -> float:
    """Bytes a walk must move: each lane's walk flag (the tensor `flag`:
    grid >= 0 or a bool), on the lanes that walk every other per-lane
    input once, and every output once."""
    import torch

    walking = flag if flag.dtype == torch.bool else flag >= 0
    per_lane = sum(x[0].numel() * x.element_size() for x in inputs) - flag.element_size()
    return (flag.element_size() * flag.numel() + per_lane * int(walking.sum())
            + sum(x.numel() * x.element_size() for x in outputs))


def check_track(dev) -> dict:
    """Both tracking walks through the kernel (ops/track.py) against their
    plain versions on the smoke path's own glue inputs (_smoke_walk_inputs,
    518,400 lanes): scatter and absorb decisions exact, t, w, trv and tau
    within rtol 1e-5 (the CPU tests' tolerance against JAX; on the card
    the kernel and torch share logf, so they agree to a few ulp). Times
    each (events and profiler) beside the plain version and a bound from
    the bytes of its lanes and the operations of the steps and collisions
    that this run's lanes take (counted by the plain walk). Returns
    {"track_interaction": ..., "track_transmittance": ...}."""
    import torch
    from zyg_tpu_torch.ops import track

    ia, ta = _smoke_walk_inputs(dev)
    arena = ia[0]
    arena_bytes = arena.data.numel() * 4 + arena.sdata.numel() * 4
    out = {}
    for name, args, kfn, pfn in (("track_interaction", ia, track.track_interaction,
                                  track.track_interaction_plain),
                                 ("track_transmittance", ta, track.track_transmittance,
                                  track.track_transmittance_plain)):
        k = kfn(*args)
        stats = {}
        t0 = time.perf_counter()
        p = pfn(*args, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lanes = args[2] if name == "track_interaction" else args[5]
        if name == "track_interaction":
            walking = lanes["grid"] >= 0
            for a, b, what in ((k[2], p[2], "scatter"), (k[3], p[3], "absorb")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: {int((a != b).sum())} {what} decisions differ")
            floats = ((k[0], p[0]), (k[1], p[1]))
            events = (f"{int(p[2].sum())} scatter, {int(p[3].sum())} absorbed of "
                      f"{int(walking.sum())} walking lanes")
        else:
            walking = lanes["inside"]
            floats = ((k[0], p[0]), (k[1], p[1]))
            events = f"{int(walking.sum())} lanes cross the smoke, mean trv {float(p[0].mean()):.4f}"
        for a, b in floats:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        err = max(float((a - b).abs().max()) for a, b in floats)
        exact = all(torch.equal(a, b) for a, b in floats)
        per_lane = list(lanes.values()) + (list(args[3].values()) if name == "track_interaction"
                                           else [])
        flag = lanes["grid"] if name == "track_interaction" else lanes["inside"]
        nbytes = arena_bytes + _track_bytes(per_lane, flag, k)
        ops = stats["steps"] * OPS_TRACK_STEP + stats["collisions"] * OPS_TRACK_COLLISION
        eff, warp_longest = warp_efficiency(stats["lane_steps"])
        res = {"warp_efficiency": eff, "longest_walk": stats["iterations"],
               "max_abs_err": err, "ms": time_ms(lambda: kfn(*args), 10),
               "device_ms": device_ms(lambda: kfn(*args), name), "plain_ms": plain_ms,
               "library_ms": None, **bound(nbytes, ops)}
        log(f"{name}: decisions exact, floats {'bit-exact' if exact else 'within rtol 1e-5'} "
            f"on {walking.numel()} lanes ({events}); {stats['steps']} lane-steps, "
            f"{stats['collisions']} tentative collisions ({stats['steps'] / max(int(walking.sum()), 1):.1f} "
            f"steps a walking lane, longest walk {stats['iterations']} steps; with a thread a "
            f"lane a warp's longest walk {warp_longest:.2f} steps on average, warp efficiency "
            f"{eff:.4f}); {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations")
        out[name] = res
    out["track_interaction"]["emissive"] = check_track_emission(dev)
    return out


def phase_slice_smoke(dev) -> None:
    """smoke.take and volumes.take at 96x56, 4 spp on the
    card against the plain CPU path (the general body with the tracking
    kernel; volumes: the homogeneous closed form beside glass)."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    for name, res in (("smoke.take", (96, 56)), ("volumes.take", (96, 56))):
        take = _take(name, res, GATE_SPP)
        scene = load_scene_file(take.scene_filename)
        t0 = time.perf_counter()
        card = Driver(take, scene, device=dev).render_frame()
        t_card = time.perf_counter() - t0
        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        cpu = Driver(take, scene, device="cpu").render_frame()
        t_cpu = time.perf_counter() - t0
        _golden_gate(card, cpu, f"{name[:-5]} {res[0]}x{res[1]}x{GATE_SPP}",
                     f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_fire(dev) -> None:
    """fire.take at 96x56, 4 spp, and fire.scene with a Rectangle lamp
    beside the emissive cube (the light tree selects between a surface
    and a volume light) at 64x48, 4 spp, on the card against the plain
    CPU path (the emissive walk, volume lights in NEE)."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict

    for variant, res in (("fire", (96, 56)), ("lamp", (64, 48))):
        take = _take("fire.take", res, GATE_SPP)
        scene = load_scene_dict(fire_root(variant))
        if (scene.light_tree is not None) != (variant == "lamp"):
            raise AssertionError(f"fire ({variant}): light tree {scene.light_tree is not None}")
        t0 = time.perf_counter()
        card = Driver(take, scene, device=dev).render_frame()
        t_card = time.perf_counter() - t0
        torch.set_num_threads(os.cpu_count() or 1)
        t0 = time.perf_counter()
        cpu = Driver(take, scene, device="cpu").render_frame()
        t_cpu = time.perf_counter() - t0
        _golden_gate(card, cpu, f"{variant} {res[0]}x{res[1]}x{GATE_SPP}",
                     f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def to_device(s, dev):
    """A PathState's tensors (and its split slot's) on dev."""
    import dataclasses

    import torch
    from zyg_tpu_torch.core.sobol import SobolArrays

    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif isinstance(v, SobolArrays):
            v = SobolArrays(*(x.to(dev) for x in (v.sample, v.start_seed, v.run_seed, v.buffer)))
        elif isinstance(v, dict):
            v = {k: x.to(dev) for k, x in v.items()}
        elif f.name == "result":
            v = type(v)(*(x.to(dev) for x in (v.emission, v.direct, v.indirect)))
        out[f.name] = v
    return type(s)(**out)


def material_state(n, bounces=4, seed=9, max_depth=MATERIAL_DEPTH):
    """A general-body PathState of n lanes on the CPU: rays from around
    material_test.take's camera toward the spheres (a third at the glass
    sphere), after `bounces` bounces of the body on the CPU (so that lanes
    sit inside the glass and hold parked split branches)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = np.array([0, 2.2, -7.5]) + rng.uniform(-0.3, 0.3, (n, 3))
    tgt = rng.uniform([-4, 0, -1], [4, 2, 3], (n, 3))
    glass = rng.normal(size=(n, 3)) * 0.5 + np.array([1.5, 0.75, 1.8])
    tgt = np.where((np.arange(n) % 3 == 0)[:, None], glass, tgt)
    return general_state(_material("cpu"), o, tgt, bounces, max_depth, split=True)


def _medium_state(scene, cube_y, n, bounces, seed, max_depth):
    """A general-body PathState of n lanes on the CPU over a scene with a
    medium cube at (0, cube_y, 0): rays from around the camera of
    smoke.take and fire.take, two thirds at the cube, the rest anywhere in
    view, after `bounces` bounces of the body."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o = np.array([0, 1.9, -5.5]) + rng.uniform(-0.3, 0.3, (n, 3))
    tgt = rng.uniform([-5, 0, -2], [5, 3.5, 4], (n, 3))
    cube = rng.uniform(-1.1, 1.1, (n, 3)) + np.array([0, cube_y, 0])
    tgt = np.where((np.arange(n) % 3 != 0)[:, None], cube, tgt)
    return general_state(scene, o, tgt, bounces, max_depth, split=False,
                         max_depth_volume=SMOKE_DEPTH_VOLUME)


def fire_state(n, bounces=3, seed=14, max_depth=FIRE_DEPTH, scene=None):
    """_medium_state over fire.scene (or `scene`): lanes inside the fire,
    absorbed, scattered and on the floor."""
    return _medium_state(scene if scene is not None else _fire("cpu"), 1.5, n, bounces, seed,
                         max_depth)


def smoke_state(n, bounces=3, seed=12, max_depth=SMOKE_DEPTH):
    """_medium_state over smoke.scene: lanes inside the smoke, with
    scatters behind them and a volume depth."""
    return _medium_state(_smoke("cpu"), 1.3, n, bounces, seed, max_depth)


def general_state(scene, o, tgt, bounces, max_depth, split, max_depth_volume=256):
    """A general-body PathState on the CPU with rays from o toward tgt
    (numpy [N, 3]) after `bounces` bounces of the port's body."""
    import dataclasses

    import numpy as np
    import torch
    from zyg_tpu_torch.core.rng import hash_u32, to_i32
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.render.integrator import ptmis, volume

    n = o.shape[0]
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    ids = torch.arange(n, dtype=torch.int64)
    f32 = torch.float32
    s = ptmis.PathState(
        o=o, d=d, throughput=torch.ones((n, 3)), result=ptmis.IValue.zeros(n, "cpu"),
        alive=torch.ones(n, dtype=torch.bool), bxdf_pdf=torch.zeros(n),
        singular=torch.ones(n, dtype=torch.bool), depth=torch.zeros(n, dtype=torch.int32),
        rays=torch.zeros((), dtype=torch.int64),
        sobol=SobolSampler.start_pixel(ids, torch.zeros_like(ids)).arrays,
        vol_key=to_i32(hash_u32(ids)), mis_o=o, mis_n=d, pid=ids,
        medium=volume.stack_empty(n, "cpu"), vol_depth=torch.zeros(n, dtype=torch.int32),
        from_volume=torch.zeros(n, dtype=torch.bool), primary_chain=torch.ones(n, dtype=torch.bool),
        nee_thr=torch.zeros(n, dtype=f32), reg_alpha=torch.zeros(n, dtype=f32),
        split=ptmis._split_init(n, "cpu") if split else {},
    )
    body = ptmis._make_body(scene, ptmis.PtmisSettings(max_depth=max_depth,
                                                       max_depth_volume=max_depth_volume,
                                                       bsdf_split=split))
    for _ in range(bounces):
        s = body(ptmis.resume_split(s))
    return dataclasses.replace(s, rays=torch.zeros((), dtype=torch.int64))


def compare_general(r1, r2) -> float:
    """The general body on the card (r1) against the same body on the CPU
    (r2): lifecycles, the stack and the split slot's integer fields (where
    the scene splits) exact,
    live-lane floats within the CPU test's tolerances against JAX (o 1e-5,
    d 2e-4, throughput 5e-3, mis_n 2e-4; bxdf_pdf 2e-2 off the mirror's
    near-delta lobe). Returns the largest absolute error of o, d."""
    import torch

    r2 = to_device(r2, r1.o.device)
    for name in ("alive", "depth", "vol_depth", "medium", "singular", "primary_chain", "vol_key",
                 "rays"):
        if not torch.equal(getattr(r1, name), getattr(r2, name)):
            raise AssertionError(f"general body: {name} differs between card and CPU")
    for k in ("pending", "depth", "medium", "vol_key", "run_seed") if r1.split else ():
        if not torch.equal(r1.split[k], r2.split[k]):
            raise AssertionError(f"general body: split.{k} differs between card and CPU")
    if not torch.equal(r1.sobol.run_seed, r2.sobol.run_seed):
        raise AssertionError("general body: the Sobol' run seed differs between card and CPU")
    live = r1.alive
    near_delta = live & (r1.reg_alpha > 0.0) & (r1.reg_alpha < 1e-3)
    for name, tol, mask in (("o", 1e-5, live), ("d", 2e-4, live), ("throughput", 5e-3, live),
                            ("mis_n", 2e-4, live), ("bxdf_pdf", 2e-2, live & ~near_delta)):
        a, b = getattr(r2, name)[mask].double(), getattr(r1, name)[mask].double()
        rel = float(((a - b).abs() / (a.abs() + 1e-3)).max()) if a.numel() else 0.0
        if rel >= tol:
            raise AssertionError(f"general body: {name} off by {rel:.3g} (tolerance {tol})")
    if not r1.o.numel():
        return 0.0
    return max(float((r1.o - r2.o).abs().max()), float((r1.d - r2.d).abs().max()))


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


def _filtered_case(mode: str, n: int, dev):
    """The filtered flush's inputs at Cornell 1080p's width: (pid, was_alive,
    alive, planes, clamps, sub_uv, clamp_edge). shuffled: _flush_lanes at
    the path's finish share, cornell_filtered's indirect clamp of 8;
    unshuffled: lane i on pixel i at the same share; clamp_edge: the scan
    path's splat, every lane finished, one plane."""
    import torch

    inf = float("inf")
    pid, was_alive, alive, e, d, x = _flush_lanes(n, CORNELL_FLUSH_SHARE, dev, seed=15)
    uv = torch.rand((n, 2), generator=torch.Generator(device="cpu").manual_seed(16)).to(dev)
    lanes = torch.arange(n, device=dev)
    if mode == "clamp_edge":
        return lanes, None, None, (e,), (inf,), uv, True
    if mode == "unshuffled":
        pid = lanes
    return pid, was_alive, alive, (e, d, x), (inf, inf, 8.0), uv, False


def atomic_lines(idx, tgt, ok) -> dict:
    """How the filtered flush's atomics fall on the framebuffer's 128-byte
    lines (8 float4 rows), for the finishing lanes idx (ascending) with
    filtered_taps' targets tgt and valid taps ok ([T, m]): the distinct
    lines one warp-wide atomic instruction touches and its active threads,
    averaged over instructions, under the lane-major mapping (a thread a
    lane of 32 consecutive lanes, an instruction a tap) and the tap-major
    one (the warp's threads share the taps of its next 32 // T finishing
    samples, an instruction those samples)."""
    import torch

    taps, m = tgt.shape
    if not bool(ok.any()):
        return {}
    warp = idx // 32
    rank = torch.arange(m, device=idx.device) - torch.searchsorted(warp, warp)
    line = tgt[ok] // 8
    nl = int(line.max()) + 1
    inst = {"lane_major": (warp[None, :] * taps
                           + torch.arange(taps, device=idx.device)[:, None])[ok],
            "tap_major": (warp * 32 + rank // (32 // taps))[None, :].expand(taps, m)[ok]}
    out = {}
    for name, i in inst.items():
        count = torch.unique(i).numel()
        out[name] = {"lines_per_instruction": torch.unique(i * nl + line).numel() / count,
                     "threads_per_instruction": line.numel() / count}
    return out


def check_accum_filtered(dev) -> dict:
    """The filtered flush against its plain version on Cornell 1080p's
    lanes: Mitchell r2 shuffled at the path's finish share (the
    cornell_filtered path), Blackman r1 shuffled, Mitchell r2 unshuffled,
    and the scan path's clamp-to-edge mode on every lane. Weights and RGB
    within rtol 1e-5 and an absolute 1e-5 of the plane's largest magnitude
    (float adds in atomic order; Mitchell's negative lobes cancel). Times
    each beside its bound (bytes, and the operations per finishing lane)
    and the one PyTorch call that adds the same tap rows (index_add_).
    Both of the kernel's mappings (tap-major, lane-major) are held against
    the plain version and timed in turns in each mode, beside the 128-byte
    lines one atomic instruction touches under each (atomic_lines)."""
    import torch
    from zyg_tpu_torch.ops.accum import (_launch_filtered, _radiance, filtered_taps,
                                         flush_filtered, flush_filtered_plain)

    w, h = 1920, 1080
    n = w * h
    fb0 = torch.rand((n, 4), generator=torch.Generator(device="cpu").manual_seed(12)).to(dev)
    out = {}
    for tag, mode, name, r in (("", "shuffled", "Mitchell", 2),
                               ("blackman_r1_", "shuffled", "Blackman", 1),
                               ("unshuffled_", "unshuffled", "Mitchell", 2),
                               ("clamp_edge_", "clamp_edge", "Mitchell", 2)):
        pid, was_alive, alive, planes, clamps, uv, edge = _filtered_case(mode, n, dev)
        args = (pid, was_alive, alive, planes, clamps, uv, w, h, name, r)
        a1 = flush_filtered(fb0.clone(), *args, clamp_edge=edge)
        a2 = flush_filtered_plain(fb0.clone(), *args, clamp_edge=edge)
        mapped = {}
        for tm in (True, False):
            mapped[tm] = fb0.clone()
            _launch_filtered(mapped[tm], *args, edge, 0, tap_major=tm)
        torch.cuda.synchronize()
        for got, how in ((a1, ""), (mapped[True], " tap-major"), (mapped[False], " lane-major")):
            for cols, what in ((slice(3, 4), "weights"), (slice(0, 3), "RGB")):
                ref = a2[:, cols] - fb0[:, cols]
                scale = float(ref.abs().max())
                torch.testing.assert_close(
                    got[:, cols] - fb0[:, cols], ref, rtol=1e-5, atol=1e-5 * scale,
                    msg=lambda m: f"accum_filtered {tag or 'mitchell_r2_'}{what}{how}: {m}")
        del mapped
        fin = (torch.ones_like(pid, dtype=torch.bool) if was_alive is None
               else was_alive & ~alive)
        idx = torch.nonzero(fin).squeeze(1)
        m = idx.shape[0]
        tgt, wts, ok = filtered_taps(pid[idx], uv[idx], w, h, name, r, edge, n)
        rgb = _radiance([p[idx] for p in planes], clamps)
        rows = torch.cat([rgb[None] * wts[:, :, None], wts[:, :, None]], dim=2)[ok]
        tgt_ok = tgt[ok]
        a3 = fb0.clone()
        taps = (2 * r + 1) ** 2
        out.update({
            f"{tag}max_abs_err": float((a1 - a2).abs().max()),
            f"{tag}ms": time_ms(lambda: flush_filtered(a1, *args, clamp_edge=edge), 20),
            f"{tag}device_ms": device_ms(lambda: flush_filtered(a1, *args, clamp_edge=edge),
                                         "accum_filtered"),
            f"{tag}plain_ms": time_ms(lambda: flush_filtered_plain(a2, *args, clamp_edge=edge),
                                      2, runs=3),
            # the one PyTorch call that adds the same tap rows by pixel
            f"{tag}library_ms": time_ms(lambda: a3.index_add_(0, tgt_ok, rows), 20),
            f"{tag}atomics": int(ok.sum()),
        })
        # pid of every lane and the two masks where given; the radiance rows
        # and the offset of each finishing lane; the [N, 4] framebuffer stays
        # in L2 (33 MB), as for the box flush
        nbytes = n * (8 + (2 if was_alive is not None else 0)) + m * (12 * len(planes) + 8)
        ops = m * (2 * (2 * r + 1) * OPS_FILTER_EVAL + taps * OPS_FILTER_TAP)
        b = bound(nbytes, ops)
        out.update({f"{tag}{k}": v for k, v in b.items()})
        # the two mappings in turns (lane-major, tap-major, tap-major,
        # lane-major), and the lines an atomic instruction touches under each
        turns = {True: [], False: []}
        for tm in (False, True, True, False):
            turns[tm].append(device_ms(
                lambda: _launch_filtered(a1, *args, edge, 0, tap_major=tm), "accum_filtered"))
        lines = atomic_lines(idx, tgt, ok)
        out[f"{tag}mappings"] = {"tap_major_device_ms": turns[True],
                                 "lane_major_device_ms": turns[False], **lines}
        log(f"accum_filtered {mode} {name} r{r}: {m} of {n} lanes finish, {int(ok.sum())} float4 "
            f"atomics ({taps} taps a lane), max_abs_err {out[f'{tag}max_abs_err']:.3g}, kernel "
            f"{out[f'{tag}ms']:.4f} ms (device {out[f'{tag}device_ms']:.4f} ms), plain "
            f"{out[f'{tag}plain_ms']:.4f} ms, library {out[f'{tag}library_ms']:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); {int(ok.sum()) / out[f'{tag}device_ms'] / 1e6:.1f} "
            f"G atomics/s; the wrapper maps {'tap' if was_alive is not None else 'lane'}-major; "
            f"device ms in turns, lane-major {turns[False]}, tap-major {turns[True]}; per atomic "
            f"instruction, 128-B lines and threads: "
            + ", ".join(f"{k} {v['lines_per_instruction']:.3f} and "
                        f"{v['threads_per_instruction']:.3f}" for k, v in lines.items()))
        del a1, a2, a3, rows, tgt, wts, ok, tgt_ok, rgb
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


def _forest_scene(dev, moving: bool):
    """forest.scene at its take's frame-0 shutter; moving: a copy the script
    writes with each of the 144 instances a Prop with a two-keyframe
    animation over the shutter (a step of 0.3 along x and a 40 degree turn
    about y), so every instance row holds a shutter-end transform."""
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.scene.loader import load_scene_dict

    with open(os.path.join(REPO, "examples/scenes/forest.scene")) as f:
        root = json.load(f)
    interval = load_take_file(os.path.join(REPO, "examples/takes/forest.take")) \
        .cameras[0].frame_interval(0)
    if moving:
        ents = []
        for e in root["entities"]:
            if e["type"] != "Instancer":
                ents.append(e)
                continue
            for inst in e["instances"]:
                end = {"position": [inst["position"][0] + 0.3] + inst["position"][1:],
                       "rotation": [inst["rotation"][0], inst["rotation"][1] + 40.0,
                                    inst["rotation"][2]]}
                ents.append({"type": "Prop", "shape": e["prototype"]["shape"],
                             "materials": e["prototype"]["materials"], "transformation": inst,
                             "animation": {"keyframes": [
                                 {"time": interval[0], "transformation": {}},
                                 {"time": interval[1], "transformation": end}]}})
        root["entities"] = ents
    t0 = time.perf_counter()
    scene = load_scene_dict(root, dev, base_dir=os.path.join(REPO, "examples/scenes"),
                            time0=interval[0], time1=interval[1])
    itab = scene.mesh_instances
    log(f"forest{' (moving)' if moving else ''}: {itab.trafo.shape[0]} instances, moving "
        f"{itab.has_anim}, load + arena build {time.perf_counter() - t0:.2f} s")
    return scene


def _forest_camera_lanes(dev, seed=23):
    """forest.take's camera rays at its own 640x360, one a pixel at a seeded
    subpixel offset, with seeded shutter times: (o, d, time)."""
    import torch
    from zyg_tpu_torch.render.camera import generate_rays

    cam = _take("forest.take", FOREST_RES, 1).cameras[0]
    w, h = FOREST_RES
    g = torch.Generator(device="cpu").manual_seed(seed)
    pids = torch.arange(w * h)
    xy = torch.stack([pids % w, pids // w], dim=-1).to(dev)
    uv = torch.rand((w * h, 2), generator=g).to(dev)
    o, d = generate_rays(cam.arrays(dev), xy, uv)
    return o.contiguous(), d.contiguous(), torch.rand(w * h, generator=g).to(dev)


def _walk_bound(n, itab, arena, counts, anim: bool) -> dict:
    """The least time of a walk over n rays: each input once (the rays, tmax
    and primary, the times where moving, the instance table and the arena)
    and the outputs once, beside the work the plain walk counted: the
    instance picks (every box a pick), the instances entered (their
    transform, a slerp where moving), the node and leaf rows."""
    ninst = itab.trafo.shape[0]
    table = ninst * (24 * 4 + 2 * 3 * 4 + 3)
    arena_bytes = (arena.node_rows.numel() + arena.tri_rows.numel()) * 4
    ops = (counts["picks"] * ninst * OPS_BOX
           + counts["entries"] * (OPS_INSTANCE + (OPS_SLERP if anim else 0))
           + counts["nodes"] * OPS_NODE + counts["leaves"] * OPS_LEAF)
    return bound(n * (29 + (4 if anim else 0) + 20) + table + arena_bytes, ops)


def _check_forest_walk(dev, moving: bool) -> dict:
    """The walk over the forest's 144 instances at forest.take's 640x360
    first-bounce lanes against the plain walk, closest (camera rays) and
    any-hit (shadow rays toward the sun): static, every hit record
    bit-exact; moving (the kAnim variant, traverse_anim, at seeded shutter
    times), ids exact except at exact-t ties and t/u/v within rtol 2e-5,
    with the share of lanes equal bit for bit, and the hits at the
    shutter's start compared. Times it beside its bound and the plain
    walk."""
    import torch
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    name = "traverse_anim" if moving else "traverse"
    scene = _forest_scene(dev, moving)
    arena, itab = scene.meshes, scene.mesh_instances
    if itab.has_anim != moving:
        raise AssertionError(f"{name}: the forest's table moves: {itab.has_anim}")
    o, d, tl = _forest_camera_lanes(dev)
    tl = tl if moving else None
    n = o.shape[0]
    tmax = torch.full((n,), RAY_MAX_T, device=dev)
    prim = torch.ones(n, dtype=torch.bool, device=dev)

    def run(time=tl):
        return traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "camera", prim,
                                            time=time)

    before = ops.launch_counts()[name]
    k = run()
    if ops.launch_counts()[name] != before + 1:
        raise AssertionError(f"{name}: the forest's walk did not launch {name}")
    counts = {"nodes": 0, "leaves": 0}
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 0, prim, False, counts, time=tl)
    # shadow rays from the hit points toward the sun (the Distant light)
    sun = scene.prop_rot[int(scene.prop_groups[3][0])][2]
    hit = p[1] >= 0
    so = torch.where(hit[:, None], o + (p[0] - 1e-3)[:, None] * d, o).contiguous()
    sd = (-sun).expand(n, 3).contiguous()
    kb = traverse.intersect_instances(arena, itab, so, sd, 0.0, tmax, "shadow", any_hit=True,
                                      time=tl)
    pb = traverse.traverse_plain(arena, itab, so, sd, 0.0, tmax, 2, None, True, time=tl)
    torch.cuda.synchronize()
    traverse.check_errors(dev)
    exact = torch.ones(n, dtype=torch.bool, device=dev)
    for a, b in zip(k, p):
        exact &= a == b
    if not torch.equal(kb, pb):
        raise AssertionError(f"{name} on forest: {int((kb != pb).sum())} any-hit results differ")
    if moving:
        err = _compare_walks(k, p, name)
        # the same rays at the shutter's start hit elsewhere: the motion shows
        still = run(torch.zeros_like(tl))
        note = (f"{float(((still[1] != k[1]) | (still[4] != k[4])).float().mean()):.4f} of the "
                "lanes hit elsewhere at the shutter's start")
    else:
        err = 0.0
        if not bool(exact.all()):
            raise AssertionError(f"{name} on forest: hit records differ from the plain walk on "
                                 f"{int((~exact).sum())} lanes")
        note = "bit-exact"
    log(f"{name} on the {'moving ' if moving else ''}forest's {n} first-bounce lanes: "
        f"{int(hit.sum())} hit an instance, {int(pb.sum())} shadow rays blocked (any-hit exact); "
        f"{float(exact.float().mean()):.6f} of the lanes equal bit for bit, t's largest "
        f"difference {err:.3g}; {note}; the closest walks made {counts['picks']} instance "
        f"picks ({counts['picks'] / n:.2f} a lane, each over {itab.trafo.shape[0]} boxes), "
        f"entered {counts['entries']} instances, visited {counts['nodes']} node rows and "
        f"{counts['leaves']} leaf rows")
    out = {
        "max_abs_err": err,
        "ms": time_ms(run, 5),
        "device_ms": device_ms(run, name, 5),
        "plain_ms": time_ms(lambda: traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 0, prim,
                                                            False, time=tl), 1, runs=1),
        **_walk_bound(n, itab, arena, counts, anim=moving),
        "library_ms": None,
    }
    if moving:
        out["exact_share"] = float(exact.float().mean())
    else:
        out["anyhit_ms"] = time_ms(lambda: traverse.intersect_instances(
            arena, itab, so, sd, 0.0, tmax, "shadow", any_hit=True), 5)
    return out


def check_traverse_forest(dev) -> dict:
    """traverse on forest.take's 144 static instances (_check_forest_walk)."""
    return _check_forest_walk(dev, moving=False)


def check_traverse_anim(dev) -> dict:
    """The traversal's motion-blur variant on the moving forest the script
    writes (_check_forest_walk)."""
    return _check_forest_walk(dev, moving=True)


def _caustics_driver(dev, res=CAUSTICS_RES, spp=CAUSTICS_SPP, paths=None):
    """A Driver on caustics_photons.take at res and spp (paths: photon
    paths, the take's 200,000 by default), its map baked; logs the bake's
    seconds, the valid photons, the fullest bucket and the scan bound."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    take, scene = _take_scene("caustics_photons.take", res, spp, "caustics")
    if paths is not None:
        take.photon.num_photons = paths
    driver = Driver(take, scene, device=dev)
    t0 = time.perf_counter()
    driver.bake_photons()
    torch.cuda.synchronize()
    pm = driver._photon_map
    log(f"caustics {res[0]}x{res[1]}: bake of {take.photon.num_photons} paths "
        f"{time.perf_counter() - t0:.4f} s (first bake of the process: with its isect "
        f"and sobol_block loads), {int(pm.cell_start[-1])} valid photons of "
        f"{pm.p.shape[0]} slots in {int((torch.diff(pm.cell_start) > 0).sum())} buckets, "
        f"fullest bucket {int(torch.diff(pm.cell_start).max())}, max_per_cell {pm.max_per_cell}")
    return driver


def _caustics_gather_inputs(driver) -> dict:
    """The arguments of the general body's first photon gather of one
    render (the first bounce: every lane a camera ray), captured at the
    call."""
    import torch
    from zyg_tpu_torch.render.integrator import photon as photon_mod

    orig = photon_mod.gather
    seen = []

    def capture(pmap, params, pos, wo, ns, geo_n, active):
        if not seen:
            seen.append({"params": {k: v.clone() if isinstance(v, torch.Tensor) else v
                                    for k, v in params.items()},
                         "pos": pos.clone(), "wo": wo.clone(), "n": ns.clone(),
                         "geo_n": geo_n.clone(), "active": active.clone(),
                         "max_per_cell": pmap.max_per_cell})
        return orig(pmap, params, pos, wo, ns, geo_n, active)

    photon_mod.gather = capture
    try:
        driver.start_frame()
        driver.render_iterations(1)
        torch.cuda.synchronize()
    finally:
        photon_mod.gather = orig
    return seen[0]


def _compare_gather(got, want) -> tuple:
    """(max abs difference, its largest share of the tolerance): each lane
    within 2e-3 of its largest channel plus 1e-6 of the batch's largest
    value (the BSDF's rounding, shade_core.cuh's against
    render/materials.py's)."""
    import torch

    if want.numel() == 0:
        return 0.0, 0.0
    err = (got.double() - want.double()).abs().amax(dim=1)
    tol = 2e-3 * want.abs().amax(dim=1).double() + 1e-6 * float(want.abs().max())
    if not torch.isfinite(got).all() or ((got.amax(dim=1) > 0) != (want.amax(dim=1) > 0)).any():
        raise AssertionError("photon_gather: non-finite values, or lanes lit on one side only")
    worst = float((err / torch.clamp(tol, min=1e-30)).max())
    if worst > 1.0:
        raise AssertionError(f"photon_gather disagrees with its plain version ({worst:.3g} of "
                             "the tolerance)")
    return float(err.max()), worst


def gather_visits(ph_p, ph_wi, cell_start, pos, n, active, radius: float,
                  max_per_cell: int) -> dict:
    """What a photon gather's data asks of it: "visits", the bucket
    entries its active lanes scan (the kernel loop's trips), from
    "visiting" lanes; "in_range", those within r on the front, which
    evaluate the BSDF, on "lit" lanes; "rows" and "rows_in_range", the
    distinct photon rows of each; "buckets", the distinct buckets its
    active lanes look up. And how the visits fall on threads:
    "most_lane_visits", one lane's most; "warp_serial_trips", the sum over
    warps of 32 consecutive lanes of the warp's most visits of one lane
    (the loop trips of a thread-a-lane design, where a warp waits on its
    longest lane); "group_trips", the same for the kernel's group of 16
    threads a lane: the sum over warps of the warp's most ceil(visits / 16)."""
    import torch
    from zyg_tpu_torch.ops import photon as op

    _, _, _, _, lane, j, _ = op._pairs(cell_start, pos, active, radius, max_per_cell)
    rad, inv_cell, r2 = op.scalars(radius, 1)[:3]
    ok = op._in_range(ph_p, ph_wi, pos, n, lane, j, r2)[2]
    looked = torch.cat([torch.where(active & ~dup, h, -1)
                        for dup, h in op._cells(pos, rad, inv_cell)])
    lanes = pos.shape[0]
    per_lane = torch.nn.functional.pad(torch.bincount(lane, minlength=lanes), (0, (-lanes) % 32))

    def trips(g: int) -> int:
        return int((-(-per_lane // g)).view(-1, 32 // g).amax(dim=1).sum())

    return {"visits": int(j.shape[0]), "visiting": int(torch.unique(lane).shape[0]),
            "in_range": int(ok.sum()), "lit": int(torch.unique(lane[ok]).shape[0]),
            "rows": int(torch.unique(j).shape[0]),
            "rows_in_range": int(torch.unique(j[ok]).shape[0]),
            "buckets": int((torch.unique(looked) >= 0).sum()),
            "most_lane_visits": int(per_lane.max()) if lanes else 0,
            "warp_serial_trips": trips(1), "group_trips": trips(16)}


def check_photon_gather(dev) -> dict:
    """The photon gather on caustics_photons.take's first-bounce lanes at
    its own 480x270 over the map baked on the card from the take's 200,000
    paths, against its plain version on the card; then on a seeded dense
    map whose buckets hold ~900 photons (the 64-photon cap binds) at 64 and
    at 4."""
    import torch
    from zyg_tpu_torch.ops import photon as op
    from zyg_tpu_torch.render.integrator import photon as photon_mod

    driver = _caustics_driver(dev)
    pm = driver._photon_map
    a = _caustics_gather_inputs(driver)
    params = a["params"]
    cap = a["max_per_cell"]
    args = (pm.p, pm.wi, pm.alpha, pm.cell_start, params, a["pos"], a["wo"], a["n"],
            a["geo_n"], a["active"], pm.radius, pm.num_paths, cap)
    n = a["pos"].shape[0]

    def kern():
        return op.photon_gather(*args)

    def plain():
        return op.photon_gather_plain(*args)

    got, want = kern(), plain()
    err, worst = _compare_gather(got, want)
    v = gather_visits(pm.p, pm.wi, pm.cell_start, a["pos"], a["n"], a["active"], pm.radius,
                      cap)
    active = int(a["active"].sum())
    lit = int((want.amax(dim=1) > 0).sum())
    # the bytes this run's data needs, each read once: every lane's active
    # flag and output; an active lane's point; a visiting lane's normal; a
    # lit lane's wo, geometric normal and material; each bucket looked up
    # (its two bounds); a visited photon's point and direction, an in-range
    # one's power; the fit table. The map's other rows are never read
    mat_bytes = sum(params[k].element_size() * params[k][0].numel()
                    for k in ("albedo", "f0", "alpha", "metallic", "specular"))
    nbytes = (n * 13 + active * 12 + v["visiting"] * 12 + v["lit"] * (24 + mat_bytes)
              + v["buckets"] * 8 + v["rows"] * 24 + v["rows_in_range"] * 12 + 112 * 4)
    lane_bytes = 4 * 12 + 1 + mat_bytes
    whole = n * (lane_bytes + 12) + 3 * pm.p.numel() * 4 + pm.cell_start.numel() * 4 + 112 * 4
    b = bound(nbytes, active * OPS_PHOTON_CELLS + v["lit"] * OPS_PHOTON_TERMS
              + v["visits"] * OPS_PHOTON_VISIT + v["in_range"] * OPS_PHOTON_EVAL)
    res = {"max_abs_err": err, "ms": time_ms(kern, 20),
           "device_ms": device_ms(kern, "photon_gather"),
           "plain_ms": time_ms(plain, 2, runs=3), "library_ms": None, **b}
    log(f"photon_gather on caustics' first bounce, {n} lanes: {active} gather "
        f"({active / n:.4f}), {lit} lit; {v['visits']} photon visits "
        f"({v['visits'] / max(active, 1):.3f} a gathering lane) from {v['visiting']} lanes, "
        f"at most {v['most_lane_visits']} on one lane, {v['warp_serial_trips']} serial trips of "
        f"a thread a lane (the sum over warps of the warp's longest lane), {v['group_trips']} of "
        f"a group of 16 threads a lane; "
        f"{v['in_range']} in range on {v['lit']} lanes, {v['rows']} photon rows "
        f"({v['rows_in_range']} in range) and {v['buckets']} buckets touched; max_per_cell "
        f"{cap}; max_abs_err {err:.3g} ({worst:.3f} of the tolerance); bytes needed {nbytes} "
        f"(every lane's inputs and the whole map read once: {whole} B, "
        f"{bound(whole, 0)['bound_ms']:.4f} ms)")

    # a seeded dense map: 200,000 photons in a 0.6 m cube of 0.1 m cells
    g = torch.Generator(device=dev).manual_seed(31)
    m, nd = 200_000, 16_384
    p = (torch.rand((m, 3), device=dev, generator=g) - 0.5) * 0.6
    wi = torch.nn.functional.normalize(torch.randn((m, 3), device=dev, generator=g), dim=1)
    power = torch.rand((m, 3), device=dev, generator=g)
    dmap = photon_mod.build_map(p, wi, power, torch.ones(m, dtype=torch.bool, device=dev), 0.05,
                                m)
    pos = (torch.rand((nd, 3), device=dev, generator=g) - 0.5) * 0.6
    nrm = torch.nn.functional.normalize(torch.randn((nd, 3), device=dev, generator=g), dim=1)
    wo = torch.nn.functional.normalize(torch.randn((nd, 3), device=dev, generator=g), dim=1)
    wo = torch.where(((wo * nrm).sum(1) < 0)[:, None], -wo, wo).contiguous()
    # the materials of the take's gathering lanes (Substitutes: the kernel
    # evaluates no other BSDF, and the body gathers on no other lane)
    gathering = torch.nonzero(a["active"]).squeeze(1)
    rows = gathering[torch.randint(0, gathering.shape[0], (nd,), device=dev, generator=g)]
    drows = {k: v[rows].contiguous() if isinstance(v, torch.Tensor) else v
             for k, v in params.items()}
    active_d = torch.rand(nd, device=dev, generator=g) < 0.9
    fullest = int(torch.diff(dmap.cell_start).max())
    dense = {"fullest_bucket": fullest}
    for dcap in (64, 4):
        dargs = (dmap.p, dmap.wi, dmap.alpha, dmap.cell_start, drows, pos, wo, nrm, nrm,
                 active_d, 0.05, m, dcap)
        derr, dworst = _compare_gather(op.photon_gather(*dargs), op.photon_gather_plain(*dargs))
        dv = gather_visits(dmap.p, dmap.wi, dmap.cell_start, pos, nrm, active_d, 0.05, dcap)
        dense[f"cap{dcap}"] = {"max_abs_err": derr, "share_of_tolerance": dworst,
                               "ms": time_ms(lambda: op.photon_gather(*dargs), 5),
                               "device_ms": device_ms(lambda: op.photon_gather(*dargs),
                                                      "photon_gather", reps=5),
                               **{k: dv[k] for k in ("visits", "in_range", "most_lane_visits",
                                                     "warp_serial_trips", "group_trips")}}
    log(f"photon_gather on a dense map ({m} photons, fullest bucket {fullest}), {nd} lanes: "
        f"{dense}")
    if fullest <= 64:
        raise AssertionError("the dense map does not exercise the 64-photon cap")
    res["dense"] = dense
    del driver
    return res


def _particles_take(res, ppp):
    """cornell_particles.take at res with ppp particles a pixel."""
    from zyg_tpu_torch.io.take import load_take_file

    take = load_take_file(os.path.join(REPO, "examples/takes/cornell_particles.take"))
    take.cameras[0].resolution = res
    take.num_particles_per_pixel = ppp
    return take


def _lt_splat_inputs(driver) -> list:
    """The arguments of a particle pass's first camera splat (every path's
    first vertex), captured at the call."""
    import torch
    from zyg_tpu_torch.render.integrator import lighttracer as lt_mod

    orig = lt_mod.lt_splat
    seen = []

    def capture(*args):
        if not seen:
            seen.append([{k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in a.items()} if isinstance(a, dict) else a.clone()
                         for a in args])
        return orig(*args)

    lt_mod.lt_splat = capture
    try:
        driver.start_frame()
        driver.render_particles(1)
        torch.cuda.synchronize()
    finally:
        lt_mod.lt_splat = orig
    return seen[0]


def check_lt_splat(dev) -> dict:
    """The camera splat on the first bounce of one particle pass of
    cornell_particles.take at its own 512x512 (every path's first
    vertex), against its plain version on the card: the connections
    counted exactly, RGB within rtol 4e-6 (the atomics add in another
    order), as the flush is held."""
    import torch
    from zyg_tpu_torch.ops import lt_splat as op
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _particles_take(PARTICLE_RES, 1)
    driver = Driver(take, load_scene_file(take.scene_filename), device=dev)
    params, wo, wi, nrm, geo, tp, cam_pdf, ids, connect, blocked, splat0, _ = \
        _lt_splat_inputs(driver)
    lanes = (params, wo, wi, nrm, geo, tp, cam_pdf, ids, connect, blocked)
    pixels = splat0.shape[0]

    def fresh():
        return (torch.zeros((pixels, 4), device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))

    got, got_count = fresh()
    op.lt_splat(*lanes, got, got_count)
    want, want_count = fresh()
    op.lt_splat_plain(*lanes, want, want_count)
    torch.cuda.synchronize()
    if int(got_count) != int(want_count):
        raise AssertionError(f"lt_splat: {int(got_count)} connections, the plain version "
                             f"{int(want_count)}")
    torch.testing.assert_close(got, want, rtol=4e-6,
                               atol=4e-6 * float(want[:, :3].abs().max()))
    conn, contrib = op.contributions(params, wo, wi, nrm, geo, tp, cam_pdf, connect, blocked)
    n = wo.shape[0]
    cand = int((connect & (params["kind"] == 0)).sum())
    adds = int((conn & ~blocked).sum())
    touched = int(torch.unique(ids[conn & ~blocked]).shape[0])
    k_splat, k_count = fresh()
    p_splat, p_count = fresh()
    lib = torch.zeros((pixels, 3), device=dev)
    dms = device_ms(lambda: op.lt_splat(*lanes, k_splat, k_count), "lt_splat")
    # the bytes this run's data needs: every lane's connect flag; a
    # candidate's directions, normals, material row and kind, throughput,
    # pdf, pixel and blocked flag; each add's 12 B of RGB; the fit table
    mat_bytes = 12 + 12 + 4 + 4 + 4 + 4
    nbytes = n + cand * (48 + mat_bytes + 12 + 4 + 8 + 1) + adds * 12 + 112 * 4
    res = {"max_abs_err": float((got - want).abs().max()),
           "ms": time_ms(lambda: op.lt_splat(*lanes, k_splat, k_count), 20),
           "device_ms": dms,
           "plain_ms": time_ms(lambda: op.lt_splat_plain(*lanes, p_splat, p_count), 3, runs=3),
           # the one PyTorch call that adds the same contributions by pixel
           "library_ms": time_ms(lambda: lib.index_add_(0, ids, contrib), 20),
           **bound(nbytes, cand * OPS_LT_SPLAT_LANE + adds * OPS_LT_SPLAT_ADD),
           "lanes": n, "candidates": cand, "connections": int(want_count), "adds": adds}
    log(f"lt_splat on cornell_particles' first bounce, {n} lanes: {cand} candidates "
        f"(camera-visible, in the frame, a Substitute), {int(want_count)} connect (f > 0), "
        f"{adds} add (unblocked) onto {touched} of {pixels} pixels; float4 atomics "
        f"{adds / (dms * 1e-3) / 1e9:.2f} G/s at the device time; bytes needed {nbytes}")
    del driver
    return res


def _camera_lanes(dev, take_name, res, seed):
    """A take's camera rays at res, one a pixel at a seeded subpixel offset,
    with seeded shutter times: (o, d, time)."""
    import torch
    from zyg_tpu_torch.render.camera import generate_rays

    cam = _take(take_name, res, 1).cameras[0]
    w, h = res
    g = torch.Generator(device="cpu").manual_seed(seed)
    pids = torch.arange(w * h)
    xy = torch.stack([pids % w, pids // w], dim=-1).to(dev)
    uv = torch.rand((w * h, 2), generator=g).to(dev)
    o, d = generate_rays(cam.arrays(dev), xy, uv)
    return o.contiguous(), d.contiguous(), torch.rand(w * h, generator=g).to(dev)


def _walk_lanes(dev, take_name, res, seed, shape):
    """The take's scene over frame 0's shutter on the card, its first prop
    of ShapeType `shape`, and its camera rays at res in that prop's object
    space: (scene, prop, root [N], o, d, time)."""
    import torch
    from zyg_tpu_torch.core import vecmath as vm

    _, scene = _take_scene(take_name, res, 1, take_name[:-5])
    scene = scene.to(dev)
    k = int(torch.nonzero(scene.prop_shape == int(shape))[0])
    o, d, tl = _camera_lanes(dev, take_name, res, seed)
    rot, pos, scale = scene.prop_rot[k], scene.prop_pos[k], scene.prop_scale[k]
    o_l = vm.world_to_object_point(rot, scale, pos, o).contiguous()
    d_l = vm.world_to_object_vector(rot, scale, d).contiguous()
    ids = scene.prop_cloud if scene.points is not None else scene.prop_curve
    roots = scene.points.cloud_root if scene.points is not None else scene.curves.curve_root
    root = roots[ids[k]].to(torch.int32).expand(o.shape[0]).contiguous()
    return scene, k, root, o_l, d_l, tl


def _walk_rows_bound(n, lane_bytes, counts, node_bytes, leaf_bytes, ops_leaf) -> dict:
    """The least time of a point or curve walk over n rays: each lane's
    inputs and outputs once (lane_bytes a lane) and every row the walks
    visited once, beside the plain walk's node visits and leaf tests."""
    rows = int(counts["node_seen"].sum()) * node_bytes + int(counts["leaf_seen"].sum()) * leaf_bytes
    return bound(n * lane_bytes + rows, counts["nodes"] * OPS_NODE2 + counts["leaves"] * ops_leaf)


def _incoherent_lanes(dev, node_rows, root: int, n: int, seed: int):
    """n rays from seeded origins uniform in node row root's box, along
    seeded directions uniform on the sphere, with seeded shutter times
    (torch.Generator on the CPU): (root [N], o, d, time), all walking from
    root. Camera rays alone favour designs that need coherent lanes."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = node_rows[root, 0:3].cpu(), node_rows[root, 3:6].cpu()
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    z = 2.0 * torch.rand(n, generator=g) - 1.0
    phi = 2.0 * math.pi * torch.rand(n, generator=g)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    tl = torch.rand(n, generator=g)
    return (torch.full((n,), root, dtype=torch.int32, device=dev), o.to(dev).contiguous(),
            d.to(dev).contiguous(), tl.to(dev))


def walk_diagnosis(counts: dict) -> dict:
    """What the warps of a walk with a thread a lane do, from the plain
    walk's counts (lanes in groups of 32, each warp stepping until its
    longest walk ends; scene/points.py count_steps): the share of its
    thread-steps that walk (warp_efficiency), its warp-steps, the share of
    them that run the leaf branch (a lane of the warp tests a leaf) and
    the lanes at a leaf in such a step."""
    import torch

    eff, longest = warp_efficiency(counts["lane_steps"])
    steps = counts["lane_steps"]
    pad = (-steps.numel()) % 32
    warp_steps = int(torch.nn.functional.pad(steps, (0, pad)).view(-1, 32).amax(dim=1).sum())
    leaf_steps = counts["leaf_warp_steps"]
    return {"warp_efficiency": eff, "longest_walk_mean": longest, "warp_steps": warp_steps,
            "leaf_branch_share": leaf_steps / max(warp_steps, 1),
            "leaf_lanes_per_step": counts["leaves"] / max(leaf_steps, 1),
            "node_visits": counts["nodes"], "leaf_tests": counts["leaves"]}


def _check_walk(name: str, sets: dict, variants: list, kwalk, pwalk, n_rows: tuple,
                row_bytes: tuple, lane_bytes: int, ops_leaf: int) -> dict:
    """The point or curve walk (name) through its kernel against the plain
    walk on each lane set (sets: {set: lanes}), closest and any-hit, in
    each variant ((label, kwargs); the first is the one timed, a second
    one is timed closest as `still_ms`), every output bit-exact; each call
    launches the kernel once. kwalk(lanes, any_hit, **kw) and pwalk(lanes,
    any_hit, counts, **kw) run the two walks. Per set: the diagnosis of
    a thread a lane (walk_diagnosis, the first variant's closest walk),
    the kernel's CUDA-event and device times closest and any-hit, the
    plain walk's time and the bound from its counts. Returns the first
    set's results, with each other set's under its name."""
    import torch
    from zyg_tpu_torch import ops

    out = {}
    for set_name, lanes in sets.items():
        n = lanes[1].shape[0]
        counts = {"nodes": 0, "leaves": 0,
                  "node_seen": torch.zeros(n_rows[0], dtype=torch.bool, device=lanes[1].device),
                  "leaf_seen": torch.zeros(n_rows[1], dtype=torch.bool, device=lanes[1].device),
                  "lane_steps": torch.zeros(n, dtype=torch.int64, device=lanes[1].device)}
        notes = []
        for v, (label, kw) in enumerate(variants):
            for any_hit in (False, True):
                before = ops.launch_counts()[name]
                k = kwalk(lanes, any_hit, **kw)
                if ops.launch_counts()[name] != before + 1:
                    raise AssertionError(f"{name}: the walk did not launch the {name} kernel")
                p = pwalk(lanes, any_hit, counts if v == 0 and not any_hit else None, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(k, p)):
                    bad = int(sum((a != b) for a, b in zip(k, p)).bool().sum())
                    raise AssertionError(f"{name} ({set_name}, {label}, "
                                         f"{'any' if any_hit else 'closest'} hit): {bad} lanes "
                                         "differ from the plain walk")
                notes.append(f"{label} {'any-hit' if any_hit else 'closest'} "
                             f"{int((k[-1] >= 0).sum())} hits")
        diag = walk_diagnosis(counts)
        label0, kw0 = variants[0]
        res = {"max_abs_err": 0.0, "ms": time_ms(lambda: kwalk(lanes, False, **kw0), 20),
               "device_ms": device_ms(lambda: kwalk(lanes, False, **kw0), name),
               "anyhit_ms": time_ms(lambda: kwalk(lanes, True, **kw0), 20),
               "plain_ms": time_ms(lambda: pwalk(lanes, False, None, **kw0), 1, runs=3),
               **_walk_rows_bound(n, lane_bytes, counts, *row_bytes, ops_leaf),
               "library_ms": None, "diagnosis": diag}
        still = ""
        if len(variants) > 1:
            res["still_ms"] = time_ms(lambda: kwalk(lanes, False, **variants[1][1]), 20)
            still = f", {variants[1][0]} {res['still_ms']:.4f} ms"
        log(f"{name} on {n} {set_name} lanes: bit-exact ({', '.join(notes)}); the {label0} "
            f"closest walks visited {counts['nodes']} node rows "
            f"({int(counts['node_seen'].sum())} of {n_rows[0]} distinct) and tested "
            f"{counts['leaves']} leaf rows ({int(counts['leaf_seen'].sum())} of {n_rows[1]} "
            f"distinct); with a thread a lane: warp efficiency {diag['warp_efficiency']:.4f} "
            f"(longest walk of a warp {diag['longest_walk_mean']:.2f} steps on average), "
            f"{diag['warp_steps']} warp-steps, {diag['leaf_branch_share']:.4f} of them run the "
            f"leaf branch for {diag['leaf_lanes_per_step']:.2f} lanes at a leaf on average; "
            f"kernel {res['ms']:.4f} ms (device {res['device_ms']:.4f} ms, any-hit "
            f"{res['anyhit_ms']:.4f} ms{still}), "
            f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        if out:
            out[set_name] = res
        else:
            out = res
    return out


def check_points(dev) -> dict:
    """The point walk on sparks.take's 640x360 first-bounce lanes (camera
    rays in the cloud's object space at seeded shutter times) and on as
    many incoherent lanes (_incoherent_lanes in the cloud's root box)
    against the plain walk: closest and any-hit over the take's moving
    arena (its particles lerped over the 1/24 s shutter), on the camera
    lanes also over the same arena held at shutter open, t and prim
    bit-exact (_check_walk). Times the moving walks beside their bound and
    the plain walk; the incoherent set's results under "incoherent"."""
    import dataclasses

    from zyg_tpu_torch.ops import points
    from zyg_tpu_torch.scene import points as pts
    from zyg_tpu_torch.scene.types import RAY_MAX_T, ShapeType

    scene, _, root, o, d, tl = _walk_lanes(dev, "sparks.take", SPARKS_RES, 29, ShapeType.POINTS)
    arena = scene.points
    if not arena.has_motion:
        raise AssertionError("points: sparks' arena does not move over the shutter")
    import torch

    tmax = torch.full((o.shape[0],), RAY_MAX_T, device=dev)
    still = dataclasses.replace(arena, has_motion=False)
    inc = _incoherent_lanes(dev, arena.node_rows, int(root[0]), o.shape[0], 37)

    def kwalk(lanes, any_hit, ar=arena, moving=True):
        r, o_, d_, t_ = lanes
        return points.walk(ar, r, o_, d_, 0.0, tmax, time=t_ if moving else None,
                           any_hit=any_hit)

    def pwalk(lanes, any_hit, counts, ar=arena, moving=True):
        r, o_, d_, t_ = lanes
        return pts.traverse(ar, r, o_, d_, 0.0, tmax, time=t_ if moving else None,
                            any_hit=any_hit, counts=counts)

    return _check_walk(
        "points", {"first-bounce": (root, o, d, tl), "incoherent": inc},
        [("moving", {}), ("still", {"ar": still, "moving": False})], kwalk, pwalk,
        (arena.node_rows.shape[0], arena.point_rows.shape[0]),
        # 48-byte node rows and 128-byte leaf rows; in: o, d, tmax, time and
        # root; out: t and prim
        (48, 128), 24 + 4 + 4 + 4 + 8, OPS_POINT_LEAF)


def check_curves(dev) -> dict:
    """The curve walk on hairball.take's 384x384 first-bounce lanes
    (camera rays in the hair's object space) and on as many incoherent
    lanes in the hair's root box against the plain walk: closest and
    any-hit, t, s and prim bit-exact (_check_walk). Times the walks beside
    their bound and the plain walk; the incoherent set's results under
    "incoherent"."""
    import torch
    from zyg_tpu_torch.ops import curves
    from zyg_tpu_torch.scene import curves as crv
    from zyg_tpu_torch.scene.types import RAY_MAX_T, ShapeType

    scene, _, root, o, d, tl = _walk_lanes(dev, "hairball.take", HAIRBALL_RES, 31,
                                           ShapeType.CURVES)
    arena = scene.curves
    tmax = torch.full((o.shape[0],), RAY_MAX_T, device=dev)
    inc = _incoherent_lanes(dev, arena.node_rows, int(root[0]), o.shape[0], 41)
    return _check_walk(
        "curves", {"first-bounce": (root, o, d, tl), "incoherent": inc}, [("hair", {})],
        lambda lanes, any_hit: curves.walk(arena, *lanes[:3], 0.0, tmax, any_hit=any_hit),
        lambda lanes, any_hit, counts: crv.traverse(arena, *lanes[:3], 0.0, tmax,
                                                    any_hit=any_hit, counts=counts),
        (arena.node_rows.shape[0], arena.seg_rows.shape[0]),
        # 48-byte node rows and 160-byte leaf rows; in: o, d, tmax and root;
        # out: t, s and prim
        (48, 160), 24 + 4 + 4 + 12, OPS_CURVE_LEAF)


def lane_sets(kernel: str, st: dict, ua, out: dict, max_depth: int, nee_only: bool,
              tables=None) -> dict:
    """The lane sets of ops/surface.py's and ops/surface_v2.py's LANE_READS
    for one launch of kernel 5 ("surface", with its tables) or 6
    ("surface_v2") on the inputs st, ua and the plain version's outputs."""
    import torch

    alive = st["alive"]
    hit = alive & st["finite"]
    if kernel == "surface":
        is_sub = tables.mtab[st["mslot"].long(), 0] == 0
        light_hit = hit & (st["light_id"] >= 0)
    else:
        is_sub = st["mat_kind"] == 0
        light_hit = alive & st["is_light"]
    light_hit = light_hit & ~st["singular"] & (not nee_only)
    p_rr = st["throughput"].amax(1) / 0.1
    goes = hit & (st["depth"] < max_depth) & is_sub
    draws = goes & (p_rr < 1.0)
    reach = goes & ~(draws & (ua[:, 0] >= p_rr))
    sets = {"every": torch.ones_like(alive), "stopped": ~reach, "alive": alive, "hit": hit,
            "reach": reach, "failed": reach & ~out["alive"], "light_hit": light_hit,
            "roulette": draws}
    if kernel == "surface_v2":
        sets.update(nee_pre=reach & st["nee_pre"], nee_active=out["nee_active"])
    return sets


def lane_classes(sets: dict, out: dict) -> dict:
    """Lane counts by lifecycle: dead on entry, missed, ended on a hit
    (depth, roulette or a non-substitute material), reaching NEE, and of
    those with an active NEE sample and with a failed BSDF sample."""
    alive, hit, reach = sets["alive"], sets["hit"], sets["reach"]
    return {"dead": int((~alive).sum()), "missed": int((alive & ~hit).sum()),
            "ended_on_hit": int((hit & ~reach).sum()), "nee_reached": int(reach.sum()),
            "nee_active": int(out["nee_active"].sum()), "sample_failed": int(sets["failed"].sum())}


def shares(classes: dict) -> str:
    n = max(sum(classes[k] for k in ("dead", "missed", "ended_on_hit", "nee_reached")), 1)
    return ", ".join(f"{k} {v / n:.4f}" for k, v in classes.items())


def _field_bytes(fields) -> int:
    import torch

    return sum((1 if dt == torch.bool else 4) * max(w, 1) for _, dt, w in fields)


def lane_bound(mod, fields, out_fields, sets: dict, ops_reach: int) -> dict:
    """bound() of one launch of kernel 5 or 6 from the bytes its lanes need:
    every output written, and each input (and uniform column) read by the
    lanes of the sets mod.LANE_READS (mod.UNIFORM_READS) names for it; the
    operations of the lanes that reach NEE and of the hits that end before."""
    import functools
    import operator

    names = {name for name, _, _ in fields}
    if names != set(mod.LANE_READS):
        raise AssertionError(f"{mod.__name__}.LANE_READS does not name the kernel's inputs: "
                             f"{sorted(names ^ set(mod.LANE_READS))}")

    def lanes(set_names):
        return int(functools.reduce(operator.or_, (sets[k] for k in set_names)).sum())

    n = len(sets["every"])
    nbytes = n * _field_bytes(out_fields)
    nbytes += sum(_field_bytes([f]) * lanes(mod.LANE_READS[f[0]]) for f in fields)
    nbytes += sum(4 * cols * lanes(set_names) for _, cols, set_names in mod.UNIFORM_READS)
    ended = int((sets["hit"] & ~sets["reach"]).sum())
    return bound(nbytes, int(sets["reach"].sum()) * ops_reach + ended * OPS_ENDED_LANE)


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


def surface_inputs(scene, tables, s):
    """Kernel 5's lane fields and uniforms (st, ua, ub) for the path state
    s: its closest hits and fragments, as ops/surface.py's body makes them."""
    import torch
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

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
    return st, ua, ub


def check_surface(dev) -> dict:
    import torch
    from zyg_tpu_torch.ops import shade, surface

    scene = _trefoil(dev)
    tables = surface.pack_mesh_tables(scene)
    st, ua, ub = surface_inputs(scene, tables, _surface_lanes(N_MESH, dev))
    args = (4, True, False)  # the trefoil take: PTMIS at depth 4
    r1 = surface.surface(tables, st, ua, ub, *args)
    r2 = surface.surface_plain(tables, st, ua, ub, *args)
    torch.cuda.synchronize()
    err = compare_surface(r1, r2)
    sets = lane_sets("surface", st, ua, r2, args[0], args[2], tables)
    classes = lane_classes(sets, r2)
    log(f"surface: the check's lanes: {shares(classes)}")
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: surface.surface(tables, st, ua, ub, *args), 10),
        "device_ms": device_ms(lambda: surface.surface(tables, st, ua, ub, *args), "surface", 10),
        "plain_ms": time_ms(lambda: surface.surface_plain(tables, st, ua, ub, *args), 1, runs=3),
        **lane_bound(surface, shade._IN_FIELDS + surface.FRAG_FIELDS, surface._OUT_FIELDS, sets,
                     OPS_SURFACE_LANE),
        "library_ms": None,
        "lanes": classes,
    }


def _surface_lanes(n, dev):
    """The mesh checks' lane state: rays from [-4, 4]^3 aimed into
    [-1.5, 1.5]^3 (they hit the knot, the ground, a light or the dome)."""
    s = _shade_state(n, dev)
    s.o, s.d, _ = _mesh_rays(n, dev)
    s.mis_o, s.mis_n = s.o.clone(), s.d.clone()
    return s


def compare_surface_v2(r1: dict, r2: dict) -> float:
    """compare_bounce's rules at the mesh tolerances, plus the NEE lanes
    exact, their shadow tmax within rtol 1e-6 and pending values summed
    within rtol 2e-3."""
    import torch

    err = compare_bounce(r1, r2, MESH_BOUNCE_TOLS)
    if not torch.equal(r1["nee_active"], r2["nee_active"]):
        raise AssertionError("surface_v2: NEE lanes differ")
    nee = r1["nee_active"]
    torch.testing.assert_close(r1["shadow_tmax"][nee], r2["shadow_tmax"][nee], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(r1["nee"].double().sum(0), r2["nee"].double().sum(0), rtol=2e-3,
                               atol=1e-4)
    return err


def _check_surface_v2_on(label: str, fit, st: dict, ua, ub, args) -> dict:
    """Kernel 6 against its plain version on one launch's arguments, with
    the lanes' shares, times and bound."""
    import torch
    from zyg_tpu_torch.ops import surface_v2

    r1 = surface_v2.surface_v2(fit, st, ua, ub, *args)
    r2 = surface_v2.surface_v2_plain(st, ua, ub, *args)
    torch.cuda.synchronize()
    err = compare_surface_v2(r1, r2)
    sets = lane_sets("surface_v2", st, ua, r2, args[0], args[2])
    classes = lane_classes(sets, r2)
    log(f"{label}: the check's lanes: {shares(classes)}")
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: surface_v2.surface_v2(fit, st, ua, ub, *args), 10),
        "device_ms": device_ms(lambda: surface_v2.surface_v2(fit, st, ua, ub, *args), "surface_v2",
                               10),
        "plain_ms": time_ms(lambda: surface_v2.surface_v2_plain(st, ua, ub, *args), 1, runs=3),
        **lane_bound(surface_v2, surface_v2.IN_FIELDS, surface_v2.OUT_FIELDS, sets,
                     OPS_SURFACE_V2_LANE),
        "library_ms": None,
        "lanes": classes,
    }


def check_surface_v2(dev) -> dict:
    """Kernel 6 on the bench textured scene's own lane inputs: the general
    bounce's glue output for one bounce of 921,600 lanes."""
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    _, scene = _textured(dev, ci=False)
    body = surface_v2.make_mesh_fused_body_v2(scene, PtmisSettings(max_depth=4))
    st, ua, ub, *_ = body.inputs(_surface_lanes(N_MESH, dev))
    textured = int((st["finite"] & (st["mat_kind"] == 0)).sum())
    log(f"surface_v2: {int(st['alive'].sum())} live lanes, {textured} on surfaces, "
        f"{int(st['is_light'].sum())} on the dome")
    # the bench's PTMIS at depth 4
    return _check_surface_v2_on("surface_v2", body.fit, st, ua, ub, (4, True, False))


def first_bounce_lanes(dev, take_name, res):
    """Kernel 6's arguments in the first bounce of one render of a take at
    res (one sample a pixel), caught at the wrapper: (fit, lane fields, ua, ub, (max_depth, caustics,
    nee_only))."""
    import torch
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take(take_name, res, 1)
    driver = Driver(take, load_scene_file(take.scene_filename), device=dev)
    orig = surface_v2.surface_v2
    caught = []

    def catch(fit, st, ua, ub, *args):
        if not caught:
            caught.append((fit, {k: v.clone() for k, v in st.items()}, ua.clone(), ub.clone(),
                           args))
        return orig(fit, st, ua, ub, *args)

    surface_v2.surface_v2 = catch
    try:
        driver.start_frame()
        driver.render_iterations(1)
        torch.cuda.synchronize()
    finally:
        surface_v2.surface_v2 = orig
    return caught[0]


def check_surface_v2_hero(dev) -> dict:
    """Kernel 6 on hero.take's own lanes: the first bounce of a 1280x720
    render, whose knot lanes carry the analytic checker's albedo and a
    roughness that varies per lane (the baked Mix/Noise graph)."""
    import torch

    fit, st, ua, ub, args = first_bounce_lanes(dev, "hero.take", HERO_RES)
    on = st["alive"] & st["finite"] & (st["mat_kind"] == 0)
    alpha = st["alpha"][on]
    log(f"surface_v2 on hero: {int(st['alive'].sum())} live lanes, {int(on.sum())} on surfaces, "
        f"their alpha in [{float(alpha.min()):.6f}, {float(alpha.max()):.6f}] with "
        f"{int(torch.unique(alpha).numel())} values")
    return _check_surface_v2_on("surface_v2 on hero", fit, st, ua, ub, args)


def check_surface_v2_portal(dev) -> dict:
    """Kernel 6 on portal.take's own lanes: the first bounce of a 512x384
    render, whose NEE candidates toward the portal carry the windowed
    distribution's pdfs and whose camera rays through the window end on
    the portal's emission."""
    fit, st, ua, ub, args = first_bounce_lanes(dev, "portal.take", PORTAL_RES)
    log(f"surface_v2 on portal: {int(st['alive'].sum())} live lanes, "
        f"{int((st['alive'] & st['is_light']).sum())} on the window's emission, "
        f"{int(st['nee_pre'].sum())} with a NEE candidate")
    return _check_surface_v2_on("surface_v2 on portal", fit, st, ua, ub, args)


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
    """128x128, GATE_SPP (4) spp on the card (kernels) against the plain CPU path
    (the CPU render is the costly half)."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    take = _take("cornell_ptmis.take", (128, 128), GATE_SPP)
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"slice 128x128x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


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
    """The CI textured trefoil at 96x56, 4 spp on the card against the
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
    _golden_gate(card, cpu, f"textured trefoil 96x56x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_mesh(dev) -> None:
    """The CI trefoil at 96x56, 4 spp on the card against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    take, scene = _ci_trefoil((96, 56), GATE_SPP)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"trefoil 96x56x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_sunsky(dev) -> None:
    """sunsky.take at 96x56, 4 spp, depth 4 on the card against the plain
    CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take("sunsky.take", (96, 56), GATE_SPP)
    take.integrator.max_depth_surface = 4
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"sunsky 96x56x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_hero(dev) -> None:
    """hero.take at 96x56, 4 spp, depth 5 on the card against the plain
    CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take("hero.take", (96, 56), GATE_SPP)
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"hero 96x56x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_portal(dev) -> None:
    """portal.take at 96x72, 4 spp, depth 8, and a canopy + IES scene the
    script writes at 96x72, 4 spp, on the card against the plain CPU
    path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take("portal.take", (96, 72), GATE_SPP)
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"portal 96x72x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        take, scene = _canopy_ies_scene(tmp, (96, 72), GATE_SPP)
        t0 = time.perf_counter()
        card = Driver(take, scene, device=dev).render_frame()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = Driver(take, scene, device="cpu").render_frame()
        t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"canopy + IES 96x72x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


# an LM-63 profile with its beam down the lamp's normal
IES_TEXT = """IESNA:LM-63-2002
TILT=NONE
1 1000.0 1 5 1 1 1 0.1 0.1 0.1
1.0 1.0 0.0
0 22.5 45 90 180
0
1000 800 50 0 0
"""


def _canopy_ies_scene(tmp, res, spp):
    """(take, scene) of a scene written to tmp: a Canopy with a seeded PNG
    emission map (its env sampler's disk mapping) beside a downward
    Rectangle lamp with an IES profile, over a floor with a sphere and a
    metal cube, PTMIS depth 6, loaded from its files by the port's
    loader."""
    import numpy as np
    from zyg_tpu_torch.io.png import write_png
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.scene.loader import load_scene_file, read_transformation

    rng = np.random.default_rng(23)
    sky = rng.integers(60, 200, (64, 64, 3)).astype(np.uint8)
    sky[8:20, 36:52] = 255  # a bright patch off the disk's center
    write_png(os.path.join(tmp, "canopy.png"), sky)
    with open(os.path.join(tmp, "spot.ies"), "w", encoding="utf-8") as f:
        f.write(IES_TEXT)
    root = {
        "materials": [
            {"name": "sky", "rendering": {"Light": {"emittance": {
                "value": 1.5, "emission_map": {"file": "canopy.png"}}}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {
                "value": 8.0, "spectrum": [1.0, 0.9, 0.7], "profile": {"file": "spot.ies"}}}}},
            {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5],
                                                           "roughness": 0.7}}},
            {"name": "ball", "rendering": {"Substitute": {"color": [0.7, 0.3, 0.2],
                                                          "roughness": 0.3}}},
            {"name": "box", "rendering": {"Substitute": {"color": [0.9, 0.8, 0.5],
                                                         "roughness": 0.2, "metallic": 1.0}}},
        ],
        "entities": [
            {"type": "Light", "shape": {"type": "Canopy"}, "materials": ["sky"],
             "transformation": {"rotation": [80, 25, 0]}},
            {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"],
             "transformation": {"position": [0.3, 2.4, 0.2], "rotation": [-90, 0, 0],
                                "scale": [0.8, 0.8, 1]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"rotation": [90, 0, 0], "scale": [12, 12, 1]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["ball"],
             "transformation": {"position": [-0.8, 0.7, 0.3], "scale": [1.4, 1.4, 1.4]}},
            {"type": "Prop", "shape": {"type": "Cube"}, "materials": ["box"],
             "transformation": {"position": [1.0, 0.5, -0.4], "rotation": [0, 25, 0]}},
        ],
    }
    path = os.path.join(tmp, "canopy_ies.scene")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(root, f)
    scene = load_scene_file(path)
    if scene.env is None or scene.env.canopy != (True,) or "ies" not in scene.mat_features:
        raise AssertionError("the canopy + IES scene lacks its canopy env entry or its profile")
    take = Take()
    take.num_samples_per_pixel = spp
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=6)
    cam = PerspectiveCamera(resolution=res, fov=np.deg2rad(60))
    tr = read_transformation({"position": [0, 2.2, -5.5], "look_at": [0, 0.8, 0]})
    cam.position, cam.rotation = tr.position, tr.rotation
    take.cameras = [cam]
    return take, scene


def portal_sampler_profile(dev, scene, spp: int) -> str:
    """The portal sampler's share of one render: its calls counted on the
    host around one render (sample_to in NEE, pdf_to in the BSDF-hit MIS,
    each at the full lane width), and one call of each at the path's
    196,608 lanes profiled by device kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene import portal as portal_mod

    calls = {"sample_to": 0, "pdf_to": 0}
    orig = {k: getattr(portal_mod, k) for k in calls}

    def counting(name):
        def fn(*args):
            calls[name] += 1
            return orig[name](*args)
        return fn

    driver = Driver(_take("portal.take", PORTAL_RES, spp), scene, device=dev)
    for k in calls:
        setattr(portal_mod, k, counting(k))
    try:
        driver.start_frame()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
    finally:
        for k, fn in orig.items():
            setattr(portal_mod, k, fn)
    scene = driver.scene  # on the card
    ((_, pp), pd), = scene.portals.items()
    geo = (scene.prop_rot[pp], scene.prop_pos[pp], scene.prop_scale[pp])
    g = torch.Generator(device="cpu").manual_seed(5)
    p = (torch.rand((N_PORTAL, 3), generator=g) * torch.tensor([3.6, 2.8, 3.6])
         - torch.tensor([1.8, -0.1, 1.8])).to(dev)
    xi = torch.rand((N_PORTAL, 2), generator=g).to(dev)
    res = portal_mod.sample_to(pd, *geo, p, xi)
    portal_mod.pdf_to(pd, *geo, p, res["wi"])
    torch.cuda.synchronize()
    lines = []
    for name, fn in (("sample_to", lambda: portal_mod.sample_to(pd, *geo, p, xi)),
                     ("pdf_to", lambda: portal_mod.pdf_to(pd, *geo, p, res["wi"]))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name: dict[str, list] = {}
        for ev, sec in device_events(prof):
            row = by_name.setdefault(ev, [0.0, 0])
            row[0] += sec
            row[1] += 1
        launches = sum(v[1] for v in by_name.values())
        dev_s = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        lines.append(f"{name}: {calls[name]} calls a render, {launches} launches and "
                     f"{dev_s * 1e3:.4f} ms of device time a call at {N_PORTAL} lanes "
                     f"({calls[name] * dev_s:.4f} s a render); led by " + "; ".join(
                         f"{ev[:60]} {sec * 1e3:.4f} ms x{c}" for ev, (sec, c) in top))
    return "portal sampler: " + " | ".join(lines)


def _tree_scene(res, spp):
    """(take, scene): two downward rectangle lamps of different powers under
    a constant dome, over a floor with a sphere and a metal cube (analytic
    props; two lights, one finite, so NEE selects through the light tree),
    PTMIS depth 4, loaded by the port's scene loader."""
    import numpy as np
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.scene.loader import load_scene_dict, read_transformation

    def lamp(name, pos, rot, scale):
        return {"type": "Light", "shape": {"type": "Rectangle"}, "materials": [name],
                "transformation": {"position": pos, "rotation": rot, "scale": scale}}

    def mat(name, body):
        return {"name": name, "rendering": body}

    root = {
        "materials": [
            mat("l0", {"Light": {"emittance": {"value": 14.0}}}),
            mat("l1", {"Light": {"emittance": {"value": 5.0}}}),
            mat("sky", {"Light": {"emittance": {"value": 0.2}}}),
            mat("floor", {"Substitute": {"color": [0.5, 0.5, 0.5], "roughness": 0.7}}),
            mat("ball", {"Substitute": {"color": [0.7, 0.3, 0.2], "roughness": 0.3}}),
            mat("box", {"Substitute": {"color": [0.9, 0.8, 0.5], "roughness": 0.2,
                                       "metallic": 1.0}}),
        ],
        "entities": [
            lamp("l0", [-1.5, 3.0, -0.5], [-80, 20, 0], [1.0, 0.6, 1]),
            lamp("l1", [2.0, 2.4, 1.0], [-100, 200, 0], [0.8, 0.8, 1]),
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"rotation": [90, 0, 0], "scale": [12, 12, 1]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["ball"],
             "transformation": {"position": [-0.8, 0.7, 0.3], "scale": [1.4, 1.4, 1.4]}},
            {"type": "Prop", "shape": {"type": "Cube"}, "materials": ["box"],
             "transformation": {"position": [1.0, 0.5, -0.4], "rotation": [0, 25, 0],
                                "scale": [1, 1, 1]}},
        ],
    }
    scene = load_scene_dict(root)
    if scene.light_tree is None or scene.light_tree.num_finite != 2:
        raise AssertionError("the two-lamp scene has no light tree over its lamps")
    take = Take()
    take.num_samples_per_pixel = spp
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    cam = PerspectiveCamera(resolution=res, fov=np.deg2rad(55))
    tr = read_transformation({"position": [0, 3.0, -6.5], "look_at": [0, 0.6, 0]})
    cam.position, cam.rotation = tr.position, tr.rotation
    take.cameras = [cam]
    return take, scene


def phase_slice_tree(dev) -> None:
    """The two-lamp tree scene at 96x96, 4 spp on the card against the
    plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    take, scene = _tree_scene((96, 96), GATE_SPP)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"two lamps + dome (light tree) 96x96x{GATE_SPP}",
                 f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_material(dev) -> None:
    """material_test.take at 96x72, 4 spp, depth 6 on the card against the
    plain CPU path (the general body, glass and BSDF splitting)."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take("material_test.take", (96, 72), GATE_SPP)
    take.integrator.max_depth_surface = 6
    scene = load_scene_file(take.scene_filename)
    t0 = time.perf_counter()
    card = Driver(take, scene, device=dev).render_frame()
    t_card = time.perf_counter() - t0
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = Driver(take, scene, device="cpu").render_frame()
    t_cpu = time.perf_counter() - t0
    _golden_gate(card, cpu, f"material_test 96x72x{GATE_SPP}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_slice_cornell_variants(dev) -> None:
    """The five integrator and sensor takes on Cornell at 96x96 (8 spp; AO
    16, aov_normals its own 1) on the card against the plain CPU path:
    cornell.take (PT, the scan path), cornell_filtered.take (Mitchell
    through the filtered flush), cornell_ao.take and
    cornell_aov_normals.take (the AOV integrator), cornell_aovs.take (an
    unshuffled dispatch through the general body), and its Albedo, Depth
    and ShadingNormal planes: on 99 % of the pixels within 1e-4, 1e-5 and
    1e-4."""
    import numpy as np
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    for name, spp in (("cornell.take", GATE_SPP), ("cornell_filtered.take", GATE_SPP),
                      ("cornell_ao.take", GATE_SPP), ("cornell_aov_normals.take", 1),
                      ("cornell_aovs.take", GATE_SPP)):
        take = _take(name, (96, 96), spp)
        scene = load_scene_file(take.scene_filename)
        t0 = time.perf_counter()
        card_d = Driver(take, scene, device=dev)
        card = card_d.render_frame()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_d = Driver(take, scene, device="cpu")
        cpu = cpu_d.render_frame()
        t_cpu = time.perf_counter() - t0
        _golden_gate(card, cpu, f"{name[:-5]} 96x96x{spp}", f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")
        for plane, atol in (("albedo", 1e-4), ("depth", 1e-5), ("shading_normal", 1e-4)):
            if plane not in card_d.aov_names:
                continue
            a, b = card_d.resolve_aov(plane), cpu_d.resolve_aov(plane)
            close = float(np.isclose(a, b, rtol=0, atol=atol).all(axis=-1).mean())
            log(f"{name[:-5]} 96x96x{spp} {plane} plane: {close:.4f} of the pixels within {atol}, "
                f"max difference {float(np.abs(a - b).max()):.3g}")
            if not np.isfinite(a).all() or close < 0.99:
                raise AssertionError(f"{name}: the card's {plane} plane disagrees with the CPU's")


def _strip_of_path(cam, start, end, radius):
    """Rows and columns (slices) of the pixels a sphere of `radius` crosses
    between world points start and end beyond its start (the strip its
    smear covers and its shutter-start image does not)."""
    import numpy as np

    w, h = cam.resolution
    ratio, z = h / w, 1.0 / np.tan(0.5 * cam.fov)

    def px(p):
        lp = np.asarray(cam.rotation, np.float64) @ (np.asarray(p, np.float64) - cam.position)
        return (lp[0] / lp[2] * z + 1.0) / 2.0 * w, (ratio - lp[1] / lp[2] * z) / (2 * ratio) * h

    (x0, y0), (x1, _) = px(start), px(end)
    r = px(np.asarray(start) + [radius, 0.0, 0.0])[0] - x0
    return (slice(int(round(y0 - r / 2)), int(round(y0 + r / 2))),
            slice(int(round(x0 + r)), int(round(min(x0 + 3 * r, x1)))))


def phase_slice_motion(dev) -> None:
    """forest.take at 96x56, 4 spp and motion.take at 96x56, 4 spp on the
    card against the plain CPU path, and motion.take's Sphere smeared on
    both: the mean of a strip across its path beyond its shutter-start
    place, at the take's shutter, against a render of the scene without
    motion (shutter [0, 0]): at least 2 % darker (the sky behind the
    strip is brighter than the moving red sphere) on both devices, and the
    card's strip within 1 % of the CPU's."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    for name, spp in (("forest.take", GATE_SPP), ("motion.take", GATE_SPP)):
        take = _take(name, (96, 56), spp)
        cam = take.cameras[0]
        t0_, t1_ = cam.frame_interval(0)
        strips = {}
        for label, t1 in (("", t1_), (" still", t0_)) if name == "motion.take" else (("", t1_),):
            scene = load_scene_file(take.scene_filename, time0=t0_, time1=t1)
            t0 = time.perf_counter()
            card = Driver(take, scene, device=dev).render_frame()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = Driver(take, scene, device="cpu").render_frame()
            t_cpu = time.perf_counter() - t0
            _golden_gate(card, cpu, f"{name[:-5]}{label} 96x56x{spp}",
                         f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")
            if name == "motion.take":
                rows, cols = _strip_of_path(cam, (-1.4, 0.0, 0.6), (0.0, 0.15, 0.6), 0.35)
                strips[label] = (float(card[rows, cols].mean()), float(cpu[rows, cols].mean()))
        if name == "motion.take":
            (mc, mp), (sc, sp) = strips[""], strips[" still"]
            log(f"motion 96x56x{spp}: the Sphere's strip (rows {rows.start}-{rows.stop}, columns "
                f"{cols.start}-{cols.stop}) mean card {mc:.6f} / cpu {mp:.6f} at the shutter, "
                f"card {sc:.6f} / cpu {sp:.6f} without motion")
            if not (mc < 0.98 * sc and mp < 0.98 * sp and abs(mc / mp - 1.0) < 0.01):
                raise AssertionError("motion: the card and the CPU do not agree that the Sphere "
                                     "is smeared across its path")


def phase_slice_sparks_hairball(dev) -> None:
    """sparks.take at 96x56, 4 spp over its frame-0 shutter (kernel 6 with
    the moving point walk) and hairball.take at 96x96, 4 spp, depth 4
    (the general body with the curve walk and the hair BSDF) on the card
    against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    for name, res, depth in (("sparks.take", (96, 56), None), ("hairball.take", (96, 96), 4)):
        take = _take(name, res, 4)
        if depth is not None:
            take.integrator.max_depth_surface = depth
        scene = load_scene_file(take.scene_filename, "cpu", *take.cameras[0].frame_interval(0))
        t0 = time.perf_counter()
        card = Driver(take, scene, device=dev).render_frame()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = Driver(take, scene, device="cpu").render_frame()
        t_cpu = time.perf_counter() - t0
        _golden_gate(card, cpu, f"{name[:-5]} {res[0]}x{res[1]}x4",
                     f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def lamp_root() -> dict:
    """A Substitute floor and ball under a Sphere lamp and a two-sided Disk
    lamp: kernel 6's bounce with both new light shapes (the light tree
    over two finite lights)."""
    return {
        "materials": [
            {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.48, 0.45],
                                                           "roughness": 0.7}}},
            {"name": "ball", "rendering": {"Substitute": {"color": [0.7, 0.25, 0.2],
                                                          "roughness": 0.35}}},
            {"name": "warm", "rendering": {"Light": {"emittance": {
                "spectrum": [1.0, 0.85, 0.6], "value": 40.0}}}},
            {"name": "cool", "rendering": {"Light": {"emittance": {
                "spectrum": [0.6, 0.8, 1.0], "value": 12.0}, "two_sided": True}}},
        ],
        "entities": [
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
             "transformation": {"rotation": [90, 0, 0], "scale": [8, 8, 1]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["ball"],
             "transformation": {"position": [0.2, 0.6, 0.3], "scale": [1.2, 1.2, 1.2]}},
            {"type": "Light", "shape": {"type": "Sphere"}, "materials": ["warm"],
             "transformation": {"position": [1.4, 2.2, -0.4], "scale": [0.3, 0.3, 0.3]}},
            {"type": "Light", "shape": {"type": "Disk"}, "materials": ["cool"],
             "transformation": {"position": [-1.2, 2.6, 0.8], "rotation": [-80, 20, 0],
                                "scale": [0.9, 0.9, 1]}},
        ],
    }


def phase_slice_caustics(dev) -> None:
    """caustics_photons.take at 96x56, 4 spp with 100,000 photon paths (the
    bake and the gather on each device) and the Sphere/Disk lamp scene at
    96x64, 4 spp through kernel 6, on the card against the plain CPU
    path."""
    import torch
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict, load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    take = _take("caustics_photons.take", (96, 56), GATE_SPP)
    take.photon.num_photons = 100_000
    scene = load_scene_file(take.scene_filename)
    imgs, secs = [], []
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        imgs.append(Driver(take, scene, device=device).render_frame())
        secs.append(time.perf_counter() - t0)
    _golden_gate(imgs[0], imgs[1], f"caustics 96x56x{GATE_SPP} (100,000 paths)",
                 f"card {secs[0]:.2f} s, cpu {secs[1]:.2f} s")
    take = load_take_dict({
        "camera": {"Perspective": {
            "parameters": {"fov": 65},
            "transformation": {"position": [0, 1.6, -3.8], "rotation": [16, 0, 0]},
            "resolution": [96, 64]}},
        "sampler": {"Sobol": {"samples_per_pixel": GATE_SPP}},
        "integrator": {"surface": {"PTMIS": {"depth": {"surface": 6}}}},
    })
    scene = load_scene_dict(lamp_root())
    if not structural_ok_mesh_v2(scene):
        raise AssertionError("the Sphere/Disk lamp scene does not take kernel 6's bounce")
    imgs, secs = [], []
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        imgs.append(Driver(take, scene, device=device).render_frame())
        secs.append(time.perf_counter() - t0)
    _golden_gate(imgs[0], imgs[1], f"Sphere/Disk lamps 96x64x{GATE_SPP}",
                 f"card {secs[0]:.2f} s, cpu {secs[1]:.2f} s")


def phase_slice_particles(dev) -> None:
    """cornell_particles.take at 64x64, 4 passes (the particle pass
    alone: 0 spp) on the card against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    torch.set_num_threads(os.cpu_count() or 1)
    take = _particles_take((64, 64), 4)
    scene = load_scene_file(take.scene_filename)
    imgs, secs, rays = [], [], []
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        d = Driver(take, scene, device=device)
        imgs.append(d.render_frame())
        secs.append(time.perf_counter() - t0)
        rays.append(d.rays_traced)
    _golden_gate(imgs[0], imgs[1], "cornell_particles 64x64 (4 passes)",
                 f"card {secs[0]:.2f} s, cpu {secs[1]:.2f} s; rays card {rays[0]}, cpu {rays[1]}")


def general_profile(driver, spp: int) -> str:
    """The general body's loop over one render, counted on the host around
    the calls (so the render is not timed): its iterations over all chunks
    (isect closest launches: one a bounce), and the share of lane-bounces
    and of samples that resume a parked split branch."""
    import torch
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.render.integrator import ptmis

    closest, resume = isect.closest_props, ptmis.resume_split
    calls = {"closest": 0, "resumed": 0, "lanes": 0}

    def counting_closest(*args, **kw):
        calls["closest"] += 1
        return closest(*args, **kw)

    def counting_resume(s):
        if s.split:
            calls["resumed"] += int(((~s.alive) & s.split["pending"]).sum())
            calls["lanes"] += s.alive.shape[0]
        return resume(s)

    isect.closest_props, ptmis.resume_split = counting_closest, counting_resume
    try:
        driver.start_frame()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
    finally:
        isect.closest_props, ptmis.resume_split = closest, resume
    w, h = driver.camera.resolution
    return (f"general body: {calls['closest']} iterations over all chunks (isect closest "
            f"launches); {calls['resumed']} split branches resumed, "
            f"{calls['resumed'] / max(calls['lanes'], 1):.4f} of the lanes stepped and "
            f"{calls['resumed'] / (w * h * spp):.4f} per sample")


def lane_shares(driver, spp: int, kernel: str) -> str:
    """The lifecycle shares (lane_classes) of kernel 5's or 6's lanes in
    the first bounce of one render of driver and over all its launches:
    each launch's inputs are classified on the host around the wrapper, so
    this render is not timed."""
    import torch
    from zyg_tpu_torch.ops import surface, surface_v2

    mod = surface if kernel == "surface" else surface_v2
    orig = getattr(mod, kernel)
    calls = []

    def counting(tables_or_fit, st, ua, ub, max_depth, caustics, nee_only):
        out = orig(tables_or_fit, st, ua, ub, max_depth, caustics, nee_only)
        sets = lane_sets(kernel, st, ua, out, max_depth, nee_only, tables_or_fit)
        calls.append(lane_classes(sets, out))
        return out

    setattr(mod, kernel, counting)
    try:
        driver.start_frame()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
    finally:
        setattr(mod, kernel, orig)
    total = {k: sum(c[k] for c in calls) for k in calls[0]}
    return (f"{kernel} lanes of the first bounce: {shares(calls[0])}; of all {len(calls)} "
            f"launches: {shares(total)}")


def device_events(prof) -> list:
    """(name, seconds) of each device event of a trace, read from the raw
    kineto events: prof.events() also builds a Python tree of every host
    event, which takes minutes for a render of ~400,000 launches."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.duration_ns() / 1e9) for e in raw
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:  # a torch without the raw event accessors
        return [(e.name, e.time_range.elapsed_us() / 1e6) for e in prof.events()
                if e.device_type == DeviceType.CUDA]


def profile_render(driver, spp: int, label: str, kernels, run=None) -> int:
    """Device kernel time of one warm render by kernel, from a torch.profiler
    trace, and the device's busy share of the profiled wall time (run: what
    renders after start_frame, by default spp samples). Returns the
    launches of kernels that are not the port's (the torch glue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        driver.start_frame()
        t0 = time.perf_counter()
        if run is not None:
            run()
        else:
            driver.render_iterations(spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name: dict[str, list] = {}
    for name, sec in device_events(prof):
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += sec
        row[1] += 1
    log(f"profile {label}: {sum(v[1] for v in by_name.values())} device events read in "
        f"{time.perf_counter() - t0:.1f} s")
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

    calls = []  # (finished, lanes) per flush, box or filtered
    origs = {name: getattr(ptmis, name) for name in ("flush_pixels", "flush_filtered")}

    def counting(orig):
        def flush(fb, pid, was_alive, alive, *rest, **kw):
            calls.append((int((was_alive & ~alive).sum()), pid.shape[0]))
            return orig(fb, pid, was_alive, alive, *rest, **kw)
        return flush

    for name, orig in origs.items():
        setattr(ptmis, name, counting(orig))
    try:
        driver.start_frame()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
    finally:
        for name, orig in origs.items():
            setattr(ptmis, name, orig)
    if not calls:  # the scan path flushes nothing
        return float("nan"), float("nan")
    width = max(w for _, w in calls)
    full = [f for f, w in calls if w == width]
    return sum(full) / (len(full) * width), sum(f for f, _ in calls) / sum(w for _, w in calls)


def _cli_run(take_name: str, kernels, spp: int | None = None, out_name: str = "out.png",
             companions: tuple = (), ppp: int | None = None) -> dict:
    """The user's entry point at the take's own size (with spp or ppp: on a
    copy of the take with that many samples or particles a pixel, written
    to a temporary directory), writing out_name (.png, .exr or .hdr) and the AOV
    companion files out_<name>.exr, which are read back (EXR with the
    port's read_exr); returns its kernel launch counts."""
    import numpy as np
    import torch
    from zyg_tpu_torch import cli, ops
    from zyg_tpu_torch.io.exr import read_exr

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, out_name)
        take_path = os.path.join(REPO, "examples/takes", take_name)
        if spp is not None or ppp is not None:
            with open(take_path) as f:
                body = json.load(f)
            body["scene"] = os.path.normpath(os.path.join(os.path.dirname(take_path),
                                                          body["scene"]))
            if spp is not None:
                body["sampler"]["Sobol"]["samples_per_pixel"] = spp
            if ppp is not None:
                body["integrator"]["particle"]["particles_per_pixel"] = ppp
            take_path = os.path.join(tmp, take_name)
            with open(take_path, "w") as f:
                json.dump(body, f)
        rc = cli.main(["-i", take_path, "-o", png, "-s"])
        torch.cuda.synchronize()
        if rc != 0 or os.path.getsize(png) < 1000:
            raise AssertionError(f"cli {take_name}: no image written")
        for f in [out_name] * out_name.endswith(".exr") + [f"out_{c}.exr" for c in companions]:
            ch = read_exr(os.path.join(tmp, f))
            planes = np.stack([ch[k] for k in sorted(ch)], axis=-1)
            if not np.isfinite(planes).all() or not np.abs(planes).max() > 0.0:
                raise AssertionError(f"cli {take_name}: {f} is not finite and non-zero")
            log(f"cli {take_name}: {f} read back, channels {sorted(ch)}, shape "
                f"{planes.shape}, mean {float(planes.mean()):.6f}")
    launches = ops.launch_counts()
    copy = f" at {spp} spp" if spp else (f" at {ppp} particles a pixel" if ppp else "")
    log(f"main path (cli {take_name}{copy}) launches: {launches}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"main path {take_name} never launched the {name} kernel")
    return launches


def _cli_frames(take_name: str, kernels) -> dict:
    """The CLI on the take at its own size for frames 0 and 1 (-f 0 -n 2):
    both images written, finite, and different (frame 1's shutter moves
    the animated props on); returns its kernel launch counts."""
    import numpy as np
    import torch
    from zyg_tpu_torch import cli, ops
    from zyg_tpu_torch.io.png import read_png

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.png")
        rc = cli.main(["-i", os.path.join(REPO, "examples/takes", take_name), "-o", out,
                       "-f", "0", "-n", "2", "-s"])
        torch.cuda.synchronize()
        frames = [read_png(os.path.join(tmp, f"out_{f:06d}.png")) for f in (0, 1)]
    if rc != 0 or os.path.exists(out):
        raise AssertionError(f"cli {take_name} -f 0 -n 2: rc {rc}, or the unnumbered name written")
    diff = float(np.abs(frames[0].astype(np.float64) - frames[1]).mean())
    log(f"cli {take_name} -f 0 -n 2: out_000000.png and out_000001.png written, "
        f"{frames[0].shape}, means {float(frames[0].mean()):.3f} / {float(frames[1].mean()):.3f}, "
        f"mean absolute difference {diff:.3f} (of 255)")
    if not diff > 0.0 or min(float(f.mean()) for f in frames) < 10:
        raise AssertionError(f"cli {take_name} -f 0 -n 2: the frames are blank or equal")
    launches = ops.launch_counts()
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"cli {take_name} -f 0 -n 2 never launched the {name} kernel")
    return launches


def _take_scene(take_name, res, spp, label):
    """The take at res and spp, and its scene over frame 0's shutter."""
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = _take(take_name, res, spp)
    t0 = time.perf_counter()
    scene = load_scene_file(take.scene_filename, "cpu", *take.cameras[0].frame_interval(0))
    log(f"{label}: scene load (with any mesh arena build) {time.perf_counter() - t0:.2f} s")
    return take, scene


def phase_main_path(dev, card: str, label: str, take, scene, kernels, lanes_of=None) -> dict:
    """A main path through the Driver at the take's resolution and spp:
    warm-up (WARMUP_SPP samples; one sample on the per-sample scan path), best of 3 (of 2 when a render takes over
    SLOW_RENDER_S: host drift exceeds a third run's worth there; once over
    VERY_SLOW_RENDER_S), one
    profiled render, one render for the peak memory and the flush shares
    (on the scan path, which flushes nothing, the peak is read over the
    timed renders), and with lanes_of ("surface" or "surface_v2") that
    kernel's lane shares in one more render, or ("general") the general
    body's iterations and split resumes. A render over SLOW_RENDER_S
    profiles only its first chunk, of at most SLOW_PROFILE_SPP samples (a
    trace of ~7,000 launches an iteration takes as long to read as to
    record), takes its lane shares or iterations over that many samples,
    and takes its peak memory over the timed renders, with no
    flush-share render. Once the script has run SCRIPT_BUDGET_S, a path
    is timed once, with no profile and no further render. A take with a photon
    map bakes it first, twice, each bake timed. Returns the kernel
    launches of one render."""
    import numpy as np
    import torch
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.render.driver import Driver

    res, spp = take.cameras[0].resolution, take.num_samples_per_pixel
    driver = Driver(take, scene, device=dev)
    if take.photon.num_photons > 0:
        # the frame's photon map, timed on its own (twice: the first bake
        # of a map this size allocates its buffers)
        for run in range(2):
            t0 = time.perf_counter()
            driver.bake_photons()
            torch.cuda.synchronize()
            log(f"{label}: photon bake {run} of {take.photon.num_photons} paths "
                f"{time.perf_counter() - t0:.4f} s, {int(driver._photon_map.cell_start[-1])} "
                f"valid photons, max_per_cell {driver._photon_map.max_per_cell}")
    driver.start_frame()
    driver.render_iterations(min(driver.chunk_size, WARMUP_SPP) if driver.persistent else 1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    best = None
    runs = 0
    late = time.perf_counter() - _CLOCK[0] > SCRIPT_BUDGET_S
    while runs < (1 if late else 3) and not (runs == 2 and best["seconds"] > SLOW_RENDER_S) \
            and not (runs == 1 and best["seconds"] > VERY_SLOW_RENDER_S):
        driver.start_frame()
        t0 = time.perf_counter()
        driver.render_iterations(spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs += 1
        if best is None or dt < best["seconds"]:
            best = {"seconds": dt, "rays": driver.rays_traced,
                    "iterations": driver.last_iterations, "all_iterations": driver.iterations,
                    "dispatches": len(driver.chunk_plan(spp)) * len(driver.tile_plan())}
    peak = torch.cuda.max_memory_allocated(dev)
    counts = ops.launch_counts()
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"{label} render never launched the {name} kernel")
    img = driver.resolve()
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        raise AssertionError(f"{label} image is not finite with a positive mean")
    per_render = {k: v // runs for k, v in counts.items()}
    log(f"{label} {res[0]}x{res[1]} {spp}spp [{card}]: {best['seconds']:.4f} s (best of {runs}), "
        f"{best['rays']} rays, "
        f"{best['iterations']} wavefront iterations in the last dispatch, "
        f"{best['all_iterations']} in all {best['dispatches']} dispatches (chunks x tiles), "
        f"{best['rays'] / best['seconds'] / 1e6:.2f} Mrays/s, image mean {float(img.mean()):.6f}, "
        f"launches per render {({k: v for k, v in per_render.items() if v})}")
    if late:
        log(f"{label} [{card}]: the script is past {SCRIPT_BUDGET_S:.0f} s: timed once, not "
            f"profiled; peak device memory of one render {peak} B ({peak / 2**30:.3f} GiB)")
        return per_render
    slow = best["seconds"] > SLOW_RENDER_S
    prof_spp = min(driver.chunk_size, SLOW_PROFILE_SPP, spp) if slow else spp
    glue = profile_render(driver, prof_spp,
                          f"{label} {res[0]}x{res[1]}{f' ({prof_spp} spp)' * (prof_spp != spp)} "
                          f"[{card}]", kernels)
    prof_iterations = max(driver.iterations, 1)
    shares = ""
    if driver.persistent and not slow:
        # one more render gives both the peak memory and the flush shares
        # (the host's counting adds a bool per lane and flush to the
        # device's tensors)
        torch.cuda.reset_peak_memory_stats(dev)
        full, mean = flush_share(driver, spp)
        peak = torch.cuda.max_memory_allocated(dev)
        shares = (f"; flushes finish {full:.4f} of the lanes of a full-width launch, {mean:.4f} "
                  f"over all launches")
    log(f"{label} [{card}]: peak device memory of one render {peak} B ({peak / 2**30:.3f} GiB); "
        f"glue launches per profiled render ({prof_spp} spp) {glue} "
        f"({glue / prof_iterations:.0f} an iteration){shares}")
    if lanes_of == "general":
        log(f"{label} [{card}]: {general_profile(driver, prof_spp)}"
            f"{f' ({prof_spp} spp)' * (prof_spp != spp)}")
    elif lanes_of:
        log(f"{label} [{card}]: {lane_shares(driver, prof_spp, lanes_of)}"
            f"{f' ({prof_spp} spp)' * (prof_spp != spp)}")
    return per_render


def phase_particles(dev, card: str) -> tuple[dict, dict]:
    """The lighttracer main path at cornell_particles.take's own 512x512:
    one pass timed (a warm-up, and the CLI's budget), the CLI at the
    take's 64 particles a pixel (a copy at PARTICLE_CLI_CUT_PPP where one
    pass times 64 would take over PARTICLE_CLI_BUDGET_S, said in the log),
    then the Driver's particle pass at PARTICLE_RENDER_PASSES passes: its
    time, rays, Mrays/s, peak memory and launches, and its first
    PARTICLE_PROFILE_PASSES passes profiled (busy share, glue launches a
    bounce, lt_splat's and isect's device time). Returns the CLI's and the
    render's kernel launches."""
    import numpy as np
    import torch
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.render.driver import Driver

    label = "cornell_particles"
    take, scene = _take_scene("cornell_particles.take", PARTICLE_RES, 0, label)
    take.num_particles_per_pixel = PARTICLE_RENDER_PASSES
    driver = Driver(take, scene, device=dev)
    driver.start_frame()
    t0 = time.perf_counter()
    driver.render_particles(1)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    cut = first * PARTICLE_PPP > PARTICLE_CLI_BUDGET_S
    log(f"{label}: one pass of {PARTICLE_RES[0] * PARTICLE_RES[1]} light paths {first:.4f} s "
        f"(the process's first: with its loads); {PARTICLE_PPP} passes would take "
        f"~{first * PARTICLE_PPP:.1f} s: the CLI renders "
        + (f"a copy of the take at {PARTICLE_CLI_CUT_PPP} particles a pixel" if cut
           else f"the take at its own {PARTICLE_PPP} particles a pixel"))
    cli = _cli_run("cornell_particles.take", PARTICLE_KERNELS,
                   ppp=PARTICLE_CLI_CUT_PPP if cut else None)
    mark(f"main path {label} cli")

    passes = PARTICLE_RENDER_PASSES
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    driver.start_frame()
    t0 = time.perf_counter()
    driver.render_particles(passes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts = ops.launch_counts()
    for name in PARTICLE_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{label} render never launched the {name} kernel")
    img = driver.resolve()
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        raise AssertionError(f"{label} image is not finite with a positive mean")
    # one camera splat a bounce that has live lanes
    bounces = counts["lt_splat"]
    log(f"{label} {PARTICLE_RES[0]}x{PARTICLE_RES[1]} {passes} passes [{card}]: {dt:.4f} s, "
        f"{driver.rays_traced} rays, {driver.rays_traced / dt / 1e6:.2f} Mrays/s, "
        f"{bounces / passes:.2f} bounces a pass, image mean {float(img.mean()):.6f}; peak "
        f"device memory {peak} B ({peak / 2**30:.3f} GiB); launches per render "
        f"{({k: v for k, v in counts.items() if v})}")
    # two passes profile in ~3 s with the trace read, so they run past the
    # script's budget too
    before = ops.launch_counts()["lt_splat"]
    prof = PARTICLE_PROFILE_PASSES
    glue = profile_render(driver, prof, f"{label} {PARTICLE_RES[0]}x{PARTICLE_RES[1]} "
                          f"({prof} passes) [{card}]", PARTICLE_KERNELS,
                          run=lambda: driver.render_particles(prof))
    prof_bounces = max(ops.launch_counts()["lt_splat"] - before, 1)
    log(f"{label} [{card}]: glue launches in {prof} profiled passes {glue} ({prof_bounces} "
        f"bounces, {glue / prof_bounces:.0f} a bounce)")
    return cli, counts


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


# ---------------------------------------------------------------------------
# mesh files, deforming meshes and emissive meshes: the files the paths load
# ---------------------------------------------------------------------------


def _displaced(mesh):
    """The second position frame of the deforming trefoil: each vertex
    pushed along its normal by a ripple of up to 0.12 and the whole knot
    shifted 0.15 along x (object units)."""
    import numpy as np

    p = mesh.positions
    bump = (0.12 * np.sin(5.0 * p[:, 0] + 3.0 * p[:, 1])).astype(np.float32)
    return (p + mesh.normals * bump[:, None] + np.float32([0.15, 0.0, 0.0])).astype(np.float32)


def _panel_glb(path: str, nx: int, emission, strength: float) -> None:
    """A .glb of one emissive nx x nx panel, 2 (nx - 1)^2 triangles facing
    down, under a node that lifts, tilts and widens it."""
    import struct

    import numpy as np

    x, z = np.meshgrid(np.linspace(-0.5, 0.5, nx), np.linspace(-0.5, 0.5, nx), indexing="ij")
    pos = np.stack([x, np.zeros_like(x), z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(nx - 1)[:, None] * nx + np.arange(nx - 1)[None]
    idx = np.concatenate([np.stack([i, i + nx + 1, i + 1], -1).reshape(-1, 3),
                          np.stack([i, i + nx, i + nx + 1], -1).reshape(-1, 3)]).astype(np.uint32)
    blob = pos.tobytes() + idx.tobytes()
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0, "translation": [0.0, 2.5, -0.3],
                      "rotation": [-0.08715574, 0.0, 0.0, 0.9961947], "scale": [3.0, 1.0, 2.0]}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                       "material": 0}]}],
           "materials": [{"name": "panel", "emissiveFactor": list(emission),
                          "extensions": {"KHR_materials_emissive_strength":
                                         {"emissiveStrength": strength}}}],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(pos),
                          "type": "VEC3"},
                         {"bufferView": 1, "componentType": 5125, "count": idx.size,
                          "type": "SCALAR"}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
                           {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": idx.nbytes}],
           "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


@functools.lru_cache(maxsize=1)
def slice_files() -> str:
    """A temporary directory (removed at exit) with the files this slice's
    paths load, written by the port's own writers: trefoil.sub (the
    proc:trefoil-512x480 mesh, its second position frame _displaced) and
    small.sub (the same at 128x120, for the card-vs-CPU gate), deform.scene
    and deform_small.scene (trefoil.scene's setup, its mesh from the
    .sub), panel.glb (an emissive panel of GLB_PANEL^2 cells' triangles)
    and glb.scene (the trefoil-512x480 over a floor, lit by the panel
    alone) with glb_small.scene (a 128x120 trefoil)."""
    import atexit

    from zyg_tpu_torch.io.mesh import load_mesh_file
    from zyg_tpu_torch.io.sub_mesh import write_sub_mesh

    tmp = tempfile.mkdtemp(prefix="zyg_slice_")
    atexit.register(shutil.rmtree, tmp, True)
    t0 = time.perf_counter()
    with open(os.path.join(REPO, "examples/scenes/trefoil.scene")) as f:
        tref = json.load(f)
    for name, proc in (("trefoil", "proc:trefoil-512x480"), ("small", "proc:trefoil-128x120")):
        m = load_mesh_file(proc)
        write_sub_mesh(os.path.join(tmp, f"{name}.sub"), m,
                       position_frames=[m.positions, _displaced(m)])
        root = json.loads(json.dumps(tref))
        root["entities"][0]["shape"]["file"] = f"{name}.sub"
        with open(os.path.join(tmp, "deform.scene" if name == "trefoil"
                               else "deform_small.scene"), "w") as f:
            json.dump(root, f)
    _panel_glb(os.path.join(tmp, "panel.glb"), GLB_PANEL, (1.0, 0.9, 0.75), 3.0)
    for name, proc in (("glb", "proc:trefoil-512x480"), ("glb_small", "proc:trefoil-128x120")):
        root = {"materials": [
            {"name": "grey", "rendering": {"Substitute": {"color": [0.6, 0.6, 0.6],
                                                          "roughness": 0.5}}},
            {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.45, 0.4]}}}],
            "entities": [
                {"type": "Prop", "shape": {"file": proc}, "materials": ["grey"],
                 "transformation": {"scale": [0.35, 0.35, 0.35]}},
                {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"],
                 "transformation": {"position": [0, -1.3, 0], "rotation": [90, 0, 0],
                                    "scale": [12, 12, 1]}},
                {"type": "Prop", "shape": {"file": "panel.glb"}}]}
        with open(os.path.join(tmp, f"{name}.scene"), "w") as f:
            json.dump(root, f)
    log(f"slice files (two-frame .sub meshes by write_sub_mesh, the emissive .glb, scenes) "
        f"written in {time.perf_counter() - t0:.2f} s")
    return tmp


def _slice_take(scene_name: str, res, spp: int):
    """trefoil.take over scene_name (a file of slice_files()) at res, spp."""
    from zyg_tpu_torch.io.take import load_take_file

    tmp = slice_files()
    with open(os.path.join(REPO, "examples/takes/trefoil.take")) as f:
        body = json.load(f)
    body["scene"] = os.path.join(tmp, scene_name)
    body["camera"]["Perspective"]["resolution"] = list(res)
    body["sampler"]["Sobol"]["samples_per_pixel"] = spp
    path = os.path.join(tmp, f"{os.path.splitext(scene_name)[0]}_{res[0]}x{res[1]}.take")
    with open(path, "w") as f:
        json.dump(body, f)
    return load_take_file(path)


def _slice_scene(scene_name: str, res, spp: int, label: str):
    """(take, scene) of a slice_files() scene, the load timed; for a scene
    with an emissive mesh, the primitive light tree's build timed apart:
    light_tree.build_light_tree run again on each tree's leaves (each
    triangle's centre, radius, cone, area and sidedness as the loader gave
    them), which must give the loaded tree back."""
    import numpy as np
    from zyg_tpu_torch.scene import loader
    from zyg_tpu_torch.scene.light_tree import build_light_tree

    take = _slice_take(scene_name, res, spp)
    t0 = time.perf_counter()
    scene = loader.load_scene_file(take.scene_filename, "cpu", *take.cameras[0].frame_interval(0))
    dt = time.perf_counter() - t0
    m = scene.meshes
    trees = scene.mesh_light_trees or {}
    spent = 0.0
    for tree, _ in trees.values():
        leaf = tree.light_leaf.numpy()
        ins = [getattr(tree, k).numpy()[leaf] for k in ("center", "radius", "cone", "power",
                                                         "two_sided")]
        t0 = time.perf_counter()
        again = build_light_tree(*ins, np.ones(len(leaf), bool))
        spent += time.perf_counter() - t0
        if not all(np.array_equal(getattr(again, k).numpy(), getattr(tree, k).numpy())
                   for k in ("center", "radius", "cone", "power", "child0", "light")):
            raise AssertionError(f"{label}: the primitive light tree built again from its "
                                 "leaves differs from the loaded one")
    tri = (f", {int(scene.lights.tri_count.sum())} emissive triangles, primitive light tree "
           f"build {spent:.2f} s ({', '.join(str(t.depth) for t, _ in trees.values())} "
           f"levels)" if scene.lights.tri_count is not None else "")
    log(f"{label}: scene load + arena build {dt:.2f} s ({m.tri_rows.shape[0]} leaf rows, "
        f"deforming {m.tri_rows_d is not None}{tri})")
    return take, scene


def check_traverse_deform(dev) -> dict:
    """The deforming form of the walk (traverse_deform, and
    traverse_anim_deform over a moving table) against its plain version,
    bit-exact: t, prim, u, v, prop and the any-hit flags. On the
    deforming trefoil of path A (491,520 triangles from trefoil.sub) at
    its 1280x720 camera lanes, 921,600, at seeded shutter times in [0, 1]
    (exactly 0 and 1 on some lanes, one NaN ray), closest and any-hit
    (shadow rays toward the lamp); then on a table whose one instance of
    the deforming mesh moves (the slerp and the lerp). Times the form
    beside the static form on the same lanes (the arena without its
    deltas) and its bound: each lane's inputs and outputs, the instance
    table and the arena with its leaf deltas, each read once, beside the
    work the plain walk counted (each leaf visit's test and lerp)."""
    import dataclasses

    import numpy as np
    import torch
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.render.camera import generate_rays
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    take, scene = _slice_scene("deform.scene", MESH_RES, MESH_SPP, "deforming trefoil")
    scene = scene.to(dev)
    arena, itab = scene.meshes, scene.mesh_instances
    if arena.tri_rows_d is None:
        raise AssertionError("traverse_deform: the .sub trefoil loaded without its second frame")
    w, h = MESH_RES
    n = w * h
    g = torch.Generator(device="cpu").manual_seed(29)
    pids = torch.arange(n)
    xy = torch.stack([pids % w, pids // w], dim=-1).to(dev)
    o, d = generate_rays(take.cameras[0].arrays(dev), xy, torch.rand((n, 2), generator=g).to(dev))
    o, d = o.contiguous(), d.contiguous()
    tl = torch.rand(n, generator=g).to(dev)
    tl[:4096], tl[4096:8192] = 0.0, 1.0
    d[8192] = float("nan")
    tmax = torch.full((n,), RAY_MAX_T, device=dev)
    prim = torch.ones(n, dtype=torch.bool, device=dev)

    def exact(k, p, what):
        for name, a, b in zip(("t", "prim", "u", "v", "prop"), k, p):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs from the plain walk on "
                                     f"{int((a != b).sum())} lanes")

    def run(tab, name, time_=tl, tm=tmax, any_hit=False, o_=o, d_=d):
        before = ops.launch_counts()[name]
        k = traverse.intersect_instances(arena, tab, o_, d_, 0.0, tm, "shadow" if any_hit
                                         else "camera", None if any_hit else prim,
                                         any_hit=any_hit, time=time_)
        if ops.launch_counts()[name] != before + 1:
            raise AssertionError(f"{name}: the walk did not launch {name}")
        return k

    k = run(itab, "traverse_deform")
    counts = {"nodes": 0, "leaves": 0}
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 0, prim, False, counts, time=tl)
    lamp = scene.prop_pos[int(scene.lights.prop[0])]
    hit = p[1] >= 0
    so = torch.where(hit[:, None], o + (p[0] - 1e-3)[:, None] * d, o).contiguous()
    sv = lamp[None] - so
    smax = torch.where(hit, sv.norm(dim=1), 0.0)
    sd = (sv / sv.norm(dim=1, keepdim=True)).contiguous()
    kb = run(itab, "traverse_deform", tm=smax, any_hit=True, o_=so, d_=sd)
    pb = traverse.traverse_plain(arena, itab, so, sd, 0.0, smax, 2, None, True, time=tl)
    torch.cuda.synchronize()
    traverse.check_errors(dev)
    exact(k, p, "traverse_deform")
    if not torch.equal(kb, pb):
        raise AssertionError(f"traverse_deform: {int((kb != pb).sum())} any-hit results differ")
    if int(k[1][8192]) != -1:
        raise AssertionError("traverse_deform: the NaN ray hit")
    still = traverse.intersect_instances(dataclasses.replace(arena, tri_rows_d=None,
                                                             attr_rows_d=None),
                                         itab, o, d, 0.0, tmax, "camera", prim)
    moved = float((still[1] != k[1]).float().mean())

    # a moving table over the deforming mesh: the slerp at entry, the lerp at each leaf
    host = {"node_rows": arena.node_rows.cpu().numpy(), "mesh_root": arena.mesh_root.cpu().numpy()}
    mtab = trimesh.build_instance_table(host, [dict(
        prop=0, mesh=0, rot=np.eye(3, dtype=np.float32), pos=np.zeros(3, np.float32),
        scale=np.full(3, 0.35, np.float32), rot1=rot([0, 25, 10]),
        pos1=np.float32([0.3, 0.1, 0.0]), scale1=np.full(3, 0.4, np.float32))]).to(dev)
    ka = run(mtab, "traverse_anim_deform")
    pa = traverse.traverse_plain(arena, mtab, o, d, 0.0, tmax, 0, prim, False, time=tl)
    kab = run(mtab, "traverse_anim_deform", tm=smax, any_hit=True, o_=so, d_=sd)
    pab = traverse.traverse_plain(arena, mtab, so, sd, 0.0, smax, 2, None, True, time=tl)
    torch.cuda.synchronize()
    traverse.check_errors(dev)
    exact(ka, pa, "traverse_anim_deform")
    if not torch.equal(kab, pab):
        raise AssertionError(f"traverse_anim_deform: {int((kab != pab).sum())} any-hit results "
                             "differ")
    log(f"traverse_deform on the deforming trefoil's {n} camera lanes: {int(hit.sum())} hit, "
        f"{int(pb.sum())} shadow rays blocked, every hit record and any-hit flag equal to the "
        f"plain walk's (times 0 and 1 on 8,192 lanes, a NaN ray); {moved:.4f} of the lanes hit "
        f"another triangle than at frame 0; the walks visited {counts['nodes']} node rows and "
        f"{counts['leaves']} leaf rows; traverse_anim_deform over a moving instance: "
        f"{int((pa[1] >= 0).sum())} hit, {int(pab.sum())} blocked, all equal")

    def walk(a=arena):
        return traverse.intersect_instances(a, itab, o, d, 0.0, tmax, "camera", prim, time=tl)

    static = dataclasses.replace(arena, tri_rows_d=None, attr_rows_d=None)
    arena_bytes = (arena.node_rows.numel() + arena.tri_rows.numel()
                   + arena.tri_rows_d.numel()) * 4

    def table_bytes(tab):  # trafo, world box and visibility of each instance
        return tab.trafo.shape[0] * (24 * 4 + 2 * 3 * 4 + 3)

    out = {
        "max_abs_err": 0.0,
        "ms": time_ms(walk, 5),
        "device_ms": device_ms(walk, "traverse_deform", 5),
        "static_ms": time_ms(lambda: walk(static), 5),
        "static_device_ms": device_ms(lambda: walk(static), "traverse", 5),
        "anyhit_ms": time_ms(lambda: traverse.intersect_instances(
            arena, itab, so, sd, 0.0, smax, "shadow", any_hit=True, time=tl), 5),
        "plain_ms": time_ms(lambda: traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 0, prim,
                                                            False, time=tl), 1, runs=1),
        # each lane's o, d, tmax, primary, time in and t, prim, u, v, prop
        # out; the table and the arena, its leaf deltas included, read once
        **bound(n * (29 + 4 + 20) + table_bytes(itab) + arena_bytes,
                counts["nodes"] * OPS_NODE + counts["leaves"] * (OPS_LEAF + OPS_DEFORM_LEAF)
                + n * OPS_INSTANCE),
        "library_ms": None,
    }
    anim_counts = {"nodes": 0, "leaves": 0}
    traverse.traverse_plain(arena, mtab, o, d, 0.0, tmax, 0, prim, False, anim_counts, time=tl)
    anim = {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: traverse.intersect_instances(arena, mtab, o, d, 0.0, tmax, "camera",
                                                           prim, time=tl), 5),
        "device_ms": device_ms(lambda: traverse.intersect_instances(
            arena, mtab, o, d, 0.0, tmax, "camera", prim, time=tl), "traverse_anim_deform", 5),
        "plain_ms": time_ms(lambda: traverse.traverse_plain(arena, mtab, o, d, 0.0, tmax, 0,
                                                            prim, False, time=tl), 1, runs=1),
        **bound(n * (29 + 4 + 20) + table_bytes(mtab) + arena_bytes,
                anim_counts["nodes"] * OPS_NODE
                + anim_counts["leaves"] * (OPS_LEAF + OPS_DEFORM_LEAF)
                + n * (OPS_INSTANCE + OPS_SLERP)),
        "library_ms": None,
    }
    log(f"traverse_deform: kernel {out['ms']:.4f} ms (device {out['device_ms']:.4f} ms) against "
        f"the static form on the same lanes {out['static_ms']:.4f} ms (device "
        f"{out['static_device_ms']:.4f} ms); any-hit {out['anyhit_ms']:.4f} ms; "
        f"traverse_anim_deform {anim['ms']:.4f} ms (device {anim['device_ms']:.4f} ms)")
    return {"traverse_deform": out, "traverse_anim_deform": anim}


def phase_slice_deform_glb(dev) -> None:
    """The deforming SUB trefoil (128x120, kernel 5) and the trefoil lit by
    the emissive glTF panel (kernel 6, the primitive light tree) at 96x56,
    4 spp on the card against the plain CPU path."""
    import torch
    from zyg_tpu_torch.render.driver import Driver

    torch.set_num_threads(os.cpu_count() or 1)
    for name in ("deform_small.scene", "glb_small.scene"):
        take, scene = _slice_scene(name, (96, 56), GATE_SPP, f"{name[:-6]} gate")
        t0 = time.perf_counter()
        card = Driver(take, scene, device=dev).render_frame()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = Driver(take, scene, device="cpu").render_frame()
        t_cpu = time.perf_counter() - t0
        _golden_gate(card, cpu, f"{name[:-6]} 96x56x{GATE_SPP}",
                     f"card {t_card:.2f} s, cpu {t_cpu:.2f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    mark("card and build")

    checks = {}
    for name, fn in (("sobol_block", check_sobol), ("isect", check_isect),
                     ("accum", check_accum), ("shade", check_shade),
                     ("surface", check_surface), ("surface_v2", check_surface_v2),
                     ("traverse", check_traverse), ("track", check_track),
                     ("accum_filtered", check_accum_filtered),
                     ("traverse_anim", check_traverse_anim)):
        res = fn(dev)
        checks.update(res if name == "track" else {name: res})
        torch.cuda.empty_cache()
    checks["traverse"]["forest"] = check_traverse_forest(dev)
    torch.cuda.empty_cache()
    checks["surface_v2"]["hero"] = check_surface_v2_hero(dev)
    torch.cuda.empty_cache()
    checks["surface_v2"]["portal"] = check_surface_v2_portal(dev)
    torch.cuda.empty_cache()
    checks["photon_gather"] = check_photon_gather(dev)
    torch.cuda.empty_cache()
    checks["lt_splat"] = check_lt_splat(dev)
    torch.cuda.empty_cache()
    checks["points"] = check_points(dev)
    torch.cuda.empty_cache()
    checks["curves"] = check_curves(dev)
    torch.cuda.empty_cache()
    checks.update(check_traverse_deform(dev))
    torch.cuda.empty_cache()
    for name in SOURCES:
        c = checks[name]
        lib = f", library {c['library_ms']:.4f} ms" if c["library_ms"] is not None else ""
        anyhit = f" (any-hit {c['anyhit_ms']:.4f} ms)" if "anyhit_ms" in c else ""
        if "static_ms" in c:
            anyhit += (f" (the static form on the same lanes {c['static_ms']:.4f} ms, device "
                       f"{c['static_device_ms']:.4f} ms)")
        if "all_lanes_ms" in c:
            anyhit = (f" (all lanes {c['all_lanes_ms']:.4f} ms, device {c['all_lanes_device_ms']:.4f} ms, "
                      f"plain {c['all_lanes_plain_ms']:.4f} ms, "
                      f"library {c['all_lanes_library_ms']:.4f} ms)")
        log(f"{name}: ok, max_abs_err {c['max_abs_err']:.3g}, kernel {c['ms']:.4f} ms "
            f"(device {c['device_ms']:.4f} ms){anyhit}, "
            f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}){lib} "
            f"[{card}]")
    for name, lanes in (("surface_v2", "hero"), ("surface_v2", "portal"), ("traverse", "forest")):
        h = checks[name][lanes]
        log(f"{name} on {lanes}'s lanes: ok, max_abs_err {h['max_abs_err']:.3g}, kernel "
            f"{h['ms']:.4f} ms (device {h['device_ms']:.4f} ms), plain {h['plain_ms']:.4f} ms, "
            f"bound {h['bound_ms']:.4f} ms ({h['bound_by']}) [{card}]")
    mark("kernel checks")
    for phase in (phase_slice, phase_slice_mesh, phase_slice_textured, phase_slice_sunsky,
                  phase_slice_hero, phase_slice_portal, phase_slice_tree, phase_slice_material,
                  phase_slice_smoke, phase_slice_fire, phase_slice_cornell_variants,
                  phase_slice_motion, phase_slice_caustics, phase_slice_particles,
                  phase_slice_sparks_hairball, phase_slice_deform_glb):
        phase(dev)
        mark(phase.__name__)
    # launches: the CLI runs of the Cornell, trefoil, sunsky, hero,
    # material, smoke and fire paths and one render of the textured path
    launches = {k: 0 for k in SOURCES}
    # the point-cloud and hair paths at their takes' own sizes: the CLI, then
    # the Driver (kernel 6's lane shares on sparks; hairball, which never
    # splits, takes no general_profile render: its iterations are in the
    # report)
    new_paths = {}
    for take_name, res, spp, kernels, lanes_of in (
            ("sparks.take", SPARKS_RES, SPARKS_SPP, SPARKS_KERNELS, "surface_v2"),
            ("hairball.take", HAIRBALL_RES, HAIRBALL_SPP, HAIRBALL_KERNELS, None)):
        label = f"{take_name[:-5]} PTMIS"
        cli_counts = _cli_run(take_name, kernels)
        for k in launches:
            launches[k] += cli_counts[k]
        new_paths[take_name] = (cli_counts, phase_main_path(
            dev, card, label, *_take_scene(take_name, res, spp, label), kernels,
            lanes_of=lanes_of))
        mark(f"main path {label}")
    # the mesh-file paths: the CLI on the take over the written scene, then
    # the Driver (the scene's load with its primitive light tree timed)
    slice_paths = {}
    for scene_name, label, kernels in (
            ("deform.scene", "deforming trefoil PTMIS", DEFORM_KERNELS),
            ("glb.scene", "emissive glTF PTMIS", GLB_KERNELS)):
        _slice_take(scene_name, MESH_RES, MESH_SPP)  # writes the take file the CLI reads
        cli_counts = _cli_run(os.path.join(slice_files(), f"{scene_name[:-6]}_{MESH_RES[0]}x"
                                           f"{MESH_RES[1]}.take"), kernels)
        for k in launches:
            launches[k] += cli_counts[k]
        slice_paths[scene_name] = (cli_counts, phase_main_path(
            dev, card, label, *_slice_scene(scene_name, MESH_RES, MESH_SPP, label), kernels))
        mark(f"main path {label}")
    for take_name, label, res, spp, kernels in (
            ("cornell_ptmis.take", "Cornell PTMIS", (1920, 1080), 16, CORNELL_KERNELS),
            ("trefoil.take", "trefoil PTMIS", MESH_RES, MESH_SPP, MESH_KERNELS)):
        cli_counts = _cli_run(take_name, kernels)
        for k in launches:
            launches[k] += cli_counts[k]
        phase_main_path(dev, card, label, *_take_scene(take_name, res, spp, label), kernels)
        mark(f"main path {label}")
    textured = phase_main_path(dev, card, "textured trefoil PTMIS", *_textured(dev, ci=False),
                               TEXTURED_KERNELS)
    for k in launches:
        launches[k] += textured[k]
    mark("main path textured trefoil")
    cli_counts = _cli_run("sunsky.take", SUNSKY_KERNELS)
    for k in launches:
        launches[k] += cli_counts[k]
    phase_main_path(dev, card, "sunsky PTMIS",
                    *_take_scene("sunsky.take", SUNSKY_RES, 32, "sunsky PTMIS"), SUNSKY_KERNELS,
                    lanes_of="surface_v2")
    mark("main path sunsky")
    hero_cli = _cli_run("hero.take", HERO_KERNELS)
    for k in launches:
        launches[k] += hero_cli[k]
    hero = phase_main_path(dev, card, "hero PTMIS",
                           *_take_scene("hero.take", HERO_RES, HERO_SPP, "hero PTMIS"),
                           HERO_KERNELS, lanes_of="surface_v2")
    mark("main path hero")
    portal_cli = _cli_run("portal.take", PORTAL_KERNELS, spp=CLI_CUT_SPP)
    for k in launches:
        launches[k] += portal_cli[k]
    take, scene = _take_scene("portal.take", PORTAL_RES, PORTAL_SPP, "portal PTMIS")
    portal = phase_main_path(dev, card, "portal PTMIS", take, scene, PORTAL_KERNELS,
                             lanes_of="surface_v2")
    log(f"portal PTMIS [{card}]: {portal_sampler_profile(dev, scene, SLOW_PROFILE_SPP)}")
    mark("main path portal")
    material_cli = _cli_run("material_test.take", MATERIAL_KERNELS, spp=CLI_CUT_SPP)
    for k in launches:
        launches[k] += material_cli[k]
    take, scene = _take_scene("material_test.take", MATERIAL_RES, MATERIAL_SPP, "material PTMIS")
    take.integrator.max_depth_surface = MATERIAL_DEPTH
    phase_main_path(dev, card, "material PTMIS", take, scene, MATERIAL_KERNELS,
                    lanes_of="general")
    mark("main path material")
    # smoke.take's own 64 spp through the CLI took 73-87 s: the CLI renders
    # a copy of the take at CLI_CUT_SPP, as fire's does
    smoke_cli = _cli_run("smoke.take", SMOKE_KERNELS, spp=CLI_CUT_SPP)
    for k in launches:
        launches[k] += smoke_cli[k]
    take, scene = _take_scene("smoke.take", SMOKE_RES, SMOKE_SPP, "smoke PTMIS")
    smoke = phase_main_path(dev, card, "smoke PTMIS", take, scene, SMOKE_KERNELS)
    mark("main path smoke")
    # fire.take's own 64 spp through the CLI would take ~70-120 s, as
    # smoke's did: the CLI renders a copy of the take at CLI_CUT_SPP
    fire_cli = _cli_run("fire.take", FIRE_KERNELS, spp=CLI_CUT_SPP)
    for k in launches:
        launches[k] += fire_cli[k]
    take, scene = _take_scene("fire.take", FIRE_RES, FIRE_SPP, "fire PTMIS")
    fire = phase_main_path(dev, card, "fire PTMIS", take, scene, FIRE_KERNELS)
    mark("main path fire")
    # the integrator and sensor variants on Cornell: the CLI on each take at
    # its own size (EXR outputs and AOV companion files read back), the
    # Driver at the same size, then cornell_filtered at 1080p and 16 spp
    # beside the box Cornell figure of the first main path
    slice_cli = {}
    for take_name, (res, spp, kernels) in SLICE_TAKES.items():
        out_name = {"cornell_filtered.take": "out.hdr", "cornell_aov_normals.take": "out.exr",
                    "cornell_aovs.take": "out.exr"}.get(take_name, "out.png")
        companions = ("albedo", "depth", "shading_normal") if take_name == "cornell_aovs.take" else ()
        scan = take_name == "cornell.take"  # the per-sample scan path
        slice_cli[take_name] = _cli_run(take_name, kernels, spp=SCAN_CUT_SPP if scan else None,
                                        out_name=out_name, companions=companions)
        for k in launches:
            launches[k] += slice_cli[take_name][k]
        label = take_name[:-5]
        phase_main_path(dev, card, label,
                        *_take_scene(take_name, res, SCAN_CUT_SPP if scan else spp, label),
                        kernels)
        mark(f"main path {label}")
    filtered = phase_main_path(
        dev, card, "cornell_filtered 1080p",
        *_take_scene("cornell_filtered.take", (1920, 1080), 16, "cornell_filtered 1080p"),
        FILTERED_KERNELS)
    mark("main path cornell_filtered 1080p")
    # the instancer and motion paths at their takes' own sizes: the CLI,
    # then the Driver (kernel 6's lane shares), then motion's frame pair
    paths = {}
    for take_name, res, spp, kernels in (("forest.take", FOREST_RES, FOREST_SPP, FOREST_KERNELS),
                                         ("motion.take", MOTION_RES, MOTION_SPP, MOTION_KERNELS)):
        label = f"{take_name[:-5]} PTMIS"
        cli_counts = _cli_run(take_name, kernels)
        for k in launches:
            launches[k] += cli_counts[k]
        paths[take_name] = (cli_counts, phase_main_path(
            dev, card, label, *_take_scene(take_name, res, spp, label), kernels,
            lanes_of="surface_v2"))
        mark(f"main path {label}")
    frames = _cli_frames("motion.take", MOTION_KERNELS)
    mark("motion frames 0-1")
    # the photon-map path at the take's own size: the CLI (bake and
    # render), then the Driver (the bake timed on its own, then the render)
    caustics_cli = _cli_run("caustics_photons.take", CAUSTICS_KERNELS, spp=CLI_CUT_SPP)
    for k in launches:
        launches[k] += caustics_cli[k]
    caustics = phase_main_path(
        dev, card, "caustics_photons PTMIS",
        *_take_scene("caustics_photons.take", CAUSTICS_RES, CAUSTICS_MAIN_SPP,
                     "caustics_photons PTMIS"), CAUSTICS_KERNELS)
    mark("main path caustics_photons")
    # the lighttracer path at the take's own size: the CLI, then the
    # Driver's particle pass
    particles_cli, particles = phase_particles(dev, card)
    for k in launches:
        launches[k] += particles_cli[k]
    mark("main path cornell_particles")
    measure_bounces(dev, card)
    mark("bounces")

    def entry(name):
        c = checks[name]
        return {"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "launches_of": "cli sparks.take + cli hairball.take + cli of trefoil.take "
                               "over the deforming .sub trefoil and over the emissive glTF "
                               "scene (1280x720, 4 spp) + cli "
                               "cornell_ptmis.take + cli trefoil.take + cli sunsky.take + cli "
                               "hero.take + cli portal.take, material_test.take, smoke.take "
                               "and fire.take (copies at 4 spp) + one 1280x720 4 spp "
                               "textured-trefoil render + cli cornell.take (a copy at 4 spp), "
                               "cornell_filtered.take, cornell_ao.take, "
                               "cornell_aov_normals.take and cornell_aovs.take + cli "
                               "forest.take + cli motion.take + cli caustics_photons.take (a "
                               "copy at 4 spp) + cli cornell_particles.take (a copy at 16 "
                               "particles a pixel where 64 would take over 20 s)",
                "launches_deform_cli": slice_paths["deform.scene"][0][name],
                "launches_deform_render": slice_paths["deform.scene"][1][name],
                "launches_glb_cli": slice_paths["glb.scene"][0][name],
                "launches_glb_render": slice_paths["glb.scene"][1][name],
                "launches_sparks_cli": new_paths["sparks.take"][0][name],
                "launches_sparks_render": new_paths["sparks.take"][1][name],
                "launches_hairball_cli": new_paths["hairball.take"][0][name],
                "launches_hairball_render": new_paths["hairball.take"][1][name],
                "launches_particles_cli": particles_cli[name],
                "launches_particles_render": particles[name],
                "launches_caustics_cli": caustics_cli[name],
                "launches_caustics_render": caustics[name],
                "launches_forest_cli": paths["forest.take"][0][name],
                "launches_forest_render": paths["forest.take"][1][name],
                "launches_motion_cli": paths["motion.take"][0][name],
                "launches_motion_render": paths["motion.take"][1][name],
                "launches_motion_frames_0_1": frames[name],
                "launches_cornell_variants_cli": sum(c[name] for c in slice_cli.values()),
                "launches_cornell_filtered_1080p_render": filtered[name],
                "launches_hero_cli": hero_cli[name],
                "launches_hero_render": hero[name],
                "launches_portal_cli": portal_cli[name],
                "launches_portal_render": portal[name],
                "launches_material": material_cli[name],
                "launches_smoke_render": smoke[name],
                "launches_fire_render": fire[name],
                "max_abs_err": c["max_abs_err"], "ms": c["ms"], "device_ms": c["device_ms"],
                "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"],
                # the emissive variant of the walk (fire grey and spectral)
                **({"emissive": c["emissive"]} if "emissive" in c else {}),
                # kernel 6 again on hero.take's and portal.take's own
                # first-bounce lanes, the traversal on forest.take's
                # and the walks on incoherent lanes
                **{lanes: {k: c[lanes][k] for k in ("max_abs_err", "ms", "device_ms",
                                                    "plain_ms", "bound_ms", "bound_by")}
                   for lanes in ("hero", "portal", "forest", "incoherent") if lanes in c},
                # the motion-blur variant's share of lanes equal bit for bit
                **({"exact_share": c["exact_share"]} if "exact_share" in c else {}),
                # the photon gather again on a dense map, the cap binding
                **({"dense": c["dense"]} if "dense" in c else {}),
                # the walks' any-hit forms, the point walk on the still arena
                # and what a thread a lane's warps would do on their lanes
                **{f: c[f] for f in ("anyhit_ms", "still_ms", "diagnosis")
                   if f in c and name in ("points", "curves")},
                # the deforming form beside the static form on the same lanes
                **{f: c[f] for f in ("anyhit_ms", "static_ms", "static_device_ms")
                   if f in c and name == "traverse_deform"}}

    print(json.dumps({"kernels": [entry(k) for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
