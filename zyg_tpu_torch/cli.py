"""Command-line interface, flag-compatible with the JAX package's CLI for
what the port renders: -i/--input take, -o/--output image (.png, .exr or
.hdr, by its extension; default <take>.png), -f/--start-frame and
-n/--num-frames, -s/--stats, plus --device (default cuda; no CPU
fallback). Sensor AOV planes go beside the image as <stem>_<name>.exr.

`render_frame` runs a take's photon bake, its particle pass (the
lighttracer's light paths) and its forward samples, in that order; -s
reports the particle pass's rays apart.

Each frame loads the scene with its animations resolved over the frame's
shutter interval (the camera's frame_interval) and renders it with a new
Driver. With more than one frame the images are <stem>_<frame:06d><ext>,
or, where the output name holds a run of '#', the frame number padded
to the run's width in its place (zyg_tpu/cli.py:58-110).

Usage: python -m zyg_tpu_torch -i examples/takes/cornell_ptmis.take -o out.png -s
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zyg_tpu_torch", description="zyg renderer on PyTorch/CUDA")
    p.add_argument("-i", "--input", required=True, help="take file")
    p.add_argument("-o", "--output", default="",
                   help="output image path: .png, .exr or .hdr (default <take>.png)")
    p.add_argument("-f", "--start-frame", type=int, default=0)
    p.add_argument("-n", "--num-frames", type=int, default=1)
    p.add_argument("-s", "--stats", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def frame_output(out: str, frame: int) -> str:
    """A sequence frame's image name: the first run of '#' replaced by the
    frame number padded to the run's width (ref file/system.zig
    frameDependantName, zyg_tpu/io/fs.py:67-79), else
    <stem>_<frame:06d><ext>."""
    m = re.search(r"#+", out)
    if m:
        return out[: m.start()] + str(frame).zfill(len(m.group(0))) + out[m.end() :]
    base, ext = os.path.splitext(out)
    return f"{base}_{frame:06d}{ext}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.output and os.path.splitext(args.output)[1].lower() not in (".png", ".exr", ".hdr"):
        raise SystemExit(f"zyg_tpu_torch: -o {args.output!r}: the port writes .png, .exr and .hdr")
    if args.num_frames < 1:
        raise SystemExit(f"zyg_tpu_torch: -n {args.num_frames}: at least one frame")

    import torch

    from .io.take import load_take_file
    from .render.driver import Driver, resolve_device
    from .scene.loader import load_scene_file

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    take = load_take_file(args.input)
    cam = take.cameras[0]
    scene = load_scene_file(take.scene_filename, device, *cam.frame_interval(args.start_frame))
    print(f"Loading time {time.perf_counter() - t0:.3f} s")

    out = args.output or (os.path.splitext(os.path.basename(args.input))[0] + ".png")
    render_time = 0.0
    for fi in range(args.num_frames):
        frame = args.start_frame + fi
        if fi > 0:
            # the next frame's shutter interval moves the animated props
            scene = load_scene_file(take.scene_filename, device, *cam.frame_interval(frame))
        driver = Driver(take=take, scene=scene, device=device)
        t0 = time.perf_counter()
        driver.render_frame()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        render_time += time.perf_counter() - t0
        print(f"Render time {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        driver.export_frame(frame_output(out, frame) if args.num_frames > 1 else out)
        print(f"Export time {time.perf_counter() - t0:.3f} s")
    if args.stats:
        w, h = driver.camera.resolution
        spp = take.num_samples_per_pixel
        print(f"resolution {w}x{h}, {spp} spp, {driver.rays_traced / 1e6:.1f}M rays")
        if take.num_particles_per_pixel > 0:
            # the particle pass (render_frame runs it before the forward samples)
            print(f"particle pass: {take.num_particles_per_pixel} light paths a pixel, "
                  f"{driver.particle_rays / 1e6:.1f}M rays")
        print(f"{driver.rays_traced / render_time / 1e6:.1f} Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
