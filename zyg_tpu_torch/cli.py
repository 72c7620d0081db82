"""Command-line interface, flag-compatible with the JAX package's CLI for
what the port renders: -i/--input take, -o/--output image (.png, .exr or
.hdr, by its extension; default <take>.png), -s/--stats, plus --device
(default cuda; no CPU fallback). Sensor AOV planes go beside the image as
<stem>_<name>.exr.

Usage: python -m zyg_tpu_torch -i examples/takes/cornell_ptmis.take -o out.png -s
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zyg_tpu_torch", description="zyg renderer on PyTorch/CUDA")
    p.add_argument("-i", "--input", required=True, help="take file")
    p.add_argument("-o", "--output", default="",
                   help="output image path: .png, .exr or .hdr (default <take>.png)")
    p.add_argument("-s", "--stats", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.output and os.path.splitext(args.output)[1].lower() not in (".png", ".exr", ".hdr"):
        raise SystemExit(f"zyg_tpu_torch: -o {args.output!r}: the port writes .png, .exr and .hdr")

    import torch

    from .io.take import load_take_file
    from .render.driver import Driver, resolve_device
    from .scene.loader import load_scene_file

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    take = load_take_file(args.input)
    scene = load_scene_file(take.scene_filename, device)
    print(f"Loading time {time.perf_counter() - t0:.3f} s")

    out = args.output or (os.path.splitext(os.path.basename(args.input))[0] + ".png")
    driver = Driver(take=take, scene=scene, device=device)
    t0 = time.perf_counter()
    driver.render_frame()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    render_time = time.perf_counter() - t0
    print(f"Render time {render_time:.3f} s")
    t0 = time.perf_counter()
    driver.export_frame(out)
    print(f"Export time {time.perf_counter() - t0:.3f} s")
    if args.stats:
        w, h = driver.camera.resolution
        spp = take.num_samples_per_pixel
        print(f"resolution {w}x{h}, {spp} spp, {driver.rays_traced / 1e6:.1f}M rays")
        print(f"{driver.rays_traced / render_time / 1e6:.1f} Mrays/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
