"""Per-pixel sample flushes of the persistent wavefront, box and filtered
(counterpart of zyg_tpu/ops/accum.py's column flush together with the
affine unpermute, the filtered unpermute and the drain splats of
zyg_tpu/render/integrator/ptmis.py). Kernels: csrc/accum.cu.

Each dispatch keeps one float32[N, 4] framebuffer (RGB plus the sample
count) by local pixel. A lane whose path ended in this step,
`was_alive & ~alive`, adds its clamped sample to its pixel's row:

    fb[pid[i]] += (clamp(e) + clamp(d) + clamp(x), 1)

in place, with e, d, x its emission, direct and indirect radiance and each
class clamped by its own limit (ref sensor.zig addSample, clamp).

Tolerance against an ordered sum (the plain version, the JAX package's
slot order): two lanes of one launch can finish samples of the same pixel,
so the kernel's atomic adds run in an order that varies from run to run.
RGB agrees within rtol 4e-6, about kmax float32 epsilons (absolute 4e-6
times the plane's max); counts are small integers in float32 and agree
exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..render.sensor import clamp_radiance, filter_eval

_KERNEL = register(
    "accum",
    "zyg_flush_pixels",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
)


_FILTERED = register(
    "accum_filtered",
    "zyg_flush_filtered",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
FILTERS = {"Blackman": 0, "Mitchell": 1}


def flush_rows(was_alive, alive, emission, direct, indirect, clamp_max) -> torch.Tensor:
    """[N, 4] rows the flush adds: the clamped sample and a count of 1 on
    finishing lanes, zeros elsewhere."""
    rgb = (clamp_radiance(emission, clamp_max[0]) + clamp_radiance(direct, clamp_max[1])
           + clamp_radiance(indirect, clamp_max[2]))
    rows = torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=1)
    return torch.where((was_alive & ~alive)[:, None], rows, 0.0)


def flush_plain(fb, pid, was_alive, alive, emission, direct, indirect, clamp_max) -> torch.Tensor:
    """Plain torch version: the rows above, then one indexed add by pixel
    (deterministic on the CPU)."""
    return fb.index_add_(0, pid, flush_rows(was_alive, alive, emission, direct, indirect,
                                            clamp_max))


def flush_pixels(fb: torch.Tensor, pid: torch.Tensor, was_alive: torch.Tensor, alive: torch.Tensor,
                 emission: torch.Tensor, direct: torch.Tensor, indirect: torch.Tensor,
                 clamp_max=(float("inf"),) * 3) -> torch.Tensor:
    """Add the samples that finished in this step to their pixels.

    fb: float32[P, 4], updated in place and returned. pid: int64[N], each
    lane's pixel in [0, P). was_alive, alive: bool[N]. emission, direct,
    indirect: float32[N, 3] (any row stride, unit column stride).
    clamp_max: the three classes' clamp limits (inf: no clamp)."""
    if fb.device.type == "cpu":
        return flush_plain(fb, pid, was_alive, alive, emission, direct, indirect, clamp_max)
    dev = fb.device
    n = pid.shape[0]
    check_cuda("flush_pixels.fb", fb, torch.float32, dev, (fb.shape[0], 4))
    if fb.data_ptr() % 16:
        raise ValueError("flush_pixels.fb: the kernel adds float4 rows; expected 16-byte alignment")
    check_cuda("flush_pixels.pid", pid, torch.int64, dev, (n,))
    check_cuda("flush_pixels.was_alive", was_alive, torch.bool, dev, (n,))
    check_cuda("flush_pixels.alive", alive, torch.bool, dev, (n,))
    planes = (emission, direct, indirect)
    for name, p in zip(("emission", "direct", "indirect"), planes):
        check_cuda(f"flush_pixels.{name}", p, torch.float32, dev, contiguous=False)
        if p.dim() != 2 or p.shape != (n, 3) or p.stride(1) != 1:
            raise ValueError(f"flush_pixels.{name}: expected [{n}, 3] rows with unit column stride")
    ptrs = (ctypes.c_void_p * 3)(*[p.data_ptr() for p in planes])
    strides = (ctypes.c_int64 * 3)(*[p.stride(0) for p in planes])
    limits = (ctypes.c_float * 3)(*[float(c) for c in clamp_max])
    if n > 0:
        _KERNEL(fb.data_ptr(), pid.data_ptr(), was_alive.data_ptr(), alive.data_ptr(), ptrs,
                strides, limits, n, stream_handle(dev))
    return fb


# ---------------------------------------------------------------------------
# The filtered flush
#
# Each lane whose sample finished (was_alive & ~alive; every lane where
# was_alive is None) adds its clamped sample to the (2r+1)^2 pixels around
# its own, r in {1, 2}: fb[t] += (rgb * w, w) with
# w = f(su - dx) * f(sv - dy), (su, sv) = sub_uv - 0.5, f the Blackman or
# Mitchell filter of render/sensor.py at radius r. Taps are visited dy
# outer, dx inner. Two footprint rules:
#   drop (the persistent path): a tap outside the frame, or outside the
#     dispatch's rows, adds nothing (zyg_tpu/render/integrator/
#     ptmis.py:1371-1375, :1495-1499), so border pixels renormalize;
#   clamp_edge (the scan path's Framebuffer.splat_filtered): taps past the
#     frame edge land on it (zyg_tpu/render/sensor.py:136-137).
#
# Tolerance against an ordered sum (the plain version): the kernel's
# atomics add a pixel's taps in an order that varies from run to run, so
# RGB and weights agree to float32 rounding of the pixel's sum of taps
# (Mitchell's negative lobes can cancel it: compare against the plane's
# magnitude, chip_smoke.py uses rtol 1e-5 of the plane's max); counts of
# the box flush are integers, filter weights are not.
# ---------------------------------------------------------------------------


def _radiance(planes, clamps) -> torch.Tensor:
    """The clamped sum of one to three radiance planes, in clamp_cur's
    order ((emission + direct) + indirect)."""
    rgb = clamp_radiance(planes[0], clamps[0])
    for p, c in zip(planes[1:], clamps[1:]):
        rgb = rgb + clamp_radiance(p, c)
    return rgb


def filtered_taps(pid, sub_uv, width: int, height: int, filter_name: str, radius: int,
                  clamp_edge: bool, rows: int, base: int = 0):
    """The footprint of each lane: (targets int64 [T, N], weights [T, N],
    valid bool [T, N]) over the T = (2r+1)^2 taps, dy outer, dx inner.
    targets are local rows (global pixel - base); an invalid tap adds
    nothing."""
    g = base + pid
    gx, gy = g % width, g // width
    su, sv = sub_uv[:, 0] - 0.5, sub_uv[:, 1] - 0.5
    offs = range(-radius, radius + 1)
    wx = [filter_eval(filter_name, su - dx, float(radius)) for dx in offs]
    wy = [filter_eval(filter_name, sv - dy, float(radius)) for dy in offs]
    tgt, wts, ok = [], [], []
    for iy, dy in enumerate(offs):
        for ix, dx in enumerate(offs):
            if clamp_edge:
                t = (torch.clamp(gy + dy, 0, height - 1) * width
                     + torch.clamp(gx + dx, 0, width - 1) - base)
                v = torch.ones_like(pid, dtype=torch.bool)
            else:
                t = pid + (dy * width + dx)
                v = (gx + dx >= 0) & (gx + dx < width) & (gy + dy >= 0) & (gy + dy < height)
            tgt.append(t)
            wts.append(wx[ix] * wy[iy])
            ok.append(v & (t >= 0) & (t < rows))
    return torch.stack(tgt), torch.stack(wts), torch.stack(ok)


def flush_filtered_plain(fb, pid, was_alive, alive, planes, clamps, sub_uv, width, height,
                         filter_name, radius, clamp_edge=False, base=0) -> torch.Tensor:
    """Plain torch version: the finishing lanes' tap rows, then one indexed
    add (deterministic on the CPU, in tap-major order)."""
    fin = (torch.ones_like(pid, dtype=torch.bool) if was_alive is None
           else was_alive & ~alive)
    idx = torch.nonzero(fin).squeeze(1)
    rgb = _radiance([p[idx] for p in planes], clamps)
    tgt, w, ok = filtered_taps(pid[idx], sub_uv[idx], width, height, filter_name, radius,
                               clamp_edge, fb.shape[0], base)
    rows = torch.cat([rgb[None] * w[:, :, None], w[:, :, None]], dim=2)
    return fb.index_add_(0, tgt[ok], rows[ok])


def flush_filtered(fb: torch.Tensor, pid: torch.Tensor, was_alive, alive, planes, clamps,
                   sub_uv: torch.Tensor, width: int, height: int, filter_name: str, radius: int,
                   clamp_edge: bool = False, base: int = 0) -> torch.Tensor:
    """Splat the samples that finished in this step, filtered, into fb.

    fb: float32[P, 4] (RGB, weight), updated in place and returned. pid:
    int64[N], each lane's local pixel in [0, P); the global pixel is
    base + pid, row-major in a width x height frame. was_alive, alive:
    bool[N], or both None when every lane finished (the scan path).
    planes: one to three float32[N, 3] radiance planes (any row stride,
    unit column stride), summed after clamping each by its limit in
    clamps. sub_uv: float32[N, 2] subpixel offsets. filter_name: Blackman
    or Mitchell; radius: 1 or 2."""
    if filter_name not in FILTERS or radius not in (1, 2):
        raise ValueError(f"flush_filtered: filter {filter_name!r} at radius {radius}")
    if (was_alive is None) != (alive is None):
        raise ValueError("flush_filtered: was_alive and alive come together")
    if fb.device.type == "cpu":
        return flush_filtered_plain(fb, pid, was_alive, alive, planes, clamps, sub_uv, width,
                                    height, filter_name, radius, clamp_edge, base)
    dev = fb.device
    n = pid.shape[0]
    check_cuda("flush_filtered.fb", fb, torch.float32, dev, (fb.shape[0], 4))
    if fb.data_ptr() % 16:
        raise ValueError("flush_filtered.fb: the kernel adds float4 rows; expected 16-byte "
                         "alignment")
    check_cuda("flush_filtered.pid", pid, torch.int64, dev, (n,))
    if was_alive is not None:
        check_cuda("flush_filtered.was_alive", was_alive, torch.bool, dev, (n,))
        check_cuda("flush_filtered.alive", alive, torch.bool, dev, (n,))
    check_cuda("flush_filtered.sub_uv", sub_uv, torch.float32, dev, (n, 2))
    if not 1 <= len(planes) <= 3 or len(clamps) != len(planes):
        raise ValueError("flush_filtered: one to three radiance planes, a clamp each")
    for k, p in enumerate(planes):
        check_cuda(f"flush_filtered.planes[{k}]", p, torch.float32, dev, contiguous=False)
        if p.dim() != 2 or p.shape != (n, 3) or p.stride(1) != 1:
            raise ValueError(f"flush_filtered.planes[{k}]: expected [{n}, 3] rows with unit "
                             "column stride")
    if n > 0:
        # a fifth of the lanes finish on the persistent path, each on an
        # unrelated pixel: the warp's threads share each sample's taps;
        # every lane finishes on the scan path, lane by pixel: a lane a thread
        _launch_filtered(fb, pid, was_alive, alive, planes, clamps, sub_uv, width, height,
                         filter_name, radius, clamp_edge, base, tap_major=was_alive is not None)
    return fb


def _launch_filtered(fb, pid, was_alive, alive, planes, clamps, sub_uv, width: int, height: int,
                     filter_name: str, radius: int, clamp_edge: bool, base: int,
                     tap_major: bool) -> None:
    """One launch of the filtered flush kernel on flush_filtered's checked
    arguments (n > 0): the warp's threads share each finishing sample's
    taps (tap_major), or one thread adds a lane's taps (csrc/accum.cu)."""
    ptrs = (ctypes.c_void_p * 3)(*[p.data_ptr() for p in planes])
    strides = (ctypes.c_int64 * 3)(*[p.stride(0) for p in planes])
    limits = (ctypes.c_float * 3)(*[float(c) for c in clamps])
    _FILTERED(fb.data_ptr(), fb.shape[0], pid.data_ptr(),
              None if was_alive is None else was_alive.data_ptr(),
              None if alive is None else alive.data_ptr(), ptrs, strides, limits, len(planes),
              sub_uv.data_ptr(), pid.shape[0], base, width, height, FILTERS[filter_name], radius,
              int(clamp_edge), int(tap_major), stream_handle(pid.device))
