"""Per-pixel sample flush of the persistent wavefront (counterpart of
zyg_tpu/ops/accum.py's column flush together with the affine unpermute of
zyg_tpu/render/integrator/ptmis.py). Kernel: csrc/accum.cu.

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
from ..render.sensor import clamp_radiance

_KERNEL = register(
    "accum",
    "zyg_flush_pixels",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
)


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
