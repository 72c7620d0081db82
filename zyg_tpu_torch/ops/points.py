"""The point-cloud walk over a scene's point arena (counterpart of
zyg_tpu/scene/points.py:205 `traverse`, an XLA while_loop in the JAX
package). Kernel: csrc/points.cu over the skeleton of csrc/walk2.cuh:
persistent warps that claim 32 lanes at a time from a lane counter and
refill finished threads, with the 4 point tests of the lanes that stand
at a leaf shared across the warp and replayed in slot order by their
lanes; a motion form lerps each center by the ray's shutter time, an
any-hit form stops at the first hit. The wrapper allocates the counter,
one int64 of scratch a launch, which the entry point zeroes on the
stream. The plain version is scene/points.py `traverse`, which the
wrapper runs for CPU tensors; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..scene import points as pts

_KERNEL = register("points", "zyg_points",
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
                    ctypes.c_void_p])


def _points_cuda(arena, root, o, d, tmin: float, tmax, time, any_hit: bool):
    dev = o.device
    n = o.shape[0]
    check_cuda("points.node_rows", arena.node_rows, torch.float32, dev)
    check_cuda("points.point_rows", arena.point_rows, torch.float32, dev)
    check_cuda("points.root", root, torch.int32, dev, (n,))
    check_cuda("points.o", o, torch.float32, dev, (n, 3))
    check_cuda("points.d", d, torch.float32, dev, (n, 3))
    check_cuda("points.tmax", tmax, torch.float32, dev, (n,))
    if arena.node_rows.shape[1:] != (12,) or arena.point_rows.shape[1:] != (4 * pts.POINT_F,):
        raise ValueError("points: node rows must be [M, 12] and point rows [G, 32]")
    for name, rows in (("node_rows", arena.node_rows), ("point_rows", arena.point_rows)):
        if rows.data_ptr() % 16:
            raise ValueError(f"points.{name}: the kernel reads rows as 16-byte loads and needs "
                             "a 16-byte aligned tensor")
    if arena.has_motion:
        check_cuda("points.time", time, torch.float32, dev, (n,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    ptrs = [arena.node_rows.data_ptr(), arena.point_rows.data_ptr(), root.data_ptr(),
            o.data_ptr(), d.data_ptr(), tmax.data_ptr(),
            time.data_ptr() if arena.has_motion else None, t.data_ptr(), prim.data_ptr(),
            counter.data_ptr()]
    if n > 0:
        _KERNEL((ctypes.c_void_p * len(ptrs))(*ptrs), int(any_hit), int(arena.has_motion),
                float(tmin), n, stream_handle(dev))
    return t, prim


def walk(arena, root, o, d, tmin: float, tmax, time=None, any_hit: bool = False):
    """(t [N], prim [N] int32) of the point walk (scene/points.py
    traverse): the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors. root int32[N] (-1: the lane does not walk); time
    float32[N], the shutter times a moving arena needs."""
    if arena.has_motion and time is None:
        raise ValueError("points: a moving arena needs the rays' shutter times")
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(o.shape[0])
    if o.device.type == "cpu":
        return pts.traverse(arena, root, o, d, float(tmin), tmax, time=time, any_hit=any_hit)
    return _points_cuda(arena, root, o, d, float(tmin), tmax.contiguous(), time, any_hit)
