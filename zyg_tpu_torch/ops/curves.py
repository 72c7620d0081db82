"""The curve walk over a scene's curve arena (counterpart of
zyg_tpu/scene/curves.py:290 `traverse`, an XLA while_loop in the JAX
package). Kernel: csrc/curves.cu over the skeleton of csrc/walk2.cuh
(ops/points.py tells it): persistent warps that refill finished
threads from a lane counter, with the 4 round-cone segment tests of the
lanes at a leaf, on the normalized direction, shared across the warp
and replayed in slot order by their lanes; an any-hit form. The plain
version is scene/curves.py `traverse`, which the wrapper runs for CPU
tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..scene import curves as crv

_KERNEL = register("curves", "zyg_curves",
                   [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
                    ctypes.c_void_p])


def _curves_cuda(arena, root, o, d, tmin: float, tmax, any_hit: bool):
    dev = o.device
    n = o.shape[0]
    check_cuda("curves.node_rows", arena.node_rows, torch.float32, dev)
    check_cuda("curves.seg_rows", arena.seg_rows, torch.float32, dev)
    check_cuda("curves.root", root, torch.int32, dev, (n,))
    check_cuda("curves.o", o, torch.float32, dev, (n, 3))
    check_cuda("curves.d", d, torch.float32, dev, (n, 3))
    check_cuda("curves.tmax", tmax, torch.float32, dev, (n,))
    if arena.node_rows.shape[1:] != (12,) or arena.seg_rows.shape[1:] != (4 * crv.SEG_F,):
        raise ValueError("curves: node rows must be [M, 12] and segment rows [G, 40]")
    for name, rows in (("node_rows", arena.node_rows), ("seg_rows", arena.seg_rows)):
        if rows.data_ptr() % 16:
            raise ValueError(f"curves.{name}: the kernel reads rows as 16-byte loads and needs "
                             "a 16-byte aligned tensor")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    s = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    ptrs = [arena.node_rows.data_ptr(), arena.seg_rows.data_ptr(), root.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmax.data_ptr(), t.data_ptr(), s.data_ptr(), prim.data_ptr(),
            counter.data_ptr()]
    if n > 0:
        _KERNEL((ctypes.c_void_p * len(ptrs))(*ptrs), int(any_hit), float(tmin), n,
                stream_handle(dev))
    return t, s, prim


def walk(arena, root, o, d, tmin: float, tmax, any_hit: bool = False):
    """(t [N], s [N], prim [N] int32) of the curve walk (scene/curves.py
    traverse): the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors. root int32[N] (-1: the lane does not walk)."""
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=o.device).expand(o.shape[0])
    if o.device.type == "cpu":
        return crv.traverse(arena, root, o, d, float(tmin), tmax, any_hit=any_hit)
    return _curves_cuda(arena, root, o, d, float(tmin), tmax.contiguous(), any_hit)
