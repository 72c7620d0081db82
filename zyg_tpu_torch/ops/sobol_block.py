"""One 5-D Owen-scrambled Sobol' block per lane (counterpart of
zyg_tpu/ops/sobol_block.py). Kernel: csrc/sobol_block.cu."""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..core.sobol import sobol_block_reference

_KERNEL = register(
    "sobol_block",
    "zyg_sobol_block",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_void_p],
)


def sobol_block_plain(sample: torch.Tensor, run_seed: torch.Tensor):
    """Plain torch version: the core/sobol.py chain, its direction sums by
    the kernel's byte-sliced table walk."""
    return sobol_block_reference(sample, run_seed)


def sobol_block(sample: torch.Tensor, run_seed: torch.Tensor):
    """(buffer float32[N, 5], next run seed int32[N]) for one block draw.

    sample, run_seed: int32[N] tensors holding u32 bit patterns."""
    if sample.device.type == "cpu":
        return sobol_block_plain(sample, run_seed)
    dev = sample.device
    n = sample.shape[0]
    check_cuda("sobol_block.sample", sample, torch.int32, dev, (n,))
    check_cuda("sobol_block.run_seed", run_seed, torch.int32, dev, (n,))
    buf = torch.empty((n, 5), dtype=torch.float32, device=dev)
    next_seed = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        _KERNEL(sample.data_ptr(), run_seed.data_ptr(), buf.data_ptr(),
                next_seed.data_ptr(), n, stream_handle(dev))
    return buf, next_seed
