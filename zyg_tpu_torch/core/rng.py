"""uint32 hashing on torch tensors (counterpart of zyg_tpu/core/rng.py).

torch has no full uint32 arithmetic, so a u32 value travels in an int64
tensor holding [0, 2^32). Products are split into 16-bit halves so no
intermediate leaves int64's range; every result is masked back to 32 bits,
which reproduces uint32 wraparound exactly. Right shifts of a non-negative
int64 are logical. State that is stored (Sobol' sample, seeds) is kept as
int32 bit patterns: `to_i32` / `u32` convert between the two forms.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """Any integer tensor (int32 bit pattern or int64) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32); b may be an int or a tensor."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (hash-prospector), as in the JAX package."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(seed: torch.Tensor, v) -> torch.Tensor:
    seed = u32(seed)
    v = u32(v) if isinstance(v, torch.Tensor) else (int(v) & MASK)
    return (seed ^ ((v + ((seed << 6) & MASK) + (seed >> 2)) & MASK)) & MASK


def hash2_u32(key: torch.Tensor, counter) -> torch.Tensor:
    """Two-word mix: distinct streams per key, distinct draws per counter."""
    return hash_u32(hash_combine(hash_u32(key), counter))


def u32_to_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) via the mantissa trick."""
    f = to_i32((u32(bits) >> 9) | 0x3F800000).view(torch.float32)
    return f - 1.0
