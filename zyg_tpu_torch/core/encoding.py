"""Octahedral snorm16x2 normal words (counterpart of
zyg_tpu/core/encoding.py:22-88).

The mesh arena stores a triangle's three shading normals as three 32-bit
words (octahedral uv, two snorm16 halves) instead of nine floats. Packing
runs on the host in numpy at arena build; unpacking runs per lane in torch
on the words the fragment gathers (kept as int32, the uint32 bit pattern).
The unpack rounds as XLA rounds the JAX package's jitted decode: the
snorm scale is a multiplication by the folded reciprocal, the squared
length a fused accumulation and its root correctly rounded (core/fmath.py).

ref: src/base/math/vector.zig octEncode/octDecode.
"""

from __future__ import annotations

import numpy as np
import torch

from .fmath import dot3, sqrt


def oct_encode(n: np.ndarray) -> np.ndarray:
    """Host: unit vectors [..., 3] -> octahedral uv [..., 2] in [-1, 1]."""
    an = np.abs(n)
    denom = np.maximum(an[..., 0] + an[..., 1] + an[..., 2], 1e-20)
    u = n[..., 0] / denom
    v = n[..., 1] / denom
    # the lower hemisphere folds over the diagonal
    neg = n[..., 2] < 0.0
    fu = (1.0 - np.abs(v)) * np.where(u >= 0.0, 1.0, -1.0)
    fv = (1.0 - np.abs(u)) * np.where(v >= 0.0, 1.0, -1.0)
    return np.stack([np.where(neg, fu, u), np.where(neg, fv, v)], axis=-1)


def snorm16x2_pack(e: np.ndarray) -> np.ndarray:
    """Host: [..., 2] in [-1, 1] -> uint32 words (lo = x, hi = y)."""
    q = np.clip(np.round(np.asarray(e, np.float32) * 32767.0), -32767, 32767)
    q = q.astype(np.int32) & 0xFFFF
    return (q[..., 0] | (q[..., 1] << 16)).astype(np.uint32)


def oct_normal_pack(n) -> np.ndarray:
    """Host: unit normals [..., 3] -> uint32 oct-snorm16x2 words."""
    return snorm16x2_pack(oct_encode(np.asarray(n, np.float32)))


def oct_normal_unpack(w: torch.Tensor) -> torch.Tensor:
    """Device: int32 words (uint32 bit patterns) [...] -> unit normals [..., 3]."""
    w = w.to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(w, 16), 16)  # sign-extend
    hi = torch.bitwise_right_shift(w, 16)
    u = lo.to(torch.float32) * (1.0 / 32767.0)  # XLA folds the division
    v = hi.to(torch.float32) * (1.0 / 32767.0)
    z = 1.0 - torch.abs(u) - torch.abs(v)
    t = torch.clamp(-z, min=0.0)
    x = u - torch.where(u >= 0.0, t, -t)
    y = v - torch.where(v >= 0.0, t, -t)
    length = sqrt(dot3(x, x, y, y, z, z))
    inv = torch.clamp(length, min=1e-20)
    return torch.stack([x / inv, y / inv, z / inv], dim=-1)
