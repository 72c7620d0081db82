"""Fused multiply-add and a correctly rounded square root for the plain
torch versions.

The JAX package's arithmetic runs through XLA, whose CPU backend contracts
a multiply feeding an add into one fused multiply-add, and the port's CUDA
kernels call fmaf at the same places. Where a result is sensitive to that
single rounding (dot products feeding a ray-hit distance, the energy-fit
Horner chains), the plain versions use `fma` so that plain, kernel and
JAX round alike. torch has no float32 fma: a*b is exact in float64 for
float32 operands, so a float64 multiply-add rounded once to float32 gives
the fused result (up to double rounding, which needs a float64 sum that
lands exactly on a float32 midpoint).
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """a * b + c rounded once to float32; a, b, c tensors or floats, at
    least one of a, b a tensor."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).to(torch.float32)


def dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as a fused accumulation (the order of XLA's
    3-element reduction): fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a2, b2, fma(a1, b1, a0 * b0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded correctly, as XLA and CUDA's sqrtf (with
    IEEE square roots) round it: torch's vectorized CPU sqrt is off by one
    ulp on ~0.6 % of inputs. A float64 root rounded once to float32 is the
    correctly rounded float32 root."""
    return torch.sqrt(x.double()).to(torch.float32)
