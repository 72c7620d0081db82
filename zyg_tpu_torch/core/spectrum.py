"""Colour-space helpers of the host scene build (counterpart of
zyg_tpu/core/spectrum.py:35 `srgb_to_linear_np`)."""

from __future__ import annotations

import numpy as np


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    """sRGB-encoded values in [0, 1] -> linear, computed in float64 and
    rounded once to float32 (the texture arena is compared exactly)."""
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, np.power((c + 0.055) / 1.055, 2.4)).astype(np.float32)
