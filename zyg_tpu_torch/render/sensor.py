"""Sensor: framebuffer accumulation, reconstruction filters and
tonemapping (counterpart of zyg_tpu/render/sensor.py). ref
rendering/sensor/."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.fmath import fma


@dataclass
class Clamp:
    """Per-class radiance clamp (ref sensor.zig Clamp)."""

    emission: float = np.inf
    direct: float = np.inf
    indirect: float = np.inf


@dataclass
class SensorSettings:
    clamp: Clamp
    filter_radius: float = 0.0  # 0 = box
    filter_name: str = "Blackman"  # Blackman | Mitchell
    alpha_transparency: bool = False
    tonemapper: str = "Linear"
    exposure: float = 0.0
    look: str = "Substitute"  # AgX ASC-CDL look (ref agx.zig Look)


class Framebuffer:
    """Weighted accumulation buffer, row-major [H*W]: one float32 [H*W, 4]
    tensor `rows` (R, G, B, weight), the layout the flush kernels add
    into; `value` and `weight` are views of it. The add methods update it
    in place and return it."""

    def __init__(self, value: torch.Tensor, weight: torch.Tensor):
        self.rows = torch.cat([value, weight[:, None]], dim=1).contiguous()

    @property
    def value(self) -> torch.Tensor:  # [H*W, 3]
        return self.rows[:, 0:3]

    @property
    def weight(self) -> torch.Tensor:  # [H*W]
        return self.rows[:, 3]

    @staticmethod
    def zeros(num_pixels: int, device: torch.device | str = "cpu") -> "Framebuffer":
        fb = Framebuffer.__new__(Framebuffer)
        fb.rows = torch.zeros((num_pixels, 4), dtype=torch.float32, device=device)
        return fb

    def add_box(self, radiance: torch.Tensor) -> "Framebuffer":
        """One full-frame pass in pixel order: box filter radius 0."""
        self.rows[:, 0:3] += radiance
        self.rows[:, 3] += 1.0
        return self

    def splat(self, pixel_ids: torch.Tensor, radiance: torch.Tensor,
              weights: torch.Tensor) -> "Framebuffer":
        """Indexed add of weighted samples (radiance * weight, weight)."""
        rows = torch.cat([radiance * weights[:, None], weights[:, None]], dim=1)
        self.rows.index_add_(0, pixel_ids.long(), rows)
        return self

    def splat_filtered(self, radiance: torch.Tensor, pixel_ids: torch.Tensor,
                       pixel_uv: torch.Tensor, width: int, height: int, filter_name: str,
                       radius: int) -> "Framebuffer":
        """Add each lane's sample to the (2r+1)^2 pixels around its pixel
        (pixel_ids int64[N], row-major), weighted by the filter at its
        subpixel offset pixel_uv [N, 2], taps past the frame edge clamped
        onto it (zyg_tpu/render/sensor.py:111-147): the scan path's splat,
        through the filtered flush (ops/accum.py), every lane finished."""
        from ..ops.accum import flush_filtered

        flush_filtered(self.rows, pixel_ids, None, None, (radiance,), (math.inf,), pixel_uv,
                       width, height, filter_name, radius, clamp_edge=True)
        return self

    def resolve(self) -> torch.Tensor:
        w = torch.where(self.weight > 0.0, self.weight, 1.0)
        return self.value / w[..., None]


def clamp_radiance(radiance: torch.Tensor, max_value: float) -> torch.Tensor:
    """ref buffer clamping: clamp each channel."""
    if not np.isfinite(max_value):
        return radiance
    return torch.clamp(radiance, max=max_value)


# ---------------------------------------------------------------------------
# Reconstruction filters (ref sensor.zig:27-58 tabulates them; evaluated
# analytically, as the JAX package does). Rounded as XLA's CPU backend
# rounds the JAX formulas, so that the plain versions, the filtered flush
# kernel (csrc/accum.cu) and the JAX package agree: Mitchell's polynomials
# fuse their first two products (fma(c0, x^3, c1 * x^2), and outside
# [0, 1) also fma(c2, x, .)) and divide by 6 as a multiplication by
# float32(1/6); Blackman fuses its 0.08 term. torch's and XLA's cos round
# an ulp apart on ~5 % of inputs, so Blackman weights agree with the JAX
# package within 2.4e-7 (the kernel's cosf and torch's on the card alike).
# ---------------------------------------------------------------------------

_MITCHELL_B = _MITCHELL_C = 1.0 / 3.0
# the two pieces' coefficients as the JAX formulas round them to float32
MITCHELL_INNER = tuple(float(np.float32(v)) for v in (
    12.0 - 9.0 * _MITCHELL_B - 6.0 * _MITCHELL_C, -18.0 + 12.0 * _MITCHELL_B + 6.0 * _MITCHELL_C,
    6.0 - 2.0 * _MITCHELL_B))
MITCHELL_OUTER = tuple(float(np.float32(v)) for v in (
    -_MITCHELL_B - 6.0 * _MITCHELL_C, 6.0 * _MITCHELL_B + 30.0 * _MITCHELL_C,
    -12.0 * _MITCHELL_B - 48.0 * _MITCHELL_C, 8.0 * _MITCHELL_B + 24.0 * _MITCHELL_C))
SIXTH = float(np.float32(1.0 / 6.0))
PI_F32 = float(np.float32(math.pi))
BLACKMAN_A2 = float(np.float32(0.08))


def blackman(x: torch.Tensor, r: float) -> torch.Tensor:
    """Blackman window over [-r, r]."""
    a = (x / r) * PI_F32
    w = fma(BLACKMAN_A2, torch.cos(2.0 * a), 0.42 + 0.5 * torch.cos(a))
    return torch.where(torch.abs(x) <= r, w, 0.0)


def mitchell(x: torch.Tensor) -> torch.Tensor:
    """Mitchell-Netravali cubic (B = C = 1/3) over [-2, 2]."""
    ax = torch.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    i0, i1, i2 = MITCHELL_INNER
    o0, o1, o2, o3 = MITCHELL_OUTER
    inner = (fma(i0, ax3, i1 * ax2) + i2) * SIXTH
    outer = (fma(o2, ax, fma(o0, ax3, o1 * ax2)) + o3) * SIXTH
    return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))


def filter_eval(name: str, x: torch.Tensor, radius: float) -> torch.Tensor:
    """The named filter at offset x for a filter of `radius` pixels
    (Mitchell's [-2, 2] support scaled onto [-radius, radius])."""
    if name == "Mitchell":
        return mitchell(x * (2.0 / radius))
    return blackman(x, radius)


# ---------------------------------------------------------------------------
# Tonemappers (ref rendering/sensor/tonemapper.zig, agx.zig)
# ---------------------------------------------------------------------------


def tonemap_linear(c):
    return c


def tonemap_aces(c):
    """ACES fitted (Hill/Narkowicz-style fit used by the reference)."""
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(a / b, 0.0, 1.0)


def tonemap_pbr_neutral(c):
    """Khronos PBR Neutral."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15
    x = torch.amin(c, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = c - offset
    peak = torch.amax(c, dim=-1, keepdim=True)
    need = peak >= start_compression
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / (peak + d - start_compression)
    scaled = c * (new_peak / torch.clamp(peak, min=1e-8))
    g = 1.0 - 1.0 / (desaturation * (peak - new_peak) + 1.0)
    compressed = (1.0 - g) * scaled + g * new_peak
    return torch.where(need, compressed, c)


_AGX_INSET = np.array(
    [
        [0.856627153315983, 0.137318972929847, 0.11189821299995],
        [0.0951212405381588, 0.761241990602591, 0.0767994186031903],
        [0.0482516061458583, 0.101439036467562, 0.811302368396859],
    ],
    np.float32,
)

_AGX_OUTSET = np.array(
    [
        [1.1271005818144368, -0.1413297634984383, -0.14132976349843826],
        [-0.11060664309660323, 1.157823702216272, -0.11060664309660294],
        [-0.016493938717834573, -0.016493938717834257, 1.2519364065950405],
    ],
    np.float32,
)

# ASC CDL parameters per AgX look (ref agx.zig:38-69): (slope, power, sat)
AGX_LOOKS = {
    "Default": ((1.0, 1.0, 1.0), 1.0, 1.0),
    "Substitute": ((1.0, 1.0, 1.0), 1.1, 1.05),
    "Golden": ((1.0, 0.9, 0.5), 0.8, 0.8),
    "Punchy": ((1.0, 1.0, 1.0), 1.35, 1.4),
}


def _agx_look(v, look: str):
    slope, power, sat = AGX_LOOKS.get(look, AGX_LOOKS["Default"])
    luma = 0.2126 * v[..., 0:1] + 0.7152 * v[..., 1:2] + 0.072 * v[..., 2:3]
    p = torch.pow(torch.clamp(v * torch.tensor(slope, dtype=v.dtype, device=v.device), min=0.0), power)
    return luma + sat * (p - luma)


def tonemap_agx(c, look: str = "Substitute"):
    """AgX: inset -> log2 encode -> sigmoid -> look -> outset -> 2.2 EOTF."""
    min_ev, max_ev = -12.47393, 4.026069
    c = c @ torch.as_tensor(_AGX_INSET, device=c.device)
    c = torch.clamp(torch.log2(torch.clamp(c, min=1e-10)), min_ev, max_ev)
    x = (c - min_ev) / (max_ev - min_ev)
    x2 = x * x
    x4 = x2 * x2
    v = (
        15.5 * x4 * x2
        - 40.14 * x4 * x
        + 31.96 * x4
        - 6.868 * x2 * x
        + 0.4298 * x2
        + 0.1191 * x
        - 0.00232
    )
    v = _agx_look(torch.clamp(v, min=0.0), look)
    v = v @ torch.as_tensor(_AGX_OUTSET, device=v.device)
    return torch.clamp(torch.pow(torch.clamp(v, 0.0, 1.0), 2.2), 0.0, 1.0)


TONEMAPPERS = {
    "Linear": tonemap_linear,
    "ACES": tonemap_aces,
    "AgX": tonemap_agx,
    "PbrNeutral": tonemap_pbr_neutral,
}


def tonemap(c, name: str = "Linear", exposure: float = 0.0, look: str | None = None):
    f = TONEMAPPERS.get(name, tonemap_linear)
    scaled = c * (2.0**exposure)
    if name == "AgX":
        return f(scaled, look if look is not None else "Substitute")
    return f(scaled)
