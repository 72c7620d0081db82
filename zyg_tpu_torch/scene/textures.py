"""Textures: one flat RGBA float32 arena, its samplers and the analytic
procedurals (counterpart of zyg_tpu/scene/textures.py).

All textures are packed into one arena at build time:

    data   float32[total_texels, 4]   (unused channels are 0; one channel
                                       images repeat into RGB, alpha 1)
    offset/width/height/address/texcoord int32[K] per texture

address: bit 0 clamps u, bit 1 clamps v; 0 repeats both (the default).
texcoord: 0 reads the fragment's uv, 1 (Triplanar) and 2 (ObjectPos) the
caller's alternate uv (render/materials.py triplanar_uv). sRGB images are
decoded to linear at pack time (core/spectrum.py). `procedurals` lists the
textures that are evaluated analytically per lane (scene/procedural.py
eval_analytic) as (texture id, kind, params): static host data, not a
tensor, carried unchanged by `to(device)`; the arena keeps a low-resolution
bake of the same node as their texels.

Arithmetic follows the JAX package's jitted bounces on the CPU: a
multiply feeding an add is one fused multiply-add (core/fmath.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.fmath import fma
from ..core.spectrum import srgb_to_linear_np
from . import procedural
from .types import to_device


@dataclass
class TextureArena:
    data: torch.Tensor  # float32[T, 4]
    offset: torch.Tensor  # int32[K]
    width: torch.Tensor  # int32[K]
    height: torch.Tensor  # int32[K]
    address: torch.Tensor  # int32[K] bit 0 clamp u, bit 1 clamp v
    texcoord: torch.Tensor  # int32[K] 0 UV0, 1 Triplanar, 2 ObjectPos
    procedurals: tuple = ()  # ((tid, kind, params), ...) evaluated analytically

    def to(self, device) -> "TextureArena":
        return to_device(self, device)


class TextureBuilder:
    def __init__(self):
        self._images: list[np.ndarray] = []
        self._address: list[int] = []
        self._texcoord: list[int] = []
        self._procedurals: list[tuple] = []

    @staticmethod
    def _convert(image: np.ndarray, srgb: bool) -> np.ndarray:
        """[H,W,C] or [H,W] uint8/uint16/float32 -> packed [H,W,4] float32."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        elif img.dtype == np.uint16:
            img = img.astype(np.float32) / 65535.0
        else:
            img = img.astype(np.float32)
        if srgb:  # colour channels only, never alpha
            img = img.copy()
            c = min(img.shape[-1], 3)
            img[..., :c] = srgb_to_linear_np(img[..., :c])
        h, w, c = img.shape
        rgba = np.zeros((h, w, 4), np.float32)
        rgba[..., :c] = img
        if c == 1:
            rgba[..., 1] = rgba[..., 2] = rgba[..., 0]
            rgba[..., 3] = 1.0
        return rgba

    def add(self, image: np.ndarray, srgb: bool = False, clamp_u: bool = False,
            clamp_v: bool = False, texcoord: int = 0) -> int:
        """An image -> texture id."""
        self._images.append(self._convert(image, srgb))
        self._address.append((1 if clamp_u else 0) | (2 if clamp_v else 0))
        self._texcoord.append(int(texcoord))
        return len(self._images) - 1

    def add_procedural_meta(self, tid: int, spec: tuple) -> None:
        """Mark texture tid for analytic evaluation per lane (spec from
        procedural.analytic_spec); its texels are the node's fallback bake."""
        if any(p[0] == tid for p in self._procedurals):
            raise ValueError(f"texture {tid} is already an analytic procedural")
        self._procedurals.append((int(tid),) + tuple(spec))

    def __len__(self) -> int:
        return len(self._images)

    @property
    def texcoords(self) -> list[int]:
        """Each texture's coordinate set, by texture id."""
        return self._texcoord

    def image(self, tex_id: int) -> np.ndarray:
        """The packed [H, W, 4] image of a texture."""
        return self._images[tex_id]

    def build(self) -> TextureArena | None:
        if not self._images:
            return None
        offsets = np.cumsum([0] + [i.shape[0] * i.shape[1] for i in self._images[:-1]])

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32))

        return TextureArena(
            data=torch.from_numpy(np.concatenate([i.reshape(-1, 4) for i in self._images])),
            offset=i32(offsets),
            width=i32([i.shape[1] for i in self._images]),
            height=i32([i.shape[0] for i in self._images]),
            address=i32(self._address),
            texcoord=i32(self._texcoord),
            procedurals=tuple(self._procedurals),
        )


def _select_uv(arena: TextureArena, tid, uv, uv_alt):
    """Each lane's coordinate set: the alternate uv where its texture reads
    Triplanar or ObjectPos coordinates."""
    if uv_alt is None:
        return uv
    return torch.where((arena.texcoord[tid] > 0)[:, None], uv_alt, uv)


def _analytic_override(arena: TextureArena, tex_id, uv, out, footprint):
    """out with the lanes of an analytic procedural texture replaced by its
    evaluation at uv (the arena's procedurals in their order)."""
    for tid, kind, params in arena.procedurals:
        val = procedural.eval_analytic(kind, params, uv, footprint)
        out = torch.where((tex_id == tid)[:, None], val, out)
    return out


def _lookup(arena: TextureArena, tid, xi, yi):
    """Texels (xi, yi) of textures tid under their address modes: wrap is
    a floor modulo (jnp.mod), so negative indices wrap from the end."""
    w = arena.width[tid]
    h = arena.height[tid]
    adr = arena.address[tid]
    xi = torch.where((adr & 1) != 0, torch.minimum(torch.clamp(xi, min=0), w - 1),
                     torch.remainder(xi, w))
    yi = torch.where((adr & 2) != 0, torch.minimum(torch.clamp(yi, min=0), h - 1),
                     torch.remainder(yi, h))
    return arena.data[(arena.offset[tid] + yi * w + xi).long()]


def sample_bilinear(arena: TextureArena, tex_id, uv, uv_alt=None, footprint=None):
    """Bilinear sample. tex_id int32[N] (< 0 reads texture 0; callers
    select), uv [N, 2], uv_alt [N, 2] or None, footprint [N] (uv units, for
    the analytic procedurals) or None. Returns [N, 4]."""
    tid = torch.clamp(tex_id, min=0).long()
    uv = _select_uv(arena, tid, uv, uv_alt)
    fw = arena.width[tid].to(torch.float32)
    fh = arena.height[tid].to(torch.float32)
    x = fma(uv[:, 0], fw, -0.5)
    y = fma(uv[:, 1], fh, -0.5)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    tx = (x - x0.to(torch.float32))[:, None]
    ty = (y - y0.to(torch.float32))[:, None]
    c00 = _lookup(arena, tid, x0, y0)
    c10 = _lookup(arena, tid, x0 + 1, y0)
    c01 = _lookup(arena, tid, x0, y0 + 1)
    c11 = _lookup(arena, tid, x0 + 1, y0 + 1)
    top = fma(c10 - c00, tx, c00)
    bot = fma(c11 - c01, tx, c01)
    return _analytic_override(arena, tex_id, uv, fma(bot - top, ty, top), footprint)


def sample_stochastic(arena: TextureArena, tex_id, uv, xi, uv_alt=None, footprint=None):
    """One-texel stochastic bilinear sample (the reference's default
    LinearStochastic filter): the sample point jittered by xi in [0, 1)^2
    reads its nearest texel, which picks each of the four bilinear texels
    with its bilinear weight. tex_id int32[N], uv [N, 2], xi [N, 2], uv_alt
    and footprint as sample_bilinear's. Returns [N, 4]."""
    tid = torch.clamp(tex_id, min=0).long()
    uv = _select_uv(arena, tid, uv, uv_alt)
    x = fma(uv[:, 0], arena.width[tid].to(torch.float32), -0.5) + xi[:, 0]
    y = fma(uv[:, 1], arena.height[tid].to(torch.float32), -0.5) + xi[:, 1]
    out = _lookup(arena, tid, torch.floor(x).to(torch.int32), torch.floor(y).to(torch.int32))
    return _analytic_override(arena, tex_id, uv, out, footprint)
