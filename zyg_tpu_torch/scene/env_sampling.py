"""Env-map importance sampling for dome and canopy lights (counterpart of
zyg_tpu/scene/env_sampling.py: the host alias-table build :74-163, a copy
that gives the same table array for array, and the device sample and pdf
:171-289 in torch).

The reference samples the emission map through a 2-D CDF with a per-lane
binary search; the JAX package realizes the same distribution as an alias
table over the texels of a downsampled luminance proxy, so a sample is one
table-row gather and a pdf one gather by texel id. The pdf is the solid-
angle density at the ACTUAL direction (the texel's uv density over the
lat-long jacobian there), the density that uniform jitter inside the picked
texel induces, so sample and pdf agree to float precision.

Mappings (the fragment's, scene/shapes.py), in light space: a dome is
lat-long, u = atan2(x, z) / 2pi + 0.5, v = acos(y) / pi, over the whole
sphere; a canopy is the equidistant disk over the upper hemisphere (z
up), r = 2 acos(z) / pi, u = r x / |xy| / 2 + 0.5, v = r y / |xy| / 2 + 0.5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma
from .types import to_device

_PI = math.pi


@dataclass
class EnvSampler:
    """Alias tables of the scene's mapped dome lights.

    table: float32[E, K, 4] rows (prob, alias, pdf_self, pdf_alias), the
    pdfs being uv-space densities (K times the texel's normalized weight)
    of the texel and of its alias; light: int32[E] light index of each
    entry; K = width * height texels of the shared proxy resolution;
    canopy: a bool for each entry, True for a canopy (host data, as the
    JAX package's static aux)."""

    table: torch.Tensor
    light: torch.Tensor
    width: int
    height: int
    canopy: tuple = ()

    def to(self, device) -> "EnvSampler":
        return to_device(self, device)


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------


def _alias_table(w: np.ndarray):
    """Walker/Vose alias method. w: float64[K] >= 0 (not all zero).
    Returns (prob[K], alias[K]) with P(pick k) == w[k]/sum(w). The work
    lists pop from their ends, as the JAX package's do, so the table is
    the same array."""
    k = len(w)
    p = w * (k / w.sum())
    prob = np.ones(k, np.float64)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)


def build_env_entry(image: np.ndarray, canopy: bool = False, max_w: int = 256):
    """One env light's table rows. image: [H, W, C] linear radiance; canopy:
    the equidistant disk instead of the lat-long map. Returns (float32[K, 4]
    rows, proxy width, proxy height)."""
    img = np.asarray(image, np.float64)
    h_full, w_full = img.shape[:2]
    # downsample the importance proxy (power-conserving box filter); the
    # sampled radiance still comes from the full-resolution texture
    fx = max(1, int(np.ceil(w_full / max_w)))
    fy = max(1, int(np.ceil(h_full / (max_w // 2))))
    h, w = h_full // fy, w_full // fx
    lum = img[..., :3] @ np.array([0.2126, 0.7152, 0.0722])
    lum = lum[: h * fy, : w * fx].reshape(h, fy, w, fx).mean(axis=(1, 3))
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    if canopy:
        # a texel's solid angle ~ 2 pi sin(theta) / r per unit uv area
        dx = xs[None, :] - 0.5
        dy = ys[:, None] - 0.5
        r = 2.0 * np.sqrt(dx * dx + dy * dy)
        theta = r * (np.pi / 2.0)
        jac = np.where(r <= 1.0, 2.0 * np.pi * np.sin(theta) / np.maximum(r, 1e-6), 0.0)
        weight = lum * jac
    else:
        weight = lum * np.sin(ys * np.pi)[:, None]
    weight = weight.reshape(-1)
    total = weight.sum()
    if total <= 0.0:
        weight = np.ones_like(weight)
        total = weight.sum()
    weight = np.maximum(weight, 1e-4 * total / len(weight))  # keep pdf > 0
    prob, alias = _alias_table(weight)
    pdf_uv = (weight / weight.sum()) * (w * h)
    table = np.stack(
        [prob, alias.astype(np.float32), pdf_uv.astype(np.float32),
         pdf_uv[alias].astype(np.float32)],
        axis=-1,
    ).astype(np.float32)
    return table, w, h


def build_env_sampler(entries) -> EnvSampler | None:
    """entries: list of (image, canopy, light_index). Proxies after the
    first are resampled to the first's (w, h)."""
    if not entries:
        return None
    tables, lights = [], []
    w0 = h0 = None
    for image, canopy, light_idx in entries:
        table, w, h = build_env_entry(image, canopy)
        if w0 is None:
            w0, h0 = w, h
        elif (w, h) != (w0, h0):
            img = np.asarray(image, np.float32)
            yi = (np.linspace(0, img.shape[0] - 1, h0 * 2)).astype(np.int64)
            xi = (np.linspace(0, img.shape[1] - 1, w0 * 2)).astype(np.int64)
            table, w, h = build_env_entry(img[yi][:, xi], canopy, max_w=w0)
        tables.append(table)
        lights.append(int(light_idx))
    return EnvSampler(table=torch.from_numpy(np.stack(tables)),
                      light=torch.as_tensor(np.array(lights, np.int32)), width=w0, height=h0,
                      canopy=tuple(bool(c) for _, c, _ in entries))


# ---------------------------------------------------------------------------
# Device sample / pdf
# ---------------------------------------------------------------------------


def dome_uv(ldir):
    """Lat-long uv [N, 2] of unit light-space directions [N, 3]."""
    phi = torch.atan2(ldir[:, 0], ldir[:, 2])
    return torch.stack([fma(phi, 0.5 / _PI, 0.5),
                        torch.acos(torch.clamp(ldir[:, 1], -1.0, 1.0)) / _PI], dim=-1)


def canopy_uv(ldir):
    """Equidistant-disk uv [N, 2] of unit light-space directions [N, 3]."""
    r = torch.acos(torch.clamp(ldir[:, 2], -1.0, 1.0)) * (2.0 / _PI)
    lxy = torch.sqrt(torch.clamp(fma(ldir[:, 0], ldir[:, 0], ldir[:, 1] * ldir[:, 1]), min=1e-20))
    return torch.stack([0.5 * (r * ldir[:, 0] / lxy) + 0.5, 0.5 * (r * ldir[:, 1] / lxy) + 0.5],
                       dim=-1)


def _is_canopy(env: EnvSampler, entry):
    """bool[N]: the lanes whose env entry is a canopy's."""
    c = torch.zeros_like(entry, dtype=torch.bool)
    for k, flag in enumerate(env.canopy):
        if flag:
            c = c | (entry == k)
    return c


def _uv_to_dir_local(env: EnvSampler, is_can, uv):
    """Light-space directions of uv, by each lane's mapping."""
    phi = (uv[:, 0] - 0.5) * (2.0 * _PI)
    theta = uv[:, 1] * _PI
    st = torch.sin(theta)
    ldir = torch.stack([st * torch.sin(phi), torch.cos(theta), st * torch.cos(phi)], dim=-1)
    if not any(env.canopy):
        return ldir
    dx = 2.0 * (uv[:, 0] - 0.5)
    dy = 2.0 * (uv[:, 1] - 0.5)
    r = torch.sqrt(fma(dx, dx, dy * dy))
    th = torch.clamp(r, max=1.0) * (_PI / 2.0)
    s = torch.sin(th) / torch.clamp(r, min=1e-8)
    can = torch.stack([dx * s, dy * s, torch.cos(th)], dim=-1)
    return torch.where(is_can[:, None], can, ldir)


def _jacobian(env: EnvSampler, is_can, ldir):
    """|dOmega/duv| at the direction: 2 pi^2 sin(theta) for the lat-long
    map, 2 pi sin(theta) / r for the equidistant disk."""
    jac = (2.0 * _PI * _PI) * torch.sqrt(torch.clamp(fma(-ldir[:, 1], ldir[:, 1], 1.0), min=1e-8))
    if any(env.canopy):
        lz = torch.clamp(ldir[:, 2], -1.0, 1.0)
        r = torch.acos(lz) * (2.0 / _PI)
        jac_c = ((2.0 * _PI) * torch.sqrt(torch.clamp(fma(-lz, lz, 1.0), min=1e-8))
                 / torch.clamp(r, min=1e-6))
        jac = torch.where(is_can, jac_c, jac)
    return jac


def entry_of_light(env: EnvSampler, light_idx):
    """Light index -> env entry index, or -1 (E is tiny: a select chain)."""
    e = torch.full_like(light_idx, -1)
    for k in range(env.light.shape[0]):
        e = torch.where(light_idx == env.light[k], k, e)
    return e


def sample(env: EnvSampler, entry, rot, xi):
    """Importance-sample a direction of env entry per lane. entry: int32[N]
    (>= 0 where it applies); rot: [N, 3, 3] light rotation; xi: [N, 2].
    Returns (wi [N, 3], solid-angle pdf [N], uv [N, 2])."""
    w, h = env.width, env.height
    k = w * h
    ent = torch.clamp(entry, min=0).long()
    # the integer part of xi0 * K picks the slot; the fraction decides
    # texel vs alias and, stretched again, jitters u inside the texel
    x = xi[:, 0] * float(k)
    slot = torch.clamp(x.to(torch.int32), 0, k - 1)
    frac = x - slot.to(torch.float32)
    row = env.table[ent, slot.long()]
    p0 = row[:, 0]
    take_alias = frac >= p0
    texel = torch.where(take_alias, row[:, 1].to(torch.int32), slot)
    pdf_uv = torch.where(take_alias, row[:, 3], row[:, 2])
    ju = torch.where(take_alias, (frac - p0) / torch.clamp(1.0 - p0, min=1e-7),
                     frac / torch.clamp(p0, min=1e-7))
    ju = torch.clamp(ju, 0.0, 0.999999)
    tx = torch.remainder(texel, w).to(torch.float32)
    ty = torch.div(texel, w, rounding_mode="floor").to(torch.float32)
    uv = torch.stack([(tx + ju) / w, (ty + xi[:, 1]) / h], dim=-1)
    is_can = _is_canopy(env, ent)
    ldir = _uv_to_dir_local(env, is_can, uv)
    wi = vm.object_to_world_normal(rot, ldir)
    return wi, pdf_uv / _jacobian(env, is_can, ldir), uv


def pdf(env: EnvSampler, light_idx, rot, wi):
    """The solid-angle pdf `sample` has for direction wi toward light_idx;
    0 where the light has no env entry."""
    entry = entry_of_light(env, light_idx)
    ent = torch.clamp(entry, min=0).long()
    w, h = env.width, env.height
    is_can = _is_canopy(env, ent)
    ldir = vm.safe_normalize(vm.world_to_object_normal(rot, wi))
    uv = dome_uv(ldir)
    if any(env.canopy):
        uv = torch.where(is_can[:, None], canopy_uv(ldir), uv)
    tx = torch.clamp((uv[:, 0] * w).to(torch.int32), 0, w - 1)
    ty = torch.clamp((uv[:, 1] * h).to(torch.int32), 0, h - 1)
    pdf_uv = env.table[ent, (ty * w + tx).long(), 2]
    return torch.where(entry >= 0, pdf_uv / _jacobian(env, is_can, ldir), 0.0)
