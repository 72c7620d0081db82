"""Portal lights: importance-sample an env map through an opening
(counterpart of zyg_tpu/scene/portal.py: the host bake :68-129, a copy of
its numpy in the same operation order, so the tables are equal byte for
byte, and the device math :132-323 in torch).

A Portal entity links a Rectangle to an image-mapped Dome: the loader
turns the dome into an invisible prop that is no light, and the rectangle,
with the dome's material and invisible to shadow rays, takes over its
emission. NEE samples the part of the dome seen through the rectangle by a
coarse D x D luminance grid over the portal's gnomonic image, stored as
per-row prefix sums: a windowed sample takes four [N, D] column fetches for
the row marginal and one row fetch for the column, and inverts both by
cumulative sums and compares. Sample and pdf read the same grid, so MIS
stays exact.

Portal-local directions have z > 0 toward the interior; the image maps
such a direction w to uv = (atan2(w.x, w.z), atan2(w.y, w.z)) / pi + 0.5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma
from .env_sampling import dome_uv
from .types import to_device

D_GRID = 64  # portal-image luminance grid resolution
_PI = math.pi
# the float32 constants XLA folds into the JAX functions' fused steps
_INV_PI = float(np.float32(1.0 / math.pi))
_PI_F = float(np.float32(math.pi))
_HALF_PI_F = float(np.float32(-0.5 * math.pi))


@dataclass
class PortalDist:
    """One portal's windowed distribution and its link to the dome."""

    pfx: torch.Tensor  # float32[D, D + 1] per-row prefix sums of the luminance grid
    pfx_t: torch.Tensor  # float32[D + 1, D] its transpose (column fetches become row reads)
    dome_rot: torch.Tensor  # float32[3, 3] the dome prop's rotation (the env map's frame)

    def to(self, device) -> "PortalDist":
        return to_device(self, device)


ARRAY_FIELDS = ("pfx", "pfx_t", "dome_rot")


def dome_uv_of_dir(dome_rot, wi):
    """Lat-long uv [N, 2] of world directions wi [N, 3] on the dome (the
    dome branch of light_sampling.light_radiance and of the fragment)."""
    return dome_uv(vm.safe_normalize(vm.world_to_object_normal(dome_rot, wi)))


# ---------------------------------------------------------------------------
# Host bake
# ---------------------------------------------------------------------------


def build_portal_dist(env_img: np.ndarray, dome_rot: np.ndarray, portal_rot: np.ndarray,
                      d: int = D_GRID, subsamples: int = 2) -> tuple[np.ndarray, float]:
    """The D x D luminance grid over the portal image (ref light_material.zig
    PortalLuminanceContext): each cell the env radiance's max channel at the
    outward direction through the portal times the uv -> solid-angle
    jacobian, averaged over subsamples^2 points. Returns (lum float32[d, d],
    its mean)."""
    h, w = env_img.shape[:2]
    pr = np.asarray(portal_rot, np.float64)
    dr = np.asarray(dome_rot, np.float64)
    n = d * subsamples
    uv = (np.arange(n) + 0.5) * (1.0 / n)
    uu, vv = np.meshgrid(uv, uv)  # rows of vv are y
    x = np.tan(-np.pi / 2 + uu * np.pi)
    y = np.tan(-np.pi / 2 + vv * np.pi)
    inv_len = 1.0 / np.sqrt(x * x + y * y + 1.0)
    wx, wy, wz = x * inv_len, y * inv_len, inv_len
    weight = (np.pi**2) * (1.0 - wx**2) * (1.0 - wy**2) / wz
    # the outward direction is minus the portal-local w in world space
    dirs = -(wx[..., None] * pr[0] + wy[..., None] * pr[1] + wz[..., None] * pr[2])
    ldir = dirs @ dr.T  # the rows of dr are the dome's object axes in world
    phi = np.arctan2(ldir[..., 0], ldir[..., 2])
    u_env = phi * (0.5 / np.pi) + 0.5
    v_env = np.arccos(np.clip(ldir[..., 1], -1.0, 1.0)) * (1.0 / np.pi)
    xi = np.clip((u_env * w).astype(np.int64), 0, w - 1)
    yi = np.clip((v_env * h).astype(np.int64), 0, h - 1)
    rad = env_img[yi, xi, :3].astype(np.float64)
    lum_full = rad.max(axis=-1) * weight
    lum = lum_full.reshape(d, subsamples, d, subsamples).mean(axis=(1, 3))
    lum = np.maximum(lum, 1e-12).astype(np.float32)
    return lum, float(lum.mean())


def make_portal_dist(lum: np.ndarray, dome_rot: np.ndarray) -> PortalDist:
    d = lum.shape[0]
    pfx = np.zeros((d, d + 1), np.float32)
    pfx[:, 1:] = np.cumsum(lum, axis=1)
    return PortalDist(pfx=torch.from_numpy(pfx), pfx_t=torch.from_numpy(pfx.T.copy()),
                      dome_rot=torch.from_numpy(np.asarray(dome_rot, np.float32).copy()))


# ---------------------------------------------------------------------------
# Device math on [N] / [N, 3] lanes
# ---------------------------------------------------------------------------


def world_to_image(w):
    """Portal-local directions [N, 3] -> (image uv [N, 2] clamped to [0, 1],
    bool[N] toward the interior) (ref portal.zig worldToImage)."""
    u = fma(torch.atan2(w[:, 0], w[:, 2]), _INV_PI, 0.5)
    v = fma(torch.atan2(w[:, 1], w[:, 2]), _INV_PI, 0.5)
    return torch.clamp(torch.stack([u, v], dim=-1), 0.0, 1.0), w[:, 2] > 0.0


def _weight(w):
    """The uv -> solid-angle jacobian pi^2 (1 - x^2)(1 - y^2) / z of unit
    portal-local directions."""
    return ((_PI**2) * fma(-w[:, 0], w[:, 0], 1.0) * fma(-w[:, 1], w[:, 1], 1.0)
            / torch.clamp(w[:, 2], min=1e-12))


def image_to_world_local(uv):
    """Image uv [N, 2] -> (portal-local direction [N, 3], uv -> solid-angle
    weight [N]) (ref portal.zig imageToWorld)."""
    xy = torch.tan(fma(uv, _PI_F, _HALF_PI_F))
    w = vm.safe_normalize(torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1))
    return w, _weight(w)


def image_bounds(p, rot, pos, scale):
    """The uv window [lo, hi] of the portal rectangle (rot [3, 3], pos [3],
    scale [3]) seen from the points p [N, 3]: its two diagonal corners
    projected to the image plane, and bool[N] where both lie in front (ref
    portal.zig imageBounds)."""
    ab = scale[0] * rot[0] + scale[1] * rot[1]
    o = p - pos
    w0 = vm.world_to_object_normal(rot, vm.safe_normalize(0.5 * ab + o))
    w1 = vm.world_to_object_normal(rot, vm.safe_normalize(-0.5 * ab + o))
    uv0, ok0 = world_to_image(w0)
    uv1, ok1 = world_to_image(w1)
    return torch.minimum(uv0, uv1), torch.maximum(uv0, uv1), ok0 & ok1


def _interp_cols(pfx_t, xc):
    """The prefix sums at column xc (cell units in [0, D]) of every row:
    [N, D]."""
    dmax = pfx_t.shape[0] - 1
    x0 = torch.clamp(torch.floor(xc).to(torch.int64), 0, dmax - 1)
    f = (xc - x0.to(torch.float32))[:, None]
    a = pfx_t[x0]
    return fma(f, pfx_t[x0 + 1] - a, a)


def _window_marginal(pd: PortalDist, lo, hi):
    """(mm [N, D] each row's mass inside the window, total [N], and the
    window's x0, x1, y0, y1 in cell units)."""
    df = float(pd.pfx.shape[0])
    x0c = torch.clamp(lo[:, 0] * df, 0.0, df)
    x1c = torch.clamp(hi[:, 0] * df, 0.0, df)
    y0c = torch.clamp(lo[:, 1] * df, 0.0, df)
    y1c = torch.clamp(hi[:, 1] * df, 0.0, df)
    m = _interp_cols(pd.pfx_t, x1c) - _interp_cols(pd.pfx_t, x0c)
    yi = torch.arange(pd.pfx.shape[0], dtype=torch.float32, device=lo.device)
    cov = torch.clamp(torch.minimum(y1c[:, None], yi + 1.0) - torch.maximum(y0c[:, None], yi),
                      0.0, 1.0)
    mm = m * cov
    return mm, mm.sum(dim=-1), x0c, x1c, y0c, y1c


def _pick(x, idx):
    """x[n, idx[n]] of [N, K] x and int64[N] idx."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _interp_row(row, xc):
    """The prefix row [N, D + 1] at cell coordinate xc [N]."""
    dmax = row.shape[-1] - 2
    x0 = torch.clamp(torch.floor(xc).to(torch.int64), 0, dmax)
    f = xc - x0.to(torch.float32)
    a = _pick(row, x0)
    return fma(f, _pick(row, x0 + 1) - a, a)


def sample_windowed(pd: PortalDist, lo, hi, r2):
    """uv [N, 2] drawn by the luminance restricted to the window [lo, hi],
    and its pdf [N] in 1/uv^2 (0 where the window holds no mass): the
    ref's WindowedDistribution2D.sampleContinuous."""
    d = pd.pfx.shape[0]
    df = float(d)
    mm, total, x0c, x1c, y0c, y1c = _window_marginal(pd, lo, hi)
    tot = torch.clamp(total, min=1e-30)
    # y: invert the CDF of the rows' masses
    cdf = torch.cumsum(mm, dim=-1)
    ty = r2[:, 1] * tot
    yc = torch.clamp((cdf < ty[:, None]).sum(dim=-1), 0, d - 1)
    prev = torch.where(yc > 0, _pick(cdf, torch.clamp(yc - 1, min=0)), 0.0)
    my = _pick(mm, yc)
    yf = yc.to(torch.float32)
    cov_y = torch.clamp(torch.minimum(y1c, yf + 1.0) - torch.maximum(y0c, yf), 0.0, 1.0)
    fy = torch.clamp((ty - prev) / torch.clamp(my, min=1e-30), 0.0, 1.0)
    v = fma(fy, cov_y, torch.maximum(y0c, yf)) / df
    # x: invert the row's prefix sums inside [x0, x1]
    row = pd.pfx[yc]
    f0 = _interp_row(row, x0c)
    tx = fma(r2[:, 0], _interp_row(row, x1c) - f0, f0)
    xc = torch.clamp((row[:, 1:] < tx[:, None]).sum(dim=-1), 0, d - 1)
    ra = _pick(row, xc)
    fcell = torch.clamp(_pick(row, xc + 1) - ra, min=1e-30)  # the luminance of cell (yc, xc)
    fx = torch.clamp((tx - ra) / fcell, 0.0, 1.0)
    u = torch.minimum(torch.maximum(xc.to(torch.float32) + fx, x0c), x1c) / df
    # the pdf: f(u, v) over the integral, which is total / D^2 in f x uv units
    pdf_uv = fcell * df * df / tot
    return torch.stack([u, v], dim=-1), torch.where(total > 0.0, pdf_uv, 0.0)


def pdf_windowed(pd: PortalDist, lo, hi, uv):
    """The pdf (1/uv^2) of uv under the windowed distribution: the
    BSDF-hit side of MIS (ref WindowedDistribution2D.pdf)."""
    d = pd.pfx.shape[0]
    df = float(d)
    total = _window_marginal(pd, lo, hi)[1]
    yc = torch.clamp((uv[:, 1] * df).to(torch.int64), 0, d - 1)
    xc = torch.clamp((uv[:, 0] * df).to(torch.int64), 0, d - 1)
    row = pd.pfx[yc]
    f = _pick(row, xc + 1) - _pick(row, xc)
    return torch.where(total > 0.0, f * df * df / torch.clamp(total, min=1e-30), 0.0)


def sample_to(pd: PortalDist, rot, pos, scale, p, r2):
    """NEE toward the portal (rot [3, 3], pos [3], scale [3]) from the
    points p [N, 3] with the uniforms r2 [N, 2] (ref rectangle.zig
    samplePortalTo): dict of wi [N, 3] out through the portal, its
    solid-angle pdf, t the distance to the portal's plane, uv the dome's
    lat-long uv of wi, and ok."""
    lo, hi, ok = image_bounds(p, rot, pos, scale)
    uv, pdf_uv = sample_windowed(pd, lo, hi, r2)
    w, weight = image_to_world_local(uv)
    wi = -vm.frame_to_world(rot[0], rot[1], rot[2], w)  # from p out through the portal
    denom = vm.dot(rot[2], wi)
    t = -(vm.dot(rot[2], p) - vm.dot(rot[2], pos)) / torch.where(torch.abs(denom) > 1e-12,
                                                                  denom, 1e-12)
    pdf = pdf_uv / torch.clamp(weight, min=1e-12)
    return {"wi": wi, "pdf": pdf, "t": t, "uv": dome_uv_of_dir(pd.dome_rot, wi),
            "ok": ok & (pdf_uv > 0.0) & (t > 0.0)}


def pdf_to(pd: PortalDist, rot, pos, scale, p, wi):
    """The solid-angle pdf with which sample_to from p would have drawn the
    direction wi [N, 3] (ref light.zig propPortalPdf)."""
    lo, hi, okb = image_bounds(p, rot, pos, scale)
    w = vm.world_to_object_normal(rot, -wi)  # the inward direction, portal-local
    uv, okw = world_to_image(w)
    pdf_uv = pdf_windowed(pd, lo, hi, uv)
    return torch.where(okb & okw, pdf_uv / torch.clamp(_weight(vm.safe_normalize(w)), min=1e-12),
                       0.0)
