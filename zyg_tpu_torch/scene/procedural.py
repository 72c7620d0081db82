"""Procedural texture nodes (counterpart of zyg_tpu/scene/procedural.py).

The host part bakes a node graph (Checker, Noise with gradient or
cellular fbm, Mix, Mul, Max, ChannelMix, DetailNormal) over a uv grid at
scene build into the texture arena, in plain numpy in the JAX package's
operation order (the arenas are compared exactly). `analytic_spec` names
the nodes that the bounces evaluate per lane instead: a lone Checker or
Noise node, which keeps only a 128^2 bake as fallback data.

The device part, `eval_analytic`, is that per-lane evaluation on torch
tensors on their own device, with the optional isotropic footprint `foot`
(uv units): the checker is box-filtered exactly, fbm octaves finer than the
footprint fade toward their mean. The uint32 lattice hash runs in int64
as core/rng.py does, so CPU and card agree to the bit. Arithmetic follows
XLA's rounding of the JAX function: a division by a constant is a
multiplication by its float32 reciprocal, and a product feeding an add is
one fused multiply-add (core/fmath.py) where that changes a result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fmath import fma, sqrt
from ..core.rng import mul_u32, u32

BAKE_RES = 1024

PROCEDURAL_KEYS = (
    "Checker", "Noise", "Mix", "Mul", "Max", "ChannelMix", "DetailNormal",
)


def is_procedural(value) -> bool:
    return isinstance(value, dict) and any(k in value for k in PROCEDURAL_KEYS)


# ---------------------------------------------------------------------------
# noise primitives (original implementations of the classic algorithms)
# ---------------------------------------------------------------------------


def _hash2(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Integer lattice hash -> uint32."""
    h = (ix.astype(np.uint32) * np.uint32(0x8DA6B343)) ^ (
        iy.astype(np.uint32) * np.uint32(0xD8163841)
    )
    h ^= h >> np.uint32(13)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(16)
    return h


def perlin2d(x: np.ndarray, y: np.ndarray, period=(0.0, 0.0)) -> np.ndarray:
    """Gradient (Perlin) noise in [-1, 1]; optional integer period wrap."""
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = x - x0
    fy = y - y0

    def grad_dot(cx, cy, ox, oy):
        ix = (x0 + cx).astype(np.int64)
        iy = (y0 + cy).astype(np.int64)
        if period[0] > 0:
            ix = np.mod(ix, int(period[0]))
        if period[1] > 0:
            iy = np.mod(iy, int(period[1]))
        h = _hash2(ix, iy)
        ang = (h.astype(np.float64) / 2**32) * (2.0 * np.pi)
        return np.cos(ang) * (fx - ox) + np.sin(ang) * (fy - oy)

    def fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    u, v = fade(fx), fade(fy)
    n00 = grad_dot(0, 0, 0.0, 0.0)
    n10 = grad_dot(1, 0, 1.0, 0.0)
    n01 = grad_dot(0, 1, 0.0, 1.0)
    n11 = grad_dot(1, 1, 1.0, 1.0)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    # sqrt(2) normalization puts 2D gradient noise into ~[-1,1]
    return np.float32(np.sqrt(2.0)) * (nx0 + v * (nx1 - nx0)).astype(np.float32)


def worley2d(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cellular (Worley) F1 distance in [0, ~1]."""
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = x - x0
    fy = y - y0
    best = np.full(x.shape, 1e9, np.float32)
    for cy in (-1, 0, 1):
        for cx in (-1, 0, 1):
            ix = (x0 + cx).astype(np.int64)
            iy = (y0 + cy).astype(np.int64)
            h = _hash2(ix, iy)
            jx = (h & np.uint32(0xFFFF)).astype(np.float32) / 65535.0
            jy = (h >> np.uint32(16)).astype(np.float32) / 65535.0
            dx = cx + jx - fx
            dy = cy + jy - fy
            best = np.minimum(best, dx * dx + dy * dy)
    return np.sqrt(best).astype(np.float32)


def noise_eval(params: dict, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """fbm noise per ref procedural_noise.zig evaluate1 (uv mode)."""
    cellular = params.get("class", "") == "Cellular"
    levels = int(params.get("levels", 1))
    att = float(params.get("attenuation", 0.0))
    ratio = float(params.get("ratio", 0.5))
    transition = float(params.get("transition", 0.5))
    scale = params.get("scale", [1.0, 1.0, 1.0])
    sx, sy = float(scale[0]), float(scale[1] if len(scale) > 1 else scale[0])
    period = params.get("period", [0.0, 0.0, 0.0])
    px, py = float(period[0]), float(period[1] if len(period) > 1 else period[0])

    value = np.zeros(u.shape, np.float32)
    weight = 0.0
    amplitude = 1.0
    for _ in range(max(levels, 1)):
        lw = amplitude**att
        if cellular:
            local = worley2d(u * sx, v * sy)
        else:
            local = perlin2d(u * sx, v * sy, (px, py))
        value += lw * local
        weight += lw
        amplitude *= 0.5
        sx *= 2.0
        sy *= 2.0
        px *= 2.0
        py *= 2.0
    value /= max(weight, 1e-9)

    unsigned = value if cellular else (
        np.abs(value) if params.get("absolute", False) else (value + 1.0) * 0.5
    )
    a = ratio - transition
    b = ratio + transition
    out = np.clip((unsigned - a) / max(b - a, 1e-9), 0.0, 1.0)
    if params.get("invert", False):
        out = 1.0 - out
    return out.astype(np.float32)


def checker_eval(params: dict, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """XOR checker (ref procedural_checker.zig, point-sampled at bake res —
    the bilinear arena sample supplies the filtering)."""
    scale = float(params.get("scale", 1.0))
    colors = params.get("colors", [[0.0] * 3, [1.0] * 3])
    ca = np.asarray(colors[0], np.float32).reshape(1, 1, -1)
    cb = np.asarray(colors[1], np.float32).reshape(1, 1, -1)
    t = (
        (np.floor(u * scale).astype(np.int64) ^ np.floor(v * scale).astype(np.int64)) & 1
    ).astype(np.float32)[..., None]
    return ca + t * (cb - ca)


# ---------------------------------------------------------------------------
# node-graph bake
# ---------------------------------------------------------------------------


def _eval_operand(v, u, vgrid, load_image, channels=3):
    """Operand of a procedural node: scalar, color, nested procedural, or
    {"file": ...} image resampled onto the bake grid."""
    if isinstance(v, (int, float)):
        return np.full(u.shape + (channels,), float(v), np.float32)
    if isinstance(v, (list, tuple)):
        arr = np.asarray(v, np.float32)
        return np.broadcast_to(arr, u.shape + (arr.shape[0],)).astype(np.float32)
    if is_procedural(v):
        return bake(v, u, vgrid, load_image)
    if isinstance(v, dict) and "file" in v and load_image is not None:
        img = load_image(v["file"])
        if img is None:
            return np.zeros(u.shape + (channels,), np.float32)
        h, w = img.shape[:2]
        xi = np.clip((u * w).astype(np.int64), 0, w - 1)
        yi = np.clip((vgrid * h).astype(np.int64), 0, h - 1)
        out = img[yi, xi]
        return out[..., :channels] if out.ndim == 3 else out[..., None]
    return np.zeros(u.shape + (channels,), np.float32)


def bake(value: dict, u=None, vgrid=None, load_image=None, res: int = BAKE_RES) -> np.ndarray:
    """Bake one procedural texture JSON node to [res, res, 3] float32."""
    if u is None:
        ys, xs = np.mgrid[0:res, 0:res]
        u = (xs.astype(np.float32) + 0.5) / res
        vgrid = (ys.astype(np.float32) + 0.5) / res

    if "Checker" in value:
        return checker_eval(value["Checker"], u, vgrid)
    if "Noise" in value:
        n = noise_eval(value["Noise"], u, vgrid)
        return np.repeat(n[..., None], 3, axis=-1)
    if "Mix" in value:
        node = value["Mix"]
        a = _eval_operand(node.get("a", 0.0), u, vgrid, load_image)
        b = _eval_operand(node.get("b", 1.0), u, vgrid, load_image)
        t = _eval_operand(node.get("weight", 0.5), u, vgrid, load_image, channels=1)
        return (a + t * (b - a)).astype(np.float32)
    if "Mul" in value:
        node = value["Mul"]
        a = _eval_operand(node.get("a", 1.0), u, vgrid, load_image)
        b = _eval_operand(node.get("b", 1.0), u, vgrid, load_image)
        return (a * b).astype(np.float32)
    if "Max" in value:
        node = value["Max"]
        a = _eval_operand(node.get("a", 0.0), u, vgrid, load_image)
        b = _eval_operand(node.get("b", 0.0), u, vgrid, load_image)
        return np.maximum(a, b).astype(np.float32)
    if "ChannelMix" in value:
        node = value["ChannelMix"]
        src = _eval_operand(node.get("source", 0.0), u, vgrid, load_image)
        ch = np.asarray(node.get("channels", np.eye(3)), np.float32)[:3, :3]
        return np.einsum("...c,kc->...k", src[..., :3], ch).astype(np.float32)
    if "DetailNormal" in value:
        node = value["DetailNormal"]
        base = _eval_operand(node.get("base", [0.5, 0.5, 1.0]), u, vgrid, load_image)
        detail = _eval_operand(node.get("detail", [0.5, 0.5, 1.0]), u, vgrid, load_image)
        # whiteout blend of tangent-space normals
        bn = base * 2.0 - 1.0
        dn = detail * 2.0 - 1.0
        n = np.stack(
            [bn[..., 0] + dn[..., 0], bn[..., 1] + dn[..., 1],
             np.maximum(bn[..., 2], 1e-3) * np.maximum(dn[..., 2], 1e-3)],
            axis=-1,
        )
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return ((n + 1.0) * 0.5).astype(np.float32)
    raise ValueError(f"not a procedural texture node: {list(value.keys())}")


# ---------------------------------------------------------------------------
# DEVICE-side analytic shade-time evaluation (ref context.zig:139-199
# screenspaceDifferentials feeding texture/procedural_noise.zig /
# procedural_checker.zig: the reference evaluates procedurals analytically
# per shading point with differential-based filtering; the bake above is
# now only the fallback for graphs with image operands).
#
# Filtering model: an isotropic footprint width `foot` in uv units (the
# integrator's pixel-cone proxy for the reference's screen-space
# differentials). Checker box-filters EXACTLY (separable square-wave
# integral); fbm noise fades octaves whose lattice frequency exceeds the
# footprint's Nyquist rate toward their statistical mean — the classic
# band-limited fbm.
# ---------------------------------------------------------------------------


def analytic_spec(value):
    """('checker'|'noise', hashable-params) for nodes the device evaluates
    analytically at shade time; None for graphs that must stay baked
    (image operands, combinators)."""
    if not isinstance(value, dict):
        return None
    if set(value.keys()) == {"Checker"}:
        p = value["Checker"]
        if not isinstance(p.get("scale", 1.0), (int, float)):
            return None
        colors = p.get("colors", [[0.0] * 3, [1.0] * 3])
        try:
            ca = tuple(float(x) for x in colors[0])
            cb = tuple(float(x) for x in colors[1])
        except TypeError:
            return None
        return ("checker", (float(p.get("scale", 1.0)), ca, cb))
    if set(value.keys()) == {"Noise"}:
        p = value["Noise"]
        scale = p.get("scale", [1.0, 1.0, 1.0])
        period = p.get("period", [0.0, 0.0, 0.0])
        if not isinstance(scale, (list, tuple)):
            scale = [scale]
        return ("noise", (
            p.get("class", "") == "Cellular",
            int(p.get("levels", 1)),
            float(p.get("attenuation", 0.0)),
            float(p.get("ratio", 0.5)),
            float(p.get("transition", 0.5)),
            float(scale[0]),
            float(scale[1] if len(scale) > 1 else scale[0]),
            float(period[0]),
            float(period[1] if len(period) > 1 else period[0]),
            bool(p.get("absolute", False)),
            bool(p.get("invert", False)),
        ))
    return None


# ---------------------------------------------------------------------------
# device-side analytic evaluation (torch)
# ---------------------------------------------------------------------------


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant, as XLA folds `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def _hash2_t(ix, iy):
    """_hash2 of int32 tensors: uint32 values held in int64."""
    h = mul_u32(u32(ix), 0x8DA6B343) ^ mul_u32(u32(iy), 0xD8163841)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0x85EBCA6B)
    return h ^ (h >> 16)


def perlin2d_t(x, y, period=(0.0, 0.0)):
    """Gradient noise of float32 tensors (counterpart of perlin2d_j)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def grad_dot(cx, cy, ox, oy):
        ix = (x0 + cx).to(torch.int32)
        iy = (y0 + cy).to(torch.int32)
        if period[0] > 0:
            ix = torch.remainder(ix, int(period[0]))
        if period[1] > 0:
            iy = torch.remainder(iy, int(period[1]))
        ang = _hash2_t(ix, iy).to(torch.float32) * (2.0 * 3.14159265 / 2**32)
        return fma(torch.cos(ang), fx - ox, torch.sin(ang) * (fy - oy))

    def fade(t):
        return t * t * t * fma(t, fma(t, 6.0, -15.0), 10.0)

    u, v = fade(fx), fade(fy)
    n00 = grad_dot(0, 0, 0.0, 0.0)
    n10 = grad_dot(1, 0, 1.0, 0.0)
    n01 = grad_dot(0, 1, 0.0, 1.0)
    n11 = grad_dot(1, 1, 1.0, 1.0)
    nx0 = fma(u, n10 - n00, n00)
    nx1 = fma(u, n11 - n01, n01)
    return float(np.float32(np.sqrt(2.0))) * fma(v, nx1 - nx0, nx0)


def worley2d_t(x, y):
    """Cellular F1 distance of float32 tensors (counterpart of worley2d_j)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    best = torch.full_like(x, 1e9)
    r = _recip(65535.0)
    for cy in (-1, 0, 1):
        for cx in (-1, 0, 1):
            h = _hash2_t((x0 + cx).to(torch.int32), (y0 + cy).to(torch.int32))
            # cx + jx - fx: the product fuses into the add of a non-zero
            # cell offset, else into the subtraction
            qx, qy = (h & 0xFFFF).to(torch.float32), (h >> 16).to(torch.float32)
            dx = fma(qx, r, float(cx)) - fx if cx else fma(qx, r, -fx)
            dy = fma(qy, r, float(cy)) - fy if cy else fma(qy, r, -fy)
            best = torch.minimum(best, fma(dx, dx, dy * dy))
    return sqrt(best)


_WORLEY_MEAN = 0.66  # spatial mean of F1 over the unit cell (host-measured)


def _checker_point(x):
    return torch.floor(x).to(torch.int32) & 1


def _checker_box(x, wx):
    """Box-filtered square wave: the mean of (floor(t) & 1) over
    [x - wx/2, x + wx/2], exactly; footprints under a milli-cell take the
    point sample (the float32 integral difference underflows there)."""
    wx = torch.clamp(wx, min=1e-3)

    def integ(y):  # int_0^y (floor(t) & 1) dt
        f = torch.floor(y * 0.5)
        return f + torch.clamp(y - 2.0 * f - 1.0, min=0.0)

    filt = (integ(x + 0.5 * wx) - integ(x - 0.5 * wx)) / wx
    return torch.where(wx > 1e-3, filt, _checker_point(x).to(torch.float32))


def eval_analytic(kind: str, params: tuple, uv, foot=None):
    """Analytic value of an `analytic_spec` node at uv ([N, 2] float32),
    with an optional isotropic footprint width foot ([N], uv units; None
    is a point sample). Returns [N, 4] (alpha 1)."""
    u = uv[:, 0]
    v = uv[:, 1]
    w = None if foot is None else torch.clamp(foot, min=0.0)
    if kind == "checker":
        scale, ca, cb = params
        su, sv = u * scale, v * scale
        if w is None:
            t = (_checker_point(su) ^ _checker_point(sv)).to(torch.float32)
        else:
            au = _checker_box(su, w * scale)
            av = _checker_box(sv, w * scale)
            t = fma(au, 1.0 - av, av * (1.0 - au))  # XOR of the filtered axes
        # ca + t (cb - ca) per channel, cb - ca folded in float32; a point
        # sample's t is 0 or 1, where fused and unfused agree
        ch = []
        for a, b in zip(ca, cb):
            d = float(np.float32(b) - np.float32(a))
            ch.append(t * d + a if w is None else fma(t, d, a))
        rgb = torch.stack(ch, dim=1)
    else:
        (cellular, levels, att, ratio, transition,
         sx, sy, px, py, absolute, invert) = params
        value = None
        weight = 0.0
        amplitude = 1.0
        for _ in range(max(levels, 1)):
            lw = amplitude ** att if att else 1.0
            if cellular:
                local = worley2d_t(u * sx, v * sy)
                mean = _WORLEY_MEAN
            else:
                local = perlin2d_t(u * sx, v * sy, (px, py))
                mean = 0.0
            if w is not None:
                # band limit: fade this octave toward its mean once the
                # footprint spans ~a lattice cell (frequency > Nyquist)
                fade_w = torch.clamp(2.0 - 4.0 * w * max(sx, sy), 0.0, 1.0)
                local = fma(fade_w, local - mean, mean)
            elif mean:
                local = (local - mean) + mean
            if value is None:
                value = local if lw == 1.0 else local * lw
            else:
                value = value + local if lw == 1.0 else fma(local, lw, value)
            weight += lw
            amplitude *= 0.5
            sx *= 2.0
            sy *= 2.0
            px *= 2.0
            py *= 2.0
        value = value * _recip(max(weight, 1e-9))
        if cellular:
            unsigned = value
        else:
            unsigned = torch.abs(value) if absolute else (value + 1.0) * 0.5
        a = ratio - transition
        b = ratio + transition
        out = torch.clamp((unsigned - a) * _recip(max(b - a, 1e-9)), 0.0, 1.0)
        if invert:
            out = 1.0 - out
        rgb = out[:, None].expand(-1, 3)
    return torch.cat([rgb, torch.ones_like(u)[:, None]], dim=1)
