"""Batched 3-vector, frame, quaternion and transform math (the part of
zyg_tpu/core/vecmath.py that the mesh paths, motion blur and the general
bounce use).

Arrays carry the vector on the last axis and broadcast over leading batch
axes. A transform is (rotation rows, position, scale), rot[i] being the
i-th object axis in world space (ref composed_transformation.zig).

Products are rounded as XLA rounds the JAX package's jitted bounces on
the CPU (probed bit for bit): a 3-element reduction is the fused chain
fma(a2, b2, fma(a1, b1, a0 * b0)) (core/fmath.dot3); in `a*b + c*d` and
`a*b - c*d` the FIRST product is fused, fma(a, b, +-(c * d)); a third
product term fuses onto that sum. Scene constants (an instance's
quaternion and scale) are folded by XLA in plain float32 arithmetic, and
a division by one becomes a multiplication by its reciprocal.
"""

from __future__ import annotations

import math

import torch

from .fmath import dot3, fma, sqrt


def _c(v):
    return v[..., 0], v[..., 1], v[..., 2]


def dot(a, b):
    a0, a1, a2 = _c(a)
    b0, b1, b2 = _c(b)
    return dot3(a0, b0, a1, b1, a2, b2)


def cross(a, b):
    a0, a1, a2 = _c(a)
    b0, b1, b2 = _c(b)
    return torch.stack([
        fma(a1, b2, -(a2 * b1)),
        fma(a2, b0, -(a0 * b2)),
        fma(a0, b1, -(a1 * b0)),
    ], dim=-1)


def length(v):
    return sqrt(torch.clamp(dot(v, v), min=0.0))


def safe_normalize(v):
    return v * (1.0 / torch.clamp(length(v), min=1e-20))[..., None]


def orthonormal_basis(n):
    """Duff et al. branch-free frame (t, b) around unit normal n, t x b = n
    (ref vector4.zig Frame.init)."""
    nx, ny, nz = _c(n)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([fma(sign * nx * nx, a, 1.0), sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, fma(ny * ny, a, sign), -ny], dim=-1)
    return t, bt


def frame_to_world(t, b, n, v):
    """Local vector v -> world, given the frame rows t, b, n."""
    return fma(v[..., 2:3], n, fma(v[..., 0:1], t, v[..., 1:2] * b))


def world_to_frame(t, b, n, v):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def sample_hemisphere_cosine(uv):
    """Cosine-weighted direction about +z: uv [..., 2] -> [..., 3]."""
    u, v = uv[..., 0], uv[..., 1]
    r = sqrt(u)
    phi = (2.0 * math.pi) * v
    z = sqrt(torch.clamp(1.0 - u, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def quat_to_mat3(q):
    """Quaternion (x, y, z, w) -> 3x3 rotation, rows = rotated basis axes
    (ref quaternion.zig toMat3x3). Unfused: in the JAX package's bounces
    an instance's quaternion is a scene constant, which XLA folds with
    plain float32 operations."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = 2.0 * x * x, 2.0 * y * y, 2.0 * z * z
    xy, xz, yz = 2.0 * x * y, 2.0 * x * z, 2.0 * y * z
    wx, wy, wz = 2.0 * w * x, 2.0 * w * y, 2.0 * w * z
    r0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1)
    r1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1)
    r2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1)
    return torch.stack([r0, r1, r2], dim=-2)


def lerp(a, b, t):
    """a + (b - a) * t, the product fused into the add as XLA fuses it."""
    return fma(b - a, t, a)


def quat_slerp(a, b, t):
    """Spherical interpolation of unit quaternions a -> b at t (broadcast
    over a trailing axis of 1), in zyg_tpu/core/vecmath.py:179-190's
    order: b flips where cos(a, b) < 0, a lerp where cos > 0.9995, else
    the sine weights over max(sin, 1e-12), then the normalize. The dot
    products are fused chains (probed against the jitted JAX function:
    equal on ~67 % of random lanes, the rest an ulp apart through XLA's
    own acos and sin)."""
    a0, a1, a2, a3 = (a[..., k : k + 1] for k in range(4))
    cosom = fma(a3, b[..., 3:4], fma(a2, b[..., 2:3], fma(a1, b[..., 1:2], a0 * b[..., 0:1])))
    b = torch.where(cosom < 0.0, -b, b)
    cosom = torch.abs(cosom)
    om = torch.acos(torch.clamp(cosom, -1.0, 1.0))
    sinom = torch.clamp(torch.sin(om), min=1e-12)
    close = cosom > 0.9995
    one_t = 1.0 - t
    wa = torch.where(close, one_t, torch.sin(one_t * om) / sinom)
    wb = torch.where(close, t, torch.sin(t * om) / sinom)
    out = fma(wa, a, wb * b)
    o0, o1, o2, o3 = (out[..., k : k + 1] for k in range(4))
    return out / sqrt(fma(o3, o3, fma(o2, o2, fma(o1, o1, o0 * o0))))


def object_to_world_normal(rot, v):
    """sum_i v_i * rot[i] (rotation only: the reference's uniform-scale
    normal transform)."""
    v0, v1, v2 = (v[..., i : i + 1] for i in range(3))
    return fma(v2, rot[..., 2, :], fma(v0, rot[..., 0, :], v1 * rot[..., 1, :]))


def object_to_world_vector(rot, scale, v):
    """sum_i (v_i * scale_i) * rot[i]: an object-space vector to world."""
    return object_to_world_normal(rot, v * scale)


def object_to_world_point(rot, scale, pos, p):
    return object_to_world_vector(rot, scale, p) + pos


def sample_triangle_uniform(uv):
    """Uniform barycentrics (u, v) on the unit triangle from uv [N, 2]
    (Heitz 2019's square-root-free map, zyg_tpu/core/vecmath.py:315)."""
    u, v = uv[..., 0], uv[..., 1]
    lt = u < v
    return torch.stack([torch.where(lt, 0.5 * u, u - 0.5 * v),
                        torch.where(lt, v - 0.5 * u, 0.5 * v)], dim=-1)


def world_to_object_normal(rot, v):
    """(v . rot[0], v . rot[1], v . rot[2]): rotation only."""
    return torch.stack([dot(v, rot[..., 0, :]), dot(v, rot[..., 1, :]), dot(v, rot[..., 2, :])], -1)


def world_to_object_vector(rot, scale, v):
    """(v @ rot^T) / scale, the division as a multiplication by 1/scale:
    XLA's rounding where the transform is a folded scene constant (a
    scene's instance and prop transforms are, in the JAX package's
    jitted bounces)."""
    return world_to_object_normal(rot, v) * (1.0 / scale)


def world_to_object_point(rot, scale, pos, p):
    return world_to_object_vector(rot, scale, p - pos)


def sample_disk_concentric(uv):
    """Concentric map of [0, 1)^2 onto the unit disk (Shirley-Chiu; ref
    sample_distribution.zig diskConcentric): uv [..., 2] -> [..., 2]."""
    sx, sy = 2.0 * uv[..., 0] - 1.0, 2.0 * uv[..., 1] - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    use_x = torch.abs(sx) > torch.abs(sy)
    r = torch.where(use_x, sx, sy)
    ratio = torch.where(use_x, sy / torch.where(sx == 0.0, 1.0, sx),
                        sx / torch.where(sy == 0.0, 1.0, sy))
    quarter = math.pi / 4.0
    phi = torch.where(use_x, quarter * ratio, math.pi / 2.0 - quarter * ratio)
    x = torch.where(zero, 0.0, r * torch.cos(phi))
    y = torch.where(zero, 0.0, r * torch.sin(phi))
    return torch.stack([x, y], dim=-1)


def sample_sphere_uniform(uv):
    """Uniform direction on the unit sphere (zyg_tpu/core/vecmath.py:293-298):
    uv [..., 2] -> (direction [..., 3], pdf 1/(4 pi) [...]). 1 - z*z is
    fused as XLA fuses it; XLA's cos and sin round apart from torch's by
    an ulp on a few percent of the lanes."""
    u, v = uv[..., 0], uv[..., 1]
    z = 1.0 - 2.0 * u
    r = sqrt(torch.clamp(fma(-z, z, 1.0), min=0.0))
    phi = (2.0 * math.pi) * v
    return (torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1),
            torch.full_like(u, 1.0 / (4.0 * math.pi)))
