"""Perspective camera (counterpart of zyg_tpu/render/camera.py, the
pinhole subset with its shutter): NDC x in [-1,1], y in [ratio,-ratio]
(ratio=h/w), z = 1/tan(fov/2), fov horizontal; rays = left_top +
d_x*(px+ux) + d_y*(py+uy), rotated to world by the camera transform
(rows-as-axes). ref camera_perspective.zig.

The shutter (ref camera_base.zig): frame f spans [f*frame_step +
open*dur, f*frame_step + close*dur] seconds, dur = frame_step with
motion blur, else 0 (`frame_interval`); a lane's shutter time in [0, 1]
is a uniform draw mapped through the inverse CDF of the shutter's
response, baked on the host (`_shutter_icdf`; None, the identity, for
the uniform shutter).

`camera_sample_to` connects a world point to the camera for the
lighttracer (ref camera_perspective.zig sampleTo): its pixel, the
direction and distance to the pinhole and the sensor importance."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.fmath import fma


@dataclass
class CameraArrays:
    """Device-side camera constants: rays are an affine function of the
    pixel coordinate, dir_local = d_base + d_dx*cx + d_dy*cy."""

    rot: torch.Tensor  # [3,3] rows = camera axes in world
    pos: torch.Tensor  # [3]
    d_base: torch.Tensor  # [3]
    d_dx: torch.Tensor  # [3]
    d_dy: torch.Tensor  # [3]
    # the shutter response's inverse CDF at K+1 control points, or None
    # for the uniform shutter (sample_shutter_time)
    shutter_icdf: torch.Tensor | None = None  # [K + 1]


@dataclass
class PerspectiveCamera:
    resolution: tuple[int, int] = (1280, 720)
    fov: float = float(np.deg2rad(60.0))  # horizontal, radians
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # frame timing and the shutter (ref camera_base.zig frame_step,
    # take_loader.zig loadShutter); the slope's bezier handles: 4 shape the
    # opening ramp, 8 the closing one too
    frame_step: float = 1.0 / 60.0
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    motion_blur: bool = True
    shutter_slope: tuple = ()

    def frame_interval(self, frame: int) -> tuple[float, float]:
        """The shutter interval of `frame` in seconds."""
        t0 = frame * self.frame_step
        dur = self.frame_step if self.motion_blur else 0.0
        return (t0 + self.shutter_open * dur, t0 + self.shutter_close * dur)

    def _shutter_icdf(self, k: int = 32) -> np.ndarray | None:
        """Inverse CDF control points [k + 1] of the shutter response (ref
        camera_base.zig setShutter: trapezoid open/close ramps, optional
        cubic bezier slope handles), as zyg_tpu/render/camera.py:163-226
        bakes it. None for the uniform shutter."""
        if self.shutter_open <= 0.0 and self.shutter_close >= 1.0 and len(self.shutter_slope) < 4:
            return None
        m = 512
        t = (np.arange(m) + 0.5) / m
        f = np.ones(m, np.float64)
        op, cl = float(self.shutter_open), float(self.shutter_close)
        sl = [float(x) for x in self.shutter_slope]

        def bezier_y_at_x(cp, xs):
            # 16-step bisection a sample (ref camera_base searchBezier)
            u = np.full(len(xs), 0.5)
            step = 0.25
            for _ in range(16):
                omu = 1.0 - u
                cx = (omu**3 * cp[0][0] + 3 * omu**2 * u * cp[1][0]
                      + 3 * omu * u**2 * cp[2][0] + u**3 * cp[3][0])
                u = np.where(xs < cx, u - step, np.where(xs > cx, u + step, u))
                step *= 0.5
            omu = 1.0 - u
            return (omu**3 * cp[0][1] + 3 * omu**2 * u * cp[1][1]
                    + 3 * omu * u**2 * cp[2][1] + u**3 * cp[3][1])

        ramp_in = t < op
        if op > 0.0:
            if len(sl) >= 4:
                f[ramp_in] = bezier_y_at_x([(0.0, 0.0), (sl[0], sl[1]), (sl[2], sl[3]), (op, 1.0)],
                                           t[ramp_in])
            else:
                f[ramp_in] = t[ramp_in] / op
        ramp_out = t > cl
        if cl < 1.0:
            if len(sl) >= 8:
                f[ramp_out] = bezier_y_at_x([(cl, 1.0), (sl[4], sl[5]), (sl[6], sl[7]), (1.0, 0.0)],
                                            t[ramp_out])
            else:
                f[ramp_out] = (1.0 - t[ramp_out]) / (1.0 - cl)
        cdf = np.concatenate([[0.0], np.cumsum(np.maximum(f, 0.0))])
        cdf /= max(cdf[-1], 1e-20)
        xs = np.linspace(0.0, 1.0, m + 1)
        u = np.linspace(0.0, 1.0, k + 1)
        return np.interp(u, cdf, xs).astype(np.float32)

    def arrays(self, device: torch.device | str = "cpu") -> CameraArrays:
        w, h = self.resolution
        ratio = h / w
        z = 1.0 / np.tan(0.5 * self.fov)
        d_base = np.array([-1.0, ratio, z], np.float32)
        right_top = np.array([1.0, ratio, z], np.float32)
        left_bottom = np.array([-1.0, -ratio, z], np.float32)
        d_dx = (right_top - d_base) / w
        d_dy = (left_bottom - d_base) / h

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        icdf = self._shutter_icdf()
        return CameraArrays(
            rot=t(self.rotation), pos=t(self.position), d_base=t(d_base), d_dx=t(d_dx), d_dy=t(d_dy),
            shutter_icdf=None if icdf is None else t(icdf),
        )


def sample_shutter_time(cam: CameraArrays, u: torch.Tensor) -> torch.Tensor:
    """A uniform draw -> shutter-relative time in [0, 1], through the baked
    inverse CDF (ref camera_base.zig sampleShutterTime; the lerp of
    zyg_tpu/render/camera.py:342-355, fused as XLA fuses it); the identity
    for the uniform shutter."""
    if cam.shutter_icdf is None:
        return u
    k = cam.shutter_icdf.shape[0] - 1
    x = torch.clamp(u, 0.0, 1.0 - 1e-7) * k
    i = x.to(torch.int64)
    f = x - i.to(torch.float32)
    a = cam.shutter_icdf[i]
    b = cam.shutter_icdf[torch.clamp(i + 1, max=k)]
    return fma(f, b - a, a)


def camera_sample_to(cam: CameraArrays, resolution, p: torch.Tensor):
    """Connect world points p [N, 3] to the camera (zyg_tpu/render/
    camera.py:282-312): (pixel xy int32[N, 2], the direction from p toward
    the camera [N, 3], the distance t [N], the sensor-importance pdf wa *
    wb [N], 0 where invalid, valid bool[N]). A point is valid in front of
    the camera (cos > 1e-6) on a pixel of the frame; the pixel is the
    floor of the sensor-plane offset, so its rounding decides border
    pixels. The JAX operation order throughout, each division a
    tensor-by-tensor division (on CUDA torch turns a division by a Python
    float into a multiplication by its reciprocal)."""
    w, h = resolution
    po = vm.world_to_frame(cam.rot[0], cam.rot[1], cam.rot[2], p - cam.pos)
    t = vm.length(po)
    dirs = po / torch.clamp(t, min=1e-20)[:, None]
    cos_theta = dirs[:, 2]
    valid = cos_theta > 1e-6
    # project onto the sensor plane
    z = cam.d_base[2]
    pd = (z / torch.clamp(dirs[:, 2], min=1e-6))[:, None] * dirs
    offset = pd - cam.d_base
    px = torch.floor(offset[:, 0] / cam.d_dx[0]).to(torch.int32)
    py = torch.floor(offset[:, 1] / cam.d_dy[1]).to(torch.int32)
    valid = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # the sensor area factor a (ref camera_perspective.zig update: self.a),
    # float32 divisions of the Python constants as XLA rounds them
    two = torch.full_like(z, 2.0)
    a = torch.abs((two / z) * (torch.full_like(z, 2.0 * (h / w)) / z))
    cos2 = cos_theta * cos_theta
    wa = cos_theta / torch.clamp(t * t, min=1e-12)
    wb = torch.ones_like(cos2) / torch.clamp(a * cos2 * cos2, min=1e-12)
    pdf = torch.where(valid, wa * wb, 0.0)
    dir_to_cam = vm.safe_normalize(cam.pos - p)
    return torch.stack([px, py], dim=-1), dir_to_cam, t, pdf, valid


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """vm.normalize: v * 1/max(|v|, 0) with |v| = sqrt(max(dot(v, v), 0))."""
    sq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    length = torch.sqrt(torch.clamp(sq, min=0.0))
    return v * (1.0 / length)[..., None]


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """vm.object_to_world_normal: v_x * rot[0] + v_y * rot[1] + v_z * rot[2]."""
    return v[..., 0:1] * rot[0] + v[..., 1:2] * rot[1] + v[..., 2:3] * rot[2]


def generate_rays(cam: CameraArrays, pixel_xy: torch.Tensor, pixel_uv: torch.Tensor):
    """pixel_xy int[N,2], pixel_uv float[N,2] -> (origin[N,3], dir[N,3]).
    ref camera_perspective.zig generateVertex (pinhole)."""
    coords = pixel_xy.to(torch.float32) + pixel_uv
    direction = cam.d_base + cam.d_dx * coords[..., 0:1] + cam.d_dy * coords[..., 1:2]
    # normalize AFTER the rotation too: look_at rotations are not
    # orthonormalized, so the transform can scale lengths
    d_world = _normalize(_rotate(cam.rot, _normalize(direction)))
    o_world = torch.zeros_like(d_world) + cam.pos
    return o_world, d_world
