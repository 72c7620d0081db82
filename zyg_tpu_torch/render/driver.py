"""Render driver: frame orchestration (counterpart of
zyg_tpu/render/driver.py, the persistent-wavefront PTMIS/PTDL subset).

Deterministic seeding law (ref worker.zig:136-149):
    pixel_id     = y * W + x
    sobol sample = pixel_id * num_expected_samples + iteration
    sobol seed   = iteration // num_expected_samples
with num_expected_samples = max(spp, 2), as in the JAX driver.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.png import float_to_srgb8, write_png
from ..io.take import Take
from ..scene.types import SceneData
from . import sensor as sensor_mod
from .integrator import ptmis as ptmis_mod
from .sensor import Framebuffer

# samples per dispatch: the JAX driver dispatches shuffled frames in
# 16-sample chunks (zyg_tpu/render/driver.py), and the lane->pixel shuffle
# and the final chunk's slack follow the chunk, so the port chunks the same
# way to keep the sample streams equal
_CHUNK = 16


def resolve_device(device: torch.device | str) -> torch.device:
    """The render device; a CUDA device without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
    return device


class Driver:
    """Progressive frame renderer for one camera."""

    def __init__(self, take: Take, scene: SceneData, device: torch.device | str = "cuda"):
        self.take = take
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.camera = take.cameras[0]
        w, h = self.camera.resolution
        self._pixel_ids = torch.arange(w * h, dtype=torch.int64, device=self.device)
        integ = take.integrator
        self.settings = ptmis_mod.PtmisSettings(
            max_depth=integ.max_depth_surface, caustics=integ.caustics,
            nee_only=integ.kind == "PTDL",
        )
        clamp = take.sensor.clamp
        self._clamp_max = (clamp.emission, clamp.direct, clamp.indirect)
        spp = max(take.num_samples_per_pixel, 1)
        self.chunk_size = min(spp, _CHUNK)
        self.start_frame()

    def start_frame(self):
        w, h = self.camera.resolution
        self._fb = Framebuffer.zeros(w * h, self.device)
        self._iteration = 0
        self.rays_traced = 0
        self.last_iterations = 0  # wavefront loop iterations of the last dispatch

    def render_iterations(self, num: int | None = None) -> Framebuffer:
        """Render `num` further samples per pixel (default: take spp)."""
        num = num if num is not None else self.take.num_samples_per_pixel
        cam_arrays = self.camera.arrays(self.device)
        w = self.camera.resolution[0]
        done = 0
        while done < num:
            n = min(self.chunk_size, num - done)
            # final chunk: oversample — fast lanes keep regenerating past
            # their quota so the wavefront drains at the MEAN path length
            slack = max(2, n // 2) if done + n >= num else 0
            acc, rays, iters, counts = ptmis_mod.integrate_persistent(
                self.scene, cam_arrays, self._pixel_ids, self._iteration, n,
                max(self.take.num_samples_per_pixel, 2), self.settings, self._clamp_max,
                frame_width=w, oversample_slack=slack,
            )
            self._fb = Framebuffer(self._fb.value + acc, self._fb.weight + counts)
            self.rays_traced += int(rays)
            self.last_iterations = iters
            self._iteration += n
            done += n
        return self._fb

    def render_frame(self) -> np.ndarray:
        """Full frame at take spp. Returns linear [H, W, 3]."""
        self.start_frame()
        if self.take.num_samples_per_pixel > 0:
            self.render_iterations(self.take.num_samples_per_pixel)
        return self.resolve()

    def resolve(self, tonemapped: bool = False) -> np.ndarray:
        w, h = self.camera.resolution
        img = self._fb.resolve().reshape(h, w, 3)
        if tonemapped:
            s = self.take.sensor
            img = sensor_mod.tonemap(img, s.tonemapper, s.exposure, look=s.look)
        return img.cpu().numpy()

    def export_frame(self, path: str):
        """Write the tonemapped frame as an sRGB8 PNG."""
        if not path.lower().endswith(".png"):
            raise ValueError(f"the port exports PNG only: {path}")
        write_png(path, float_to_srgb8(self.resolve(tonemapped=True)))
