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
from ..scene.types import SceneData, UnsupportedScene
from . import sensor as sensor_mod
from .integrator import ptmis as ptmis_mod
from .sensor import Framebuffer

# the light tree's size from which the JAX Driver splits NEE over several
# picks a vertex (zyg_tpu/render/driver.py:265-270), which the port lacks
SPLIT_MIN_FINITE_LIGHTS = 16

# samples per dispatch, by the JAX driver's rule for shuffled persistent
# frames (zyg_tpu/render/driver.py:276-289): 8 for a scene with nested
# device loops (of what the port loads, meshes and density grids), 16
# otherwise. The lane->pixel shuffle and the final chunk's slack follow
# the chunk, so the port chunks the same way to keep the per-pixel sample
# sets equal.
_CHUNK_HEAVY = 8
_CHUNK = 16
# pixels per dispatch of a scene with nested device loops, by the JAX
# driver's tile rule (zyg_tpu/render/driver.py:185-190, :481-540): mesh-only
# scenes in tiles of 2^21 pixels, scenes with density grids in tiles of
# _HEAVY_TILE; each tile is its own shuffled persistent run with its own
# final-chunk slack, so the port tiles the same way
_HEAVY_TILE = 1 << 18
_MESH_TILE = 1 << 21


def resolve_device(device: torch.device | str) -> torch.device:
    """The render device; a CUDA device without CUDA raises (no fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
    return device


class Driver:
    """Progressive frame renderer for one camera."""

    def __init__(self, take: Take, scene: SceneData, device: torch.device | str = "cuda"):
        tree = scene.light_tree
        if (tree is not None and tree.num_finite >= SPLIT_MIN_FINITE_LIGHTS
                and take.integrator.light_split_threshold > 0.0):
            raise UnsupportedScene(
                f"NEE light splitting ({tree.num_finite} finite lights in the light tree and "
                "split_threshold > 0): the port samples one light a vertex")
        integ = take.integrator
        self.settings = ptmis_mod.PtmisSettings(
            max_depth=integ.max_depth_surface, max_depth_volume=integ.max_depth_volume,
            caustics=integ.caustics, nee_only=integ.kind == "PTDL", bsdf_split=integ.bsdf_split,
        )
        # the dispatch's refusals surface here, not mid-render
        ptmis_mod.check_scene(scene, self.settings)
        self.take = take
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.camera = take.cameras[0]
        w, h = self.camera.resolution
        self._pixel_ids = torch.arange(w * h, dtype=torch.int64, device=self.device)
        clamp = take.sensor.clamp
        self._clamp_max = (clamp.emission, clamp.direct, clamp.indirect)
        spp = max(take.num_samples_per_pixel, 1)
        self._heavy_loops = scene.meshes is not None or scene.grids is not None
        self.chunk_size = min(spp, _CHUNK_HEAVY if self._heavy_loops else _CHUNK)
        self.start_frame()

    def start_frame(self):
        w, h = self.camera.resolution
        self._fb = Framebuffer.zeros(w * h, self.device)
        self._iteration = 0
        self.rays_traced = 0
        self.last_iterations = 0  # wavefront loop iterations of the last dispatch
        self.iterations = 0  # wavefront loop iterations of every dispatch since start_frame

    def chunk_plan(self, num: int) -> list[tuple[int, int]]:
        """The dispatches of `num` samples per pixel: (samples, oversample
        slack) each, as zyg_tpu/render/driver.py:505-515 walks them."""
        plan = []
        done = 0
        while done < num:
            n = min(self.chunk_size, num - done)
            done += n
            # final chunk: oversample — fast lanes keep regenerating past
            # their quota so the wavefront drains at the MEAN path length
            plan.append((n, max(2, n // 2) if done >= num else 0))
        return plan

    def tile_plan(self) -> list[tuple[int, int]]:
        """The pixel ranges [t0, t1) of each dispatch of a chunk, as
        zyg_tpu/render/driver.py:497-519 cuts the frame: tiles of
        _MESH_TILE pixels for a scene whose only nested loops are mesh
        walks, of _HEAVY_TILE with density grids, the whole frame
        otherwise."""
        n = self._pixel_ids.shape[0]
        tile = n
        if self._heavy_loops:
            tile = min(n, _MESH_TILE if self.scene.grids is None else _HEAVY_TILE)
        return [(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]

    def render_iterations(self, num: int | None = None) -> Framebuffer:
        """Render `num` further samples per pixel (default: take spp): each
        chunk of chunk_plan over each tile of tile_plan."""
        num = num if num is not None else self.take.num_samples_per_pixel
        cam_arrays = self.camera.arrays(self.device)
        w = self.camera.resolution[0]
        tiles = self.tile_plan()
        for n, slack in self.chunk_plan(num):
            value, weight = self._fb.value.clone(), self._fb.weight.clone()
            for t0, t1 in tiles:
                acc, rays, iters, counts = ptmis_mod.integrate_persistent(
                    self.scene, cam_arrays, self._pixel_ids[t0:t1], self._iteration, n,
                    max(self.take.num_samples_per_pixel, 2), self.settings, self._clamp_max,
                    frame_width=w, oversample_slack=slack,
                )
                value[t0:t1] += acc
                weight[t0:t1] += counts
                self.rays_traced += int(rays)
                self.last_iterations = iters
                self.iterations += iters
            self._fb = Framebuffer(value, weight)
            self._iteration += n
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
