"""Render driver: frame orchestration (counterpart of
zyg_tpu/render/driver.py for what the port renders).

Two paths, chosen as the JAX driver chooses (:64-69, :240-244):
- the persistent wavefront (render/integrator/ptmis.py::
  integrate_persistent) for PTMIS and PTDL with a filter radius of at most
  2: shuffled lanes, or unshuffled when sensor AOVs ride;
- the per-sample scan (`_render_samples`, :108-181) for every other take
  (PT, AOV): each sample of a chunk traces the whole frame's camera rays
  to the end, then adds them to the framebuffer (box) or splats them
  (filtered, ops/accum.py::flush_filtered with taps clamped to the edge).

Deterministic seeding law (ref worker.zig:136-149):
    pixel_id     = y * W + x
    sobol sample = pixel_id * num_expected_samples + iteration
    sobol seed   = iteration // num_expected_samples
with num_expected_samples = max(spp, 2), as in the JAX driver.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..core.rng import MASK, mul_u32
from ..core.sobol import SobolSampler
from ..io.exr import write_exr
from ..io.png import float_to_srgb8, write_png
from ..io.rgbe import write_hdr
from ..io.take import Take
from ..scene.types import SceneData, UnsupportedScene
from . import sensor as sensor_mod
from .camera import generate_rays, sample_shutter_time
from .integrator import aov as aov_mod
from .integrator import pt as pt_mod
from .integrator import ptmis as ptmis_mod
from .sensor import Framebuffer

# the light tree's size from which the JAX Driver splits NEE over several
# picks a vertex (zyg_tpu/render/driver.py:265-270), which the port lacks
SPLIT_MIN_FINITE_LIGHTS = 16

# samples per dispatch, by the JAX driver's rule (zyg_tpu/render/
# driver.py:283-293): on the persistent path 8 for a scene with nested
# device loops (of what the port loads, meshes and density grids), else 16
# for a shuffled dispatch and 64 for an unshuffled one (AOVs); on the scan
# path min(16, _SCAN_LANES // pixels). The lane->pixel shuffle and the
# final chunk's slack follow the chunk, so the port chunks the same way to
# keep the per-pixel sample sets equal.
_CHUNK_HEAVY = 8
_CHUNK = 16
_CHUNK_UNSHUFFLED = 64
_SCAN_LANES = 4_000_000
# pixels per dispatch of a box-filtered scene with nested device loops, by
# the JAX driver's tile rule (zyg_tpu/render/driver.py:185-190, :481-540):
# mesh-only scenes in tiles of 2^21 pixels, scenes with density grids in
# tiles of _HEAVY_TILE; each tile is its own dispatch with its own
# final-chunk slack, so the port tiles the same way. Filtered renders do
# not tile: their splats cross tile borders.
_HEAVY_TILE = 1 << 18
_MESH_TILE = 1 << 21

_log = logging.getLogger("zyg_tpu_torch")


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
        self.take = take
        self.camera = take.cameras[0]
        w, h = self.camera.resolution
        self.filter_radius = int(round(take.sensor.filter_radius))
        self.persistent = integ.kind in ("PTMIS", "PTDL") and self.filter_radius <= 2
        # sensor AOVs ride the persistent path only (the scan path has no
        # per-bounce capture); alpha coverage comes with alpha_transparency
        aovs = tuple(take.aovs)
        if take.sensor.alpha_transparency and "alpha" not in aovs:
            aovs = aovs + ("alpha",)
        self.aov_names = aovs if self.persistent else ()
        if aovs and not self.persistent:
            _log.warning(
                "sensor AOVs/alpha (%s) require the persistent wavefront path (PTMIS/PTDL with "
                "filter_radius <= 2); this take uses %s with filter_radius %s: AOV planes will "
                "not be rendered", ", ".join(aovs), integ.kind, take.sensor.filter_radius)
        self.settings = ptmis_mod.PtmisSettings(
            max_depth=integ.max_depth_surface, max_depth_volume=integ.max_depth_volume,
            caustics=integ.caustics, nee_only=integ.kind == "PTDL", bsdf_split=integ.bsdf_split,
            collect_aovs=self.aov_names,
        )
        # the dispatch's refusals surface here, not mid-render
        if self.persistent:
            ptmis_mod.check_scene(scene, self.settings)
        else:
            self._check_scan_scene(scene)
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self._pixel_ids = torch.arange(w * h, dtype=torch.int64, device=self.device)
        clamp = take.sensor.clamp
        self._clamp_max = (clamp.emission, clamp.direct, clamp.indirect)
        # the lane->pixel shuffle balances work; AOV planes accumulate by lane,
        # so a dispatch with AOVs is unshuffled
        self._frame_width = w if (self.persistent and not self.aov_names) else 0
        spp = max(take.num_samples_per_pixel, 1)
        self._heavy_loops = scene.meshes is not None or scene.grids is not None
        if self.persistent:
            self.chunk_size = min(spp, _CHUNK_HEAVY if self._heavy_loops else (
                _CHUNK if self._frame_width else _CHUNK_UNSHUFFLED))
        else:
            self.chunk_size = min(spp, _CHUNK, max(1, _SCAN_LANES // max(w * h, 1)))
        self.start_frame()

    def _check_scan_scene(self, scene) -> None:
        """The PT and AOV integrators render the scenes the general body
        renders; others raise UnsupportedScene by name."""
        from .integrator.ptmis_general import check_general

        try:
            check_general(scene, self.settings)
        except UnsupportedScene as e:
            raise UnsupportedScene(f"the {self.take.integrator.kind} integrator on {e}") from None

    def start_frame(self):
        w, h = self.camera.resolution
        self._fb = Framebuffer.zeros(w * h, self.device)
        self._aov = ptmis_mod.aov_init(self.aov_names, w * h, self.device)
        self._iteration = 0
        self.rays_traced = 0
        # wavefront loop iterations (scan path: PT bounces) of the last
        # dispatch, and of every dispatch since start_frame
        self.last_iterations = 0
        self.iterations = 0

    def chunk_plan(self, num: int) -> list[tuple[int, int]]:
        """The dispatches of `num` samples per pixel: (samples, oversample
        slack) each, as zyg_tpu/render/driver.py:505-515 walks them (slack
        on a shuffled frame's final chunk only)."""
        plan = []
        done = 0
        while done < num:
            n = min(self.chunk_size, num - done)
            done += n
            # final chunk: oversample — fast lanes keep regenerating past
            # their quota so the wavefront drains at the MEAN path length
            plan.append((n, max(2, n // 2) if (self._frame_width > 0 and done >= num) else 0))
        return plan

    def tile_plan(self) -> list[tuple[int, int]]:
        """The pixel ranges [t0, t1) of each dispatch of a chunk, as
        zyg_tpu/render/driver.py:484-519 cuts the frame: box-filtered scenes
        whose only nested loops are mesh walks in tiles of _MESH_TILE
        pixels, with density grids of _HEAVY_TILE, the whole frame
        otherwise."""
        n = self._pixel_ids.shape[0]
        tile = n
        if self._heavy_loops and self.filter_radius == 0:
            tile = min(n, _MESH_TILE if self.scene.grids is None else _HEAVY_TILE)
        return [(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]

    def render_iterations(self, num: int | None = None) -> Framebuffer:
        """Render `num` further samples per pixel (default: take spp): each
        chunk of chunk_plan over each tile of tile_plan."""
        num = num if num is not None else self.take.num_samples_per_pixel
        cam_arrays = self.camera.arrays(self.device)
        tiles = self.tile_plan()
        for n, slack in self.chunk_plan(num):
            for t0, t1 in tiles:
                if self.persistent:
                    self._dispatch_persistent(cam_arrays, t0, t1, n, slack)
                else:
                    self._dispatch_scan(cam_arrays, t0, t1, n)
            self._iteration += n
        return self._fb

    def _dispatch_persistent(self, cam_arrays, t0, t1, n, slack) -> None:
        acc, rays, iters, counts, aov = ptmis_mod.integrate_persistent(
            self.scene, cam_arrays, self._pixel_ids[t0:t1], self._iteration, n,
            max(self.take.num_samples_per_pixel, 2), self.settings, self._clamp_max,
            frame_width=self._frame_width, oversample_slack=slack,
            filter_name=self.take.sensor.filter_name, filter_radius=self.filter_radius,
            resolution=self.camera.resolution,
        )
        self._fb.value[t0:t1] += acc
        self._fb.weight[t0:t1] += counts
        # the tile's AOV planes merge by their accumulation mode
        for name, part in aov.items():
            cur = self._aov[name][t0:t1]
            mode = ptmis_mod.AOV_SPECS[name][1]
            if mode == "sum":
                cur += part
            elif mode == "min":
                torch.minimum(cur, part, out=cur)
            else:
                torch.maximum(cur, part, out=cur)
        self.rays_traced += int(rays)
        self.last_iterations = iters
        self.iterations += iters

    def _dispatch_scan(self, cam_arrays, t0, t1, n) -> None:
        """`n` consecutive samples of the pixels [t0, t1), one after another
        (zyg_tpu/render/driver.py:108-181 one_sample): each traces every
        pixel's camera ray to the end, then adds to the framebuffer."""
        integ = self.take.integrator
        w, h = self.camera.resolution
        pids = self._pixel_ids[t0:t1]
        xy = torch.stack([pids % w, pids // w], dim=-1)
        nes = max(self.take.num_samples_per_pixel, 2)
        rays = torch.zeros((), dtype=torch.int64, device=self.device)
        bounces = 0
        fb_tile = Framebuffer.__new__(Framebuffer)
        fb_tile.rows = self._fb.rows[t0:t1]
        for s in range(n):
            iteration = (self._iteration + s) & MASK
            sample_index = (mul_u32(pids, nes) + iteration) & MASK
            seed = torch.full_like(pids, iteration // nes)
            smp = SobolSampler.start_pixel(sample_index, seed)
            s4 = smp.sample_4d()
            sample_shutter_time(cam_arrays, smp.sample_1d())
            smp.increment_padding()
            o, d = generate_rays(cam_arrays, xy, s4[:, 0:2])
            if integ.kind == "AOV":
                radiance, _, r = aov_mod.integrate(
                    self.scene, o, d, smp,
                    aov_mod.AovSettings(integ.aov_value, integ.aov_num_samples, integ.aov_radius))
            else:  # PT
                radiance, _, r, b = pt_mod.integrate(self.scene, o, d, smp,
                                                     pt_mod.PtSettings(integ.max_depth_surface))
                radiance = sensor_mod.clamp_radiance(radiance, self._clamp_max[1])
                bounces += b
            rays = rays + r
            if self.filter_radius > 0:
                fb_tile.splat_filtered(radiance, pids - t0, s4[:, 0:2], w, h,
                                       self.take.sensor.filter_name, self.filter_radius)
            else:
                fb_tile.add_box(radiance)
        self.rays_traced += int(rays)
        self.last_iterations = bounces
        self.iterations += bounces

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

    def resolve_aov(self, name: str) -> np.ndarray:
        """One resolved AOV plane [H, W, C] (zyg_tpu/render/driver.py:658-672):
        sum-mode planes average over the pixel's samples (normals
        renormalize), min/max planes pass through."""
        w, h = self.camera.resolution
        buf = self._aov[name]
        c, mode = ptmis_mod.AOV_SPECS[name]
        if mode == "sum":
            img = buf / torch.clamp(self._fb.weight[:, None], min=1e-20)
            if name in ("geometric_normal", "shading_normal"):
                ln = torch.sqrt(torch.sum(img * img, dim=-1, keepdim=True))
                img = img / torch.clamp(ln, min=1e-20)
        else:
            img = buf
        return img.cpu().numpy().reshape(h, w, c)

    def resolve_alpha(self) -> np.ndarray | None:
        """[H, W] coverage when alpha_transparency is on, else None."""
        if "alpha" not in self._aov:
            return None
        return np.clip(self.resolve_aov("alpha")[..., 0], 0.0, 1.0)

    def export_frame(self, path: str):
        """Write by extension (zyg_tpu/render/driver.py:711-750): .png
        (tonemapped sRGB8, RGBA when alpha rides), .exr (linear HDR, with
        an A channel when alpha rides) or .hdr (RGBE); every other AOV
        plane goes to a companion <stem>_<name>.exr."""
        ext = os.path.splitext(path)[1].lower()
        if ext not in (".png", ".exr", ".hdr"):
            raise ValueError(f"export to {path!r}: the port writes .png, .exr and .hdr")
        alpha = self.resolve_alpha()
        if ext == ".exr":
            img = self.resolve(tonemapped=False)
            channels = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
            if alpha is not None:
                channels["A"] = alpha
            write_exr(path, channels)
        elif ext == ".hdr":
            write_hdr(path, self.resolve(tonemapped=False))
        else:
            rgb8 = float_to_srgb8(self.resolve(tonemapped=True))
            if alpha is not None:
                a8 = (np.clip(alpha, 0, 1) * 255.0 + 0.5).astype(np.uint8)
                rgb8 = np.concatenate([rgb8, a8[..., None]], axis=-1)
            write_png(path, rgb8)
        stem = os.path.splitext(path)[0]
        for name in self.aov_names:
            if name == "alpha":
                continue
            plane = self.resolve_aov(name)
            if plane.shape[-1] == 3:
                ch = {"R": plane[..., 0], "G": plane[..., 1], "B": plane[..., 2]}
            else:
                ch = {"Y": plane[..., 0]}
            write_exr(f"{stem}_{name}.exr", ch)
