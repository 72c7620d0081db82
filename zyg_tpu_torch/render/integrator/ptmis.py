"""Wavefront PTMIS on the persistent wavefront (counterpart of
zyg_tpu/render/integrator/ptmis.py:31-123, :326-346 and :1049-1540, box
filter, shuffled lanes; the fused Cornell-class bounce, the mesh bounce or
the general bounce for textured and env-lit scenes).

ref: src/core/rendering/integrator/surface/pathtracer_mis.zig. Radiance is
tracked as the reference's IValue triple {emission, direct, indirect} so
the sensor can clamp each class separately. The JAX `lax.while_loop`
becomes a host loop of launches, and the JAX column buffer with its
unpermute becomes one per-pixel flush a step (ops/accum.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ...core.rng import MASK, hash_u32, mul_u32, to_i32, u32
from ...core.sobol import SobolArrays, SobolSampler
from ...ops import traverse
from ...ops.accum import flush_pixels
from ...ops.shade import make_fused_body, structural_ok
from ...ops.surface import make_mesh_fused_body, structural_ok_mesh
from ...ops.surface_v2 import make_mesh_fused_body_v2, structural_ok_mesh_v2
from ..camera import generate_rays, sample_shutter_time


@dataclass(frozen=True)
class PtmisSettings:
    max_depth: int = 16
    caustics: bool = True
    nee_only: bool = False  # PTDL mode: no MIS weight on BSDF light hits


@dataclass
class IValue:
    emission: torch.Tensor  # [N, 3]
    direct: torch.Tensor  # [N, 3]
    indirect: torch.Tensor  # [N, 3]

    @staticmethod
    def zeros(n: int, device) -> "IValue":
        z = torch.zeros((n, 3), dtype=torch.float32, device=device)
        return IValue(z, z.clone(), z.clone())


@dataclass
class PathState:
    """Per-lane path state of the slice (the JAX PathState without media,
    split, AOV and motion fields)."""

    o: torch.Tensor  # [N, 3]
    d: torch.Tensor  # [N, 3]
    throughput: torch.Tensor  # [N, 3]
    result: IValue  # the current sample's radiance sums
    alive: torch.Tensor  # bool[N]
    bxdf_pdf: torch.Tensor  # [N] pdf of the previous BSDF sample
    singular: torch.Tensor  # bool[N] previous bounce was a delta event
    depth: torch.Tensor  # int32[N] surface bounce depth
    rays: torch.Tensor  # int64 scalar: rays traced so far
    sobol: SobolArrays
    vol_key: torch.Tensor  # int32[N] u32 bits: the lane's non-Sobol' key
    # (texture jitter), seeded per sample and hashed once per bounce
    mis_o: torch.Tensor  # [N, 3] origin of the last real scatter vertex
    mis_n: torch.Tensor  # [N, 3] shading normal at the last real vertex
    pid: torch.Tensor  # int64[N] local pixel index of the lane's current sample

    def fields(self) -> dict:
        """The lane fields the fused bounce reads."""
        return {
            "o": self.o, "d": self.d, "throughput": self.throughput, "alive": self.alive,
            "bxdf_pdf": self.bxdf_pdf, "singular": self.singular, "depth": self.depth,
            "mis_o": self.mis_o, "mis_n": self.mis_n, "emission": self.result.emission,
            "direct": self.result.direct, "indirect": self.result.indirect,
        }

    def merged(self, r: dict, sobol: SobolArrays) -> "PathState":
        """The state after a fused bounce returned `r`."""
        return PathState(
            o=r["o"], d=r["d"], throughput=r["throughput"],
            result=IValue(r["emission"], r["direct"], r["indirect"]),
            alive=r["alive"], bxdf_pdf=r["bxdf_pdf"],
            singular=torch.zeros_like(self.singular),  # substitute samples are never delta
            depth=r["depth"], rays=self.rays + r["rays"], sobol=sobol,
            vol_key=to_i32(hash_u32(u32(self.vol_key) ^ 0x27D4EB2F)),
            mis_o=r["mis_o"], mis_n=r["mis_n"], pid=self.pid,
        )

    def index(self, idx: torch.Tensor) -> "PathState":
        """The lanes `idx` of this state (drain compaction)."""
        return PathState(
            o=self.o[idx], d=self.d[idx], throughput=self.throughput[idx],
            result=IValue(self.result.emission[idx], self.result.direct[idx],
                          self.result.indirect[idx]),
            alive=self.alive[idx], bxdf_pdf=self.bxdf_pdf[idx], singular=self.singular[idx],
            depth=self.depth[idx], rays=self.rays, sobol=self.sobol.index(idx),
            vol_key=self.vol_key[idx], mis_o=self.mis_o[idx], mis_n=self.mis_n[idx], pid=self.pid[idx],
        )


def _make_body(scene, settings: PtmisSettings):
    """One wavefront bounce (ptmis.py:326-346): the fused bounce for
    Cornell-class analytic scenes, the mesh bounce for untextured mesh
    scenes under rectangle lights, the general bounce for the rest."""
    if structural_ok(scene):
        return make_fused_body(scene, settings)
    if structural_ok_mesh(scene):
        return make_mesh_fused_body(scene, settings)
    if structural_ok_mesh_v2(scene):
        return make_mesh_fused_body_v2(scene, settings)
    raise ValueError("scene is outside the fused, mesh and general bounces")


# smallest wavefront-drain stage width (tests lower it to exercise the
# cascade at tiny dispatch sizes)
_DRAIN_MIN = 1 << 13


def _coprime_stride(n: int) -> int:
    """Golden-ratio stride coprime with n: the lane->pixel shuffle
    (lane + iteration*stride) mod n is a bijection per iteration."""
    if n <= 2:
        return 1
    s = max(1, int(0.6180339887498949 * n))
    while math.gcd(s, n) != 1:
        s += 1
    return s


def _check_every(device: torch.device) -> int:
    """Loop-condition polls: every iteration on the CPU; every 4th on a
    card, so the host keeps launching ahead instead of waiting on each
    read. Extra iterations past the exit change nothing: regeneration is
    masked by issued < target and flushes need a lane that was alive."""
    return 1 if device.type == "cpu" else 4


def integrate_persistent(
    scene,
    cam_arrays,
    pixel_ids: torch.Tensor,
    first_iteration: int,
    num_samples: int,
    num_expected_samples: int,
    settings: PtmisSettings,
    clamp_max=(math.inf, math.inf, math.inf),
    frame_width: int = 0,
    oversample_slack: int = 0,
):
    """Render `num_samples` samples/pixel with lane regeneration AND
    per-sample lane->pixel shuffling (see the JAX docstring for the design:
    work balancing by the coprime-stride shuffle, work stealing by the
    oversample slack and the drain cascade). Finished samples go straight
    to their pixels' rows of one [N, 4] framebuffer (RGB + sample count).

    CONTRACT: pixel_ids (int64[N]) is a contiguous ascending range; the
    pixel of lane i's sample k is pixel_ids[0] + (i + k*stride) mod N, and
    frame_width recovers its x/y.

    Returns (radiance[N, 3] summed over samples by pixel, rays (int64
    scalar tensor), loop iterations, per-pixel sample counts[N])."""
    if frame_width <= 0:
        raise ValueError("integrate_persistent: the port renders shuffled dispatches only")
    dev = pixel_ids.device
    n = pixel_ids.shape[0]
    body = _make_body(scene, settings)
    stride = _coprime_stride(n)
    base = int(pixel_ids[0])
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    f32 = torch.float32
    zero3 = torch.zeros((n, 3), dtype=f32, device=dev)
    z_up = torch.zeros((n, 3), dtype=f32, device=dev)
    z_up[:, 2] = 1.0
    path = PathState(
        o=zero3, d=z_up, throughput=zero3, result=IValue.zeros(n, dev),
        alive=torch.zeros(n, dtype=torch.bool, device=dev),
        bxdf_pdf=torch.zeros(n, dtype=f32, device=dev),
        singular=torch.ones(n, dtype=torch.bool, device=dev),
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        sobol=SobolSampler.start_pixel(pixel_ids, torch.zeros_like(pixel_ids)).arrays,
        vol_key=to_i32(hash_u32(pixel_ids ^ 0x2545F491)),
        mis_o=zero3, mis_n=z_up, pid=lanes,
    )
    kmax = num_samples + oversample_slack
    target = n * num_samples
    fb = torch.zeros((n, 4), dtype=f32, device=dev)  # by local pixel: RGB, sample count
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    issued = torch.zeros((), dtype=torch.int64, device=dev)
    check_every = _check_every(dev)

    def flush(s: PathState, was_alive: torch.Tensor) -> None:
        # samples that finished since was_alive, each clamped once
        r = s.result
        flush_pixels(fb, s.pid, was_alive, s.alive, r.emission, r.direct, r.indirect, clamp_max)

    # drain cascade: once issuance ends and fewer than n/4 paths are in
    # flight, compact the survivors into a 4x smaller state and go on there
    drain_stages = []
    wd = n
    while wd // 4 >= _DRAIN_MIN:
        wd //= 4
        drain_stages.append(wd)

    def step(s: PathState, done, issued):
        # regenerate finished lanes with the NEXT sample, shuffled onto
        # pixel (lane + iteration*stride) mod n
        regen = (~s.alive) & (done < kmax) & (issued < target)
        iteration = (first_iteration + done).to(torch.int64) & MASK
        pid_new = ((lanes + mul_u32(iteration, stride)) & MASK) % n
        gpid = base + pid_new
        xy_new = torch.stack([gpid % frame_width, gpid // frame_width], dim=-1)
        sample_index = (mul_u32(gpid, num_expected_samples) + iteration) & MASK
        seed = iteration // num_expected_samples
        fresh = SobolSampler.start_pixel(sample_index, seed).arrays
        # camera block: consumed uniformly by every lane every iteration
        smp = SobolSampler(fresh.where(regen, s.sobol), dim=5)
        s4 = smp.sample_4d()
        sample_shutter_time(cam_arrays, smp.sample_1d())
        smp.increment_padding()
        o_cam, d_cam = generate_rays(cam_arrays, xy_new, s4[:, 0:2])

        rm = regen[:, None]
        s = PathState(
            o=torch.where(rm, o_cam, s.o),
            d=torch.where(rm, d_cam, s.d),
            throughput=torch.where(rm, 1.0, s.throughput),
            result=IValue(*(torch.where(rm, 0.0, c) for c in
                            (s.result.emission, s.result.direct, s.result.indirect))),
            alive=s.alive | regen,
            bxdf_pdf=torch.where(regen, 0.0, s.bxdf_pdf),
            singular=s.singular | regen,
            depth=torch.where(regen, 0, s.depth),
            rays=s.rays,
            sobol=smp.arrays,
            vol_key=torch.where(regen, to_i32(hash_u32(sample_index ^ 0x2545F491)), s.vol_key),
            mis_o=torch.where(rm, o_cam, s.mis_o),
            mis_n=torch.where(rm, d_cam, s.mis_n),
            pid=torch.where(regen, pid_new, s.pid),
        )
        done = done + regen.to(torch.int32)
        was_alive = s.alive
        s = body(s)
        flush(s, was_alive)
        return s, done, issued + regen.sum()

    def cond(s: PathState, done, issued) -> torch.Tensor:
        can_start = (issued < target) & torch.any(done < kmax)
        if drain_stages:
            return can_start | (s.alive.sum() > drain_stages[0])
        return torch.any(s.alive) | can_start

    iters = 0
    while True:
        if iters % check_every == 0 and not bool(cond(path, done, issued)):
            break
        path, done, issued = step(path, done, issued)
        iters += 1

    width_cur = n
    for si, wd in enumerate(drain_stages):
        live = torch.nonzero(path.alive).squeeze(1)
        m = live.shape[0]
        idx = torch.full((wd,), width_cur - 1, dtype=torch.int64, device=dev)
        idx[:m] = live[:wd]
        valid = torch.arange(wd, device=dev) < m
        path = path.index(idx)
        path.alive = path.alive & valid
        nxt = drain_stages[si + 1] if si + 1 < len(drain_stages) else 0
        it = 0
        while it < 65536:
            if it % check_every == 0 and not bool(path.alive.sum() > nxt):
                break
            # replay the full-width step's camera block exactly: it advances
            # every lane's run seed even when nothing regenerates
            smp = SobolSampler(path.sobol, dim=5)
            smp.sample_4d()
            smp.sample_1d()
            smp.increment_padding()
            path.sobol = smp.arrays
            path = body(path)
            it += 1
        iters += it
        # each drained lane finishes at most its one sample in the stage
        flush(path, valid)
        width_cur = wd

    if scene.meshes is not None and dev.type == "cuda":
        traverse.check_errors(dev)  # the walks' stack-overflow flag
    return fb[:, 0:3], path.rays, iters, fb[:, 3]
