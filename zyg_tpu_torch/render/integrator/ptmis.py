"""Wavefront PTMIS on the persistent wavefront (counterpart of
zyg_tpu/render/integrator/ptmis.py:31-280, :326-352 and :1049-1540: box
or Blackman/Mitchell filter, shuffled lanes, or unshuffled with sensor
AOVs; the fused Cornell-class bounce, the mesh bounce, kernel 6's bounce
for textured and env-lit scenes, or the general body for glass, media and
AOVs (render/integrator/ptmis_general.py), with its medium stack and
BSDF-split resume slot).

ref: src/core/rendering/integrator/surface/pathtracer_mis.zig. Radiance is
tracked as the reference's IValue triple {emission, direct, indirect} so
the sensor can clamp each class separately. The JAX `lax.while_loop`
becomes a host loop of launches, and the JAX column buffer with its
unpermute (and, filtered, its rolled footprint taps) becomes one
per-pixel flush a step (ops/accum.py: flush_pixels, flush_filtered).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch

from ...core.rng import MASK, hash_u32, mul_u32, to_i32, u32
from ...core.sobol import SobolArrays, SobolSampler
from ...ops import traverse
from ...ops.accum import flush_filtered, flush_pixels
from ...ops.shade import make_fused_body, structural_ok
from ...ops.surface import make_mesh_fused_body, structural_ok_mesh
from ...ops.surface_v2 import make_mesh_fused_body_v2, structural_ok_mesh_v2
from ...scene.types import RAY_MAX_T, UnsupportedScene
from ..camera import generate_rays, sample_shutter_time
from . import volume as vol_mod


@dataclass(frozen=True)
class PtmisSettings:
    max_depth: int = 16
    max_depth_volume: int = 256  # null-interface crossings + volume scatters
    caustics: bool = True
    nee_only: bool = False  # PTDL mode: no MIS weight on BSDF light hits
    # BSDF path splitting (ref vertex.zig Pool + glass_sample.zig split): a
    # glass vertex traces both fresnel branches, the untaken one parked in
    # a one-deep resume slot that the lane continues when its path ends
    bsdf_split: bool = False
    # sensor AOV classes (keys of AOV_SPECS) collected at the primary hit
    # by the general body; () collects none
    collect_aovs: tuple = ()


# sensor AOV classes (ref aov_value.zig Class): name -> (channels,
# accumulation mode). "sum" resolves to the mean over samples, "min"/"max"
# keep extrema (depth and ids must not be averaged). The first seven are
# captured at the primary hit, the IValue classes at the sample's flush.
AOV_SPECS = {
    "albedo": (3, "sum"),
    "depth": (1, "min"),
    "material_id": (1, "max"),
    "geometric_normal": (3, "sum"),
    "shading_normal": (3, "sum"),
    "roughness": (1, "sum"),
    "alpha": (1, "sum"),  # coverage for the Transparent sensor buffer
    "emission": (3, "sum"),
    "direct": (3, "sum"),
    "indirect": (3, "sum"),
}


def aov_init(names, n: int, device) -> dict:
    """Fresh pixel-indexed accumulators [n, channels] of the AOV classes."""
    out = {}
    for name in names:
        c, mode = AOV_SPECS[name]
        fill = {"sum": 0.0, "min": float(RAY_MAX_T), "max": -1.0}[mode]
        out[name] = torch.full((n, c), fill, dtype=torch.float32, device=device)
    return out


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
    """Per-lane path state (the JAX PathState without the AOV, motion and
    spectral fields). The fields from `medium` on are the general body's:
    None, and the split slot empty, on the kernel bounces' states."""

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
    # the general body's fields (None elsewhere)
    medium: torch.Tensor = None  # int32[N, 4] stack of enclosing medium prop ids, -1 empty
    vol_depth: torch.Tensor = None  # int32[N] null-interface crossings (ref probe.zig Depth)
    from_volume: torch.Tensor = None  # bool[N] last real vertex was a volume scatter
    primary_chain: torch.Tensor = None  # bool[N] every bounce so far was singular
    nee_thr: torch.Tensor = None  # float32[N] NEE split threshold of the last real vertex
    reg_alpha: torch.Tensor = None  # float32[N] alpha of the previously sampled lobe
    # the BSDF-split resume slot (_split_init's keys; {} = splitting off)
    split: dict = field(default_factory=dict)
    # sensor AOV accumulators by PIXEL (aov_init; {} = none), added to in
    # place; only unshuffled dispatches carry them, where pixel = lane
    aov: dict = field(default_factory=dict)
    # float32[N, 2] the current sample's subpixel offset (filtered dispatches)
    sub_uv: torch.Tensor = None

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
        return dataclasses.replace(
            self, o=r["o"], d=r["d"], throughput=r["throughput"],
            result=IValue(r["emission"], r["direct"], r["indirect"]),
            alive=r["alive"], bxdf_pdf=r["bxdf_pdf"],
            singular=torch.zeros_like(self.singular),  # substitute samples are never delta
            depth=r["depth"], rays=self.rays + r["rays"], sobol=sobol,
            vol_key=to_i32(hash_u32(u32(self.vol_key) ^ 0x27D4EB2F)),
            mis_o=r["mis_o"], mis_n=r["mis_n"],
        )

    def index(self, idx: torch.Tensor) -> "PathState":
        """The lanes `idx` of this state (drain compaction)."""
        def g(x):
            return None if x is None else x[idx]

        return PathState(
            o=self.o[idx], d=self.d[idx], throughput=self.throughput[idx],
            result=IValue(self.result.emission[idx], self.result.direct[idx],
                          self.result.indirect[idx]),
            alive=self.alive[idx], bxdf_pdf=self.bxdf_pdf[idx], singular=self.singular[idx],
            depth=self.depth[idx], rays=self.rays, sobol=self.sobol.index(idx),
            vol_key=self.vol_key[idx], mis_o=self.mis_o[idx], mis_n=self.mis_n[idx], pid=self.pid[idx],
            medium=g(self.medium), vol_depth=g(self.vol_depth), from_volume=g(self.from_volume),
            primary_chain=g(self.primary_chain), nee_thr=g(self.nee_thr),
            reg_alpha=g(self.reg_alpha), split={k: v[idx] for k, v in self.split.items()},
            aov=self.aov, sub_uv=g(self.sub_uv),
        )


def _split_init(n: int, device) -> dict:
    """An empty one-deep BSDF-split resume slot (ref vertex.zig Pool)."""
    f32 = torch.float32
    z3 = torch.zeros((n, 3), dtype=f32, device=device)
    z1 = torch.zeros((n,), dtype=f32, device=device)
    z_up = z3.clone()
    z_up[:, 2] = 1.0
    zi = torch.zeros((n,), dtype=torch.int32, device=device)
    zb = torch.zeros((n,), dtype=torch.bool, device=device)
    return {
        "pending": zb,
        # the lane's current split weight (ref vertex.zig split_weight): it
        # scales contributions, never throughput, so roulette never sees it
        "w": torch.ones((n,), dtype=f32, device=device),
        "w1": torch.ones((n,), dtype=f32, device=device),  # the parked branch's
        "o": z3, "d": z_up, "thr": z3.clone(), "pdf": z1, "singular": zb.clone(),
        "medium": vol_mod.stack_empty(n, device), "depth": zi, "vol_depth": zi.clone(),
        "mis_n": z_up.clone(), "primary": zb.clone(), "nee_thr": z1.clone(),
        "reg_alpha": z1.clone(),
        "vol_key": zi.clone(),  # u32 bits as int32, as PathState.vol_key
        "run_seed": zi.clone(),  # the parked branch's Sobol' run seed (int32 bits)
    }


def split_enabled(scene, settings: PtmisSettings) -> bool:
    """BSDF splitting runs only for scenes with glass (ptmis.py:208)."""
    return bool(settings.bsdf_split) and "glass" in scene.mat_features


def split_pending(s: PathState) -> torch.Tensor:
    """bool[N]: lanes holding an untraced BSDF-split branch."""
    return s.split["pending"] if s.split else torch.zeros_like(s.alive)


def resume_split(s: PathState) -> PathState:
    """Revive dead lanes whose resume slot holds the untaken fresnel branch:
    restore its restart state, keep the sample's result and pid (the branch
    belongs to the same sample) and swap in the branch's Sobol' run seed."""
    sp = s.split
    if not sp:
        return s
    res = (~s.alive) & sp["pending"]
    rm = res[:, None]
    a = s.sobol
    return dataclasses.replace(
        s,
        o=torch.where(rm, sp["o"], s.o),
        d=torch.where(rm, sp["d"], s.d),
        throughput=torch.where(rm, sp["thr"], s.throughput),
        alive=s.alive | res,
        bxdf_pdf=torch.where(res, sp["pdf"], s.bxdf_pdf),
        singular=torch.where(res, sp["singular"], s.singular),
        medium=torch.where(rm, sp["medium"], s.medium),
        depth=torch.where(res, sp["depth"], s.depth),
        vol_depth=torch.where(res, sp["vol_depth"], s.vol_depth),
        sobol=SobolArrays(a.sample, a.start_seed, torch.where(res, sp["run_seed"], a.run_seed),
                          a.buffer),
        vol_key=torch.where(res, sp["vol_key"], s.vol_key),
        mis_o=torch.where(rm, sp["o"], s.mis_o),
        mis_n=torch.where(rm, sp["mis_n"], s.mis_n),
        from_volume=s.from_volume & ~res,
        primary_chain=torch.where(res, sp["primary"], s.primary_chain),
        nee_thr=torch.where(res, sp["nee_thr"], s.nee_thr),
        reg_alpha=torch.where(res, sp["reg_alpha"], s.reg_alpha),
        split={**sp, "pending": sp["pending"] & ~res, "w": torch.where(res, sp["w1"], sp["w"])},
    )


def unfinished(s: PathState) -> torch.Tensor:
    """bool[N]: lanes whose sample goes on, alive or holding a parked split
    branch (a lane whose path ended with a branch parked is not finished)."""
    return s.alive | split_pending(s) if s.split else s.alive


# the flush's mask of unfinished lanes (a test swaps it for one that
# ignores the split slot, to show the pixel counts then go wrong)
_flush_unfinished = unfinished


def power_heuristic(f_pdf, g_pdf):
    f2 = f_pdf * f_pdf
    return f2 / torch.clamp(g_pdf * g_pdf + f2, min=1e-20)


def predivided_power_heuristic(f_pdf, g_pdf):
    f2 = f_pdf * f_pdf
    return f_pdf / torch.clamp(g_pdf * g_pdf + f2, min=1e-20)


def _make_body(scene, settings: PtmisSettings):
    """One wavefront bounce (ptmis.py:326-352): the fused bounce for
    Cornell-class analytic scenes, the mesh bounce for untextured mesh
    scenes under rectangle lights, kernel 6's bounce for textured and
    env-lit scenes, and the general body for the rest (glass, media) and
    for every dispatch that collects sensor AOVs (the JAX gates refuse AOVs
    for kernels 3, 5 and 6: zyg_tpu/ops/shade.py:692, :1142, :1521); a
    scene outside all four raises UnsupportedScene naming what it lacks."""
    if settings.collect_aovs:
        from .ptmis_general import GeneralBody

        check_scene(scene, settings)
        return GeneralBody(scene, settings)
    if structural_ok(scene):
        return make_fused_body(scene, settings)
    if structural_ok_mesh(scene):
        return make_mesh_fused_body(scene, settings)
    if structural_ok_mesh_v2(scene):
        return make_mesh_fused_body_v2(scene, settings)
    from .ptmis_general import GeneralBody

    return GeneralBody(scene, settings)


def check_scene(scene, settings: PtmisSettings) -> None:
    """Raise UnsupportedScene where no bounce renders the scene: the
    dispatch's refusals, before a render starts. Sensor AOVs ride the
    general body only."""
    from .ptmis_general import check_general

    if settings.collect_aovs:
        try:
            check_general(scene, settings)
        except UnsupportedScene as e:
            raise UnsupportedScene(f"sensor AOVs {list(settings.collect_aovs)} ride the general "
                                   f"body, which refuses {e}") from None
        return
    if structural_ok(scene) or structural_ok_mesh(scene) or structural_ok_mesh_v2(scene):
        return
    check_general(scene, settings)


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
    filter_name: str = "Blackman",
    filter_radius: int = 0,
    resolution: tuple = (0, 0),
):
    """Render `num_samples` samples/pixel with lane regeneration and, with
    frame_width > 0, per-sample lane->pixel shuffling (see the JAX
    docstring for the design: work balancing by the coprime-stride
    shuffle, work stealing by the oversample slack and the drain cascade).
    Finished samples go straight to their pixels' rows of one [N, 4]
    framebuffer (RGB + sample count, or + filter weight with a filter of
    radius 1 or 2: each finished sample then splats its (2r+1)^2 footprint
    at the subpixel offset the lane carries, taps outside the frame or the
    dispatch dropped with their weights).

    frame_width == 0 is the unshuffled dispatch (sensor AOVs ride it):
    lane i renders pixel pixel_ids[0] + i, every pixel exactly num_samples
    samples, with no slack and no drain stages; the AOV classes of
    settings.collect_aovs accumulate by pixel.

    CONTRACT: pixel_ids (int64[N]) is a contiguous ascending range; the
    pixel of lane i's sample k is pixel_ids[0] + (i + k*stride) mod N, and
    the frame width (frame_width, or resolution[0] when unshuffled)
    recovers its x/y.

    Returns (radiance[N, 3] summed over samples by pixel, rays (int64
    scalar tensor), loop iterations, per-pixel sample counts (filter
    weights when filtered) [N], the AOV accumulators {name: [N, c]})."""
    shuffled = frame_width > 0
    width = frame_width if shuffled else int(resolution[0])
    if width <= 0:
        raise ValueError("integrate_persistent: an unshuffled dispatch needs the resolution")
    filtering = filter_radius > 0
    if filtering and (resolution[0] <= 0 or resolution[1] <= 0):
        raise ValueError("integrate_persistent: a filtered dispatch needs the resolution")
    if settings.collect_aovs and shuffled:
        raise ValueError("integrate_persistent: sensor AOVs accumulate by lane; they ride "
                         "unshuffled dispatches (frame_width 0)")
    dev = pixel_ids.device
    n = pixel_ids.shape[0]
    body = _make_body(scene, settings)
    general = getattr(body, "general", False)  # carries the medium stack and split slot
    stride = _coprime_stride(n) if shuffled else 0
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
        aov=aov_init(settings.collect_aovs, n, dev),
        sub_uv=torch.zeros((n, 2), dtype=f32, device=dev) if filtering else None,
    )
    if general:
        zb = torch.zeros(n, dtype=torch.bool, device=dev)
        path = dataclasses.replace(
            path, medium=vol_mod.stack_empty(n, dev),
            vol_depth=torch.zeros(n, dtype=torch.int32, device=dev), from_volume=zb,
            primary_chain=torch.ones(n, dtype=torch.bool, device=dev),
            nee_thr=torch.zeros(n, dtype=f32, device=dev),
            reg_alpha=torch.zeros(n, dtype=f32, device=dev),
            split=_split_init(n, dev) if body.split_on else {},
        )
    kmax = num_samples + (oversample_slack if shuffled else 0)
    target = n * num_samples
    fb = torch.zeros((n, 4), dtype=f32, device=dev)  # by local pixel: RGB, sample count
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    issued = torch.zeros((), dtype=torch.int64, device=dev)
    check_every = _check_every(dev)
    # the IValue classes a finished sample adds to the AOV planes, unclamped
    ivalue_aovs = [k for k in ("emission", "direct", "indirect") if k in path.aov]

    inflight = unfinished

    def flush(s: PathState, was_alive: torch.Tensor) -> None:
        # samples that finished since was_alive, each clamped once
        r = s.result
        alive = _flush_unfinished(s)
        if filtering:
            flush_filtered(fb, s.pid, was_alive, alive, (r.emission, r.direct, r.indirect),
                           clamp_max, s.sub_uv, int(resolution[0]), int(resolution[1]),
                           filter_name, filter_radius, base=base)
        else:
            flush_pixels(fb, s.pid, was_alive, alive, r.emission, r.direct, r.indirect,
                         clamp_max)
        if ivalue_aovs:
            fin = (was_alive & ~alive)[:, None]
            for k in ivalue_aovs:
                s.aov[k] += torch.where(fin, getattr(r, k), 0.0)

    # drain cascade: once issuance ends and fewer than n/4 paths are in
    # flight, compact the survivors into a 4x smaller state and go on there
    # (shuffled dispatches only: AOV accumulators are indexed by lane)
    drain_stages = []
    wd = n
    while shuffled and wd // 4 >= _DRAIN_MIN:
        wd //= 4
        drain_stages.append(wd)

    def step(s: PathState, done, issued):
        # dead lanes with a parked split branch resume it first (the same
        # sample: no flush between its branches)
        s = resume_split(s)
        # regenerate finished lanes with the NEXT sample, shuffled onto
        # pixel (lane + iteration*stride) mod n
        regen = (~s.alive) & (done < kmax) & (issued < target)
        iteration = (first_iteration + done).to(torch.int64) & MASK
        pid_new = ((lanes + mul_u32(iteration, stride)) & MASK) % n
        gpid = base + pid_new
        xy_new = torch.stack([gpid % width, gpid // width], dim=-1)
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
        s = dataclasses.replace(
            s,
            o=torch.where(rm, o_cam, s.o),
            d=torch.where(rm, d_cam, s.d),
            throughput=torch.where(rm, 1.0, s.throughput),
            result=IValue(*(torch.where(rm, 0.0, c) for c in
                            (s.result.emission, s.result.direct, s.result.indirect))),
            alive=s.alive | regen,
            bxdf_pdf=torch.where(regen, 0.0, s.bxdf_pdf),
            singular=s.singular | regen,
            depth=torch.where(regen, 0, s.depth),
            sobol=smp.arrays,
            vol_key=torch.where(regen, to_i32(hash_u32(sample_index ^ 0x2545F491)), s.vol_key),
            mis_o=torch.where(rm, o_cam, s.mis_o),
            mis_n=torch.where(rm, d_cam, s.mis_n),
            pid=torch.where(regen, pid_new, s.pid),
            sub_uv=torch.where(rm, s4[:, 0:2], s.sub_uv) if filtering else None,
        )
        if general:
            # resume slots are empty on regenerating lanes; the lane's split
            # weight restarts at 1
            s = dataclasses.replace(
                s, medium=torch.where(rm, -1, s.medium),
                vol_depth=torch.where(regen, 0, s.vol_depth),
                from_volume=s.from_volume & ~regen, primary_chain=s.primary_chain | regen,
                nee_thr=torch.where(regen, 0.0, s.nee_thr),
                reg_alpha=torch.where(regen, 0.0, s.reg_alpha),
                split={**s.split, "w": torch.where(regen, 1.0, s.split["w"])} if s.split else {},
            )
        done = done + regen.to(torch.int32)
        was_alive = s.alive
        s = body(s)
        flush(s, was_alive)
        return s, done, issued + regen.sum()

    def cond(s: PathState, done, issued) -> torch.Tensor:
        can_start = (issued < target) & torch.any(done < kmax)
        if drain_stages:
            return can_start | (inflight(s).sum() > drain_stages[0])
        return torch.any(inflight(s)) | can_start

    iters = 0
    while True:
        if iters % check_every == 0 and not bool(cond(path, done, issued)):
            break
        path, done, issued = step(path, done, issued)
        iters += 1

    width_cur = n
    for si, wd in enumerate(drain_stages):
        live = torch.nonzero(inflight(path)).squeeze(1)
        m = live.shape[0]
        idx = torch.full((wd,), width_cur - 1, dtype=torch.int64, device=dev)
        idx[:m] = live[:wd]
        valid = torch.arange(wd, device=dev) < m
        path = path.index(idx)
        path.alive = path.alive & valid
        if path.split:
            path.split["pending"] = path.split["pending"] & valid
        nxt = drain_stages[si + 1] if si + 1 < len(drain_stages) else 0
        it = 0
        while it < 65536:
            if it % check_every == 0 and not bool(inflight(path).sum() > nxt):
                break
            path = resume_split(path)
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
    return fb[:, 0:3], path.rays, iters, fb[:, 3], path.aov
