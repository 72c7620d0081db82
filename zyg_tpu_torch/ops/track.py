"""The tracking walks through density grids (counterpart of the two
`lax.while_loop`s of zyg_tpu/render/integrator/volume.py: decomposition
tracking in `sample_interaction`, :273-382, and residual-ratio tracking
in `_prop_transmittance`, :631-701). Kernel: csrc/track.cu.

Both walk a ray through the supergrid of scene/grids.py one step at a
time. A step reads the macrocell's row (local majorant, minorant, free
radius), draws a free flight against the local majorant from a counter
hash of the lane's key, and either hops to the cell's wall (through the
empty cells around it when its majorant is zero) or reads the density at
the tentative collision by one jittered voxel read. `track_interaction`
then classifies the collision as a scatter, an absorption or a null
event (grey media: analog, weight 1; spectral media: max-blended
probabilities with the null and scatter weights). In an emissive medium
it also returns the emission collected at an analog absorption (ref
tracking.zig trackingEmission; zyg_tpu/render/integrator/volume.py:345-370):
the medium's emission e on grey media, w * mu_a(x) / (mu_maj * pa) * e
with the weight from before the kill on spectral ones. `track_transmittance`
multiplies the ratio of the residual density over the residual majorant
and integrates the cell minorant in closed form (tau). The key is
re-hashed after every step. A walk stops when it leaves its segment,
scatters, is absorbed, its ratio falls below 1e-5, or after 16,384 steps
(insurance against a NaN ray).

The JAX package's compaction cascade (`_TRACK_MIN`) only relocates
lanes, so it is not ported: the kernel walks each lane to its end in
its own thread, and the plain version steps the lanes that are not done.

Arithmetic is the JAX formulas, rounded as XLA rounds them on the CPU:
`lo + t * ld`, `o + t * d` and the transforms' dot products are fused
multiply-adds (core/fmath.py; fmaf in the kernel), and the JAX package's
round is round-half-even (torch.round; rintf in the kernel).
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..core.fmath import fma
from ..core.rng import hash2_u32, hash_u32, to_i32, u32, u32_to_float
from ..core.vecmath import dot
from ..scene.grids import GridArena, _cell_flat, local_majorant_free, sample_density_stochastic

MAX_STEPS = 16384  # the walks' step cap

_INTERACTION = register(
    "track_interaction",
    "zyg_track_interaction",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
)
_TRANSMITTANCE = register(
    "track_transmittance",
    "zyg_track_transmittance",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
     ctypes.c_void_p],
)

# the per-lane inputs of each walk, in the kernels' pointer order
INTERACTION_LANES = ("lo", "ld", "inv", "seg", "mu_t_max", "grid", "eps", "o", "d", "mp", "key")
TRANSMITTANCE_LANES = ("lo", "ld", "inv", "t0", "t1", "eps", "o", "d", "key", "inside")


def to_object(rot, scale, v, recip: bool):
    """World vectors v in a prop's object space, (v . rot[0], v . rot[1],
    v . rot[2]) / scale (rot [N, 3, 3] or [3, 3], scale [N, 3] or [3]).
    recip: divide by the scale as a multiplication by its reciprocal,
    XLA's rounding where the prop is a folded constant (a shadow walk's
    prop), instead of a division (a lane's enclosing prop, gathered per
    lane)."""
    local = torch.stack([dot(v, rot[..., 0, :]), dot(v, rot[..., 1, :]),
                         dot(v, rot[..., 2, :])], dim=-1)
    return local * (1.0 / scale) if recip else local / scale


def object_uvw(rot, scale, pos, p, recip: bool):
    """Unit-cube coordinates of world points p in a prop (to_object)."""
    return torch.clamp(to_object(rot, scale, p - pos, recip) + 0.5, 0.0, 1.0)


def _jitter(rbits):
    """Three voxel-jitter uniforms from one hash: 11, 11 and 10 bits."""
    return torch.stack([
        (rbits & 0x7FF).to(torch.float32) * (1.0 / 2048.0),
        ((rbits >> 11) & 0x7FF).to(torch.float32) * (1.0 / 2048.0),
        (rbits >> 22).to(torch.float32) * (1.0 / 1024.0),
    ], dim=-1)


def _cell_exit(t, skip_r, lo, ld, inv, sdims, eps):
    """Ray t at which the current macrocell, grown by skip_r empty cells on
    every side, is left; cell walls live in unit-cube object space."""
    p_l = fma(t[:, None], ld, lo)
    cell = torch.floor(torch.minimum(torch.clamp((p_l + 0.5) * sdims, min=0.0), sdims - 1.0))
    r = skip_r[:, None]
    wall_cell = torch.where(ld > 0.0, cell + r + 1.0, cell - r)
    wall = wall_cell / torch.clamp(sdims, min=1.0) - 0.5
    t_ax = (wall - p_l) * inv
    return t + torch.clamp(t_ax.amin(dim=-1), min=0.0) + eps


def _mean3(x):
    """jnp.mean over a last axis of 3: the sum in order, then / 3. The 3 is
    a tensor on x's device: torch divides a CUDA tensor by a Python scalar
    as a multiplication by its reciprocal, the kernel (and the CPU)
    divide."""
    return (x[:, 0] + x[:, 1] + x[:, 2]) / torch.tensor(3.0, device=x.device)


def _flight(t, u1, mu):
    """t plus an exponential free flight against the majorant mu."""
    return t - torch.log(torch.clamp(1.0 - u1, min=1e-7)) / torch.clamp(mu, min=1e-12)


def _count(stats, live, collide):
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + int(live.numel())
        stats["collisions"] = stats.get("collisions", 0) + int(collide.sum())
        stats["iterations"] = stats.get("iterations", 0) + 1


def track_interaction_plain(arena: GridArena, props, lanes: dict, coef: dict, grey: bool,
                            stats: dict | None = None, e_med=None):
    """Plain torch version of the decomposition-tracking walk: each step
    runs on the lanes that are not done. props: (prop_rot, prop_pos,
    prop_scale) of the scene; lanes: INTERACTION_LANES (grid < 0: a lane
    that does not walk); coef: mu_t1, mu_s1 [N] (grey) or mu_t, mu_s
    [N, 3]. Returns (t, w ([N] grey, [N, 3] spectral), scatter, absorb),
    and with e_med ([N, 3], the emission of each lane's medium) a fifth
    result, the emission [N, 3] collected at an absorption (0 elsewhere).
    stats (a dict, optional) gains the lane-steps walked ("steps"), the
    tentative collisions among them ("collisions") and the steps of the
    longest walk ("iterations")."""
    rot_t, pos_t, scale_t = props
    grid = lanes["grid"]
    n = grid.shape[0]
    dev = grid.device
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    w = torch.ones((n,) if grey else (n, 3), dtype=torch.float32, device=dev)
    scat = torch.zeros(n, dtype=torch.bool, device=dev)
    absb = torch.zeros(n, dtype=torch.bool, device=dev)
    emis = None if e_med is None else torch.zeros((n, 3), dtype=torch.float32, device=dev)
    key = u32(lanes["key"])
    live = torch.nonzero(grid >= 0).squeeze(1)
    it = 0
    while live.numel() > 0 and it < MAX_STEPS:
        L = {k: lanes[k][live] for k in INTERACTION_LANES}
        g = L["grid"]
        sdims = arena.sdims[g.long()].to(torch.float32)
        tl, kl = t[live], key[live]
        u1 = u32_to_float(hash2_u32(kl, 0))
        u2 = u32_to_float(hash2_u32(kl, 1))
        r3 = _jitter(hash2_u32(kl, 2))
        p_cur = fma(tl[:, None], L["ld"], L["lo"])
        maj, free_r = local_majorant_free(arena, g, torch.clamp(p_cur + 0.5, 0.0, 1.0))
        mu_loc = maj * L["mu_t_max"]
        empty = mu_loc <= 1e-9
        t_cell = _cell_exit(tl, torch.where(empty, free_r, 0.0), L["lo"], L["ld"], L["inv"],
                            sdims, L["eps"])
        t_cand = _flight(tl, u1, mu_loc)
        crossed = empty | (t_cand > t_cell)
        t_new = torch.where(crossed, t_cell, t_cand)
        exited = t_new >= L["seg"]
        collide = ~exited & ~crossed
        _count(stats, live, collide)
        mp = L["mp"].long()
        uvw = object_uvw(rot_t[mp], scale_t[mp], pos_t[mp], fma(t_new[:, None], L["d"], L["o"]),
                         recip=False)
        dens = sample_density_stochastic(arena, g, uvw, r3)
        mu_s = torch.clamp(mu_loc, min=1e-12)
        if grey:
            ms1, mt1 = coef["mu_s1"][live], coef["mu_t1"][live]
            ps = dens * ms1 / mu_s
            pa = dens * (mt1 - ms1) / mu_s
            scat_now = collide & (u2 < ps)
            abs_now = collide & ~scat_now & (u2 < ps + pa)
            if emis is not None:
                emis[live] = torch.where(abs_now[:, None], e_med[live], emis[live])
        else:
            mt, ms = coef["mu_t"][live], coef["mu_s"][live]
            mu_t_x = dens[:, None] * mt
            mu_s_x = dens[:, None] * ms
            mu_a_x = mu_t_x - mu_s_x
            ps = _mean3(mu_s_x) / mu_s
            pa = _mean3(mu_a_x) / mu_s
            pn = torch.clamp(1.0 - ps - pa, min=1e-7)
            scat_now = collide & (u2 < ps)
            abs_now = collide & ~scat_now & (u2 < ps + pa)
            w_scat = mu_s_x / torch.clamp(mu_s * ps, min=1e-20)[:, None]
            w_null = (mu_s[:, None] - mu_t_x) / (mu_s * pn)[:, None]
            wl = w[live]
            if emis is not None:
                # the weight from before the kill
                w_abs = mu_a_x / torch.clamp(mu_s * pa, min=1e-20)[:, None]
                emis[live] = torch.where(abs_now[:, None], wl * w_abs * e_med[live], emis[live])
            wl = torch.where(scat_now[:, None], wl * w_scat,
                             torch.where(abs_now[:, None], 0.0,
                                         torch.where(collide[:, None], wl * w_null, wl)))
            w[live] = wl
        scat[live] = scat[live] | scat_now
        absb[live] = absb[live] | abs_now
        t[live] = torch.minimum(t_new, L["seg"])
        key[live] = hash_u32(kl ^ 0x9E3779B9)
        live = live[~(exited | scat_now | abs_now)]
        it += 1
    return (t, w, scat, absb) if emis is None else (t, w, scat, absb, emis)


def track_transmittance_plain(arena: GridArena, props, prop: int, grid: int, consts,
                              lanes: dict, grey: bool, stats: dict | None = None):
    """Plain torch version of the residual-ratio walk through one grid
    prop: each step runs on the lanes that are not done. consts: float32
    [4] (mu_t [3] of the prop's medium, its max); lanes:
    TRANSMITTANCE_LANES (inside: bool, the lanes whose chord through the
    prop is longer than 1e-7). Returns (trv ([N] grey, [N, 3] spectral),
    tau [N]); stats as track_interaction_plain's."""
    rot_t, pos_t, scale_t = props
    t0 = lanes["t0"]
    n = t0.shape[0]
    dev = t0.device
    gi = torch.full((1,), grid, dtype=torch.int64, device=dev)
    sdims = arena.sdims[gi].to(torch.float32)
    mu_t, mu_t_max = consts[:3], consts[3]
    t = t0.clone()
    trv = torch.ones((n,) if grey else (n, 3), dtype=torch.float32, device=dev)
    tau = torch.zeros(n, dtype=torch.float32, device=dev)
    key = u32(lanes["key"])
    live = torch.nonzero(lanes["inside"]).squeeze(1)
    it = 0
    while live.numel() > 0 and it < MAX_STEPS:
        L = {k: lanes[k][live] for k in TRANSMITTANCE_LANES}
        m = live.shape[0]
        g = gi.expand(m)
        tl, kl = t[live], key[live]
        u1 = u32_to_float(hash2_u32(kl, 0))
        r3 = _jitter(hash2_u32(kl, 1))
        p_cur = fma(tl[:, None], L["ld"], L["lo"])
        row = arena.sdata[_cell_flat(arena, g, torch.clamp(p_cur + 0.5, 0.0, 1.0))]
        maj, mn = row[:, 0], row[:, 1]
        # the residual majorant against the cell's own minorant
        mu_r = torch.clamp(maj - mn, min=0.0) * mu_t_max
        # empty-space skip only through cells whose majorant is zero
        t_cell = _cell_exit(tl, torch.where(maj <= 1e-9, row[:, 2], 0.0), L["lo"], L["ld"],
                            L["inv"], sdims.expand(m, 3), L["eps"])
        t_cand = _flight(tl, u1, mu_r)
        crossed = (mu_r <= 1e-9) | (t_cand > t_cell)
        t_new = torch.minimum(torch.where(crossed, t_cell, t_cand), L["t1"])
        exited = t_new >= L["t1"]
        collide = ~exited & ~crossed
        _count(stats, live, collide)
        uvw = object_uvw(rot_t[prop], scale_t[prop], pos_t[prop],
                         fma(t_new[:, None], L["d"], L["o"]), recip=True)
        dens = sample_density_stochastic(arena, g, uvw, r3)
        mu_rs = torch.clamp(mu_r, min=1e-12)
        if grey:
            ratio = torch.clamp(1.0 - torch.clamp(dens - mn, min=0.0) * mu_t[0] / mu_rs, 0.0, 1.0)
            tr = torch.where(collide, trv[live] * ratio, trv[live])
            tr_max = tr
        else:
            res = torch.clamp(dens - mn, min=0.0)[:, None] * mu_t
            ratio = torch.clamp(1.0 - res / mu_rs[:, None], 0.0, 1.0)
            tr = torch.where(collide[:, None], trv[live] * ratio, trv[live])
            tr_max = tr.amax(dim=-1)
        trv[live] = tr
        # the minorant's optical depth over the span walked in this cell
        tau[live] = tau[live] + mn * (t_new - tl)
        t[live] = t_new
        key[live] = hash_u32(kl ^ 0x85EBCA6B)
        live = live[~(exited | (tr_max < 1e-5))]
        it += 1
    return trv, tau


def _lane_ptrs(lanes: dict, names, n: int, dev, kind: str) -> list:
    """Check the lane tensors a kernel reads and return their pointers."""
    ptrs = []
    for k in names:
        x = lanes[k]
        if k in ("grid", "mp", "key"):
            dtype, shape = torch.int32, (n,)
        elif k == "inside":
            dtype, shape = torch.bool, (n,)
        elif k in ("lo", "ld", "inv", "o", "d"):
            dtype, shape = torch.float32, (n, 3)
        else:
            dtype, shape = torch.float32, (n,)
        check_cuda(f"{kind}.{k}", x, dtype, dev, shape)
        ptrs.append(x.data_ptr())
    return ptrs


def _arena_ptrs(arena: GridArena, props, dev, kind: str) -> list:
    rot_t, pos_t, scale_t = props
    p = rot_t.shape[0]
    check_cuda(f"{kind}.prop_rot", rot_t, torch.float32, dev, (p, 3, 3))
    check_cuda(f"{kind}.prop_pos", pos_t, torch.float32, dev, (p, 3))
    check_cuda(f"{kind}.prop_scale", scale_t, torch.float32, dev, (p, 3))
    g = arena.dims.shape[0]
    check_cuda(f"{kind}.data", arena.data, torch.float32, dev)
    check_cuda(f"{kind}.dims", arena.dims, torch.int32, dev, (g, 3))
    check_cuda(f"{kind}.sdata", arena.sdata, torch.float32, dev)
    if arena.sdata.data_ptr() % 16:
        raise ValueError(f"{kind}: the supergrid rows must be 16-byte aligned (float4 reads)")
    check_cuda(f"{kind}.soffset", arena.soffset, torch.int32, dev, (g,))
    check_cuda(f"{kind}.sdims", arena.sdims, torch.int32, dev, (g, 3))
    check_cuda(f"{kind}.brick_base", arena.brick_base, torch.int32, dev, (g,))
    return [arena.data.data_ptr(), arena.dims.data_ptr(), arena.sdata.data_ptr(),
            arena.soffset.data_ptr(), arena.sdims.data_ptr(), arena.brick_base.data_ptr(),
            rot_t.data_ptr(), pos_t.data_ptr(), scale_t.data_ptr()]


def track_interaction(arena: GridArena, props, lanes: dict, coef: dict, grey: bool, e_med=None):
    """The decomposition-tracking walk (see track_interaction_plain for
    the arguments and results): the plain version for CPU tensors, the
    kernel for CUDA tensors (its emissive variant where e_med is given)."""
    grid = lanes["grid"]
    if grid.device.type == "cpu":
        return track_interaction_plain(arena, props, lanes, coef, grey, e_med=e_med)
    dev = grid.device
    n = grid.shape[0]
    ptrs = _arena_ptrs(arena, props, dev, "track_interaction")
    ptrs += _lane_ptrs(lanes, INTERACTION_LANES, n, dev, "track_interaction")
    for k in (("mu_t1", "mu_s1") if grey else ("mu_t", "mu_s")):
        check_cuda(f"track_interaction.{k}", coef[k], torch.float32, dev,
                   (n,) if grey else (n, 3))
        ptrs.append(coef[k].data_ptr())
    t = torch.empty(n, dtype=torch.float32, device=dev)
    w = torch.empty((n,) if grey else (n, 3), dtype=torch.float32, device=dev)
    scat = torch.empty(n, dtype=torch.bool, device=dev)
    absb = torch.empty(n, dtype=torch.bool, device=dev)
    ptrs += [t.data_ptr(), w.data_ptr(), scat.data_ptr(), absb.data_ptr()]
    emis = None
    if e_med is not None:
        check_cuda("track_interaction.e_med", e_med, torch.float32, dev, (n, 3))
        emis = torch.empty((n, 3), dtype=torch.float32, device=dev)
        ptrs += [e_med.data_ptr(), emis.data_ptr()]
    else:
        ptrs += [None, None]
    if n > 0:
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        _INTERACTION(arr, int(grey), int(arena.sparse), int(emis is not None), n,
                     stream_handle(dev))
    return (t, w, scat, absb) if emis is None else (t, w, scat, absb, emis)


def track_transmittance(arena: GridArena, props, prop: int, grid: int, consts, lanes: dict,
                        grey: bool):
    """The residual-ratio walk through one grid prop (see
    track_transmittance_plain): the plain version for CPU tensors, one
    kernel launch for CUDA tensors."""
    t0 = lanes["t0"]
    if t0.device.type == "cpu":
        return track_transmittance_plain(arena, props, prop, grid, consts, lanes, grey)
    dev = t0.device
    n = t0.shape[0]
    if not (0 <= prop < props[0].shape[0] and 0 <= grid < arena.dims.shape[0]):
        raise ValueError(f"track_transmittance: prop {prop} / grid {grid} out of range")
    ptrs = _arena_ptrs(arena, props, dev, "track_transmittance")
    ptrs += _lane_ptrs(lanes, TRANSMITTANCE_LANES, n, dev, "track_transmittance")
    check_cuda("track_transmittance.consts", consts, torch.float32, dev, (4,))
    ptrs.append(consts.data_ptr())
    trv = torch.empty((n,) if grey else (n, 3), dtype=torch.float32, device=dev)
    tau = torch.empty(n, dtype=torch.float32, device=dev)
    ptrs += [trv.data_ptr(), tau.data_ptr()]
    if n > 0:
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        _TRANSMITTANCE(arr, int(grey), int(arena.sparse), prop, grid, n, stream_handle(dev))
    return trv, tau


def salted_key(vol_key: torch.Tensor, prop: int) -> torch.Tensor:
    """A shadow walk's key through prop: vol_key ^ (prop * 0x6C078965 + 1)
    as int32 bits (the JAX package's per-prop stream salt)."""
    salt = (prop * 0x6C078965 + 1) & 0xFFFFFFFF
    return to_i32(u32(vol_key) ^ salt)
