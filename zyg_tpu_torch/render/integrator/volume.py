"""Medium transport (counterpart of zyg_tpu/render/integrator/volume.py):
the nested-dielectric medium stack, distance sampling through the
enclosing medium and the shadow rays' transmittance through the scene's
volume props.

Media are identified by prop id. Each lane carries a fixed-depth stack of
the prop ids enclosing it (int32 [N, 4], -1 empty; ref prop/medium.zig
Stack). The effective medium is the highest-priority entry, ties going to
the newest; an interface against a material is real only when its
priority beats every other entry, otherwise the ray passes through it
(a false interface).

`sample_interaction` samples a scatter event along a segment: the
homogeneous closed form driven by a Sobol' uniform (scatter or pass,
with its weight; a glass interior only absorbs), and for a medium with a
density grid the decomposition-tracking walk of ops/track.py against the
supergrid's local majorants, whose stream is the lane's counter-hash key.
Where a Volumetric material emits (the "vol_emission" feature) it also
returns the emission gathered along the segment: the closed form
e mu_a (1 - exp(-mu_t seg)) / mu_t in a homogeneous medium, the walk's
estimate at an analog absorption in a grid medium.
`transmittance` multiplies, for every volume prop a shadow ray crosses,
the Beer term of a homogeneous prop or the residual-ratio estimate of a
grid prop (ops/track.py, one launch a prop, the key salted by the prop).
A grid lives in the unit cube of its prop's object space (uvw = local +
0.5); the chord through a Cube or a Sphere prop is exact, and a
Volumetric material on a mesh prop is refused at load.

Rounding follows XLA on the CPU as the rest of the port does: a multiply
feeding an add is one fused multiply-add, and a division by a prop's
scale is a division where the prop is gathered per lane (the enclosing
medium) and a multiplication by the reciprocal where it is a folded
constant (a shadow ray's prop).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.fmath import fma, sqrt
from ...core.vecmath import dot
from ...ops import track
from ...scene.types import ShapeType, UnsupportedScene
from .. import materials as mat

MEDIUM_STACK_DEPTH = 4
_PRIO_EMPTY = -1e9


def stack_empty(n: int, device) -> torch.Tensor:
    return torch.full((n, MEDIUM_STACK_DEPTH), -1, dtype=torch.int32, device=device)


def medium_material(scene, medium_prop):
    """Material id of the enclosing medium prop (-1 = vacuum)."""
    m = scene.prop_material[torch.clamp(medium_prop, min=0).long()]
    return torch.where(medium_prop >= 0, m, -1)


def _stack_prio_ior(scene, stack):
    """(priority with the newest-wins tiebreak [N, K], ior [N, K]); empty
    slots get _PRIO_EMPTY."""
    mats = scene.prop_material[torch.clamp(stack, min=0).long()].long()
    prio = scene.materials.priority[mats].to(torch.float32)
    ior = scene.materials.ior[mats]
    k = stack.shape[-1]
    tie = torch.arange(k, dtype=torch.float32, device=stack.device) * (1.0 / (k + 1.0))
    return torch.where(stack >= 0, prio + tie, _PRIO_EMPTY), ior


def _argmax_first(x):
    """Index of the first maximum along the last axis (jnp.argmax's rule)."""
    k = x.shape[-1]
    idx = torch.arange(k, dtype=torch.int64, device=x.device)
    at_max = x == x.amax(dim=-1, keepdim=True)
    return torch.where(at_max, idx, k).amin(dim=-1)


def stack_effective(scene, stack):
    """(eff_prop [N] int32, -1 = vacuum; eff_ior [N]) of the highest-
    priority entry (ref medium.zig topIor / highestPriority)."""
    prio_f, ior = _stack_prio_ior(scene, stack)
    slot = _argmax_first(prio_f)[:, None]
    any_med = prio_f.amax(dim=-1) > _PRIO_EMPTY
    eff_prop = torch.where(any_med, torch.gather(stack, 1, slot)[:, 0], -1)
    eff_ior = torch.where(any_med, torch.gather(ior, 1, slot)[:, 0], 1.0)
    return eff_prop, eff_ior


def stack_info_at_hit(scene, stack, hit_prop):
    """Interface against hit_prop: (ior_excl [N], the effective ior without
    hit_prop's entry; max_prio_excl [N] float32; in_stack [N] bool)."""
    prio_f, ior = _stack_prio_ior(scene, stack)
    same = stack == hit_prop[:, None]
    prio_x = torch.where(same, _PRIO_EMPTY, prio_f)
    slot = _argmax_first(prio_x)[:, None]
    max_p = prio_x.amax(dim=-1)
    ior_excl = torch.where(max_p > _PRIO_EMPTY, torch.gather(ior, 1, slot)[:, 0], 1.0)
    return ior_excl, max_p, same.any(dim=-1)


def stack_update(stack, hit_prop, entering, apply):
    """Push hit_prop on entry, pop it on exit, on the lanes where `apply`.
    A push into a full stack drops silently (the reference's capacity)."""
    popped = torch.where(stack == hit_prop[:, None], -1, stack)
    free = (stack < 0).to(torch.int32)  # argmax takes no bool
    first_free = _argmax_first(free)
    has_free = free.amax(dim=-1) > 0
    k = stack.shape[-1]
    slot_idx = torch.arange(k, dtype=torch.int64, device=stack.device)
    push_here = (slot_idx[None, :] == first_free[:, None]) & has_free[:, None]
    pushed = torch.where(push_here, hit_prop[:, None], stack)
    out = torch.where(entering[:, None], pushed, popped)
    return torch.where(apply[:, None], out, stack)


def absorption_weight(scene, medium_prop, seg_t):
    """Throughput weight over a segment of length seg_t inside the medium
    prop (vacuum: 1): sample_interaction's homogeneous closed form for a
    medium that does not scatter, exp(-mu_t seg) over a pass pdf of 1
    (ref tracking.zig)."""
    mu_t, _, _ = mat.medium_coefficients(scene.materials, medium_material(scene, medium_prop))
    seg = torch.clamp(seg_t, max=3.0e37)
    return torch.exp(-mu_t * seg[:, None])


@dataclass
class VolumeEvent:
    scatter: torch.Tensor  # bool[N] a real scatter event before the surface
    absorb: torch.Tensor  # bool[N] analog absorption (kills the lane; grid media only)
    p: torch.Tensor  # [N, 3] the scatter position
    weight: torch.Tensor  # [N, 3] throughput multiplier (scatter or pass)
    # [N, 3] emission gathered along the segment (ref tracking.zig
    # trackingEmission); None unless a Volumetric material emits
    emission: torch.Tensor = None


def grey_media(scene) -> bool:
    """Every Volumetric medium is grey (mu_t and mu_s equal per channel):
    the tracking weights are exactly 1 and ride as one scalar."""
    return "spectral_media" not in scene.mat_features


def _medium_grid(scene, medium_prop):
    """Density grid id of the enclosing medium (-1: homogeneous or vacuum)."""
    if scene.grids is None:
        return torch.full_like(medium_prop, -1)
    m = torch.clamp(medium_material(scene, medium_prop), min=0).long()
    return torch.where(medium_prop >= 0, scene.materials.density_grid[m], -1)


def _safe(ld, tiny: float):
    return torch.where(torch.abs(ld) < tiny, torch.where(ld < 0, -tiny, tiny), ld)


def _cell_eps(sdims, ld_safe):
    """A step of ~0.1 % of one macrocell in ray t (scale-free)."""
    return 1e-3 * (1.0 / torch.clamp(sdims * torch.abs(ld_safe), min=1e-12)).amin(dim=-1)


def _props(scene):
    return (scene.prop_rot, scene.prop_pos, scene.prop_scale)


def sample_interaction(scene, medium_prop, o, d, seg_t, u_dist, vol_key, vol_depth=None):
    """Distance sampling through the enclosing medium prop over [0, seg_t]
    (zyg_tpu/render/integrator/volume.py:161-461).

    u_dist: the Sobol' uniform of the homogeneous closed form; vol_key:
    int32[N] u32 bits, the grid walk's key; vol_depth: the lanes' volume
    bounce counts for the similarity relation (the phase function's).
    Lanes in vacuum get weight 1 and no event."""
    n = medium_prop.shape[0]
    zeros_b = torch.zeros(n, dtype=torch.bool, device=medium_prop.device)
    if "media" not in scene.mat_features:
        return VolumeEvent(zeros_b, zeros_b, o, torch.ones_like(o))
    med_mat = medium_material(scene, medium_prop)
    mu_t, mu_s, _ = mat.medium_coefficients(scene.materials, med_mat, vol_depth=vol_depth)
    seg = torch.clamp(seg_t, max=3.0e37)
    # emissive media: e is the enclosing Volumetric material's emission
    emissive = "vol_emission" in scene.mat_features
    if emissive:
        e_med = scene.materials.emission[torch.clamp(med_mat, min=0).long()]
        e_med = torch.where((med_mat >= 0)[:, None], e_med, 0.0)
        mu_a = torch.clamp(mu_t - mu_s, min=0.0)

    # ---- homogeneous analog decomposition (closed form, QMC-driven)
    mu_t_bar = track._mean3(mu_t)
    scattering = mu_s.amax(dim=-1) > 0.0
    t_free = -torch.log(torch.clamp(1.0 - u_dist, min=1e-7)) / torch.clamp(mu_t_bar, min=1e-12)
    h_scatter = scattering & (t_free < seg)
    pdf_sc = torch.clamp(mu_t_bar * torch.exp(-mu_t_bar * t_free), min=1e-20)
    w_scatter = torch.exp(-mu_t * t_free[:, None]) * mu_s / pdf_sc[:, None]
    pdf_pass = torch.where(scattering, torch.exp(-mu_t_bar * seg), 1.0)
    w_pass = torch.exp(-mu_t * seg[:, None]) / torch.clamp(pdf_pass, min=1e-20)[:, None]
    h_w = torch.where(h_scatter[:, None], w_scatter, w_pass)
    h_emis = None
    if emissive:
        # the emission source term over the segment in closed form,
        # int_0^seg e mu_a exp(-mu_t s) ds (the scatter sampling estimates
        # only the in-scattering): JAX's operation order, exp and not expm1
        h_emis = (e_med * mu_a * (1.0 - torch.exp(-mu_t * seg[:, None]))
                  / torch.clamp(mu_t, min=1e-12))
    if scene.grids is None:
        return VolumeEvent(h_scatter, zeros_b, fma(t_free[:, None], d, o), h_w, h_emis)

    # ---- heterogeneous: decomposition tracking against the local majorants
    grid = _medium_grid(scene, medium_prop)
    hetero = grid >= 0
    pr = torch.clamp(medium_prop, min=0).long()
    rot, pos, scl = scene.prop_rot[pr], scene.prop_pos[pr], scene.prop_scale[pr]
    lo = track.to_object(rot, scl, o - pos, recip=False)
    ld = track.to_object(rot, scl, d, recip=False)
    ld_safe = _safe(ld, 1e-12)
    inv = 1.0 / ld_safe
    # clamp the walk to the medium prop's exit (visibility flags can hide
    # the boundary from the closest hit)
    t_exit = torch.maximum((-0.5 - lo) * inv, (0.5 - lo) * inv).amin(dim=-1)
    seg = torch.where(hetero, torch.minimum(seg, torch.clamp(t_exit, min=0.0) + 1e-4), seg)
    sdims = scene.grids.sdims[torch.clamp(grid, min=0).long()].to(torch.float32)
    grey = grey_media(scene)
    lanes = {
        "lo": lo, "ld": ld, "inv": inv, "seg": seg,
        "mu_t_max": torch.clamp(mu_t.amax(dim=-1), min=1e-12),
        "grid": grid.to(torch.int32), "eps": _cell_eps(sdims, ld_safe),
        "o": o.contiguous(), "d": d.contiguous(), "mp": medium_prop.to(torch.int32),
        "key": vol_key.to(torch.int32),
    }
    if grey:
        coef = {"mu_t1": mu_t[:, 0].contiguous(), "mu_s1": mu_s[:, 0].contiguous()}
    else:
        coef = {"mu_t": mu_t, "mu_s": mu_s}
    walk = track.track_interaction(scene.grids, _props(scene), lanes, coef, grey,
                                   e_med=e_med.contiguous() if emissive else None)
    t_h, w_h, scat_h, abs_h = walk[:4]
    if grey:
        # analog grey weights are 1 everywhere but the absorption kill
        w_h = torch.where(abs_h, 0.0, 1.0)[:, None]
    t_ev = torch.where(hetero, t_h, t_free)
    return VolumeEvent(
        scatter=torch.where(hetero, scat_h, h_scatter),
        absorb=hetero & abs_h,
        p=fma(t_ev[:, None], d, o),
        weight=torch.where(hetero[:, None], w_h, h_w),
        emission=torch.where(hetero[:, None], walk[4], h_emis) if emissive else None,
    )


def _prop_interval(scene, prop: int, shape: int, o, d, tmax):
    """[t0, t1] of the rays (o, d) inside volume prop `prop`, clipped to
    [0, tmax]: exact for a Sphere (the quadratic) and a Cube (the slabs of
    its object unit cube; other analytic shapes by that bound)."""
    if shape == int(ShapeType.TRIANGLE_MESH):
        raise UnsupportedScene("a Volumetric material on a mesh prop (the chord through a "
                               "mesh interior)")
    rot, pos, scale = scene.prop_rot[prop], scene.prop_pos[prop], scene.prop_scale[prop]
    if shape == int(ShapeType.SPHERE):
        v = pos - o
        b = dot(d, v)
        r = 0.5 * scale[0]
        remedy = fma(-b[:, None], d, v)
        disc = r * r - dot(remedy, remedy)
        dist = sqrt(torch.clamp(disc, min=0.0))
        t0 = torch.where(disc > 0.0, b - dist, 0.0)
        t1 = torch.where(disc > 0.0, b + dist, 0.0)
    else:
        lo = track.to_object(rot, scale, o - pos, recip=True)
        inv = 1.0 / _safe(track.to_object(rot, scale, d, recip=True), 1e-20)
        ta = (-0.5 - lo) * inv
        tb = (0.5 - lo) * inv
        t0 = torch.minimum(ta, tb).amax(dim=-1)
        t1 = torch.maximum(ta, tb).amin(dim=-1)
        t1 = torch.where(t1 >= t0, t1, t0)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.minimum(t1, tmax)
    return t0, torch.maximum(t1, t0)


def _prop_transmittance(scene, prop: int, mat_id: int, grid: int, shape: int, use_grid: bool,
                        o, d, tmax, vol_key):
    """Transmittance [N, 3] through one volume prop."""
    t0, t1 = _prop_interval(scene, prop, shape, o, d, tmax)
    seg = t1 - t0
    mu_t, _, _ = mat.medium_coefficients(
        scene.materials, torch.full((1,), mat_id, dtype=torch.int32, device=o.device))
    inside = seg > 1e-7
    if not use_grid:
        return torch.where(inside[:, None], torch.exp(-mu_t * seg[:, None]), 1.0)
    # residual-ratio tracking (ref tracking.zig:26-78): the cells' minorant
    # in closed form, the residual by ratio tracking against the local
    # residual majorant
    rot, pos, scl = scene.prop_rot[prop], scene.prop_pos[prop], scene.prop_scale[prop]
    ld = track.to_object(rot, scl, d, recip=True)
    ld_safe = _safe(ld, 1e-12)
    sdims = scene.grids.sdims[grid].to(torch.float32)
    grey = grey_media(scene)
    lanes = {
        "lo": track.to_object(rot, scl, o - pos, recip=True), "ld": ld, "inv": 1.0 / ld_safe,
        "t0": t0, "t1": t1, "eps": _cell_eps(sdims, ld_safe), "o": o.contiguous(),
        "d": d.contiguous(), "key": track.salted_key(vol_key, prop), "inside": inside,
    }
    consts = torch.cat([mu_t[0], torch.clamp(mu_t[0].amax(), min=1e-12)[None]])
    trv, tau = track.track_transmittance(scene.grids, _props(scene), prop, grid, consts, lanes,
                                         grey)
    trv3 = trv[:, None] if grey else trv
    return torch.where(inside[:, None], torch.exp(-mu_t * tau[:, None]) * trv3, 1.0)


def transmittance(scene, o, d, tmax, vol_key=None):
    """RGB transmittance [N, 3] through all volume props along shadow rays
    (o, d) of length tmax: 1 where the scene has none. Props are taken as
    the JAX package groups them, by (shape, grid or not), in sorted order;
    vol_key (int32[N] u32 bits) keys the grid props' walks."""
    tr = torch.ones_like(o)
    if not scene.volume_props:
        return tr
    groups: dict = {}
    for prop, mat_id, grid, shape in scene.volume_props:
        use_grid = grid >= 0 and scene.grids is not None
        groups.setdefault((shape, use_grid), []).append((prop, mat_id, grid))
    for (shape, use_grid), plist in sorted(groups.items()):
        for prop, mat_id, grid in sorted(plist):
            tr = tr * _prop_transmittance(scene, prop, mat_id, grid, shape, use_grid, o, d, tmax,
                                          vol_key)
    return tr
