"""The nested-dielectric medium stack and homogeneous transport through a
glass interior (counterpart of zyg_tpu/render/integrator/volume.py:44
`medium_material`, :58-123 the stack helpers, :161-220 the homogeneous
closed form of `sample_interaction`, :535-550 `transmittance` without
volume props).

Media are identified by prop id. Each lane carries a fixed-depth stack of
the prop ids enclosing it (int32 [N, 4], -1 empty; ref prop/medium.zig
Stack). The effective medium is the highest-priority entry, ties going to
the newest; an interface against a material is real only when its
priority beats every other entry, otherwise the ray passes through it
(a false interface).

The port loads glass and no Volumetric material, so a medium absorbs and
never scatters or emits: `sample_interaction` reduces to the Beer weight
exp(-mu_t seg) and `transmittance` to 1 (shadow rays are blocked by
glass, not attenuated).
"""

from __future__ import annotations

import torch

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


def transmittance(scene, o, d, tmax):
    """Shadow-ray transmittance through the scene's volume props: 1 on every
    lane, since the port loads none (SceneData.volume_props is empty)."""
    if scene.volume_props:
        raise ValueError("volume props: shadow transmittance through media is not ported")
    return torch.ones_like(o)
