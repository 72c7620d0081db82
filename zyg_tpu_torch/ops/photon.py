"""The photon-map gather (counterpart of the XLA loop
zyg_tpu/render/integrator/photon.py:219-271 `gather`; not a TPU kernel in
the JAX package). Kernel: csrc/photon.cu.

The cone-filtered density estimate at each lane's shading point: the 8
hash cells (edge 2r) a radius-r sphere can touch, in the JAX order with a
repeated cell skipped; at most min(max_per_cell, MAX_PER_CELL) photons of
each cell's bucket, in bucket order; a photon within r on the front of the
shading normal adds k * power * f / max(cos, 1e-5) with k = (1 - d^2/r^2)^2
and f * cos the BSDF toward the photon's incoming direction; each cell's
part summed from zero, the lane's sum times 1 / (pi/3 * paths * r^2).

`photon_gather` runs the plain version for CPU tensors and the kernel for
CUDA tensors (it raises on anything the kernel cannot take: the kernel
evaluates the substitute BSDF only, so a material set with rough glass is
refused). The plain version is the JAX loop in torch, through
render/materials.py::eval_bsdf: it evaluates only the steps whose bucket
still holds a photon (the JAX loop adds 0 at the others), in one batch,
then sums them in the JAX order. Arithmetic as XLA rounds it on the CPU: dot products and
1 - d^2 * (1/r^2) fused (core/fmath.py), the division by the cosine an
IEEE division. The kernel's BSDF rounds as the fused kernels' do
(csrc/shade_core.cuh), a few ulps from the plain version's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import check_cuda, register, stream_handle
from ..core.fmath import fma
from ..core.vecmath import dot

TABLE_BITS = 18  # 2^18 hash buckets
TABLE_SIZE = 1 << TABLE_BITS
MAX_PER_CELL = 64  # the bound on a bucket's scan

_GATHER = register(
    "photon_gather",
    "zyg_photon_gather",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
)

# the kernel's lane inputs, in its pointer order, with their trailing shape
LANE_FIELDS = (("pos", (3,)), ("wo", (3,)), ("n", (3,)), ("geo_n", (3,)), ("active", ()),
               ("albedo", (3,)), ("f0", (3,)), ("alpha", ()), ("metallic", ()),
               ("specular", ()))
_FIT = {}  # device -> the GGX energy-fit table


def cell_hash(ix, iy, iz):
    """The bucket of integer cell coordinates (int32 tensors, negative ones
    too): the uint32 products wrap, so the low TABLE_BITS bits of the
    int64 products are the JAX hash's."""
    h = (ix.long() * 73856093) ^ (iy.long() * 19349663) ^ (iz.long() * 83492791)
    return (h & (TABLE_SIZE - 1)).to(torch.int32)


def scalars(radius: float, num_paths: int) -> tuple:
    """(radius, 1 / 2r, r^2, 1 / r^2, norm) as float32 values: the JAX
    gather's Python doubles as XLA rounds them (norm = 1 / (pi/3 * paths *
    r^2) in double precision, then float32)."""
    r2 = radius * radius
    vals = (radius, 1.0 / (2.0 * radius), r2, 1.0 / r2, 1.0 / ((math.pi / 3.0) * num_paths * r2))
    return tuple(float(np.float32(v)) for v in vals)


def _cells(pos, radius: float, inv_cell: float):
    """The 8 cells of each lane: [(dup bool[N], bucket int32[N])] in the
    JAX order."""
    lo = torch.floor((pos - radius) * inv_cell).to(torch.int32)
    hi = torch.floor((pos + radius) * inv_cell).to(torch.int32)
    same = hi == lo
    out = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = [hi[:, a] if dd else lo[:, a] for a, dd in enumerate((dx, dy, dz))]
                dup = ((dx > 0) & same[:, 0]) | ((dy > 0) & same[:, 1]) | ((dz > 0) & same[:, 2])
                out.append((dup, cell_hash(*c)))
    return out


def _pairs(cell_start, pos, active, radius: float, max_per_cell: int):
    """The bucket entries the active lanes scan, as (lane index [P], cell
    slot [P], step [P], photon row [P]) with the lanes that scan any
    (lanes [L], li [P] their index) and the most steps a cell takes."""
    rad, inv_cell = scalars(radius, 1)[:2]
    cap = min(int(max_per_cell), MAX_PER_CELL)
    cells = _cells(pos, rad, inv_cell)
    start = torch.stack([cell_start[h.long()] for _, h in cells], dim=1)  # [N, 8]
    cnt = torch.stack([cell_start[h.long() + 1] for _, h in cells], dim=1) - start
    dup = torch.stack([d for d, _ in cells], dim=1)
    cnt = torch.where(active[:, None] & ~dup, torch.clamp(cnt, max=cap), 0)
    lanes = torch.nonzero(cnt.amax(dim=1) > 0).squeeze(1)
    kmax = int(cnt.max()) if cnt.numel() else 0
    steps = torch.arange(kmax, device=pos.device)
    li, ci, ki = torch.nonzero(steps[None, None, :] < cnt[lanes][:, :, None], as_tuple=True)
    lane = lanes[li]
    return lanes, li, ci, ki, lane, (start[lane, ci] + ki).long(), kmax


def _in_range(ph_p, ph_wi, pos, n, lane, j, r2: float):
    """(d^2, cos, the visits that contribute: d^2 < r^2 on the front)."""
    dp = ph_p[j] - pos[lane]
    d2 = dot(dp, dp)
    cosw = dot(n[lane], ph_wi[j])
    return d2, cosw, (d2 < r2) & (cosw > 0.0)


def _rows(params: dict, idx) -> dict:
    return {k: (v[idx] if isinstance(v, torch.Tensor) else v) for k, v in params.items()}


def photon_gather_plain(ph_p, ph_wi, ph_power, cell_start, params, pos, wo, n, geo_n, active,
                        radius: float, num_paths: int, max_per_cell: int):
    """The JAX gather in torch: [N, 3] radiance at the lanes' points pos
    (wo toward the viewer, n the shading and geo_n the geometric normal,
    params the general body's material rows). Every (lane, cell, step)
    whose bucket holds a photon is evaluated in one batch; the sums then
    run in the JAX order, step by step from zero within a cell, cell by
    cell into the lane's total."""
    from ..render.materials import eval_bsdf

    _, _, r2, inv_r2, norm = scalars(radius, num_paths)
    lanes, li, ci, ki, lane, j, kmax = _pairs(cell_start, pos, active, radius, max_per_cell)
    d2, cosw, ok = _in_range(ph_p, ph_wi, pos, n, lane, j, r2)
    kc = torch.square(fma(-d2, inv_r2, 1.0))
    f_cos, _ = eval_bsdf(_rows(params, lane), wo[lane], ph_wi[j], n[lane], geo_n[lane])
    f = f_cos / torch.clamp(cosw, min=1e-5)[:, None]
    contrib = torch.where(ok[:, None], kc[:, None] * ph_power[j] * f, 0.0)
    dense = torch.zeros((lanes.shape[0], 8, kmax, 3), dtype=torch.float32, device=pos.device)
    dense[li, ci, ki] = contrib
    total = torch.zeros((lanes.shape[0], 3), dtype=torch.float32, device=pos.device)
    for c in range(8):
        part = torch.zeros_like(total)
        for k in range(kmax):
            part = part + dense[:, c, k]
        total = total + part
    result = torch.zeros_like(pos)
    result[lanes] = total
    return result * norm


def _fit(device):
    from ..render.materials import fit_table

    if device not in _FIT:
        _FIT[device] = fit_table(device)
    return _FIT[device]


def photon_gather(ph_p, ph_wi, ph_power, cell_start, params, pos, wo, n, geo_n, active,
                  radius: float, num_paths: int, max_per_cell: int):
    """The gather (see photon_gather_plain): the plain version for CPU
    tensors, the kernel for CUDA tensors. Active lanes hold Substitute
    materials (the general body gathers where can_evaluate holds, and
    refuses rough glass under a photon map)."""
    if pos.device.type == "cpu":
        return photon_gather_plain(ph_p, ph_wi, ph_power, cell_start, params, pos, wo, n, geo_n,
                                   active, radius, num_paths, max_per_cell)
    dev = pos.device
    if set(params["features"]) & {"rough_glass"}:
        raise ValueError("photon_gather: the kernel evaluates the substitute BSDF only "
                         "(rough glass under a photon map)")
    nl = pos.shape[0]
    m = ph_p.shape[0]
    lanes = {"pos": pos, "wo": wo, "n": n, "geo_n": geo_n, "active": active, **params}
    ptrs = [_fit(dev).data_ptr()]
    for k, tail in LANE_FIELDS:
        dtype = torch.bool if k == "active" else torch.float32
        check_cuda(f"photon_gather.{k}", lanes[k], dtype, dev, (nl, *tail))
        ptrs.append(lanes[k].data_ptr())
    for k, x in (("p", ph_p), ("wi", ph_wi), ("power", ph_power)):
        check_cuda(f"photon_gather.{k}", x, torch.float32, dev, (m, 3))
        ptrs.append(x.data_ptr())
    check_cuda("photon_gather.cell_start", cell_start, torch.int32, dev, (TABLE_SIZE + 1,))
    ptrs.append(cell_start.data_ptr())
    out = torch.empty((nl, 3), dtype=torch.float32, device=dev)
    ptrs.append(out.data_ptr())
    if nl > 0:
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        scal = (ctypes.c_float * 5)(*scalars(radius, num_paths))
        _GATHER(arr, scal, min(int(max_per_cell), MAX_PER_CELL), nl, stream_handle(dev))
    return out
