"""3-D density grids of heterogeneous volumes (counterpart of
zyg_tpu/scene/grids.py).

A scene's grids live in one flat voxel arena of SUPER_CELL^3 bricks, with
a coarse halo'd supergrid whose rows (majorant, minorant, free radius,
page) drive the tracking walks (ops/track.py): one row read gives a
macrocell's local bounds, and the free radius lets a walk hop across
empty space. Density inside a walk is one jittered nearest-voxel read
(stochastic trilinear filtering, ref texture_sampler.zig
LinearStochastic).

Addressing is a per-arena choice: when most bricks hold density ("dense"
mode) every brick is kept in grid order and a voxel's page is
brick_base[g] + its cell index; otherwise ("sparse" mode) empty bricks
share pool brick 0 and the page rides column 3 of the supergrid row.

The build is the JAX package's numpy code, so the arrays are equal to
its arena's; the lookups are the JAX formulas in torch, rounded as XLA
rounds them on the CPU (a multiply feeding an add is one fused
multiply-add, core/fmath.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.fmath import fma
from .types import to_device

SUPER_CELL = 8  # voxels per supergrid cell edge and per brick edge
# below this mean brick occupancy the arena drops empty bricks and reads
# each voxel's page from the supergrid row; above it, pages are arithmetic
SPARSE_OCCUPANCY = 0.6


@dataclass
class GridArena:
    """All density grids of a scene, flattened into one arena."""

    data: torch.Tensor  # float32[B * SUPER_CELL^3] brick pool (brick 0 = zeros)
    offset: torch.Tensor  # int32[G] dense offsets (informational)
    dims: torch.Tensor  # int32[G, 3] (nx, ny, nz)
    majorant: torch.Tensor  # float32[G] global max density
    minorant: torch.Tensor  # float32[G] global min density
    sdata: torch.Tensor  # float32[Ts, 4] (majorant, minorant, free radius, page)
    soffset: torch.Tensor  # int32[G] first supergrid row of each grid
    sdims: torch.Tensor  # int32[G, 3] supergrid cells per axis
    brick_base: torch.Tensor  # int32[G] first pool brick of each grid
    sparse: bool  # page-table (sparse) or arithmetic (dense) addressing

    def to(self, device) -> "GridArena":
        return to_device(self, device)


ARRAY_FIELDS = ("data", "offset", "dims", "majorant", "minorant", "sdata", "soffset", "sdims",
                "brick_base")


def _dilate(g: np.ndarray, op) -> np.ndarray:
    """Separable 3^3 min/max filter (edge-replicated): pooling the dilated
    grid equals pooling (SUPER_CELL+2)^3 halo windows."""
    out = g
    for ax in range(3):
        p = np.pad(out, [(1, 1) if a == ax else (0, 0) for a in range(3)], mode="edge")
        n = out.shape[ax]

        def sl(s, ax=ax, n=n):
            return tuple(slice(s, s + n) if a == ax else slice(None) for a in range(3))

        out = op(op(p[sl(0)], p[sl(1)]), p[sl(2)])
    return out


def build_grid_arena(grids: list[np.ndarray]) -> GridArena:
    """Flatten host grids (each float32[nz, ny, nx]) into one arena."""
    offsets, dims = [], []
    sdatas, smins, sfree, spages, soffsets, sdims = [], [], [], [], [], []
    majorants, minorants = [], []
    off = 0
    soff = 0
    # first pass: brick every grid and decide the addressing mode from the
    # total occupancy (dense mode keeps all bricks: the page is arithmetic)
    bricked = []
    for g in grids:
        g = np.asarray(g, np.float32)
        assert g.ndim == 3
        nz, ny, nx = g.shape
        bz, by, bx = (-(-n // SUPER_CELL) for n in (nz, ny, nx))
        gp = np.zeros((bz * SUPER_CELL, by * SUPER_CELL, bx * SUPER_CELL), np.float32)
        gp[:nz, :ny, :nx] = g
        bl = (
            gp.reshape(bz, SUPER_CELL, by, SUPER_CELL, bx, SUPER_CELL)
            .transpose(0, 2, 4, 1, 3, 5)
            .reshape(bz * by * bx, -1)
        )
        bricked.append((g, bl))
    total = sum(bl.shape[0] for _, bl in bricked) or 1
    occ = sum(int((np.abs(bl).max(axis=1) > 0.0).sum()) for _, bl in bricked)
    sparse = occ / total < SPARSE_OCCUPANCY
    bricks = [np.zeros(SUPER_CELL ** 3, np.float32)]  # the pool; 0 = the zero brick
    brick_base = []
    for g, bl in bricked:
        nz, ny, nx = g.shape
        offsets.append(off)
        dims.append((nx, ny, nz))
        majorants.append(float(g.max()))
        minorants.append(float(g.min()))
        off += g.size
        occ_b = np.abs(bl).max(axis=1) > 0.0 if sparse else np.ones(bl.shape[0], bool)
        page = np.zeros(bl.shape[0], np.float32)
        page[occ_b] = np.arange(len(bricks), len(bricks) + int(occ_b.sum()))
        brick_base.append(len(bricks))
        bricks.extend(bl[occ_b])
        spages.append(page)
        # halo'd min/max-pool supergrids, padded to a full cell with each
        # op's identity (pad voxels are never sampled)
        sz, sy, sx = (-(-n // SUPER_CELL) for n in (nz, ny, nx))
        for op, acc, pad in ((np.maximum, sdatas, 0.0), (np.minimum, smins, np.inf)):
            gd = _dilate(g, op)
            sp = np.full((sz * SUPER_CELL, sy * SUPER_CELL, sx * SUPER_CELL), pad, np.float32)
            sp[:nz, :ny, :nx] = gd
            s = op.reduce(
                sp.reshape(sz, SUPER_CELL, sy, SUPER_CELL, sx, SUPER_CELL)
                .transpose(0, 2, 4, 1, 3, 5)
                .reshape(sz, sy, sx, -1),
                axis=-1,
            )
            acc.append(s.reshape(-1))
        # free radius per cell: iterated 3^3 dilation of the occupancy mask
        occ = sdatas[-1].reshape(sz, sy, sx) > 1e-9
        r_free = np.zeros((sz, sy, sx), np.float32)
        reach = occ.copy()
        for r in range(1, 33):
            if reach.all():
                break
            reach_n = _dilate(reach.astype(np.float32), np.maximum) > 0.0
            r_free[~reach_n & ~reach] = r  # still unreachable after r dilations
            r_free[reach_n & ~reach] = r - 1
            reach = reach_n
        sfree.append(r_free.reshape(-1))
        soffsets.append(soff)
        sdims.append((sx, sy, sz))
        soff += sdatas[-1].size
        assert sx * sy * sz == bl.shape[0]  # supergrid cells and bricks share the partition

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    return GridArena(
        data=t(np.concatenate(bricks), torch.float32),
        offset=t(offsets, torch.int32),
        dims=t(dims, torch.int32),
        majorant=t(majorants, torch.float32),
        minorant=t(minorants, torch.float32),
        sdata=t(np.stack([np.concatenate(sdatas), np.concatenate(smins),
                          np.concatenate(sfree), np.concatenate(spages)], axis=-1),
                torch.float32),
        soffset=t(soffsets, torch.int32),
        sdims=t(sdims, torch.int32),
        brick_base=t(brick_base, torch.int32),
        sparse=bool(sparse),
    )


def _voxel_fetch(arena: GridArena, g, idx):
    """Brick-pool read of voxel idx (int64 [N, 3], in range) of grid g
    (int64 [N]): the page through the supergrid row (sparse) or brick_base
    plus the cell index (dense)."""
    sdimsi = arena.sdims[g].long()
    cell = idx // SUPER_CELL
    local = idx - cell * SUPER_CELL
    cellloc = (cell[:, 2] * sdimsi[:, 1] + cell[:, 1]) * sdimsi[:, 0] + cell[:, 0]
    if arena.sparse:
        page = arena.sdata[arena.soffset[g].long() + cellloc, 3].long()
    else:
        page = arena.brick_base[g].long() + cellloc
    flat = page * (SUPER_CELL ** 3) + (local[:, 2] * SUPER_CELL + local[:, 1]) * SUPER_CELL \
        + local[:, 0]
    return arena.data[flat]


def _clip_index(c, dims):
    """clip(c, 0, dims - 1) as int64 (c integral); a NaN index converts to
    0, as XLA's and CUDA's float-to-int conversions do."""
    return torch.minimum(torch.clamp(torch.nan_to_num(c, nan=0.0), min=0.0), dims - 1.0).long()


def sample_density_stochastic(arena: GridArena, grid_id, uvw, r):
    """Unbiased trilinear density by one jittered nearest read: uvw [N, 3]
    in the unit cube, r [N, 3] uniforms. Rounds half to even (jnp.round)."""
    g = torch.clamp(grid_id, min=0).long()
    dims = arena.dims[g].to(torch.float32)
    # cell-centred: c = uvw * n - 0.5, and the jitter r - 0.5
    c = fma(uvw, dims, -0.5) + (r - 0.5)
    return _voxel_fetch(arena, g, _clip_index(torch.round(c), dims))


def sample_density_trilinear(arena: GridArena, grid_id, uvw):
    """Deterministic trilinear density (8 reads)."""
    g = torch.clamp(grid_id, min=0).long()
    dims = arena.dims[g].to(torch.float32)
    c = fma(uvw, dims, -0.5)
    c0 = torch.floor(c)
    f = c - c0
    out = torch.zeros(uvw.shape[:-1], dtype=torch.float32, device=uvw.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = c0 + torch.tensor([dx, dy, dz], dtype=torch.float32, device=uvw.device)
                v = _voxel_fetch(arena, g, _clip_index(corner, dims))
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                out = fma(wx * wy * wz, v, out)
    return out


def _cell_flat(arena: GridArena, grid_id, uvw):
    """Supergrid row of the macrocell holding uvw."""
    g = torch.clamp(grid_id, min=0).long()
    dims = arena.dims[g].to(torch.float32)
    sdimsi = arena.sdims[g].long()
    vox = _clip_index(uvw * dims, dims) // SUPER_CELL
    return arena.soffset[g].long() + (vox[:, 2] * sdimsi[:, 1] + vox[:, 1]) * sdimsi[:, 0] \
        + vox[:, 0]


def local_majorant_free(arena: GridArena, grid_id, uvw):
    """(majorant, free radius) of the macrocell at uvw: one row read."""
    row = arena.sdata[_cell_flat(arena, grid_id, uvw)]
    return row[:, 0], row[:, 2]


def local_extrema(arena: GridArena, grid_id, uvw):
    """(majorant, minorant) of the macrocell at uvw: one row read."""
    row = arena.sdata[_cell_flat(arena, grid_id, uvw)]
    return row[:, 0], row[:, 1]


def make_fbm_grid(n: int = 64, octaves: int = 4, seed: int = 7, sharpness: float = 2.0) -> np.ndarray:
    """Smoke-like fBm density in [0, 1], spherically masked (numpy, the
    JAX package's generator: equal arrays for equal arguments)."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((n, n, n), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cn = max(2, n >> (octaves - 1 - o))
        coarse = rng.standard_normal((cn, cn, cn)).astype(np.float32)
        z = np.linspace(0, cn - 1, n)
        zi = np.clip(z.astype(int), 0, cn - 2)
        zf = (z - zi).astype(np.float32)

        def lerp_axis(a, axis, zi=zi, zf=zf):
            a0 = np.take(a, zi, axis=axis)
            a1 = np.take(a, zi + 1, axis=axis)
            sh = [1, 1, 1]
            sh[axis] = -1
            return a0 + (a1 - a0) * zf.reshape(sh)

        up = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
        acc += amp * up
        total += amp
        amp *= 0.5
    acc = (acc / total - acc.min() / total) / max(1e-6, (acc.max() - acc.min()) / total)
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, n)] * 3), indexing="ij")
    mask = np.clip(1.0 - np.sqrt(xx**2 + yy**2 + zz**2), 0.0, 1.0)
    return np.clip(acc**sharpness * mask * 2.0, 0.0, 1.0).astype(np.float32)


def to_dense(arena: GridArena, gid: int) -> np.ndarray:
    """Host-side dense [nz, ny, nx] copy of grid gid from the brick pool."""
    nx, ny, nz = (int(x) for x in arena.dims[gid].tolist())
    sx, sy, sz = (int(x) for x in arena.sdims[gid].tolist())
    soff = int(arena.soffset[gid])
    pages = arena.sdata[soff: soff + sx * sy * sz, 3].cpu().numpy().astype(np.int64)
    pool = arena.data.cpu().numpy().reshape(-1, SUPER_CELL ** 3)
    gp = (
        pool[pages]
        .reshape(sz, sy, sx, SUPER_CELL, SUPER_CELL, SUPER_CELL)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(sz * SUPER_CELL, sy * SUPER_CELL, sx * SUPER_CELL)
    )
    return gp[:nz, :ny, :nx]
