"""Piecewise-constant 3-D distribution over a density grid (counterpart of
zyg_tpu/core/distribution.py:146-228, Distribution3D; ref
base/math/distribution_3d.zig): the marginal over the grid's slices, each
slice's marginal over its rows and each row's conditional over its
columns, stacked so that one lane's sample is a chain of gathers. Volume
lights sample their interior points by it (scene/light_sampling.py).

Zero totals fall back to uniform at that level and every CDF ends exactly
at 1.0: a CDF that never reached 1 would map a uniform past its last cell.
The tables are float32 cumulative sums on the host (torch), so they may
round an ulp apart from the JAX package's (XLA's summation order).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene.types import to_device

_OFFSET_MAX = 1.0 - 1e-6  # in-cell offsets stay in [0, 1)


def _cdf(w: torch.Tensor) -> torch.Tensor:
    """Leading 0, cumulative sums over the last axis over their total, the
    last entry exactly 1."""
    c = torch.cumsum(w, dim=-1) / w.sum(dim=-1, keepdim=True)
    c = torch.cat([torch.zeros(w.shape[:-1] + (1,), dtype=torch.float32), c], dim=-1)
    c[..., -1] = 1.0
    return c


def _count_le(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Entries of each row of cdf [N, K] at or below u [N]: the
    right-sided search of u on a sorted row."""
    return (cdf <= u[:, None]).sum(dim=-1)


@dataclass
class Distribution3D:
    slice_cdf: torch.Tensor  # float32[D + 1] marginal over the slices
    row_cdf: torch.Tensor  # float32[D, H + 1] marginal over each slice's rows
    col_cdf: torch.Tensor  # float32[D, H, W + 1] conditional over each row's columns
    pdf_grid: torch.Tensor  # float32[D, H, W] density over the unit cube (integrates to 1)

    @staticmethod
    def build(grid) -> "Distribution3D":
        """grid: [D, H, W] weights (negative ones count as 0), on the CPU."""
        g = torch.clamp(torch.as_tensor(np.asarray(grid, np.float32)), min=0.0)
        d, h, w = g.shape
        slice_sum = g.sum(dim=(1, 2))
        total = slice_sum.sum()
        slice_cdf = _cdf(torch.where(total > 0.0, slice_sum, 1.0))
        row_sum = g.sum(dim=2)
        row_tot = row_sum.sum(dim=1, keepdim=True)
        row_cdf = _cdf(torch.where(row_tot > 0.0, row_sum, 1.0))
        col_cdf = _cdf(torch.where(row_sum[..., None] > 0.0, g, 1.0))
        pdf = g / torch.clamp(total, min=1e-20) * float(d * h * w)
        return Distribution3D(slice_cdf, row_cdf, col_cdf, pdf)

    def to(self, device) -> "Distribution3D":
        return to_device(self, device)

    def sample_continuous(self, uvw):
        """uvw [N, 3] uniforms -> (xyz [N, 3] in [0, 1)^3, pdf [N])."""
        u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
        d, h, wd = self.pdf_grid.shape
        k = torch.clamp(torch.searchsorted(self.slice_cdf, w.contiguous(), right=True) - 1,
                        0, d - 1)
        rc = self.row_cdf[k]
        j = torch.clamp(_count_le(rc, v) - 1, 0, h - 1)
        cc = self.col_cdf[k, j]
        i = torch.clamp(_count_le(cc, u) - 1, 0, wd - 1)

        def offset(x, lo, hi):
            return torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, _OFFSET_MAX)

        fz = offset(w, self.slice_cdf[k], self.slice_cdf[k + 1])
        jc, ic = j[:, None], i[:, None]
        fy = offset(v, rc.gather(1, jc)[:, 0], rc.gather(1, jc + 1)[:, 0])
        fx = offset(u, cc.gather(1, ic)[:, 0], cc.gather(1, ic + 1)[:, 0])
        xyz = torch.stack([(i + fx) / wd, (j + fy) / h, (k + fz) / d], dim=-1)
        return xyz, self.pdf_grid[k, j, i]

    def pdf(self, xyz):
        """The density at unit-cube points xyz [N, 3]."""
        d, h, w = self.pdf_grid.shape
        i = torch.clamp((xyz[:, 0] * w).to(torch.int64), 0, w - 1)
        j = torch.clamp((xyz[:, 1] * h).to(torch.int64), 0, h - 1)
        k = torch.clamp((xyz[:, 2] * d).to(torch.int64), 0, d - 1)
        return self.pdf_grid[k, j, i]
