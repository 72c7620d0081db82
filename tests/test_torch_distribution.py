"""The port's Distribution3D (zyg_tpu_torch/core/distribution.py) against
the JAX package's (zyg_tpu/core/distribution.py:146-228) on fire.scene's
64^3 fbm grid (seed 5, sharpness 2.2) and on a 5x6x7 grid with a zero
slice, a zero row and a zero column in every slice.

Tolerances:
- the tables (slice, row and column CDFs, the pdf grid) within 8 ulp
  (measured 7 on the column CDFs of the fbm grid): both are float32
  cumulative sums over their totals, and torch and XLA sum in different
  orders; every CDF starts at 0, ends at exactly 1 and does not decrease
  before its last entry (the sum before it may round up to 1.0000002, in
  both packages), and the pdf grid integrates to 1 within 1e-5;
- 20,000 seeded uniform triples, sampled through the port's own tables:
  the sampled cell equal on all but 0.1 % of the lanes (none differ on
  these), the point within 1e-4 (measured 5.1e-5: an in-cell offset is
  (u - c0) / (c1 - c0), which carries the tables' ulps over a narrow
  cell), the pdf within rtol 1e-6 (measured 2.2e-7);
- with the JAX tables handed to the port: the point within 1e-7
  (measured 6e-8 on the 5x6x7 grid, 0 on the fbm grid) and the pdf exact,
  so sampling itself follows the JAX rules (the slice by a right-sided
  search, row and column by counting cdf <= u, offsets clamped to
  [0, 1 - 1e-6));
- `pdf` at the sampled points equal to the sampled pdf.
"""

import json

import numpy as np
import jax
import pytest
import torch

N = 20000
FIELDS = ("slice_cdf", "row_cdf", "col_cdf", "pdf_grid")


def _grids():
    from zyg_tpu.scene.grids import make_fbm_grid

    with open("examples/scenes/fire.scene") as f:
        p = json.load(f)["materials"][1]["rendering"]["Volumetric"]["density_map"]["procedural"]
    fire = make_fbm_grid(p["resolution"], octaves=p["octaves"], seed=p["seed"],
                         sharpness=p["sharpness"])
    holes = np.random.default_rng(3).random((5, 6, 7)).astype(np.float32)
    holes[1] = 0.0  # a zero slice
    holes[3, 2] = 0.0  # a zero row
    holes[:, 4] = 0.0  # a zero row in every slice
    holes[:, :, 2] = 0.0  # a zero column
    return {"fire": fire, "holes": holes}


@pytest.fixture(scope="module", params=["fire", "holes"])
def dists(request):
    from zyg_tpu.core.distribution import Distribution3D as J
    from zyg_tpu_torch.core.distribution import Distribution3D as T

    g = _grids()[request.param]
    return g, J.build(g), T.build(g)


def _ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_tables_match_jax(dists):
    g, j, t = dists
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape and b.dtype == np.float32, f
        assert _ulp(a, b).max() <= 8, (f, _ulp(a, b).max())
    for f in ("slice_cdf", "row_cdf", "col_cdf"):
        c = getattr(t, f).numpy()
        assert (c[..., 0] == 0.0).all() and (c[..., -1] == 1.0).all(), f
        # non-decreasing up to the forced 1.0, which the sum before it may
        # exceed by an ulp or two (so may the JAX tables': rows and
        # columns are searched by counting cdf <= u, not by bisection)
        assert (np.diff(c[..., :-1], axis=-1) >= 0.0).all() and c.max() <= 1.0 + 3e-7, f
    assert abs(float(t.pdf_grid.double().mean()) - 1.0) < 1e-5
    if g.shape == (5, 6, 7):  # the zero slice and rows fall back to uniform
        np.testing.assert_allclose(t.col_cdf[3, 2].numpy(), np.arange(8) / 7.0, rtol=1e-6)
        assert float(t.slice_cdf[2] - t.slice_cdf[1]) == 0.0


def _uniforms(seed=1):
    return np.random.default_rng(seed).random((N, 3)).astype(np.float32)


def _cells(xyz, shape):
    return np.floor(np.asarray(xyz, np.float64) * np.array(shape[::-1])).astype(np.int64)


def test_samples_match_jax(dists):
    g, j, t = dists
    u = _uniforms()
    jx, jp = jax.jit(j.sample_continuous)(u)
    jx, jp = np.asarray(jx), np.asarray(jp)
    tx, tp = t.sample_continuous(torch.from_numpy(u))
    same_cell = (_cells(jx, g.shape) == _cells(tx.numpy(), g.shape)).all(-1)
    assert (~same_cell).mean() <= 1e-3, int((~same_cell).sum())
    np.testing.assert_allclose(tx.numpy()[same_cell], jx[same_cell], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.numpy()[same_cell], jp[same_cell], rtol=1e-6)
    assert ((tx >= 0.0) & (tx < 1.0)).all()
    # pdf() at the sampled points is the sampled density
    assert torch.equal(t.pdf(tx), tp)
    # denser cells are drawn more often: E[pdf] under the pdf is > 1
    assert float(tp.mean()) > 1.2


def test_sampling_with_jax_tables_matches_jax(dists):
    from zyg_tpu_torch.core.distribution import Distribution3D as T

    g, j, _ = dists
    handed = T(*(torch.from_numpy(np.array(getattr(j, f))) for f in FIELDS))
    u = _uniforms(seed=2)
    jx, jp = jax.jit(j.sample_continuous)(u)
    tx, tp = handed.sample_continuous(torch.from_numpy(u))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # no lane lands in a zero-weight cell
    assert (tp > 0.0).all()
