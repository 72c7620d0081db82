"""The port's density grids (zyg_tpu_torch/scene/grids.py) against the JAX
package's (zyg_tpu/scene/grids.py).

- make_fbm_grid at smoke.scene's (64^3, 4 octaves, seed 11, sharpness
  1.6) and fire.scene's parameters, and at a small odd size, equal to the
  JAX array exactly (both are numpy with np.random.default_rng).
- build_grid_arena gives equal data, offset, dims, majorant, minorant,
  sdata (majorant, minorant, free radius, page), soffset, sdims and
  brick_base in both addressing modes: dense for the smoke grid, sparse
  for a mostly empty grid beside a non-cubic one; to_dense gives each
  grid back.
- On 4,096 seeded uvw (a seventh of them on voxel boundaries) over both
  arenas: sample_density_stochastic, local_majorant_free and
  local_extrema exact; sample_density_trilinear within 1e-7 absolute
  (XLA contracts its 8-term weighted sum in an order the port does not
  reproduce: 107 of 4,096 values differ, by up to 6e-8; the walks never
  call it).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)


def _scene_fbm(path):
    with open(path) as f:
        root = json.load(f)
    for m in root["materials"]:
        body = m["rendering"].get("Volumetric")
        if body and "density_map" in body:
            p = body["density_map"]["procedural"]
            return dict(n=p.get("resolution", 64), octaves=p.get("octaves", 4),
                        seed=p.get("seed", 7), sharpness=p.get("sharpness", 2.0))
    raise AssertionError(f"no fbm density map in {path}")


@pytest.mark.parametrize("params", [
    _scene_fbm("examples/scenes/smoke.scene"),
    _scene_fbm("examples/scenes/fire.scene"),
    dict(n=21, octaves=3, seed=5, sharpness=1.0),
])
def test_fbm_grid_equals_jax(params):
    from zyg_tpu.scene import grids as jg
    from zyg_tpu_torch.scene import grids as tg

    a, b = jg.make_fbm_grid(**params), tg.make_fbm_grid(**params)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _grid_sets():
    from zyg_tpu.scene.grids import make_fbm_grid

    smoke = make_fbm_grid(64, 4, 11, 1.6)
    blob = np.zeros((40, 48, 56), np.float32)
    blob[5:20, 10:30, 30:50] = np.random.default_rng(2).random((15, 20, 20)).astype(np.float32)
    return {"dense": [smoke], "sparse": [blob, smoke[:13, :17, :9]]}


@pytest.fixture(scope="module", params=["dense", "sparse"])
def arenas(request):
    from zyg_tpu.scene import grids as jg
    from zyg_tpu_torch.scene import grids as tg

    grids = _grid_sets()[request.param]
    return request.param, grids, jg.build_grid_arena(grids), tg.build_grid_arena(grids)


def test_arena_arrays_equal_jax(arenas):
    from zyg_tpu_torch.scene import grids as tg

    mode, grids, ja, ta = arenas
    assert ja.sparse == ta.sparse == (mode == "sparse")
    for f in tg.ARRAY_FIELDS:
        a, b = np.asarray(getattr(ja, f)), getattr(ta, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for g, grid in enumerate(grids):
        np.testing.assert_array_equal(tg.to_dense(ta, g), grid)
    if mode == "sparse":  # empty bricks share the zero brick
        assert ta.data.numel() < sum(
            (-(-np.array(g.shape) // tg.SUPER_CELL)).prod() for g in grids) * tg.SUPER_CELL ** 3


def _uvw(n, ngrids, seed=3):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, ngrids, n).astype(np.int32)
    uvw = rng.random((n, 3)).astype(np.float32)
    uvw[::7] = (np.round(uvw[::7] * 64) / 64).astype(np.float32)  # voxel boundaries
    r = rng.random((n, 3)).astype(np.float32)
    return gid, uvw, r


@pytest.mark.parametrize("fn", ["sample_density_stochastic", "local_majorant_free",
                                "local_extrema", "sample_density_trilinear"])
def test_lookups_match_jax(arenas, fn):
    from zyg_tpu.scene import grids as jg
    from zyg_tpu_torch.scene import grids as tg

    _, grids, ja, ta = arenas
    gid, uvw, r = _uvw(4096, len(grids))
    args = (uvw, r) if fn == "sample_density_stochastic" else (uvw,)
    ref = jax.jit(lambda g, *x: getattr(jg, fn)(ja, g, *x))(jnp.asarray(gid),
                                                            *map(jnp.asarray, args))
    got = getattr(tg, fn)(ta, torch.from_numpy(gid), *map(torch.from_numpy, args))
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b.numpy()
        if fn == "sample_density_trilinear":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-7)
            assert (a != b).mean() < 0.05
        else:
            np.testing.assert_array_equal(b, a)
    assert float(np.asarray(ref[0]).max()) > 0.0
