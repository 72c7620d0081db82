"""The port's tonemappers (render/sensor.py) and sRGB8 encoding
(io/png.py::float_to_srgb8) against the JAX package's, on numpy-seeded
colours spanning the dark end to far over white, at exposure 0.5:
Linear and ACES exact, PbrNeutral within 1.8e-7, AgX within 2.3e-5 for
the Default, Substitute and Golden looks and 3e-5 for Punchy, whose power
1.35 and saturation 1.4 amplify the ulp by which torch and XLA round log2
and pow apart (2.66e-5 on 91 of 66,012 values of these colours), and the
8-bit encoding of the same linear images byte for byte, dithered and
not."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

EXPOSURE = 0.5


def _colours(seed=0, n=22004):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 3)) * np.exp(rng.uniform(-9.0, 4.0, (n, 1)))
    c[:8] = [[0, 0, 0], [1, 1, 1], [1e-12, 0, 0], [0.08, 0.08, 0.08], [0.76, 0.76, 0.76],
             [40.0, 0.0, 0.0], [0.0, 3.0, 0.01], [1e4, 1e4, 1e4]]
    return c.astype(np.float32)


def _jax_and_port(name, look=None):
    from zyg_tpu.render import sensor as jsensor
    from zyg_tpu_torch.render import sensor as tsensor

    c = _colours()
    ref = np.asarray(jsensor.tonemap(jnp.asarray(c), name, EXPOSURE, look=look))
    got = tsensor.tonemap(torch.from_numpy(c), name, EXPOSURE, look=look).numpy()
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    return ref, got


@pytest.mark.parametrize("name", ["Linear", "ACES"])
def test_linear_and_aces_match_jax_exactly(name):
    ref, got = _jax_and_port(name)
    np.testing.assert_array_equal(got, ref)


def test_pbr_neutral_matches_jax():
    ref, got = _jax_and_port("PbrNeutral")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.8e-7)


@pytest.mark.parametrize("look,tol", [("Default", 2.3e-5), ("Substitute", 2.3e-5),
                                      ("Golden", 2.3e-5), ("Punchy", 3e-5)])
def test_agx_matches_jax(look, tol):
    ref, got = _jax_and_port("AgX", look)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dither", [True, False])
def test_float_to_srgb8_matches_jax_bytes(dither):
    from zyg_tpu.io.png import float_to_srgb8 as jenc
    from zyg_tpu_torch.io.png import float_to_srgb8 as tenc

    img = _colours(1, 96 * 64).reshape(64, 96, 3)
    for x in (img, np.clip(img, 0.0, 1.0) ** 2.2):
        a, b = jenc(x, dither=dither, seed=3), tenc(x, dither=dither, seed=3)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
