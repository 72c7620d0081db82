"""The port's procedural textures (zyg_tpu_torch/scene/procedural.py) against
the JAX package's (zyg_tpu/scene/procedural.py), on the same numpy inputs:

- the host bake of every node kind (Checker, Noise gradient and cellular
  with period, attenuation, absolute and invert, Mix, Mul, Max, ChannelMix,
  DetailNormal, nested graphs and an image operand) array-equal, dtype
  included; `analytic_spec` equal on analytic and baked nodes;
- the device part per function on 20,000 seeded points spanning
  [-3, 4)^2: the uint32 lattice hash exact; `eval_analytic`'s point-sampled
  checker exact; gradient and cellular noise and the footprint-filtered
  checker within 1e-6 absolute (torch and XLA round cos and sin an ulp
  apart, and XLA fuses a product into an add or subtract by the context of
  the whole function: measured up to 1.8e-7); the footprint's limits (a
  wide footprint gives the mean, a tiny one the point sample).
"""

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

NODES = {
    "checker": {"Checker": {"scale": 24, "colors": [[0.62, 0.32, 0.18], [0.22, 0.42, 0.55]]}},
    "checker_default": {"Checker": {}},
    "perlin": {"Noise": {"levels": 3, "scale": [12, 12, 12], "transition": 0.6}},
    "perlin_period": {"Noise": {"levels": 4, "scale": [5, 7], "attenuation": 0.7,
                                "period": [8, 8], "absolute": True}},
    "cellular": {"Noise": {"class": "Cellular", "levels": 2, "scale": [3, 3], "ratio": 0.4,
                           "invert": True}},
    "cellular_att": {"Noise": {"class": "Cellular", "scale": [9], "attenuation": 0.5}},
}
GRAPHS = {
    "mix": {"Mix": {"a": 0.15, "b": 0.7, "weight": NODES["perlin"]}},
    "mix_colors": {"Mix": {"a": [0.9, 0.1, 0.1], "b": NODES["checker"],
                           "weight": NODES["cellular"]}},
    "mul": {"Mul": {"a": NODES["checker"], "b": 0.5}},
    "max": {"Max": {"a": NODES["perlin_period"], "b": [0.2, 0.3, 0.4]}},
    "channel_mix": {"ChannelMix": {"source": NODES["checker"],
                                   "channels": [[0.2, 0.7, 0.1], [0.5, 0.5, 0.0], [1, 0, 0]]}},
    "detail_normal": {"DetailNormal": {"base": {"Mix": {"a": [0.5, 0.5, 1.0],
                                                        "b": [0.8, 0.3, 0.9],
                                                        "weight": NODES["perlin"]}},
                                       "detail": {"Mix": {"a": [0.5, 0.5, 1.0],
                                                          "b": [0.2, 0.6, 0.8],
                                                          "weight": NODES["cellular_att"]}}}},
    "image_operand": {"Mul": {"a": {"file": "img.png"}, "b": NODES["perlin"]}},
}


def _image(name):
    """The image operand's loader: a seeded uint8 image, as PNG decoding
    returns it (the bake reads raw texel values)."""
    assert name == "img.png"
    return (np.random.default_rng(4).random((24, 40, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", sorted({**NODES, **GRAPHS}))
def test_bake_matches_jax(name):
    from zyg_tpu.scene import procedural as jp
    from zyg_tpu_torch.scene import procedural as tp

    node = {**NODES, **GRAPHS}[name]
    a = jp.bake(node, load_image=_image, res=96)
    b = tp.bake(node, load_image=_image, res=96)
    assert a.dtype == b.dtype == np.float32 and b.shape == (96, 96, 3)
    np.testing.assert_array_equal(a, b)


def test_analytic_spec_matches_jax():
    from zyg_tpu.scene import procedural as jp
    from zyg_tpu_torch.scene import procedural as tp

    for name, node in {**NODES, **GRAPHS}.items():
        assert tp.is_procedural(node)
        spec = tp.analytic_spec(node)
        assert spec == jp.analytic_spec(node), name
        assert (spec is None) == (name in GRAPHS), name
    assert tp.analytic_spec({"Checker": {"scale": [1, 2]}}) is None
    assert not tp.is_procedural({"file": "a.png"}) and not tp.is_procedural(0.5)


def _points(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, 4, (n, 2)).astype(np.float32),
            rng.uniform(0, 0.3, n).astype(np.float32))


def test_noise_primitives_match_jax():
    from zyg_tpu.scene import procedural as jp
    from zyg_tpu_torch.scene import procedural as tp

    rng = np.random.default_rng(1)
    ix = rng.integers(-2**31, 2**31, 20000, dtype=np.int64).astype(np.int32)
    iy = rng.integers(-2**31, 2**31, 20000, dtype=np.int64).astype(np.int32)
    h = np.asarray(jax.jit(jp._hash2_j)(ix, iy)).astype(np.int64)
    np.testing.assert_array_equal(h, tp._hash2_t(torch.from_numpy(ix), torch.from_numpy(iy)).numpy())
    x, y = (rng.uniform(-40, 40, 20000).astype(np.float32) for _ in range(2))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for jf, tf in ((jp.perlin2d_j, tp.perlin2d_t), (jp.worley2d_j, tp.worley2d_t)):
        np.testing.assert_allclose(tf(tx, ty).numpy(), np.asarray(jax.jit(jf)(x, y)), rtol=0,
                                   atol=1e-6)
    per = np.asarray(jax.jit(lambda x, y: jp.perlin2d_j(x, y, (6.0, 4.0)))(x, y))
    np.testing.assert_allclose(tp.perlin2d_t(tx, ty, (6.0, 4.0)).numpy(), per, rtol=0, atol=1e-6)


@pytest.mark.parametrize("footprint", [False, True])
@pytest.mark.parametrize("name", sorted(NODES))
def test_eval_analytic_matches_jax(name, footprint):
    from zyg_tpu.scene import procedural as jp
    from zyg_tpu_torch.scene import procedural as tp

    kind, params = tp.analytic_spec(NODES[name])
    uv, foot = _points()
    if footprint:
        ref = jax.jit(lambda uv, f: jp.eval_analytic(kind, params, uv, f))(uv, foot)
        got = tp.eval_analytic(kind, params, torch.from_numpy(uv), torch.from_numpy(foot))
    else:
        ref = jax.jit(lambda uv: jp.eval_analytic(kind, params, uv))(uv)
        got = tp.eval_analytic(kind, params, torch.from_numpy(uv))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == (uv.shape[0], 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 3], 1.0)
    if kind == "checker" and not footprint:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_footprint_limits():
    """A footprint of many cells gives the checker's mean colour and fades
    every octave to its mean; one under a milli-cell is the point sample."""
    from zyg_tpu_torch.scene import procedural as tp

    uv = torch.from_numpy(_points(4096, 2)[0])
    kind, params = tp.analytic_spec(NODES["checker"])
    wide = tp.eval_analytic(kind, params, uv, torch.full((4096,), 2.0))
    mean = 0.5 * (np.float32(params[1]) + np.float32(params[2]))
    np.testing.assert_allclose(wide[:, :3].numpy(), np.broadcast_to(mean, (4096, 3)), atol=1e-6)
    tiny = tp.eval_analytic(kind, params, uv, torch.full((4096,), 1e-6))
    assert torch.equal(tiny, tp.eval_analytic(kind, params, uv))
    kind, params = tp.analytic_spec(NODES["perlin"])
    flat = tp.eval_analytic(kind, params, uv, torch.full((4096,), 10.0))[:, 0]
    # every octave at its mean 0: (0 + 1) / 2 through the 0.5 +- 0.6 ramp
    torch.testing.assert_close(flat, torch.full_like(flat, (0.5 + 0.1) / 1.2), rtol=0, atol=1e-6)
