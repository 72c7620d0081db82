"""The port's u32 hashing and Sobol' sampler, bit-exact against zyg_tpu.core
on 4096 random u32, and the plain sobol_block against the JAX Pallas
kernel run in interpret mode (as tests/test_pallas_kernels.py runs it)."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

N = 4096


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(0xC0FFEE)
    x = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return x, y


def _t(x: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(x.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    """The port's u32 tensor (int64 value or int32 bits) -> uint32 numpy."""
    from zyg_tpu_torch.core.rng import to_i32

    if t.dtype == torch.int64:
        t = to_i32(t)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("fn", ["hash_u32", "u32_to_float"])
def test_rng_unary_bit_exact(words, fn):
    from zyg_tpu.core import rng as jr
    from zyg_tpu_torch.core import rng as tr

    x, _ = words
    ref = np.asarray(getattr(jr, fn)(x))
    out = getattr(tr, fn)(_t(x))
    if out.dtype == torch.float32:
        np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))
    else:
        np.testing.assert_array_equal(_u32(out), ref)


def test_hash_combine_bit_exact(words):
    from zyg_tpu.core import rng as jr
    from zyg_tpu_torch.core import rng as tr

    x, y = words
    np.testing.assert_array_equal(_u32(tr.hash_combine(_t(x), _t(y))), np.asarray(jr.hash_combine(x, y)))


def test_nested_uniform_scramble_bit_exact(words):
    from zyg_tpu.core import sobol as js
    from zyg_tpu_torch.core import sobol as ts

    x, y = words
    np.testing.assert_array_equal(
        _u32(ts.nested_uniform_scramble(_t(x), _t(y))), np.asarray(js.nested_uniform_scramble(x, y))
    )


def test_sobol5_bit_exact(words):
    from zyg_tpu.core import sobol as js
    from zyg_tpu_torch.core import sobol as ts

    x, _ = words
    np.testing.assert_array_equal(_u32(ts.sobol5(_t(x))), np.asarray(js.sobol5(x)))
    np.testing.assert_array_equal(ts._DIRECTIONS, js._DIRECTIONS)


def test_kernel_direction_table_matches():
    """csrc/sobol_block.cu's __constant__ table is the sampler's table."""
    from zyg_tpu_torch.core.sobol import _DIRECTIONS
    import zyg_tpu_torch.ops as ops

    src = (ops.CSRC / "sobol_block.cu").read_text()
    body = src[src.index("kSobolDirections[5][32] = {"):]
    body = body[: body.index("};")]
    vals = [int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u", body)]
    np.testing.assert_array_equal(np.asarray(vals, np.uint32).reshape(5, 32), _DIRECTIONS)


def test_byte_table_is_xor_of_directions():
    """Every entry of the byte-sliced table (dims 1-4) is the bit-reversed XOR
    of the direction numbers its byte's set bits select, counted bit by bit."""
    from zyg_tpu_torch.core.sobol import _DIRECTIONS, BYTE_TABLE

    assert BYTE_TABLE.shape == (4, 256, 4) and BYTE_TABLE.dtype == np.uint32
    for b in range(4):
        for v in range(256):
            for d in range(1, 5):
                x = 0
                for i in range(8):
                    if (v >> i) & 1:
                        x ^= int(_DIRECTIONS[d, 31 - (8 * b + i)])
                assert int(BYTE_TABLE[b, v, d - 1]) == int(f"{x:032b}"[::-1], 2), (b, v, d)


def test_table_walk_matches_sobol5():
    """The kernel's table walk equals the 32-bit direction loop bit for bit,
    on 2^16 random indices plus 0 and 0xFFFFFFFF."""
    from zyg_tpu.core import sobol as js
    from zyg_tpu_torch.core import sobol as ts

    rng = np.random.default_rng(0x5EED)
    x = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([x, np.array([0, 0xFFFFFFFF], np.uint32)])
    walk = _u32(ts.sobol5_bytes(_t(x)))
    np.testing.assert_array_equal(walk, _u32(ts.sobol5(_t(x))))
    np.testing.assert_array_equal(walk, np.asarray(js.sobol5(x)))


def _draws_jax(sample, seed):
    from zyg_tpu.core.sobol import SobolSampler

    smp = SobolSampler.start_pixel(jnp.asarray(sample), jnp.asarray(seed))
    out = [smp.sample_4d(), smp.sample_1d()]
    smp.increment_padding()
    out += [smp.sample_1d(), smp.sample_1d(), smp.sample_2d(), smp.sample_3d()]
    smp.increment_padding()
    out += [smp.sample_2d(), smp.sample_2d(), smp.sample_2d()]
    return [np.asarray(v) for v in out] + [np.asarray(smp.arrays.run_seed)]


def _draws_port(sample, seed):
    from zyg_tpu_torch.core.sobol import SobolSampler

    smp = SobolSampler.start_pixel(_t(sample), _t(seed))
    out = [smp.sample_4d(), smp.sample_1d()]
    smp.increment_padding()
    out += [smp.sample_1d(), smp.sample_1d(), smp.sample_2d(), smp.sample_3d()]
    smp.increment_padding()
    out += [smp.sample_2d(), smp.sample_2d(), smp.sample_2d()]
    return [v.numpy() for v in out] + [_u32(smp.arrays.run_seed)]


def test_sampler_draw_sequence_bit_exact(words):
    x, y = words
    for a, b in zip(_draws_jax(x, y), _draws_port(x, y)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_plain_sobol_block_matches_pallas_interpret(monkeypatch, words):
    import zyg_tpu.ops as jops
    import zyg_tpu.ops.sobol_block as jsb
    from zyg_tpu_torch.ops.sobol_block import sobol_block

    monkeypatch.setattr(jops, "use_pallas", lambda: True)
    monkeypatch.setattr(jsb, "use_pallas", lambda: True)
    x, y = words
    n = 3000  # not a multiple of the Pallas lane tile
    with pltpu.force_tpu_interpret_mode():
        ref_buf, ref_seed = jsb.sobol_block(jnp.asarray(x[:n]), jnp.asarray(y[:n]))
    buf, seed = sobol_block(_t(x[:n]), _t(y[:n]))
    np.testing.assert_array_equal(buf.numpy().view(np.uint32), np.asarray(ref_buf).view(np.uint32))
    np.testing.assert_array_equal(_u32(seed), np.asarray(ref_seed))


def test_non_cpu_tensor_never_falls_back():
    """Wrappers take the plain version only for CPU tensors; any other
    device goes to the kernel path, which refuses it instead of computing."""
    from zyg_tpu_torch.ops.sobol_block import sobol_block

    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sobol_block(z, z)
