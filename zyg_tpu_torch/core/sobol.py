"""Owen-scrambled 5-D Sobol' sampler over ray lanes (counterpart of
zyg_tpu/core/sobol.py, bit-exact with it).

5-dimension blocks, Burley-style shuffled index + nested uniform scrambling
with the improved Laine-Karras hash, per-pixel streams keyed by
(sample_index, seed), and "padding" between decision groups (the next draw
after a padding step starts a fresh scrambled block). The dimension counter
is a Python int: every lane consumes dimensions at the same call sites.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import MASK, hash_combine, hash_u32, mul_u32, to_i32, u32, u32_to_float


def _generate_directions() -> np.ndarray:
    """Joe-Kuo direction numbers for dims 1..5, 32 bits. Returns (5, 32) uint32."""
    params = [
        (0, 0, []),  # dim 1: van der Corput
        (1, 0, [1]),
        (2, 1, [1, 3]),
        (3, 1, [1, 3, 1]),
        (3, 2, [1, 1, 1]),
    ]
    out = np.zeros((5, 32), np.uint32)
    for d, (s, a, m_init) in enumerate(params):
        if s == 0:
            for k in range(32):
                out[d, k] = np.uint32(1 << (31 - k))
            continue
        m = list(m_init)
        for k in range(s, 32):
            new = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                if (a >> (s - 1 - j)) & 1:
                    new ^= m[k - j] << j
            m.append(new)
        for k in range(32):
            out[d, k] = np.uint32((m[k] << (31 - k)) & 0xFFFFFFFF)
    return out


_DIRECTIONS = _generate_directions()  # (5, 32) uint32


def bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    x = u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK


def _byte_table(directions: np.ndarray) -> np.ndarray:
    """Byte-sliced XOR table of dims 1-4, (4, 256, 4) uint32: entry
    [b, v, d - 1] is the bit-reversed XOR of dim d's direction numbers for
    the index bits 31 - (8b + i) at the set bits i of v, i.e. the bits that
    byte b = v of y = bit_reverse32(index) selects."""
    rev = bit_reverse32(torch.from_numpy(directions[1:5].astype(np.int64))).numpy().astype(np.uint32)
    v = np.arange(256)
    out = np.zeros((4, 256, 4), np.uint32)
    for b in range(4):
        for i in range(8):
            out[b, ((v >> i) & 1).astype(bool)] ^= rev[:, 31 - (8 * b + i)]
    return out


# the table csrc/sobol_block.cu fills in shared memory
BYTE_TABLE = _byte_table(_DIRECTIONS)


def laine_karras_permutation(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Improved LK hash (psychopath.io 2021), the reference's constants."""
    x = u32(x)
    seed = u32(seed)
    x = x ^ mul_u32(x, 0x3D20ADEA)
    x = (x + seed) & MASK
    x = mul_u32(x, (seed >> 16) | 1)
    x = x ^ mul_u32(x, 0x05526C56)
    x = x ^ mul_u32(x, 0x53A22864)
    return x


def nested_uniform_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return bit_reverse32(laine_karras_permutation(bit_reverse32(x), seed))


def sobol5(index: torch.Tensor) -> torch.Tensor:
    """5-D Sobol' point for a (scrambled) index: u32[...] -> u32[..., 5]."""
    index = u32(index)
    dirs = torch.as_tensor(_DIRECTIONS.astype(np.int64), device=index.device)
    acc = torch.zeros(index.shape + (5,), dtype=torch.int64, device=index.device)
    for bit in range(32):
        take = -((index >> bit) & 1)  # 0 or all ones (int64)
        acc = acc ^ (take[..., None] & dirs[:, bit])
    return acc


def sobol5_bytes(index: torch.Tensor) -> torch.Tensor:
    """sobol5 by the byte-sliced table walk of csrc/sobol_block.cu: dim 0's
    sum is the bit-reversed index; dims 1-4 XOR one BYTE_TABLE row per byte
    of y = bit_reverse32(index) and reverse the result back."""
    y = bit_reverse32(index)
    table = torch.as_tensor(BYTE_TABLE.astype(np.int64), device=y.device)
    r = table[0][y & 255] ^ table[1][(y >> 8) & 255] ^ table[2][(y >> 16) & 255] ^ table[3][y >> 24]
    return torch.cat([y[..., None], bit_reverse32(r)], dim=-1)


class SobolArrays:
    """Per-lane sampler state: int32 bit patterns of the u32 sample index,
    start seed and running seed, plus the float32[N, 5] block buffer."""

    __slots__ = ("sample", "start_seed", "run_seed", "buffer")

    def __init__(self, sample, start_seed, run_seed, buffer):
        self.sample = sample
        self.start_seed = start_seed
        self.run_seed = run_seed
        self.buffer = buffer

    def where(self, mask: torch.Tensor, other: "SobolArrays") -> "SobolArrays":
        """Lanes where `mask` holds take self's fields, the rest other's."""
        return SobolArrays(
            torch.where(mask, self.sample, other.sample),
            torch.where(mask, self.start_seed, other.start_seed),
            torch.where(mask, self.run_seed, other.run_seed),
            torch.where(mask[:, None], self.buffer, other.buffer),
        )

    def index(self, idx: torch.Tensor) -> "SobolArrays":
        return SobolArrays(
            self.sample[idx], self.start_seed[idx], self.run_seed[idx], self.buffer[idx]
        )


class SobolSampler:
    """SobolArrays plus the static dimension counter: start_pixel /
    increment_padding / sample_1d..4d."""

    def __init__(self, arrays: SobolArrays, dim: int = 5):
        self.arrays = arrays
        self.dim = dim

    @staticmethod
    def start_pixel(sample: torch.Tensor, seed: torch.Tensor) -> "SobolSampler":
        """sample: u32[N] global sample index; seed: u32[N] stream seed."""
        hashed = to_i32(hash_u32(seed))
        buf = torch.zeros(sample.shape + (5,), dtype=torch.float32, device=sample.device)
        return SobolSampler(SobolArrays(to_i32(u32(sample)), hashed, hashed, buf), dim=5)

    def increment_padding(self):
        self.dim = 5

    def _increment_seed(self):
        from ..ops.sobol_block import sobol_block

        a = self.arrays
        buf, next_seed = sobol_block(a.sample, a.run_seed)
        self.arrays = SobolArrays(a.sample, a.start_seed, next_seed, buf)
        self.dim = 0

    def _take(self, n: int) -> torch.Tensor:
        if self.dim > 5 - n:
            self._increment_seed()
        d = self.dim
        self.dim += n
        return self.arrays.buffer[..., d : d + n]

    def sample_1d(self) -> torch.Tensor:
        return self._take(1)[..., 0]

    def sample_2d(self) -> torch.Tensor:
        return self._take(2)

    def sample_3d(self) -> torch.Tensor:
        return self._take(3)

    def sample_4d(self) -> torch.Tensor:
        return self._take(4)


def sobol_block_reference(sample: torch.Tensor, run_seed: torch.Tensor):
    """The block draw as the chain of the functions above, with the kernel's
    table walk for the direction sums: (buffer float32[N, 5], next run seed
    as int32 bits)."""
    s = u32(run_seed)
    idx = nested_uniform_scramble(sample, s)
    sob = sobol5_bytes(idx)
    seeds = hash_combine(s[..., None], torch.arange(5, dtype=torch.int64, device=s.device))
    buf = u32_to_float(nested_uniform_scramble(sob, seeds))
    return buf, to_i32(hash_u32((s + 1) & MASK))
