// One 5-D Owen-scrambled Sobol' block per lane.
//
// Replaces the TPU kernel zyg_tpu/ops/sobol_block.py::_kernel (launched by
// sobol_block, pallas_call at :65). Same chain, bit-exact: Laine-Karras
// nested uniform scramble of the sample index, 32-bit direction-number XOR
// accumulation for 5 dimensions, per-dimension rescramble with
// hash_combine(seed, d), mantissa-trick floats, next seed hash_u32(seed + 1).
//
// What bounds it on an H100: per lane it reads 8 bytes and writes 24
// (~66 MB at 2,073,600 lanes, ~20 us at 3.35 TB/s). The TPU kernel's
// direction loop (32 bits x 5 dimensions of bit extracts and XORs, ~200 of
// a lane's ~300 integer instructions) made a one-thread-per-lane port bound
// by integer issue instead: Hopper issues 64 INT32 lanes a clock an SM, a
// quarter of its float32 rate. So the design cuts integer work:
// - the scrambles run on bit-reversed values and the direction sums are
//   kept bit-reversed, which drops five of the twelve bit reversals;
// - dimension 0's direction numbers are 0x80000000 >> bit, so its sum is
//   the bit-reversed index itself;
// - dimensions 1-4 come from a byte-sliced table in shared memory: entry
//   (b, v) holds, as one uint4, the four dimensions' XOR of the direction
//   numbers that byte b = v selects, so a lane makes four 16-byte shared
//   loads and 12 XORs instead of 32 x 4 masked XORs. Each 512-thread block
//   fills the table (16 KB) from two 16-entry nibble tables per byte.
// Random table bytes conflict in shared memory banks (~10 wavefronts per
// warp-wide 16-byte load instead of 4, counted by chip_smoke.py on the main
// path's data); the loads still cost less than the loop they replace.
// Measured and not kept (PERF.md): a resident grid over a grid-stride loop
// (one fill per block), staging the output tile in shared memory for
// 16-byte stores, prefetching the next chunk's inputs, 256 or 1024 threads.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kSobolThreads = 512;

// Joe-Kuo direction numbers, dims 1..5 (zyg_tpu_torch/core/sobol.py
// _DIRECTIONS; tests/test_torch_core.py holds this literal against it).
__constant__ uint32_t kSobolDirections[5][32] = {
    {0x80000000u, 0x40000000u, 0x20000000u, 0x10000000u, 0x08000000u, 0x04000000u, 0x02000000u, 0x01000000u,
     0x00800000u, 0x00400000u, 0x00200000u, 0x00100000u, 0x00080000u, 0x00040000u, 0x00020000u, 0x00010000u,
     0x00008000u, 0x00004000u, 0x00002000u, 0x00001000u, 0x00000800u, 0x00000400u, 0x00000200u, 0x00000100u,
     0x00000080u, 0x00000040u, 0x00000020u, 0x00000010u, 0x00000008u, 0x00000004u, 0x00000002u, 0x00000001u},
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u, 0x88000000u, 0xCC000000u, 0xAA000000u, 0xFF000000u,
     0x80800000u, 0xC0C00000u, 0xA0A00000u, 0xF0F00000u, 0x88880000u, 0xCCCC0000u, 0xAAAA0000u, 0xFFFF0000u,
     0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u, 0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u,
     0x80808080u, 0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u, 0x88888888u, 0xCCCCCCCCu, 0xAAAAAAAAu, 0xFFFFFFFFu},
    {0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u, 0x5C000000u, 0x8E000000u, 0xC5000000u,
     0x68800000u, 0x9CC00000u, 0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u, 0x90550000u,
     0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u, 0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u,
     0x8000E880u, 0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu, 0x8E00EEEEu, 0xC5005555u},
    {0x80000000u, 0xC0000000u, 0x20000000u, 0x50000000u, 0xF8000000u, 0x74000000u, 0xA2000000u, 0x93000000u,
     0xD8800000u, 0x25400000u, 0x59E00000u, 0xE6D00000u, 0x78080000u, 0xB40C0000u, 0x82020000u, 0xC3050000u,
     0x208F8000u, 0x51474000u, 0xFBEA2000u, 0x75D93000u, 0xA0858800u, 0x914E5400u, 0xDBE79E00u, 0x25DB6D00u,
     0x58800080u, 0xE54000C0u, 0x79E00020u, 0xB6D00050u, 0x800800F8u, 0xC00C0074u, 0x200200A2u, 0x50050093u},
    {0x80000000u, 0x40000000u, 0x20000000u, 0xB0000000u, 0xF8000000u, 0xDC000000u, 0x7A000000u, 0x9D000000u,
     0x5A800000u, 0x2FC00000u, 0xA1600000u, 0xF0B00000u, 0xDA880000u, 0x6FC40000u, 0x81620000u, 0x40BB0000u,
     0x22878000u, 0xB3C9C000u, 0xFB65A000u, 0xDDB2D000u, 0x78022800u, 0x9C0B3C00u, 0x5A0FB600u, 0x2D0DDB00u,
     0xA2878080u, 0xF3C9C040u, 0xDB65A020u, 0x6DB2D0B0u, 0x800228F8u, 0x400B3CDCu, 0x200FB67Au, 0xB00DDB9Du},
};


__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return x;
}

// The byte-sliced table of dims 1-4 (core/sobol.py BYTE_TABLE): entry
// 256 * b + v holds, bit-reversed, the XOR of the direction numbers of the
// index bits 31 - (8b + i) for the set bits i of v, i.e. of the bits that
// byte b = v of y = brev(index) selects. Built as lo ^ hi from two
// 16-entry tables per byte position (its low and its high nibble).
__device__ void fill_table(uint4* table, uint4* nib) {
  for (int h = threadIdx.x; h < 128; h += blockDim.x) {
    const int b = h >> 5, top = 31 - 8 * b - 4 * ((h >> 4) & 1), u = h & 15;
    uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t take = 0u - ((u >> i) & 1u);
#pragma unroll
      for (int d = 0; d < 4; ++d) x[d] ^= take & kSobolDirections[d + 1][top - i];
    }
    nib[h] = make_uint4(__brev(x[0]), __brev(x[1]), __brev(x[2]), __brev(x[3]));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 1024; e += blockDim.x) {
    const uint4 lo = nib[32 * (e >> 8) + (e & 15)];
    const uint4 hi = nib[32 * (e >> 8) + 16 + ((e >> 4) & 15)];
    table[e] = make_uint4(lo.x ^ hi.x, lo.y ^ hi.y, lo.z ^ hi.z, lo.w ^ hi.w);
  }
  __syncthreads();
}

// One lane's block: its 5 floats to dst[0..4], and its next run seed.
__device__ __forceinline__ uint32_t draw(uint32_t sample, uint32_t s, const uint4* table,
                                         float* dst) {
  // y = brev(index) for the scrambled index = nested_uniform_scramble(sample, s)
  const uint32_t y = laine_karras(__brev(sample), s);
  uint32_t r[5];  // bit-reversed direction sums; dim 0's sum is brev(index)
  r[0] = __brev(y);
  const uint4 t0 = table[y & 255u];
  const uint4 t1 = table[256 + ((y >> 8) & 255u)];
  const uint4 t2 = table[512 + ((y >> 16) & 255u)];
  const uint4 t3 = table[768 + (y >> 24)];
  r[1] = t0.x ^ t1.x ^ t2.x ^ t3.x;
  r[2] = t0.y ^ t1.y ^ t2.y ^ t3.y;
  r[3] = t0.z ^ t1.z ^ t2.z ^ t3.z;
  r[4] = t0.w ^ t1.w ^ t2.w ^ t3.w;
  // nested_uniform_scramble(sum, hash_combine(s, d)) on the reversed sum
  const uint32_t hc = (s << 6) + (s >> 2);
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const uint32_t bits = __brev(laine_karras(r[d], s ^ (hc + (uint32_t)d)));
    dst[d] = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  }
  return hash_u32(s + 1u);
}

__global__ void __launch_bounds__(kSobolThreads)
sobol_block_kernel(const uint32_t* __restrict__ sample, const uint32_t* __restrict__ run_seed,
                   float* __restrict__ buf, uint32_t* __restrict__ next_seed, int64_t n) {
  __shared__ uint4 table[1024];
  __shared__ uint4 nib[128];
  const int64_t i = (int64_t)blockIdx.x * kSobolThreads + threadIdx.x;
  // the lane's inputs are in flight while the block fills its table
  const uint32_t smp = i < n ? sample[i] : 0u, sd = i < n ? run_seed[i] : 0u;
  fill_table(table, nib);
  if (i < n) next_seed[i] = draw(smp, sd, table, buf + i * 5);
}

extern "C" int zyg_sobol_block(const void* sample, const void* run_seed, void* buf,
                               void* next_seed, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (n + kSobolThreads - 1) / kSobolThreads;
  sobol_block_kernel<<<(unsigned)blocks, kSobolThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sample, (const uint32_t*)run_seed, (float*)buf, (uint32_t*)next_seed, n);
  return (int)cudaGetLastError();
}
