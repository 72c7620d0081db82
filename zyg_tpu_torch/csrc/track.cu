// Tracking walks through density grids: decomposition (delta) tracking for
// distance sampling (with the emission an emissive medium gives off at an
// analog absorption) and residual-ratio tracking for shadow transmittance.
//
// Replaces two XLA while loops of the JAX package (not TPU kernels):
// zyg_tpu/render/integrator/volume.py:273-382 (sample_interaction's
// track_stage) and :631-701 (_prop_transmittance's track_stage), with the
// grid lookups of zyg_tpu/scene/grids.py (_cell_flat, _voxel_fetch,
// sample_density_stochastic), and the emission collected at an absorption
// (volume.py:345-370). The plain torch versions, with the same
// arithmetic, are zyg_tpu_torch/ops/track.py.
//
// What bounds it on an H100: a lane reads ~60-100 bytes of inputs and
// writes 10-22, then each step reads one 16-byte supergrid row and, at a
// tentative collision, one 4-byte voxel (the smoke arena is ~1 MB, the
// supergrid 8 KB) and spends a few hundred instructions on three counter
// hashes, the cell walls (IEEE divisions), the free flight's logf and
// NaN-propagating clamps. The step count is data dependent (on smoke's
// shadow rays 8.6 a walking lane, 31 at most), so the kernel is bound by
// instruction issue and the latency of its dependent reads, over the
// thread-steps it runs, walking or idle: with a thread a lane a warp runs
// until its longest walk ends, and on smoke's shadow rays only 29.5 % of
// those thread-steps walk (63 % on its camera rays, 76 % on fire's).
// Design:
// - persistent warps that refill finished threads (the GPU counterpart of
//   the JAX package's compaction cascade, volume.py:403-420): the grid is
//   the card's resident blocks (SMs x the blocks an SM holds of each
//   template form, queried once a device and form), and each warp claims
//   32 lanes at a time from a lane counter in device memory (one atomicAdd
//   by its thread 0, the base passed round with __shfl_sync). At a claim
//   each thread reads one lane's walk flag: a lane that does not walk has
//   its outputs written there, a walking one has its inputs (and its
//   grid's constants) copied into the thread's column of the warp's buffer
//   in shared memory. The threads without a lane (a __ballot_sync mask)
//   take the walking lanes in rank order and read their words from shared
//   memory, so a refill waits on no device-memory read. The warp refills
//   once kRefill of its threads are idle, and leaves when the counter
//   has passed n and none of its threads holds a lane: a warp-uniform test,
//   so every collective runs on the full mask. (Copying every claimed
//   lane's words, walking or not, or claiming one pool ahead, measured
//   slower: the first adds load traffic, the second a pool a warp to the
//   tail.)
// - each grid's constants (voxel and supergrid dims, first supergrid row,
//   brick base) sit in registers, loaded once a thread in the
//   transmittance walk (one grid and prop a launch, the prop's transform
//   too) and once a lane in the interaction walk, whose transform is read
//   at a tentative collision (held in registers it cost ~25 registers a
//   thread and resident blocks); the arena is read through the read-only
//   path (__ldg);
// - where the whole supergrid fits in TRACK_ROWS_ON_CHIP rows (16 KB;
//   ops/track.py::rows_on_chip decides), each block first stages the rows
//   a walk can read into shared memory (the interaction walk all of them,
//   since its lanes may sit in different grids; the transmittance walk its
//   grid's), and a step's row and a sparse arena's page come from there.
// Each lane's arithmetic and step order are those of a walk in its own
// thread, so the outputs do not depend on the mapping; the 16,384-step cap
// stays per lane, so a NaN lane holds one thread, not its warp. The voxel
// is read only at a tentative collision (the plain version reads it on
// every lane and masks it). Dense arenas compute the page (brick_base +
// cell); sparse arenas read it from the row's page column. The emission
// is a template flag (kEmit): a medium that does not emit runs the walk
// without it, and an emissive one reads its lane's e (12 bytes) only at
// the absorption that ends the walk and writes 12 bytes of emission a lane.
//
// Numerics: built with -fmad=false; fmaf exactly where the plain version
// (and XLA) fuse: lo + t * ld, o + t * d, the transform's dot products,
// and uvw * dims - 0.5. Precise logf, IEEE division, rintf for
// round-half-even. Min, max and clamp propagate NaN as torch's do, and a
// NaN index is 0, as the plain version's nan_to_num makes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

#define TRACK_SUPER 8
#define TRACK_MAX_STEPS 16384
#define TRACK_THREADS 128
// supergrid rows a block stages in shared memory (16 KB): ops/track.py ROWS_ON_CHIP
#define TRACK_ROWS_ON_CHIP 1024

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
// idle threads a warp waits for before it refills them (1, 2, 4, 8, 16 and
// 32 measured in turns: 2 best, by ~1 %)
constexpr int kRefill = 2;
// resident blocks of 128 threads an SM must hold: at most 80 registers a
// thread (1, 5, 6, 7 and 8 measured in turns: 6 best); one fewer for the
// spectral emissive interaction walk, which spills at 80
constexpr int kMinBlocks = 6;

struct TrackArena {
  const float* data;  // brick pool
  const int32_t* dims;  // [G, 3]
  const float4* rows;  // [Ts] majorant, minorant, free radius, page
  const int32_t* soffset;  // [G]
  const int32_t* sdims;  // [G, 3]
  const int32_t* brick_base;  // [G]
  const float* rot;  // [P, 3, 3] prop rotation rows
  const float* pos;  // [P, 3]
  const float* scale;  // [P, 3]
};

// one grid's constants
struct GridC {
  float dim[3];  // voxels a side
  float sd[3];  // supergrid cells a side
  int snx, sny, soffset, base;  // supergrid cells in x and y, first row, brick base
};

// one prop's transform; s is the scale, or its reciprocal (kRecip)
struct Xform {
  float r[9], pos[3], s[3];
};

__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float clamp01(float x) { return nmin(nmax(x, 0.0f), 1.0f); }
// clip(x, 0, hi) as an index; NaN -> 0 (the plain version's nan_to_num)
__device__ __forceinline__ int clip_index(float x, float hi) {
  const float c = nmin(nmax(x, 0.0f), hi);
  return c != c ? 0 : (int)c;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t hash2_u32(uint32_t key, uint32_t counter) {
  uint32_t s = hash_u32(key);
  s = s ^ (counter + (s << 6) + (s >> 2));
  return hash_u32(s);
}
__device__ __forceinline__ float u32_to_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ GridC grid_of(const TrackArena& a, int g) {
  GridC c;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c.dim[j] = (float)__ldg(a.dims + 3 * g + j);
    c.sd[j] = (float)__ldg(a.sdims + 3 * g + j);
  }
  c.snx = __ldg(a.sdims + 3 * g);
  c.sny = __ldg(a.sdims + 3 * g + 1);
  c.soffset = __ldg(a.soffset + g);
  c.base = __ldg(a.brick_base + g);
  return c;
}

template <bool kRecip>
__device__ __forceinline__ Xform xform_of(const TrackArena& a, int prop) {
  Xform x;
#pragma unroll
  for (int k = 0; k < 9; ++k) x.r[k] = __ldg(a.rot + 9 * prop + k);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    x.pos[j] = __ldg(a.pos + 3 * prop + j);
    const float s = __ldg(a.scale + 3 * prop + j);
    x.s[j] = kRecip ? 1.0f / s : s;
  }
  return x;
}

// the supergrid rows a walk reads: shared memory's copy of rows [base,
// base + staged) (kRows), or the arena's
template <bool kRows>
struct RowSrc {
  const float4* g;
  const float4* s;
  int base;
  __device__ __forceinline__ float4 row(int64_t r) const {
    if (kRows) return s[r - base];
    return __ldg(g + r);
  }
  __device__ __forceinline__ float page(int64_t r) const {
    if (kRows) return s[r - base].w;
    return __ldg(reinterpret_cast<const float*>(g + r) + 3);
  }
};

// a block's copy of rows [base, base + count) into shared memory
template <bool kRows>
__device__ __forceinline__ void stage_rows(float4* s, const float4* g, int64_t base, int64_t count) {
  if (!kRows) return;
  if (count > TRACK_ROWS_ON_CHIP) count = TRACK_ROWS_ON_CHIP;
  for (int64_t r = threadIdx.x; r < count; r += blockDim.x) s[r] = __ldg(g + base + r);
  __syncthreads();
}

// the supergrid row of the macrocell holding uvw (grids._cell_flat)
__device__ __forceinline__ int64_t cell_row(const GridC& c, const float uvw[3]) {
  int vox[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) vox[j] = clip_index(uvw[j] * c.dim[j], c.dim[j] - 1.0f) / TRACK_SUPER;
  const int64_t snx = c.snx, sny = c.sny;
  return (int64_t)c.soffset + ((int64_t)vox[2] * sny + vox[1]) * snx + vox[0];
}

// one jittered nearest-voxel read (grids.sample_density_stochastic)
template <bool kRows>
__device__ __forceinline__ float density(const float* data, const RowSrc<kRows>& rows,
                                         const GridC& c, bool sparse, const float uvw[3],
                                         const float r[3]) {
  int idx[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float v = fmaf(uvw[j], c.dim[j], -0.5f) + (r[j] - 0.5f);
    idx[j] = clip_index(rintf(v), c.dim[j] - 1.0f);
  }
  const int64_t snx = c.snx, sny = c.sny;
  const int64_t cellloc = ((int64_t)(idx[2] / TRACK_SUPER) * sny + idx[1] / TRACK_SUPER) * snx
                          + idx[0] / TRACK_SUPER;
  const int64_t page = sparse ? (int64_t)rows.page((int64_t)c.soffset + cellloc)
                              : (int64_t)c.base + cellloc;
  const int64_t local = ((int64_t)(idx[2] % TRACK_SUPER) * TRACK_SUPER + idx[1] % TRACK_SUPER)
                        * TRACK_SUPER + idx[0] % TRACK_SUPER;
  return __ldg(data + page * (TRACK_SUPER * TRACK_SUPER * TRACK_SUPER) + local);
}

// unit-cube coordinates of world point p in a prop (track.object_uvw)
template <bool kRecip>
__device__ __forceinline__ void object_uvw(const Xform& x, const float p[3], float uvw[3]) {
  const float v0 = p[0] - x.pos[0], v1 = p[1] - x.pos[1], v2 = p[2] - x.pos[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float l = fmaf(v2, x.r[3 * i + 2], fmaf(v1, x.r[3 * i + 1], v0 * x.r[3 * i]));
    uvw[i] = clamp01((kRecip ? l * x.s[i] : l / x.s[i]) + 0.5f);
  }
}

// the three voxel-jitter uniforms of one hash (11, 11 and 10 bits)
__device__ __forceinline__ void jitter(uint32_t bits, float r[3]) {
  r[0] = (float)(bits & 0x7FFu) * (1.0f / 2048.0f);
  r[1] = (float)((bits >> 11) & 0x7FFu) * (1.0f / 2048.0f);
  r[2] = (float)(bits >> 22) * (1.0f / 1024.0f);
}

// ray t at which the current macrocell, grown by skip_r empty cells, is left
__device__ __forceinline__ float cell_exit(float t, float skip_r, const float lo[3],
                                           const float ld[3], const float inv[3],
                                           const float sd[3], float eps) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float p_l = fmaf(t, ld[j], lo[j]);
    const float cell = floorf(nmin(nmax((p_l + 0.5f) * sd[j], 0.0f), sd[j] - 1.0f));
    const float wall_cell = ld[j] > 0.0f ? (cell + skip_r) + 1.0f : cell - skip_r;
    const float wall = wall_cell / nmax(sd[j], 1.0f) - 0.5f;
    const float t_ax = (wall - p_l) * inv[j];
    m = j == 0 ? t_ax : nmin(m, t_ax);
  }
  return (t + nmax(m, 0.0f)) + eps;
}

__device__ __forceinline__ float flight(float t, float u1, float mu) {
  return t - logf(nmax(1.0f - u1, 1e-7f)) / nmax(mu, 1e-12f);
}

__device__ __forceinline__ void load3(const float* x, int64_t i, float v[3]) {
  v[0] = __ldg(x + 3 * i);
  v[1] = __ldg(x + 3 * i + 1);
  v[2] = __ldg(x + 3 * i + 2);
}

// a lane's staged words, read from its column with 128-bit shared loads
template <int kWords>
__device__ __forceinline__ void read_col(const uint32_t* col, uint32_t (&w)[kWords]) {
  static_assert(kWords % 4 == 0, "a column is whole 16-byte words");
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 v = reinterpret_cast<const uint4*>(col)[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

// A warp's walk over lanes, which every thread of the warp runs. The warp
// claims 32 lanes at a time from the counter (one atomicAdd); thread t
// runs stage(base + t, column t of buf) on lane base + t, which writes the
// outputs of a lane that does not walk and returns false, or copies a
// walking lane's kWords words (its inputs, and its grid's constants) into
// its column of the warp's buffer in shared memory (buf[t * kWords + w])
// and returns true; a ballot gives the claimed lanes that walk. Once
// kRefill of the warp's threads are idle, they take those lanes in
// rank order (each column writes its rank's entry of pick, the idle
// thread of that rank reads it) and start(lane, column) reads the lane's
// words: a refill waits on shared memory, not on device memory. Then each
// thread that holds a lane runs step(), one step of its walk, which
// returns true once the walk has ended (and has written its outputs). The
// warp leaves when the counter has passed n and none of its threads holds
// a lane: a warp-uniform test, so every collective runs on the full mask.
template <int kWords, typename Stage, typename Start, typename Step>
__device__ __forceinline__ void walk_lanes(unsigned long long* counter, int64_t n, uint32_t* buf,
                                           int* pick, Stage&& stage, Start&& start, Step&& step) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned lower = (1u << lane) - 1u;
  int64_t base = 0;
  unsigned avail = 0;  // the claimed lanes that walk and wait for a thread
  bool dry = false, busy = false;
  while (true) {
    unsigned idle = __ballot_sync(kFull, !busy);
    if (!dry && __popc(idle) >= kRefill) {
      while (idle != 0) {
        if (avail == 0) {
          unsigned long long b = 0;
          if (lane == 0) b = atomicAdd(counter, 32ull);
          base = (int64_t)__shfl_sync(kFull, b, 0);
          if (base >= n) {
            dry = true;
            break;
          }
          __syncwarp();  // the buffer's last reads before its new lanes
          const bool walks = base + lane < n && stage(base + lane, buf + lane * kWords);
          avail = __ballot_sync(kFull, walks);
          continue;
        }
        const int take = __popc(idle) < __popc(avail) ? __popc(idle) : __popc(avail);
        const bool mine = (avail >> lane) & 1u;
        const int col_rank = __popc(avail & lower);
        __syncwarp();  // pick's last reads before its new entries
        if (mine && col_rank < take) pick[col_rank] = (int)lane;
        __syncwarp();
        const int rank = __popc(idle & lower);
        if (((idle >> lane) & 1u) && rank < take) {
          const int col = pick[rank];
          start(base + col, buf + col * kWords);
          busy = true;
        }
        avail = __ballot_sync(kFull, mine && col_rank >= take);
        idle = __ballot_sync(kFull, !busy);
      }
    }
    if (idle == kFull) break;  // only once dry: an idle warp that is not dry refills
    if (busy && step()) busy = false;
  }
}

struct InteractionArgs {
  TrackArena a;
  const float *lo, *ld, *inv, *seg, *mu_t_max;
  const int32_t* grid;
  const float *eps, *o, *d;
  const int32_t *mp, *key;
  const float *mu_t, *mu_s;  // [N] grey, [N, 3] spectral
  float *t_out, *w_out;
  uint8_t *scat_out, *abs_out;
  const float* e_med;  // [N, 3] the lane's medium emission (kEmit only)
  float* emis_out;  // [N, 3] the emission collected at an absorption (kEmit only)
  unsigned long long* next;  // the lane counter, zeroed before the launch
  int64_t n, n_rows;  // lanes; supergrid rows (the rows staged, kRows)
  int sparse;
};

// one thread's lane of the interaction walk
struct ILane {
  int64_t i;
  GridC c;
  float lo[3], ld[3], inv[3], o[3], d[3], mt[3], ms[3], w[3], em[3];
  float seg, mu_t_max, eps, t;
  uint32_t key;
  int mp, it;
  bool scat, absb;
};

// a staged interaction lane: lo, ld, inv, o, d (0-14), seg, mu_t_max, eps,
// key, mp (15-19), its grid's dims and supergrid dims as floats (20-25),
// supergrid cells in x and y, first row and brick base (26-29), then mu_t
// and mu_s (1 or 3 each), padded to whole 16-byte words
template <bool kGrey>
struct InteractionWords {
  static constexpr int value = kGrey ? 32 : 36;
};

template <bool kGrey, bool kEmit>
__device__ __forceinline__ bool interaction_stage(const InteractionArgs& q, int64_t i,
                                                  uint32_t* col) {
  const int g = __ldg(q.grid + i);
  if (g < 0) {
    q.t_out[i] = 0.0f;
    if (kGrey) {
      q.w_out[i] = 1.0f;
    } else {
      for (int j = 0; j < 3; ++j) q.w_out[3 * i + j] = 1.0f;
    }
    q.scat_out[i] = 0;
    q.abs_out[i] = 0;
    if (kEmit) {
      for (int j = 0; j < 3; ++j) q.emis_out[3 * i + j] = 0.0f;
    }
    return false;
  }
  const float* v3[5] = {q.lo, q.ld, q.inv, q.o, q.d};
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) col[3 * k + j] = __float_as_uint(__ldg(v3[k] + 3 * i + j));
  col[15] = __float_as_uint(__ldg(q.seg + i));
  col[16] = __float_as_uint(__ldg(q.mu_t_max + i));
  col[17] = __float_as_uint(__ldg(q.eps + i));
  col[18] = (uint32_t)__ldg(q.key + i);
  col[19] = (uint32_t)__ldg(q.mp + i);
  const GridC c = grid_of(q.a, g);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    col[20 + j] = __float_as_uint(c.dim[j]);
    col[23 + j] = __float_as_uint(c.sd[j]);
  }
  col[26] = (uint32_t)c.snx;
  col[27] = (uint32_t)c.sny;
  col[28] = (uint32_t)c.soffset;
  col[29] = (uint32_t)c.base;
  const int m = kGrey ? 1 : 3;
#pragma unroll
  for (int j = 0; j < m; ++j) {
    col[30 + j] = __float_as_uint(__ldg(q.mu_t + m * i + j));
    col[30 + m + j] = __float_as_uint(__ldg(q.mu_s + m * i + j));
  }
  return true;
}

template <bool kGrey>
__device__ __forceinline__ void interaction_start(int64_t i, const uint32_t* col, ILane& s) {
  uint32_t w[InteractionWords<kGrey>::value];
  read_col(col, w);
  s.i = i;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.lo[j] = __uint_as_float(w[j]);
    s.ld[j] = __uint_as_float(w[3 + j]);
    s.inv[j] = __uint_as_float(w[6 + j]);
    s.o[j] = __uint_as_float(w[9 + j]);
    s.d[j] = __uint_as_float(w[12 + j]);
    s.c.dim[j] = __uint_as_float(w[20 + j]);
    s.c.sd[j] = __uint_as_float(w[23 + j]);
  }
  s.seg = __uint_as_float(w[15]);
  s.mu_t_max = __uint_as_float(w[16]);
  s.eps = __uint_as_float(w[17]);
  s.key = w[18];
  s.mp = (int)w[19];
  s.c.snx = (int)w[26];
  s.c.sny = (int)w[27];
  s.c.soffset = (int)w[28];
  s.c.base = (int)w[29];
  const int m = kGrey ? 1 : 3;
#pragma unroll
  for (int j = 0; j < m; ++j) {
    s.mt[j] = __uint_as_float(w[30 + j]);
    s.ms[j] = __uint_as_float(w[30 + m + j]);
  }
  s.t = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.w[j] = 1.0f;
    s.em[j] = 0.0f;
  }
  s.it = 0;
  s.scat = s.absb = false;
}

// one step of the lane's walk; true once the walk has ended
template <bool kGrey, bool kEmit, bool kRows>
__device__ __forceinline__ bool interaction_step(const InteractionArgs& q, const RowSrc<kRows>& rows,
                                                 ILane& s) {
  const float u1 = u32_to_float(hash2_u32(s.key, 0u));
  const float u2 = u32_to_float(hash2_u32(s.key, 1u));
  float uvw[3];
  for (int j = 0; j < 3; ++j) uvw[j] = clamp01(fmaf(s.t, s.ld[j], s.lo[j]) + 0.5f);
  const float4 row = rows.row(cell_row(s.c, uvw));
  const float mu_loc = row.x * s.mu_t_max;
  const bool empty = mu_loc <= 1e-9f;
  const float t_cell = cell_exit(s.t, empty ? row.z : 0.0f, s.lo, s.ld, s.inv, s.c.sd, s.eps);
  const float t_cand = flight(s.t, u1, mu_loc);
  const bool crossed = empty || (t_cand > t_cell);
  const float t_new = crossed ? t_cell : t_cand;
  const bool exited = t_new >= s.seg;
  const bool collide = !exited && !crossed;
  bool scat_now = false, abs_now = false;
  if (collide) {
    float r3[3], p[3];
    jitter(hash2_u32(s.key, 2u), r3);
    for (int j = 0; j < 3; ++j) p[j] = fmaf(t_new, s.d[j], s.o[j]);
    // the transform, read at a tentative collision only (an L1 hit)
    object_uvw<false>(xform_of<false>(q.a, s.mp), p, uvw);
    const float dens = density(q.a.data, rows, s.c, q.sparse != 0, uvw, r3);
    const float mu_s = nmax(mu_loc, 1e-12f);
    if (kGrey) {
      const float ps = dens * s.ms[0] / mu_s;
      const float pa = dens * (s.mt[0] - s.ms[0]) / mu_s;
      scat_now = u2 < ps;
      abs_now = !scat_now && (u2 < ps + pa);
      if (kEmit && abs_now) load3(q.e_med, s.i, s.em);
    } else {
      float mtx[3], msx[3], max_[3];
      for (int j = 0; j < 3; ++j) {
        mtx[j] = dens * s.mt[j];
        msx[j] = dens * s.ms[j];
        max_[j] = mtx[j] - msx[j];
      }
      const float ps = ((msx[0] + msx[1]) + msx[2]) / 3.0f / mu_s;
      const float pa = ((max_[0] + max_[1]) + max_[2]) / 3.0f / mu_s;
      const float pn = nmax(1.0f - ps - pa, 1e-7f);
      scat_now = u2 < ps;
      abs_now = !scat_now && (u2 < ps + pa);
      if (kEmit && abs_now) {
        // w * mu_a(x) / (mu_maj * pa) * e, with the weight before the kill
        float e[3];
        load3(q.e_med, s.i, e);
        const float apdf = nmax(mu_s * pa, 1e-20f);
        for (int j = 0; j < 3; ++j) s.em[j] = (s.w[j] * (max_[j] / apdf)) * e[j];
      }
      for (int j = 0; j < 3; ++j) {
        if (scat_now)
          s.w[j] = s.w[j] * (msx[j] / nmax(mu_s * ps, 1e-20f));
        else if (abs_now)
          s.w[j] = 0.0f;
        else
          s.w[j] = s.w[j] * ((mu_s - mtx[j]) / (mu_s * pn));
      }
    }
  }
  s.scat |= scat_now;
  s.absb |= abs_now;
  s.t = nmin(t_new, s.seg);
  s.key = hash_u32(s.key ^ 0x9E3779B9u);
  return exited || scat_now || abs_now || ++s.it >= TRACK_MAX_STEPS;
}

template <bool kGrey, bool kEmit>
__device__ __forceinline__ void interaction_finish(const InteractionArgs& q, const ILane& s) {
  const int64_t i = s.i;
  q.t_out[i] = s.t;
  if (kGrey) {
    q.w_out[i] = s.w[0];
  } else {
    for (int j = 0; j < 3; ++j) q.w_out[3 * i + j] = s.w[j];
  }
  q.scat_out[i] = s.scat;
  q.abs_out[i] = s.absb;
  if (kEmit) {
    for (int j = 0; j < 3; ++j) q.emis_out[3 * i + j] = s.em[j];
  }
}

template <bool kGrey, bool kEmit, bool kRows>
__global__ void __launch_bounds__(TRACK_THREADS,
                                  kGrey || !kEmit ? kMinBlocks : kMinBlocks - 1)
    track_interaction_kernel(InteractionArgs q) {
  constexpr int kWords = InteractionWords<kGrey>::value;
  __shared__ float4 srows[kRows ? TRACK_ROWS_ON_CHIP : 1];
  __shared__ uint4 staged[TRACK_THREADS / 32][32 * kWords / 4];
  __shared__ int pick[TRACK_THREADS / 32][32];
  stage_rows<kRows>(srows, q.a.rows, 0, q.n_rows);
  const RowSrc<kRows> rows{q.a.rows, srows, 0};
  ILane s;
  walk_lanes<kWords>(
      q.next, q.n, reinterpret_cast<uint32_t*>(staged[threadIdx.x / 32]), pick[threadIdx.x / 32],
      [&](int64_t i, uint32_t* col) { return interaction_stage<kGrey, kEmit>(q, i, col); },
      [&](int64_t i, const uint32_t* col) { interaction_start<kGrey>(i, col, s); },
      [&]() {
        if (!interaction_step<kGrey, kEmit, kRows>(q, rows, s)) return false;
        interaction_finish<kGrey, kEmit>(q, s);
        return true;
      });
}

struct TransmittanceArgs {
  TrackArena a;
  const float *lo, *ld, *inv, *t0, *t1, *eps, *o, *d;
  const int32_t* key;
  const uint8_t* inside;
  const float* consts;  // mu_t [3], max(mu_t)
  float *trv_out, *tau_out;
  unsigned long long* next;  // the lane counter, zeroed before the launch
  int64_t n;
  int sparse, prop, grid;
};

// one thread's lane of the transmittance walk
struct TLane {
  int64_t i;
  float lo[3], ld[3], inv[3], o[3], d[3], trv[3];
  float t, t1, eps, tau;
  uint32_t key;
  int it;
};

// a staged transmittance lane: lo, ld, inv, o, d (0-14), t0, t1, eps,
// key (15-18), padded to whole 16-byte words
constexpr int kTransmittanceWords = 20;

template <bool kGrey>
__device__ __forceinline__ bool transmittance_stage(const TransmittanceArgs& q, int64_t i,
                                                    uint32_t* col) {
  if (!__ldg(q.inside + i)) {
    q.tau_out[i] = 0.0f;
    if (kGrey) {
      q.trv_out[i] = 1.0f;
    } else {
      for (int j = 0; j < 3; ++j) q.trv_out[3 * i + j] = 1.0f;
    }
    return false;
  }
  const float* v3[5] = {q.lo, q.ld, q.inv, q.o, q.d};
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) col[3 * k + j] = __float_as_uint(__ldg(v3[k] + 3 * i + j));
  col[15] = __float_as_uint(__ldg(q.t0 + i));
  col[16] = __float_as_uint(__ldg(q.t1 + i));
  col[17] = __float_as_uint(__ldg(q.eps + i));
  col[18] = (uint32_t)__ldg(q.key + i);
  return true;
}

__device__ __forceinline__ void transmittance_start(int64_t i, const uint32_t* col, TLane& s) {
  uint32_t w[kTransmittanceWords];
  read_col(col, w);
  s.i = i;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s.lo[j] = __uint_as_float(w[j]);
    s.ld[j] = __uint_as_float(w[3 + j]);
    s.inv[j] = __uint_as_float(w[6 + j]);
    s.o[j] = __uint_as_float(w[9 + j]);
    s.d[j] = __uint_as_float(w[12 + j]);
    s.trv[j] = 1.0f;
  }
  s.t = __uint_as_float(w[15]);
  s.t1 = __uint_as_float(w[16]);
  s.eps = __uint_as_float(w[17]);
  s.key = w[18];
  s.tau = 0.0f;
  s.it = 0;
}

template <bool kGrey, bool kRows>
__device__ __forceinline__ bool transmittance_step(const TransmittanceArgs& q,
                                                   const RowSrc<kRows>& rows, const GridC& c,
                                                   const Xform& x, const float mu_t[3],
                                                   float mu_t_max, TLane& s) {
  const float u1 = u32_to_float(hash2_u32(s.key, 0u));
  float uvw[3];
  for (int j = 0; j < 3; ++j) uvw[j] = clamp01(fmaf(s.t, s.ld[j], s.lo[j]) + 0.5f);
  const float4 row = rows.row(cell_row(c, uvw));
  const float maj = row.x, mn = row.y;
  const float mu_r = nmax(maj - mn, 0.0f) * mu_t_max;
  const float t_cell = cell_exit(s.t, maj <= 1e-9f ? row.z : 0.0f, s.lo, s.ld, s.inv, c.sd, s.eps);
  const float t_cand = flight(s.t, u1, mu_r);
  const bool crossed = (mu_r <= 1e-9f) || (t_cand > t_cell);
  const float t_new = nmin(crossed ? t_cell : t_cand, s.t1);
  const bool exited = t_new >= s.t1;
  if (!exited && !crossed) {
    float r3[3], p[3];
    jitter(hash2_u32(s.key, 1u), r3);
    for (int j = 0; j < 3; ++j) p[j] = fmaf(t_new, s.d[j], s.o[j]);
    object_uvw<true>(x, p, uvw);
    const float res = nmax(density(q.a.data, rows, c, q.sparse != 0, uvw, r3) - mn, 0.0f);
    const float mu_rs = nmax(mu_r, 1e-12f);
    for (int j = 0; j < (kGrey ? 1 : 3); ++j)
      s.trv[j] = s.trv[j] * nmin(nmax(1.0f - res * mu_t[j] / mu_rs, 0.0f), 1.0f);
  }
  const float trv_max = kGrey ? s.trv[0] : nmax(nmax(s.trv[0], s.trv[1]), s.trv[2]);
  // the minorant's optical depth over the span walked in this cell
  s.tau = s.tau + mn * (t_new - s.t);
  s.t = t_new;
  s.key = hash_u32(s.key ^ 0x85EBCA6Bu);
  return exited || trv_max < 1e-5f || ++s.it >= TRACK_MAX_STEPS;
}

template <bool kGrey>
__device__ __forceinline__ void transmittance_finish(const TransmittanceArgs& q, const TLane& s) {
  q.tau_out[s.i] = s.tau;
  if (kGrey) {
    q.trv_out[s.i] = s.trv[0];
  } else {
    for (int j = 0; j < 3; ++j) q.trv_out[3 * s.i + j] = s.trv[j];
  }
}

template <bool kGrey, bool kRows>
__global__ void __launch_bounds__(TRACK_THREADS, kMinBlocks)
    track_transmittance_kernel(TransmittanceArgs q) {
  __shared__ float4 srows[kRows ? TRACK_ROWS_ON_CHIP : 1];
  __shared__ uint4 staged[TRACK_THREADS / 32][32 * kTransmittanceWords / 4];
  __shared__ int pick[TRACK_THREADS / 32][32];
  // the launch's grid, prop and medium: the same for every lane
  const GridC c = grid_of(q.a, q.grid);
  const Xform x = xform_of<true>(q.a, q.prop);
  const float mu_t[3] = {__ldg(q.consts), __ldg(q.consts + 1), __ldg(q.consts + 2)};
  const float mu_t_max = __ldg(q.consts + 3);
  stage_rows<kRows>(srows, q.a.rows, c.soffset,
                    (int64_t)c.snx * c.sny * __ldg(q.a.sdims + 3 * q.grid + 2));
  const RowSrc<kRows> rows{q.a.rows, srows, c.soffset};
  TLane s;
  walk_lanes<kTransmittanceWords>(
      q.next, q.n, reinterpret_cast<uint32_t*>(staged[threadIdx.x / 32]), pick[threadIdx.x / 32],
      [&](int64_t i, uint32_t* col) { return transmittance_stage<kGrey>(q, i, col); },
      [&](int64_t i, const uint32_t* col) { transmittance_start(i, col, s); },
      [&]() {
        if (!transmittance_step<kGrey, kRows>(q, rows, c, x, mu_t, mu_t_max, s)) return false;
        transmittance_finish<kGrey>(q, s);
        return true;
      });
}

// blocks of a launch over n lanes: the resident grid, or fewer for few lanes;
// and the lane counter zeroed on the stream
cudaError_t prepare(const void* kernel, int64_t n, unsigned long long* next, cudaStream_t st,
                    unsigned* blocks) {
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, TRACK_THREADS, &resident);
  if (err != cudaSuccess) return err;
  const int64_t want = (n + TRACK_THREADS - 1) / TRACK_THREADS;
  *blocks = (unsigned)(want < resident ? want : resident);
  return cudaMemsetAsync(next, 0, sizeof(unsigned long long), st);
}

template <bool kGrey, bool kEmit, bool kRows>
cudaError_t launch_interaction(const InteractionArgs& q, cudaStream_t st) {
  unsigned blocks = 0;
  const cudaError_t err = prepare((const void*)track_interaction_kernel<kGrey, kEmit, kRows>,
                                  q.n, q.next, st, &blocks);
  if (err != cudaSuccess) return err;
  track_interaction_kernel<kGrey, kEmit, kRows><<<blocks, TRACK_THREADS, 0, st>>>(q);
  return cudaGetLastError();
}

template <bool kGrey, bool kRows>
cudaError_t launch_transmittance(const TransmittanceArgs& q, cudaStream_t st) {
  unsigned blocks = 0;
  const cudaError_t err = prepare((const void*)track_transmittance_kernel<kGrey, kRows>, q.n,
                                  q.next, st, &blocks);
  if (err != cudaSuccess) return err;
  track_transmittance_kernel<kGrey, kRows><<<blocks, TRACK_THREADS, 0, st>>>(q);
  return cudaGetLastError();
}

TrackArena arena_of(void** p) {
  TrackArena a;
  a.data = (const float*)p[0];
  a.dims = (const int32_t*)p[1];
  a.rows = (const float4*)p[2];
  a.soffset = (const int32_t*)p[3];
  a.sdims = (const int32_t*)p[4];
  a.brick_base = (const int32_t*)p[5];
  a.rot = (const float*)p[6];
  a.pos = (const float*)p[7];
  a.scale = (const float*)p[8];
  return a;
}

// rows: stage the supergrid in shared memory (all n_rows rows must fit)
bool rows_refused(int rows, int64_t n_rows) {
  return rows && (n_rows < 1 || n_rows > TRACK_ROWS_ON_CHIP);
}

}  // namespace

// ptrs: the arena and prop tables (9), then lo, ld, inv, seg, mu_t_max,
// grid, eps, o, d, mp, key, mu_t, mu_s, then t, w, scatter, absorb, then
// e_med and the emission (null unless emit), then the lane counter (one
// uint64 of scratch); n_rows: the supergrid's rows
extern "C" int zyg_track_interaction(void** ptrs, int grey, int sparse, int emit, int rows,
                                     int64_t n_rows, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  InteractionArgs q;
  q.a = arena_of(ptrs);
  void** l = ptrs + 9;
  q.lo = (const float*)l[0];
  q.ld = (const float*)l[1];
  q.inv = (const float*)l[2];
  q.seg = (const float*)l[3];
  q.mu_t_max = (const float*)l[4];
  q.grid = (const int32_t*)l[5];
  q.eps = (const float*)l[6];
  q.o = (const float*)l[7];
  q.d = (const float*)l[8];
  q.mp = (const int32_t*)l[9];
  q.key = (const int32_t*)l[10];
  q.mu_t = (const float*)l[11];
  q.mu_s = (const float*)l[12];
  q.t_out = (float*)l[13];
  q.w_out = (float*)l[14];
  q.scat_out = (uint8_t*)l[15];
  q.abs_out = (uint8_t*)l[16];
  q.e_med = (const float*)l[17];
  q.emis_out = (float*)l[18];
  q.next = (unsigned long long*)l[19];
  q.n = n;
  q.n_rows = n_rows;
  q.sparse = sparse;
  if (emit && (q.e_med == nullptr || q.emis_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (q.next == nullptr || rows_refused(rows, n_rows)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q.a.rows & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (grey)
    err = emit ? (rows ? launch_interaction<true, true, true>(q, st)
                       : launch_interaction<true, true, false>(q, st))
               : (rows ? launch_interaction<true, false, true>(q, st)
                       : launch_interaction<true, false, false>(q, st));
  else
    err = emit ? (rows ? launch_interaction<false, true, true>(q, st)
                       : launch_interaction<false, true, false>(q, st))
               : (rows ? launch_interaction<false, false, true>(q, st)
                       : launch_interaction<false, false, false>(q, st));
  return (int)err;
}

// ptrs: the arena and prop tables (9), then lo, ld, inv, t0, t1, eps, o,
// d, key, inside, consts, then trv, tau, then the lane counter (one uint64
// of scratch); n_rows: the supergrid's rows
extern "C" int zyg_track_transmittance(void** ptrs, int grey, int sparse, int rows,
                                       int64_t n_rows, int prop, int grid, int64_t n,
                                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  TransmittanceArgs q;
  q.a = arena_of(ptrs);
  void** l = ptrs + 9;
  q.lo = (const float*)l[0];
  q.ld = (const float*)l[1];
  q.inv = (const float*)l[2];
  q.t0 = (const float*)l[3];
  q.t1 = (const float*)l[4];
  q.eps = (const float*)l[5];
  q.o = (const float*)l[6];
  q.d = (const float*)l[7];
  q.key = (const int32_t*)l[8];
  q.inside = (const uint8_t*)l[9];
  q.consts = (const float*)l[10];
  q.trv_out = (float*)l[11];
  q.tau_out = (float*)l[12];
  q.next = (unsigned long long*)l[13];
  q.n = n;
  q.sparse = sparse;
  q.prop = prop;
  q.grid = grid;
  if (q.next == nullptr || rows_refused(rows, n_rows)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q.a.rows & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (grey)
    err = rows ? launch_transmittance<true, true>(q, st) : launch_transmittance<true, false>(q, st);
  else
    err = rows ? launch_transmittance<false, true>(q, st) : launch_transmittance<false, false>(q, st);
  return (int)err;
}
