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
// tentative collision, one 4-byte voxel (both mostly from L2: the smoke
// arena is ~1 MB) and spends ~150 float and integer operations on three
// counter hashes, the cell walls and the transforms. The step count is
// data dependent (a few to a few hundred), so the kernel is latency bound
// on its dependent row and voxel reads rather than on bytes or flops.
// Design: one thread walks one lane to its end; there is no compaction
// cascade (the JAX package's _TRACK_MIN), since a warp retires when its
// lanes finish and a long walk holds only its own warp. The voxel is read
// only at a tentative collision (the plain version reads it on every
// lane and masks it). Dense arenas compute the page (brick_base + cell);
// sparse arenas read it from the row's page column. The emission is a
// template flag (kEmit): a medium that does not emit runs the walk without
// it, and an emissive one reads its lane's e (12 bytes) only at the
// absorption that ends the walk and writes 12 bytes of emission a lane.
//
// Numerics: built with -fmad=false; fmaf exactly where the plain version
// (and XLA) fuse: lo + t * ld, o + t * d, the transform's dot products,
// and uvw * dims - 0.5. Precise logf, IEEE division, rintf for
// round-half-even. Min, max and clamp propagate NaN as torch's do, and a
// NaN index is 0, as the plain version's nan_to_num makes it.
#include <cuda_runtime.h>
#include <stdint.h>

#define TRACK_SUPER 8
#define TRACK_MAX_STEPS 16384
#define TRACK_THREADS 128

struct TrackArena {
  const float* data;  // brick pool
  const int32_t* dims;  // [G, 3]
  const float* sdata;  // [Ts, 4] majorant, minorant, free radius, page
  const int32_t* soffset;  // [G]
  const int32_t* sdims;  // [G, 3]
  const int32_t* brick_base;  // [G]
  const float* rot;  // [P, 3, 3] prop rotation rows
  const float* pos;  // [P, 3]
  const float* scale;  // [P, 3]
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

// the supergrid row of the macrocell holding uvw (grids._cell_flat)
__device__ __forceinline__ int64_t cell_row(const TrackArena& a, int g, const float uvw[3]) {
  int vox[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dim = (float)a.dims[3 * g + j];
    vox[j] = clip_index(uvw[j] * dim, dim - 1.0f) / TRACK_SUPER;
  }
  const int64_t snx = a.sdims[3 * g], sny = a.sdims[3 * g + 1];
  return (int64_t)a.soffset[g] + ((int64_t)vox[2] * sny + vox[1]) * snx + vox[0];
}

// one jittered nearest-voxel read (grids.sample_density_stochastic)
__device__ __forceinline__ float density(const TrackArena& a, int g, bool sparse,
                                         const float uvw[3], const float r[3]) {
  int idx[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dim = (float)a.dims[3 * g + j];
    const float c = fmaf(uvw[j], dim, -0.5f) + (r[j] - 0.5f);
    idx[j] = clip_index(rintf(c), dim - 1.0f);
  }
  const int64_t snx = a.sdims[3 * g], sny = a.sdims[3 * g + 1];
  const int64_t cellloc = ((int64_t)(idx[2] / TRACK_SUPER) * sny + idx[1] / TRACK_SUPER) * snx
                          + idx[0] / TRACK_SUPER;
  const int64_t page = sparse ? (int64_t)a.sdata[4 * ((int64_t)a.soffset[g] + cellloc) + 3]
                              : (int64_t)a.brick_base[g] + cellloc;
  const int64_t local = ((int64_t)(idx[2] % TRACK_SUPER) * TRACK_SUPER + idx[1] % TRACK_SUPER)
                        * TRACK_SUPER + idx[0] % TRACK_SUPER;
  return a.data[page * (TRACK_SUPER * TRACK_SUPER * TRACK_SUPER) + local];
}

// unit-cube coordinates of world point p in prop `prop` (track.object_uvw)
__device__ __forceinline__ void object_uvw(const TrackArena& a, int prop, bool recip,
                                           const float p[3], float uvw[3]) {
  const float* r = a.rot + 9 * prop;
  const float v0 = p[0] - a.pos[3 * prop], v1 = p[1] - a.pos[3 * prop + 1],
              v2 = p[2] - a.pos[3 * prop + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float l = fmaf(v2, r[3 * i + 2], fmaf(v1, r[3 * i + 1], v0 * r[3 * i]));
    const float s = a.scale[3 * prop + i];
    uvw[i] = clamp01((recip ? l * (1.0f / s) : l / s) + 0.5f);
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
  v[0] = x[3 * i];
  v[1] = x[3 * i + 1];
  v[2] = x[3 * i + 2];
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
  int64_t n;
  int sparse;
};

template <bool kGrey, bool kEmit>
__global__ void __launch_bounds__(TRACK_THREADS) track_interaction_kernel(InteractionArgs q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.n) return;
  const int g = q.grid[i];
  float t = 0.0f;
  float w[3] = {1.0f, 1.0f, 1.0f};
  float em[3] = {0.0f, 0.0f, 0.0f};
  bool scat = false, absb = false;
  if (g >= 0) {
    const TrackArena& a = q.a;
    float lo[3], ld[3], inv[3], o[3], d[3], sd[3], mt[3], ms[3];
    load3(q.lo, i, lo);
    load3(q.ld, i, ld);
    load3(q.inv, i, inv);
    load3(q.o, i, o);
    load3(q.d, i, d);
    for (int j = 0; j < 3; ++j) sd[j] = (float)a.sdims[3 * g + j];
    if (kGrey) {
      mt[0] = q.mu_t[i];
      ms[0] = q.mu_s[i];
    } else {
      load3(q.mu_t, i, mt);
      load3(q.mu_s, i, ms);
    }
    const float seg = q.seg[i], mu_t_max = q.mu_t_max[i], eps = q.eps[i];
    const int mp = q.mp[i];
    const bool sparse = q.sparse != 0;
    uint32_t key = (uint32_t)q.key[i];
    for (int it = 0; it < TRACK_MAX_STEPS; ++it) {
      const float u1 = u32_to_float(hash2_u32(key, 0u));
      const float u2 = u32_to_float(hash2_u32(key, 1u));
      float uvw[3];
      for (int j = 0; j < 3; ++j) uvw[j] = clamp01(fmaf(t, ld[j], lo[j]) + 0.5f);
      const float4 row = *reinterpret_cast<const float4*>(a.sdata + 4 * cell_row(a, g, uvw));
      const float mu_loc = row.x * mu_t_max;
      const bool empty = mu_loc <= 1e-9f;
      const float t_cell = cell_exit(t, empty ? row.z : 0.0f, lo, ld, inv, sd, eps);
      const float t_cand = flight(t, u1, mu_loc);
      const bool crossed = empty || (t_cand > t_cell);
      const float t_new = crossed ? t_cell : t_cand;
      const bool exited = t_new >= seg;
      const bool collide = !exited && !crossed;
      bool scat_now = false, abs_now = false;
      if (collide) {
        float r3[3], p[3];
        jitter(hash2_u32(key, 2u), r3);
        for (int j = 0; j < 3; ++j) p[j] = fmaf(t_new, d[j], o[j]);
        object_uvw(a, mp, false, p, uvw);
        const float dens = density(a, g, sparse, uvw, r3);
        const float mu_s = nmax(mu_loc, 1e-12f);
        if (kGrey) {
          const float ps = dens * ms[0] / mu_s;
          const float pa = dens * (mt[0] - ms[0]) / mu_s;
          scat_now = u2 < ps;
          abs_now = !scat_now && (u2 < ps + pa);
          if (kEmit && abs_now) load3(q.e_med, i, em);
        } else {
          float mtx[3], msx[3], max_[3];
          for (int j = 0; j < 3; ++j) {
            mtx[j] = dens * mt[j];
            msx[j] = dens * ms[j];
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
            load3(q.e_med, i, e);
            const float apdf = nmax(mu_s * pa, 1e-20f);
            for (int j = 0; j < 3; ++j) em[j] = (w[j] * (max_[j] / apdf)) * e[j];
          }
          for (int j = 0; j < 3; ++j) {
            if (scat_now)
              w[j] = w[j] * (msx[j] / nmax(mu_s * ps, 1e-20f));
            else if (abs_now)
              w[j] = 0.0f;
            else
              w[j] = w[j] * ((mu_s - mtx[j]) / (mu_s * pn));
          }
        }
      }
      scat |= scat_now;
      absb |= abs_now;
      t = nmin(t_new, seg);
      key = hash_u32(key ^ 0x9E3779B9u);
      if (exited || scat_now || abs_now) break;
    }
  }
  q.t_out[i] = t;
  if (kGrey) {
    q.w_out[i] = w[0];
  } else {
    for (int j = 0; j < 3; ++j) q.w_out[3 * i + j] = w[j];
  }
  q.scat_out[i] = scat;
  q.abs_out[i] = absb;
  if (kEmit) {
    for (int j = 0; j < 3; ++j) q.emis_out[3 * i + j] = em[j];
  }
}

struct TransmittanceArgs {
  TrackArena a;
  const float *lo, *ld, *inv, *t0, *t1, *eps, *o, *d;
  const int32_t* key;
  const uint8_t* inside;
  const float* consts;  // mu_t [3], max(mu_t)
  float *trv_out, *tau_out;
  int64_t n;
  int sparse, prop, grid;
};

template <bool kGrey>
__global__ void __launch_bounds__(TRACK_THREADS) track_transmittance_kernel(TransmittanceArgs q) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.n) return;
  float trv[3] = {1.0f, 1.0f, 1.0f};
  float tau = 0.0f;
  if (q.inside[i]) {
    const TrackArena& a = q.a;
    const int g = q.grid;
    float lo[3], ld[3], inv[3], o[3], d[3], sd[3];
    load3(q.lo, i, lo);
    load3(q.ld, i, ld);
    load3(q.inv, i, inv);
    load3(q.o, i, o);
    load3(q.d, i, d);
    for (int j = 0; j < 3; ++j) sd[j] = (float)a.sdims[3 * g + j];
    const float mu_t[3] = {q.consts[0], q.consts[1], q.consts[2]};
    const float mu_t_max = q.consts[3];
    const float t1 = q.t1[i], eps = q.eps[i];
    const bool sparse = q.sparse != 0;
    float t = q.t0[i];
    uint32_t key = (uint32_t)q.key[i];
    for (int it = 0; it < TRACK_MAX_STEPS; ++it) {
      const float u1 = u32_to_float(hash2_u32(key, 0u));
      float uvw[3];
      for (int j = 0; j < 3; ++j) uvw[j] = clamp01(fmaf(t, ld[j], lo[j]) + 0.5f);
      const float4 row = *reinterpret_cast<const float4*>(a.sdata + 4 * cell_row(a, g, uvw));
      const float maj = row.x, mn = row.y;
      const float mu_r = nmax(maj - mn, 0.0f) * mu_t_max;
      const float t_cell = cell_exit(t, maj <= 1e-9f ? row.z : 0.0f, lo, ld, inv, sd, eps);
      const float t_cand = flight(t, u1, mu_r);
      const bool crossed = (mu_r <= 1e-9f) || (t_cand > t_cell);
      const float t_new = nmin(crossed ? t_cell : t_cand, t1);
      const bool exited = t_new >= t1;
      if (!exited && !crossed) {
        float r3[3], p[3];
        jitter(hash2_u32(key, 1u), r3);
        for (int j = 0; j < 3; ++j) p[j] = fmaf(t_new, d[j], o[j]);
        object_uvw(a, q.prop, true, p, uvw);
        const float res = nmax(density(a, g, sparse, uvw, r3) - mn, 0.0f);
        const float mu_rs = nmax(mu_r, 1e-12f);
        for (int j = 0; j < (kGrey ? 1 : 3); ++j)
          trv[j] = trv[j] * nmin(nmax(1.0f - res * mu_t[j] / mu_rs, 0.0f), 1.0f);
      }
      const float trv_max = kGrey ? trv[0] : nmax(nmax(trv[0], trv[1]), trv[2]);
      // the minorant's optical depth over the span walked in this cell
      tau = tau + mn * (t_new - t);
      t = t_new;
      key = hash_u32(key ^ 0x85EBCA6Bu);
      if (exited || trv_max < 1e-5f) break;
    }
  }
  q.tau_out[i] = tau;
  if (kGrey) {
    q.trv_out[i] = trv[0];
  } else {
    for (int j = 0; j < 3; ++j) q.trv_out[3 * i + j] = trv[j];
  }
}

static TrackArena arena_of(void** p) {
  TrackArena a;
  a.data = (const float*)p[0];
  a.dims = (const int32_t*)p[1];
  a.sdata = (const float*)p[2];
  a.soffset = (const int32_t*)p[3];
  a.sdims = (const int32_t*)p[4];
  a.brick_base = (const int32_t*)p[5];
  a.rot = (const float*)p[6];
  a.pos = (const float*)p[7];
  a.scale = (const float*)p[8];
  return a;
}

// ptrs: the arena and prop tables (9), then lo, ld, inv, seg, mu_t_max,
// grid, eps, o, d, mp, key, mu_t, mu_s, then t, w, scatter, absorb, then
// e_med and the emission (null unless emit)
extern "C" int zyg_track_interaction(void** ptrs, int grey, int sparse, int emit, int64_t n,
                                     void* stream) {
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
  q.n = n;
  q.sparse = sparse;
  if (emit && (q.e_med == nullptr || q.emis_out == nullptr)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + TRACK_THREADS - 1) / TRACK_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (grey && emit)
    track_interaction_kernel<true, true><<<blocks, TRACK_THREADS, 0, st>>>(q);
  else if (grey)
    track_interaction_kernel<true, false><<<blocks, TRACK_THREADS, 0, st>>>(q);
  else if (emit)
    track_interaction_kernel<false, true><<<blocks, TRACK_THREADS, 0, st>>>(q);
  else
    track_interaction_kernel<false, false><<<blocks, TRACK_THREADS, 0, st>>>(q);
  return (int)cudaGetLastError();
}

// ptrs: the arena and prop tables (9), then lo, ld, inv, t0, t1, eps, o,
// d, key, inside, consts, then trv, tau
extern "C" int zyg_track_transmittance(void** ptrs, int grey, int sparse, int prop, int grid,
                                       int64_t n, void* stream) {
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
  q.n = n;
  q.sparse = sparse;
  q.prop = prop;
  q.grid = grid;
  const unsigned blocks = (unsigned)((n + TRACK_THREADS - 1) / TRACK_THREADS);
  if (grey)
    track_transmittance_kernel<true><<<blocks, TRACK_THREADS, 0, (cudaStream_t)stream>>>(q);
  else
    track_transmittance_kernel<false><<<blocks, TRACK_THREADS, 0, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
