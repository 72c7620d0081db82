// Per-pixel sample flushes of the persistent wavefront, box and filtered.
//
// Box (accum_kernel): for every lane i whose path ended in this launch
// (was_alive[i] && !alive[i]),
//
//     fb[pid[i]] += (clamp(e_i, c0) + clamp(d_i, c1) + clamp(x_i, c2), 1)
//
// with e, d, x the lane's emission, direct and indirect radiance, in place.
//
// Replaces the TPU kernel zyg_tpu/ops/accum.py::_flush_kernel (launched by
// flush_columns through _flush_pallas, pallas_call at :57) together with
// the affine unpermute after the loop (zyg_tpu/render/integrator/
// ptmis.py:1465-1503). A TPU scatter by pixel id cost ~80 ms an iteration
// (ptmis.py:1143-1152), so the TPU flushes each sample into a per-lane
// [4*kmax, N] column buffer and puts the columns back on their pixels with
// circular shifts once per dispatch. Hopper scatters natively and has
// vector atomics, so each finished sample goes straight to its pixel's
// float4 [R, G, B, count] row, as the reference's sensor adds samples
// (sensor.zig addSample).
//
// What bounds it on an H100: bytes. Every lane reads its pid (8 B) and its
// two masks (2 B); a finishing lane reads its three radiance rows (36 B)
// and adds one float4 with a single vector atomic. The [N, 4]
// framebuffer (33 MB at 1080p) stays in the 50 MB L2, so the atomics
// resolve there and do not reach device memory per launch.
//
// Two lanes of one launch can finish samples of the same pixel (sample k
// and sample k' of a pixel sit on different lanes under the affine
// shuffle); the order of their float adds then varies from run to run, and
// RGB agrees with an ordered sum to about kmax float32 epsilons. Counts are
// small integers in float32 and exact in any order.
#include <cstdint>
#include <cuda_runtime.h>

struct AccumArgs {
  float* fb;  // [rows, 4]: R, G, B, sample count
  const int64_t* pid;  // [n] the lane's pixel, in [0, rows)
  const uint8_t* was_alive;  // [n] bool
  const uint8_t* alive;  // [n] bool
  const float* rad[3];  // emission, direct, indirect: [n, 3] rows
  int64_t rad_stride[3];  // row strides in floats
  float clamp[3];  // per-class clamp limits (inf = none)
  int64_t n;
};

// torch.clamp(x, max=m): NaN stays NaN, an infinite m changes nothing
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }

__global__ void accum_kernel(AccumArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n || !a.was_alive[i] || a.alive[i]) return;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // the JAX integrator's clamp_cur order: (emission + direct) + indirect
    const float e = clamp_max(a.rad[0][i * a.rad_stride[0] + c], a.clamp[0]);
    const float d = clamp_max(a.rad[1][i * a.rad_stride[1] + c], a.clamp[1]);
    const float x = clamp_max(a.rad[2][i * a.rad_stride[2] + c], a.clamp[2]);
    v[c] = (e + d) + x;
  }
  // one REDG.E.ADD.F32x4 (sm_90); four scalar adds measured 1.3-1.7x slower
  atomicAdd(reinterpret_cast<float4*>(a.fb + 4 * a.pid[i]), make_float4(v[0], v[1], v[2], 1.0f));
}

// rad: 3 pointers, strides: 3 row strides, clamp: 3 limits
extern "C" int zyg_flush_pixels(void* fb, const void* pid, const void* was_alive,
                                const void* alive, const void** rad, const int64_t* strides,
                                const float* clamp, int64_t n, void* stream) {
  AccumArgs a;
  a.fb = (float*)fb;
  a.pid = (const int64_t*)pid;
  a.was_alive = (const uint8_t*)was_alive;
  a.alive = (const uint8_t*)alive;
  for (int c = 0; c < 3; ++c) {
    a.rad[c] = (const float*)rad[c];
    a.rad_stride[c] = strides[c];
    a.clamp[c] = clamp[c];
  }
  a.n = n;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  accum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Filtered flush (accum_filtered_kernel): every finishing lane splats its
// clamped sample into the (2r+1)^2 pixels around its own, r in {1, 2}:
//
//     fb[t] += (rgb * w, w),  w = f(su - dx) * f(sv - dy),
//
// with (su, sv) = sub_uv - 0.5 the sample's offset from the pixel centre, f
// the Blackman or Mitchell filter and t the pixel at (dx, dy) from the
// sample's. Two footprint rules: taps past the frame or the dispatch are
// dropped with their weights (the persistent path, so border pixels
// renormalize exactly), or clamped onto the frame's edge (the scan path's
// splat_filtered).
//
// Replaces, together, the TPU kernel zyg_tpu/ops/accum.py::_flush_kernel
// (flush_columns, pallas_call at :57) on the shuffled filtered path with
// its filtered unpermute and the drain stages' scatter-splats
// (zyg_tpu/render/integrator/ptmis.py:1465-1528), and the unshuffled
// in-loop rolled splat (:1359-1378), and zyg_tpu/render/sensor.py:111-147.
// The TPU could not scatter, so it kept each sample in a per-lane column
// buffer and rolled every footprint tap into place after the loop,
// recomputing the subpixel offset from the seeding law. Hopper scatters
// natively: the lane carries its offset (8 B) and adds each tap to its
// pixel's float4 row with one vector atomic, as the box flush does.
//
// What bounds it on an H100: the atomics. At Cornell 1080p's finish share
// of 0.2005 and r = 2, a launch adds ~10.4 M float4 rows into the 33 MB
// framebuffer, which stays in the 50 MB L2; the device-memory traffic
// (pid and masks of every lane, radiance and offset of the finishing
// ones) is ~39 MB. How fast the L2 takes the atomics depends on how many
// 128-byte lines one warp-wide atomic instruction touches.
//
// Design: two mappings of taps to threads, each a template instantiation
// for the radius (1, 2) and the filter (Blackman, Mitchell), so the
// weights live in registers.
//   Tap-major (the persistent path's shuffled and unshuffled dispatches,
//     where a fifth of the lanes finish, each on an unrelated pixel): a
//     warp finds its finishing lanes with __ballot_sync and walks them.
//     Each finishing lane computes its clamped RGB sum and its separable
//     weights wx, wy once; the warp's threads take the taps of the next
//     32 / (2r+1)^2 samples (one at r = 2, three at r = 1), thread t tap
//     (t / (2r+1), t % (2r+1)) of its sample, and fetch the sample's
//     values with shuffles. So one atomic instruction adds 2r+1 runs of
//     2r+1 consecutive float4 rows (80 B a run at r = 2): about 2(2r+1)
//     lines, where a lane a thread touches up to 32.
//   Lane-major (the scan path's splat, every lane finished, lane i on
//     pixel i): one thread a lane adds its taps one after another; one
//     instruction then adds 32 consecutive rows, about 4 lines.
// The wrapper picks the mapping from its arguments (ops/accum.py).
//
// Rounding: the filters round as the plain versions in
// render/sensor.py, which round as XLA rounds the JAX formulas (fmaf
// where XLA fuses, built with -fmad=false); cosf is the function torch
// calls on the card. The order of the float adds into a pixel varies
// from run to run: RGB agrees with an ordered sum to float32 rounding of
// the pixel's taps, weights likewise (they are not integers here).

struct FilteredArgs {
  float* fb;  // [rows, 4]: R, G, B, weight
  int64_t rows;
  const int64_t* pid;  // [n] the lane's local pixel
  const uint8_t* was_alive;  // [n] bool, or null: every lane finished
  const uint8_t* alive;  // [n] bool, or null
  const float* rad[3];  // up to three [n, 3] radiance planes
  int64_t rad_stride[3];
  float clamp[3];
  int nplanes;
  const float* sub_uv;  // [n, 2] subpixel offsets in [0, 1)
  int64_t n, base, width, height;  // base: the global pixel of local row 0
  int clamp_edge;  // 1: clamp taps onto the frame, 0: drop them
};

// render/sensor.py::blackman: fmaf(0.08, cos(2a), 0.42 + 0.5 cos(a))
__device__ __forceinline__ float blackman_w(float x, float r) {
  const float a = (x / r) * 0x1.921fb6p+1f;  // float32(pi)
  const float w = fmaf(0x1.47ae14p-4f, cosf(2.0f * a), 0x1.ae147ap-2f + 0.5f * cosf(a));
  return fabsf(x) <= r ? w : 0.0f;
}

// render/sensor.py::mitchell (B = C = 1/3), coefficients as float32
__device__ __forceinline__ float mitchell_w(float x) {
  const float ax = fabsf(x);
  const float ax2 = ax * ax;
  const float ax3 = ax2 * ax;
  const float sixth = 0x1.555556p-3f;
  if (ax < 1.0f) return (fmaf(7.0f, ax3, -12.0f * ax2) + 0x1.555556p+2f) * sixth;
  if (ax < 2.0f)
    return (fmaf(-20.0f, ax, fmaf(-0x1.2aaaaap+1f, ax3, 12.0f * ax2)) + 0x1.555556p+3f) * sixth;
  return 0.0f;
}

enum : int { kBlackman = 0, kMitchell = 1 };  // ops/accum.py FILTERS

template <int F, int R>
__device__ __forceinline__ float filter_w(float x) {
  const float r = (float)R;
  return F == kMitchell ? mitchell_w(x * (2.0f / r)) : blackman_w(x, r);
}

__device__ __forceinline__ int64_t clamp_index(int64_t x, int64_t size) {
  return x < 0 ? 0 : (x >= size ? size - 1 : x);
}

// One finishing lane's sample: its clamped RGB sum, its weights along x
// and y (tap k at offset k - R), its local pixel and the global pixel's
// column and row.
template <int R>
struct Sample {
  float v[3];
  float wx[2 * R + 1], wy[2 * R + 1];
  int64_t p, gx, gy;
};

template <int F, int R>
__device__ __forceinline__ Sample<R> load_sample(const FilteredArgs& a, int64_t i) {
  Sample<R> s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // (emission + direct) + indirect, as the box flush
    float acc = clamp_max(a.rad[0][i * a.rad_stride[0] + c], a.clamp[0]);
#pragma unroll
    for (int k = 1; k < 3; ++k)
      if (k < a.nplanes) acc = acc + clamp_max(a.rad[k][i * a.rad_stride[k] + c], a.clamp[k]);
    s.v[c] = acc;
  }
  const float su = a.sub_uv[2 * i] - 0.5f;
  const float sv = a.sub_uv[2 * i + 1] - 0.5f;
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) {
    s.wx[k] = filter_w<F, R>(su - (float)(k - R));
    s.wy[k] = filter_w<F, R>(sv - (float)(k - R));
  }
  s.p = a.pid[i];
  const int64_t g = a.base + s.p;
  s.gx = g % a.width;
  s.gy = g / a.width;
  return s;
}

// tap (dx, dy) of a sample at local pixel p (global column gx, row gy):
// its local row, or -1 where the footprint rule drops it
__device__ __forceinline__ int64_t tap_row(const FilteredArgs& a, int64_t p, int64_t gx,
                                           int64_t gy, int dx, int dy) {
  int64_t t;
  if (a.clamp_edge) {
    t = clamp_index(gy + dy, a.height) * a.width + clamp_index(gx + dx, a.width) - a.base;
  } else {
    if (gx + dx < 0 || gx + dx >= a.width || gy + dy < 0 || gy + dy >= a.height) return -1;
    t = p + dy * a.width + dx;
  }
  return t < 0 || t >= a.rows ? -1 : t;
}

__device__ __forceinline__ void add_tap(const FilteredArgs& a, int64_t t, const float* v,
                                        float w) {
  atomicAdd(reinterpret_cast<float4*>(a.fb + 4 * t),
            make_float4(v[0] * w, v[1] * w, v[2] * w, w));
}

template <int F, int R, bool kTapMajor>
__global__ void __launch_bounds__(256) accum_filtered_kernel(FilteredArgs a) {
  constexpr int D = 2 * R + 1;  // taps a row
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool fin =
      i < a.n && (a.was_alive == nullptr || (a.was_alive[i] && !a.alive[i]));
  if (!kTapMajor) {
    if (!fin) return;
    const Sample<R> s = load_sample<F, R>(a, i);
#pragma unroll
    for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
      for (int dx = -R; dx <= R; ++dx) {
        const int64_t t = tap_row(a, s.p, s.gx, s.gy, dx, dy);
        if (t >= 0) add_tap(a, t, s.v, s.wx[dx + R] * s.wy[dy + R]);
      }
    }
    return;
  }
  // tap-major: the whole warp walks its finishing lanes, so no thread
  // leaves before the ballot (the block is whole warps)
  constexpr int kPer = 32 / (D * D);  // samples an instruction: 1 at r = 2, 3 at r = 1
  Sample<R> s = {};
  if (fin) s = load_sample<F, R>(a, i);
  const int lane = threadIdx.x & 31;
  const int q = lane / (D * D);  // this thread's sample of the kPer; q == kPer: idle
  const int tap = lane % (D * D);
  const int ix = tap % D, iy = tap / D;
  unsigned todo = __ballot_sync(0xffffffffu, fin);
  while (todo) {
    // the next kPer finishing lanes; src < 0: none for this thread
    int src = -1;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int next = todo ? __ffs(todo) - 1 : -1;
      src = q == k ? next : src;
      todo &= todo - 1u;
    }
    const int from = src < 0 ? lane : src;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __shfl_sync(0xffffffffu, s.v[c], from);
    float wx = 0.0f, wy = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float x = __shfl_sync(0xffffffffu, s.wx[k], from);
      const float y = __shfl_sync(0xffffffffu, s.wy[k], from);
      wx = ix == k ? x : wx;
      wy = iy == k ? y : wy;
    }
    const int64_t p = __shfl_sync(0xffffffffu, s.p, from);
    const int64_t gx = __shfl_sync(0xffffffffu, s.gx, from);
    const int64_t gy = __shfl_sync(0xffffffffu, s.gy, from);
    if (src >= 0) {
      const int64_t t = tap_row(a, p, gx, gy, ix - R, iy - R);
      if (t >= 0) add_tap(a, t, v, wx * wy);
    }
  }
}

template <int F, int R>
cudaError_t launch_filtered(const FilteredArgs& a, bool tap_major, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
  if (tap_major)
    accum_filtered_kernel<F, R, true><<<blocks, threads, 0, stream>>>(a);
  else
    accum_filtered_kernel<F, R, false><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// rad: nplanes pointers, strides: their row strides, clamp: their limits;
// filter: 0 Blackman, 1 Mitchell; tap_major: 1 the warp's threads share a
// sample's taps, 0 one thread a lane
extern "C" int zyg_flush_filtered(void* fb, int64_t rows, const void* pid, const void* was_alive,
                                  const void* alive, const void** rad, const int64_t* strides,
                                  const float* clamp, int nplanes, const void* sub_uv, int64_t n,
                                  int64_t base, int64_t width, int64_t height, int filter,
                                  int radius, int clamp_edge, int tap_major, void* stream) {
  if (nplanes < 1 || nplanes > 3 || radius < 1 || radius > 2 || width < 1 || height < 1 ||
      (filter != kBlackman && filter != kMitchell))
    return (int)cudaErrorInvalidValue;
  FilteredArgs a;
  a.fb = (float*)fb;
  a.rows = rows;
  a.pid = (const int64_t*)pid;
  a.was_alive = (const uint8_t*)was_alive;
  a.alive = (const uint8_t*)alive;
  for (int c = 0; c < 3; ++c) {
    a.rad[c] = c < nplanes ? (const float*)rad[c] : nullptr;
    a.rad_stride[c] = c < nplanes ? strides[c] : 0;
    a.clamp[c] = c < nplanes ? clamp[c] : 0.0f;
  }
  a.nplanes = nplanes;
  a.sub_uv = (const float*)sub_uv;
  a.n = n;
  a.base = base;
  a.width = width;
  a.height = height;
  a.clamp_edge = clamp_edge;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool tm = tap_major != 0;
  cudaError_t err;
  if (filter == kMitchell)
    err = radius == 2 ? launch_filtered<kMitchell, 2>(a, tm, st)
                      : launch_filtered<kMitchell, 1>(a, tm, st);
  else
    err = radius == 2 ? launch_filtered<kBlackman, 2>(a, tm, st)
                      : launch_filtered<kBlackman, 1>(a, tm, st);
  return (int)err;
}
