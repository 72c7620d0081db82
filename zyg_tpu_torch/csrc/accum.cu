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
// ones) is ~39 MB.
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
  int filter;  // 0 Blackman, 1 Mitchell
  int radius;  // 1 or 2
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

__device__ __forceinline__ float filter_w(int filter, float x, float r) {
  return filter == 1 ? mitchell_w(x * (2.0f / r)) : blackman_w(x, r);
}

__device__ __forceinline__ int64_t clamp_index(int64_t x, int64_t size) {
  return x < 0 ? 0 : (x >= size ? size - 1 : x);
}

__global__ void accum_filtered_kernel(FilteredArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if (a.was_alive != nullptr && (!a.was_alive[i] || a.alive[i])) return;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // (emission + direct) + indirect, as the box flush
    float acc = clamp_max(a.rad[0][i * a.rad_stride[0] + c], a.clamp[0]);
    for (int k = 1; k < a.nplanes; ++k)
      acc = acc + clamp_max(a.rad[k][i * a.rad_stride[k] + c], a.clamp[k]);
    v[c] = acc;
  }
  const int R = a.radius;
  const float r = (float)R;
  const float su = a.sub_uv[2 * i] - 0.5f;
  const float sv = a.sub_uv[2 * i + 1] - 0.5f;
  float wx[5], wy[5];
  for (int k = 0; k <= 2 * R; ++k) {
    wx[k] = filter_w(a.filter, su - (float)(k - R), r);
    wy[k] = filter_w(a.filter, sv - (float)(k - R), r);
  }
  const int64_t p = a.pid[i];
  const int64_t g = a.base + p;
  const int64_t gx = g % a.width, gy = g / a.width;
  for (int dy = -R; dy <= R; ++dy) {
    for (int dx = -R; dx <= R; ++dx) {
      int64_t t;
      if (a.clamp_edge) {
        const int64_t tx = clamp_index(gx + dx, a.width);
        const int64_t ty = clamp_index(gy + dy, a.height);
        t = ty * a.width + tx - a.base;
      } else {
        if (gx + dx < 0 || gx + dx >= a.width || gy + dy < 0 || gy + dy >= a.height) continue;
        t = p + dy * a.width + dx;
      }
      if (t < 0 || t >= a.rows) continue;
      const float w = wx[dx + R] * wy[dy + R];
      atomicAdd(reinterpret_cast<float4*>(a.fb + 4 * t),
                make_float4(v[0] * w, v[1] * w, v[2] * w, w));
    }
  }
}

// rad: nplanes pointers, strides: their row strides, clamp: their limits
extern "C" int zyg_flush_filtered(void* fb, int64_t rows, const void* pid, const void* was_alive,
                                  const void* alive, const void** rad, const int64_t* strides,
                                  const float* clamp, int nplanes, const void* sub_uv, int64_t n,
                                  int64_t base, int64_t width, int64_t height, int filter,
                                  int radius, int clamp_edge, void* stream) {
  if (nplanes < 1 || nplanes > 3 || radius < 1 || radius > 2 || width < 1 || height < 1)
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
  a.filter = filter;
  a.radius = radius;
  a.clamp_edge = clamp_edge;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  accum_filtered_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
