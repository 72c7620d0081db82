// Per-pixel sample flush of the persistent wavefront: for every lane i
// whose path ended in this launch (was_alive[i] && !alive[i]),
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
