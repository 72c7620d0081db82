// The point-cloud walk: closest hit or any hit of rays against sphere
// particles over a binary threaded BVH, in object space.
//
// Replaces the XLA while_loop of zyg_tpu/scene/points.py:205 traverse /
// :253 _traverse_stage (not a TPU kernel: the JAX package walks in XLA);
// the plain torch version is zyg_tpu_torch/scene/points.py::traverse.
//
// One thread a ray. It follows the hit and miss links from its root (-1:
// the lane does not walk): a node whose box the ray enters within [tmin,
// best t] is hit; at a hit leaf it tests the leaf's 4 packed points in
// slot order with the stable quadratic bounded by the running best t,
// where a later slot or leaf at an equal t takes the hit, as the plain
// walk does. kMotion lerps each center by the ray's shutter time toward
// its shutter-close position; kAnyHit stops at the first hit. Rows are
// read as 16-byte loads (the wrapper checks the alignment). Every
// expression keeps the plain version's rounding: fused dot chains and the
// products fused into the sums they feed, as fmaf (the library is built
// with -fmad=false), IEEE division and square root.
#include "walk2.cuh"

struct PointsArgs {
  const float4* nodes;  // [M, 12]
  const float4* prows;  // [G, 32]: 4 points of p0(3) r p1(3) pad
  const int32_t* root;  // [N]
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const float* tmax;  // [N]
  const float* time;  // [N] shutter times (kMotion), else null
  float* t_out;  // [N]
  int32_t* prim_out;  // [N] group * 4 + slot, -1 on a miss
  float tmin;
  int64_t n;
};

template <bool kMotion, bool kAnyHit>
__global__ void __launch_bounds__(WALK2_THREADS) points_kernel(PointsArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(a.o + 3 * i + k);
    d[k] = __ldg(a.d + 3 * i + k);
    inv[k] = inv_dir2(d[k]);
  }
  const float tl = kMotion ? __ldg(a.time + i) : 0.0f;
  const float d2 = dot3f(d[0], d[0], d[1], d[1], d[2], d[2]);
  const float den = zmax(d2, 1e-20f);
  float tb = __ldg(a.tmax + i);
  int pb = -1;
  int ptr = __ldg(a.root + i);
  while (ptr >= 0) {
    const Node2 nd = load_node2(a.nodes, ptr);
    const bool hit = slab2(nd, o, inv, a.tmin, tb);
    if (hit & (nd.group >= 0)) {
      const float4* pr = a.prows + 8 * (int64_t)nd.group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 p = __ldg(pr + 2 * j), q = __ldg(pr + 2 * j + 1);
        float c[3] = {p.x, p.y, p.z};
        const float r = p.w;
        if (kMotion) {
          c[0] = fmaf(tl, q.x - c[0], c[0]);
          c[1] = fmaf(tl, q.y - c[1], c[1]);
          c[2] = fmaf(tl, q.z - c[2], c[2]);
        }
        const float lx = c[0] - o[0], ly = c[1] - o[1], lz = c[2] - o[2];
        const float b = dot3f(lx, d[0], ly, d[1], lz, d[2]);
        const float det = fmaf(b, b, -(d2 * fmaf(-r, r, dot3f(lx, lx, ly, ly, lz, lz))));
        const float sq = sqrtf(zmax(det, 0.0f));
        const float t0 = (b - sq) / den;
        const float t1 = (b + sq) / den;
        const float t = ((t0 >= a.tmin) & (t0 <= tb)) ? t0 : t1;
        const bool ok = (det >= 0.0f) & (r > 0.0f) & (t >= a.tmin) & (t <= tb) & (j < nd.cnt);
        if (ok) {
          tb = t;
          pb = nd.group * 4 + j;
        }
      }
    }
    ptr = hit ? nd.hit : nd.miss;
    if (kAnyHit && pb >= 0) break;
  }
  a.t_out[i] = tb;
  a.prim_out[i] = pb;
}

// ptrs: nodes, point rows, root, o, d, tmax, time (or null), t, prim
extern "C" int zyg_points(void** ptrs, int any_hit, int motion, float tmin, int64_t n,
                          void* stream) {
  PointsArgs a;
  a.nodes = (const float4*)ptrs[0];
  a.prows = (const float4*)ptrs[1];
  a.root = (const int32_t*)ptrs[2];
  a.o = (const float*)ptrs[3];
  a.d = (const float*)ptrs[4];
  a.tmax = (const float*)ptrs[5];
  a.time = (const float*)ptrs[6];
  a.t_out = (float*)ptrs[7];
  a.prim_out = (int32_t*)ptrs[8];
  a.tmin = tmin;
  a.n = n;
  if (motion && a.time == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + WALK2_THREADS - 1) / WALK2_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (motion) {
    if (any_hit)
      points_kernel<true, true><<<blocks, WALK2_THREADS, 0, s>>>(a);
    else
      points_kernel<true, false><<<blocks, WALK2_THREADS, 0, s>>>(a);
  } else {
    if (any_hit)
      points_kernel<false, true><<<blocks, WALK2_THREADS, 0, s>>>(a);
    else
      points_kernel<false, false><<<blocks, WALK2_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
