// The binary threaded BVH walk shared by the point and curve kernels
// (points.cu, curves.cu): node rows [M, 12] of min(3) max(3) hit link,
// miss link, leaf group (-1 inner), count, pad(2), as the JAX package's
// zyg_tpu/scene/points.py and curves.py lay them out. Read as three
// 16-byte loads; a row's leaf primitives are tested by the caller.
#pragma once
#include "prop_hit.cuh"

#define WALK2_THREADS 256

struct Node2 {
  float lo[3], hi[3];
  int hit, miss, group, cnt;
};

__device__ __forceinline__ Node2 load_node2(const float4* rows, int ptr) {
  const float4* r = rows + 3 * (int64_t)ptr;
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  Node2 n;
  n.lo[0] = a.x;
  n.lo[1] = a.y;
  n.lo[2] = a.z;
  n.hi[0] = a.w;
  n.hi[1] = b.x;
  n.hi[2] = b.y;
  // the links, group and count are float32 rows, exact integers
  n.hit = (int)b.z;
  n.miss = (int)b.w;
  n.group = (int)c.x;
  n.cnt = (int)c.y;
  return n;
}

__device__ __forceinline__ float inv_dir2(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

// the node's box entered within [tmin, tb] (torch.minimum/maximum: NaN wins)
__device__ __forceinline__ bool slab2(const Node2& n, const float* o, const float* inv,
                                      float tmin, float tb) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (n.lo[k] - o[k]) * inv[k];
    const float t1 = (n.hi[k] - o[k]) * inv[k];
    const float lo = zmin(t0, t1), hi = zmax(t0, t1);
    tn = k == 0 ? lo : zmax(tn, lo);
    tf = k == 0 ? hi : zmin(tf, hi);
  }
  return (tn <= tf) & (tf >= tmin) & (tn <= tb);
}
