// The curve (hair) walk: closest hit or any hit of rays against
// round-cone segments over a binary threaded BVH, in object space.
//
// Replaces the XLA while_loop of zyg_tpu/scene/curves.py:290 traverse /
// :346 _traverse_stage (not a TPU kernel: the JAX package walks in XLA);
// the plain torch version is zyg_tpu_torch/scene/curves.py::traverse.
//
// One thread a ray, the node walk of points.cu (walk2.cuh). A hit leaf's
// 4 segments are tested in slot order with the rounded-cone test
// (zyg_tpu/scene/curves.py:225 _cone_test: the cone body's quadratic with
// its k2 guard, then the two spherical caps, the nearest in range wins)
// on the normalized direction, its bounds and hit scaled by the
// direction's length; a later slot or leaf at an equal t takes the hit.
// Outputs t, the axial parameter s of the hit segment (the body's y / d2
// clamped to [0, 1], 0 or 1 on a cap) and the segment. kAnyHit stops at
// the first hit. Rounding as the plain version's: fused dot chains, the
// first product of a sum or difference of products fused into the rest
// and each further product term onto that (fmaf; built with
// -fmad=false), IEEE division and square root.
#include "walk2.cuh"

#define CURVES_FAR 3.0e38f

struct CurvesArgs {
  const float4* nodes;  // [M, 12]
  const float4* srows;  // [G, 40]: 4 segments of pa(3) ra pb(3) rb u0 u1
  const int32_t* root;  // [N]
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const float* tmax;  // [N]
  float* t_out;  // [N]
  float* s_out;  // [N]
  int32_t* prim_out;  // [N] group * 4 + slot, -1 on a miss
  float tmin;
  int64_t n;
};

struct ConeHit {
  float t, s;
};

__device__ __forceinline__ float in_range(float t, bool ok, float tmin, float tmax) {
  return (ok & (t >= tmin) & (t <= tmax)) ? t : CURVES_FAR;
}

// one segment against the unit direction dn, t in [tmin, tmax] (dn units);
// t = CURVES_FAR on a miss
__device__ __forceinline__ ConeHit cone_test(const float* o, const float* dn, const float* seg,
                                             float tmin, float tmax) {
  const float ra = seg[3], rb = seg[7];
  float ba[3], oa[3], ob[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ba[k] = seg[4 + k] - seg[k];
    oa[k] = o[k] - seg[k];
    ob[k] = o[k] - seg[4 + k];
  }
  const float rr = ra - rb;
  const float m0 = dot3f(ba[0], ba[0], ba[1], ba[1], ba[2], ba[2]);
  const float m1 = dot3f(ba[0], oa[0], ba[1], oa[1], ba[2], oa[2]);
  const float m2 = dot3f(ba[0], dn[0], ba[1], dn[1], ba[2], dn[2]);
  const float m3 = dot3f(dn[0], oa[0], dn[1], oa[1], dn[2], oa[2]);
  const float m5 = dot3f(oa[0], oa[0], oa[1], oa[1], oa[2], oa[2]);
  const float m6 = dot3f(ob[0], dn[0], ob[1], dn[1], ob[2], dn[2]);
  const float m7 = dot3f(ob[0], ob[0], ob[1], ob[1], ob[2], ob[2]);
  const float d2 = fmaf(-rr, rr, m0);
  const float k2 = fmaf(-m2, m2, d2);
  const float k1 = fmaf(m2 * rr, ra, fmaf(d2, m3, -(m1 * m2)));
  const float k0 = fmaf(-(m0 * ra), ra, fmaf(2.0f * m1 * rr, ra, fmaf(d2, m5, -(m1 * m1))));
  const float h = fmaf(k1, k1, -(k0 * k2));
  const float k2s = fabsf(k2) < 1e-12f ? 1e-12f : k2;
  const float t_body = (-sqrtf(zmax(h, 0.0f)) - k1) / k2s;
  const float y = fmaf(t_body, m2, fmaf(-ra, rr, m1));
  const bool body_ok = (h > 0.0f) & (y > 0.0f) & (y < d2) & (ra > 0.0f);
  // the spherical caps
  const float h1 = fmaf(ra, ra, fmaf(m3, m3, -m5));
  const float h2 = fmaf(rb, rb, fmaf(m6, m6, -m7));
  const float t_a = -m3 - sqrtf(zmax(h1, 0.0f));
  const float t_cb = -m6 - sqrtf(zmax(h2, 0.0f));
  const float tb = in_range(t_body, body_ok, tmin, tmax);
  const float ta = in_range(t_a, (h1 > 0.0f) & (ra > 0.0f), tmin, tmax);
  const float tbb = in_range(t_cb, (h2 > 0.0f) & (rb > 0.0f), tmin, tmax);
  ConeHit c;
  c.t = zmin(tb, zmin(ta, tbb));
  const float s_body = zmin(zmax(y / zmax(d2, 1e-20f), 0.0f), 1.0f);
  c.s = c.t == tb ? s_body : (c.t == ta ? 0.0f : 1.0f);
  return c;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(WALK2_THREADS) curves_kernel(CurvesArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float o[3], d[3], inv[3], dn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(a.o + 3 * i + k);
    d[k] = __ldg(a.d + 3 * i + k);
    inv[k] = inv_dir2(d[k]);
  }
  const float dlen = zmax(sqrtf(zmax(dot3f(d[0], d[0], d[1], d[1], d[2], d[2]), 0.0f)), 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) dn[k] = d[k] / dlen;
  const float tmin_u = a.tmin * dlen;
  float tb = __ldg(a.tmax + i), sb = 0.0f;
  int pb = -1;
  int ptr = __ldg(a.root + i);
  while (ptr >= 0) {
    const Node2 nd = load_node2(a.nodes, ptr);
    const bool hit = slab2(nd, o, inv, a.tmin, tb);
    if (hit & (nd.group >= 0)) {
      const float4* sr = a.srows + 10 * (int64_t)nd.group;
      float seg[40];
#pragma unroll
      for (int q = 0; q < 10; ++q) {
        const float4 v = __ldg(sr + q);
        seg[4 * q] = v.x;
        seg[4 * q + 1] = v.y;
        seg[4 * q + 2] = v.z;
        seg[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const ConeHit c = cone_test(o, dn, seg + 10 * j, tmin_u, tb * dlen);
        if ((c.t < CURVES_FAR) & (j < nd.cnt)) {
          tb = c.t / dlen;
          sb = c.s;
          pb = nd.group * 4 + j;
        }
      }
    }
    ptr = hit ? nd.hit : nd.miss;
    if (kAnyHit && pb >= 0) break;
  }
  a.t_out[i] = tb;
  a.s_out[i] = sb;
  a.prim_out[i] = pb;
}

// ptrs: nodes, segment rows, root, o, d, tmax, t, s, prim
extern "C" int zyg_curves(void** ptrs, int any_hit, float tmin, int64_t n, void* stream) {
  CurvesArgs a;
  a.nodes = (const float4*)ptrs[0];
  a.srows = (const float4*)ptrs[1];
  a.root = (const int32_t*)ptrs[2];
  a.o = (const float*)ptrs[3];
  a.d = (const float*)ptrs[4];
  a.tmax = (const float*)ptrs[5];
  a.t_out = (float*)ptrs[6];
  a.s_out = (float*)ptrs[7];
  a.prim_out = (int32_t*)ptrs[8];
  a.tmin = tmin;
  a.n = n;
  const unsigned blocks = (unsigned)((n + WALK2_THREADS - 1) / WALK2_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    curves_kernel<true><<<blocks, WALK2_THREADS, 0, s>>>(a);
  else
    curves_kernel<false><<<blocks, WALK2_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
