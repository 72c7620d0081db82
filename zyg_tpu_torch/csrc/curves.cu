// The curve (hair) walk: closest hit or any hit of rays against
// round-cone segments over a binary threaded BVH, in object space.
//
// Replaces the XLA while_loop of zyg_tpu/scene/curves.py:290 traverse /
// :346 _traverse_stage (not a TPU kernel: the JAX package walks in XLA);
// the plain torch version is zyg_tpu_torch/scene/curves.py::traverse.
//
// The node walk of points.cu (walk2.cuh). A hit leaf's 4 segments are
// tested with the rounded-cone test (zyg_tpu/scene/curves.py:225
// _cone_test: the cone body's quadratic with its k2 guard, then the two
// spherical caps, the nearest in range wins) on the normalized direction,
// each bounded by the best t at entry scaled by the direction's length,
// then replayed in slot order: a slot takes the hit where its t is within
// the running best (a later slot or leaf at an equal t takes it). Outputs
// t, the axial parameter s of the hit segment (the body's y / d2 clamped
// to [0, 1], 0 or 1 on a cap) and the segment. kAnyHit stops at the
// first hit.
//
// What bounds it on an H100: per lane it reads 32 bytes and writes 12,
// and walks ~31 node rows (hairball.take's 2,033-row tree, 260 KB with
// its leaves, in L1/L2), so it is bound by the instructions its warps
// issue and the chain of dependent reads and divisions of each step. A
// segment test is ~110 operations (three square roots, two IEEE
// divisions): with a thread a ray (PR 20) a warp ran a leaf's 4 tests on
// 21 % of its warp-steps on hairball's camera rays for 4.5 lanes at a
// leaf (35 % for 1.4 lanes on incoherent rays), held all ten float4s of a
// leaf in registers, and ran until its longest walk ended. Design
// (walk2.cuh): persistent warps that refill finished threads, with each
// lane's 1/d, unit direction and length computed once at its claim, and
// the leaf tests shared across the warp, a thread a (lane, slot) pair
// loading only its own segment's 40 bytes (five 8-byte loads); the node
// rows through the read-only path (a copy in shared memory, 97 KB a block,
// measured slower). Rounding as the plain version's: fused dot chains, the
// first product of a sum or difference of products fused into the rest and
// each further product term onto that (fmaf; built with -fmad=false), IEEE
// division and square root.
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
  unsigned long long* next;  // the lane counter, zeroed before the launch
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

// the primitive policy of walk2_lanes: a lane's ray words dn(3), the
// normalized direction, and dl, the direction's length; a slot's result
// its t along dn (NaN on a miss) and s
struct CurvesPrim {
  static constexpr int kHitWords = 2;
  struct Hit {
    float v[kHitWords];
  };
  CurvesArgs a;

  __device__ __forceinline__ void skip(int64_t i) const {
    a.t_out[i] = __ldg(a.tmax + i);
    a.s_out[i] = 0.0f;
    a.prim_out[i] = -1;
  }
  __device__ __forceinline__ void load(int64_t i, float* col) const {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = __ldg(a.d + 3 * i + k);
      col[32 * (walk2::kO + k)] = __ldg(a.o + 3 * i + k);
      col[32 * (walk2::kInv + k)] = walk2::inv_dir2(d[k]);
    }
    const float dl = zmax(sqrtf(zmax(dot3f(d[0], d[0], d[1], d[1], d[2], d[2]), 0.0f)), 1e-20f);
#pragma unroll
    for (int k = 0; k < 3; ++k) col[32 * (walk2::kExtraAt + k)] = d[k] / dl;
    col[32 * (walk2::kExtraAt + 3)] = dl;
    col[32 * walk2::kTmax] = __ldg(a.tmax + i);
  }
  __device__ __forceinline__ void start(walk2::Lane& r, const float* ray) const {
    r.dl = ray[32 * 6];
    r.sb = 0.0f;
  }
  // the slot tests' upper bound, in dn units
  __device__ __forceinline__ float bound(const walk2::Lane& r) const { return r.tb * r.dl; }
  // slot `slot` of leaf group `group` against the ray words o(3) dn(3) dl,
  // within [tmin, ub] (dn units): its t along dn, or NaN, and s
  __device__ __forceinline__ void test(const float* ray, int group, int slot, float ub,
                                       Hit& h) const {
    const float o[3] = {ray[0], ray[32], ray[64]};
    const float dn[3] = {ray[96], ray[128], ray[160]};
    const float dl = ray[192];
    const float2* sr = reinterpret_cast<const float2*>(a.srows) + 20 * (int64_t)group + 5 * slot;
    float seg[10];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float2 v = __ldg(sr + q);
      seg[2 * q] = v.x;
      seg[2 * q + 1] = v.y;
    }
    const ConeHit c = cone_test(o, dn, seg, a.tmin * dl, ub);
    h.v[0] = c.t < CURVES_FAR ? c.t : __int_as_float(0x7FC00000);
    h.v[1] = c.s;
  }
  __device__ __forceinline__ void take(walk2::Lane& r, const Hit& h, int group, int slot,
                                       int cnt) const {
    if ((h.v[0] <= r.tb * r.dl) & (slot < cnt)) {
      r.tb = h.v[0] / r.dl;
      r.sb = h.v[1];
      r.pb = group * walk2::kSlots + slot;
    }
  }
  __device__ __forceinline__ void finish(const walk2::Lane& r) const {
    a.t_out[r.id] = r.tb;
    a.s_out[r.id] = r.sb;
    a.prim_out[r.id] = r.pb;
  }
};

template <bool kAnyHit>
__global__ void __launch_bounds__(WALK2_THREADS) curves_kernel(CurvesArgs a) {
  __shared__ walk2::Buffers<CurvesPrim::kHitWords> buf;
  walk2::walk2_lanes<kAnyHit>(CurvesPrim{a}, a.nodes, a.root, a.tmin, a.n, a.next, buf);
}

template <bool kAnyHit>
cudaError_t launch_curves(const CurvesArgs& a, cudaStream_t st) {
  unsigned blocks = 0;
  const cudaError_t err =
      walk2::prepare((const void*)curves_kernel<kAnyHit>, a.n, a.next, st, &blocks);
  if (err != cudaSuccess) return err;
  curves_kernel<kAnyHit><<<blocks, WALK2_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// ptrs: nodes, segment rows, root, o, d, tmax, t, s, prim, the lane
// counter (one uint64 of scratch)
extern "C" int zyg_curves(void** ptrs, int any_hit, float tmin, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
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
  a.next = (unsigned long long*)ptrs[9];
  a.tmin = tmin;
  a.n = n;
  if (a.next == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(any_hit ? launch_curves<true>(a, s) : launch_curves<false>(a, s));
}

// the lanes one pass of the resident grid covers on the current device:
// the more of the two forms'
extern "C" int zyg_curves_resident_lanes(int64_t* out) {
  int64_t closest = 0, any = 0;
  cudaError_t err = resident_lanes((const void*)curves_kernel<false>, WALK2_THREADS, &closest);
  if (err == cudaSuccess) err = resident_lanes((const void*)curves_kernel<true>, WALK2_THREADS, &any);
  *out = closest > any ? closest : any;
  return (int)err;
}
