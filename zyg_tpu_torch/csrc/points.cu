// The point-cloud walk: closest hit or any hit of rays against sphere
// particles over a binary threaded BVH, in object space.
//
// Replaces the XLA while_loop of zyg_tpu/scene/points.py:205 traverse /
// :253 _traverse_stage (not a TPU kernel: the JAX package walks in XLA);
// the plain torch version is zyg_tpu_torch/scene/points.py::traverse.
//
// Each lane follows the hit and miss links from its root (-1: the lane
// does not walk): a node whose box the ray enters within [tmin, best t] is
// hit; at a hit leaf its 4 packed points are tested with the stable
// quadratic, each bounded by the best t at entry, and replayed in slot
// order: a slot takes the hit where it is within the running best t, so a
// later slot or leaf at an equal t takes it, as the plain walk does.
// kMotion lerps each center by the ray's shutter time toward its
// shutter-close position; kAnyHit stops at the first hit.
//
// What bounds it on an H100: per lane it reads 36-40 bytes and writes 8,
// and walks ~27 node rows (sparks.take's 405-row tree, 45 KB with its
// leaves, stays in L1/L2), so it is bound by the instructions its warps
// issue and the chain of dependent reads and divisions of each step, not
// by bytes. With a thread a ray (PR 20) a warp ran the leaf branch, 4
// point tests, for every lane whenever one lane stood at a leaf (43 % of
// the warp-steps on sparks' camera rays, for 8.5 lanes on average; 59 %
// for 2.2 lanes on incoherent rays), and ran until its longest walk ended
// (27 % of its thread-steps walk on incoherent rays). Design (walk2.cuh):
// persistent warps that refill finished threads from a lane counter, with
// each lane's 1/d computed once at its claim, and the leaf tests of a
// step shared across the warp, a thread a (lane, slot) pair, each loading
// only its own point's 16 or 32 bytes; the node rows through the
// read-only path (a copy in shared memory measured no faster). Rows are
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
  unsigned long long* next;  // the lane counter, zeroed before the launch
  float tmin;
  int64_t n;
};

// the primitive policy of walk2_lanes: a lane's ray words d(3) and its
// shutter time, a slot's result its t (NaN on a miss)
template <bool kMotion>
struct PointsPrim {
  static constexpr int kHitWords = 1;
  struct Hit {
    float v[kHitWords];
  };
  PointsArgs a;

  __device__ __forceinline__ void skip(int64_t i) const {
    a.t_out[i] = __ldg(a.tmax + i);
    a.prim_out[i] = -1;
  }
  __device__ __forceinline__ void load(int64_t i, float* col) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = __ldg(a.d + 3 * i + k);
      col[32 * (walk2::kO + k)] = __ldg(a.o + 3 * i + k);
      col[32 * (walk2::kInv + k)] = walk2::inv_dir2(d);
      col[32 * (walk2::kExtraAt + k)] = d;
    }
    col[32 * walk2::kTmax] = __ldg(a.tmax + i);
    col[32 * (walk2::kExtraAt + 3)] = kMotion ? __ldg(a.time + i) : 0.0f;
  }
  __device__ __forceinline__ void start(walk2::Lane&, const float*) const {}
  __device__ __forceinline__ float bound(const walk2::Lane& r) const { return r.tb; }
  // slot `slot` of leaf group `group` against the ray words o(3) d(3)
  // time, within [tmin, tb]: its t, or NaN
  __device__ __forceinline__ void test(const float* ray, int group, int slot, float tb,
                                       Hit& h) const {
    const float o[3] = {ray[0], ray[32], ray[64]};
    const float d[3] = {ray[96], ray[128], ray[160]};
    const float4* pr = a.prows + 8 * (int64_t)group + 2 * slot;
    const float4 p = __ldg(pr);
    float c[3] = {p.x, p.y, p.z};
    const float r = p.w;
    if (kMotion) {
      const float4 q = __ldg(pr + 1);
      const float tl = ray[192];
      c[0] = fmaf(tl, q.x - c[0], c[0]);
      c[1] = fmaf(tl, q.y - c[1], c[1]);
      c[2] = fmaf(tl, q.z - c[2], c[2]);
    }
    const float d2 = dot3f(d[0], d[0], d[1], d[1], d[2], d[2]);
    const float den = zmax(d2, 1e-20f);
    const float lx = c[0] - o[0], ly = c[1] - o[1], lz = c[2] - o[2];
    const float b = dot3f(lx, d[0], ly, d[1], lz, d[2]);
    const float det = fmaf(b, b, -(d2 * fmaf(-r, r, dot3f(lx, lx, ly, ly, lz, lz))));
    const float sq = sqrtf(zmax(det, 0.0f));
    const float t0 = (b - sq) / den;
    const float t1 = (b + sq) / den;
    const float t = ((t0 >= a.tmin) & (t0 <= tb)) ? t0 : t1;
    const bool ok = (det >= 0.0f) & (r > 0.0f) & (t >= a.tmin) & (t <= tb);
    h.v[0] = ok ? t : __int_as_float(0x7FC00000);
  }
  __device__ __forceinline__ void take(walk2::Lane& r, const Hit& h, int group, int slot,
                                       int cnt) const {
    if ((h.v[0] <= r.tb) & (slot < cnt)) {
      r.tb = h.v[0];
      r.pb = group * walk2::kSlots + slot;
    }
  }
  __device__ __forceinline__ void finish(const walk2::Lane& r) const {
    a.t_out[r.id] = r.tb;
    a.prim_out[r.id] = r.pb;
  }
};

template <bool kMotion, bool kAnyHit>
__global__ void __launch_bounds__(WALK2_THREADS) points_kernel(PointsArgs a) {
  __shared__ walk2::Buffers<PointsPrim<kMotion>::kHitWords> buf;
  walk2::walk2_lanes<kAnyHit>(PointsPrim<kMotion>{a}, a.nodes, a.root, a.tmin, a.n, a.next, buf);
}

template <bool kMotion, bool kAnyHit>
cudaError_t launch_points(const PointsArgs& a, cudaStream_t st) {
  unsigned blocks = 0;
  const cudaError_t err =
      walk2::prepare((const void*)points_kernel<kMotion, kAnyHit>, a.n, a.next, st, &blocks);
  if (err != cudaSuccess) return err;
  points_kernel<kMotion, kAnyHit><<<blocks, WALK2_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// ptrs: nodes, point rows, root, o, d, tmax, time (or null), t, prim, the
// lane counter (one uint64 of scratch)
extern "C" int zyg_points(void** ptrs, int any_hit, int motion, float tmin, int64_t n,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
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
  a.next = (unsigned long long*)ptrs[9];
  a.tmin = tmin;
  a.n = n;
  if ((motion && a.time == nullptr) || a.next == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (motion) {
    return (int)(any_hit ? launch_points<true, true>(a, s) : launch_points<true, false>(a, s));
  }
  return (int)(any_hit ? launch_points<false, true>(a, s) : launch_points<false, false>(a, s));
}

// the lanes one pass of the resident grid covers on the current device:
// the most of the four forms'
extern "C" int zyg_points_resident_lanes(int64_t* out) {
  const void* forms[4] = {(const void*)points_kernel<false, false>,
                          (const void*)points_kernel<false, true>,
                          (const void*)points_kernel<true, false>,
                          (const void*)points_kernel<true, true>};
  *out = 0;
  for (const void* k : forms) {
    int64_t lanes = 0;
    const cudaError_t err = resident_lanes(k, WALK2_THREADS, &lanes);
    if (err != cudaSuccess) return (int)err;
    if (lanes > *out) *out = lanes;
  }
  return (int)cudaSuccess;
}
