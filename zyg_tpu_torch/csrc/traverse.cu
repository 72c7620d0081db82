// Closest-hit and any-hit over the mesh instances: the instance walk and
// the 8-wide BLAS traversal.
//
// Replaces the XLA traversal of the JAX package (zyg_tpu/scene/trimesh.py
// :1053 intersect_instances, :611 traverse / :718 _traverse_stage, :544
// _tri_test): it is not a TPU kernel there, but it is where a mesh render
// spends its time. The walk is the JAX package's, ray by ray, so both pick
// the same triangle (ops/traverse.py tells it in full): instances in strict
// (entry t, index) order, each walked in object space bounded by the best
// t; at a wide node the nearest eligible child by (entry-t bits & ~7) |
// slot, the rest pushed as ONE continuation (a direct child ref, or the
// node with its remaining-child mask to re-test on resume), so the stack
// holds at most depth + 1 entries; at a leaf Moller-Trumbore over its 12
// triangles, the lowest slot winning a tie and a strictly closer hit
// replacing the best. Rounding follows ops/traverse.py: the quaternion to
// rotation in plain float32, dot products as fmaf chains, cross products
// fusing their first product, 1/scale multiplied (built with -fmad=false).
//
// What bounds it on an H100: per ray it reads 28 bytes and writes 20 (t,
// prim, u, v, prop), but walks node rows (256 B each) and leaf rows (432 B
// each) gathered at random from an arena of ~30 MB (the 491,520-triangle
// trefoil, which stays in the 50 MB L2; ~4 node rows and ~0.7 leaf rows a
// ray for random rays), so it is bound by the latency of those dependent
// loads and by the lanes of a warp that idle while its longest ray walks,
// not by the bytes of its inputs. Design:
// - rows are read as 16-byte read-only loads (__ldg of float4): a node's
//   48 bounds in 12 loads and its 8 child refs in 2, a leaf's triangles in
//   27, 4 triangles (9 loads) at a time. Both row widths are multiples of
//   16 bytes; the wrapper checks that the arena tensors are 16-byte
//   aligned. The arena layout is the JAX package's, element for element;
// - the continuation stack lives in shared memory (stack_d <= 32 ints a
//   thread, entry k of a thread at [k * 128 + thread]: no bank conflicts),
//   not in local memory;
// - persistent warps (Aila & Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009): the grid is sized to the resident
//   blocks; each warp takes 32 ray ids at a time from a global counter
//   (one atomicAdd; the entry point zeroes it before the launch) into a
//   pool, and a lane whose ray ends takes the next id of the pool at once,
//   so a warp's lanes stay busy until the rays run out. Each iteration a
//   lane does one step of its ray (pick the next instance, or one wide
//   node or one leaf and the pop), so a lane whose ray ended takes a new
//   one after one step, not after the warp's longest descent: the paper's
//   while-while loop (nodes until every lane stands at a leaf) measured
//   slower on the card. Each ray keeps its own visit order and every
//   rounding, so the hit records are the plain walk's, ties included.
// Dead lanes (tmax <= 0) are written at once; any-hit ends a ray at its
// first hit. A stack overflow or a runaway walk sets a flag that the
// wrapper turns into an exception; it never truncates a walk silently.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "prop_hit.cuh"

#define TRAV_MAX_STACK 32
#define TRAV_B 8  // children per wide node
#define TRAV_LEAF 12  // triangles per leaf row
#define TRAV_MAX_STEPS 65536
#define TRAV_THREADS 128
#define TRAV_NODE_F4 16  // float4s per node row (64 floats)
#define TRAV_LEAF_F4 27  // float4s per leaf row (108 floats)

namespace {

constexpr int kMissKey = 0x7F800000;
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct TravArgs {
  const float4* node_rows;  // [W, 64]
  const float4* tri_rows;  // [G, 108]
  const float* wmin;  // [I, 3]
  const float* wmax;  // [I, 3]
  const float* trafo;  // [I, 24]
  const uint8_t* vis;  // [I, 3] camera / reflection / shadow
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const float* tmax;  // [N]
  const uint8_t* primary;  // [N] or null
  int* err;  // [1] bit 0: stack overflow, bit 1: runaway walk
  unsigned long long* next;  // [1] the next ray id to hand out
  float* t_out;
  int32_t* prim_out;
  float* u_out;
  float* v_out;
  int32_t* prop_out;
  uint8_t* blocked_out;
  int ninst, vis_col, any_hit, stack_d;
  float tmin;
  int64_t n;
};

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(F3 a, F3 b) { return dot3f(a.x, b.x, a.y, b.y, a.z, b.z); }
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return F3{fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x))};
}
__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}
__device__ __forceinline__ F3 inv3(F3 d) { return F3{inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)}; }
__device__ __forceinline__ void unpack4(float4 v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
// v[s] for a slot known only at run time, by selects (v stays in registers)
__device__ __forceinline__ float pick8(const float* v, int s) {
  float r = v[0];
#pragma unroll
  for (int b = 1; b < TRAV_B; ++b) r = s == b ? v[b] : r;
  return r;
}

struct Best {
  float t, u, v;
  int prim;
};

// one lane's ray and where its walk stands
struct Ray {
  int64_t id;  // -1: the lane holds no ray
  F3 ol, dl, invl;  // object space of the instance being walked (the world
                    // ray is read again at each instance pick)
  Best best;
  int prop;
  bool prim_ray, walking;
  float last_t, bt;  // the last instance walked and the current one: entry t ...
  int last_i, bi;  // ... and index
  int round, node, mask, sp, steps, found;
};

__device__ __forceinline__ void finish(const TravArgs& a, const Ray& r) {
  if (a.any_hit) {
    a.blocked_out[r.id] = r.best.prim >= 0;
  } else {
    a.t_out[r.id] = r.best.t;
    a.prim_out[r.id] = r.best.prim;
    a.u_out[r.id] = r.best.u;
    a.v_out[r.id] = r.best.v;
    a.prop_out[r.id] = r.prop;
  }
}

// start ray id in r; returns false (after writing its record) for a ray
// that enters no instance: dead lanes (tmax = 0) and NaN bounds
__device__ __forceinline__ bool start(const TravArgs& a, int64_t id, Ray& r) {
  r.id = id;
  r.best = Best{__ldg(a.tmax + id), 0.0f, 0.0f, -1};
  r.prop = -1;
  if (!(r.best.t > 0.0f)) {
    finish(a, r);
    return false;
  }
  r.prim_ray = a.primary != nullptr && __ldg(a.primary + id) != 0;
  r.last_t = -1.0f;
  r.last_i = -1;
  r.round = 0;
  r.walking = false;
  return true;
}

// the nearest eligible instance strictly after (last_t, last_i); returns
// false (the ray is done) if there is none, or the rounds are spent, or an
// any-hit ray has its hit. Otherwise sets up the object-space walk.
__device__ __forceinline__ bool pick_instance(const TravArgs& a, Ray& r) {
  if (r.round >= a.ninst || (a.any_hit && r.best.prim >= 0)) return false;
  const int64_t id = r.id;
  const F3 o{__ldg(a.o + 3 * id), __ldg(a.o + 3 * id + 1), __ldg(a.o + 3 * id + 2)};
  const F3 d{__ldg(a.d + 3 * id), __ldg(a.d + 3 * id + 1), __ldg(a.d + 3 * id + 2)};
  const F3 inv = inv3(d);
  float bt = kBig;
  int bi = -1;
  for (int k = 0; k < a.ninst; ++k) {
    const float* lo = a.wmin + 3 * k;
    const float* hi = a.wmax + 3 * k;
    const float lx = (__ldg(lo) - o.x) * inv.x, hx = (__ldg(hi) - o.x) * inv.x;
    const float ly = (__ldg(lo + 1) - o.y) * inv.y, hy = (__ldg(hi + 1) - o.y) * inv.y;
    const float lz = (__ldg(lo + 2) - o.z) * inv.z, hz = (__ldg(hi + 2) - o.z) * inv.z;
    const float near = zmax(zmax(zmin(lx, hx), zmin(ly, hy)), zmin(lz, hz));
    const float far = zmin(zmin(zmax(lx, hx), zmax(ly, hy)), zmax(lz, hz));
    const float nearc = zmax(zmax(near, a.tmin), 0.0f);
    const bool vis = __ldg(a.vis + 3 * k + (r.prim_ray ? 0 : a.vis_col)) != 0;
    const bool elig = (nearc <= far) & vis & (nearc < r.best.t) &
                      ((nearc > r.last_t) | ((nearc == r.last_t) & (k > r.last_i)));
    const float te = elig ? nearc : kBig;
    if (te < bt) {
      bt = te;
      bi = k;
    }
  }
  if (bi < 0) return false;
  // the ray in the instance's object space (t stays in world units)
  const float* tf = a.trafo + 24 * bi;
  const float x = __ldg(tf), y = __ldg(tf + 1), z = __ldg(tf + 2), w = __ldg(tf + 3);
  const float xx = 2.0f * x * x, yy = 2.0f * y * y, zz = 2.0f * z * z;
  const float xy = 2.0f * x * y, xz = 2.0f * x * z, yz = 2.0f * y * z;
  const float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
  const F3 r0{1.0f - (yy + zz), xy - wz, xz + wy};
  const F3 r1{xy + wz, 1.0f - (xx + zz), yz - wx};
  const F3 r2{xz - wy, yz + wx, 1.0f - (xx + yy)};
  const F3 rs{1.0f / __ldg(tf + 7), 1.0f / __ldg(tf + 8), 1.0f / __ldg(tf + 9)};
  const F3 op{o.x - __ldg(tf + 4), o.y - __ldg(tf + 5), o.z - __ldg(tf + 6)};
  r.ol = F3{dot(op, r0) * rs.x, dot(op, r1) * rs.y, dot(op, r2) * rs.z};
  r.dl = F3{dot(d, r0) * rs.x, dot(d, r1) * rs.y, dot(d, r2) * rs.z};
  r.invl = inv3(r.dl);
  r.bt = bt;
  r.bi = bi;
  r.node = (int)__ldg(tf + 20);
  r.mask = (1 << TRAV_B) - 1;
  r.sp = 0;
  r.steps = 0;
  r.found = 0;
  r.walking = true;
  return true;
}

// one step of the instance's BLAS walk: a wide node or a leaf, then the
// pop. Returns -2 while the walk goes on, else its end: 1 if it found a
// closer hit, 0 if not, -1 if it had to stop early (the error flag is set).
__device__ __forceinline__ int walk_step(const TravArgs& a, Ray& r, int* stack) {
  if (r.steps >= TRAV_MAX_STEPS) {
    atomicOr(a.err, 2);
    return -1;
  }
  ++r.steps;
  const F3 o = r.ol, d = r.dl, inv = r.invl;
  if (r.node >= 0) {
    // ---- wide node: slab-test the children, key the eligible ones
    const float4* row = a.node_rows + (int64_t)r.node * TRAV_NODE_F4;
    float refs[TRAV_B];
    unpack4(__ldg(row + 12), refs);
    unpack4(__ldg(row + 13), refs + 4);
    int keys[TRAV_B];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lo[3][4], hi[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        unpack4(__ldg(row + 2 * c + h), lo[c]);
        unpack4(__ldg(row + 6 + 2 * c + h), hi[c]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = 4 * h + k;
        const float lox = (lo[0][k] - o.x) * inv.x;
        const float loy = (lo[1][k] - o.y) * inv.y;
        const float loz = (lo[2][k] - o.z) * inv.z;
        const float hix = (hi[0][k] - o.x) * inv.x;
        const float hiy = (hi[1][k] - o.y) * inv.y;
        const float hiz = (hi[2][k] - o.z) * inv.z;
        const float near = zmax(zmax(zmin(lox, hix), zmin(loy, hiy)), zmin(loz, hiz));
        const float far = zmin(zmin(zmax(lox, hix), zmax(loy, hiy)), zmax(loz, hiz));
        const float nearc = zmax(zmax(near, a.tmin), 0.0f);
        const bool hit = (nearc <= far) & (refs[b] != -1.0f) & (nearc < r.best.t);
        const bool elig = hit & (((r.mask >> b) & 1) != 0);
        keys[b] = elig ? ((__float_as_int(nearc) & ~(TRAV_B - 1)) | b) : (kMissKey | b);
      }
    }
    int key_min = keys[0];
#pragma unroll
    for (int b = 1; b < TRAV_B; ++b) key_min = min(key_min, keys[b]);
    if (key_min < kMissKey) {
      const int slot = key_min & (TRAV_B - 1);
      int key2 = kMissKey | slot, rem = 0;
#pragma unroll
      for (int b = 0; b < TRAV_B; ++b) {
        if (b == slot) continue;
        key2 = min(key2, keys[b]);
        rem |= keys[b] < kMissKey ? 1 << b : 0;
      }
      if (rem != 0) {
        if (r.sp >= a.stack_d) {
          atomicOr(a.err, 1);
          return -1;
        }
        const int cref2 = (int)pick8(refs, key2 & (TRAV_B - 1));
        stack[r.sp * TRAV_THREADS] = __popc(rem) == 1 ? cref2 * 2 + 1 : (r.node * 256 + rem) * 2;
        ++r.sp;
      }
      r.node = (int)pick8(refs, slot);
      r.mask = (1 << TRAV_B) - 1;
      return -2;
    }
  } else {
    // ---- leaf: Moller-Trumbore over its triangles (lowest slot wins a tie)
    const int g = -r.node - 2;
    const float4* tr = a.tri_rows + (int64_t)g * TRAV_LEAF_F4;
    float t16 = kBig, u16 = 0.0f, v16 = 0.0f;
    int jj = 0;
#pragma unroll
    for (int q = 0; q < TRAV_LEAF / 4; ++q) {
      float f[36];  // 4 triangles of (p0, e1, e2)
#pragma unroll
      for (int k = 0; k < 9; ++k) unpack4(__ldg(tr + 9 * q + k), f + 4 * k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * q + c;
        const float* t9 = f + 9 * c;
        const F3 p0{t9[0], t9[1], t9[2]}, e1{t9[3], t9[4], t9[5]}, e2{t9[6], t9[7], t9[8]};
        const F3 pvec = cross(d, e2);
        const float det = dot(e1, pvec);
        const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
        const F3 tvec{o.x - p0.x, o.y - p0.y, o.z - p0.z};
        const float u = dot(tvec, pvec) * inv_det;
        const F3 qvec = cross(tvec, e1);
        const float v = dot(d, qvec) * inv_det;
        const float t = dot(e2, qvec) * inv_det;
        const bool hit = (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= a.tmin) &
                         (t <= r.best.t) & (fabsf(det) > 1e-12f);
        const float tm = hit ? t : kBig;
        if (j == 0 || tm < t16) {
          t16 = tm;
          u16 = u;
          v16 = v;
          jj = j;
        }
      }
    }
    if (t16 < r.best.t) {
      r.best = Best{t16, u16, v16, g * TRAV_LEAF + jj};
      r.found = 1;
      if (a.any_hit) return 1;
    }
  }
  // ---- resume the innermost continuation, or finish
  if (r.sp == 0) return r.found;
  --r.sp;
  const int top = stack[r.sp * TRAV_THREADS];
  if (top & 1) {
    r.node = (top - 1) >> 1;  // direct child ref (a leaf ref is negative)
    r.mask = (1 << TRAV_B) - 1;
  } else {
    r.node = (top >> 1) / 256;
    r.mask = (top >> 1) % 256;
  }
  return -2;
}

__global__ void __launch_bounds__(TRAV_THREADS) traverse_kernel(TravArgs a) {
  __shared__ int stack_s[TRAV_MAX_STACK * TRAV_THREADS];
  int* const stack = stack_s + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  // the warp's pool of ray ids [pool, pool_end): the same in every lane
  int64_t pool = 0, pool_end = 0;
  bool dry = false;
  Ray r;
  r.id = -1;
  while (true) {
    // ---- idle lanes take the pool's next ids, in lane order
    unsigned idle = __ballot_sync(kFull, r.id < 0);
    while (idle != 0 && !dry) {
      if (pool >= pool_end) {
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(a.next, 32ull);
        base = __shfl_sync(kFull, base, 0);
        pool = (int64_t)base;
        pool_end = pool + 32 < a.n ? pool + 32 : a.n;
        if (pool >= a.n) {
          dry = true;
          break;
        }
      }
      const int64_t left = pool_end - pool;
      const int take = __popc(idle) < left ? __popc(idle) : (int)left;
      const int rank = __popc(idle & below);
      if (((idle >> lane) & 1u) && rank < take && !start(a, pool + rank, r)) r.id = -1;
      pool += take;
      idle = __ballot_sync(kFull, r.id < 0);
    }
    if (__ballot_sync(kFull, r.id >= 0) == 0) break;
    // ---- one step of this lane's ray
    if (r.id < 0) continue;
    if (!r.walking && !pick_instance(a, r)) {
      finish(a, r);
      r.id = -1;
      continue;
    }
    const int end = walk_step(a, r, stack);
    if (end == -2) continue;
    r.walking = false;
    if (end < 0) {
      finish(a, r);
      r.id = -1;
    } else {
      if (end) r.prop = (int)__ldg(a.trafo + 24 * r.bi + 21);
      r.last_t = r.bt;
      r.last_i = r.bi;
      ++r.round;
    }
  }
}

}  // namespace

// ptrs: node_rows, tri_rows, wmin, wmax, trafo, vis, o, d, tmax, primary
// (or null), err, the ray counter, then t, prim, u, v, prop (closest) or
// blocked (any-hit)
extern "C" int zyg_traverse(void** ptrs, int ninst, int vis_col, int any_hit, int stack_d,
                            float tmin, int64_t n, void* stream) {
  if (stack_d < 1 || stack_d > TRAV_MAX_STACK || ninst < 0 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  TravArgs a;
  a.node_rows = (const float4*)ptrs[0];
  a.tri_rows = (const float4*)ptrs[1];
  a.wmin = (const float*)ptrs[2];
  a.wmax = (const float*)ptrs[3];
  a.trafo = (const float*)ptrs[4];
  a.vis = (const uint8_t*)ptrs[5];
  a.o = (const float*)ptrs[6];
  a.d = (const float*)ptrs[7];
  a.tmax = (const float*)ptrs[8];
  a.primary = (const uint8_t*)ptrs[9];
  a.err = (int*)ptrs[10];
  a.next = (unsigned long long*)ptrs[11];
  a.t_out = any_hit ? nullptr : (float*)ptrs[12];
  a.prim_out = any_hit ? nullptr : (int32_t*)ptrs[13];
  a.u_out = any_hit ? nullptr : (float*)ptrs[14];
  a.v_out = any_hit ? nullptr : (float*)ptrs[15];
  a.prop_out = any_hit ? nullptr : (int32_t*)ptrs[16];
  a.blocked_out = any_hit ? (uint8_t*)ptrs[12] : nullptr;
  a.ninst = ninst;
  a.vis_col = vis_col;
  a.any_hit = any_hit;
  a.stack_d = stack_d;
  a.tmin = tmin;
  a.n = n;
  if (((uintptr_t)a.node_rows | (uintptr_t)a.tri_rows) & 15) return (int)cudaErrorMisalignedAddress;
  int resident = 0;
  cudaError_t err = resident_blocks((const void*)traverse_kernel, TRAV_THREADS, &resident);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.next, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + TRAV_THREADS - 1) / TRAV_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  traverse_kernel<<<blocks, TRAV_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the lanes one pass of the resident grid covers on the current device
extern "C" int zyg_traverse_resident_lanes(int64_t* out) {
  int blocks = 0;
  const cudaError_t err = resident_blocks((const void*)traverse_kernel, TRAV_THREADS, &blocks);
  *out = (int64_t)blocks * TRAV_THREADS;
  return (int)err;
}
