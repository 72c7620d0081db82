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
//
// The instance level: a pick tests every instance box (forest.take's 144
// boxes, ~2.3 picks a ray), which a lane alone loops over while the rest
// of its warp waits, walking or not. The kernel has two forms, chosen per
// launch from the table's size:
// - the warp pick (kWarpPickMin instances or more): the lanes that pick
//   in a step are served one after another by the whole warp: thread j
//   tests boxes j, j + 32, ... of the picking ray, read from the instance
//   arrays (coalesced across the warp), keeps its nearest by strict <,
//   and two warp reductions take the least entry t's bits and then the
//   least index at that t. nearc is >= +0.0 (zmax(x, 0.0f) never returns
//   -0.0) or the ineligible kBig, and a NaN bound is ineligible, so the
//   bits order as the floats do: the pick is the serial scan's, ties at
//   one entry t going to the smallest index. When more lanes pick in a
//   step than that pays for (pickers x (ceil(ninst / 32) + 1) >= ninst,
//   in box tests), each picking lane scans the boxes alone;
// - the lane pick (fewer instances, as a scene of a few mesh props): each
//   lane scans the instance arrays alone, with no ballot of the picking
//   lanes. Measured on the card, the lane pick is as fast or faster up to
//   4 instances and the warp pick from 8 (PERF.md).
//
// Motion blur (traverse_anim_kernel, the kAnim variant): an instance row
// also holds the shutter-end transform (columns 10-19), and the ray's
// shutter time t in [0, 1] (one more float a ray) picks the transform:
// the quaternion slerped, position and scale lerped, as zyg_tpu/scene/
// trimesh.py:1145-1155 does per lane and core/vecmath.py's quat_slerp and
// lerp write it (acosf, sinf, IEEE divisions, fmaf exactly where the
// plain version fuses). The instance boxes are already the union over
// the shutter, so the pick is unchanged. It runs once an instance visit:
// ~60 operations beside the ~300 of a wide node; the static variant is
// compiled without it.
//
// Deforming meshes (the kDeform forms, traverse_deform_kernel and
// traverse_anim_deform_kernel): the arena also holds each leaf row's
// shutter-end minus shutter-start deltas (tri_rows_d), and a leaf test
// first lerps the row to the ray's shutter time, fmaf(time, trd, tr) a
// float, as the plain walk fuses it (XLA:CPU fuses the JAX walk's
// single-use product, zyg_tpu/scene/trimesh.py:894-897). It reads another
// 27 float4s a leaf visit and the ray's time once at its start. A
// template flag rather than a branch on the pointer: the static forms
// keep the code they had, and the deforming forms have kernel names and
// entry points of their own (zyg_traverse_deform,
// zyg_traverse_anim_deform), so the entry point alone picks the form and
// a trace shows which one ran; the build compiles eight forms instead of
// four (the register and SASS counts are in PERF.md).
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
constexpr int kWarpPickMin = 8;  // the fewest instances whose tables launch the warp pick

struct TravArgs {
  const float4* node_rows;  // [W, 64]
  const float4* tri_rows;  // [G, 108]
  const float4* tri_rows_d;  // [G, 108] deltas of a deforming arena, else null
  const float* wmin;  // [I, 3]
  const float* wmax;  // [I, 3]
  const float* trafo;  // [I, 24]
  const uint8_t* vis;  // [I, 3] camera / reflection / shadow
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const float* tmax;  // [N]
  const uint8_t* primary;  // [N] or null
  const float* time;  // [N] shutter times (kAnim or a deforming arena), else null
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
  float time;  // the ray's shutter time (read where a.time is given)
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
  r.time = a.time != nullptr ? __ldg(a.time + id) : 0.0f;
  r.last_t = -1.0f;
  r.last_i = -1;
  r.round = 0;
  r.walking = false;
  return true;
}

// the instance's transform at shutter time t: core/vecmath.py's
// quat_slerp of q0 -> q1 (the cos < 0 flip, the lerp above 0.9995, the
// sine weights over max(sin, 1e-12), the normalize) and lerps of the
// position and scale (fmaf(b - a, t, a))
__device__ __forceinline__ void transform_at(const float* tf, float t, float* q, float* pos,
                                             float* scale) {
  float qa[4], qb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qa[k] = __ldg(tf + k);
    qb[k] = __ldg(tf + 10 + k);
  }
  float cosom = fmaf(qa[3], qb[3], fmaf(qa[2], qb[2], fmaf(qa[1], qb[1], qa[0] * qb[0])));
  if (cosom < 0.0f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) qb[k] = -qb[k];
  }
  cosom = fabsf(cosom);
  const float om = acosf(zmin(zmax(cosom, -1.0f), 1.0f));
  const float sinom = zmax(sinf(om), 1e-12f);
  const bool close = cosom > 0.9995f;
  const float one_t = 1.0f - t;
  const float wa = close ? one_t : sinf(one_t * om) / sinom;
  const float wb = close ? t : sinf(t * om) / sinom;
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = fmaf(wa, qa[k], wb * qb[k]);
  const float norm =
      sqrtf(fmaf(out[3], out[3], fmaf(out[2], out[2], fmaf(out[1], out[1], out[0] * out[0]))));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = out[k] / norm;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p0 = __ldg(tf + 4 + k), s0 = __ldg(tf + 7 + k);
    pos[k] = fmaf(__ldg(tf + 14 + k) - p0, t, p0);
    scale[k] = fmaf(__ldg(tf + 17 + k) - s0, t, s0);
  }
}

// what a pick needs of its ray: the world ray, its box entry bound and
// the cursor of the instances it walked
struct PickRay {
  F3 o, inv;
  float best_t, last_t;
  int last_i, col;  // col: the visibility column of the ray's class
};

// instance box k as a ray of visibility column col reads it: its bounds
// and whether it is visible
struct Box {
  float lo[3], hi[3];
  bool vis;
};

__device__ __forceinline__ Box load_box(const TravArgs& a, int k, int col) {
  Box b;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b.lo[c] = __ldg(a.wmin + 3 * k + c);
    b.hi[c] = __ldg(a.wmax + 3 * k + c);
  }
  b.vis = __ldg(a.vis + 3 * k + col) != 0;
  return b;
}

// box k's clipped entry t if the ray may pick it, else kBig: entered
// (nearc <= far), visible to the ray's class, before the best hit and
// strictly after (last_t, last_i) in (entry t, index) order
__device__ __forceinline__ float box_entry(const TravArgs& a, const Box& b, int k,
                                           const PickRay& p) {
  const float lx = (b.lo[0] - p.o.x) * p.inv.x, hx = (b.hi[0] - p.o.x) * p.inv.x;
  const float ly = (b.lo[1] - p.o.y) * p.inv.y, hy = (b.hi[1] - p.o.y) * p.inv.y;
  const float lz = (b.lo[2] - p.o.z) * p.inv.z, hz = (b.hi[2] - p.o.z) * p.inv.z;
  const float near = zmax(zmax(zmin(lx, hx), zmin(ly, hy)), zmin(lz, hz));
  const float far = zmin(zmin(zmax(lx, hx), zmax(ly, hy)), zmax(lz, hz));
  const float nearc = zmax(zmax(near, a.tmin), 0.0f);
  const bool elig = (nearc <= far) & b.vis & (nearc < p.best_t) &
                    ((nearc > p.last_t) | ((nearc == p.last_t) & (k > p.last_i)));
  return elig ? nearc : kBig;
}

// the nearest eligible box of one lane's ray, the lane alone over every
// box (the first of equal entries wins): sets bt, bi, or leaves bi < 0
__device__ __forceinline__ void pick_lane(const TravArgs& a, const PickRay& p, float& bt,
                                          int& bi) {
  for (int k = 0; k < a.ninst; ++k) {
    const float te = box_entry(a, load_box(a, k, p.col), k, p);
    if (te < bt) {
      bt = te;
      bi = k;
    }
  }
}

// the nearest eligible box of each picking lane's ray, the lanes
// served one after another by the whole warp (every lane calls it;
// pickers: the ballot of the picking lanes); sets bt, bi in each picking
// lane
__device__ __forceinline__ void pick_warp(const TravArgs& a, unsigned pickers, unsigned lane,
                                          const PickRay& mine, float& bt, int& bi) {
  const unsigned big = __float_as_uint(kBig);
  while (pickers != 0) {
    const int src = __ffs(pickers) - 1;
    pickers &= pickers - 1;
    PickRay p;
    p.o = F3{__shfl_sync(kFull, mine.o.x, src), __shfl_sync(kFull, mine.o.y, src),
             __shfl_sync(kFull, mine.o.z, src)};
    p.inv = F3{__shfl_sync(kFull, mine.inv.x, src), __shfl_sync(kFull, mine.inv.y, src),
               __shfl_sync(kFull, mine.inv.z, src)};
    p.best_t = __shfl_sync(kFull, mine.best_t, src);
    p.last_t = __shfl_sync(kFull, mine.last_t, src);
    p.last_i = __shfl_sync(kFull, mine.last_i, src);
    p.col = __shfl_sync(kFull, mine.col, src);
    float tl = kBig;
    int il = -1;
    for (int k = (int)lane; k < a.ninst; k += 32) {
      const float te = box_entry(a, load_box(a, k, p.col), k, p);
      if (te < tl) {
        tl = te;
        il = k;
      }
    }
    const unsigned tb = __float_as_uint(tl);
    const unsigned tmin = __reduce_min_sync(kFull, tb);
    const unsigned kmin = __reduce_min_sync(kFull, tb == tmin ? (unsigned)il : 0xFFFFFFFFu);
    if ((int)lane == src && tmin < big) {
      bt = __uint_as_float(tmin);
      bi = (int)kmin;
    }
  }
}

// the ray enters instance bi (picked at entry t bt): its object-space ray
// for the BLAS walk (t stays in world units)
template <bool kAnim>
__device__ __forceinline__ void enter_instance(const TravArgs& a, Ray& r, F3 o, F3 d, float bt,
                                               int bi) {
  const float* tf = a.trafo + 24 * bi;
  float q[4], pos[3], scale[3];
  if constexpr (kAnim) {
    transform_at(tf, r.time, q, pos, scale);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(tf + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[k] = __ldg(tf + 4 + k);
      scale[k] = __ldg(tf + 7 + k);
    }
  }
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = 2.0f * x * x, yy = 2.0f * y * y, zz = 2.0f * z * z;
  const float xy = 2.0f * x * y, xz = 2.0f * x * z, yz = 2.0f * y * z;
  const float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
  const F3 r0{1.0f - (yy + zz), xy - wz, xz + wy};
  const F3 r1{xy + wz, 1.0f - (xx + zz), yz - wx};
  const F3 r2{xz - wy, yz + wx, 1.0f - (xx + yy)};
  const F3 rs{1.0f / scale[0], 1.0f / scale[1], 1.0f / scale[2]};
  const F3 op{o.x - pos[0], o.y - pos[1], o.z - pos[2]};
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
}

// one step of the instance's BLAS walk: a wide node or a leaf, then the
// pop. Returns -2 while the walk goes on, else its end: 1 if it found a
// closer hit, 0 if not, -1 if it had to stop early (the error flag is set).
template <bool kDeform>
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
    const float4* trd = kDeform ? a.tri_rows_d + (int64_t)g * TRAV_LEAF_F4 : nullptr;
    float t16 = kBig, u16 = 0.0f, v16 = 0.0f;
    int jj = 0;
#pragma unroll
    for (int q = 0; q < TRAV_LEAF / 4; ++q) {
      float f[36];  // 4 triangles of (p0, e1, e2)
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float4 row = __ldg(tr + 9 * q + k);
        if constexpr (kDeform) {  // a deforming leaf at the ray's shutter time
          const float4 dr = __ldg(trd + 9 * q + k);
          row = make_float4(fmaf(r.time, dr.x, row.x), fmaf(r.time, dr.y, row.y),
                            fmaf(r.time, dr.z, row.z), fmaf(r.time, dr.w, row.w));
        }
        unpack4(row, f + 4 * k);
      }
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

// a ray between two instances that cannot pick: its rounds are spent, or
// an any-hit ray has its hit
__device__ __forceinline__ bool pick_done(const TravArgs& a, const Ray& r) {
  return r.round >= a.ninst || (a.any_hit && r.best.prim >= 0);
}

// what the pick needs of lane r's ray (the world ray read again)
__device__ __forceinline__ PickRay pick_ray(const TravArgs& a, const Ray& r, F3& o, F3& d) {
  const int64_t id = r.id;
  o = F3{__ldg(a.o + 3 * id), __ldg(a.o + 3 * id + 1), __ldg(a.o + 3 * id + 2)};
  d = F3{__ldg(a.d + 3 * id), __ldg(a.d + 3 * id + 1), __ldg(a.d + 3 * id + 2)};
  return PickRay{o, inv3(d), r.best.t, r.last_t, r.last_i, r.prim_ray ? 0 : a.vis_col};
}

// after a pick: a ray with no eligible instance is done, else it enters bi
template <bool kAnim>
__device__ __forceinline__ void end_pick(const TravArgs& a, Ray& r, F3 o, F3 d, float bt,
                                         int bi) {
  if (bi < 0) {
    finish(a, r);
    r.id = -1;
  } else {
    enter_instance<kAnim>(a, r, o, d, bt, bi);
  }
}

// kWarpPick: the warp pick's form; else the lane pick's
template <bool kAnim, bool kDeform, bool kWarpPick>
__device__ __forceinline__ void traverse_run(const TravArgs& a, int* const stack) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const int box_rounds = (a.ninst + 31) >> 5;  // a warp pick's box tests a thread
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
    // ---- the lanes between two instances pick the nearest eligible one
    // strictly after (last_t, last_i), or end their ray
    if constexpr (kWarpPick) {
      bool picking = r.id >= 0 && !r.walking;
      if (picking && pick_done(a, r)) {
        finish(a, r);
        r.id = -1;
        picking = false;
      }
      const unsigned pickers = __ballot_sync(kFull, picking);
      if (pickers != 0) {
        F3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 0.0f};
        PickRay p;  // read only from the picking lanes
        if (picking) p = pick_ray(a, r, o, d);
        float bt = kBig;
        int bi = -1;
        if (__popc(pickers) * (box_rounds + 1) < a.ninst) {
          pick_warp(a, pickers, lane, p, bt, bi);
        } else if (picking) {
          pick_lane(a, p, bt, bi);
        }
        if (picking) end_pick<kAnim>(a, r, o, d, bt, bi);
      }
    } else if (r.id >= 0 && !r.walking) {
      if (pick_done(a, r)) {
        finish(a, r);
        r.id = -1;
      } else {
        F3 o, d;
        const PickRay p = pick_ray(a, r, o, d);
        float bt = kBig;
        int bi = -1;
        pick_lane(a, p, bt, bi);
        end_pick<kAnim>(a, r, o, d, bt, bi);
      }
    }
    // ---- one step of this lane's walk
    if (r.id < 0) continue;
    const int end = walk_step<kDeform>(a, r, stack);
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

template <bool kWarpPick>
__global__ void __launch_bounds__(TRAV_THREADS) traverse_kernel(TravArgs a) {
  __shared__ int stack_s[TRAV_MAX_STACK * TRAV_THREADS];
  traverse_run<false, false, kWarpPick>(a, stack_s + threadIdx.x);
}

template <bool kWarpPick>
__global__ void __launch_bounds__(TRAV_THREADS) traverse_anim_kernel(TravArgs a) {
  __shared__ int stack_s[TRAV_MAX_STACK * TRAV_THREADS];
  traverse_run<true, false, kWarpPick>(a, stack_s + threadIdx.x);
}

template <bool kWarpPick>
__global__ void __launch_bounds__(TRAV_THREADS) traverse_deform_kernel(TravArgs a) {
  __shared__ int stack_s[TRAV_MAX_STACK * TRAV_THREADS];
  traverse_run<false, true, kWarpPick>(a, stack_s + threadIdx.x);
}

template <bool kWarpPick>
__global__ void __launch_bounds__(TRAV_THREADS) traverse_anim_deform_kernel(TravArgs a) {
  __shared__ int stack_s[TRAV_MAX_STACK * TRAV_THREADS];
  traverse_run<true, true, kWarpPick>(a, stack_s + threadIdx.x);
}

}  // namespace

// ptrs: node_rows, tri_rows, wmin, wmax, trafo, vis, o, d, tmax, primary
// (or null), err, the ray counter, then t, prim, u, v, prop (closest) or
// blocked (any-hit), then the rays' shutter times (read by the anim and
// deforming forms, else unread) and the arena's leaf deltas (read by the
// deforming forms, else unread)
static int launch_traverse(bool anim, bool deform, void** ptrs, int ninst, int vis_col,
                           int any_hit, int stack_d, float tmin, int64_t n, void* stream) {
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
  a.time = anim || deform ? (const float*)ptrs[any_hit ? 13 : 17] : nullptr;
  a.tri_rows_d = deform ? (const float4*)ptrs[any_hit ? 14 : 18] : nullptr;
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
  if (((uintptr_t)a.node_rows | (uintptr_t)a.tri_rows | (uintptr_t)a.tri_rows_d) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  if ((anim || deform) && a.time == nullptr) return (int)cudaErrorInvalidValue;
  if (deform && a.tri_rows_d == nullptr) return (int)cudaErrorInvalidValue;
  const bool wp = ninst >= kWarpPickMin;
  void (*const kernel)(TravArgs) =
      deform
          ? (anim ? (wp ? traverse_anim_deform_kernel<true> : traverse_anim_deform_kernel<false>)
                  : (wp ? traverse_deform_kernel<true> : traverse_deform_kernel<false>))
          : (anim ? (wp ? traverse_anim_kernel<true> : traverse_anim_kernel<false>)
                  : (wp ? traverse_kernel<true> : traverse_kernel<false>));
  int resident = 0;
  cudaError_t err = resident_blocks((const void*)kernel, TRAV_THREADS, &resident);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.next, 0, sizeof(unsigned long long), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + TRAV_THREADS - 1) / TRAV_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  kernel<<<blocks, TRAV_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int zyg_traverse(void** ptrs, int ninst, int vis_col, int any_hit, int stack_d,
                            float tmin, int64_t n, void* stream) {
  return launch_traverse(false, false, ptrs, ninst, vis_col, any_hit, stack_d, tmin, n, stream);
}

// the motion-blur variant: ptrs as zyg_traverse's (the shutter times given)
extern "C" int zyg_traverse_anim(void** ptrs, int ninst, int vis_col, int any_hit, int stack_d,
                                 float tmin, int64_t n, void* stream) {
  return launch_traverse(true, false, ptrs, ninst, vis_col, any_hit, stack_d, tmin, n, stream);
}

// the deforming forms: ptrs as zyg_traverse's (the shutter times and the
// leaf deltas given), over a static table and over a moving one
extern "C" int zyg_traverse_deform(void** ptrs, int ninst, int vis_col, int any_hit,
                                   int stack_d, float tmin, int64_t n, void* stream) {
  return launch_traverse(false, true, ptrs, ninst, vis_col, any_hit, stack_d, tmin, n, stream);
}

extern "C" int zyg_traverse_anim_deform(void** ptrs, int ninst, int vis_col, int any_hit,
                                        int stack_d, float tmin, int64_t n, void* stream) {
  return launch_traverse(true, true, ptrs, ninst, vis_col, any_hit, stack_d, tmin, n, stream);
}

// the lanes one pass of the resident grid covers on the current device:
// the larger of the two forms' (the lane pick's and the warp pick's)
static int resident_lanes_of(const void* lane_form, const void* warp_form, int64_t* out) {
  int64_t lane = 0, warp = 0;
  cudaError_t err = resident_lanes(lane_form, TRAV_THREADS, &lane);
  if (err == cudaSuccess) err = resident_lanes(warp_form, TRAV_THREADS, &warp);
  *out = lane > warp ? lane : warp;
  return (int)err;
}

extern "C" int zyg_traverse_resident_lanes(int64_t* out) {
  return resident_lanes_of((const void*)traverse_kernel<false>, (const void*)traverse_kernel<true>,
                           out);
}

extern "C" int zyg_traverse_anim_resident_lanes(int64_t* out) {
  return resident_lanes_of((const void*)traverse_anim_kernel<false>,
                           (const void*)traverse_anim_kernel<true>, out);
}

extern "C" int zyg_traverse_deform_resident_lanes(int64_t* out) {
  return resident_lanes_of((const void*)traverse_deform_kernel<false>,
                           (const void*)traverse_deform_kernel<true>, out);
}

extern "C" int zyg_traverse_anim_deform_resident_lanes(int64_t* out) {
  return resident_lanes_of((const void*)traverse_anim_deform_kernel<false>,
                           (const void*)traverse_anim_deform_kernel<true>, out);
}
