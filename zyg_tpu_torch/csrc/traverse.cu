// Closest-hit and any-hit over the mesh instances: the instance walk and
// the 8-wide BLAS traversal, one thread per ray.
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
// prim, u, v, prop), but walks ~10-40 node rows (256 B each) and leaf rows
// (432 B each) gathered at random from an arena of ~40 MB (the 491,520-
// triangle trefoil), so it is bound by the latency of those dependent
// loads and by divergence between the rays of a warp, not by the bytes of
// its inputs. Design, simple first: one thread walks one ray from start to
// end with its stack in local memory (sized from the arena's depth: the
// wrapper passes max_depth + 1, at most TRAV_MAX_STACK); dead lanes
// (tmax <= 0) return at once; any-hit returns at the first hit. A stack
// overflow or a runaway walk sets a flag that the wrapper turns into an
// exception; it never truncates a walk silently.
#include <cstdint>
#include <cuda_runtime.h>

#include "prop_hit.cuh"

#define TRAV_MAX_STACK 32
#define TRAV_B 8  // children per wide node
#define TRAV_LEAF 12  // triangles per leaf row
#define TRAV_MAX_STEPS 65536

namespace {

constexpr int kMissKey = 0x7F800000;
constexpr float kBig = 3.4e38f;

struct TravArgs {
  const float* node_rows;  // [W, 64]
  const float* tri_rows;  // [G, 108]
  const float* wmin;  // [I, 3]
  const float* wmax;  // [I, 3]
  const float* trafo;  // [I, 24]
  const uint8_t* vis;  // [I, 3] camera / reflection / shadow
  const float* o;  // [N, 3]
  const float* d;  // [N, 3]
  const float* tmax;  // [N]
  const uint8_t* primary;  // [N] or null
  int* err;  // [1] bit 0: stack overflow, bit 1: runaway walk
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

struct Best {
  float t, u, v;
  int prim;
};

// one instance's BLAS walk in object space; updates best only with
// strictly closer hits. Returns 1 if it found one, 0 if not, -1 if the
// walk had to stop early (the error flag is set).
__device__ int walk_blas(const TravArgs& a, int root, F3 o, F3 d, Best& best) {
  const F3 inv{inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
  int stack[TRAV_MAX_STACK];
  int sp = 0;
  int node = root;
  int mask = (1 << TRAV_B) - 1;
  int found = 0;
  for (int step = 0; step < TRAV_MAX_STEPS; ++step) {
    if (node >= 0) {
      // ---- wide node: slab-test the children, key the eligible ones
      const float* row = a.node_rows + (int64_t)node * (8 * TRAV_B);
      int keys[TRAV_B];
#pragma unroll
      for (int b = 0; b < TRAV_B; ++b) {
        const float lox = (row[0 * TRAV_B + b] - o.x) * inv.x;
        const float loy = (row[1 * TRAV_B + b] - o.y) * inv.y;
        const float loz = (row[2 * TRAV_B + b] - o.z) * inv.z;
        const float hix = (row[3 * TRAV_B + b] - o.x) * inv.x;
        const float hiy = (row[4 * TRAV_B + b] - o.y) * inv.y;
        const float hiz = (row[5 * TRAV_B + b] - o.z) * inv.z;
        const float near = zmax(zmax(zmin(lox, hix), zmin(loy, hiy)), zmin(loz, hiz));
        const float far = zmin(zmin(zmax(lox, hix), zmax(loy, hiy)), zmax(loz, hiz));
        const float nearc = zmax(zmax(near, a.tmin), 0.0f);
        const bool hit = (nearc <= far) & (row[6 * TRAV_B + b] != -1.0f) & (nearc < best.t);
        const bool elig = hit & (((mask >> b) & 1) != 0);
        keys[b] = elig ? ((__float_as_int(nearc) & ~(TRAV_B - 1)) | b) : (kMissKey | b);
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
          if (sp >= a.stack_d) {
            atomicOr(a.err, 1);
            return -1;
          }
          const int cref2 = (int)row[6 * TRAV_B + (key2 & (TRAV_B - 1))];
          stack[sp++] = __popc(rem) == 1 ? cref2 * 2 + 1 : (node * 256 + rem) * 2;
        }
        node = (int)row[6 * TRAV_B + slot];
        mask = (1 << TRAV_B) - 1;
        continue;
      }
    } else {
      // ---- leaf: Moller-Trumbore over its triangles (lowest slot wins a tie)
      const int g = -node - 2;
      const float* tr = a.tri_rows + (int64_t)g * (9 * TRAV_LEAF);
      float t16 = kBig, u16 = 0.0f, v16 = 0.0f;
      int jj = 0;
      for (int j = 0; j < TRAV_LEAF; ++j) {
        const float* r = tr + 9 * j;
        const F3 p0{r[0], r[1], r[2]}, e1{r[3], r[4], r[5]}, e2{r[6], r[7], r[8]};
        const F3 pvec = cross(d, e2);
        const float det = dot(e1, pvec);
        const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
        const F3 tvec{o.x - p0.x, o.y - p0.y, o.z - p0.z};
        const float u = dot(tvec, pvec) * inv_det;
        const F3 qvec = cross(tvec, e1);
        const float v = dot(d, qvec) * inv_det;
        const float t = dot(e2, qvec) * inv_det;
        const bool hit = (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t >= a.tmin) &
                         (t <= best.t) & (fabsf(det) > 1e-12f);
        const float tm = hit ? t : kBig;
        if (j == 0 || tm < t16) {
          t16 = tm;
          u16 = u;
          v16 = v;
          jj = j;
        }
      }
      if (t16 < best.t) {
        best.t = t16;
        best.u = u16;
        best.v = v16;
        best.prim = g * TRAV_LEAF + jj;
        found = 1;
        if (a.any_hit) return 1;
      }
    }
    // ---- resume the innermost continuation, or finish
    if (sp == 0) return found;
    const int top = stack[--sp];
    if (top & 1) {
      node = (top - 1) >> 1;  // direct child ref (a leaf ref is negative)
      mask = (1 << TRAV_B) - 1;
    } else {
      node = (top >> 1) / 256;
      mask = (top >> 1) % 256;
    }
  }
  atomicOr(a.err, 2);
  return -1;
}

__global__ void __launch_bounds__(128) traverse_kernel(TravArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const F3 o{a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2]};
  const F3 d{a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2]};
  Best best{a.tmax[i], 0.0f, 0.0f, -1};
  int prop = -1;
  // dead lanes (tmax = 0) and NaN bounds cannot enter any instance
  if (best.t > 0.0f) {
    const bool prim_ray = a.primary != nullptr && a.primary[i] != 0;
    const F3 inv{inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
    float last_t = -1.0f;
    int last_i = -1;
    for (int round = 0; round < a.ninst; ++round) {
      // nearest eligible instance strictly after (last_t, last_i)
      float bt = kBig;
      int bi = -1;
      for (int k = 0; k < a.ninst; ++k) {
        const float* lo = a.wmin + 3 * k;
        const float* hi = a.wmax + 3 * k;
        const float lx = (lo[0] - o.x) * inv.x, hx = (hi[0] - o.x) * inv.x;
        const float ly = (lo[1] - o.y) * inv.y, hy = (hi[1] - o.y) * inv.y;
        const float lz = (lo[2] - o.z) * inv.z, hz = (hi[2] - o.z) * inv.z;
        const float near = zmax(zmax(zmin(lx, hx), zmin(ly, hy)), zmin(lz, hz));
        const float far = zmin(zmin(zmax(lx, hx), zmax(ly, hy)), zmax(lz, hz));
        const float nearc = zmax(zmax(near, a.tmin), 0.0f);
        const bool vis = a.vis[3 * k + (prim_ray ? 0 : a.vis_col)] != 0;
        const bool elig = (nearc <= far) & vis & (nearc < best.t) &
                          ((nearc > last_t) | ((nearc == last_t) & (k > last_i)));
        const float te = elig ? nearc : kBig;
        if (te < bt) {
          bt = te;
          bi = k;
        }
      }
      if (bi < 0 || (a.any_hit && best.prim >= 0)) break;
      // the ray in the instance's object space (t stays in world units)
      const float* tf = a.trafo + 24 * bi;
      const float x = tf[0], y = tf[1], z = tf[2], w = tf[3];
      const float xx = 2.0f * x * x, yy = 2.0f * y * y, zz = 2.0f * z * z;
      const float xy = 2.0f * x * y, xz = 2.0f * x * z, yz = 2.0f * y * z;
      const float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
      const F3 r0{1.0f - (yy + zz), xy - wz, xz + wy};
      const F3 r1{xy + wz, 1.0f - (xx + zz), yz - wx};
      const F3 r2{xz - wy, yz + wx, 1.0f - (xx + yy)};
      const F3 rs{1.0f / tf[7], 1.0f / tf[8], 1.0f / tf[9]};
      const F3 op{o.x - tf[4], o.y - tf[5], o.z - tf[6]};
      const F3 o_l{dot(op, r0) * rs.x, dot(op, r1) * rs.y, dot(op, r2) * rs.z};
      const F3 d_l{dot(d, r0) * rs.x, dot(d, r1) * rs.y, dot(d, r2) * rs.z};
      const int found = walk_blas(a, (int)tf[20], o_l, d_l, best);
      if (found < 0) break;
      if (found) prop = (int)tf[21];
      last_t = bt;
      last_i = bi;
    }
  }
  if (a.any_hit) {
    a.blocked_out[i] = best.prim >= 0;
  } else {
    a.t_out[i] = best.t;
    a.prim_out[i] = best.prim;
    a.u_out[i] = best.u;
    a.v_out[i] = best.v;
    a.prop_out[i] = prop;
  }
}

}  // namespace

// ptrs: node_rows, tri_rows, wmin, wmax, trafo, vis, o, d, tmax, primary
// (or null), err, then t, prim, u, v, prop (closest) or blocked (any-hit)
extern "C" int zyg_traverse(void** ptrs, int ninst, int vis_col, int any_hit, int stack_d,
                            float tmin, int64_t n, void* stream) {
  if (stack_d < 1 || stack_d > TRAV_MAX_STACK || ninst < 0) return (int)cudaErrorInvalidValue;
  TravArgs a;
  a.node_rows = (const float*)ptrs[0];
  a.tri_rows = (const float*)ptrs[1];
  a.wmin = (const float*)ptrs[2];
  a.wmax = (const float*)ptrs[3];
  a.trafo = (const float*)ptrs[4];
  a.vis = (const uint8_t*)ptrs[5];
  a.o = (const float*)ptrs[6];
  a.d = (const float*)ptrs[7];
  a.tmax = (const float*)ptrs[8];
  a.primary = (const uint8_t*)ptrs[9];
  a.err = (int*)ptrs[10];
  a.t_out = any_hit ? nullptr : (float*)ptrs[11];
  a.prim_out = any_hit ? nullptr : (int32_t*)ptrs[12];
  a.u_out = any_hit ? nullptr : (float*)ptrs[13];
  a.v_out = any_hit ? nullptr : (float*)ptrs[14];
  a.prop_out = any_hit ? nullptr : (int32_t*)ptrs[15];
  a.blocked_out = any_hit ? (uint8_t*)ptrs[11] : nullptr;
  a.ninst = ninst;
  a.vis_col = vis_col;
  a.any_hit = any_hit;
  a.stack_d = stack_d;
  a.tmin = tmin;
  a.n = n;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  traverse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
