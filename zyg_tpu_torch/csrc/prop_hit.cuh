// One analytic prop's ray hit, shared by the isect and shade kernels.
//
// Port of zyg_tpu/ops/isect.py::_prop_hit (formulas 1:1 with
// zyg_tpu/scene/shapes.py). Every expression keeps the operation order of
// the plain torch version (zyg_tpu_torch/ops/isect.py::prop_hit): dot
// products are explicit fused accumulations (dot3f), divisions by a prop's
// scale are multiplications by its reciprocal, and the library is built
// with -fmad=false so nothing else is contracted. Plain and kernel then
// round alike on the card.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define ZYG_FAR 3.0e37f
#define ZYG_RAY_MAX_T 2.14748313e9f

// shape codes: zyg_tpu_torch/scene/types.py::ShapeType
enum : int {
  kCanopy = 0, kCube = 1, kDisk = 2, kDistant = 3, kDome = 4, kRectangle = 5, kSphere = 6
};

// torch.minimum / torch.maximum semantics: NaN in either operand wins
__device__ __forceinline__ float zmin(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float zmax(float a, float b) { return (a != a || a > b) ? a : b; }

// a0*b0 + a1*b1 + a2*b2 as a fused accumulation (core/fmath.py::dot3)
__device__ __forceinline__ float dot3f(float a0, float b0, float a1, float b1, float a2,
                                       float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

struct PropHit {
  float t, u, v;
  bool hit;
};

// The terms of a prop's hit test that depend on the prop alone (its plane
// distance and scale reciprocals), as prop_hit computes them inline. A
// kernel that tests many rays against one table computes them once.
struct PropConsts {
  float c[3];  // rectangle: plane distance, 1/(sx/2), 1/(sy/2); disk: plane
               // distance, 1/radius; cube: 1/sx, 1/sy, 1/sz
};

// r: the prop's table row, rot row-major [0:9], pos [9:12], scale [12:15]
__device__ __forceinline__ PropConsts prop_consts(int kind, const float* r) {
  PropConsts k{{0.0f, 0.0f, 0.0f}};
  if (kind == kRectangle || kind == kDisk) {
    k.c[0] = dot3f(r[6], r[9], r[7], r[10], r[8], r[11]);
    if (kind == kRectangle) {
      k.c[1] = 1.0f / (0.5f * r[12]);
      k.c[2] = 1.0f / (0.5f * r[13]);
    } else {
      k.c[1] = 1.0f / zmax(0.5f * r[12], 1e-20f);
    }
  } else if (kind == kCube) {
    k.c[0] = 1.0f / r[12];
    k.c[1] = 1.0f / r[13];
    k.c[2] = 1.0f / r[14];
  }
  return k;
}

// prop_hit from the prop's precomputed terms k (prop_consts)
__device__ __forceinline__ PropHit prop_hit_k(int kind, const float* r, const PropConsts& k,
                                              float ox, float oy, float oz, float dx, float dy,
                                              float dz, float tmin, float tmax) {
  const float px = r[9], py = r[10], pz = r[11];
  const float sx = r[12];
  PropHit h;
  h.u = 0.0f;
  h.v = 0.0f;
  if (kind == kRectangle || kind == kDisk) {
    const float dd = dot3f(r[6], dx, r[7], dy, r[8], dz);
    const float dist = k.c[0];
    const float no = dot3f(r[6], ox, r[7], oy, r[8], oz);
    const float t = -(no - dist) / (fabsf(dd) < 1e-20f ? 1e-20f : dd);
    const float kx = ox + t * dx - px;
    const float ky = oy + t * dy - py;
    const float kz = oz + t * dz - pz;
    bool hit;
    if (kind == kRectangle) {
      h.u = -dot3f(r[0], kx, r[1], ky, r[2], kz) * k.c[1];
      h.v = -dot3f(r[3], kx, r[4], ky, r[5], kz) * k.c[2];
      hit = (t >= tmin) & (t <= tmax) & (fabsf(h.u) <= 1.0f) & (fabsf(h.v) <= 1.0f);
    } else {
      const float l2 = dot3f(kx, kx, ky, ky, kz, kz);
      const float rr = 0.5f * sx;
      hit = (t >= tmin) & (t <= tmax) & (l2 <= rr * rr);
      const float inv_r = k.c[1];
      h.u = -dot3f(r[0], kx, r[1], ky, r[2], kz) * inv_r;
      h.v = -dot3f(r[3], kx, r[4], ky, r[5], kz) * inv_r;
    }
    h.t = hit ? t : ZYG_FAR;
    h.hit = hit;
    return h;
  }
  if (kind == kSphere) {
    const float vx = px - ox, vy = py - oy, vz = pz - oz;
    const float b = dot3f(dx, vx, dy, vy, dz, vz);
    const float rx = vx - b * dx, ry = vy - b * dy, rz = vz - b * dz;
    const float rr = 0.5f * sx;
    const float disc = rr * rr - dot3f(rx, rx, ry, ry, rz, rz);
    const bool ok = disc > 0.0f;
    const float dist = sqrtf(zmax(disc, 0.0f));
    const float t0 = b - dist;
    const float t1 = b + dist;
    const bool sel0 = ok & (t0 >= tmin) & (t0 <= tmax);
    const bool sel1 = ok & !sel0 & (t1 >= tmin) & (t1 <= tmax);
    h.t = sel0 ? t0 : (sel1 ? t1 : ZYG_FAR);
    h.hit = sel0 | sel1;
    return h;
  }
  if (kind == kCube) {
    const float wx = ox - px, wy = oy - py, wz = oz - pz;
    const float* inv_s = k.c;
    float tn = 0.0f, tf = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = dot3f(wx, r[3 * a], wy, r[3 * a + 1], wz, r[3 * a + 2]) * inv_s[a];
      const float l = dot3f(dx, r[3 * a], dy, r[3 * a + 1], dz, r[3 * a + 2]) * inv_s[a];
      const float inv = 1.0f / (fabsf(l) < 1e-20f ? (l < 0.0f ? -1e-20f : 1e-20f) : l);
      const float t_a = (-0.5f - lo) * inv;
      const float t_b = (0.5f - lo) * inv;
      const float n_a = zmin(t_a, t_b), f_a = zmax(t_a, t_b);
      tn = a == 0 ? n_a : zmax(tn, n_a);
      tf = a == 0 ? f_a : zmin(tf, f_a);
    }
    const bool hit_near = (tn <= tf) & (tn >= tmin) & (tn <= tmax);
    const bool hit_far = (tn <= tf) & !hit_near & (tf >= tmin) & (tf <= tmax);
    h.t = hit_near ? tn : (hit_far ? tf : ZYG_FAR);
    h.hit = hit_near | hit_far;
    return h;
  }
  if (kind == kDistant) {
    const float b = dot3f(r[6], dx, r[7], dy, r[8], dz);
    const float nn = dot3f(r[6], r[6], r[7], r[7], r[8], r[8]);
    const float radius = sx;
    const float det = b * b - nn + radius * radius;
    const bool hit = (b <= 0.0f) & (tmax >= ZYG_RAY_MAX_T) & (radius > 0.0f) & (det >= 0.0f);
    const float kx = dx - r[6], ky = dy - r[7], kz = dz - r[8];
    const float inv_r = 1.0f / zmax(radius, 1e-20f);
    h.u = dot3f(r[0], kx, r[1], ky, r[2], kz) * inv_r;
    h.v = dot3f(r[3], kx, r[4], ky, r[5], kz) * inv_r;
    h.t = hit ? ZYG_RAY_MAX_T : ZYG_FAR;
    h.hit = hit;
    return h;
  }
  const float cz = dot3f(r[6], dx, r[7], dy, r[8], dz);
  const bool hit = kind == kCanopy ? (tmax >= ZYG_RAY_MAX_T) & (cz >= -0.0005f)
                                   : (cz > -2.0f) & (tmax >= ZYG_RAY_MAX_T);  // dome
  h.t = hit ? ZYG_RAY_MAX_T : ZYG_FAR;
  h.hit = hit;
  return h;
}

// one prop's hit, its per-prop terms computed inline
__device__ __forceinline__ PropHit prop_hit(int kind, const float* r, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            float tmin, float tmax) {
  return prop_hit_k(kind, r, prop_consts(kind, r), ox, oy, oz, dx, dy, dz, tmin, tmax);
}
