// The photon-map gather: the cone-filtered density estimate of the
// photons near each shading point, through the substitute BSDF.
//
// Replaces an XLA loop of the JAX package (not a TPU kernel):
// zyg_tpu/render/integrator/photon.py:219-271 (`gather`, a
// lax.fori_loop over min(max_per_cell, 64) photons in each of the 8 hash
// cells a radius-r sphere can touch, evaluating the BSDF toward each).
// The plain torch version, with the same arithmetic, is
// zyg_tpu_torch/ops/photon.py::photon_gather_plain.
//
// Per lane: the cells (cell edge 2r) of floor((pos -+ r) / 2r) on each
// axis, in the JAX order (x outer, z inner), a cell that repeats another
// (lo == hi on an axis it varies) skipped; each cell's bucket
// [cell_start[h], cell_start[h + 1]) of the photons sorted by their cell
// hash h, capped at max_per_cell photons; a photon within r on the front
// of the shading normal adds (1 - d^2 / r^2)^2 * power * f / cos, where
// f * cos is the substitute BSDF toward the photon's direction; each
// cell's part is summed from zero in bucket order and then added to the
// lane's sum, which is scaled by norm = 1 / (pi/3 * paths * r^2) at the
// end. An inactive lane writes 0.
//
// What bounds it on an H100: a lane reads 85 bytes (point, directions,
// normals, material) and writes 12; a photon visit reads 36 bytes (point,
// direction, power) of a map that fits L2 on a caustic take (~1,200 valid
// photons) and spends ~200 operations on the distance test and the BSDF's
// wi terms. The visits are data dependent: most lanes' cells are empty.
// Design, a simple kernel: one thread a lane, 128 threads a block, the
// GGX energy fit in shared memory; the material's terms (MatTerms) and
// wo's (WoTerms) are computed once a lane, and only the wi-dependent
// lobes run per photon (shade_core.cuh::eval_terms, as kernels 3, 5 and 6
// evaluate the BSDF). The photon's distance and cosine tests come first,
// so a photon out of range costs 24 bytes and ~12 operations.
//
// Numerics: built with -fmad=false; fmaf where the plain version (and
// XLA) fuse: the dot products and 1 - d^2 * (1/r^2). The BSDF is
// shade_core.cuh's, whose rounding is the fused kernels' (ops/shade.py),
// not the general body's (render/materials.py): the two agree to a few
// float32 ulps, which sets the kernel's tolerance against the plain
// version (ops/photon.py).
#include "shade_core.cuh"

#define PHOTON_THREADS 128
#define PHOTON_TABLE_MASK ((1u << 18) - 1u)  // ops/photon.py TABLE_BITS

namespace {

struct PhotonArgs {
  const float* fit;
  // lanes
  const float* pos;
  const float* wo;
  const float* n;
  const float* geo_n;
  const uint8_t* active;
  const float* albedo;
  const float* f0;
  const float* alpha;
  const float* metallic;
  const float* specular;
  // the map, sorted by cell hash
  const float* ph_p;
  const float* ph_wi;
  const float* ph_power;
  const int32_t* cell_start;
  float* out;
  float radius, inv_cell, r2, inv_r2, norm;
  int cap;
  int64_t count;
};

// ops/photon.py::cell_hash: uint32 products that wrap, low 18 bits
__device__ __forceinline__ int cell_hash(int ix, int iy, int iz) {
  const uint32_t h = ((uint32_t)ix * 73856093u) ^ ((uint32_t)iy * 19349663u) ^
                     ((uint32_t)iz * 83492791u);
  return (int)(h & PHOTON_TABLE_MASK);
}

__global__ void __launch_bounds__(PHOTON_THREADS) photon_gather_kernel(PhotonArgs a) {
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.count) return;
  if (!__ldg(a.active + i)) {
    store3(a.out, i, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  const V3 pos = ld3(a.pos, i);
  const V3 wo = ld3(a.wo, i);
  const V3 n = ld3(a.n, i);
  Mat mat;
  mat.albedo = ld3(a.albedo, i);
  mat.f0 = ld3(a.f0, i);
  mat.alpha = __ldg(a.alpha + i);
  mat.metallic = __ldg(a.metallic + i);
  mat.specular = __ldg(a.specular + i);
  const MatTerms mt = mat_terms(fit, mat);
  const V3 ns = shading_normal(wo, n, ld3(a.geo_n, i));
  const WoTerms w = wo_terms(fit, mat.alpha, mt.f0m, wo, ns);

  const float p3[3] = {pos.x, pos.y, pos.z};
  int lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = (int)floorf((p3[c] - a.radius) * a.inv_cell);
    hi[c] = (int)floorf((p3[c] + a.radius) * a.inv_cell);
  }
  V3 res = v3(0.0f, 0.0f, 0.0f);
  for (int cell = 0; cell < 8; ++cell) {
    const int dx = (cell >> 2) & 1, dy = (cell >> 1) & 1, dz = cell & 1;
    // a repeated cell (lo == hi on an axis this one varies) adds nothing
    if ((dx & (hi[0] == lo[0])) | (dy & (hi[1] == lo[1])) | (dz & (hi[2] == lo[2]))) continue;
    const int h = cell_hash(dx ? hi[0] : lo[0], dy ? hi[1] : lo[1], dz ? hi[2] : lo[2]);
    const int start = __ldg(a.cell_start + h);
    const int end = __ldg(a.cell_start + h + 1);
    const int cnt = min(end - start, a.cap);
    V3 part = v3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < cnt; ++k) {
      const int64_t j = start + k;
      const V3 dp = sub3(ld3(a.ph_p, j), pos);
      const float d2 = dot3(dp, dp);
      const V3 phwi = ld3(a.ph_wi, j);
      const float cosw = dot3(n, phwi);
      if (!((d2 < a.r2) & (cosw > 0.0f))) continue;
      const float kc0 = fmaf(-d2, a.inv_r2, 1.0f);
      const float kc = kc0 * kc0;
      V3 f;
      float pdf;
      eval_terms(fit, mat, mt, w, wo, phwi, ns, f, pdf);
      const float c = zmax(cosw, 1e-5f);
      const V3 pw = ld3(a.ph_power, j);
      part = add3(part, v3(kc * pw.x * (f.x / c), kc * pw.y * (f.y / c), kc * pw.z * (f.z / c)));
    }
    res = add3(res, part);
  }
  store3(a.out, i, scale3(res, a.norm));
}

}  // namespace

// ptrs: fit, the 10 lane inputs (pos, wo, n, geo_n, active, albedo, f0,
// alpha, metallic, specular), the map (p, wi, power, cell_start), out
// (ops/photon.py LANE_FIELDS); scal: radius, inv_cell, r2,
// inv_r2, norm
extern "C" int zyg_photon_gather(void** ptrs, const float* scal, int cap, int64_t n,
                                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  PhotonArgs a;
  int k = 0;
  a.fit = (const float*)ptrs[k++];
  a.pos = (const float*)ptrs[k++];
  a.wo = (const float*)ptrs[k++];
  a.n = (const float*)ptrs[k++];
  a.geo_n = (const float*)ptrs[k++];
  a.active = (const uint8_t*)ptrs[k++];
  a.albedo = (const float*)ptrs[k++];
  a.f0 = (const float*)ptrs[k++];
  a.alpha = (const float*)ptrs[k++];
  a.metallic = (const float*)ptrs[k++];
  a.specular = (const float*)ptrs[k++];
  a.ph_p = (const float*)ptrs[k++];
  a.ph_wi = (const float*)ptrs[k++];
  a.ph_power = (const float*)ptrs[k++];
  a.cell_start = (const int32_t*)ptrs[k++];
  a.out = (float*)ptrs[k++];
  a.radius = scal[0];
  a.inv_cell = scal[1];
  a.r2 = scal[2];
  a.inv_r2 = scal[3];
  a.norm = scal[4];
  a.cap = cap;
  a.count = n;
  const unsigned blocks = (unsigned)((n + PHOTON_THREADS - 1) / PHOTON_THREADS);
  photon_gather_kernel<<<blocks, PHOTON_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
