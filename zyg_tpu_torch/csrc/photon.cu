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
// wi terms. The visits are data dependent: most lanes' cells are empty,
// and a lane visits 0 to 8 x 64 = 512 photons.
//
// Design: a group of G = 16 threads serves one lane, so a lane's
// visits spread over its group and no warp waits on one thread's serial
// scan of its longest lane.
//   Cells: thread c < 8 of the group takes cell c (its hash, its repeat
//     flag, its capped count); an exclusive scan over the group
//     (__shfl_up_sync) gives each cell's offset in the lane's flat list of
//     visits. An inactive lane, or one whose cells are all empty, writes 0
//     and its whole group exits together.
//   Visits: thread t takes visits t, t + G, t + 2G, ...: neighbouring
//     threads read neighbouring 12-byte rows of one bucket (p, wi), so a
//     group's reads coalesce. The distance and cosine tests come first; the
//     material's terms (MatTerms) and wo's (WoTerms) are computed by every
//     thread of the group when the group first meets a photon in range
//     (only a lit lane reads its material; one thread computing them into
//     shared memory measured slower), and a visit in range runs only
//     the wi-dependent lobes (shade_core.cuh::eval_terms, as kernels 3, 5
//     and 6 evaluate the BSDF). Each thread keeps its own partial RGB.
//   Sum: a __shfl_xor_sync tree over the group adds the partials; thread 0
//     writes norm * sum.
// The GGX energy fit sits in shared memory, loaded once a block.
//
// Numerics: built with -fmad=false; fmaf where the plain version (and
// XLA) fuse: the dot products and 1 - d^2 * (1/r^2). The BSDF is
// shade_core.cuh's, whose rounding is the fused kernels' (ops/shade.py),
// not the general body's (render/materials.py): the two agree to a few
// float32 ulps. The sum runs in another order than the plain version's
// (each cell from zero in bucket order, then cell by cell): each thread
// adds its visits in its own order, then the tree adds the threads'
// partials. Every term is non-negative (the cone weight, the photon's
// power and f), so a lane is lit exactly when one of its terms is
// positive, on either side, and the sums differ by float32 rounding of the
// lane's terms. Both set the kernel's tolerance against the plain version
// (ops/photon.py).
#include "shade_core.cuh"

#define PHOTON_THREADS 256
#define PHOTON_TABLE_MASK ((1u << 18) - 1u)  // ops/photon.py TABLE_BITS

namespace {

// threads a lane, within one warp: 16 measured faster than 8 and 32 on
// caustics' first-bounce lanes (PERF.md)
constexpr int kGroup = 16;

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

// a lane's shading terms: its material, their MatTerms, wo's WoTerms
struct LaneTerms {
  Mat mat;
  MatTerms mt;
  WoTerms w;
  V3 wo, ns;
};

__device__ __forceinline__ LaneTerms lane_terms(const PhotonArgs& a, const float* fit, int64_t i,
                                                V3 n) {
  LaneTerms l;
  l.wo = ld3(a.wo, i);
  l.mat.albedo = ld3(a.albedo, i);
  l.mat.f0 = ld3(a.f0, i);
  l.mat.alpha = __ldg(a.alpha + i);
  l.mat.metallic = __ldg(a.metallic + i);
  l.mat.specular = __ldg(a.specular + i);
  l.mt = mat_terms(fit, l.mat);
  l.ns = shading_normal(l.wo, n, ld3(a.geo_n, i));
  l.w = wo_terms(fit, l.mat.alpha, l.mt.f0m, l.wo, l.ns);
  return l;
}

__global__ void __launch_bounds__(PHOTON_THREADS) photon_gather_kernel(PhotonArgs a) {
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  // the lane of this thread's group, and the thread's place in it; every
  // branch below is uniform over the group, whose threads share one warp
  const int64_t i = ((int64_t)blockIdx.x * PHOTON_THREADS + threadIdx.x) / kGroup;
  const int t = threadIdx.x % kGroup;
  const unsigned mask = (0xffffffffu >> (32 - kGroup)) << ((threadIdx.x & 31) & ~(kGroup - 1));
  if (i >= a.count) return;
  if (!__ldg(a.active + i)) {
    if (t == 0) store3(a.out, i, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  const V3 pos = ld3(a.pos, i);

  // cell t (t < 8): its bucket's first row and its capped count; a repeated
  // cell (lo == hi on an axis it varies) has none
  int start = 0, cnt = 0;
  if (t < 8) {
    const int dx = (t >> 2) & 1, dy = (t >> 1) & 1, dz = t & 1;
    const float p3[3] = {pos.x, pos.y, pos.z};
    int c3[3];
    bool dup = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int lo = (int)floorf((p3[c] - a.radius) * a.inv_cell);
      const int hi = (int)floorf((p3[c] + a.radius) * a.inv_cell);
      const int d = c == 0 ? dx : (c == 1 ? dy : dz);
      dup |= d & (hi == lo);
      c3[c] = d ? hi : lo;
    }
    if (!dup) {
      const int h = cell_hash(c3[0], c3[1], c3[2]);
      start = __ldg(a.cell_start + h);
      cnt = min(__ldg(a.cell_start + h + 1) - start, a.cap);
    }
  }
  // inclusive scan over the 8 cells; thread 7 holds the lane's visits
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const int up = __shfl_up_sync(mask, incl, d, kGroup);
    if (t >= d) incl += up;
  }
  const int total = __shfl_sync(mask, incl, 7, kGroup);
  if (total == 0) {
    if (t == 0) store3(a.out, i, v3(0.0f, 0.0f, 0.0f));
    return;
  }
  // every cell's offset in the flat list and its bucket's first row
  int off[8], first[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    off[c] = __shfl_sync(mask, incl - cnt, c, kGroup);
    first[c] = __shfl_sync(mask, start, c, kGroup);
  }
  const V3 n = ld3(a.n, i);

  LaneTerms l;
  bool have_terms = false;
  V3 part = v3(0.0f, 0.0f, 0.0f);
  // visit v = base + t; the trips are the same for the whole group
  for (int base = 0; base < total; base += kGroup) {
    const int v = base + t;
    bool in_range = false;
    float d2 = 0.0f, cosw = 0.0f;
    V3 phwi = v3(0.0f, 0.0f, 0.0f);
    int64_t j = 0;
    if (v < total) {
      // the last cell whose offset is <= v holds visit v (an empty cell
      // shares its offset with the next one, and the last cell is not
      // empty when v < total)
      j = first[0] + v;
#pragma unroll
      for (int c = 1; c < 8; ++c) j = v >= off[c] ? (int64_t)first[c] + (v - off[c]) : j;
      const V3 dp = sub3(ld3(a.ph_p, j), pos);
      d2 = dot3(dp, dp);
      phwi = ld3(a.ph_wi, j);
      cosw = dot3(n, phwi);
      in_range = (d2 < a.r2) & (cosw > 0.0f);
    }
    if (!have_terms && __any_sync(mask, in_range)) {
      l = lane_terms(a, fit, i, n);
      have_terms = true;
    }
    if (in_range) {
      const float kc0 = fmaf(-d2, a.inv_r2, 1.0f);
      const float kc = kc0 * kc0;
      V3 f;
      float pdf;
      eval_terms(fit, l.mat, l.mt, l.w, l.wo, phwi, l.ns, f, pdf);
      const float c = zmax(cosw, 1e-5f);
      const V3 pw = ld3(a.ph_power, j);
      part = add3(part, v3(kc * pw.x * (f.x / c), kc * pw.y * (f.y / c), kc * pw.z * (f.z / c)));
    }
  }
#pragma unroll
  for (int d = kGroup / 2; d >= 1; d >>= 1) {
    part.x += __shfl_xor_sync(mask, part.x, d, kGroup);
    part.y += __shfl_xor_sync(mask, part.y, d, kGroup);
    part.z += __shfl_xor_sync(mask, part.z, d, kGroup);
  }
  if (t == 0) store3(a.out, i, scale3(part, a.norm));
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
  const int64_t threads = n * kGroup;
  const unsigned blocks = (unsigned)((threads + PHOTON_THREADS - 1) / PHOTON_THREADS);
  photon_gather_kernel<<<blocks, PHOTON_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
