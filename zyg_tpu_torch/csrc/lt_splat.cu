// The lighttracer's camera splat: at each vertex of a light path that
// connects to the camera, the substitute BSDF toward the camera and the
// contribution cam_pdf * throughput * f added to the vertex's pixel.
//
// Replaces an XLA scatter of the JAX package (not a TPU kernel):
// zyg_tpu/render/integrator/lighttracer.py:287-308 (the BSDF toward the
// camera, `connect`, and splat.at[ids].add(contrib) in the loop of light
// bounces). The plain torch version is
// zyg_tpu_torch/ops/lt_splat.py::lt_splat_plain.
//
// Per lane: where `connect` holds (every test of the JAX `connect` but
// the BSDF's) on a Substitute material, f toward wi (the camera) through
// shade_core.cuh's eval_terms, as the fused kernels and the photon
// gather evaluate it; the lane connects where max(f) > 0, and adds
// (cam_pdf * tp.x * f.x, ...) to splat[ids] with one float4 atomic where
// its shadow ray is not blocked. Other material kinds (smooth glass,
// Light) have f = 0 and add nothing. The connecting lanes are counted
// into *count (one atomic a warp).
//
// What bounds it on an H100: bytes. Every lane reads its connect flag
// (1 B); a connecting lane its directions, normals, material, kind,
// throughput, pdf, pixel and blocked flag (~97 B) and adds 16 B by one
// vector atomic into a [P, 4] splat that stays in L2 (4 MB at 512x512).
// A Cornell vertex lands on a pixel of the frame nearly at random, so
// the atomics scatter; their rate, not the bytes, may bind (the filtered
// flush's ran at 41.2 G float4 atomics/s). A first bounce's ~160,000
// atomics are not the limit (the tap-major filtered flush adds ~70 G/s);
// the latency of the reads is: a thread that reads `connect`, then
// `kind`, then the rest, then evaluates and adds, waits three times, and
// a thread a lane at the BSDF's ~150 registers leaves ~12 warps an SM to
// cover those waits.
// Design:
// - every lane's inputs are read at once, before the BSDF, and the BSDF
//   is evaluated on every lane in range and masked after (a warp's
//   coalesced reads fetch its lines for its candidates anyway, and ~80 %
//   of a first bounce's lanes are candidates): one wait a lane;
// - __launch_bounds__(LT_SPLAT_THREADS, LT_SPLAT_MIN_BLOCKS) holds the
//   registers to what that many resident blocks allow, with no spill;
// - the grid is the card's resident blocks striding over the lanes, so
//   each block loads the GGX energy fit into shared memory once; a launch
//   on fewer lanes (the later bounces) takes one block per 128 lanes;
// - a warp counts its connecting lanes by ballot over its strides and adds
//   them with one atomic at the end. The ballots see the full mask: every
//   thread of a block runs the same strides.
//
// Numerics: built with -fmad=false; the BSDF rounds as shade_core.cuh
// rounds it (the fused kernels' order), a few float32 ulps from
// render/materials.py's; the atomics add in another order than the plain
// version's index_add_.
#include "launch.cuh"
#include "shade_core.cuh"

#define LT_SPLAT_THREADS 128
// resident blocks an SM the registers must allow: at 3 the kernel takes
// 154 registers with no spill; 4 (128 registers) spilled 112 B and 5
// more, both slower
#define LT_SPLAT_MIN_BLOCKS 3

namespace {

struct LtSplatArgs {
  const float* fit;
  const float* wo;
  const float* wi;
  const float* n;
  const float* geo_n;
  const int32_t* kind;
  const float* albedo;
  const float* f0;
  const float* alpha;
  const float* metallic;
  const float* specular;
  const float* throughput;
  const float* cam_pdf;
  const int64_t* ids;
  const uint8_t* connect;
  const uint8_t* blocked;
  float* splat;  // [pixels, 4]: R, G, B, 0
  unsigned long long* count;
  int64_t lanes;
};

__global__ void __launch_bounds__(LT_SPLAT_THREADS, LT_SPLAT_MIN_BLOCKS)
    lt_splat_kernel(LtSplatArgs a) {
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned conns = 0;  // the warp's connecting lanes so far
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < a.lanes; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool conn = false;
    if (i < a.lanes) {
      const bool cand = (__ldg(a.connect + i) != 0) & (__ldg(a.kind + i) == 0);
      const bool blocked = __ldg(a.blocked + i) != 0;
      const V3 wo = ld3(a.wo, i);
      const V3 wi = ld3(a.wi, i);
      const V3 n = ld3(a.n, i);
      const V3 geo_n = ld3(a.geo_n, i);
      Mat mat;
      mat.albedo = ld3(a.albedo, i);
      mat.f0 = ld3(a.f0, i);
      mat.alpha = __ldg(a.alpha + i);
      mat.metallic = __ldg(a.metallic + i);
      mat.specular = __ldg(a.specular + i);
      const float cp = __ldg(a.cam_pdf + i);
      const V3 tp = ld3(a.throughput, i);
      const int64_t pix = __ldg(a.ids + i);
      // render/materials.py _SUBSTITUTE: the kind eval_bsdf evaluates here;
      // the other lanes' values are masked
      const MatTerms mt = mat_terms(fit, mat);
      const V3 ns = shading_normal(wo, n, geo_n);
      const WoTerms w = wo_terms(fit, mat.alpha, mt.f0m, wo, ns);
      V3 f;
      float pdf;
      eval_terms(fit, mat, mt, w, wo, wi, ns, f, pdf);
      conn = cand && max3(f) > 0.0f;
      if (conn && !blocked) {
        atomicAdd(reinterpret_cast<float4*>(a.splat + 4 * pix),
                  make_float4(cp * tp.x * f.x, cp * tp.y * f.y, cp * tp.z * f.z, 0.0f));
      }
    }
    conns += __popc(__ballot_sync(0xffffffffu, conn));
  }
  if ((threadIdx.x & 31) == 0 && conns != 0u) atomicAdd(a.count, (unsigned long long)conns);
}

}  // namespace

// ptrs: fit, the 15 lane inputs (wo, wi, n, geo_n, kind, albedo, f0,
// alpha, metallic, specular, throughput, cam_pdf, ids, connect, blocked;
// ops/lt_splat.py LANE_FIELDS), splat [pixels, 4], count (int64)
extern "C" int zyg_lt_splat(void** ptrs, int64_t lanes, int64_t pixels, void* stream) {
  if (lanes < 1 || pixels < 1) return (int)cudaErrorInvalidValue;
  LtSplatArgs a;
  int k = 0;
  a.fit = (const float*)ptrs[k++];
  a.wo = (const float*)ptrs[k++];
  a.wi = (const float*)ptrs[k++];
  a.n = (const float*)ptrs[k++];
  a.geo_n = (const float*)ptrs[k++];
  a.kind = (const int32_t*)ptrs[k++];
  a.albedo = (const float*)ptrs[k++];
  a.f0 = (const float*)ptrs[k++];
  a.alpha = (const float*)ptrs[k++];
  a.metallic = (const float*)ptrs[k++];
  a.specular = (const float*)ptrs[k++];
  a.throughput = (const float*)ptrs[k++];
  a.cam_pdf = (const float*)ptrs[k++];
  a.ids = (const int64_t*)ptrs[k++];
  a.connect = (const uint8_t*)ptrs[k++];
  a.blocked = (const uint8_t*)ptrs[k++];
  a.splat = (float*)ptrs[k++];
  a.count = (unsigned long long*)ptrs[k++];
  a.lanes = lanes;
  int resident = 0;
  const cudaError_t err =
      resident_blocks((const void*)lt_splat_kernel, LT_SPLAT_THREADS, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (lanes + LT_SPLAT_THREADS - 1) / LT_SPLAT_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  lt_splat_kernel<<<blocks, LT_SPLAT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
