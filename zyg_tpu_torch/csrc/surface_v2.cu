// The general shade core between the gathers and the shadow walk (kernel 6).
//
// Replaces the TPU kernel zyg_tpu/ops/shade.py::_make_surface_kernel_v2
// (launched by make_mesh_fused_body_v2 -> _run_surface_v2, pallas_call at
// :1504). The torch glue has already intersected the scene, built the
// fragment, gathered the hit material's parameters (textures included),
// evaluated the BSDF-hit emission with its light pdf, and sampled the NEE
// candidate (direction, radiance, pdf, shadow tmax) for any light type.
// Per lane this kernel does the rest: the MIS weight of the BSDF-hit
// emission -> russian roulette -> the substitute BSDF evaluation of the
// NEE candidate with the predivided power heuristic -> the VNDF/cosine
// BSDF sample -> the PathState merge. It emits nee_active, the pending NEE
// value and the shadow tmax for the any-hit walks that follow. Every
// expression follows zyg_tpu_torch/ops/surface_v2.py::surface_v2_plain in
// its operation order, with the device functions it shares with the other
// bounces (shade_core.cuh): explicit fmaf where the plain version calls
// core/fmath.py, built with -fmad=false.
//
// What bounds it on an H100: a lane that reaches NEE reads 249 bytes
// (path state, fragment, material, emission and NEE candidate, four
// uniforms) and every lane writes 126, ~0.35 GB at the mesh path's 921,600
// lanes (~0.10 ms at 3.35 TB/s), against ~2k floating-point operations
// (~0.03 ms at the float32 peak): bytes first, then the latency of the
// BSDF's dependent chains. A first version that loaded all 249 bytes of
// every lane at the top needed 198 registers (8 warps an SM), recomputed
// the material's energy-fit terms twice and ran the whole shade core for
// every lane, though in a render most lanes are dead or end before NEE.
//
// Design, one thread per lane, in two parts, as the mesh bounce's
// (surface.cu, which says why; the parts they share are in
// shade_core.cuh):
// - the head loads, in one batch, what a lane needs to decide whether it
//   goes on (alive, the hit, the material's kind, the emission, u_rr) and
//   what a lane that stops writes through (its path state); it adds the
//   BSDF-hit emission with its MIS weight and plays russian roulette. A
//   lane dead on entry or ended there stores its path state through,
//   alive 0, nee_active 0, shadow tmax 0 and a zero NEE value, and reads
//   none of the material beyond its kind, the NEE candidate, the
//   fragment's normals or the BSDF uniforms;
// - the tail, for the lanes that go on, loads its inputs in one batch,
//   computes the material's terms (MatTerms: the material is textured per
//   lane, so there is no table) and the wo terms (WoTerms) once for both
//   uses, evaluates the BSDF toward the glue's NEE candidate only where
//   there is one (nee_pre) and reads its radiance only where the sample is
//   active, then samples the BSDF.
// A warp skips a part none of its lanes takes. The kernel is bounded to
// SURFACE_V2_MIN_BLOCKS resident blocks of 128, and the grid is sized to
// the resident blocks and walks the lanes in a grid-stride loop, so each
// block stages the GGX fit once.
//
// What a skipped lane leaves behind: its throughput and bxdf_pdf are its
// INPUTS and its reg_alpha is 1, where the plain version computes values
// that nothing reads (surface.cu says why); the checks compare them on
// live lanes only. The shadow ray itself is the glue's. Every other output
// is the plain version's value. The ray count is kept per thread across
// the loop and reduced once per warp at the end.
#include "launch.cuh"
#include "shade_core.cuh"

#define SURF_V2_THREADS 128
#define SURFACE_V2_MIN_BLOCKS 3  // resident blocks per SM the registers are bounded for

namespace {

struct SurfaceV2Args {
  const float* fit;
  // path state (ops/shade.py _IN_FIELDS)
  const float* o;
  const float* d;
  const float* thr;
  const uint8_t* alive;
  const float* bxdf_pdf;
  const uint8_t* singular;
  const int32_t* depth;
  const float* mis_o;
  const float* mis_n;
  const float* res_em;
  const float* res_di;
  const float* res_in;
  // fragment (ops/surface_v2.py FRAG_FIELDS)
  const uint8_t* finite;
  const float* p;
  const float* geo_n;
  const float* n;
  // material (MAT_FIELDS)
  const int32_t* mat_kind;
  const float* albedo;
  const float* alpha;
  const float* metallic;
  const float* f0;
  const float* specular;
  // emission and the NEE candidate (LIGHT_FIELDS)
  const float* em;
  const float* hit_lp;
  const uint8_t* is_light;
  const float* nee_wi;
  const float* nee_rad;
  const float* nee_lpdf;
  const uint8_t* nee_pre;
  const float* nee_pre_tmax;
  const float* ua;  // [N, >=1] rows: u_rr
  const float* ub;  // [N, >=3] rows: BSDF lobe pick, xi
  // outputs (OUT_FIELDS)
  float* o_out;
  float* d_out;
  float* thr_out;
  uint8_t* alive_out;
  float* bxdf_pdf_out;
  int32_t* depth_out;
  float* mis_o_out;
  float* mis_n_out;
  float* em_out;
  float* di_out;
  float* in_out;
  float* reg_alpha_out;
  uint8_t* nee_active_out;
  float* shadow_tmax_out;
  float* nee_out;
  unsigned long long* rays;
  int64_t ua_stride, ub_stride;
  int max_depth, caustics, nee_only;
  int64_t count;
};

// a lane's shade core up to NEE: the MIS weight of the BSDF-hit emission
// and russian roulette. It loads in one batch what a lane that ends here
// writes through and what decides that, so a warp waits on memory once.
// A lane dead on entry or ended here stores all its outputs; the radiance
// sums of every lane are final here (the pending NEE value joins
// direct/indirect after the shadow walk, ops/surface_v2.py). Returns
// whether the lane goes on to NEE; adds its alive ray to rays.
__device__ __forceinline__ bool surface_v2_head(const SurfaceV2Args& a, int64_t i,
                                                unsigned& rays) {
  const bool alive = __ldg(a.alive + i) != 0;
  const Pass s = load_pass(a, i);
  V3 res_em = ld3(a.res_em, i), res_di = ld3(a.res_di, i), res_in = ld3(a.res_in, i);
  const bool singular = __ldg(a.singular + i) != 0;
  const bool is_light = __ldg(a.is_light + i) != 0;
  const float hit_lp = __ldg(a.hit_lp + i);
  const V3 em = ld3(a.em, i);  // masked by the glue
  const float u_rr = __ldg(a.ua + i * a.ua_stride);
  const bool is_sub = __ldg(a.mat_kind + i) == 0;  // MaterialKind.SUBSTITUTE
  const bool valid = __ldg(a.finite + i) != 0;
  bool go = false;
  if (alive) {
    rays += 1;
    // ---- connectLight: the MIS weight of the BSDF-hit emission
    const float mis_w =
        emission_mis(a.nee_only, a.caustics, singular, is_light, s.depth, s.bxdf_pdf, hit_lp);
    add_emission(res_em, res_di, res_in, s.thr, em, mis_w, s.depth, singular);
    // ---- continuation + russian roulette
    go = valid & (s.depth < a.max_depth) & !rr_kill(s.thr, u_rr) & is_sub;
  }
  store3(a.em_out, i, res_em);
  store3(a.di_out, i, res_di);
  store3(a.in_out, i, res_in);
  if (!go) store_ended(a, i, s);
  return go;
}

// the rest of the shade core of a lane that surface_v2_head sent on: the
// BSDF evaluation of the NEE candidate and the BSDF sample with the
// PathState merge. It loads its inputs in one batch, re-reading the few
// the head used (from L2: the head read them moments before); adds the
// NEE lane to rays.
__device__ __forceinline__ void surface_v2_tail(const SurfaceV2Args& a, int64_t i,
                                                const float* fit, unsigned& rays) {
  const V3 thr0 = ld3(a.thr, i);
  Mat mat;
  mat.albedo = ld3(a.albedo, i);
  mat.alpha = __ldg(a.alpha + i);
  mat.metallic = __ldg(a.metallic + i);
  mat.f0 = ld3(a.f0, i);
  mat.specular = __ldg(a.specular + i);
  const V3 d = ld3(a.d, i);
  const V3 geo_n = ld3(a.geo_n, i);
  const V3 frag_n = ld3(a.n, i);
  const V3 p_hit = ld3(a.p, i);
  const int depth = __ldg(a.depth + i);
  const bool nee_pre = __ldg(a.nee_pre + i) != 0;
  const V3 nee_wi = ld3(a.nee_wi, i);
  const float* ub = a.ub + i * a.ub_stride;
  const float s0 = __ldg(ub), s1 = __ldg(ub + 1), s2 = __ldg(ub + 2);
  const V3 thr = rr_scaled(thr0);

  // ---- the material's and wo's BSDF terms, once for both uses
  const MatTerms mt = mat_terms(fit, mat);
  const V3 wo = neg3(d);
  const V3 ns = shading_normal(wo, frag_n, geo_n);
  const WoTerms w = wo_terms(fit, mat.alpha, mt.f0m, wo, ns);

  // ---- NEE: evaluate the glue's candidate
  V3 nee = v3(0.0f, 0.0f, 0.0f);
  bool nee_active = false;
  if (nee_pre) {
    V3 f_nee;
    float bpdf;
    eval_terms(fit, mat, mt, w, wo, nee_wi, ns, f_nee, bpdf);
    nee_active = max3(f_nee) > 0.0f;
    if (nee_active) {
      const float w_mis = predivided_power_heuristic(__ldg(a.nee_lpdf + i), bpdf);
      const V3 rad = ld3(a.nee_rad, i);
      nee = v3(thr.x * rad.x * f_nee.x * w_mis, thr.y * rad.y * f_nee.y * w_mis,
               thr.z * rad.z * f_nee.z * w_mis);
    }
  }
  a.nee_active_out[i] = nee_active;
  a.shadow_tmax_out[i] = nee_active ? __ldg(a.nee_pre_tmax + i) : 0.0f;
  store3(a.nee_out, i, nee);
  rays += nee_active ? 1u : 0u;

  // ---- BSDF sample + PathState merge
  V3 wi_s, weight;
  float pdf_s, reg_a;
  bool ok_s;
  sample_terms(fit, mat, mt, w, wo, ns, s0, s1, s2, wi_s, weight, pdf_s, ok_s, reg_a);
  store_merged(a, i, thr, ok_s, wi_s, weight, pdf_s, reg_a, p_hit, geo_n, frag_n, d, depth);
}

__global__ void __launch_bounds__(SURF_V2_THREADS, SURFACE_V2_MIN_BLOCKS)
    surface_v2_kernel(SurfaceV2Args a) {
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  // every thread of a block runs the same number of rounds, so the whole
  // warp reaches the reduction below
  unsigned rays = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < a.count; base += stride) {
    const int64_t i = base + threadIdx.x;
    if (i < a.count && surface_v2_head(a, i, rays)) surface_v2_tail(a, i, fit, rays);
  }
  rays = __reduce_add_sync(0xFFFFFFFFu, rays);
  if ((threadIdx.x & 31) == 0 && rays != 0) atomicAdd(a.rays, (unsigned long long)rays);
}

}  // namespace

// ptrs: fit, the 12 state inputs, the 4 fragment inputs, the 6 material
// inputs, the 8 emission/NEE inputs, ua, ub, then the 15 outputs and the
// ray counter (ops/surface_v2.py IN_FIELDS / OUT_FIELDS)
extern "C" int zyg_surface_v2(void** ptrs, int64_t ua_stride, int64_t ub_stride, int max_depth,
                              int caustics, int nee_only, int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  SurfaceV2Args a;
  int k = 0;
  a.fit = (const float*)ptrs[k++];
  a.o = (const float*)ptrs[k++];
  a.d = (const float*)ptrs[k++];
  a.thr = (const float*)ptrs[k++];
  a.alive = (const uint8_t*)ptrs[k++];
  a.bxdf_pdf = (const float*)ptrs[k++];
  a.singular = (const uint8_t*)ptrs[k++];
  a.depth = (const int32_t*)ptrs[k++];
  a.mis_o = (const float*)ptrs[k++];
  a.mis_n = (const float*)ptrs[k++];
  a.res_em = (const float*)ptrs[k++];
  a.res_di = (const float*)ptrs[k++];
  a.res_in = (const float*)ptrs[k++];
  a.finite = (const uint8_t*)ptrs[k++];
  a.p = (const float*)ptrs[k++];
  a.geo_n = (const float*)ptrs[k++];
  a.n = (const float*)ptrs[k++];
  a.mat_kind = (const int32_t*)ptrs[k++];
  a.albedo = (const float*)ptrs[k++];
  a.alpha = (const float*)ptrs[k++];
  a.metallic = (const float*)ptrs[k++];
  a.f0 = (const float*)ptrs[k++];
  a.specular = (const float*)ptrs[k++];
  a.em = (const float*)ptrs[k++];
  a.hit_lp = (const float*)ptrs[k++];
  a.is_light = (const uint8_t*)ptrs[k++];
  a.nee_wi = (const float*)ptrs[k++];
  a.nee_rad = (const float*)ptrs[k++];
  a.nee_lpdf = (const float*)ptrs[k++];
  a.nee_pre = (const uint8_t*)ptrs[k++];
  a.nee_pre_tmax = (const float*)ptrs[k++];
  a.ua = (const float*)ptrs[k++];
  a.ub = (const float*)ptrs[k++];
  a.o_out = (float*)ptrs[k++];
  a.d_out = (float*)ptrs[k++];
  a.thr_out = (float*)ptrs[k++];
  a.alive_out = (uint8_t*)ptrs[k++];
  a.bxdf_pdf_out = (float*)ptrs[k++];
  a.depth_out = (int32_t*)ptrs[k++];
  a.mis_o_out = (float*)ptrs[k++];
  a.mis_n_out = (float*)ptrs[k++];
  a.em_out = (float*)ptrs[k++];
  a.di_out = (float*)ptrs[k++];
  a.in_out = (float*)ptrs[k++];
  a.reg_alpha_out = (float*)ptrs[k++];
  a.nee_active_out = (uint8_t*)ptrs[k++];
  a.shadow_tmax_out = (float*)ptrs[k++];
  a.nee_out = (float*)ptrs[k++];
  a.rays = (unsigned long long*)ptrs[k++];
  a.ua_stride = ua_stride;
  a.ub_stride = ub_stride;
  a.max_depth = max_depth;
  a.caustics = caustics;
  a.nee_only = nee_only;
  a.count = n;
  int resident = 0;
  const cudaError_t err = resident_blocks((const void*)surface_v2_kernel, SURF_V2_THREADS, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + SURF_V2_THREADS - 1) / SURF_V2_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  surface_v2_kernel<<<blocks, SURF_V2_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the lanes one pass of the resident grid covers on the current device
extern "C" int zyg_surface_v2_resident_lanes(int64_t* out) {
  return (int)resident_lanes((const void*)surface_v2_kernel, SURF_V2_THREADS, out);
}
