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
// value and the shadow tmax for the any-hit walk that follows. Every
// expression follows zyg_tpu_torch/ops/surface_v2.py::surface_v2_plain in
// its operation order, with the device functions it shares with the other
// bounces (shade_core.cuh): explicit fmaf where the plain version calls
// core/fmath.py, built with -fmad=false.
//
// What bounds it on an H100: per lane it reads 251 bytes (path state,
// fragment, material, emission and NEE candidate, four uniforms) and
// writes 128, ~0.35 GB at the mesh path's 921,600 lanes (~0.10 ms at
// 3.35 TB/s), against ~2k floating-point operations (~0.03 ms at the
// float32 peak): bytes first, then latency and issue of the BSDF's
// transcendentals. Design: one thread per lane, the whole lane in
// registers; no material or light table (the glue gathered them); only
// the GGX fit coefficients are staged in shared memory once per block;
// max_depth / caustics / nee_only are uniform runtime branches; the ray
// count is reduced per warp and added with one atomic per warp.
#include "shade_core.cuh"

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

// one lane's shade core; returns its ray count (alive + NEE lane)
__device__ int surface_v2_lane(const SurfaceV2Args& a, int64_t i, const float* fit) {
  const V3 o = load3(a.o, i), d = load3(a.d, i), thr0 = load3(a.thr, i);
  const bool alive = a.alive[i] != 0;
  const float bxdf_pdf_in = a.bxdf_pdf[i];
  const bool singular = a.singular[i] != 0;
  const int depth = a.depth[i];
  const V3 mis_o = load3(a.mis_o, i), mis_n_in = load3(a.mis_n, i);
  V3 res_em = load3(a.res_em, i), res_di = load3(a.res_di, i), res_in = load3(a.res_in, i);
  const float u_rr = a.ua[i * a.ua_stride];
  const float* ub = a.ub + i * a.ub_stride;
  const float s0 = ub[0], s1 = ub[1], s2 = ub[2];
  const bool valid = a.finite[i] != 0;
  const V3 p_hit = load3(a.p, i), geo_n = load3(a.geo_n, i), frag_n = load3(a.n, i);
  Mat mat;
  mat.albedo = load3(a.albedo, i);
  mat.alpha = a.alpha[i];
  mat.metallic = a.metallic[i];
  mat.f0 = load3(a.f0, i);
  mat.specular = a.specular[i];
  const V3 em = load3(a.em, i);  // masked by the glue
  const float hit_lp = a.hit_lp[i];
  const bool is_light = a.is_light[i] != 0;
  const V3 nee_wi = load3(a.nee_wi, i), nee_rad = load3(a.nee_rad, i);
  const V3 wo = neg3(d);
  const bool primary = depth == 0;

  // ---- connectLight: the MIS weight of the BSDF-hit emission
  float mis_w;
  if (!a.nee_only) {
    mis_w = (singular | !is_light) ? 1.0f : power_heuristic(bxdf_pdf_in, hit_lp);
    if (!a.caustics) mis_w = (singular & (depth > 0) & is_light) ? 0.0f : mis_w;
  } else {
    mis_w = singular ? 1.0f : (is_light ? 0.0f : 1.0f);
  }
  const bool is_em = primary;
  const bool to_dir = singular | (depth < 2);
  const float add_em = (alive & is_em) ? mis_w : 0.0f;
  const float add_di = (alive & !is_em & to_dir) ? mis_w : 0.0f;
  const float add_in = (alive & !is_em & !to_dir) ? mis_w : 0.0f;
  res_em = add3(res_em, v3(thr0.x * add_em * em.x, thr0.y * add_em * em.y, thr0.z * add_em * em.z));
  res_di = add3(res_di, v3(thr0.x * add_di * em.x, thr0.y * add_di * em.y, thr0.z * add_di * em.z));
  res_in = add3(res_in, v3(thr0.x * add_in * em.x, thr0.y * add_in * em.y, thr0.z * add_in * em.z));

  // ---- continuation + russian roulette
  bool cont = alive & valid & (depth < a.max_depth);
  const float p_rr = max3(thr0) / 0.1f;
  const bool kill = (p_rr < 1.0f) & (u_rr >= p_rr);
  const float rr_scale = p_rr < 1.0f ? 1.0f / zmax(p_rr, 1e-12f) : 1.0f;
  const float rr_mul = kill ? 0.0f : rr_scale;
  const V3 thr = scale3(thr0, rr_mul);
  cont = cont & !kill;

  // ---- NEE: evaluate the glue's candidate
  const bool is_sub = a.mat_kind[i] == 0;  // MaterialKind.SUBSTITUTE
  const bool can_nee = cont & is_sub;
  V3 f_nee;
  float bpdf;
  substitute_eval(fit, mat, wo, nee_wi, frag_n, geo_n, f_nee, bpdf);
  f_nee = is_sub ? f_nee : v3(0.0f, 0.0f, 0.0f);
  bpdf = is_sub ? bpdf : 0.0f;
  const float w_mis = predivided_power_heuristic(a.nee_lpdf[i], bpdf);
  const bool nee_active = can_nee & (a.nee_pre[i] != 0) & (max3(f_nee) > 0.0f);
  const V3 nee = nee_active ? v3(thr.x * nee_rad.x * f_nee.x * w_mis,
                                 thr.y * nee_rad.y * f_nee.y * w_mis,
                                 thr.z * nee_rad.z * f_nee.z * w_mis)
                            : v3(0.0f, 0.0f, 0.0f);

  // ---- BSDF sample + PathState merge
  V3 wi_s, weight;
  float pdf_s, reg_a;
  bool ok_s;
  substitute_sample(fit, mat, wo, frag_n, geo_n, s0, s1, s2, wi_s, weight, pdf_s, ok_s, reg_a);
  const bool valid_s = ok_s & is_sub;
  cont = cont & valid_s;
  const V3 thr_out = v3(thr.x * (valid_s ? weight.x : 0.0f), thr.y * (valid_s ? weight.y : 0.0f),
                        thr.z * (valid_s ? weight.z : 0.0f));
  const V3 b_n = sel3(dot3(wi_s, geo_n) >= 0.0f, geo_n, neg3(geo_n));
  const V3 new_o = offset_ray(p_hit, b_n);

  store3(a.o_out, i, cont ? new_o : o);
  store3(a.d_out, i, cont ? wi_s : d);
  store3(a.thr_out, i, thr_out);
  a.alive_out[i] = cont;
  a.bxdf_pdf_out[i] = valid_s ? pdf_s : 0.0f;
  a.depth_out[i] = cont ? depth + 1 : depth;
  store3(a.mis_o_out, i, cont ? new_o : mis_o);
  store3(a.mis_n_out, i, cont ? frag_n : mis_n_in);
  store3(a.em_out, i, res_em);
  store3(a.di_out, i, res_di);
  store3(a.in_out, i, res_in);
  a.reg_alpha_out[i] = reg_a;
  a.nee_active_out[i] = nee_active;
  a.shadow_tmax_out[i] = nee_active ? a.nee_pre_tmax[i] : 0.0f;
  store3(a.nee_out, i, nee);
  return (alive ? 1 : 0) + (nee_active ? 1 : 0);
}

__global__ void __launch_bounds__(128) surface_v2_kernel(SurfaceV2Args a) {
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int rays = 0;
  if (i < a.count) rays = surface_v2_lane(a, i, fit);
  rays = __reduce_add_sync(0xFFFFFFFFu, rays);
  if ((threadIdx.x & 31) == 0 && rays != 0) atomicAdd(a.rays, (unsigned long long)rays);
}

}  // namespace

// ptrs: fit, the 12 state inputs, the 4 fragment inputs, the 6 material
// inputs, the 8 emission/NEE inputs, ua, ub, then the 15 outputs and the
// ray counter (ops/surface_v2.py IN_FIELDS / OUT_FIELDS)
extern "C" int zyg_surface_v2(void** ptrs, int64_t ua_stride, int64_t ub_stride, int max_depth,
                              int caustics, int nee_only, int64_t count, void* stream) {
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
  a.count = count;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  surface_v2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
