// The mesh bounce between the two traversals (kernel 5).
//
// Replaces the TPU kernel zyg_tpu/ops/shade.py::_make_surface_kernel
// (launched by make_mesh_fused_body -> _run_surface, pallas_call at
// :1122). Per lane, after the closest-hit walk and the fragment gathers:
// BSDF-hit emission with the SphQuad MIS weight from the last real vertex
// (mis_o) -> russian roulette -> NEE (power-CDF light pick, Urena
// spherical-rectangle sample, substitute BSDF eval, predivided power
// heuristic) -> substitute BSDF sample (VNDF + cosine lobes) -> PathState
// merge. It emits the shadow ray (origin, direction, tmax) and the pending
// NEE value for the any-hit walk that follows. Every expression follows
// zyg_tpu_torch/ops/surface.py::surface_plain in its operation order, with
// the device functions it shares with the fused bounce (shade_core.cuh):
// explicit fmaf where the plain version calls core/fmath.py, built with
// -fmad=false.
//
// What bounds it on an H100: per lane it reads 161 bytes (path state,
// uniforms, the fragment) and writes 176, ~0.35 GB per launch at 1,048,576
// lanes (~0.1 ms at 3.35 TB/s), against ~2-3k floating-point operations
// with transcendentals (acos, sin, cos, sqrt) on the critical path, so it
// is bound by latency and issue, not bytes. Design: one thread per lane,
// the whole lane in registers; the material table (<= 64 rows of 14), the
// light table (<= 8 rows of 20) and the GGX fit coefficients are staged in
// shared memory once per block and read by index (the TPU kernel used
// select chains over SMEM rows); max_depth / caustics / nee_only are
// uniform runtime branches; the ray count is reduced per warp and added
// with one atomic per warp.
#include "shade_core.cuh"

#define MTAB_W 14
#define SURF_MAX_M 64
#define SURF_MAX_L 8

namespace {

struct SurfaceArgs {
  const float* mtab;
  const float* ltab;
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
  // fragment (ops/surface.py FRAG_FIELDS)
  const uint8_t* finite;
  const float* p;
  const float* geo_n;
  const float* n;
  const int32_t* mslot;
  const int32_t* light_id;
  const float* ua;  // [N, >=4] rows: u_rr, u_sel, xi_l
  const float* ub;  // [N, >=3] rows: BSDF lobe pick, xi
  // outputs (ops/surface.py _OUT_FIELDS)
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
  float* shadow_o_out;
  float* shadow_d_out;
  float* shadow_tmax_out;
  float* nee_out;
  unsigned long long* rays;
  int64_t ua_stride, ub_stride;
  int m, l, max_depth, caustics, nee_only;
  int64_t count;
};

// one lane's bounce; returns its ray count (alive + shadow ray)
__device__ int surface_lane(const SurfaceArgs& a, int64_t i, const float* mtab, const float* ltab,
                            const float* fit) {
  const V3 o = load3(a.o, i), d = load3(a.d, i), thr0 = load3(a.thr, i);
  const bool alive = a.alive[i] != 0;
  const float bxdf_pdf_in = a.bxdf_pdf[i];
  const bool singular = a.singular[i] != 0;
  const int depth = a.depth[i];
  const V3 mis_o = load3(a.mis_o, i), mis_n_in = load3(a.mis_n, i);
  V3 res_em = load3(a.res_em, i), res_di = load3(a.res_di, i), res_in = load3(a.res_in, i);
  const float* ua = a.ua + i * a.ua_stride;
  const float* ub = a.ub + i * a.ub_stride;
  const float u_rr = ua[0], u_sel = ua[1], xl0 = ua[2], xl1 = ua[3];
  const float s0 = ub[0], s1 = ub[1], s2 = ub[2];
  const bool valid = a.finite[i] != 0;
  const V3 p_hit = load3(a.p, i), geo_n = load3(a.geo_n, i), frag_n = load3(a.n, i);
  const int light_id = a.light_id[i];
  const V3 wo = neg3(d);
  const bool primary = depth == 0;

  // ---- the hit material's row
  const float* mrow = mtab + a.mslot[i] * MTAB_W;
  const float kind_m = mrow[0];
  Mat mat;
  mat.albedo = v3(mrow[1], mrow[2], mrow[3]);
  mat.alpha = mrow[4];
  mat.metallic = mrow[5];
  mat.f0 = v3(mrow[6], mrow[7], mrow[8]);
  mat.specular = mrow[9];
  const V3 emission = v3(mrow[10], mrow[11], mrow[12]);
  const bool two_sided = mrow[13] > 0.5f;

  // ---- connectLight: BSDF-hit emission, MIS against the hit light's
  // SphQuad pdf from the last real vertex
  const bool facing = dot3(wo, geo_n) > 0.0f;
  const bool em_vis = valid & (facing | two_sided);
  const V3 em = em_vis ? emission : v3(0.0f, 0.0f, 0.0f);
  const bool is_light = light_id >= 0;
  float mis_w;
  if (!a.nee_only) {
    const float* hrow = ltab + min(max(light_id, 0), a.l - 1) * LTAB_W;
    const V3 dlh = sub3(mis_o, v3(hrow[11], hrow[12], hrow[13]));
    const V3 olh = v3(dot3(dlh, v3(hrow[2], hrow[3], hrow[4])),
                      dot3(dlh, v3(hrow[5], hrow[6], hrow[7])),
                      dot3(dlh, v3(hrow[8], hrow[9], hrow[10])));
    const SphQuad qh = sphquad_init(hrow[14], hrow[15], olh);
    const float lp = sphquad_pdf(qh, olh, hrow[14], hrow[15]) * hrow[1];
    mis_w = (singular | !is_light) ? 1.0f : power_heuristic(bxdf_pdf_in, lp);
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

  // ---- NEE: light by power CDF, Urena SphQuad sample
  const bool is_sub = kind_m == 0.0f;  // MaterialKind.SUBSTITUTE
  const bool can_nee = cont & is_sub;
  int lidx = 0;
  for (int l = 0; l < a.l - 1; ++l) lidx += u_sel >= ltab[l * LTAB_W] ? 1 : 0;
  const float* lrow = ltab + lidx * LTAB_W;
  const float sel_pdf = lrow[1];
  const V3 lr0 = v3(lrow[2], lrow[3], lrow[4]);
  const V3 lr1 = v3(lrow[5], lrow[6], lrow[7]);
  const V3 lr2 = v3(lrow[8], lrow[9], lrow[10]);
  const V3 lpos = v3(lrow[11], lrow[12], lrow[13]);
  const float lsx = lrow[14], lsy = lrow[15];
  const V3 lem = v3(lrow[16], lrow[17], lrow[18]);
  const bool l2s = lrow[19] > 0.5f;

  const V3 dl = sub3(p_hit, lpos);
  const V3 ol = v3(dot3(dl, lr0), dot3(dl, lr1), dot3(dl, lr2));
  const SphQuad q = sphquad_init(lsx, lsy, ol);
  float xu, yv;
  sphquad_sample(q, xl0, xl1, xu, yv);
  const V3 rect_p = add3(add3(lpos, scale3(lr0, ol.x + xu)), scale3(lr1, ol.y + yv));
  const V3 axis = sub3(rect_p, p_hit);
  const V3 wi_n = scale3(axis, 1.0f / zmax(length3(axis), 1e-20f));
  // validity: q.S and the hemisphere of the GEOMETRIC normal
  const bool valid_l = (q.S > 1e-7f) & (dot3(wi_n, geo_n) > 0.0f);
  const float pdf_l = valid_l ? sphquad_pdf(q, ol, lsx, lsy) : 0.0f;
  const bool l_facing = dot3(neg3(wi_n), lr2) > 0.0f;
  const V3 radiance = (l_facing | l2s) ? lem : v3(0.0f, 0.0f, 0.0f);

  V3 f_nee;
  float bpdf;
  substitute_eval(fit, mat, wo, wi_n, frag_n, geo_n, f_nee, bpdf);
  f_nee = is_sub ? f_nee : v3(0.0f, 0.0f, 0.0f);
  bpdf = is_sub ? bpdf : 0.0f;
  const float w_mis = predivided_power_heuristic(pdf_l * sel_pdf, bpdf);

  const V3 sh_n = sel3(dot3(wi_n, geo_n) >= 0.0f, geo_n, neg3(geo_n));
  const V3 shadow_o = offset_ray(p_hit, sh_n);
  const V3 sh_axis = sub3(offset_ray(rect_p, lr2), shadow_o);
  const float slen = length3(sh_axis);
  const V3 sdir = scale3(sh_axis, 1.0f / zmax(slen, 1e-20f));
  const bool nee_active = can_nee & (sel_pdf > 0.0f) & (pdf_l > 0.0f) & (max3(f_nee) > 0.0f);
  const V3 nee = nee_active ? v3(thr.x * radiance.x * f_nee.x * w_mis,
                                 thr.y * radiance.y * f_nee.y * w_mis,
                                 thr.z * radiance.z * f_nee.z * w_mis)
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
  store3(a.shadow_o_out, i, shadow_o);
  store3(a.shadow_d_out, i, sdir);
  a.shadow_tmax_out[i] = nee_active ? slen : 0.0f;
  store3(a.nee_out, i, nee);
  return (alive ? 1 : 0) + (nee_active ? 1 : 0);
}

__global__ void __launch_bounds__(128) surface_kernel(SurfaceArgs a) {
  __shared__ float mtab[SURF_MAX_M * MTAB_W];
  __shared__ float ltab[SURF_MAX_L * LTAB_W];
  __shared__ float fit[FIT_N];
  for (int k = threadIdx.x; k < a.m * MTAB_W; k += blockDim.x) mtab[k] = a.mtab[k];
  for (int k = threadIdx.x; k < a.l * LTAB_W; k += blockDim.x) ltab[k] = a.ltab[k];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int rays = 0;
  if (i < a.count) rays = surface_lane(a, i, mtab, ltab, fit);
  rays = __reduce_add_sync(0xFFFFFFFFu, rays);
  if ((threadIdx.x & 31) == 0 && rays != 0) atomicAdd(a.rays, (unsigned long long)rays);
}

}  // namespace

// ptrs: mtab, ltab, fit, the 12 state inputs, the 6 fragment inputs, ua,
// ub, then the 17 outputs and the ray counter (ops/surface.py)
extern "C" int zyg_surface(void** ptrs, int m, int l, int64_t ua_stride, int64_t ub_stride,
                           int max_depth, int caustics, int nee_only, int64_t count,
                           void* stream) {
  if (m < 1 || m > SURF_MAX_M || l < 1 || l > SURF_MAX_L) return (int)cudaErrorInvalidValue;
  SurfaceArgs a;
  int k = 0;
  a.mtab = (const float*)ptrs[k++];
  a.ltab = (const float*)ptrs[k++];
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
  a.mslot = (const int32_t*)ptrs[k++];
  a.light_id = (const int32_t*)ptrs[k++];
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
  a.shadow_o_out = (float*)ptrs[k++];
  a.shadow_d_out = (float*)ptrs[k++];
  a.shadow_tmax_out = (float*)ptrs[k++];
  a.nee_out = (float*)ptrs[k++];
  a.rays = (unsigned long long*)ptrs[k++];
  a.ua_stride = ua_stride;
  a.ub_stride = ub_stride;
  a.m = m;
  a.l = l;
  a.max_depth = max_depth;
  a.caustics = caustics;
  a.nee_only = nee_only;
  a.count = count;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  surface_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
