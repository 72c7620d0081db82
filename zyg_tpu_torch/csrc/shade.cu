// The whole Cornell-class wavefront bounce in one kernel.
//
// Replaces the TPU kernel zyg_tpu/ops/shade.py::_make_kernel (launched by
// make_fused_body -> fused_bounce -> _run, pallas_call at :663). Per lane:
// closest hit over the analytic props (prop_hit.cuh) -> fragment ->
// BSDF-hit emission with SphQuad MIS -> russian roulette -> NEE (power-CDF
// light pick, Urena spherical-rectangle sample, substitute BSDF eval,
// predivided power heuristic, in-kernel shadow any-hit) -> substitute BSDF
// sample (VNDF + cosine lobes, dspbr energy compensation) -> PathState
// merge. Every expression follows zyg_tpu_torch/ops/shade.py::bounce_plain
// in its operation order: dot products and the energy-fit Horner steps are
// explicit fmaf calls where the plain version calls core/fmath.py, and the
// library is built with -fmad=false so nothing else is contracted.
//
// What bounds it on an H100: per lane it reads ~136 bytes of path state
// and uniforms and writes ~120, ~0.5 GB per launch at 2,073,600 lanes
// (~0.16 ms at 3.35 TB/s), against roughly 2-3k floating-point operations
// and 16 prop hit tests per lane, with transcendentals (acos, sin, cos,
// sqrt) on long dependent chains. A lane that keeps its whole state in
// registers for the length of the bounce needed ~205 of them, which left
// 2 blocks of 128 threads (8 warps) on an SM to hide that latency.
//
// Design: one thread per lane over the JAX package's [N, 3] layouts (a
// warp's three loads of one [N, 3] field cover one contiguous 384-byte
// span), read through the read-only path where each value is first used and
// written as soon as it is final, so few values live across the bounce
// (~168 registers, no spills, against 205 when every value lived from the
// top). It is bounded to 3 resident blocks of 128 (<= 168 registers): at 4
// blocks (<= 128) ptxas spills ~180 bytes a thread and the kernel is no
// faster, so with 12 warps an SM it stays bound by the latency of its
// dependent chains (IEEE divisions, acos/sin/cos, the 49-step Horner fits),
// not by its bytes. The grid is sized to the resident blocks (SMs x blocks per SM from the
// occupancy API) and walks the lanes in a grid-stride loop, so each block
// stages the prop, light, kind and GGX fit tables in shared memory once,
// and computes once per prop the BSDF terms that depend on the material
// alone (MatTerms: energy averages, lobe pick weights, multiple-scattering
// Fresnel factors). Each lane computes the terms that depend on wo once
// (WoTerms) for the evaluation toward the light and for the sample. Work no
// output reads is skipped, per lane (a warp skips a branch none of its
// lanes takes):
// - a lane dead on entry writes its inputs through (alive 0, rays 0);
// - the hit-side SphQuad pdf runs only for a non-singular hit on a
//   rectangle light, the only case whose MIS weight reads it;
// - a lane that the hit, depth, roulette or a non-substitute material ends
//   skips NEE and the BSDF sample: it writes o, d, depth, mis_o and mis_n
//   through, and alive 0;
// - the shadow test runs only for a lane with an active NEE sample and
//   stops at its first blocker (blocked is an OR over the props).
// A lane that leaves the bounce dead before NEE (the first and third
// skips) writes its INPUT throughput and bxdf_pdf: nothing reads those of
// a dead lane (regeneration overwrites them, render/integrator/ptmis.py
// step(), and the flush reads only the result), so they differ from the
// plain version's there, and the checks compare them on live lanes only.
// Every other output is the plain version's value. The ray count is kept
// per thread across the loop and reduced once per warp at the end.
#include "launch.cuh"
#include "shade_core.cuh"

#define PTAB_W 34
#define SHADE_MAX_P 32
#define SHADE_MAX_L 8
#define SHADE_THREADS 128
#define SHADE_MIN_BLOCKS 3  // resident blocks per SM the registers are bounded for

namespace {

struct ShadeArgs {
  const float* ptab;
  const float* ltab;
  const int32_t* kinds;
  const float* fit;
  // inputs
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
  const float* ua;  // [N, >=4] rows: u_rr, u_sel, xi_l
  const float* ub;  // [N, >=3] rows: BSDF lobe pick, xi
  // outputs
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
  unsigned long long* rays;
  int64_t ua_stride, ub_stride;
  int p, l, max_depth, caustics, nee_only;
  int64_t n;
};

// the BSDF's material from a prop's table row
__device__ __forceinline__ Mat row_mat(const float* row) {
  Mat m;
  m.albedo = rowv(row, 19);
  m.alpha = row[22];
  m.metallic = row[23];
  m.f0 = rowv(row, 24);
  m.specular = row[27];
  return m;
}

// the outputs of a lane that leaves the bounce dead before NEE: its path
// state passes through; throughput and bxdf_pdf are its inputs (read by
// nothing, see the note above)
__device__ __forceinline__ void store_ended(const ShadeArgs& a, int64_t i, int depth,
                                            V3 res_di, V3 res_in) {
  store3(a.o_out, i, ld3(a.o, i));
  store3(a.d_out, i, ld3(a.d, i));
  store3(a.thr_out, i, ld3(a.thr, i));
  a.alive_out[i] = 0;
  a.bxdf_pdf_out[i] = __ldg(a.bxdf_pdf + i);
  a.depth_out[i] = depth;
  store3(a.mis_o_out, i, ld3(a.mis_o, i));
  store3(a.mis_n_out, i, ld3(a.mis_n, i));
  store3(a.di_out, i, res_di);
  store3(a.in_out, i, res_in);
}

// one lane's bounce; returns its ray count (alive + shadow ray)
__device__ __forceinline__ int shade_lane(const ShadeArgs& a, int64_t i, const float* ptab,
                                          const float* ltab, const int32_t* kinds,
                                          const PropConsts* pk, const MatTerms* mterms,
                                          const float* fit) {
  const int depth = __ldg(a.depth + i);
  if (__ldg(a.alive + i) == 0) {
    store3(a.em_out, i, ld3(a.res_em, i));
    store_ended(a, i, depth, ld3(a.res_di, i), ld3(a.res_in, i));
    return 0;
  }
  const V3 o = ld3(a.o, i), d = ld3(a.d, i);
  const V3 wo = neg3(d);
  const bool primary = depth == 0;

  // ---- closest hit over the prop rows
  float t_b = ZYG_FAR;
  int slot_b = -1;
  for (int p = 0; p < a.p; ++p) {
    const float* row = ptab + p * PTAB_W;
    const PropHit h =
        prop_hit_k(kinds[p], row, pk[p], o.x, o.y, o.z, d.x, d.y, d.z, 0.0f, ZYG_RAY_MAX_T);
    const bool hit = h.hit & ((primary ? row[15] : row[16]) > 0.5f);
    if (hit & (h.t < t_b)) {
      t_b = h.t;
      slot_b = p;
    }
  }
  const bool valid = slot_b >= 0;
  const int slot = valid ? slot_b : 0;
  const float* row = ptab + slot * PTAB_W;
  const int kind_p = kinds[slot];

  // ---- fragment (shapes.build_fragment, analytic branches)
  const V3 p_hit = add3(o, scale3(d, t_b));
  V3 geo_n = rowv(row, 6);  // rectangle/disk
  if (kind_p == kCube) {
    const V3 r0 = rowv(row, 0), r1 = rowv(row, 3), r2 = rowv(row, 6);
    const V3 lp = sub3(p_hit, rowv(row, 9));
    const float lx = dot3(lp, r0) / row[12];
    const float ly = dot3(lp, r1) / row[13];
    const float lz = dot3(lp, r2) / row[14];
    const float ax = 0.5f - fabsf(lx);
    const float ay = 0.5f - fabsf(ly);
    const float az = 0.5f - fabsf(lz);
    const bool use_x = (ax <= ay) & (ax <= az);
    const bool use_y = !use_x & (ay <= az);
    const V3 face_n = sel3(use_x, r0, sel3(use_y, r1, r2));
    const float comp = use_x ? lx : (use_y ? ly : lz);
    geo_n = scale3(face_n, sgn(comp));
  } else if (kind_p == kSphere) {
    geo_n = normalize3(sub3(p_hit, rowv(row, 9)));
  }
  const V3 frag_n = geo_n;

  // ---- connectLight: BSDF-hit emission with MIS
  const bool singular = __ldg(a.singular + i) != 0;
  const bool facing = dot3(wo, geo_n) > 0.0f;
  const bool em_vis = valid & (facing | (row[31] > 0.5f));
  const V3 em = em_vis ? rowv(row, 28) : v3(0.0f, 0.0f, 0.0f);
  const bool is_light = valid & ((int)row[32] >= 0);
  float mis_w = 1.0f;
  if (!a.nee_only) {
    if (!singular & is_light) {
      // the light pdf of the hit rectangle from the last real vertex (a
      // light of another shape has pdf 0 here: MIS weight 1)
      float lp_rect = 0.0f;
      if (kind_p == kRectangle) {
        const V3 dmo = sub3(ld3(a.mis_o, i), rowv(row, 9));
        const V3 olh = v3(dot3(dmo, rowv(row, 0)), dot3(dmo, rowv(row, 3)), dot3(dmo, rowv(row, 6)));
        const SphQuad qh = sphquad_init(row[12], row[13], olh);
        lp_rect = sphquad_pdf(qh, olh, row[12], row[13]);
      }
      mis_w = power_heuristic(__ldg(a.bxdf_pdf + i), lp_rect * row[33]);
    }
    if (!a.caustics) mis_w = (singular & (depth > 0) & is_light) ? 0.0f : mis_w;
  } else {
    mis_w = singular ? 1.0f : (is_light ? 0.0f : 1.0f);
  }
  const bool to_dir = singular | (depth < 2);
  const float add_em = primary ? mis_w : 0.0f;
  const float add_di = (!primary & to_dir) ? mis_w : 0.0f;
  const float add_in = (!primary & !to_dir) ? mis_w : 0.0f;
  const V3 thr0 = ld3(a.thr, i);
  store3(a.em_out, i, add3(ld3(a.res_em, i), v3(thr0.x * add_em * em.x, thr0.y * add_em * em.y,
                                               thr0.z * add_em * em.z)));
  V3 res_di = add3(ld3(a.res_di, i), v3(thr0.x * add_di * em.x, thr0.y * add_di * em.y,
                                        thr0.z * add_di * em.z));
  V3 res_in = add3(ld3(a.res_in, i), v3(thr0.x * add_in * em.x, thr0.y * add_in * em.y,
                                        thr0.z * add_in * em.z));

  // ---- continuation + russian roulette
  const float* ua = a.ua + i * a.ua_stride;
  const float p_rr = max3(thr0) / 0.1f;
  const bool kill = (p_rr < 1.0f) & (__ldg(ua) >= p_rr);
  const bool is_sub = row[18] == 0.0f;  // MaterialKind.SUBSTITUTE
  if (!(valid & (depth < a.max_depth) & !kill & is_sub)) {
    store_ended(a, i, depth, res_di, res_in);
    return 1;
  }
  const float rr_scale = p_rr < 1.0f ? 1.0f / zmax(p_rr, 1e-12f) : 1.0f;
  const V3 thr = scale3(thr0, rr_scale);

  // ---- NEE: light by power CDF, Urena SphQuad sample
  const float u_sel = __ldg(ua + 1);
  int lidx = 0;
  for (int l = 0; l < a.l - 1; ++l) lidx += u_sel >= ltab[l * LTAB_W] ? 1 : 0;
  const float* lrow = ltab + lidx * LTAB_W;
  const float sel_pdf = lrow[1];
  const V3 lr0 = rowv(lrow, 2);
  const V3 lr1 = rowv(lrow, 5);
  const V3 lr2 = rowv(lrow, 8);
  const V3 lpos = rowv(lrow, 11);
  const float lsx = lrow[14], lsy = lrow[15];

  const V3 dl = sub3(p_hit, lpos);
  const V3 ol = v3(dot3(dl, lr0), dot3(dl, lr1), dot3(dl, lr2));
  const SphQuad q = sphquad_init(lsx, lsy, ol);
  float xu, yv;
  sphquad_sample(q, __ldg(ua + 2), __ldg(ua + 3), xu, yv);
  const V3 rect_p = add3(add3(lpos, scale3(lr0, ol.x + xu)), scale3(lr1, ol.y + yv));
  const V3 axis = sub3(rect_p, p_hit);
  const float rect_t = length3(axis);
  const V3 wi_n = scale3(axis, 1.0f / zmax(rect_t, 1e-20f));
  float pdf_l = sphquad_pdf(q, ol, lsx, lsy);
  const bool valid_l = (q.S > 1e-7f) & (dot3(wi_n, geo_n) > 0.0f) & (pdf_l > 0.0f);
  pdf_l = valid_l ? pdf_l : 0.0f;
  const bool l_facing = dot3(neg3(wi_n), lr2) > 0.0f;
  const V3 radiance = (l_facing | (lrow[19] > 0.5f)) ? rowv(lrow, 16) : v3(0.0f, 0.0f, 0.0f);

  const Mat mat = row_mat(row);
  const MatTerms& mt = mterms[slot];
  const V3 ns = shading_normal(wo, frag_n, geo_n);
  const WoTerms w = wo_terms(fit, mat.alpha, mt.f0m, wo, ns);
  V3 f_nee;
  float bpdf;
  eval_terms(fit, mat, mt, w, wo, wi_n, ns, f_nee, bpdf);
  const float w_mis = predivided_power_heuristic(pdf_l * sel_pdf, bpdf);

  const V3 sh_n = sel3(dot3(wi_n, geo_n) >= 0.0f, geo_n, neg3(geo_n));
  const V3 shadow_o = offset_ray(p_hit, sh_n);
  const V3 lp_off = offset_ray(rect_p, lr2);
  const V3 sh_axis = sub3(lp_off, shadow_o);
  const float slen = length3(sh_axis);
  const V3 sdir = scale3(sh_axis, 1.0f / zmax(slen, 1e-20f));
  const bool nee_active = (sel_pdf > 0.0f) & (pdf_l > 0.0f) & (max3(f_nee) > 0.0f);
  bool blocked = false;
  if (nee_active) {
    for (int p = 0; p < a.p && !blocked; ++p) {
      const float* prow = ptab + p * PTAB_W;
      const PropHit h = prop_hit_k(kinds[p], prow, pk[p], shadow_o.x, shadow_o.y, shadow_o.z,
                                   sdir.x, sdir.y, sdir.z, 0.0f, slen);
      blocked = h.hit & (prow[17] > 0.5f);
    }
  }
  const bool nee_ok = nee_active & !blocked;
  const V3 nee = nee_ok ? v3(thr.x * radiance.x * f_nee.x * w_mis,
                             thr.y * radiance.y * f_nee.y * w_mis,
                             thr.z * radiance.z * f_nee.z * w_mis)
                        : v3(0.0f, 0.0f, 0.0f);
  const bool nee_dir = depth < 1;
  store3(a.di_out, i, add3(res_di, nee_dir ? nee : v3(0.0f, 0.0f, 0.0f)));
  store3(a.in_out, i, add3(res_in, nee_dir ? v3(0.0f, 0.0f, 0.0f) : nee));

  // ---- BSDF sample (materials._substitute_sample)
  const float* ub = a.ub + i * a.ub_stride;
  V3 wi_s, weight;
  float pdf_s, reg_a;
  bool ok_s;
  sample_terms(fit, mat, mt, w, wo, ns, __ldg(ub), __ldg(ub + 1), __ldg(ub + 2), wi_s, weight,
               pdf_s, ok_s, reg_a);
  store3(a.thr_out, i, v3(thr.x * (ok_s ? weight.x : 0.0f), thr.y * (ok_s ? weight.y : 0.0f),
                          thr.z * (ok_s ? weight.z : 0.0f)));
  a.bxdf_pdf_out[i] = ok_s ? pdf_s : 0.0f;
  a.alive_out[i] = ok_s;
  if (ok_s) {
    const V3 b_n = sel3(dot3(wi_s, geo_n) >= 0.0f, geo_n, neg3(geo_n));
    const V3 new_o = offset_ray(p_hit, b_n);
    store3(a.o_out, i, new_o);
    store3(a.d_out, i, wi_s);
    a.depth_out[i] = depth + 1;
    store3(a.mis_o_out, i, new_o);
    store3(a.mis_n_out, i, frag_n);
  } else {
    store3(a.o_out, i, ld3(a.o, i));
    store3(a.d_out, i, d);
    a.depth_out[i] = depth;
    store3(a.mis_o_out, i, ld3(a.mis_o, i));
    store3(a.mis_n_out, i, ld3(a.mis_n, i));
  }
  return 1 + (nee_active ? 1 : 0);
}

__global__ void __launch_bounds__(SHADE_THREADS, SHADE_MIN_BLOCKS) shade_kernel(ShadeArgs a) {
  __shared__ float ptab[SHADE_MAX_P * PTAB_W];
  __shared__ float ltab[SHADE_MAX_L * LTAB_W];
  __shared__ int32_t kinds[SHADE_MAX_P];
  __shared__ float fit[FIT_N];
  __shared__ PropConsts pk[SHADE_MAX_P];
  __shared__ MatTerms mterms[SHADE_MAX_P];
  for (int k = threadIdx.x; k < a.p * PTAB_W; k += blockDim.x) ptab[k] = a.ptab[k];
  for (int k = threadIdx.x; k < a.l * LTAB_W; k += blockDim.x) ltab[k] = a.ltab[k];
  for (int k = threadIdx.x; k < a.p; k += blockDim.x) kinds[k] = a.kinds[k];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  for (int k = threadIdx.x; k < a.p; k += blockDim.x) {
    pk[k] = prop_consts(kinds[k], ptab + k * PTAB_W);
    mterms[k] = mat_terms(fit, row_mat(ptab + k * PTAB_W));
  }
  __syncthreads();
  // every thread of a block runs the same number of rounds, so the whole
  // warp reaches the reduction below
  unsigned rays = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < a.n; base += stride) {
    const int64_t i = base + threadIdx.x;
    if (i < a.n) rays += (unsigned)shade_lane(a, i, ptab, ltab, kinds, pk, mterms, fit);
  }
  rays = __reduce_add_sync(0xFFFFFFFFu, rays);
  if ((threadIdx.x & 31) == 0 && rays != 0) atomicAdd(a.rays, (unsigned long long)rays);
}

}  // namespace

// ptrs: ptab, ltab, kinds, fit, then the 12 state inputs, ua, ub, then the
// 11 state outputs and the ray counter (see ops/shade.py _IN/_OUT_FIELDS)
extern "C" int zyg_shade(void** ptrs, int p, int l, int64_t ua_stride, int64_t ub_stride,
                         int max_depth, int caustics, int nee_only, int64_t n, void* stream) {
  if (p < 1 || p > SHADE_MAX_P || l < 1 || l > SHADE_MAX_L || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ShadeArgs a;
  int k = 0;
  a.ptab = (const float*)ptrs[k++];
  a.ltab = (const float*)ptrs[k++];
  a.kinds = (const int32_t*)ptrs[k++];
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
  a.rays = (unsigned long long*)ptrs[k++];
  a.ua_stride = ua_stride;
  a.ub_stride = ub_stride;
  a.p = p;
  a.l = l;
  a.max_depth = max_depth;
  a.caustics = caustics;
  a.nee_only = nee_only;
  a.n = n;
  int resident = 0;
  const cudaError_t err = resident_blocks((const void*)shade_kernel, SHADE_THREADS, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + SHADE_THREADS - 1) / SHADE_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  shade_kernel<<<blocks, SHADE_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the lanes one pass of the resident grid covers on the current device
extern "C" int zyg_shade_resident_lanes(int64_t* out) {
  int blocks = 0;
  const cudaError_t err = resident_blocks((const void*)shade_kernel, SHADE_THREADS, &blocks);
  *out = (int64_t)blocks * SHADE_THREADS;
  return (int)err;
}
