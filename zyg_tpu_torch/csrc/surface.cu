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
// NEE value for the any-hit walks that follow. Every expression follows
// zyg_tpu_torch/ops/surface.py::surface_plain in its operation order, with
// the device functions it shares with the other bounces (shade_core.cuh):
// explicit fmaf where the plain version calls core/fmath.py, built with
// -fmad=false.
//
// What bounds it on an H100: a lane that reaches NEE reads 179 bytes
// (path state, fragment, seven uniforms) and every lane writes 150, ~0.3 GB
// at the mesh path's 921,600 lanes (~0.09 ms at 3.35 TB/s), against
// ~2.5k floating-point operations with transcendentals (acos, sin, cos,
// sqrt) and IEEE divisions on long dependent chains: latency and issue,
// not bytes. A first version that loaded the whole lane at the top and
// kept it live needed 204 registers (8 warps an SM), recomputed the
// material's energy-fit terms twice and ran the whole bounce for every
// lane, though in a render most lanes are dead or end before NEE.
//
// Design, one thread per lane, in two parts:
// - the head loads, in one batch, what a lane needs to decide whether it
//   goes on (alive, the hit, the material row's index, u_rr) and what a
//   lane that stops writes through (its path state); it adds the BSDF-hit
//   emission with its MIS weight (the hit-side SphQuad pdf only for a
//   non-singular hit on a light, the only case whose weight reads it) and
//   plays russian roulette. A lane dead on entry or ended there (miss,
//   depth, roulette, a non-substitute material) stores its path state
//   through, alive 0, nee_active 0, shadow tmax 0 and a zero shadow ray and
//   NEE value, and skips the rest;
// - the tail, for the lanes that go on, loads its inputs in one batch and
//   runs NEE and the BSDF sample, the BSDF evaluation toward the light only
//   where the light sample is valid (nee_active needs it nowhere else).
// A warp skips a part none of its lanes takes. Loading at each value's
// first use instead put several dependent round trips to memory in each
// lane's path and measured slower; a block-wide queue that gathered the
// lanes going on into full warps before their tails paid for its barriers
// only where few lanes go on (PERF.md). Each lane computes its wo terms
// (WoTerms) once for the evaluation and the sample. The kernel is bounded
// to SURFACE_MIN_BLOCKS resident blocks of 128, and the grid is sized to
// the resident blocks and walks the lanes in a grid-stride loop, so each
// block stages the material table, the light table and the GGX fit in
// shared memory once and computes once per material row the BSDF terms
// that depend on the material alone (MatTerms). The lifecycle's parts that
// the general bounce shares (the emission's MIS weight and sum, roulette,
// the stores of an ended lane and the merge) are in shade_core.cuh.
//
// What a skipped lane leaves behind. Its throughput and bxdf_pdf are its
// INPUTS and its reg_alpha is 1, where the plain version computes values
// that nothing reads: the merge (render/integrator/ptmis.py
// PathState.merged) drops reg_alpha; a dead lane's throughput and
// bxdf_pdf are overwritten by regeneration (ptmis.py step()) or pass
// through the next bounce dead again, and the flush reads only the
// radiance sums; the checks compare them on live lanes only. The shadow
// walks read the shadow ray of every lane: the traversal writes a lane
// with tmax <= 0 at once without reading its ray (traverse.cu), but the
// analytic any-hit kernel (isect.cu) tests every lane's ray against the
// props, so an ended lane writes a zero ray (with tmax 0 it hits nothing),
// and its blocked bit is masked by nee_active in the merge (ops/surface.py)
// anyway. Every other output is the plain version's value. The ray count
// is kept per thread across the loop and reduced once per warp at the end.
#include "launch.cuh"
#include "shade_core.cuh"

#define MTAB_W 14
#define SURF_MAX_M 64
#define SURF_MAX_L 8
#define SURF_THREADS 128
#define SURFACE_MIN_BLOCKS 3  // resident blocks per SM the registers are bounded for

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

// the BSDF's material from a material table row
__device__ __forceinline__ Mat row_mat(const float* row) {
  Mat m;
  m.albedo = rowv(row, 1);
  m.alpha = row[4];
  m.metallic = row[5];
  m.f0 = rowv(row, 6);
  m.specular = row[9];
  return m;
}

// a lane's bounce up to NEE: the BSDF-hit emission with its MIS weight
// and russian roulette. It loads in one batch what a lane that ends here
// writes through and what decides that, so a warp waits on memory once.
// A lane dead on entry or ended here stores all its outputs; the radiance
// sums of every lane are final here (the pending NEE value joins
// direct/indirect after the shadow walk, ops/surface.py). Returns whether
// the lane goes on to NEE; adds its alive ray to rays.
__device__ __forceinline__ bool surface_head(const SurfaceArgs& a, int64_t i, const float* mtab,
                                             const float* ltab, unsigned& rays) {
  const bool alive = __ldg(a.alive + i) != 0;
  const Pass s = load_pass(a, i);
  V3 res_em = ld3(a.res_em, i), res_di = ld3(a.res_di, i), res_in = ld3(a.res_in, i);
  const bool singular = __ldg(a.singular + i) != 0;
  const bool valid = __ldg(a.finite + i) != 0;
  const int slot = __ldg(a.mslot + i);
  const V3 geo_n = ld3(a.geo_n, i);
  const int light_id = __ldg(a.light_id + i);
  const float u_rr = __ldg(a.ua + i * a.ua_stride);
  const float* row = mtab + slot * MTAB_W;
  bool go = false;
  if (alive) {
    rays += 1;
    // ---- connectLight: BSDF-hit emission, MIS against the hit light's
    // SphQuad pdf from the last real vertex
    const bool facing = dot3(neg3(s.d), geo_n) > 0.0f;
    const bool em_vis = valid & (facing | (row[13] > 0.5f));
    const V3 em = em_vis ? rowv(row, 10) : v3(0.0f, 0.0f, 0.0f);
    const bool is_light = light_id >= 0;
    float lp = 0.0f;
    if (!a.nee_only & !singular & is_light) {
      const float* hrow = ltab + min(light_id, a.l - 1) * LTAB_W;
      const V3 dlh = sub3(s.mis_o, rowv(hrow, 11));
      const V3 olh = v3(dot3(dlh, rowv(hrow, 2)), dot3(dlh, rowv(hrow, 5)), dot3(dlh, rowv(hrow, 8)));
      const SphQuad qh = sphquad_init(hrow[14], hrow[15], olh);
      lp = sphquad_pdf(qh, olh, hrow[14], hrow[15]) * hrow[1];
    }
    const float mis_w =
        emission_mis(a.nee_only, a.caustics, singular, is_light, s.depth, s.bxdf_pdf, lp);
    add_emission(res_em, res_di, res_in, s.thr, em, mis_w, s.depth, singular);
    // ---- continuation + russian roulette
    go = valid & (s.depth < a.max_depth) & !rr_kill(s.thr, u_rr) & (row[0] == 0.0f);  // SUBSTITUTE
  }
  store3(a.em_out, i, res_em);
  store3(a.di_out, i, res_di);
  store3(a.in_out, i, res_in);
  if (!go) {
    store_ended(a, i, s);
    store3(a.shadow_o_out, i, v3(0.0f, 0.0f, 0.0f));
    store3(a.shadow_d_out, i, v3(0.0f, 0.0f, 0.0f));
  }
  return go;
}

// the rest of the bounce of a lane that surface_head sent on: NEE (light
// by power CDF, Urena SphQuad sample, BSDF evaluation, shadow ray) and the
// BSDF sample with the PathState merge. It loads its inputs in one batch,
// re-reading the few the head used (from L2: the head read them moments
// before); adds the shadow ray to rays.
__device__ __forceinline__ void surface_tail(const SurfaceArgs& a, int64_t i, const float* mtab,
                                             const float* ltab, const MatTerms* mterms,
                                             const float* fit, unsigned& rays) {
  const int depth = __ldg(a.depth + i);
  const V3 d = ld3(a.d, i);
  const int slot = __ldg(a.mslot + i);
  const V3 geo_n = ld3(a.geo_n, i);
  const V3 p_hit = ld3(a.p, i);
  const V3 frag_n = ld3(a.n, i);
  const float* ua = a.ua + i * a.ua_stride;
  const float u_sel = __ldg(ua + 1), xl0 = __ldg(ua + 2), xl1 = __ldg(ua + 3);
  const float* ub = a.ub + i * a.ub_stride;
  const float s0 = __ldg(ub), s1 = __ldg(ub + 1), s2 = __ldg(ub + 2);
  const V3 wo = neg3(d);
  const V3 thr = rr_scaled(ld3(a.thr, i));

  // ---- NEE: light by power CDF, Urena SphQuad sample
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
  sphquad_sample(q, xl0, xl1, xu, yv);
  const V3 rect_p = add3(add3(lpos, scale3(lr0, ol.x + xu)), scale3(lr1, ol.y + yv));
  const V3 axis = sub3(rect_p, p_hit);
  const V3 wi_n = scale3(axis, 1.0f / zmax(length3(axis), 1e-20f));
  // validity: q.S and the hemisphere of the GEOMETRIC normal
  const bool valid_l = (q.S > 1e-7f) & (dot3(wi_n, geo_n) > 0.0f);
  const float pdf_l = valid_l ? sphquad_pdf(q, ol, lsx, lsy) : 0.0f;

  const float* row = mtab + slot * MTAB_W;
  const Mat mat = row_mat(row);
  const MatTerms& mt = mterms[slot];
  const V3 ns = shading_normal(wo, frag_n, geo_n);
  const WoTerms w = wo_terms(fit, mat.alpha, mt.f0m, wo, ns);
  V3 nee = v3(0.0f, 0.0f, 0.0f);
  bool nee_active = false;
  if ((sel_pdf > 0.0f) & (pdf_l > 0.0f)) {
    V3 f_nee;
    float bpdf;
    eval_terms(fit, mat, mt, w, wo, wi_n, ns, f_nee, bpdf);
    const float w_mis = predivided_power_heuristic(pdf_l * sel_pdf, bpdf);
    nee_active = max3(f_nee) > 0.0f;
    if (nee_active) {
      const bool l_facing = dot3(neg3(wi_n), lr2) > 0.0f;
      const V3 radiance = (l_facing | (lrow[19] > 0.5f)) ? rowv(lrow, 16) : v3(0.0f, 0.0f, 0.0f);
      nee = v3(thr.x * radiance.x * f_nee.x * w_mis, thr.y * radiance.y * f_nee.y * w_mis,
               thr.z * radiance.z * f_nee.z * w_mis);
    }
  }
  const V3 sh_n = sel3(dot3(wi_n, geo_n) >= 0.0f, geo_n, neg3(geo_n));
  const V3 shadow_o = offset_ray(p_hit, sh_n);
  const V3 sh_axis = sub3(offset_ray(rect_p, lr2), shadow_o);
  const float slen = length3(sh_axis);
  store3(a.shadow_o_out, i, shadow_o);
  store3(a.shadow_d_out, i, scale3(sh_axis, 1.0f / zmax(slen, 1e-20f)));
  a.shadow_tmax_out[i] = nee_active ? slen : 0.0f;
  a.nee_active_out[i] = nee_active;
  store3(a.nee_out, i, nee);
  rays += nee_active ? 1u : 0u;

  // ---- BSDF sample + PathState merge
  V3 wi_s, weight;
  float pdf_s, reg_a;
  bool ok_s;
  sample_terms(fit, mat, mt, w, wo, ns, s0, s1, s2, wi_s, weight, pdf_s, ok_s, reg_a);
  store_merged(a, i, thr, ok_s, wi_s, weight, pdf_s, reg_a, p_hit, geo_n, frag_n, d, depth);
}

__global__ void __launch_bounds__(SURF_THREADS, SURFACE_MIN_BLOCKS) surface_kernel(SurfaceArgs a) {
  __shared__ float mtab[SURF_MAX_M * MTAB_W];
  __shared__ float ltab[SURF_MAX_L * LTAB_W];
  __shared__ float fit[FIT_N];
  __shared__ MatTerms mterms[SURF_MAX_M];
  for (int k = threadIdx.x; k < a.m * MTAB_W; k += blockDim.x) mtab[k] = a.mtab[k];
  for (int k = threadIdx.x; k < a.l * LTAB_W; k += blockDim.x) ltab[k] = a.ltab[k];
  for (int k = threadIdx.x; k < FIT_N; k += blockDim.x) fit[k] = a.fit[k];
  __syncthreads();
  for (int k = threadIdx.x; k < a.m; k += blockDim.x)
    mterms[k] = mat_terms(fit, row_mat(mtab + k * MTAB_W));
  __syncthreads();
  // every thread of a block runs the same number of rounds, so the whole
  // warp reaches the reduction below
  unsigned rays = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < a.count; base += stride) {
    const int64_t i = base + threadIdx.x;
    if (i < a.count && surface_head(a, i, mtab, ltab, rays))
      surface_tail(a, i, mtab, ltab, mterms, fit, rays);
  }
  rays = __reduce_add_sync(0xFFFFFFFFu, rays);
  if ((threadIdx.x & 31) == 0 && rays != 0) atomicAdd(a.rays, (unsigned long long)rays);
}

}  // namespace

// ptrs: mtab, ltab, fit, the 12 state inputs, the 6 fragment inputs, ua,
// ub, then the 17 outputs and the ray counter (ops/surface.py)
extern "C" int zyg_surface(void** ptrs, int m, int l, int64_t ua_stride, int64_t ub_stride,
                           int max_depth, int caustics, int nee_only, int64_t n, void* stream) {
  if (m < 1 || m > SURF_MAX_M || l < 1 || l > SURF_MAX_L || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
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
  a.count = n;
  int resident = 0;
  const cudaError_t err = resident_blocks((const void*)surface_kernel, SURF_THREADS, &resident);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + SURF_THREADS - 1) / SURF_THREADS;
  const unsigned blocks = (unsigned)(want < resident ? want : resident);
  surface_kernel<<<blocks, SURF_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// the lanes one pass of the resident grid covers on the current device
extern "C" int zyg_surface_resident_lanes(int64_t* out) {
  return (int)resident_lanes((const void*)surface_kernel, SURF_THREADS, out);
}
