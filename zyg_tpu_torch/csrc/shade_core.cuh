// Device functions shared by the three bounce kernels: the fused Cornell
// bounce (shade.cu), the mesh bounce between the traversals (surface.cu)
// and the general bounce (surface_v2.cu). Ports of
// zyg_tpu/ops/shade.py:72-378 (the substitute BSDF with its GGX energy
// fits, the Urena spherical-rectangle sampler, the ray offset and the MIS
// heuristics), following the plain torch versions in
// zyg_tpu_torch/ops/shade.py in their operation order: dot products and
// the energy-fit Horner steps are explicit fmaf calls where the plain
// versions call core/fmath.py, and the library is built with -fmad=false
// so nothing else is contracted.
//
// The BSDF is split by what its terms depend on: the material alone
// (MatTerms), wo and the shading normal (WoTerms), and wi (lobes). The
// fused bounce computes each once (the material terms once per prop and
// block); substitute_eval / substitute_sample compute all three per call,
// as kernels 5 and 6 use them. Either way every value is the same
// operations on the same inputs.
#pragma once
#include "prop_hit.cuh"

#define LTAB_W 20  // light table row (ops/shade.py pack_ltab)
#define FIT_N 112  // GGX energy-fit coefficients (render/materials.py fit_table)

namespace {

// the plain version's constants: Python doubles rounded to float32
constexpr float kPi = (float)3.14159265358979;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kF20_21 = (float)(20.0 / 21.0);
constexpr float kF1_21 = (float)(1.0 / 21.0);
constexpr float kDotMin = 0.00001f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return dot3f(a.x, b.x, a.y, b.y, a.z, b.z); }
__device__ __forceinline__ V3 add3(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale3(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg3(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 sel3(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float length3(V3 a) { return sqrtf(zmax(dot3(a, a), 0.0f)); }
__device__ __forceinline__ V3 normalize3(V3 a) {
  return scale3(a, 1.0f / zmax(length3(a), 1e-20f));
}
__device__ __forceinline__ float max3(V3 a) { return zmax(zmax(a.x, a.y), a.z); }
__device__ __forceinline__ float clamp01(float x) { return zmin(zmax(x, 0.0f), 1.0f); }
__device__ __forceinline__ float clampf(float x) { return zmax(x, 1e-5f); }
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}
// jnp.sign: -1, 1, or x itself for zeros and NaN
__device__ __forceinline__ float sgn(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x); }
__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}

// ---- GGX energy fits (render/materials.py): Horner chains over the table
__device__ __forceinline__ float poly2(const float* c, float x, float y) {
  float res = 0.0f;
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    float row = c[i * 7 + 6];
#pragma unroll
    for (int j = 5; j >= 0; --j) row = fmaf(row, y, c[i * 7 + j]);
    res = i == 6 ? row : fmaf(res, x, row);
  }
  return res;
}
__device__ __forceinline__ float poly1(const float* c, float x) {
  float res = c[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) res = fmaf(res, x, c[i]);
  return res;
}
__device__ __forceinline__ float e_m(const float* fit, float a, float mu) {
  return clamp01(poly2(fit, a, sqrtf(zmax(mu, 0.0f))));
}
__device__ __forceinline__ float e_p(const float* fit, float a, float mu) {
  return clamp01(poly2(fit + 49, a, sqrtf(zmax(mu, 0.0f))));
}
__device__ __forceinline__ float e_m_avg(const float* fit, float a) {
  return clamp01(poly1(fit + 98, a));
}
__device__ __forceinline__ float e_p_avg(const float* fit, float a) {
  return clamp01(poly1(fit + 105, a));
}
__device__ __forceinline__ float e_s(const float* fit, float f0, float a, float mu) {
  return f0 * e_m(fit, a, mu) + (1.0f - f0) * e_p(fit, a, mu);
}
__device__ __forceinline__ float e_s_avg(const float* fit, float f0, float a) {
  return f0 * e_m_avg(fit, a) + (1.0f - f0) * e_p_avg(fit, a);
}

struct Mat {
  V3 albedo, f0;
  float alpha, metallic, specular;
};

__device__ __forceinline__ float schlick1(float f0, float cos) {
  return f0 + (1.0f - f0) * pow5(zmax(1.0f - cos, 0.0f));
}

// The terms of materials._substitute_lobes that depend on the material
// alone: the energy averages, the lobe pick weights (dw for the pdf, dw_s
// for the sample's lobe choice, which rounds its own division) and the
// multiple-scattering Fresnel factors. Same operations as inline.
struct MatTerms {
  float f0m, inv_pi_1me, dw, dw_s, mm_den, fc[3];
};

__device__ __forceinline__ MatTerms mat_terms(const float* fit, const Mat& m) {
  MatTerms t;
  t.f0m = max3(m.f0);
  const float am = max3(m.albedo);
  const float e_avg = e_s_avg(fit, t.f0m, m.alpha);
  t.inv_pi_1me = 1.0f / zmax(kPi * (1.0f - e_avg), 1e-6f);
  const float bsel = am * t.inv_pi_1me;
  const float dw = bsel / zmax(e_avg + bsel, 1e-12f);
  t.dw = m.metallic >= 1.0f ? 0.0f : dw;
  const float bsel_s = am / zmax(kPi * (1.0f - e_avg), 1e-6f);
  const float dw_s = bsel_s / zmax(e_avg + bsel_s, 1e-12f);
  t.dw_s = m.metallic >= 1.0f ? 0.0f : dw_s;
  const float em_avg = e_m_avg(fit, m.alpha);
  t.mm_den = zmax(kPi * (1.0f - em_avg), 1e-6f);
  const float f0c[3] = {m.f0.x, m.f0.y, m.f0.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f_avg = kF20_21 * f0c[c] + kF1_21;
    t.fc[c] = (f_avg * f_avg * em_avg) / zmax(1.0f - f_avg * (1.0f - em_avg), 1e-6f);
  }
  return t;
}

// The terms that depend on wo and the shading normal only: the same in the
// evaluation toward the light and in the sample's evaluation.
struct WoTerms {
  float n_dot_wo, t_wo, e_wo, em_wo;
};

__device__ __forceinline__ WoTerms wo_terms(const float* fit, float alpha, float f0m, V3 wo,
                                            V3 ns) {
  WoTerms w;
  const float a2 = alpha * alpha;
  w.n_dot_wo = clampf(fabsf(dot3(ns, wo)));
  w.t_wo = sqrtf((1.0f - a2) * w.n_dot_wo * w.n_dot_wo + a2);
  w.em_wo = e_m(fit, alpha, w.n_dot_wo);
  w.e_wo = f0m * w.em_wo + (1.0f - f0m) * e_p(fit, alpha, w.n_dot_wo);  // e_s
  return w;
}

// materials._substitute_lobes: f*cos and pdf, from the precomputed terms
__device__ __forceinline__ void lobes(const float* fit, const Mat& m, const MatTerms& mt,
                                      const WoTerms& w, V3 wo, V3 wi, V3 ns, V3& f, float& pdf) {
  const float alpha = m.alpha;
  const float a2 = alpha * alpha;

  const float n_dot_wi = clampf(dot3(ns, wi));
  const V3 h = normalize3(add3(wo, wi));
  const float wo_dot_h = clampf(dot3(wo, h));
  const float n_dot_h = clamp01(dot3(ns, h));

  const float em_wi = e_m(fit, alpha, n_dot_wi);
  const float e_wi = mt.f0m * em_wi + (1.0f - mt.f0m) * e_p(fit, alpha, n_dot_wi);  // e_s
  const float d_scal = (1.0f - w.e_wo) * (1.0f - e_wi) * mt.inv_pi_1me;
  const V3 d_refl = scale3(m.albedo, d_scal);
  const float d_pdf = n_dot_wi * kInvPi;

  const float x = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  const float d_ggx = a2 / zmax(kPi * (x * x), 1e-20f);
  const float t_wi = sqrtf((1.0f - a2) * n_dot_wi * n_dot_wi + a2);
  const float vis = 0.5f / zmax(n_dot_wi * w.t_wo + w.n_dot_wo * t_wi, 1e-20f);
  const float g1_denom = w.t_wo + w.n_dot_wo;
  const V3 gg_refl = v3(d_ggx * vis * schlick1(m.f0.x, wo_dot_h),
                        d_ggx * vis * schlick1(m.f0.y, wo_dot_h),
                        d_ggx * vis * schlick1(m.f0.z, wo_dot_h));
  const float gg_pdf = (0.5f * d_ggx) / zmax(g1_denom, 1e-20f);

  const float mm = ((1.0f - w.em_wo) * (1.0f - em_wi)) / mt.mm_den;
  const float s = m.specular;
  f = v3(n_dot_wi * (d_refl.x + s * (gg_refl.x + mm * mt.fc[0])),
         n_dot_wi * (d_refl.y + s * (gg_refl.y + mm * mt.fc[1])),
         n_dot_wi * (d_refl.z + s * (gg_refl.z + mm * mt.fc[2])));
  pdf = mt.dw * d_pdf + (1.0f - mt.dw) * gg_pdf;
}

// Duff et al. branch-free ONB
__device__ __forceinline__ void onb(V3 n, V3& t, V3& bt) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  t = v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
  bt = v3(b, sign + n.y * n.y * a, -n.y);
}

// one component of shapes.offset_ray (int-bit nudge)
__device__ __forceinline__ float offset1(float p, float n) {
  const int of_i = (int)(256.0f * n);
  const int p_i = __float_as_int(p);
  const float p_in = __int_as_float((int)((unsigned)p_i - (unsigned)of_i));
  const float p_ip = __int_as_float((int)((unsigned)p_i + (unsigned)of_i));
  const float p_adj = p < 0.0f ? p_in : p_ip;
  const float mad = (1.0f / 65536.0f) * n + p;
  return fabsf(p) < (1.0f / 32.0f) ? mad : p_adj;
}
__device__ __forceinline__ V3 offset_ray(V3 p, V3 n) {
  return v3(offset1(p.x, n.x), offset1(p.y, n.y), offset1(p.z, n.z));
}

struct SphQuad {
  float x0, y0, x1, y1, z0, b0, b1, k, S;
};

__device__ SphQuad sphquad_init(float scale_x, float scale_y, V3 ol) {
  SphQuad q;
  q.x0 = -0.5f * scale_x - ol.x;
  q.y0 = -0.5f * scale_y - ol.y;
  float z0 = -ol.z;
  q.z0 = z0 > 0.0f ? -z0 : z0;
  q.x1 = q.x0 + scale_x;
  q.y1 = q.y0 + scale_y;
  const V3 v00 = v3(q.x0, q.y0, q.z0), v01 = v3(q.x0, q.y1, q.z0);
  const V3 v10 = v3(q.x1, q.y0, q.z0), v11 = v3(q.x1, q.y1, q.z0);
  const V3 n0 = normalize3(cross3(v00, v10));
  const V3 n1 = normalize3(cross3(v10, v11));
  const V3 n2 = normalize3(cross3(v11, v01));
  const V3 n3 = normalize3(cross3(v01, v00));
  const float g0 = acosf(zmin(zmax(-dot3(n0, n1), -1.0f), 1.0f));
  const float g1 = acosf(zmin(zmax(-dot3(n1, n2), -1.0f), 1.0f));
  const float g2 = acosf(zmin(zmax(-dot3(n2, n3), -1.0f), 1.0f));
  const float g3 = acosf(zmin(zmax(-dot3(n3, n0), -1.0f), 1.0f));
  q.b0 = n0.z;
  q.b1 = n2.z;
  q.k = kTwoPi - g2 - g3;
  q.S = g0 + g1 - q.k;
  return q;
}

__device__ void sphquad_sample(const SphQuad& q, float u, float v, float& xu, float& yv) {
  const float au = u * q.S + q.k;
  const float sau = sinf(au);
  const float fu = (cosf(au) * q.b0 - q.b1) / zmax(fabsf(sau), 1e-12f) * sgn(sau);
  float cu = (fu > 0.0f ? 1.0f : -1.0f) / sqrtf(fu * fu + q.b0 * q.b0);
  cu = zmin(zmax(cu, -1.0f), 1.0f);
  xu = -(cu * q.z0) / sqrtf(zmax(1.0f - cu * cu, 1e-12f));
  xu = zmin(zmax(xu, q.x0), q.x1);
  const float d = sqrtf(xu * xu + q.z0 * q.z0);
  const float h0 = q.y0 / sqrtf(d * d + q.y0 * q.y0);
  const float h1 = q.y1 / sqrtf(d * d + q.y1 * q.y1);
  const float hv = h0 + v * (h1 - h0);
  const float hv2 = hv * hv;
  const float eps = 9.5367431640625e-7f;
  yv = hv2 < (float)(1.0 - 9.5367431640625e-7) ? (hv * d) / sqrtf(zmax(1.0f - hv2, eps)) : q.y1;
}

__device__ float sphquad_pdf(const SphQuad& q, V3 ol, float scale_x, float scale_y) {
  const float sqr_dist = dot3(ol, ol);
  const float area = scale_x * scale_y;
  const float numer = area * fabsf(ol.z);
  const float denom = sqr_dist * sqrtf(sqr_dist);
  const bool stable = numer > denom * kDotMin;
  const float inv_s = 1.0f / zmax(q.S, 1e-12f);
  return stable ? inv_s : denom / zmax(numer, 1e-20f);
}

__device__ __forceinline__ float power_heuristic(float f_pdf, float g_pdf) {
  const float f2 = f_pdf * f_pdf;
  return f2 / zmax(g_pdf * g_pdf + f2, 1e-20f);
}

__device__ __forceinline__ float predivided_power_heuristic(float f_pdf, float g_pdf) {
  const float f2 = f_pdf * f_pdf;
  return f_pdf / zmax(g_pdf * g_pdf + f2, 1e-20f);
}

// the shading normal flipped to wo's geometric side
__device__ __forceinline__ V3 shading_normal(V3 wo, V3 n, V3 geo_n) {
  return sel3(dot3(wo, geo_n) > 0.0f, n, neg3(n));
}

// materials._substitute_eval from the precomputed terms: f*cos and pdf
// toward wi, zero below the shading hemisphere ns
__device__ __forceinline__ void eval_terms(const float* fit, const Mat& mat, const MatTerms& mt,
                                           const WoTerms& w, V3 wo, V3 wi, V3 ns, V3& f,
                                           float& pdf) {
  const bool refl_side = dot3(wi, ns) > 0.0f;
  lobes(fit, mat, mt, w, wo, wi, ns, f, pdf);
  f = refl_side ? f : v3(0.0f, 0.0f, 0.0f);
  pdf = refl_side ? pdf : 0.0f;
}

// materials._substitute_eval: f*cos and pdf toward wi, zero below the
// shading hemisphere (the shading normal flipped to wo's geometric side)
__device__ void substitute_eval(const float* fit, const Mat& mat, V3 wo, V3 wi, V3 n, V3 geo_n,
                                V3& f, float& pdf) {
  const V3 ns = shading_normal(wo, n, geo_n);
  const MatTerms mt = mat_terms(fit, mat);
  eval_terms(fit, mat, mt, wo_terms(fit, mat.alpha, mt.f0m, wo, ns), wo, wi, ns, f, pdf);
}

// materials._substitute_sample from the precomputed terms: cosine or VNDF
// lobe by s0 with (s1, s2) around the shading normal ns; reg_a is the
// regularization alpha (1 for the diffuse lobe)
__device__ __forceinline__ void sample_terms(const float* fit, const Mat& mat, const MatTerms& mt,
                                             const WoTerms& w, V3 wo, V3 ns, float s0, float s1,
                                             float s2, V3& wi, V3& weight, float& pdf, bool& ok,
                                             float& reg_a) {
  V3 t, b;
  onb(ns, t, b);
  const float r = sqrtf(s1);
  const float phi = kTwoPi * s2;
  const float dlx = r * cosf(phi);
  const float dly = r * sinf(phi);
  const float dlz = sqrtf(zmax(1.0f - s1, 0.0f));
  const V3 wi_diffuse = add3(add3(scale3(t, dlx), scale3(b, dly)), scale3(ns, dlz));

  const V3 wo_l = v3(dot3(wo, t), dot3(wo, b), dot3(wo, ns));
  // VNDF sample
  const V3 vv = normalize3(v3(mat.alpha * wo_l.x, mat.alpha * wo_l.y, wo_l.z));
  const float vphi = kTwoPi * s1;
  const float z = (1.0f - s2) * (1.0f + vv.z) - vv.z;
  const float st = sqrtf(clamp01(1.0f - z * z));
  const V3 hh = v3(st * cosf(vphi) + vv.x, st * sinf(vphi) + vv.y, z + vv.z);
  const V3 m_l = normalize3(v3(mat.alpha * hh.x, mat.alpha * hh.y, hh.z));
  const V3 h = add3(add3(scale3(t, m_l.x), scale3(b, m_l.y)), scale3(ns, m_l.z));
  const float wo_dot_h = clampf(dot3(wo, h));
  const V3 wi_gloss = normalize3(sub3(scale3(h, 2.0f * wo_dot_h), wo));

  const bool take_diffuse = s0 < mt.dw_s;
  wi = sel3(take_diffuse, wi_diffuse, wi_gloss);
  reg_a = take_diffuse ? 1.0f : mat.alpha;
  V3 f;
  lobes(fit, mat, mt, w, wo, wi, ns, f, pdf);
  ok = (dot3(wi, ns) > 0.0f) & (pdf > 1e-10f);
  const float inv_pdf = 1.0f / zmax(pdf, 1e-10f);
  weight = ok ? v3(f.x * inv_pdf, f.y * inv_pdf, f.z * inv_pdf) : v3(0.0f, 0.0f, 0.0f);
}

// materials._substitute_sample: cosine or VNDF lobe by s0 with (s1, s2);
// reg_a is the regularization alpha (1 for the diffuse lobe)
__device__ void substitute_sample(const float* fit, const Mat& mat, V3 wo, V3 n, V3 geo_n,
                                  float s0, float s1, float s2, V3& wi, V3& weight, float& pdf,
                                  bool& ok, float& reg_a) {
  const V3 ns = shading_normal(wo, n, geo_n);
  const MatTerms mt = mat_terms(fit, mat);
  sample_terms(fit, mat, mt, wo_terms(fit, mat.alpha, mt.f0m, wo, ns), wo, ns, s0, s1, s2, wi,
               weight, pdf, ok, reg_a);
}


}  // namespace
