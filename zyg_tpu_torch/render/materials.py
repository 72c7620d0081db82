"""Per-lane material parameters with image textures, emitted radiance,
the GGX energy fits of the substitute BSDF, and the BSDFs of the general
bounce (counterpart of zyg_tpu/render/materials.py:116 `ior_to_f0`,
:121-246 `gather` for substitute, light and glass materials, :247-264
`triplanar_uv`, :403-420 `apply_normal_map`, :440-451
`eval_radiance`, the energy functions, :458-760 the GGX pieces and the
substitute BSDF as the XLA general body calls it, :786-976 the rough and
smooth dielectric, :977-1132 `sample_bsdf`/`eval_bsdf` with BSDF-split
forcing, :1134 `can_evaluate`, :1148-1247 the medium coefficients, the
Henyey-Greenstein phase and russian roulette).

The general bounce's functions take the scene's material features (a
set: "glass", "rough_glass", "media", "volumetric", "spectral_media",
"vol_emission") in params["features"] and compute only what those
features need, as the JAX package compiles the rest away (a Volumetric
material emits inside its medium, never at its boundary: eval_radiance);
the port refuses every other feature (coatings, translucency, flakes,
anisotropy, hair, dispersion). Fused kernels
keep their own component-form copies of the substitute BSDF
(ops/shade.py), held against the JAX kernel bodies.

Directional and average GGX albedos as tensor-polynomial fits of the
reference's LUT integrals (coefficients of zyg_tpu/render/ggx_fit.npz,
float32 values written out exactly). Schlick fresnel is linear in f0, so
    E_schlick(f0) = f0 * E_m + (1 - f0) * E_p.
Evaluated as Horner chains in float32 whose every step is one fused
multiply-add (core/fmath.py): the chains are ill-conditioned in float32
(coefficients up to ~1e5 cancel to results below 1), so each step's
rounding shows in the result. The shade kernel receives the same
coefficients through `fit_table` and runs the same chains with fmaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core import vecmath as vm
from ..core.fmath import fma as _fma
from ..core.fmath import sqrt as _sqrt
from ..core.vecmath import dot
from ..scene.textures import sample_bilinear, sample_stochastic

MIN_ROUGHNESS = 0.01314  # ref ggx.zig MinRoughness
MIN_ALPHA = MIN_ROUGHNESS * MIN_ROUGHNESS
_SUBSTITUTE = 0  # scene.types.MaterialKind codes
_GLASS = 1
_VOLUMETRIC = 4
_PI = math.pi


def ior_to_f0(ior, ior_outside):
    t = (ior - ior_outside) / (ior + ior_outside)
    return t * t


def gather(materials, mat_id, textures=None, uv=None, tex_xi=None, medium_ior=None,
           features=None, uv_alt=None, footprint=None) -> dict:
    """Per-lane parameters of material mat_id (int32[N], < 0 reads 0).

    With a texture arena and uv, mapped color and roughness multiply their
    constant values, read by one stochastic texel (the reference's default
    LinearStochastic filter) driven by tex_xi [N, 2] (bilinearly without
    it); emission maps stay BILINEAR: a jittered single-texel read of an
    HDR map turns a bright texel into rare large spikes on the MIS'd
    BSDF-hit estimator. uv_alt [N, 2] is the alternate (triplanar) uv of
    textures that ask for it, footprint [N] the analytic procedurals'
    filter width (scene/textures.py). Returns
    kind (int32), albedo, f0 and emission [N, 3], alpha, metallic and
    specular [N], two_sided (bool), and where features (the scene's
    material feature set) holds "ies", the IES profile [N, 32].

    With medium_ior ([N], the ior of the medium the ray travels in) the
    general bounce's fields come too: f0 against that medium, color, ior,
    ior_outside and attenuation_distance, and features (the scene's
    material feature set)."""
    m = torch.clamp(mat_id, min=0).long()
    color = materials.color[m]
    roughness = materials.roughness[m]
    metallic = materials.metallic[m]
    ior = materials.ior[m]
    emission = materials.emission[m]
    if textures is not None and uv is not None:
        def samp(tid):
            if tex_xi is None:
                return sample_bilinear(textures, tid, uv, uv_alt, footprint)
            return sample_stochastic(textures, tid, uv, tex_xi, uv_alt, footprint)

        ct = materials.color_tex[m]
        color = torch.where((ct >= 0)[:, None], color * samp(ct)[:, :3], color)
        rt = materials.roughness_tex[m]
        roughness = torch.where(rt >= 0, roughness * samp(rt)[:, 0], roughness)
        et = materials.emission_tex[m]
        emission = emission * torch.where(
            (et >= 0)[:, None], sample_bilinear(textures, et, uv, uv_alt, footprint)[:, :3], 1.0)
    roughness = torch.clamp(roughness, min=MIN_ROUGHNESS)
    if medium_ior is None:
        t = (ior - 1.0) / (ior + 1.0)
        f0_scalar = (t * t)[:, None]
    else:
        f0_scalar = ior_to_f0(ior, medium_ior)[:, None]
    out = {
        "kind": materials.kind[m],
        "albedo": (1.0 - metallic[:, None]) * color,
        "alpha": roughness * roughness,
        "metallic": metallic,
        "f0": _fma(color - f0_scalar, metallic[:, None], f0_scalar),  # lerp
        "specular": materials.specular[m],
        "emission": emission,
        "two_sided": materials.two_sided[m],
    }
    if features and "ies" in features:
        out["ies"] = materials.ies[m]
    if medium_ior is not None:
        out.update(color=color, ior=ior, ior_outside=medium_ior,
                   attenuation_distance=materials.attenuation_distance[m],
                   features=set(features or ()))
    return out


def triplanar_uv(scene, frag):
    """Object-space triplanar uv of a fragment (the reference's
    triplanarMapping): the planar projection along the dominant axis of
    the object-space shading normal, sign-fixed. Feeds the textures whose
    texcoord is Triplanar or ObjectPos."""
    pr = torch.clamp(frag.prop, min=0).long()
    rot = scene.prop_rot[pr]
    op = vm.world_to_object_normal(rot, frag.p - scene.prop_pos[pr])
    on = vm.world_to_object_normal(rot, frag.n)
    an = torch.abs(on)
    ax = (an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2])
    ay = (an[:, 1] > an[:, 0]) & (an[:, 1] > an[:, 2]) & ~ax
    sgn = torch.sign(torch.where(ax, on[:, 0], torch.where(ay, on[:, 1], on[:, 2])))
    u = torch.where(ax, sgn * op[:, 2], torch.where(ay, sgn * op[:, 0], -sgn * op[:, 0])) + 0.5
    v = torch.where(ax, -op[:, 1], torch.where(ay, -op[:, 2], -op[:, 1])) + 0.5
    return torch.stack([u, v], dim=-1)


def apply_normal_map(materials, textures, mat_id, uv, n, t, b, tex_xi=None, uv_alt=None):
    """The shading normal n perturbed by the material's tangent-space
    normal map through the frame (t, b, n); unchanged on lanes whose
    material has none."""
    if textures is None:
        return n
    nt = materials.normal_tex[torch.clamp(mat_id, min=0).long()]
    tid = torch.clamp(nt, min=0)
    if tex_xi is not None:
        texel = sample_stochastic(textures, tid, uv, tex_xi, uv_alt)
    else:
        texel = sample_bilinear(textures, tid, uv, uv_alt)
    nm = texel[:, :3] * 2.0 - 1.0
    n_pert = vm.safe_normalize(vm.frame_to_world(
        t, b, n, torch.cat([nm[:, :2], torch.clamp(nm[:, 2:3], min=0.1)], dim=1)))
    return torch.where((nt >= 0)[:, None], n_pert, n)


def eval_ies(profile, cos_theta):
    """The [N, 32] angular profiles linearly interpolated at theta =
    acos(cos_theta) [N] (zyg_tpu/render/materials.py:423)."""
    nb = profile.shape[-1]
    x = torch.acos(torch.clamp(cos_theta, -1.0, 1.0)) * ((nb - 1) / _PI)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, nb - 2)
    frac = x - i0.to(torch.float32)
    v0 = torch.gather(profile, 1, i0[:, None])[:, 0]
    v1 = torch.gather(profile, 1, (i0 + 1)[:, None])[:, 0]
    return _fma(frac, v1 - v0, v0)


def eval_radiance(params: dict, wo, geo_n):
    """Radiance the surface emits toward wo: its emission where it faces
    wo or is two-sided (volumetric materials emit inside, not here), times
    its IES profile at the angle from geo_n where params carry one."""
    facing = dot(wo, geo_n) > 0.0
    visible = (facing | params["two_sided"]) & (params["kind"] != _VOLUMETRIC)
    emission = params["emission"]
    if "ies" in params:
        emission = emission * eval_ies(params["ies"], dot(wo, geo_n))[:, None]
    return torch.where(visible[:, None], emission, 0.0)

# [7, 7] coefficients over alpha^i * sqrt(mu)^j
_CM = (
    (0.9268081188201904, -2.294907569885254, 21.8424015045166, -69.04193878173828, 101.50402069091797, -71.49762725830078, 19.563722610473633),
    (3.6853253841400146, 21.308063507080078, -487.3769226074219, 1899.5953369140625, -3094.30322265625, 2317.1611328125, -660.174072265625),
    (-39.659156799316406, 59.280635833740234, 2621.5947265625, -12474.0244140625, 22066.52734375, -17322.42578125, 5088.861328125),
    (163.7630157470703, -775.064453125, -5661.12548828125, 34773.02734375, -66452.15625, 54311.23046875, -16367.751953125),
    (-311.7025451660156, 2027.9886474609375, 5157.52783203125, -47401.55078125, 98165.8671875, -83314.0078125, 25693.5625),
    (276.1719055175781, -2098.998046875, -1426.5587158203125, 31305.712890625, -70662.3125, 62178.78125, -19587.880859375),
    (-92.22754669189453, 767.8062744140625, -227.54383850097656, -8038.90380859375, 19893.9921875, -18119.208984375, 5820.82421875),
)
_CP = (
    (0.5943781137466431, 2.877635955810547, -8.026581764221191, -16.647245407104492, 62.52177047729492, -61.1254997253418, 19.80879020690918),
    (3.0814602375030518, -146.87779235839844, 704.0037841796875, -1320.9290771484375, 1126.1724853515625, -386.75140380859375, 21.24036979675293),
    (-51.02705001831055, 1266.6888427734375, -6514.54541015625, 14220.470703125, -15285.3017578125, 7926.06494140625, -1562.02978515625),
    (195.15895080566406, -4323.76513671875, 22905.802734375, -52497.671875, 59921.96484375, -33507.95703125, 7306.1923828125),
    (-326.6684265136719, 7008.8291015625, -37819.80859375, 88895.7421875, -104493.890625, 60516.67578125, -13782.19921875),
    (253.81204223632812, -5415.529296875, 29640.1875, -70862.53125, 84934.6015625, -50348.03515625, 11800.2353515625),
    (-74.97563934326172, 1609.344970703125, -8918.90625, 21616.552734375, -26320.9296875, 15903.7490234375, -3816.256591796875),
)
_CMA = (1.0006967782974243, -0.07426631450653076, -2.571140766143799, 5.092080116271973, -5.677613735198975, 3.6404471397399902, -1.0012387037277222)
_CPA = (0.050289783626794815, -0.2090347409248352, 0.5112331509590149, -0.9588462710380554, 1.241287350654602, -0.8799128532409668, 0.24669140577316284)


def _poly2(c, x, y):
    res = None
    for i in reversed(range(len(c))):
        row = c[i][-1]
        for j in reversed(range(len(c[i]) - 1)):
            row = _fma(row, y, c[i][j])
        res = row if res is None else _fma(res, x, row)
    return res


def _poly1(c, x):
    res = c[-1]
    for i in reversed(range(len(c) - 1)):
        res = _fma(res, x, c[i])
    return res


def eval_e_m(alpha, mu):
    return torch.clamp(_poly2(_CM, alpha, torch.sqrt(torch.clamp(mu, min=0.0))), 0.0, 1.0)


def eval_e_p(alpha, mu):
    return torch.clamp(_poly2(_CP, alpha, torch.sqrt(torch.clamp(mu, min=0.0))), 0.0, 1.0)


def eval_e_m_avg(alpha):
    return torch.clamp(_poly1(_CMA, alpha), 0.0, 1.0)


def eval_e_p_avg(alpha):
    return torch.clamp(_poly1(_CPA, alpha), 0.0, 1.0)


def eval_e_s(f0, alpha, mu):
    return f0 * eval_e_m(alpha, mu) + (1.0 - f0) * eval_e_p(alpha, mu)


def eval_e_s_avg(f0, alpha):
    return f0 * eval_e_m_avg(alpha) + (1.0 - f0) * eval_e_p_avg(alpha)


def fit_table(device) -> torch.Tensor:
    """float32[112]: CM (49, row-major) | CP (49) | CMA (7) | CPA (7)."""
    flat = [v for row in _CM for v in row] + [v for row in _CP for v in row]
    return torch.tensor(flat + list(_CMA) + list(_CPA), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The general bounce's BSDFs (zyg_tpu/render/materials.py:458-1250). Rows of
# [N, 3] vectors; a multiply feeding an add is fused where XLA fuses it
# (core/fmath.py), dot products through core/vecmath.dot.
# ---------------------------------------------------------------------------


@dataclass
class BsdfSample:
    wi: torch.Tensor  # [N, 3]
    weight: torch.Tensor  # [N, 3] reflection / pdf (throughput multiplier)
    pdf: torch.Tensor  # [N]
    valid: torch.Tensor  # bool[N]
    singular: torch.Tensor  # bool[N] delta event (no MIS)
    transmission: torch.Tensor  # bool[N] crossed the surface
    reg_alpha: torch.Tensor  # [N] alpha of the sampled lobe (diffuse 1, specular 0)
    fresnel: torch.Tensor = None  # [N] dielectric F of glass lanes (the split weights)
    # bool[N] a null interface (a Volumetric boundary): the ray goes on
    # along its line and the medium inside does the work
    passthrough: torch.Tensor = None


def _clamp(x, lo=1e-5):
    return torch.clamp(x, min=lo)


def _ggx_distribution(n_dot_h, a2):
    d = _fma(n_dot_h * n_dot_h, a2 - 1.0, 1.0)
    return a2 / torch.clamp(_PI * d * d, min=1e-20)


def _visibility_and_g1wo(n_dot_wi, n_dot_wo, a2):
    t_wi = _sqrt(_fma((1.0 - a2) * n_dot_wi, n_dot_wi, a2))
    t_wo = _sqrt(_fma((1.0 - a2) * n_dot_wo, n_dot_wo, a2))
    vis = 0.5 / torch.clamp(_fma(n_dot_wi, t_wo, n_dot_wo * t_wi), min=1e-20)
    return vis, t_wo + n_dot_wo


def _schlick(f0, cos):
    x = torch.clamp(1.0 - cos, min=0.0)
    return _fma(1.0 - f0, torch.pow(x, 5.0)[:, None], f0)


def _vndf_sample(wo_l, alpha, xi):
    """Dupuy/Benyoub spherical-cap VNDF sample in the local frame."""
    v = vm.safe_normalize(torch.stack([alpha * wo_l[:, 0], alpha * wo_l[:, 1], wo_l[:, 2]], -1))
    phi = (2.0 * _PI) * xi[:, 0]
    z = _fma(1.0 - xi[:, 1], 1.0 + v[:, 2], -v[:, 2])
    st = _sqrt(torch.clamp(_fma(-z, z, 1.0), 0.0, 1.0))
    h = torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], -1) + v
    return vm.safe_normalize(torch.stack([alpha * h[:, 0], alpha * h[:, 1], h[:, 2]], -1))


def _dspbr_micro_ec(f0, n_dot_wi, n_dot_wo, alpha):
    """Multi-scatter compensation term (ref ggx.zig dspbrMicroEc)."""
    e_wo = eval_e_m(alpha, n_dot_wo)
    e_wi = eval_e_m(alpha, n_dot_wi)
    e_avg = eval_e_m_avg(alpha)
    m = ((1.0 - e_wo) * (1.0 - e_wi)) / torch.clamp(_PI * (1.0 - e_avg), min=1e-6)
    f_avg = _fma(20.0 / 21.0, f0, 1.0 / 21.0)
    f = (f_avg * f_avg * e_avg[:, None]) / torch.clamp(
        _fma(-f_avg, 1.0 - e_avg[:, None], 1.0), min=1e-6)
    return m[:, None] * f


def _substitute_lobes(params, wo, wi, ns):
    """(f * cos [N, 3], pdf [N]) of the substitute BSDF at wi (ref
    substitute_sample.zig baseEvaluate; isotropic GGX)."""
    alpha = params["alpha"]
    a2 = alpha * alpha
    f0 = params["f0"]
    f0m = f0.amax(dim=-1)
    albedo = params["albedo"]
    am = albedo.amax(dim=-1)

    n_dot_wi = _clamp(dot(ns, wi))
    n_dot_wo = _clamp(torch.abs(dot(ns, wo)))
    h = vm.safe_normalize(wo + wi)
    wo_dot_h = _clamp(dot(wo, h))
    n_dot_h = torch.clamp(dot(ns, h), 0.0, 1.0)

    e_wo = eval_e_s(f0m, alpha, n_dot_wo)
    e_wi = eval_e_s(f0m, alpha, n_dot_wi)
    e_avg = eval_e_s_avg(f0m, alpha)
    inv_pi_1me = 1.0 / torch.clamp(_PI * (1.0 - e_avg), min=1e-6)
    d_refl = ((1.0 - e_wo) * (1.0 - e_wi) * inv_pi_1me)[:, None] * albedo
    d_pdf = n_dot_wi * (1.0 / _PI)
    b = am * inv_pi_1me
    dw = b / torch.clamp(e_avg + b, min=1e-12)
    dw = torch.where(params["metallic"] >= 1.0, 0.0, dw)

    fr = _schlick(f0, wo_dot_h)
    d_ggx = _ggx_distribution(n_dot_h, a2)
    vis, g1_denom = _visibility_and_g1wo(n_dot_wi, n_dot_wo, a2)
    gg_refl = (d_ggx * vis)[:, None] * fr
    gg_pdf = (0.5 * d_ggx) / torch.clamp(g1_denom, min=1e-20)
    mms = _dspbr_micro_ec(f0, n_dot_wi, n_dot_wo, alpha)

    s = params["specular"][:, None]
    f_total = n_dot_wi[:, None] * _fma(s, gg_refl + mms, d_refl)
    pdf = _fma(dw, d_pdf, (1.0 - dw) * gg_pdf)
    return f_total, pdf


def _substitute_eval(params, wo, wi, n, geo_n):
    same_side = dot(wo, geo_n) > 0.0
    ns = torch.where(same_side[:, None], n, -n)
    ok = dot(wi, ns) > 0.0
    f, pdf = _substitute_lobes(params, wo, wi, ns)
    return torch.where(ok[:, None], f, 0.0), torch.where(ok, pdf, 0.0)


def _substitute_sample(params, wo, n, geo_n, p, xi):
    """(wi, weight, pdf, ok, reg_alpha) of the substitute BSDF: the
    cosine diffuse lobe or the VNDF gloss lobe by p against the diffuse
    weight, as the JAX general body samples it."""
    same_side = dot(wo, geo_n) > 0.0
    ns = torch.where(same_side[:, None], n, -n)
    t, b = vm.orthonormal_basis(ns)
    wi_diffuse = vm.frame_to_world(t, b, ns, vm.sample_hemisphere_cosine(xi))
    wo_l = vm.world_to_frame(t, b, ns, wo)
    h = vm.frame_to_world(t, b, ns, _vndf_sample(wo_l, params["alpha"], xi))
    wo_dot_h = _clamp(dot(wo, h))
    wi_gloss = vm.safe_normalize(_fma(2.0 * wo_dot_h[:, None], h, -wo))

    f0m = params["f0"].amax(dim=-1)
    am = params["albedo"].amax(dim=-1)
    e_avg = eval_e_s_avg(f0m, params["alpha"])
    bsel = am / torch.clamp(_PI * (1.0 - e_avg), min=1e-6)
    dw = bsel / torch.clamp(e_avg + bsel, min=1e-12)
    dw = torch.where(params["metallic"] >= 1.0, 0.0, dw)
    take_diffuse = p < dw
    wi = torch.where(take_diffuse[:, None], wi_diffuse, wi_gloss)
    reg_a = torch.where(take_diffuse, 1.0, params["alpha"])
    if not params["features"]:
        # the JAX fast path of a scene without features
        f, pdf = _substitute_lobes(params, wo, wi, ns)
        ok = (dot(wi, ns) > 0.0) & (pdf > 1e-10)
    else:
        f, pdf = _substitute_eval(params, wo, wi, n, geo_n)
        ok = pdf > 1e-10
    weight = torch.where(ok[:, None], f / torch.clamp(pdf, min=1e-10)[:, None], 0.0)
    return wi, weight, pdf, ok, reg_a


def _smith_g1(mu, a2):
    mu = torch.clamp(torch.abs(mu), 1e-5, 1.0)
    return (2.0 * mu) / (mu + _sqrt(_fma((1.0 - a2) * mu, mu, a2)))


def _smith_lambda(mu, a2):
    t2 = (1.0 - mu * mu) / torch.clamp(mu * mu, min=1e-10)
    return 0.5 * (_sqrt(_fma(a2, t2, 1.0)) - 1.0)


def _dielectric_fresnel(eta_i, eta_t, cos_i):
    """(eta, total internal reflection, cos_t, F) at an interface with
    cos_i toward the incident side (ref fresnel.zig dielectric)."""
    eta = eta_i / torch.clamp(eta_t, min=1e-6)
    sint2 = (eta * eta) * _fma(-cos_i, cos_i, 1.0)
    tir = sint2 >= 1.0
    cos_t = _sqrt(torch.clamp(1.0 - sint2, min=0.0))
    # products with two uses stay unfused (XLA contracts single-use ones)
    a, b = eta_t * cos_i, eta_i * cos_t
    r_p = (a - b) / torch.clamp(a + b, min=1e-12)
    a, b = eta_i * cos_i, eta_t * cos_t
    r_o = (a - b) / torch.clamp(a + b, min=1e-12)
    f = torch.where(tir, 1.0, 0.5 * _fma(r_p, r_p, r_o * r_o))
    return eta, tir, cos_t, f


def _glass_etas(params, wo, n, geo_n):
    same_side = dot(wo, geo_n) > 0.0
    ns = torch.where(same_side[:, None], n, -n)
    eta_i = torch.where(same_side, params["ior_outside"], params["ior"])
    eta_t = torch.where(same_side, params["ior"], 1.0)
    return ns, eta_i, eta_t


def _glass_rough_sample(params, wo, n, geo_n, p, xi, forced=None):
    """Rough dielectric by VNDF microfacet sampling (ref glass_sample.zig
    roughSample): (wi, weight, pdf, transmission, F). forced: lanes whose
    reflect/refract choice the caller forced (BSDF splitting); their pdf
    drops the fresnel selection factor."""
    ns, eta_i, eta_t = _glass_etas(params, wo, n, geo_n)
    alpha = params["alpha"]
    a2 = alpha * alpha
    t, b = vm.orthonormal_basis(ns)
    wo_l = vm.world_to_frame(t, b, ns, wo)
    h = vm.frame_to_world(t, b, ns, _vndf_sample(wo_l, alpha, xi))
    wo_dot_h = _clamp(dot(wo, h))
    eta, _, cos_t, f = _dielectric_fresnel(eta_i, eta_t, wo_dot_h)

    wi_refl = vm.safe_normalize(_fma(2.0 * wo_dot_h[:, None], h, -wo))
    wi_refr = vm.safe_normalize(_fma(_fma(eta, wo_dot_h, -cos_t)[:, None], h,
                                     -(eta[:, None] * wo)))
    reflect_it = p <= f
    wi = torch.where(reflect_it[:, None], wi_refl, wi_refr)

    n_dot_wo = _clamp(torch.abs(dot(ns, wo)))
    n_dot_wi = _clamp(torch.abs(dot(ns, wi)))
    g1 = _smith_g1(n_dot_wo, a2)
    g2 = 1.0 / (1.0 + _smith_lambda(n_dot_wo, a2) + _smith_lambda(n_dot_wi, a2))
    ms_boost = 1.0 / torch.clamp(eval_e_m(alpha, n_dot_wo), min=0.5)
    weight = (g2 / torch.clamp(g1, min=1e-6) * ms_boost)[:, None] * params["specular"][:, None]

    n_dot_h = _clamp(dot(ns, h))
    d_ggx = _ggx_distribution(n_dot_h, a2)
    pdf_h = g1 * wo_dot_h * d_ggx / torch.clamp(n_dot_wo, min=1e-6)
    wi_dot_h = torch.abs(dot(wi, h))
    denom = torch.square(_fma(eta_i, wo_dot_h, -(eta_t * wi_dot_h)))
    jac = torch.where(reflect_it, 1.0 / torch.clamp(4.0 * wo_dot_h, min=1e-6),
                      (eta_t * eta_t * wi_dot_h) / torch.clamp(denom, min=1e-12))
    sel_pdf = torch.where(reflect_it, f, 1.0 - f)
    if forced is not None:
        sel_pdf = torch.where(forced, 1.0, sel_pdf)
    return wi, weight, pdf_h * jac * sel_pdf, ~reflect_it, f


def _glass_rough_eval(params, wo, wi, n, geo_n, split=None):
    """The rough dielectric at wi for NEE and MIS (Walter 2007): (f * |cos|
    [N, 3], pdf [N]), consistent with _glass_rough_sample. split: lanes
    whose BSDF sample splits at this vertex report the pdf without the
    fresnel selection factor, as the forced sampler does."""
    ns, eta_i, eta_t = _glass_etas(params, wo, n, geo_n)
    alpha = params["alpha"]
    a2 = alpha * alpha
    n_dot_wo = _clamp(torch.abs(dot(ns, wo)))
    n_dot_wi = _clamp(torch.abs(dot(ns, wi)))
    reflecting = dot(ns, wi) > 0.0

    h_r = vm.safe_normalize(wo + wi)
    h_t = vm.safe_normalize(-_fma(eta_i[:, None], wo, eta_t[:, None] * wi))
    h_t = torch.where((dot(h_t, ns) < 0.0)[:, None], -h_t, h_t)
    h = torch.where(reflecting[:, None], h_r, h_t)

    wo_dot_h = dot(wo, h)
    wi_dot_h = dot(wi, h)
    n_dot_h = _clamp(dot(ns, h))
    geom_ok = wo_dot_h > 1e-6
    wo_dot_h = _clamp(wo_dot_h)
    _, tir, _, f = _dielectric_fresnel(eta_i, eta_t, wo_dot_h)

    d_ggx = _ggx_distribution(n_dot_h, a2)
    g1 = _smith_g1(n_dot_wo, a2)
    g2 = 1.0 / (1.0 + _smith_lambda(n_dot_wo, a2) + _smith_lambda(n_dot_wi, a2))
    ms_boost = 1.0 / torch.clamp(eval_e_m(alpha, n_dot_wo), min=0.5)

    pdf_h = g1 * wo_dot_h * d_ggx / torch.clamp(n_dot_wo, min=1e-6)
    sel_r = f if split is None else torch.where(split, 1.0, f)
    sel_t = (1.0 - f) if split is None else torch.where(split, 1.0, 1.0 - f)
    f_refl = f * d_ggx * g2 / torch.clamp(4.0 * n_dot_wo, min=1e-6)
    pdf_refl = pdf_h * sel_r / torch.clamp(4.0 * wo_dot_h, min=1e-6)
    awih = torch.abs(wi_dot_h)
    denom = torch.square(_fma(eta_i, wo_dot_h, -(eta_t * awih)))
    f_trans = ((1.0 - f) * d_ggx * g2 * (wo_dot_h * awih * eta_t * eta_t)
               / torch.clamp(n_dot_wo * denom, min=1e-10))
    jac_t = (eta_t * eta_t * awih) / torch.clamp(denom, min=1e-12)
    pdf_trans = pdf_h * sel_t * jac_t

    trans_ok = ~reflecting & (wi_dot_h < 0.0) & ~tir
    valid = geom_ok & (reflecting | trans_ok)
    f_scalar = torch.where(reflecting, f_refl, f_trans) * ms_boost
    f_out = (torch.where(valid, f_scalar, 0.0) * params["specular"])[:, None].expand(-1, 3)
    pdf = torch.where(valid, torch.where(reflecting, pdf_refl, pdf_trans), 0.0)
    return f_out, pdf


def _glass_sample(params, wo, n, geo_n, p):
    """Smooth dielectric (ref glass_sample.zig specularSample, thick
    path): (wi, weight, transmission, F)."""
    ns, eta_i, eta_t = _glass_etas(params, wo, n, geo_n)
    n_dot_wo = torch.clamp(torch.abs(dot(ns, wo)), max=1.0)
    eta, _, n_dot_t, f = _dielectric_fresnel(eta_i, eta_t, n_dot_wo)
    wi_refl = vm.safe_normalize(_fma(2.0 * n_dot_wo[:, None], ns, -wo))
    wi_refr = vm.safe_normalize(_fma(_fma(eta, n_dot_wo, -n_dot_t)[:, None], ns,
                                     -(eta[:, None] * wo)))
    reflect_it = p <= f
    wi = torch.where(reflect_it[:, None], wi_refl, wi_refr)
    weight = torch.where(reflect_it, params["specular"], 1.0)[:, None].expand(-1, 3)
    # index-matched: straight through
    matched = torch.abs(eta_i - eta_t) < 1e-6
    wi = torch.where(matched[:, None], -wo, wi)
    weight = torch.where(matched[:, None], 1.0, weight)
    return wi, weight, (~reflect_it) | matched, f


def sample_glass(params, wo, n, geo_n, s3, glass_branch=None) -> BsdfSample:
    """The glass lobes (smooth, or rough above MIN_ALPHA * 1.001) as
    sample_bsdf gives them on glass lanes. glass_branch (int32[N], BSDF
    splitting): -1 the stochastic fresnel choice, 0 forces reflection, 1
    refraction; forced lanes return the branch without the fresnel
    selection factor in weight or pdf."""
    p = s3[:, 0]
    xi = s3[:, 1:3]
    if glass_branch is not None:
        # forcing rides the fresnel comparison: p = -1 always reflects,
        # p = 2 always refracts
        forced = glass_branch >= 0
        p = torch.where(glass_branch == 0, -1.0, torch.where(glass_branch == 1, 2.0, p))
    else:
        forced = None
    gl_wi, gl_w, gl_trans, gl_f = _glass_sample(params, wo, n, geo_n, p)
    gr_wi, gr_w, gr_pdf, gr_trans, gr_f = _glass_rough_sample(params, wo, n, geo_n, p, xi,
                                                              forced=forced)
    rough = params["alpha"] > MIN_ALPHA * 1.001
    r3 = rough[:, None]
    return BsdfSample(
        wi=torch.where(r3, gr_wi, gl_wi), weight=torch.where(r3, gr_w, gl_w),
        pdf=torch.where(rough, gr_pdf, 1.0), valid=torch.ones_like(rough), singular=~rough,
        transmission=torch.where(rough, gr_trans, gl_trans),
        reg_alpha=torch.where(rough, params["alpha"], 0.0), fresnel=torch.where(rough, gr_f, gl_f),
    )


def sample_bsdf(params, wo, n, geo_n, s3, glass_branch=None) -> BsdfSample:
    """Sample the BSDF; s3 [N, 3]: the lobe uniform and the 2-D sample.
    glass_branch: BSDF-split forcing of the glass lanes (sample_glass)."""
    kind = params["kind"]
    wi, weight, pdf, sub_ok, reg_a = _substitute_sample(params, wo, n, geo_n, s3[:, 0],
                                                        s3[:, 1:3])
    valid = sub_ok & (kind == _SUBSTITUTE)
    singular = torch.zeros_like(valid)
    transmission = torch.zeros_like(valid)
    fresnel = None
    if "glass" in params["features"]:
        g = sample_glass(params, wo, n, geo_n, s3, glass_branch)
        is_glass = kind == _GLASS
        g3 = is_glass[:, None]
        wi = torch.where(g3, g.wi, wi)
        weight = torch.where(g3, g.weight, weight)
        pdf = torch.where(is_glass, g.pdf, pdf)
        valid = valid | is_glass
        singular = is_glass & g.singular
        transmission = is_glass & g.transmission
        reg_a = torch.where(is_glass, g.reg_alpha, reg_a)
        fresnel = g.fresnel
    passthrough = torch.zeros_like(valid)
    if "volumetric" in params["features"]:
        # Volumetric boundaries pass straight through (ref volumetric_material.zig)
        is_vol = kind == _VOLUMETRIC
        wi = torch.where(is_vol[:, None], -wo, wi)
        weight = torch.where(is_vol[:, None], 1.0, weight)
        pdf = torch.where(is_vol, 1.0, pdf)
        valid = valid | is_vol
        singular = singular | is_vol
        transmission = transmission | is_vol
        passthrough = is_vol
    return BsdfSample(
        wi=wi, weight=torch.where(valid[:, None], weight, 0.0), pdf=torch.where(valid, pdf, 0.0),
        valid=valid, singular=singular, transmission=transmission, reg_alpha=reg_a,
        fresnel=fresnel, passthrough=passthrough,
    )


def eval_bsdf(params, wo, wi, n, geo_n, glass_split=None):
    """f(wo, wi) * |cos| and pdf for NEE and MIS; glass_split: lanes that
    take both fresnel branches at this vertex (their pdf drops the
    selection factor)."""
    kind = params["kind"]
    f, pdf = _substitute_eval(params, wo, wi, n, geo_n)
    is_sub = kind == _SUBSTITUTE
    f = torch.where(is_sub[:, None], f, 0.0)
    pdf = torch.where(is_sub, pdf, 0.0)
    if "rough_glass" in params["features"]:
        gl = (kind == _GLASS) & (params["alpha"] > MIN_ALPHA * 1.001)
        f_gl, pdf_gl = _glass_rough_eval(params, wo, wi, n, geo_n, split=glass_split)
        f = torch.where(gl[:, None], f_gl, f)
        pdf = torch.where(gl, pdf_gl, pdf)
    return f, pdf


def can_evaluate(params):
    """Substitute and rough glass lanes can do NEE; smooth glass (a delta
    BSDF) and emitters cannot (ref glass_sample.zig:51)."""
    ok = params["kind"] == _SUBSTITUTE
    if "rough_glass" in params["features"]:
        ok = ok | ((params["kind"] == _GLASS) & (params["alpha"] > MIN_ALPHA * 1.001))
    return ok


def medium_coefficients(materials, medium_mat, vol_depth=None):
    """(mu_t, mu_s [N, 3], g [N]) of the enclosing medium; zeros in vacuum
    (ref collision_coefficients.zig; the dense-SSS similarity relation
    with vol_depth). Only Volumetric media scatter: a glass interior's
    mu_s is zero."""
    inside = medium_mat >= 0
    m = torch.clamp(medium_mat, min=0).long()
    att_color = torch.clamp(materials.color[m], 0.01, 0.991102)
    att_dist = materials.attenuation_distance[m]
    has = inside & (att_dist > 0.0)
    mu_t = -torch.log(att_color) / torch.clamp(att_dist, min=1e-6)[:, None]
    mu_t = torch.where(has[:, None], mu_t, 0.0)
    ssc = torch.clamp(materials.subsurface_color[m], 0.0, 1.0)
    g = materials.volumetric_anisotropy[m]
    root = _sqrt(_fma(ssc, _fma(ssc, 17.7126, 41.6808), 9.59217))
    factor = torch.clamp(_fma(4.20863, ssc, 4.097125) - root, 0.0, 1.0)
    fsq = factor * factor
    pss = (1.0 - fsq) / torch.clamp(_fma(-g[:, None], fsq, 1.0), min=1e-6)
    is_volume = materials.kind[m] == _VOLUMETRIC
    mu_s = torch.where((has & is_volume)[:, None], mu_t * pss, 0.0)
    g = torch.where(inside, g, 0.0)
    if vol_depth is not None:
        towards0 = torch.clamp((vol_depth.to(torch.float32) - SR_LOW) / (SR_HIGH - SR_LOW), 0.0, 1.0)
        gs = g * (1.0 - towards0)
        scale = (1.0 - g) / torch.clamp(1.0 - gs, min=1e-6)
        mu_s = mu_s * scale[:, None]
        g = gs
    return mu_t, mu_s, g


# dense-SSS similarity relation bounds (ref volumetric_material.zig)
SR_LOW = 16.0
SR_HIGH = 48.0


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase value (= its pdf); cos_theta between the
    ray direction and wi."""
    denom = _fma(-2.0 * g, cos_theta, _fma(g, g, 1.0))
    return (1.0 / (4.0 * _PI)) * _fma(-g, g, 1.0) / torch.clamp(
        denom * _sqrt(torch.clamp(denom, min=1e-8)), min=1e-8)


def hg_sample(wo, g, xi):
    """wi ~ HG about the ray direction -wo."""
    d = -wo
    gg = torch.where(torch.abs(g) < 1e-3, torch.where(g < 0, -1e-3, 1e-3), g)
    sqr = _fma(-g, g, 1.0) / _fma(-2.0 * gg, xi[:, 0], 1.0 + gg)
    cos_theta = torch.where(torch.abs(g) < 1e-3, _fma(-2.0, xi[:, 0], 1.0),
                            _fma(-sqr, sqr, _fma(g, g, 1.0)) / (2.0 * gg))
    sin_theta = _sqrt(torch.clamp(_fma(-cos_theta, cos_theta, 1.0), min=0.0))
    phi = (2.0 * _PI) * xi[:, 1]
    t, b = vm.orthonormal_basis(d)
    return vm.frame_to_world(t, b, d, torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], -1))


def medium_absorption(materials, medium_mat, distance):
    """Beer-Lambert transmittance through the medium of material
    medium_mat (-1: none) over `distance` (zyg_tpu/render/materials.py:1230):
    mu_t = -ln(color) / attenuation_distance, a scattering-free interior."""
    inside = medium_mat >= 0
    m = torch.clamp(medium_mat, min=0).long()
    color = torch.clamp(materials.color[m], 1e-4, 1.0)
    att_dist = materials.attenuation_distance[m]
    mu_t = -torch.log(color) / torch.clamp(att_dist, min=1e-6)[:, None]
    tr = torch.exp(-mu_t * torch.clamp(distance, max=1e12)[:, None])
    return torch.where((inside & (att_dist > 0.0))[:, None], tr, 1.0)


def russian_roulette(throughput, r):
    """ref integrator/helper.zig russianRoulette: p = maxcomp / 0.1, the
    division by the constant as XLA emits it, a multiply by its float32
    reciprocal (10)."""
    p = throughput.amax(dim=-1) * 10.0
    kill = (p < 1.0) & (r >= p)
    scale = torch.where(p < 1.0, 1.0 / torch.clamp(p, min=1e-12), 1.0)
    return throughput * torch.where(kill, 0.0, scale)[:, None], kill
