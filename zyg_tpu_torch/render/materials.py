"""Per-lane material parameters with image textures, emitted radiance,
and the GGX energy fits of the substitute BSDF (counterpart of
zyg_tpu/render/materials.py:121-239 `gather` for substitute and light
materials, :440-451 `eval_radiance`, and the energy functions).

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

import torch

from ..core.fmath import fma as _fma
from ..core.vecmath import dot
from ..scene.textures import sample_bilinear, sample_stochastic

MIN_ROUGHNESS = 0.01314  # ref ggx.zig MinRoughness
_VOLUMETRIC = 4  # scene.types.MaterialKind.VOLUMETRIC


def gather(materials, mat_id, textures=None, uv=None, tex_xi=None) -> dict:
    """Per-lane parameters of material mat_id (int32[N], < 0 reads 0).

    With a texture arena and uv, mapped color and roughness multiply their
    constant values, read by one stochastic texel (the reference's default
    LinearStochastic filter) driven by tex_xi [N, 2]; emission maps stay
    BILINEAR: a jittered single-texel read of an HDR map turns a bright
    texel into rare large spikes on the MIS'd BSDF-hit estimator. Returns
    kind (int32), albedo, f0 and emission [N, 3], alpha, metallic and
    specular [N], two_sided (bool)."""
    m = torch.clamp(mat_id, min=0).long()
    color = materials.color[m]
    roughness = materials.roughness[m]
    metallic = materials.metallic[m]
    ior = materials.ior[m]
    emission = materials.emission[m]
    if textures is not None and uv is not None:
        def samp(tid):
            return sample_stochastic(textures, tid, uv, tex_xi)

        ct = materials.color_tex[m]
        color = torch.where((ct >= 0)[:, None], color * samp(ct)[:, :3], color)
        rt = materials.roughness_tex[m]
        roughness = torch.where(rt >= 0, roughness * samp(rt)[:, 0], roughness)
        et = materials.emission_tex[m]
        emission = emission * torch.where((et >= 0)[:, None],
                                          sample_bilinear(textures, et, uv)[:, :3], 1.0)
    roughness = torch.clamp(roughness, min=MIN_ROUGHNESS)
    t = (ior - 1.0) / (ior + 1.0)
    f0_scalar = (t * t)[:, None]
    return {
        "kind": materials.kind[m],
        "albedo": (1.0 - metallic[:, None]) * color,
        "alpha": roughness * roughness,
        "metallic": metallic,
        "f0": _fma(color - f0_scalar, metallic[:, None], f0_scalar),  # lerp
        "specular": materials.specular[m],
        "emission": emission,
        "two_sided": materials.two_sided[m],
    }


def eval_radiance(params: dict, wo, geo_n):
    """Radiance the surface emits toward wo: its emission where it faces
    wo or is two-sided (volumetric materials emit inside, not here)."""
    facing = dot(wo, geo_n) > 0.0
    visible = (facing | params["two_sided"]) & (params["kind"] != _VOLUMETRIC)
    return torch.where(visible[:, None], params["emission"], 0.0)

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
