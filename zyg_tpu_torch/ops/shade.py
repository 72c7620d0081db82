"""Fused full-bounce shade kernel for analytic substitute/light scenes
(counterpart of zyg_tpu/ops/shade.py:1-886). Kernel: csrc/shade.cu.

One bounce of the Cornell-class wavefront, per lane:

  closest hit over the analytic props (ops/isect.py::prop_hit) -> fragment
  -> BSDF-hit emission with MIS (SphQuad light pdf, ref rectangle.zig) ->
  russian roulette -> NEE (power-CDF light pick, Urena spherical rectangle
  sample, substitute BSDF eval, predivided power heuristic, shadow any-hit)
  -> substitute BSDF sample (VNDF + cosine lobes, dspbr energy
  compensation fits) -> PathState merge.

Applicability (`structural_ok`): analytic rectangle/cube/sphere/disk props
only, 1..8 rectangle lights, substitute and light materials, no textures
and no env map. Scenes outside it take the mesh bounce (ops/surface.py) or
the general one (ops/surface_v2.py).

The plain version below is the JAX Pallas kernel body in torch, in
component form and the same operation order, with per-lane table rows read
by indexing (no select chains) and native acos (no polynomial). The CUDA
kernel is the same code line by line.

ref: src/core/rendering/integrator/surface/pathtracer_mis.zig,
src/core/scene/material/substitute/substitute_sample.zig,
src/core/scene/shape/rectangle.zig (SphQuad).
"""

from __future__ import annotations

import ctypes

import torch

from . import check_cuda, register, stream_handle
from ..core.fmath import dot3
from .isect import FAR, prop_hit, static_layout
from ..render import materials as M
from ..scene.types import RAY_MAX_T, MaterialKind, ShapeType

_PI = 3.14159265358979
_DOT_MIN = 0.00001
MAX_PROPS = 32
MAX_LIGHTS = 8

# ptab row layout (one row per analytic prop, material columns joined in):
# 0:9 rot row-major | 9:12 pos | 12:15 scale | 15 vis_cam | 16 vis_refl |
# 17 vis_shadow | 18 mat kind | 19:22 albedo | 22 alpha | 23 metallic |
# 24:27 f0 | 27 specular | 28:31 emission | 31 two_sided | 32 light_id |
# 33 light_select_pdf
PTAB_W = 34
# ltab row layout (one row per light, its prop geometry joined in):
# 0 cdf[l+1] | 1 select_pdf | 2:11 rot | 11:14 pos | 14:16 scale.xy |
# 16:19 emission | 19 two_sided
LTAB_W = 20

_KERNEL = register(
    "shade",
    "zyg_shade",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
)


class Tables:
    """The bounce's constant tables: prop kinds, ptab [P, 34], ltab [L, 20]
    and the GGX fit coefficients [112]."""

    def __init__(self, kinds: list[int], ptab: torch.Tensor, ltab: torch.Tensor, fit: torch.Tensor):
        self.kinds = kinds
        self.kinds_t = torch.tensor(kinds, dtype=torch.int32, device=ptab.device)
        self.ptab = ptab
        self.ltab = ltab
        self.fit = fit


# ---------------------------------------------------------------------------
# component-form vector math (tuples of [N] tensors)
# ---------------------------------------------------------------------------


def _vdot(a, b):
    return dot3(a[0], b[0], a[1], b[1], a[2], b[2])


def _vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _vneg(a):
    return (-a[0], -a[1], -a[2])


def _vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _vnormalize(a, eps=1e-20):
    length = torch.sqrt(torch.clamp(_vdot(a, a), min=0.0))
    return _vscale(a, 1.0 / torch.clamp(length, min=eps))


def _vlength(a):
    return torch.sqrt(torch.clamp(_vdot(a, a), min=0.0))


def _vmax(a):
    return torch.maximum(torch.maximum(a[0], a[1]), a[2])


def _clampf(x, lo=1e-5):
    return torch.clamp(x, min=lo)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _onb(n):
    """Duff et al. branch-free ONB (vm.orthonormal_basis)."""
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bt = (b, sign + ny * ny * a, -ny)
    return t, bt


def _offset1(p, n):
    """One component of shapes.offset_ray (int-bit nudge)."""
    of_i = (256.0 * n).to(torch.int32)
    p_i = p.contiguous().view(torch.int32)
    p_in = (p_i - of_i).view(torch.float32)
    p_ip = (p_i + of_i).view(torch.float32)
    p_adj = torch.where(p < 0.0, p_in, p_ip)
    mad = (1.0 / 65536.0) * n + p
    return torch.where(torch.abs(p) < (1.0 / 32.0), mad, p_adj)


def _offset_ray(p, n):
    return tuple(_offset1(pc, nc) for pc, nc in zip(p, n))


def _sign(x):
    """jnp.sign: -1, 1, or x itself for zeros and NaN."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, x))


def _power_heuristic(f_pdf, g_pdf):
    f2 = f_pdf * f_pdf
    return f2 / torch.clamp(g_pdf * g_pdf + f2, min=1e-20)


def _predivided_power_heuristic(f_pdf, g_pdf):
    f2 = f_pdf * f_pdf
    return f_pdf / torch.clamp(g_pdf * g_pdf + f2, min=1e-20)


# ---------------------------------------------------------------------------
# substitute BSDF (materials._substitute_lobes/_eval/_sample, plain features)
# ---------------------------------------------------------------------------


def _schlick1(f0, cos):
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos, min=0.0))


def _substitute_lobes(mat, wo, wi, ns):
    """(f*cos (3-tuple), pdf, diffuse weight)."""
    alpha = mat["alpha"]
    a2 = alpha * alpha
    f0 = mat["f0"]
    albedo = mat["albedo"]
    f0m = _vmax(f0)
    am = _vmax(albedo)

    n_dot_wi = _clampf(_vdot(ns, wi))
    n_dot_wo = _clampf(torch.abs(_vdot(ns, wo)))
    h = _vnormalize(_vadd(wo, wi))
    wo_dot_h = _clampf(_vdot(wo, h))
    n_dot_h = torch.clamp(_vdot(ns, h), 0.0, 1.0)

    e_wo = M.eval_e_s(f0m, alpha, n_dot_wo)
    e_wi = M.eval_e_s(f0m, alpha, n_dot_wi)
    e_avg = M.eval_e_s_avg(f0m, alpha)
    inv_pi_1me = 1.0 / torch.clamp(_PI * (1.0 - e_avg), min=1e-6)
    d_scal = (1.0 - e_wo) * (1.0 - e_wi) * inv_pi_1me
    d_refl = _vscale(albedo, d_scal)
    d_pdf = n_dot_wi * (1.0 / _PI)
    bsel = am * inv_pi_1me
    dw = bsel / torch.clamp(e_avg + bsel, min=1e-12)
    dw = torch.where(mat["metallic"] >= 1.0, 0.0, dw)

    x = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    d_ggx = a2 / torch.clamp(_PI * (x * x), min=1e-20)
    t_wi = torch.sqrt((1.0 - a2) * n_dot_wi * n_dot_wi + a2)
    t_wo = torch.sqrt((1.0 - a2) * n_dot_wo * n_dot_wo + a2)
    vis = 0.5 / torch.clamp(n_dot_wi * t_wo + n_dot_wo * t_wi, min=1e-20)
    g1_denom = t_wo + n_dot_wo
    fr = tuple(_schlick1(c, wo_dot_h) for c in f0)
    gg_refl = tuple(d_ggx * vis * c for c in fr)
    gg_pdf = (0.5 * d_ggx) / torch.clamp(g1_denom, min=1e-20)

    # dspbr multi-scatter compensation (materials._dspbr_micro_ec)
    em_wo = M.eval_e_m(alpha, n_dot_wo)
    em_wi = M.eval_e_m(alpha, n_dot_wi)
    em_avg = M.eval_e_m_avg(alpha)
    mm = ((1.0 - em_wo) * (1.0 - em_wi)) / torch.clamp(_PI * (1.0 - em_avg), min=1e-6)
    mms = []
    for c in f0:
        f_avg = (20.0 / 21.0) * c + (1.0 / 21.0)
        fc = (f_avg * f_avg * em_avg) / torch.clamp(1.0 - f_avg * (1.0 - em_avg), min=1e-6)
        mms.append(mm * fc)

    s = mat["specular"]
    f_total = tuple(
        n_dot_wi * (dr + s * (gg + ms)) for dr, gg, ms in zip(d_refl, gg_refl, mms)
    )
    pdf = dw * d_pdf + (1.0 - dw) * gg_pdf
    return f_total, pdf, dw


def _substitute_eval(mat, wo, wi, n, geo_n):
    same_side = _vdot(wo, geo_n) > 0.0
    ns = _vwhere(same_side, n, _vneg(n))
    refl_side = _vdot(wi, ns) > 0.0
    f, pdf, _ = _substitute_lobes(mat, wo, wi, ns)
    f = tuple(torch.where(refl_side, c, 0.0) for c in f)
    return f, torch.where(refl_side, pdf, 0.0)


def _vndf_sample(wo_l, alpha, xi0, xi1):
    v = _vnormalize((alpha * wo_l[0], alpha * wo_l[1], wo_l[2]))
    phi = (2.0 * _PI) * xi0
    z = (1.0 - xi1) * (1.0 + v[2]) - v[2]
    st = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    h = (st * torch.cos(phi) + v[0], st * torch.sin(phi) + v[1], z + v[2])
    return _vnormalize((alpha * h[0], alpha * h[1], h[2]))


def _substitute_sample(mat, wo, n, geo_n, p_lobe, xi0, xi1):
    """(wi, weight (3-tuple), pdf, ok, regularization alpha: 1 for the
    diffuse lobe, alpha for the glossy one)."""
    same_side = _vdot(wo, geo_n) > 0.0
    ns = _vwhere(same_side, n, _vneg(n))
    t, b = _onb(ns)

    r = torch.sqrt(xi0)
    phi = (2.0 * _PI) * xi1
    dlx = r * torch.cos(phi)
    dly = r * torch.sin(phi)
    dlz = torch.sqrt(torch.clamp(1.0 - xi0, min=0.0))
    wi_diffuse = _vadd(_vadd(_vscale(t, dlx), _vscale(b, dly)), _vscale(ns, dlz))

    wo_l = (_vdot(wo, t), _vdot(wo, b), _vdot(wo, ns))
    m_l = _vndf_sample(wo_l, mat["alpha"], xi0, xi1)
    h = _vadd(_vadd(_vscale(t, m_l[0]), _vscale(b, m_l[1])), _vscale(ns, m_l[2]))
    wo_dot_h = _clampf(_vdot(wo, h))
    wi_gloss = _vnormalize(_vsub(_vscale(h, 2.0 * wo_dot_h), wo))

    f0m = _vmax(mat["f0"])
    am = _vmax(mat["albedo"])
    e_avg = M.eval_e_s_avg(f0m, mat["alpha"])
    bsel = am / torch.clamp(_PI * (1.0 - e_avg), min=1e-6)
    dw = bsel / torch.clamp(e_avg + bsel, min=1e-12)
    dw = torch.where(mat["metallic"] >= 1.0, 0.0, dw)

    take_diffuse = p_lobe < dw
    wi = _vwhere(take_diffuse, wi_diffuse, wi_gloss)
    f, pdf, _ = _substitute_lobes(mat, wo, wi, ns)
    ok = (_vdot(wi, ns) > 0.0) & (pdf > 1e-10)
    inv_pdf = 1.0 / torch.clamp(pdf, min=1e-10)
    weight = tuple(torch.where(ok, c * inv_pdf, 0.0) for c in f)
    return wi, weight, pdf, ok, torch.where(take_diffuse, 1.0, mat["alpha"])


# ---------------------------------------------------------------------------
# Urena spherical rectangle (light_sampling.sphquad_*)
# ---------------------------------------------------------------------------


def _sphquad_init(scale_x, scale_y, ol):
    ox, oy, oz = ol
    x0 = -0.5 * scale_x - ox
    y0 = -0.5 * scale_y - oy
    z0 = -oz
    z0 = torch.where(z0 > 0.0, -z0, z0)
    x1 = x0 + scale_x
    y1 = y0 + scale_y
    v00 = (x0, y0, z0)
    v01 = (x0, y1, z0)
    v10 = (x1, y0, z0)
    v11 = (x1, y1, z0)
    n0 = _vnormalize(_vcross(v00, v10))
    n1 = _vnormalize(_vcross(v10, v11))
    n2 = _vnormalize(_vcross(v11, v01))
    n3 = _vnormalize(_vcross(v01, v00))
    g0 = torch.acos(torch.clamp(-_vdot(n0, n1), -1.0, 1.0))
    g1 = torch.acos(torch.clamp(-_vdot(n1, n2), -1.0, 1.0))
    g2 = torch.acos(torch.clamp(-_vdot(n2, n3), -1.0, 1.0))
    g3 = torch.acos(torch.clamp(-_vdot(n3, n0), -1.0, 1.0))
    k = 2.0 * _PI - g2 - g3
    return {"x0": x0, "y0": y0, "x1": x1, "y1": y1, "z0": z0,
            "b0": n0[2], "b1": n2[2], "k": k, "S": g0 + g1 - k}


def _sphquad_sample(q, u, v):
    au = u * q["S"] + q["k"]
    sau = torch.sin(au)
    fu = (torch.cos(au) * q["b0"] - q["b1"]) / torch.clamp(torch.abs(sau), min=1e-12) * _sign(sau)
    cu = torch.where(fu > 0.0, 1.0, -1.0) / torch.sqrt(fu * fu + q["b0"] * q["b0"])
    cu = torch.clamp(cu, -1.0, 1.0)
    xu = -(cu * q["z0"]) / torch.sqrt(torch.clamp(1.0 - cu * cu, min=1e-12))
    xu = torch.minimum(torch.maximum(xu, q["x0"]), q["x1"])
    d = torch.sqrt(xu * xu + q["z0"] * q["z0"])
    h0 = q["y0"] / torch.sqrt(d * d + q["y0"] * q["y0"])
    h1 = q["y1"] / torch.sqrt(d * d + q["y1"] * q["y1"])
    hv = h0 + v * (h1 - h0)
    hv2 = hv * hv
    eps = 9.5367431640625e-7
    yv = torch.where(
        hv2 < 1.0 - eps, (hv * d) / torch.sqrt(torch.clamp(1.0 - hv2, min=eps)), q["y1"]
    )
    return xu, yv


def _sphquad_pdf(q, ol, scale_x, scale_y):
    sqr_dist = _vdot(ol, ol)
    area = scale_x * scale_y
    numer = area * torch.abs(ol[2])
    denom = sqr_dist * torch.sqrt(sqr_dist)
    stable = numer > denom * _DOT_MIN
    inv_s = 1.0 / torch.clamp(q["S"], min=1e-12)
    return torch.where(stable, inv_s, denom / torch.clamp(numer, min=1e-20))


# ---------------------------------------------------------------------------
# the bounce
# ---------------------------------------------------------------------------


def bounce_plain(tables: Tables, st: dict, ua: torch.Tensor, ub: torch.Tensor,
                 max_depth: int, caustics: bool, nee_only: bool) -> dict:
    """Plain torch bounce. st: PathState fields {o, d, throughput, alive,
    bxdf_pdf, singular, depth, mis_o, mis_n, emission, direct, indirect};
    ua[:, 0:4] = (u_rr, u_sel, xi_l), ub[:, 0:3] = BSDF sample uniforms.
    Returns the merged fields plus "rays": alive lanes + shadow rays."""
    ptab, ltab, kinds = tables.ptab, tables.ltab, tables.kinds
    L = ltab.shape[0]

    def cols(x):
        return (x[:, 0], x[:, 1], x[:, 2])

    o, d, thr0 = cols(st["o"]), cols(st["d"]), cols(st["throughput"])
    alive, singular, depth = st["alive"], st["singular"], st["depth"]
    bxdf_pdf_in = st["bxdf_pdf"]
    mis_o, mis_n_in = cols(st["mis_o"]), cols(st["mis_n"])
    res_em, res_di, res_in = cols(st["emission"]), cols(st["direct"]), cols(st["indirect"])
    u_rr, u_sel, xl0, xl1 = ua[:, 0], ua[:, 1], ua[:, 2], ua[:, 3]
    s0, s1, s2 = ub[:, 0], ub[:, 1], ub[:, 2]
    wo = _vneg(d)
    primary = depth == 0

    # ---- closest hit over the prop rows
    tmin = 0.0
    tmax = torch.where(alive, RAY_MAX_T, 0.0)
    t_b = torch.full_like(u_rr, FAR)
    slot_b = torch.full(u_rr.shape, -1, dtype=torch.int64, device=u_rr.device)
    for p, kind in enumerate(kinds):
        t, _u, _v, hit = prop_hit(kind, ptab[p], *o, *d, tmin, tmax)
        hit = hit & (torch.where(primary, ptab[p, 15], ptab[p, 16]) > 0.5)
        closer = hit & (t < t_b)
        t_b = torch.where(closer, t, t_b)
        slot_b = torch.where(closer, p, slot_b)
    valid = slot_b >= 0
    slot = torch.clamp(slot_b, min=0)

    # ---- per-lane prop/material params: the hit prop's table row
    row = ptab[slot]
    kind_p = tables.kinds_t[slot]

    def g(c):
        return row[:, c]

    r0 = (g(0), g(1), g(2))
    r1 = (g(3), g(4), g(5))
    r2 = (g(6), g(7), g(8))
    pos = (g(9), g(10), g(11))
    scl = (g(12), g(13), g(14))
    kind_m = g(18)
    mat = {
        "albedo": (g(19), g(20), g(21)),
        "alpha": g(22),
        "metallic": g(23),
        "f0": (g(24), g(25), g(26)),
        "specular": g(27),
    }
    emission = (g(28), g(29), g(30))
    two_sided = g(31) > 0.5
    light_id = torch.where(valid, g(32).to(torch.int32), -1)
    hit_sel_pdf = g(33)

    # ---- fragment (shapes.build_fragment, analytic branches)
    p_hit = _vadd(o, _vscale(d, t_b))
    geo_n = r2  # rectangle/disk
    if ShapeType.CUBE in kinds:
        lp = _vsub(p_hit, pos)
        lx = _vdot(lp, r0) / scl[0]
        ly = _vdot(lp, r1) / scl[1]
        lz = _vdot(lp, r2) / scl[2]
        ax = 0.5 - torch.abs(lx)
        ay = 0.5 - torch.abs(ly)
        az = 0.5 - torch.abs(lz)
        use_x = (ax <= ay) & (ax <= az)
        use_y = (~use_x) & (ay <= az)
        face_n = _vwhere(use_x, r0, _vwhere(use_y, r1, r2))
        comp = torch.where(use_x, lx, torch.where(use_y, ly, lz))
        cube_n = _vscale(face_n, _sign(comp))
        geo_n = _vwhere(kind_p == int(ShapeType.CUBE), cube_n, geo_n)
    if ShapeType.SPHERE in kinds:
        sph_n = _vnormalize(_vsub(p_hit, pos))
        geo_n = _vwhere(kind_p == int(ShapeType.SPHERE), sph_n, geo_n)
    frag_n = geo_n  # analytic shapes: shading normal == geometric

    # ---- connectLight: BSDF-hit emission with MIS
    facing = _vdot(wo, geo_n) > 0.0
    em_vis = valid & (facing | two_sided)
    em = tuple(torch.where(em_vis, c, 0.0) for c in emission)
    is_light = light_id >= 0
    if not nee_only:
        # light_hit_pdf: SphQuad of the HIT rect from the last real vertex
        # (cube emitters: pdf 0 -> MIS weight 1)
        dmo = _vsub(mis_o, pos)
        olh = (_vdot(dmo, r0), _vdot(dmo, r1), _vdot(dmo, r2))
        qh = _sphquad_init(scl[0], scl[1], olh)
        lp_rect = _sphquad_pdf(qh, olh, scl[0], scl[1])
        lp_sel = torch.where(kind_p == int(ShapeType.RECTANGLE), lp_rect, 0.0) * hit_sel_pdf
        mis_w = torch.where(singular | ~is_light, 1.0, _power_heuristic(bxdf_pdf_in, lp_sel))
        if not caustics:
            mis_w = torch.where(singular & (depth > 0) & is_light, 0.0, mis_w)
    else:
        mis_w = torch.where(singular, 1.0, torch.where(is_light, 0.0, 1.0))
    is_em = primary
    to_dir = singular | (depth < 2)
    add_em = torch.where(alive & is_em, mis_w, 0.0)
    add_di = torch.where(alive & ~is_em & to_dir, mis_w, 0.0)
    add_in = torch.where(alive & ~is_em & ~to_dir, mis_w, 0.0)
    res_em = _vadd(res_em, tuple(t * add_em * c for t, c in zip(thr0, em)))
    res_di = _vadd(res_di, tuple(t * add_di * c for t, c in zip(thr0, em)))
    res_in = _vadd(res_in, tuple(t * add_in * c for t, c in zip(thr0, em)))

    # ---- continuation + russian roulette
    cont = alive & valid & (depth < max_depth)
    p_rr = _vmax(thr0) / 0.1
    kill = (p_rr < 1.0) & (u_rr >= p_rr)
    rr_scale = torch.where(p_rr < 1.0, 1.0 / torch.clamp(p_rr, min=1e-12), 1.0)
    rr_mul = torch.where(kill, 0.0, rr_scale)
    thr = tuple(c * rr_mul for c in thr0)
    cont = cont & ~kill

    # ---- NEE: light by power CDF, Urena SphQuad sample
    is_sub = kind_m == float(MaterialKind.SUBSTITUTE)
    can_nee = cont & is_sub
    lidx = torch.zeros(u_rr.shape, dtype=torch.int64, device=u_rr.device)
    for l in range(L - 1):
        lidx = lidx + (u_sel >= ltab[l, 0]).to(torch.int64)
    lrow = ltab[lidx]

    def gl(c):
        return lrow[:, c]

    sel_pdf = gl(1)
    lr0 = (gl(2), gl(3), gl(4))
    lr1 = (gl(5), gl(6), gl(7))
    lr2 = (gl(8), gl(9), gl(10))
    lpos = (gl(11), gl(12), gl(13))
    lsx, lsy = gl(14), gl(15)
    lem = (gl(16), gl(17), gl(18))
    l2s = gl(19) > 0.5

    dl = _vsub(p_hit, lpos)
    ol = (_vdot(dl, lr0), _vdot(dl, lr1), _vdot(dl, lr2))
    q = _sphquad_init(lsx, lsy, ol)
    xu, yv = _sphquad_sample(q, xl0, xl1)
    rect_p = _vadd(_vadd(lpos, _vscale(lr0, ol[0] + xu)), _vscale(lr1, ol[1] + yv))
    axis = _vsub(rect_p, p_hit)
    rect_t = _vlength(axis)
    wi_n = _vscale(axis, 1.0 / torch.clamp(rect_t, min=1e-20))
    pdf_l = _sphquad_pdf(q, ol, lsx, lsy)
    valid_l = (q["S"] > 1e-7) & (_vdot(wi_n, geo_n) > 0.0) & (pdf_l > 0.0)
    pdf_l = torch.where(valid_l, pdf_l, 0.0)
    l_facing = _vdot(_vneg(wi_n), lr2) > 0.0
    radiance = tuple(torch.where(l_facing | l2s, c, 0.0) for c in lem)

    f_nee, bpdf = _substitute_eval(mat, wo, wi_n, frag_n, geo_n)
    f_nee = tuple(torch.where(is_sub, c, 0.0) for c in f_nee)
    bpdf = torch.where(is_sub, bpdf, 0.0)
    w_mis = _predivided_power_heuristic(pdf_l * sel_pdf, bpdf)

    sh_n = _vwhere(_vdot(wi_n, geo_n) >= 0.0, geo_n, _vneg(geo_n))
    shadow_o = _offset_ray(p_hit, sh_n)
    lp_off = _offset_ray(rect_p, lr2)
    sh_axis = _vsub(lp_off, shadow_o)
    slen = _vlength(sh_axis)
    sdir = _vscale(sh_axis, 1.0 / torch.clamp(slen, min=1e-20))
    nee_active = can_nee & (sel_pdf > 0.0) & (pdf_l > 0.0) & (_vmax(f_nee) > 0.0)
    shadow_tmax = torch.where(nee_active, slen, 0.0)
    blocked = torch.zeros_like(alive)
    for p, kind in enumerate(kinds):
        _t, _u, _v, hit = prop_hit(kind, ptab[p], *shadow_o, *sdir, tmin, shadow_tmax)
        blocked = blocked | (hit & (ptab[p, 17] > 0.5))
    nee_ok = nee_active & ~blocked
    nee = tuple(
        torch.where(nee_ok, t * r * f * w_mis, 0.0) for t, r, f in zip(thr, radiance, f_nee)
    )
    nee_dir = depth < 1
    res_di = _vadd(res_di, tuple(torch.where(nee_dir, c, 0.0) for c in nee))
    res_in = _vadd(res_in, tuple(torch.where(nee_dir, 0.0, c) for c in nee))

    # ---- BSDF sample + PathState merge
    wi_s, weight, pdf_s, ok_s, _ = _substitute_sample(mat, wo, frag_n, geo_n, s0, s1, s2)
    valid_s = ok_s & is_sub
    cont = cont & valid_s
    thr_out = tuple(t * torch.where(valid_s, w, 0.0) for t, w in zip(thr, weight))
    b_n = _vwhere(_vdot(wi_s, geo_n) >= 0.0, geo_n, _vneg(geo_n))
    new_o = _offset_ray(p_hit, b_n)

    def stack(v):
        return torch.stack(v, dim=-1)

    return {
        "o": stack(_vwhere(cont, new_o, o)),
        "d": stack(_vwhere(cont, wi_s, d)),
        "throughput": stack(thr_out),
        "alive": cont,
        "bxdf_pdf": torch.where(valid_s, pdf_s, 0.0),
        "depth": torch.where(cont, depth + 1, depth),
        "mis_o": stack(_vwhere(cont, new_o, mis_o)),
        "mis_n": stack(_vwhere(cont, frag_n, mis_n_in)),
        "emission": stack(res_em),
        "direct": stack(res_di),
        "indirect": stack(res_in),
        "rays": alive.sum(dtype=torch.int64) + nee_active.sum(dtype=torch.int64),
    }


_IN_FIELDS = (("o", torch.float32, 3), ("d", torch.float32, 3),
              ("throughput", torch.float32, 3), ("alive", torch.bool, 0),
              ("bxdf_pdf", torch.float32, 0), ("singular", torch.bool, 0),
              ("depth", torch.int32, 0), ("mis_o", torch.float32, 3),
              ("mis_n", torch.float32, 3), ("emission", torch.float32, 3),
              ("direct", torch.float32, 3), ("indirect", torch.float32, 3))
_OUT_FIELDS = (("o", torch.float32, 3), ("d", torch.float32, 3),
               ("throughput", torch.float32, 3), ("alive", torch.bool, 0),
               ("bxdf_pdf", torch.float32, 0), ("depth", torch.int32, 0),
               ("mis_o", torch.float32, 3), ("mis_n", torch.float32, 3),
               ("emission", torch.float32, 3), ("direct", torch.float32, 3),
               ("indirect", torch.float32, 3))


def _bounce_cuda(tables: Tables, st: dict, ua, ub, max_depth, caustics, nee_only) -> dict:
    dev = st["o"].device
    n = st["o"].shape[0]
    p, l = len(tables.kinds), tables.ltab.shape[0]
    check_cuda("shade.ptab", tables.ptab, torch.float32, dev, (p, PTAB_W))
    check_cuda("shade.ltab", tables.ltab, torch.float32, dev, (l, LTAB_W))
    check_cuda("shade.kinds", tables.kinds_t, torch.int32, dev, (p,))
    check_cuda("shade.fit", tables.fit, torch.float32, dev, (112,))
    for name, dtype, w in _IN_FIELDS:
        check_cuda(f"shade.{name}", st[name], dtype, dev, (n, w) if w else (n,))
    for name, u, cols in (("ua", ua, 4), ("ub", ub, 3)):
        check_cuda(f"shade.{name}", u, torch.float32, dev, contiguous=False)
        if u.dim() != 2 or u.shape[0] != n or u.shape[1] < cols or u.stride(1) != 1:
            raise ValueError(f"shade.{name}: expected [N, >={cols}] rows with unit column stride")
    out = {
        name: torch.empty((n, w) if w else (n,), dtype=dtype, device=dev)
        for name, dtype, w in _OUT_FIELDS
    }
    rays = torch.zeros((1,), dtype=torch.int64, device=dev)
    ptrs = [tables.ptab, tables.ltab, tables.kinds_t, tables.fit]
    ptrs += [st[name] for name, _, _ in _IN_FIELDS] + [ua, ub]
    ptrs += [out[name] for name, _, _ in _OUT_FIELDS] + [rays]
    arr = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    if n > 0:
        _KERNEL(arr, p, l, ua.stride(0), ub.stride(0), int(max_depth), int(caustics),
                int(nee_only), n, stream_handle(dev))
    out["rays"] = rays[0]
    return out


def fused_bounce(tables: Tables, st: dict, ua, ub, max_depth: int, caustics: bool,
                 nee_only: bool) -> dict:
    """One full wavefront bounce; the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    fn = bounce_plain if st["o"].device.type == "cpu" else _bounce_cuda
    return fn(tables, st, ua, ub, int(max_depth), bool(caustics), bool(nee_only))


# ---------------------------------------------------------------------------
# applicability + table packing
# ---------------------------------------------------------------------------

_SUPPORTED_KINDS = {int(ShapeType.RECTANGLE), int(ShapeType.CUBE), int(ShapeType.SPHERE),
                    int(ShapeType.DISK)}


def structural_ok(scene) -> bool:
    """Can this scene run the fused bounce? (rectangle lights selected by
    the power CDF, no light tree; static analytic rectangle/cube/sphere/
    disk props, substitute and light materials)."""
    if scene.meshes is not None:
        return False  # mesh scenes take the mesh bounce (ops/surface.py)
    if scene.curves is not None or scene.points is not None:
        return False  # as the JAX gate (zyg_tpu/ops/shade.py:702): ops/surface_v2.py
    if scene.textures is not None or scene.env is not None:
        return False  # textured and env-lit scenes take ops/surface_v2.py
    if scene.light_tree is not None:
        return False  # the kernel selects by the power CDF (ops/surface_v2.py)
    if scene.mat_features or scene.portals:
        return False  # IES profiles and portals take ops/surface_v2.py
    if scene.animated_props:
        return False  # the kernel's props are static (zyg_tpu/ops/shade.py:704)
    if scene.lights.count < 1 or scene.lights.count > MAX_LIGHTS:
        return False
    light_shapes = {int(s) for s in scene.prop_shape[scene.lights.prop.long()].tolist()}
    if light_shapes != {int(ShapeType.RECTANGLE)}:
        return False
    kinds = {int(k) for k in scene.prop_groups}
    if not kinds <= _SUPPORTED_KINDS:
        return False
    if sum(int(g.shape[0]) for g in scene.prop_groups.values()) > MAX_PROPS:
        return False
    mkinds = set(scene.materials.kind.tolist())
    return mkinds <= {int(MaterialKind.SUBSTITUTE), int(MaterialKind.LIGHT)}


def pack_tables(scene) -> Tables:
    """Kinds, ptab [P, 34], ltab [L, 20] (layouts above) and the fit table."""
    kinds, ids = static_layout(scene)
    f32 = torch.float32
    P = ids.shape[0]
    m = torch.clamp(scene.prop_material[ids], min=0).long()
    mats = scene.materials
    rough = torch.clamp(mats.roughness[m], min=M.MIN_ROUGHNESS)
    metallic = mats.metallic[m]
    color = mats.color[m]
    ior = mats.ior[m]
    t = (ior - 1.0) / (ior + 1.0)
    f0s = t * t
    f0 = f0s[:, None] * (1.0 - metallic[:, None]) + color * metallic[:, None]
    albedo = (1.0 - metallic[:, None]) * color
    li = scene.prop_light[ids]
    lc = torch.clamp(li, 0, scene.lights.count - 1).long()
    cdf = scene.lights.cdf
    selpdf = cdf[lc + 1] - cdf[lc]

    def col1(x):
        return x.to(f32).reshape(P, 1)

    ptab = torch.cat([
        scene.prop_rot[ids].reshape(P, 9), scene.prop_pos[ids], scene.prop_scale[ids],
        col1(scene.prop_visible_camera[ids]), col1(scene.prop_visible_reflection[ids]),
        col1(scene.prop_visible_shadow[ids]), col1(mats.kind[m]), albedo,
        col1(rough * rough), col1(metallic), f0, col1(mats.specular[m]), mats.emission[m],
        col1(mats.two_sided[m]), col1(li), col1(selpdf),
    ], dim=1).contiguous()
    return Tables(kinds, ptab, pack_ltab(scene), M.fit_table(ptab.device))


def pack_ltab(scene) -> torch.Tensor:
    """[L, 20] light table (layout above), shared with ops/surface.py."""
    L = scene.lights.count
    cdf = scene.lights.cdf
    mats = scene.materials
    lprop = scene.lights.prop.long()
    lm = torch.clamp(scene.prop_material[lprop], min=0).long()
    return torch.cat([
        cdf[1 : L + 1].reshape(L, 1), (cdf[1 : L + 1] - cdf[0:L]).reshape(L, 1),
        scene.prop_rot[lprop].reshape(L, 9), scene.prop_pos[lprop],
        scene.prop_scale[lprop][:, 0:2], mats.emission[lm],
        mats.two_sided[lm].to(torch.float32).reshape(L, 1),
    ], dim=1).contiguous()


def make_fused_body(scene, settings):
    """body(PathState) -> PathState running the whole bounce in one kernel
    launch (plus its two Sobol' block draws)."""
    if not structural_ok(scene):
        raise ValueError("scene is outside the fused bounce's analytic subset")
    from ..core.sobol import SobolSampler

    tables = pack_tables(scene)

    def body(s):
        # draw order of the JAX body: u_rr, u_sel, xi_l fill dims 0..3 of a
        # fresh block; the 3D BSDF draw does not fit and starts another
        smp = SobolSampler(s.sobol, dim=5)
        smp.sample_1d()
        smp.sample_1d()
        smp.sample_2d()
        ua = smp.arrays.buffer
        smp.sample_3d()
        ub = smp.arrays.buffer
        smp.increment_padding()
        r = fused_bounce(tables, s.fields(), ua, ub, settings.max_depth,
                         settings.caustics, settings.nee_only)
        return s.merged(r, smp.arrays)

    return body
