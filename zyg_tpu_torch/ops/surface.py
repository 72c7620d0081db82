"""The hybrid mesh bounce (counterpart of zyg_tpu/ops/shade.py:889-1330:
`_make_surface_kernel`, `_run_surface`, `structural_ok_mesh`, `_pack_mtab`,
`make_mesh_fused_body`). Kernel: csrc/surface.cu.

A mesh-scene bounce splits at its two traversals:

  intersect_scene (isect kernel over the analytic props, then the traverse
  kernel over the mesh instances) + build_fragment (torch gathers)
  -> the SURFACE kernel: everything between the hits, per lane: BSDF-hit
     emission with the SphQuad MIS weight from the last vertex, russian
     roulette, NEE (power-CDF light pick, Urena spherical-rectangle sample,
     substitute BSDF eval, predivided power heuristic), the VNDF/cosine
     BSDF sample and the PathState merge; it emits the shadow ray and the
     pending NEE value
  -> occluded (isect any-hit, then the traverse kernel's any-hit walk)
  -> the merge: pending NEE where the shadow ray got through.

Applicability (`structural_ok_mesh`): a scene with meshes, 1..8 rectangle
lights, <= 64 materials, all substitute or light, no textures and no env
map. The material of a lane
is its hit prop's (an index into the material table, [M, 14]); the light
table is the fused bounce's (ops/shade.py pack_ltab, [L, 20]).

Where the bounce can part from the fused Cornell bounce, it follows the
JAX mesh kernel (shade.py:1030-1036): NEE validity tests the GEOMETRIC
normal, and a light's radiance counts where it faces the point or is two
sided.

The plain version is the JAX kernel body in torch with the fused bounce's
helpers (ops/shade.py); the CUDA kernel computes each lane's outputs by the
same operations in the same order, and skips work whose result no output
reads (csrc/surface.cu says which, and what such a lane leaves behind).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import check_cuda, register, shade, stream_handle
from .isect import PropTable, prop_table
from .shade import (
    LTAB_W, MAX_LIGHTS, _offset_ray, _power_heuristic, _predivided_power_heuristic,
    _sphquad_init, _sphquad_pdf, _sphquad_sample, _substitute_eval, _substitute_sample, _vadd,
    _vdot, _vlength, _vmax, _vneg, _vscale, _vsub, _vwhere, pack_ltab,
)
from ..render import materials as M
from ..scene import shapes
from ..scene.types import RAY_MAX_T, MaterialKind, ShapeType

# mtab row layout (one row per scene material):
# 0 kind | 1:4 albedo | 4 alpha | 5 metallic | 6:9 f0 | 9 specular |
# 10:13 emission | 13 two_sided
MTAB_W = 14
MAX_MATERIALS = 64

_KERNEL = register(
    "surface",
    "zyg_surface",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p],
)


def pack_mtab(scene) -> torch.Tensor:
    """[M, 14] per-material parameters (layout above)."""
    mats = scene.materials
    n = mats.kind.shape[0]
    rough = torch.clamp(mats.roughness, min=M.MIN_ROUGHNESS)
    metallic = mats.metallic
    color = mats.color
    t = (mats.ior - 1.0) / (mats.ior + 1.0)
    f0 = (t * t)[:, None] * (1.0 - metallic[:, None]) + color * metallic[:, None]
    albedo = (1.0 - metallic[:, None]) * color

    def col1(x):
        return x.to(torch.float32).reshape(n, 1)

    return torch.cat([
        col1(mats.kind), albedo, col1(rough * rough), col1(metallic), f0,
        col1(mats.specular), mats.emission, col1(mats.two_sided),
    ], dim=1).contiguous()


@dataclass
class MeshTables:
    """The mesh bounce's constant tables, packed once per render: mtab
    [M, 14], ltab [L, 20], the GGX fit coefficients [112] (the kernel's;
    the plain version evaluates the fits in render/materials.py) and the
    analytic props for closest-hit and shadow rays."""

    mtab: torch.Tensor
    ltab: torch.Tensor
    fit: torch.Tensor
    refl: PropTable
    shadow: PropTable


def pack_mesh_tables(scene) -> MeshTables:
    mtab = pack_mtab(scene)
    return MeshTables(mtab, pack_ltab(scene), M.fit_table(mtab.device),
                      prop_table(scene, "reflection"), prop_table(scene, "shadow"))


def structural_ok_mesh(scene) -> bool:
    """Can this scene run the mesh bounce? (meshes present, 1..8 rectangle
    lights selected by the power CDF, no light tree, <= 64 materials,
    substitute and light materials only, no textures, env map or moving
    props)"""
    if scene.meshes is None:
        return False  # analytic-only scenes take the fused bounce
    if scene.curves is not None or scene.points is not None:
        return False  # as the JAX gate (zyg_tpu/ops/shade.py:1152): ops/surface_v2.py
    if scene.textures is not None or scene.env is not None:
        return False  # textured and env-lit scenes take ops/surface_v2.py
    if scene.light_tree is not None:
        return False  # the kernel selects by the power CDF (ops/surface_v2.py)
    if scene.mat_features or scene.portals:
        return False  # IES profiles and portals take ops/surface_v2.py
    if scene.animated_props:
        return False  # moving props take ops/surface_v2.py (zyg_tpu/ops/shade.py:1154)
    if scene.lights.count < 1 or scene.lights.count > MAX_LIGHTS:
        return False
    light_shapes = {int(s) for s in scene.prop_shape[scene.lights.prop.long()].tolist()}
    if light_shapes != {int(ShapeType.RECTANGLE)}:
        return False
    if scene.materials.kind.shape[0] > MAX_MATERIALS:
        return False
    mkinds = set(scene.materials.kind.tolist())
    return mkinds <= {int(MaterialKind.SUBSTITUTE), int(MaterialKind.LIGHT)}


# the lane fields the kernel reads beside the PathState fields of the
# fused bounce (ops/shade.py _IN_FIELDS): the fragment of the closest hit
FRAG_FIELDS = (("finite", torch.bool, 0), ("p", torch.float32, 3),
               ("geo_n", torch.float32, 3), ("n", torch.float32, 3),
               ("mslot", torch.int32, 0), ("light_id", torch.int32, 0))
_OUT_FIELDS = shade._OUT_FIELDS + (
    ("reg_alpha", torch.float32, 0), ("nee_active", torch.bool, 0),
    ("shadow_o", torch.float32, 3), ("shadow_d", torch.float32, 3),
    ("shadow_tmax", torch.float32, 0), ("nee", torch.float32, 3),
)
# Which lanes' outputs depend on each input, by the lane's lifecycle: the
# bytes the function must read, by which the card check bounds the kernel
# (csrc/surface.cu loads the head's inputs of every lane in one batch, a
# little more). The outputs are those the checks compare: a lane that
# leaves the bounce dead has no throughput, bxdf_pdf or reg_alpha that
# anything reads (csrc/surface.cu), and no shadow ray or NEE value unless
# its NEE sample is active. The lane sets: "every" lane; "stopped", dead on
# entry or ended before NEE, whose path state passes through; "alive";
# "hit", alive on a finite hit; "reach", going on to NEE; "failed",
# reaching lanes whose BSDF sample fails, which keep their ray and MIS
# vertex; "light_hit", hits on a light whose emission's MIS weight reads
# the light's pdf from mis_o and bxdf_pdf (not singular, not NEE only);
# "roulette", hits short of the depth limit on a substitute material whose
# throughput makes roulette draw.
LANE_READS = {
    "alive": ("every",), "throughput": ("alive",), "depth": ("every",),
    "emission": ("every",), "direct": ("every",), "indirect": ("every",),
    "o": ("stopped", "failed"), "mis_n": ("stopped", "failed"),
    "mis_o": ("stopped", "failed", "light_hit"), "bxdf_pdf": ("light_hit",),
    "d": ("stopped", "hit"), "finite": ("alive",), "singular": ("hit",), "geo_n": ("hit",),
    "mslot": ("hit",), "light_id": ("hit",), "p": ("reach",), "n": ("reach",),
}
# the uniforms: (array, columns, lane sets): u_rr, then (u_sel, xi_l), then
# the BSDF sample's three
UNIFORM_READS = (("ua", 1, ("roulette",)), ("ua", 3, ("reach",)), ("ub", 3, ("reach",)))


def surface_plain(tables: MeshTables, st: dict, ua, ub, max_depth: int, caustics: bool,
                  nee_only: bool) -> dict:
    """Plain torch version. st: the PathState fields of shade._IN_FIELDS
    plus the FRAG_FIELDS; ua[:, 0:4] = (u_rr, u_sel, xi_l), ub[:, 0:3] = BSDF
    sample uniforms. Returns the _OUT_FIELDS plus "rays" (alive lanes +
    shadow rays); "direct"/"indirect" still lack the pending NEE value."""
    mtab, ltab = tables.mtab, tables.ltab
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
    valid = st["finite"]
    p_hit, geo_n, frag_n = cols(st["p"]), cols(st["geo_n"]), cols(st["n"])
    light_id = st["light_id"]
    wo = _vneg(d)
    primary = depth == 0

    # ---- per-lane material: the hit material's row
    row = mtab[st["mslot"].long()]

    def gm(c):
        return row[:, c]

    kind_m = gm(0)
    mat = {"albedo": (gm(1), gm(2), gm(3)), "alpha": gm(4), "metallic": gm(5),
           "f0": (gm(6), gm(7), gm(8)), "specular": gm(9)}
    emission = (gm(10), gm(11), gm(12))
    two_sided = gm(13) > 0.5

    # ---- connectLight: BSDF-hit emission, MIS against the hit light's
    # SphQuad pdf from the last real vertex mis_o
    facing = _vdot(wo, geo_n) > 0.0
    em_vis = valid & (facing | two_sided)
    em = tuple(torch.where(em_vis, c, 0.0) for c in emission)
    is_light = light_id >= 0
    if not nee_only:
        hrow = ltab[torch.clamp(light_id, 0, L - 1).long()]

        def glh(c):
            return hrow[:, c]

        dlh = _vsub(mis_o, (glh(11), glh(12), glh(13)))
        olh = (_vdot(dlh, (glh(2), glh(3), glh(4))), _vdot(dlh, (glh(5), glh(6), glh(7))),
               _vdot(dlh, (glh(8), glh(9), glh(10))))
        qh = _sphquad_init(glh(14), glh(15), olh)
        lp = _sphquad_pdf(qh, olh, glh(14), glh(15)) * glh(1)
        mis_w = torch.where(singular | ~is_light, 1.0, _power_heuristic(bxdf_pdf_in, lp))
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
    lr0, lr1, lr2 = (gl(2), gl(3), gl(4)), (gl(5), gl(6), gl(7)), (gl(8), gl(9), gl(10))
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
    wi_n = _vscale(axis, 1.0 / torch.clamp(_vlength(axis), min=1e-20))
    # validity: q.S and the hemisphere of the GEOMETRIC normal (the
    # shading normal only steers f)
    valid_l = (q["S"] > 1e-7) & (_vdot(wi_n, geo_n) > 0.0)
    pdf_l = torch.where(valid_l, _sphquad_pdf(q, ol, lsx, lsy), 0.0)
    l_facing = _vdot(_vneg(wi_n), lr2) > 0.0
    radiance = tuple(torch.where(l_facing | l2s, c, 0.0) for c in lem)

    f_nee, bpdf = _substitute_eval(mat, wo, wi_n, frag_n, geo_n)
    f_nee = tuple(torch.where(is_sub, c, 0.0) for c in f_nee)
    bpdf = torch.where(is_sub, bpdf, 0.0)
    w_mis = _predivided_power_heuristic(pdf_l * sel_pdf, bpdf)

    sh_n = _vwhere(_vdot(wi_n, geo_n) >= 0.0, geo_n, _vneg(geo_n))
    shadow_o = _offset_ray(p_hit, sh_n)
    sh_axis = _vsub(_offset_ray(rect_p, lr2), shadow_o)
    slen = _vlength(sh_axis)
    sdir = _vscale(sh_axis, 1.0 / torch.clamp(slen, min=1e-20))
    nee_active = can_nee & (sel_pdf > 0.0) & (pdf_l > 0.0) & (_vmax(f_nee) > 0.0)
    nee = tuple(torch.where(nee_active, t * r * f * w_mis, 0.0)
                for t, r, f in zip(thr, radiance, f_nee))

    # ---- BSDF sample + PathState merge
    wi_s, weight, pdf_s, ok_s, reg_a = _substitute_sample(mat, wo, frag_n, geo_n, s0, s1, s2)
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
        "reg_alpha": reg_a,
        "nee_active": nee_active,
        "shadow_o": stack(shadow_o),
        "shadow_d": stack(sdir),
        "shadow_tmax": torch.where(nee_active, slen, 0.0),
        "nee": stack(nee),
        "rays": alive.sum(dtype=torch.int64) + nee_active.sum(dtype=torch.int64),
    }


def _surface_cuda(tables: MeshTables, st: dict, ua, ub, max_depth, caustics, nee_only) -> dict:
    dev = st["o"].device
    n = st["o"].shape[0]
    mtab, ltab, fit = tables.mtab, tables.ltab, tables.fit
    m, l = mtab.shape[0], ltab.shape[0]
    check_cuda("surface.mtab", mtab, torch.float32, dev, (m, MTAB_W))
    check_cuda("surface.ltab", ltab, torch.float32, dev, (l, LTAB_W))
    check_cuda("surface.fit", fit, torch.float32, dev, (112,))
    for name, dtype, w in shade._IN_FIELDS + FRAG_FIELDS:
        check_cuda(f"surface.{name}", st[name], dtype, dev, (n, w) if w else (n,))
    for name, u, ncol in (("ua", ua, 4), ("ub", ub, 3)):
        check_cuda(f"surface.{name}", u, torch.float32, dev, contiguous=False)
        if u.dim() != 2 or u.shape[0] != n or u.shape[1] < ncol or u.stride(1) != 1:
            raise ValueError(f"surface.{name}: expected [N, >={ncol}] rows with unit column stride")
    out ={name: torch.empty((n, w) if w else (n,), dtype=dtype, device=dev)
           for name, dtype, w in _OUT_FIELDS}
    rays = torch.zeros((1,), dtype=torch.int64, device=dev)
    ptrs = [mtab, ltab, fit] + [st[name] for name, _, _ in shade._IN_FIELDS + FRAG_FIELDS]
    ptrs += [ua, ub]
    ptrs += [out[name] for name, _, _ in _OUT_FIELDS] + [rays]
    arr = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    if n > 0:
        _KERNEL(arr, m, l, ua.stride(0), ub.stride(0), int(max_depth), int(caustics),
                int(nee_only), n, stream_handle(dev))
    out["rays"] = rays[0]
    return out


def surface(tables: MeshTables, st: dict, ua, ub, max_depth: int, caustics: bool,
            nee_only: bool) -> dict:
    """The bounce between the traversals; the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    fn = surface_plain if st["o"].device.type == "cpu" else _surface_cuda
    return fn(tables, st, ua, ub, int(max_depth), bool(caustics), bool(nee_only))


def make_mesh_fused_body(scene, settings):
    """body(PathState) -> PathState for mesh scenes: the two traversals
    around the surface kernel (plus the bounce's two Sobol' block draws)."""
    if not structural_ok_mesh(scene):
        raise ValueError("scene is outside the mesh bounce's subset")
    from ..core.sobol import SobolSampler

    tables = pack_mesh_tables(scene)

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

        tmax = torch.where(s.alive, RAY_MAX_T, 0.0)
        # the lanes' shutter times: a deforming mesh is walked and shaded
        # at them (zyg_tpu/ops/shade.py:1247-1253, :1290)
        hit = shapes.intersect_scene(scene, tables.refl, s.o, s.d, 0.0, tmax,
                                     primary=s.depth == 0, time=s.time)
        frag = shapes.build_fragment(scene, hit, s.o, s.d, time=s.time)
        valid = hit.valid()
        st = s.fields()
        st.update(
            finite=valid & (hit.t < RAY_MAX_T), p=frag.p, geo_n=frag.geo_n, n=frag.n,
            mslot=torch.clamp(frag.material, min=0).to(torch.int32),
            light_id=torch.where(valid, scene.prop_light[torch.clamp(hit.prop, min=0).long()],
                                 -1).to(torch.int32),
        )
        r = surface(tables, st, ua, ub, settings.max_depth, settings.caustics, settings.nee_only)
        blocked = shapes.occluded(scene, tables.shadow, r["shadow_o"], r["shadow_d"], 0.0,
                                  r["shadow_tmax"], time=s.time)
        nee = torch.where((r["nee_active"] & ~blocked)[:, None], r["nee"], 0.0)
        nee_dir = (s.depth < 1)[:, None]
        r["direct"] = r["direct"] + torch.where(nee_dir, nee, 0.0)
        r["indirect"] = r["indirect"] + torch.where(nee_dir, 0.0, nee)
        return s.merged(r, smp.arrays)

    return body
