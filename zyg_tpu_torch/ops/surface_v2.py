"""The general hybrid bounce for textured and env-lit scenes (counterpart of
zyg_tpu/ops/shade.py:1333-1738: `_make_surface_kernel_v2`,
`_run_surface_v2`, `structural_ok_mesh_v2`, `make_mesh_fused_body_v2`).
Kernel: csrc/surface_v2.cu.

Kernel 5 (ops/surface.py) samples the lights inside its kernel, which caps
it at untextured rectangle lights. This bounce keeps everything that reads
a large table in torch glue and only the register-resident shade core in
the kernel:

  glue    intersect_scene (isect, the moving props at the lane's shutter
          time, then traverse) + build_fragment with uv
          (and the tangent frame where a material has a normal map) ->
          texture jitter -> the triplanar uv where a texture reads it ->
          the normal map -> materials.gather (stochastic color and
          roughness texels, bilinear emission maps, the analytic Checker
          and Noise nodes point-sampled, IES profiles) -> eval_radiance ->
          light_hit_pdf * light_select_pdf (rectangle SphQuad, sphere
          cone, disk, canopy, dome, distant cone, env-map density, the portal's windowed
          density; the light tree's pdf at the previous vertex) ->
          select_light (the power CDF, or the tree's descent at the hit) /
          sample_light / light_radiance (the NEE candidate: direction,
          radiance, pdf, shadow tmax)
  KERNEL  the MIS weight of the BSDF-hit emission, russian roulette, the
          substitute BSDF evaluation of the NEE candidate with the
          predivided power heuristic, the VNDF/cosine BSDF sample and the
          PathState merge; it emits nee_active, the pending NEE value and
          the shadow tmax
  glue    occluded (isect any-hit, then the traverse any-hit walk) and the
          merge of the pending value where the shadow ray got through.

The Sobol' draws follow the JAX body's order (u_rr, u_sel, xi_l, s3), so
lane lifecycles match lane for lane. The plain version is the JAX kernel
body in torch with the fused bounce's helpers (ops/shade.py); the CUDA
kernel computes each lane's outputs by the same operations in the same
order, and skips work whose result no output reads (csrc/surface_v2.cu).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import check_cuda, register, shade, stream_handle
from .isect import prop_table, static_layout
from .shade import (
    _offset_ray, _power_heuristic, _predivided_power_heuristic, _substitute_eval,
    _substitute_sample, _vadd, _vdot, _vmax, _vneg, _vwhere,
)
from ..core import vecmath as vm
from ..core.rng import hash2_u32, hash_u32, u32, u32_to_float
from ..render import materials as M
from ..scene import light_sampling as ls
from ..scene import shapes
from ..scene.types import RAY_MAX_T, MaterialKind, ShapeType

_KERNEL = register(
    "surface_v2",
    "zyg_surface_v2",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int64, ctypes.c_void_p],
)

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# the lane fields the kernel reads beside the PathState fields of the fused
# bounce (ops/shade.py _IN_FIELDS): the fragment of the closest hit, the
# hit material's parameters, the emission toward the ray with its light
# pdf, and the NEE candidate the glue sampled
FRAG_FIELDS = (("finite", _BOOL, 0), ("p", _F32, 3), ("geo_n", _F32, 3), ("n", _F32, 3))
MAT_FIELDS = (("mat_kind", _I32, 0), ("albedo", _F32, 3), ("alpha", _F32, 0),
              ("metallic", _F32, 0), ("f0", _F32, 3), ("specular", _F32, 0))
LIGHT_FIELDS = (("em", _F32, 3), ("hit_lp", _F32, 0), ("is_light", _BOOL, 0),
                ("nee_wi", _F32, 3), ("nee_rad", _F32, 3), ("nee_lpdf", _F32, 0),
                ("nee_pre", _BOOL, 0), ("nee_pre_tmax", _F32, 0))
IN_FIELDS = shade._IN_FIELDS + FRAG_FIELDS + MAT_FIELDS + LIGHT_FIELDS
OUT_FIELDS = shade._OUT_FIELDS + (
    ("reg_alpha", _F32, 0), ("nee_active", _BOOL, 0), ("shadow_tmax", _F32, 0),
    ("nee", _F32, 3),
)
# Which lanes' outputs depend on each input, by the lane's lifecycle: the
# bytes the function must read, by which the card check bounds the kernel
# (csrc/surface_v2.cu loads the head's inputs of every lane in one batch).
# The outputs and lane sets are ops/surface.py LANE_READS's, with
# "light_hit" any alive lane on a light (the dome is hit by a miss) whose
# emission's MIS weight reads hit_lp and bxdf_pdf, "nee_pre" the reaching
# lanes with a NEE candidate, and "nee_active" those whose NEE sample is
# active.
LANE_READS = {
    "alive": ("every",), "throughput": ("alive",), "depth": ("every",),
    "emission": ("every",), "direct": ("every",), "indirect": ("every",),
    "o": ("stopped", "failed"), "mis_o": ("stopped", "failed"), "mis_n": ("stopped", "failed"),
    "bxdf_pdf": ("light_hit",), "d": ("stopped", "reach"),
    "finite": ("alive",), "singular": ("alive",), "is_light": ("alive",), "em": ("alive",),
    "hit_lp": ("light_hit",), "mat_kind": ("hit",),
    "p": ("reach",), "geo_n": ("reach",), "n": ("reach",), "albedo": ("reach",),
    "alpha": ("reach",), "metallic": ("reach",), "f0": ("reach",), "specular": ("reach",),
    "nee_pre": ("reach",), "nee_wi": ("nee_pre",), "nee_rad": ("nee_active",),
    "nee_lpdf": ("nee_active",), "nee_pre_tmax": ("nee_active",),
}
# the uniforms: (array, columns, lane sets): u_rr, then the BSDF sample's three
UNIFORM_READS = (("ua", 1, ("roulette",)), ("ub", 3, ("reach",)))


def surface_v2_plain(st: dict, ua, ub, max_depth: int, caustics: bool, nee_only: bool) -> dict:
    """Plain torch version. st: the IN_FIELDS; ua[:, 0] = u_rr, ub[:, 0:3]
    = BSDF sample uniforms. Returns the OUT_FIELDS plus "rays" (alive lanes
    + NEE lanes); "direct"/"indirect" still lack the pending NEE value."""

    def cols(x):
        return (x[:, 0], x[:, 1], x[:, 2])

    o, d, thr0 = cols(st["o"]), cols(st["d"]), cols(st["throughput"])
    alive, singular, depth = st["alive"], st["singular"], st["depth"]
    bxdf_pdf_in = st["bxdf_pdf"]
    mis_o, mis_n_in = cols(st["mis_o"]), cols(st["mis_n"])
    res_em, res_di, res_in = cols(st["emission"]), cols(st["direct"]), cols(st["indirect"])
    u_rr = ua[:, 0]
    s0, s1, s2 = ub[:, 0], ub[:, 1], ub[:, 2]
    valid = st["finite"]
    p_hit, geo_n, frag_n = cols(st["p"]), cols(st["geo_n"]), cols(st["n"])
    mat = {"albedo": cols(st["albedo"]), "alpha": st["alpha"], "metallic": st["metallic"],
           "f0": cols(st["f0"]), "specular": st["specular"]}
    em = cols(st["em"])  # masked by the glue
    hit_lp, is_light = st["hit_lp"], st["is_light"]
    nee_wi, nee_rad = cols(st["nee_wi"]), cols(st["nee_rad"])
    wo = _vneg(d)
    primary = depth == 0

    # ---- connectLight: the MIS weight of the BSDF-hit emission (radiance
    # and light pdf arrive per lane)
    if not nee_only:
        mis_w = torch.where(singular | ~is_light, 1.0, _power_heuristic(bxdf_pdf_in, hit_lp))
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

    # ---- NEE: evaluate the glue's candidate
    is_sub = st["mat_kind"] == int(MaterialKind.SUBSTITUTE)
    can_nee = cont & is_sub
    f_nee, bpdf = _substitute_eval(mat, wo, nee_wi, frag_n, geo_n)
    f_nee = tuple(torch.where(is_sub, c, 0.0) for c in f_nee)
    bpdf = torch.where(is_sub, bpdf, 0.0)
    w_mis = _predivided_power_heuristic(st["nee_lpdf"], bpdf)
    nee_active = can_nee & st["nee_pre"] & (_vmax(f_nee) > 0.0)
    nee = tuple(torch.where(nee_active, t * r * f * w_mis, 0.0)
                for t, r, f in zip(thr, nee_rad, f_nee))

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
        "shadow_tmax": torch.where(nee_active, st["nee_pre_tmax"], 0.0),
        "nee": stack(nee),
        "rays": alive.sum(dtype=torch.int64) + nee_active.sum(dtype=torch.int64),
    }


def _surface_v2_cuda(fit, st: dict, ua, ub, max_depth, caustics, nee_only) -> dict:
    dev = st["o"].device
    n = st["o"].shape[0]
    check_cuda("surface_v2.fit", fit, _F32, dev, (112,))
    for name, dtype, w in IN_FIELDS:
        check_cuda(f"surface_v2.{name}", st[name], dtype, dev, (n, w) if w else (n,))
    for name, u, ncol in (("ua", ua, 1), ("ub", ub, 3)):
        check_cuda(f"surface_v2.{name}", u, _F32, dev, contiguous=False)
        if u.dim() != 2 or u.shape[0] != n or u.shape[1] < ncol or u.stride(1) != 1:
            raise ValueError(f"surface_v2.{name}: expected [N, >={ncol}] rows with unit column stride")
    out = {name: torch.empty((n, w) if w else (n,), dtype=dtype, device=dev)
           for name, dtype, w in OUT_FIELDS}
    rays = torch.zeros((1,), dtype=torch.int64, device=dev)
    ptrs = [fit] + [st[name] for name, _, _ in IN_FIELDS] + [ua, ub]
    ptrs += [out[name] for name, _, _ in OUT_FIELDS] + [rays]
    arr = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    if n > 0:
        _KERNEL(arr, ua.stride(0), ub.stride(0), int(max_depth), int(caustics), int(nee_only), n,
                stream_handle(dev))
    out["rays"] = rays[0]
    return out


def surface_v2(fit, st: dict, ua, ub, max_depth: int, caustics: bool, nee_only: bool) -> dict:
    """The shade core between the gathers and the shadow walk; the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors. fit: the GGX
    energy-fit table (render/materials.py fit_table), the kernel's copy of
    the coefficients the plain version evaluates in render/materials.py."""
    if st["o"].device.type == "cpu":
        return surface_v2_plain(st, ua, ub, int(max_depth), bool(caustics), bool(nee_only))
    return _surface_v2_cuda(fit, st, ua, ub, int(max_depth), bool(caustics), bool(nee_only))


_V2_LIGHT_SHAPES = {int(ShapeType.RECTANGLE), int(ShapeType.SPHERE), int(ShapeType.DISK),
                    int(ShapeType.CANOPY), int(ShapeType.DOME), int(ShapeType.DISTANT),
                    int(ShapeType.TRIANGLE_MESH), ls.PORTAL}
# the material features whose machinery runs in the glue (the JAX
# package's _V2_XLA_SIDE_FEATURES)
_V2_FEATURES = {"ies", "triplanar"}
# the shadow tmax toward an infinite light, float32(RAY_MAX_T) * float32(0.9)
_INF_SHADOW_TMAX = float(np.float32(RAY_MAX_T) * np.float32(0.9))


def structural_ok_mesh_v2(scene) -> bool:
    """Can this scene run the general bounce? (at least one light, all
    rectangles, spheres, disks, canopies, domes, distant lights, emissive
    meshes or portals; substitute and
    light materials with no feature but IES profiles and triplanar
    textures; analytic props the isect kernel tests)"""
    if scene.lights.count < 1:
        return False
    if not ls.light_shapes(scene) <= _V2_LIGHT_SHAPES:
        return False
    if set(scene.mat_features) - _V2_FEATURES:
        return False
    try:
        static_layout(scene)
    except ValueError:
        return False
    mkinds = set(scene.materials.kind.tolist())
    return mkinds <= {int(MaterialKind.SUBSTITUTE), int(MaterialKind.LIGHT)}


def _offset_rows(p, n):
    """shapes.offset_ray on [N, 3] rows."""
    return torch.stack(_offset_ray(p.unbind(1), n.unbind(1)), dim=-1)


class GeneralBounce:
    """body(PathState) -> PathState: the gathers, light sampling and the
    two traversals in torch glue around the surface_v2 kernel. `inputs`
    is the glue before the kernel, for measuring the kernel on a real
    bounce's lanes."""

    def __init__(self, scene, settings):
        if not structural_ok_mesh_v2(scene):
            raise ValueError("scene is outside the general bounce's subset")
        self.scene = scene
        self.settings = settings
        self.present = ls.light_shapes(scene)
        self.refl, self.shadow = prop_table(scene, "reflection"), prop_table(scene, "shadow")
        self.fit = M.fit_table(scene.prop_rot.device)
        # the JAX glue builds the tangent frame and applies the normal map
        # on every textured scene; both change nothing without a normal
        # map, so the port does them only where a material has one
        self.normal_mapped = (scene.textures is not None
                              and bool((scene.materials.normal_tex >= 0).any()))

    def inputs(self, s):
        """The kernel's lane fields, uniforms and the shadow rays of state
        s: (st, ua, ub, sampler after the bounce's draws, shadow origins,
        shadow directions)."""
        from ..core.sobol import SobolSampler

        scene = self.scene
        smp = SobolSampler(s.sobol, dim=5)
        tmax = torch.where(s.alive, RAY_MAX_T, 0.0)
        hit = shapes.intersect_scene(scene, self.refl, s.o, s.d, 0.0, tmax, primary=s.depth == 0,
                                     time=s.time)
        frag = shapes.build_fragment(scene, hit, s.o, s.d, need_tangents=self.normal_mapped,
                                     time=s.time)
        tex_xi = uv_alt = None
        if scene.textures is not None:
            # the texture jitter: a non-Sobol' stream per lane and bounce
            kx = hash2_u32(u32(s.vol_key) ^ 0xA511E9B3, u32(s.depth))
            ky = hash_u32(kx ^ 0x85EBCA6B)
            tex_xi = torch.stack([u32_to_float(kx), u32_to_float(ky)], dim=-1)
            if "triplanar" in scene.mat_features:
                uv_alt = M.triplanar_uv(scene, frag)
            if self.normal_mapped:
                frag.n = M.apply_normal_map(scene.materials, scene.textures, frag.material, frag.uv,
                                            frag.n, frag.t, frag.b, tex_xi=tex_xi, uv_alt=uv_alt)
        # no footprint: the JAX TPU dispatch point-samples the procedurals
        params = M.gather(scene.materials, frag.material, scene.textures, frag.uv, tex_xi,
                          features=scene.mat_features, uv_alt=uv_alt)
        valid = hit.valid()

        # ---- the BSDF-hit emission and its light pdf
        emission = torch.where(valid[:, None], M.eval_radiance(params, -s.d, frag.geo_n), 0.0)
        light_id = torch.where(valid, scene.prop_light[torch.clamp(hit.prop, min=0).long()], -1)
        if not self.settings.nee_only:
            hit_lp = (ls.light_hit_pdf(scene, self.present, hit.prop, s.mis_o, s.d,
                                       *ls.mis_hit(self.present, hit.t, frag, s.mis_o),
                                       time=s.time, hit_prim=hit.prim, n_at_origin=s.mis_n)
                      * ls.light_select_pdf(scene, light_id, p=s.mis_o, n=s.mis_n))
        else:
            hit_lp = torch.zeros_like(hit.t)

        # ---- Sobol' draws in the JAX body's order: u_rr, u_sel, xi_l fill
        # dims 0..3 of a fresh block; the 3-D BSDF draw starts another
        smp.sample_1d()
        u_sel = smp.sample_1d()
        xi_l = smp.sample_2d()
        ua = smp.arrays.buffer

        # ---- the NEE candidate
        light_idx, sel_pdf = ls.select_light(scene, u_sel, p=frag.p, n=frag.n)
        lsmp = ls.sample_light(scene, self.present, light_idx, frag.p, frag.geo_n, xi_l,
                               time=s.time, ns=frag.n)
        radiance = ls.light_radiance(scene, light_idx, lsmp.wi, lsmp.light_n, lsmp.uv)
        side = (vm.dot(lsmp.wi, frag.geo_n) >= 0.0)[:, None]
        shadow_o = _offset_rows(frag.p, torch.where(side, frag.geo_n, -frag.geo_n))
        inf = lsmp.infinite
        axis = torch.where(inf[:, None], lsmp.wi,
                           _offset_rows(lsmp.light_p, lsmp.light_n) - shadow_o)
        slen = torch.where(inf, RAY_MAX_T, vm.length(axis))
        sdir = torch.where(inf[:, None], lsmp.wi, axis / torch.clamp(slen, min=1e-20)[:, None])

        smp.sample_3d()
        ub = smp.arrays.buffer
        smp.increment_padding()

        st = s.fields()
        st.update(
            finite=valid & (hit.t < RAY_MAX_T), p=frag.p, geo_n=frag.geo_n, n=frag.n,
            mat_kind=params["kind"], albedo=params["albedo"], alpha=params["alpha"],
            metallic=params["metallic"], f0=params["f0"], specular=params["specular"],
            em=emission, hit_lp=hit_lp, is_light=light_id >= 0,
            nee_wi=lsmp.wi, nee_rad=radiance, nee_lpdf=lsmp.pdf * sel_pdf,
            nee_pre=(light_idx >= 0) & (sel_pdf > 0.0) & (lsmp.pdf > 0.0),
            # infinite lights: a shadow ray short of RAY_MAX_T, so the dome
            # (visible to shadow rays) never blocks its own light
            nee_pre_tmax=torch.where(inf, _INF_SHADOW_TMAX, slen),
        )
        return st, ua, ub, smp, shadow_o, sdir

    def __call__(self, s):
        st, ua, ub, smp, shadow_o, sdir = self.inputs(s)
        cfg = self.settings
        r = surface_v2(self.fit, st, ua, ub, cfg.max_depth, cfg.caustics, cfg.nee_only)
        blocked = shapes.occluded(self.scene, self.shadow, shadow_o, sdir, 0.0, r["shadow_tmax"],
                                  time=s.time)
        nee = torch.where((r["nee_active"] & ~blocked)[:, None], r["nee"], 0.0)
        nee_dir = (s.depth < 1)[:, None]
        r["direct"] = r["direct"] + torch.where(nee_dir, nee, 0.0)
        r["indirect"] = r["indirect"] + torch.where(nee_dir, 0.0, nee)
        return s.merged(r, smp.arrays)


def make_mesh_fused_body_v2(scene, settings) -> GeneralBounce:
    """body(PathState) -> PathState for textured and env-lit scenes."""
    return GeneralBounce(scene, settings)
