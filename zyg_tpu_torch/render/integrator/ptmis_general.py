"""The general PTMIS body in torch, for scenes with glass or participating
media (counterpart of the XLA body of
zyg_tpu/render/integrator/ptmis.py:353-1058, restricted to what the port
loads).

One masked wavefront bounce over the per-lane PathState, as the JAX
package's general body computes it:

  closest hit (isect, then the BVH walk on mesh scenes) -> fragment ->
  the medium stack: the effective enclosing medium and the ior outside
  the hit prop -> material gather -> the volume event along the segment
  inside the enclosing medium (Beer absorption in glass; a scatter, an
  absorption or a pass through a Volumetric medium, by the homogeneous
  closed form or the tracking kernel, render/integrator/volume.py, with
  the emission an emissive medium gives off along it) -> false
  interfaces (a lower-priority dielectric inside a higher one) -> the
  BSDF-hit emission with its MIS weight, and the segment's volume
  emission unweighted -> russian roulette -> which glass vertices split
  -> NEE at the surface or the scatter point (light tree or power CDF,
  rectangle, sphere, disk, dome and volume lights, over the whole sphere at a scatter
  vertex; the BSDF, or the Henyey-Greenstein phase at a scatter,
  evaluated with the split's pdf convention; shadow any-hit and the
  transmittance through the volume props, the emitting one included) ->
  the BSDF or phase sample (substitute, smooth or rough glass, hair on
  the curve fragment's tangent frame, the Volumetric boundary's
  pass-through; the reflect branch forced on splitting lanes) -> the stack update where a ray crosses a medium
  boundary -> the refract branch parked in the lane's resume slot.

The Sobol' draws keep the JAX body's order: u_dist (scenes with media),
the roulette's r, u_sel and xi_l (scenes with lights), xi3_l (scenes with
volume lights: the interior point's third dimension), then the 3-D BSDF
(or phase) sample, then padding. The JAX body decides features at trace
time (`has_media`, `split_on`, ...); this one decides the same things
once per render in `__init__` and computes nothing for refused features,
which `check_general` names: portal lights, Canopy lights, image
textures, env-mapped domes and Distant lights on this body, and material
features other than glass, rough glass, media, volumetric, spectral media,
emissive media and hair (so IES profiles and triplanar textures). Scenes
with hair get the fragment's tangent frame (the JAX body asks for it,
zyg_tpu/render/integrator/ptmis.py:371-373).

With settings.collect_aovs (every dispatch with sensor AOVs rides this
body) the primary hit also adds its albedo, depth, material id, normals,
roughness and coverage to the dispatch's pixel planes (_capture_aovs).
The shadow-catcher alpha of the JAX body (ptmis.py:810-840) has no
counterpart: the scene loader refuses the `shadow_catcher` entity key.

With a photon map (render/integrator/photon.py) the primary chain's
vertices that can evaluate a BSDF add the map's estimate to the direct
class, after the segment's emission (the photon_gather kernel).

Kernels on this path: isect (closest and any hit), traverse (mesh
scenes), curves and points (scenes with curves or point clouds,
ops/curves.py and ops/points.py), sobol_block (every draw), track (the grid media's walks,
ops/track.py), photon_gather (ops/photon.py, under a photon map) and
accum (the flushes, in ptmis.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ...core import fmath
from ...core import vecmath as vm
from ...core.rng import hash_u32, to_i32, u32
from ...core.sobol import SobolSampler
from ...ops.isect import prop_table
from ...ops.shade import _offset_ray
from ...ops.surface_v2 import _INF_SHADOW_TMAX
from ...scene import light_sampling as ls
from ...scene import shapes
from ...scene.types import RAY_MAX_T, MaterialKind, ShapeType, UnsupportedScene
from .. import materials as M
from . import photon as photon_mod
from .lighttracer import check_emitters
from . import volume as vol_mod
from .ptmis import IValue, PathState, power_heuristic, predivided_power_heuristic, split_enabled

_GLASS = int(MaterialKind.GLASS)
_MEDIUM_KINDS = (int(MaterialKind.GLASS), int(MaterialKind.VOLUMETRIC))
# the material features this body renders
_FEATURES = {"glass", "rough_glass", "media", "volumetric", "spectral_media", "vol_emission",
             "hair"}
_LIGHT_SHAPES = {int(ShapeType.RECTANGLE), int(ShapeType.SPHERE), int(ShapeType.DISK),
                 int(ShapeType.DOME), int(ShapeType.TRIANGLE_MESH), ls.VOLUME}


def check_general(scene, settings, photons: bool = False) -> None:
    """Raise UnsupportedScene naming the first feature of the scene that the
    general body does not render (photons: under a photon map, whose
    light paths start at the lights of lighttracer.sample_light_from and
    whose gather kernel evaluates the substitute BSDF only)."""
    extra = set(scene.mat_features) - _FEATURES
    if extra:
        raise UnsupportedScene(f"material features {sorted(extra)}")
    if photons and "rough_glass" in scene.mat_features:
        raise UnsupportedScene("rough glass under a photon map (the gather kernel evaluates the "
                               "substitute BSDF only)")
    if scene.portals:
        raise UnsupportedScene("portal lights on the general body (glass under a portal)")
    if scene.lights.count and int(ShapeType.CANOPY) in ls.light_shapes(scene):
        raise UnsupportedScene("Canopy lights on the general body (glass under a canopy)")
    if scene.env is not None:
        raise UnsupportedScene("env-mapped Dome lights on the general body (glass under a sky)")
    if scene.textures is not None:
        raise UnsupportedScene("image textures on the general body (glass with textures)")
    shapes_ = ls.light_shapes(scene) if scene.lights.count else set()
    if int(ShapeType.DISTANT) in shapes_:
        raise UnsupportedScene("Distant lights on the general body (glass under a sun)")
    if not shapes_ <= _LIGHT_SHAPES:
        raise UnsupportedScene(f"light shapes {sorted(shapes_ - _LIGHT_SHAPES)} on the general body")
    if photons:
        check_emitters(scene)


def _offset_rows(p, n):
    """shapes.offset_ray on [N, 3] rows."""
    return torch.stack(_offset_ray(p.unbind(1), n.unbind(1)), dim=-1)


def _side(v, geo_n):
    """geo_n flipped to the side of v (the offset direction of a ray
    leaving along v)."""
    return torch.where((vm.dot(v, geo_n) >= 0.0)[:, None], geo_n, -geo_n)


def _add(result: IValue, value, depth, direct_cutoff: int, is_emission, singular) -> IValue:
    """ref helper.zig IValue.add: emission, direct (singular or shallow) or
    indirect, by lane."""
    to_direct = singular | (depth < direct_cutoff)
    em = torch.where(is_emission[:, None], value, 0.0)
    di = torch.where((~is_emission & to_direct)[:, None], value, 0.0)
    ind = torch.where((~is_emission & ~to_direct)[:, None], value, 0.0)
    return IValue(result.emission + em, result.direct + di, result.indirect + ind)


class GeneralBody:
    """body(PathState) -> PathState for scenes with glass. Per-render
    constants (prop tables, material kinds and priorities, light shapes)
    are built once here."""

    general = True  # integrate_persistent carries the medium stack and split slot

    def __init__(self, scene, settings, photon_map=None):
        check_general(scene, settings, photons=photon_map is not None)
        self.scene = scene
        self.settings = settings
        # the frame's photon map (render/integrator/photon.py), gathered at
        # the primary chain's first vertices that can evaluate a BSDF
        self.photon_map = photon_map
        feats = set(scene.mat_features)
        self.features = feats
        self.has_media = "media" in feats
        # hair reads the fragment's tangent frame and its offset across the fiber
        self.has_hair = "hair" in feats
        # Volumetric media scatter: the scatter, phase and NEE-at-a-scatter
        # branches exist only then (glass interiors only absorb)
        self.scatters = "volumetric" in feats
        self.has_lights = scene.lights.count > 0
        self.split_on = split_enabled(scene, settings)
        self.present = ls.light_shapes(scene) if self.has_lights else set()
        # volume lights draw a third NEE dimension (xi3_l)
        self.vol_lights = ls.VOLUME in self.present
        self.refl, self.shadow = prop_table(scene, "reflection"), prop_table(scene, "shadow")
        kinds = scene.materials.kind
        self.mat_medium = (kinds == _MEDIUM_KINDS[0]) | (kinds == _MEDIUM_KINDS[1])
        self.mat_prio = scene.materials.priority.to(torch.float32)

    def __call__(self, s: PathState) -> PathState:
        scene, cfg = self.scene, self.settings
        smp = SobolSampler(s.sobol, dim=5)
        rays = s.rays + s.alive.sum(dtype=torch.int64)
        # the split weight scales contributions, never throughput
        sw = s.split["w"][:, None] if self.split_on else 1.0
        primary = s.depth == 0
        zeros_b = torch.zeros_like(s.alive)

        # dead lanes get tmax 0: they fall out of the walks at once
        ray_tmax = torch.where(s.alive, RAY_MAX_T, 0.0)
        hit = shapes.intersect_scene(scene, self.refl, s.o, s.d, 0.0, ray_tmax, primary=primary,
                                     time=s.time)
        frag = shapes.build_fragment(scene, hit, s.o, s.d, need_tangents=self.has_hair,
                                     time=s.time)
        valid = hit.valid()
        prop_c = torch.clamp(hit.prop, min=0)
        mat_c = torch.clamp(frag.material, min=0).long()
        if self.has_media:
            # the enclosing medium is the stack's highest-priority entry;
            # fresnel sees the medium around the hit prop, its own entry
            # excluded (ref medium.zig topIor, vertex.zig interfaceChange)
            eff_prop, _ = vol_mod.stack_effective(scene, s.medium)
            medium_ior, max_prio_excl, _ = vol_mod.stack_info_at_hit(scene, s.medium, prop_c)
        else:
            medium_ior = torch.ones_like(hit.t)
        params = M.gather(scene.materials, frag.material, uv=frag.uv, medium_ior=medium_ior,
                          features=self.features)
        wo = -s.d
        finite_hit = valid & (hit.t < RAY_MAX_T)

        scatter = absorbed = zeros_b
        if self.has_media:
            u_dist = smp.sample_1d()
            seg = torch.clamp(hit.t, max=3.0e37)
            if self.scatters:
                # distance sampling: the phase g and the sampler use the
                # same depth-scaled coefficients (similarity relation)
                _, _, g_med = M.medium_coefficients(
                    scene.materials, vol_mod.medium_material(scene, eff_prop),
                    vol_depth=s.vol_depth)
                ev = vol_mod.sample_interaction(scene, eff_prop, s.o, s.d, seg, u_dist,
                                                s.vol_key, vol_depth=s.vol_depth)
                scatter = s.alive & ev.scatter & valid
                absorbed = s.alive & ev.absorb
                throughput0 = s.throughput * ev.weight
                p_scatter = ev.p
            else:
                throughput0 = s.throughput * vol_mod.absorption_weight(scene, eff_prop, seg)
            # false interface: the hit dielectric loses to an enclosing one
            # and the ray passes straight through (ref medium.zig priorities)
            is_medium_b = self.mat_medium[mat_c]
            false_if = (finite_hit & is_medium_b & (self.mat_prio[mat_c] < max_prio_excl)
                        & ~scatter)
        else:
            throughput0 = s.throughput
            false_if = zeros_b

        if cfg.collect_aovs:
            self._capture_aovs(s, hit, frag, params, finite_hit, scatter)

        # ---- connectLight: the BSDF-hit emission with its MIS weight,
        # pdfs measured from the last real vertex (mis_o, mis_n)
        emission = torch.where((valid & ~scatter)[:, None],
                               M.eval_radiance(params, wo, frag.geo_n), 0.0)
        light_id = torch.where(valid, scene.prop_light[prop_c.long()], -1)
        is_light = light_id >= 0
        if self.has_lights and not cfg.nee_only:
            # the previous real vertex's NEE sampled the sphere if it was a scatter
            ts = s.from_volume if self.scatters else None
            lp = (ls.light_hit_pdf(scene, self.present, hit.prop, s.mis_o, s.d,
                                   *ls.mis_hit(self.present, hit.t, frag, s.mis_o),
                                   total_sphere=ts, time=s.time, hit_prim=hit.prim,
                                   n_at_origin=s.mis_n)
                  * ls.light_select_pdf(scene, light_id, p=s.mis_o, n=s.mis_n,
                                        total_sphere=ts))
            mis_w = torch.where(s.singular | ~is_light, 1.0, power_heuristic(s.bxdf_pdf, lp))
            if not cfg.caustics:
                mis_w = torch.where(s.singular & (s.depth > 0) & is_light, 0.0, mis_w)
        elif cfg.nee_only:
            mis_w = torch.where(s.singular, 1.0, torch.where(is_light, 0.0, 1.0))
        else:
            mis_w = torch.ones_like(hit.t)
        contrib = torch.where(s.alive[:, None], sw * throughput0 * mis_w[:, None] * emission, 0.0)
        result = _add(s.result, contrib, s.depth, 2, primary, s.singular)
        if self.scatters and ev.emission is not None:
            # the volume emission gathered along this segment, unweighted
            # (ref pathtracer_mis: the Absorb event's li)
            vol_c = torch.where(s.alive[:, None], sw * s.throughput * ev.emission, 0.0)
            result = _add(result, vol_c, s.depth, 2, primary, s.singular)
        if self.photon_map is not None:
            # the photon map's estimate at the primary chain's vertices that
            # can evaluate a BSDF (ref pathtracer_mis.zig photonLi -> direct;
            # zyg_tpu/render/integrator/ptmis.py:607-628)
            gather_ok = s.alive & valid & ~scatter & M.can_evaluate(params) & s.primary_chain
            if not cfg.photons_not_only_through_specular:
                gather_ok = gather_ok & (s.depth > 0) & s.singular
            ph_li = photon_mod.gather(self.photon_map, params, frag.p, wo, frag.n, frag.geo_n,
                                      gather_ok)
            result = IValue(result.emission,
                            result.direct + torch.where(gather_ok[:, None],
                                                        sw * throughput0 * ph_li, 0.0),
                            result.indirect)

        cont = (s.alive & (finite_hit | scatter) & ~absorbed & (s.depth < cfg.max_depth)
                & (s.vol_depth < cfg.max_depth_volume))

        # ---- russian roulette
        throughput, kill = M.russian_roulette(throughput0, smp.sample_1d())
        cont = cont & ~kill

        # ---- which glass vertices split (ref vertex.zig Pool maxSplits),
        # decided before NEE so its MIS pdf drops the fresnel selection
        # factor on exactly the lanes whose BSDF sample is forced
        same_side = vm.dot(wo, frag.geo_n) > 0.0
        if self.split_on:
            eta_i = torch.where(same_side, params["ior_outside"], params["ior"])
            eta_t = torch.where(same_side, params["ior"], 1.0)
            rough = params["alpha"] > M.MIN_ALPHA * 1.001
            will_split = (
                cont & (params["kind"] == _GLASS) & ~s.split["pending"]
                & (s.primary_chain | (s.depth < 3))
                & (torch.abs(eta_i - eta_t) >= 1e-6)  # index-matched: a null event
                & ~scatter
                & ~false_if
                & (same_side | ~rough)  # rough refraction splits only from outside
            )
        else:
            will_split = None

        # ---- NEE (ref sampleLights / evaluateLight)
        if self.has_lights:
            u_sel = smp.sample_1d()
            xi_l = smp.sample_2d()
            xi3_l = smp.sample_1d() if self.vol_lights else None
            ts = scatter if self.scatters else None
            nee_p = torch.where(scatter[:, None], p_scatter, frag.p) if self.scatters else frag.p
            can_nee = cont & (scatter | M.can_evaluate(params)) & ~false_if
            light_idx, sel_pdf = ls.select_light(scene, u_sel, p=nee_p, n=frag.n, total_sphere=ts)
            lsmp = ls.sample_light(scene, self.present, light_idx, nee_p, frag.geo_n, xi_l,
                                   total_sphere=ts, xi3=xi3_l, time=s.time, ns=frag.n)
            # a volume light's lanes radiate from their interior point (its
            # light_n is 0: the shadow ray's end takes no offset)
            radiance = ls.light_radiance(scene, light_idx, lsmp.wi, lsmp.light_n, lsmp.uv,
                                         vol=(lsmp.vol_mask, lsmp.vol_radiance))
            f, bpdf = M.eval_bsdf(params, wo, lsmp.wi, frag.n, frag.geo_n, glass_split=will_split,
                                  t=frag.t, b=frag.b)
            if self.scatters:
                # a scatter vertex evaluates the phase function instead
                ph = M.hg_phase(vm.dot(s.d, lsmp.wi), g_med)
                f = torch.where(scatter[:, None], ph[:, None], f)
                bpdf = torch.where(scatter, ph, bpdf)
            w = predivided_power_heuristic(lsmp.pdf * sel_pdf, bpdf)
            shadow_o = _offset_rows(frag.p, _side(lsmp.wi, frag.geo_n))
            if self.scatters:
                shadow_o = torch.where(scatter[:, None], p_scatter, shadow_o)
            inf = lsmp.infinite
            axis = torch.where(inf[:, None], lsmp.wi,
                               _offset_rows(lsmp.light_p, lsmp.light_n) - shadow_o)
            slen = torch.where(inf, RAY_MAX_T, vm.length(axis))
            sdir = torch.where(inf[:, None], lsmp.wi, axis / torch.clamp(slen, min=1e-20)[:, None])
            nee_active = (can_nee & (light_idx >= 0) & (sel_pdf > 0.0) & (lsmp.pdf > 0.0)
                          & (f.amax(dim=-1) > 0.0))
            shadow_tmax = torch.where(nee_active, torch.where(inf, _INF_SHADOW_TMAX, slen), 0.0)
            blocked = shapes.occluded(scene, self.shadow, shadow_o, sdir, 0.0, shadow_tmax,
                                      time=s.time)
            base = sw * throughput * radiance * f * w[:, None]
            if scene.volume_props:
                # media attenuate shadow rays instead of blocking them
                base = base * vol_mod.transmittance(
                    scene, shadow_o, sdir, shadow_tmax,
                    to_i32(hash_u32(u32(s.vol_key) ^ 0x1B873593)))
            nee = torch.where((nee_active & ~blocked)[:, None], base, 0.0)
            rays = rays + nee_active.sum(dtype=torch.int64)
            result = _add(result, nee, s.depth, 1, zeros_b, zeros_b)
        else:
            smp.sample_1d()
            smp.sample_2d()
        new_nee_thr = torch.zeros_like(hit.t)

        # ---- BSDF sample (the reflect branch forced where the vertex splits)
        s3 = smp.sample_3d()
        branch = None
        if self.split_on:
            branch = torch.where(will_split, 0, -1).to(torch.int32)
        bs = M.sample_bsdf(params, wo, frag.n, frag.geo_n, s3, glass_branch=branch, t=frag.t,
                           b=frag.b)
        # false interfaces override the BSDF by a straight-through null event
        # (a Volumetric boundary is one already: bs.passthrough)
        wi = torch.where(false_if[:, None], -wo, bs.wi)
        bsdf_weight = torch.where(false_if[:, None], 1.0, bs.weight)
        transmission = bs.transmission | false_if
        passthrough = bs.passthrough | false_if
        valid_bs = bs.valid | false_if
        if self.scatters:
            # a scatter vertex samples the phase function instead
            wi_hg = M.hg_sample(wo, g_med, s3[:, 1:3])
            ph_s = M.hg_phase(vm.dot(s.d, wi_hg), g_med)
            wi = torch.where(scatter[:, None], wi_hg, wi)
            bsdf_weight = torch.where(scatter[:, None], 1.0, bsdf_weight)
            passthrough = passthrough & ~scatter
            new_bxdf_pdf = torch.where(scatter, ph_s,
                                       torch.where(passthrough, s.bxdf_pdf, bs.pdf))
            new_singular = ~scatter & torch.where(passthrough, s.singular, bs.singular)
            new_from_volume = scatter | (passthrough & s.from_volume)
            new_reg_alpha = torch.where(scatter, 1.0,
                                        torch.where(passthrough, s.reg_alpha, bs.reg_alpha))
        else:
            new_bxdf_pdf = torch.where(passthrough, s.bxdf_pdf, bs.pdf)
            new_singular = torch.where(passthrough, s.singular, bs.singular)
            new_from_volume = s.from_volume & passthrough
            new_reg_alpha = torch.where(passthrough, s.reg_alpha, bs.reg_alpha)
        cont = cont & (valid_bs | scatter)
        thr_vertex = throughput  # both split children restart here
        throughput = throughput * bsdf_weight
        new_o = _offset_rows(frag.p, _side(wi, frag.geo_n))
        smp.increment_padding()

        if self.has_media:
            # entering pushes the prop onto the stack, exiting pops it;
            # only glass and Volumetric boundaries enclose a medium
            crossing = transmission & cont & ~scatter & is_medium_b
            new_medium = vol_mod.stack_update(s.medium, hit.prop, same_side, crossing)
        else:
            new_medium = s.medium
        new_mis_o = torch.where(passthrough[:, None], s.mis_o, new_o)
        new_mis_n = torch.where(passthrough[:, None], s.mis_n, frag.n)
        if self.scatters:
            new_o = torch.where(scatter[:, None], p_scatter, new_o)
            new_mis_o = torch.where(scatter[:, None], p_scatter, new_mis_o)
            new_mis_n = torch.where(scatter[:, None], s.d, new_mis_n)
        new_depth = torch.where(cont & ~scatter & ~passthrough, s.depth + 1, s.depth)
        new_vol_depth = torch.where(cont & (scatter | passthrough), s.vol_depth + 1, s.vol_depth)

        # ---- park the refract branch in the resume slot (ref vertex.zig Pool.new)
        split = s.split
        if self.split_on:
            split = self._park(s, params, wo, frag, hit, s3, bs, will_split, cont, thr_vertex,
                               same_side, sw, smp, new_nee_thr)

        return dataclasses.replace(
            s,
            o=torch.where(cont[:, None], new_o, s.o),
            d=torch.where(cont[:, None], wi, s.d),
            throughput=throughput,
            result=result,
            alive=cont,
            bxdf_pdf=new_bxdf_pdf,
            singular=new_singular,
            medium=new_medium,
            depth=new_depth,
            vol_depth=new_vol_depth,
            rays=rays,
            sobol=smp.arrays,
            vol_key=to_i32(hash_u32(u32(s.vol_key) ^ 0x27D4EB2F)),
            mis_o=torch.where(cont[:, None], new_mis_o, s.mis_o),
            mis_n=torch.where(cont[:, None], new_mis_n, s.mis_n),
            from_volume=new_from_volume,
            primary_chain=s.primary_chain & (new_singular | passthrough) & ~scatter,
            nee_thr=torch.where(passthrough, s.nee_thr, new_nee_thr),
            reg_alpha=new_reg_alpha,
            split=split,
        )

    @staticmethod
    def _capture_aovs(s, hit, frag, params, finite_hit, scatter) -> None:
        """Add the primary hit's sensor AOV values to the pixel planes in
        s.aov (zyg_tpu/render/integrator/ptmis.py:507-555): every sample
        passes depth 0 and volume depth 0 exactly once. The dispatch is
        unshuffled (pid is the lane), so the JAX package's indexed
        add/min/max by pid is an elementwise one here."""
        aov = s.aov
        m = (s.alive & (s.depth == 0) & (s.vol_depth == 0) & ~scatter & finite_hit)[:, None]
        if "albedo" in aov:
            aov["albedo"] += torch.where(m, params["color"], 0.0)
        if "depth" in aov:
            torch.minimum(aov["depth"], torch.where(m, hit.t[:, None], RAY_MAX_T),
                          out=aov["depth"])
        if "material_id" in aov:
            torch.maximum(aov["material_id"],
                          torch.where(m, frag.material.to(torch.float32)[:, None], -1.0),
                          out=aov["material_id"])
        if "geometric_normal" in aov:
            aov["geometric_normal"] += torch.where(m, frag.geo_n, 0.0)
        if "shading_normal" in aov:
            aov["shading_normal"] += torch.where(m, frag.n, 0.0)
        if "roughness" in aov:
            rough = fmath.sqrt(torch.clamp(params["alpha"], min=0.0))
            aov["roughness"] += torch.where(m, rough[:, None], 0.0)
        if "alpha" in aov:
            # coverage: 1 where the primary ray lands on geometry
            aov["alpha"] += m.to(torch.float32)

    def _park(self, s, params, wo, frag, hit, s3, bs, will_split, cont, thr_vertex, same_side,
              sw, smp, new_nee_thr) -> dict:
        """The resume slot after this bounce: lanes that split store the
        refract branch's restart state with split weight 1 - F; the
        continuing reflect branch takes weight F."""
        bs1 = M.sample_glass(params, wo, frag.n, frag.geo_n, s3,
                             torch.where(will_split, 1, -1).to(torch.int32))
        fres = bs.fresnel
        do_split = will_split & ((1.0 - fres) > 1e-6) & cont
        o1 = _offset_rows(frag.p, _side(bs1.wi, frag.geo_n))
        thr1 = thr_vertex * bs1.weight
        if self.has_media:
            medium1 = vol_mod.stack_update(s.medium, hit.prop, same_side,
                                           do_split & bs1.transmission)
        else:
            medium1 = s.medium
        sp = s.split
        dm = do_split[:, None]
        sw1 = sw[:, 0]
        return {
            "pending": do_split | sp["pending"],
            "w": torch.where(will_split, sw1 * fres, sw1),
            "w1": torch.where(do_split, sw1 * (1.0 - fres), sp["w1"]),
            "o": torch.where(dm, o1, sp["o"]),
            "d": torch.where(dm, bs1.wi, sp["d"]),
            "thr": torch.where(dm, thr1, sp["thr"]),
            "pdf": torch.where(do_split, bs1.pdf, sp["pdf"]),
            "singular": torch.where(do_split, bs1.singular, sp["singular"]),
            "medium": torch.where(dm, medium1, sp["medium"]),
            "depth": torch.where(do_split, s.depth + 1, sp["depth"]),
            "vol_depth": torch.where(do_split, s.vol_depth, sp["vol_depth"]),
            "mis_n": torch.where(dm, frag.n, sp["mis_n"]),
            "primary": torch.where(do_split, s.primary_chain & bs1.singular, sp["primary"]),
            "nee_thr": torch.where(do_split, new_nee_thr, sp["nee_thr"]),
            "reg_alpha": torch.where(do_split, bs1.reg_alpha, sp["reg_alpha"]),
            "vol_key": torch.where(do_split, to_i32(hash_u32(u32(s.vol_key) ^ 0x85EBCA6B)),
                                   sp["vol_key"]),
            "run_seed": torch.where(
                do_split, to_i32(hash_u32(u32(smp.arrays.run_seed) ^ 0x9E3779B9)),
                sp["run_seed"]),
        }
