"""The material slice as a whole: examples/takes/material_test.take (five
analytic spheres, among them smooth glass with attenuation_distance 0.5,
over a Rectangle floor under a Rectangle lamp and a constant Dome; PTMIS
with BSDF splitting) through the port's general body
(zyg_tpu_torch/render/integrator/ptmis_general.py) against the JAX
package.

- Loader: the scene's arrays and mat_features equal the JAX loader's;
  the take's bsdf_split and depth.volume parse as the JAX take's; each
  refused feature raises UnsupportedScene naming it, at load or at
  Driver construction.
- One general bounce (after resume_split, as the JAX loop steps it) on
  4,096 material_test lanes taken after three real bounces of the port's
  body (lanes inside the glass with a stack entry, lanes holding a parked
  split, dead lanes about to resume one), against the JAX
  `_make_body(scene, settings)`. Exact: alive, depth, vol_depth, medium,
  singular, primary_chain, the split slot's integer and bool fields,
  rays, the Sobol' run seed and vol_key. Within tolerance, as relative
  error |a - b| / (|a| + 1e-3) on live lanes: o, mis_o 1e-5; d 2e-4
  (measured 1.0e-4: a refraction out of the glass near total internal
  reflection, where cos_t = sqrt(1 - sin_t^2) amplifies an ulp, 3.3e-7
  absolute on a component of 1.1e-4); throughput 5e-3; bxdf_pdf 2e-2 except the mirror sphere's near-delta
  GGX lanes (sampled lobe alpha < 1e-3, 15 of 1,239 live lanes: there
  the pdf, ~1e5, moves by up to 5.4x with an ulp of the half vector's
  cosine, so it is held within a factor 10); mis_n 2e-4 (measured 1.1e-4: a sphere normal is
  normalize(p - pos) with p = o + t d, and the port's isect, the Pallas
  kernel's formula, and the JAX package's XLA sphere test round t an ulp
  apart; 3e-7 absolute); the parked branch's o, d, thr, pdf and mis_n
  1e-5; the split weights F and 1 - F 5e-5 (measured 1.1e-5: the
  fresnel term of a grazing sphere hit inherits the sphere normal's
  ulp); radiance (pending NEE included) 5e-3.
- The image of tests/golden_configs.py's material_spheres (64x48, 12 spp,
  depth 6) from the port's Driver against tests/goldens/material_spheres.exr
  with tests/test_goldens.py's gate: mean within 1.5 %, 4x4 RMSE within
  6 % and raw RMSE within 35 % of the mean.
- Split on and off agree in the mean within 2 %, smooth and rough glass
  (tests/test_bsdf_split.py's furnace, a Rectangle floor for its Plane).
- The drain carries the split slot: _DRAIN_MIN lowered against the
  undrained loop gives equal rays and per-pixel counts and radiance
  within rtol 1e-5 / atol 1e-6; a flush that ignores the slot miscounts.
- The CLI renders material_test.take at a tiny size on the CPU.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/material_test.take"
SCENE = "examples/scenes/material_test.scene"
N_LANES = 4096
PRE_BOUNCES = 3


@pytest.fixture(scope="module")
def jax_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file(SCENE)


@pytest.fixture(scope="module")
def port_scene():
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(SCENE)


def test_material_scene_matches_jax_arrays(jax_scene, port_scene):
    from zyg_tpu_torch.ops import shade, surface, surface_v2
    from zyg_tpu_torch.render.integrator import ptmis
    from zyg_tpu_torch.render.integrator.ptmis_general import GeneralBody
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    a, b = scene_arrays(jax_scene), scene_arrays(port_scene)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port_scene.mat_features == {"glass", "media"} == set(jax_scene.mat_features)
    assert not port_scene.volume_props and not jax_scene.volume_props
    shapes = port_scene.prop_shape[port_scene.lights.prop.long()].tolist()
    assert shapes == [int(ShapeType.RECTANGLE), int(ShapeType.DOME)]
    assert port_scene.light_tree is not None and port_scene.light_tree.num_finite == 1
    # the kernel bounces refuse glass; the dispatch returns the general body
    assert not (shade.structural_ok(port_scene) or surface.structural_ok_mesh(port_scene)
                or surface_v2.structural_ok_mesh_v2(port_scene))
    body = ptmis._make_body(port_scene, ptmis.PtmisSettings(bsdf_split=True))
    assert isinstance(body, GeneralBody) and body.split_on and body.has_media


def test_take_parses_split_and_volume_depth():
    from zyg_tpu.io import take as jtake
    from zyg_tpu_torch.io import take as ttake

    for root in ({}, {"bsdf_split": False, "depth": {"surface": 7, "volume": 9}},
                 {"depth": 5, "bsdf_split": True}):
        body = {"camera": {"Perspective": {}}, "integrator": {"surface": {"PTMIS": root}}}
        a, b = jtake.load_take_dict(body), ttake.load_take_dict(body)
        for k in ("max_depth_surface", "max_depth_volume", "bsdf_split"):
            assert getattr(a.integrator, k) == getattr(b.integrator, k), (root, k)
    t = ttake.load_take_file(TAKE)
    assert t.integrator.bsdf_split and t.integrator.max_depth_volume == 256
    with pytest.raises(ttake.UnsupportedTake, match="regularize_roughness"):
        ttake.load_take_dict({"camera": {"Perspective": {}}, "integrator": {"surface": {
            "PTMIS": {"regularize_roughness": 0.5}}}})
    with pytest.raises(ttake.UnsupportedTake, match="AOVs"):
        ttake.load_take_dict({"camera": {"Perspective": {}}, "sensor": {"aov": ["albedo"]}})


def _glass_root(glass=None, extra_entities=(), extra_materials=()):
    return {
        "materials": [
            {"name": "glass", "rendering": {"Glass": glass or {"ior": 1.5}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 2.0}}}},
            *extra_materials,
        ],
        "entities": [
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["glass"]},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["lamp"]},
            *extra_entities,
        ],
    }


@pytest.mark.parametrize("root, match", [
    (_glass_root({"ior": 1.5, "abbe": 40.0}), "dispersive glass"),
    (_glass_root(extra_materials=[{"name": "v", "rendering": {"Volumetric": {
        "attenuation_distance": 1.0}}}],
                 extra_entities=[{"type": "Prop", "shape": {"file": "proc:sphere"},
                                  "materials": ["v"]}]),
     "Volumetric"),
    # the Hair material loads (tests/test_torch_hair.py); a roughness
    # texture on it is refused by name
    (_glass_root(extra_materials=[{"name": "h", "rendering": {"Hair": {
        "roughness": {"file": "r.png"}}}}],
                 extra_entities=[{"type": "Prop", "shape": {"type": "Cube"}, "materials": ["h"]}]),
     "Hair"),
    (_glass_root({"ior": 1.5, "normal": {"file": "n.png"}}), "normal"),
    (_glass_root({"ior": 1.5, "mask": {"file": "m.png"}}), "mask"),
    (_glass_root(extra_materials=[{"name": "c", "rendering": {"Substitute": {
        "coating": {"thickness": 0.1}}}}],
        extra_entities=[{"type": "Prop", "shape": {"type": "Cube"}, "materials": ["c"]}]),
     "coating"),
    (_glass_root(extra_materials=[{"name": "f", "rendering": {"Substitute": {
        "flakes": {"coverage": 0.5}}}}],
        extra_entities=[{"type": "Prop", "shape": {"type": "Cube"}, "materials": ["f"]}]),
     "flakes"),
])
def test_loader_refuses_by_name(root, match):
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match=match):
        load_scene_dict(root)


def _take(res=(8, 8), spp=1):
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera

    take = Take()
    take.num_samples_per_pixel = spp
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    cam = PerspectiveCamera(resolution=res, fov=np.deg2rad(45.0))
    cam.position = np.array([0, 0.3, -5.0], np.float32)
    take.cameras = [cam]
    return take


def _refused_at_driver(case):
    """Scenes the loader accepts and the general body refuses."""
    from zyg_tpu_torch.scene.loader import (MaterialDesc, PropDesc, SceneBuilder,
                                            Transformation, load_scene_dict)
    from zyg_tpu_torch.scene.types import MaterialKind, ShapeType

    if case == "distant":
        return load_scene_dict(_glass_root(extra_materials=[
            {"name": "sun", "rendering": {"Light": {"emittance": {"value": 5.0}}}}],
            extra_entities=[{"type": "Light", "shape": {"type": "Distant"},
                             "materials": ["sun"]}]))
    b = SceneBuilder()
    glass = b.add_material(MaterialDesc(kind=int(MaterialKind.GLASS), roughness=0.0,
                                        color=np.ones(3, np.float32), ior=1.5))
    tex = b.add_texture_image(np.full((4, 4, 3), 0.5, np.float32))
    b.add_prop(PropDesc(shape=int(ShapeType.SPHERE), trafo=Transformation(), material=glass))
    if case == "textures":
        wall = b.add_material(MaterialDesc(color_tex=tex))
        b.add_prop(PropDesc(shape=int(ShapeType.RECTANGLE), trafo=Transformation(), material=wall))
        sky = b.add_material(MaterialDesc(kind=int(MaterialKind.LIGHT), emission=np.ones(3, np.float32)))
    else:  # an env-mapped dome
        sky = b.add_material(MaterialDesc(kind=int(MaterialKind.LIGHT),
                                          emission=np.ones(3, np.float32), emission_tex=tex))
    b.add_prop(PropDesc(shape=int(ShapeType.DOME), trafo=Transformation(), material=sky,
                        visible_shadow=False, is_light=True))
    return b.build()


@pytest.mark.parametrize("case, match", [("textures", "image textures"),
                                         ("env", "env-mapped Dome"),
                                         ("distant", "Distant lights")])
def test_driver_refuses_general_body_features(case, match):
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match=match):
        Driver(_take(), _refused_at_driver(case), device="cpu")


def test_hand_off_refuses_jax_features():
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import UnsupportedScene

    dispersive = jload(_glass_root({"ior": 1.5, "abbe": 40.0}))
    assert "dispersion" in dispersive.mat_features
    with pytest.raises(UnsupportedScene, match="dispersion"):
        scene_arrays(dispersive)


# ---------------------------------------------------------------------------
# one general bounce against the JAX body
# ---------------------------------------------------------------------------


def _jax_state(s):
    """The port's PathState as the JAX package's."""
    from zyg_tpu.core.sobol import SobolArrays
    from zyg_tpu.render.integrator import ptmis as jp

    def j(x):
        return jnp.asarray(x.numpy())

    def u(x):
        return jnp.asarray(x.numpy().view(np.uint32))

    n = s.o.shape[0]
    split = {k: (u(v) if k in ("vol_key", "run_seed") else j(v)) for k, v in s.split.items()}
    split["wavelength"] = jnp.zeros(n, jnp.float32)
    return jp.PathState(
        o=j(s.o), d=j(s.d), throughput=j(s.throughput),
        result=jp.IValue(j(s.result.emission), j(s.result.direct), j(s.result.indirect)),
        alive=j(s.alive), bxdf_pdf=j(s.bxdf_pdf), singular=j(s.singular), medium=j(s.medium),
        depth=j(s.depth), vol_depth=j(s.vol_depth), rays=jnp.int32(int(s.rays)),
        sobol=SobolArrays(u(s.sobol.sample), u(s.sobol.start_seed), u(s.sobol.run_seed),
                          j(s.sobol.buffer)),
        vol_key=u(s.vol_key), mis_o=j(s.mis_o), mis_n=j(s.mis_n), from_volume=j(s.from_volume),
        primary_chain=j(s.primary_chain), time=jnp.zeros(n, jnp.float32), nee_thr=j(s.nee_thr),
        reg_alpha=j(s.reg_alpha), aov={}, wavelength=jnp.zeros(n, jnp.float32),
        pid=jnp.asarray(s.pid.numpy().astype(np.uint32)), split=split,
    )


def _exact(a, b, name):
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _rel(a, b, mask, tol, name):
    a = np.asarray(a, np.float64)[mask]
    b = b.numpy().astype(np.float64)[mask]
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert rel.max(initial=0.0) < tol, (name, rel.max())


def test_general_bounce_matches_jax(jax_scene, port_scene):
    from zyg_tpu.render.integrator import ptmis as jp
    from zyg_tpu_torch.render.integrator import ptmis as tp

    import chip_smoke

    s = chip_smoke.material_state(N_LANES, PRE_BOUNCES, seed=7, max_depth=6)
    js = _jax_state(s)
    jbody = jp._make_body(jax_scene, jp.PtmisSettings(max_depth=6, bsdf_split=True))
    step = jax.jit(lambda s: jbody(jp.resume_split(s)))
    # the lane classes the test means to cover
    assert int((s.medium[:, 0] >= 0).sum()) > 300  # inside the glass
    assert int((s.alive & s.split["pending"]).sum()) > 300  # alive with a parked branch
    assert int((~s.alive & s.split["pending"]).sum()) > 100  # about to resume one
    # resume_split alone
    r0 = jp.resume_split(js)
    p0 = tp.resume_split(s)
    for name in ("alive", "depth", "vol_depth", "medium", "singular", "primary_chain", "o", "d",
                 "throughput", "bxdf_pdf", "mis_o", "mis_n"):
        _exact(getattr(r0, name), getattr(p0, name), name)
    _exact(r0.sobol.run_seed, p0.sobol.run_seed, "run_seed")
    # one bounce
    r1 = step(js)
    body = tp._make_body(port_scene, tp.PtmisSettings(max_depth=6, bsdf_split=True))
    r2 = body(p0)
    for name in ("alive", "depth", "vol_depth", "medium", "singular", "primary_chain",
                 "vol_key"):
        _exact(getattr(r1, name), getattr(r2, name), name)
    _exact(r1.sobol.run_seed, r2.sobol.run_seed, "run_seed")
    _exact(r1.sobol.sample, r2.sobol.sample, "sample")
    assert int(r1.rays) == int(r2.rays)
    for k in ("pending", "depth", "vol_depth", "medium", "singular", "primary", "vol_key",
              "run_seed"):
        _exact(r1.split[k], r2.split[k], f"split.{k}")
    live = np.asarray(r1.alive)
    for name, tol in (("o", 1e-5), ("mis_o", 1e-5), ("d", 2e-4), ("throughput", 5e-3),
                      ("mis_n", 2e-4), ("reg_alpha", 1e-5)):
        _rel(getattr(r1, name), getattr(r2, name), live, tol, name)
    near_delta = live & (np.asarray(r1.reg_alpha) > 0.0) & (np.asarray(r1.reg_alpha) < 1e-3)
    _rel(r1.bxdf_pdf, r2.bxdf_pdf, live & ~near_delta, 2e-2, "bxdf_pdf")
    ratio = r2.bxdf_pdf.numpy()[near_delta] / np.asarray(r1.bxdf_pdf)[near_delta]
    assert near_delta.sum() < 0.05 * live.sum() and ((ratio > 0.1) & (ratio < 10.0)).all()
    pend = np.asarray(r1.split["pending"])
    for k in ("o", "d", "thr", "pdf", "mis_n"):
        _rel(r1.split[k], r2.split[k], pend, 1e-5, f"split.{k}")
    _rel(r1.split["w1"], r2.split["w1"], pend, 5e-5, "split.w1")
    _rel(r1.split["w"], r2.split["w"], np.ones_like(pend), 5e-5, "split.w")
    for c in ("emission", "direct", "indirect"):
        _rel(getattr(r1.result, c), getattr(r2.result, c), np.ones_like(live), 5e-3, c)
    # splits happened in this bounce and lanes crossed into the glass
    assert int((r2.split["pending"] & ~p0.split["pending"]).sum()) > 20  # branches parked now
    assert int(((r2.medium[:, 0] >= 0) != (p0.medium[:, 0] >= 0)).sum()) > 20


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def _material_driver(res, spp, depth, split=True):
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    take.integrator.max_depth_surface = depth
    take.integrator.bsdf_split = split
    return Driver(take, load_scene_file(take.scene_filename), device="cpu")


def test_material_spheres_matches_golden():
    import golden_configs as gc
    from zyg_tpu.tools import it as it_mod

    img = _material_driver((64, 48), 12, 6).render_frame()
    ref = it_mod.load_image(gc.golden_path("material_spheres"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = it_mod.op_downsample(ref, 4) - it_mod.op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert float(np.sqrt(np.mean((img - ref) ** 2))) / scale < 0.35


def _furnace(rough):
    """tests/test_bsdf_split.py's glass_scene with a Rectangle floor."""
    from zyg_tpu_torch.scene.loader import load_scene_dict

    gl = {"ior": 1.5}
    if rough:
        gl["roughness"] = 0.35
    return load_scene_dict({
        "materials": [
            {"name": "glass", "rendering": {"Glass": gl}},
            {"name": "diff", "rendering": {"Substitute": {"color": [0.6, 0.5, 0.4],
                                                          "roughness": 0.8}}},
            {"name": "env", "rendering": {"Light": {"emittance": {"value": 1.0}}}},
        ],
        "entities": [
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["glass"],
             "transformation": {"scale": [0.9, 0.9, 0.9]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["diff"],
             "transformation": {"position": [0, -1.0, 0], "rotation": [90, 0, 0],
                                "scale": [40, 40, 1]}},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["env"],
             "visibility": {"in_shadow": False}},
        ],
    })


def _furnace_take(split, spp):
    take = _take((32, 24), spp)
    take.integrator.max_depth_surface = 12
    take.integrator.bsdf_split = split
    return take


@pytest.mark.parametrize("rough", [False, True])
def test_split_on_off_agree_in_the_mean(rough):
    from zyg_tpu_torch.render.driver import Driver

    scene = _furnace(rough)
    off = Driver(_furnace_take(False, 48), scene, device="cpu").render_frame()
    on_d = Driver(_furnace_take(True, 48), scene, device="cpu")
    on = on_d.render_frame()
    m_off, m_on = float(off.mean()), float(on.mean())
    assert abs(m_on - m_off) / m_off < 0.02, (m_off, m_on)
    assert on_d.settings.bsdf_split


def _drain_run(scene, monkeypatch, drain_min):
    from zyg_tpu_torch.render.integrator import ptmis

    monkeypatch.setattr(ptmis, "_DRAIN_MIN", drain_min)
    take = _furnace_take(True, 8)
    cam = take.cameras[0]
    w, h = cam.resolution
    st = ptmis.PtmisSettings(max_depth=12, bsdf_split=True)
    acc, rays, _, counts, _ = ptmis.integrate_persistent(
        scene, cam.arrays("cpu"), torch.arange(w * h, dtype=torch.int64), 0, 8, 8, st,
        frame_width=w, oversample_slack=4)
    return acc.numpy().copy(), int(rays), counts.numpy().copy()


def test_drain_carries_the_split_slot(monkeypatch):
    """tests/test_bsdf_split.py::test_drain_matches_full_width_with_glass on
    the port: 768 lanes, drain stages 192 / 48 / 12 against none."""
    from zyg_tpu_torch.render.integrator import ptmis

    scene = _furnace(False)
    acc0, rays0, c0 = _drain_run(scene, monkeypatch, 1 << 30)
    acc1, rays1, c1 = _drain_run(scene, monkeypatch, 12)
    assert rays1 == rays0
    np.testing.assert_array_equal(c1, c0)
    np.testing.assert_allclose(acc1, acc0, rtol=1e-5, atol=1e-6)
    # a flush that finishes a lane whose branch is still parked counts
    # that sample twice
    monkeypatch.setattr(ptmis, "_flush_unfinished", lambda s: s.alive)
    _, _, c2 = _drain_run(scene, monkeypatch, 12)
    assert c2.sum() > c0.sum()


def test_cli_renders_material_take(tmp_path):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(TAKE) as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [24, 16]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "small.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu", "-s"]) == 0
    img = read_png(str(out))
    assert img.shape == (16, 24, 3) and img.mean() > 10
