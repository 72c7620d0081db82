"""The texture-node slice as a whole: examples/takes/hero.take (a Sky, a
600x600 ground Rectangle and the 491,520-triangle trefoil with an analytic
Checker albedo and a baked Mix(0.15, 0.7, Noise) roughness; PTMIS depth 5,
ACES) and a scene the test writes (an sRGB PNG colour map under Clamp/
Repeat addressing, a Triplanar colour map, an analytic Checker roughness,
a DetailNormal normal map, a clamped HDR emission map on a Dome, a Distant
sun, on a mesh, a Sphere, a Cube, a Disk and a Rectangle) against the JAX
package.

- Both loaded scenes' arrays equal through scene_arrays (materials with
  their texture ids, texels, offsets, sizes, address and texcoord columns,
  the procedural specs, the env alias table, the light CDF).
- build_fragment(need_tangents=True) on every analytic shape and the mesh
  against the JAX fragment: hit props exact, points within 1e-6
  relative, normals, tangents, bitangents and uv within 2e-5 (torch and
  XLA round atan2, acos, sin and cos an ulp apart); need_tangents=False
  leaves every other output bit for bit as it was.
- triplanar_uv and apply_normal_map on the JAX fragment's own values,
  within 1e-6.
- The texture glue's kernel-6 lane rows on hero (albedo and alpha from the
  analytic checker and the baked roughness, the shading normal) exact
  against the JAX glue, and one v2 bounce on 2,048 hero lanes and on the
  written scene against make_mesh_fused_body_v2(force_interpret=True)
  under test_torch_surface_v2.py's rules.
- Hero at 64x36, 8 spp, depth 5 against the JAX Driver through the golden
  gate (mean within 1.5 %, 4x4 RMSE within 6 % of the mean), rays within
  1e-3, iterations within 2. The JAX Driver on the CPU box-filters the
  checker by the pixel footprint, which the TPU dispatch and the port do
  not: measured rmse4 0.0061 of the mean, so no pin of the footprint.
- The CLI renders a small copy of the take; what stays outside the slice
  is refused by name.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_surface import _arrays, _jax_state, _port_state
from test_torch_surface_v2 import V2_TOLS, _compare_bounce

torch.set_num_threads(2)

TAKE = "examples/takes/hero.take"
SCENE = "examples/scenes/hero.scene"


@pytest.fixture(scope="module")
def jax_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file(SCENE)


@pytest.fixture(scope="module")
def port_scene():
    from zyg_tpu_torch.scene.loader import load_scene_file

    return load_scene_file(SCENE)


def _same_arrays(jscene, pscene):
    from zyg_tpu_torch.scene.loader import scene_arrays

    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return b


def test_hero_scene_matches_jax_arrays(jax_scene, port_scene):
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2

    b = _same_arrays(jax_scene, port_scene)
    assert {"textures.data", "textures.procedurals", "env.table", "meshes.node_rows"} <= set(b)
    # the sky, the checker's 128^2 fallback and the roughness graph's bake
    assert port_scene.textures.width.tolist() == [512, 128, 1024]
    assert [p[:2] for p in port_scene.textures.procedurals] == [(1, "checker")]
    hero = int(port_scene.prop_material[3])  # the dome, the sun, the ground, the knot
    assert (int(port_scene.materials.color_tex[hero]), int(port_scene.materials.roughness_tex[hero])
            ) == (1, 2)
    assert port_scene.mat_features == set() and structural_ok_mesh_v2(port_scene)


def _hero_lanes(n=2048):
    """_arrays' lane state with the rays aimed into the knot's box."""
    a = _arrays(n)
    tgt = np.random.default_rng(22).uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = tgt - a["o"]
    a["d"] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return a


def test_hero_glue_lane_rows_match_jax(jax_scene, port_scene):
    """The lane rows the texture glue hands kernel 6 on hero: the point-
    sampled checker albedo and the stochastic roughness texel's alpha
    exact, the shading normal within 1e-6, against the JAX glue
    (zyg_tpu/ops/shade.py:1562-1586); roughness varies across the knot."""
    from zyg_tpu.core.rng import hash2_u32, hash_u32, u32_to_float
    from zyg_tpu.render import materials as jmat
    from zyg_tpu.scene import shapes as jshapes
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    a = _hero_lanes()
    js = _jax_state(a)

    @jax.jit
    def glue(s):
        tmax = jnp.where(s.alive, jnp.float32(jshapes.RAY_MAX_T), 0.0)
        hit = jshapes.intersect_scene(jax_scene, s.o, s.d, jnp.float32(0.0), tmax, "reflection",
                                      primary=s.depth == 0)
        frag = jshapes.build_fragment(jax_scene, hit, s.o, s.d, need_tangents=True)
        kx = hash2_u32(s.vol_key ^ jnp.uint32(0xA511E9B3), s.depth.astype(jnp.uint32))
        ky = hash_u32(kx ^ jnp.uint32(0x85EBCA6B))
        tex_xi = jnp.stack([u32_to_float(kx), u32_to_float(ky)], -1)
        n = jmat.apply_normal_map(jax_scene.materials, jax_scene.textures, frag.material,
                                  frag.uv, frag.n, frag.t, frag.b, tex_xi=tex_xi)
        p = jmat.gather(jax_scene.materials, frag.material, None, jax_scene.textures, frag.uv,
                        features=jax_scene.mat_features, tex_xi=tex_xi)
        return p["albedo"], p["alpha"], n

    albedo, alpha, n = (np.asarray(x) for x in glue(js))
    body = surface_v2.make_mesh_fused_body_v2(port_scene, PtmisSettings(max_depth=5))
    st = body.inputs(_port_state(a))[0]
    np.testing.assert_array_equal(st["albedo"].numpy(), albedo)
    np.testing.assert_array_equal(st["alpha"].numpy(), alpha)
    # the mesh's interpolated shading normal rounds an ulp apart (the
    # fragment tests' tolerance); no hero material has a normal map
    np.testing.assert_allclose(st["n"].numpy(), n, rtol=0, atol=1e-6)
    # the knot's lanes: only the checker has these albedos
    on = st["finite"].numpy() & np.isin(albedo[:, 0], np.float32([0.62, 0.22]))
    assert on.sum() > 500
    assert len(np.unique(alpha[on])) > 200  # per-lane roughness across the surface
    assert (albedo[on, 0] == np.float32(0.62)).any() and (albedo[on, 0] == np.float32(0.22)).any()


def test_v2_body_on_hero_matches_jax(jax_scene, port_scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    a = _hero_lanes()
    body_ref = jshade.make_mesh_fused_body_v2(jax_scene, jptmis.PtmisSettings(max_depth=5),
                                              force_interpret=True)
    r1 = jax.jit(body_ref)(_jax_state(a))
    r2 = surface_v2.make_mesh_fused_body_v2(port_scene, PtmisSettings(max_depth=5))(_port_state(a))
    _compare_bounce(r1, r2)


# ---------------------------------------------------------------------------
# a scene with image files, a normal map and triplanar coordinates
# ---------------------------------------------------------------------------


def written_root() -> dict:
    """The scene JSON over albedo.png (sRGB) and sky.hdr beside it."""
    painted = {"Substitute": {
        "color": {"file": "albedo.png", "sampler": {"address": ["Clamp", "Repeat"]}},
        "roughness": 0.35,
        "normal": {"DetailNormal": {"base": [0.5, 0.5, 1.0], "detail": {"Mix": {
            "a": [0.5, 0.5, 1.0], "b": [0.85, 0.3, 0.8],
            "weight": {"Noise": {"levels": 2, "scale": [6, 6]}}}}}}}}
    tri = {"Substitute": {
        "color": {"file": "albedo.png", "sampler": {"texcoord": "Triplanar"}},
        "roughness": {"Checker": {"scale": 4, "colors": [[0.2] * 3, [0.8] * 3]}},
        "metallic": 0.3}}
    sky = {"Light": {"emittance": {"value": 1.5, "emission_map": {
        "file": "sky.hdr", "sampler": {"address": "Clamp"}}}}}
    return {
        "materials": [
            {"name": "painted", "rendering": painted},
            {"name": "tri", "rendering": tri},
            {"name": "ground", "rendering": {"Substitute": {"color": [0.5, 0.45, 0.4],
                                                            "roughness": 0.7}}},
            {"name": "sky", "rendering": sky},
            {"name": "sun", "rendering": {"Light": {"emittance": {"value": 40.0}}}},
        ],
        "entities": [
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
            {"type": "Light", "shape": {"type": "Distant"}, "materials": ["sun"],
             "transformation": {"rotation": [-60, 30, 0], "scale": [0.1, 0.1, 0.1]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["ground"],
             "transformation": {"position": [0, -1, 0], "rotation": [90, 0, 0],
                                "scale": [8, 8, 1]}},
            {"type": "Prop", "shape": {"file": "proc:trefoil-48x32"}, "materials": ["painted"],
             "transformation": {"scale": [0.4, 0.4, 0.4]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["tri"],
             "transformation": {"position": [1.6, -0.4, 0.5], "scale": [1.1, 1.1, 1.1]}},
            {"type": "Prop", "shape": {"type": "Cube"}, "materials": ["painted"],
             "transformation": {"position": [-1.7, -0.5, 0.3], "rotation": [0, 30, 0]}},
            {"type": "Prop", "shape": {"type": "Disk"}, "materials": ["tri"],
             "transformation": {"position": [0, 0.2, 1.8], "rotation": [10, 0, 0],
                                "scale": [1.2, 1.2, 1]}},
        ],
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(JAX scene, port scene, directory) of written_root() loaded from
    its files."""
    from zyg_tpu.io.rgbe import write_hdr
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.io.png import write_png
    from zyg_tpu_torch.scene.loader import load_scene_file

    d = tmp_path_factory.mktemp("written")
    rng = np.random.default_rng(17)
    write_png(str(d / "albedo.png"), (rng.random((16, 24, 3)) * 255).astype(np.uint8))
    write_hdr(str(d / "sky.hdr"), (rng.random((16, 32, 3)) * [4.0, 3.0, 2.0]).astype(np.float32))
    path = d / "written.scene"
    path.write_text(json.dumps(written_root()))
    return jload(str(path)), load_scene_file(str(path)), d


def test_written_scene_matches_jax_arrays(written):
    from zyg_tpu.core.spectrum import srgb_to_linear_np
    from zyg_tpu.io.png import read_png

    jscene, pscene, d = written
    b = _same_arrays(jscene, pscene)
    tex = pscene.textures
    # in load order: sky.hdr clamped, albedo.png under Clamp/Repeat, the
    # normal map's bake, albedo.png again under Triplanar, the checker's
    # fallback bake
    assert tex.width.tolist() == [32, 24, 1024, 24, 128]
    assert tex.address.tolist() == [3, 1, 0, 0, 0] and tex.texcoord.tolist() == [0, 0, 0, 1, 0]
    assert [p[:2] for p in tex.procedurals] == [(4, "checker")]
    assert pscene.mat_features == {"triplanar"} and "env.table" in b
    assert sorted(pscene.materials.normal_tex.tolist()) == [-1] * 5 + [2]
    # the colour map decoded from sRGB, the HDR map linear
    png = read_png(str(d / "albedo.png")).astype(np.float32) / 255.0
    off = int(tex.offset[1])
    np.testing.assert_array_equal(tex.data[off: off + 16 * 24, :3].numpy(),
                                  srgb_to_linear_np(png).reshape(-1, 3))


def _rays(n, seed, scene):
    """From a ring around the scene toward its props (and past them into
    the dome), every 8th into the sun's disc (the Distant prop 1)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([5 * np.cos(ang), rng.uniform(1.0, 2.5, n), 5 * np.sin(ang)], -1)
    d = rng.uniform([-2.5, -1.2, -1.5], [2.5, 1.0, 2.5], (n, 3)) - o
    rot = scene.prop_rot[1].numpy()
    disc = rng.uniform(-0.06, 0.06, (n, 2))
    sun = -rot[2] + disc[:, :1] * rot[0] + disc[:, 1:] * rot[1]
    d = np.where((np.arange(n) % 8 == 0)[:, None], sun, d)
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def fragments(written):
    """(JAX fragment, port fragment with tangents, port fragment without)
    of 4,096 closest hits in the written scene."""
    from zyg_tpu.scene import shapes as jshapes
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    jscene, pscene, _ = written
    o, d = _rays(4096, 5, pscene)
    tmax = np.full(4096, RAY_MAX_T, np.float32)

    @jax.jit
    def ref(o, d, tmax):
        hit = jshapes.intersect_scene(jscene, o, d, jnp.float32(0.0), tmax, "reflection")
        return jshapes.build_fragment(jscene, hit, o, d, need_tangents=True)

    t = torch.from_numpy
    hit = shapes.intersect_scene(pscene, isect.prop_table(pscene, "reflection"), t(o), t(d), 0.0,
                                 t(tmax))
    return (ref(o, d, tmax), shapes.build_fragment(pscene, hit, t(o), t(d), need_tangents=True),
            shapes.build_fragment(pscene, hit, t(o), t(d)))


def test_fragment_tangents_match_jax(written, fragments):
    from zyg_tpu_torch.scene.types import ShapeType

    pscene = written[1]
    jf, f, plain = fragments
    prop = f.prop.numpy()
    np.testing.assert_array_equal(np.asarray(jf.prop), prop)
    shape = pscene.prop_shape[np.maximum(prop, 0)].numpy()
    for st in (ShapeType.RECTANGLE, ShapeType.DISK, ShapeType.SPHERE, ShapeType.CUBE,
               ShapeType.DOME, ShapeType.DISTANT, ShapeType.TRIANGLE_MESH):
        assert ((shape == int(st)) & (prop >= 0)).sum() > 100, st.name
    np.testing.assert_allclose(f.p.numpy(), np.asarray(jf.p), rtol=1e-6, atol=1e-5)
    for k in ("n", "t", "b", "uv"):
        np.testing.assert_allclose(getattr(f, k).numpy(), np.asarray(getattr(jf, k)), rtol=0,
                                   atol=2e-5, err_msg=k)
    # a frame: unit tangents orthogonal to the normal on the finite shapes
    fin = (prop >= 0) & (shape != int(ShapeType.DOME)) & (shape != int(ShapeType.DISTANT))
    assert np.abs(np.einsum("ij,ij->i", f.t.numpy(), f.n.numpy())[fin]).max() < 1e-4
    np.testing.assert_allclose(np.linalg.norm(f.t.numpy()[fin], axis=1), 1.0, atol=1e-5)
    # without tangents every other output is as it was, bit for bit
    assert plain.t is None and plain.b is None
    for k in ("p", "geo_n", "n", "uv", "material"):
        assert torch.equal(getattr(plain, k), getattr(f, k)), k


def test_triplanar_uv_and_normal_map_match_jax(written, fragments):
    """Both functions on the JAX fragment's own values, with a jitter."""
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as tmat
    from zyg_tpu_torch.scene.shapes import Fragment

    jscene, pscene, _ = written
    jf = fragments[0]
    t = torch.from_numpy
    f = Fragment(**{k: t(np.array(getattr(jf, k))) for k in ("p", "geo_n", "n", "material",
                                                              "uv", "t", "b", "prop")})
    ref = np.asarray(jax.jit(lambda fr: jmat.triplanar_uv(jscene, fr))(jf))
    alt = tmat.triplanar_uv(pscene, f)
    np.testing.assert_allclose(alt.numpy(), ref, rtol=0, atol=1e-6)
    xi = np.random.default_rng(6).random((4096, 2)).astype(np.float32)
    for tex_xi in (None, xi):
        nref = jax.jit(lambda fr, a, x: jmat.apply_normal_map(
            jscene.materials, jscene.textures, fr.material, fr.uv, fr.n, fr.t, fr.b, tex_xi=x,
            uv_alt=a))(jf, ref, tex_xi)
        got = tmat.apply_normal_map(pscene.materials, pscene.textures, f.material, f.uv, f.n,
                                    f.t, f.b, tex_xi=None if tex_xi is None else t(tex_xi),
                                    uv_alt=t(ref.copy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(nref), rtol=0, atol=1e-6)
        mapped = pscene.materials.normal_tex[torch.clamp(f.material, min=0).long()] >= 0
        assert int(mapped.sum()) > 500 and not torch.equal(got[mapped], f.n[mapped])
        assert torch.equal(got[~mapped], f.n[~mapped])


def test_v2_body_on_written_scene_matches_jax(written):
    """The glue with the normal map, the triplanar uv, the analytic
    roughness and the clamped HDR dome, around kernel 6's plain version:
    test_torch_surface_v2.py's rules, but d within 1e-4 (the plain
    kernel's own tolerance against the Pallas body in that file): the
    normal-mapped normal, normalised from three fused products, rounds an
    ulp apart, and the GGX sample carries that into d (measured 6.7e-5)."""
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator import ptmis as jptmis
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    jscene, pscene, _ = written
    a = _arrays(2048)
    a["o"], a["d"] = _rays(2048, 7, pscene)
    body_ref = jshade.make_mesh_fused_body_v2(jscene, jptmis.PtmisSettings(max_depth=4),
                                              force_interpret=True)
    r1 = jax.jit(body_ref)(_jax_state(a))
    body = surface_v2.make_mesh_fused_body_v2(pscene, PtmisSettings(max_depth=4))
    assert body.normal_mapped
    r2 = body(_port_state(a))
    _compare_bounce(r1, r2, tuple((k, 1e-4 if k == "d" else tol) for k, tol in V2_TOLS))


# ---------------------------------------------------------------------------
# hero's image, the CLI, the refusals
# ---------------------------------------------------------------------------


def _take(module, res, spp, depth):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    take.integrator.max_depth_surface = depth
    return take


def test_hero_render_matches_jax_at_golden_gate(jax_scene, port_scene):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    jd = JDriver(take=_take(jtake, (64, 36), 8, 5), scene=jax_scene)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (64, 36), 8, 5), port_scene, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (36, 64, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    assert abs(d.last_iterations - jd.last_iterations) <= 2


def test_cli_renders_hero(tmp_path):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [32, 18]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    take["integrator"]["surface"]["PTMIS"]["depth"]["surface"] = 2
    path = tmp_path / "hero_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3) and img.mean() > 10


def _substitute_root(body: dict, kind="Substitute") -> dict:
    return {
        "materials": [{"name": "m", "rendering": {kind: body}},
                      {"name": "l", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
        "entities": [{"type": "Prop", "shape": {"type": "Cube"}, "materials": ["m"]},
                     {"type": "Light", "shape": {"type": "Dome"}, "materials": ["l"]}],
    }


@pytest.mark.parametrize("body, kind, match", [
    ({"color": {"file": "albedo.jpg"}}, "Substitute", "image format '.jpg'"),
    ({"roughness": {"file": "r.tga"}}, "Substitute", "image format '.tga'"),
    ({"color": {"id": 3}}, "Substitute", "C-API image references"),
    ({"mask": {"file": "m.png"}}, "Substitute", r"keys \['mask'\]"),
    ({"color": {"temperature": 3000}}, "Substitute", "temperature"),
    ({"roughness": [0.2, 0.3]}, "Substitute", "roughness"),
    ({"attenuation_distance": 1.0, "emittance": {"value": 1.0, "emission_map": {
        "Checker": {}}}}, "Volumetric", "emission map on a Volumetric"),
], ids=["jpg", "tga", "capi_id", "mask", "temperature", "roughness_vec", "volumetric_map"])
def test_loader_refuses_by_name(body, kind, match):
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match=match):
        load_scene_dict(_substitute_root(body, kind))


def test_triplanar_off_the_textured_bounce_is_refused(tmp_path):
    """Triplanar coordinates beside glass would take the general body,
    which refuses them by name (as it refuses image textures)."""
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.io.png import write_png
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.types import UnsupportedScene

    write_png(str(tmp_path / "a.png"), np.full((4, 4, 3), 128, np.uint8))
    root = _substitute_root({"color": {"file": "a.png", "sampler": {"texcoord": "ObjectPos"}}})
    root["materials"].append({"name": "g", "rendering": {"Glass": {"ior": 1.5}}})
    root["entities"].append({"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["g"]})
    (tmp_path / "s.scene").write_text(json.dumps(root))
    scene = load_scene_file(str(tmp_path / "s.scene"))
    assert scene.mat_features == {"triplanar", "glass", "media"}
    with pytest.raises(UnsupportedScene, match=r"material features \['triplanar'\]"):
        Driver(_take(ttake, (8, 8), 1, 2), scene, device="cpu")
