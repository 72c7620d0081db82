"""Canopy env lights and IES profiles against the JAX package, on scenes
the test writes: a uniform Canopy beside a Rectangle lamp with an IES
profile, and a Canopy with an emission map written as HDR beside the same
lamp, over a ground and a Sphere.

- Both scenes' arrays equal through scene_arrays (the canopy's env alias
  table and its canopy flag, materials.ies, the features, the light CDF
  and tree); build_env_sampler's canopy tables equal on a seeded image.
- The env sampler's sample and pdf per lane on canopy entries: uv, wi
  and pdf within 1e-4, 1e-4 and rtol 2e-2 (torch and XLA round acos,
  sin and cos an ulp apart; PR 3's dome tolerances); sample_light,
  light_radiance (the IES factor and the canopy's disk uv) and
  light_hit_pdf per lane over the hand-off's tables, within the same
  tolerances; the canopy fragment (normal, tangent, bitangent, uv).
- ies_profile_bins byte-equal on LM-63 texts (a tilt block, a Type B file
  and a malformed one refused by both) and eval_ies per lane within 3e-5
  (the acos ulp).
- The mapped canopy + IES scene at 32x32x8 against the JAX Driver at the
  golden gate (mean within 1.5 %, 4x4 RMSE within 6 % of the mean).
- Dispatch parity: the port picks kernel 3, 5 or 6 exactly where the JAX
  package's gates (structural_ok, structural_ok_mesh,
  structural_ok_mesh_v2) do, on portal, canopy and IES scenes.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

# tests/test_ies.py's narrow beam, with a tilt block, as Type B, and cut short
IES_TEXT = """IESNA:LM-63-2002
[TEST] narrow beam
TILT=NONE
1 1000.0 1 5 1 1 1 0.1 0.1 0.1
1.0 1.0 0.0
0 22.5 45 90 180
0
1000 800 50 0 0
"""
IES_TILT = IES_TEXT.replace("TILT=NONE", "TILT=INCLUDE\n1 3\n0 45\n90\n1.0 1.0\n0.9")
IES_TWO_PLANES = """IESNA:LM-63-1995
TILT=NONE
1 1200 1.5 4 2 1 1 0.2 0.2 0
1 1 40
0 30 75 120
0 90
900 600 100 10
700 400 120 0
"""
IES_TYPE_B = IES_TEXT.replace("1 1000.0 1 5 1 1 1", "1 1000.0 1 5 1 2 1")
IES_SHORT = "IESNA:LM-63-2002\nTILT=NONE\n1 1000.0 1 5\n"


def written_root(mapped: bool) -> dict:
    canopy = {"value": 1.2}
    if mapped:
        canopy = {"value": 1.0, "emission_map": {"file": "canopy.hdr"}}
    return {
        "materials": [
            {"name": "sky", "rendering": {"Light": {"emittance": canopy}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {
                "value": 6.0, "spectrum": [1.0, 0.9, 0.7], "profile": {"file": "spot.ies"}}}}},
            {"name": "ground", "rendering": {"Substitute": {"color": [0.5, 0.45, 0.4],
                                                            "roughness": 0.7}}},
            {"name": "red", "rendering": {"Substitute": {"color": [0.7, 0.2, 0.15],
                                                         "roughness": 0.3}}},
        ],
        "entities": [
            {"type": "Light", "shape": {"type": "Canopy"}, "materials": ["sky"],
             "transformation": {"rotation": [80, 25, 0]}},
            {"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["lamp"],
             "transformation": {"position": [0.3, 2.2, 0.2], "rotation": [-90, 0, 0],
                                "scale": [0.8, 0.8, 1]}},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["ground"],
             "transformation": {"rotation": [90, 0, 0], "scale": [6, 6, 1]}},
            {"type": "Prop", "shape": {"type": "Sphere"}, "materials": ["red"],
             "transformation": {"position": [-0.3, 0.5, 0.3]}},
        ],
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{"uniform"/"mapped": (JAX scene, port scene, port scene from the
    JAX tables)} of written_root loaded from its files."""
    from zyg_tpu.io.rgbe import write_hdr
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file, scene_arrays, scene_from_jax_arrays

    d = tmp_path_factory.mktemp("canopy")
    rng = np.random.default_rng(41)
    img = rng.random((32, 32, 3)) * [3.0, 2.5, 2.0] + 0.2
    img[4:10, 18:26] *= 12.0  # a bright patch off the disk's center
    write_hdr(str(d / "canopy.hdr"), img.astype(np.float32))
    (d / "spot.ies").write_text(IES_TEXT)
    out = {}
    for kind in ("uniform", "mapped"):
        path = d / f"{kind}.scene"
        path.write_text(json.dumps(written_root(kind == "mapped")))
        js = jload(str(path))
        out[kind] = (js, load_scene_file(str(path)), scene_from_jax_arrays(scene_arrays(js)))
    return out


def test_written_scenes_match_jax_arrays(written):
    from zyg_tpu_torch.io.ies import ies_profile_bins
    from zyg_tpu_torch.scene import light_sampling as ls
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import ShapeType

    for kind, (js, ps, _) in written.items():
        a, b = scene_arrays(js), scene_arrays(ps)
        assert sorted(a) == sorted(b), kind
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kind} {k}")
        assert ps.mat_features == {"ies"}
        lamp = int(ps.prop_material[1])
        np.testing.assert_array_equal(ps.materials.ies[lamp].numpy(), ies_profile_bins(IES_TEXT))
        assert (ps.materials.ies[int(ps.prop_material[2])] == 1.0).all()
        assert ls.light_shapes(ps) == {int(ShapeType.CANOPY), int(ShapeType.RECTANGLE)}
        assert {str(k) for k in ls.light_shapes(ps)} == set(js.light_shapes)
        assert ps.light_tree is not None and ps.light_tree.num_finite == 1
    assert written["uniform"][1].env is None
    env = written["mapped"][1].env
    assert env.canopy == (True,) and b["env.canopy"].tolist() == [True]


def test_canopy_env_tables_and_sampling_match_jax():
    """A canopy and a dome entry on seeded images: the alias tables equal,
    and sample / pdf per lane on both entries under seeded rotations."""
    from zyg_tpu.scene import env_sampling as je
    from zyg_tpu_torch.scene import env_sampling as te
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    rng = np.random.default_rng(5)
    entries = [((rng.random((24, 48, 4)) ** 2 * 5).astype(np.float32), True, 0),
               ((rng.random((12, 24, 4)) * 2).astype(np.float32), False, 2)]
    jenv, tenv = je.build_env_sampler(entries), te.build_env_sampler(entries)
    assert tenv.canopy == jenv.canopy == (True, False)
    for k in ("table", "light"):
        np.testing.assert_array_equal(getattr(tenv, k).numpy(), np.asarray(getattr(jenv, k)))
    n = 20000
    xi = rng.random((n, 2)).astype(np.float32)
    ent = rng.integers(0, 2, n).astype(np.int32)
    rots = np.stack([rot(a) for a in rng.uniform(-180, 180, (3, 3))])[rng.integers(0, 3, n)]
    wi_j, pdf_j, uv_j = (np.asarray(x) for x in jax.jit(je.sample)(jenv, ent, rots, xi))
    t = torch.from_numpy
    wi, pdf, uv = te.sample(tenv, t(ent), t(rots), t(xi))
    np.testing.assert_allclose(uv.numpy(), uv_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(wi.numpy(), wi_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pdf.numpy(), pdf_j, rtol=2e-2, atol=0)
    # the pdf of sampled and of random directions, by light index
    li = np.where(ent == 0, 0, 2).astype(np.int32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = np.concatenate([wi_j, d / np.linalg.norm(d, axis=1, keepdims=True)])
    li, rots = np.concatenate([li, li]), np.concatenate([rots, rots])
    want = np.asarray(jax.jit(je.pdf)(jenv, li, rots, d))
    got = te.pdf(tenv, t(li), t(rots), t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)


def _lanes(scene, n, seed):
    """Shading points over the ground and the sphere with upward normals,
    light uniforms, and directions (a third straight up into the canopy,
    a third toward the lamp)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform([-2.0, 0.01, -2.0], [2.0, 1.2, 2.0], (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)) + [0.0, 2.5, 0.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    xi = rng.random((n, 2)).astype(np.float32)
    lamp = scene.prop_pos[1].numpy() + rng.uniform(-0.35, 0.35, (n, 3)) * [1, 0, 1]
    d = rng.normal(size=(n, 3)) + [0.0, 1.0, 0.0]
    d = np.where((np.arange(n) % 3 == 1)[:, None], lamp - p, d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return p, nrm, xi, d


@pytest.mark.parametrize("kind", ["uniform", "mapped"])
def test_light_sampling_matches_jax(written, kind):
    """sample_light, light_radiance and light_hit_pdf per lane on both
    lights (the canopy and the IES lamp) over the JAX tables."""
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as ls

    js, _, hs = written[kind]
    n = 6000
    p, nrm, xi, d = _lanes(hs, n, 7)
    li = (np.arange(n) % 2).astype(np.int32)

    @jax.jit
    def ref(li, p, nrm, xi, d, prop):
        s = jls.sample_light(js, li, p, nrm, xi)
        rad = jls.light_radiance(js, li, s.wi, s.light_n, s.uv)
        z = jnp.zeros(p.shape[0], jnp.float32)
        hit_pdf = jls.light_hit_pdf(js, prop, p, d, z, p, nrm, nrm)
        return s, rad, hit_pdf

    t = torch.from_numpy
    prop = hs.lights.prop[torch.from_numpy(li).long()].numpy()
    s_j, rad_j, hp_j = ref(li, p, nrm, xi, d, prop)
    present = ls.light_shapes(hs)
    s = ls.sample_light(hs, present, t(li), t(p), t(nrm), t(xi))
    rad = ls.light_radiance(hs, t(li), s.wi, s.light_n, s.uv)
    hp = ls.light_hit_pdf(hs, present, t(prop), t(p), t(d))
    valid = np.asarray(s_j.pdf) > 0
    np.testing.assert_array_equal(s.pdf.numpy() > 0, valid)
    assert valid[li == 0].mean() > 0.4 and valid[li == 1].mean() > 0.4
    np.testing.assert_array_equal(s.infinite.numpy(), np.asarray(s_j.infinite))
    np.testing.assert_allclose(s.wi.numpy()[valid], np.asarray(s_j.wi)[valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.pdf.numpy(), np.asarray(s_j.pdf), rtol=2e-2, atol=0)
    # the uv a lane reads: the lamp's, and the mapped canopy's disk uv (a
    # uniform canopy's lanes carry the first branch's value, unread)
    read = valid & ((li == 1) | (hs.env is not None))
    np.testing.assert_allclose(s.uv.numpy()[read], np.asarray(s_j.uv)[read], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rad.numpy()[valid], np.asarray(rad_j)[valid], rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hp_j), rtol=2e-2, atol=0)
    # the IES factor: the lamp's radiance varies with the angle off its axis
    lamp = valid & (li == 1)
    r = rad.numpy()[lamp, 0]
    assert r.max() > 2.0 * r.min() > 0.0


def test_canopy_fragment_matches_jax(written):
    """Rays into the sky hit the canopy (above its horizon) or miss: the
    fragment's normal (-d), tangent frame (the canopy's axes) and
    equidistant-disk uv, within 2e-5."""
    from zyg_tpu.scene import shapes as jshapes
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T, ShapeType

    js, _, hs = written["mapped"]
    n = 4096
    p, _, _, d = _lanes(hs, n, 9)
    d = np.where((np.arange(n) % 4 == 0)[:, None], -d, d).astype(np.float32)
    tmax = np.full(n, RAY_MAX_T, np.float32)

    @jax.jit
    def ref(o, d, tmax):
        hit = jshapes.intersect_scene(js, o, d, jnp.float32(0.0), tmax, "reflection")
        return hit.prop, jshapes.build_fragment(js, hit, o, d, need_tangents=True)

    jprop, jf = ref(p, d, tmax)
    t = torch.from_numpy
    hit = shapes.intersect_scene(hs, isect.prop_table(hs, "reflection"), t(p), t(d), 0.0, t(tmax))
    f = shapes.build_fragment(hs, hit, t(p), t(d), need_tangents=True)
    np.testing.assert_array_equal(hit.prop.numpy(), np.asarray(jprop))
    on = hit.prop.numpy() == 0
    assert int(hs.prop_shape[0]) == int(ShapeType.CANOPY) and on.sum() > 800
    for k in ("p", "n", "t", "b", "uv"):
        np.testing.assert_allclose(getattr(f, k).numpy(), np.asarray(getattr(jf, k)), rtol=1e-6,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(f.n.numpy()[on], -d[on])


@pytest.mark.parametrize("text", [IES_TEXT, IES_TILT, IES_TWO_PLANES, IES_TYPE_B, IES_SHORT],
                         ids=["narrow", "tilt", "two_planes", "type_b", "short"])
def test_ies_profile_bins_match_jax(text):
    from zyg_tpu.io import ies as jies
    from zyg_tpu_torch.io import ies as ties

    a, b = jies.ies_profile_bins(text), ties.ies_profile_bins(text)
    assert (a is None) == (b is None)
    if text in (IES_TYPE_B, IES_SHORT):
        assert b is None
    else:
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_eval_ies_matches_jax():
    from zyg_tpu.render.materials import eval_ies as jeval
    from zyg_tpu_torch.render.materials import eval_ies

    rng = np.random.default_rng(3)
    n = 8192
    prof = (rng.random((n, 32)) * 3).astype(np.float32)
    cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    cos[:4] = [1.0, -1.0, 0.0, 0.5]
    want = np.asarray(jax.jit(jeval)(prof, cos))
    got = eval_ies(torch.from_numpy(prof), torch.from_numpy(cos)).numpy()
    # torch and XLA round acos an ulp apart on ~19 % of these inputs; the
    # bin coordinate (up to 31) carries that ulp into the lerp between
    # bins up to 3 apart (measured 1.05e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    np.testing.assert_array_equal(got[:2], want[:2])  # the end bins exactly


def test_mapped_canopy_ies_render_matches_jax_at_golden_gate(written):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    def take(module):
        t = module.load_take_dict({
            "camera": {"Perspective": {
                "parameters": {"fov": 70},
                "transformation": {"position": [0, 1.6, -3.5], "rotation": [18, 0, 0]},
                "resolution": [32, 32]}},
            "sampler": {"Sobol": {"samples_per_pixel": 8}},
            "integrator": {"surface": {"PTMIS": {"depth": {"surface": 6}}}},
        })
        return t

    js, ps, _ = written["mapped"]
    jd = JDriver(take=take(jtake), scene=js)
    ref = jd.render_frame()
    d = Driver(take(ttake), ps, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (32, 32, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced


def _jax_pick(scene):
    from zyg_tpu.ops import shade as jshade
    from zyg_tpu.render.integrator.ptmis import PtmisSettings

    s = PtmisSettings(max_depth=4)
    for name, gate in (("k3", jshade.structural_ok), ("k5", jshade.structural_ok_mesh),
                       ("k6", jshade.structural_ok_mesh_v2)):
        if gate(scene, s, None):
            return name
    return "general"


def _port_pick(scene):
    from zyg_tpu_torch.ops.shade import structural_ok
    from zyg_tpu_torch.ops.surface import structural_ok_mesh
    from zyg_tpu_torch.ops.surface_v2 import structural_ok_mesh_v2

    for name, gate in (("k3", structural_ok), ("k5", structural_ok_mesh),
                       ("k6", structural_ok_mesh_v2)):
        if gate(scene):
            return name
    return "general"


def test_dispatch_matches_jax(written, tmp_path):
    """Kernel 6 exactly where JAX's gates pick it: portal, canopy and IES
    scenes, IES on analytic props and on a mesh, and the controls without
    a profile (kernel 3 and kernel 5) and with glass (the general body)."""
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file

    (tmp_path / "spot.ies").write_text(IES_TEXT)

    def lamp_scene(name, profile=True, mesh=False, glass=False):
        root = written_root(False)
        root["entities"] = root["entities"][1:]  # no canopy: the lamp alone
        if not profile:
            del root["materials"][1]["rendering"]["Light"]["emittance"]["profile"]
        if mesh:
            root["entities"][-1]["shape"] = {"file": "proc:cube"}
        if glass:
            root["materials"].append({"name": "g", "rendering": {"Glass": {"ior": 1.5}}})
            root["entities"][2]["materials"] = ["g"]
        path = tmp_path / f"{name}.scene"
        path.write_text(json.dumps(root))
        return str(path)

    cases = {"portal": "examples/scenes/portal.scene",
             "ies": lamp_scene("ies"), "ies_mesh": lamp_scene("ies_mesh", mesh=True),
             "ies_glass": lamp_scene("ies_glass", glass=True),
             "lamp": lamp_scene("lamp", profile=False),
             "lamp_mesh": lamp_scene("lamp_mesh", profile=False, mesh=True)}
    picks = {k: (_jax_pick(jload(v)), _port_pick(load_scene_file(v))) for k, v in cases.items()}
    for kind, (js, ps, _) in written.items():
        picks[kind] = (_jax_pick(js), _port_pick(ps))
    for k, (want, got) in picks.items():
        assert got == want, (k, want, got)
    assert {k: v[0] for k, v in picks.items()} == {
        "portal": "k6", "ies": "k6", "ies_mesh": "k6", "ies_glass": "general", "lamp": "k3",
        "lamp_mesh": "k5", "uniform": "k6", "mapped": "k6"}
