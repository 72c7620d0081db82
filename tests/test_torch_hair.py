"""The hair slice: examples/takes/hairball.take (400 strands of
examples/assets/furball.hair as cubic Beziers flattened into 3,006
round-cone segments, under the Hair material; two Rectangle lamps through
the light tree; PTMIS depth 8 through the general body) against the JAX
package.

- read_hair (and a gzip copy through io/fs.py open_stream),
  flatten_curves and the curve arena array-equal; the resource cache
  hands back the decoded file; the scene's arrays equal through
  scene_arrays (the Hair material's constants, the curve props outside
  prop_groups, the "hair" feature).
- The plain curve walk per lane against zyg_tpu.scene.curves.traverse on
  8,192 rays aimed at strands from around the camera, closest and
  any-hit: prim, t and s equal on at least 99.5 % of the lanes (measured
  99.85-99.87 %: on a few grazing lanes the cone body's h = k1^2 - k0 k2
  cancels to ~1e-14 and XLA's fusion of the products rounds it to the
  other side of 0), and where prim agrees t within rtol 1e-6 and s
  within 1e-6 (measured: equal bit for bit).
- The curve fragment where both packages hit the same segment: normals,
  tangents and bitangents within 1e-6, uv within 1e-6 (measured: equal,
  uv within 1.2e-7, with the hit point and the axis point fused as XLA
  fuses them; unfused, the normal of a 0.4 mm strand moves by 3e-5).
- The Chiang hair BSDF per lane against zyg_tpu/render/materials.py on
  4,096 lanes (the hairball's constants and seeded variants, random
  frames, offsets, directions and uniforms): hair_eval's f and pdf within
  1e-4 of the lane's largest value (measured 6.1e-5); hair_sample's
  validity equal, its direction within 1e-4 (measured 6.3e-5), its pdf
  within 1e-3 (measured 4.9e-4) and its weight within 1e-5 (measured
  3.0e-6) of the lane's largest value: torch and XLA round acos, atan2,
  asin, log, exp and sinh apart.
- One general bounce on 2,048 hairball lanes (after one bounce of the
  port's body) against the JAX `_make_body`: lifecycles, rays and the
  Sobol' state exact; on live lanes o and mis_o within 1e-5 relative, d
  within 1e-4 absolute (measured 2.4e-5), mis_n within 1e-6, throughput
  within 1e-3 and bxdf_pdf within 2e-4 relative (measured 5.9e-4 and
  6.2e-5: the BSDF sample's rounding), the radiance classes' sums within
  2e-5 and each lane's within 5e-3.
- The hairball image at 48x48, 8 spp, depth 1 (the camera rays' hits and
  NEE through the hair BSDF's evaluation) against the JAX Driver under
  the golden gate (measured: mean ratio 1.0010, 4x4 RMSE 1.65 % of the
  mean). At the take's depth 8 the two images agree in the mean (0.994)
  but not in the 4x4 RMSE (17.5 %; two renders of the port's own with
  different samples differ by 58.7 %): a hair path's direction differs by
  an ulp-level ~1e-5 after each BSDF sample, one path in a few hundred
  then ends at another depth, and from there the persistent wavefront
  hands every later sample of the dispatch to other lanes in the two
  packages, so the renders become independent estimates.
- The CLI renders a small copy of the take.
"""

import gzip
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/hairball.take"
SCENE = "examples/scenes/hairball.scene"
HAIR = "examples/assets/furball.hair"
EYE = np.array([0.0, 0.35, -1.8], np.float32)
N_LANES = 2048


@pytest.fixture(scope="module")
def scenes():
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file as tload

    return jload(SCENE), tload(SCENE)


def test_hair_file_curves_and_arena_match_jax(tmp_path):
    from zyg_tpu.io.hair import read_hair as jread
    from zyg_tpu.scene import curves as jcrv
    from zyg_tpu_torch.io import fs, resource
    from zyg_tpu_torch.io.hair import read_hair
    from zyg_tpu_torch.scene import curves as tcrv

    with open(HAIR, "rb") as f:
        jh = jread(f)
    gz = tmp_path / "furball.hair.gz"
    with open(HAIR, "rb") as f:
        gz.write_bytes(gzip.compress(f.read()))
    for name, base in ((HAIR, ""), ("furball.hair.gz", str(tmp_path))):
        with fs.open_stream(name, base) as f:
            th = read_hair(f)
        for k in jh._fields:
            a, b = getattr(jh, k), getattr(th, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert len(th.strand_ids) > 0 and int(th.strand_ids.max()) == 399
    assert fs.resolve("missing.hair", str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        fs.open_stream("missing.hair", str(tmp_path))
    jf, tf = jcrv.flatten_curves(jh), tcrv.flatten_curves(th)
    assert len(tf[0]) == 3006
    for a, b in zip(jf, tf):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # two sets in one arena: the file and the JAX package's procedural ball
    ball = jcrv.make_hair_ball(num_strands=40, seed=3)
    ja = jcrv.build_arena([jh, ball])
    ta = tcrv.build_arena([th, tcrv.HostCurves(*ball)])
    for k in ("node_rows", "seg_rows", "seg_strand", "curve_root"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, k)), getattr(ta, k).numpy(),
                                      err_msg=k)
    # the cache decodes a file once and keeps no failed load
    cache = resource.ResourceCache()
    calls = []

    def load(path):
        calls.append(path)
        return None if path.endswith("missing") else read_hair(open(path, "rb"))

    first = cache.get_or_load("hair", HAIR, (), load)
    assert cache.get_or_load("hair", HAIR, (), load) is first and calls == [HAIR]
    assert cache.get_or_load("hair", "missing", (), load) is None
    assert cache.get_or_load("hair", "missing", (), load) is None and len(calls) == 3
    assert len(cache) == 1


def test_hairball_scene_matches_jax_arrays(scenes):
    from zyg_tpu_torch.scene.loader import scene_arrays
    from zyg_tpu_torch.scene.types import MaterialKind, ShapeType

    jscene, pscene = scenes
    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    assert {"curves.seg_rows", "curve_props", "prop_curve", "light_tree.center"} <= set(a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["mat_features"].tolist() == ["hair"]
    hair = pscene.materials.kind.tolist().index(int(MaterialKind.HAIR))
    assert (b["materials.hair"][hair] > 0).all()
    assert int(ShapeType.CURVES) not in {int(k) for k in pscene.prop_groups}


@pytest.mark.parametrize("root, match", [
    ({"Hair": {"roughness": {"file": "r.png"}}}, "Hair roughness"),
    ({"Hair": {"color": 0.3, "anisotropy": 0.5}}, "material keys"),
])
def test_hair_material_refusals(root, match):
    from zyg_tpu_torch.scene.loader import parse_material
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match=match):
        parse_material({"rendering": root})


def test_hair_material_constants_match_jax():
    from zyg_tpu.scene import loader as jl
    from zyg_tpu_torch.scene import loader as tl

    for body in ({}, {"color": [0.45, 0.25, 0.08], "roughness": [0.3, 0.35]},
                 {"roughness": 0.5, "ior": 1.6}, {"eumelanin": 1.3, "pheomelanin": 0.4},
                 {"eumelanin": 0.2, "roughness": [0.1]}, {"pheomelanin": 2.0}):
        root = {"rendering": {"Hair": body}}
        jd, td = jl.parse_material(root), tl.parse_material(root)
        for k in ("kind", "roughness", "hair_beta_n", "ior"):
            assert getattr(jd, k) == getattr(td, k), (body, k)
        np.testing.assert_array_equal(jl._hair_constants(jd), tl.hair_constants(td))


def _strand_rays(n, seed):
    """n rays from around the take's camera aimed at points near the
    strands' segments, a quarter of them with non-unit directions."""
    from zyg_tpu_torch.io.hair import read_hair
    from zyg_tpu_torch.scene.curves import flatten_curves

    with open(HAIR, "rb") as f:
        pa = flatten_curves(read_hair(f))[0]
    rng = np.random.default_rng(seed)
    tgt = pa[rng.integers(0, len(pa), n)] + rng.normal(0, 0.003, (n, 3))
    o = EYE + rng.normal(0, 0.05, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_curve_walk_matches_jax(scenes, any_hit):
    from zyg_tpu.scene import curves as jcrv
    from zyg_tpu_torch.ops import curves as ops_curves

    jscene, pscene = scenes
    n = 8192
    o, d = _strand_rays(n, 2)
    d[: n // 8] *= 0.6
    root = np.zeros(n, np.int32)
    root[:7] = -1
    tmax = np.full(n, 1e9, np.float32)
    tmax[7:40] = 1.0

    @jax.jit
    def ref(o, d, tmax):
        return jcrv.traverse(jscene.curves, jnp.asarray(root), o, d, jnp.float32(0.0), tmax,
                             any_hit=any_hit)

    h = ref(o, d, tmax)
    t = torch.from_numpy
    tt, ts, tp = ops_curves.walk(pscene.curves, t(root), t(o), t(d), 0.0, t(tmax),
                                 any_hit=any_hit)
    jt, js, jp = (np.asarray(x) for x in (h.t, h.s, h.prim))
    same = tp.numpy() == jp
    assert same.mean() >= 0.995, same.mean()
    np.testing.assert_allclose(tt.numpy()[same], jt[same], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts.numpy()[same], js[same], rtol=0, atol=1e-6)
    assert (jp >= 0).mean() > 0.8 and (jp[:7] < 0).all()


def _curve_frags(scene, o, d, pkg):
    if pkg == "jax":
        from zyg_tpu.scene import shapes as js

        @jax.jit
        def f(o, d):
            tmax = jnp.full(o.shape[0], js.RAY_MAX_T, jnp.float32)
            hit = js.intersect_scene(scene, o, d, jnp.float32(0.0), tmax, "reflection")
            return hit, js.build_fragment(scene, hit, o, d, need_tangents=True)

        hit, frag = f(o, d)
        out = dict(prop=hit.prop, prim=hit.prim, t=hit.t, n=frag.n, geo_n=frag.geo_n,
                   tan=frag.t, bit=frag.b, uv=frag.uv)
        return {k: np.asarray(v) for k, v in out.items()}
    from zyg_tpu_torch.ops import isect
    from zyg_tpu_torch.scene import shapes
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    t = torch.from_numpy
    table = isect.prop_table(scene, "reflection")
    hit = shapes.intersect_scene(scene, table, t(o), t(d), 0.0,
                                 torch.full((o.shape[0],), RAY_MAX_T))
    frag = shapes.build_fragment(scene, hit, t(o), t(d), need_tangents=True)
    out = dict(prop=hit.prop, prim=hit.prim, t=hit.t, n=frag.n, geo_n=frag.geo_n, tan=frag.t,
               bit=frag.b, uv=frag.uv)
    return {k: v.numpy() for k, v in out.items()}


def test_curve_fragment_matches_jax(scenes):
    jscene, pscene = scenes
    o, d = _strand_rays(2048, 5)
    j = _curve_frags(jscene, o, d, "jax")
    p = _curve_frags(pscene, o, d, "port")
    same = (p["prop"] == j["prop"]) & (p["prim"] == j["prim"])
    assert same.mean() >= 0.995
    on = same & (p["prop"] == 0)
    assert on.sum() > 1500
    for k in ("n", "geo_n", "tan", "bit", "uv"):
        np.testing.assert_allclose(p[k][on], j[k][on], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(p["t"][same], j["t"][same], rtol=0, atol=0)
    assert ((p["uv"][on] >= 0.0) & (p["uv"][on] <= 1.0)).all()


def _hair_lanes(n, seed=7):
    """Per-lane hair BSDF inputs: the hairball's constants and seeded
    variants, ior, the offset h, an orthonormal frame (t, b, n) and unit
    wo, wi, and the three uniforms of a sample."""
    from zyg_tpu_torch.scene.loader import MaterialDesc, hair_constants
    from zyg_tpu_torch.scene.types import MaterialKind

    rng = np.random.default_rng(seed)
    consts = [hair_constants(MaterialDesc(kind=int(MaterialKind.HAIR), roughness=bm,
                                          hair_beta_n=bn, color=np.float32(c)))
              for bm, bn, c in ((0.3, 0.35, [0.45, 0.25, 0.08]), (0.1, 0.2, [0.9, 0.8, 0.6]),
                                (0.6, 0.8, [0.2, 0.2, 0.2]), (0.05, 0.1, [0.5, 0.3, 0.2]))]
    hc = np.stack(consts)[rng.integers(0, len(consts), n)]
    q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0].astype(np.float32)
    frame = [q[:, :, k] for k in range(3)]
    wo = rng.normal(size=(n, 3))
    wi = rng.normal(size=(n, 3))
    unit = lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    return dict(hair=hc.astype(np.float32), ior=rng.uniform(1.4, 1.7, n).astype(np.float32),
                h=rng.uniform(-1.0, 1.0, n).astype(np.float32), t=frame[0], b=frame[1],
                n=frame[2], wo=unit(wo), wi=unit(wi),
                s3=rng.random((n, 3)).astype(np.float32))


def _lobe_close(a, b, tol, scale=None):
    """|a - b| within tol of each lane's largest value (of a, or scale)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.abs(a if scale is None else scale).reshape(a.shape[0], -1).max(axis=1)
    err = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)
    bad = err > tol * ref + 1e-6
    assert not bad.any(), (int(bad.sum()), float((err / (ref + 1e-30)).max()))


def test_hair_bsdf_matches_jax():
    from zyg_tpu.render import materials as jm
    from zyg_tpu_torch.render import materials as tm

    x = _hair_lanes(4096)
    jp = {"hair": jnp.asarray(x["hair"]), "ior": jnp.asarray(x["ior"]),
          "hair_h": jnp.asarray(x["h"])}
    tp = {"hair": torch.from_numpy(x["hair"]), "ior": torch.from_numpy(x["ior"]),
          "hair_h": torch.from_numpy(x["h"])}
    J = {k: jnp.asarray(x[k]) for k in ("t", "b", "n", "wo", "wi", "s3")}
    T = {k: torch.from_numpy(x[k]) for k in ("t", "b", "n", "wo", "wi", "s3")}
    jf, jpdf = jax.jit(jm.hair_eval)(jp, J["wo"], J["wi"], J["t"], J["b"], J["n"])
    tf, tpdf = tm.hair_eval(tp, T["wo"], T["wi"], T["t"], T["b"], T["n"])
    assert float(jnp.max(jf)) > 1.0 and (np.asarray(jpdf) > 0).mean() > 0.9
    _lobe_close(jf, tf.numpy(), 1e-4)
    _lobe_close(jpdf, tpdf.numpy(), 1e-4)
    jwi, jw, jspdf, jok = jax.jit(jm.hair_sample)(jp, J["wo"], J["t"], J["b"], J["n"], J["s3"])
    twi, tw, tspdf, tok = tm.hair_sample(tp, T["wo"], T["t"], T["b"], T["n"], T["s3"])
    jok, tok = np.asarray(jok), tok.numpy()
    np.testing.assert_array_equal(tok, jok)
    assert jok.mean() > 0.99
    np.testing.assert_allclose(twi.numpy()[jok], np.asarray(jwi)[jok], rtol=0, atol=1e-4)
    _lobe_close(np.asarray(jspdf)[jok], tspdf.numpy()[jok], 1e-3)
    _lobe_close(np.asarray(jw)[jok], tw.numpy()[jok], 1e-5)


def test_hair_in_the_bsdf_dispatch():
    """sample_bsdf, eval_bsdf and can_evaluate route hair lanes to the hair
    BSDF where the frame is given, beside substitute lanes."""
    from zyg_tpu_torch.render import materials as tm

    x = _hair_lanes(64, seed=9)
    n = 64
    kind = torch.where(torch.arange(n) % 2 == 0, 5, 0).to(torch.int32)
    T = {k: torch.from_numpy(x[k]) for k in ("t", "b", "n", "wo", "wi", "s3")}
    params = {"kind": kind, "hair": torch.from_numpy(x["hair"]), "ior": torch.from_numpy(x["ior"]),
              "hair_h": torch.from_numpy(x["h"]), "features": {"hair"},
              "albedo": torch.full((n, 3), 0.5), "alpha": torch.full((n,), 0.25),
              "metallic": torch.zeros(n), "f0": torch.full((n, 3), 0.04),
              "specular": torch.ones(n)}
    f, pdf = tm.eval_bsdf(params, T["wo"], T["wi"], T["n"], T["n"], t=T["t"], b=T["b"])
    hf, hpdf = tm.hair_eval(params, T["wo"], T["wi"], T["t"], T["b"], T["n"])
    hair = kind == 5
    assert torch.equal(f[hair], hf[hair]) and torch.equal(pdf[hair], hpdf[hair])
    bs = tm.sample_bsdf(params, T["wo"], T["n"], T["n"], T["s3"], t=T["t"], b=T["b"])
    hwi, hw, _, hok = tm.hair_sample(params, T["wo"], T["t"], T["b"], T["n"], T["s3"])
    assert torch.equal(bs.wi[hair], hwi[hair]) and torch.equal(bs.valid[hair], hok[hair])
    assert bool((bs.reg_alpha[hair] == 1.0).all()) and not bool(bs.singular.any())
    assert bool(tm.can_evaluate(params).all())
    # without the frame, hair lanes evaluate to nothing (the JAX package's
    # integrators that pass no frame do the same)
    f0, _ = tm.eval_bsdf(params, T["wo"], T["wi"], T["n"], T["n"])
    assert not bool(f0[hair].any())


@pytest.fixture(scope="module")
def bounce(scenes):
    import chip_smoke
    from test_torch_render_material import _jax_state
    from zyg_tpu.render.integrator import ptmis as jp
    from zyg_tpu_torch.render.integrator import ptmis as tp

    jscene, pscene = scenes
    o, tgt = _strand_rays(N_LANES, 8)
    tgt = o + tgt  # unit directions: a point one unit along each
    s = chip_smoke.general_state(pscene, o, tgt, 1, 8, split=False)
    jbody = jp._make_body(jscene, jp.PtmisSettings(max_depth=8, bsdf_split=False))
    r1 = jax.jit(jbody)(_jax_state(s))
    r2 = tp._make_body(pscene, tp.PtmisSettings(max_depth=8, bsdf_split=False))(s)
    return s, r1, r2


def test_general_bounce_on_hairball_matches_jax(bounce):
    from test_torch_render_material import _exact, _rel

    s, r1, r2 = bounce
    # lanes that left a strand and lanes hitting one now
    assert int(s.alive.sum()) > 1000
    for name in ("alive", "depth", "singular", "primary_chain", "vol_key"):
        _exact(getattr(r1, name), getattr(r2, name), name)
    _exact(r1.sobol.run_seed, r2.sobol.run_seed, "run_seed")
    _exact(r1.sobol.sample, r2.sobol.sample, "sample")
    assert int(r1.rays) == int(r2.rays)
    live = np.asarray(r1.alive)
    assert live.sum() > 500
    for name, tol in (("o", 1e-5), ("mis_o", 1e-5), ("mis_n", 1e-6), ("throughput", 1e-3),
                      ("bxdf_pdf", 2e-4)):
        _rel(getattr(r1, name), getattr(r2, name), live, tol, name)
    assert np.abs(np.asarray(r1.d) - r2.d.numpy())[live].max() < 1e-4
    everywhere = np.ones_like(live)
    for c in ("emission", "direct", "indirect"):
        np.testing.assert_allclose(getattr(r2.result, c).numpy().sum(axis=0),
                                   np.asarray(getattr(r1.result, c)).sum(axis=0), rtol=2e-5)
        _rel(getattr(r1.result, c), getattr(r2.result, c), everywhere, 5e-3, c)


def _take(module, res, spp, depth):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    take.integrator.max_depth_surface = depth
    return take


def test_hairball_render_matches_jax_at_golden_gate(scenes):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    jscene, pscene = scenes
    jd = JDriver(take=_take(jtake, (48, 48), 8, 1), scene=jscene)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (48, 48), 8, 1), pscene, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (48, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced


def test_cli_renders_hairball(tmp_path):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.png import read_png

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [24, 24]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 1
    take["integrator"]["surface"]["PTMIS"]["depth"]["surface"] = 3
    path = tmp_path / "hairball_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (24, 24, 3) and img.mean() > 5


def test_curve_walk_step_counts_by_hand():
    """The plain curve walk's lane steps and leaf warp-steps on a port-only
    arena of two clusters of 2 straight strands (2 segments each: a root
    and two leaves of 4 segments): test_torch_points.check_step_counts'
    hand count, and each cluster's lanes hit its z = 0.2 strand (1 and 3)."""
    from test_torch_points import check_step_counts
    from zyg_tpu_torch.scene import curves as crv

    pts = []
    for x in (-5.0, 5.0):
        for z in (-0.2, 0.2):
            pts.append(np.stack([np.full(4, x), np.linspace(-1.0, 1.0, 4), np.full(4, z)], -1))
    host = crv.HostCurves(points=np.concatenate(pts).astype(np.float32),
                          widths=np.full(16, 0.2, np.float32),
                          curve_starts=np.arange(0, 16, 4), strand_ids=np.arange(4),
                          strand_u=np.tile(np.array([[0.0, 1.0]], np.float32), (4, 1)))
    arena = crv.build_arena([host])
    prim = check_step_counts(
        arena.node_rows,
        lambda root, o, d, tmax, counts: crv.traverse(arena, root, o, d, 0.0, tmax,
                                                      counts=counts),
        int(arena.curve_root[0]))
    strand = crv.segment_fields(arena, prim[prim >= 0])["strand"]
    assert torch.equal(strand, torch.tensor([1] * 10 + [3] * 4, dtype=strand.dtype))
