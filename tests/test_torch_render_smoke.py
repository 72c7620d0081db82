"""The media slice as a whole: examples/takes/smoke.take (a Volumetric
Cube with a 64^3 fbm density grid over a Substitute floor, under a
Rectangle lamp and a constant Dome) and examples/takes/volumes.take (a
homogeneous scattering Cube beside a glass Sphere) through the port's
general body (zyg_tpu_torch/render/integrator/ptmis_general.py, with
render/integrator/volume.py and the tracking walks of ops/track.py)
against the JAX package.

- Loader: both scenes' arrays equal the JAX loader's, with the density
  grid arena, the volume_props rows and the mat_features gates; each
  refused feature raises UnsupportedScene naming it (an emissive medium
  on a mesh prop, a density file, a Volumetric material on a mesh prop).
- total_sphere on smoke.scene's lights (a tree of one finite light and
  the dome), 4,096 seeded lanes, half of them scatter vertices: the
  selection, its pdf and the dome's sample and hit pdfs exact, the
  dome's directions within 2e-6 (torch's and XLA's cos and sin an ulp
  apart); and through test_torch_light_tree.py's four-lamp tree, indices
  exact and pdfs within rtol 2e-5 (that file's tolerance).
- One general bounce on 4,096 smoke lanes taken after three bounces of
  the port's body (lanes inside the smoke, scattered, with a volume
  depth), against the JAX `_make_body`: alive, depth, vol_depth, medium,
  singular, primary_chain, from_volume, vol_key, the Sobol' state and the
  ray count exact; o and mis_o within 1e-5, d and mis_n 1e-5, throughput
  5e-4 (measured 9.4e-5), bxdf_pdf 1e-5, as relative error |a - b| / (|a|
  + 1e-3) on live lanes; emission and indirect radiance within 1e-4, the
  direct radiance within 1e-2: NEE from the floor through the smoke
  multiplies the shadow walk's ratio estimate, which moves with the
  walk's free flights where torch's and XLA's log round an ulp apart
  (measured 4.7e-3 on 1 of 4,096 lanes).
- The Driver's chunk plan and tile plan against the JAX Driver's rules
  (8 samples a chunk and 262,144-pixel tiles for grid scenes): smoke at
  its own 960x540 is two tiles (262,144 + 256,256). With both packages'
  _HEAVY_TILE patched to 256, a 32x16x16 render of smoke.scene with its
  Cube moved out of view (a grid scene whose lifecycles no rounding can
  move) has every pixel's sample count equal to the JAX render's. On
  smoke.scene itself they are not: the Volumetric cube's pass-through
  boundaries make lifecycles sensitive to rounding, and the JAX
  package's own ray count at 32x16, 1 spp moves from 1,573 to 1,549
  between a jit that folds the scene's constants and the Driver's, which
  does not (the port counts 1,577).
- The port's CPU render of tests/golden_configs.py's volume_smoke (64x36,
  8 spp) against tests/goldens/volume_smoke.exr with
  tests/test_goldens.py's gate (mean within 1.5 %, 4x4 RMSE within 6 %
  and raw RMSE within 35 % of the mean), and volumes.take at 48x28, 8 spp
  against the JAX Driver (mean within 1.5 %, 4x4 RMSE within 6 %).
- The CLI renders smoke.take at a tiny size on the CPU.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

SMOKE_TAKE = "examples/takes/smoke.take"
SMOKE = "examples/scenes/smoke.scene"
VOLUMES = "examples/scenes/volumes.scene"
N_LANES = 4096


@pytest.fixture(scope="module")
def smoke_scenes():
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file as tload

    return jload(SMOKE), tload(SMOKE)


@pytest.mark.parametrize("path, feats, sparse", [
    (SMOKE, {"media", "volumetric"}, False),
    (VOLUMES, {"media", "glass", "volumetric"}, None),
])
def test_scene_arrays_match_jax(path, feats, sparse):
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.render.integrator import ptmis
    from zyg_tpu_torch.render.integrator.ptmis_general import GeneralBody
    from zyg_tpu_torch.scene.loader import load_scene_file as tload
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js, ps = jload(path), tload(path)
    a, b = scene_arrays(js), scene_arrays(ps)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ps.mat_features == feats == set(js.mat_features)
    assert list(ps.volume_props) == sorted(js.volume_props)
    assert (ps.grids.sparse if ps.grids is not None else None) == sparse
    # the volume prop never blocks a shadow ray
    vp = ps.volume_props[0][0]
    assert not bool(ps.prop_visible_shadow[vp])
    # the hand-off rebuilds the same scene
    c = scene_arrays(scene_from_jax_arrays(a))
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    body = ptmis._make_body(ps, ptmis.PtmisSettings())
    assert isinstance(body, GeneralBody) and body.scatters


def _volumetric_root(vol, shape=None):
    return {
        "materials": [
            {"name": "v", "rendering": {"Volumetric": vol}},
            {"name": "sky", "rendering": {"Light": {"emittance": {"value": 1.0}}}},
        ],
        "entities": [
            {"type": "Prop", "shape": shape or {"type": "Cube"}, "materials": ["v"]},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
        ],
    }


@pytest.mark.parametrize("root, match", [
    (_volumetric_root({"attenuation_distance": 0.5, "emittance": {"value": 3.0}},
                      shape={"file": "proc:sphere"}),
     "vol_emission"),
    (_volumetric_root({"attenuation_distance": 0.5, "density_map": {"file": "smoke.npy"}}),
     "density file"),
    (_volumetric_root({"attenuation_distance": 0.5}, shape={"file": "proc:sphere"}),
     "Volumetric material on a mesh prop"),
])
def test_refusals_by_name(root, match):
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with pytest.raises(UnsupportedScene, match=match):
        load_scene_dict(root)


def test_total_sphere_selection_and_dome_match_jax(smoke_scenes):
    from zyg_tpu.scene import light_sampling as jls
    from zyg_tpu_torch.scene import light_sampling as tls

    js, ps = smoke_scenes
    rng = np.random.default_rng(21)
    n = N_LANES
    p = rng.uniform([-4, 0, -3], [4, 3, 3], (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    xi = rng.random((n, 2)).astype(np.float32)
    ts = rng.random(n) < 0.5
    t = torch.from_numpy

    @jax.jit
    def ref(u, p, nrm, xi, ts):
        li, sel = jls.select_light(js, u, p=p, n=nrm, total_sphere=ts)
        pdf = jls.light_select_pdf(js, li, p=p, n=nrm, total_sphere=ts)
        dome = jnp.full(li.shape, 1, jnp.int32)
        s = jls.sample_light(js, dome, p, nrm, xi, total_sphere=ts)
        prop = jnp.full(li.shape, 3, jnp.int32)
        hp = jls.light_hit_pdf(js, prop, p, nrm, jnp.ones(li.shape), p, nrm, nrm,
                               total_sphere=ts)
        return li, sel, pdf, s.wi, s.pdf, hp

    jli, jsel, jpdf, jwi, jspdf, jhp = ref(*map(jnp.asarray, (u, p, nrm, xi, ts)))
    li, sel = tls.select_light(ps, t(u), p=t(p), n=t(nrm), total_sphere=t(ts))
    np.testing.assert_array_equal(li.numpy(), np.asarray(jli))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    pdf = tls.light_select_pdf(ps, li, p=t(p), n=t(nrm), total_sphere=t(ts))
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    present = tls.light_shapes(ps)
    dome = torch.full((n,), 1, dtype=torch.int32)
    s = tls.sample_light(ps, present, dome, t(p), t(nrm), t(xi), total_sphere=t(ts))
    np.testing.assert_array_equal(s.pdf.numpy(), np.asarray(jspdf))
    np.testing.assert_allclose(s.wi.numpy(), np.asarray(jwi), rtol=0, atol=2e-6)
    hp = tls.light_hit_pdf(ps, present, torch.full((n,), 3, dtype=torch.int32), t(p), t(nrm),
                           total_sphere=t(ts))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(jhp))
    # the sphere's half below the normal is sampled, and the tree weighs
    # the lamp differently at scatter vertices
    below = (s.wi.numpy() * nrm).sum(-1) < 0
    assert below[ts].mean() > 0.4 and not (below & ~ts & (s.pdf.numpy() > 0)).any()


def test_total_sphere_through_a_deeper_tree_matches_jax():
    """smoke's tree holds one finite light, so its descent is trivial:
    test_torch_light_tree.py's four-lamp scene under a dome, at 4,096
    seeded points, half of them scatter vertices (ra = 1 in the
    importance). Indices exact, pdfs within rtol 2e-5 (that file's
    tolerance: XLA rounds the importance apart inside select and pdf)."""
    from zyg_tpu.scene import light_tree as jlt
    from test_torch_light_tree import _load, tree_scene
    from zyg_tpu_torch.scene import light_tree as tlt

    js, ps = _load(tree_scene(4))
    rng = np.random.default_rng(22)
    n = N_LANES
    p = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    ts = rng.random(n) < 0.5
    jt = js.light_tree
    ji, jsel = jax.jit(lambda p, nn, u, ts: jlt.select(jt, p, nn, ts, u))(p, nrm, u, ts)
    jpdf = jax.jit(lambda p, nn, li, ts: jlt.pdf(jt, p, nn, ts, li))(p, nrm, ji, ts)
    t = torch.from_numpy
    ti, tsel = tlt.select(ps.light_tree, t(p), t(nrm), t(u), t(ts))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tsel.numpy(), np.asarray(jsel), rtol=2e-5)
    tpdf = tlt.pdf(ps.light_tree, t(p), t(nrm), ti, t(ts))
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=2e-5, atol=1e-6)
    # the whole sphere changes the receivers' weights
    plain = tlt.pdf(ps.light_tree, t(p), t(nrm), ti).numpy()
    assert (np.abs(plain - tpdf.numpy()) > 1e-3)[ts].mean() > 0.1
    assert (plain == tpdf.numpy())[~ts].all()


def test_general_bounce_on_smoke_lanes_matches_jax(smoke_scenes):
    from zyg_tpu.render.integrator import ptmis as jp
    from zyg_tpu_torch.render.integrator import ptmis as tp

    import chip_smoke
    from test_torch_render_material import _exact, _jax_state, _rel

    js, ps = smoke_scenes
    s = chip_smoke.smoke_state(N_LANES, 3, seed=12)
    # the lane classes the test means to cover
    assert int((s.medium[:, 0] >= 0).sum()) > 500  # inside the smoke
    assert int((s.alive & s.from_volume).sum()) > 500  # leaving a scatter vertex
    assert int((s.vol_depth > 1).sum()) > 500
    st = dict(max_depth=24, max_depth_volume=128)
    jbody = jp._make_body(js, jp.PtmisSettings(**st, bsdf_split=False))
    r1 = jax.jit(jbody)(_jax_state(s))
    r2 = tp._make_body(ps, tp.PtmisSettings(**st, bsdf_split=False))(s)
    for name in ("alive", "depth", "vol_depth", "medium", "singular", "primary_chain",
                 "from_volume", "vol_key"):
        _exact(getattr(r1, name), getattr(r2, name), name)
    _exact(r1.sobol.run_seed, r2.sobol.run_seed, "run_seed")
    _exact(r1.sobol.sample, r2.sobol.sample, "sample")
    assert int(r1.rays) == int(r2.rays)
    live = np.asarray(r1.alive)
    for name, tol in (("o", 1e-5), ("mis_o", 1e-5), ("d", 1e-5), ("mis_n", 1e-5),
                      ("throughput", 5e-4), ("bxdf_pdf", 1e-5), ("reg_alpha", 1e-6)):
        _rel(getattr(r1, name), getattr(r2, name), live, tol, name)
    everywhere = np.ones_like(live)
    for c, tol in (("emission", 1e-4), ("indirect", 1e-4), ("direct", 1e-2)):
        _rel(getattr(r1.result, c), getattr(r2.result, c), everywhere, tol, c)
    # this bounce scatters lanes in the smoke and passes others through
    # its boundary (both count a volume bounce)
    assert int((r2.from_volume & r2.alive).sum()) > 300
    assert int((r2.alive & ~r2.from_volume & (r2.vol_depth > s.vol_depth)).sum()) > 100


def _plans(take_res, spp):
    """(JAX Driver, port Driver) on smoke.take at take_res and spp."""
    import golden_configs as gc
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take, scene = gc._take_file("smoke.take", take_res, spp)
    pt = load_take_file(SMOKE_TAKE)
    pt.cameras[0].resolution = take_res
    pt.num_samples_per_pixel = spp
    return JaxDriver(take=take, scene=scene, use_mesh=False), Driver(
        pt, load_scene_file(pt.scene_filename), device="cpu")


def _jax_tile_plan(jd):
    """The pixel ranges zyg_tpu/render/driver.py:497-519 dispatches."""
    import zyg_tpu.render.driver as jdm

    n = int(jd._pixel_ids.shape[0])
    sc = jd.scene
    mesh_only = sc.meshes is not None and sc.grids is None and sc.curves is None \
        and sc.points is None
    tile_n = 1 << 21 if mesh_only else jdm._HEAVY_TILE
    can_tile = jd._heavy_loops and jd.take.sensor.filter_radius == 0
    tile = min(n, tile_n) if can_tile else n
    return [(t0, min(t0 + tile, n)) for t0 in range(0, n, tile)]


@pytest.mark.parametrize("res, spp", [((960, 540), 64), ((64, 36), 8), ((32, 16), 12)])
def test_tile_and_chunk_plans_match_jax(res, spp):
    from test_torch_driver import _jax_plan

    jd, pd = _plans(res, spp)
    assert jd._heavy_loops and jd._frame_width > 0
    assert pd.chunk_size == jd.chunk_size == min(spp, 8)
    assert pd.chunk_plan(spp) == _jax_plan(jd, spp)
    assert pd.tile_plan() == _jax_tile_plan(jd)
    if res == (960, 540):
        assert pd.tile_plan() == [(0, 262144), (262144, 518400)]


def test_tiled_render_counts_match_jax(monkeypatch):
    """32x16x16 with 256-pixel tiles: two tiles, two chunks (the second with
    slack 4), the Cube moved out of view."""
    import zyg_tpu.render.driver as jdm
    import zyg_tpu_torch.render.driver as tdm
    from zyg_tpu.io.take import load_take_file as jtake
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    monkeypatch.setattr(jdm, "_HEAVY_TILE", 256)
    monkeypatch.setattr(tdm, "_HEAVY_TILE", 256)
    with open(SMOKE) as f:
        root = json.load(f)
    cube = next(e for e in root["entities"] if e.get("materials") == ["smoke"])
    cube["transformation"]["position"] = [0, 1.3, -30.0]  # behind the camera
    jt, pt = jtake(SMOKE_TAKE), load_take_file(SMOKE_TAKE)
    for t in (jt, pt):
        t.cameras[0].resolution = (32, 16)
        t.num_samples_per_pixel = 16
    jd = JaxDriver(take=jt, scene=jload(root), use_mesh=False)
    pd = Driver(pt, tload(root), device="cpu")
    assert pd.tile_plan() == _jax_tile_plan(jd) == [(0, 256), (256, 512)]
    assert pd.chunk_plan(16) == [(8, 0), (8, 4)]
    jd.render_frame()
    pd.render_frame()
    jw = np.asarray(jd._fb.weight).reshape(-1)
    pw = pd._fb.weight.numpy().reshape(-1)
    assert np.array_equal(pw, jw), f"{int((pw != jw).sum())} of {jw.size} pixel weights differ"
    assert pw.sum() > 512 * 16  # the slack ran
    assert abs(pd.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    assert pd.iterations >= pd.last_iterations > 0


def _gate(img, ref, raw=None):
    from zyg_tpu.tools import it as it_mod

    assert img.shape == ref.shape and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015, img.mean() / scale
    d4 = it_mod.op_downsample(ref, 4) - it_mod.op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    if raw is not None:
        assert float(np.sqrt(np.mean((img - ref) ** 2))) / scale < raw


def test_volume_smoke_matches_golden():
    import golden_configs as gc
    from zyg_tpu.tools import it as it_mod

    _, pd = _plans((64, 36), 8)
    img = pd.render_frame()
    _gate(img, it_mod.load_image(gc.golden_path("volume_smoke")), raw=0.35)
    assert pd.tile_plan() == [(0, 64 * 36)] and pd.chunk_plan(8) == [(8, 4)]


def test_volumes_take_matches_jax_driver():
    from zyg_tpu.io.take import load_take_file as jtake
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = "examples/takes/volumes.take"
    jt, pt = jtake(take), load_take_file(take)
    for t in (jt, pt):
        t.cameras[0].resolution = (48, 28)
        t.num_samples_per_pixel = 8
    ref = JaxDriver(take=jt, scene=jload(jt.scene_filename), use_mesh=False).render_frame()
    pd = Driver(pt, load_scene_file(pt.scene_filename), device="cpu")
    assert pd.settings.bsdf_split and pd.chunk_size == 8  # glass splits; no grid
    _gate(pd.render_frame(), np.asarray(ref))


def test_cli_renders_smoke_take(tmp_path, capsys):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(SMOKE_TAKE) as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SMOKE)
    take["camera"]["Perspective"]["resolution"] = [24, 16]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "small.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu", "-s"]) == 0
    printed = capsys.readouterr().out
    assert "resolution 24x16, 2 spp" in printed and "M rays" in printed
    img = read_png(str(out))
    assert img.shape == (16, 24, 3) and img.mean() > 10
