"""The lighttracer (the particle pass) against the JAX package
(zyg_tpu/render/integrator/lighttracer.py, render/camera.py
camera_sample_to, render/driver.py render_particles).

- Take parse: the `particle` integrator alone (cornell_particles.take:
  64 particles a pixel, 0 spp, the JAX defaults of the forward
  integrator), beside a surface integrator (caustics off), and the photon
  map's not_only_through_specular with and without particles, all equal
  to zyg_tpu/io/take.py's; other particle keys refused by name.
- camera_sample_to per lane on a turned camera: validity and pixel exact
  away from pixel borders (1e-3 of a pixel), direction, distance and pdf
  within rtol 1e-5.
- The keys law (pixel_id * max(ppp, 2) + pass, uint32) bit for bit,
  wrapping past 2^32.
- lt_splat's plain version against the JAX expression (eval_bsdf,
  cam_pdf * throughput * f, .at[ids].add) on seeded lanes over five
  material kinds: the connections counted equal, each pixel within 2e-3
  of its largest channel plus 1e-6 of the largest value (the general
  body's BSDF against XLA's, as the photon gather is held).
- trace on cornell.scene at 32x32, 4 passes, against the JAX Driver's own
  `_particle_fn()`, whose one compile also renders the JAX Driver's
  render_frame: rays within 0.5 % (XLA's log flips roulette decisions),
  each pass's splat and the frame at the golden gate (mean within 1.5 %,
  4x4 RMSE within 6 % of the mean); with 0 spp the forward framebuffer
  resolves to zeros and the image is splat / passes.
- full_light_path=False (only vertices reached through a specular chain
  splat) on caustics.scene at 192x108, 4 passes, against one JAX compile of
  trace, seen by caustics_photons.take's camera turned by Euler angles
  (its look_at rotation is not orthonormal, and camera_sample_to projects
  through it as it stands, in both packages): rays within 0.5 %, the
  same pixels lit (~0.7 %), the image at the golden gate.
- sample_light_from's Distant, env-mapped Dome, Canopy (uniform and
  mapped), portal and IES branches per lane against the JAX function on
  sunsky.scene, portal.scene and test_torch_canopy_ies.py's written
  scenes (built from the JAX tables): finite flags exact, p, n and d
  within 1e-5, weights within rtol 1e-4 of a lane's largest channel (the
  env map's lat-long and disk uv come from atan2 and acos, which XLA and
  torch round apart).
- The refusals by name: rough glass and volume lights in a light path.
- The CLI on a 16x16, 2-particle copy of cornell_particles.take.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_canopy_ies import IES_TEXT, written_root

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKES = os.path.join(REPO, "examples/takes")
PARTICLES = os.path.join(TAKES, "cornell_particles.take")
RES = (32, 32)
PASSES = 4


def _gate(img, ref, what):
    """The golden gate: mean within 1.5 %, 4x4 RMSE within 6 % of the mean."""
    from zyg_tpu.tools.it import op_downsample

    assert np.isfinite(img).all(), what
    scale = float(ref.mean())
    assert scale > 0.0, what
    assert abs(float(img.mean()) / scale - 1.0) < 0.015, what
    d4 = op_downsample(img, 4) - op_downsample(ref, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06, what


# ---------------------------------------------------------------------------
# take parse
# ---------------------------------------------------------------------------


def _particles_root() -> dict:
    with open(PARTICLES, encoding="utf-8") as f:
        return json.load(f)


def _photon_root(particles: bool) -> dict:
    with open(os.path.join(TAKES, "caustics_photons.take"), encoding="utf-8") as f:
        root = json.load(f)
    if particles:
        root["integrator"]["particle"] = {"particles_per_pixel": 3}
    return root


def _beside_surface_root() -> dict:
    root = _particles_root()
    root["integrator"] = {"surface": {"PTMIS": {"depth": {"surface": 5}}},
                          "particle": {"particles_per_pixel": 2, "full_light_path": False}}
    root["sampler"]["Sobol"]["samples_per_pixel"] = 4
    return root


@pytest.mark.parametrize("case", ["particle_alone", "beside_surface", "photon_without",
                                  "photon_with"])
def test_take_parse_matches_jax(case):
    from zyg_tpu.io.take import load_take_dict as jload
    from zyg_tpu_torch.io.take import load_take_dict

    root = {"particle_alone": _particles_root, "beside_surface": _beside_surface_root,
            "photon_without": lambda: _photon_root(False),
            "photon_with": lambda: _photon_root(True)}[case]()
    want, got = jload(root, base_dir=TAKES), load_take_dict(root, base_dir=TAKES)
    for a, b in ((want, got), (want.integrator, got.integrator), (want.photon, got.photon)):
        for k in ("num_particles_per_pixel", "num_samples_per_pixel", "max_depth_surface",
                  "caustics", "kind", "num_photons", "not_only_through_specular"):
            if hasattr(b, k):
                assert getattr(b, k) == getattr(a, k), (case, k)
    expect = {"particle_alone": (64, 0, True, 16), "beside_surface": (2, 4, False, 5),
              "photon_without": (0, 32, False, 16), "photon_with": (3, 32, False, 16)}[case]
    integ = got.integrator
    assert (got.num_particles_per_pixel, got.num_samples_per_pixel, integ.caustics,
            integ.max_depth_surface) == expect
    if case.startswith("photon"):
        assert got.photon.not_only_through_specular == (case == "photon_without")


def test_particle_keys_refused_by_name():
    from zyg_tpu_torch.io.take import UnsupportedTake, load_take_dict

    root = _particles_root()
    root["integrator"]["particle"]["max_bounces"] = 4
    with pytest.raises(UnsupportedTake, match="particle integrator keys.*max_bounces"):
        load_take_dict(root, base_dir=TAKES)


# ---------------------------------------------------------------------------
# camera_sample_to and the keys law
# ---------------------------------------------------------------------------


def test_camera_sample_to_matches_jax():
    from zyg_tpu.io.take import load_take_dict as jload
    from zyg_tpu.render.camera import camera_sample_to as jsample_to
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.camera import camera_sample_to

    root = _particles_root()
    res = (80, 48)
    root["camera"]["Perspective"]["resolution"] = list(res)
    root["camera"]["Perspective"]["transformation"]["rotation"] = [8, -12, 3]
    jcam = jload(root, base_dir=TAKES).cameras[0]
    tcam = load_take_dict(root, base_dir=TAKES).cameras[0]
    rng = np.random.default_rng(21)
    n = 20000
    # points over the view, a fifth of them behind the camera
    p = rng.uniform([-1.6, -1.2, -2.0], [1.6, 1.2, 1.5], (n, 3)).astype(np.float32)
    p[: n // 5, 2] -= 4.5
    want = jax.jit(jsample_to, static_argnums=1)(jcam.arrays(), res, jnp.asarray(p))
    got = camera_sample_to(tcam.arrays(), res, torch.from_numpy(p))
    wpix, wdir, wt, wpdf, wok = (np.asarray(x) for x in want)
    gpix, gdir, gt, gpdf, gok = (x.numpy() for x in got)
    # the sensor-plane coordinates in float64: lanes within 1e-3 of a pixel
    # border may round to either side
    arr = tcam.arrays()
    rot, pos = arr.rot.numpy().astype(np.float64), arr.pos.numpy().astype(np.float64)
    po = (p - pos) @ rot.T
    lt, dx, dy = (x.numpy().astype(np.float64) for x in (arr.d_base, arr.d_dx, arr.d_dy))
    with np.errstate(divide="ignore", invalid="ignore"):
        pd = po * (lt[2] / po[:, 2])[:, None]
        xy = np.stack([(pd[:, 0] - lt[0]) / dx[0], (pd[:, 1] - lt[1]) / dy[1]], axis=1)
    frac = xy - np.round(xy)
    clear = np.isfinite(xy).all(axis=1) & (np.abs(frac) > 1e-3).all(axis=1)
    assert clear.mean() > 0.99 and wok.mean() > 0.2 and (~wok).mean() > 0.2
    np.testing.assert_array_equal(gok[clear], wok[clear])
    ok = clear & wok
    np.testing.assert_array_equal(gpix[ok], wpix[ok])
    np.testing.assert_array_equal(gpdf[~wok & ~gok], 0.0)
    np.testing.assert_allclose(gdir, wdir, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=0)
    np.testing.assert_allclose(gpdf[ok], wpdf[ok], rtol=1e-5, atol=0)


def test_particle_keys_match_jax():
    from zyg_tpu_torch.render.driver import particle_keys

    ids = np.concatenate([np.arange(4096), np.arange(70_000_000, 70_004_096)]).astype(np.uint32)
    for ppp, traced in ((1, 0), (64, 0), (64, 63), (100, 7)):
        want = jnp.asarray(ids) * jnp.uint32(max(ppp, 2)) + jnp.uint32(traced)
        got = particle_keys(torch.from_numpy(ids.astype(np.int64)), ppp, traced)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (np.asarray(want).astype(np.int64) < ids.astype(np.int64) * 100).any()  # wrapped


# ---------------------------------------------------------------------------
# the camera splat's plain version
# ---------------------------------------------------------------------------


def _splat_root() -> dict:
    mats = [
        {"name": "white", "rendering": {"Substitute": {"color": [0.73, 0.73, 0.73],
                                                       "roughness": 1.0}}},
        {"name": "gold", "rendering": {"Substitute": {"color": [0.9, 0.6, 0.2],
                                                      "roughness": 0.15, "metallic": 1.0}}},
        {"name": "plastic", "rendering": {"Substitute": {"color": [0.2, 0.4, 0.8],
                                                         "roughness": 0.35}}},
        {"name": "glass", "rendering": {"Glass": {"color": [1.0, 1.0, 1.0], "ior": 1.5}}},
        {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 5.0}}}},
    ]
    ents = [{"type": "Prop" if m["name"] != "lamp" else "Light",
             "shape": {"type": "Rectangle"}, "materials": [m["name"]],
             "transformation": {"position": [i, 0, 0]}} for i, m in enumerate(mats)]
    return {"materials": mats, "entities": ents}


def test_lt_splat_plain_matches_jax():
    from zyg_tpu.render import materials as jmat
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.ops.lt_splat import lt_splat
    from zyg_tpu_torch.render import materials as M
    from zyg_tpu_torch.scene.loader import load_scene_dict

    js, ps = jload(_splat_root()), load_scene_dict(_splat_root())
    rng = np.random.default_rng(33)
    n, pixels = 8192, 64

    def unit(shape):
        v = rng.normal(size=shape)
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    mat = rng.integers(0, ps.materials.kind.shape[0], n).astype(np.int32)
    nrm = unit((n, 3))
    geo = nrm + 0.3 * unit((n, 3))
    geo = (geo / np.linalg.norm(geo, axis=1, keepdims=True)).astype(np.float32)
    wo, wi = unit((n, 3)), unit((n, 3))
    tp = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    cam_pdf = rng.exponential(3.0, n).astype(np.float32)
    ids = rng.integers(0, pixels, n)
    connect = rng.random(n) < 0.8
    blocked = rng.random(n) < 0.2
    ior = np.ones(n, np.float32)

    def ref(mat, wo, wi, nrm, geo, tp, cam_pdf, ids, connect, blocked, ior):
        params = jmat.gather(js.materials, mat, ior, js.textures, jnp.zeros((n, 2)),
                             features=js.mat_features)
        f, _ = jmat.eval_bsdf(params, wo, wi, nrm, geo)
        conn = connect & (jnp.max(f, axis=-1) > 0.0)
        contrib = jnp.where((conn & ~blocked)[..., None], cam_pdf[..., None] * tp * f, 0.0)
        return jnp.zeros((pixels, 3), jnp.float32).at[ids].add(contrib), jnp.sum(conn)

    args = (mat, wo, wi, nrm, geo, tp, cam_pdf, ids.astype(np.int32), connect, blocked, ior)
    want, wcount = (np.asarray(x) for x in jax.jit(ref)(*(jnp.asarray(a) for a in args)))
    t = torch.from_numpy
    params = M.gather(ps.materials, t(mat), medium_ior=t(ior), features=set(ps.mat_features))
    splat = torch.zeros((pixels, 4))
    count = torch.zeros(1, dtype=torch.int64)
    lt_splat(params, t(wo), t(wi), t(nrm), t(geo), t(tp), t(cam_pdf), t(ids), t(connect),
             t(blocked), splat, count)
    assert int(count) == int(wcount) > n // 4
    got = splat.numpy()
    np.testing.assert_array_equal(got[:, 3], 0.0)
    tol = 2e-3 * want.max(axis=1) + 1e-6 * want.max()
    assert (np.abs(got[:, :3] - want).max(axis=1) <= tol).all()
    # kinds the substitute BSDF leaves out add nothing, as in JAX
    kinds = ps.materials.kind.numpy()[mat]
    assert (kinds != 0).any() and want.max() > 0


# ---------------------------------------------------------------------------
# the particle pass on cornell.scene against the JAX Driver
# ---------------------------------------------------------------------------


def _cut_root(res, ppp):
    root = _particles_root()
    root["camera"]["Perspective"]["resolution"] = list(res)
    root["integrator"]["particle"]["particles_per_pixel"] = ppp
    return root


@pytest.fixture(scope="module")
def cornell():
    """Each pass's (splat, rays) of both packages, then both Drivers'
    render_frame; the JAX pass function is the Driver's own, compiled once
    for both."""
    from zyg_tpu.io.take import load_take_dict as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.scene.loader import load_scene_file as jscene
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver, particle_keys
    from zyg_tpu_torch.render.integrator.lighttracer import trace
    from zyg_tpu_torch.scene.loader import load_scene_file

    jt = jtake(_cut_root(RES, PASSES), base_dir=TAKES)
    jd = JDriver(take=jt, scene=jscene(jt.scene_filename))
    fn = jd._particle_fn()
    tt = load_take_dict(_cut_root(RES, PASSES), base_dir=TAKES)
    d = Driver(tt, load_scene_file(tt.scene_filename), device="cpu")
    cam = d.camera.arrays("cpu")
    passes = []
    for k in range(PASSES):
        keys = jd._pixel_ids * jnp.uint32(PASSES) + jnp.uint32(k)
        js, jr = fn(jd.scene, jd.camera.arrays(jd.layer), keys)
        ts, tr = trace(d.scene, cam, RES, particle_keys(d._pixel_ids, PASSES, k),
                       d.particle_settings())
        passes.append((np.asarray(js), int(jr), ts.numpy(), int(tr)))
    jimg = np.asarray(jd.render_frame())
    img = d.render_frame()
    return {"passes": passes, "jax": (jimg, jd.rays_traced), "port": (img, d)}


def test_particle_passes_match_jax(cornell):
    w, h = RES
    for k, (js, jr, ts, tr) in enumerate(cornell["passes"]):
        assert abs(tr - jr) <= 5e-3 * jr, (k, tr, jr)
        _gate(ts.reshape(h, w, 3), js.reshape(h, w, 3), f"pass {k}")


def test_particle_frame_matches_jax(cornell):
    jimg, jrays = cornell["jax"]
    img, d = cornell["port"]
    assert img.shape == jimg.shape == (RES[1], RES[0], 3)
    _gate(img, jimg, "render_frame")
    assert abs(d.rays_traced - jrays) <= 5e-3 * jrays
    assert d.rays_traced == d.particle_rays == sum(p[3] for p in cornell["passes"])
    # no forward samples: the framebuffer resolves to zeros, and the image
    # is the splat over the passes
    assert float(d._fb.weight.max()) == 0.0
    np.testing.assert_array_equal(d._fb.resolve().numpy(), 0.0)
    want = sum(p[2] for p in cornell["passes"]) / np.float32(PASSES)
    np.testing.assert_allclose(img.reshape(-1, 3), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# caustic chains only (full_light_path False)
# ---------------------------------------------------------------------------


def test_caustic_chains_match_jax():
    from zyg_tpu.io.take import load_take_dict as jtake
    from zyg_tpu.render.integrator import lighttracer as jlt
    from zyg_tpu.scene.loader import load_scene_file as jscene
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import particle_keys
    from zyg_tpu_torch.render.integrator.lighttracer import LighttracerSettings, trace
    from zyg_tpu_torch.scene.loader import load_scene_file

    res, passes = (192, 108), 4
    with open(os.path.join(TAKES, "caustics_photons.take"), encoding="utf-8") as f:
        root = json.load(f)
    # the take's look_at rotation is not orthonormal, which camera_sample_to
    # does not undo (in both packages): the same view by Euler angles
    root["camera"]["Perspective"]["transformation"] = {"position": [0, 2.6, -5.5],
                                                       "rotation": [-19, 0, 0]}
    root["camera"]["Perspective"]["resolution"] = list(res)
    jt, tt = jtake(root, base_dir=TAKES), load_take_dict(root, base_dir=TAKES)
    js, ps = jscene(jt.scene_filename), load_scene_file(tt.scene_filename)
    settings = LighttracerSettings(max_depth=8, full_light_path=False)
    fn = jax.jit(lambda scene, cam, keys: jlt.trace(
        scene, cam, res, keys, jlt.LighttracerSettings(max_depth=8, full_light_path=False)))
    ids = np.arange(res[0] * res[1])
    jsum, tsum, jrays, trays = 0.0, 0.0, 0, 0
    for k in range(passes):
        keys = particle_keys(torch.from_numpy(ids), passes, k)
        s, r = fn(js, jt.cameras[0].arrays(), jnp.asarray(keys.numpy().astype(np.uint32)))
        jsum, jrays = jsum + np.asarray(s), jrays + int(r)
        s, r = trace(ps, tt.cameras[0].arrays("cpu"), res, keys, settings)
        tsum, trays = tsum + s.numpy(), trays + int(r)
    assert abs(trays - jrays) <= 5e-3 * jrays
    w, h = res
    lit = (jsum.max(axis=1) > 0).mean()
    print(f"caustic chains: {lit:.4f} of the pixels lit, rays {trays} / {jrays}, mean "
          f"{tsum.mean() / jsum.mean():.6f}")
    assert 0.005 < lit < 0.5, lit
    np.testing.assert_array_equal(tsum.max(axis=1) > 0, jsum.max(axis=1) > 0)
    _gate(tsum.reshape(h, w, 3), jsum.reshape(h, w, 3), "caustic chains")


# ---------------------------------------------------------------------------
# sample_light_from's new branches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emitter_scenes(tmp_path_factory):
    """{name: (JAX scene, the port's scene from its tables)}: sunsky (a
    Distant sun beside a mapped Dome), portal (a portal beside the Sky's
    dome and sun) and the canopy/IES scenes, uniform and mapped."""
    from zyg_tpu.io.rgbe import write_hdr
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    d = tmp_path_factory.mktemp("emitters")
    img = np.random.default_rng(41).random((32, 32, 3)) * [3.0, 2.5, 2.0] + 0.2
    write_hdr(str(d / "canopy.hdr"), img.astype(np.float32))
    (d / "spot.ies").write_text(IES_TEXT)
    paths = {"sunsky": os.path.join(REPO, "examples/scenes/sunsky.scene"),
             "portal": os.path.join(REPO, "examples/scenes/portal.scene")}
    for kind in ("uniform", "mapped"):
        paths[f"canopy_{kind}"] = str(d / f"{kind}.scene")
        (d / f"{kind}.scene").write_text(json.dumps(written_root(kind == "mapped")))
    out = {}
    for name, path in paths.items():
        js = jload(path)
        # the world bounding sphere is a host constant beside the tables
        ps = dataclasses.replace(scene_from_jax_arrays(scene_arrays(js), "cpu"),
                                 world_center=tuple(js.world_center),
                                 world_radius=js.world_radius)
        out[name] = (js, ps)
    return out


@pytest.mark.parametrize("name", ["sunsky", "portal", "canopy_uniform", "canopy_mapped"])
def test_sample_light_from_branches_match_jax(emitter_scenes, name):
    from zyg_tpu.render.integrator.lighttracer import sample_light_from as jslf
    from zyg_tpu_torch.render.integrator.lighttracer import sample_light_from
    from zyg_tpu_torch.scene import light_sampling as ls
    from zyg_tpu_torch.scene.types import ShapeType

    js, ps = emitter_scenes[name]
    n = 20000
    rng = np.random.default_rng(51)
    li = rng.integers(0, ps.lights.count, n).astype(np.int32)
    xi = rng.random((n, 4)).astype(np.float32)
    side = rng.random(n).astype(np.float32)
    want = jax.jit(lambda li, xi, us: jslf(js, li, xi, u_side=us))(
        jnp.asarray(li), jnp.asarray(xi), jnp.asarray(side))
    t = torch.from_numpy
    got = [x.numpy() for x in sample_light_from(ps, t(li), t(xi), t(side))]
    p, nn, dd, w, fin = (np.asarray(x) for x in want)
    present = ls.light_shapes(ps)
    expect = {"sunsky": {int(ShapeType.DISTANT), int(ShapeType.DOME)},
              "portal": {ls.PORTAL}, "canopy_uniform": {int(ShapeType.CANOPY)},
              "canopy_mapped": {int(ShapeType.CANOPY)}}[name]
    assert expect <= present, present
    if name.startswith("canopy"):
        assert "ies" in ps.mat_features
    if name == "canopy_mapped" or name == "sunsky":
        assert ps.env is not None
    np.testing.assert_array_equal(got[4], fin)
    assert fin.all()
    np.testing.assert_allclose(got[0], p, rtol=0, atol=1e-5 * max(1.0, ps.world_radius))
    np.testing.assert_allclose(got[1], nn, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], dd, rtol=0, atol=1e-5)
    scale = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-30)
    np.testing.assert_allclose(got[3] / scale, w / scale, rtol=0, atol=1e-4)
    assert (w.max(axis=1) > 0).mean() > 0.3


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


def test_lighttracer_refusals_by_name():
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    take = load_take_dict(_cut_root((16, 16), 1), base_dir=TAKES)
    root = _splat_root()
    root["materials"][3]["rendering"]["Glass"]["roughness"] = 0.3
    with pytest.raises(UnsupportedScene, match="rough glass"):
        Driver(take, load_scene_dict(root), device="cpu")
    with open(os.path.join(REPO, "examples/scenes/fire.scene"), encoding="utf-8") as f:
        fire = json.load(f)
    with pytest.raises(UnsupportedScene, match="volume"):
        Driver(take, load_scene_dict(fire, base_dir=os.path.join(REPO, "examples/scenes")),
               device="cpu")


def test_cli_renders_particles(tmp_path, capsys):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.png import read_png

    root = _cut_root((16, 16), 2)
    root["scene"] = os.path.join(REPO, "examples/scenes/cornell.scene")
    take = tmp_path / "p.take"
    take.write_text(json.dumps(root))
    out = tmp_path / "p.png"
    assert cli.main(["-i", str(take), "-o", str(out), "-s", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "0 spp" in text and "particle pass: 2 light paths a pixel" in text
    img = read_png(str(out))
    assert img.shape[:2] == (16, 16) and img.mean() > 10
