"""The photon map against the JAX package (zyg_tpu/render/integrator/
photon.py), on examples/takes/caustics_photons.take cut to 64x36, 8 spp
and 100,000 photon paths (~560 photons land through the glass sphere),
and on a seeded photon cloud.

- The cell hash equals the JAX hash exactly, negative and large cell
  coordinates included; build_map on the JAX bake's own arrays, and on
  the cloud (cells on both sides of 0), gives the JAX map: p, wi and
  alpha in the same order and the same cell_start, exactly.
- The bake (render/integrator/photon.py::bake, through Driver.bake_photons)
  against the JAX bake with the Driver's seeding law: the valid masks
  equal (at least 99.5 % of the slots required; measured 100 %), where
  both are valid p within 2e-4 (measured 6.4e-5: two refractions through
  the glass amplify torch's and XLA's ulps), wi within 1e-5 (4.0e-6) and
  alpha within rtol 2e-3 (4.2e-4); the gather's scan bound (the fullest
  bucket's next power of two) equal.
- The plain gather (ops/photon.py) against the JAX gather on the cloud
  (photons on both sides of each lane's shading normal), a rough diffuse
  and a glossy metallic Substitute per lane, 20 % of the lanes inactive,
  max_per_cell 4 (the cap drops photons) and 64: inactive lanes exactly 0,
  the lanes with an estimate the same, each lane within rtol 2e-3 of its
  largest channel plus 1e-6 of the batch's largest value (measured 8e-4:
  the general body's BSDF against XLA's, test_torch_glass.py's f
  tolerance).
- The caustics image through the port's Driver (bake and render) against
  the JAX Driver's at the golden gate (mean within 1.5 %, 4x4 RMSE within
  6 % of the mean; measured 0.999998 and 3.2e-5), with the take's photon
  settings, chunk and tile plans equal to the JAX Driver's.
- The photon term alone (each Driver's image less its render without
  photons: the port's map with its power zeroed, an empty JAX map): mean
  within 0.2 %, 4x4 RMSE within 1 % of the JAX term's mean (measured
  0.999996 and 1.8e-4); the image without the term fails the image's
  gate (mean 0.856 of the JAX image's).
- Rough glass under a photon map is refused by name.

The JAX bake and render compile once each (a module fixture); the JAX
Driver renders with the fixture's map, so it does not bake again, and
renders an empty map (no valid photon: the same image as zeroed power)
through the same compile, while two threads run the JAX bake and the
port's bake and renders. The JAX gather compiles once: at max_per_cell
64, and for the cap of 4 over the map cut to each bucket's first 4
photons (the same sums).
"""

import concurrent.futures
import dataclasses
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/caustics_photons.take"
PATHS = 100_000


def _root():
    with open(TAKE, encoding="utf-8") as f:
        root = json.load(f)
    root["camera"]["Perspective"]["resolution"] = [64, 36]
    root["sampler"]["Sobol"]["samples_per_pixel"] = 8
    root["photon"]["num_photons"] = PATHS
    return root


def _keys(n):
    return (np.arange(n, dtype=np.uint64) * 2654435761 + 977) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def caustics():
    """The JAX bake, map and renders (with the map, and with an empty map:
    the image without the photon term), and the port's Driver after its
    bake and renders (with the map, and with its power zeroed), of the
    cut take. Three threads overlap the JAX render's compile, the JAX
    bake and the port's work; the JAX render compiles once, for the empty
    map, and renders the real map through the same compile."""
    from zyg_tpu.io.take import load_take_dict as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.render.integrator import photon as jp
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.render.integrator import photon as tp
    from zyg_tpu_torch.scene.loader import load_scene_file

    base = os.path.dirname(os.path.abspath(TAKE))
    jt = jtake(_root(), base_dir=base)
    js = jload(jt.scene_filename)
    ps = jt.photon
    settings = jp.PhotonSettings(ps.num_photons, ps.max_bounces, ps.search_radius,
                                 ps.full_light_path)
    build = jax.jit(functools.partial(jp.build_map, search_radius=ps.search_radius,
                                      num_paths=PATHS))

    def jax_bake():
        bake = jax.jit(functools.partial(jp.bake, settings=settings))(
            js, jnp.asarray(_keys(PATHS).astype(np.uint32)))
        bake = tuple(np.asarray(x) for x in bake)
        return bake, build(*bake)

    def port():
        tt = load_take_dict(_root(), base_dir=base)
        d = Driver(tt, load_scene_file(tt.scene_filename), device="cpu")
        # the Driver's own bake (its seeding law), captured at the call
        orig, port_bake = tp.bake, []

        def capture(*args, **kw):
            port_bake.append(orig(*args, **kw))
            return port_bake[-1]

        tp.bake = capture
        try:
            img = d.render_frame()
        finally:
            tp.bake = orig
        rays, pmap = d.rays_traced, d._photon_map
        d._photon_map = dataclasses.replace(pmap, alpha=torch.zeros_like(pmap.alpha))
        d.start_frame()
        d.render_iterations(tt.num_samples_per_pixel)
        img0 = d.resolve()
        d._photon_map = pmap
        return {"driver": d, "img": img, "img0": img0, "rays": rays, "port_bake": port_bake[0]}

    def jax_render(jd, pmap, max_per_cell):
        # render_frame without its bake: the map given is the Driver's own
        jd._photon_map, jd._photon_max_per_cell = pmap, max_per_cell
        jd.start_frame()
        jd.render_iterations(jt.num_samples_per_pixel)
        return np.asarray(jd.resolve()), jd.rays_traced

    m = PATHS * ps.max_bounces
    zeros = np.zeros((m, 3), np.float32)
    # no valid photon: every bucket empty, the same shapes as the real map
    empty = build(zeros, zeros, zeros, np.zeros(m, bool))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        baking, porting = pool.submit(jax_bake), pool.submit(port)
        jd = JDriver(take=jt, scene=js)
        # the bound the real map takes at 100,000 paths (its fullest bucket
        # holds 64), so that both renders share one compile
        ref0, _ = jax_render(jd, empty, 64)
        bake, jmap = baking.result()
        fullest = int(np.diff(np.asarray(jmap.cell_start)).max())
        ref, jax_rays = jax_render(jd, jmap, 1 << max(fullest - 1, 0).bit_length())
        out = porting.result()
    return {"jax_take": jt, "jax_driver": jd, "bake": bake, "jmap": jmap, "ref": ref,
            "ref0": ref0, "jax_rays": jax_rays, **out}


def test_cell_hash_matches_jax():
    from zyg_tpu.render.integrator import photon as jp
    from zyg_tpu_torch.render.integrator import photon as tp

    rng = np.random.default_rng(3)
    c = rng.integers(-(1 << 31), (1 << 31) - 1, (3, 50000), dtype=np.int64).astype(np.int32)
    c[:, :1000] = rng.integers(-40, 40, (3, 1000))
    want = np.asarray(jax.jit(jp._cell_hash)(*(jnp.asarray(x) for x in c)))
    got = tp._cell_hash(*(torch.from_numpy(x) for x in c)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tp.TABLE_BITS == jp.TABLE_BITS and tp.MAX_PER_CELL == jp.MAX_PER_CELL


def _assert_maps_equal(jmap, tmap):
    for f in ("p", "wi", "alpha", "cell_start"):
        want = np.asarray(getattr(jmap, f))
        got = getattr(tmap, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tmap.radius, tmap.num_paths) == (jmap.radius, jmap.num_paths)
    assert tmap.inv_cell == jmap.inv_cell


def test_build_map_matches_jax_on_its_bake(caustics):
    from zyg_tpu_torch.render.integrator import photon as tp

    p, wi, alpha, valid = (torch.from_numpy(x.copy()) for x in caustics["bake"])
    tmap = tp.build_map(p, wi, alpha, valid, 0.05, PATHS)
    _assert_maps_equal(caustics["jmap"], tmap)
    assert int(tmap.cell_start[-1]) == int(valid.sum()) > 300


def test_bake_matches_jax(caustics):
    jv = caustics["bake"][3]
    d = caustics["driver"]
    got = caustics["port_bake"]  # the Driver's bake of the take's paths
    tv = got[3].numpy()
    assert (tv == jv).mean() >= 0.995 and jv.sum() > 300
    both = tv & jv
    want = caustics["bake"]
    np.testing.assert_allclose(got[0].numpy()[both], want[0][both], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy()[both], want[1][both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy()[both], want[2][both], rtol=2e-3, atol=0)
    assert d._photon_map.max_per_cell == caustics["jax_driver"]._photon_max_per_cell


def _cloud(seed=11, m=4000):
    """A seeded photon cloud in [-0.2, 0.2]^3 (cells of 0.1 on both sides
    of 0, ~60 photons a bucket) with directions over the whole sphere."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.2, 0.2, (m, 3)).astype(np.float32)
    wi = rng.normal(size=(m, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    alpha = rng.uniform(0.0, 2.0, (m, 3)).astype(np.float32)
    valid = rng.random(m) < 0.9
    return p, wi, alpha, valid


def _gather_scenes():
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict

    root = {
        "materials": [
            {"name": "rough", "rendering": {"Substitute": {"color": [0.55, 0.52, 0.48],
                                                           "roughness": 0.8}}},
            {"name": "gold", "rendering": {"Substitute": {"color": [0.9, 0.7, 0.4],
                                                          "roughness": 0.25, "metallic": 1.0}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
        "entities": [
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["rough"]},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["gold"]},
            {"type": "Light", "shape": {"type": "Sphere"}, "materials": ["lamp"],
             "transformation": {"position": [0, 3, 0]}}]}
    return jload(root), load_scene_dict(root)


@pytest.fixture(scope="module")
def cloud_maps():
    from zyg_tpu.render.integrator import photon as jp
    from zyg_tpu_torch.render.integrator import photon as tp

    arrs = _cloud()
    jmap = jax.jit(functools.partial(jp.build_map, search_radius=0.05, num_paths=3000))(
        *(jnp.asarray(x) for x in arrs))
    tmap = tp.build_map(*(torch.from_numpy(x) for x in arrs), 0.05, 3000)
    return jmap, tmap


def test_build_map_matches_jax_on_a_cloud(cloud_maps):
    jmap, tmap = cloud_maps
    _assert_maps_equal(jmap, tmap)
    assert int(torch.diff(tmap.cell_start).max()) > 64  # the cap drops photons
    # the scan bound: the fullest bucket's next power of two, by the JAX Driver's rule
    fullest = int(np.diff(np.asarray(jmap.cell_start)).max())
    assert tmap.max_per_cell == 1 << max(fullest - 1, 0).bit_length() > 64


def _first_of_each_bucket(jmap, cap):
    """The JAX map with each bucket cut to its first `cap` photons, padded
    to the same rows: the JAX gather at max_per_cell 64 over it sums what
    the JAX gather at max_per_cell `cap` sums over the full map (the loop
    visits a bucket's photons in order and adds 0 past its end)."""
    cs = np.asarray(jmap.cell_start)
    counts = np.minimum(np.diff(cs), cap)
    rows = np.concatenate([np.arange(a, a + c) for a, c in zip(cs[:-1], counts) if c])
    pad = np.asarray(jmap.p).shape[0] - rows.shape[0]
    out = [np.concatenate([np.asarray(getattr(jmap, f))[rows],
                           np.zeros((pad, 3), np.float32)]) for f in ("p", "wi", "alpha")]
    return out + [np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)]


@pytest.fixture(scope="module")
def cloud_gathers(cloud_maps):
    """The JAX gather on lanes in the cloud at max_per_cell 64 and, through
    the same compile over the map's first 4 photons of each bucket, 4; and
    the lanes."""
    from zyg_tpu.render import materials as jm
    from zyg_tpu.render.integrator import photon as jp

    jmap, _ = cloud_maps
    js, ts = _gather_scenes()
    n = 2000
    rng = np.random.default_rng(12)
    pos = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    geo = nrm + rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    geo /= np.linalg.norm(geo, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((wo * geo).sum(1, keepdims=True) < 0, -wo, wo).astype(np.float32)
    active = rng.random(n) < 0.8
    mid = rng.integers(0, 2, n).astype(np.int32)
    lanes = (mid, pos, wo, nrm, geo, active)

    @jax.jit
    def ref(p, wi, alpha, cell_start, mid, pos, wo, nrm, geo, active):
        pmap = jmap._replace(p=p, wi=wi, alpha=alpha, cell_start=cell_start)
        params = jm.gather(js.materials, mid, medium_ior=jnp.ones(mid.shape),
                           features=js.mat_features)
        return jp.gather(pmap, params, pos, wo, nrm, geo, active, max_per_cell=64)

    maps = {64: [np.asarray(getattr(jmap, f)) for f in ("p", "wi", "alpha", "cell_start")],
            4: _first_of_each_bucket(jmap, 4)}
    want = {cap: np.asarray(ref(*(jnp.asarray(x) for x in (*m, *lanes))))
            for cap, m in maps.items()}
    return ts, lanes, want


@pytest.mark.parametrize("cap", [4, 64])
def test_gather_matches_jax(cloud_maps, cloud_gathers, cap):
    from zyg_tpu_torch.render import materials as tm
    from zyg_tpu_torch.render.integrator import photon as tp

    _, tmap = cloud_maps
    ts, (mid, pos, wo, nrm, geo, active), want = cloud_gathers
    want = want[cap]
    n = mid.shape[0]
    t = torch.from_numpy
    params = tm.gather(ts.materials, t(mid), medium_ior=torch.ones(n), features=ts.mat_features)
    got = tp.gather(dataclasses.replace(tmap, max_per_cell=cap), params, t(pos), t(wo), t(nrm),
                    t(geo), t(active))
    got = got.numpy()
    assert not got[~active].any() and not want[~active].any()
    lit = want.max(axis=1) > 0
    np.testing.assert_array_equal(got.max(axis=1) > 0, lit)
    assert lit.mean() > 0.2
    err = np.abs(got.astype(np.float64) - want).max(axis=1)
    assert (err <= 2e-3 * want.max(axis=1) + 1e-6 * want.max()).all(), err.max()


def test_caustics_take_settings_and_plans_match_jax(caustics):
    d, jd = caustics["driver"], caustics["jax_driver"]
    jps, tps = caustics["jax_take"].photon, d.take.photon
    assert (tps.num_photons, tps.max_bounces, tps.search_radius, tps.full_light_path,
            tps.not_only_through_specular) == (jps.num_photons, jps.max_bounces,
                                                jps.search_radius, jps.full_light_path,
                                                jps.not_only_through_specular)
    assert tps.not_only_through_specular and d.settings.photons_not_only_through_specular
    assert d.chunk_size == jd.chunk_size == 8
    assert d.tile_plan() == [(0, 64 * 36)]


def _golden_gate(ref, img):
    """(mean ratio, 4x4-downsampled RMSE over the mean) of img against ref."""
    from zyg_tpu.tools.it import op_downsample

    scale = float(ref.mean())
    assert scale > 0.0
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    return float(img.mean()) / scale, float(np.sqrt(np.mean(d4 * d4))) / scale


def test_caustics_image_matches_jax_at_golden_gate(caustics):
    ref, img = caustics["ref"], caustics["img"]
    assert img.shape == ref.shape == (36, 64, 3) and np.isfinite(img).all()
    ratio, rmse = _golden_gate(ref, img)
    assert abs(ratio - 1.0) < 0.015 and rmse < 0.06
    assert abs(caustics["rays"] - caustics["jax_rays"]) <= 1e-3 * caustics["jax_rays"]


def test_caustics_photon_term_matches_jax(caustics):
    """The photon term alone: each Driver's image less its render without
    photons (zeroed power, an empty map). Both Drivers draw the same samples, so
    the term is held tighter than the golden gate: mean within 0.2 %, 4x4
    RMSE within 1 % of the JAX term's mean (measured 0.999996 and 1.8e-4;
    a body that gathers off the primary chain too gives 1.0146 and 0.055,
    inside the golden gate). The image without the term fails the image's
    gate."""
    ref, img, ref0, img0 = (caustics[k] for k in ("ref", "img", "ref0", "img0"))
    ratio0, _ = _golden_gate(ref, img0)
    assert abs(ratio0 - 1.0) > 0.05  # measured 0.856: the term is ~14 % of the mean
    ratio, rmse = _golden_gate(ref - ref0, img - img0)
    assert abs(ratio - 1.0) < 0.002 and rmse < 0.01


def test_rough_glass_under_a_photon_map_is_refused_by_name(tmp_path):
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    with open("examples/scenes/caustics.scene", encoding="utf-8") as f:
        root = json.load(f)
    root["materials"][1]["rendering"]["Glass"]["roughness"] = 0.3
    scene = load_scene_dict(root)
    take = load_take_dict(_root(), base_dir=os.path.dirname(os.path.abspath(TAKE)))
    with pytest.raises(UnsupportedScene, match="rough glass under a photon map"):
        Driver(take, scene, device="cpu")
    take.photon.num_photons = 0
    Driver(take, scene, device="cpu")  # without the map the general body takes it
