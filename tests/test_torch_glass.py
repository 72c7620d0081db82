"""The general body's BSDFs (zyg_tpu_torch/render/materials.py) per lane
against zyg_tpu.render.materials, on gathered parameters of one table of
materials: four substitutes (rough and smooth plastic, gold, a mirror),
smooth glass, rough glass (roughness 0.3) and a second smooth glass, with
the scene's features {"glass", "rough_glass", "media"}.

Lanes: random shading frames (the shading normal up to ~0.2 rad off the
geometric one), wo on both sides of the surface (entering and exiting
glass), the surrounding medium's ior 1, 1.33 or equal to the glass's own
(index-matched lanes pass straight through), grazing exits (total
internal reflection), and glass_branch -1 / 0 / 1 and glass_split drawn
per lane.

Tolerances: valid, singular and transmission exact; the gathered
parameters, among them f0 against the medium and ior_outside, exact;
wi within 5e-6 (measured 2.4e-6); weights within rtol 5e-3, atol 1e-6
(measured 2.7e-3, on the mirror's GGX lobe of alpha 4e-4, whose f and
pdf each carry the cancellation of 1 - cos^2 of the half vector); pdfs
and f within rtol 2e-3, atol 1e-6, except the mirror's lobe, whose pdf
peaks at ~1e5 and turns an ulp of the half vector's cosine into a change
of several times (measured up to 5.4x): there held within a factor 10,
positive and finite (its weight f / pdf is held as above);
sampled pdfs within rtol 5e-3 (measured 3.4e-3 on the smooth plastic,
alpha 0.0144), not compared on forced refractions under total internal
reflection, which the body never parks; the fresnel term within 1e-5;
roulette exact. Substitute lanes whose wo
lies below the shading hemisphere (the shading normal on the far side,
which only interpolated normals produce) sample through the VNDF's
cancelling 1 + v.z: there wi is held within 0.1 (measured 0.059 on the
mirror) and the weight within rtol 5e-2 (measured 1.6e-2), the flags
exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

FEATS = {"glass", "rough_glass", "media"}
MATS = {
    "materials": [
        {"name": "rough", "rendering": {"Substitute": {"color": [0.2, 0.3, 0.8], "roughness": 0.5,
                                                       "ior": 1.5}}},
        {"name": "smooth", "rendering": {"Substitute": {"color": [0.8, 0.2, 0.2],
                                                        "roughness": 0.12, "ior": 1.5}}},
        {"name": "gold", "rendering": {"Substitute": {"color": [1.0, 0.77, 0.34],
                                                      "roughness": 0.25, "metallic": 1.0}}},
        {"name": "mirror", "rendering": {"Substitute": {"color": [0.95, 0.95, 0.95],
                                                        "roughness": 0.02, "metallic": 1.0}}},
        {"name": "glass", "rendering": {"Glass": {"color": [0.95, 1.0, 0.98], "ior": 1.5,
                                                  "attenuation_distance": 0.5}}},
        {"name": "rough_glass", "rendering": {"Glass": {"ior": 1.45, "roughness": 0.3}}},
        {"name": "water", "rendering": {"Glass": {"ior": 1.33}}},
        {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 1.0}}}},
    ],
    "entities": [{"type": "Prop", "shape": {"type": "Rectangle"}, "materials": [n]}
                 for n in ("rough", "smooth", "gold", "mirror", "glass", "rough_glass", "water")]
    + [{"type": "Light", "shape": {"type": "Dome"}, "materials": ["lamp"]}],
}
# material ids in the order the entities name them; 0 is the loader's fallback
MIRROR, GLASS, ROUGH_GLASS, WATER = 4, 5, 6, 7


@pytest.fixture(scope="module")
def tables():
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    js = jload(MATS)
    ps = scene_from_jax_arrays(scene_arrays(js), "cpu")
    assert ps.mat_features == FEATS
    return js.materials, ps.materials


def _lanes(n, seed):
    rng = np.random.default_rng(seed)
    geo_n = rng.normal(size=(n, 3))
    geo_n /= np.linalg.norm(geo_n, axis=1, keepdims=True)
    ns = geo_n + 0.2 * rng.normal(size=(n, 3)) * (rng.random(n) < 0.5)[:, None]
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    # a quarter of the lanes leave at grazing angles (TIR when exiting glass)
    graze = rng.random(n) < 0.25
    t = np.cross(geo_n, rng.normal(size=(n, 3)))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0)[:, None]
    wo_g = t + side * rng.uniform(0.05, 0.5, (n, 1)) * geo_n
    wo = np.where(graze[:, None], wo_g / np.linalg.norm(wo_g, axis=1, keepdims=True), wo)
    wi = rng.normal(size=(n, 3))
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    mat = rng.integers(1, 8, n).astype(np.int32)
    med = rng.choice(np.array([1.0, 1.33, 1.5, 1.45], np.float32), n)
    s3 = rng.random((n, 3)).astype(np.float32)
    branch = rng.integers(-1, 2, n).astype(np.int32)
    split = rng.random(n) < 0.5
    f32 = np.float32
    return dict(geo_n=geo_n.astype(f32), n=ns.astype(f32), wo=wo.astype(f32), wi=wi.astype(f32),
                mat=mat, med=med, s3=s3, branch=branch, split=split)


def _params(tables, a):
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as M

    jm, pm = tables
    jp = jax.jit(lambda m, med: jmat.gather(jm, m, med, features={k: True for k in FEATS}))(
        jnp.asarray(a["mat"]), jnp.asarray(a["med"]))
    pp = M.gather(pm, torch.from_numpy(a["mat"]), medium_ior=torch.from_numpy(a["med"]),
                  features=FEATS)
    return jp, pp


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, rtol, atol, mask=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def test_gather_against_the_medium(tables):
    a = _lanes(2048, 1)
    jp, pp = _params(tables, a)
    for k in ("kind", "f0", "albedo", "alpha", "ior", "ior_outside", "specular",
              "attenuation_distance", "color"):
        np.testing.assert_array_equal(np.asarray(jp[k]), pp[k].numpy(), err_msg=k)


@pytest.mark.parametrize("forcing", ["stochastic", "branch"])
def test_sample_bsdf_matches_jax(tables, forcing):
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as M

    a = _lanes(8192, 2 if forcing == "stochastic" else 3)
    jp, pp = _params(tables, a)
    branch = a["branch"] if forcing == "branch" else None

    @jax.jit
    def ref(wo, n, gn, s3, br):
        return jmat.sample_bsdf(jp, wo, n, gn, s3, glass_branch=br)

    j = ref(*(jnp.asarray(a[k]) for k in ("wo", "n", "geo_n", "s3")),
            None if branch is None else jnp.asarray(branch))
    p = M.sample_bsdf(pp, _t(a["wo"]), _t(a["n"]), _t(a["geo_n"]), _t(a["s3"]),
                      glass_branch=None if branch is None else _t(branch))
    for k in ("valid", "singular", "transmission"):
        np.testing.assert_array_equal(np.asarray(getattr(j, k)), getattr(p, k).numpy(), err_msg=k)
    valid = np.asarray(j.valid)
    kind = a["mat"]
    glass = kind >= GLASS
    same = (a["wo"] * a["geo_n"]).sum(1) > 0
    below = (a["wo"] * np.where(same[:, None], a["n"], -a["n"])).sum(1) <= 0
    sub_below = below & ~glass
    _close(j.wi, p.wi, 0, 5e-6, valid & ~sub_below)
    _close(j.wi, p.wi, 0, 0.1, valid & sub_below)
    _close(j.weight, p.weight, 5e-3, 1e-6, ~sub_below)
    _close(j.weight, p.weight, 5e-2, 1e-6, sub_below)
    _close(j.fresnel, p.fresnel, 0, 1e-5, glass)
    _close(j.reg_alpha, p.reg_alpha, 0, 0)
    mirror = (kind == MIRROR) & ~np.asarray(j.singular)
    # a forced refraction under total internal reflection (F = 1) is never
    # parked (the body splits only where 1 - F > 1e-6): its jacobian divides
    # by ~0, so its pdf is not compared
    tir_forced = glass & (np.asarray(j.fresnel) >= 1.0 - 1e-6)
    if branch is not None:
        tir_forced &= branch == 1
    else:
        tir_forced &= False
    _close(j.pdf, p.pdf, 5e-3, 1e-6, ~mirror & ~sub_below & ~tir_forced)
    jm, pm = np.asarray(j.pdf)[mirror & valid], p.pdf.numpy()[mirror & valid]
    assert np.isfinite(pm).all() and (np.abs(np.log(np.maximum(pm, 1e-30) / np.maximum(jm, 1e-30)))
                                      < np.log(10.0)).all()
    # the lane classes the test means to cover
    trans = np.asarray(j.transmission)
    matched = glass & np.isclose(np.where(same, a["med"], 0), np.asarray(jp["ior"]))
    assert (glass & same & trans).sum() > 100 and (glass & ~same & trans).sum() > 100
    assert matched.sum() > 50
    assert (glass & ~same & ~trans & (np.asarray(j.fresnel) >= 1.0)).sum() > 50  # TIR
    if forcing == "branch":
        forced = glass & (branch >= 0) & ~matched
        np.testing.assert_array_equal(trans[forced], branch[forced] == 1)


def test_eval_bsdf_matches_jax(tables):
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as M

    a = _lanes(8192, 4)
    jp, pp = _params(tables, a)
    f1, pdf1 = jax.jit(lambda wo, wi, n, gn, sp: jmat.eval_bsdf(jp, wo, wi, n, gn, glass_split=sp))(
        *(jnp.asarray(a[k]) for k in ("wo", "wi", "n", "geo_n", "split")))
    f2, pdf2 = M.eval_bsdf(pp, *(_t(a[k]) for k in ("wo", "wi", "n", "geo_n")),
                           glass_split=_t(a["split"]))
    mirror = a["mat"] == MIRROR
    _close(f1, f2, 1e-4, 1e-6, ~mirror)
    _close(pdf1, pdf2, 2e-3, 1e-6, ~mirror)
    rough_glass = a["mat"] == ROUGH_GLASS
    assert (np.asarray(pdf1)[rough_glass] > 0).sum() > 200
    np.testing.assert_array_equal(np.asarray(jmat.can_evaluate(jp)), M.can_evaluate(pp).numpy())


def test_russian_roulette_matches_jax():
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as M

    rng = np.random.default_rng(5)
    thr = (rng.random((4096, 3)) * 0.12).astype(np.float32)
    r = rng.random(4096).astype(np.float32)
    a, ka = jax.jit(jmat.russian_roulette)(jnp.asarray(thr), jnp.asarray(r))
    b, kb = M.russian_roulette(_t(thr), _t(r))
    np.testing.assert_array_equal(np.asarray(ka), kb.numpy())
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 100 < int(kb.sum()) < 4000
