"""The port's medium stack and homogeneous glass-interior transport
(zyg_tpu_torch/render/integrator/volume.py, render/materials.py
medium_coefficients / hg_*) against the JAX package's
(zyg_tpu/render/integrator/volume.py, render/materials.py).

Tolerances: the stack helpers exactly (stacks, effective props, iors,
priorities, in-stack flags), on random stacks over six glass props of
priorities 0-2 with pushes into full stacks, pops of absent props and
ties of equal priority, and on tests/test_medium_stack.py's cases; the
Beer weight exp(-mu_t seg) and the medium coefficients within rtol 1e-6
(torch's and XLA's log and exp round an ulp apart); the HG phase and its
sampled directions within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

SCENE = {
    "materials": [
        {"name": "g0", "rendering": {"Glass": {"ior": 1.5, "priority": 1,
                                               "attenuation_distance": 0.5,
                                               "color": [0.9, 0.8, 0.95]}}},
        {"name": "g1", "rendering": {"Glass": {"ior": 1.33}}},
        {"name": "g2", "rendering": {"Glass": {"ior": 1.8, "priority": 2, "roughness": 0.3}}},
        {"name": "g3", "rendering": {"Glass": {"ior": 1.2, "attenuation_color": [0.5, 0.6, 0.7],
                                               "attenuation_distance": 2.0}}},
        {"name": "floor", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.5]}}},
        {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 1.0}}}},
    ],
    "entities": [
        {"type": "Prop", "shape": {"type": "Sphere"}, "materials": [m],
         "transformation": {"position": [i, 0, 0]}}
        for i, m in enumerate(["g0", "g1", "g2", "g3", "g1", "g2"])
    ] + [
        {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["floor"]},
        {"type": "Light", "shape": {"type": "Dome"}, "materials": ["lamp"]},
    ],
}


@pytest.fixture(scope="module")
def scenes():
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict, scene_arrays, scene_from_jax_arrays

    js = jload(SCENE)
    a, b = scene_arrays(js), scene_arrays(load_scene_dict(SCENE))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return js, scene_from_jax_arrays(a, "cpu")


def _random_stacks(n, seed):
    """Stacks of 0-4 distinct glass props (ids 0-5), entries in push order
    with gaps where a pop left a hole; a quarter of them full."""
    rng = np.random.default_rng(seed)
    st = np.full((n, 4), -1, np.int32)
    for i in range(n):
        k = 4 if i % 4 == 0 else rng.integers(0, 5)
        props = rng.permutation(6)[:k]
        st[i, :k] = props
        if k and rng.random() < 0.3:
            st[i, rng.integers(0, k)] = -1  # a popped slot
    return st


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_stack_queries_match_jax(scenes):
    from zyg_tpu.render.integrator import volume as jvol
    from zyg_tpu_torch.render.integrator import volume as vol

    js, ps = scenes
    n = 2048
    st = _random_stacks(n, 1)
    hit = np.random.default_rng(2).integers(0, 6, n).astype(np.int32)
    e1 = jax.jit(lambda s: jvol.stack_effective(js, s))(_j(st))
    e2 = vol.stack_effective(ps, _t(st))
    for a, b in zip(e1, e2):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    i1 = jax.jit(lambda s, h: jvol.stack_info_at_hit(js, s, h))(_j(st), _j(hit))
    i2 = vol.stack_info_at_hit(ps, _t(st), _t(hit))
    for a, b in zip(i1, i2):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # ties of equal priority occur (g1 twice, g2 twice) and the newest wins
    prio = ps.materials.priority[ps.prop_material[torch.clamp(_t(st), min=0).long()]]
    ties = ((prio[:, :, None] == prio[:, None, :]) & (_t(st)[:, :, None] >= 0)
            & (_t(st)[:, None, :] >= 0)).sum(dim=(1, 2)) > (_t(st) >= 0).sum(1)
    assert int(ties.sum()) > 200


def test_stack_update_matches_jax(scenes):
    from zyg_tpu.render.integrator import volume as jvol
    from zyg_tpu_torch.render.integrator import volume as vol

    n = 4096
    rng = np.random.default_rng(3)
    st = _random_stacks(n, 4)
    hit = rng.integers(-1, 6, n).astype(np.int32)
    entering = rng.random(n) < 0.5
    apply = rng.random(n) < 0.8
    a = np.asarray(jax.jit(jvol.stack_update)(_j(st), _j(hit), _j(entering), _j(apply)))
    b = vol.stack_update(_t(st), _t(hit), _t(entering), _t(apply)).numpy()
    np.testing.assert_array_equal(a, b)
    full = (st >= 0).all(axis=1) & entering & apply
    assert full.sum() > 100 and (b[full] == st[full]).all()  # a push into a full stack drops
    popped = ~entering & apply & (st == hit[:, None]).any(axis=1)
    assert popped.sum() > 100


def test_stack_sequences_match_jax(scenes):
    """tests/test_medium_stack.py's cases: enter glass, enter water (the
    glass's priority owns the overlap; the water's boundary is false),
    exit both; equal priorities, the newest wins."""
    from zyg_tpu.render.integrator import volume as jvol
    from zyg_tpu_torch.render.integrator import volume as vol

    js, ps = scenes
    n = 6
    jst, tst = jvol.stack_empty(n), vol.stack_empty(n, "cpu")
    tr = np.ones(n, bool)
    for prop, enter in ((0, True), (1, True), (4, True), (2, True), (5, True), (1, False),
                        (0, False), (3, True), (2, False), (4, False)):
        h = np.full(n, prop, np.int32)
        e = tr if enter else ~tr
        jst = jvol.stack_update(jst, _j(h), _j(e), _j(tr))
        tst = vol.stack_update(tst, _t(h), _t(e), _t(tr))
        np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
        for a, b in zip(jvol.stack_effective(js, jst), vol.stack_effective(ps, tst)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jvol.stack_info_at_hit(js, jst, _j(h)),
                        vol.stack_info_at_hit(ps, tst, _t(h))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_beer_weight_matches_jax(scenes):
    """absorption_weight against sample_interaction's homogeneous weight
    (the JAX event never scatters in glass) and medium_coefficients."""
    from zyg_tpu.render import materials as jmat
    from zyg_tpu.render.integrator import volume as jvol
    from zyg_tpu_torch.render import materials as M
    from zyg_tpu_torch.render.integrator import volume as vol

    js, ps = scenes
    n = 2048
    rng = np.random.default_rng(5)
    prop = rng.integers(-1, 6, n).astype(np.int32)
    seg = np.where(rng.random(n) < 0.1, 3.0e37, rng.exponential(1.0, n)).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = rng.random(n).astype(np.float32)
    key = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    depth = rng.integers(0, 40, n).astype(np.int32)

    @jax.jit
    def ref(prop, seg, o, d, u, key, depth):
        ev = jvol.sample_interaction(js, prop, o, d, seg, u, key, vol_depth=depth)
        mm = jvol.medium_material(js, prop)
        return ev, mm, jmat.medium_coefficients(js.materials, mm, vol_depth=depth)

    ev, mm, coef = ref(_j(prop), _j(seg), _j(o), _j(d), _j(u), _j(key), _j(depth))
    assert not np.asarray(ev.scatter).any() and not np.asarray(ev.absorb).any()
    np.testing.assert_array_equal(np.asarray(mm), vol.medium_material(ps, _t(prop)).numpy())
    w = vol.absorption_weight(ps, _t(prop), _t(seg)).numpy()
    np.testing.assert_allclose(w, np.asarray(ev.weight), rtol=1e-6, atol=1e-30)
    inside = prop >= 0
    assert (w[inside] < 1.0).any() and (w[~inside] == 1.0).all()
    for a, b in zip(coef, M.medium_coefficients(ps.materials, _t(np.asarray(mm)), _t(depth))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    tr = vol.transmittance(ps, _t(o), _t(d), _t(seg))
    assert torch.equal(tr, torch.ones_like(tr))


def test_hg_phase_and_sample_match_jax():
    from zyg_tpu.render import materials as jmat
    from zyg_tpu_torch.render import materials as M

    n = 4096
    rng = np.random.default_rng(6)
    g = np.concatenate([np.zeros(n // 4), rng.uniform(-0.95, 0.95, n - n // 4)]).astype(np.float32)
    g[1::17] = 5e-4  # the |g| < 1e-3 branch
    cos = rng.uniform(-1, 1, n).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    xi = rng.random((n, 2)).astype(np.float32)
    np.testing.assert_allclose(M.hg_phase(_t(cos), _t(g)).numpy(),
                               np.asarray(jax.jit(jmat.hg_phase)(_j(cos), _j(g))), rtol=1e-5)
    np.testing.assert_allclose(M.hg_sample(_t(wo), _t(g), _t(xi)).numpy(),
                               np.asarray(jax.jit(jmat.hg_sample)(_j(wo), _j(g), _j(xi))),
                               rtol=0, atol=1e-5)
