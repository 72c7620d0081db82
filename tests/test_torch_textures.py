"""The port's image textures, sky bake and env-map sampler against the JAX
package (zyg_tpu/scene/textures.py, sky.py, env_sampling.py):

- the texture arena array-equal, for float, one-channel and uint8 images
  under wrap and clamp addressing;
- sample_bilinear / sample_stochastic on seeded uv spanning [-2, 3)
  (negative texel indices wrap from the end): exact values;
- bake_sky array-equal; the env alias table array-equal;
- env sample: uv exact, directions within 1e-6; its pdf within 1e-5
  relative where sin(theta) > 0.2 and 1e-4 near the poles, where torch and
  XLA round cos(theta) apart by an ulp and 1 - cos^2 amplifies it; env pdf
  of random directions within 1e-5 relative where the texel index agrees
  (off texel edges).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

SUN = np.array([0.35, -0.65, 0.4], np.float32) / np.linalg.norm([0.35, -0.65, 0.4])


@pytest.fixture(scope="module")
def arenas():
    from zyg_tpu.scene import textures as jt
    from zyg_tpu_torch.scene import textures as tt

    rng = np.random.default_rng(0)
    imgs = [rng.random((13, 17, 3)).astype(np.float32), rng.random((8, 5)).astype(np.float32),
            (rng.random((6, 9, 4)) * 255).astype(np.uint8)]
    jb, tb = jt.TextureBuilder(), tt.TextureBuilder()
    for i, im in enumerate(imgs):
        jb.add(im, clamp_u=i == 1, clamp_v=i == 2)
        tb.add(im, clamp_u=i == 1, clamp_v=i == 2)
    return jb.build(), tb.build()


def test_texture_arena_matches_jax(arenas):
    ja, ta = arenas
    for k in ("data", "offset", "width", "height", "address"):
        a, b = np.asarray(getattr(ja, k)), getattr(ta, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _lookups(n=20000, seed=1):
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    xi = rng.random((n, 2)).astype(np.float32)
    return tid, uv, xi


@pytest.mark.parametrize("sampler", ["bilinear", "stochastic"])
def test_texture_sampling_matches_jax(arenas, sampler):
    from zyg_tpu.scene import textures as jt
    from zyg_tpu_torch.scene import textures as tt

    ja, ta = arenas
    tid, uv, xi = _lookups()
    if sampler == "bilinear":
        ref = jax.jit(jt.sample_bilinear)(ja, jnp.asarray(tid), jnp.asarray(uv))
        got = tt.sample_bilinear(ta, torch.from_numpy(tid), torch.from_numpy(uv))
    else:
        ref = jax.jit(jt.sample_stochastic)(ja, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(xi))
        got = tt.sample_stochastic(ta, torch.from_numpy(tid), torch.from_numpy(uv),
                                   torch.from_numpy(xi))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("size", [(32, 16), (256, 128), (600, 300)])
def test_bake_sky_matches_jax(size):
    from zyg_tpu.scene.sky import bake_sky as jbake
    from zyg_tpu_torch.scene.sky import bake_sky as tbake

    w, h = size
    a = jbake(SUN, turbidity=2.8, width=w, height=h)
    b = tbake(SUN, turbidity=2.8, width=w, height=h)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def envs():
    """The bench dome's 256x128 sky as both packages' env samplers, plus a
    second 600x300 entry (proxy downsampled and resampled)."""
    from zyg_tpu.scene import env_sampling as je
    from zyg_tpu.scene.sky import bake_sky
    from zyg_tpu_torch.scene import env_sampling as te

    def rgba(w, h):
        img = bake_sky(SUN, turbidity=2.8, width=w, height=h)
        return np.concatenate([img, np.zeros_like(img[..., :1])], -1)

    entries = [(rgba(256, 128), False, 0), (rgba(600, 300), False, 3)]
    return je.build_env_sampler(entries), te.build_env_sampler(entries)


def test_env_table_matches_jax(envs):
    jenv, tenv = envs
    assert (jenv.width, jenv.height) == (tenv.width, tenv.height) == (256, 128)
    for k in ("table", "light"):
        a, b = np.asarray(getattr(jenv, k)), getattr(tenv, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _rotations(n, seed):
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees

    rng = np.random.default_rng(seed)
    rots = np.stack([rotation_matrix_from_euler_degrees(a) for a in rng.uniform(-180, 180, (4, 3))])
    return rots[rng.integers(0, 4, n)].astype(np.float32)


def test_env_sample_matches_jax(envs):
    from zyg_tpu.scene import env_sampling as je
    from zyg_tpu_torch.scene import env_sampling as te

    jenv, tenv = envs
    n = 40000
    rng = np.random.default_rng(2)
    xi = rng.random((n, 2)).astype(np.float32)
    ent = rng.integers(0, 2, n).astype(np.int32)
    rot = _rotations(n, 3)
    jw, jp, juv = (np.asarray(x) for x in jax.jit(je.sample)(
        jenv, jnp.asarray(ent), jnp.asarray(rot), jnp.asarray(xi)))
    tw, tp, tuv = (x.numpy() for x in te.sample(
        tenv, torch.from_numpy(ent), torch.from_numpy(rot), torch.from_numpy(xi)))
    np.testing.assert_array_equal(juv, tuv)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    rel = np.abs(tp - jp) / jp
    off_pole = np.sin(np.pi * juv[:, 1]) > 0.2
    assert rel[off_pole].max() < 1e-5, rel[off_pole].max()
    assert rel.max() < 1e-4, rel.max()


def test_env_pdf_matches_jax(envs):
    from zyg_tpu.scene import env_sampling as je
    from zyg_tpu_torch.scene import env_sampling as te

    jenv, tenv = envs
    n = 40000
    rng = np.random.default_rng(4)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    li = rng.choice(np.array([-1, 0, 1, 3], np.int32), n)
    rot = _rotations(n, 5)
    ref = np.asarray(jax.jit(je.pdf)(jenv, jnp.asarray(li), jnp.asarray(rot), jnp.asarray(d)))
    got = te.pdf(tenv, torch.from_numpy(li), torch.from_numpy(rot), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(ref == 0.0, got == 0.0)  # lights without an entry
    # off texel edges: the lanes whose texel index agrees (the uv of both
    # packages lands in the same texel)
    uv = te.dome_uv(torch.nn.functional.normalize(torch.einsum(
        "nij,nj->ni", torch.from_numpy(rot), torch.from_numpy(d)), dim=1)).numpy()
    tx, ty = uv[:, 0] * 256, uv[:, 1] * 128
    off_edge = (np.abs(tx - np.round(tx)) > 1e-3) & (np.abs(ty - np.round(ty)) > 1e-3)
    on = (ref > 0) & off_edge
    assert on.mean() > 0.4  # half the lanes ask for a light with an entry
    np.testing.assert_allclose(got[on], ref[on], rtol=1e-5)
