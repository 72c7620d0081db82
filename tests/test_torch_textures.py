"""The port's image textures, sky bake and env-map sampler against the JAX
package (zyg_tpu/scene/textures.py, sky.py, env_sampling.py, io/png.py,
io/rgbe.py, core/spectrum.py):

- the texture arena array-equal, for float, one-channel and uint8 images
  under wrap and clamp addressing;
- sample_bilinear / sample_stochastic on seeded uv spanning [-2, 3)
  (negative texel indices wrap from the end): exact values;
- bake_sky array-equal; the env alias table array-equal;
- env sample: uv exact, directions within 1e-6; its pdf within 1e-5
  relative where sin(theta) > 0.2 and 1e-4 near the poles, where torch and
  XLA round cos(theta) apart by an ulp and 1 - cos^2 amplifies it; env pdf
  of random directions within 1e-5 relative where the texel index agrees
  (off texel edges);
- read_png on 8/16-bit grey, grey-alpha, RGB, RGBA and palette files (both
  packages' writers and the test's own encoder, every filter type) and
  read_hdr on flat and run-length scanlines: the pixels exactly, as the
  JAX readers return them; the sRGB decode exactly;
- the arena over sRGB and linear images of every pixel type, address mode
  and texcoord, with two analytic procedurals: every column equal and the
  procedural specs equal; _select_uv and _analytic_override, and both
  samplers with procedurals, alternate uv and (or not) a footprint: exact,
  but within 1e-6 on the noise's lanes and under a footprint
  (test_torch_procedural.py).
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


# ---------------------------------------------------------------------------
# image files, sRGB, address and texcoord columns, procedurals in the arena
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_bytes(rows: np.ndarray, bitdepth: int, color_type: int, palette=None) -> bytes:
    """A PNG of raw scanline bytes rows [H, stride] (uint8), the five filter
    types in turn by row: the test's own encoder for what neither
    package's writer makes (16 bits, grey-alpha, palettes, filters)."""
    import struct
    import zlib

    h, stride = rows.shape
    bpp = max(bitdepth // 8, 1) * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    w = stride // bpp
    prev = np.zeros(stride, np.int32)
    out = b""
    for y in range(h):
        cur = rows[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = y % 5
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][ft]
        out += bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth, color_type, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b"")


def test_read_png_matches_jax(tmp_path):
    """Both packages' writers (8-bit grey, RGB, RGBA) and the test's encoder
    (16-bit grey/RGB/RGBA, 8- and 16-bit grey-alpha, palette; every filter
    type): the port's read_png returns the written pixels exactly, as the
    JAX reader does."""
    from zyg_tpu.io import png as jpng
    from zyg_tpu_torch.io import png as tpng

    rng = np.random.default_rng(7)
    cases = []
    for c in (1, 3, 4):
        img = (rng.random((11, 13, c)) * 256).astype(np.uint8)
        for name, writer in (("jax", jpng.write_png), ("port", tpng.write_png)):
            path = str(tmp_path / f"{name}{c}.png")
            writer(path, img[..., 0] if c == 1 else img)
            cases.append((path, img))
    for bitdepth, color_type, c in ((16, 0, 1), (16, 2, 3), (16, 6, 4), (8, 4, 2), (16, 4, 2)):
        dtype = np.uint16 if bitdepth == 16 else np.uint8
        img = (rng.random((9, 14, c)) * (65536 if bitdepth == 16 else 256)).astype(dtype)
        rows = img.astype(">u2" if bitdepth == 16 else np.uint8).view(np.uint8).reshape(9, -1)
        path = tmp_path / f"b{bitdepth}c{color_type}.png"
        path.write_bytes(_png_bytes(rows, bitdepth, color_type))
        cases.append((str(path), img))
    palette = (rng.random((7, 3)) * 256).astype(np.uint8)
    idx = rng.integers(0, 7, (10, 12)).astype(np.uint8)
    path = tmp_path / "palette.png"
    path.write_bytes(_png_bytes(idx, 8, 3, palette))
    cases.append((str(path), palette[idx]))
    for path, img in cases:
        got, ref = tpng.read_png(path), jpng.read_png(path)
        assert got.dtype == ref.dtype == img.dtype, path
        np.testing.assert_array_equal(got, img.reshape(got.shape), err_msg=path)
        np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("width", [5, 40])
def test_read_hdr_matches_jax(tmp_path, width):
    """A Radiance file by the JAX writer (flat scanlines under 8 texels
    wide, run-length encoded ones at 40) decodes exactly as the JAX reader
    decodes it, within the shared exponent's precision of the source."""
    from zyg_tpu.io.rgbe import read_hdr as jread, write_hdr
    from zyg_tpu_torch.io.rgbe import read_hdr

    rng = np.random.default_rng(8)
    img = (rng.random((6, width, 3)) * np.array([20.0, 1.0, 0.05])).astype(np.float32)
    img[2, :] = 3.0  # runs for the encoder
    img[3, 1] = 0.0
    path = str(tmp_path / "env.hdr")
    write_hdr(path, img)
    got, ref = read_hdr(path), jread(path)
    assert got.dtype == ref.dtype and got.shape == (6, width, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, img, rtol=2 ** -7, atol=1e-30 + img.max() * 2 ** -7)


def test_srgb_decode_matches_jax():
    from zyg_tpu.core.spectrum import srgb_to_linear_np as jdecode
    from zyg_tpu_torch.core.spectrum import srgb_to_linear_np

    c = np.concatenate([np.linspace(0, 1, 4097, dtype=np.float32),
                        np.arange(256, dtype=np.float32) / 255.0])
    a, b = jdecode(c), srgb_to_linear_np(c)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _builders(jt, tt):
    """Both packages' arenas over sRGB and linear images of every pixel
    type, under every address mode and texcoord, with two analytic
    procedurals (their 16^2 fallback bakes) among them."""
    from zyg_tpu.scene import procedural as jp

    rng = np.random.default_rng(9)
    imgs = [(rng.random((7, 9, 3)) * 255).astype(np.uint8),
            (rng.random((5, 6, 4)) * 65535).astype(np.uint16),
            rng.random((8, 3)).astype(np.float32),
            (rng.random((4, 4, 2)) * 255).astype(np.uint8)]
    nodes = [{"Checker": {"scale": 3, "colors": [[0.9, 0.2, 0.1], [0.1, 0.3, 0.8]]}},
             {"Noise": {"levels": 2, "scale": [4, 4]}}]
    out = []
    for mod in (jt, tt):
        b = mod.TextureBuilder()
        for i, im in enumerate(imgs):
            b.add(im, srgb=i % 2 == 0, clamp_u=i in (1, 3), clamp_v=i in (2, 3), texcoord=i % 3)
            if i < 2:
                tid = b.add(jp.bake(nodes[i], res=16))
                b.add_procedural_meta(tid, jp.analytic_spec(nodes[i]))
        out.append(b.build())
    return out


def test_arena_with_srgb_address_texcoord_matches_jax():
    from zyg_tpu.scene import textures as jt
    from zyg_tpu_torch.scene import textures as tt

    ja, ta = _builders(jt, tt)
    for k in ("data", "offset", "width", "height", "address", "texcoord"):
        a, b = np.asarray(getattr(ja, k)), getattr(ta, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert list(ja.procedurals) == list(ta.procedurals)
    assert [p[0] for p in ta.procedurals] == [1, 3]
    assert ta.to("cpu").procedurals is ta.procedurals  # static host data
    with pytest.raises(ValueError, match="already an analytic procedural"):
        b = tt.TextureBuilder()
        b.add(np.ones((2, 2), np.float32))
        b.add_procedural_meta(0, ("checker", (1.0, (0.0,) * 3, (1.0,) * 3)))
        b.add_procedural_meta(0, ("checker", (2.0, (0.0,) * 3, (1.0,) * 3)))


def _hold(got, ref, tid, footprint=False):
    """Exact, but within 1e-6 on the lanes of the analytic noise (texture
    3; torch and XLA round its cos and sin an ulp apart) and everywhere a
    footprint fades the octaves (test_torch_procedural.py)."""
    got, ref = got.numpy(), np.asarray(ref)
    near = np.ones_like(tid, bool) if footprint else tid == 3
    np.testing.assert_array_equal(got[~near], ref[~near])
    np.testing.assert_allclose(got[near], ref[near], rtol=0, atol=1e-6)


def test_select_uv_and_analytic_override_match_jax():
    from zyg_tpu.scene import textures as jt
    from zyg_tpu_torch.scene import textures as tt

    ja, ta = _builders(jt, tt)
    tid, uv, _ = _lookups(n=8000, seed=10)
    tid = np.random.default_rng(11).integers(-1, 6, tid.shape[0]).astype(np.int32)
    alt = np.random.default_rng(12).uniform(-2, 3, uv.shape).astype(np.float32)
    t = torch.from_numpy
    ref = np.asarray(jt._select_uv(ja, jnp.maximum(tid, 0), jnp.asarray(uv), jnp.asarray(alt)))
    got = tt._select_uv(ta, t(tid).clamp(min=0).long(), t(uv), t(alt))
    np.testing.assert_array_equal(ref, got.numpy())
    tuv = t(uv)
    assert tt._select_uv(ta, t(tid).clamp(min=0).long(), tuv, None) is tuv  # no alternate set
    base = np.random.default_rng(13).random((8000, 4)).astype(np.float32)
    ref = jax.jit(lambda i, u, o: jt._analytic_override(ja, i, u, o, None))(tid, uv, base)
    got = tt._analytic_override(ta, t(tid), t(uv), t(base), None)
    _hold(got, ref, tid)
    on = np.isin(tid, [1, 3])
    assert on.any() and (got.numpy()[~on] == base[~on]).all()


@pytest.mark.parametrize("footprint", [False, True])
@pytest.mark.parametrize("sampler", ["bilinear", "stochastic"])
def test_sampling_with_procedurals_and_uv_alt_matches_jax(sampler, footprint):
    """Both samplers over the arena with procedurals, alternate uv and
    (or not) a footprint, held by _hold."""
    from zyg_tpu.scene import textures as jt
    from zyg_tpu_torch.scene import textures as tt

    ja, ta = _builders(jt, tt)
    _, uv, xi = _lookups(n=8000, seed=14)
    rng = np.random.default_rng(15)
    tid = rng.integers(-1, 6, 8000).astype(np.int32)
    alt = rng.uniform(-2, 3, uv.shape).astype(np.float32)
    foot = rng.uniform(0, 0.2, 8000).astype(np.float32) if footprint else None
    t = torch.from_numpy
    tf = None if foot is None else t(foot)
    if sampler == "bilinear":
        ref = jax.jit(lambda i, u, a, f: jt.sample_bilinear(ja, i, u, uv_alt=a, footprint=f))(
            tid, uv, alt, foot)
        got = tt.sample_bilinear(ta, t(tid), t(uv), uv_alt=t(alt), footprint=tf)
    else:
        ref = jax.jit(lambda i, u, x, a, f: jt.sample_stochastic(ja, i, u, x, uv_alt=a,
                                                                 footprint=f))(
            tid, uv, xi, alt, foot)
        got = tt.sample_stochastic(ta, t(tid), t(uv), t(xi), uv_alt=t(alt), footprint=tf)
    _hold(got, ref, tid, footprint)
