"""The port's image writers and readers, take settings, CLI outputs and the
example takes that load, against the JAX package:

- `write_exr` byte for byte equal to zyg_tpu.io.exr.write_exr, HALF and
  FLOAT, ZIP and no compression, RGB(A) and a one-channel plane;
- `read_exr` equal to the JAX reader's on JAX-written files and on every
  tests/goldens/*.exr;
- `write_hdr` byte for byte equal (RLE scanlines, and flat ones below 8
  pixels of width);
- the Driver's `export_frame` to .png (RGBA with alpha_transparency),
  .exr and .hdr, with the AOV companion files, byte for byte equal to the
  JAX Driver's export of the same framebuffer and planes;
- a `.exr` image through `load_image` and as a texture of a scene file;
- the five takes of the integrator and sensor slice parse to the JAX
  Take's settings;
- the CLI (`--device cpu`) on 16x16 copies of the five takes, its default
  output name, its .exr/.hdr outputs and companion files read back;
- all 22 example takes load through `load_take_file`, `load_scene_file`
  and `Driver(device="cpu")`, none refused (sparks' point cloud and
  hairball's .hair strands included).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAKES = os.path.join(REPO, "examples/takes")
SLICE = ["cornell", "cornell_filtered", "cornell_ao", "cornell_aov_normals", "cornell_aovs"]


def _image(rng, h, w, c):
    img = rng.exponential(0.6, (h, w, c)).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 70000.0  # beyond half's range
    img[1, :4] = np.array([1e-8, 3e-5, 0.5, 1.0], np.float32)[:, None]
    return img


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("compression", [0, 3], ids=["none", "zip"])
@pytest.mark.parametrize("names", [("R", "G", "B"), ("A", "B", "G", "R"), ("Y",)],
                         ids=["rgb", "rgba", "y"])
def test_write_exr_bytes_equal_jax(tmp_path, half, compression, names):
    from zyg_tpu.io import exr as jexr
    from zyg_tpu_torch.io import exr

    img = _image(np.random.default_rng(len(names) + compression), 37, 21, len(names))
    ch = {n: img[..., i] for i, n in enumerate(names)}
    with np.errstate(over="ignore"):  # 70000 is beyond half's range: inf, as in the JAX writer
        exr.write_exr(str(tmp_path / "p.exr"), ch, half=half, compression=compression)
        jexr.write_exr(str(tmp_path / "j.exr"), ch, half=half, compression=compression)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    out = exr.read_exr(str(tmp_path / "j.exr"))
    ref = jexr.read_exr(str(tmp_path / "j.exr"))
    assert sorted(out) == sorted(ref) == sorted(names)
    for n in names:
        np.testing.assert_array_equal(out[n], ref[n])
        if not half:
            np.testing.assert_array_equal(out[n], ch[n])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "tests/goldens/*.exr"))),
                         ids=os.path.basename)
def test_read_exr_equal_jax_on_goldens(path):
    from zyg_tpu.io.exr import read_exr as jread
    from zyg_tpu_torch.io.exr import read_exr

    out, ref = read_exr(path), jread(path)
    assert sorted(out) == sorted(ref)
    for n in ref:
        np.testing.assert_array_equal(out[n], ref[n])
        assert np.isfinite(out[n]).all()


@pytest.mark.parametrize("w", [5, 64], ids=["flat", "rle"])
def test_write_hdr_bytes_equal_jax(tmp_path, w):
    from zyg_tpu.io.rgbe import write_hdr as jwrite
    from zyg_tpu_torch.io.rgbe import read_hdr, write_hdr

    img = _image(np.random.default_rng(w), 9, w, 3)
    img[3, 10 % w:] = 0.25  # runs for the RLE
    write_hdr(str(tmp_path / "p.hdr"), img)
    jwrite(str(tmp_path / "j.hdr"), img)
    assert (tmp_path / "p.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = read_hdr(str(tmp_path / "p.hdr"))
    assert back.shape == img.shape
    # 8 bits of mantissa shared by the pixel's largest channel
    assert (np.abs(back - img) <= img.max(axis=-1, keepdims=True) / 64 + 1e-6).all()


def _drivers(take_name, res, alpha):
    """(JAX Driver, port Driver) of a take, not rendered, their framebuffers
    and AOV planes set to the same seeded values."""
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu.render.sensor import Framebuffer as JaxFramebuffer
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.render.sensor import Framebuffer
    from zyg_tpu_torch.scene.loader import load_scene_file

    path = os.path.join(TAKES, take_name + ".take")
    jt, pt = jload_take(path), load_take_file(path)
    for t in (jt, pt):
        t.cameras[0].resolution = res
        t.sensor.alpha_transparency = alpha
    jd = JaxDriver(take=jt, scene=jload_scene(jt.scene_filename), use_mesh=False)
    pd = Driver(pt, load_scene_file(pt.scene_filename), device="cpu")
    assert pd.aov_names == jd._aov_names
    rng = np.random.default_rng(21)
    n = res[0] * res[1]
    value = rng.exponential(1.0, (n, 3)).astype(np.float32)
    weight = rng.integers(0, 9, n).astype(np.float32)
    jd._fb = JaxFramebuffer(jnp.asarray(value), jnp.asarray(weight))
    pd._fb = Framebuffer(torch.from_numpy(value), torch.from_numpy(weight))
    for name in pd.aov_names:
        plane = rng.random(tuple(pd._aov[name].shape)).astype(np.float32) * 8.0
        if name in ("albedo", "alpha"):
            plane = np.minimum(plane, weight[:, None])
        jd._aov[name] = jnp.asarray(plane)
        pd._aov[name] = torch.from_numpy(plane)
    return jd, pd


@pytest.mark.parametrize("take_name,alpha", [("cornell_aovs", True), ("cornell_aovs", False),
                                             ("cornell_ptmis", True)])
def test_export_frame_bytes_equal_jax(tmp_path, take_name, alpha):
    jd, pd = _drivers(take_name, (24, 16), alpha)
    for ext in ("png", "exr", "hdr"):
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "p").mkdir(exist_ok=True)
        jd.export_frame(str(tmp_path / "j" / f"out.{ext}"))
        pd.export_frame(str(tmp_path / "p" / f"out.{ext}"))
    jfiles = sorted(os.listdir(tmp_path / "j"))
    assert jfiles == sorted(os.listdir(tmp_path / "p"))
    assert len(jfiles) == 3 + (3 if take_name == "cornell_aovs" else 0)
    for f in jfiles:
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    if alpha:
        from zyg_tpu_torch.io.png import read_png

        assert read_png(str(tmp_path / "p" / "out.png")).shape == (16, 24, 4)
    for name in pd.aov_names:
        if name != "alpha":
            np.testing.assert_array_equal(pd.resolve_aov(name), jd.resolve_aov(name))


def test_export_refuses_other_extensions(tmp_path):
    _, pd = _drivers("cornell_ptmis", (8, 8), False)
    with pytest.raises(ValueError, match=r"\.png, \.exr and \.hdr"):
        pd.export_frame(str(tmp_path / "out.jpg"))


def test_exr_image_through_load_image_and_a_scene_file(tmp_path):
    from zyg_tpu.scene.loader import load_image as jload_image
    from zyg_tpu_torch.io.exr import write_exr
    from zyg_tpu_torch.io.take import load_take_dict
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_image, load_scene_file

    img = np.random.default_rng(4).random((8, 12, 3)).astype(np.float32)
    write_exr(str(tmp_path / "t.exr"), {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]},
              half=False)
    write_exr(str(tmp_path / "y.exr"), {"Y": img[..., 0]})
    for name in ("t.exr", "y.exr"):
        out, ref = load_image(str(tmp_path / name)), jload_image(str(tmp_path / name))
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(load_image(str(tmp_path / "t.exr")), img)
    scene = {
        "materials": [
            {"name": "tex", "rendering": {"Substitute": {"color": {"file": "t.exr"},
                                                         "roughness": 0.7}}},
            {"name": "light", "rendering": {"Light": {"emittance": {"value": 4.0}}}}],
        "entities": [
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["tex"],
             "transformation": {"position": [0, 0, 2]}},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["light"]}]}
    (tmp_path / "s.scene").write_text(json.dumps(scene))
    sc = load_scene_file(str(tmp_path / "s.scene"))
    assert sc.textures is not None
    take = load_take_dict({"camera": {"Perspective": {"resolution": [8, 8]}}})
    frame = Driver(take, sc, device="cpu").render_frame()
    assert np.isfinite(frame).all() and frame.mean() > 0.0


@pytest.mark.parametrize("take_name", SLICE)
def test_slice_takes_parse_to_jax_settings(take_name):
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu_torch.io.take import load_take_file

    path = os.path.join(TAKES, take_name + ".take")
    j, p = jload_take(path), load_take_file(path)
    assert p.num_samples_per_pixel == j.num_samples_per_pixel
    assert p.cameras[0].resolution == j.cameras[0].resolution
    for k in ("kind", "max_depth_surface", "max_depth_volume", "caustics", "bsdf_split",
              "light_split_threshold", "aov_value", "aov_num_samples", "aov_radius"):
        assert getattr(p.integrator, k) == getattr(j.integrator, k), k
    for k in ("filter_radius", "filter_name", "alpha_transparency", "tonemapper", "exposure"):
        assert getattr(p.sensor, k) == getattr(j.sensor, k), k
    for k in ("emission", "direct", "indirect"):
        assert getattr(p.sensor.clamp, k) == getattr(j.sensor.clamp, k), k
    assert p.aovs == j.aovs
    assert [(e.kind, e.format, e.error_diffusion) for e in p.exporters] == \
        [(e.kind, e.format, e.error_diffusion) for e in j.exporters]


def _small_copy(tmp_path, take_name, spp=2):
    path = os.path.join(TAKES, take_name + ".take")
    with open(path) as f:
        body = json.load(f)
    body["scene"] = os.path.normpath(os.path.join(TAKES, body["scene"]))
    body["camera"]["Perspective"]["resolution"] = [16, 16]
    body["sampler"]["Sobol"]["samples_per_pixel"] = spp
    out = tmp_path / f"{take_name}.take"
    out.write_text(json.dumps(body))
    return str(out)


@pytest.mark.parametrize("take_name,ext", [("cornell", ""), ("cornell_filtered", ".hdr"),
                                           ("cornell_ao", ".png"), ("cornell_aov_normals", ".exr"),
                                           ("cornell_aovs", ".exr")])
def test_cli_renders_slice_takes(tmp_path, monkeypatch, capsys, take_name, ext):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.exr import read_exr
    from zyg_tpu_torch.io.png import read_png
    from zyg_tpu_torch.io.rgbe import read_hdr

    take = _small_copy(tmp_path, take_name)
    monkeypatch.chdir(tmp_path)
    args = ["-i", take, "-s", "--device", "cpu"]
    if ext:
        args += ["-o", str(tmp_path / f"out{ext}")]
    assert cli.main(args) == 0
    assert "Mrays/s" in capsys.readouterr().out
    out = tmp_path / (f"out{ext}" if ext else f"{take_name}.png")
    if out.suffix == ".png":
        img = read_png(str(out)).astype(np.float32) / 255.0
    elif out.suffix == ".hdr":
        img = read_hdr(str(out))
    else:
        ch = read_exr(str(out))
        assert sorted(ch) == ["B", "G", "R"]
        img = np.stack([ch["R"], ch["G"], ch["B"]], -1)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0.0
    companions = sorted(p.name for p in tmp_path.glob("out_*.exr"))
    if take_name == "cornell_aovs":
        assert companions == ["out_albedo.exr", "out_depth.exr", "out_shading_normal.exr"]
        depth = read_exr(str(tmp_path / "out_depth.exr"))
        assert sorted(depth) == ["Y"] and depth["Y"].shape == (16, 16)
        assert 1.0 < float(depth["Y"].min()) and float(depth["Y"].max()) < 10.0
        normal = read_exr(str(tmp_path / "out_shading_normal.exr"))
        assert sorted(normal) == ["B", "G", "R"]
    else:
        assert companions == []


def test_cli_refuses_other_output_extensions(tmp_path):
    from zyg_tpu_torch import cli

    with pytest.raises(SystemExit, match=r"\.png, \.exr and \.hdr"):
        cli.main(["-i", os.path.join(TAKES, "cornell.take"), "-o", str(tmp_path / "o.tga"),
                  "--device", "cpu"])


def test_example_takes_load_or_refuse_by_name():
    from zyg_tpu_torch.io.take import UnsupportedTake, load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file
    from zyg_tpu_torch.scene.types import UnsupportedScene

    loaded, refused = [], {}
    for path in sorted(glob.glob(os.path.join(TAKES, "*.take"))):
        name = os.path.basename(path)[:-5]
        try:
            take = load_take_file(path)
            Driver(take, load_scene_file(take.scene_filename), device="cpu")
            loaded.append(name)
        except (UnsupportedTake, UnsupportedScene) as e:
            refused[name] = str(e)
    assert len(loaded) + len(refused) == 22
    assert set(SLICE) | {"forest", "motion", "caustics_photons", "cornell_particles",
                         "hairball", "sparks"} <= set(loaded), loaded
    assert len(loaded) == 22, loaded
    assert refused == {}
