"""The slice as a whole: the port's Driver (plain torch versions, CPU)
against the JAX Driver (CPU) on examples/takes/cornell_ptmis.take at
64x64 and 16 spp, judged by the golden gate's statistics
(tests/test_goldens.py): mean energy within 1.5%, 4x4-downsampled RMSE
within 6% of the mean. Both follow the same seeding law and Sobol'
streams, so the two images are far closer than that (paths part only
where float rounding flips a decision). The same gate holds the PTDL take
(cornell_ptdl.take, 64x64, 16 spp). Also: the drain cascade, the CLI, and
that the port never imports jax (rendering Cornell, a mesh and
material_test through the general body)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/cornell_ptmis.take"
RES = (64, 64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_driver():
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = load_take_file(TAKE)
    take.cameras[0].resolution = RES
    return Driver(take, load_scene_file(take.scene_filename), device="cpu")


@pytest.fixture(scope="module")
def jax_render():
    from zyg_tpu.io.take import load_take_file
    from zyg_tpu.render.driver import Driver
    from zyg_tpu.scene.loader import load_scene_file

    take = load_take_file(TAKE)
    take.cameras[0].resolution = RES
    d = Driver(take=take, scene=load_scene_file(take.scene_filename))
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


@pytest.fixture(scope="module")
def port_render():
    d = _port_driver()
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


def test_port_matches_jax_at_golden_gate(jax_render, port_render):
    from zyg_tpu.tools.it import op_downsample

    ref, img = jax_render[0], port_render[0]
    assert img.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06


def test_port_traces_the_same_wavefront(jax_render, port_render):
    """Same rays (to float-flip noise) and the same loop length."""
    _, jrays, jiters = jax_render
    _, rays, iters = port_render
    assert abs(rays - jrays) <= 1e-3 * jrays
    assert abs(iters - jiters) <= 2


def test_drain_cascade_matches_full_width(monkeypatch, port_render):
    """With the drain stage width lowered, survivors finish in compacted
    states; every sample still lands on its pixel exactly once (the
    per-pixel sample counts are exact). Radiance is held statistically:
    torch's CPU transcendentals may round a lane differently at another
    width or thread split, and a path parts from there."""
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.render.integrator import ptmis

    full = _port_driver()
    full.render_frame()
    monkeypatch.setattr(ptmis, "_DRAIN_MIN", 64)  # 4096 lanes -> 1024/256/64
    d = _port_driver()
    img = d.render_frame()
    torch.testing.assert_close(d._fb.weight, full._fb.weight, rtol=0, atol=0)
    ref, rays, _ = port_render
    assert abs(d.rays_traced - rays) <= 1e-3 * rays
    scale = float(ref.mean())
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06


def test_ptdl_render_matches_jax_at_golden_gate():
    """examples/takes/cornell_ptdl.take (PTDL: NEE only, no MIS weight on
    BSDF light hits) at 64x64 and its own 16 spp through both Drivers, by
    the same gate, rays and loop length."""
    from zyg_tpu.io.take import load_take_file as jload_take
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.scene.loader import load_scene_file as jload_scene
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io.take import load_take_file
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    path = "examples/takes/cornell_ptdl.take"
    jt = jload_take(path)
    jt.cameras[0].resolution = RES
    jd = JDriver(take=jt, scene=jload_scene(jt.scene_filename))
    ref = jd.render_frame()
    take = load_take_file(path)
    take.cameras[0].resolution = RES
    d = Driver(take, load_scene_file(take.scene_filename), device="cpu")
    assert d.settings.nee_only
    img = d.render_frame()
    assert img.shape == ref.shape == (RES[1], RES[0], 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
    assert abs(d.last_iterations - jd.last_iterations) <= 2


def test_cli_writes_png(tmp_path):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open(TAKE) as f:
        take = json.load(f)
    take["scene"] = os.path.abspath("examples/scenes/cornell.scene")
    take["camera"]["Perspective"]["resolution"] = [32, 32]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "small.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu", "-s"]) == 0
    img = read_png(str(out))
    assert img.shape == (32, 32, 3)
    assert img.mean() > 10


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from zyg_tpu_torch.render.driver import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import zyg_tpu_torch\n"
        "from zyg_tpu_torch.io.take import load_take_file\n"
        "from zyg_tpu_torch.scene.loader import load_scene_file\n"
        "from zyg_tpu_torch.render.driver import Driver\n"
        "from zyg_tpu_torch.render.integrator import ptmis\n"
        "import zyg_tpu_torch.cli, chip_smoke\n"
        f"take = load_take_file({os.path.join(REPO, TAKE)!r})\n"
        "take.cameras[0].resolution = (8, 8)\n"
        "take.num_samples_per_pixel = 1\n"
        "img = Driver(take, load_scene_file(take.scene_filename), device='cpu').render_frame()\n"
        "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
        "import importlib, json, pkgutil\n"
        "for m in pkgutil.walk_packages(zyg_tpu_torch.__path__, 'zyg_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):  # __main__ runs the CLI\n"
        "        importlib.import_module(m.name)\n"
        "from zyg_tpu_torch.scene.loader import load_scene_dict\n"
        f"root = json.load(open({os.path.join(REPO, 'examples/scenes/trefoil.scene')!r}))\n"
        "root['entities'][0]['shape']['file'] = 'proc:trefoil-16x8'\n"
        "img = Driver(take, load_scene_dict(root), device='cpu').render_frame()\n"
        "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
        f"take = load_take_file({os.path.join(REPO, 'examples/takes/material_test.take')!r})\n"
        "take.cameras[0].resolution = (8, 8)\n"
        "take.num_samples_per_pixel = 2\n"
        "d = Driver(take, load_scene_file(take.scene_filename), device='cpu')\n"
        "from zyg_tpu_torch.render.integrator import ptmis_general, volume\n"
        "assert isinstance(ptmis._make_body(d.scene, d.settings), ptmis_general.GeneralBody)\n"
        "img = d.render_frame()\n"
        "assert img.shape == (8, 8, 3) and img.mean() > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zyg_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
