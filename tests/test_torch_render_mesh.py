"""The mesh slice as a whole: the port's Driver (plain torch versions, CPU)
against the JAX Driver (CPU) on tests/golden_configs.py's mesh_trefoil
scene (the 30,720-triangle trefoil under one rectangle light, PTMIS depth
4), built through both packages' SceneBuilders, at 64x64 and 8 spp, judged
by the golden gate: mean energy within 1.5 %, 4x4-downsampled RMSE within
6 % of the mean; rays within 1e-3 and wavefront iterations within 2. Also
the CLI on examples/takes/trefoil.take."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

RES = (64, 64)
SPP = 8


@pytest.fixture(scope="module")
def jax_render():
    import golden_configs
    from zyg_tpu.render.driver import Driver

    take, scene = golden_configs.mesh_trefoil()
    take.cameras[0].resolution = RES
    take.num_samples_per_pixel = SPP
    d = Driver(take=take, scene=scene)
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


@pytest.fixture(scope="module")
def port_render():
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import MaterialDesc, PropDesc, SceneBuilder, Transformation
    from zyg_tpu_torch.scene.types import ShapeType

    # golden_configs.mesh_trefoil, through the port's SceneBuilder
    b = SceneBuilder()
    grey = b.add_material(MaterialDesc(color=np.full(3, 0.6, np.float32), roughness=0.5))
    lightm = b.add_material(MaterialDesc(kind=2, emission=np.full(3, 30.0, np.float32)))
    mid = b.add_mesh(trimesh.make_trefoil_mesh(128, 120))
    b.add_mesh_prop(mid, Transformation(scale=np.full(3, 0.35, np.float32)), grey)
    rot_down = np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]], np.float32)
    b.add_prop(PropDesc(
        shape=int(ShapeType.RECTANGLE),
        trafo=Transformation(position=np.array([0, 4.0, 0], np.float32), rotation=rot_down,
                             scale=np.array([3.0, 3.0, 1], np.float32)),
        material=lightm, is_light=True, visible_shadow=False,
    ))
    take = Take()
    take.num_samples_per_pixel = SPP
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    cam = PerspectiveCamera(resolution=RES, fov=np.deg2rad(50))
    cam.position = np.array([0, 0.8, -5.5], np.float32)
    take.cameras = [cam]
    d = Driver(take, b.build(), device="cpu")
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


def test_port_mesh_render_matches_jax_at_golden_gate(jax_render, port_render):
    from zyg_tpu.tools.it import op_downsample

    ref, img = jax_render[0], port_render[0]
    assert img.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06


def test_port_mesh_render_traces_the_same_wavefront(jax_render, port_render):
    _, jrays, jiters = jax_render
    _, rays, iters = port_render
    assert abs(rays - jrays) <= 1e-3 * jrays
    assert abs(iters - jiters) <= 2


def test_cli_renders_trefoil_take(tmp_path):
    from zyg_tpu.io.png import read_png
    from zyg_tpu_torch import cli

    with open("examples/takes/trefoil.take") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath("examples/scenes/trefoil.scene")
    take["camera"]["Perspective"]["resolution"] = [32, 18]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "small.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu", "-s"]) == 0
    img = read_png(str(out))
    assert img.shape == (18, 32, 3)
    assert img.mean() > 1
