"""The textured slice as a whole: test_shade_kernel.py's textured_env_scene
(the 48x32 trefoil with checker albedo and noise roughness textures over a
grey ground, under a baked 32x16 Preetham sky on a Dome light), built
through each package's own SceneBuilder from the same numpy recipes, with
bench.py's textured camera (bench_mesh_textured), rendered by the port's
Driver (plain torch versions, CPU) and the JAX Driver (CPU) at 64x64, 8 spp,
PTMIS depth 4, and judged by the golden gate: mean energy within 1.5 %,
4x4-downsampled RMSE within 6 % of the mean; rays within 1e-3 and
wavefront iterations within 2. The two builders' scene arrays (texture
arena, material texture ids, env alias table) are array-equal.
"""

import numpy as np
import pytest
import torch

from test_torch_surface_v2 import jax_scene, textured_env_scene  # noqa: F401

torch.set_num_threads(2)

RES = (64, 64)
SPP = 8


def _camera(camera_cls):
    cam = camera_cls(resolution=RES, fov=np.deg2rad(50))
    cam.position = np.array([0, 0.8, -5.5], np.float32)
    return cam


@pytest.fixture(scope="module")
def port_scene():
    import zyg_tpu_torch.scene.loader as tl
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.sky import bake_sky
    from zyg_tpu_torch.scene.types import ShapeType

    return textured_env_scene(tl, trimesh, bake_sky, ShapeType)


def test_port_builder_matches_jax_arrays(jax_scene, port_scene):  # noqa: F811
    from zyg_tpu_torch.scene.loader import scene_arrays

    a, b = scene_arrays(jax_scene), scene_arrays(port_scene)
    assert sorted(a) == sorted(b)
    assert {"textures.data", "env.table", "materials.color_tex"} <= set(a)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_render(jax_scene):  # noqa: F811
    from zyg_tpu.io.take import IntegratorSettings, Take
    from zyg_tpu.render.camera import PerspectiveCamera
    from zyg_tpu.render.driver import Driver

    take = Take()
    take.num_samples_per_pixel = SPP
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    take.cameras = [_camera(PerspectiveCamera)]
    d = Driver(take=take, scene=jax_scene)
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


@pytest.fixture(scope="module")
def port_render(port_scene):
    from zyg_tpu_torch.io.take import IntegratorSettings, Take
    from zyg_tpu_torch.render.camera import PerspectiveCamera
    from zyg_tpu_torch.render.driver import Driver

    take = Take()
    take.num_samples_per_pixel = SPP
    take.integrator = IntegratorSettings(kind="PTMIS", max_depth_surface=4)
    take.cameras = [_camera(PerspectiveCamera)]
    d = Driver(take, port_scene, device="cpu")
    img = d.render_frame()
    return img, d.rays_traced, d.last_iterations


def test_port_textured_render_matches_jax_at_golden_gate(jax_render, port_render):
    from zyg_tpu.tools.it import op_downsample

    ref, img = jax_render[0], port_render[0]
    assert img.shape == ref.shape == (RES[1], RES[0], 3)
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06


def test_port_textured_render_traces_the_same_wavefront(jax_render, port_render):
    _, jrays, jiters = jax_render
    _, rays, iters = port_render
    assert abs(rays - jrays) <= 1e-3 * jrays
    assert abs(iters - jiters) <= 2
