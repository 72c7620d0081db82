"""The port's Driver dispatches samples as the JAX Driver does: the chunk
size (8 samples for a mesh scene, 16 for an analytic one) and the plan of
(samples, oversample slack) chunks that zyg_tpu/render/driver.py:505-515
walks for a shuffled persistent frame. The lane->pixel shuffle and the
final chunk's slack follow that plan, so above 8 spp on a mesh scene a
different plan gives every pixel a different sample set: the render case
holds the per-pixel sample counts exactly equal on
tests/golden_configs.py's mesh_trefoil at 16x16 and 32 spp."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
SPPS = [4, 8, 16, 32, 64]


def _jax_plan(driver, num: int) -> list[tuple[int, int]]:
    """The (samples, slack) chunks of zyg_tpu/render/driver.py:505-515."""
    plan = []
    done = 0
    while done < num:
        n = min(driver.chunk_size, num - done)
        slack = max(2, n // 2) if (driver._frame_width > 0 and done + n >= num) else 0
        plan.append((n, slack))
        done += n
    return plan


def _drivers(scene_name: str, spp: int, res):
    """(JAX Driver, port Driver) of one scene at res and spp, not rendered."""
    import chip_smoke
    import golden_configs
    from zyg_tpu.render.driver import Driver as JaxDriver
    from zyg_tpu_torch.render.driver import Driver

    if scene_name == "mesh_trefoil":
        take, scene = golden_configs.mesh_trefoil()
        take.cameras[0].resolution = res
        take.num_samples_per_pixel = spp
        ptake, pscene = chip_smoke._ci_trefoil(res, spp)
    else:
        take, scene = golden_configs._take_file("cornell_ptmis.take", res, spp)
        ptake = chip_smoke._take("cornell_ptmis.take", res, spp)
        from zyg_tpu_torch.scene.loader import load_scene_file

        pscene = load_scene_file(ptake.scene_filename)
    return JaxDriver(take=take, scene=scene), Driver(ptake, pscene, device="cpu")


@pytest.mark.parametrize("scene_name", ["mesh_trefoil", "cornell"])
@pytest.mark.parametrize("spp", SPPS)
def test_chunk_plan_matches_jax(scene_name, spp):
    jd, pd = _drivers(scene_name, spp, (16, 16) if scene_name == "mesh_trefoil" else (64, 64))
    assert jd._frame_width > 0  # a shuffled persistent frame
    assert pd.chunk_size == jd.chunk_size == min(spp, 8 if scene_name == "mesh_trefoil" else 16)
    assert pd.chunk_plan(spp) == _jax_plan(jd, spp)


def test_mesh_render_weights_match_jax_above_one_chunk():
    """32 spp on the mesh trefoil (four chunks of 8, the last with slack 4):
    every pixel's sample count equal to the JAX render's, rays within 1e-3."""
    jd, pd = _drivers("mesh_trefoil", 32, (16, 16))
    jd.render_frame()
    pd.render_frame()
    jw = np.asarray(jd._fb.weight).reshape(-1)
    pw = pd._fb.weight.numpy().reshape(-1)
    assert np.array_equal(pw, jw), f"{int((pw != jw).sum())} of {jw.size} pixel weights differ"
    assert abs(pd.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced
