"""The instancer slice: examples/takes/forest.take (an Instancer of 144
proc:sphere instances, a ground Rectangle and a Sky; PTMIS depth 8) and
Instancer entities the tests write, against the JAX package.

- forest.scene's arrays equal the JAX loader's: props, materials, the
  arena, and the 144-row instance table exactly (world boxes, quaternion
  rows, vis).
- An Instancer through a "source" file the test writes (sow's .instancer
  JSON: rotation_matrix and Euler rotations, a scale, the prototype
  without materials, so the entity's), under a transformed parent, with
  an analytic prototype beside it: arrays equal; an unreadable source is
  dropped with a warning by both packages; keys outside the slice are
  refused by name.
- forest at 48x32, 8 spp against the JAX Driver through the golden gate
  (mean within 1.5 %, 4x4 RMSE within 6 % of the mean), rays within 1e-3;
  the CLI renders a small copy of the take.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TAKE = "examples/takes/forest.take"
SCENE = "examples/scenes/forest.scene"


def _same_arrays(jscene, pscene):
    from zyg_tpu_torch.scene.loader import scene_arrays

    a, b = scene_arrays(jscene), scene_arrays(pscene)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        x, y = a[k], b[k]
        if x.dtype == np.float32:  # normal words are bit patterns (NaNs among them)
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=k)
    return b


@pytest.fixture(scope="module")
def forest_scenes():
    from zyg_tpu.scene.loader import load_scene_file as jload
    from zyg_tpu_torch.scene.loader import load_scene_file as tload

    return jload(SCENE), tload(SCENE)


def test_forest_arrays_match_jax(forest_scenes):
    b = _same_arrays(*forest_scenes)
    assert b["mesh_instances.trafo"].shape == (144, 24) and not b["mesh_instances.has_anim"]
    # one proc:sphere mesh shared by all 144 instances
    assert b["meshes.mesh_root"].tolist() == [0]
    assert (b["mesh_instances.trafo"][:, 20] == 0).all()
    np.testing.assert_array_equal(b["mesh_instances.trafo"][:, 21], np.arange(144))
    # the static instance rows repeat the start in the end columns
    np.testing.assert_array_equal(b["mesh_instances.trafo"][:, 10:20],
                                  b["mesh_instances.trafo"][:, 0:10])
    assert sorted(int(k.split(".")[1]) for k in b if k.startswith("prop_groups.")) == [3, 4, 5]


def _written_root(tmp_path, source="trees.instancer"):
    inst = {
        "prototype": {"shape": {"file": "proc:sphere"}},
        "instances": [
            {"position": [1.0, 0.5, 2.0], "rotation": [0, 45, 10], "scale": [1.2, 0.8, 1.0]},
            {"position": [-1.5, 0.4, 0.5],
             "rotation_matrix": [0.0, 0.0, -1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0]},
            {"position": [0.2, 0.3, -1.0], "scale": 0.6},
        ],
    }
    (tmp_path / source).write_text(json.dumps(inst))
    return {
        "materials": [
            {"name": "bark", "rendering": {"Substitute": {"color": [0.35, 0.23, 0.12],
                                                          "roughness": 0.8}}},
            {"name": "rock", "rendering": {"Substitute": {"color": [0.5, 0.5, 0.55]}}},
            {"name": "sky", "rendering": {"Light": {"emittance": {"value": 1.5}}}},
        ],
        "entities": [
            {"type": "Instancer", "source": "trees.instancer", "materials": ["bark"],
             "transformation": {"position": [0, 0.1, 0], "rotation": [0, 20, 0]}},
            {"type": "Instancer", "prototype": {"shape": {"type": "Cube"}, "materials": ["rock"]},
             "instances": [{"position": [2, 0.25, -2], "scale": [0.5, 0.5, 0.5]},
                           {"position": [-2, 0.25, -2], "rotation": [0, 30, 0]}]},
            {"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["rock"],
             "transformation": {"rotation": [90, 0, 0], "scale": [10, 10, 1]}},
            {"type": "Light", "shape": {"type": "Dome"}, "materials": ["sky"]},
        ],
    }


def test_written_instancer_matches_jax(tmp_path):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    root = _written_root(tmp_path)
    b = _same_arrays(jload(root, base_dir=str(tmp_path)), tload(root, base_dir=str(tmp_path)))
    # three mesh instances with the entity's material, two Cubes with the prototype's
    assert b["mesh_instances.trafo"].shape == (3, 24)
    bark = b["prop_material"][b["mesh_instances.trafo"][:, 21].astype(np.int64)]
    assert len(set(bark.tolist())) == 1 and b["materials.color"][bark[0]][0] == np.float32(0.35)
    assert b["prop_groups.1"].size == 2


def test_unreadable_instancer_source_is_dropped_with_a_warning(tmp_path):
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict as tload

    root = _written_root(tmp_path)
    root["entities"][0]["source"] = "missing.instancer"
    js = jload(root, base_dir=str(tmp_path))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ts = tload(root, base_dir=str(tmp_path))
    assert any("instancer load failed" in str(w.message) for w in caught)
    b = _same_arrays(js, ts)
    assert "mesh_instances.trafo" not in b and b["prop_shape"].tolist() == [1, 1, 5, 4]


@pytest.mark.parametrize("entity, match", [
    ({"type": "Instancer", "prototype": {"shape": {"type": "Sphere"}}, "instances": [{}],
      "animation": {}}, r"Instancer keys \['animation'\]"),
    ({"type": "Instancer", "prototype": {"shape": {"type": "Sphere"}, "visibility": {}},
      "instances": [{}]}, "Instancer prototype keys"),
    ({"type": "Instancer", "prototype": {"shape": {"type": "Sphere"}},
      "instances": [{"position": [0, 0, 0], "motion": 1}]}, "Instancer instance keys"),
    ({"type": "Instancer", "prototype": {"shape": {"type": "Cone"}}, "instances": [{}]},
     "shape"),
], ids=["animation", "prototype_key", "instance_key", "shape"])
def test_instancer_refuses_by_name(entity, match):
    from zyg_tpu_torch.scene.loader import load_scene_dict
    from zyg_tpu_torch.scene.types import UnsupportedScene

    root = {"materials": [{"name": "l", "rendering": {"Light": {"emittance": {"value": 1}}}}],
            "entities": [entity, {"type": "Light", "shape": {"type": "Dome"},
                                  "materials": ["l"]}]}
    with pytest.raises(UnsupportedScene, match=match):
        load_scene_dict(root)


def _take(module, res, spp):
    take = module.load_take_file(TAKE)
    take.cameras[0].resolution = res
    take.num_samples_per_pixel = spp
    return take


def test_forest_render_matches_jax_at_golden_gate(forest_scenes):
    from zyg_tpu.io import take as jtake
    from zyg_tpu.render.driver import Driver as JDriver
    from zyg_tpu.tools.it import op_downsample
    from zyg_tpu_torch.io import take as ttake
    from zyg_tpu_torch.render.driver import Driver

    js, ts = forest_scenes
    jd = JDriver(take=_take(jtake, (48, 32), 8), scene=js)
    ref = jd.render_frame()
    d = Driver(_take(ttake, (48, 32), 8), ts, device="cpu")
    img = d.render_frame()
    assert img.shape == ref.shape == (32, 48, 3) and np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    assert abs(img.mean() / scale - 1.0) < 0.015
    d4 = op_downsample(ref, 4) - op_downsample(img, 4)
    assert float(np.sqrt(np.mean(d4 * d4))) / scale < 0.06
    assert abs(d.rays_traced - jd.rays_traced) <= 1e-3 * jd.rays_traced


def test_cli_renders_forest(tmp_path):
    from zyg_tpu_torch import cli
    from zyg_tpu_torch.io.png import read_png

    with open(TAKE, encoding="utf-8") as f:
        take = json.load(f)
    take["scene"] = os.path.abspath(SCENE)
    take["camera"]["Perspective"]["resolution"] = [24, 16]
    take["sampler"]["Sobol"]["samples_per_pixel"] = 2
    path = tmp_path / "forest_small.take"
    path.write_text(json.dumps(take))
    out = tmp_path / "out.png"
    assert cli.main(["-i", str(path), "-o", str(out), "--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (16, 24, 3) and img.mean() > 10
