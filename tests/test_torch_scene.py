"""The port's host side against the JAX package: the scene loader on
examples/scenes/cornell.scene (exact arrays), the JAX -> port scene
hand-off, the take parse, and camera ray generation (rtol 1e-6)."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

SCENE = "examples/scenes/cornell.scene"
TAKE = "examples/takes/cornell_ptmis.take"


@pytest.fixture(scope="module")
def jax_scene():
    from zyg_tpu.scene.loader import load_scene_file

    return load_scene_file(SCENE)


def _assert_same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_matches_jax(jax_scene):
    from zyg_tpu_torch.scene.loader import load_scene_file, scene_arrays

    _assert_same_arrays(scene_arrays(jax_scene), scene_arrays(load_scene_file(SCENE)))


def test_scene_from_jax_arrays_roundtrip(jax_scene):
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    d = scene_arrays(jax_scene)
    port = scene_from_jax_arrays(d, "cpu")
    _assert_same_arrays(d, scene_arrays(port))
    assert list(port.prop_groups) == [1, 5]


def test_textured_scene_from_jax_arrays_roundtrip():
    """The textured-trefoil-under-a-dome scene (test_shade_kernel.py's
    textured_env_scene): texture arena, material texture ids and the env
    alias table carry across array-equal."""
    import zyg_tpu.scene.loader as jl
    import zyg_tpu.scene.types as jt
    from test_torch_surface_v2 import textured_env_scene
    from zyg_tpu.scene import trimesh
    from zyg_tpu.scene.sky import bake_sky
    from zyg_tpu_torch.scene.loader import scene_arrays, scene_from_jax_arrays

    d = scene_arrays(textured_env_scene(jl, trimesh, bake_sky, jt.ShapeType))
    assert {"textures.data", "textures.address", "env.table", "env.width",
            "materials.emission_tex"} <= set(d)
    port = scene_from_jax_arrays(d, "cpu")
    _assert_same_arrays(d, scene_arrays(port))
    assert (port.env.width, port.env.height) == (32, 16)


def test_euler_rotation_matches_jax():
    from zyg_tpu.scene.loader import rotation_matrix_from_euler_degrees as jrot
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as trot

    rng = np.random.default_rng(4)
    for xyz in rng.uniform(-180, 180, (32, 3)):
        np.testing.assert_array_equal(jrot(xyz), trot(xyz))


@pytest.mark.parametrize(
    "scene",
    [
        {"materials": [{"name": "g", "rendering": {"Glass": {}}}],
         "entities": [{"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["g"]}]},
        {"entities": [{"type": "Prop", "shape": {"file": "mesh.obj"}}]},
        {"entities": [{"type": "Light", "shape": {"type": "Sphere"},
                       "materials": ["l"]}],
         "materials": [{"name": "l", "rendering": {"Light": {"emittance": {"value": 1}}}}]},
        {"entities": [{"type": "Prop", "shape": {"type": "Cube"}}]},
    ],
    ids=["glass", "mesh", "sphere_light", "no_light"],
)
def test_loader_refuses_outside_the_subset(scene):
    from zyg_tpu_torch.scene.loader import UnsupportedScene, load_scene_dict

    with pytest.raises(UnsupportedScene):
        load_scene_dict(scene)


def _light(shape, **extra):
    return {"materials": [{"name": "l", "rendering": {"Light": {"emittance": {"value": 1}}}}],
            "entities": [{"type": "Light", "shape": shape, "materials": ["l"], **extra}]}


@pytest.mark.parametrize(
    "scene,reason",
    [
        (_light({"type": "Sphere"}), "Sphere lights"),
        (_light({"type": "Disk"}), "Disk lights"),
        (_light({"type": "Cube"}), "Cube lights"),
        (_light({"file": "proc:cube"}), "emissive meshes"),
        ({"entities": [{"type": "Instancer", "prototypes": []}]}, "entity 'Instancer'"),
        ({"entities": [{"type": "Prop", "shape": {"file": "curly.hair"}}]}, r"curly\.hair"),
        ({"entities": [{"type": "Sky", "parameters": {"sun": {"rotation": [0, 0, 0],
                                                              "scale": 2}}}]}, "Sky keys"),
    ],
    ids=["sphere_light", "disk_light", "cube_light", "mesh_light", "instancer", "hair_file",
         "sky_key"],
)
def test_loader_names_what_it_refuses(scene, reason):
    """Each light kind, entity and Sky parameter outside the port's subset
    raises UnsupportedScene naming it."""
    from zyg_tpu_torch.scene.loader import UnsupportedScene, load_scene_dict

    with pytest.raises(UnsupportedScene, match=reason):
        load_scene_dict(scene)


# a one-lamp LM-63 profile (tests/test_ies.py's narrow beam)
IES_TEXT = """IESNA:LM-63-2002
TILT=NONE
1 1000.0 1 5 1 1 1 0.1 0.1 0.1
1.0 1.0 0.0
0 22.5 45 90 180
0
1000 800 50 0 0
"""


def _under_glass(entities, materials):
    """entities and materials beside a Glass sphere: a scene for the
    general body."""
    return {"materials": materials + [{"name": "g", "rendering": {"Glass": {"ior": 1.5}}}],
            "entities": entities + [{"type": "Prop", "shape": {"type": "Sphere"},
                                     "materials": ["g"]}]}


@pytest.mark.parametrize("kind,reason", [
    ("ies", r"material features \['ies'\]"),
    ("portal", "portal lights on the general body"),
    ("canopy", "Canopy lights on the general body"),
])
def test_general_body_names_what_it_refuses(kind, reason, tmp_path):
    """An IES profile, a portal or a Canopy light beside glass would take
    the general body, which refuses each by name when the render is set
    up (Driver -> check_scene), as it refuses triplanar textures."""
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings, check_scene
    from zyg_tpu_torch.scene.loader import UnsupportedScene, load_scene_file

    lamp = {"Light": {"emittance": {"value": 5.0}}}
    if kind == "ies":
        (tmp_path / "spot.ies").write_text(IES_TEXT)
        lamp["Light"]["emittance"]["profile"] = {"file": "spot.ies"}
        ents = [{"type": "Light", "shape": {"type": "Rectangle"}, "materials": ["l"],
                 "transformation": {"position": [0, 2, 0], "rotation": [90, 0, 0]}}]
    elif kind == "portal":
        ents = [{"type": "Sky", "parameters": {}},
                {"type": "Portal", "shape": {"type": "Rectangle"}, "light": 0}]
    else:
        ents = [{"type": "Light", "shape": {"type": "Canopy"}, "materials": ["l"]}]
    (tmp_path / "s.scene").write_text(json.dumps(_under_glass(ents, [{"name": "l",
                                                                       "rendering": lamp}])))
    scene = load_scene_file(str(tmp_path / "s.scene"))
    assert "glass" in scene.mat_features
    with pytest.raises(UnsupportedScene, match=reason):
        check_scene(scene, PtmisSettings())


def test_two_lights_load_as_in_jax():
    """A rectangle lamp and a Distant light (a Celestial_disk): the power
    CDF and the light tree as the JAX loader builds them."""
    from zyg_tpu.scene.loader import load_scene_dict as jload
    from zyg_tpu_torch.scene.loader import load_scene_dict, scene_arrays

    d = _light({"type": "Rectangle"}, transformation={"position": [0, 2, 0],
                                                      "rotation": [-90, 0, 0]})
    d["materials"].append({"name": "sun", "rendering": {"Light": {"emittance": {"value": 3e3}}}})
    d["entities"].append({"type": "Light", "shape": {"type": "Celestial_disk"},
                          "materials": ["sun"],
                          "transformation": {"rotation": [-60, 30, 0], "scale": [0.01, 1, 1]}})
    port = load_scene_dict(d)
    assert port.lights.count == 2 and port.light_tree is not None
    assert port.light_tree.num_finite == 1 and port.light_tree.depth == 0
    _assert_same_arrays(scene_arrays(jload(d)), scene_arrays(port))


@pytest.mark.parametrize("threshold", [None, 0.0, 0.3, 2.0])
def test_take_parses_split_threshold_as_jax(threshold):
    from zyg_tpu.io.take import load_take_dict as jload
    from zyg_tpu_torch.io.take import load_take_dict as tload

    body = {"depth": {"surface": 4}}
    if threshold is not None:
        body["light_sampling"] = {"split_threshold": threshold}
    root = {"camera": {"Perspective": {}}, "integrator": {"surface": {"PTMIS": body}}}
    assert tload(root).integrator.light_split_threshold == \
        jload(root).integrator.light_split_threshold


def test_take_parse_matches_jax():
    from zyg_tpu.io.take import load_take_file as jload
    from zyg_tpu_torch.io.take import load_take_file as tload

    j, t = jload(TAKE), tload(TAKE)
    assert t.num_samples_per_pixel == j.num_samples_per_pixel == 16
    assert t.integrator.kind == j.integrator.kind
    assert t.integrator.max_depth_surface == j.integrator.max_depth_surface
    assert t.integrator.caustics == j.integrator.caustics
    assert t.sensor.tonemapper == j.sensor.tonemapper
    assert t.sensor.exposure == j.sensor.exposure
    assert (t.sensor.clamp.emission, t.sensor.clamp.direct, t.sensor.clamp.indirect) == (
        j.sensor.clamp.emission, j.sensor.clamp.direct, j.sensor.clamp.indirect)
    assert j.sensor.filter_radius == 0.0
    cj, ct = j.cameras[0], t.cameras[0]
    assert ct.resolution == cj.resolution
    assert ct.fov == cj.fov
    np.testing.assert_array_equal(ct.rotation, cj.rotation)
    np.testing.assert_array_equal(ct.position, cj.position)
    import os

    assert os.path.samefile(t.scene_filename, j.scene_filename)


def test_take_refuses_filters_and_other_integrators():
    """Blackman and Mitchell filters and the PT and AOV integrators load
    (tests/test_torch_export.py holds their settings against the JAX
    take's); other filters and integrators are refused by name."""
    from zyg_tpu_torch.io.take import UnsupportedTake, load_take_dict

    with pytest.raises(UnsupportedTake, match="Gaussian"):
        load_take_dict({"camera": {"Perspective": {}},
                        "sensor": {"filter": {"Gaussian": {"radius": 2}}}})
    with pytest.raises(UnsupportedTake, match="Whitted"):
        load_take_dict({"camera": {"Perspective": {}},
                        "integrator": {"surface": {"Whitted": {}}}})
    t = load_take_dict({"camera": {"Perspective": {}},
                        "sensor": {"filter": {"Blackman": {"radius": 2}}},
                        "integrator": {"surface": {"PT": {}}}})
    assert (t.sensor.filter_name, t.sensor.filter_radius, t.integrator.kind) == \
        ("Blackman", 2.0, "PT")


def test_generate_rays_matches_jax():
    from zyg_tpu.io.take import load_take_file as jload
    from zyg_tpu.render.camera import generate_rays as jgen
    from zyg_tpu_torch.io.take import load_take_file as tload
    from zyg_tpu_torch.render.camera import generate_rays as tgen

    rng = np.random.default_rng(9)
    n = 4096
    xy = np.stack([rng.integers(0, 512, n), rng.integers(0, 512, n)], -1).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    jo, jd = jgen(jload(TAKE).cameras[0].arrays(), jnp.asarray(xy), jnp.asarray(uv))
    to, td = tgen(tload(TAKE).cameras[0].arrays("cpu"), torch.from_numpy(xy), torch.from_numpy(uv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
