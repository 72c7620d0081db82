"""Take (render description) loader, the keys the port renders
(counterpart of zyg_tpu/io/take.py; source-compatible with zyg take JSON).

Supported: a Perspective camera (fov, transformation, resolution), the
Sobol sampler's samples_per_pixel, a PTMIS or PTDL surface integrator
(depth.surface and depth.volume, caustics, bsdf_split,
light_sampling.split_threshold; regularize_roughness only at 0), the
sensor clamp, a
tonemapper with exposure, and PNG export. Anything else raises
`UnsupportedTake`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..render.camera import PerspectiveCamera
from ..render.sensor import Clamp, SensorSettings
from ..scene.loader import read_transformation


class UnsupportedTake(ValueError):
    """The take uses a feature outside the port's slice."""


@dataclass
class IntegratorSettings:
    kind: str = "PTMIS"  # PTMIS | PTDL
    max_depth_surface: int = 16
    # null-interface crossings and volume scatters (ref probe.zig Depth)
    max_depth_volume: int = 256
    caustics: bool = True
    # BSDF path splitting at glass vertices (zyg_tpu/io/take.py:35)
    bsdf_split: bool = True
    # NEE light splitting: split_threshold^4 (ref take.zig:263-271);
    # render/driver.py refuses a scene that would split
    light_split_threshold: float = 0.5**4


@dataclass
class Take:
    scene_filename: str = ""
    cameras: list[PerspectiveCamera] = field(default_factory=list)
    num_samples_per_pixel: int = 1
    integrator: IntegratorSettings = field(default_factory=IntegratorSettings)
    sensor: SensorSettings = field(default_factory=lambda: SensorSettings(clamp=Clamp()))
    export_format: str = "PNG"


def _only(node: dict, allowed: set, what: str) -> None:
    extra = set(node) - allowed
    if extra:
        raise UnsupportedTake(f"{what} keys {sorted(extra)}")


def _load_camera(node: dict) -> PerspectiveCamera:
    _only(node, {"Perspective"}, "camera")
    body = node["Perspective"]
    _only(body, {"parameters", "transformation", "resolution"}, "Perspective camera")
    params = body.get("parameters", {})
    _only(params, {"fov"}, "camera parameters")
    cam = PerspectiveCamera()
    if "fov" in params:
        cam.fov = float(np.deg2rad(params["fov"]))
    trafo = read_transformation(body.get("transformation"))
    cam.rotation = trafo.rotation
    cam.position = trafo.position
    res = body.get("resolution", [1280, 720])
    cam.resolution = (int(res[0]), int(res[1]))
    return cam


def _load_integrator(node: dict, take: Take) -> None:
    _only(node, {"surface"}, "integrator")
    surface = node["surface"]
    _only(surface, {"PTMIS", "PTDL"}, "surface integrator")
    for kind in ("PTDL", "PTMIS"):
        if kind not in surface:
            continue
        body = surface[kind] or {}
        _only(body, {"depth", "caustics", "light_sampling", "bsdf_split",
                     "regularize_roughness"}, kind)
        if float(body.get("regularize_roughness", 0.0)) > 0.0:
            raise UnsupportedTake("regularize_roughness > 0 (path-space regularization)")
        s = take.integrator
        s.kind = kind
        depth = body.get("depth", {})
        if isinstance(depth, dict):
            _only(depth, {"surface", "volume"}, "depth")
            s.max_depth_surface = int(depth.get("surface", 16))
            s.max_depth_volume = int(depth.get("volume", 256))
        else:
            s.max_depth_surface = int(depth)
        s.caustics = bool(body.get("caustics", True))
        s.bsdf_split = bool(body.get("bsdf_split", True))
        ls = body.get("light_sampling", {})
        _only(ls, {"split_threshold"}, "light_sampling")
        st = float(np.clip(ls.get("split_threshold", 0.5), 0.0, 1.0))
        s.light_split_threshold = (st * st) * (st * st)
        break


def _load_sensor(node: dict) -> SensorSettings:
    _only(node, {"clamp"}, "sensor (filters, alpha and AOVs are not ported)")
    clamp = Clamp()
    cl = node.get("clamp")
    if isinstance(cl, dict):
        clamp.emission = float(cl.get("emission", np.inf))
        clamp.direct = float(cl.get("direct", np.inf))
        clamp.indirect = float(cl.get("indirect", np.inf))
    return SensorSettings(clamp=clamp)


def load_take_dict(root: dict, base_dir: str = "") -> Take:
    _only(root, {"scene", "camera", "sampler", "integrator", "sensor", "post", "export"}, "take")
    take = Take()
    take.scene_filename = root.get("scene", "")
    if take.scene_filename and base_dir:
        take.scene_filename = os.path.join(base_dir, take.scene_filename)
    if "camera" in root:
        take.cameras.append(_load_camera(root["camera"]))
    for name, body in root.get("sampler", {}).items():
        if name != "Sobol":
            raise UnsupportedTake(f"sampler {name!r}")
        take.num_samples_per_pixel = int(body.get("samples_per_pixel", 1))
    if "integrator" in root:
        _load_integrator(root["integrator"], take)
    if "sensor" in root:
        take.sensor = _load_sensor(root["sensor"])
    for pp in root.get("post", []):
        _only(pp, {"tonemapper"}, "post")
        for tname, tbody in pp["tonemapper"].items():
            take.sensor.tonemapper = tname
            if isinstance(tbody, dict):
                take.sensor.exposure = float(tbody.get("exposure", 0.0))
                take.sensor.look = str(tbody.get("look", take.sensor.look))
            else:
                take.sensor.exposure = 0.0
    exp = root.get("export")
    if isinstance(exp, dict):
        _only(exp, {"Image"}, "export")
        fmt = exp["Image"].get("format", "PNG").upper()
        if fmt != "PNG":
            raise UnsupportedTake(f"export format {fmt!r}")
        take.export_format = fmt
    if not take.cameras:
        raise UnsupportedTake("take without a camera")
    return take


def load_take_file(path: str) -> Take:
    with open(path, encoding="utf-8") as f:
        root = json.load(f)
    return load_take_dict(root, base_dir=os.path.dirname(os.path.abspath(path)))
