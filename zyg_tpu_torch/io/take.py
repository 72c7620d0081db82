"""Take (render description) loader, the keys the port renders
(counterpart of zyg_tpu/io/take.py; source-compatible with zyg take JSON).

Supported: a Perspective camera (fov, its shutter's frame_step or
frames_per_second, open, close, motion_blur and up to 8 slope handles,
under parameters or beside them, transformation, resolution), the
Sobol sampler's samples_per_pixel (0: no forward pass), a PTMIS, PTDL,
PT or AOV surface integrator (depth.surface and depth.volume, caustics,
bsdf_split, light_sampling.split_threshold; regularize_roughness only at
0; the AOV integrator's value, num_samples and radius), the `particle`
integrator (the lighttracer: particles_per_pixel, default 1, and
full_light_path, accepted and not read: the Driver derives it; beside a
surface integrator it turns the forward pass's caustics off, as the JAX
package does), the sensor's clamp,
Blackman or Mitchell filter (always at radius 2) and alpha_transparency,
the root `aov` classes, the root `photon` settings (the photon map), a
tonemapper with exposure, and PNG, EXR or RGBE image export. Anything
else raises `UnsupportedTake`, and so does the AOV integrator's Photon
value (its wiring to the photon map is not ported).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..render.camera import PerspectiveCamera
from ..render.integrator.aov import VALUES as AOV_VALUES
from ..render.sensor import Clamp, SensorSettings
from ..scene.loader import read_transformation


class UnsupportedTake(ValueError):
    """The take uses a feature outside the port's slice."""


@dataclass
class IntegratorSettings:
    kind: str = "PTMIS"  # AOV | PT | PTDL | PTMIS
    max_depth_surface: int = 16
    # null-interface crossings and volume scatters (ref probe.zig Depth)
    max_depth_volume: int = 256
    caustics: bool = True
    # BSDF path splitting at glass vertices (zyg_tpu/io/take.py:35)
    bsdf_split: bool = True
    # NEE light splitting: split_threshold^4 (ref take.zig:263-271);
    # render/driver.py refuses a scene that would split
    light_split_threshold: float = 0.5**4
    # the AOV integrator (render/integrator/aov.py)
    aov_value: str = "AO"
    aov_num_samples: int = 1
    aov_radius: float = 1.0


@dataclass
class PhotonSettings:
    """The photon map's settings (zyg_tpu/io/take.py:40-51)."""

    num_photons: int = 0  # photon paths a frame; 0: no photon map
    max_bounces: int = 2
    search_radius: float = 0.01
    full_light_path: bool = False
    # gather at every primary diffuse vertex, not only after specular
    # chains: set where the take traces no particles (the JAX rule,
    # num_particles_per_pixel == 0); with a particle pass the lighttracer
    # carries the caustic chains
    not_only_through_specular: bool = False


@dataclass
class Exporter:
    kind: str = "Image"
    format: str = "PNG"  # PNG | EXR | RGBE
    error_diffusion: bool = True


# reference AOV JSON keys -> the sensor AOV classes
# (render/integrator/ptmis.py AOV_SPECS; ref aov_value.zig Class)
AOV_NAME_MAP = {
    "Albedo": "albedo",
    "Depth": "depth",
    "MaterialId": "material_id",
    "GeometricNormal": "geometric_normal",
    "ShadingNormal": "shading_normal",
    "Roughness": "roughness",
    "Emission": "emission",
    "Direct": "direct",
    "Indirect": "indirect",
}

def parse_aovs(node: dict) -> tuple:
    """{"Albedo": true, ...} -> the enabled AOV class names, in the node's
    order; a key outside AOV_NAME_MAP raises."""
    _only(node, set(AOV_NAME_MAP), "aov")
    return tuple(AOV_NAME_MAP[k] for k, enabled in node.items() if bool(enabled))


@dataclass
class Take:
    scene_filename: str = ""
    cameras: list[PerspectiveCamera] = field(default_factory=list)
    num_samples_per_pixel: int = 1
    integrator: IntegratorSettings = field(default_factory=IntegratorSettings)
    sensor: SensorSettings = field(default_factory=lambda: SensorSettings(clamp=Clamp()))
    exporters: list[Exporter] = field(default_factory=list)
    # enabled sensor AOV classes (keys of ptmis.AOV_SPECS)
    aovs: tuple = ()
    photon: PhotonSettings = field(default_factory=PhotonSettings)
    # light paths a pixel a frame (the `particle` integrator; 0: none)
    num_particles_per_pixel: int = 0


def _only(node: dict, allowed: set, what: str) -> None:
    extra = set(node) - allowed
    if extra:
        raise UnsupportedTake(f"{what} keys {sorted(extra)}")


def _load_camera(node: dict) -> PerspectiveCamera:
    _only(node, {"Perspective"}, "camera")
    body = node["Perspective"]
    _only(body, {"parameters", "transformation", "resolution", "shutter"}, "Perspective camera")
    params = body.get("parameters", {})
    _only(params, {"fov", "shutter"}, "camera parameters")
    cam = PerspectiveCamera()
    if "fov" in params:
        cam.fov = float(np.deg2rad(params["fov"]))
    if "shutter" in params or "shutter" in body:
        # frame timing and the shutter's response (zyg_tpu/io/take.py:141-152)
        sh = params.get("shutter", body.get("shutter", {}))
        _only(sh, {"frame_step", "frames_per_second", "open", "close", "motion_blur", "slope"},
              "shutter")
        if "frame_step" in sh:
            cam.frame_step = float(sh["frame_step"])
        elif "frames_per_second" in sh:
            fps = float(sh["frames_per_second"])
            cam.frame_step = 1.0 / fps if fps > 0 else 0.0
        cam.shutter_open = float(sh.get("open", 0.0))
        cam.shutter_close = float(sh.get("close", 1.0))
        cam.motion_blur = bool(sh.get("motion_blur", True))
        cam.shutter_slope = tuple(float(x) for x in sh.get("slope", ()))[:8]
    trafo = read_transformation(body.get("transformation"))
    cam.rotation = trafo.rotation
    cam.position = trafo.position
    res = body.get("resolution", [1280, 720])
    cam.resolution = (int(res[0]), int(res[1]))
    return cam


def _load_integrator(node: dict, take: Take) -> None:
    _only(node, {"surface", "particle"}, "integrator")
    particle = node.get("particle")
    if particle:
        # the lighttracer (zyg_tpu/io/take.py:189-195); full_light_path is
        # derived by the Driver from the forward pass's spp
        _only(particle, {"particles_per_pixel", "full_light_path"}, "particle integrator")
        take.num_particles_per_pixel = int(particle.get("particles_per_pixel", 1))
    surface = node.get("surface", {})
    _only(surface, {"AOV", "PT", "PTMIS", "PTDL"}, "surface integrator")
    for kind in ("AOV", "PT", "PTDL", "PTMIS"):
        if kind not in surface:
            continue
        body = surface[kind] or {}
        aov_keys = {"value", "num_samples", "radius"} if kind == "AOV" else set()
        _only(body, {"depth", "caustics", "light_sampling", "bsdf_split",
                     "regularize_roughness"} | aov_keys, kind)
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
        if kind == "AOV":
            s.aov_value = str(body.get("value", "AO"))
            if s.aov_value == "Photon":
                raise UnsupportedTake("AOV value 'Photon' (its wiring to the photon map is "
                                      "not ported)")
            if s.aov_value not in AOV_VALUES:  # the AOV integrator's values
                raise UnsupportedTake(f"AOV value {s.aov_value!r}")
            s.aov_num_samples = int(body.get("num_samples", 1))
            s.aov_radius = float(body.get("radius", 1.0))
        break
    if particle and "surface" in node:
        # caustic chains move to the lighttracer (ref take.zig: caustics_path
        # = caustics and !lighttracer)
        take.integrator.caustics = False


def _load_sensor(node: dict) -> SensorSettings:
    _only(node, {"clamp", "filter", "alpha_transparency"},
          "sensor (AOVs go under the take's root 'aov' key)")
    clamp = Clamp()
    cl = node.get("clamp")
    if isinstance(cl, dict):
        clamp.emission = float(cl.get("emission", np.inf))
        clamp.direct = float(cl.get("direct", np.inf))
        clamp.indirect = float(cl.get("indirect", np.inf))
    settings = SensorSettings(clamp=clamp)
    settings.alpha_transparency = bool(node.get("alpha_transparency", False))
    filt = node.get("filter")
    if isinstance(filt, dict):
        _only(filt, {"Blackman", "Mitchell"}, "filter")
        for name in ("Blackman", "Mitchell"):
            if name in filt:
                # the reference's radius key is not read: always 2
                settings.filter_name = name
                settings.filter_radius = 2.0
                break
    return settings


def load_take_dict(root: dict, base_dir: str = "") -> Take:
    _only(root, {"scene", "camera", "sampler", "integrator", "sensor", "aov", "photon", "post",
                 "export"}, "take")
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
    if isinstance(root.get("aov"), dict):
        take.aovs = parse_aovs(root["aov"])
    ph = root.get("photon")
    if isinstance(ph, dict):
        _only(ph, {"num_photons", "max_bounces", "search_radius", "full_light_path"}, "photon")
        take.photon = PhotonSettings(
            num_photons=int(ph.get("num_photons", 0)),
            max_bounces=int(ph.get("max_bounces", 2)),
            search_radius=float(ph.get("search_radius", 0.01)),
            full_light_path=bool(ph.get("full_light_path", False)),
            not_only_through_specular=take.num_particles_per_pixel == 0,
        )
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
        img = exp["Image"]
        _only(img, {"format", "error_diffusion"}, "export Image")
        fmt = img.get("format", "PNG").upper()
        if fmt not in ("PNG", "EXR", "RGBE"):
            raise UnsupportedTake(f"export format {fmt!r}")
        take.exporters.append(Exporter("Image", fmt, bool(img.get("error_diffusion", True))))
    if not take.cameras:
        raise UnsupportedTake("take without a camera")
    return take


def load_take_file(path: str) -> Take:
    with open(path, encoding="utf-8") as f:
        root = json.load(f)
    return load_take_dict(root, base_dir=os.path.dirname(os.path.abspath(path)))
