"""Scene container on torch tensors (counterpart of zyg_tpu/scene/types.py).

Holds only the fields the port's paths read: per-prop transforms, shape
and material ids, visibility, the material table (with its texture
ids), the light records with their power CDF, the analytic props grouped by
shape type, for mesh scenes the triangle arena and the mesh instance table
(scene/trimesh.py), for textured scenes the texture arena
(scene/textures.py) and the env-map sampler (scene/env_sampling.py), for
two or more lights of which one is finite the light tree
(scene/light_tree.py), for emissive meshes their triangle area CDFs and
the primitive light trees of the large ones, for volume lights over a density grid their
interior-point distributions (core/distribution.py), for portal lights
their windowed portal-image distributions (scene/portal.py), for motion
blur the moving props and their shutter keyframes, for point-cloud and
curve props their arenas (scene/points.py, scene/curves.py), and the
material features and volume props by
which the general bounce decides, once per render, what it computes
(the JAX package's static `mat_features` and `volume_props`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields

import numpy as np
import torch


class UnsupportedScene(ValueError):
    """The scene uses a feature outside what the port renders."""


class ShapeType(enum.IntEnum):
    """Builtin shape ids, the JAX package's (and the reference's) order."""

    CANOPY = 0
    CUBE = 1
    DISK = 2
    DISTANT = 3
    DOME = 4
    RECTANGLE = 5
    SPHERE = 6
    TRIANGLE_MESH = 7
    CURVES = 8
    POINTS = 9


class MaterialKind(enum.IntEnum):
    SUBSTITUTE = 0
    GLASS = 1
    LIGHT = 2
    DEBUG = 3
    VOLUMETRIC = 4
    HAIR = 5
    SKY = 6


RAY_MAX_T = float(np.float32(2.14748313e9))  # ref ray_offset.zig RayMaxT


def to_device(obj, device):
    """A copy of the dataclass `obj` with its tensor fields on `device`."""
    return type(obj)(**{
        f.name: v.to(device) if isinstance(v, torch.Tensor) else v
        for f in fields(obj) for v in (getattr(obj, f.name),)
    })


@dataclass
class Materials:
    kind: torch.Tensor  # int32[M]
    color: torch.Tensor  # float32[M, 3]
    roughness: torch.Tensor  # float32[M]
    metallic: torch.Tensor  # float32[M]
    ior: torch.Tensor  # float32[M]
    specular: torch.Tensor  # float32[M]
    emission: torch.Tensor  # float32[M, 3]
    two_sided: torch.Tensor  # bool[M]
    # textures (ids into SceneData.textures, -1 for none): color and
    # roughness multiply their constant values, emission scales emission,
    # a normal map perturbs the shading normal in the tangent frame
    color_tex: torch.Tensor  # int32[M]
    roughness_tex: torch.Tensor  # int32[M]
    emission_tex: torch.Tensor  # int32[M]
    normal_tex: torch.Tensor  # int32[M]
    # glass and media (the general bounce): Beer absorption distance (0 =
    # none), nested-dielectric priority, and the two scattering parameters
    # of the JAX table (zero on every material the port loads)
    attenuation_distance: torch.Tensor  # float32[M]
    priority: torch.Tensor  # int32[M]
    subsurface_color: torch.Tensor  # float32[M, 3]
    volumetric_anisotropy: torch.Tensor  # float32[M]
    # heterogeneous media: density grid id into SceneData.grids, -1 for a
    # homogeneous medium (or a material that is not a medium)
    density_grid: torch.Tensor  # int32[M]
    # IES profiles (io/ies.py): the emission's intensity over the polar
    # angle from the emitting surface's normal, 32 bins; all ones unprofiled
    ies: torch.Tensor  # float32[M, 32]
    # the Hair material's constants [mu_a(3), v0, s, alpha] (zeros on other
    # kinds; scene/loader.py hair_constants), or None without hair
    hair: torch.Tensor = None  # float32[M, 6]

    def to(self, device) -> "Materials":
        return to_device(self, device)


@dataclass
class Lights:
    prop: torch.Tensor  # int32[L] prop index
    two_sided: torch.Tensor  # bool[L]
    cdf: torch.Tensor  # float32[L + 1] power CDF, cdf[0] = 0 .. cdf[L] = 1
    # volume lights (emissive Volumetric Cubes): NEE samples a point
    # inside the prop instead of on its surface
    volume: torch.Tensor  # bool[L]
    # emissive meshes (None without them): each light's world area (0
    # for other lights), the slice [tri_offset, tri_offset + tri_count)
    # of the triangle area CDF that is its (-1, 0 for other lights), and
    # the padded arena triangle id of each CDF entry
    area: torch.Tensor = None  # float32[L]
    tri_offset: torch.Tensor = None  # int32[L]
    tri_count: torch.Tensor = None  # int32[L]
    tri_cdf: torch.Tensor = None  # float32[T]
    tri_idx: torch.Tensor = None  # int32[T]

    @property
    def count(self) -> int:
        return self.prop.shape[0]

    def to(self, device) -> "Lights":
        return to_device(self, device)


@dataclass
class SceneData:
    prop_shape: torch.Tensor  # int32[P]
    prop_rot: torch.Tensor  # float32[P, 3, 3] rows = object axes in world
    prop_pos: torch.Tensor  # float32[P, 3]
    prop_scale: torch.Tensor  # float32[P, 3]
    prop_material: torch.Tensor  # int32[P]
    prop_visible_camera: torch.Tensor  # bool[P]
    prop_visible_reflection: torch.Tensor  # bool[P]
    prop_visible_shadow: torch.Tensor  # bool[P] (occluding)
    prop_light: torch.Tensor  # int32[P] light index, -1 if not a light
    materials: Materials
    lights: Lights
    # {shape_type: int32[G] prop ids} of the analytic props, ascending
    # shape type (mesh props are in mesh_instances instead)
    prop_groups: dict
    meshes: object = None  # trimesh.MeshArena, or None without meshes
    mesh_instances: object = None  # trimesh.InstanceTable, or None
    textures: object = None  # textures.TextureArena, or None without textures
    env: object = None  # env_sampling.EnvSampler of a mapped dome, or None
    light_tree: object = None  # light_tree.LightTree, or None (power-CDF selection)
    grids: object = None  # grids.GridArena of the density grids, or None
    # names of the material features present ("glass", "rough_glass",
    # "media", "volumetric", "spectral_media", "vol_emission", "triplanar";
    # scene/loader.py material_features), a Python set
    mat_features: set = field(default_factory=set)
    # props filled with a Volumetric medium, which attenuates shadow rays
    # instead of blocking them: sorted (prop, material, density grid or -1,
    # ShapeType code) rows (the keys of the JAX package's volume_props)
    volume_props: tuple = ()
    # {light index: Distribution3D over its density grid} of the volume
    # lights with a grid (interior points by density), or None
    vol_light_dist: dict = None
    # {(light index, portal prop): portal.PortalDist} of the portal lights
    # (scene/portal.py), or None
    portals: dict = None
    # motion blur (SceneBuilder.build over a shutter interval): the props
    # that move, {(prop, ShapeType code): True} in prop order, analytic
    # ones (which leave prop_groups) and mesh ones (whose instance rows
    # carry the shutter-end transform); the analytic lights among them,
    # {prop: True}; and every prop's K+1 shutter keyframes, float32
    # [P, K+1, 10] rows of quaternion | position | scale (None, like the
    # dicts, when nothing moves)
    animated_props: dict = None
    animated_lights: dict = None
    prop_keys: torch.Tensor = None
    # the bounding sphere of the finite props (host floats), from which an
    # infinite light's photons start (render/integrator/lighttracer.py)
    world_center: tuple = (0.0, 0.0, 0.0)
    world_radius: float = 1.0
    # point clouds and curves (hair): the arena (points.PointArena,
    # curves.CurveArena), its static props (int32[K], outside prop_groups,
    # as in the JAX arrays), each prop's cloud or curve set (int32[P], -1
    # elsewhere) and the moving props {prop: True}, walked at each lane's
    # shutter time; None without such props
    points: object = None
    point_props: torch.Tensor = None
    prop_cloud: torch.Tensor = None
    animated_points: dict = None
    curves: object = None
    curve_props: torch.Tensor = None
    prop_curve: torch.Tensor = None
    animated_curves: dict = None
    # the primitive light trees of the large emissive meshes: {(light
    # index, the mesh's first arena triangle id): (light_tree.LightTree
    # over its triangles, {"arena": int32 [T] each tree entry's arena
    # triangle, "area": float32 [T] its world area, "local_of": int32 the
    # tree entry of each arena triangle from the base, -1 for none})}, or
    # None
    mesh_light_trees: dict = None

    def to(self, device) -> "SceneData":
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name in ("mat_features", "volume_props", "animated_props", "animated_lights",
                          "world_center", "world_radius", "animated_points", "animated_curves"):
                out[f.name] = v
            elif f.name in ("prop_groups", "vol_light_dist", "portals") and v is not None:
                out[f.name] = {k: g.to(device) for k, g in v.items()}
            elif f.name == "mesh_light_trees" and v is not None:
                out[f.name] = {k: (tree.to(device), {a: x.to(device) for a, x in aux.items()})
                               for k, (tree, aux) in v.items()}
            else:
                out[f.name] = v if v is None else v.to(device)
        return SceneData(**out)
