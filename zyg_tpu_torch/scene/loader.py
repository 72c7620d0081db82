"""Host-side scene compiler (counterpart of zyg_tpu/scene/loader.py,
plain numpy then torch).

Supported: Prop and Light entities with analytic Rectangle/Cube/Sphere/
Disk/Canopy/Dome/Distant shapes (Celestial_disk is a Distant) or procedural
triangle meshes (shape "file": "proc:..."), the Sky entity (a baked
Preetham dome plus a distant sun, scene/sky.py), Portal entities (a
Rectangle through which an image-mapped dome, such as the Sky's, is
sampled; scene/portal.py), nested child entities,
Euler or look-at transformations, Substitute, Light and Glass materials
with constant parameters (Glass: color or attenuation_color, ior,
roughness, attenuation_distance, priority), Volumetric media
(attenuation_color, subsurface_color, attenuation_distance, anisotropy,
and a procedural `fbm` or `constant` density map built into the density
grid arena of scene/grids.py) on analytic props, with emission (an
emissive Volumetric Cube is a volume light, whose interior NEE samples
through a Distribution3D over its density grid, core/distribution.py;
any emissive medium gives off light along the walks), an emittance's IES
profile ({"profile": {"file": "*.ies"}}, io/ies.py), and one or more
emitting Rectangle, Canopy, Dome or Distant lights, volume lights or
portals. Two or more
lights are selected as
the JAX package selects them: by the power CDF when every light is
infinite, through the SAOH light
tree (scene/light_tree.py) when one is finite. Mesh props become
instances over one BVH arena (scene/trimesh.py). A material's color (or
attenuation_color), roughness, normal map and emission map may be texture
nodes, by the JAX loader's `tex()` rule: a lone Checker or Noise node is
evaluated analytically per lane (with a 128^2 fallback bake), any other
procedural graph is baked at scene build (scene/procedural.py), and a
{"file": ...} node loads a PNG or Radiance HDR image, resolved against
the scene file's directory (colours decoded from sRGB), with its
sampler's address modes and texcoord (UV0, Triplanar, ObjectPos); through
`SceneBuilder`, `add_texture_image`. A dome or canopy with an emission map
gets an env-map sampler (scene/env_sampling.py). As the JAX loader does,
a Portal whose link is not an image-mapped dome, a Portal of another
shape and an unreadable IES file are dropped with a warning.

Everything else raises `UnsupportedScene`: Sphere, Disk, Cube and mesh
lights, Instancer and other entities, C-API image references ({"id": N}),
EXR and other image formats, dispersive glass (abbe), coatings, flakes,
masks, density files, emission maps on media, Volumetric materials on
mesh props and every other material kind (Hair, Debug, Sky). (Scenes
whose light tree would split NEE, glass under textures, env maps, Distant
lights, Canopy lights or portals, and IES profiles or triplanar textures
off the textured bounce are refused by render/driver.py.) The port
renders only what its bounces cover, and never silently drops a feature.
"""

from __future__ import annotations

import ast
import json
import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.distribution import Distribution3D
from ..io.exr import read_exr
from ..io.ies import PROFILE_BINS, ies_profile_bins
from ..io.mesh import load_mesh_file
from ..io.png import read_png
from ..io.rgbe import read_hdr
from ..render.materials import MIN_ROUGHNESS
from .env_sampling import EnvSampler, build_env_sampler
from .grids import ARRAY_FIELDS as _GRID_FIELDS
from .grids import GridArena, build_grid_arena, make_fbm_grid
from .light_tree import ARRAY_FIELDS as _TREE_FIELDS
from .light_tree import LightTree, build_light_tree
from . import procedural
from .portal import ARRAY_FIELDS as _PORTAL_FIELDS
from .portal import PortalDist, build_portal_dist, make_portal_dist
from .sky import SUN_ANGULAR_RADIUS, bake_sky, sun_radiance
from .textures import TextureArena, TextureBuilder
from .trimesh import HostMesh, InstanceTable, MeshArena, build_arena, build_instance_table
from .types import Lights, Materials, MaterialKind, SceneData, ShapeType, UnsupportedScene

# CIE 1931 Y weights for linear sRGB primaries (ref srgb.zig luminance)
LUMINANCE_WEIGHTS = (0.212671, 0.715160, 0.072169)

# analytic shapes the bounces intersect (ops/isect.py)
_SHAPE_NAMES = {
    "Canopy": ShapeType.CANOPY,
    "Cube": ShapeType.CUBE,
    "Disk": ShapeType.DISK,
    "Distant": ShapeType.DISTANT,
    "Dome": ShapeType.DOME,
    "Rectangle": ShapeType.RECTANGLE,
    "Sphere": ShapeType.SPHERE,
    # zyg alias: the sun is a Distant light
    "Celestial_disk": ShapeType.DISTANT,
}
_MAX_PROPS = 32  # analytic props (ops/shade.py MAX_PROPS)
# the light shapes the port samples (scene/light_sampling.py)
_LIGHT_SHAPES = (ShapeType.RECTANGLE, ShapeType.CANOPY, ShapeType.DOME, ShapeType.DISTANT)


# ---------------------------------------------------------------------------
# Transformation parsing (ref json.zig readTransformation, as in the JAX loader)
# ---------------------------------------------------------------------------


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def rotation_matrix_from_euler_degrees(xyz) -> np.ndarray:
    """R = Rz * Rx * Ry, rows then used as object axes (ref json.zig:169-180)."""
    x, y, z = (np.deg2rad(float(v)) for v in xyz)
    return (_rot_z(z) @ _rot_x(x) @ _rot_y(y)).astype(np.float32)


def _read_vec3(value, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if value is None:
        return np.array(default, np.float32)
    if isinstance(value, (int, float)):
        return np.full(3, float(value), np.float32)
    return np.array([float(v) for v in value[:3]], np.float32)


@dataclass
class Transformation:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    def compose(self, child: "Transformation") -> "Transformation":
        """self (parent) o child — ref composed_transformation.zig transform()."""
        rot = child.rotation @ self.rotation
        scale = self.scale * child.scale
        pos = ((child.position * self.scale) @ self.rotation) + self.position
        return Transformation(pos.astype(np.float32), rot.astype(np.float32), scale.astype(np.float32))


def read_transformation(value: dict | None) -> Transformation:
    t = Transformation()
    if value is None:
        return t
    up = np.array([0.0, 1.0, 0.0], np.float32)
    look_at = None
    for key, v in value.items():
        if key == "position":
            t.position = _read_vec3(v)
        elif key == "scale":
            t.scale = _read_vec3(v, default=(1.0, 1.0, 1.0))
        elif key == "rotation":
            t.rotation = rotation_matrix_from_euler_degrees(_read_vec3(v))
        elif key == "look_at":
            look_at = _read_vec3(v)
        elif key == "up":
            up = _read_vec3(v)
    if look_at is not None:
        direction = look_at - t.position
        direction = direction / np.linalg.norm(direction)
        right = -np.cross(direction, up)
        t.rotation = np.stack([right, up, direction], axis=0).astype(np.float32)
    return t


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------


@dataclass
class MaterialDesc:
    kind: int = int(MaterialKind.SUBSTITUTE)
    color: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))
    roughness: float = 0.8
    metallic: float = 0.0
    ior: float = 1.46
    specular: float = 1.0
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    two_sided: bool = False
    # texture ids (SceneBuilder.add_texture_image / load_texture), -1 for none
    color_tex: int = -1
    roughness_tex: int = -1
    emission_tex: int = -1
    normal_tex: int = -1
    # glass and media: Beer absorption distance (0 = none) and
    # nested-dielectric priority
    attenuation_distance: float = 0.0
    priority: int = 0
    # Volumetric media: the scattering colour, the Henyey-Greenstein g and
    # the density grid id (SceneBuilder.add_density_grid, -1 homogeneous)
    subsurface_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    volumetric_anisotropy: float = 0.0
    density_grid: int = -1
    # an emittance's IES profile (io/ies.py): float32[PROFILE_BINS], or None
    ies: np.ndarray | None = None


def _read_color(v) -> np.ndarray:
    if isinstance(v, (int, float)):
        return np.full(3, float(v), np.float32)
    if isinstance(v, dict):
        if set(v) == {"value"}:
            return _read_color(v["value"])
        raise UnsupportedScene(f"color node {sorted(v)} (temperature)")
    return np.array([float(x) for x in v[:3]], np.float32)


_SUBSTITUTE_KEYS = {"color", "roughness", "metallic", "ior", "specular", "two_sided",
                    "emittance", "normal"}
_LIGHT_KEYS = {"emittance", "two_sided"}
_GLASS_KEYS = {"color", "attenuation_color", "ior", "roughness", "attenuation_distance",
               "priority"}
_VOLUMETRIC_KEYS = {"color", "attenuation_color", "subsurface_color", "attenuation_distance",
                    "anisotropy", "density", "density_map", "priority", "emittance"}
_OTHER_KINDS = {"Debug", "Hair", "Sky"}


def _load_density_grid(v) -> np.ndarray | None:
    """A density node -> host float32[nz, ny, nx] grid, or None (a
    homogeneous medium): {"procedural": {"type": "fbm", "resolution",
    "octaves", "seed", "sharpness", "scale"}} or {"procedural": {"type":
    "constant", "resolution", "value"}}, by the JAX loader's defaults
    (zyg_tpu/scene/loader.py:412-430). Density files are refused."""
    if not isinstance(v, dict):
        return None
    if "procedural" in v:
        p = v["procedural"]
        kind = p.get("type", "fbm")
        if kind == "constant":
            n = int(p.get("resolution", 4))
            return np.full((n, n, n), float(p.get("value", 1.0)), np.float32)
        if kind != "fbm":
            raise UnsupportedScene(f"procedural density {kind!r}")
        return make_fbm_grid(
            n=int(p.get("resolution", 64)),
            octaves=int(p.get("octaves", 4)),
            seed=int(p.get("seed", 7)),
            sharpness=float(p.get("sharpness", 2.0)),
        ) * float(p.get("scale", 1.0))
    if "file" in v:
        raise UnsupportedScene(f"density file {v['file']!r} (.npy/.sub density maps)")
    return None


def _read_texcoord(sampler) -> int:
    """A texture node's sampler "texcoord": UV0 (default) 0, Triplanar 1,
    ObjectPos 2 (zyg_tpu/scene/loader.py:197)."""
    if not isinstance(sampler, dict):
        return 0
    return {"UV0": 0, "Triplanar": 1, "ObjectPos": 2}.get(sampler.get("texcoord", "UV0"), 0)


def _read_address(sampler) -> tuple[bool, bool]:
    """A texture node's sampler "address": "Clamp"/"Repeat" or [u, v] of
    them -> (clamp u, clamp v) (zyg_tpu/scene/loader.py:207)."""
    if not isinstance(sampler, dict):
        return False, False
    adr = sampler.get("address")
    if isinstance(adr, (list, tuple)):
        return str(adr[0]) == "Clamp", str(adr[1 if len(adr) > 1 else 0]) == "Clamp"
    if isinstance(adr, str):
        return adr == "Clamp", adr == "Clamp"
    return False, False


def load_image(path: str) -> np.ndarray:
    """An image file by its extension: PNG (uint8/uint16 [H, W, C]),
    Radiance HDR (float [H, W, 3]) or OpenEXR (float [H, W, C]: R, G, B
    where present, else every channel in name order, as
    zyg_tpu/scene/loader.py:647-650 stacks them). Other formats raise
    UnsupportedScene."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".exr":
        chans = read_exr(path)
        keys = [k for k in ("R", "G", "B") if k in chans] or sorted(chans)
        return np.stack([chans[k] for k in keys], axis=-1)
    raise UnsupportedScene(f"image format {ext or path!r} (the port reads PNG, HDR and EXR)")


def _texture(v, srgb: bool, builder: "SceneBuilder | None", base_dir: str) -> int:
    """A texture node -> texture id, or -1 for a constant value, by the
    JAX loader's tex() rule (zyg_tpu/scene/loader.py:237-267): a lone
    Checker or Noise node gets a 128^2 fallback bake marked for analytic
    evaluation, any other procedural graph a BAKE_RES bake, a {"file": ...}
    node its image."""
    if builder is None or not isinstance(v, dict):
        return -1
    if procedural.is_procedural(v):
        def load(name):
            return load_image(os.path.join(base_dir, name))

        spec = procedural.analytic_spec(v)
        if spec is not None:
            tid = builder.add_texture_image(procedural.bake(v, load_image=load, res=128))
            builder.textures.add_procedural_meta(tid, spec)
            return tid
        return builder.add_texture_image(procedural.bake(v, load_image=load))
    if "file" in v:
        clamp_u, clamp_v = _read_address(v.get("sampler"))
        return builder.load_texture(os.path.join(base_dir, v["file"]), srgb=srgb,
                                    clamp_u=clamp_u, clamp_v=clamp_v,
                                    texcoord=_read_texcoord(v.get("sampler")))
    if "id" in v:
        raise UnsupportedScene("C-API image references ({'id': N})")
    return -1


def parse_material(value: dict, builder: "SceneBuilder | None" = None,
                   base_dir: str = "") -> MaterialDesc:
    """One material JSON node (ref material_provider.zig loadMaterial),
    Substitute, Light, Glass and Volumetric kinds; texture nodes (image
    files resolved against base_dir) and a Volumetric density map go into
    builder's texture arena and grid list."""
    rendering = value.get("rendering", value)
    desc = MaterialDesc()

    def tex(v, srgb):
        return _texture(v, srgb, builder, base_dir)
    for kind_name, body in rendering.items():
        if kind_name in _OTHER_KINDS:
            raise UnsupportedScene(f"material kind {kind_name!r}")
        if kind_name == "Substitute":
            desc.kind = int(MaterialKind.SUBSTITUTE)
            allowed = _SUBSTITUTE_KEYS
        elif kind_name == "Light":
            desc.kind = int(MaterialKind.LIGHT)
            allowed = _LIGHT_KEYS
        elif kind_name == "Glass":
            # the JAX loader's Glass defaults (zyg_tpu/scene/loader.py:281-285)
            desc.kind = int(MaterialKind.GLASS)
            desc.roughness = 0.0
            desc.color = np.ones(3, np.float32)
            desc.ior = 1.46
            allowed = _GLASS_KEYS
        elif kind_name == "Volumetric":
            desc.kind = int(MaterialKind.VOLUMETRIC)
            allowed = _VOLUMETRIC_KEYS
        else:
            continue
        if not isinstance(body, dict):
            break
        if kind_name == "Glass" and "abbe" in body:
            raise UnsupportedScene("dispersive glass (abbe)")
        extra = set(body) - allowed
        if extra:
            raise UnsupportedScene(f"{kind_name} material keys {sorted(extra)}")
        for key, v in body.items():
            if key in ("color", "attenuation_color"):
                t = tex(v, srgb=True)
                if t >= 0:
                    desc.color_tex = t
                    desc.color = np.ones(3, np.float32)
                else:
                    desc.color = _read_color(v)
            elif key == "attenuation_distance":
                desc.attenuation_distance = float(v)
            elif key == "priority":
                desc.priority = int(v)
            elif key == "roughness":
                t = tex(v, srgb=False)
                if t >= 0:
                    desc.roughness_tex = t
                    desc.roughness = 1.0
                elif isinstance(v, (int, float)):
                    desc.roughness = float(v)
                else:
                    raise UnsupportedScene(f"roughness {v!r}")
            elif key == "normal":
                desc.normal_tex = tex(v, srgb=False)
            elif key == "metallic":
                desc.metallic = float(v)
            elif key == "ior":
                desc.ior = float(v)
            elif key == "specular":
                desc.specular = float(v)
            elif key == "two_sided":
                desc.two_sided = bool(v)
            elif key == "subsurface_color":
                desc.subsurface_color = _read_color(v)
            elif key == "anisotropy":  # a Volumetric medium's HG g
                desc.volumetric_anisotropy = float(v)
            elif key in ("density", "density_map"):
                grid = _load_density_grid(v)
                if grid is not None and builder is not None:
                    desc.density_grid = builder.add_density_grid(grid)
            elif key == "emittance":
                extra = set(v) - {"spectrum", "value", "emission_map", "profile"}
                if extra:
                    raise UnsupportedScene(f"emittance keys {sorted(extra)}")
                spectrum = _read_color(v.get("spectrum", [1.0, 1.0, 1.0]))
                desc.emission = np.float32(v.get("value", 1.0)) * spectrum
                if "emission_map" in v:
                    if kind_name == "Volumetric":
                        raise UnsupportedScene("an emission map on a Volumetric material")
                    desc.emission_tex = tex(v["emission_map"], srgb=False)
                if "profile" in v:
                    desc.ies = _load_profile(v["profile"], base_dir)
        break
    return desc


def _load_profile(v, base_dir: str) -> np.ndarray | None:
    """An emittance's {"file": "*.ies"} profile -> its bins, or None (with
    a warning) where the file cannot be read or parsed, as the JAX loader
    ignores it (zyg_tpu/scene/loader.py:391-401)."""
    if not isinstance(v, dict) or "file" not in v:
        raise UnsupportedScene(f"emittance profile {v!r} (an IES file is read)")
    path = os.path.join(base_dir, v["file"])
    try:
        with open(path, encoding="utf-8") as f:
            bins = ies_profile_bins(f.read())
    except OSError as e:
        warnings.warn(f"IES profile {path!r} not read ({e}); the emission is unprofiled",
                      stacklevel=2)
        return None
    if bins is None:
        warnings.warn(f"IES profile {path!r} not parsed; the emission is unprofiled", stacklevel=2)
    return bins


def _emissive_volumetric(m: MaterialDesc) -> bool:
    return m.kind == int(MaterialKind.VOLUMETRIC) and float(np.max(m.emission)) > 0.0


def material_features(kinds, roughness, color, subsurface, emission, texcoord=(),
                      ies=False) -> set:
    """The material features present, by the JAX loader's rules
    (zyg_tpu/scene/loader.py:1232-1315) over every material of the table:
    "ies" where a material has an IES profile (ies),
    "media" with any Glass or Volumetric material, "glass" with any Glass,
    "rough_glass" with any Glass rougher than MIN_ROUGHNESS * 1.001,
    "volumetric" with any Volumetric material, "vol_emission" with an
    emissive one and "spectral_media" where a Volumetric material's
    attenuation or subsurface colour is not grey; and "triplanar" where a
    texture's coordinate set (texcoord, one a texture) is not UV0."""
    kinds = [int(k) for k in kinds]
    glass = [float(r) for k, r in zip(kinds, roughness) if k == int(MaterialKind.GLASS)]
    vols = [i for i, k in enumerate(kinds) if k == int(MaterialKind.VOLUMETRIC)]
    feats = {"ies"} if ies else set()
    if glass or vols:
        feats.add("media")
    if glass:
        feats.add("glass")
    if any(r > MIN_ROUGHNESS * 1.001 for r in glass):
        feats.add("rough_glass")
    if vols:
        feats.add("volumetric")
    if any(float(np.max(np.asarray(emission[i]))) > 0.0 for i in vols):
        feats.add("vol_emission")
    if any(float(np.ptp(np.asarray(color[i]))) > 0.0
           or float(np.ptp(np.asarray(subsurface[i]))) > 0.0 for i in vols):
        feats.add("spectral_media")
    if any(int(tc) > 0 for tc in texcoord):
        feats.add("triplanar")
    return feats


# ---------------------------------------------------------------------------
# Scene building
# ---------------------------------------------------------------------------


@dataclass
class PropDesc:
    shape: int
    trafo: Transformation
    material: int
    visible_camera: bool = True
    visible_reflection: bool = True
    visible_shadow: bool = True
    is_light: bool = False
    mesh_id: int = -1  # index into SceneBuilder.meshes for mesh props


class SceneBuilder:
    def __init__(self, base_dir: str = ""):
        self.base_dir = base_dir  # image files resolve against it
        self.props: list[PropDesc] = []
        self.materials: list[MaterialDesc] = []
        self.meshes: list[HostMesh] = []
        self.density_grids: list[np.ndarray] = []
        self.textures = TextureBuilder()
        self._mat_by_name: dict[str, int] = {}
        self._mesh_by_name: dict[str, int] = {}
        self._tex_by_key: dict[tuple, int] = {}
        # Portal entities: {"trafo", "light" (index over the lights declared
        # so far), "prop" (the portal's prop once built, -1 when dropped)}
        self.portals: list[dict] = []
        # fallback material id 0 (ref createFallbackMaterial)
        self._fallback = self.add_material(MaterialDesc(color=np.array([1.0, 0.0, 0.6], np.float32)))

    def add_texture_image(self, image: np.ndarray, srgb: bool = False) -> int:
        """An image ([H, W, C] or [H, W]; uint8, uint16 or float32; srgb:
        its colour channels are sRGB-encoded) -> texture id for
        MaterialDesc's *_tex fields."""
        return self.textures.add(image, srgb=srgb)

    def load_texture(self, path: str, srgb: bool = False, clamp_u: bool = False,
                     clamp_v: bool = False, texcoord: int = 0) -> int:
        """An image file -> texture id, one texture for each (path, srgb,
        address, texcoord), as the JAX builder dedupes them."""
        key = (path, srgb, clamp_u, clamp_v, texcoord)
        if key not in self._tex_by_key:
            self._tex_by_key[key] = self.textures.add(
                load_image(path), srgb=srgb, clamp_u=clamp_u, clamp_v=clamp_v, texcoord=texcoord)
        return self._tex_by_key[key]

    def add_density_grid(self, grid: np.ndarray) -> int:
        """A host density grid (float32[nz, ny, nx]) -> its grid id for
        MaterialDesc.density_grid."""
        self.density_grids.append(np.asarray(grid, np.float32))
        return len(self.density_grids) - 1

    def add_material(self, desc: MaterialDesc, name: str | None = None) -> int:
        self.materials.append(desc)
        if name:
            self._mat_by_name[name] = len(self.materials) - 1
        return len(self.materials) - 1

    def material_id(self, name: str, local_materials: dict[str, dict]) -> int:
        if name in self._mat_by_name:
            return self._mat_by_name[name]
        if name in local_materials:
            return self.add_material(parse_material(local_materials[name], self, self.base_dir),
                                     name)
        return self._fallback

    def add_prop(self, desc: PropDesc) -> int:
        self.props.append(desc)
        return len(self.props) - 1

    def add_mesh(self, mesh: HostMesh, name: str | None = None) -> int:
        if name and name in self._mesh_by_name:
            return self._mesh_by_name[name]
        self.meshes.append(mesh)
        if name:
            self._mesh_by_name[name] = len(self.meshes) - 1
        return len(self.meshes) - 1

    def add_mesh_prop(self, mesh_id: int, trafo: Transformation, material: int, **kw) -> int:
        return self.add_prop(PropDesc(shape=int(ShapeType.TRIANGLE_MESH), trafo=trafo,
                                      material=material, mesh_id=mesh_id, **kw))

    def _light_weight(self, p: PropDesc) -> float:
        """Luminance-weighted emission times emitting area (4 pi for a dome;
        an emission map scales by its mean luminance); for a volume light
        times its world volume and its grid's mean density (a Volumetric
        material on another shape weighs 0)."""
        m = self.materials[p.material]
        lum = float(np.dot(np.asarray(LUMINANCE_WEIGHTS, np.float64), m.emission))
        if m.kind == int(MaterialKind.VOLUMETRIC):
            if lum <= 0.0 or p.shape != int(ShapeType.CUBE):
                return 0.0
            s = p.trafo.scale
            dens = 1.0
            if m.density_grid >= 0:
                # np.mean over the float32 grid, as the JAX loader computes it
                dens = float(np.mean(self.density_grids[m.density_grid]))
            return lum * float(s[0] * s[1] * s[2]) * max(dens, 1e-6)
        if m.emission_tex >= 0:
            img = np.asarray(self.textures.image(m.emission_tex), np.float64)
            lum *= float((img[..., :3] @ np.asarray(LUMINANCE_WEIGHTS, np.float64)).mean())
        if lum <= 0.0:
            return 0.0
        s = p.trafo.scale
        shape = ShapeType(p.shape)
        if shape == ShapeType.RECTANGLE:
            area = float(s[0] * s[1])
        elif shape == ShapeType.DISK:
            area = float(np.pi * (0.5 * s[0]) ** 2)
        elif shape == ShapeType.SPHERE:
            area = float(4.0 * np.pi * (0.5 * s[0]) ** 2)
        elif shape == ShapeType.CUBE:
            area = float(2.0 * (s[0] * s[1] + s[0] * s[2] + s[1] * s[2]))
        elif shape == ShapeType.DISTANT:
            area = float(2.0 * np.pi * (1.0 - np.sqrt(1.0 / (s[0] ** 2 + 1.0))))
        elif shape in (ShapeType.CANOPY, ShapeType.DOME):
            area = 4.0 * np.pi
        else:
            raise UnsupportedScene("emissive meshes")
        if m.two_sided:
            area *= 2.0
        return lum * area

    def build(self, device: torch.device | str = "cpu") -> SceneData:
        props = self.props
        if not props:
            raise UnsupportedScene("scene without props")
        # an emissive Volumetric Cube is a volume light (ref scene.zig
        # createLight; zyg_tpu/scene/loader.py:1063-1074); on another shape
        # it only glows along the walks
        for p in props:
            if _emissive_volumetric(self.materials[p.material]) and p.shape == int(ShapeType.CUBE):
                p.is_light = True
        portal_pending = self._link_portals()
        analytic = [i for i, p in enumerate(props) if p.mesh_id < 0]
        if len(analytic) > _MAX_PROPS:
            raise UnsupportedScene(f"{len(analytic)} analytic props (at most {_MAX_PROPS})")
        light_props = [i for i, p in enumerate(props) if p.is_light and self._light_weight(p) > 0.0]
        vol_light = [self.materials[props[i].material].kind == int(MaterialKind.VOLUMETRIC)
                     for i in light_props]
        for i, v in zip(light_props, vol_light):
            if not v and props[i].shape not in {int(s) for s in _LIGHT_SHAPES}:
                raise UnsupportedScene(f"{ShapeType(props[i].shape).name.capitalize()} lights "
                                       "(the port samples Rectangle, Dome, Distant and volume "
                                       "lights)")
        if not light_props:
            raise UnsupportedScene("a scene without an emitting light")
        for d in self.materials:
            for tid in (d.color_tex, d.roughness_tex, d.emission_tex, d.normal_tex):
                if not -1 <= tid < len(self.textures):
                    raise UnsupportedScene(f"texture id {tid} out of range")
            if not -1 <= d.density_grid < len(self.density_grids):
                raise UnsupportedScene(f"density grid id {d.density_grid} out of range")
        # participating media: a Volumetric prop never blocks a shadow ray,
        # NEE multiplies by its transmittance instead (ref scene.zig
        # visibility -> propTransmittance; zyg_tpu/scene/loader.py:1199-1205)
        volume_props = []
        for i, p in enumerate(props):
            m = self.materials[p.material]
            if m.kind == int(MaterialKind.VOLUMETRIC):
                if p.mesh_id >= 0:
                    what = ("an emissive Volumetric material (vol_emission)"
                            if _emissive_volumetric(m) else "a Volumetric material")
                    raise UnsupportedScene(f"{what} on a mesh prop (the chord through a mesh "
                                           "interior)")
                volume_props.append((i, p.material, m.density_grid, p.shape))
                p.visible_shadow = False
        weights = np.array([self._light_weight(props[i]) for i in light_props], np.float32)
        total = weights.sum()
        cdf = np.concatenate([[0.0], np.cumsum(weights) / (total if total > 0 else 1.0)]).astype(np.float32)
        cdf[-1] = 1.0
        prop_light = np.full(len(props), -1, np.int32)
        for li, pi in enumerate(light_props):
            prop_light[pi] = li
        # the portal image's windowed distributions (ref light_material.zig
        # PortalLuminanceContext), keyed by (light index, portal prop)
        portals = {}
        for pe in portal_pending:
            pp = props[pe["prop"]]
            dome_rot = np.asarray(props[pe["dome_prop"]].trafo.rotation, np.float64)
            lum, _ = build_portal_dist(self.textures.image(self.materials[pp.material].emission_tex),
                                       dome_rot, np.asarray(pp.trafo.rotation, np.float64))
            portals[(light_props.index(pe["prop"]), pe["prop"])] = make_portal_dist(lum, dome_rot)
        # the many-light tree over the finite lights (ref light_tree_builder.zig)
        light_tree = None
        if len(light_props) >= 2 and float(weights.sum()) > 0.0:
            bounds = [self._light_bounds(props[pi]) for pi in light_props]
            light_tree = build_light_tree(
                np.stack([b[0] for b in bounds]),
                np.asarray([b[1] for b in bounds], np.float32),
                np.stack([b[2] for b in bounds]),
                weights,
                np.asarray([self.materials[props[i].material].two_sided for i in light_props],
                           bool),
                np.asarray([b[3] for b in bounds], bool),
            )

        groups: dict[int, list[int]] = {}
        for i in analytic:
            groups.setdefault(props[i].shape, []).append(i)
        meshes, instances = self._build_meshes()
        # volume lights over a density grid sample their interior by density
        vol_light_dist = {
            li: Distribution3D.build(self.density_grids[self.materials[props[pi].material]
                                                        .density_grid])
            for li, pi in enumerate(light_props)
            if vol_light[li] and self.materials[props[pi].material].density_grid >= 0
        }
        # env-map importance sampling of a dome or canopy with an emission map
        env_entries = [
            (self.textures.image(self.materials[props[pi].material].emission_tex),
             props[pi].shape == int(ShapeType.CANOPY), li)
            for li, pi in enumerate(light_props)
            if props[pi].shape in (int(ShapeType.CANOPY), int(ShapeType.DOME))
            and self.materials[props[pi].material].emission_tex >= 0
        ]

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        mats = self.materials
        f32, i32 = torch.float32, torch.int32
        return SceneData(
            prop_shape=t([p.shape for p in props], i32),
            prop_rot=t(np.stack([p.trafo.rotation for p in props]), f32),
            prop_pos=t(np.stack([p.trafo.position for p in props]), f32),
            prop_scale=t(np.stack([p.trafo.scale for p in props]), f32),
            prop_material=t([p.material for p in props], i32),
            prop_visible_camera=t([p.visible_camera for p in props], torch.bool),
            prop_visible_reflection=t([p.visible_reflection for p in props], torch.bool),
            prop_visible_shadow=t([p.visible_shadow for p in props], torch.bool),
            prop_light=t(prop_light, i32),
            materials=Materials(
                kind=t([d.kind for d in mats], i32),
                color=t(np.stack([d.color for d in mats]), f32),
                roughness=t([d.roughness for d in mats], f32),
                metallic=t([d.metallic for d in mats], f32),
                ior=t([d.ior for d in mats], f32),
                specular=t([d.specular for d in mats], f32),
                emission=t(np.stack([d.emission for d in mats]), f32),
                two_sided=t([d.two_sided for d in mats], torch.bool),
                color_tex=t([d.color_tex for d in mats], i32),
                roughness_tex=t([d.roughness_tex for d in mats], i32),
                emission_tex=t([d.emission_tex for d in mats], i32),
                normal_tex=t([d.normal_tex for d in mats], i32),
                attenuation_distance=t([d.attenuation_distance for d in mats], f32),
                priority=t([d.priority for d in mats], i32),
                subsurface_color=t(np.stack([d.subsurface_color for d in mats]), f32),
                volumetric_anisotropy=t([d.volumetric_anisotropy for d in mats], f32),
                density_grid=t([d.density_grid for d in mats], i32),
                ies=t(np.stack([d.ies if d.ies is not None else np.ones(PROFILE_BINS, np.float32)
                                for d in mats]), f32),
            ),
            lights=Lights(
                prop=t(light_props, i32),
                two_sided=t([mats[props[i].material].two_sided for i in light_props], torch.bool),
                cdf=t(cdf, f32),
                volume=t(vol_light, torch.bool),
            ),
            prop_groups={k: t(v, i32) for k, v in sorted(groups.items())},
            meshes=meshes,
            mesh_instances=instances,
            textures=self.textures.build(),
            env=build_env_sampler(env_entries),
            light_tree=light_tree,
            grids=build_grid_arena(self.density_grids) if self.density_grids else None,
            mat_features=material_features([d.kind for d in mats], [d.roughness for d in mats],
                                           [d.color for d in mats],
                                           [d.subsurface_color for d in mats],
                                           [d.emission for d in mats], self.textures.texcoords,
                                           any(d.ies is not None for d in mats)),
            volume_props=tuple(volume_props),
            vol_light_dist=vol_light_dist or None,
            portals=portals or None,
        ).to(device)

    def _link_portals(self) -> list[dict]:
        """Link each Portal entity to the light its "light" index names
        among the lights declared so far (ref scene_loader.zig loadPortal;
        zyg_tpu/scene/loader.py:1075-1118): that light, an image-mapped
        dome, becomes an invisible prop that is no light, and a Rectangle
        light with its material, invisible to shadow rays, is appended in
        its place. A link to anything else is dropped with a warning, as
        the JAX loader drops it. Returns the linked entries."""
        props = self.props
        declared = [i for i, p in enumerate(props) if p.is_light and self._light_weight(p) > 0.0]
        for pe in self.portals:
            if pe["prop"] is not None:
                continue
            li = pe["light"]
            if li >= len(declared):
                warnings.warn(f"Portal links undefined light {li}; the portal is dropped",
                              stacklevel=3)
                pe["prop"] = -1
                continue
            linked = declared[li]
            lp = props[linked]
            if lp.shape != int(ShapeType.DOME) or self.materials[lp.material].emission_tex < 0:
                warnings.warn("Portal link must be an image-mapped dome light; the portal is "
                              "dropped", stacklevel=3)
                pe["prop"] = -1
                continue
            lp.is_light = lp.visible_camera = lp.visible_reflection = lp.visible_shadow = False
            props.append(PropDesc(shape=int(ShapeType.RECTANGLE), trafo=pe["trafo"],
                                  material=lp.material, is_light=True, visible_shadow=False))
            pe["prop"], pe["dome_prop"] = len(props) - 1, linked
        return [pe for pe in self.portals if pe["prop"] >= 0]

    @staticmethod
    def _light_bounds(p: PropDesc):
        """(center [3], radius, cone [4], finite) of a light prop: the
        bounding sphere and normal cone the tree's importance uses (ref
        light_tree_builder.zig light properties)."""
        t = p.trafo
        pos = np.asarray(t.position, np.float32)
        if p.shape == int(ShapeType.RECTANGLE):
            s = np.asarray(t.scale, np.float32)
            rot = np.asarray(t.rotation, np.float32)
            r = 0.5 * float(np.hypot(s[0], s[1]))
            return pos, r, np.concatenate([rot[2], [1.0]]).astype(np.float32), True
        if p.shape == int(ShapeType.CUBE):  # a volume light: its bounding sphere, all directions
            r = 0.5 * float(np.linalg.norm(np.asarray(t.scale, np.float32)))
            return pos, r, np.array([0.0, 0.0, 1.0, -1.0], np.float32), True
        # infinite shapes (distant, dome)
        return pos, 0.0, np.array([0.0, 0.0, 1.0, -1.0], np.float32), False

    def _build_meshes(self):
        """(arena, instance table) over the mesh props, or (None, None)."""
        mesh_props = [i for i, p in enumerate(self.props) if p.mesh_id >= 0]
        if not mesh_props:
            return None, None
        arena, host = build_arena(self.meshes)
        instances = []
        for i in mesh_props:
            p = self.props[i]
            instances.append({
                "prop": i, "mesh": p.mesh_id, "rot": p.trafo.rotation,
                "pos": p.trafo.position, "scale": p.trafo.scale,
                "vis": (p.visible_camera, p.visible_reflection, p.visible_shadow),
            })
        return arena, build_instance_table(host, instances)


_ENTITY_KEYS = {"type", "shape", "materials", "transformation", "visibility",
                "occluding", "entities"}


_SKY_KEYS = {"type", "parameters"}
_PORTAL_KEYS = {"type", "shape", "light", "transformation"}


def _load_sky(e: dict, builder: SceneBuilder) -> None:
    """Sky entity -> baked Preetham dome + distant sun (as the JAX
    package's _load_sky; ref core/sky/sky.zig bakes its Prague sky to an
    env image the same way)."""
    extra = set(e) - _SKY_KEYS
    params = e.get("parameters", {})
    extra |= set(params) - {"sun", "turbidity"}
    sun_node = params.get("sun", {})
    extra |= set(sun_node) - {"rotation"}
    if extra:
        raise UnsupportedScene(f"Sky keys {sorted(extra)}")
    turbidity = float(params.get("turbidity", 2.5))
    if "rotation" in sun_node:
        sun_rot = rotation_matrix_from_euler_degrees(_read_vec3(sun_node["rotation"]))
    else:
        # default: sun overhead shining straight down (ref sky.zig:41)
        sun_rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32)
    sun_dir = sun_rot[2]

    tex = builder.add_texture_image(bake_sky(sun_dir, turbidity))
    sky_mat = builder.add_material(MaterialDesc(
        kind=int(MaterialKind.LIGHT), emission=np.ones(3, np.float32), emission_tex=tex))
    builder.add_prop(PropDesc(shape=int(ShapeType.DOME), trafo=Transformation(), material=sky_mat,
                              visible_shadow=False, is_light=True))
    sun_mat = builder.add_material(MaterialDesc(kind=int(MaterialKind.LIGHT),
                                                emission=sun_radiance(sun_dir, turbidity)))
    radius = float(np.tan(SUN_ANGULAR_RADIUS))
    builder.add_prop(PropDesc(
        shape=int(ShapeType.DISTANT),
        trafo=Transformation(rotation=sun_rot.astype(np.float32),
                             scale=np.array([radius, radius, radius], np.float32)),
        material=sun_mat, visible_shadow=False, is_light=True,
    ))


def _load_portal(e: dict, parent: Transformation, builder: SceneBuilder) -> None:
    """A Portal entity: a Rectangle linked to the light its "light" index
    names (zyg_tpu/scene/loader.py:1602-1614); SceneBuilder.build links
    it. Another shape is dropped with a warning, as the JAX loader does."""
    extra = set(e) - _PORTAL_KEYS
    if extra:
        raise UnsupportedScene(f"Portal keys {sorted(extra)}")
    stype = e.get("shape", {}).get("type")
    if stype not in (None, "Rectangle"):
        warnings.warn(f"Portal shape {stype!r} unsupported (Rectangle only); the portal is "
                      "dropped", stacklevel=3)
        return
    builder.portals.append({"trafo": parent.compose(read_transformation(e.get("transformation"))),
                            "light": int(e.get("light", 0)), "prop": None})


def _load_entities(entities, parent: Transformation, local_materials, builder: SceneBuilder):
    for e in entities:
        etype = e.get("type")
        if etype == "Sky":
            _load_sky(e, builder)
            continue
        if etype == "Portal":
            _load_portal(e, parent, builder)
            continue
        if etype not in ("Prop", "Light"):
            raise UnsupportedScene(f"entity {etype or sorted(e)!r}")
        extra = set(e) - _ENTITY_KEYS
        if extra:
            raise UnsupportedScene(f"entity keys {sorted(extra)}")
        trafo = parent.compose(read_transformation(e.get("transformation")))
        shape_node = e.get("shape", {})
        stype = shape_node.get("type")
        mesh_id = -1
        if stype in _SHAPE_NAMES:
            shape = int(_SHAPE_NAMES[stype])
        elif "file" in shape_node:
            fname = shape_node["file"]
            mesh_id = builder._mesh_by_name.get(fname, -1)
            if mesh_id < 0:
                mesh_id = builder.add_mesh(load_mesh_file(fname), fname)
            shape = int(ShapeType.TRIANGLE_MESH)
        else:
            raise UnsupportedScene(f"shape {shape_node!r}")
        mat_names = e.get("materials", [])
        mat = builder.material_id(mat_names[0], local_materials) if mat_names else builder._fallback
        is_light = etype == "Light"
        vis = e.get("visibility", {})
        # lights default to non-occluding (ref scene_loader.zig loadProp)
        occluding = bool(e.get("occluding", not is_light))
        builder.add_prop(PropDesc(
            shape=shape,
            trafo=trafo,
            material=mat,
            visible_camera=bool(vis.get("in_camera", True)),
            visible_reflection=bool(vis.get("in_reflection", True)),
            visible_shadow=occluding and bool(vis.get("in_shadow", True)),
            is_light=is_light,
            mesh_id=mesh_id,
        ))
        if "entities" in e:
            _load_entities(e["entities"], trafo, local_materials, builder)


def load_scene_dict(root: dict, device: torch.device | str = "cpu", base_dir: str = "") -> SceneData:
    """A scene JSON dict -> SceneData; image files resolve against base_dir."""
    builder = SceneBuilder(base_dir)
    local_materials = {m["name"]: m for m in root.get("materials", []) if "name" in m}
    _load_entities(root.get("entities", []), Transformation(), local_materials, builder)
    return builder.build(device)


def load_scene_file(path: str, device: torch.device | str = "cpu") -> SceneData:
    with open(path, encoding="utf-8") as f:
        root = json.load(f)
    return load_scene_dict(root, device, base_dir=os.path.dirname(os.path.abspath(path)))


# ---------------------------------------------------------------------------
# Hand-off between the JAX package and the port
# ---------------------------------------------------------------------------

_PLAIN = ("prop_shape", "prop_rot", "prop_pos", "prop_scale", "prop_material",
          "prop_visible_camera", "prop_visible_reflection", "prop_visible_shadow",
          "prop_light")
_MATERIAL = ("kind", "color", "roughness", "metallic", "ior", "specular", "emission",
             "two_sided", "color_tex", "roughness_tex", "emission_tex", "normal_tex",
             "attenuation_distance", "priority", "subsurface_color", "volumetric_anisotropy",
             "density_grid", "ies")
# the material features the port renders (the general bounce's, and
# "triplanar", which only the textured bounce renders; the JAX package
# names more, each of which the port refuses)
_FEATURES = {"glass", "rough_glass", "media", "volumetric", "spectral_media", "vol_emission",
             "triplanar", "ies"}
_LIGHT = ("prop", "two_sided", "cdf", "volume")
_DIST3 = ("slice_cdf", "row_cdf", "col_cdf", "pdf_grid")
_ARENA = ("node_rows", "tri_rows", "attr_rows", "mesh_root")
_INSTANCES = ("wmin", "wmax", "trafo", "vis")
_TEXTURES = ("data", "offset", "width", "height", "address", "texcoord")
_ENV = ("table", "light")


def scene_arrays(scene) -> dict[str, np.ndarray]:
    """The fields the port reads, as numpy arrays, from either package's
    SceneData: keys "prop_*", "materials.<f>", "lights.<f>",
    "prop_groups.<shape>", for mesh scenes "meshes.<f>" (with
    "meshes.max_depth") and "mesh_instances.<f>", for textured scenes
    "textures.<f>" (with "textures.procedurals", the repr of each
    (texture id, kind, params) as a string array), for a mapped dome
    "env.<f>" (with "env.width" and
    "env.height"), and for a light tree "light_tree.<f>" (with
    "light_tree.depth", "light_tree.inf_weight", "light_tree.num_finite"),
    for density grids "grids.<f>" (with "grids.sparse"), "volume_props"
    (int64 [K, 4] rows), for volume lights over a grid
    "vol_light_dist.<light>.<f>", for portal lights
    "portals.<light>.<prop>.<f>", with a mapped dome or canopy
    "env.canopy" (a bool an entry), and "mat_features", the sorted feature
    names as a string array. A JAX scene with a feature outside the port's raises
    UnsupportedScene naming it."""
    def arr(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    d = {k: arr(getattr(scene, k)) for k in _PLAIN}
    mats = scene.materials
    for k in _MATERIAL:
        v = getattr(mats, k)
        # a hand-built JAX table may leave the priorities (all 0), the
        # density grids and normal maps (all -1) and the profiles (all 1) unset
        if v is None and k == "ies":
            v = np.ones(arr(mats.kind).shape + (PROFILE_BINS,), np.float32)
        elif v is None:
            v = np.full(arr(mats.kind).shape, -1 if k in ("density_grid", "normal_tex") else 0,
                        np.int32)
        d[f"materials.{k}"] = arr(v)
    feats = scene.mat_features
    tex = scene.textures
    texcoord = None
    if tex is not None:
        # a hand-built JAX arena may leave the coordinate sets (all UV0) unset
        texcoord = (arr(tex.texcoord) if getattr(tex, "texcoord", None) is not None
                    else np.zeros(arr(tex.offset).shape, np.int32))
    if feats is None:  # the JAX "all features" default: derive them
        feats = material_features(d["materials.kind"], d["materials.roughness"],
                                  d["materials.color"], d["materials.subsurface_color"],
                                  d["materials.emission"], () if texcoord is None else texcoord,
                                  bool((d["materials.ies"] != 1.0).any()))
    extra = set(feats) - _FEATURES
    if extra:
        raise UnsupportedScene(f"material features {sorted(extra)}")
    d["mat_features"] = np.array(sorted(feats), dtype=np.str_)
    d["volume_props"] = np.asarray(sorted(tuple(int(x) for x in r) for r in scene.volume_props),
                                   np.int64).reshape(-1, 4)
    if scene.grids is not None:
        d.update({f"grids.{k}": arr(getattr(scene.grids, k)) for k in _GRID_FIELDS})
        d["grids.sparse"] = np.asarray(bool(scene.grids.sparse))
    for k in _LIGHT:
        v = getattr(scene.lights, k)
        # a hand-built JAX scene may leave the volume flags (all False) unset
        d[f"lights.{k}"] = (arr(v) if v is not None
                            else np.zeros(arr(scene.lights.prop).shape, bool))
    for li, dist in sorted((scene.vol_light_dist or {}).items()):
        d.update({f"vol_light_dist.{int(li)}.{k}": arr(getattr(dist, k)) for k in _DIST3})
    d.update({f"prop_groups.{int(k)}": arr(v) for k, v in (scene.prop_groups or {}).items()})
    if scene.meshes is not None:
        m = scene.meshes
        d.update({f"meshes.{k}": arr(getattr(m, k)) for k in _ARENA})
        # the JAX arena carries its depth as the static key of `meta`
        depth = m.max_depth if hasattr(m, "max_depth") else next(iter(m.meta))[0]
        d["meshes.max_depth"] = np.asarray(depth, np.int64)
        d.update({f"mesh_instances.{k}": arr(getattr(scene.mesh_instances, k))
                  for k in _INSTANCES})
    if tex is not None:
        d.update({f"textures.{k}": arr(getattr(tex, k)) for k in _TEXTURES if k != "texcoord"})
        d["textures.texcoord"] = texcoord
        # the JAX arena keys its procedurals (tid, kind, params) in a dict
        d["textures.procedurals"] = np.array([repr(tuple(p)) for p in (tex.procedurals or ())],
                                             dtype=np.str_)
    if scene.env is not None:
        d.update({f"env.{k}": arr(getattr(scene.env, k)) for k in _ENV})
        d["env.width"] = np.asarray(scene.env.width, np.int64)
        d["env.height"] = np.asarray(scene.env.height, np.int64)
        d["env.canopy"] = np.asarray(tuple(scene.env.canopy), bool)
    for (li, pp), pd in sorted((scene.portals or {}).items()):
        d.update({f"portals.{int(li)}.{int(pp)}.{k}": arr(getattr(pd, k))
                  for k in _PORTAL_FIELDS})
    tree = scene.light_tree
    if tree is not None:
        d.update({f"light_tree.{k}": arr(getattr(tree, k)) for k in _TREE_FIELDS})
        d["light_tree.depth"] = np.asarray(tree.depth, np.int64)
        d["light_tree.inf_weight"] = np.asarray(tree.inf_weight, np.float64)
        d["light_tree.num_finite"] = np.asarray(tree.num_finite, np.int64)
    return d


def scene_from_jax_arrays(d: dict[str, np.ndarray], device: torch.device | str = "cpu") -> SceneData:
    """Build the port's scene from the JAX SceneData fields (numpy arrays,
    keyed as `scene_arrays` returns them)."""
    def t(k):
        return torch.as_tensor(np.array(d[k]), device=device)

    groups = {int(k.split(".", 1)[1]): t(k) for k in d if k.startswith("prop_groups.")}
    meshes = instances = None
    if "meshes.node_rows" in d:
        meshes = MeshArena(**{k: t(f"meshes.{k}") for k in _ARENA},
                           max_depth=int(d["meshes.max_depth"]))
        instances = InstanceTable(**{k: t(f"mesh_instances.{k}") for k in _INSTANCES})
    textures = env = None
    if "textures.data" in d:
        textures = TextureArena(
            **{k: t(f"textures.{k}") for k in _TEXTURES},
            procedurals=tuple(ast.literal_eval(str(p)) for p in d["textures.procedurals"]))
    if "env.table" in d:
        env = EnvSampler(**{k: t(f"env.{k}") for k in _ENV}, width=int(d["env.width"]),
                         height=int(d["env.height"]),
                         canopy=tuple(bool(c) for c in d["env.canopy"]))
    portal_keys = sorted({tuple(int(x) for x in k.split(".")[1:3]) for k in d
                          if k.startswith("portals.")})
    portals = {(li, pp): PortalDist(**{f: t(f"portals.{li}.{pp}.{f}") for f in _PORTAL_FIELDS})
               for li, pp in portal_keys}
    vol_light_dist = {
        int(li): Distribution3D(**{f: t(f"vol_light_dist.{li}.{f}") for f in _DIST3})
        for li in sorted({k.split(".")[1] for k in d if k.startswith("vol_light_dist.")}, key=int)
    }
    grids = None
    if "grids.data" in d:
        grids = GridArena(**{k: t(f"grids.{k}") for k in _GRID_FIELDS},
                          sparse=bool(d["grids.sparse"]))
    light_tree = None
    if "light_tree.center" in d:
        light_tree = LightTree(**{k: t(f"light_tree.{k}") for k in _TREE_FIELDS},
                               depth=int(d["light_tree.depth"]),
                               inf_weight=float(d["light_tree.inf_weight"]),
                               num_finite=int(d["light_tree.num_finite"]))
    return SceneData(
        **{k: t(k) for k in _PLAIN},
        materials=Materials(**{k: t(f"materials.{k}") for k in _MATERIAL}),
        lights=Lights(**{k: t(f"lights.{k}") for k in _LIGHT}),
        prop_groups=dict(sorted(groups.items())),
        meshes=meshes,
        mesh_instances=instances,
        textures=textures,
        env=env,
        light_tree=light_tree,
        grids=grids,
        mat_features={str(f) for f in d["mat_features"]},
        volume_props=tuple(tuple(int(x) for x in r) for r in d["volume_props"]),
        vol_light_dist=vol_light_dist or None,
        portals=portals or None,
    )
