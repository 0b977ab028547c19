"""Frozen copy of chess2rt_tpu_torch/models/packed.py at commit d735142 for the
benchmark's plain reference (the bump derivative map of imageio/bitmap.py
inlined).  It imports nothing of the program.

ScenePacked: the device-side scene representation, as torch tensors.

Counterpart of chess2rt_tpu/models/packed.py.  The reference's object graph
(Node -> Geometry/Shader/Texture, scene.d:38-96) becomes two things:

* ``ScenePacked`` — a dataclass of SoA tensors on one device: geometry
  parameters, node transforms, light and material tables, camera
  parameters, texture params and bitmap texels.
* ``SceneStatic`` — hashable static structure: per-node CSG expression
  trees, shader/texture kinds, frame size and engine knobs.  Copied from the
  JAX package field for field, so both packages agree on what a scene is.

Geometry expressions (``GeomExpr``) are nested tuples:
    ("plane", i) | ("sphere", i) | ("cube", i)
    ("csg", op, left_expr, right_expr)        op in {"union","inter","diff"}
with ``i`` indexing the per-kind parameter tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import types as T

# shader kinds
LAMBERT, PHONG, REFLECTION, REFRACTION = 0, 1, 2, 3
# texture kinds
TEX_NONE, TEX_CHECKER, TEX_PROC2, TEX_BITMAP = 0, 1, 2, 3

_SHADER_KIND = {T.Lambert: LAMBERT, T.Phong: PHONG, T.Reflection: REFLECTION, T.Refraction: REFRACTION}


def differentiate(rgb: np.ndarray) -> np.ndarray:
    """Finite-difference derivative map (chess2rt_tpu_torch/imageio/bitmap.py
    ``differentiate``): red = d(intensity)/dx, green = d/dy, blue = 0, with
    wrap-around neighbours."""
    lum = np.asarray(rgb, dtype=np.float32).mean(axis=-1)
    out = np.zeros(lum.shape + (3,), dtype=np.float32)
    out[..., 0] = lum - np.roll(lum, -1, axis=1)
    out[..., 1] = lum - np.roll(lum, -1, axis=0)
    return out


def _to(obj, device):
    return dataclasses.replace(
        obj,
        **{
            f.name: (getattr(obj, f.name).to(device) if isinstance(getattr(obj, f.name), torch.Tensor)
                     else _to(getattr(obj, f.name), device))
            for f in dataclasses.fields(obj)
        },
    )


@dataclass
class CameraPacked:
    """Camera parameters (camera.d:29-53), 0-d or [3] tensors."""

    pos: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    roll: torch.Tensor
    fov: torch.Tensor
    focal_plane_dist: torch.Tensor
    disc_multiplier: torch.Tensor
    stereo_separation: torch.Tensor

    def to(self, device) -> "CameraPacked":
        return _to(self, device)


@dataclass
class ScenePacked:
    """SoA parameter tables.  Empty kinds hold shape-(0, ...) tensors."""

    # leaf geometry tables
    plane_y: torch.Tensor
    plane_limit: torch.Tensor
    sphere_center: torch.Tensor  # [Ns, 3]
    sphere_r: torch.Tensor
    cube_center: torch.Tensor  # [Nc, 3]
    cube_side: torch.Tensor

    # node transforms (node.d, transform.d); inverses are derived per call
    node_matrix: torch.Tensor  # [Nn, 3, 3]
    node_offset: torch.Tensor  # [Nn, 3]

    # lights (light.d:52-89)
    light_pos: torch.Tensor  # [L, 3]
    light_color: torch.Tensor  # [L, 3]
    light_power: torch.Tensor  # [L]

    # material table indexed by node id
    mat_color: torch.Tensor  # [Nn, 3]
    mat_exponent: torch.Tensor  # [Nn]
    mat_strength: torch.Tensor  # [Nn]
    mat_ior: torch.Tensor  # [Nn]

    # texture parameter tables indexed by node id (zeros where unused)
    checker_c1: torch.Tensor  # [Nn, 3]
    checker_c2: torch.Tensor  # [Nn, 3]
    checker_size: torch.Tensor  # [Nn]
    proc2_color_u: torch.Tensor  # [Nn, 3, 3]
    proc2_color_v: torch.Tensor  # [Nn, 3, 3]
    proc2_freq_u: torch.Tensor  # [Nn, 3]
    proc2_freq_v: torch.Tensor  # [Nn, 3]
    bitmap_scaling: torch.Tensor  # [Nn]

    # stacked bitmap atlas [Tb, Hmax, Wmax, 3] (linear float) + true sizes
    bitmap_atlas: torch.Tensor
    bitmap_hw: torch.Tensor  # [Tb, 2] float (h, w)

    # bump-map extension: derivative maps [Tp, Hmax, Wmax, 3] + per-node
    # scaling/strength
    bump_atlas: torch.Tensor
    bump_scaling: torch.Tensor  # [Nn]
    bump_strength: torch.Tensor  # [Nn]

    # environment cubemap [6, S, S, 3] (zeros-shaped [0,1,1,3] when absent)
    env_cubemap: torch.Tensor

    ambient: torch.Tensor  # [3]
    camera: CameraPacked

    @property
    def dtype(self):
        return self.node_matrix.dtype

    @property
    def device(self):
        return self.node_matrix.device

    def to(self, device) -> "ScenePacked":
        return _to(self, device)


@dataclass(frozen=True)
class NodeStatic:
    geom: Tuple  # GeomExpr
    shader_kind: int
    tex_kind: int
    bitmap_idx: int  # row in the atlas (-1 if not a bitmap texture)
    identity_transform: bool
    offset_only: bool
    bump_idx: int = -1  # row in the bump atlas (-1 = no bump map)


@dataclass(frozen=True)
class SceneStatic:
    """Hashable structure + engine knobs (global_settings.d:5-78).  The
    field set is the JAX package's, so a static from either package
    describes the same scene.  The engine's modes are honoured where the
    JAX package honours them: ``gi_path_batch`` (ops/gi.py),
    ``bounce_mode``, ``texel_tap_reuse`` and ``texel_reuse_capacity``
    (ops/flagship.py), ``texel_grad_mode`` (ops/shade.py).  The two knobs
    that only steer JAX/TPU machinery, ``use_pallas`` and
    ``interpret_pallas``, are carried and ignored here."""

    nodes: Tuple[NodeStatic, ...]
    n_lights: int
    width: int
    height: int
    has_env: bool = False
    bitmap_sizes: Tuple[Tuple[int, int], ...] = ()
    bump_sizes: Tuple[Tuple[int, int], ...] = ()
    max_trace_depth: int = 4
    aa_enabled: bool = True
    aa_adaptive: bool = False
    aa_capacity: Optional[int] = None
    dof: bool = False
    dof_samples: int = 25
    gi_enabled: bool = False
    paths_per_pixel: int = 40
    stereo: bool = False
    gi_multiplier_quirk: bool = True
    gi_point_light_direct: bool = False
    fast_forward: bool = False
    compensated_raygen: bool = False
    chunk_pixels: Optional[int] = None
    bounce_capacity: Optional[int] = None
    bounce_mode: str = "block"
    bounce_block_capacity: Optional[int] = None
    gi_path_batch: Optional[int] = None
    gi_remat_paths: bool = False
    train_textures: bool = True
    texel_tap_reuse: bool = False
    texel_reuse_capacity: Optional[int] = None
    texel_grad_mode: str = "histogram"
    use_pallas: bool = False
    interpret_pallas: bool = False
    remat_rounds: bool = True

    @property
    def tex_kinds_present(self):
        return frozenset(n.tex_kind for n in self.nodes)

    @property
    def shader_kinds_present(self):
        return frozenset(n.shader_kind for n in self.nodes)

    @property
    def has_bump(self) -> bool:
        return any(n.bump_idx >= 0 for n in self.nodes)

    @property
    def inf_dist(self) -> float:
        return 1e30  # f32-safe stand-in for the reference's 1e99 seed


def leaf_table(static: SceneStatic):
    """Global enumeration of geometry LEAVES in left-then-right traversal
    order: returns (leaves, node_base) with leaves[g] = (node_idx, kind,
    table_idx) and node_base[i] = global id of node i's first leaf."""
    leaves = []
    node_base = []
    for i, ns in enumerate(static.nodes):
        node_base.append(len(leaves))

        def walk(e, i=i):
            if e[0] == "csg":
                walk(e[2])
                walk(e[3])
            else:
                leaves.append((i, e[0], e[1]))

        walk(ns.geom)
    return leaves, node_base


def max_hits(expr: Tuple) -> int:
    """Static per-ray hit capacity of a geometry expression (SURVEY.md §7.2)."""
    if expr[0] == "plane":
        return 1
    if expr[0] in ("sphere", "cube"):
        return 2
    return max_hits(expr[2]) + max_hits(expr[3])


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------


def _geom_expr(geom: T.Geometry, tables) -> Tuple:
    if isinstance(geom, T.Plane):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["plane_y"])
            tables["plane_y"].append(geom.y)
            tables["plane_limit"].append(geom.limit if np.isfinite(geom.limit) else 1e30)
        return ("plane", tables["geom_ids"][key])
    if isinstance(geom, T.Sphere):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["sphere_r"])
            tables["sphere_center"].append(geom.center)
            tables["sphere_r"].append(geom.R)
        return ("sphere", tables["geom_ids"][key])
    if isinstance(geom, T.Cube):
        key = id(geom)
        if key not in tables["geom_ids"]:
            tables["geom_ids"][key] = len(tables["cube_side"])
            tables["cube_center"].append(geom.center)
            tables["cube_side"].append(geom.side)
        return ("cube", tables["geom_ids"][key])
    if isinstance(geom, T.CsgOp):
        left = _geom_expr(geom.left, tables)
        right = _geom_expr(geom.right, tables)
        return ("csg", geom.op, left, right)
    raise TypeError(type(geom))


def _resolve_device(device, who: str) -> torch.device:
    """The device an entry point places a scene on: the caller's, or the
    current CUDA device when none is given.  Without a card and without
    ``device=`` it raises: nothing carries on on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device; pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


def pack_scene(
    scene: T.Scene, dtype=torch.float32, device=None
) -> Tuple[ScenePacked, SceneStatic]:
    """Scene (host object model) -> (ScenePacked on ``device``, SceneStatic).
    ``device=None`` is the current CUDA device (see ``_resolve_device``).

    The tables are assembled in numpy exactly as the JAX packer assembles
    them (float64 host values, one rounding to ``dtype``)."""
    device = _resolve_device(device, "pack_scene")
    tables = {
        "geom_ids": {},
        "plane_y": [],
        "plane_limit": [],
        "sphere_center": [],
        "sphere_r": [],
        "cube_center": [],
        "cube_side": [],
    }

    nn = len(scene.nodes)
    node_static = []
    node_matrix = np.zeros((nn, 3, 3))
    node_offset = np.zeros((nn, 3))
    mat_color = np.ones((nn, 3), dtype=np.float32)
    mat_exponent = np.ones(nn, dtype=np.float32)
    mat_strength = np.ones(nn, dtype=np.float32)
    mat_ior = np.full(nn, 1.33, dtype=np.float32)
    checker_c1 = np.zeros((nn, 3), dtype=np.float32)
    checker_c2 = np.zeros((nn, 3), dtype=np.float32)
    checker_size = np.ones(nn, dtype=np.float32)
    proc2_cu = np.zeros((nn, 3, 3), dtype=np.float32)
    proc2_cv = np.zeros((nn, 3, 3), dtype=np.float32)
    proc2_fu = np.zeros((nn, 3), dtype=np.float32)
    proc2_fv = np.zeros((nn, 3), dtype=np.float32)
    bitmap_scaling = np.ones(nn, dtype=np.float32)
    bump_scaling = np.ones(nn, dtype=np.float32)
    bump_strength = np.zeros(nn, dtype=np.float32)

    bitmaps = []  # unique BitmapTexture.data arrays
    bitmap_ids = {}
    bumps = []  # unique differentiated BumpTexture derivative maps
    bump_ids = {}

    for i, node in enumerate(scene.nodes):
        expr = _geom_expr(node.geometry, tables)
        tr = node.transform
        node_matrix[i] = tr.matrix
        node_offset[i] = tr.offset
        ident = bool(np.allclose(tr.matrix, np.eye(3)) and np.allclose(tr.offset, 0))
        offset_only = bool(np.allclose(tr.matrix, np.eye(3)))

        sh = node.shader
        kind = _SHADER_KIND[type(sh)]
        mat_color[i] = np.asarray(sh.color, dtype=np.float32)
        if isinstance(sh, T.Phong):
            mat_exponent[i] = sh.exponent
            mat_strength[i] = sh.strength
        if isinstance(sh, T.Refraction):
            mat_ior[i] = sh.ior

        tex = getattr(sh, "texture", None)
        tex_kind, bidx = TEX_NONE, -1
        if isinstance(tex, T.Checker):
            tex_kind = TEX_CHECKER
            checker_c1[i] = tex.color1
            checker_c2[i] = tex.color2
            checker_size[i] = tex.size
        elif isinstance(tex, T.Procedure2):
            tex_kind = TEX_PROC2
            proc2_cu[i] = np.asarray(tex.colorU, dtype=np.float32)
            proc2_cv[i] = np.asarray(tex.colorV, dtype=np.float32)
            proc2_fu[i] = np.asarray(tex.freqU, dtype=np.float32)
            proc2_fv[i] = np.asarray(tex.freqV, dtype=np.float32)
        elif isinstance(tex, T.BitmapTexture):
            tex_kind = TEX_BITMAP
            key = id(tex)
            if key not in bitmap_ids:
                bitmap_ids[key] = len(bitmaps)
                bitmaps.append(np.asarray(tex.data, dtype=np.float32))
            bidx = bitmap_ids[key]
            bitmap_scaling[i] = tex.scaling

        # bump-map extension: only the BumpTexture subclass perturbs
        # normals (the reference's modifyNormal hook is a no-op for every
        # other texture kind, texture.d:10-12)
        pidx = -1
        if isinstance(node.bumpmap, T.BumpTexture):
            key = id(node.bumpmap)
            if key not in bump_ids:
                bump_ids[key] = len(bumps)
                bumps.append(differentiate(np.asarray(node.bumpmap.data, dtype=np.float32)))
            pidx = bump_ids[key]
            bump_scaling[i] = node.bumpmap.scaling
            bump_strength[i] = node.bumpmap.strength

        node_static.append(
            NodeStatic(
                geom=expr,
                shader_kind=kind,
                tex_kind=tex_kind,
                bitmap_idx=bidx,
                identity_transform=ident,
                offset_only=offset_only,
                bump_idx=pidx,
            )
        )

    # Pad bitmaps into one atlas so a per-ray texture id can gather rows.
    if bitmaps:
        hmax = max(b.shape[0] for b in bitmaps)
        wmax = max(b.shape[1] for b in bitmaps)
        atlas = np.zeros((len(bitmaps), hmax, wmax, 3), dtype=np.float32)
        hw = np.zeros((len(bitmaps), 2), dtype=np.float32)
        for j, b in enumerate(bitmaps):
            atlas[j, : b.shape[0], : b.shape[1]] = b
            hw[j] = (b.shape[0], b.shape[1])
    else:
        atlas = np.zeros((0, 1, 1, 3), dtype=np.float32)
        hw = np.zeros((0, 2), dtype=np.float32)

    if bumps:
        phmax = max(b.shape[0] for b in bumps)
        pwmax = max(b.shape[1] for b in bumps)
        bump_atlas = np.zeros((len(bumps), phmax, pwmax, 3), dtype=np.float32)
        for j, b in enumerate(bumps):
            bump_atlas[j, : b.shape[0], : b.shape[1]] = b
    else:
        bump_atlas = np.zeros((0, 1, 1, 3), dtype=np.float32)

    lights = scene.lights
    cam = scene.camera
    s = scene.settings
    # one rounding from the float64 host values, like jnp.asarray(x, dtype)
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))

    def f(x):
        return torch.from_numpy(np.asarray(np.asarray(x, dtype=np.float64), dtype=np_dtype)).to(device)

    packed = ScenePacked(
        plane_y=f(tables["plane_y"]),
        plane_limit=f(tables["plane_limit"]),
        sphere_center=f(np.asarray(tables["sphere_center"], dtype=np.float64).reshape(-1, 3)),
        sphere_r=f(tables["sphere_r"]),
        cube_center=f(np.asarray(tables["cube_center"], dtype=np.float64).reshape(-1, 3)),
        cube_side=f(tables["cube_side"]),
        node_matrix=f(node_matrix),
        node_offset=f(node_offset),
        light_pos=f(np.asarray([li.pos for li in lights], dtype=np.float64).reshape(-1, 3)),
        light_color=f(np.asarray([li.color for li in lights], dtype=np.float64).reshape(-1, 3)),
        light_power=f([li.power for li in lights]),
        mat_color=f(mat_color),
        mat_exponent=f(mat_exponent),
        mat_strength=f(mat_strength),
        mat_ior=f(mat_ior),
        checker_c1=f(checker_c1),
        checker_c2=f(checker_c2),
        checker_size=f(checker_size),
        proc2_color_u=f(proc2_cu),
        proc2_color_v=f(proc2_cv),
        proc2_freq_u=f(proc2_fu),
        proc2_freq_v=f(proc2_fv),
        bitmap_scaling=f(bitmap_scaling),
        bitmap_atlas=f(atlas),
        bitmap_hw=f(hw),
        bump_atlas=f(bump_atlas),
        bump_scaling=f(bump_scaling),
        bump_strength=f(bump_strength),
        env_cubemap=f(
            scene.environment.cubemap
            if scene.environment.cubemap is not None
            else np.zeros((0, 1, 1, 3), dtype=np.float32)
        ),
        ambient=f(s.ambientLightColor),
        camera=CameraPacked(
            pos=f(cam.pos),
            yaw=f(cam.yaw),
            pitch=f(cam.pitch),
            roll=f(cam.roll),
            fov=f(cam.fov),
            focal_plane_dist=f(cam.focalPlaneDist),
            disc_multiplier=f(cam.discMultiplier),
            stereo_separation=f(cam.stereoSeparation),
        ),
    )

    static = SceneStatic(
        nodes=tuple(node_static),
        n_lights=len(lights),
        width=s.frameWidth,
        height=s.frameHeight,
        has_env=scene.environment.cubemap is not None,
        bitmap_sizes=tuple((b.shape[0], b.shape[1]) for b in bitmaps),
        bump_sizes=tuple((b.shape[0], b.shape[1]) for b in bumps),
        max_trace_depth=s.maxTraceDepth,
        aa_enabled=s.AAEnabled,
        aa_adaptive=getattr(s, "adaptiveAA", False),
        compensated_raygen=getattr(s, "compensatedRayGen", False),
        dof=cam.dof,
        dof_samples=cam.numSamples,
        gi_enabled=s.GIEnabled,
        paths_per_pixel=s.pathsPerPixel,
        stereo=cam.stereoSeparation != 0.0,
    )
    return packed, static


# The fixed order of a ScenePacked's tensor leaves: every ScenePacked field
# but the camera, then every CameraPacked field as "camera.<field>" (the
# keys of from_numpy / to_numpy).  The round-0 autograd Function, fit() and
# the checkpoints all flatten a scene in this order.
_SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(ScenePacked) if f.name != "camera")
_CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(CameraPacked))
LEAF_NAMES = _SCENE_FIELDS + tuple(f"camera.{k}" for k in _CAMERA_FIELDS)


def leaves(packed: ScenePacked) -> list:
    """The scene's tensor leaves in LEAF_NAMES order."""
    return [getattr(packed, k) for k in _SCENE_FIELDS] + [getattr(packed.camera, k) for k in _CAMERA_FIELDS]


def from_leaves(values) -> ScenePacked:
    """A ScenePacked from its leaves in LEAF_NAMES order."""
    values = dict(zip(LEAF_NAMES, values, strict=True))
    return ScenePacked(
        **{k: values[k] for k in _SCENE_FIELDS},
        camera=CameraPacked(**{k: values[f"camera.{k}"] for k in _CAMERA_FIELDS}),
    )


def replace_leaves(packed: ScenePacked, values: Dict[str, torch.Tensor]) -> ScenePacked:
    """A copy of ``packed`` with the leaves named in ``values`` (LEAF_NAMES
    keys) replaced."""
    cam = {k.split(".", 1)[1]: v for k, v in values.items() if k.startswith("camera.")}
    rest = {k: v for k, v in values.items() if not k.startswith("camera.")}
    unknown = (set(rest) - set(_SCENE_FIELDS)) | (set(cam) - set(_CAMERA_FIELDS))
    if unknown:
        raise KeyError(f"replace_leaves: unknown leaves {sorted(unknown)}")
    return dataclasses.replace(packed, **rest, camera=dataclasses.replace(packed.camera, **cam))


def to_numpy(packed: ScenePacked) -> Dict[str, np.ndarray]:
    """The inverse of from_numpy: {LEAF_NAMES key: numpy array}.  A
    ScenePacked of gradients carries them across to numpy the same way."""
    return {k: v.detach().cpu().numpy() for k, v in zip(LEAF_NAMES, leaves(packed))}


def from_numpy(
    leaves: Dict[str, np.ndarray], static: SceneStatic, device=None
) -> ScenePacked:
    """Carry a packed scene across from numpy arrays: ``leaves`` maps every
    ScenePacked field name to its array, and every CameraPacked field to
    ``"camera.<field>"`` — e.g. the leaves of the JAX package's ScenePacked,
    made into numpy.  Shapes are checked against ``static``.
    ``device=None`` is the current CUDA device (see ``_resolve_device``)."""
    device = _resolve_device(device, "from_numpy")
    want = set(LEAF_NAMES)
    if set(leaves) != want:
        raise ValueError(
            f"from_numpy: missing {sorted(want - set(leaves))}, unknown {sorted(set(leaves) - want)}"
        )

    def t(name):
        return torch.from_numpy(np.array(leaves[name], copy=True)).to(device)

    packed = ScenePacked(
        **{k: t(k) for k in _SCENE_FIELDS},
        camera=CameraPacked(**{k: t(f"camera.{k}") for k in _CAMERA_FIELDS}),
    )
    nn = len(static.nodes)
    checks = {
        "node_matrix": (nn, 3, 3),
        "node_offset": (nn, 3),
        "mat_color": (nn, 3),
        "light_pos": (static.n_lights, 3),
        "ambient": (3,),
    }
    for name, shape in checks.items():
        if tuple(getattr(packed, name).shape) != shape:
            raise ValueError(f"from_numpy: {name} has shape {tuple(getattr(packed, name).shape)}, want {shape}")
    if packed.bitmap_atlas.shape[0] != len(static.bitmap_sizes):
        raise ValueError("from_numpy: bitmap_atlas rows do not match static.bitmap_sizes")
    if packed.bump_atlas.shape[0] != len(static.bump_sizes):
        raise ValueError("from_numpy: bump_atlas rows do not match static.bump_sizes")
    return packed
