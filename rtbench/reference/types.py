"""Frozen copy of chess2rt_tpu_torch/models/types.py at commit d735142 for the
benchmark's plain reference (unchanged but for the import of vec).  It imports
nothing of the program.

Typed scene object model.

Host-side description of a scene, mirroring the reference's entity classes
(source/rt/{geometry,texture,shader,light,node,camera,global_settings,scene}.d)
with identical property names and defaults — this is the scene-file
compatibility surface.  The device-side differentiable representation is
produced from this by models/packed.py; all float fields here are plain
Python/NumPy values.

Extension beyond the reference (documented, off by default in its scenes):
`Reflection` / `Refraction` shaders — the reference carries the recursive
machinery (Ray.depth, maxTraceDepth, RayFlags) but ships no
reflective/refractive Shader subclass; these complete the depth-K story the
BASELINE asks for ("recursive reflection depth 5").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import vec

BLACK = (0.0, 0.0, 0.0)


# --------------------------------------------------------------------------
# Settings / camera / environment
# --------------------------------------------------------------------------


@dataclass
class GlobalSettings:
    """All render knobs, defaults per global_settings.d:8-35."""

    frameWidth: int = 640
    frameHeight: int = 480
    fullscreen: bool = False
    allowResize: bool = False
    dynamicAspectRatio: bool = False
    interactive: bool = False
    bucketSize: int = 48
    threadCount: int = 0
    prepassEnabled: bool = True
    prepassOnly: bool = False
    GIEnabled: bool = False
    AAEnabled: bool = True
    AAThreshold: float = 0.1
    pathsPerPixel: int = 40
    maxTraceDepth: int = 4
    ambientLightColor: tuple = BLACK
    debugEnabled: bool = True
    # EXTENSION (off by default): honor the needs-AA mask the reference
    # computes and then ignores (renderer.d:150-186 detects, :183-186
    # resamples every pixel unconditionally).  True = resample only
    # flagged pixels (the evident intent); detection still uses
    # tooDifferent's default 0.1 threshold, like the reference
    # (AAThreshold is never forwarded, renderer.d:172).
    adaptiveAA: bool = False
    # EXTENSION (off by default): compensated (df32 two-float, ~f64
    # emulated) camera ray-gen on the f32 XLA pipeline — closes the f32
    # horizon-UV tail vs the f64 oracle (ops/camera._begin_frame_df)
    compensatedRayGen: bool = False

    def adjust_frame_size(self) -> None:
        """Round the frame up to a bucket multiple (global_settings.d:38-45).

        NB: the reference defines but never calls this; exposed for API
        parity.
        """
        if self.frameWidth % self.bucketSize != 0:
            self.frameWidth = (self.frameWidth // self.bucketSize + 1) * self.bucketSize
        if self.frameHeight % self.bucketSize != 0:
            self.frameHeight = (self.frameHeight // self.bucketSize + 1) * self.bucketSize


@dataclass
class Camera:
    """Pinhole camera with yaw/pitch/roll, DoF and stereo (camera.d).

    `aspect` is always re-derived from the frame size during deserialization
    (camera.d:254 calls setFrameSize) — a scene file's `aspect` key is
    ignored, like the reference.
    """

    pos: tuple = BLACK
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    fov: float = 0.0
    focalPlaneDist: float = 1.0
    fNumber: float = 1.0
    dof: bool = False
    numSamples: int = 25
    stereoSeparation: float = 0.0
    frameWidth: int = 640
    frameHeight: int = 480
    aspect: float = 1.0
    discMultiplier: float = 10.0

    def set_frame_size(self, width: int, height: int) -> None:
        self.frameWidth = int(width)
        self.frameHeight = int(height)
        self.aspect = float(width) / float(height)

    # interactive controls (camera.d:176-229); the basis vectors mirror
    # beginFrame's rotation (oracle/renderer.py begin_frame)
    def _basis(self):
        from . import vec

        rot = (
            vec.rotate_z(vec.radians(self.roll))
            @ vec.rotate_x(vec.radians(self.pitch))
            @ vec.rotate_y(vec.radians(self.yaw))
        )
        return rot[0], rot[1], rot[2]  # right, up, front (row-vector basis)

    def move(self, dx: float, dy: float, dz: float) -> None:
        """dx right/left, dy up/down, dz forward/backward (camera.d:176-204)."""
        right, up, front = self._basis()
        pos = np.asarray(self.pos, dtype=np.float64)
        self.pos = tuple(pos + dx * right + dy * up + dz * front)

    def rotate(self, d_yaw: float, d_roll: float, d_pitch: float) -> None:
        """Yaw/roll/pitch deltas in degrees; pitch clamps to ±90
        (camera.d:206-229)."""
        self.yaw += d_yaw
        self.roll += d_roll
        self.pitch = float(np.clip(self.pitch + d_pitch, -90.0, 90.0))


@dataclass
class Environment:
    """Miss shader. The reference returns black unconditionally
    (environment.d:5-15); `cubemap` is this framework's natural extension —
    when set (a `[6, S, S, 3]` float32 array), directions sample the cubemap,
    default stays black for parity."""

    cubemap: Optional[np.ndarray] = None


# --------------------------------------------------------------------------
# Geometries
# --------------------------------------------------------------------------


@dataclass
class Geometry:
    name: str = ""


@dataclass
class Plane(Geometry):
    """Infinite XZ plane at height `y` with optional half-extent `limit`.

    The reference never deserializes `limit` (geometry.d:61-64) and its
    default-constructed value is NaN, which disables the extent check; we use
    +inf, which is behaviorally identical.
    """

    y: float = 0.0
    limit: float = float("inf")


@dataclass
class Sphere(Geometry):
    center: tuple = BLACK
    R: float = 1.0


@dataclass
class Cube(Geometry):
    center: tuple = BLACK
    side: float = 1.0


@dataclass
class CsgOp(Geometry):
    """Boolean combinator over two child geometries (geometry.d:250-403)."""

    left: Optional[Geometry] = None
    right: Optional[Geometry] = None

    op: str = ""  # "union" | "inter" | "diff"

    def bool_op(self, in_left, in_right):
        if self.op == "union":
            return in_left | in_right
        if self.op == "inter":
            return in_left & in_right
        if self.op == "diff":
            return in_left & ~in_right
        raise ValueError(f"Unknown CSG op {self.op!r}")


@dataclass
class CsgUnion(CsgOp):
    op: str = "union"


@dataclass
class CsgInter(CsgOp):
    op: str = "inter"


@dataclass
class CsgDiff(CsgOp):
    op: str = "diff"


# --------------------------------------------------------------------------
# Textures
# --------------------------------------------------------------------------


@dataclass
class Texture:
    name: str = ""


@dataclass
class Checker(Texture):
    """2-color checkerboard in (u, v) (texture.d:20-68)."""

    color1: tuple = BLACK
    color2: tuple = (1.0, 1.0, 1.0)
    size: float = 1.0


@dataclass
class Procedure2(Texture):
    """Sum of 3 sine bands per axis (texture.d:70-101)."""

    colorU: tuple = ()
    colorV: tuple = ()
    freqU: tuple = ()
    freqV: tuple = ()


@dataclass
class BitmapTexture(Texture):
    """Bilinear-filtered bitmap lookup with wrap (texture.d:103-162).

    `data` holds the gamma-decompressed linear float32 texels `[h, w, 3]`.
    """

    file: str = ""
    scaling: float = 1.0
    assumedGamma: float = 2.2
    data: Optional[np.ndarray] = None


@dataclass
class BumpTexture(BitmapTexture):
    """EXTENSION: a bitmap used as a height/derivative map via a node's
    ``bump`` property.  The reference stages the machinery — tangent
    frames in every intersect (intersectable.d:24-25), the
    Texture.modifyNormal hook (texture.d:10-12), Bitmap.differentiate
    (bitmap.d:139-154), Node.bumpmap parsing (node.d:72-81) — but never
    implements a concrete bump texture (no getTexColor override calls
    modifyNormal anywhere), so a reference scene with ``bump`` renders
    unperturbed.  This class completes the staged feature:

        (dx, dy) = bilinear sample of imageio.differentiate(texels)
                   at (u*scaling, v*scaling), wrap like getTexColor
        normal'  = normalize(normal + (dNdx*dx + dNdy*dy) * strength)

    applied at the renderer.d:370-372 hook site (Whitted raytrace only,
    like the reference's call site)."""

    strength: float = 20.0


# --------------------------------------------------------------------------
# Shaders
# --------------------------------------------------------------------------


@dataclass
class Shader:
    name: str = ""
    color: tuple = (1.0, 1.0, 1.0)


@dataclass
class Lambert(Shader):
    """Diffuse direct lighting + cosine BRDF for GI (shader.d:54-174)."""

    texture: Optional[Texture] = None


@dataclass
class Phong(Shader):
    """Lambert diffuse + untinted cos^n specular (shader.d:176-287)."""

    exponent: float = 16.0
    strength: float = 1.0
    texture: Optional[Texture] = None


@dataclass
class Reflection(Shader):
    """Perfect mirror (framework extension; completes the reference's unused
    recursion machinery — see module docstring).  `color` multiplies the
    reflected radiance; `glossiness < 1` perturbs the reflected direction."""

    glossiness: float = 1.0
    numSamples: int = 8


@dataclass
class Refraction(Shader):
    """Perfect refraction with index-of-refraction `ior` (extension)."""

    ior: float = 1.33


# --------------------------------------------------------------------------
# Lights
# --------------------------------------------------------------------------


@dataclass
class PointLight:
    """Single-sample point light (light.d:52-89).  Its solid angle is zero
    by definition in the reference (light.d:72-75), which makes the GI
    direct-light term vanish — preserved."""

    name: str = ""
    pos: tuple = BLACK
    color: tuple = (0.0, 0.0, 0.0)
    power: float = 0.0


# --------------------------------------------------------------------------
# Node + transform
# --------------------------------------------------------------------------


class Transform:
    """Model transform: 3x3 matrix + translation, with cached inverse and
    transposed inverse (transform.d:7-103).  Matrices are float64 numpy; the
    packed device representation recomputes inverses in-graph so gradients
    flow to the raw matrix entries."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.matrix = np.eye(3)
        self.offset = np.zeros(3)
        self._refresh()

    def _refresh(self):
        self.inverse = np.linalg.inv(self.matrix)
        self.transposed_inverse = self.inverse.T.copy()

    def scale(self, x, y, z):
        self.matrix = self.matrix @ vec.scaled_identity(x, y, z)
        self._refresh()

    def rotate(self, yaw, pitch, roll):
        """transform * rotX(pitch) * rotY(yaw) * rotZ(roll) (transform.d:41-50)."""
        self.matrix = (
            self.matrix
            @ vec.rotate_x(vec.radians(pitch))
            @ vec.rotate_y(vec.radians(yaw))
            @ vec.rotate_z(vec.radians(roll))
        )
        self._refresh()

    def translate(self, v):
        self.offset = np.asarray(v, dtype=np.float64)

    # host-side helpers (oracle / debugging); device path lives in ops/
    def point(self, p):
        return vec.mul_vm(np.asarray(p, np.float64), self.matrix) + self.offset

    def undo_point(self, p):
        return vec.mul_vm(np.asarray(p, np.float64) - self.offset, self.inverse)

    def direction(self, d):
        return vec.mul_vm(np.asarray(d, np.float64), self.matrix)

    def undo_direction(self, d):
        return vec.mul_vm(np.asarray(d, np.float64), self.inverse)

    def normal(self, n):
        return vec.mul_vm(np.asarray(n, np.float64), self.transposed_inverse)


@dataclass
class Node:
    """Scene instance: geometry + shader + optional bump texture + transform
    (node.d:5-101)."""

    name: str = ""
    geometry: Optional[Geometry] = None
    shader: Optional[Shader] = None
    bumpmap: Optional[Texture] = None
    transform: Transform = field(default_factory=Transform)


# --------------------------------------------------------------------------
# Scene aggregate
# --------------------------------------------------------------------------


@dataclass
class Scene:
    name: str = ""
    settings: GlobalSettings = field(default_factory=GlobalSettings)
    camera: Camera = field(default_factory=Camera)
    environment: Environment = field(default_factory=Environment)
    lights: list = field(default_factory=list)
    geometries: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    shaders: list = field(default_factory=list)
    nodes: list = field(default_factory=list)
    # name -> entity registries, one per kind (scene.d:9-36)
    named: dict = field(default_factory=lambda: {"lights": {}, "geometries": {}, "textures": {}, "shaders": {}, "nodes": {}})

    def pretty(self) -> str:
        """Load-time scene dump, the parity feature for Scene.toString
        (scene.d:80-95)."""
        lines = []
        for kind in ("lights", "geometries", "textures", "shaders", "nodes"):
            for name, entity in self.named[kind].items():
                lines.append(f"'{name}' -> {type(entity).__name__}{_summarize(entity)}")
        lines.append(f"GlobalSettings{_summarize(self.settings)}")
        return "\n".join(lines)


def _summarize(entity) -> str:
    import dataclasses

    if dataclasses.is_dataclass(entity):
        parts = []
        for f in dataclasses.fields(entity):
            v = getattr(entity, f.name)
            if isinstance(v, np.ndarray):
                v = f"array{v.shape}"
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                v = f"{type(v).__name__}({getattr(v, 'name', '')!r})"
            elif isinstance(v, Transform):
                v = "Transform"
            parts.append(f"{f.name}={v!r}" if isinstance(v, str) else f"{f.name}={v}")
        return "(" + ", ".join(parts) + ")"
    return ""
