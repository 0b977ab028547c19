"""Scene loading: SDLang + JSON -> typed Scene.

Reproduces the reference loader's observable semantics
(source/rt/scene_loader.d):

* extension dispatch: `.sdl` / `.json` (scene_loader.d:47-60); missing file
  -> SceneNotFoundException, malformed content -> InvalidSceneException.
* fixed top-level section order — Name, GlobalSettings, Camera, Environment,
  Lights, Geometries, Textures, Shaders, Nodes — so later sections resolve
  names registered by earlier ones (scene_loader.d:62-83).
* entity type = SDL tag name / JSON `"type"`; entity name = first SDL string
  value, `name` child, or JSON `"name"` (scene_loader.d:247-352).
* duplicate names raise EntityWithDuplicateName (scene_loader.d:195-202).
* absent properties keep the model defaults; absent class-typed sections get
  default-constructed (scene_loader.d:112-133).
* texture file paths resolve relative to the scene file (scene_loader.d:135-138).

Reference quirks preserved (opt out via `fix_reference_bugs=True`):
* a Node's `rotate` property applies a *scale* (node.d:89-90).
* a Camera's `aspect` key is ignored; aspect is re-derived from the frame
  size (camera.d:238-255).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..exceptions import (
    EntityWithDuplicateName,
    InvalidSceneException,
    SceneNotFoundException,
)
from ..models import types as T
from ..utils.color import decompress_gamma, decompress_gamma_srgb
from .sdlang import SdlTag, parse_sdl

# --------------------------------------------------------------------------
# Format-agnostic node view (the SceneDscNode role, scene_loader.d:210-241)
# --------------------------------------------------------------------------


class DscNode:
    def get_type(self) -> str: ...
    def get_name(self): ...
    def is_specified(self, prop: str) -> bool: ...
    def get_child(self, prop: str) -> "DscNode": ...
    def get_children(self) -> list: ...
    def get_values(self) -> list: ...

    # typed scalar accessors
    def scalar(self):
        vs = self.get_values()
        if not vs:
            raise InvalidSceneException("Expected a value")
        return vs[0]


class SdlNode(DscNode):
    def __init__(self, tag: SdlTag):
        self.tag = tag

    def get_type(self):
        return self.tag.name

    def get_name(self):
        if self.tag.values and isinstance(self.tag.values[0], str):
            return self.tag.values[0]
        if self.tag.has_child("name"):
            return self.tag.child("name").values[0]
        return None

    def is_specified(self, prop):
        return self.tag.has_child(prop)

    def get_child(self, prop):
        return SdlNode(self.tag.child(prop))

    def get_children(self):
        return [SdlNode(t) for t in self.tag.children]

    def get_values(self):
        return list(self.tag.values)


class JsonNode(DscNode):
    def __init__(self, value):
        self.value = value

    def get_type(self):
        return self.value["type"]

    def get_name(self):
        return self.value.get("name")

    def is_specified(self, prop):
        return isinstance(self.value, dict) and prop in self.value

    def get_child(self, prop):
        return JsonNode(self.value[prop])

    def get_children(self):
        return [JsonNode(v) for v in self.value]

    def get_values(self):
        if isinstance(self.value, list):
            return list(self.value)
        return [self.value]


# --------------------------------------------------------------------------
# Typed property extraction (SceneLoadContext.set/extractValue)
# --------------------------------------------------------------------------


class LoadContext:
    def __init__(self, file_path: str, fix_reference_bugs: bool = False):
        self.file_path = file_path
        self.fix_reference_bugs = fix_reference_bugs
        self.scene = T.Scene()

    @property
    def named(self):
        return self.scene.named

    def resolve_relative_path(self, path: str) -> str:
        base = os.path.dirname(os.path.abspath(self.file_path)) if self.file_path else os.getcwd()
        return path if os.path.isabs(path) else os.path.join(base, path)

    def register(self, kind: str, name, entity):
        if name:
            if name in self.named[kind]:
                raise EntityWithDuplicateName(name)
            self.named[kind][name] = entity

    # -- scalar / vector getters -------------------------------------------

    def get_scalar(self, node: DscNode, prop: str, default, cast):
        if not node.is_specified(prop):
            return default
        return cast(node.get_child(prop).scalar())

    def get_vec3(self, node: DscNode, prop: str, default):
        if not node.is_specified(prop):
            return default
        vs = node.get_child(prop).get_values()
        return (float(vs[0]), float(vs[1]), float(vs[2]))

    def get_float_list(self, node: DscNode, prop: str):
        if not node.is_specified(prop):
            return ()
        return tuple(float(v) for v in node.get_child(prop).get_values())

    def get_vec3_list(self, node: DscNode, prop: str):
        """Array of colors/vectors: each SDL child tag's (or JSON sub-array's)
        3 values (extractValue's array branch, scene_loader.d:159-177)."""
        if not node.is_specified(prop):
            return ()
        out = []
        for ch in node.get_child(prop).get_children():
            vs = ch.get_values()
            out.append((float(vs[0]), float(vs[1]), float(vs[2])))
        return tuple(out)

    def get_str(self, node: DscNode, prop: str, default=""):
        if not node.is_specified(prop):
            return default
        return str(node.get_child(prop).scalar())


# --------------------------------------------------------------------------
# Per-entity deserializers
# --------------------------------------------------------------------------


def _load_settings(node: DscNode, ctx: LoadContext) -> T.GlobalSettings:
    s = T.GlobalSettings()
    g = ctx.get_scalar
    s.frameWidth = g(node, "frameWidth", s.frameWidth, int)
    s.frameHeight = g(node, "frameHeight", s.frameHeight, int)
    s.fullscreen = g(node, "fullscreen", s.fullscreen, bool)
    s.allowResize = g(node, "allowResize", s.allowResize, bool)
    s.dynamicAspectRatio = g(node, "dynamicAspectRatio", s.dynamicAspectRatio, bool)
    s.interactive = g(node, "interactive", s.interactive, bool)
    s.bucketSize = g(node, "bucketSize", s.bucketSize, int)
    s.threadCount = g(node, "threadCount", s.threadCount, int)
    s.prepassEnabled = g(node, "prepassEnabled", s.prepassEnabled, bool)
    s.prepassOnly = g(node, "prepassOnly", s.prepassOnly, bool)
    s.GIEnabled = g(node, "GIEnabled", s.GIEnabled, bool)
    s.AAEnabled = g(node, "AAEnabled", s.AAEnabled, bool)
    s.AAThreshold = g(node, "AAThreshold", s.AAThreshold, float)
    s.adaptiveAA = g(node, "adaptiveAA", s.adaptiveAA, bool)  # extension
    s.compensatedRayGen = g(node, "compensatedRayGen", s.compensatedRayGen, bool)  # extension
    s.maxTraceDepth = g(node, "maxTraceDepth", s.maxTraceDepth, int)
    s.pathsPerPixel = g(node, "pathsPerPixel", s.pathsPerPixel, int)
    s.ambientLightColor = ctx.get_vec3(node, "ambientLightColor", s.ambientLightColor)
    s.debugEnabled = g(node, "debugEnabled", s.debugEnabled, bool)
    return s


def _load_camera(node: DscNode, ctx: LoadContext) -> T.Camera:
    c = T.Camera()
    g = ctx.get_scalar
    c.pos = ctx.get_vec3(node, "pos", c.pos)
    c.yaw = g(node, "yaw", c.yaw, float)
    c.pitch = g(node, "pitch", c.pitch, float)
    c.roll = g(node, "roll", c.roll, float)
    c.fov = g(node, "fov", c.fov, float)
    c.focalPlaneDist = g(node, "focalPlaneDist", c.focalPlaneDist, float)
    c.fNumber = g(node, "fNumber", c.fNumber, float)
    c.dof = g(node, "dof", c.dof, bool)
    c.numSamples = g(node, "numSamples", c.numSamples, int)
    c.stereoSeparation = g(node, "stereoSeparation", c.stereoSeparation, float)
    c.discMultiplier = 10.0 / c.fNumber  # camera.d:252
    # NB: a scene-file `aspect` key is ignored (deserialize never reads it);
    # aspect always comes from the frame size (camera.d:254).
    c.set_frame_size(ctx.scene.settings.frameWidth, ctx.scene.settings.frameHeight)
    return c


def _load_environment(node: DscNode, ctx: LoadContext) -> T.Environment:
    """Environment section.  The reference's Environment is a stub that
    always returns black (environment.d:5-15); the `cubemap` property is
    this framework's skybox extension: a path prefix resolving to
    <prefix><face>.bmp for faces posx/negx/posy/negy/posz/negz, decoded
    with `assumedGamma` like BitmapTexture (2.2 = sRGB)."""
    env = T.Environment()
    prefix = ctx.get_str(node, "cubemap")
    if not prefix:
        return env
    gamma = ctx.get_scalar(node, "assumedGamma", 2.2, float)
    from ..imageio import load_bmp_file

    faces = []
    for face in ("posx", "negx", "posy", "negy", "posz", "negz"):
        path = ctx.resolve_relative_path(prefix + face + ".bmp")
        rgb = load_bmp_file(path).to_float_rgb()
        if gamma == 2.2:
            rgb = decompress_gamma_srgb(rgb)
        elif gamma != 1 and 0 < gamma < 10:
            rgb = decompress_gamma(rgb, gamma)
        faces.append(rgb)
    shapes = {f.shape for f in faces}
    if len(shapes) != 1 or faces[0].shape[0] != faces[0].shape[1]:
        raise InvalidSceneException("cubemap faces must be square and same-size")
    env.cubemap = np.stack(faces)
    return env


def _load_light(node: DscNode, ctx: LoadContext):
    kind = node.get_type()
    if kind != "PointLight":
        raise InvalidSceneException(f"Unknown object type (or not yet supported): {kind}")
    li = T.PointLight(name=node.get_name() or "")
    li.color = ctx.get_vec3(node, "color", li.color)
    li.power = ctx.get_scalar(node, "power", li.power, float)
    li.pos = ctx.get_vec3(node, "pos", li.pos)
    return li


def _load_geometry(node: DscNode, ctx: LoadContext):
    kind = node.get_type()
    name = node.get_name() or ""
    if kind == "Plane":
        geo = T.Plane(name=name, y=ctx.get_scalar(node, "y", 0.0, float))
    elif kind == "Sphere":
        center = ctx.get_vec3(node, "center", (0.0, 0.0, 0.0))
        geo = T.Sphere(name=name, center=center, R=ctx.get_scalar(node, "R", 1.0, float))
    elif kind == "Cube":
        center = ctx.get_vec3(node, "center", (0.0, 0.0, 0.0))
        geo = T.Cube(name=name, center=center, side=ctx.get_scalar(node, "side", 1.0, float))
    elif kind in ("CsgUnion", "CsgInter", "CsgDiff"):
        cls = {"CsgUnion": T.CsgUnion, "CsgInter": T.CsgInter, "CsgDiff": T.CsgDiff}[kind]
        left = ctx.get_str(node, "left")
        right = ctx.get_str(node, "right")
        try:
            geo = cls(name=name, left=ctx.named["geometries"][left], right=ctx.named["geometries"][right])
        except KeyError as e:
            raise InvalidSceneException(f"CSG child geometry not found: {e}") from e
    else:
        raise InvalidSceneException(f"Unknown object type (or not yet supported): {kind}")
    return geo


def _load_texture(node: DscNode, ctx: LoadContext):
    kind = node.get_type()
    name = node.get_name() or ""
    if kind == "Checker":
        t = T.Checker(name=name)
        t.color1 = ctx.get_vec3(node, "color1", t.color1)
        t.color2 = ctx.get_vec3(node, "color2", t.color2)
        t.size = ctx.get_scalar(node, "size", t.size, float)
    elif kind == "Procedure2":
        t = T.Procedure2(name=name)
        t.colorU = ctx.get_vec3_list(node, "colorU")
        t.colorV = ctx.get_vec3_list(node, "colorV")
        t.freqU = ctx.get_float_list(node, "freqU")
        t.freqV = ctx.get_float_list(node, "freqV")
    elif kind in ("BitmapTexture", "BumpTexture"):
        # BumpTexture (extension, models/types.py): same file/scaling/gamma
        # schema as BitmapTexture plus a derivative-map strength
        t = T.BitmapTexture(name=name) if kind == "BitmapTexture" else T.BumpTexture(name=name)
        if kind == "BumpTexture":
            t.strength = ctx.get_scalar(node, "strength", t.strength, float)
        t.scaling = ctx.get_scalar(node, "scaling", t.scaling, float)
        t.assumedGamma = ctx.get_scalar(node, "assumedGamma", t.assumedGamma, float)
        t.file = ctx.resolve_relative_path(ctx.get_str(node, "file"))
        from ..imageio import load_bmp_file

        rgb = load_bmp_file(t.file).to_float_rgb()
        # gamma decode at load time (texture.d:137-141)
        if t.assumedGamma == 2.2:
            rgb = decompress_gamma_srgb(rgb)
        elif t.assumedGamma != 1 and 0 < t.assumedGamma < 10:
            rgb = decompress_gamma(rgb, t.assumedGamma)
        t.data = rgb
    else:
        raise InvalidSceneException(f"Unknown object type (or not yet supported): {kind}")
    return t


def _resolve_texture(node: DscNode, ctx: LoadContext, prop: str = "texture"):
    """Texture refs are optional and silently None if the name is unknown
    (shader.d:137-147)."""
    tname = ctx.get_str(node, prop)
    return ctx.named["textures"].get(tname)


def _load_shader(node: DscNode, ctx: LoadContext):
    kind = node.get_type()
    name = node.get_name() or ""
    if kind == "Lambert":
        sh = T.Lambert(name=name)
        sh.color = ctx.get_vec3(node, "color", sh.color)
        sh.texture = _resolve_texture(node, ctx)
    elif kind == "Phong":
        sh = T.Phong(name=name)
        sh.color = ctx.get_vec3(node, "color", sh.color)
        sh.exponent = float(np.clip(ctx.get_scalar(node, "exponent", sh.exponent, float), 1e-6, 1e6))
        sh.strength = float(np.clip(ctx.get_scalar(node, "strength", sh.strength, float), 0.0, 1e6))
        sh.texture = _resolve_texture(node, ctx)
    elif kind == "Reflection":
        sh = T.Reflection(name=name)
        sh.color = ctx.get_vec3(node, "color", sh.color)
        sh.glossiness = ctx.get_scalar(node, "glossiness", sh.glossiness, float)
        sh.numSamples = ctx.get_scalar(node, "numSamples", sh.numSamples, int)
    elif kind == "Refraction":
        sh = T.Refraction(name=name)
        sh.color = ctx.get_vec3(node, "color", sh.color)
        sh.ior = ctx.get_scalar(node, "ior", sh.ior, float)
    else:
        raise InvalidSceneException(f"Unknown object type (or not yet supported): {kind}")
    return sh


def _load_node(node: DscNode, ctx: LoadContext):
    n = T.Node(name=node.get_name() or "")
    gname = ctx.get_str(node, "geometry")
    sname = ctx.get_str(node, "shader")
    try:
        n.geometry = ctx.named["geometries"][gname]
        n.shader = ctx.named["shaders"][sname]
    except KeyError as e:
        raise InvalidSceneException(f"Node references unknown entity: {e}") from e
    n.bumpmap = ctx.named["textures"].get(ctx.get_str(node, "bump"))
    if node.is_specified("scale"):
        n.transform.scale(*ctx.get_vec3(node, "scale", (1, 1, 1)))
    if node.is_specified("rotate"):
        v = ctx.get_vec3(node, "rotate", (0, 0, 0))
        if ctx.fix_reference_bugs:
            n.transform.rotate(*v)
        else:
            # Reference quirk preserved: `rotate` applies a scale (node.d:89-90).
            n.transform.scale(*v)
    if node.is_specified("translate"):
        n.transform.translate(ctx.get_vec3(node, "translate", (0, 0, 0)))
    return n


# --------------------------------------------------------------------------
# Top-level
# --------------------------------------------------------------------------

_SECTION_LOADERS = [
    ("Lights", "lights", _load_light),
    ("Geometries", "geometries", _load_geometry),
    ("Textures", "textures", _load_texture),
    ("Shaders", "shaders", _load_shader),
    ("Nodes", "nodes", _load_node),
]


def _load_scene(root: DscNode, ctx: LoadContext) -> T.Scene:
    scene = ctx.scene
    if root.is_specified("Name"):
        scene.name = str(root.get_child("Name").scalar())
    if root.is_specified("GlobalSettings"):
        scene.settings = _load_settings(root.get_child("GlobalSettings"), ctx)
    if root.is_specified("Camera"):
        scene.camera = _load_camera(root.get_child("Camera"), ctx)
    else:
        scene.camera = T.Camera()
    scene.environment = (
        _load_environment(root.get_child("Environment"), ctx)
        if root.is_specified("Environment")
        else T.Environment()
    )

    for section, kind, fn in _SECTION_LOADERS:
        if not root.is_specified(section):
            continue
        for child in root.get_child(section).get_children():
            entity = fn(child, ctx)
            ctx.register(kind, getattr(entity, "name", None), entity)
            getattr(scene, kind).append(entity)
    return scene


def parse_scene_from_string(text: str, fmt: str, file_path: str = "", fix_reference_bugs: bool = False) -> T.Scene:
    ctx = LoadContext(file_path, fix_reference_bugs=fix_reference_bugs)
    if fmt == "sdl":
        try:
            doc = parse_sdl(text)
        except InvalidSceneException:
            raise
        except Exception as e:
            raise InvalidSceneException(f"Invalid SDL in scene file! ({e})") from e
        if not doc.children:
            raise InvalidSceneException("Empty SDL scene file")
        root = SdlNode(doc.children[0])  # reference grabs tags[0] (scene_loader.d:55)
    elif fmt == "json":
        try:
            root = JsonNode(json.loads(text))
        except json.JSONDecodeError as e:
            raise InvalidSceneException(f"Invalid JSON in scene file! ({e})") from e
    else:
        raise InvalidSceneException("Error loading scene: unknown file type!")
    return _load_scene(root, ctx)


def parse_scene_from_file(filename: str, fix_reference_bugs: bool = False) -> T.Scene:
    """Main entry point (scene_loader.d:20-41)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext not in (".sdl", ".json"):
        raise InvalidSceneException("Error loading scene: unknown file type!")
    try:
        with open(filename, "r") as f:
            text = f.read()
    except OSError as e:
        raise SceneNotFoundException() from e
    return parse_scene_from_string(text, ext[1:], file_path=filename, fix_reference_bugs=fix_reference_bugs)
