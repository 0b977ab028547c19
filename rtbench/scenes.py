"""The benchmark's scenes: a frozen copy of ``flagship_standin`` (with the
helpers and constants it reads) and of lecture4.sdl's part of
``gi_standin``, from chess2rt_tpu_torch/scenes.py at commit d735142; the GI
scene appends the wall of bench.py's ``build_gi`` to the latter.

Each builder takes a ``types`` module, so one call makes the scene for the
port (``chess2rt_tpu_torch.models.types``) and one for the reference
(``rtbench.reference.types``), from the same numbers.  ``seed`` makes the
bitmaps' texels and nothing else: the geometry, lights, camera and every size
are the configuration's, the same for every seed.
"""

from __future__ import annotations

import numpy as np


def _bitmap(rng, h, w):
    """A smooth seeded RGB texture in linear [0, 1] (texels as a
    BitmapTexture holds them after gamma decompression)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, (3, 2))
    freq = rng.uniform(2, 6, (3, 2)) * 2 * np.pi
    chans = [
        0.5 + 0.25 * np.sin(freq[c, 0] * xx / w + phase[c, 0]) + 0.25 * np.cos(freq[c, 1] * yy / h + phase[c, 1])
        for c in range(3)
    ]
    noise = rng.uniform(-0.05, 0.05, (h, w, 3))
    return np.clip(np.stack(chans, axis=-1) + noise, 0.0, 1.0).astype(np.float32)


def sky_cubemap(size: int = 64) -> np.ndarray:
    """[6, size, size, 3] gradient sky (linear texels): the +Y face zenith
    blue, the side faces blending from zenith blue at their top row to a
    warm horizon at their bottom row, the -Y face ground haze."""
    zenith = np.array([0.20, 0.45, 0.85], np.float32)
    horizon = np.array([0.85, 0.80, 0.70], np.float32)
    ground = np.array([0.25, 0.22, 0.20], np.float32)
    t = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
    faces = np.zeros((6, size, size, 3), np.float32)
    side = horizon * t + zenith * (1 - t)
    for f in (0, 1, 4, 5):
        faces[f] = side
    faces[2] = zenith
    faces[3] = ground
    return faces


# the pitch of the stand-in's camera under the sky: the horizon moves down
# the frame, so about a fifth of the 1080p pixels miss every node
ENV_PITCH = -15.0


# the Monte-Carlo variants of the stand-in's camera: the focal plane at the
# CSG pieces' depth along the view (the diff 349, the inter 321 units), and
# fNumber 2 (a disc of radius 10 / 2 = 5 units, camera.d:252), which blurs
# the floor near the camera and the mirror sphere behind; the eyes of the
# stereo pair 6 units apart
DOF_FOCAL_PLANE, DOF_F_NUMBER, STEREO_SEPARATION = 335.0, 2.0, 6.0


def flagship_standin(T, width: int = 1920, height: int = 1080, seed: int = 5, glass: bool = False,
                     dof: bool = False, stereo: bool = False, samples: int = 25, env: bool = False):
    """The flagship stand-in scene at ``width`` x ``height``: AA on,
    maxTraceDepth 5, two point lights, and

    * a textured floor plane (bitmap A, 256x256),
    * a CSG diff (cube minus sphere) with Phong,
    * a CSG inter (sphere and cube) with a checker texture,
    * a scaled + translated cube with bitmap B (128x128),
    * a sphere with a procedure2 texture,
    * the mirror sphere Reflection(0.9, 0.9, 0.9) at (0, 60, 360), R=55
      (with ``glass``: Refraction(0.95, 0.95, 0.95), ior 1.5, instead).

    ``dof``: the camera's depth of field on, ``samples`` per pixel (the
    reference's default 25), focused on the CSG pieces; ``stereo``: the
    anaglyph stereo pair (DOF_FOCAL_PLANE, DOF_F_NUMBER,
    STEREO_SEPARATION).  ``env``: a 64x64 ``sky_cubemap`` environment,
    with the camera pitched to ENV_PITCH so that more of the frame shows
    it.  ``T`` is a ``models.types`` module (either package's)."""
    rng = np.random.default_rng(seed)
    sc = T.Scene(name="flagship_standin")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = True
    sc.settings.maxTraceDepth = 5
    sc.settings.ambientLightColor = (0.12, 0.12, 0.14)
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=ENV_PITCH if env else -20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(width, height)
    if env:
        sc.environment.cubemap = sky_cubemap(64)
    if dof:
        sc.camera.dof, sc.camera.numSamples = True, samples
        sc.camera.focalPlaneDist, sc.camera.fNumber = DOF_FOCAL_PLANE, DOF_F_NUMBER
        sc.camera.discMultiplier = 10.0 / DOF_F_NUMBER
    if stereo:
        sc.camera.stereoSeparation = STEREO_SEPARATION
    sc.lights = [
        T.PointLight(name="key", pos=(-160.0, 420.0, 120.0), color=(1.0, 0.95, 0.9), power=150000.0),
        T.PointLight(name="fill", pos=(220.0, 260.0, 500.0), color=(0.8, 0.85, 1.0), power=60000.0),
    ]

    bmp_a = T.BitmapTexture(name="floor_tex", scaling=1.0 / 180.0, data=_bitmap(rng, 256, 256))
    bmp_b = T.BitmapTexture(name="box_tex", scaling=1.0 / 40.0, data=_bitmap(rng, 128, 128))
    checker = T.Checker(name="checker", color1=(0.9, 0.9, 0.85), color2=(0.15, 0.2, 0.5), size=12.0)
    proc2 = T.Procedure2(
        name="proc2",
        colorU=[[0.4, 0.1, 0.1], [0.1, 0.3, 0.1], [0.05, 0.05, 0.3]],
        colorV=[[0.1, 0.1, 0.3], [0.3, 0.2, 0.05], [0.1, 0.3, 0.3]],
        freqU=[3.0, 7.0, 13.0],
        freqV=[5.0, 11.0, 17.0],
    )
    sc.textures = [bmp_a, bmp_b, checker, proc2]

    floor_sh = T.Lambert(name="floor", color=(1.0, 1.0, 1.0), texture=bmp_a)
    diff_sh = T.Phong(name="diff", color=(0.85, 0.35, 0.25), exponent=40.0, strength=0.8)
    inter_sh = T.Lambert(name="inter", color=(1.0, 1.0, 1.0), texture=checker)
    box_sh = T.Lambert(name="box", color=(1.0, 1.0, 1.0), texture=bmp_b)
    proc_sh = T.Phong(name="proc", color=(1.0, 1.0, 1.0), exponent=20.0, strength=0.5, texture=proc2)
    if glass:
        mirror = T.Refraction(name="glass", color=(0.95, 0.95, 0.95), ior=1.5)
    else:
        mirror = T.Reflection(name="mirror", color=(0.9, 0.9, 0.9))
    sc.shaders = [floor_sh, diff_sh, inter_sh, box_sh, proc_sh, mirror]

    floor = T.Plane(name="floor", y=0.0)
    diff = T.CsgDiff(
        name="diff",
        left=T.Cube(name="diff_cube", center=(-150.0, 50.0, 330.0), side=100.0),
        right=T.Sphere(name="diff_sphere", center=(-150.0, 70.0, 290.0), R=62.0),
    )
    inter = T.CsgInter(
        name="inter",
        left=T.Sphere(name="inter_sphere", center=(0.0, 0.0, 0.0), R=50.0),
        right=T.Cube(name="inter_cube", center=(0.0, 0.0, 0.0), side=80.0),
    )
    box = T.Cube(name="box", center=(0.0, 0.0, 0.0), side=60.0)
    ball = T.Sphere(name="proc_ball", center=(-60.0, 40.0, 200.0), R=40.0)
    mball = T.Sphere(name="mb", center=(0.0, 60.0, 360.0), R=55.0)
    sc.geometries = [floor, diff, inter, box, ball, mball]

    def node(name, geom, shader, transform=None):
        n = T.Node(name=name, geometry=geom, shader=shader)
        if transform is not None:
            transform(n.transform)
        sc.nodes.append(n)

    node("floor", floor, floor_sh)
    node("diff", diff, diff_sh)
    node("inter", inter, inter_sh, lambda tr: tr.translate((150.0, 50.0, 300.0)))
    node("box", box, box_sh, lambda tr: (tr.scale(1.6, 1.0, 1.3), tr.translate((120.0, 30.0, 180.0))))
    node("proc_ball", ball, proc_sh)
    node("mirror_ball", mball, mirror)
    return sc


# lecture4.sdl's light (the part of scenes.gi_standin with gi=False) and the
# far bounce wall that bench.py's build_gi appends (bench.py:55-81)
GI_LIGHT = ((-150.0, 400.0, 150.0), (1.0, 1.0, 1.0), 120000.0)
GI_WALL = ((60.0, 80.0, 330.0), 50.0, (0.8, 0.8, 0.8))


def lecture4_gi(T, width: int = 640, height: int = 480, seed: int = 5, paths: int = 40):
    """bench.py's ``build_gi`` scene at ``width`` x ``height``: the stand-in
    for the reference's lecture4.sdl (not in the repository) that
    ``scenes.gi_standin(gi=False)`` builds (a checkered Lambert floor, one
    point light, the flagship stand-in's camera), then GI on with ``paths``
    paths per pixel, maxTraceDepth 5, AA off, and the far bounce wall (a
    Lambert 0.8 sphere at (60, 80, 330), R 50) appended as ``build_gi``
    appends it.  NEE (the point-light direct term) is the SceneStatic knob
    ``gi_point_light_direct``, not a scene setting: ``build_gi`` turns it on
    after packing, and so does the configuration.  The scene has no bitmap,
    so ``seed`` changes nothing in it.  ``T`` is a ``models.types`` module
    (either package's)."""
    del seed
    sc = T.Scene(name="lecture4_gi")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = False
    sc.settings.GIEnabled = True
    sc.settings.pathsPerPixel = paths
    sc.settings.maxTraceDepth = 5
    sc.settings.ambientLightColor = (0.1, 0.1, 0.1)
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=-20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(width, height)
    pos, color, power = GI_LIGHT
    sc.lights = [T.PointLight(name="light", pos=pos, color=color, power=power)]
    checker = T.Checker(name="checker", color1=(0.8, 0.8, 0.8), color2=(0.2, 0.2, 0.2), size=20.0)
    sc.textures = [checker]
    floor = T.Node(name="floor", geometry=T.Plane(name="floor", y=0.0),
                   shader=T.Lambert(name="floor", color=(1.0, 1.0, 1.0), texture=checker))
    center, r, white = GI_WALL
    wall = T.Node(name="wall", geometry=T.Sphere(name="w", center=center, R=r),
                  shader=T.Lambert(name="white", color=white))
    for n in (floor, wall):
        sc.nodes.append(n)
        sc.geometries.append(n.geometry)
        sc.shaders.append(n.shader)
    return sc


def build_scene(types_module, config: dict, mode: dict, seed: int):
    """The configuration's scene in ``types_module`` at the mode's size
    (not part of the copy): the builder that ``config["scene"]`` names, with
    its arguments; ``seed`` makes the bitmaps' texels."""
    spec = config["scene"]
    if spec["builder"] not in BUILDERS:
        raise ValueError(f"config {config['name']}: unknown scene builder {spec['builder']!r}")
    return BUILDERS[spec["builder"]](types_module, mode["width"], mode["height"],
                                     seed=int(seed) & 0xFFFFFFFFFFFFFFFF, **spec.get("args", {}))


BUILDERS = {"flagship_standin": flagship_standin, "lecture4_gi": lecture4_gi}
