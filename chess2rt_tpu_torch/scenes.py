"""Scenes built in code.

``flagship_standin`` stands in for the flagship configuration — the
reference's lecture5.sdl (plane + globe bitmaps, a CsgDiff cube minus
sphere, Phong spheres, translated nodes) plus the depth-5 mirror sphere
that the benchmark adds — because no scene file ships with the repository.
It builds from either package's ``models.types`` module, so the JAX
package and this one render the identical scene.  ``random_scene`` makes
the seeded fuzz scenes that hold the round-0 kernel to its references,
``csg_stress_scene`` the two scenes that load its CSG hit lists the most,
``csg_free_scene`` the scenes a float64 frame is held u8-exact to the
oracle on, and ``gi_standin`` the global-illumination configuration (the
reference's lecture4.sdl plus the benchmark's far bounce wall, made
all-Lambert with a bitmap and a CSG node).  ``bump_scene`` is the bump-map
configuration (every tangent case the reference computes) and
``sky_cubemap`` the gradient sky that ``flagship_standin(env=True)`` and
``gi_standin(env=True)`` put around the stand-ins.  ``write_standin_sdl``
and ``write_gi_standin_sdl`` write the two stand-ins as scene files with
their bitmaps, for the command line.
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


def _random_leaf(T, rng, name):
    kind = rng.integers(0, 3)
    if kind == 0:
        return T.Plane(name=name, y=float(rng.uniform(-2, 2)))
    if kind == 1:
        return T.Sphere(name=name, center=tuple(rng.uniform(-3, 3, 3)), R=float(rng.uniform(0.5, 2.5)))
    return T.Cube(name=name, center=tuple(rng.uniform(-3, 3, 3)), side=float(rng.uniform(0.5, 3.0)))


def _random_csg(T, rng, name, depth):
    if depth == 0 or rng.random() < 0.3:
        return _random_leaf(T, rng, name)
    op = ["union", "inter", "diff"][rng.integers(0, 3)]
    cls = {"union": T.CsgUnion, "inter": T.CsgInter, "diff": T.CsgDiff}[op]
    return cls(
        name=name,
        op=op,
        left=_random_csg(T, rng, name + "l", depth - 1),
        right=_random_csg(T, rng, name + "r", depth - 1),
    )


def random_scene(T, seed: int, n_nodes: int = 3, width: int = 32, height: int = 24):
    """A seeded random scene: random primitive mixes, nested CSG up to two
    levels, identity / translate / scale+translate transforms, Lambert,
    Phong and Reflection shaders, checker and procedure2 textures, one
    light, AA off.  The recipe (and the draw order) of the JAX package's
    fuzz scenes, tests/test_fuzz.py TestFuzzPallasKernel._random_scene."""
    rng = np.random.default_rng(seed)
    sc = T.Scene()
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.camera.set_frame_size(width, height)
    sc.settings.AAEnabled = False
    sc.camera.pos = (0.0, float(rng.uniform(1.0, 4.0)), -8.0)
    sc.camera.pitch = float(rng.uniform(-25, 5))
    sc.lights = [
        T.PointLight(name="L", pos=tuple(rng.uniform(-5, 5, 3) + (0, 8, 0)),
                     color=(1, 1, 1), power=float(rng.uniform(30, 120)))
    ]
    for i in range(n_nodes):
        geom = _random_csg(T, rng, f"g{i}", depth=rng.integers(0, 3))
        skind = rng.integers(0, 3)
        if skind == 0:
            sh = T.Lambert(name=f"s{i}", color=tuple(rng.uniform(0.2, 1.0, 3)))
        elif skind == 1:
            sh = T.Phong(name=f"s{i}", color=tuple(rng.uniform(0.2, 1.0, 3)),
                         exponent=float(rng.uniform(5, 80)), strength=float(rng.uniform(0.2, 1.0)))
        else:
            sh = T.Reflection(name=f"s{i}", color=(0.9, 0.9, 0.9))
        tkind = rng.integers(0, 3)
        if tkind == 1 and skind != 2:
            sh.texture = T.Checker(name=f"t{i}", color1=tuple(rng.uniform(0, 1, 3)),
                                   color2=tuple(rng.uniform(0, 1, 3)), size=float(rng.uniform(0.5, 3)))
        elif tkind == 2 and skind != 2:
            sh.texture = T.Procedure2(
                name=f"t{i}",
                colorU=rng.uniform(0, 0.5, (3, 3)).tolist(),
                colorV=rng.uniform(0, 0.5, (3, 3)).tolist(),
                freqU=rng.uniform(0.2, 2.0, 3).tolist(),
                freqV=rng.uniform(0.2, 2.0, 3).tolist(),
            )
        node = T.Node(name=f"n{i}", geometry=geom, shader=sh)
        tr = rng.integers(0, 3)
        if tr == 1:
            node.transform.translate(tuple(rng.uniform(-3, 3, 3)))
        elif tr == 2:
            sx, sy, sz = rng.uniform(0.6, 1.8, 3)
            node.transform.scale(float(sx), float(sy), float(sz))
            node.transform.translate(tuple(rng.uniform(-3, 3, 3)))
        sc.nodes.append(node)
        sc.geometries.append(geom)
        sc.shaders.append(sh)
    return sc


def csg_stress_scene(T, kind: str, width: int = 32, height: int = 24):
    """Scenes that load the round-0 kernel's CSG hit lists the most.

    ``"deep16"``: a union of eight overlapping spheres, 16 hits per ray (the
    list length the kernel held before its lists were sized per scene),
    checker-textured so its records carry UVs; a scaled and translated
    intersection of a four-sphere union with a cube (10 hits); a floor
    plane.  ``"nested_diff"``: CsgDiff nodes inside CsgDiff nodes on both
    sides, so a hit's normal is flipped by more than one level and hits are
    dropped at inner and outer levels; one of them translated, one a
    mirror.  ``"deep40"``: a union of 20 overlapping spheres (40 hits, 39
    instructions: one sphere and a balanced union of 19), checker-textured,
    scaled and translated; a floor plane.  ``"diff_nest"``: 17 spheres nested right-deep under
    CsgDiffs, s0 - (s1 - (s2 - ...)), 33 instructions and 34 hits, so tags
    name instructions past 31 and a leaf sits under up to 16 CsgDiffs; a
    floor plane.  One light, AA off, a 70 degree camera."""
    sc = T.Scene(name=f"csg_stress_{kind}")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.camera.set_frame_size(width, height)
    sc.settings.AAEnabled = False
    sc.camera.pos = (0.0, 2.2, -5.0)
    sc.camera.pitch = -12.0
    sc.camera.fov = 70.0
    sc.lights = [T.PointLight(name="L", pos=(-3.0, 9.0, -4.0), color=(1, 1, 1), power=90.0)]

    def union(name, parts):
        geom = parts[0]
        for k, part in enumerate(parts[1:]):
            geom = T.CsgUnion(name=f"{name}u{k}", op="union", left=geom, right=part)
        return geom

    def balanced_union(name, parts):
        if len(parts) == 1:
            return parts[0]
        m = len(parts) // 2
        return T.CsgUnion(name=f"{name}{len(parts)}_{m}", op="union", left=balanced_union(f"{name}l", parts[:m]),
                          right=balanced_union(f"{name}r", parts[m:]))

    def node(name, geom, shader, transform=None):
        n = T.Node(name=name, geometry=geom, shader=shader)
        if transform is not None:
            transform(n.transform)
        sc.nodes.append(n)
        sc.geometries.append(geom)
        sc.shaders.append(shader)

    checker = T.Checker(name="chk", color1=(0.9, 0.9, 0.8), color2=(0.2, 0.3, 0.6), size=0.7)
    node("floor", T.Plane(name="floor", y=-1.0), T.Lambert(name="floor", color=(0.7, 0.7, 0.7)))
    if kind == "deep16":
        chain = union("chain", [T.Sphere(name=f"c{k}", center=(-3.5 + k, 0.3 * (k % 3), 1.0 + 0.4 * (k % 2)), R=0.8)
                                for k in range(8)])
        node("chain", chain, T.Lambert(name="chain", color=(1.0, 1.0, 1.0), texture=checker))
        blob = T.CsgInter(
            name="blob", op="inter",
            left=union("blob", [T.Sphere(name=f"b{k}", center=(-0.9 + 0.6 * k, 0.0, 0.0), R=0.7) for k in range(4)]),
            right=T.Cube(name="blob_cube", center=(0.0, 0.0, 0.0), side=1.1),
        )
        node("blob", blob, T.Phong(name="blob", color=(0.8, 0.4, 0.3), exponent=30.0, strength=0.6),
             lambda tr: (tr.scale(1.4, 1.0, 0.8), tr.translate((0.5, 2.2, -1.0))))
    elif kind == "nested_diff":
        both = T.CsgDiff(
            name="both", op="diff",
            left=T.CsgDiff(name="bl", op="diff", left=T.Cube(name="bl_c", center=(-1.5, 0.5, 0.0), side=3.0),
                           right=T.Sphere(name="bl_s", center=(-1.5, 0.9, -1.2), R=1.3)),
            right=T.CsgDiff(name="br", op="diff", left=T.Sphere(name="br_s", center=(-0.4, 1.6, 0.2), R=1.4),
                            right=T.Cube(name="br_c", center=(-0.4, 1.6, -0.6), side=1.2)),
        )
        node("both", both, T.Phong(name="both", color=(0.85, 0.5, 0.3), exponent=25.0, strength=0.7))
        shell = T.CsgDiff(
            name="shell", op="diff", left=T.Sphere(name="sh_s", center=(0.0, 0.0, 0.0), R=1.5),
            right=T.CsgDiff(name="sh_in", op="diff", left=T.Cube(name="sh_c", center=(0.0, 0.2, -0.8), side=1.8),
                            right=T.Sphere(name="sh_h", center=(0.0, 0.2, -0.8), R=0.7)),
        )
        node("shell", shell, T.Lambert(name="shell", color=(1.0, 1.0, 1.0), texture=checker),
             lambda tr: tr.translate((2.6, 0.8, 0.5)))
        pit = T.CsgDiff(name="pit", op="diff", left=T.Sphere(name="pit_s", center=(0.8, 3.2, 2.0), R=1.2),
                        right=T.Sphere(name="pit_h", center=(0.8, 3.4, 1.1), R=0.8))
        node("pit", pit, T.Reflection(name="pit", color=(0.9, 0.9, 0.9)))
    elif kind == "deep40":
        # a sphere in front of a 5 x 4 wall of 19 overlapping spheres, the wall a
        # balanced union (the reference's CSG keeps the hits where the state
        # after a crossing is inside, so below the top merge a union drops its
        # exits and the wall itself never wins; the top merge still sorts and
        # walks all 40 slots)
        wall = [T.Sphere(name=f"d{k}", center=(-2.4 + 1.2 * (k % 5), -0.5 + 0.8 * (k // 5), 0.6 + 0.3 * (k % 2)),
                         R=0.65) for k in range(1, 20)]
        front = T.Sphere(name="d0", center=(-0.4, 0.4, -0.4), R=0.9)
        node("cluster", T.CsgUnion(name="cl", op="union", left=front, right=balanced_union("cl", wall)),
             T.Lambert(name="cluster", color=(1.0, 1.0, 1.0), texture=checker),
             lambda tr: (tr.scale(1.1, 1.0, 0.9), tr.translate((0.3, 0.2, 1.0))))
    elif kind == "diff_nest":
        geom = None
        for k in reversed(range(17)):
            ball = T.Sphere(name=f"n{k}", center=(-1.6 + 0.2 * k, 0.8 + 0.1 * (k % 3), 0.6 - 0.05 * k),
                            R=1.5 - 0.04 * k)
            geom = ball if geom is None else T.CsgDiff(name=f"nd{k}", op="diff", left=ball, right=geom)
        node("nest", geom,
             T.Phong(name="nest", color=(0.8, 0.6, 0.3), exponent=20.0, strength=0.5, texture=checker))
    else:
        raise ValueError(f"csg_stress_scene: kind must be 'deep16', 'nested_diff', 'deep40' or 'diff_nest', "
                         f"got {kind!r}")
    return sc


def csg_free_scene(T, seed: int, width: int = 32, height: int = 24):
    """A seeded scene without CSG or bitmaps, in the manner of the
    reference's lecture4.sdl (a checkered floor, Lambert and Phong
    primitives, a procedure2 texture), plus a scaled and translated cube
    and a mirror sphere: the scene class on which a float64 frame is held
    u8-exact to the oracle.  AA on, maxTraceDepth 4, one light, the
    stand-in's camera."""
    rng = np.random.default_rng(seed)
    sc = T.Scene(name=f"csg_free_{seed}")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = True
    sc.settings.ambientLightColor = (0.1, 0.1, 0.12)
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=-20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(width, height)
    sc.lights = [T.PointLight(name="key", pos=tuple(rng.uniform(-200, 200, 3) + (0, 420, 200)),
                              color=(1.0, 0.95, 0.9), power=float(rng.uniform(1e5, 2e5)))]
    checker = T.Checker(name="checker", color1=(0.9, 0.9, 0.85), color2=(0.15, 0.2, 0.5),
                        size=float(rng.uniform(15, 40)))
    proc2 = T.Procedure2(
        name="proc2",
        colorU=rng.uniform(0, 0.4, (3, 3)).tolist(),
        colorV=rng.uniform(0, 0.4, (3, 3)).tolist(),
        freqU=rng.uniform(2, 15, 3).tolist(),
        freqV=rng.uniform(2, 15, 3).tolist(),
    )

    def node(name, geom, shader, transform=None):
        n = T.Node(name=name, geometry=geom, shader=shader)
        if transform is not None:
            transform(n.transform)
        sc.nodes.append(n)
        sc.geometries.append(geom)
        sc.shaders.append(shader)

    def spot(z):
        return (float(rng.uniform(-150, 150)), float(rng.uniform(30, 70)), float(z))

    node("floor", T.Plane(name="floor", y=0.0), T.Lambert(name="floor", color=(1.0, 1.0, 1.0), texture=checker))
    node("phong_ball", T.Sphere(name="pb", center=spot(220), R=float(rng.uniform(30, 50))),
         T.Phong(name="pb", color=tuple(rng.uniform(0.3, 1.0, 3)), exponent=float(rng.uniform(10, 60)), strength=0.7))
    node("proc_ball", T.Sphere(name="qb", center=spot(300), R=float(rng.uniform(30, 50))),
         T.Lambert(name="qb", color=(1.0, 1.0, 1.0), texture=proc2))
    node("box", T.Cube(name="box", center=(0.0, 0.0, 0.0), side=60.0),
         T.Lambert(name="box", color=tuple(rng.uniform(0.3, 1.0, 3))),
         lambda tr: (tr.scale(1.5, 1.0, 1.2), tr.translate(spot(180))))
    node("mirror_ball", T.Sphere(name="mb", center=(0.0, 60.0, 380.0), R=55.0),
         T.Reflection(name="mirror", color=(0.9, 0.9, 0.9)))
    return sc


# the GI stand-in's geometry, shared by gi_standin and write_gi_standin_sdl:
# the far bounce wall of bench.py's build_gi, a bitmap box and a CSG node
# (a cube with a sphere bitten out, rounded by an inter with a sphere: six
# hits per ray, so K1 merges them in its hit lists)
GI_LIGHT = ((-150.0, 400.0, 150.0), (1.0, 1.0, 1.0), 120000.0)
GI_WALL = ((60.0, 80.0, 330.0), 50.0, (0.8, 0.8, 0.8))
GI_BOX = ((1.5, 1.0, 1.2), (-130.0, 30.0, 250.0))
GI_CSG = ((150.0, 50.0, 280.0), (0.3, 0.5, 0.8))


def gi_standin(T, width: int = 640, height: int = 480, seed: int = 5, paths: int = 40, env: bool = False,
               gi: bool = True):
    """The GI stand-in at ``width`` x ``height``: the reference's lecture4.sdl
    (a checkered Lambert floor, one point light, 640x480; not in the
    repository) plus the far bounce wall of bench.py's ``build_gi`` (a
    Lambert 0.8 sphere at (60, 80, 330), R 50), a bitmap-textured Lambert
    box (scaled and translated) and a Lambert CSG node, every shader
    Lambert, so that the fused GI path covers it.  GI on, ``paths`` paths
    per pixel (``build_gi``'s 40), maxTraceDepth 5, AA off, the flagship
    stand-in's camera.  NEE (the point-light direct term) is the SceneStatic
    knob ``gi_point_light_direct``, not a scene setting: ``build_gi`` turns
    it on after packing, and so do this scene's callers.  ``env``: a 64x64
    ``sky_cubemap`` environment, the paths' miss term.  ``gi`` False:
    lecture4.sdl's part alone (the floor and the light), GI off, the scene
    the inverse-rendering demo adds its ball to.  ``T`` is a
    ``models.types`` module (either package's)."""
    rng = np.random.default_rng(seed)
    sc = T.Scene(name="gi_standin")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = False
    sc.settings.GIEnabled = gi
    sc.settings.pathsPerPixel = paths
    sc.settings.maxTraceDepth = 5
    sc.settings.ambientLightColor = (0.1, 0.1, 0.1)
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=-20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(width, height)
    if env:
        sc.environment.cubemap = sky_cubemap(64)
    pos, color, power = GI_LIGHT
    sc.lights = [T.PointLight(name="light", pos=pos, color=color, power=power)]
    checker = T.Checker(name="checker", color1=(0.8, 0.8, 0.8), color2=(0.2, 0.2, 0.2), size=20.0)
    bmp = T.BitmapTexture(name="box_tex", scaling=1.0 / 40.0, data=_bitmap(rng, 128, 128))
    sc.textures = [checker, bmp]

    def node(name, geom, shader, transform=None):
        n = T.Node(name=name, geometry=geom, shader=shader)
        if transform is not None:
            transform(n.transform)
        sc.nodes.append(n)
        sc.geometries.append(geom)
        sc.shaders.append(shader)

    center, r, white = GI_WALL
    scale, move = GI_BOX
    at, blue = GI_CSG
    node("floor", T.Plane(name="floor", y=0.0), T.Lambert(name="floor", color=(1.0, 1.0, 1.0), texture=checker))
    if not gi:
        sc.textures = [checker]
        return sc
    node("wall", T.Sphere(name="w", center=center, R=r), T.Lambert(name="white", color=white))
    node("box", T.Cube(name="box", center=(0.0, 0.0, 0.0), side=60.0),
         T.Lambert(name="box", color=(1.0, 1.0, 1.0), texture=bmp),
         lambda tr: (tr.scale(*scale), tr.translate(move)))
    csg = T.CsgInter(
        name="csg",
        left=T.CsgDiff(name="csg_diff", left=T.Cube(name="csg_cube", center=(0.0, 0.0, 0.0), side=80.0),
                       right=T.Sphere(name="csg_bite", center=(-25.0, 30.0, -25.0), R=30.0)),
        right=T.Sphere(name="csg_sphere", center=(0.0, 0.0, 0.0), R=52.0),
    )
    node("csg", csg, T.Lambert(name="csg", color=blue), lambda tr: tr.translate(at))
    return sc


def heightmap(size: int = 32) -> np.ndarray:
    """A smooth, low-frequency [size, size, 3] height field (the bump maps'
    source; ``differentiate`` makes the derivative map)."""
    yy, xx = np.mgrid[0:size, 0:size]
    height = (0.5 + 0.5 * np.sin(xx * 0.25) * np.cos(yy * 0.2)).astype(np.float32)
    return np.repeat(height[..., None], 3, axis=-1)


def bump_scene(T, width: int = 1920, height: int = 1080, mirror: bool = True, bump_csg: bool = True,
               aa: bool = True):
    """The bump-map configuration: a plane, a sphere, a scaled and
    translated cube and a CsgDiff of two spheres, every tangent case the
    reference computes, all Lambert and bump-mapped by one BumpTexture
    (``heightmap``, scaling 0.05, strength 8), one light, maxTraceDepth 2.  ``mirror``
    adds a Reflection sphere, so bounce rounds re-shade bump-mapped
    surfaces; ``bump_csg`` False leaves the CSG node un-bumped, which lets
    the fused path take its fast forward (every bump-mapped node a single
    primitive).  ``aa``: 5-tap AA.  The JAX package's bump scene
    (tests/test_bump.py), built from either package's ``models.types``
    module ``T``."""
    sc = T.Scene(name="bump_scene")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = aa
    sc.settings.maxTraceDepth = 2
    sc.camera = T.Camera(pos=(0, 60, -120), yaw=0, pitch=-15, fov=90)
    sc.camera.set_frame_size(width, height)
    sc.lights.append(T.PointLight(pos=(60, 180, -60), color=(1, 1, 1), power=40000))
    lam = T.Lambert(name="l", color=(0.7, 0.7, 0.7))
    sc.shaders.append(lam)
    bt = T.BumpTexture(name="bt", scaling=0.05, data=heightmap())
    bt.strength = 8.0
    sc.textures.append(bt)

    def node(name, geom, transform=None, bumped=True):
        sc.geometries.append(geom)
        n = T.Node(name=name, geometry=geom, shader=lam)
        if transform:
            transform(n.transform)
        if bumped:
            n.bumpmap = bt
        sc.nodes.append(n)

    node("floor", T.Plane(name="p", y=0, limit=200))
    node("ball", T.Sphere(name="s", center=(0, 40, 30), R=30.0))
    node("box", T.Cube(name="c", center=(0, 0, 0), side=30.0),
         transform=lambda tr: (tr.scale(1.5, 1.0, 1.0), tr.translate((-60, 20, 10))))
    node("csg", T.CsgDiff(name="d", left=T.Sphere(name="ds", center=(60, 25, 0), R=25.0),
                          right=T.Sphere(name="ds2", center=(60, 40, -15), R=20.0)), bumped=bump_csg)
    if mirror:
        mir = T.Reflection(name="m", color=(0.9, 0.9, 0.9))
        sc.shaders.append(mir)
        g = T.Sphere(name="ms", center=(-15, 30, -45), R=15.0)
        sc.geometries.append(g)
        sc.nodes.append(T.Node(name="mirror", geometry=g, shader=mir))
    return sc


def _sdl_vec(v) -> str:
    return " ".join(repr(float(x)) for x in v)


def write_standin_sdl(directory: str, width: int = 1920, height: int = 1080, seed: int = 5,
                      name: str = "standin.sdl", aa: bool = True, dof: bool = False, stereo: bool = False,
                      samples: int = 25, bump: bool = False, env: bool = False) -> str:
    """Write the flagship stand-in as a scene file the loaders read: an
    SDLang ``name`` in ``directory`` and its two bitmaps beside it as BMP
    files (``floor_tex.bmp``, ``box_tex.bmp``; 8-bit sRGB, so the loader's
    gamma decode gives texels close to, not equal to, ``flagship_standin``'s).
    Returns the scene file's path.  Same features as ``flagship_standin``:
    CSG diff and inter, two bitmaps, a checker, a procedure2, Phong, a
    scaled and translated cube, the mirror sphere, AA5 (``aa``),
    maxTraceDepth 5, and the Monte-Carlo camera options (``dof``,
    ``stereo``, ``samples``).  ``bump``: a BumpTexture of ``heightmap``
    (``bump.bmp``, strength 8) on the floor and the procedure2 ball;
    ``env``: the ``sky_cubemap`` environment as six BMP faces
    (``sky_posx.bmp`` ... ``sky_negz.bmp``) and the camera at ENV_PITCH,
    as ``flagship_standin(env=True)``."""
    import os

    from .imageio.bmp import save_bmp_file

    rng = np.random.default_rng(seed)
    for fname, size in (("floor_tex.bmp", 256), ("box_tex.bmp", 128)):
        # linear texels in, sRGB bytes out (the loader decodes them back)
        save_bmp_file(os.path.join(directory, fname), _bitmap(rng, size, size))
    camera_mc = ""
    if dof:
        camera_mc += (f"\n        dof true\n        numSamples {samples}\n        focalPlaneDist {DOF_FOCAL_PLANE!r}"
                      f"\n        fNumber {DOF_F_NUMBER!r}")
    if stereo:
        camera_mc += f"\n        stereoSeparation {STEREO_SEPARATION!r}"
    bump_tex = bump_floor = bump_ball = environment = ""
    if bump:
        save_bmp_file(os.path.join(directory, "bump.bmp"), heightmap())
        bump_tex = '\n        BumpTexture { name "bump"; file "bump.bmp"; scaling 0.05; strength 8.0 }'
        bump_floor = bump_ball = '; bump "bump"'
    if env:
        for face, rgb in zip(("posx", "negx", "posy", "negy", "posz", "negz"), sky_cubemap(64)):
            save_bmp_file(os.path.join(directory, f"sky_{face}.bmp"), rgb)
        environment = '\n    Environment {\n        cubemap "sky_"\n    }'
    text = f"""// the flagship stand-in (chess2rt_tpu_torch/scenes.py), as a scene file
Scene {{
    Name "flagship_standin"
    GlobalSettings {{
        frameWidth {width}
        frameHeight {height}
        AAEnabled {"true" if aa else "false"}
        maxTraceDepth 5
        ambientLightColor 0.12 0.12 0.14
    }}
    Camera {{
        pos 0.0 165.0 0.0
        pitch {ENV_PITCH if env else -20.0!r}
        fov 90.0{camera_mc}
    }}{environment}
    Lights {{
        PointLight {{ name "key"; pos -160.0 420.0 120.0; color 1.0 0.95 0.9; power 150000.0 }}
        PointLight {{ name "fill"; pos 220.0 260.0 500.0; color 0.8 0.85 1.0; power 60000.0 }}
    }}
    Geometries {{
        Plane {{ name "floor"; y 0.0 }}
        Cube {{ name "diff_cube"; center -150.0 50.0 330.0; side 100.0 }}
        Sphere {{ name "diff_sphere"; center -150.0 70.0 290.0; R 62.0 }}
        CsgDiff {{ name "diff"; left "diff_cube"; right "diff_sphere" }}
        Sphere {{ name "inter_sphere"; center 0.0 0.0 0.0; R 50.0 }}
        Cube {{ name "inter_cube"; center 0.0 0.0 0.0; side 80.0 }}
        CsgInter {{ name "inter"; left "inter_sphere"; right "inter_cube" }}
        Cube {{ name "box"; center 0.0 0.0 0.0; side 60.0 }}
        Sphere {{ name "proc_ball"; center -60.0 40.0 200.0; R 40.0 }}
        Sphere {{ name "mb"; center 0.0 60.0 360.0; R 55.0 }}
    }}
    Textures {{
        BitmapTexture {{ name "floor_tex"; file "floor_tex.bmp"; scaling {1.0 / 180.0!r} }}
        BitmapTexture {{ name "box_tex"; file "box_tex.bmp"; scaling {1.0 / 40.0!r} }}
        Checker {{ name "checker"; color1 0.9 0.9 0.85; color2 0.15 0.2 0.5; size 12.0 }}
        Procedure2 {{
            name "proc2"
            colorU {{ {_sdl_vec((0.4, 0.1, 0.1))}; {_sdl_vec((0.1, 0.3, 0.1))}; {_sdl_vec((0.05, 0.05, 0.3))} }}
            colorV {{ {_sdl_vec((0.1, 0.1, 0.3))}; {_sdl_vec((0.3, 0.2, 0.05))}; {_sdl_vec((0.1, 0.3, 0.3))} }}
            freqU 3.0 7.0 13.0
            freqV 5.0 11.0 17.0
        }}{bump_tex}
    }}
    Shaders {{
        Lambert {{ name "floor"; color 1.0 1.0 1.0; texture "floor_tex" }}
        Phong {{ name "diff"; color 0.85 0.35 0.25; exponent 40.0; strength 0.8 }}
        Lambert {{ name "inter"; color 1.0 1.0 1.0; texture "checker" }}
        Lambert {{ name "box"; color 1.0 1.0 1.0; texture "box_tex" }}
        Phong {{ name "proc"; color 1.0 1.0 1.0; exponent 20.0; strength 0.5; texture "proc2" }}
        Reflection {{ name "mirror"; color 0.9 0.9 0.9 }}
    }}
    Nodes {{
        Node {{ name "floor"; geometry "floor"; shader "floor"{bump_floor} }}
        Node {{ name "diff"; geometry "diff"; shader "diff" }}
        Node {{ name "inter"; geometry "inter"; shader "inter"; translate 150.0 50.0 300.0 }}
        Node {{ name "box"; geometry "box"; shader "box"; scale 1.6 1.0 1.3; translate 120.0 30.0 180.0 }}
        Node {{ name "proc_ball"; geometry "proc_ball"; shader "proc"{bump_ball} }}
        Node {{ name "mirror_ball"; geometry "mb"; shader "mirror" }}
    }}
}}
"""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def write_gi_standin_sdl(directory: str, width: int = 640, height: int = 480, seed: int = 5,
                         name: str = "gi.sdl", paths: int = 40) -> str:
    """Write ``gi_standin`` as a scene file the loaders read: an SDLang
    ``name`` in ``directory`` and the box's bitmap beside it as a BMP file
    (``box_tex.bmp``, 8-bit sRGB).  Returns the scene file's path.  SDL has
    no switch for the NEE extension, so the file renders the reference's
    GI, which is black with point lights only (their solid angle is 0)."""
    import os

    from .imageio.bmp import save_bmp_file

    rng = np.random.default_rng(seed)
    save_bmp_file(os.path.join(directory, "box_tex.bmp"), _bitmap(rng, 128, 128))
    (lpos, lcol, lpow), (wc, wr, wcol), (bscale, bmove), (cat, ccol) = GI_LIGHT, GI_WALL, GI_BOX, GI_CSG
    text = f"""// the GI stand-in (chess2rt_tpu_torch/scenes.py), as a scene file
Scene {{
    Name "gi_standin"
    GlobalSettings {{
        frameWidth {width}
        frameHeight {height}
        AAEnabled false
        GIEnabled true
        pathsPerPixel {paths}
        maxTraceDepth 5
        ambientLightColor 0.1 0.1 0.1
    }}
    Camera {{
        pos 0.0 165.0 0.0
        pitch -20.0
        fov 90.0
    }}
    Lights {{
        PointLight {{ name "light"; pos {_sdl_vec(lpos)}; color {_sdl_vec(lcol)}; power {lpow!r} }}
    }}
    Geometries {{
        Plane {{ name "floor"; y 0.0 }}
        Sphere {{ name "w"; center {_sdl_vec(wc)}; R {wr!r} }}
        Cube {{ name "box"; center 0.0 0.0 0.0; side 60.0 }}
        Cube {{ name "csg_cube"; center 0.0 0.0 0.0; side 80.0 }}
        Sphere {{ name "csg_bite"; center -25.0 30.0 -25.0; R 30.0 }}
        CsgDiff {{ name "csg_diff"; left "csg_cube"; right "csg_bite" }}
        Sphere {{ name "csg_sphere"; center 0.0 0.0 0.0; R 52.0 }}
        CsgInter {{ name "csg"; left "csg_diff"; right "csg_sphere" }}
    }}
    Textures {{
        Checker {{ name "checker"; color1 0.8 0.8 0.8; color2 0.2 0.2 0.2; size 20.0 }}
        BitmapTexture {{ name "box_tex"; file "box_tex.bmp"; scaling {1.0 / 40.0!r} }}
    }}
    Shaders {{
        Lambert {{ name "floor"; color 1.0 1.0 1.0; texture "checker" }}
        Lambert {{ name "white"; color {_sdl_vec(wcol)} }}
        Lambert {{ name "box"; color 1.0 1.0 1.0; texture "box_tex" }}
        Lambert {{ name "csg"; color {_sdl_vec(ccol)} }}
    }}
    Nodes {{
        Node {{ name "floor"; geometry "floor"; shader "floor" }}
        Node {{ name "wall"; geometry "w"; shader "white" }}
        Node {{ name "box"; geometry "box"; shader "box"; scale {_sdl_vec(bscale)}; translate {_sdl_vec(bmove)} }}
        Node {{ name "csg"; geometry "csg"; shader "csg"; translate {_sdl_vec(cat)} }}
    }}
}}
"""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write(text)
    return path
