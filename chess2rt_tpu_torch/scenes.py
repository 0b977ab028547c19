"""Scenes built in code.

``flagship_standin`` stands in for the flagship configuration — the
reference's lecture5.sdl (plane + globe bitmaps, a CsgDiff cube minus
sphere, Phong spheres, translated nodes) plus the depth-5 mirror sphere
that the benchmark adds — because no scene file ships with the repository.
It builds from either package's ``models.types`` module, so the JAX
package and this one render the identical scene.  ``random_scene`` makes
the seeded fuzz scenes that hold the round-0 kernel to its references, and
``csg_stress_scene`` the two scenes that load its CSG hit lists the most.
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


def flagship_standin(T, width: int = 1920, height: int = 1080, seed: int = 5, glass: bool = False):
    """The flagship stand-in scene at ``width`` x ``height``: AA on,
    maxTraceDepth 5, two point lights, and

    * a textured floor plane (bitmap A, 256x256),
    * a CSG diff (cube minus sphere) with Phong,
    * a CSG inter (sphere and cube) with a checker texture,
    * a scaled + translated cube with bitmap B (128x128),
    * a sphere with a procedure2 texture,
    * the mirror sphere Reflection(0.9, 0.9, 0.9) at (0, 60, 360), R=55
      (with ``glass``: Refraction(0.95, 0.95, 0.95), ior 1.5, instead).

    ``T`` is a ``models.types`` module (either package's)."""
    rng = np.random.default_rng(seed)
    sc = T.Scene(name="flagship_standin")
    sc.settings.frameWidth, sc.settings.frameHeight = width, height
    sc.settings.AAEnabled = True
    sc.settings.maxTraceDepth = 5
    sc.settings.ambientLightColor = (0.12, 0.12, 0.14)
    sc.camera = T.Camera(pos=(0.0, 165.0, 0.0), yaw=0.0, pitch=-20.0, roll=0.0, fov=90.0)
    sc.camera.set_frame_size(width, height)
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
    kernel's ``MAX_HITS``), checker-textured so its records carry UVs; a
    scaled and translated intersection of a four-sphere union with a cube
    (10 hits); a floor plane.  ``"nested_diff"``: CsgDiff nodes inside
    CsgDiff nodes on both sides, so a hit's normal is flipped by more than
    one level and hits are dropped at inner and outer levels; one of them
    translated, one a mirror.  One light, AA off, a 70 degree camera."""
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
    else:
        raise ValueError(f"csg_stress_scene: kind must be 'deep16' or 'nested_diff', got {kind!r}")
    return sc
