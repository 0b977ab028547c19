"""Device-side camera: the frame's screen corners and pinhole rays
(camera.d:77-147).

Counterpart of chess2rt_tpu/ops/camera.py: the pinhole rays with the
stereo eye offset, the depth-of-field disc sample and the df32
``compensated_raygen`` opt-in (``_begin_frame_df``, ops/df32.py).  The op order
is the JAX package's: the round-0 kernel's camera slot is built from these
corners, and a reordered product moves knife-edge pixels and camera
gradients.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.packed import CameraPacked
from ..utils import vec
from . import prng


def _begin_frame_df(cam: CameraPacked, aspect: float):
    """Screen corners in df32 (two-float) precision: beginFrame's f64
    corner math (camera.d:77-117) in emulated double-float arithmetic
    (ops/df32.py), so the per-ray direction rounded back to f32 is
    correctly rounded.

    Returns {"ul": [(hi, lo)] * 3, "dx": ..., "dy": ...}, with dx = ur - ul
    and dy = dl - ul the interpolation deltas, each component a df32 pair
    of f32 scalars."""
    from . import df32 as df

    dev = cam.pos.device

    def c(x):
        return df.const(x, device=dev)

    rad = np.pi / 180.0  # host f64, split exactly into df32
    fov_half = df.mul_f32(c(rad / 2.0), cam.fov)
    wanted = df.tan(fov_half)
    # x = -aspect, y = 1 (camera.d:88-93); aspect is a host f64
    aspect_d = c(float(aspect))
    len_xy = df.sqrt(df.add(df.mul(aspect_d, aspect_d), c(1.0)))
    scaling = df.div(wanted, len_xy)
    xs = df.neg(df.mul(aspect_d, scaling))
    ys = scaling
    one = c(1.0)

    def rot_axis(i, j, angle):
        s, co = df.sincos(df.mul_f32(c(rad), angle))
        zero, uno = c(0.0), c(1.0)
        m = [[uno if r == col else zero for col in range(3)] for r in range(3)]
        m[i][i] = co
        m[i][j] = df.neg(s)
        m[j][i] = s
        m[j][j] = co
        return m

    def matmul(a, b):
        return [
            [df.add(df.add(df.mul(a[r][0], b[0][col]), df.mul(a[r][1], b[1][col])), df.mul(a[r][2], b[2][col]))
             for col in range(3)]
            for r in range(3)
        ]

    # rotZ(roll) @ rotX(pitch) @ rotY(yaw), row-vector convention
    rot = matmul(matmul(rot_axis(0, 1, cam.roll), rot_axis(1, 2, cam.pitch)), rot_axis(2, 0, cam.yaw))

    def mulr(v):  # row vector times matrix: out_j = sum_i v_i rot[i][j]
        return [df.add(df.add(df.mul(v[0], rot[0][j]), df.mul(v[1], rot[1][j])), df.mul(v[2], rot[2][j]))
                for j in range(3)]

    ul = mulr([xs, ys, one])
    ur = mulr([df.neg(xs), ys, one])
    dl = mulr([xs, df.neg(ys), one])
    return {"ul": ul, "dx": [df.sub(ur[j], ul[j]) for j in range(3)], "dy": [df.sub(dl[j], ul[j]) for j in range(3)]}


def begin_frame(cam: CameraPacked, aspect: float, compensated: bool = False):
    """Screen corners + basis from camera params (camera.d:77-117).

    The ``*_rel`` corners are pos-FREE: the reference adds camera.pos and
    subtracts it again per ray, which in f32 cancels catastrophically near
    pos.y ~ 1e2 (see chess2rt_tpu/ops/camera.py).  ``compensated=True``
    also attaches the df32 corner pairs under "df" (``_begin_frame_df``);
    ``screen_rays`` then interpolates those and rounds the direction to
    f32 last."""
    dt = cam.pos.dtype
    dev = cam.pos.device

    def const(x):
        return torch.tensor(x, dtype=dt, device=dev)

    rad = const(np.pi / 180.0)
    x = -aspect
    y = 1.0
    len_xy = torch.sqrt(const(x * x + y * y))
    wanted = torch.tan(cam.fov * (rad / 2))
    scaling = wanted / len_xy
    xs = const(x) * scaling
    ys = const(y) * scaling
    one = torch.ones((), dtype=dt, device=dev)

    rot = (
        vec.rotate_z(cam.roll * rad, xp=torch)
        @ vec.rotate_x(cam.pitch * rad, xp=torch)
        @ vec.rotate_y(cam.yaw * rad, xp=torch)
    ).to(dt)

    def mulr(v):  # row-vector times matrix
        return torch.stack(v, dim=-1) @ rot

    ul = mulr([xs, ys, one])
    ur = mulr([-xs, ys, one])
    dl = mulr([xs, -ys, one])
    out = {"df": _begin_frame_df(cam, aspect)} if compensated else {}
    out.update({
        "up_left_rel": ul,
        "up_right_rel": ur,
        "down_left_rel": dl,
        # absolute corners kept for parity consumers (debug dumps)
        "up_left": ul + cam.pos,
        "up_right": ur + cam.pos,
        "down_left": dl + cam.pos,
        # row-vector multiply: e_i @ rot = rot row i (imported_types.d:13-20)
        "right_dir": rot[0],
        "up_dir": rot[1],
        "front_dir": rot[2],
        "pos": cam.pos,
    })
    return out


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def screen_rays(cam: CameraPacked, frame, width: float, height: float, x, y, stereo_offset: float = 0.0,
                dof: bool = False, key=None, disc_uv=None):
    """getScreenRay over a batch of (possibly fractional) pixel coordinates
    (camera.d:119-174): -> (orig, dir), each [..., 3].  The pos-free
    corners are interpolated (see begin_frame), so differentiable in every
    camera leaf the corners depend on.  ``stereo_offset`` in {-1, 0, +1}
    moves the eye along the camera's right axis by the stereo separation.

    ``dof``: the depth-of-field sample (camera.d:154-173): the focal point
    along the pinhole ray, the origin moved on the disc of radius
    ``disc_multiplier`` by two uniforms drawn from ``key`` (``split(key)``,
    one per key, as JAX draws them) or given as ``disc_uv`` = (angle_u,
    rad_u): a lane-compacted caller gathers them from the full-width draw,
    since the draw is positional."""
    fx = (x / width)[..., None]
    fy = (y / height)[..., None]
    if "df" in frame and not dof:
        # the compensated (df32) interpolation: corners, pixel fractions and
        # the normalize carry ~48-bit significands, and dir is rounded to f32
        # last, so each component is correctly rounded
        from . import df32 as dfm

        c = frame["df"]
        fx_d = dfm.div((x, torch.zeros_like(x)), dfm.const(float(width), like=x))
        fy_d = dfm.div((y, torch.zeros_like(y)), dfm.const(float(height), like=y))
        t = [dfm.add(c["ul"][j], dfm.add(dfm.mul(c["dx"][j], fx_d), dfm.mul(c["dy"][j], fy_d))) for j in range(3)]
        n2 = dfm.add(dfm.add(dfm.mul(t[0], t[0]), dfm.mul(t[1], t[1])), dfm.mul(t[2], t[2]))
        ln = dfm.sqrt(n2)
        dir = torch.stack([dfm.to_f32(dfm.div(t[j], ln)) for j in range(3)], dim=-1)
        target_rel = torch.stack([dfm.to_f32(t[j]) for j in range(3)], dim=-1)
    else:
        target_rel = (
            frame["up_left_rel"]
            + (frame["up_right_rel"] - frame["up_left_rel"]) * fx
            + (frame["down_left_rel"] - frame["up_left_rel"]) * fy
        )
        dir = _norm(target_rel)
    stereo_off = frame["right_dir"] * (stereo_offset * cam.stereo_separation) if stereo_offset else 0.0
    if not dof:
        orig = torch.broadcast_to(frame["pos"], target_rel.shape)
        if stereo_offset:
            orig = orig + stereo_off
        return orig, dir

    # focal point and disc origin pos-relative throughout (T_rel = T - pos)
    cos_theta = (dir * frame["front_dir"]).sum(-1)
    M = cam.focal_plane_dist / cos_theta
    T_rel = stereo_off + dir * M[..., None]
    if disc_uv is None:
        k1, k2 = prng.split(key)
        angle_u = prng.uniform(k1, x.shape, x.dtype, device=x.device)
        rad_u = prng.uniform(k2, x.shape, x.dtype, device=x.device)
    else:
        angle_u, rad_u = disc_uv
    angle = angle_u * (2 * math.pi)
    rad = torch.sqrt(rad_u)
    dx = torch.sin(angle) * rad * cam.disc_multiplier
    dy = torch.cos(angle) * rad * cam.disc_multiplier
    orig_off = dx[..., None] * frame["right_dir"] + dy[..., None] * frame["up_dir"] + stereo_off
    orig = frame["pos"] + orig_off
    dir = _norm(T_rel - orig_off)
    return orig, dir


def pixel_rays(cam: CameraPacked, width: int, height: int, lin, aa):
    """The pinhole rays of the flat pixel indices ``lin`` (an integer
    tensor, row-major over the ``width`` x ``height`` frame) moved by the
    sub-pixel offset ``aa`` (two numbers, or a 2-vector): the twin of K1's
    in-kernel ray-gen (``screen_rays``' op order) -> (orig, dir), each
    [..., 3] in the camera's dtype."""
    frame = begin_frame(cam, width / height)
    dt = cam.pos.dtype
    xs = (lin % width).to(dt) + aa[0]
    ys = (lin // width).to(dt) + aa[1]
    return screen_rays(cam, frame, float(width), float(height), xs, ys)
