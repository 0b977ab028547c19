"""Frozen copy of chess2rt_tpu_torch/ops/camera.py at commit d735142 for the
benchmark's plain reference (the df32 compensated ray-gen left out).  It
imports nothing of the program.

Device-side camera: the frame's screen corners and pinhole rays
(camera.d:77-147).

Counterpart of chess2rt_tpu/ops/camera.py: the pinhole rays with the
stereo eye offset and the depth-of-field disc sample (the df32
``compensated_raygen`` opt-in is left out).  The op order
is the JAX package's: the round-0 kernel's camera slot is built from these
corners, and a reordered product moves knife-edge pixels and camera
gradients.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .packed import CameraPacked
from . import vec
from . import prng


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
    if compensated:
        raise NotImplementedError("the reference has no compensated (df32) ray-gen")
    out = {}
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
