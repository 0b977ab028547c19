"""Device-side camera: the frame's screen corners and pinhole rays
(camera.d:77-147).

Counterpart of chess2rt_tpu/ops/camera.py, uncompensated pinhole branch
only (the df32 ``compensated_raygen`` opt-in is ROADMAP.md queue 1 item 10,
DoF and stereo item 7).  The op order is the JAX package's: the round-0
kernel's camera slot is built from these corners, and a reordered product
moves knife-edge pixels and camera gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.packed import CameraPacked
from ..utils import vec


def begin_frame(cam: CameraPacked, aspect: float):
    """Screen corners + basis from camera params (camera.d:77-117).

    The ``*_rel`` corners are pos-FREE: the reference adds camera.pos and
    subtracts it again per ray, which in f32 cancels catastrophically near
    pos.y ~ 1e2 (see chess2rt_tpu/ops/camera.py)."""
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
    return {
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
    }


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def screen_rays(cam: CameraPacked, frame, width: float, height: float, x, y):
    """Pinhole getScreenRay over a batch of (possibly fractional) pixel
    coordinates (camera.d:119-147): -> (orig, dir), each [..., 3].  The
    pos-free corners are interpolated (see begin_frame), so differentiable
    in every camera leaf the corners depend on."""
    fx = (x / width)[..., None]
    fy = (y / height)[..., None]
    target_rel = (
        frame["up_left_rel"]
        + (frame["up_right_rel"] - frame["up_left_rel"]) * fx
        + (frame["down_left_rel"] - frame["up_left_rel"]) * fy
    )
    dir = _norm(target_rel)
    orig = torch.broadcast_to(frame["pos"], target_rel.shape)
    return orig, dir
