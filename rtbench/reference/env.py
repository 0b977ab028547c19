"""Frozen copy of chess2rt_tpu_torch/ops/env.py at commit d735142 for the
benchmark's plain reference (unchanged).  It imports nothing of the program.

Environment (miss shader): a cubemap skybox.

Counterpart of chess2rt_tpu/ops/env.py.  The reference Environment returns
black (environment.d:5-15) but is the declared hook for a cubemap skybox;
the extension samples a 6-face cubemap by ray direction with bilinear
filtering, differentiable in the texels.

Face layout (major-axis projection): 0:+X 1:-X 2:+Y 3:-Y 4:+Z 5:-Z, with
per-face (u, v) from the two minor axes over the major magnitude.

Split into quads / plan / sample so the fused path can merge the miss
gather with the deferred bitmap-texel gather into one per-ray row gather
(``ops/flagship.combine_outputs``).  ``sample_cubemap`` is a plain index
gather, whose VJP is the scatter-add.
"""

from __future__ import annotations

import torch


def cubemap_quads(cubemap):
    """[6, S, S, 3] -> flat quad table [6*S*S, 12]: each row holds the 2x2
    bilinear neighbourhood (t00|t10|t01|t11), neighbours clamping at face
    edges (cf. ops/shade._quad_atlas_flat's per-texture wrap)."""
    size = cubemap.shape[1]
    xn = cubemap[:, :, 1:]
    xn = torch.cat([xn, xn[:, :, -1:]], dim=2)
    yn = cubemap[:, 1:]
    yn = torch.cat([yn, yn[:, -1:]], dim=1)
    xyn = yn[:, :, 1:]
    xyn = torch.cat([xyn, xyn[:, :, -1:]], dim=2)
    quads = torch.cat([cubemap, xn, yn, xyn], dim=-1)
    return quads.reshape(6 * size * size, 12)


def cubemap_plan(cubemap, dir):
    """-> (key, p, q): the int32 row index into ``cubemap_quads``' table and
    the bilinear fractions, for dir [..., 3] (need not be normalized)."""
    x, y, z = dir[..., 0], dir[..., 1], dir[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x,
        torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    ).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    sc = torch.where(is_x, torch.where(x > 0, -z, z), torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    s = (sc / ma + 1.0) * 0.5
    t = (tc / ma + 1.0) * 0.5
    size = cubemap.shape[1]
    fx = s * (size - 1)
    fy = t * (size - 1)
    # a zero direction (a dead lane) gives NaN: pin it to texel 0
    x0 = torch.nan_to_num(torch.clamp(torch.floor(fx), 0, size - 1), nan=0.0).to(torch.int32)
    y0 = torch.nan_to_num(torch.clamp(torch.floor(fy), 0, size - 1), nan=0.0).to(torch.int32)
    p = (fx - x0)[..., None]
    q = (fy - y0)[..., None]
    return (face * size + y0) * size + x0, p, q


def sample_cubemap(cubemap, dir):
    """cubemap [6, S, S, 3], dir [..., 3] (need not be normalized) -> [..., 3]."""
    from .shade import bilerp_quad

    key, p, q = cubemap_plan(cubemap, dir)
    return bilerp_quad(cubemap_quads(cubemap)[key.long()], p, q)
