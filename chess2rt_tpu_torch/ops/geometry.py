"""Closed-form leaf intersectors for the gradient's backward (geometry.d).

Counterpart of the subset of chess2rt_tpu/ops/geometry.py that the
leaf-pinned re-shade (ops/round0_grad.py) differentiates: per-leaf closed
forms on [N, 3] ray batches, with the JAX package's op order and its
NaN-free dead-lane guards.  ``all_hits_expr``, ``scene_closest`` and the
rest of the XLA wavefront wait for the eager Whitted twin (ROADMAP.md queue
1 item 3).

The guarded derivatives (``_safe_sqrt``, ``_safe_arcsin``,
``_safe_arctan2``) keep the exact forward and clamp the derivative where
it is infinite: a ray grazing a sphere (discriminant 0), hitting its pole
(|y / r| = 1) or its axis (atan2 at the origin) would otherwise send inf
or NaN into every upstream gradient.
"""

from __future__ import annotations

import torch

INF = 1e30


def _norm(v):
    # tiny floor keeps dead-lane zero vectors NaN-free (their results are
    # masked out); real geometry normals/directions are far above it
    return v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-30))


def dot(a, b):
    return (a * b).sum(-1)


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sqrt(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * 0.5 * torch.rsqrt(torch.clamp_min(x, 1e-8))


class _SafeArcsin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.asin(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.rsqrt(torch.clamp_min(1.0 - x * x, 1e-12))


class _SafeArctan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        denom = torch.clamp_min(x * x + y * y, 1e-12)
        return g * x / denom, -g * y / denom


def _safe_sqrt(x):
    """sqrt with its derivative clamped at 0 (geometry.py:126-139)."""
    return _SafeSqrt.apply(x)


def _safe_arcsin(x):
    """arcsin with its derivative clamped at |x| = 1 (geometry.py:78-90)."""
    return _SafeArcsin.apply(x)


def _safe_arctan2(y, x):
    """atan2 with its derivative clamped at the origin (geometry.py:93-104)."""
    return _SafeArctan2.apply(y, x)


def plane_closest(y, limit, orig, dir):
    """Plane candidate: a hit dict with dist = INF on a miss."""
    oy, dy = orig[..., 1], dir[..., 1]
    miss = ((oy > y) & (dy > -1e-9)) | ((oy < y) & (dy < 1e-9))
    # guarded reciprocal: dy == 0 lanes are all misses
    nonzero = dy != 0
    mult = (oy - y) * torch.where(nonzero, -1.0 / torch.where(nonzero, dy, 1.0), 0.0)
    p = orig + dir * mult[..., None]
    ok = ~miss & nonzero & (torch.abs(p[..., 0]) <= limit) & (torch.abs(p[..., 2]) <= limit)
    dist = torch.where(ok, mult, INF)
    n = torch.zeros_like(p)
    n[..., 1] = 1.0
    return {"dist": dist, "p": p, "normal": n, "u": p[..., 0], "v": p[..., 2]}


def _sphere_record(center, r, orig, dir, t):
    """Position, normal and spherical UVs of the hit at ``t``."""
    p = orig + dir * t[..., None]
    rel = p - center
    normal = _norm(rel)
    angle = _safe_arctan2(rel[..., 2], rel[..., 0])
    u = (torch.pi + angle) / (2 * torch.pi)
    v = 1.0 - (torch.pi / 2 + _safe_arcsin(torch.clamp(rel[..., 1] / r, -1.0, 1.0))) / torch.pi
    return {"p": p, "normal": normal, "u": u, "v": v}


def _sphere_roots(center, r, orig, dir):
    """(has, x1, x2): the two quadratic roots, x2 <= x1."""
    H = orig - center
    A = dot(dir, dir)
    B = 2.0 * dot(H, dir)
    C = dot(H, H) - r * r
    Dscr = B * B - 4.0 * A * C
    has = Dscr >= 0
    sq = _safe_sqrt(torch.where(has, Dscr, 0.0))
    x1 = (-B + sq) / (2.0 * A)
    x2 = (-B - sq) / (2.0 * A)
    return has, x1, x2


_CUBE_FACES = (
    # (axis, sign, u_axis, v_axis) in reference processing order
    (1, -1.0, 0, 2),
    (1, 1.0, 0, 2),
    (0, -1.0, 1, 2),
    (0, 1.0, 1, 2),
    (2, -1.0, 0, 1),
    (2, 1.0, 0, 1),
)


def _cube_face_candidates(center, side, orig, dir):
    """Per-face candidate (dist, normal, u, v) for all 6 faces -> [N, 6, ...]."""
    half = side * 0.5
    dists, normals, us, vs = [], [], [], []
    for axis, s, ua, va in _CUBE_FACES:
        d_k = dir[..., axis]
        o_k = orig[..., axis]
        valid = torch.abs(d_k) >= 1e-9
        inv_d = torch.where(valid, -1.0 / torch.where(valid, d_k, 1.0), 0.0)
        mult = (o_k - (center[..., axis] + s * half)) * inv_d
        p = orig + dir * mult[..., None]
        oa, ob = (axis + 1) % 3, (axis + 2) % 3
        inside = (
            (p[..., oa] >= center[..., oa] - half)
            & (p[..., oa] <= center[..., oa] + half)
            & (p[..., ob] >= center[..., ob] - half)
            & (p[..., ob] <= center[..., ob] + half)
        )
        ok = valid & (mult >= 0) & inside & torch.isfinite(mult)
        n = torch.zeros_like(p)
        n[..., axis] = s
        dists.append(torch.where(ok, mult, INF))
        normals.append(n)
        us.append(p[..., ua] - center[..., ua])
        vs.append(p[..., va] - center[..., va])
    return {
        "dist": torch.stack(dists, -1),  # [N, 6]
        "normal": torch.stack(normals, -2),  # [N, 6, 3]
        "u": torch.stack(us, -1),
        "v": torch.stack(vs, -1),
    }
