"""Deferred bitmap texturing and node-table lookups (texture.d, bitmap.d).

Counterpart of the forward subset of chess2rt_tpu/ops/shade.py that the
flagship combine needs.  Material and texture parameters live in
node-indexed tables and are picked by the per-ray winning-node id; bitmap
texels are fetched as one 12-float quad row per ray from an unpadded flat
quad table.  The JAX package gathered that row in XLA, outside any Pallas
kernel, so here it is plain tensor indexing (``quad_gather_flat``).  Its
backward is the texel-gradient custom VJP of the JAX package's
``histogram`` mode: the cotangent rows sorted by texel key, then summed per
key by the texel-histogram kernel K2 (ops/texel_hist.py).
"""

from __future__ import annotations

import torch

from ..models.packed import ScenePacked, SceneStatic
from .texel_hist import texel_histogram


def static_select(winc, values, dtype=torch.int32):
    """Per-ray lookup of a STATICALLY-known per-node value via a
    compare-select chain (values are Python constants)."""
    values = list(values)
    if not values:
        return torch.zeros(winc.shape, dtype=dtype, device=winc.device)
    out = torch.full(winc.shape, values[0], dtype=dtype, device=winc.device)
    for i, v in enumerate(values[1:], 1):
        if v != values[0]:
            out = torch.where(winc == i, torch.tensor(v, dtype=dtype, device=winc.device), out)
    return out


def shader_kind_of(static: SceneStatic, winc):
    return static_select(winc, [n.shader_kind for n in static.nodes])


def tex_kind_of(static: SceneStatic, winc):
    return static_select(winc, [n.tex_kind for n in static.nodes])


def node_onehot(static: SceneStatic, winc):
    """[N, Nn] one-hot of the winning node id."""
    n_nodes = max(len(static.nodes), 1)
    return (winc[..., None] == torch.arange(n_nodes, device=winc.device)).to(torch.float32)


def node_gather(onehot, table):
    """Per-ray row of a [Nn, ...] node table via one-hot contraction (exact
    for finite tables; float32 matmuls run in full precision, see
    chess2rt_tpu_torch/__init__.py)."""
    flat = table.reshape(table.shape[0], -1)
    out = onehot.to(table.dtype) @ flat
    return out.reshape(onehot.shape[:-1] + table.shape[1:])


def bilerp_quad(g, p, q):
    """Bilinear blend of a gathered [.., 12] quad row (t00|t10|t01|t11)."""
    return (
        g[..., 0:3] * (1 - p) * (1 - q)
        + g[..., 3:6] * p * (1 - q)
        + g[..., 6:9] * (1 - p) * q
        + g[..., 9:12] * p * q
    )


def _quad_row_key(sizes, idx, idx_to_tex, ixi, iyi):
    """Per-ray row key into a ``_quad_atlas_flat`` table:
    ``base[t] + iy*w + ix`` with base the per-texture h*w prefix sums."""
    bases = [0]
    for hh, wwid in sizes:
        bases.append(bases[-1] + hh * wwid)
    base = static_select(idx, [bases[t] for t in idx_to_tex])
    wi = static_select(idx, [sizes[t][1] if sizes else 1 for t in idx_to_tex])
    return base + iyi * wi + ixi


def bitmap_plan(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Bilinear bitmap sample PLAN: -> (quads2d, key, p, q) with quads2d the
    flat quad table [rows, 12], key the per-ray row index and (p, q) the
    bilinear fractions (texture.d:103-162 scaling/wrap + bitmap.d:48-63)."""
    if onehot is None:
        onehot = node_onehot(static, winc)
    dt = packed.bitmap_atlas.dtype
    b = static_select(winc, [max(n.bitmap_idx, 0) for n in static.nodes])
    h = static_select(b, [s[0] for s in static.bitmap_sizes], dt)
    w = static_select(b, [s[1] for s in static.bitmap_sizes], dt)
    scaling = node_gather(onehot, packed.bitmap_scaling)
    uu = u * scaling
    vv = v * scaling
    uu = uu - torch.floor(uu)
    vv = vv - torch.floor(vv)
    tx = uu * w
    ty = vv * h
    ix = torch.minimum(torch.clamp_min(torch.floor(tx), 0), w - 1)
    iy = torch.minimum(torch.clamp_min(torch.floor(ty), 0), h - 1)
    p = (tx - ix)[..., None]
    q = (ty - iy)[..., None]
    # non-finite u/v (missed or non-bitmap lanes, masked by the caller)
    # would make the int cast undefined: pin them to texel 0
    ixi = torch.nan_to_num(ix, nan=0.0).to(torch.int32)
    iyi = torch.nan_to_num(iy, nan=0.0).to(torch.int32)
    atlas = packed.bitmap_atlas
    if not static.train_textures:
        # no texel gradient (and no texel cotangents to pay for) when the
        # atlas is not trained
        atlas = atlas.detach()
    quads2d = _quad_atlas_flat(atlas, static.bitmap_sizes)
    key = _quad_row_key(
        static.bitmap_sizes, winc, [max(n.bitmap_idx, 0) for n in static.nodes], ixi, iyi,
    )
    return quads2d, key, p, q


class _QuadGather(torch.autograd.Function):
    """``table[key]`` whose backward sums the cotangent rows per key: a
    stable sort of the rows by key (JAX's ``lax.sort``, outside the kernel
    there too), then K2 on the sorted runs."""

    @staticmethod
    def forward(ctx, table, key):
        ctx.save_for_backward(key)
        ctx.n_rows = table.shape[0]
        return table[key.long()]

    @staticmethod
    def backward(ctx, g):
        (key,) = ctx.saved_tensors
        if g.dtype != torch.float32:
            raise NotImplementedError(
                "quad_gather_flat: texel gradients of non-f32 tables are not ported yet "
                "(ROADMAP.md queue 1 item 5, the texel-grad f64 path)"
            )
        kf = key.reshape(-1)
        gf = g.reshape(kf.shape[0], g.shape[-1])
        sk, perm = torch.sort(kf, stable=True)
        return texel_histogram(sk, gf[perm].contiguous(), ctx.n_rows), None


def quad_gather_flat(table, key):
    """``table[key]`` for a flat [rows, C] quad table (int32 keys); out-of-
    range keys clamp, like the JAX gather.  Differentiable in ``table``
    through the texel-histogram VJP (plain indexing when no gradient is
    wanted, which keeps a forward frame free of the Function's cost)."""
    key = key.clamp(0, table.shape[0] - 1)
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[key.long()]
    return _QuadGather.apply(table, key)


def bitmap_color(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Bilinear bitmap sample for the winning node's texture: the gather the
    round-0 kernel defers (it emits win, u, v)."""
    quads2d, key, p, q = bitmap_plan(packed, static, winc, u, v, onehot)
    return bilerp_quad(quad_gather_flat(quads2d, key), p, q)


def _quad_atlas_flat(atlas, sizes):
    """[T, Hmax, Wmax, C] padded atlas -> UNPADDED flat quad table
    [sum(h*w), 4C]: per texture, each row holds (t00, t10, t01, t11) of its
    2x2 neighbourhood with wrap-around (bitmap.d:55-56)."""
    C = atlas.shape[-1]
    rows = []
    for t, (h, w) in enumerate(sizes):
        img = atlas[t, :h, :w]
        x1 = torch.roll(img, -1, dims=1)
        y1 = torch.roll(img, -1, dims=0)
        xy1 = torch.roll(x1, -1, dims=0)
        quad = torch.cat([img, x1, y1, xy1], dim=-1)
        rows.append(quad.reshape(h * w, 4 * C))
    if not rows:
        return torch.zeros((0, 4 * C), dtype=atlas.dtype, device=atlas.device)
    return rows[0] if len(rows) == 1 else torch.cat(rows)
