"""Texturing, direct shading and node-table lookups (texture.d, bitmap.d,
shader.d).

Counterpart of chess2rt_tpu/ops/shade.py.  Material and texture parameters
live in node-indexed tables and are picked by the per-ray winning-node id,
so a whole wavefront shades in one pass:

* ``texture_color`` (flat, checker, procedure2, bitmap) and
  ``shade_direct`` (Lambert + Phong, one distance-only shadow scan per
  light for the whole batch) are what the eager Whitted twin
  (render/pipeline.py) shades with;
* bitmap texels are fetched as one 12-float quad row per ray from an
  unpadded flat quad table.  The JAX package gathered that row in XLA,
  outside any Pallas kernel, so here it is plain tensor indexing
  (``quad_gather_flat``).  Its backward is the texel-gradient custom VJP of
  the JAX package, in the mode ``SceneStatic.texel_grad_mode`` names:
  ``"histogram"`` (the default: the cotangent rows sorted by texel key, then
  summed per key by the texel-histogram kernel K2, ops/texel_hist.py),
  ``"sorted"`` (the sorted rows summed by ``index_add_``) or ``"scatter"``
  (``index_add_`` on the unsorted keys); the last two are XLA scatters in
  JAX too.  The fused path defers exactly this gather from K1
  (``bitmap_color``).

``apply_bump`` perturbs hit normals by the winning node's bump map (the
BumpTexture extension).  The JAX package's ``checkpoint_name`` tag on the
shadow bits has no counterpart.
"""

from __future__ import annotations

import torch

from ..models.packed import PHONG, TEX_BITMAP, TEX_CHECKER, TEX_PROC2, ScenePacked, SceneStatic
from . import geometry as G
from .texel_hist import texel_histogram
from ..utils.spans import span


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def dot(a, b):
    return (a * b).sum(-1)


def faceforward(ray, norm):
    """imported_types.d:69-73: +norm towards the viewer, else -norm."""
    return torch.where(dot(ray, norm)[..., None] < 0, norm, -norm)


def shadow_eps(dtype) -> float:
    """Self-intersection offset for shadow and secondary rays: the
    reference's 1e-6 in float64 (shader.d:88); under float32 that offset is
    below one ulp at the scenes' coordinate scale (~1e2), so 1e-3."""
    return 1e-6 if dtype == torch.float64 else 1e-3


def static_select(winc, values, dtype=torch.int32):
    """Per-ray lookup of a STATICALLY-known per-node value via a
    compare-select chain (values are Python constants)."""
    values = list(values)
    if not values:
        return torch.zeros(winc.shape, dtype=dtype, device=winc.device)
    out = torch.full(winc.shape, values[0], dtype=dtype, device=winc.device)
    for i, v in enumerate(values[1:], 1):
        if v != values[0]:
            # a Python scalar keeps ``out``'s dtype and needs no host-to-device copy
            out = torch.where(winc == i, v, out)
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
    if table.shape[0] == 0:
        # an empty scene's tables: every lane missed, so any value is masked
        return torch.zeros(onehot.shape[:-1] + table.shape[1:], dtype=table.dtype, device=table.device)
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


# the texel VJP's modes (``SceneStatic.texel_grad_mode``)
TEXEL_GRAD_MODES = ("histogram", "sorted", "scatter")


class _QuadGather(torch.autograd.Function):
    """``table[key]`` whose backward sums the cotangent rows per key, as
    JAX's ``_qgf_bwd`` in ``mode``:

    * ``"histogram"``: a stable sort of the rows by key (JAX's ``lax.sort``,
      outside the kernel there too), then K2 on the sorted runs.  K2 is f32
      only, as the TPU kernel is; another dtype (the f64 twin's) takes the
      sorted ``index_add_`` in its own dtype, as JAX sends it to its
      dtype-generic sorted scatter;
    * ``"sorted"``: the stable sort, then ``index_add_`` of the sorted rows;
    * ``"scatter"``: ``index_add_`` of the rows at their unsorted keys."""

    @staticmethod
    def forward(ctx, table, key, mode):
        ctx.save_for_backward(key)
        ctx.n_rows, ctx.mode = table.shape[0], mode
        return table[key.long()]

    @staticmethod
    def backward(ctx, g):
        (key,) = ctx.saved_tensors
        with span("c2rt.bwd.texel"):
            kf = key.reshape(-1)
            gf = g.reshape(kf.shape[0], g.shape[-1])
            if ctx.mode != "scatter":
                sk, perm = torch.sort(kf, stable=True)
                kf, gf = sk, gf[perm].contiguous()
                if ctx.mode == "histogram" and g.dtype == torch.float32:
                    return texel_histogram(kf, gf, ctx.n_rows), None, None
            out = torch.zeros((ctx.n_rows, g.shape[-1]), dtype=g.dtype, device=g.device)
            return out.index_add_(0, kf.long(), gf), None, None


def quad_gather_flat(table, key, mode="histogram"):
    """``table[key]`` for a flat [rows, C] quad table (int32 keys); out-of-
    range keys clamp, like the JAX gather.  Differentiable in ``table``
    through the texel VJP of ``mode`` (one of ``TEXEL_GRAD_MODES``, else
    ValueError); plain indexing when no gradient is wanted, which keeps a
    forward frame free of the Function's cost."""
    if mode not in TEXEL_GRAD_MODES:
        raise ValueError(f"texel_grad_mode {mode!r}: one of {TEXEL_GRAD_MODES}")
    key = key.clamp(0, table.shape[0] - 1)
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[key.long()]
    return _QuadGather.apply(table, key, mode)


def bitmap_color(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Bilinear bitmap sample for the winning node's texture: the gather the
    round-0 kernel defers (it emits win, u, v)."""
    quads2d, key, p, q = bitmap_plan(packed, static, winc, u, v, onehot)
    return bilerp_quad(quad_gather_flat(quads2d, key, static.texel_grad_mode), p, q)


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


# --------------------------------------------------------------------------
# Bump mapping (extension; oracle/renderer.modify_normal is the ground truth)
# --------------------------------------------------------------------------


def apply_bump(packed: ScenePacked, static: SceneStatic, winc, hit, onehot=None):
    """Perturb hit normals by the winning node's bump map (the
    renderer.d:370-372 hook, completed by the BumpTexture extension):

        (dx, dy) = bilinear wrap sample of the differentiated map
        normal'  = normalize(normal + (dNdx*dx + dNdy*dy) * strength)

    Nodes without a bump map keep their normal.  The hit records carry
    dndx/dndy (``scene_closest(..., tangents=True)``).  The bump atlas is
    not trainable (detached): the sample is one [rows, 8] quad-row gather
    of the dx/dy channels (differentiate's blue is always 0)."""
    if not static.has_bump:
        return hit["normal"]
    if onehot is None:
        onehot = node_onehot(static, winc)
    dt = packed.bump_atlas.dtype
    b = static_select(winc, [max(n.bump_idx, 0) for n in static.nodes])
    h = static_select(b, [s[0] for s in static.bump_sizes], dt)
    w = static_select(b, [s[1] for s in static.bump_sizes], dt)
    scaling = node_gather(onehot, packed.bump_scaling)
    uu = hit["u"] * scaling
    vv = hit["v"] * scaling
    uu = uu - torch.floor(uu)
    vv = vv - torch.floor(vv)
    tx = uu * w
    ty = vv * h
    ix = torch.minimum(torch.clamp_min(torch.floor(tx), 0), w - 1)
    iy = torch.minimum(torch.clamp_min(torch.floor(ty), 0), h - 1)
    p = (tx - ix)[..., None]
    q = (ty - iy)[..., None]
    quads = _quad_atlas_flat(packed.bump_atlas.detach()[..., :2], static.bump_sizes)  # [R, 8]
    # non-finite u/v on masked lanes: pin them to texel 0, as bitmap_plan does
    ixi = torch.nan_to_num(ix, nan=0.0).to(torch.int32)
    iyi = torch.nan_to_num(iy, nan=0.0).to(torch.int32)
    key = _quad_row_key(static.bump_sizes, b, list(range(len(static.bump_sizes))), ixi, iyi)
    g = quad_gather_flat(quads, key, static.texel_grad_mode)
    d = (
        g[..., 0:2] * (1 - p) * (1 - q)
        + g[..., 2:4] * p * (1 - q)
        + g[..., 4:6] * (1 - p) * q
        + g[..., 6:8] * p * q
    )
    strength = node_gather(onehot, packed.bump_strength)
    dn = (hit["dndx"] * d[..., 0:1] + hit["dndy"] * d[..., 1:2]) * strength[..., None]
    bumped = G._norm(hit["normal"] + dn)  # guarded: dead lanes stay NaN-free
    has = static_select(winc, [1 if n.bump_idx >= 0 else 0 for n in static.nodes]).to(torch.bool)
    return torch.where(has[..., None], bumped, hit["normal"])


# --------------------------------------------------------------------------
# Textures (texture.d:20-162, bitmap.d:48-63)
# --------------------------------------------------------------------------


def texture_color(packed: ScenePacked, static: SceneStatic, winc, u, v, onehot=None):
    """Per-ray diffuse color: the flat material color or the node's
    texture.  ``winc`` is the winning node id clipped to >= 0."""
    if onehot is None:
        onehot = node_onehot(static, winc)
    tk = tex_kind_of(static, winc)
    out = node_gather(onehot, packed.mat_color)
    present = static.tex_kinds_present

    if TEX_CHECKER in present:
        size = node_gather(onehot, packed.checker_size)
        # floor, then cast (u reaches 1e4 on a horizon plane)
        x = torch.floor(u / size).to(torch.int32)
        y = torch.floor(v / size).to(torch.int32)
        # D's signed %2 marks exactly the squares of (x + y) & 1 (texture.d:48-53)
        white = ((x + y) & 1).to(torch.bool)
        checker = torch.where(
            white[..., None],
            node_gather(onehot, packed.checker_c2),
            node_gather(onehot, packed.checker_c1),
        )
        out = torch.where((tk == TEX_CHECKER)[..., None], checker, out)

    if TEX_PROC2 in present:
        # sum_i colorU[i] * sin(u * freqU[i]) + colorV[i] * sin(v * freqV[i])
        # (texture.d:77-85), batched over the 3 bands
        su = torch.sin(u[..., None] * node_gather(onehot, packed.proc2_freq_u))  # [N, 3]
        sv = torch.sin(v[..., None] * node_gather(onehot, packed.proc2_freq_v))
        proc = (node_gather(onehot, packed.proc2_color_u) * su[..., None]).sum(-2) + (
            node_gather(onehot, packed.proc2_color_v) * sv[..., None]
        ).sum(-2)
        out = torch.where((tk == TEX_PROC2)[..., None], proc, out)

    if TEX_BITMAP in present:
        bil = bitmap_color(packed, static, winc, u, v, onehot)
        out = torch.where((tk == TEX_BITMAP)[..., None], bil, out)

    return out


# --------------------------------------------------------------------------
# Direct shading: Lambert + Phong (shader.d:67-105, :197-250)
# --------------------------------------------------------------------------


def shade_direct(packed: ScenePacked, static: SceneStatic, ray_dir, hit, winc, geom_normal=None):
    """Direct light for the whole wavefront in one pass.

    Lambert: diffuse * (ambient + sum over lights of visible *
    lightColor / d^2 * cos); Phong adds the untinted cos^n specular
    (shader.d:246-249), masked to Phong nodes.  ``geom_normal``: the
    pre-bump geometric normal, along which the shadow origin is offset
    when a bump map perturbed ``hit["normal"]`` (bump is a shading-normal
    trick; the oracle and the fused kernel offset along the surface)."""
    onehot = node_onehot(static, winc)
    N = faceforward(ray_dir, hit["normal"])
    diffuse = texture_color(packed, static, winc, hit["u"], hit["v"], onehot)

    has_phong = PHONG in static.shader_kinds_present
    lam = torch.zeros_like(hit["p"])
    spec = torch.zeros_like(hit["p"]) if has_phong else None
    Ng = N if geom_normal is None else faceforward(ray_dir, geom_normal)
    shade_from = hit["p"] + Ng * shadow_eps(ray_dir.dtype)
    if has_phong:
        exponent = node_gather(onehot, packed.mat_exponent)
        strength = node_gather(onehot, packed.mat_strength)

    for li in range(static.n_lights):
        lp = packed.light_pos[li]
        lc = packed.light_color[li] * packed.light_power[li]
        vis = G.test_visibility(packed, static, shade_from, torch.broadcast_to(lp, shade_from.shape))
        # lightColor.intensity() != 0 gate (shader.d:88), kept on the device
        vis = vis & (lc.mean() != 0)
        to_light = lp - hit["p"]
        light_dir = _norm(to_light)
        cos_theta = dot(light_dir, N)
        base = lc / dot(to_light, to_light)[..., None]
        lam = lam + torch.where((vis & (cos_theta > 0))[..., None], base * cos_theta[..., None], 0.0)
        if has_phong:
            # R = reflect(-lightDir, N), normalized (imported_types.d:62-67)
            R = _norm(-light_dir - 2.0 * dot(-light_dir, N)[..., None] * N)
            cos_gamma = dot(R, -ray_dir)
            s = base * torch.pow(torch.clamp_min(cos_gamma, 0.0), exponent)[..., None]
            s = s * strength[..., None]
            spec = spec + torch.where((vis & (cos_gamma > 0))[..., None], s, 0.0)

    out = diffuse * (packed.ambient + lam)
    if has_phong:
        out = out + torch.where((shader_kind_of(static, winc) == PHONG)[..., None], spec, 0.0)
    return out
