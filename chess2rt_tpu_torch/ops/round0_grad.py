"""The differentiable round-0 call: K1 forward, leaf-pinned re-shade backward.

Counterpart of chess2rt_tpu/ops/pallas_grad.py (``build_diff_round0``, its
screen-tap, ray-input and lin-input forms, both pin modes):

* **forward** = K1 itself.  With grad mode off, or no input requiring a
  gradient, it is the plain call (``round0``, no residual rows), so a
  forward frame does exactly what it did before.  Under differentiation
  the forward runs K1's residual form (``want_hit`` and ``want_vis``): the
  same lanes plus the winning ``t``, the raw normal and one shadow bit per
  light.  A caller's layout with ``want_hit`` (the GI renderer's, without
  the vis rows) gets its own rows back: the hit rows (t, nx, ny, nz, dr,
  dg, db) and the light-sum and u, v rows.
* **backward** = the vector-Jacobian product of a torch re-shade that
  recomputes K1's continuous math with its discrete decisions pinned to the
  kernel's own:
    - the winning node ``win`` and, matched once on stop-gradient values
      against every leaf's closed-form roots, the winning leaf and root or
      face (``compute_leaf_pins``), so the recompute is one closed form per
      leaf (``leaf_pinned_record``): no CSG walk, no sort network;
    - the shadow bits, so no shadow scan runs (their derivative is zero).
  ``pin_mode="node"`` (the JAX package's earlier backward, kept for A/B
  tests) pins ``win`` and the shadow bits only: its forward runs K1's
  residual form with the vis rows alone, and its backward re-scans every
  node's full intersection (``_pinned_record``: ``geometry.node_closest``
  per node, selected by the pinned ``win``).  Both differentiate the same
  winning closed form.
  Camera cotangents flow through the ray-gen twin (``camera.pixel_rays``
  over the frame or the lin-input form's pixel slice); the
  ray-input form also returns cotangents for ``orig`` and ``dir``, so the
  bounce chain is differentiated.

``diff_round0`` is the entry point; its autograd Function takes the
ScenePacked leaves in models/packed.LEAF_NAMES order.  Bump scenes take
the bump hybrid (ops/bump_round0.py) instead, which reuses this module's
re-shade with ``bump=True``: tangent-carrying leaf-pinned records
(``leaf_pinned_record(..., tangents=True)``) and the bump perturbation
before the lighting sums.

Discrete-pin caveat (as in the JAX package): on knife-edge lanes where the
kernel's float decisions and the recompute's would differ, the gradient
follows the kernel's decision.
"""

from __future__ import annotations

import torch

from ..models.packed import (
    LAMBERT,
    PHONG,
    REFLECTION,
    REFRACTION,
    TEX_BITMAP,
    TEX_CHECKER,
    TEX_PROC2,
    ScenePacked,
    SceneStatic,
    from_leaves,
    leaf_table,
    leaves,
)
from . import geometry as G
from . import shade as S
from .camera import pixel_rays
from .round0 import EPS_SHADOW, INF, Round0Layout, _rsqrt, layout, round0
from ..utils.spans import span

_norm = G._norm
dot = G.dot

# --------------------------------------------------------------------------
# The re-shade with pinned discrete structure
# --------------------------------------------------------------------------


def _node_space(packed, static, i, orig, dir):
    """Node-i canonic-space rays (the node.d:51-67 round trip): returns
    (orig_l, dir_l, inv_dl, m_inv); inv_dl/m_inv are None for
    identity/offset-only nodes (no dist rescale, no normal transform)."""
    ns = static.nodes[i]
    if ns.identity_transform:
        return orig, dir, None, None
    offset = packed.node_offset[i]
    if ns.offset_only:
        return orig - offset, dir, None, None
    m_inv = torch.linalg.inv_ex(packed.node_matrix[i])[0]
    co = (orig - offset) @ m_inv
    cd = dir @ m_inv
    dlen = torch.sqrt(torch.clamp_min(dot(cd, cd), 1e-30))
    return co, cd / dlen[..., None], 1.0 / dlen, m_inv


def _leaf_candidates(packed, kind, k, o_l, d_l):
    """Closed-form candidate distances of one leaf in LOCAL units, INF-masked
    like the intersectors; one (dist, sel) pair per solution branch (plane:
    1; sphere: the two roots; cube: the six faces)."""
    if kind == "plane":
        rec = G.plane_closest(packed.plane_y[k], packed.plane_limit[k], o_l, d_l)
        return [(rec["dist"], 0)]
    if kind == "sphere":
        has, x1, x2 = G._sphere_roots(packed.sphere_center[k], packed.sphere_r[k], o_l, d_l)
        return [
            (torch.where(has & (x2 >= 0), x2, INF), 0),
            (torch.where(has & (x1 >= 0), x1, INF), 1),
        ]
    faces = G._cube_face_candidates(packed.cube_center[k], packed.cube_side[k], o_l, d_l)
    return [(faces["dist"][..., fi], fi) for fi in range(6)]


def compute_leaf_pins(packed, static, orig, dir, win, t_pin):
    """(gleaf, sel) int32 pins: which global leaf (models/packed.leaf_table
    numbering) and which of its solution branches produced the kernel's
    winning hit, by nearest-|t| matching against the saved winning distance.
    Forward-only compare-selects: callers run it under torch.no_grad()."""
    lvs, _ = leaf_table(static)
    best = torch.full(win.shape, INF, dtype=t_pin.dtype, device=win.device)
    gleaf = torch.zeros(win.shape, dtype=torch.int32, device=win.device)
    sel = torch.zeros(win.shape, dtype=torch.int32, device=win.device)
    space = {}
    for g, (i, kind, k) in enumerate(lvs):
        if i not in space:
            space[i] = _node_space(packed, static, i, orig, dir)
        o_l, d_l, inv_dl, _ = space[i]
        for t_loc, s in _leaf_candidates(packed, kind, k, o_l, d_l):
            t_w = t_loc if inv_dl is None else torch.where(t_loc >= INF, INF, t_loc * inv_dl)
            err = torch.where(win == i, torch.abs(t_w - t_pin), INF)
            better = err < best
            best = torch.where(better, err, best)
            gleaf = torch.where(better, g, gleaf)
            sel = torch.where(better, s, sel)
    return gleaf, sel


def _tangent_row(packed, static, i, local3):
    """World-space tangent of a constant local tangent ``local3`` of node
    ``i``: ``_norm(local3 @ m_fwd)`` on a [3] vector (node.d:45-46); the
    local constant itself for identity and offset-only nodes."""
    ns = static.nodes[i]
    v = torch.tensor(local3, dtype=packed.node_offset.dtype, device=packed.node_offset.device)
    if ns.identity_transform or ns.offset_only:
        return v
    w = v @ packed.node_matrix[i]
    return w * torch.rsqrt(torch.clamp_min((w * w).sum(), 1e-30))


def leaf_pinned_record(packed, static, orig, dir, gleaf, sel, n_pin, tangents=False):
    """Differentiable winning-hit record (dist, normal, u, v) rebuilt from
    the pinned (leaf, solution) ids: one primitive's closed form per ray,
    selected across the static leaf list.  The CsgDiff eaten-surface normal
    flip (geometry.d:377-397) is recovered by sign-matching against the
    kernel's saved raw normal ``n_pin`` (on stop-gradient values).

    ``tangents`` adds the dNdx/dNdy frame of the bump extension, per pinned
    leaf a closed form too: plane and cube take node constants (the cube
    keeps the projected-space literals, dNdy = (0, 0, face sign),
    geometry.d:227-228), the sphere its azimuth frame (geometry.d:110-122),
    all through the forward matrix (node.d:45-46).  The CsgDiff flip turns
    the normal only, never the tangents, as in ``all_hits_expr``."""
    lvs, _ = leaf_table(static)
    rec = None
    space = {}
    keys = ("dist", "normal", "u", "v") + (("dndx", "dndy") if tangents else ())
    for g, (i, kind, k) in enumerate(lvs):
        if i not in space:
            space[i] = _node_space(packed, static, i, orig, dir)
        o_l, d_l, inv_dl, m_inv = space[i]
        if kind == "plane":
            cand = G.plane_closest(packed.plane_y[k], packed.plane_limit[k], o_l, d_l)
            if tangents:
                cand["dndx"] = _tangent_row(packed, static, i, (1.0, 0.0, 0.0)).expand(o_l.shape)
                cand["dndy"] = _tangent_row(packed, static, i, (0.0, 0.0, 1.0)).expand(o_l.shape)
        elif kind == "sphere":
            c, r = packed.sphere_center[k], packed.sphere_r[k]
            has, x1, x2 = G._sphere_roots(c, r, o_l, d_l)
            t = torch.where(sel == 1, x1, x2)
            ok = has & (t >= 0)
            cand = G._sphere_record(c, r, o_l, d_l, torch.where(ok, t, 0.0), tangents)
            cand["dist"] = torch.where(ok, t, INF)
        else:  # cube: the pinned face
            faces = G._cube_face_candidates(packed.cube_center[k], packed.cube_side[k], o_l, d_l)
            cand = {
                "dist": faces["dist"][..., 0],
                "normal": faces["normal"][..., 0, :],
                "u": faces["u"][..., 0],
                "v": faces["v"][..., 0],
            }
            for fi in range(1, 6):
                m = sel == fi
                cand = {
                    "dist": torch.where(m, faces["dist"][..., fi], cand["dist"]),
                    "normal": torch.where(m[..., None], faces["normal"][..., fi, :], cand["normal"]),
                    "u": torch.where(m, faces["u"][..., fi], cand["u"]),
                    "v": torch.where(m, faces["v"][..., fi], cand["v"]),
                }
            if tangents:
                # the face sign by the pinned face id, multiplied after the
                # normalize (a sign commutes with it)
                s = torch.full(sel.shape, G._CUBE_FACES[0][1], dtype=o_l.dtype, device=o_l.device)
                for fi in range(1, 6):
                    s = torch.where(sel == fi, G._CUBE_FACES[fi][1], s)
                cand["dndx"] = _tangent_row(packed, static, i, (1.0, 0.0, 0.0)).expand(o_l.shape)
                cand["dndy"] = s[..., None] * _tangent_row(packed, static, i, (0.0, 0.0, 1.0))
        if inv_dl is not None:
            miss = cand["dist"] >= INF
            cand["dist"] = torch.where(miss, INF, cand["dist"] * inv_dl)
            cand["normal"] = _norm(cand["normal"] @ m_inv.T)
            if tangents and kind == "sphere":
                # per-lane sphere frames through the forward matrix; plane
                # and cube frames are the node constants above
                m_fwd = packed.node_matrix[i]
                cand["dndx"] = _norm(cand["dndx"] @ m_fwd)
                cand["dndy"] = _norm(cand["dndy"] @ m_fwd)
        m = gleaf == g
        if rec is None:
            rec = {key: cand[key] for key in keys}
        else:
            rec = {
                key: torch.where(m if cand[key].dim() == m.dim() else m[..., None], cand[key], rec[key])
                for key in keys
            }
    flip = torch.where(dot(n_pin, rec["normal"].detach()) < 0, -1.0, 1.0)
    rec["normal"] = rec["normal"] * flip[..., None]
    return rec


def _pinned_record(packed, static, orig, dir, win, tangents=False):
    """The winning node's hit record selected by the pinned ``win`` (the
    node-mode backward): every node's full closest-hit recompute
    (``geometry.node_closest``, CSG walk included), the node ``win`` names
    taken per lane.  The select is piecewise constant, like the zero
    gradient of the scan's argmin.  ``tangents`` carries the dNdx/dNdy
    frames of the bump extension."""
    keys = ("dist", "normal", "u", "v") + (("dndx", "dndy") if tangents else ())
    rec = None
    for i, ns in enumerate(static.nodes):
        cand = G.node_closest(packed, ns, i, orig, dir, tangents=tangents)
        if rec is None:
            rec = {k: cand[k] for k in keys}
            continue
        m = win == i
        rec = {k: torch.where(m if cand[k].dim() == m.dim() else m[..., None], cand[k], rec[k]) for k in keys}
    return rec


def _diffuse_nobitmap(packed, static, winc, u, v, onehot):
    """texture_color minus the bitmap branch: K1 defers bitmap texels to the
    combine step and emits dr = 0 for bitmap nodes, so the re-shade does
    the same."""
    tk = S.tex_kind_of(static, winc)
    out = S.node_gather(onehot, packed.mat_color)
    present = static.tex_kinds_present

    if TEX_CHECKER in present:
        size = S.node_gather(onehot, packed.checker_size)
        x = torch.floor(u / size).to(torch.int32)
        y = torch.floor(v / size).to(torch.int32)
        white = ((x + y) & 1).to(torch.bool)
        checker = torch.where(
            white[..., None],
            S.node_gather(onehot, packed.checker_c2),
            S.node_gather(onehot, packed.checker_c1),
        )
        out = torch.where((tk == TEX_CHECKER)[..., None], checker, out)

    if TEX_PROC2 in present:
        su = torch.sin(u[..., None] * S.node_gather(onehot, packed.proc2_freq_u))
        sv = torch.sin(v[..., None] * S.node_gather(onehot, packed.proc2_freq_v))
        proc = (S.node_gather(onehot, packed.proc2_color_u) * su[..., None]).sum(-2) + (
            S.node_gather(onehot, packed.proc2_color_v) * sv[..., None]
        ).sum(-2)
        out = torch.where((tk == TEX_PROC2)[..., None], proc, out)

    if TEX_BITMAP in present:
        out = torch.where((tk == TEX_BITMAP)[..., None], 0.0, out)
    return out


def reshade(packed: ScenePacked, static: SceneStatic, orig, dir, win, vis_list, rec_pins, want_hit=False,
            bump=False):
    """Differentiable torch recompute of K1's float outputs given the pinned
    (win, vis) and leaf pins ``rec_pins`` = (gleaf, sel, n_pin), or None for
    the node-mode full re-scan (``_pinned_record``): the same keys as the
    layout (plain, or ``want_hit``), minus ``win`` and the vis rows.
    ``vis_list`` holds one bool [N] mask per light.  ``bump``: the record
    carries tangents and the winning normal is bump-perturbed before the
    lighting (the bump hybrid's shading, ops/bump_round0.py)."""
    if rec_pins is None:
        rec = _pinned_record(packed, static, orig, dir, win, tangents=bump)
    else:
        rec = leaf_pinned_record(packed, static, orig, dir, *rec_pins, tangents=bump)
    return _shade_pinned(packed, static, orig, dir, win, vis_list, rec, want_hit, bump)


def _shade_pinned(packed, static, orig, dir, win, vis_list, rec, want_hit=False, bump=False, diffuse=None):
    """The shading half of ``reshade``: direct light, continuation and the
    output rows for a given winning-hit record, in K1's op order.
    ``want_hit`` adds the light-sum, u, v and hit rows of K1's want_hit
    form (pallas_grad._shade_pinned's).  ``bump`` perturbs the raw normal
    by ``shade.apply_bump`` before faceforward, the lighting sums and the
    continuation (the hook order of render/pipeline._whitted_round);
    ``diffuse`` overrides the ``_diffuse_nobitmap`` recompute (the bump fast
    forward passes K1's own dr, dg, db rows)."""
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    emit_L = has_bitmap or want_hit
    has_refr = REFRACTION in static.shader_kinds_present
    has_cont = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    has_phong = PHONG in static.shader_kinds_present

    hitmask = win >= 0
    winc = torch.clamp_min(win, 0)
    onehot = S.node_onehot(static, winc)
    if bump:
        rec = dict(rec, normal=S.apply_bump(packed, static, winc, rec, onehot))

    # world hit point from the winning t.  Dead lanes, and knife-edge lanes
    # where the kernel hit what the recompute just misses (dist == INF), are
    # clamped to t = 0: the forward masks them out either way, but an INF
    # here would send NaN cotangents through the untaken where-branches
    t_ok = hitmask & (rec["dist"] < INF)
    ts = torch.where(t_ok, rec["dist"], 0.0)
    hp = orig + dir * ts[..., None]

    # faceforward (imported_types.d:69-73), kernel-style sign select
    ndotd = dot(dir, rec["normal"])
    sgn = torch.where(ndotd < 0, 1.0, -1.0)
    N = rec["normal"] * sgn[..., None]
    sfrom = hp + N * EPS_SHADOW

    if diffuse is None:
        diffuse = _diffuse_nobitmap(packed, static, winc, rec["u"], rec["v"], onehot)

    # direct light; the shadow scans are replaced by the pinned bits
    L = torch.broadcast_to(packed.ambient, hp.shape)
    spec = torch.zeros_like(hp) if has_phong else None
    if has_phong:
        exponent = S.node_gather(onehot, packed.mat_exponent)
        strength = S.node_gather(onehot, packed.mat_strength)
    for li in range(static.n_lights):
        lc = packed.light_color[li] * packed.light_power[li]
        vis = vis_list[li]
        to_l = packed.light_pos[li] - hp
        dist2 = dot(to_l, to_l)
        ldir = to_l * _rsqrt(dist2)[..., None]
        cos_t = dot(ldir, N)
        w = torch.where(vis & (cos_t > 0), cos_t / dist2, 0.0)
        L = L + lc * w[..., None]
        if has_phong:
            # R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249).
            # torch's pow derivative in the exponent is 0 where the base is
            # 0 (not 0 * log 0), so the masked lanes stay finite
            mdotn = dot(-ldir, N)
            R = -ldir - 2.0 * mdotn[..., None] * N
            R = R * _rsqrt(dot(R, R))[..., None]
            cos_g = dot(R, -dir)
            sw = torch.where(
                vis & (cos_g > 0),
                torch.pow(torch.clamp_min(cos_g, 0.0), exponent) * strength / dist2,
                0.0,
            )
            spec = spec + lc * sw[..., None]

    color = diffuse * L
    if has_phong:
        is_phong = S.shader_kind_of(static, winc) == PHONG
        color = color + torch.where(is_phong[..., None], spec, 0.0)

    is_direct = S.static_select(winc, [int(ns.shader_kind in (LAMBERT, PHONG)) for ns in static.nodes])
    shaded = hitmask & is_direct.to(torch.bool)

    out = {
        "r": torch.where(shaded, color[..., 0], 0.0),
        "g": torch.where(shaded, color[..., 1], 0.0),
        "b": torch.where(shaded, color[..., 2], 0.0),
    }
    if emit_L:
        out["lr"] = torch.where(shaded, L[..., 0], 0.0)
        out["lg"] = torch.where(shaded, L[..., 1], 0.0)
        out["lb"] = torch.where(shaded, L[..., 2], 0.0)
        out["u"] = rec["u"]
        out["v"] = rec["v"]

    if has_cont:
        # mirror continuation + single-sided refraction with TIR fallback
        ddn = dot(dir, N)
        rd = dir - 2.0 * ddn[..., None] * N
        rd = rd * _rsqrt(dot(rd, rd))[..., None]
        ro = sfrom
        if has_refr:
            rn = rec["normal"]
            ior = S.node_gather(onehot, packed.mat_ior)
            is_refr = S.shader_kind_of(static, winc) == REFRACTION
            cos_in = -dot(dir, rn)
            entering = cos_in > 0
            eta = torch.where(entering, 1.0 / ior, ior)
            nf = rn * torch.where(entering, 1.0, -1.0)[..., None]
            ci = torch.abs(cos_in)
            kk = 1.0 - eta * eta * (1.0 - ci * ci)
            tir = kk < 0
            # the TIR boundary (kk = 0): sqrt's derivative is infinite there
            coef = eta * ci - G._safe_sqrt(torch.clamp_min(kk, 0.0))
            f = eta[..., None] * dir + coef[..., None] * nf
            f = f * _rsqrt(dot(f, f))[..., None]
            rfd = torch.where(tir[..., None], rd, f)
            rfo = torch.where(tir[..., None], hp + nf * EPS_SHADOW, hp - nf * EPS_SHADOW)
            rd = torch.where(is_refr[..., None], rfd, rd)
            ro = torch.where(is_refr[..., None], rfo, ro)
        out["rox"], out["roy"], out["roz"] = ro.unbind(-1)
        out["rdx"], out["rdy"], out["rdz"] = rd.unbind(-1)
    if want_hit:
        out["t"] = torch.where(t_ok, rec["dist"], INF)
        out["nx"], out["ny"], out["nz"] = rec["normal"].unbind(-1)
        out["dr"], out["dg"], out["db"] = diffuse.unbind(-1)
    return out


# --------------------------------------------------------------------------
# The autograd Function
# --------------------------------------------------------------------------


def kernel_pins(o, n_lights: int):
    """(win, vis_list, t_pin, n_pin) from K1's residual rows: the winner,
    one bool [N] shadow bit per light, the winning t and raw normal (None
    without the hit rows: node mode)."""
    vis = [o[f"vis{li}"] > 0.5 for li in range(n_lights)]
    if "t" not in o:
        return o["win"], vis, None, None
    return o["win"], vis, o["t"], torch.stack([o["nx"], o["ny"], o["nz"]], dim=-1)


def form_rays(packed, lay: Round0Layout, prm, form, tensors):
    """The rays a round-0 call of ``form`` traced: the caller's (ray-input
    form, the first two of ``tensors``) or the ray-gen twin's at ``prm``'s
    aa offset (screen-tap form: the frame; lin-input form: its slice),
    differentiable in ``packed``'s camera."""
    if form == "rays":
        return tensors[0], tensors[1]
    a0 = lay.off["aa"]
    base, n = form or (0, lay.width * lay.height)
    lin = int(base) + torch.arange(n, device=packed.device)
    return pixel_rays(packed.camera, lay.width, lay.height, lin, prm[a0:a0 + 2])


class _DiffRound0(torch.autograd.Function):
    """Inputs: (residual layout, primal row names, trace, prm, form,
    primal, leaf_pins, [orig, dir,] *leaves in LEAF_NAMES order), with
    ``form`` None for the screen-tap form, "rays" for the ray-input form, or
    (lin_base, n_lanes) for the lin-input form.  ``primal`` None returns
    K1's rows; the bump fast forward passes ``primal(packed, orig, dir,
    o)``, its shading of K1's record, and the backward then re-shades with
    bump.  ``leaf_pins`` False is node mode (``lay_r`` then needs no hit
    rows).  Outputs: the primal rows in ``names`` order, then ``win``."""

    @staticmethod
    def forward(ctx, lay_r: Round0Layout, names, trace, prm, form, primal, leaf_pins, *tensors):
        ray_input = form == "rays"
        rays = tensors[:2] if ray_input else ()
        lin = {} if form is None or ray_input else {"lin_input": True, "n_lanes": form[1]}
        o = trace(lay_r, prm, *rays, **lin)
        win, vis, t_pin, n_pin = kernel_pins(o, lay_r.static.n_lights)
        if primal is not None:
            packed = from_leaves(tensors[2 if ray_input else 0:])
            o = primal(packed, *form_rays(packed, lay_r, prm, form, tensors), o)
        ctx.lay, ctx.names, ctx.ray_input, ctx.form, ctx.bump = lay_r, names, ray_input, form, primal is not None
        ctx.leaf_pins = leaf_pins
        ctx.save_for_backward(prm, win, torch.stack(vis), t_pin, n_pin, *tensors)
        ctx.mark_non_differentiable(win)
        ctx.set_materialize_grads(False)
        return tuple(o[k] for k in names) + (win,)

    @staticmethod
    def backward(ctx, *grads):
        prm, win, vis, t_pin, n_pin, *tensors = ctx.saved_tensors
        lay, static = ctx.lay, ctx.lay.static
        need = ctx.needs_input_grad[7:]
        pairs = [(k, g) for k, g in zip(ctx.names, grads[:-1]) if g is not None]
        result = [None] * len(tensors)
        if not pairs or not any(need):
            return (None,) * 7 + tuple(result)
        with span("c2rt.bwd.k1"), torch.enable_grad():
            xs = [t.detach().requires_grad_(nd) for t, nd in zip(tensors, need)]
            packed = from_leaves(xs[2 if ctx.ray_input else 0:])
            orig, dir = form_rays(packed, lay, prm, ctx.form, xs)
            rec_pins = None
            if ctx.leaf_pins:
                with span("c2rt.bwd.pins"), torch.no_grad():
                    rec_pins = (*compute_leaf_pins(packed, static, orig, dir, win, t_pin), n_pin)
            # the caller's layout had the hit rows when its names hold "t"
            with span("c2rt.bwd.reshade"):
                out = reshade(packed, static, orig, dir, win, list(vis.unbind(0)), rec_pins,
                              want_hit="t" in ctx.names, bump=ctx.bump)
            pairs = [(out[k], g) for k, g in pairs if out[k].requires_grad]
            wanted = [i for i, x in enumerate(xs) if x.requires_grad]
            if pairs:
                with span("c2rt.bwd.vjp"):
                    got = torch.autograd.grad(
                        [o for o, _ in pairs], [xs[i] for i in wanted], [g for _, g in pairs], allow_unused=True
                    )
                for i, g in zip(wanted, got):
                    result[i] = g
        return (None,) * 7 + tuple(result)


def diff_round0(lay: Round0Layout, prm, packed: ScenePacked, orig=None, dir=None, *, trace=round0,
                pin_mode: str = "leaf", lin_input: bool = False, n_lanes=None, lin_base: int = 0):
    """The differentiable round-0 call: ``trace(lay, prm[, orig, dir])``
    (K1 through ``round0``, or its plain version ``round0_reference``) with
    gradients to every ScenePacked leaf and, in the ray-input form, to
    ``orig`` and ``dir``.  ``prm`` must be ``lay.pack(packed, aa)``: the
    forward reads the scene from it, the backward from ``packed``.

    ``lin_input`` is the lin-input form, ``trace(lay, prm, lin_input=True,
    n_lanes=n_lanes)`` with ``prm = lay.pack(packed, aa, lin_base)``: the
    backward's ray-gen twin needs the same ``lin_base`` as an integer (the
    forward reads it from ``prm``), so the caller passes it here too.

    ``pin_mode`` "leaf" (the default) or "node" (see the module docstring);
    a scene without leaves takes node mode either way, as in JAX.
    Returns the dict ``trace`` returns for ``lay``."""
    static = lay.static
    if pin_mode not in ("leaf", "node"):
        raise ValueError(f'diff_round0: pin_mode is "leaf" or "node", not {pin_mode!r}')
    if lin_input and (orig is not None or n_lanes is None):
        raise ValueError("diff_round0: the lin-input form takes n_lanes and no rays")
    # bump scenes take the bump hybrid (ops/bump_round0.py, dispatched by
    # ops/flagship.round0_call); only want_hit callers (GI, which ignores
    # bump) come here with one
    assert lay.want_hit or not static.has_bump, "diff_round0: a bump scene's call belongs to bump_round0"
    rays = () if orig is None else (orig, dir)
    tensors = (*rays, *leaves(packed))
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return trace(lay, prm, *rays, **({"lin_input": True, "n_lanes": n_lanes} if lin_input else {}))
    leaf_pins = pin_mode == "leaf" and len(leaf_table(static)[0]) > 0
    lay_r = layout(static, lay.width, lay.height, want_hit=lay.want_hit or leaf_pins, want_vis=True)
    form = "rays" if rays else ((int(lin_base), int(n_lanes)) if lin_input else None)
    outs = _DiffRound0.apply(lay_r, lay.names, trace, prm.detach(), form, None, leaf_pins, *tensors)
    res = dict(zip(lay.names, outs[:-1]))
    res["win"] = outs[-1]
    return res
