"""The bump hybrid round 0: K1 pins the discrete structure, torch bumps.

Counterpart of chess2rt_tpu/ops/pallas_grad.py:698-1018
(``reconstruct_tangents``, ``_fast_bump_ok``, ``build_bump_round0`` and the
``build_trace_round0`` dispatch, here ``ops/flagship.round0_call``).  A bump
scene's every round-0 call of the Whitted path, forward frame or gradient,
screen-tap, ray-input or lin-input form, comes here:

* K1 runs in its residual form (``want_hit`` + ``want_vis``): the winner,
  the winning t, raw normal, u, v and diffuse rows, one shadow bit per
  light; closest hit and shadow scans stay in the kernel.
* torch applies the BumpTexture perturbation to the winning normal before
  the lighting sums (the renderer.d:370-372 hook order) and assembles the
  caller's rows (``round0_grad._shade_pinned``).  The bump is not in K1
  because the perturbed normal feeds the in-kernel lighting sums: the
  deferred-texel trick of the bitmaps cannot compose with it.

Two engines, as in JAX:

* **fast forward** (``_fast_bump_ok``: every bump-mapped node is a single
  primitive): the record comes straight from K1's rows, the tangents
  reconstructed from the raw normal (``reconstruct_tangents``), so only
  bump, lighting and assembly run in torch.  Under a gradient it is an
  autograd Function whose backward re-derives the differentiable re-shade
  at the pinned structure (``round0_grad._DiffRound0`` with a primal);
* **reshade forward** (a bump-mapped CSG node, whose CsgDiff flip makes the
  frame unrecoverable from the normal alone): the differentiable re-shade
  with tangent-carrying leaf-pinned records is the forward, K1 running on
  detached inputs for the pins only.

``calls`` counts the hybrid's calls (each one K1 launch in the residual
form on the card); callers zero and read it.
"""

from __future__ import annotations

import torch

from ..models.packed import ScenePacked, SceneStatic, leaves
from .round0 import Round0Layout, layout, round0
from .round0_grad import _DiffRound0, _norm, _shade_pinned, _tangent_row, compute_leaf_pins, form_rays, kernel_pins, reshade

# bump-hybrid round-0 calls made; callers zero and read it
calls = 0


def reconstruct_tangents(packed: ScenePacked, static: SceneStatic, winc, n_raw):
    """dNdx/dNdy of the winning hit from K1's raw world normal alone, by
    per-node closed forms and no re-intersection.  Valid for bump-mapped
    nodes that are single primitives (``_fast_bump_ok``): their normals
    never carry the CsgDiff flip, so the local normal (recovered through
    the forward matrix) fixes the frame:

    * plane: the (1,0,0) / (0,0,1) constants (geometry.d:47-53);
    * cube: dNdx = (1,0,0); dNdy = (0,0,s), s the sign of the winning face,
      taken from the local normal's dominant component (geometry.d:227-228);
    * sphere: the azimuth frame of the local normal (geometry.d:110-122).

    The JAX package takes the cube's sign as ``sign(n_l.sum(-1))``: on a hit
    lane the other two components are ~0 and both agree, but the sum is
    fragile on a lane whose normal is not axis-aligned (a dead or masked
    lane); the dominant component's sign is the face's by construction.
    Nodes without a bump map contribute zeros (``apply_bump`` keeps their
    normals).  NaN-free on every lane."""
    dndx = torch.zeros_like(n_raw)
    dndy = torch.zeros_like(n_raw)
    for i, ns in enumerate(static.nodes):
        if ns.bump_idx < 0 or ns.geom[0] == "csg":
            continue
        kind = ns.geom[0]
        full_tr = not (ns.identity_transform or ns.offset_only)
        if full_tr:
            m_fwd = packed.node_matrix[i]
            n_l = _norm(n_raw @ m_fwd.T)  # inverts n_w = _norm(n_l @ m_inv.T)
        else:
            n_l = n_raw
        if kind == "plane":
            cx = _tangent_row(packed, static, i, (1.0, 0.0, 0.0)).expand(n_raw.shape)
            cy = _tangent_row(packed, static, i, (0.0, 0.0, 1.0)).expand(n_raw.shape)
        elif kind == "cube":
            dominant = torch.gather(n_l, -1, torch.abs(n_l).argmax(-1, keepdim=True))[..., 0]
            s = torch.where(dominant < 0, -1.0, 1.0).to(n_raw.dtype)
            cx = _tangent_row(packed, static, i, (1.0, 0.0, 0.0)).expand(n_raw.shape)
            cy = s[..., None] * _tangent_row(packed, static, i, (0.0, 0.0, 1.0))
        else:  # sphere: _sphere_record's tangent block on the local normal
            angle = torch.atan2(n_l[..., 2], n_l[..., 0])
            cx = torch.stack(
                [torch.cos(angle + torch.pi / 2), torch.zeros_like(angle), torch.sin(angle + torch.pi / 2)], dim=-1
            )
            cy = torch.linalg.cross(cx, n_l, dim=-1)
            if full_tr:
                cx = _norm(cx @ m_fwd)
                cy = _norm(cy @ m_fwd)
        mask = (winc == i)[..., None]
        dndx = torch.where(mask, cx, dndx)
        dndy = torch.where(mask, cy, dndy)
    return dndx, dndy


def _fast_bump_ok(static: SceneStatic) -> bool:
    """True when every bump-mapped node is a single primitive, the
    ``reconstruct_tangents`` precondition."""
    return all(ns.geom[0] != "csg" for ns in static.nodes if ns.bump_idx >= 0)


def _fast_out(static: SceneStatic):
    """The fast forward's primal ``fn(packed, orig, dir, o)``: K1's record
    (t, raw normal, u, v, diffuse) with reconstructed tangents, bumped and
    shaded by ``_shade_pinned`` -> the rows of a plain layout plus ``win``."""

    def fn(packed, orig, dir, o):
        win, vis, t_pin, n_pin = kernel_pins(o, static.n_lights)
        rec = {"dist": t_pin, "normal": n_pin, "u": o["u"], "v": o["v"]}
        rec["dndx"], rec["dndy"] = reconstruct_tangents(packed, static, torch.clamp_min(win, 0), n_pin)
        diffuse = torch.stack([o["dr"], o["dg"], o["db"]], dim=-1)
        out = _shade_pinned(packed, static, orig, dir, win, vis, rec, bump=True, diffuse=diffuse)
        out["win"] = win
        return out

    return fn


def bump_round0(lay: Round0Layout, prm, packed: ScenePacked, orig=None, dir=None, *, trace=round0,
                lin_input: bool = False, n_lanes=None, lin_base: int = 0):
    """The bump hybrid's round-0 call, with ``round0_grad.diff_round0``'s
    call shape: screen-tap (no rays), ray-input (``orig``, ``dir``) or
    lin-input form (``lin_input``, ``n_lanes``, ``lin_base``; ``prm`` packed
    at that base).  ``trace`` is K1's call (``round0``, or its plain version
    ``round0_reference``), always in the residual form here.  Returns the
    rows of ``lay`` (a plain layout, no hit rows) and ``win``,
    differentiable in every ScenePacked leaf and the rays."""
    global calls
    static = lay.static
    if lay.residual:
        raise ValueError("bump_round0: the caller's layout has no residual rows (GI keeps the plain round 0)")
    if lin_input and (orig is not None or n_lanes is None):
        raise ValueError("bump_round0: the lin-input form takes n_lanes and no rays")
    calls += 1
    lay_r = layout(static, lay.width, lay.height, want_hit=True, want_vis=True)
    rays = () if orig is None else (orig, dir)
    form = "rays" if rays else ((int(lin_base), int(n_lanes)) if lin_input else None)
    lin = {"lin_input": True, "n_lanes": int(n_lanes)} if lin_input else {}
    tensors = (*rays, *leaves(packed))
    prm = prm.detach()
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if _fast_bump_ok(static):
        if grad:
            outs = _DiffRound0.apply(lay_r, lay.names, trace, prm, form, _fast_out(static), True, *tensors)
            res = dict(zip(lay.names, outs[:-1]))
            res["win"] = outs[-1]
            return res
        o = trace(lay_r, prm, *rays, **lin)
        return _fast_out(static)(packed, *form_rays(packed, lay_r, prm, form, tensors), o)
    # a bump-mapped CSG node: the differentiable re-shade is the forward
    with torch.no_grad():
        o = trace(lay_r, prm, *(r.detach() for r in rays), **lin)
    win, vis, t_pin, n_pin = kernel_pins(o, static.n_lights)
    orig, dir = form_rays(packed, lay_r, prm, form, tensors)
    with torch.no_grad():
        gleaf, sel = compute_leaf_pins(packed, static, orig, dir, win, t_pin)
    out = reshade(packed, static, orig, dir, win, vis, (gleaf, sel, n_pin), bump=True)
    out["win"] = win
    return out
