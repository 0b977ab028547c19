"""Frozen copy of chess2rt_tpu_torch/ops/geometry.py at commit d735142 for the
benchmark's plain reference (unchanged but for its imports).  It imports
nothing of the program.

Device-side geometry intersection (geometry.d, node.d, scene.d).

Counterpart of chess2rt_tpu/ops/geometry.py, with its function names, its
op order and its NaN-free dead-lane guards:

* leaf candidates (``plane_closest``, ``sphere_closest``, ``cube_closest``)
  batched over [N, 3] rays, ``dist = INF`` on a miss;
* CSG by analytic all-hits enumeration: every leaf reports all of its
  non-negative-t hits, the lists are merged by a Batcher odd-even network
  of ``torch.where`` compare-exchanges (no gathers, as in the JAX package)
  and the inside/outside parity walk runs on prefix parities (the JAX
  package's cumulative sums, as XORs);
* ``node_closest`` (identity, offset-only and full-matrix transforms, the
  |dir| distance rescale), ``scene_closest`` (the node scan, ties to the
  later node, an empty scene misses everywhere);
* the distance-only any-hit scan for shadow rays (``test_visibility``).

The eager Whitted twin (render/pipeline.py) runs all of it; the gradient's
backward (ops/round0_grad.py) reuses the leaf closed forms.  ``tangents=True``
adds the bump extension's dNdx/dNdy frame to every record
(intersectable.d:24-25); hot paths leave it off.

Hit sets are dicts of tensors: dist [N,K], p [N,K,3], normal [N,K,3],
u [N,K], v [N,K], sorted ascending by dist with +INF padding.

The guarded derivatives (``_safe_sqrt``, ``_safe_arcsin``,
``_safe_arctan2``) keep the exact forward and clamp the derivative where
it is infinite: a ray grazing a sphere (discriminant 0), hitting its pole
(|y / r| = 1) or its axis (atan2 at the origin) would otherwise send inf
or NaN into every upstream gradient.
"""

from __future__ import annotations

import torch

from .packed import ScenePacked

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


def _const_vec(like, xyz):
    return torch.tensor(xyz, dtype=like.dtype, device=like.device).expand(like.shape)


def plane_closest(y, limit, orig, dir, tangents=False):
    """Plane candidate: a hit dict with dist = INF on a miss.  ``tangents``
    adds the constant frame dNdx = x, dNdy = z (geometry.d:52-53)."""
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
    rec = {"dist": dist, "p": p, "normal": n, "u": p[..., 0], "v": p[..., 2]}
    if tangents:
        rec["dndx"] = _const_vec(p, (1.0, 0.0, 0.0))
        rec["dndy"] = _const_vec(p, (0.0, 0.0, 1.0))
    return rec


def _sphere_record(center, r, orig, dir, t, tangents=False):
    """Position, normal and spherical UVs of the hit at ``t``; ``tangents``:
    dNdx from the azimuth, dNdy = dNdx x normal (geometry.d:121-122)."""
    p = orig + dir * t[..., None]
    rel = p - center
    normal = _norm(rel)
    angle = _safe_arctan2(rel[..., 2], rel[..., 0])
    u = (torch.pi + angle) / (2 * torch.pi)
    v = 1.0 - (torch.pi / 2 + _safe_arcsin(torch.clamp(rel[..., 1] / r, -1.0, 1.0))) / torch.pi
    rec = {"p": p, "normal": normal, "u": u, "v": v}
    if tangents:
        dndx = torch.stack(
            [torch.cos(angle + torch.pi / 2), torch.zeros_like(angle), torch.sin(angle + torch.pi / 2)], dim=-1
        )
        rec["dndx"] = dndx
        rec["dndy"] = torch.linalg.cross(dndx, normal, dim=-1)
    return rec


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


def _cube_face_candidates(center, side, orig, dir, tangents=False):
    """Per-face candidate (dist, normal, u, v, p) for all 6 faces -> [N, 6, ...].

    The reference's tangent-frame quirk is kept (geometry.d:178-191,
    :227-228): it unprojects normal and p after the axis-permuted side tests
    but not dNdx/dNdy, so every face keeps the projected-space literals
    dNdx = (1, 0, 0), dNdy = (0, 0, face_sign)."""
    half = side * 0.5
    dists, normals, us, vs, ps, dndys = [], [], [], [], [], []
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
        ps.append(p)
        if tangents:
            dndys.append(_const_vec(p, (0.0, 0.0, s)))
    out = {
        "dist": torch.stack(dists, -1),  # [N, 6]
        "normal": torch.stack(normals, -2),  # [N, 6, 3]
        "u": torch.stack(us, -1),
        "v": torch.stack(vs, -1),
        "p": torch.stack(ps, -2),
    }
    if tangents:
        out["dndx"] = _const_vec(out["normal"], (1.0, 0.0, 0.0))
        out["dndy"] = torch.stack(dndys, -2)
    return out


def sphere_closest(center, r, orig, dir, tangents=False):
    """Nearer root unless it is behind the origin (geometry.d:104-108)."""
    has, x1, x2 = _sphere_roots(center, r, orig, dir)
    sol = torch.where(x2 < 0, x1, x2)
    ok = has & (sol >= 0)
    rec = _sphere_record(center, r, orig, dir, torch.where(ok, sol, 0.0), tangents)
    rec["dist"] = torch.where(ok, sol, INF)
    return rec


def cube_closest(center, side, orig, dir, tangents=False):
    """Running-min select over the 6 faces, first face winning ties."""
    faces = _cube_face_candidates(center, side, orig, dir, tangents)
    vec_keys = ("normal", "p", "dndx", "dndy") if tangents else ("normal", "p")
    best = {k: faces[k][..., 0] for k in ("dist", "u", "v")}
    best.update({k: faces[k][..., 0, :] for k in vec_keys})
    for i in range(1, 6):
        better = faces["dist"][..., i] < best["dist"]
        for k in ("dist", "u", "v"):
            best[k] = torch.where(better, faces[k][..., i], best[k])
        for k in vec_keys:
            best[k] = torch.where(better[..., None], faces[k][..., i, :], best[k])
    return best


# --------------------------------------------------------------------------
# All-hits enumeration for CSG
# --------------------------------------------------------------------------


def _oddeven_pairs(n: int):
    """Batcher odd-even mergesort compare-exchange pairs for n slots (a
    static network: selects only, no gathers)."""
    pairs = []

    def merge(lo, nn, r):
        step = r * 2
        if step < nn:
            merge(lo, nn, step)
            merge(lo + r, nn, step)
            for i in range(lo + r, lo + nn - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, nn):
        if nn > 1:
            m = nn // 2
            sort(lo, m)
            sort(lo + m, nn - m)
            merge(lo, nn, 1)

    # pad virtually to a power of two by clamping out-of-range pairs
    n2 = 1
    while n2 < n:
        n2 *= 2
    sort(0, n2)
    return [(i, j) for (i, j) in pairs if i < n and j < n]


def _sort_hit_fields(fields: dict, key: str = "dist"):
    """Network sort of a dict of [N, K(, 3)] tensors by ``fields[key]``
    ascending; slot accesses are static indices."""
    kdim = fields[key].dim()
    k = fields[key].shape[-1]
    cols = {name: [a[..., i, :] if a.dim() > kdim else a[..., i] for i in range(k)] for name, a in fields.items()}
    for i, j in _oddeven_pairs(k):
        swap = cols[key][i] > cols[key][j]
        for name in cols:
            ci, cj = cols[name][i], cols[name][j]
            sw = swap[..., None] if ci.dim() > swap.dim() else swap
            cols[name][i] = torch.where(sw, cj, ci)
            cols[name][j] = torch.where(sw, ci, cj)
    return {name: torch.stack(cols[name], dim=-2 if a.dim() > kdim else -1) for name, a in fields.items()}


def _sort_hits(hits, extra=None):
    """Sort a hit set by distance; ``extra``: optional dict of [N, K]
    companion fields sorted along."""
    fields = dict(hits)
    if extra:
        fields.update(extra)
    out = _sort_hit_fields(fields)
    if extra:
        return {k: out[k] for k in hits}, {k: out[k] for k in extra}
    return {k: out[k] for k in hits}, None


def _vec_keys(hits):
    """Hit-set fields carrying [..., 3] vectors (vs per-hit scalars)."""
    return tuple(k for k in hits if k in ("p", "normal", "dndx", "dndy"))


def plane_all_hits(y, limit, orig, dir, tangents=False):
    c = plane_closest(y, limit, orig, dir, tangents)
    vk = _vec_keys(c)
    return {k: v[..., None, :] if k in vk else v[..., None] for k, v in c.items()}


def sphere_all_hits(center, r, orig, dir, tangents=False):
    """Both quadratic roots with t >= 0, ascending (what the reference's
    re-cast loop enumerates, geometry.d:271-290)."""
    has, x1, x2 = _sphere_roots(center, r, orig, dir)  # x2 <= x1
    d = torch.stack([torch.where(has & (x2 >= 0), x2, INF), torch.where(has & (x1 >= 0), x1, INF)], dim=-1)
    recs = [_sphere_record(center, r, orig, dir, t, tangents) for t in (x2, x1)]
    out = {"dist": d}
    vk = _vec_keys(recs[0])
    for k in recs[0]:
        out[k] = torch.stack([rc[k] for rc in recs], dim=-2 if k in vk else -1)
    return out


def cube_all_hits(center, side, orig, dir, tangents=False):
    """The (<= 2) valid face crossings, ascending."""
    sorted_faces, _ = _sort_hits(_cube_face_candidates(center, side, orig, dir, tangents))
    vk = _vec_keys(sorted_faces)
    return {k: (v[..., :2, :] if k in vk else v[..., :2]) for k, v in sorted_faces.items()}


# --------------------------------------------------------------------------
# Inside tests (geometry.d:25-28, :127-130, :165-170, :334-337)
# --------------------------------------------------------------------------


def is_inside_expr(packed: ScenePacked, expr, p):
    kind = expr[0]
    if kind == "plane":
        return torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    if kind == "sphere":
        c, r = packed.sphere_center[expr[1]], packed.sphere_r[expr[1]]
        rel = c - p
        return dot(rel, rel) < r * r
    if kind == "cube":
        c, s = packed.cube_center[expr[1]], packed.cube_side[expr[1]]
        return (torch.abs(p - c) <= s * 0.5).all(-1)
    _, op, left, right = expr
    return _bool_op(op, is_inside_expr(packed, left, p), is_inside_expr(packed, right, p))


def _bool_op(op, il, ir):
    if op == "union":
        return il | ir
    if op == "inter":
        return il & ir
    return il & ~ir  # diff


def _prefix_parity(bits):
    """[..., K] bool -> the parity of each prefix: out[..., j] is the XOR of
    bits[..., :j + 1], which is ``cumsum(bits) % 2 == 1`` (the JAX package's
    form).  K is a handful of slots; on the card ``torch.cumsum`` over such a
    short innermost dimension of 2M rows was 71% of a 1080p twin frame's
    device time, K - 1 XORs are a few microseconds."""
    cols = [bits[..., 0]]
    for j in range(1, bits.shape[-1]):
        cols.append(cols[-1] ^ bits[..., j])
    return torch.stack(cols, dim=-1)


def _parity_state(op, ld, rd, from_right, valid):
    """boolOp(inL, inR) after each sorted hit (geometry.d:292-332): the
    initial parity is odd hit count -> inside (geometry.d:307-309), and each
    valid hit from a side flips that side."""
    in_l0 = (ld < INF).sum(-1) % 2 == 1
    in_r0 = (rd < INF).sum(-1) % 2 == 1
    in_l = in_l0[..., None] ^ _prefix_parity(~from_right & valid)
    in_r = in_r0[..., None] ^ _prefix_parity(from_right & valid)
    return _bool_op(op, in_l, in_r) & valid


# --------------------------------------------------------------------------
# Geometry-expression dispatch
# --------------------------------------------------------------------------


def all_hits_expr(packed: ScenePacked, expr, orig, dir, tangents=False):
    """All boundary crossings of the solid ``expr`` along the ray, as a
    sorted fixed-capacity hit set.  For a CSG node: the child hits at which
    boolOp(inL, inR) holds after the flip (geometry.d:292-332)."""
    kind = expr[0]
    if kind == "plane":
        return plane_all_hits(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir, tangents)
    if kind == "sphere":
        return sphere_all_hits(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir, tangents)
    if kind == "cube":
        return cube_all_hits(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir, tangents)

    _, op, left, right = expr
    lh = all_hits_expr(packed, left, orig, dir, tangents)
    rh = all_hits_expr(packed, right, orig, dir, tangents)
    vk = _vec_keys(lh)
    merged = {k: torch.cat([lh[k], rh[k]], dim=-2 if k in vk else -1) for k in lh}
    side_flag = torch.cat([torch.zeros_like(lh["dist"]), torch.ones_like(rh["dist"])], dim=-1)
    shits, extra = _sort_hits(merged, extra={"side": side_flag})
    valid = shits["dist"] < INF
    state = _parity_state(op, lh["dist"], rh["dist"], extra["side"] > 0.5, valid)

    # CsgDiff normal flip (geometry.d:377-397): on the subtracted child's
    # skin the stored normal points into the solid; detect it by right's
    # inside test just before and after the hit.  The probe step is the
    # reference's 1e-6 in f64; in f32 that is below one ulp at the scenes'
    # coordinate scale (~1e2) and the flip would never fire, so 1e-3 (the
    # dtype split of ops/shade.shadow_eps).  The flip turns the normal only,
    # never the tangent frame.
    if op == "diff":
        eps = 1e-6 if shits["p"].dtype == torch.float64 else 1e-3
        before = is_inside_expr(packed, right, shits["p"] - dir[..., None, :] * eps)
        after = is_inside_expr(packed, right, shits["p"] + dir[..., None, :] * eps)
        flip = (before != after) & state
        shits["normal"] = torch.where(flip[..., None], -shits["normal"], shits["normal"])

    shits["dist"] = torch.where(state, shits["dist"], INF)
    # compact: re-sort so surviving hits lead and padding trails
    out, _ = _sort_hits(shits)
    return out


def closest_hit_expr(packed: ScenePacked, expr, orig, dir, tangents=False):
    """Closest-hit candidate of a geometry expression (dist = INF on miss)."""
    kind = expr[0]
    if kind == "plane":
        return plane_closest(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir, tangents)
    if kind == "sphere":
        return sphere_closest(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir, tangents)
    if kind == "cube":
        return cube_closest(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir, tangents)
    hits = all_hits_expr(packed, expr, orig, dir, tangents)
    vk = _vec_keys(hits)
    return {k: (v[..., 0, :] if k in vk else v[..., 0]) for k, v in hits.items()}


# --------------------------------------------------------------------------
# Node = geometry + transform (node.d:23-68)
# --------------------------------------------------------------------------


def node_inverses(packed: ScenePacked):
    """Every node matrix's inverse, [Nn, 3, 3], in one batched call.
    ``inv_ex`` does not check for singular matrices on the host, so a CUDA
    scene scan pays no device sync for it.  A dtype below float32 (the
    lower-precision control) inverts in float32 and rounds: torch has no
    low-precision inverse."""
    m = packed.node_matrix
    if m.dtype in (torch.float32, torch.float64):
        return torch.linalg.inv_ex(m)[0]
    return torch.linalg.inv_ex(m.float())[0].to(m.dtype)


def _to_canonic(packed, node_idx, orig, dir, m_inv):
    offset = packed.node_offset[node_idx]
    if m_inv is None:
        m_inv = torch.linalg.inv_ex(packed.node_matrix[node_idx])[0]
    else:
        m_inv = m_inv[node_idx]
    co = (orig - offset) @ m_inv
    cd = dir @ m_inv
    dlen = torch.sqrt(dot(cd, cd))
    return offset, m_inv, co, cd / dlen[..., None], dlen


def node_closest(packed: ScenePacked, node_static, node_idx, orig, dir, tangents=False, m_inv=None):
    """Closest-hit candidate for one scene node, in world space: the
    canonic-space round trip with the |dir| distance rescale (node.d:51-67);
    identity and offset-only transforms take cheaper paths.  ``m_inv``:
    optional ``node_inverses(packed)``, shared by a whole scan.  Tangents
    transform by the forward matrix, then normalize (node.d:45-46)."""
    if node_static.identity_transform:
        return closest_hit_expr(packed, node_static.geom, orig, dir, tangents)
    if node_static.offset_only:
        offset = packed.node_offset[node_idx]
        cand = closest_hit_expr(packed, node_static.geom, orig - offset, dir, tangents)
        cand["p"] = cand["p"] + offset
        return cand
    offset, m_inv, co, cdn, dlen = _to_canonic(packed, node_idx, orig, dir, m_inv)
    m = packed.node_matrix[node_idx]
    cand = closest_hit_expr(packed, node_static.geom, co, cdn, tangents)
    out = {
        "dist": torch.where(cand["dist"] >= INF, INF, cand["dist"] / dlen),
        "p": cand["p"] @ m + offset,
        "normal": _norm(cand["normal"] @ m_inv.T),
        "u": cand["u"],
        "v": cand["v"],
    }
    if tangents:
        out["dndx"] = _norm(cand["dndx"] @ m)
        out["dndy"] = _norm(cand["dndy"] @ m)
    return out


def _needs_inverses(static) -> bool:
    return any(not (ns.identity_transform or ns.offset_only) for ns in static.nodes)


def scene_closest(packed: ScenePacked, static, orig, dir, tangents=False):
    """The node-scan hot loop (renderer.d:336-338): every node in turn, the
    last improving node wins (ties included); returns (hit, win) with
    win == -1 for misses.  An empty scene misses every ray.  ``tangents``
    carries the dNdx/dNdy frame through the records (the bump extension)."""
    m_inv = node_inverses(packed) if _needs_inverses(static) else None
    best = None
    win = torch.full(orig.shape[:-1], -1, dtype=torch.int32, device=orig.device)
    for i, ns in enumerate(static.nodes):
        cand = node_closest(packed, ns, i, orig, dir, tangents, m_inv=m_inv)
        if best is None:
            best = cand
            win = torch.where(cand["dist"] < INF, i, win)
        else:
            better = cand["dist"] <= best["dist"]  # ties: the later node wins, like the reference
            win = torch.where(better & (cand["dist"] < INF), i, win)
            vk = _vec_keys(best)
            best = {k: torch.where(better[..., None] if k in vk else better, cand[k], best[k]) for k in best}
    if best is None:  # empty scene
        z = torch.zeros(orig.shape[:-1], dtype=orig.dtype, device=orig.device)
        best = {"dist": torch.full_like(z, INF), "p": orig, "normal": dir, "u": z, "v": z}
        if tangents:
            best["dndx"] = torch.zeros_like(orig)
            best["dndy"] = torch.zeros_like(orig)
    return best, win


# --------------------------------------------------------------------------
# Distance-only any-hit (shadow rays, ray.d:15-17)
# --------------------------------------------------------------------------


def _plane_dist(y, limit, orig, dir):
    oy, dy = orig[..., 1], dir[..., 1]
    miss = ((oy > y) & (dy > -1e-9)) | ((oy < y) & (dy < 1e-9))
    nonzero = dy != 0
    mult = (oy - y) * torch.where(nonzero, -1.0 / torch.where(nonzero, dy, 1.0), 0.0)
    px = orig[..., 0] + dir[..., 0] * mult
    pz = orig[..., 2] + dir[..., 2] * mult
    ok = ~miss & nonzero & (torch.abs(px) <= limit) & (torch.abs(pz) <= limit)
    return torch.where(ok, mult, INF)[..., None]  # [N, 1] hit list


def _sphere_dists(center, r, orig, dir):
    has, x1, x2 = _sphere_roots(center, r, orig, dir)
    return torch.stack([torch.where(has & (x2 >= 0), x2, INF), torch.where(has & (x1 >= 0), x1, INF)], dim=-1)


def _cube_dists(center, side, orig, dir):
    """Slab-method (t_enter, t_exit); a ray parallel to a slab is inside it
    (-INF, INF) or misses (INF, -INF)."""
    half = side * 0.5
    t_enter = None
    t_exit = None
    for axis in range(3):
        d_k = dir[..., axis]
        o_k = orig[..., axis]
        ok = torch.abs(d_k) >= 1e-9
        inv = 1.0 / torch.where(ok, d_k, 1.0)
        t1 = (center[..., axis] - half - o_k) * inv
        t2 = (center[..., axis] + half - o_k) * inv
        tn = torch.minimum(t1, t2)
        tf = torch.maximum(t1, t2)
        inside = (o_k >= center[..., axis] - half) & (o_k <= center[..., axis] + half)
        # +-INF in the rays' dtype (a where of two Python floats would be f32)
        big = torch.full_like(tn, INF)
        tn = torch.where(ok, tn, torch.where(inside, -big, big))
        tf = torch.where(ok, tf, torch.where(inside, big, -big))
        t_enter = tn if t_enter is None else torch.maximum(t_enter, tn)
        t_exit = tf if t_exit is None else torch.minimum(t_exit, tf)
    hit = (t_enter <= t_exit) & (t_exit >= 0)
    d1 = torch.where(hit & (t_enter >= 0), t_enter, INF)
    d2 = torch.where(hit, t_exit, INF)
    return torch.stack([torch.minimum(d1, d2), torch.maximum(d1, d2)], dim=-1)


def all_hit_dists_expr(packed: ScenePacked, expr, orig, dir):
    """Sorted hit distances only (the all_hits_expr parity walk without the
    record fields)."""
    kind = expr[0]
    if kind == "plane":
        return _plane_dist(packed.plane_y[expr[1]], packed.plane_limit[expr[1]], orig, dir)
    if kind == "sphere":
        return _sphere_dists(packed.sphere_center[expr[1]], packed.sphere_r[expr[1]], orig, dir)
    if kind == "cube":
        return _cube_dists(packed.cube_center[expr[1]], packed.cube_side[expr[1]], orig, dir)
    _, op, left, right = expr
    ld = all_hit_dists_expr(packed, left, orig, dir)
    rd = all_hit_dists_expr(packed, right, orig, dir)
    s = _sort_hit_fields({
        "dist": torch.cat([ld, rd], dim=-1),
        "side": torch.cat([torch.zeros_like(ld), torch.ones_like(rd)], dim=-1),
    })
    state = _parity_state(op, ld, rd, s["side"] > 0.5, s["dist"] < INF)
    return _sort_hit_fields({"dist": torch.where(state, s["dist"], INF)})["dist"]


def node_closest_dist(packed: ScenePacked, node_static, node_idx, orig, dir, m_inv=None):
    """Closest-hit distance only, world space.  The min over the list, not
    slot 0: a leaf sphere's list is [x2, x1] with INF-masked roots,
    unsorted, so a ray starting inside has x2 < 0 <= x1 and slot 0 would
    miss the far root the reference reports (geometry.d:104-108)."""
    if node_static.identity_transform:
        return all_hit_dists_expr(packed, node_static.geom, orig, dir).amin(-1)
    if node_static.offset_only:
        return all_hit_dists_expr(packed, node_static.geom, orig - packed.node_offset[node_idx], dir).amin(-1)
    _, _, co, cdn, dlen = _to_canonic(packed, node_idx, orig, dir, m_inv)
    d = all_hit_dists_expr(packed, node_static.geom, co, cdn).amin(-1)
    return torch.where(d >= INF, INF, d / dlen)


def test_visibility(packed: ScenePacked, static, from_p, to_p):
    """Scene.testVisibility (scene.d:62-78): True = unoccluded.  One
    distance-only any-hit pass over all nodes."""
    d = to_p - from_p
    target = torch.sqrt(dot(d, d))
    dir = d / target[..., None]
    m_inv = node_inverses(packed) if _needs_inverses(static) else None
    occluded = torch.zeros(from_p.shape[:-1], dtype=torch.bool, device=from_p.device)
    for i, ns in enumerate(static.nodes):
        occluded = occluded | (node_closest_dist(packed, ns, i, from_p, dir, m_inv=m_inv) <= target)
    return ~occluded
