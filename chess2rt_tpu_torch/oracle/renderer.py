"""Trusted NumPy float64 oracle renderer.

Copy of chess2rt_tpu/oracle/renderer.py for the port, whose float64 frames
it anchors where the JAX package cannot be imported (the machine with the
card).  Only the package it imports from differs.

A direct, vectorized-over-rays transliteration of the reference renderer's
math (reference: source/rt/{renderer,geometry,node,shader,texture,camera,
scene}.d).  This is the ground truth the TPU path is validated against
(SURVEY.md §4: the reference ships no golden framebuffers, so this oracle
*is* the golden generator).  It is deliberately slow and simple: plain
numpy, float64 geometry / float32 color like the reference, Python loops
over the (few) scene entities, vectorized over the pixel/ray batch.

Reference quirks intentionally preserved (each cited at its site):
* Plane horizon test with the 1e-9 epsilon band (geometry.d:35).
* Sphere root selection: nearer root unless behind origin (geometry.d:104-108).
* CSG "find all intersections" via re-casting from p + dir*1e-6 with
  cumulative distance that *excludes* the epsilon steps (geometry.d:271-290).
* CsgDiff normal flip via the double inside-test (geometry.d:377-397).
* Node intersect distance rescaling by |dir| under transforms (node.d:23-68).
* GI path multiplier is dropped at every recursion level — `trace` always
  passes Color(1,1,1) to pathtrace_impl (renderer.d:356), so indirect
  bounces are NOT attenuated by path throughput.  Preserved behind
  ``gi_multiplier_quirk=True``; set False for physically-correct tracing.
* The AA-detect pass uses tooDifferent's default 0.1 threshold; the
  AAThreshold setting is never forwarded (renderer.d:172).
"""

from __future__ import annotations

import numpy as np

from ..models import types as T
from ..utils import vec
from ..utils.color import combine_stereo, srgb_u8, too_different

INF_DIST = 1e99


# --------------------------------------------------------------------------
# Hit record (IntersectionData, intersectable.d:6-33) as SoA arrays
# --------------------------------------------------------------------------


class HitRecord:
    """SoA hit record for a batch of N rays."""

    FIELDS = ("p", "normal", "dndx", "dndy")

    def __init__(self, n: int):
        self.p = np.zeros((n, 3))
        self.normal = np.zeros((n, 3))
        self.dndx = np.zeros((n, 3))
        self.dndy = np.zeros((n, 3))
        self.dist = np.full(n, INF_DIST)
        self.u = np.zeros(n)
        self.v = np.zeros(n)

    def update_where(self, m, p=None, normal=None, dist=None, u=None, v=None, dndx=None, dndy=None):
        """Masked overwrite — the "only improve dist" contract turns into a
        select (intersectable.d:35-59)."""
        mm = m[:, None]
        if p is not None:
            self.p = np.where(mm, p, self.p)
        if normal is not None:
            self.normal = np.where(mm, normal, self.normal)
        if dndx is not None:
            self.dndx = np.where(mm, dndx, self.dndx)
        if dndy is not None:
            self.dndy = np.where(mm, dndy, self.dndy)
        if dist is not None:
            self.dist = np.where(m, dist, self.dist)
        if u is not None:
            self.u = np.where(m, u, self.u)
        if v is not None:
            self.v = np.where(m, v, self.v)

    def copy_from_where(self, m, other: "HitRecord", idx=None):
        """self[m] = other[m] (or other[m, idx[m]] when other is a [N,K] list)."""
        for f in ("p", "normal", "dndx", "dndy"):
            src = getattr(other, f)
            if idx is not None:
                src = src[np.arange(len(m)), idx]
            setattr(self, f, np.where(m[:, None], src, getattr(self, f)))
        for f in ("dist", "u", "v"):
            src = getattr(other, f)
            if idx is not None:
                src = src[np.arange(len(m)), idx]
            setattr(self, f, np.where(m, src, getattr(self, f)))


class HitList:
    """Fixed-capacity per-ray hit lists for CSG (MyArray!IntersectionData)."""

    def __init__(self, n: int, cap: int):
        self.p = np.zeros((n, cap, 3))
        self.normal = np.zeros((n, cap, 3))
        self.dndx = np.zeros((n, cap, 3))
        self.dndy = np.zeros((n, cap, 3))
        self.dist = np.full((n, cap), np.inf)
        self.u = np.zeros((n, cap))
        self.v = np.zeros((n, cap))
        self.count = np.zeros(n, dtype=np.int64)


# --------------------------------------------------------------------------
# Geometry intersection (geometry.d)
# --------------------------------------------------------------------------


def max_hits(geom: T.Geometry) -> int:
    """Static bound on how many hits findAllIntersections can produce for a
    single ray: plane 1, sphere 2, cube 2, CSG = sum of children."""
    if isinstance(geom, T.Plane):
        return 1
    if isinstance(geom, (T.Sphere, T.Cube)):
        return 2
    if isinstance(geom, T.CsgOp):
        return max_hits(geom.left) + max_hits(geom.right)
    raise TypeError(type(geom))


def intersect_plane(geom: T.Plane, orig, dir, rec: HitRecord):
    """geometry.d:30-59."""
    oy, dy = orig[:, 1], dir[:, 1]
    miss = ((oy > geom.y) & (dy > -1e-9)) | ((oy < geom.y) & (dy < 1e-9))
    # Non-miss lanes have |dy| >= 1e-9 by construction EXCEPT the
    # degenerate origin-exactly-on-plane case (oy == y passes neither
    # miss branch): with dy == 0 the reference computes 0/0 = NaN whose
    # comparisons all fail => no hit (with dy != 0 it hits at mult = 0,
    # which the guarded division preserves).  Guard the division (the
    # NaN-free invariant, same pattern as the device path) and mask the
    # 0/0 lanes out explicitly to keep the identical no-hit outcome.
    deg = ~miss & (dy == 0)
    safe_dy = np.where(miss | deg, 1.0, -dy)
    mult = (oy - geom.y) / safe_dy
    ok = ~miss & ~deg & (mult <= rec.dist)
    p = orig + dir * mult[:, None]
    ok &= (np.abs(p[:, 0]) <= geom.limit) & (np.abs(p[:, 2]) <= geom.limit)
    n = orig.shape[0]
    rec.update_where(
        ok,
        p=p,
        dist=mult,
        normal=np.broadcast_to([0.0, 1.0, 0.0], (n, 3)),
        dndx=np.broadcast_to([1.0, 0.0, 0.0], (n, 3)),
        dndy=np.broadcast_to([0.0, 0.0, 1.0], (n, 3)),
        u=p[:, 0],
        v=p[:, 2],
    )
    return ok


def intersect_sphere(geom: T.Sphere, orig, dir, rec: HitRecord):
    """geometry.d:92-125."""
    center = np.asarray(geom.center, dtype=np.float64)
    H = orig - center
    A = vec.squared_length(dir)
    B = 2.0 * vec.dot(H, dir)
    C = vec.squared_length(H) - geom.R * geom.R
    Dscr = B * B - 4.0 * A * C
    has = Dscr >= 0
    sq = np.sqrt(np.where(has, Dscr, 0.0))
    x1 = (-B + sq) / (2.0 * A)
    x2 = (-B - sq) / (2.0 * A)
    sol = np.where(x2 < 0, x1, x2)  # nearer root, unless behind us
    ok = has & (sol >= 0) & (sol <= rec.dist)
    p = orig + dir * sol[:, None]
    normal = vec.normalize(np.where(ok[:, None], p - center, dir))  # avoid 0/0 off-mask
    angle = np.arctan2(p[:, 2] - center[2], p[:, 0] - center[0])
    u = (np.pi + angle) / (2 * np.pi)
    v = 1.0 - (np.pi / 2 + np.arcsin(np.clip((p[:, 1] - center[1]) / geom.R, -1, 1))) / np.pi
    dndx = np.stack([np.cos(angle + np.pi / 2), np.zeros_like(angle), np.sin(angle + np.pi / 2)], axis=-1)
    dndy = vec.cross(dndx, normal)
    rec.update_where(ok, p=p, dist=sol, normal=normal, dndx=dndx, dndy=dndy, u=u, v=v)
    return ok


def _intersect_cube_side(orig, dir, center, side, rec: HitRecord):
    """intersectCubeSide for the Y-slabs (geometry.d:199-235); callers permute
    axes for the X/Z sides, like the reference."""
    n = orig.shape[0]
    half = side * 0.5
    any_found = np.zeros(n, dtype=bool)
    valid_dir = np.abs(dir[:, 1]) >= 1e-9
    # guarded reciprocal (the NaN-free-masked-lanes invariant the device
    # path enforces — the repo's invariant): lanes with dir.y ~ 0 are dead via
    # valid_dir either way; dividing by 1 keeps mult (and p below) finite
    # so the suite runs warning-free
    safe_dy = np.where(valid_dir, -dir[:, 1], 1.0)
    for s in (-1.0, 1.0):
        mult = (orig[:, 1] - (center[1] + s * half)) / safe_dy
        ok = valid_dir & (mult >= 0) & (mult <= rec.dist)
        p = orig + dir * mult[:, None]
        ok &= (
            (p[:, 0] >= center[0] - half)
            & (p[:, 0] <= center[0] + half)
            & (p[:, 2] >= center[2] - half)
            & (p[:, 2] <= center[2] + half)
        )
        rec.update_where(
            ok,
            p=p,
            dist=mult,
            normal=np.broadcast_to([0.0, s, 0.0], (n, 3)),
            dndx=np.broadcast_to([1.0, 0.0, 0.0], (n, 3)),
            dndy=np.broadcast_to([0.0, 0.0, s], (n, 3)),
            u=p[:, 0] - center[0],
            v=p[:, 2] - center[2],
        )
        any_found |= ok
    return any_found


def intersect_cube(geom: T.Cube, orig, dir, rec: HitRecord):
    """geometry.d:172-197 — Y-slabs natively, then the same routine on
    axis-permuted rays for the X and Z sides."""
    center = np.asarray(geom.center, dtype=np.float64)
    found = _intersect_cube_side(orig, dir, center, geom.side, rec)
    for a, b, c in ((1, 0, 2), (0, 2, 1)):
        po, pd = vec.project(orig, a, b, c), vec.project(dir, a, b, c)
        pc = vec.project(center[None, :], a, b, c)[0]
        sub = HitRecord(orig.shape[0])
        sub.dist = rec.dist.copy()
        ok = _intersect_cube_side(po, pd, pc, geom.side, sub)
        rec.update_where(
            ok,
            p=vec.unproject(sub.p, a, b, c),
            dist=sub.dist,
            normal=vec.unproject(sub.normal, a, b, c),
            dndx=sub.dndx,
            dndy=sub.dndy,
            u=sub.u,
            v=sub.v,
        )
        found |= ok
    return found


def is_inside(geom: T.Geometry, p) -> np.ndarray:
    """Geometry.isInside, vectorized (geometry.d:25-28, :127-130, :165-170, :334-337)."""
    if isinstance(geom, T.Plane):
        return np.zeros(p.shape[0], dtype=bool)
    if isinstance(geom, T.Sphere):
        c = np.asarray(geom.center, dtype=np.float64)
        return vec.squared_length(c - p) < geom.R * geom.R
    if isinstance(geom, T.Cube):
        c = np.asarray(geom.center, dtype=np.float64)
        return np.all(np.abs(p - c) <= geom.side * 0.5, axis=-1)
    if isinstance(geom, T.CsgOp):
        return _bool_op(geom, is_inside(geom.left, p), is_inside(geom.right, p))
    raise TypeError(type(geom))


def _bool_op(csg: T.CsgOp, in_l, in_r):
    if csg.op == "union":
        return in_l | in_r
    if csg.op == "inter":
        return in_l & in_r
    return in_l & ~in_r  # diff


def find_all_intersections(geom: T.Geometry, orig, dir, cap: int) -> HitList:
    """CsgOp.findAllIntersections (geometry.d:271-290): repeatedly re-cast
    from just past each hit, accumulating cumulative distance.  NB the
    recorded distance excludes the 1e-6 epsilon steps, exactly like the
    reference (temp.dist += currentLength; currentLength = temp.dist)."""
    n = orig.shape[0]
    hits = HitList(n, cap)
    cur_orig = orig.astype(np.float64).copy()
    cumlen = np.zeros(n)
    active = np.ones(n, dtype=bool)
    for k in range(cap):
        rec = HitRecord(n)
        m = intersect_geometry(geom, cur_orig, dir, rec) & active
        if not m.any():
            break
        d = rec.dist + cumlen
        for f in ("p", "normal", "dndx", "dndy"):
            getattr(hits, f)[m, k] = getattr(rec, f)[m]
        hits.dist[m, k] = d[m]
        hits.u[m, k] = rec.u[m]
        hits.v[m, k] = rec.v[m]
        hits.count += m
        cumlen = np.where(m, d, cumlen)
        cur_orig = np.where(m[:, None], rec.p + dir * 1e-6, cur_orig)
        active &= m
    return hits


def intersect_csg(csg: T.CsgOp, orig, dir, rec: HitRecord):
    """CsgOp.intersect (geometry.d:292-332): merge both children's hit lists,
    sort by distance, walk flipping in-left/in-right parity; the first state
    where boolOp turns true wins if it improves rec.dist."""
    n = orig.shape[0]
    lcap, rcap = max_hits(csg.left), max_hits(csg.right)
    lh = find_all_intersections(csg.left, orig, dir, lcap)
    rh = find_all_intersections(csg.right, orig, dir, rcap)

    cap = lcap + rcap
    dist = np.concatenate([lh.dist, rh.dist], axis=1)  # [n, cap]
    is_right = np.concatenate(
        [np.zeros((n, lcap), dtype=bool), np.ones((n, rcap), dtype=bool)], axis=1
    )
    order = np.argsort(dist, axis=1, kind="stable")
    sdist = np.take_along_axis(dist, order, axis=1)
    sright = np.take_along_axis(is_right, order, axis=1)
    valid = np.isfinite(sdist)

    # Initial parity: odd hit count means the ray starts inside (geometry.d:307-309).
    in_l0 = (lh.count % 2).astype(bool)
    in_r0 = (rh.count % 2).astype(bool)

    # Parity after processing sorted hit j, via cumulative flip counts —
    # equivalent to the reference's sequential walk.
    flips_r = np.cumsum(sright & valid, axis=1)
    flips_l = np.cumsum(~sright & valid, axis=1)
    in_l = in_l0[:, None] ^ (flips_l % 2).astype(bool)
    in_r = in_r0[:, None] ^ (flips_r % 2).astype(bool)

    state = _bool_op(csg, in_l, in_r) & valid
    any_state = state.any(axis=1)
    first = np.argmax(state, axis=1)  # first j where boolOp turned true
    win_dist = sdist[np.arange(n), first]
    ok = any_state & (win_dist <= rec.dist)

    # Gather the winning hit's record from the side that produced it.
    flat_idx = order[np.arange(n), first]  # index into the concatenated lists
    merged = HitList(n, cap)
    for f in ("p", "normal", "dndx", "dndy", "u", "v"):
        setattr(merged, f, np.concatenate([getattr(lh, f), getattr(rh, f)], axis=1))
    merged.dist = dist

    sel = np.arange(n)
    rec.update_where(
        ok,
        p=merged.p[sel, flat_idx],
        dist=merged.dist[sel, flat_idx],
        normal=merged.normal[sel, flat_idx],
        dndx=merged.dndx[sel, flat_idx],
        dndy=merged.dndy[sel, flat_idx],
        u=merged.u[sel, flat_idx],
        v=merged.v[sel, flat_idx],
    )

    # CsgDiff corner case (geometry.d:377-397): flip the normal on the
    # "eaten-out" surface, detected when the subtracted child's inside-ness
    # differs just before vs just after the hit point.
    if csg.op == "diff" and ok.any():
        before = is_inside(csg.right, rec.p - dir * 1e-6)
        after = is_inside(csg.right, rec.p + dir * 1e-6)
        flip = ok & (before != after)
        rec.normal = np.where(flip[:, None], -rec.normal, rec.normal)
    return ok


def intersect_geometry(geom: T.Geometry, orig, dir, rec: HitRecord):
    if isinstance(geom, T.Plane):
        return intersect_plane(geom, orig, dir, rec)
    if isinstance(geom, T.Sphere):
        return intersect_sphere(geom, orig, dir, rec)
    if isinstance(geom, T.Cube):
        return intersect_cube(geom, orig, dir, rec)
    if isinstance(geom, T.CsgOp):
        return intersect_csg(geom, orig, dir, rec)
    raise TypeError(type(geom))


def intersect_node(node: T.Node, orig, dir, rec: HitRecord):
    """Node.intersect with the dist-rescaling algebra (node.d:23-68).

    Off-mask lanes produce zero vectors (e.g. `sub.normal` on rays the
    geometry missed); the normalizes below use the guarded form so those
    discarded lanes stay finite — the same NaN-free-masked-lanes invariant
    the device path enforces (no errstate suppression anywhere)."""
    tr = node.transform
    co = vec.mul_vm(orig - tr.offset, tr.inverse)
    cd = vec.mul_vm(dir, tr.inverse)
    dir_len = vec.length(cd)
    sub = HitRecord(orig.shape[0])
    sub.dist = rec.dist * dir_len  # (2) world -> canonic distance
    cdn = cd / dir_len[:, None]  # (3)
    ok = intersect_geometry(node.geometry, co, cdn, sub)
    if not ok.any():
        return ok
    rec.update_where(
        ok,
        p=vec.mul_vm(sub.p, tr.matrix) + tr.offset,
        dist=sub.dist / dir_len,  # (5) canonic -> world
        normal=vec.normalize_guarded(vec.mul_vm(sub.normal, tr.transposed_inverse)),
        dndx=vec.normalize_guarded(vec.mul_vm(sub.dndx, tr.matrix)),
        dndy=vec.normalize_guarded(vec.mul_vm(sub.dndy, tr.matrix)),
        u=sub.u,
        v=sub.v,
    )
    return ok


# --------------------------------------------------------------------------
# Textures (texture.d)
# --------------------------------------------------------------------------


def tex_color(tex: T.Texture, u, v):
    """Texture.getTexColor -> float32 [N,3] (texture.d; bitmap.d:48-63)."""
    if isinstance(tex, T.Checker):
        x = np.floor(u / tex.size).astype(np.int64)
        y = np.floor(v / tex.size).astype(np.int64)
        white = ((x + y) % 2).astype(bool)  # same squares as D's signed %2 (texture.d:48-53)
        c1 = np.asarray(tex.color1, dtype=np.float32)
        c2 = np.asarray(tex.color2, dtype=np.float32)
        return np.where(white[:, None], c2, c1)
    if isinstance(tex, T.Procedure2):
        out = np.zeros((u.shape[0], 3), dtype=np.float32)
        for i in range(3):
            cu = np.asarray(tex.colorU[i], dtype=np.float32)
            cv = np.asarray(tex.colorV[i], dtype=np.float32)
            out += cu * np.sin(u * tex.freqU[i])[:, None].astype(np.float32)
            out += cv * np.sin(v * tex.freqV[i])[:, None].astype(np.float32)
        return out
    if isinstance(tex, T.BitmapTexture):
        return _filtered_sample(tex.data, tex.scaling, u, v)
    raise TypeError(type(tex))


def _filtered_sample(img: np.ndarray, scaling: float, u, v):
    """Scaling + wrap + bilinear fetch (texture.d:116-126, bitmap.d:48-63)."""
    h, w = img.shape[:2]
    uu = u * scaling
    vv = v * scaling
    uu = uu - np.floor(uu)
    vv = vv - np.floor(vv)
    tx = uu.astype(np.float32) * w
    ty = vv.astype(np.float32) * h
    ix = np.floor(tx).astype(np.int64)
    iy = np.floor(ty).astype(np.int64)
    ix = np.clip(ix, 0, w - 1)  # guard float32 rounding to w exactly
    iy = np.clip(iy, 0, h - 1)
    ixn = (ix + 1) % w
    iyn = (iy + 1) % h
    p = (tx - ix).astype(np.float32)[:, None]
    q = (ty - iy).astype(np.float32)[:, None]
    return (
        img[iy, ix] * (1 - p) * (1 - q)
        + img[iy, ixn] * p * (1 - q)
        + img[iyn, ix] * (1 - p) * q
        + img[iyn, ixn] * p * q
    )


def modify_normal(tex: T.Texture, rec: HitRecord) -> None:
    """Texture.modifyNormal (texture.d:10-12): a no-op for every reference
    texture kind; the BumpTexture EXTENSION (models/types.py) perturbs the
    normal along the tangent frame by the differentiated bitmap's (dx, dy)
    sampled like getTexColor."""
    if not isinstance(tex, T.BumpTexture):
        return  # reference behavior: the base hook does nothing
    from ..imageio import differentiate

    deriv = getattr(tex, "_deriv", None)
    if deriv is None:
        deriv = differentiate(tex.data)
        tex._deriv = deriv
    d = _filtered_sample(deriv, tex.scaling, rec.u, rec.v)
    dn = (rec.dndx * d[:, 0:1] + rec.dndy * d[:, 1:2]) * tex.strength
    rec.normal = vec.normalize(rec.normal + dn)


# --------------------------------------------------------------------------
# Camera (camera.d:77-174)
# --------------------------------------------------------------------------


def begin_frame(cam: T.Camera):
    """Compute the screen-corner vectors; returns a dict of frame constants."""
    x, y = -cam.aspect, 1.0
    corner = np.array([x, y, 1.0])
    center = np.array([0.0, 0.0, 1.0])
    len_xy = np.linalg.norm(corner - center)
    wanted = np.tan(vec.radians(cam.fov / 2))
    scaling = wanted / len_xy
    x *= scaling
    y *= scaling
    rot = (
        vec.rotate_z(vec.radians(cam.roll))
        @ vec.rotate_x(vec.radians(cam.pitch))
        @ vec.rotate_y(vec.radians(cam.yaw))
    )
    pos = np.asarray(cam.pos, dtype=np.float64)
    f = {
        "up_left": vec.mul_vm(np.array([x, y, 1.0]), rot) + pos,
        "up_right": vec.mul_vm(np.array([-x, y, 1.0]), rot) + pos,
        "down_left": vec.mul_vm(np.array([x, -y, 1.0]), rot) + pos,
        "right_dir": vec.mul_vm(np.array([1.0, 0.0, 0.0]), rot),
        "up_dir": vec.mul_vm(np.array([0.0, 1.0, 0.0]), rot),
        "front_dir": vec.mul_vm(np.array([0.0, 0.0, 1.0]), rot),
        "pos": pos,
    }
    return f


def get_screen_rays(cam: T.Camera, frame, x, y, stereo_offset=0.0, rng=None):
    """getScreenRay vectorized over pixel coords (camera.d:119-174).
    stereo_offset: 0, -1 (left) or +1 (right); rng enables DoF jitter."""
    fx = (x / float(cam.frameWidth))[:, None]
    fy = (y / float(cam.frameHeight))[:, None]
    target = (
        frame["up_left"]
        + (frame["up_right"] - frame["up_left"]) * fx
        + (frame["down_left"] - frame["up_left"]) * fy
    )
    orig = np.broadcast_to(frame["pos"], target.shape).copy()
    dir = vec.normalize(target - frame["pos"])
    if stereo_offset:
        orig = orig + frame["right_dir"] * (stereo_offset * cam.stereoSeparation)
    if not cam.dof:
        return orig, dir
    cos_theta = vec.dot(dir, frame["front_dir"])
    M = cam.focalPlaneDist / cos_theta
    Tpt = orig + dir * M[:, None]
    angle = rng.uniform(0.0, 1.0, size=x.shape) * 2 * np.pi
    rad = np.sqrt(rng.uniform(0.0, 1.0, size=x.shape))
    dx = np.sin(angle) * rad * cam.discMultiplier
    dy = np.cos(angle) * rad * cam.discMultiplier
    orig = frame["pos"] + dx[:, None] * frame["right_dir"] + dy[:, None] * frame["up_dir"]
    if stereo_offset:
        orig = orig + frame["right_dir"] * (stereo_offset * cam.stereoSeparation)
    dir = vec.normalize(Tpt - orig)
    return orig, dir


# --------------------------------------------------------------------------
# Renderer
# --------------------------------------------------------------------------


class OracleRenderer:
    def __init__(
        self,
        scene: T.Scene,
        gi_multiplier_quirk: bool = True,
        gi_point_light_direct: bool = False,
        aa_adaptive: bool = False,
        seed: int = 0,
    ):
        self.scene = scene
        self.gi_multiplier_quirk = gi_multiplier_quirk
        # extension: standard NEE against point lights in GI, replacing the
        # reference's solidAngle==0 zero term (see pipeline trace_path)
        self.gi_point_light_direct = gi_point_light_direct
        # extension (GlobalSettings.adaptiveAA): resample only the pixels
        # the needs-AA detect flags, instead of the reference's
        # unconditional pass-4 resample (renderer.d:183-186 quirk)
        self.aa_adaptive = aa_adaptive or getattr(scene.settings, "adaptiveAA", False)
        self.rng = np.random.default_rng(seed)
        self.frame = begin_frame(scene.camera)

    # -- intersection ------------------------------------------------------

    def closest_hit(self, orig, dir):
        """The node-scan hot loop (renderer.d:336-338).  Returns (rec,
        node_idx) with node_idx == -1 for misses."""
        n = orig.shape[0]
        rec = HitRecord(n)
        win = np.full(n, -1, dtype=np.int64)
        for i, node in enumerate(self.scene.nodes):
            ok = intersect_node(node, orig, dir, rec)
            win = np.where(ok, i, win)
        return rec, win

    def test_visibility(self, from_p, to_p):
        """Scene.testVisibility (scene.d:62-78): True = unoccluded."""
        d = to_p - from_p
        dist = vec.length(d)
        dir = d / dist[:, None]
        rec = HitRecord(from_p.shape[0])
        rec.dist = dist.copy()
        occluded = np.zeros(from_p.shape[0], dtype=bool)
        for node in self.scene.nodes:
            occluded |= intersect_node(node, from_p, dir, rec)
        return ~occluded

    # -- shading (shader.d) ------------------------------------------------

    def _direct_light(self, ray_dir, rec: HitRecord, N, Ng=None):
        """The summed per-light direct term shared by Lambert and Phong.
        Returns (lambert_contrib, specular_base_terms) where specular terms
        are per-light (baseLight, cosGamma) pieces for Phong.

        ``Ng``: the GEOMETRIC faceforward normal for the shadow-ray origin
        offset when it differs from the shading normal N — the BumpTexture
        extension's convention: bump perturbs the SHADING normal only,
        visibility rays offset along the geometric surface (the standard
        production-renderer choice, and what the fused kernel's in-VMEM
        shadow scans do — they run before the XLA-side perturbation)."""
        n = ray_dir.shape[0]
        lam = np.zeros((n, 3), dtype=np.float64)
        per_light = []
        shade_from = rec.p + (N if Ng is None else Ng) * 1e-6
        for light in self.scene.lights:
            lp = np.asarray(light.pos, dtype=np.float64)
            lc = np.asarray(light.color, dtype=np.float32) * np.float32(light.power)
            if float(lc.mean()) == 0.0:  # lightColor.intensity() != 0 gate
                per_light.append((None, None, None))
                continue
            vis = self.test_visibility(shade_from, np.broadcast_to(lp, (n, 3)))
            to_light = lp - rec.p
            light_dir = vec.normalize(to_light)
            cos_theta = vec.dot(light_dir, N)
            base = lc[None, :] / vec.squared_length(to_light)[:, None]
            contrib = np.where((vis & (cos_theta > 0))[:, None], base * cos_theta[:, None], 0.0)
            lam += contrib  # 1 sample per point light; /numSamples is /1
            per_light.append((vis, base, light_dir))
        return lam, per_light

    def shade(self, shader: T.Shader, ray_dir, depth, rec: HitRecord, geom_normal=None):
        N = vec.faceforward(ray_dir, rec.normal)
        Ng = None if geom_normal is None else vec.faceforward(ray_dir, geom_normal)
        ambient = np.asarray(self.scene.settings.ambientLightColor, dtype=np.float64)

        if isinstance(shader, (T.Lambert, T.Phong)):
            tex = getattr(shader, "texture", None)
            diffuse = tex_color(tex, rec.u, rec.v).astype(np.float64) if tex is not None else np.broadcast_to(
                np.asarray(shader.color, dtype=np.float64), (ray_dir.shape[0], 3)
            )
            lam, per_light = self._direct_light(ray_dir, rec, N, Ng)
            light_contrib = ambient + lam
            if isinstance(shader, T.Lambert):
                return diffuse * light_contrib
            spec = np.zeros_like(lam)
            for vis, base, light_dir in per_light:
                if vis is None:
                    continue
                R = vec.reflect(-light_dir, N)
                cos_gamma = vec.dot(R, -ray_dir)
                s = base * (cos_gamma[:, None] ** shader.exponent) * shader.strength
                spec += np.where((vis & (cos_gamma > 0))[:, None], s, 0.0)
            return diffuse * light_contrib + spec

        if isinstance(shader, T.Reflection):
            # Framework extension (see models/types.py): perfect mirror.
            refl = ray_dir - 2.0 * vec.dot(ray_dir, N)[:, None] * N
            refl = vec.normalize(refl)
            sub = self.raytrace(rec.p + N * 1e-6, refl, depth + 1)
            return sub * np.asarray(shader.color, dtype=np.float64)

        if isinstance(shader, T.Refraction):
            # Framework extension: single-sided refraction with TIR fallback.
            cos_in = -vec.dot(ray_dir, rec.normal)
            entering = cos_in > 0
            eta = np.where(entering, 1.0 / shader.ior, shader.ior)
            n_face = np.where(entering[:, None], rec.normal, -rec.normal)
            ci = np.abs(cos_in)
            k = 1.0 - eta * eta * (1.0 - ci * ci)
            tir = k < 0
            refr = eta[:, None] * ray_dir + (eta * ci - np.sqrt(np.maximum(k, 0.0)))[:, None] * n_face
            refl = vec.normalize(ray_dir - 2.0 * vec.dot(ray_dir, n_face)[:, None] * n_face)
            out_dir = np.where(tir[:, None], refl, vec.normalize(refr))
            out_orig = np.where(tir[:, None], rec.p + n_face * 1e-6, rec.p - n_face * 1e-6)
            sub = self.raytrace(out_orig, out_dir, depth + 1)
            return sub * np.asarray(shader.color, dtype=np.float64)

        raise TypeError(type(shader))

    # -- tracing (renderer.d:325-463) --------------------------------------

    def raytrace(self, orig, dir, depth=0):
        """Whitted trace; returns float [N,3] colors (renderer.d:325-376)."""
        n = orig.shape[0]
        if depth > self.scene.settings.maxTraceDepth:
            return np.zeros((n, 3))
        rec, win = self.closest_hit(orig, dir)
        # lights never claim hits (PointLight.intersect is false, light.d:67-70)
        out = np.zeros((n, 3))
        miss = win < 0
        # miss -> black (environment.d:5-15) or the cubemap skybox extension
        if miss.any() and self.scene.environment.cubemap is not None:
            out[miss] = sample_cubemap_np(self.scene.environment.cubemap, dir[miss])
        for i, node in enumerate(self.scene.nodes):
            m = win == i
            if not m.any():
                continue
            sub_rec = HitRecord(int(m.sum()))
            for f in ("p", "normal", "dndx", "dndy"):
                setattr(sub_rec, f, getattr(rec, f)[m])
            sub_rec.dist, sub_rec.u, sub_rec.v = rec.dist[m], rec.u[m], rec.v[m]
            # bump hook site (renderer.d:370-372): no-op for reference
            # textures, real for the BumpTexture extension.  The geometric
            # normal is kept for the shadow-origin offset (_direct_light).
            geom_normal = None
            if node.bumpmap is not None:
                geom_normal = sub_rec.normal
                modify_normal(node.bumpmap, sub_rec)
            out[m] = self.shade(node.shader, dir[m], depth, sub_rec, geom_normal)
        return out

    def pathtrace(self, orig, dir, depth=0, flags_diffuse=None, multiplier=None):
        """GI path trace (renderer.d:378-463).  With gi_multiplier_quirk the
        multiplier is reset to 1 at every level, like the reference."""
        n = orig.shape[0]
        if flags_diffuse is None:
            flags_diffuse = np.zeros(n, dtype=bool)
        if multiplier is None:
            multiplier = np.ones((n, 3))
        if self.gi_multiplier_quirk:
            multiplier = np.ones((n, 3))  # renderer.d:356 drops the multiplier
        if depth > self.scene.settings.maxTraceDepth:
            return np.zeros((n, 3))
        rec, win = self.closest_hit(orig, dir)
        out = np.zeros((n, 3))
        # miss -> environment * multiplier (renderer.d:396-397); black default,
        # cubemap skybox extension.  Mirrors render/pipeline.py trace_path.
        miss = win < 0
        if miss.any() and self.scene.environment.cubemap is not None:
            mult_eff = np.ones((n, 3)) if self.gi_multiplier_quirk else multiplier
            out[miss] = mult_eff[miss] * sample_cubemap_np(
                self.scene.environment.cubemap, dir[miss]
            )
        # (PointLight cannot be hit, so the hitLight branch never fires.)
        for i, node in enumerate(self.scene.nodes):
            m = win == i
            if not m.any():
                continue
            if isinstance(node.shader, T.Phong):
                # Phong's BRDF eval/spawnRay assert(0) in the reference
                # (shader.d:252-261): a GI path that SAMPLES one aborts a
                # debug build, while a scene merely containing the node
                # renders fine.  Renderable equivalent: the engine's own
                # bogus-BRDF marker (renderer.d:457, pdf < 0 => Color(1,
                # 0, 0)) — solid red, UNSCALED (the reference's marker
                # return bypasses the multiplier weighting), terminating
                # the path.  Mirrors render/pipeline.trace_path.
                out[m] = np.array([1.0, 0.0, 0.0])
                continue
            if not isinstance(node.shader, T.Lambert):
                raise NotImplementedError(
                    f"GI needs BRDF eval/spawnRay; {type(node.shader).__name__} has none "
                    "(extension shaders have none)"
                )
            out[m] = self._pathtrace_lambert(
                node.shader, dir[m], depth, _subset(rec, m), flags_diffuse[m], multiplier[m]
            )
        return out

    def _pathtrace_lambert(self, shader, ray_dir, depth, rec, was_diffuse, multiplier):
        n = ray_dir.shape[0]
        N = vec.faceforward(ray_dir, rec.normal)
        tex = shader.texture
        diffuse = tex_color(tex, rec.u, rec.v).astype(np.float64) if tex is not None else np.broadcast_to(
            np.asarray(shader.color, dtype=np.float64), (n, 3)
        ).copy()

        # direct: explicit light sampling.  PointLight.solidAngle == 0
        # (light.d:72-75) makes this term identically zero — preserved
        # unless the NEE extension is enabled (gi_point_light_direct).
        result_direct = np.zeros((n, 3))
        lights = self.scene.lights
        if lights and not self.gi_point_light_direct:
            li = self.rng.integers(0, len(lights), size=n)
            for idx, light in enumerate(lights):
                m = li == idx
                if not m.any() or light.power == 0:
                    continue
                # solidAngle == 0 => contribution 0; keep the computation shape
                result_direct[m] += 0.0
        elif lights:
            mult_eff = np.ones((n, 3)) if self.gi_multiplier_quirk else multiplier
            shade_from = rec.p + N * 1e-6
            for light in lights:
                lp = np.asarray(light.pos, dtype=np.float64)
                lc = np.asarray(light.color, dtype=np.float64) * light.power
                vis = self.test_visibility(shade_from, np.broadcast_to(lp, (n, 3)))
                to_light = lp - rec.p
                ld = vec.normalize(to_light)
                brdf = diffuse * (1 / np.pi) * np.maximum(0.0, vec.dot(ld, N))[:, None]
                term = lc * brdf / vec.squared_length(to_light)[:, None]
                result_direct += np.where(vis[:, None], mult_eff * term, 0.0)

        # indirect: BRDF-sampled continuation (Lambert.spawnRay, shader.d:118-135)
        u = self.rng.uniform(0.0, 1.0, size=n)
        v = self.rng.uniform(0.0, 1.0, size=n)
        theta = 2 * np.pi * u
        phi = np.arccos(2 * v - 1) - np.pi / 2
        w = np.stack([np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)], axis=-1)
        w = np.where(vec.dot(w, N)[:, None] < 0, -w, w)
        color_eval = diffuse * (1 / np.pi) * np.maximum(0.0, vec.dot(w, N))[:, None]
        pdf = 1 / (2 * np.pi)
        sub = self.pathtrace(
            rec.p + N * 1e-6,
            w,
            depth + 1,
            np.ones(n, dtype=bool),
            multiplier * color_eval / pdf,
        )
        # Non-quirk mode: throughput is carried via the multiplier argument
        # (the child's direct/miss terms are already weighted by the full
        # path product), so the returned sub must NOT be reweighted here —
        # doing so squares the per-bounce attenuation.  The quirk mode drops
        # the multiplier entirely (renderer.d:356), so the sum is unweighted
        # either way.
        return result_direct + sub

    # -- per-pixel sampling dispatch (renderer.d:254-313) ------------------

    def render_samples(self, x, y, dx=1, dy=1):
        """renderSample for a batch of pixel coords; x, y may be fractional."""
        cam, s = self.scene.camera, self.scene.settings
        if cam.dof:
            acc = np.zeros((x.shape[0], 3))
            for _ in range(cam.numSamples):
                jx = x + self.rng.uniform(0.0, 1.0, size=x.shape) * dx
                jy = y + self.rng.uniform(0.0, 1.0, size=y.shape) * dy
                if cam.stereoSeparation == 0:
                    o, d = get_screen_rays(cam, self.frame, jx, jy, rng=self.rng)
                    acc += self.raytrace(o, d)
                else:
                    ol, dl = get_screen_rays(cam, self.frame, jx, jy, -1.0, rng=self.rng)
                    orr, drr = get_screen_rays(cam, self.frame, jx, jy, +1.0, rng=self.rng)
                    acc += combine_stereo(
                        self.raytrace(ol, dl).astype(np.float32), self.raytrace(orr, drr).astype(np.float32)
                    )
            return acc / cam.numSamples
        if s.GIEnabled:
            acc = np.zeros((x.shape[0], 3))
            for _ in range(s.pathsPerPixel):
                jx = x + self.rng.uniform(0.0, 1.0, size=x.shape) * dx
                jy = y + self.rng.uniform(0.0, 1.0, size=y.shape) * dy
                o, d = get_screen_rays(cam, self.frame, jx, jy)
                acc += self.pathtrace(o, d)
            return acc / s.pathsPerPixel
        if cam.stereoSeparation == 0:
            o, d = get_screen_rays(cam, self.frame, x, y)
            return self.raytrace(o, d)
        ol, dl = get_screen_rays(cam, self.frame, x, y, -1.0)
        orr, drr = get_screen_rays(cam, self.frame, x, y, +1.0)
        return combine_stereo(self.raytrace(ol, dl).astype(np.float32), self.raytrace(orr, drr).astype(np.float32))

    # -- full frame (renderer.d:83-189) ------------------------------------

    def render(self) -> np.ndarray:
        """3-pass render: 1 ray/pixel, AA-detect, AA-resample.  The coarse
        prepass (renderer.d:110-127) is display-only — pass 2 overwrites
        every pixel — so it is skipped here.  Returns float64 [H, W, 3]."""
        s = self.scene.settings
        W, H = s.frameWidth, s.frameHeight
        ys, xs = np.mgrid[0:H, 0:W]
        xf = xs.reshape(-1).astype(np.float64)
        yf = ys.reshape(-1).astype(np.float64)

        img = self.render_samples(xf, yf).reshape(H, W, 3)

        if not s.AAEnabled:
            return img

        # AA-detect (renderer.d:150-178): 5-point neighbourhood average in
        # float32 like the reference's Color accumulation.
        f32 = img.astype(np.float32)
        neighs = [
            f32,
            np.concatenate([f32[:, :1], f32[:, :-1]], axis=1),  # x-1 (clamped)
            np.concatenate([f32[:, 1:], f32[:, -1:]], axis=1),  # x+1
            np.concatenate([f32[:1, :], f32[:-1, :]], axis=0),  # y-1
            np.concatenate([f32[1:, :], f32[-1:, :]], axis=0),  # y+1
        ]
        avg = sum(neighs) / np.float32(5.0)
        needs_aa = np.zeros((H, W), dtype=bool)
        for nb in neighs:
            needs_aa |= too_different(nb, avg)  # default 0.1 threshold (quirk)

        # AA-resample (renderer.d:233-251): 4 extra kernel samples, avg of 5.
        # NB the reference resamples EVERY pixel in pass 4 (renderPixelAA is
        # called unconditionally, renderer.d:183-186) — needsAA is computed
        # but never read!  Default: preserve that quirk, resample everything.
        # aa_adaptive (extension): honor the mask — only flagged pixels get
        # the 4 extra taps; the rest keep their pass-2 sample.
        kernel = [(0.3, 0.3), (0.6, 0.0), (0.0, 0.6), (0.6, 0.6)]
        if self.aa_adaptive:
            sel = np.nonzero(needs_aa.reshape(-1))[0]
            out = img.reshape(-1, 3).copy()
            acc = out[sel].copy()
            for kx, ky in kernel:
                acc += self.render_samples(xf[sel] + kx, yf[sel] + ky)
            out[sel] = acc / 5.0
            return out.reshape(H, W, 3)
        acc = img.reshape(-1, 3).copy()
        for kx, ky in kernel:
            acc += self.render_samples(xf + kx, yf + ky)
        return (acc / 5.0).reshape(H, W, 3)

    def render_u8(self) -> np.ndarray:
        return srgb_u8(self.render().astype(np.float32))


def sample_cubemap_np(cubemap: np.ndarray, dir: np.ndarray) -> np.ndarray:
    """NumPy mirror of ops/env.py sample_cubemap (same face layout/filter)."""
    x, y, z = dir[:, 0], dir[:, 1], dir[:, 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = np.where(is_x, np.where(x > 0, 0, 1),
                    np.where(is_y, np.where(y > 0, 2, 3), np.where(z > 0, 4, 5))).astype(np.int64)
    ma = np.where(is_x, ax, np.where(is_y, ay, az))
    sc = np.where(is_x, np.where(x > 0, -z, z), np.where(is_y, x, np.where(z > 0, x, -x)))
    tc = np.where(is_x, -y, np.where(is_y, np.where(y > 0, z, -z), -y))
    s = (sc / ma + 1.0) * 0.5
    t = (tc / ma + 1.0) * 0.5
    size = cubemap.shape[1]
    fx = s * (size - 1)
    fy = t * (size - 1)
    x0 = np.clip(np.floor(fx), 0, size - 1).astype(np.int64)
    y0 = np.clip(np.floor(fy), 0, size - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, size - 1)
    y1 = np.minimum(y0 + 1, size - 1)
    p = (fx - x0)[:, None]
    q = (fy - y0)[:, None]
    return (
        cubemap[face, y0, x0] * (1 - p) * (1 - q)
        + cubemap[face, y0, x1] * p * (1 - q)
        + cubemap[face, y1, x0] * (1 - p) * q
        + cubemap[face, y1, x1] * p * q
    )


def _subset(rec: HitRecord, m) -> HitRecord:
    out = HitRecord(int(m.sum()))
    for f in ("p", "normal", "dndx", "dndy"):
        setattr(out, f, getattr(rec, f)[m])
    out.dist, out.u, out.v = rec.dist[m], rec.u[m], rec.v[m]
    return out


def render_scene(scene: T.Scene, seed: int = 0) -> np.ndarray:
    """Convenience wrapper: full-frame oracle render -> float [H,W,3]."""
    return OracleRenderer(scene, seed=seed).render()
