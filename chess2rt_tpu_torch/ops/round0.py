"""The fused round-0 ray kernel (K1): layout, plain version, CUDA wrapper.

Counterpart of the kernel half of chess2rt_tpu/ops/pallas_trace.py
(``build_round0_kernel`` and ``_make_packer``).  One call traces one ray
per lane through a whole Whitted round: pinhole ray-gen (screen-tap form,
or the lin-input form for a contiguous slice of the frame's pixels) or
caller rays (ray-input form), closest hit over every node (plane /
sphere / cube leaves, offset and full-matrix transforms, CSG union / inter
/ diff as fixed-capacity all-hits lists), faceforward, per-node material
select with in-kernel checker and procedure2, a dist-only shadow scan per
light, Lambert/Phong direct + ambient, and the reflection / refraction
continuation.  Bitmap texels stay deferred: the call emits (win, u, v) and
the light sum, and ops/shade.py gathers the texels.

* ``make_packer`` builds the flat f32 parameter vector in exactly the
  Pallas kernel's SMEM layout.
* ``scene_program`` encodes the scene's STRUCTURE (per-node transform kind,
  postfix geometry expression, CSG compare-exchange networks, shader and
  texture kinds) as a small int32 table: the one compiled CUDA kernel
  (csrc/round0.cu) walks it, so no scene needs its own build.
* ``round0_reference`` is the plain PyTorch version: the Pallas body
  transliterated onto [N] tensors, with the same Python-unrolled node loops
  and compare-exchange networks.
* ``round0`` is the wrapper: the CUDA kernel for CUDA tensors, the plain
  version for CPU tensors, nothing else.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.packed import (
    LAMBERT,
    PHONG,
    REFLECTION,
    REFRACTION,
    TEX_BITMAP,
    TEX_CHECKER,
    TEX_NONE,
    TEX_PROC2,
    ScenePacked,
    SceneStatic,
)
from .camera import begin_frame
from ..utils.spans import span

# lane granularity the JAX package pads to (its (8, 128) tile); kept for the
# bounce-capacity rounding, which both packages must share to take the same
# block/overflow branch (ops/flagship.py)
TILE_N = 8 * 128
# bounce_mode="block" compaction granularity (pallas_trace.BOUNCE_BLOCK)
BOUNCE_BLOCK = 128
INF = 1e30
EPS_SHADOW = 1e-3  # f32 self-intersection offset (ops/shade.shadow_eps)

# kernel launches made by ``round0`` (the CUDA path only): every launch,
# those of them that also wrote the residual rows (want_hit / want_vis),
# those with want_hit alone (the GI form), and those in the ray-input and in
# the lin-input form; chip_smoke.py zeroes them before driving a path and
# reads them after
launches = 0
resid_launches = 0
hit_launches = 0
ray_launches = 0
lin_launches = 0


def supports(static: SceneStatic) -> bool:
    """True when the fused Whitted path (ops/flagship.py) covers this scene
    and sampling mode (the JAX package's ``pallas_trace.supports``).  GI
    scenes go through the fused GI renderer instead (``supports_gi``)."""
    if static.gi_enabled:
        return False
    return _supports_scene(static)


def supports_gi(static: SceneStatic) -> bool:
    """True when the fused GI renderer (ops/gi.py, K1's want_hit ray-input
    form per bounce) covers this scene (the JAX package's
    ``pallas_trace.supports_gi``): GI on without DoF (DoF dispatches
    first), compensated ray-gen off, every shader Lambert.  A scene with a
    Phong node takes the twin's ``trace_path``, which paints the
    reference's red marker on the paths that hit it."""
    if not static.gi_enabled or static.dof:
        return False
    return _supports_scene(static) and all(ns.shader_kind == LAMBERT for ns in static.nodes)


def _supports_scene(static: SceneStatic) -> bool:
    if not static.nodes:
        return False
    if static.compensated_raygen:
        return False
    for ns in static.nodes:
        if ns.shader_kind not in (LAMBERT, PHONG, REFLECTION, REFRACTION):
            return False
        if ns.tex_kind not in (TEX_NONE, TEX_CHECKER, TEX_PROC2, TEX_BITMAP):
            return False
    return True


# --------------------------------------------------------------------------
# Polynomial atan2 / asin (the Pallas kernel's; csrc/round0.cu has the same)
# --------------------------------------------------------------------------

# Cephes atanf minimax coefficients (public-domain constants)
_AT0 = -3.33329491539e-1
_AT1 = 1.99777106478e-1
_AT2 = -1.38776856032e-1
_AT3 = 8.05374449538e-2
_TAN_PI_8 = 0.4142135623730951
_PI = float(np.pi)


def _atan01(t):
    """atan(t) for t in [0, 1] via one range reduction at tan(pi/8)."""
    red = t > _TAN_PI_8
    tr = torch.where(red, (t - 1.0) / (t + 1.0), t)
    z = tr * tr
    p = tr + tr * z * (((_AT3 * z + _AT2) * z + _AT1) * z + _AT0)
    return torch.where(red, _PI / 4 + p, p)


def atan2_poly(y, x):
    """Quadrant-correct atan2 from the [0,1] core (octant reduction)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = _atan01(lo / torch.clamp_min(hi, 1e-30))
    a = torch.where(ay > ax, _PI / 2 - a, a)
    a = torch.where(x < 0, _PI - a, a)
    return torch.where(y < 0, -a, a)


def asin_poly(x):
    x = torch.clamp(x, -1.0, 1.0)
    return atan2_poly(x, torch.sqrt(torch.clamp_min((1.0 - x) * (1.0 + x), 0.0)))


def _needs_uv(ns) -> bool:
    """A node's records carry UVs when it is textured or bump-mapped."""
    return ns.tex_kind != TEX_NONE or ns.bump_idx >= 0


def _rsqrt(x):
    return torch.rsqrt(torch.clamp_min(x, 1e-30))


def _oddeven_pairs(n: int):
    """Batcher odd-even mergesort compare-exchange pairs for n slots
    (chess2rt_tpu/ops/geometry._oddeven_pairs): the same network in both
    packages keeps tie order, and the records of missed slots, identical."""
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

    n2 = 1
    while n2 < n:
        n2 *= 2
    sort(0, n2)
    return [(i, j) for (i, j) in pairs if i < n and j < n]


# --------------------------------------------------------------------------
# Parameter layout (pallas_trace._make_packer)
# --------------------------------------------------------------------------


def exact_lane_base(lin_base) -> int:
    """``lin_base`` as an int, refused unless the parameter vector's f32
    lin slot holds it exactly (the kernel reads the base back from there)."""
    base = int(lin_base)
    if base != lin_base or base < 0 or base >= 2**31 or int(np.float32(base)) != base:
        raise ValueError(f"round0: lane base {lin_base} is not a non-negative integer that f32 holds exactly")
    return base


def make_packer(static: SceneStatic, width: int, height: int):
    """Computes the flat parameter-vector layout for this scene structure.

    Returns (pack, off, expr_tables, n_prm): pack(packed, aa_offset=(0, 0),
    lin_base=0) -> flat f32 tensor on the scene's device, off maps slot
    names to offsets, expr_tables[i] is node i's geometry expression with
    leaves rewritten to ("plane"|"sphere"|"cube", param_offset).  Same
    slots, order and values as the JAX package's _make_packer."""
    entries = []  # (name, size, getter(packed, frame, aa_offset))
    off = {}

    def slot(name, size, getter):
        off[name] = sum(e[1] for e in entries)
        entries.append((name, size, getter))
        return off[name]

    # camera deltas shipped UNscaled; the kernel divides by width/height
    # itself so the op sequence matches ops/camera.screen_rays
    slot(
        "cam",
        12,
        lambda p, f, a: torch.cat(
            [
                f["up_left_rel"],
                f["up_right_rel"] - f["up_left_rel"],
                f["down_left_rel"] - f["up_left_rel"],
                f["pos"],
            ]
        ),
    )
    slot("ambient", 3, lambda p, f, a: p.ambient)
    slot(
        "aa", 2,
        lambda p, f, a: torch.as_tensor(a, dtype=torch.float32, device=p.device).reshape(2),
    )
    # base linear pixel index of lane 0 (0 for full frames; the lin-input
    # form's slice base).  The kernel reads it back as an int, so pack()
    # refuses a base that f32 does not hold exactly (every multiple of 128
    # below 2^31 is exact; an 8K frame's shard bases lie above 2^24)
    slot("lin", 1, None)
    for li in range(static.n_lights):
        slot(
            f"light{li}",
            6,
            lambda p, f, a, li=li: torch.cat([p.light_pos[li], p.light_color[li] * p.light_power[li]]),
        )

    def _expr_offsets(expr, i, counter):
        kind = expr[0]
        if kind == "csg":
            left = _expr_offsets(expr[2], i, counter)
            right = _expr_offsets(expr[3], i, counter)
            return ("csg", expr[1], left, right)
        k = counter[0]
        counter[0] += 1
        name = f"n{i}_g{k}"
        gi = expr[1]
        if kind == "plane":
            o = slot(name, 2, lambda p, f, a, gi=gi: torch.stack([p.plane_y[gi], p.plane_limit[gi]]))
        elif kind == "sphere":
            o = slot(
                name, 4,
                lambda p, f, a, gi=gi: torch.cat([p.sphere_center[gi], p.sphere_r[gi][None]]),
            )
        else:
            o = slot(
                name, 4,
                lambda p, f, a, gi=gi: torch.cat([p.cube_center[gi], p.cube_side[gi][None]]),
            )
        return (kind, o)

    expr_tables = []
    for i, ns in enumerate(static.nodes):
        if not ns.identity_transform:
            if ns.offset_only:
                slot(f"n{i}_off", 3, lambda p, f, a, i=i: p.node_offset[i])
            else:
                # m, inv(m), offset.  inv_ex: no error check, so no host
                # sync on CUDA (a singular transform is a broken scene)
                slot(
                    f"n{i}_mtx",
                    21,
                    lambda p, f, a, i=i: torch.cat(
                        [
                            p.node_matrix[i].reshape(-1),
                            torch.linalg.inv_ex(p.node_matrix[i])[0].reshape(-1),
                            p.node_offset[i],
                        ]
                    ),
                )
        slot(
            f"n{i}_mat",
            6,
            lambda p, f, a, i=i: torch.cat(
                [p.mat_color[i], p.mat_exponent[i][None], p.mat_strength[i][None], p.mat_ior[i][None]]
            ),
        )
        if ns.tex_kind == TEX_CHECKER:
            slot(
                f"n{i}_tex",
                7,
                lambda p, f, a, i=i: torch.cat([p.checker_c1[i], p.checker_c2[i], p.checker_size[i][None]]),
            )
        elif ns.tex_kind == TEX_PROC2:
            slot(
                f"n{i}_tex",
                24,
                lambda p, f, a, i=i: torch.cat(
                    [
                        p.proc2_color_u[i].reshape(-1),
                        p.proc2_color_v[i].reshape(-1),
                        p.proc2_freq_u[i],
                        p.proc2_freq_v[i],
                    ]
                ),
            )
        counter = [0]
        expr_tables.append(_expr_offsets(ns.geom, i, counter))

    n_prm = sum(e[1] for e in entries)

    def pack(packed: ScenePacked, aa_offset=(0.0, 0.0), lin_base=0):
        lin_base = exact_lane_base(lin_base)
        frame = begin_frame(packed.camera, width / height)
        parts = []
        for name, _, g in entries:
            if name == "lin":
                parts.append(torch.tensor([float(lin_base)], dtype=torch.float32, device=packed.device))
            else:
                parts.append(g(packed, frame, aa_offset))
        return torch.cat([x.reshape(-1).to(torch.float32) for x in parts])

    return pack, off, expr_tables, n_prm


# --------------------------------------------------------------------------
# Scene program (the int32 structure table csrc/round0.cu walks)
# --------------------------------------------------------------------------

# header slots; keep in sync with the H_* constants in csrc/round0.cu
PROGRAM_VERSION = 5
(H_VERSION, H_NODES, H_LIGHTS, H_CAM, H_AMBIENT, H_AA, H_LIN, H_FLAGS,
 H_LIGHT_TAB, H_NODE_TAB, H_INSTR_TAB, H_PAIR_TAB, H_DIFF_TAB, H_LIST_CAP) = range(14)
HEADER = 16
# The kernel keeps the program and the parameter vector in a block's shared
# memory: the two tables together may hold this many bytes
MAX_TABLE_BYTES = 200 * 1024
# what a block may have of an H100's shared memory, and K1's threads per block
SHARED_BLOCK_BYTES = 227 * 1024
BLOCK_THREADS = 128
NODE_STRIDE = 10
INSTR_STRIDE = 8
# the hit tags' instruction fields (csrc/round0.cu TAG_BITS): a node's
# instructions must number fewer than TAG_KEPT, which 200 KB of tables
# cannot hold anyway (8191 instructions take 262 KB)
TAG_BITS = 13
TAG_KEPT = (1 << TAG_BITS) - 1
# flags; F_HIT / F_VIS add the residual rows (want_hit / want_vis); F_UV says
# that some node's records carry UVs (read by the scan stage probe only)
F_PHONG, F_REFR, F_EMIT_L, F_CONT, F_HIT, F_VIS, F_UV = 1, 2, 4, 8, 16, 32, 64
# transform kinds, leaf/CSG opcodes, CSG ops
X_IDENT, X_OFFSET, X_MATRIX = 0, 1, 2
OP_PLANE, OP_SPHERE, OP_CUBE, OP_CSG = 0, 1, 2, 3
CSG_OPS = {"union": 0, "inter": 1, "diff": 2}


def check_table_bytes(n_prog: int, n_prm: int) -> int:
    """Bytes of the two scene tables; refuses a scene whose tables do not
    fit in a block's shared memory."""
    n_bytes = 4 * (n_prog + n_prm)
    if n_bytes > MAX_TABLE_BYTES:
        raise ValueError(
            f"round0: the scene program ({n_prog} words) and parameters ({n_prm} words) take {n_bytes} bytes, "
            f"more than the {MAX_TABLE_BYTES} the kernel keeps in shared memory"
        )
    return n_bytes


def scene_program(static: SceneStatic, off: dict, expr_tables, n_prm: int, want_hit=False,
                  want_vis=False) -> np.ndarray:
    """Encode the scene's structure as an int32 table (layout in
    csrc/round0.cu): a header, one NODE_STRIDE record per node, the
    geometry expressions as postfix instructions, the compare-exchange
    pairs of every CSG merge, and the diff table.  Parameters stay in the
    packer's f32 vector (``n_prm`` words); this table only says where they
    are and what to do with them.  The flags also select the output rows,
    the residual ones included.  A leaf instruction points at its list in
    the diff table: the CsgDiff merges above it, as instruction indices
    relative to its node's first, ascending.  The kernel replays their
    normal flips for the one hit it builds a record of.  The header's list
    capacity is the longest hit list of any node: the slots a lane's CSG
    lists need (``list_placement``)."""
    instrs = []
    pairs = []
    leaf_diffs = {}  # leaf instruction -> the CsgDiff instructions above it

    def emit(expr, start):
        """Postfix emission; returns the number of hits the expression yields."""
        kind = expr[0]
        if kind != "csg":
            leaf_diffs[len(instrs)] = []
            instrs.append([{"plane": OP_PLANE, "sphere": OP_SPHERE, "cube": OP_CUBE}[kind],
                           expr[1], 0, 0, 0, 0, 0, 0])
            return 1 if kind == "plane" else 2
        _, op, left, right = expr
        l_start = len(instrs)
        n_l = emit(left, start)
        r_start = len(instrs)
        n_r = emit(right, start)
        r_end = len(instrs)
        net = _oddeven_pairs(n_l + n_r)
        instrs.append([OP_CSG, CSG_OPS[op], r_start, r_end, len(pairs), len(net), n_l, n_r])
        pairs.extend(net)
        if op == "diff":
            for k in range(l_start, r_end):
                if k in leaf_diffs:
                    leaf_diffs[k].append(r_end - start)
        return n_l + n_r

    nodes = []
    for i, ns in enumerate(static.nodes):
        start = len(instrs)
        nh = emit(expr_tables[i], start)
        if len(instrs) - start >= TAG_KEPT:
            raise ValueError(f"node {i}: {len(instrs) - start} instructions exceed the hit tags' {TAG_KEPT - 1}")
        if ns.identity_transform:
            xk, xo = X_IDENT, 0
        elif ns.offset_only:
            xk, xo = X_OFFSET, off[f"n{i}_off"]
        else:
            xk, xo = X_MATRIX, off[f"n{i}_mtx"]
        nodes.append([xk, xo, off[f"n{i}_mat"], ns.shader_kind, ns.tex_kind,
                      off.get(f"n{i}_tex", -1), int(_needs_uv(ns)), start, len(instrs) - start, nh])

    flags = 0
    kinds = static.shader_kinds_present
    if PHONG in kinds:
        flags |= F_PHONG
    if REFRACTION in kinds:
        flags |= F_REFR
    if TEX_BITMAP in static.tex_kinds_present or want_hit:
        flags |= F_EMIT_L
    if kinds & {REFLECTION, REFRACTION}:
        flags |= F_CONT
    if want_hit:
        flags |= F_HIT
    if want_vis:
        flags |= F_VIS
    if any(_needs_uv(ns) for ns in static.nodes):
        flags |= F_UV

    lights = [off[f"light{li}"] for li in range(static.n_lights)]
    light_tab = HEADER
    node_tab = light_tab + len(lights)
    instr_tab = node_tab + NODE_STRIDE * len(nodes)
    pair_tab = instr_tab + INSTR_STRIDE * len(instrs)
    diff_tab = pair_tab + 2 * len(pairs)
    diffs = []
    for k, above in leaf_diffs.items():
        # each merge was appended after the leaves below it: ascending
        instrs[k][2], instrs[k][3] = diff_tab + len(diffs), len(above)
        diffs.extend(above)
    head = [0] * HEADER
    head[H_VERSION] = PROGRAM_VERSION
    head[H_NODES] = len(nodes)
    head[H_LIGHTS] = static.n_lights
    head[H_CAM] = off["cam"]
    head[H_AMBIENT] = off["ambient"]
    head[H_AA] = off["aa"]
    head[H_LIN] = off["lin"]
    head[H_FLAGS] = flags
    head[H_LIGHT_TAB] = light_tab
    head[H_NODE_TAB] = node_tab
    head[H_INSTR_TAB] = instr_tab
    head[H_PAIR_TAB] = pair_tab
    head[H_DIFF_TAB] = diff_tab
    head[H_LIST_CAP] = max(nd[-1] for nd in nodes) if nodes else 1
    flat = head + lights + sum(nodes, []) + sum(instrs, []) + [x for pr in pairs for x in pr] + diffs
    check_table_bytes(len(flat), n_prm)
    return np.asarray(flat, dtype=np.int32)


def list_placement(program: np.ndarray, n_prm: int) -> str:
    """Where K1 keeps a lane's CSG hit lists for this scene: "shared" when the
    two tables and the lists of a block's 128 threads (the header's list
    capacity of slots, a distance and a tag each) fit in the
    ``SHARED_BLOCK_BYTES`` a block may have, else "global" (a scratch
    [2 * capacity, n] the wrapper allocates)."""
    lists = 8 * int(program[H_LIST_CAP]) * BLOCK_THREADS
    return "shared" if 4 * (program.size + n_prm) + lists <= SHARED_BLOCK_BYTES else "global"


# --------------------------------------------------------------------------
# Layout: everything about one (scene structure, frame size)
# --------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class Round0Layout:
    static: SceneStatic
    width: int
    height: int
    pack: Callable
    off: Dict[str, int]
    expr_tables: Tuple
    n_prm: int
    program: np.ndarray
    names: Tuple[str, ...]  # float output rows, in order ("win" is separate)
    emit_L: bool
    has_cont: bool
    want_hit: bool = False
    want_vis: bool = False

    @property
    def residual(self) -> bool:
        return self.want_hit or self.want_vis

    def program_on(self, device) -> torch.Tensor:
        return _program_tensor(self, torch.device(device))


@functools.lru_cache(maxsize=64)
def _program_tensor(lay: Round0Layout, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(lay.program).to(device)


@functools.lru_cache(maxsize=64)
def layout(static: SceneStatic, width: int, height: int, want_hit: bool = False,
           want_vis: bool = False) -> Round0Layout:
    """The round-0 layout of a scene structure at a frame size (cached by
    the hashable SceneStatic, like the JAX package's kernel builds).

    ``want_hit`` adds the rows t, nx, ny, nz (the winning hit's distance
    and raw, pre-faceforward normal) and dr, dg, db (the in-kernel diffuse
    color), and turns on the light-sum and u, v rows; ``want_vis`` adds one
    0/1 shadow-visibility row per light.  Row order is the JAX kernel's
    (pallas_trace.py:1039-1052)."""
    if not _supports_scene(static):
        raise ValueError("round0: the fused kernel does not cover this scene (see supports())")
    pack, off, expr_tables, n_prm = make_packer(static, width, height)
    emit_L = TEX_BITMAP in static.tex_kinds_present or want_hit
    has_cont = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    names = ["r", "g", "b"]
    if emit_L:
        names += ["lr", "lg", "lb", "u", "v"]
    if has_cont:
        names += ["rox", "roy", "roz", "rdx", "rdy", "rdz"]
    if want_hit:
        names += ["t", "nx", "ny", "nz", "dr", "dg", "db"]
    if want_vis:
        names += [f"vis{li}" for li in range(static.n_lights)]
    return Round0Layout(
        static=static, width=width, height=height, pack=pack, off=off,
        expr_tables=tuple(expr_tables), n_prm=n_prm,
        program=scene_program(static, off, expr_tables, n_prm, want_hit, want_vis),
        names=tuple(names), emit_L=emit_L, has_cont=has_cont,
        want_hit=want_hit, want_vis=want_vis,
    )


# --------------------------------------------------------------------------
# The plain PyTorch version (the Pallas body on [N] tensors)
# --------------------------------------------------------------------------


def _sel(m, a, b):
    """where(m, a, b) over two record dicts."""
    return {k: torch.where(m, a[k], b[k]) for k in a}


def _ce_sort(hits, key="t"):
    """In-place compare-exchange sort of a list of record dicts."""
    for i, j in _oddeven_pairs(len(hits)):
        swap = hits[i][key] > hits[j][key]
        hi, hj = hits[i], hits[j]
        hits[i] = _sel(swap, hj, hi)
        hits[j] = _sel(swap, hi, hj)
    return hits


def _bool_op(op, il, ir):
    if op == "union":
        return il | ir
    if op == "inter":
        return il & ir
    return il & ~ir  # diff


def _geom_builders(p):
    """Geometry on [N] SoA tensors, closed over the parameter reader ``p``
    (mirrors pallas_trace._geom_builders)."""

    def plane_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        y0, limit = p(b), p(b + 1)
        miss = ((oy > y0) & (dy > -1e-9)) | ((oy < y0) & (dy < 1e-9))
        nonzero = dy != 0
        inv = torch.where(nonzero, -1.0 / torch.where(nonzero, dy, 1.0), 0.0)
        t = (oy - y0) * inv
        px = ox + dx * t
        pz = oz + dz * t
        ok = (~miss) & nonzero & (torch.abs(px) <= limit) & (torch.abs(pz) <= limit)
        z = torch.zeros_like(t)
        rec = dict(t=torch.where(ok, t, INF), nx=z, ny=z + 1.0, nz=z)
        if needs_uv:
            rec["u"], rec["v"] = px, pz
        return rec

    def _sphere_roots(b, ox, oy, oz, dx, dy, dz):
        cx, cy, cz, r = p(b), p(b + 1), p(b + 2), p(b + 3)
        hx, hy, hz = ox - cx, oy - cy, oz - cz
        A = dx * dx + dy * dy + dz * dz
        B = 2.0 * (hx * dx + hy * dy + hz * dz)
        C = hx * hx + hy * hy + hz * hz - r * r
        D = B * B - 4.0 * A * C
        has = D >= 0
        sq = torch.sqrt(torch.where(has, D, 0.0))
        inv2a = 1.0 / (2.0 * A)
        return has, (-B + sq) * inv2a, (-B - sq) * inv2a  # x2 <= x1

    def _sphere_record(b, ox, oy, oz, dx, dy, dz, t, ok, needs_uv):
        cx, cy, cz, r = p(b), p(b + 1), p(b + 2), p(b + 3)
        ts = torch.where(ok, t, 0.0)
        rx, ry, rz = ox + dx * ts - cx, oy + dy * ts - cy, oz + dz * ts - cz
        inv = _rsqrt(rx * rx + ry * ry + rz * rz)
        rec = dict(t=torch.where(ok, t, INF), nx=rx * inv, ny=ry * inv, nz=rz * inv)
        if needs_uv:
            rec["u"] = (_PI + atan2_poly(rz, rx)) / (2 * _PI)
            rec["v"] = 1.0 - (_PI / 2 + asin_poly(ry / r)) / _PI
        return rec

    def sphere_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        has, x1, x2 = _sphere_roots(b, ox, oy, oz, dx, dy, dz)
        sol = torch.where(x2 < 0, x1, x2)
        ok = has & (sol >= 0)
        return _sphere_record(b, ox, oy, oz, dx, dy, dz, sol, ok, needs_uv)

    # face order matches ops/geometry._CUBE_FACES: (axis, sign, u_axis, v_axis)
    _FACES = ((1, -1.0, 0, 2), (1, 1.0, 0, 2), (0, -1.0, 1, 2), (0, 1.0, 1, 2), (2, -1.0, 0, 1), (2, 1.0, 0, 1))

    def _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv):
        cx, cy, cz, side = p(b), p(b + 1), p(b + 2), p(b + 3)
        half = side * 0.5
        o3, d3, c3 = (ox, oy, oz), (dx, dy, dz), (cx, cy, cz)
        cands = []
        for axis, s, ua, va in _FACES:
            dk, ok_, ck = d3[axis], o3[axis], c3[axis]
            valid = torch.abs(dk) >= 1e-9
            inv = torch.where(valid, -1.0 / torch.where(valid, dk, 1.0), 0.0)
            t = (ok_ - (ck + s * half)) * inv
            pxs = [o3[k] + d3[k] * t for k in range(3)]
            oa, ob = (axis + 1) % 3, (axis + 2) % 3
            inside = (
                (pxs[oa] >= c3[oa] - half)
                & (pxs[oa] <= c3[oa] + half)
                & (pxs[ob] >= c3[ob] - half)
                & (pxs[ob] <= c3[ob] + half)
            )
            hit_ok = valid & (t >= 0) & inside
            z = torch.zeros_like(t)
            n = [z, z, z]
            n[axis] = z + s
            rec = dict(t=torch.where(hit_ok, t, INF), nx=n[0], ny=n[1], nz=n[2])
            if needs_uv:
                rec["u"], rec["v"] = pxs[ua] - c3[ua], pxs[va] - c3[va]
            cands.append(rec)
        return cands

    def cube_closest(b, ox, oy, oz, dx, dy, dz, needs_uv):
        cands = _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv)
        best = cands[0]
        for c in cands[1:]:
            best = _sel(c["t"] < best["t"], c, best)
        return best

    def cube_two_hits(b, ox, oy, oz, dx, dy, dz, needs_uv):
        cands = _cube_faces(b, ox, oy, oz, dx, dy, dz, needs_uv)
        best, second = cands[0], cands[1]
        sw = second["t"] < best["t"]
        best, second = _sel(sw, second, best), _sel(sw, best, second)
        for c in cands[2:]:
            bb = c["t"] < best["t"]
            bs = c["t"] < second["t"]
            new_second = _sel(bb, best, _sel(bs, c, second))
            best = _sel(bb, c, best)
            second = new_second
        return [best, second]

    def cube_slab_dists(b, ox, oy, oz, dx, dy, dz):
        cx, cy, cz, side = p(b), p(b + 1), p(b + 2), p(b + 3)
        half = side * 0.5
        o3, d3, c3 = (ox, oy, oz), (dx, dy, dz), (cx, cy, cz)
        t_enter = None
        t_exit = None
        for axis in range(3):
            dk, ok_, ck = d3[axis], o3[axis], c3[axis]
            valid = torch.abs(dk) >= 1e-9
            inv = 1.0 / torch.where(valid, dk, 1.0)
            t1 = (ck - half - ok_) * inv
            t2 = (ck + half - ok_) * inv
            tn = torch.minimum(t1, t2)
            tf = torch.maximum(t1, t2)
            inside = (ok_ >= ck - half) & (ok_ <= ck + half)
            tn = torch.where(valid, tn, torch.where(inside, -INF, INF))
            tf = torch.where(valid, tf, torch.where(inside, INF, -INF))
            t_enter = tn if t_enter is None else torch.maximum(t_enter, tn)
            t_exit = tf if t_exit is None else torch.minimum(t_exit, tf)
        hit = (t_enter <= t_exit) & (t_exit >= 0)
        d1 = torch.where(hit & (t_enter >= 0), t_enter, INF)
        d2 = torch.where(hit, t_exit, INF)
        return [torch.minimum(d1, d2), torch.maximum(d1, d2)]

    def is_inside(expr, px, py, pz):
        kind = expr[0]
        if kind == "plane":
            return torch.zeros_like(px, dtype=torch.bool)
        if kind == "sphere":
            b = expr[1]
            rx, ry, rz = p(b) - px, p(b + 1) - py, p(b + 2) - pz
            return rx * rx + ry * ry + rz * rz < p(b + 3) * p(b + 3)
        if kind == "cube":
            b = expr[1]
            h = p(b + 3) * 0.5
            return (
                (torch.abs(px - p(b)) <= h)
                & (torch.abs(py - p(b + 1)) <= h)
                & (torch.abs(pz - p(b + 2)) <= h)
            )
        _, op, left, right = expr
        return _bool_op(op, is_inside(left, px, py, pz), is_inside(right, px, py, pz))

    def _odd(ts):
        c = None
        for t in ts:
            v = (t < INF).to(torch.int32)
            c = v if c is None else c + v
        return (c % 2) == 1

    def all_hits(expr, ox, oy, oz, dx, dy, dz, needs_uv):
        kind = expr[0]
        if kind == "plane":
            return [plane_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)]
        if kind == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            h2 = _sphere_record(expr[1], ox, oy, oz, dx, dy, dz, x2, has & (x2 >= 0), needs_uv)
            h1 = _sphere_record(expr[1], ox, oy, oz, dx, dy, dz, x1, has & (x1 >= 0), needs_uv)
            return [h2, h1]
        if kind == "cube":
            return cube_two_hits(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)

        _, op, left, right = expr
        lh = all_hits(left, ox, oy, oz, dx, dy, dz, needs_uv)
        rh = all_hits(right, ox, oy, oz, dx, dy, dz, needs_uv)
        merged = [dict(h, side=torch.zeros_like(h["t"])) for h in lh]
        merged += [dict(h, side=torch.ones_like(h["t"])) for h in rh]
        _ce_sort(merged)
        # initial parity: odd hit count => started inside (geometry.d:307-309)
        in_l = _odd([h["t"] for h in lh])
        in_r = _odd([h["t"] for h in rh])
        out = []
        for h in merged:
            valid = h["t"] < INF
            from_right = h["side"] > 0.5
            in_l = in_l ^ (~from_right & valid)
            in_r = in_r ^ (from_right & valid)
            state = _bool_op(op, in_l, in_r) & valid
            h = dict(h)
            h.pop("side")
            if op == "diff":
                # CsgDiff normal flip (geometry.d:377-397), probe step 1e-3
                ts = torch.where(valid, h["t"], 0.0)
                hx, hy, hz = ox + dx * ts, oy + dy * ts, oz + dz * ts
                before = is_inside(right, hx - dx * 1e-3, hy - dy * 1e-3, hz - dz * 1e-3)
                after = is_inside(right, hx + dx * 1e-3, hy + dy * 1e-3, hz + dz * 1e-3)
                flip = (before != after) & state
                sgn = torch.where(flip, -1.0, 1.0)
                h["nx"], h["ny"], h["nz"] = h["nx"] * sgn, h["ny"] * sgn, h["nz"] * sgn
            h["t"] = torch.where(state, h["t"], INF)
            out.append(h)
        return out

    def expr_closest(expr, ox, oy, oz, dx, dy, dz, needs_uv):
        if expr[0] == "plane":
            return plane_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        if expr[0] == "sphere":
            return sphere_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        if expr[0] == "cube":
            return cube_closest(expr[1], ox, oy, oz, dx, dy, dz, needs_uv)
        hits = all_hits(expr, ox, oy, oz, dx, dy, dz, needs_uv)
        best = hits[0]
        for h in hits[1:]:
            best = _sel(h["t"] < best["t"], h, best)
        return best

    def dists_only(expr, ox, oy, oz, dx, dy, dz):
        kind = expr[0]
        if kind == "plane":
            return [plane_closest(expr[1], ox, oy, oz, dx, dy, dz, False)["t"]]
        if kind == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            return [torch.where(has & (x2 >= 0), x2, INF), torch.where(has & (x1 >= 0), x1, INF)]
        if kind == "cube":
            return cube_slab_dists(expr[1], ox, oy, oz, dx, dy, dz)
        _, op, left, right = expr
        ld = dists_only(left, ox, oy, oz, dx, dy, dz)
        rd = dists_only(right, ox, oy, oz, dx, dy, dz)
        merged = [{"t": t, "side": torch.zeros_like(t)} for t in ld]
        merged += [{"t": t, "side": torch.ones_like(t)} for t in rd]
        _ce_sort(merged)
        in_l = _odd(ld)
        in_r = _odd(rd)
        out = []
        for h in merged:
            valid = h["t"] < INF
            from_right = h["side"] > 0.5
            in_l = in_l ^ (~from_right & valid)
            in_r = in_r ^ (from_right & valid)
            state = _bool_op(op, in_l, in_r) & valid
            out.append(torch.where(state, h["t"], INF))
        return out

    def expr_min_dist(expr, ox, oy, oz, dx, dy, dz):
        if expr[0] == "plane":
            return plane_closest(expr[1], ox, oy, oz, dx, dy, dz, False)["t"]
        if expr[0] == "sphere":
            has, x1, x2 = _sphere_roots(expr[1], ox, oy, oz, dx, dy, dz)
            sol = torch.where(x2 < 0, x1, x2)
            return torch.where(has & (sol >= 0), sol, INF)
        if expr[0] == "cube":
            return cube_slab_dists(expr[1], ox, oy, oz, dx, dy, dz)[0]
        ds = dists_only(expr, ox, oy, oz, dx, dy, dz)
        best = ds[0]
        for d in ds[1:]:
            best = torch.minimum(best, d)
        return best

    return expr_closest, expr_min_dist


def _raygen(p, off, width, height, n, device):
    """Pinhole ray-gen on the pos-free corner deltas (camera.d:119-147)."""
    base = p(off["lin"]).to(torch.int32)
    lin = base + torch.arange(n, dtype=torch.int32, device=device)
    xpix = ((lin % width).to(torch.float32) + p(off["aa"])) / width
    ypix = ((lin // width).to(torch.float32) + p(off["aa"] + 1)) / height
    c = off["cam"]
    dx = p(c + 0) + p(c + 3) * xpix + p(c + 6) * ypix
    dy = p(c + 1) + p(c + 4) * xpix + p(c + 7) * ypix
    dz = p(c + 2) + p(c + 5) * xpix + p(c + 8) * ypix
    inv_len = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len
    zero = torch.zeros_like(dx)
    return zero + p(c + 9), zero + p(c + 10), zero + p(c + 11), dx, dy, dz


def _node_scans(p, static, off, expr_tables):
    """Per-node intersection with transforms (node.d:23-68)."""
    expr_closest, expr_min_dist = _geom_builders(p)

    def mulr(v, M):  # row-vector times 3x3 (imported_types.d:13-20)
        return (
            v[0] * M[0] + v[1] * M[3] + v[2] * M[6],
            v[0] * M[1] + v[1] * M[4] + v[2] * M[7],
            v[0] * M[2] + v[1] * M[5] + v[2] * M[8],
        )

    def mulr_T(v, M):  # row-vector times M^T
        return (
            v[0] * M[0] + v[1] * M[1] + v[2] * M[2],
            v[0] * M[3] + v[1] * M[4] + v[2] * M[5],
            v[0] * M[6] + v[1] * M[7] + v[2] * M[8],
        )

    def node_closest(i, ox, oy, oz, dx, dy, dz):
        ns = static.nodes[i]
        needs_uv = _needs_uv(ns)
        expr = expr_tables[i]
        if ns.identity_transform:
            return expr_closest(expr, ox, oy, oz, dx, dy, dz, needs_uv)
        if ns.offset_only:
            b = off[f"n{i}_off"]
            return expr_closest(expr, ox - p(b), oy - p(b + 1), oz - p(b + 2), dx, dy, dz, needs_uv)
        b = off[f"n{i}_mtx"]
        mi = [p(b + 9 + k) for k in range(9)]
        fx, fy, fz = p(b + 18), p(b + 19), p(b + 20)
        co = mulr((ox - fx, oy - fy, oz - fz), mi)
        cd = mulr((dx, dy, dz), mi)
        dlen = torch.sqrt(torch.clamp_min(cd[0] ** 2 + cd[1] ** 2 + cd[2] ** 2, 1e-30))
        inv_dl = 1.0 / dlen
        h = expr_closest(expr, co[0], co[1], co[2], cd[0] * inv_dl, cd[1] * inv_dl, cd[2] * inv_dl, needs_uv)
        miss = h["t"] >= INF
        wn = mulr_T((h["nx"], h["ny"], h["nz"]), mi)
        ninv = _rsqrt(wn[0] ** 2 + wn[1] ** 2 + wn[2] ** 2)
        out = dict(
            t=torch.where(miss, INF, h["t"] * inv_dl),
            nx=wn[0] * ninv, ny=wn[1] * ninv, nz=wn[2] * ninv,
        )
        if needs_uv:
            out["u"], out["v"] = h["u"], h["v"]
        return out

    def node_min_dist(i, ox, oy, oz, dx, dy, dz):
        ns = static.nodes[i]
        expr = expr_tables[i]
        if ns.identity_transform:
            return expr_min_dist(expr, ox, oy, oz, dx, dy, dz)
        if ns.offset_only:
            b = off[f"n{i}_off"]
            return expr_min_dist(expr, ox - p(b), oy - p(b + 1), oz - p(b + 2), dx, dy, dz)
        b = off[f"n{i}_mtx"]
        mi = [p(b + 9 + k) for k in range(9)]
        fx, fy, fz = p(b + 18), p(b + 19), p(b + 20)
        cox = (ox - fx) * mi[0] + (oy - fy) * mi[3] + (oz - fz) * mi[6]
        coy = (ox - fx) * mi[1] + (oy - fy) * mi[4] + (oz - fz) * mi[7]
        coz = (ox - fx) * mi[2] + (oy - fy) * mi[5] + (oz - fz) * mi[8]
        cdx = dx * mi[0] + dy * mi[3] + dz * mi[6]
        cdy = dx * mi[1] + dy * mi[4] + dz * mi[7]
        cdz = dx * mi[2] + dy * mi[5] + dz * mi[8]
        dlen = torch.sqrt(torch.clamp_min(cdx * cdx + cdy * cdy + cdz * cdz, 1e-30))
        inv_dl = 1.0 / dlen
        d = expr_min_dist(expr, cox, coy, coz, cdx * inv_dl, cdy * inv_dl, cdz * inv_dl)
        return torch.where(d >= INF, INF, d * inv_dl)

    any_uv = any(_needs_uv(ns) for ns in static.nodes)

    def scene_scan(ox, oy, oz, dx, dy, dz):
        best = None
        win = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
        for i in range(len(static.nodes)):
            cand = node_closest(i, ox, oy, oz, dx, dy, dz)
            if any_uv and "u" not in cand:
                cand["u"] = cand["v"] = torch.zeros_like(ox)
            if best is None:
                best = cand
                win = torch.where(cand["t"] < INF, i, win)
            else:
                better = cand["t"] <= best["t"]  # ties: later node (renderer.d:336-338)
                win = torch.where(better & (cand["t"] < INF), i, win)
                best = _sel(better, cand, best)
        return best, win

    return node_closest, node_min_dist, scene_scan


def round0_reference(lay: Round0Layout, prm: torch.Tensor, orig=None, dir=None, *, lin_input: bool = False,
                     n_lanes: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K1.  Screen-tap form when ``orig`` is
    None (N = width * height lanes), lin-input form with ``lin_input``
    (N = ``n_lanes`` pixels from the base in ``prm``'s lin slot), ray-input
    form otherwise (``orig`` and ``dir`` are [N, 3]).  Returns {name: [N]
    f32} for ``lay.names`` plus "win" ([N] int32, -1 = miss)."""
    static, off = lay.static, lay.off
    device = prm.device

    def p(k):
        return prm[k]

    if orig is None:
        n = _lane_count(lay, lin_input, n_lanes)
        ox, oy, oz, dx, dy, dz = _raygen(p, off, lay.width, lay.height, n, device)
    else:
        ox, oy, oz = orig.unbind(-1)
        dx, dy, dz = dir.unbind(-1)
        n = ox.shape[0]

    node_closest, node_min_dist, scene_scan = _node_scans(p, static, off, lay.expr_tables)
    has_refr = REFRACTION in static.shader_kinds_present
    has_phong = PHONG in static.shader_kinds_present

    hit, win = scene_scan(ox, oy, oz, dx, dy, dz)
    hitmask = win >= 0
    ts = torch.where(hitmask, hit["t"], 0.0)
    hpx, hpy, hpz = ox + dx * ts, oy + dy * ts, oz + dz * ts

    # faceforward (imported_types.d:69-73)
    ndotd = dx * hit["nx"] + dy * hit["ny"] + dz * hit["nz"]
    sgn = torch.where(ndotd < 0, 1.0, -1.0)
    nx, ny, nz = hit["nx"] * sgn, hit["ny"] * sgn, hit["nz"] * sgn

    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    dr, dg, db = zeros, zeros, zeros
    exp_t = zeros + 1.0
    str_t = zeros
    is_phong = torch.zeros(n, dtype=torch.bool, device=device)
    is_direct = torch.zeros(n, dtype=torch.bool, device=device)
    for i, ns in enumerate(static.nodes):
        m = win == i
        bm = off[f"n{i}_mat"]
        if ns.tex_kind == TEX_CHECKER:
            bt = off[f"n{i}_tex"]
            size = p(bt + 6)
            cxi = torch.floor(hit["u"] / size).to(torch.int32)
            cyi = torch.floor(hit["v"] / size).to(torch.int32)
            white = ((cxi + cyi) & 1).to(torch.bool)
            cr = torch.where(white, p(bt + 3), p(bt + 0))
            cg = torch.where(white, p(bt + 4), p(bt + 1))
            cb = torch.where(white, p(bt + 5), p(bt + 2))
        elif ns.tex_kind == TEX_PROC2:
            bt = off[f"n{i}_tex"]
            cr, cg, cb = zeros, zeros, zeros
            for band in range(3):
                su = torch.sin(hit["u"] * p(bt + 18 + band))
                sv = torch.sin(hit["v"] * p(bt + 21 + band))
                cr = cr + (p(bt + band * 3 + 0) * su + p(bt + 9 + band * 3 + 0) * sv)
                cg = cg + (p(bt + band * 3 + 1) * su + p(bt + 9 + band * 3 + 1) * sv)
                cb = cb + (p(bt + band * 3 + 2) * su + p(bt + 9 + band * 3 + 2) * sv)
        elif ns.tex_kind == TEX_BITMAP:
            cr = cg = cb = zeros  # deferred to ops/shade.bitmap_color
        else:
            cr, cg, cb = zeros + p(bm + 0), zeros + p(bm + 1), zeros + p(bm + 2)
        dr = torch.where(m, cr, dr)
        dg = torch.where(m, cg, dg)
        db = torch.where(m, cb, db)
        exp_t = torch.where(m, p(bm + 3), exp_t)
        str_t = torch.where(m, p(bm + 4), str_t)
        if ns.shader_kind == PHONG:
            is_phong = is_phong | m
        if ns.shader_kind in (LAMBERT, PHONG):
            is_direct = is_direct | m

    # direct lighting with shadow scans
    amb = off["ambient"]
    lr, lg, lb = zeros + p(amb), zeros + p(amb + 1), zeros + p(amb + 2)
    sr, sg, sb = zeros, zeros, zeros
    sx = hpx + nx * EPS_SHADOW
    sy = hpy + ny * EPS_SHADOW
    sz = hpz + nz * EPS_SHADOW
    vis_rows = {}
    for li in range(static.n_lights):
        lbase = off[f"light{li}"]
        lx, ly, lz = p(lbase), p(lbase + 1), p(lbase + 2)
        tlx, tly, tlz = lx - hpx, ly - hpy, lz - hpz
        dist2 = tlx * tlx + tly * tly + tlz * tlz
        inv_l = _rsqrt(dist2)
        ldx, ldy, ldz = tlx * inv_l, tly * inv_l, tlz * inv_l
        # shadow scan (scene.d:62-78): any node with dist <= |to - from|
        tx2, ty2, tz2 = lx - sx, ly - sy, lz - sz
        target = torch.sqrt(torch.clamp_min(tx2 * tx2 + ty2 * ty2 + tz2 * tz2, 1e-30))
        inv_t = 1.0 / target
        sdx, sdy, sdz = tx2 * inv_t, ty2 * inv_t, tz2 * inv_t
        occ = torch.zeros(n, dtype=torch.bool, device=device)
        for i in range(len(static.nodes)):
            occ = occ | (node_min_dist(i, sx, sy, sz, sdx, sdy, sdz) <= target)
        vis = ~occ
        if lay.want_vis:
            vis_rows[f"vis{li}"] = torch.where(vis, 1.0, 0.0)
        cos_t = ldx * nx + ldy * ny + ldz * nz
        gate = vis & (cos_t > 0)
        w = torch.where(gate, cos_t / dist2, 0.0)
        lr = lr + p(lbase + 3) * w
        lg = lg + p(lbase + 4) * w
        lb = lb + p(lbase + 5) * w
        if has_phong:
            # R = reflect(-lightDir, N); cosGamma = R . -d (shader.d:226-249)
            mdotn = (-ldx) * nx + (-ldy) * ny + (-ldz) * nz
            rx = -ldx - 2.0 * mdotn * nx
            ry = -ldy - 2.0 * mdotn * ny
            rz = -ldz - 2.0 * mdotn * nz
            inv_r = _rsqrt(rx * rx + ry * ry + rz * rz)
            cos_g = (rx * (-dx) + ry * (-dy) + rz * (-dz)) * inv_r
            sgate = vis & (cos_g > 0)
            spec_w = torch.where(sgate, torch.pow(torch.clamp_min(cos_g, 0.0), exp_t) * str_t / dist2, 0.0)
            sr = sr + p(lbase + 3) * spec_w
            sg = sg + p(lbase + 4) * spec_w
            sb = sb + p(lbase + 5) * spec_w

    outr = dr * lr
    outg = dg * lg
    outb = db * lb
    if has_phong:
        outr = outr + torch.where(is_phong, sr, 0.0)
        outg = outg + torch.where(is_phong, sg, 0.0)
        outb = outb + torch.where(is_phong, sb, 0.0)

    shaded = hitmask & is_direct
    out = {
        "r": torch.where(shaded, outr, 0.0),
        "g": torch.where(shaded, outg, 0.0),
        "b": torch.where(shaded, outb, 0.0),
        "win": win,
    }
    if lay.emit_L:
        out["lr"] = torch.where(shaded, lr, 0.0)
        out["lg"] = torch.where(shaded, lg, 0.0)
        out["lb"] = torch.where(shaded, lb, 0.0)
        out["u"] = hit.get("u", zeros)
        out["v"] = hit.get("v", zeros)
    if lay.has_cont:
        # mirror continuation (render/pipeline._whitted_round)
        ddn = dx * nx + dy * ny + dz * nz
        rdx = dx - 2.0 * ddn * nx
        rdy = dy - 2.0 * ddn * ny
        rdz = dz - 2.0 * ddn * nz
        rinv = _rsqrt(rdx * rdx + rdy * rdy + rdz * rdz)
        cdx, cdy, cdz = rdx * rinv, rdy * rinv, rdz * rinv
        cox, coy, coz = sx, sy, sz
        if has_refr:
            # single-sided refraction with TIR fallback, on the RAW
            # (pre-faceforward) normal like _whitted_round
            rnx, rny, rnz = hit["nx"], hit["ny"], hit["nz"]
            ior = zeros + 1.33
            is_refr = torch.zeros(n, dtype=torch.bool, device=device)
            for i, ns in enumerate(static.nodes):
                if ns.shader_kind == REFRACTION:
                    m = win == i
                    ior = torch.where(m, p(off[f"n{i}_mat"] + 5), ior)
                    is_refr = is_refr | m
            cos_in = -(dx * rnx + dy * rny + dz * rnz)
            entering = cos_in > 0
            eta = torch.where(entering, 1.0 / ior, ior)
            fsgn = torch.where(entering, 1.0, -1.0)
            nfx, nfy, nfz = rnx * fsgn, rny * fsgn, rnz * fsgn
            ci = torch.abs(cos_in)
            kk = 1.0 - eta * eta * (1.0 - ci * ci)
            tir = kk < 0
            coef = eta * ci - torch.sqrt(torch.clamp_min(kk, 0.0))
            fx_ = eta * dx + coef * nfx
            fy_ = eta * dy + coef * nfy
            fz_ = eta * dz + coef * nfz
            finv = _rsqrt(fx_ * fx_ + fy_ * fy_ + fz_ * fz_)
            rfdx = torch.where(tir, cdx, fx_ * finv)
            rfdy = torch.where(tir, cdy, fy_ * finv)
            rfdz = torch.where(tir, cdz, fz_ * finv)
            rfox = torch.where(tir, hpx + nfx * EPS_SHADOW, hpx - nfx * EPS_SHADOW)
            rfoy = torch.where(tir, hpy + nfy * EPS_SHADOW, hpy - nfy * EPS_SHADOW)
            rfoz = torch.where(tir, hpz + nfz * EPS_SHADOW, hpz - nfz * EPS_SHADOW)
            cdx = torch.where(is_refr, rfdx, cdx)
            cdy = torch.where(is_refr, rfdy, cdy)
            cdz = torch.where(is_refr, rfdz, cdz)
            cox = torch.where(is_refr, rfox, cox)
            coy = torch.where(is_refr, rfoy, coy)
            coz = torch.where(is_refr, rfoz, coz)
        out.update(rox=cox, roy=coy, roz=coz, rdx=cdx, rdy=cdy, rdz=cdz)
    if lay.want_hit:
        out.update(t=hit["t"], nx=hit["nx"], ny=hit["ny"], nz=hit["nz"], dr=dr, dg=dg, db=db)
    out.update(vis_rows)
    return out


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------


def _lane_count(lay: Round0Layout, lin_input: bool, n_lanes: Optional[int]) -> int:
    """Lanes of a call without rays: the frame (screen-tap form) or
    ``n_lanes`` (lin-input form)."""
    if not lin_input:
        if n_lanes is not None:
            raise ValueError("round0: n_lanes belongs to the lin-input form (lin_input=True)")
        return lay.width * lay.height
    if n_lanes is None or n_lanes <= 0:
        raise ValueError("round0: the lin-input form needs n_lanes > 0")
    return int(n_lanes)


def round0(
    lay: Round0Layout,
    prm: torch.Tensor,
    orig: Optional[torch.Tensor] = None,
    dir: Optional[torch.Tensor] = None,
    *,
    lin_input: bool = False,
    n_lanes: Optional[int] = None,
    want_hit: bool = False,
    want_vis: bool = False,
    placement: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """One fused Whitted round (K1).  Screen-tap form with ``orig=None``
    (N = width * height lanes, ray-gen in-kernel from the camera slot and
    the aa offset in ``prm``), ray-input form with ``orig``/``dir`` [N, 3].
    Lin-input form with ``lin_input=True``: ray-gen in-kernel for the
    ``n_lanes`` pixels [lin_base, lin_base + n_lanes) of the flat frame,
    with ``prm = lay.pack(packed, aa_offset, lin_base)``; each lane does
    what the screen-tap form's lane of the same pixel does.  Lanes past the
    frame's last pixel compute pixels below the frame; callers slice them
    off.

    ``want_hit`` / ``want_vis`` add the residual rows (see ``layout``); a
    layout built with them does the same.  ``placement`` ("shared" or
    "global") overrides ``list_placement`` for the kernel's hit lists, so
    that a test can drive both on one scene.

    ``prm`` on a CUDA device launches csrc/round0.cu (or raises); on the
    CPU it runs ``round0_reference``.  There is no fallback between the two.
    Returns the same dict as ``round0_reference``.  Under a running
    ``torch.profiler`` the call is the span ``c2rt.k1``."""
    if want_hit or want_vis:
        lay = layout(lay.static, lay.width, lay.height, lay.want_hit or want_hit, lay.want_vis or want_vis)
    if (orig is None) != (dir is None):
        raise ValueError("round0: pass both orig and dir (ray-input form) or neither (screen-tap form)")
    if lin_input and orig is not None:
        raise ValueError("round0: the lin-input form takes no rays")
    n = _lane_count(lay, lin_input, n_lanes) if orig is None else None
    if placement not in (None, "shared", "global"):
        raise ValueError(f"round0: placement must be 'shared' or 'global', got {placement!r}")
    with span("c2rt.k1"):
        if prm.device.type == "cpu":
            return round0_reference(lay, prm, orig, dir, lin_input=lin_input, n_lanes=n_lanes)
        if prm.device.type != "cuda":
            raise RuntimeError(f"round0: no kernel for device {prm.device}")
        return _round0_cuda(lay, prm, orig, dir, n, lin_input, placement)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"round0: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"round0: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"round0: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"round0: {name} is on {t.device}, prm on {device}")
    if not t.is_contiguous():
        raise ValueError(f"round0: {name} must be contiguous")


def list_scratch(lay: Round0Layout, n: int, device, placement: Optional[str] = None) -> Optional[torch.Tensor]:
    """The global [2 * capacity, n] scratch of K1's hit lists for an
    ``n``-lane launch, or None when they go in shared memory."""
    if (placement or list_placement(lay.program, lay.n_prm)) == "shared":
        return None
    return torch.empty((2 * int(lay.program[H_LIST_CAP]), n), dtype=torch.float32, device=device)


def _round0_cuda(lay, prm, orig=None, dir=None, n=None, lin_input=False, placement=None):
    """Check the inputs, allocate the outputs (and the hit lists' scratch
    when they go in global memory) and launch csrc/round0.cu on ``n`` lanes
    (the rays' count in the ray-input form)."""
    global launches, resid_launches, hit_launches, ray_launches, lin_launches
    from .. import cuda_build

    dev = prm.device
    _check("prm", prm, torch.float32, (lay.n_prm,), dev)
    if orig is not None:
        n = orig.shape[0]
        _check("orig", orig, torch.float32, (n, 3), dev)
        _check("dir", dir, torch.float32, (n, 3), dev)
    elif n is None:
        n = lay.width * lay.height
    if n >= 2**31:
        raise ValueError(f"round0: {n} lanes exceed the kernel's int32 lane index")
    lib = cuda_build.load("round0")
    if lib.c2rt_program_version() != PROGRAM_VERSION:
        raise RuntimeError("round0: csrc/round0.cu and scene_program() disagree on the program layout")
    prog = lay.program_on(dev)
    out = torch.empty((len(lay.names), n), dtype=torch.float32, device=dev)
    win = torch.empty((n,), dtype=torch.int32, device=dev)
    lists = list_scratch(lay, n, dev, placement)
    cuda_build.launch(
        "round0",
        "c2rt_round0",
        dev,
        prm.data_ptr(),
        prog.data_ptr(),
        lay.n_prm,
        prog.numel(),
        int(lay.program[H_LIST_CAP]),
        None if orig is None else orig.data_ptr(),
        None if dir is None else dir.data_ptr(),
        None if lists is None else lists.data_ptr(),
        out.data_ptr(),
        win.data_ptr(),
        n,
        lay.width,
        lay.height,
    )
    launches += 1
    resid_launches += lay.residual
    hit_launches += lay.want_hit and not lay.want_vis
    ray_launches += orig is not None
    lin_launches += lin_input
    res = dict(zip(lay.names, out.unbind(0)))
    res["win"] = win
    return res

