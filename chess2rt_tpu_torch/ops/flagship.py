"""The flagship renderer: round-0 kernel taps + torch glue.

Counterpart of the renderer half of chess2rt_tpu/ops/pallas_trace.py
(``combine_outputs``, ``build_bounce_finisher``, ``build_flagship_renderer``,
``build_rows_renderer``) for the Whitted frame, deterministic or
Monte-Carlo (depth of field, stereo):

    for each AA tap:   round0 (screen-tap)  ->  combine_outputs (deferred
                       bitmap and cubemap texels, continuation carry: one
                       launch of csrc/combine.cu on a forward float32
                       frame on the card, else the torch glue)  ->  bounce
                       rounds: round0 (ray-input) on a block-compacted
                       buffer, full width when it overflows

The engine's modes (``SceneStatic``), honoured where the JAX package honours
them:

* ``bounce_mode``: ``"block"`` (the default: whole 128-lane blocks with a
  live lane compacted, ``bounce_block_capacity``), ``"full"`` (every round
  at full width) or any other value, the lane-granular compaction
  (``"compact"``: the live lanes compacted into ``bounce_capacity`` lanes
  rounded up to whole tiles, one merged row gather, full width on overflow,
  counted by ``compact_overflows``); without a capacity below the width it
  runs full width;
* ``texel_tap_reuse``: AA taps 1-4 of a quirk-AA frame reuse the base tap's
  gathered texel quads and re-gather only the lanes whose texel key changed
  (``texel_reuse_capacity`` of them, else the full gather), bit-identical to
  the plain gather, in the un-chunked frame and per slice of the rows
  renderer;
* ``texel_grad_mode``: passed to every texel gather (ops/shade.py).

Every batch of rays goes through one tracer, ``trace_batch``: K1's call,
``combine_outputs`` with the rays' directions (for the environment), the
bounce finisher, in one ``c2rt.tap`` span.  ``trace_rays`` feeds it K1's
ray-input form; the screen-tap and lin-input forms feed it their own
calls.  Its callers:

* ``build_flagship_renderer``: the whole frame on one device, un-chunked
  (the screen-tap form) or in ``chunk_pixels`` slabs (rays from
  ``camera.pixel_rays`` into the ray-input form at slab width, so peak
  memory follows the slab), with quirk AA (5 taps everywhere) or adaptive
  AA (4 more taps only on the pixels ``aa_detect`` flags, lane-compacted
  through the ray-input form).
* the Monte-Carlo renderer of ``build_flagship_renderer`` (DoF, stereo):
  one sampler draws the rays with the JAX package's random streams
  (ops/prng.py: the same keys, the same bits) into ``screen_rays`` and
  traces them through the ray-input form at full width, in
  ``chunk_pixels`` slabs, or, for the 4 adaptive-AA taps of a DoF frame,
  lane-compacted to the flagged pixels (their uniforms drawn at full width
  and gathered, since a draw is positional);
* ``build_rows_renderer``: one contiguous slice of the flat pixel grid
  through K1's lin-input form (ray-gen in the kernel from the slice's lane
  base): the per-shard body of parallel/mesh.py, whose per-shard sampler
  traces its Monte-Carlo rays through ``trace_rays`` too.

The deterministic renderers share one AA loop (``_deterministic_aa``); all
three share one chunk-slab loop (``_over_slabs``) and one adaptive-AA
blend (``_adaptive_taps``).

Where JAX decided "all rounds dead", "compacted buffer overflows" and
"flagged pixels fit" on the device with ``lax.cond``, this port reads the
counts on the host: one device sync per bounce round, per tap and per
adaptive frame, each through ``utils/spans.read_any`` or ``read_count``,
which count it by site (``spans.syncs``).  That is acceptable in bring-up;
a later PR can keep the decisions on the device.  Under a running
``torch.profiler`` the taps, bounce rounds, gathers and reads carry
``c2rt.*`` spans (utils/spans.py); a Monte-Carlo frame's passes, their
ray generation and the environment's share of ``combine_outputs`` have
theirs too (``c2rt.mc_pass``, ``c2rt.raygen``, ``c2rt.env``), counted by
``mc_passes`` and ``env_gathers``; the combine kernel's launch is
``c2rt.combine``, and ``combine_kernels`` and ``combine_glue`` count the
calls each path took.

Every round-0 call goes through one function, ``trace``: the wrapper
``round0`` by default (the CUDA kernel for CUDA tensors), or its plain
version ``round0_reference`` to render the same frame without the kernel.
When a gradient of the scene is wanted (decided once per frame by
``round0_call``), each call goes through ``round0_grad.diff_round0``
around ``trace``: K1's residual form forward, the leaf-pinned re-shade
backward, so the frame is differentiable in every ScenePacked leaf (the
in-place ``index_add_`` and parameter-slot writes below are on tensors
autograd tracks).  A forward frame calls ``trace`` directly.
``bounce_rounds`` counts the bounce rounds run, so a caller can tell how
many kernel launches a frame should have made.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.packed import REFLECTION, REFRACTION, TEX_BITMAP, ScenePacked, SceneStatic, leaves
from . import prng
from . import shade as S
from .camera import begin_frame, pixel_rays, screen_rays
from .env import cubemap_plan, cubemap_quads, sample_cubemap
from .round0 import BOUNCE_BLOCK, TILE_N, exact_lane_base, layout, round0, supports
from .bump_round0 import bump_round0
from .round0_grad import diff_round0, form_rays
from ..utils.spans import read_any, read_count, span

# bounce rounds run (each is one round-0 call); callers zero and read it
bounce_rounds = 0
# lane-compacted bounce passes whose live lanes overflowed the capacity (run
# at full width, JAX's lax.cond branch)
compact_overflows = 0
# AA taps that reused the base tap's texel quads, the lanes they re-gathered
# and those that overflowed the reuse capacity (a full gather)
reuse_taps = reuse_changed = reuse_overflows = 0
# Monte-Carlo passes run (a DoF sample, or a tap of a frame without DoF;
# both eyes of a stereo pair are one pass)
mc_passes = 0
# ``combine_outputs`` calls that read the cubemap (the merged bitmap+cubemap
# gather, or the cubemap alone)
env_gathers = 0
# ``combine_outputs`` calls finished by csrc/combine.cu (one launch each)
# and by the torch glue: their sum is every call
combine_kernels = combine_glue = 0


def _mc_pass():
    """The context of one Monte-Carlo pass: counted, and spanned."""
    global mc_passes
    mc_passes += 1
    return span("c2rt.mc_pass")


def _reused_quads(static: SceneStatic, quads, key, texel_reuse):
    """This tap's gathered quads from the base tap's ``texel_reuse = (key0,
    g0)``: g0 where the texel key is unchanged, and the changed lanes
    re-gathered lane-compacted (``texel_reuse_capacity`` or n / 8 lanes, one
    [cap, 12] row gather, set into g0's rows); a full gather when more lanes
    changed (decided on the host).  The same keys give the same rows, so the
    result is the plain gather's bit for bit; unchanged lanes route their
    cotangent into the base tap's gather."""
    global reuse_taps, reuse_changed, reuse_overflows
    from ..render.pipeline import compact_indices

    key0, g0 = texel_reuse
    n = key.shape[0]
    cap = min(static.texel_reuse_capacity or -(-n // 8), n)
    changed = key != key0
    count = read_count("flagship.reuse_count", changed)  # JAX's lax.cond predicate
    reuse_taps += 1
    reuse_changed += count
    if count > cap:
        reuse_overflows += 1
        return S.quad_gather_flat(quads, key, static.texel_grad_mode)
    if count == 0:
        return g0
    sel = compact_indices(changed, n, cap).long()
    rows = S.quad_gather_flat(quads, key[sel.clamp_max(n - 1)], static.texel_grad_mode)
    # out of place: the graph holds g0 for the taps to come
    return g0.index_put((sel[:count],), rows[:count])


def combine_outputs(packed: ScenePacked, static: SceneStatic, o, dirs_or_none=None, texel_plan=False,
                    texel_reuse=None):
    """Kernel outputs -> (direct color incl. deferred bitmap texels and the
    environment, continuation mask, attenuation factor, refl orig, refl
    dir); the last four None without a Reflection or Refraction shader.
    ``dirs_or_none``: the rays' directions, for the cubemap sample of the
    lanes that missed (a scene with ``has_env``; None leaves misses black).
    ``texel_plan`` and ``texel_reuse`` as in ``combine_reference``.

    One launch of csrc/combine.cu (``combine_kernel``) when K1's rows are
    on a CUDA device, no gradient is recorded (grad mode on and a row, the
    directions or a table the call reads requiring grad) and no texel plan
    is asked for or reused; otherwise ``combine_reference``, the torch glue
    (the CPU, gradient steps, ``texel_tap_reuse``).  Both give the same
    bits.  On the card the kernel takes float32 rows only and raises on
    others, as K1 does.  A call that reads the cubemap counts in
    ``env_gathers`` and runs in a ``c2rt.env`` span on either path: on the
    kernel's the whole call, on the glue's the branch that reads it."""
    global env_gathers
    use_env = static.has_env and dirs_or_none is not None
    if use_env:
        env_gathers += 1
    if not _combine_on_kernel(packed, o, dirs_or_none, texel_plan, texel_reuse):
        return combine_reference(packed, static, o, dirs_or_none, texel_plan, texel_reuse)
    if use_env:
        with span("c2rt.env"):
            return combine_kernel(packed, static, o, dirs_or_none)
    return combine_kernel(packed, static, o, dirs_or_none)


def _combine_on_kernel(packed: ScenePacked, o, dirs, texel_plan, texel_reuse) -> bool:
    """``combine_outputs``' choice of ``combine_kernel`` (its docstring)."""
    if texel_plan or texel_reuse is not None or not o["win"].is_cuda:
        return False
    if torch.is_grad_enabled():
        read = (*o.values(), packed.bitmap_atlas, packed.bitmap_scaling, packed.mat_color, packed.env_cubemap)
        if any(t.requires_grad for t in read) or (dirs is not None and dirs.requires_grad):
            return False
    return True


def combine_reference(packed: ScenePacked, static: SceneStatic, o, dirs_or_none=None, texel_plan=False,
                      texel_reuse=None):
    """``combine_outputs`` in torch, the plain version of
    ``combine_kernel``; differentiable.  ``combine_glue`` counts its calls.

    With both bitmaps and a cubemap the two gathers merge into one: the
    bitmap quad table and the cubemap's concatenated, one key per lane (a
    hit's texel, or a miss's cubemap texel past the bitmap rows), one
    ``quad_gather_flat``, so one texel VJP (K2) covers both tables.

    ``texel_plan=True`` appends this tap's plan, (texel keys, gathered
    [n, 12] quads), to the tuple (None without bitmaps); ``texel_reuse``
    takes a base tap's plan and gathers through ``_reused_quads``."""
    global combine_glue
    combine_glue += 1
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_refl = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    use_env = static.has_env and dirs_or_none is not None
    win = o["win"]
    color = torch.stack([o["r"], o["g"], o["b"]], dim=-1)
    winc = torch.clamp_min(win, 0)
    onehot = S.node_onehot(static, winc) if (has_bitmap or has_refl) else None
    plan = None

    def gather(quads, key):
        with span("c2rt.gather"):
            if texel_reuse is not None:
                return _reused_quads(static, quads, key, texel_reuse)
            return S.quad_gather_flat(quads, key, static.texel_grad_mode)

    if has_bitmap and use_env:
        with span("c2rt.env"):
            quads_t, key_t, p_t, q_t = S.bitmap_plan(packed, static, winc, o["u"], o["v"], onehot)
            quads_e = cubemap_quads(packed.env_cubemap)
            key_e, p_e, q_e = cubemap_plan(packed.env_cubemap, dirs_or_none)
            miss = win < 0
            missc = miss[..., None]
            key = torch.where(miss, quads_t.shape[0] + key_e, key_t)
            g = gather(torch.cat([quads_t, quads_e]), key)
            plan = (key, g)
            out3 = S.bilerp_quad(g, torch.where(missc, p_e, p_t), torch.where(missc, q_e, q_t))
            L = torch.stack([o["lr"], o["lg"], o["lb"]], dim=-1)
            is_bmp = (S.tex_kind_of(static, winc) == TEX_BITMAP) & (win >= 0)
            w3 = torch.where(is_bmp[..., None], L, 0.0) + torch.where(missc, 1.0, 0.0)
            color = color + out3 * w3
    elif has_bitmap:  # ``S.bitmap_color``, its gather kept as the plan
        quads_t, key_t, p_t, q_t = S.bitmap_plan(packed, static, winc, o["u"], o["v"], onehot)
        g = gather(quads_t, key_t)
        plan = (key_t, g)
        tex = S.bilerp_quad(g, p_t, q_t)
        L = torch.stack([o["lr"], o["lg"], o["lb"]], dim=-1)
        is_bmp = (S.tex_kind_of(static, winc) == TEX_BITMAP) & (win >= 0)
        color = color + torch.where(is_bmp[..., None], tex * L, 0.0)
    elif use_env:
        with span("c2rt.env"):
            env = sample_cubemap(packed.env_cubemap, dirs_or_none)
            color = color + torch.where((win < 0)[..., None], env, 0.0)
    if not has_refl:
        out = (color, None, None, None, None)
    else:
        skind = S.shader_kind_of(static, winc)
        cont = (win >= 0) & ((skind == REFLECTION) | (skind == REFRACTION))
        atten = torch.where(cont[..., None], S.node_gather(onehot, packed.mat_color), 1.0)
        ro = torch.stack([o["rox"], o["roy"], o["roz"]], dim=-1)
        rd = torch.stack([o["rdx"], o["rdy"], o["rdz"]], dim=-1)
        out = (color, cont, atten, ro, rd)
    return out + (plan,) if texel_plan else out


def combine_kernel(packed: ScenePacked, static: SceneStatic, o, dirs=None):
    """``combine_reference`` (without a texel plan) in one launch of
    csrc/combine.cu: K1's rows as ``round0`` returns them (float32 rows of
    any stride, ``win`` int32), ``dirs`` the [n, 3] directions (None leaves
    misses black).  Records nothing for autograd.  A ``c2rt.combine`` span
    under a running profiler; ``combine_kernels`` counts the launches."""
    global combine_kernels
    from .. import cuda_build

    with span("c2rt.combine"):
        args, out, _hold = combine_args(packed, static, o, dirs)
        cuda_build.launch("combine", "c2rt_combine", o["win"].device, *args)
        combine_kernels += 1
    return out


# K1's rows that csrc/combine.cu reads, in its order (after win; then the
# directions' three columns)
_COMBINE_ROWS = ("r", "g", "b", "lr", "lg", "lb", "u", "v", "rox", "roy", "roz", "rdx", "rdy", "rdz")


@functools.lru_cache(maxsize=64)
def _combine_tables(static: SceneStatic):
    """The scene's constants for csrc/combine.cu: (one int32 array of the
    node words [Nn] and the textures' (h, w, first row of the flat bitmap
    quad table) [T, 3], Nn, T, the table's rows, flags)."""
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    if has_bitmap and static.texel_grad_mode not in S.TEXEL_GRAD_MODES:  # as the glue's gather refuses it
        raise ValueError(f"texel_grad_mode {static.texel_grad_mode!r}: one of {S.TEXEL_GRAD_MODES}")
    sizes = static.bitmap_sizes
    tex = np.zeros((len(sizes), 3), dtype=np.int64)
    row = 0
    for t, (h, w) in enumerate(sizes):
        tex[t] = h, w, row
        row += h * w
    nodes = np.zeros(len(static.nodes), dtype=np.int64)
    for j, ns in enumerate(static.nodes):
        b = max(ns.bitmap_idx, 0)
        if has_bitmap and b >= len(sizes):
            raise ValueError(f"combine: node {j} names bitmap {b} of {len(sizes)}")
        nodes[j] = (int(ns.shader_kind in (REFLECTION, REFRACTION)) | 2 * int(ns.tex_kind == TEX_BITMAP)
                    | b << 2)
    words = np.concatenate([nodes, tex.reshape(-1)]).astype(np.uint32).view(np.int32)
    flags = int(has_bitmap) | 2 * int(static.has_env) | 4 * bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    return words, len(nodes), len(sizes), row, flags


@functools.lru_cache(maxsize=64)
def _combine_table(static: SceneStatic, device: torch.device) -> torch.Tensor:
    """``_combine_tables``' words on ``device``, once per scene."""
    return torch.from_numpy(_combine_tables(static)[0]).to(device)


def combine_args(packed: ScenePacked, static: SceneStatic, o, dirs=None):
    """``combine_kernel``'s inputs checked and marshalled for
    csrc/combine.cu: (``c2rt_combine``'s arguments but the stream, the
    outputs ``combine_reference`` returns, the host arrays and tensors to
    hold until the launch)."""
    _, n_nodes, n_tex, bitmap_rows, flags = _combine_tables(static)
    if dirs is None:
        flags &= ~2
    win = o["win"]
    n, dev = win.shape[0], win.device
    if win.dtype != torch.int32 or win.dim() != 1:
        raise ValueError(f"combine: win must be an [n] int32 tensor, got {list(win.shape)} {win.dtype}")
    table = _combine_table(static, dev)
    # the kernel's 22 input pointers (win, the 14 rows, the directions' 3
    # columns, the 4 tables) and 5 outputs; the rows' strides
    ptrs, strides = [0] * 27, [0] * 18
    ptrs[0], strides[0] = win.data_ptr(), win.stride(0)
    used = (0, 1, 2) + ((3, 4, 5, 6, 7) if flags & 1 else ()) + (tuple(range(8, 14)) if flags & 4 else ())
    for j in used:
        x = o[_COMBINE_ROWS[j]]
        if x.dtype != torch.float32 or x.shape != (n,) or x.device != dev:
            raise ValueError(f"combine: row {_COMBINE_ROWS[j]} must be an [{n}] float32 tensor on {dev}")
        ptrs[1 + j], strides[1 + j] = x.data_ptr(), x.stride(0)
    if flags & 2:
        if dirs.dtype != torch.float32 or dirs.shape != (n, 3) or dirs.device != dev:
            raise ValueError(f"combine: dirs must be an [{n}, 3] float32 tensor on {dev}")
        for k in range(3):
            ptrs[15 + k], strides[15 + k] = dirs.data_ptr() + 4 * k * dirs.stride(1), dirs.stride(0)
    tables = (packed.bitmap_atlas if flags & 1 else None, packed.bitmap_scaling if flags & 1 else None,
              packed.mat_color if flags & 4 else None, packed.env_cubemap if flags & 2 else None)
    for j, (name, x) in enumerate(zip(("bitmap_atlas", "bitmap_scaling", "mat_color", "env_cubemap"), tables)):
        if x is None:
            continue
        if x.dtype != torch.float32 or x.device != dev or not x.is_contiguous():
            raise ValueError(f"combine: {name} must be a contiguous float32 tensor on {dev}")
        ptrs[18 + j] = x.data_ptr()
    if flags & 1 and packed.bitmap_scaling.shape != (n_nodes,) or flags & 4 and packed.mat_color.shape != (n_nodes, 3):
        raise ValueError(f"combine: bitmap_scaling and mat_color must have a row per node ({n_nodes})")
    atlas = packed.bitmap_atlas
    dims = np.array([bitmap_rows, atlas.shape[1] if flags & 1 else 0, atlas.shape[2] if flags & 1 else 0,
                     packed.env_cubemap.shape[1] if flags & 2 else 0], dtype=np.int32)
    refl = flags & 4
    out = (torch.empty((n, 3), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.bool, device=dev) if refl else None,
           *(torch.empty((n, 3), dtype=torch.float32, device=dev) if refl else None for _ in range(3)))
    for j, x in enumerate(out):
        if x is not None:
            ptrs[22 + j] = x.data_ptr()
    ptrs, strides = np.array(ptrs, dtype=np.uint64), np.array(strides, dtype=np.int64)
    at = ptrs.ctypes.data
    args = (table.data_ptr(), n_nodes, table.data_ptr() + 4 * n_nodes, n_tex, dims.ctypes.data, n, at,
            strides.ctypes.data, at + 8 * 22, flags)
    return args, out, (table, dims, ptrs, strides, dirs, tables)


def round0_call(packed: ScenePacked, trace=round0):
    """The frame's round-0 call ``call(lay, prm[, orig, dir], lin=None)``:
    ``trace``, or ``diff_round0`` around it when grad mode is on and a leaf
    of ``packed`` requires grad.  ``lin=(lin_base, n_lanes)`` selects the
    lin-input form, with ``prm`` packed at that base.  Decided once per
    frame, so a forward frame pays nothing per call for the gradient
    machinery.  A bump scene's calls all go to the bump hybrid
    (ops/bump_round0.py), forward frame and gradient alike (the JAX
    package's ``build_trace_round0``)."""
    diff = torch.is_grad_enabled() and any(x.requires_grad for x in leaves(packed))

    def call(lay, prm, *rays, lin=None):
        kw = {} if lin is None else {"lin_input": True, "lin_base": lin[0], "n_lanes": lin[1]}
        if lay.static.has_bump:
            return bump_round0(lay, prm, packed, *rays, trace=trace, **kw)
        if diff:
            return diff_round0(lay, prm, packed, *rays, trace=trace, **kw)
        if lin is not None:
            return trace(lay, prm, lin_input=True, n_lanes=lin[1])
        return trace(lay, prm, *rays)

    return call


def _round(packed, static, lay, prm, carry, call):
    """One bounce round through the ray-input kernel."""
    global bounce_rounds
    bounce_rounds += 1
    with span("c2rt.round"):
        color, at, a, o3, d3 = carry
        o = call(lay, prm, o3.contiguous(), d3.contiguous())
        c, cont, mult, ro, rd = combine_outputs(packed, static, o, d3 if static.has_env else None)
        color = color + torch.where(a[..., None], at * c, 0.0)
        cont = cont & a
        at = at * torch.where(cont[..., None], mult, 1.0)
        o3 = torch.where(cont[..., None], ro, o3)
        d3 = torch.where(cont[..., None], rd, d3)
        return color, at, cont, o3, d3


def build_bounce_finisher(static: SceneStatic, width: int, height: int, n_lanes: int, is_slab: bool = False):
    """Reflection/refraction bounce rounds for an ``n_lanes``-wide ray
    buffer: returns ``finish(packed, prm, color, cont, atten, ro, rd,
    call)``, with ``prm`` the frame's packed parameters at aa offset (0, 0)
    and ``call`` the frame's round-0 call (``round0_call``).  ``is_slab``
    says the buffer is a part of the frame (a chunk slab, a mesh shard, the
    compacted adaptive-AA taps), which sets the block capacity.  The
    ``bounce_mode`` picks the rounds' layout (module docstring); every
    layout gives every lane the same values."""
    from ..render.pipeline import compact_indices

    if not {REFLECTION, REFRACTION} & static.shader_kinds_present:
        return lambda packed, prm, color, *_: color  # no bounce rounds
    rounds = static.max_trace_depth + 1
    n = n_lanes
    lay = layout(static, width, height)
    block_bounce = static.bounce_mode == "block" and n % BOUNCE_BLOCK == 0
    cap = static.bounce_capacity
    compact_bounce = bool(cap and cap < n and static.bounce_mode not in ("block", "full"))
    if compact_bounce:
        cap = -(-cap // TILE_N) * TILE_N  # whole kernel tiles, as JAX's kernel width
    if block_bounce:
        nblk = n // BOUNCE_BLOCK
        lanes_per_tile = TILE_N // BOUNCE_BLOCK
        # the JAX package's capacity, rounded to whole 1024-lane tiles, so
        # both packages take the same branch: ~1/12 of a whole frame's
        # blocks, 1/4 of a slab's (a slab concentrates the frame's
        # reflective set).  Overflow falls back to full-width rounds, never
        # to wrong pixels
        cap_blk = static.bounce_block_capacity or -(-nblk // (4 if is_slab else 12))
        cap_blk = max(lanes_per_tile, -(-cap_blk // lanes_per_tile) * lanes_per_tile)

    def run_rounds(packed, prm, carry, call, site):
        """The rounds on ``carry``, the list [color, atten, alive, orig,
        dir], each round's state replacing the last's in it (so a caller's
        list holds no stale buffers); a round with no live lane (read on the
        host at ``site``) ends them.  -> the color."""
        for _ in range(rounds - 1):
            if not read_any(site, carry[2]):
                break
            carry[:] = _round(packed, static, lay, prm, carry, call)
        return carry[0]

    def fullwidth_bounces(packed, prm, color, alive, atten, orig, dir, call):
        """Bounce rounds at full width; all-dead rounds are skipped."""
        return run_rounds(packed, prm, [color, atten, alive, orig, dir], call, "flagship.full_alive")

    def block_bounces(packed, prm, color, alive, atten0, orig, dir, call):
        """Bounce rounds on a BLOCK-compacted buffer: whole 128-lane blocks
        with any live lane are gathered, rounds run through the ray-input
        kernel at that width, and results add back into their blocks.

        JAX ran its rounds at the fixed capacity ``cap_blk * 128`` with junk
        slots masked off; the host knows the live block count here, so the
        kernel runs at exactly ``count * 128`` lanes — the same values for
        every live lane, and nothing for the junk ones."""
        B = BOUNCE_BLOCK
        blk_alive = alive.reshape(nblk, B).any(dim=1)
        count = read_count("flagship.block_count", blk_alive)
        if count > cap_blk:
            return fullwidth_bounces(packed, prm, color, alive, atten0, orig, dir, call)
        if count == 0:
            return color

        def slab(x):
            return x.reshape((nblk, B) + x.shape[1:])[sel].reshape((count * B,) + x.shape[1:])

        with span("c2rt.gather"):
            sel = compact_indices(blk_alive, nblk, cap_blk)[:count].long()
            carry = [
                torch.zeros((count * B, 3), dtype=color.dtype, device=color.device),
                slab(atten0), slab(alive), slab(orig), slab(dir),
            ]
        added = run_rounds(packed, prm, carry, call, "flagship.block_alive")
        out = color.reshape(nblk, B, 3).clone()
        out.index_add_(0, sel, added.reshape(count, B, 3))
        return out.reshape(n, 3)

    def compact_bounces(packed, prm, color, alive, atten0, orig, dir, call):
        """Bounce rounds on a LANE-compacted buffer of ``cap`` lanes: the
        live lanes' (atten, orig, dir) in one merged row gather, the rounds
        through the ray-input kernel at ``cap`` width (slots past the live
        count dead), the colors added back at the live lanes in ascending
        order.  More live lanes than ``cap``: full-width rounds, counted."""
        global compact_overflows
        count = read_count("flagship.compact_count", alive)  # JAX's lax.cond predicate
        if count > cap:
            compact_overflows += 1
            return fullwidth_bounces(packed, prm, color, alive, atten0, orig, dir, call)
        if count == 0:
            return color
        with span("c2rt.gather"):
            sel = compact_indices(alive, n, cap).long()
            g = torch.cat([atten0, orig, dir], dim=-1)[sel.clamp_max(n - 1)]  # junk slots clamp onto the last lane
        lane_live = torch.arange(cap, device=alive.device) < count
        carry = [torch.zeros((cap, 3), dtype=color.dtype, device=color.device), g[:, 0:3], lane_live, g[:, 3:6],
                 g[:, 6:9]]
        return color.index_add(0, sel[:count], run_rounds(packed, prm, carry, call, "flagship.compact_alive")[:count])

    # each is finish(packed, prm, color, cont, atten, ro, rd, call)
    return block_bounces if block_bounce else compact_bounces if compact_bounce else fullwidth_bounces


def trace_batch(packed: ScenePacked, static: SceneStatic, prm0, finish, call, k1, plan=False, texel_reuse=None):
    """One batch of rays in one ``c2rt.tap`` span: ``k1()`` makes K1's call
    for it and returns (its rows, the rays' directions [n, 3] or None), then
    ``combine_outputs`` (the directions read for a scene with an
    environment) and ``finish``'s bounce rounds (a ``build_bounce_finisher``
    of the batch's width; ``prm0`` and ``call`` as there) -> [n, 3]; with
    ``plan`` also the batch's texel plan, with ``texel_reuse`` a base tap's
    (``combine_reference``)."""
    with span("c2rt.tap"):
        o, dirs = k1()
        out = combine_outputs(packed, static, o, dirs if static.has_env else None, plan, texel_reuse)
        img = finish(packed, prm0, *out[:5], call)
        return (img, out[5]) if plan else img


def trace_rays(packed: ScenePacked, static: SceneStatic, lay, prm0, finish, call, rays):
    """``trace_batch`` through K1's ray-input form: ``rays()`` -> (orig,
    dir) [n, 3], made inside the batch's span, traced at ``prm0``."""

    def k1():
        o3, d3 = rays()
        return call(lay, prm0, o3.contiguous(), d3.contiguous()), d3

    return trace_batch(packed, static, prm0, finish, call, k1)


def _pixel_tap(packed, static, lay, prm0, finish, call, lin, aa):
    """One tap through the ray-input form at the flat pixel indices ``lin``
    ([C] integers) plus the offset ``aa`` -> [C, 3]."""
    return trace_rays(packed, static, lay, prm0, finish, call,
                      lambda: pixel_rays(packed.camera, lay.width, lay.height, lin, aa))


def _slice_dirs(packed: ScenePacked, static: SceneStatic, lay, prm, base: int, n: int):
    """The directions of the rays of pixels [base, base + n) at ``prm``'s aa
    offset (``round0_grad.form_rays``), for the environment term of K1's
    screen-tap and lin-input forms (the JAX package's ``_tap_dirs`` and
    ``_lin_dirs``); None without an environment."""
    return form_rays(packed, lay, prm.detach(), (base, n), ())[1] if static.has_env else None


def _texel_reuse_on(static: SceneStatic, slabs) -> bool:
    """Whether AA taps 1-4 reuse the base tap's texel quads: ``texel_tap_reuse``
    on a quirk-AA frame (or slice) with bitmaps and no chunk slabs, as in
    JAX's flagship and rows renderers."""
    return bool(static.texel_tap_reuse and static.aa_enabled and not static.aa_adaptive and slabs is None
                and TEX_BITMAP in static.tex_kinds_present)


def _chunk_slabs(static: SceneStatic, n: int):
    """(C, S) of a ``chunk_pixels`` pass over ``n`` lanes: S slabs of C lanes,
    C the chunk rounded up to whole 1024-lane tiles, or None when the pass
    is not chunked."""
    if not (static.chunk_pixels and static.chunk_pixels < n):
        return None
    C = -(-static.chunk_pixels // TILE_N) * TILE_N
    return C, -(-n // C)


def _over_slabs(slabs, n: int, batch):
    """A ``chunk_pixels`` pass (memory-bounded: a slab's temporaries, not
    the pass's, set the peak): ``batch(s)`` -> [C, 3] for each of the S
    slabs of ``slabs = (C, S)``, concatenated and cut to the ``n`` lanes
    (the caller's pad lanes re-trace a lane of the pass)."""
    return torch.cat([batch(s) for s in range(slabs[1])])[:n]


def _pass(static: SceneStatic, width: int, height: int, n: int, is_slab: bool = False):
    """(K1's layout, ``_chunk_slabs``, the bounce finisher) of an ``n``-lane
    pass over the frame: the finisher of a slab's width when the pass is
    chunked, else of the pass's (``is_slab`` as in
    ``build_bounce_finisher``)."""
    slabs = _chunk_slabs(static, n)
    if slabs is not None:
        n, is_slab = slabs[0], True
    return layout(static, width, height), slabs, build_bounce_finisher(static, width, height, n, is_slab=is_slab)


def _aa_capacity(cap: int) -> int:
    """The lane capacity of the compacted adaptive-AA taps: whole tiles."""
    return max(TILE_N, -(-cap // TILE_N) * TILE_N)


def _compacted_taps(static: SceneStatic, width: int, height: int, n: int, slabs):
    """(capacity, bounce finisher) of an ``n``-lane pass's lane-compacted
    adaptive-AA taps: the pass's share of the frame's ``aa_capacity`` (or
    1/32 of its lanes) in whole tiles; (None, None) when its adaptive taps
    run full width (no adaptive AA, or slabs)."""
    if not (static.aa_enabled and static.aa_adaptive and slabs is None):
        return None, None
    cap = _aa_capacity(-(-static.aa_capacity * n // (width * height)) if static.aa_capacity else -(-n // 32))
    return cap, build_bounce_finisher(static, width, height, cap, is_slab=True)


def _deterministic_aa(static: SceneStatic, n: int, prm0, a0: int, tap, reuse: bool, adaptive):
    """A deterministic frame (or slice) of ``n`` lanes from ``tap(prm,
    plan=False, texel_reuse=None)`` -> [n, 3], the tap at the parameters
    ``prm`` (with ``plan`` also its texel plan, with ``texel_reuse`` a base
    tap's): the base tap without AA; the reference's quirk AA, every lane
    the average of the 5 taps (``reuse``: taps 1-4 reuse the base tap's
    texel quads); or adaptive AA, ``adaptive(base_tap) -> (base, mask, cap,
    pixel_tap)`` giving the base tap (``base_tap()`` renders it), its
    needs-AA mask, and the compacted taps' capacity and ray-input tap
    ``pixel_tap(selc, aa)`` for ``_adaptive_taps`` (``cap`` None: full
    width)."""
    from ..render.pipeline import AA_KERNEL

    if not static.aa_enabled:
        return tap(prm0)
    # the 5 taps' parameter vectors ([5, n_prm]) differ only in the aa slot:
    # (0, 0), then the four AA_KERNEL offsets
    prms = prm0.repeat(5, 1)
    prms[:, a0:a0 + 2] = torch.tensor(((0.0, 0.0),) + AA_KERNEL, dtype=torch.float32, device=prm0.device)

    def taps(acc, ks, **plan_kw):
        for k in ks:
            acc = acc + tap(prms[k], **plan_kw)
        return acc

    if static.aa_adaptive:
        base, mask, cap, pixel_tap = adaptive(lambda: tap(prm0))

        def add_taps(acc, selc=None):
            if selc is None:
                return taps(acc, range(1, 5))
            for aa in AA_KERNEL:
                acc = acc + pixel_tap(selc, aa)
            return acc

        return _adaptive_taps(base, mask, add_taps, cap)
    if reuse:
        img, plan = tap(prm0, plan=True)
        return taps(img, range(1, 5), texel_reuse=plan) / 5.0
    return taps(torch.zeros((n, 3), dtype=torch.float32, device=prm0.device), range(5)) / 5.0


def _adaptive_taps(base, mask, add_taps, cap=None, site="flagship.aa_count"):
    """The adaptive-AA blend of a base tap ``base`` [n, 3] under the
    needs-AA ``mask`` [n]; ``add_taps(acc, selc=None)`` adds the 4 other
    taps to ``acc``.  ``cap`` None: the taps run full width and the mask
    only selects.  Else, when the flagged pixels fit in ``cap`` lanes (read
    on the host at the sync ``site``), the 4 taps run lane-compacted,
    ``add_taps`` rendering only the flagged lanes ``selc``, and only those
    pixels are replaced; otherwise full width."""
    from ..render.pipeline import compact_indices

    n = mask.shape[0]
    count = read_count(site, mask) if cap is not None else None
    if cap is None or count > cap:
        return torch.where(mask[:, None], add_taps(base) / 5.0, base)
    if count == 0:
        return base
    with span("c2rt.gather"):
        sel = compact_indices(mask, n, cap).long()
        selc = sel.clamp_max(n - 1)  # junk slots re-render the last lane and are dropped
        acc = base[selc]
    acc = add_taps(acc, selc)
    # every compacted lane is flagged; an out-of-place scatter, since the
    # graph may hold ``base``
    return base.index_put((sel[:count],), acc[:count] / 5.0)


def build_flagship_renderer(static: SceneStatic, width: int, height: int, trace=round0, uniform=None):
    """Flagship renderer: fn(packed, key=None) -> [H, W, 3] radiance.

    The deterministic frame (``key`` unused): with or without AA, quirk AA
    (all 5 taps everywhere) or adaptive AA (``aa_adaptive``: the 4 extra
    taps lane-compacted onto the flagged pixels, ``aa_capacity`` lanes or
    1/32 of the frame, full width on overflow), un-chunked or in
    ``chunk_pixels`` slabs.  DoF and stereo frames go to
    ``_build_mc_renderer``, which draws with ``uniform`` (None:
    ``prng.uniform``; its plain version ``prng.uniform_reference`` renders
    the same frame without the threefry kernel).
    Callers dispatch here through render/pipeline.render_frame, which
    raises for every other mode."""
    from ..render.pipeline import aa_detect

    if static.dof or static.stereo:
        return _build_mc_renderer(static, width, height, trace, uniform)
    n = width * height
    lay, slabs, finish = _pass(static, width, height, n)
    a0 = lay.off["aa"]
    reuse = _texel_reuse_on(static, slabs)
    cap_aa, finish_aa = _compacted_taps(static, width, height, n, slabs)

    def render_tap(packed: ScenePacked, prm0, prm_tap, call, plan=False, texel_reuse=None):
        """One tap [n, 3] through the screen-tap form; with ``plan`` also its
        texel plan (for the taps that reuse it), with ``texel_reuse`` a base
        tap's.  In slabs, rays from ``pixel_rays`` into the ray-input
        form, pad lanes clamped onto the last pixel."""
        if slabs is None:
            return trace_batch(packed, static, prm0, finish, call,
                               lambda: (call(lay, prm_tap), _slice_dirs(packed, static, lay, prm_tap, 0, n)),
                               plan, texel_reuse)
        C, aa = slabs[0], prm_tap[a0:a0 + 2].detach()

        def slab(s):  # pad lanes clamp onto the last pixel (recomputed, sliced off)
            lin = torch.arange(s * C, (s + 1) * C, device=prm0.device).clamp_max(n - 1)
            return _pixel_tap(packed, static, lay, prm0, finish, call, lin, aa)

        return _over_slabs(slabs, n, slab)

    def render(packed: ScenePacked, key=None):
        prm0 = lay.pack(packed)
        call = round0_call(packed, trace)

        def tap(prm, **plan_kw):
            return render_tap(packed, prm0, prm, call, **plan_kw)

        def adaptive(base_tap):
            base = base_tap()
            mask = aa_detect(base.reshape(height, width, 3)).reshape(-1)
            return base, mask, cap_aa, lambda selc, aa: _pixel_tap(packed, static, lay, prm0, finish_aa, call, selc, aa)

        return _deterministic_aa(static, n, prm0, a0, tap, reuse, adaptive).reshape(height, width, 3)

    def tap(packed, aa_offset=(0.0, 0.0)):
        prm0 = lay.pack(packed)
        return render_tap(packed, prm0, lay.pack(packed, aa_offset), round0_call(packed, trace))

    render.tap = tap
    return render


def _build_mc_renderer(static: SceneStatic, width: int, height: int, trace, uniform):
    """The DoF / stereo renderer (pallas_trace.build_flagship_renderer's
    ``mc_mode``): fn(packed, key=None) -> [H, W, 3], ``key`` a threefry key
    (None is ``PRNGKey(0)``).  It mirrors the JAX package's XLA sampling
    (render/pipeline.render_samples, _render_pixels) key for key: per AA tap
    a key, per DoF sample ``split(key, 4)`` for the x and y jitter and the
    disc, both eyes of a stereo sample from one key.  Every pass of rays
    goes through K1's ray-input form, at full width or in ``chunk_pixels``
    slabs (pad lanes re-trace the last ray; the slabs do not change the key
    stream, unlike the twin's chunked frame).  Adaptive AA on a DoF frame
    without stereo or slabs lane-compacts the 4 taps to ``aa_capacity`` (or
    1/32 of the frame) lanes when the flagged pixels fit, each sample's
    uniforms drawn at full width and gathered at the flagged lanes; other
    adaptive frames run the taps at full width and blend by the mask.  The
    "fits" decision is made on the host."""
    from ..render.pipeline import AA_KERNEL, _combine_stereo, aa_detect

    n = width * height
    lay, slabs, finish = _pass(static, width, height, n)
    W, H = float(width), float(height)
    # a stereo frame runs its adaptive taps at full width
    cap_mc, finish_aa = (None, None) if static.stereo else _compacted_taps(static, width, height, n, slabs)

    def trace_slabs(packed, prm0, orig, dir, call):
        """A full-width pass's rays in ``chunk_pixels`` slabs."""
        C, n_slabs = slabs
        pad = n_slabs * C - n
        if pad:  # pad lanes re-trace the last ray; sliced off
            orig = torch.cat([orig, orig[-1:].expand(pad, 3)])
            dir = torch.cat([dir, dir[-1:].expand(pad, 3)])
        return _over_slabs(slabs, n, lambda s: trace_rays(packed, static, lay, prm0, finish, call,
                                                          lambda: (orig[s * C:(s + 1) * C], dir[s * C:(s + 1) * C])))

    def render(packed: ScenePacked, key=None):
        draw = uniform or prng.uniform
        key = prng.as_key(key)
        prm0 = lay.pack(packed)
        call = round0_call(packed, trace)
        cam, dt, dev = packed.camera, packed.dtype, packed.device
        frame = begin_frame(cam, width / height)
        lin = torch.arange(n, device=dev)
        xf, yf = (lin % width).to(dt), (lin // width).to(dt)
        offsets = torch.tensor(AA_KERNEL, dtype=dt, device=dev)
        eyes = (-1.0, +1.0) if static.stereo else (0.0,)

        def samples(xx, yy, k, selc=None):
            """The pixels' passes: one, or ``dof_samples`` under DoF, each
            its ray-gen (everything before its first K1 call) and trace.
            With ``selc`` the pixels are the flagged lanes of the compacted
            adaptive taps, on the FULL-WIDTH stream: each uniform drawn at
            (n,) and gathered at ``selc``."""

            def at(kk):
                u = draw(kk, (n,), dt, device=dev)
                return u if selc is None else u[selc]

            def trace_eye(o3, d3):
                if selc is None and slabs is not None:
                    return trace_slabs(packed, prm0, o3, d3, call)
                fin = finish if selc is None else finish_aa
                return trace_rays(packed, static, lay, prm0, fin, call, lambda: (o3, d3))

            def rays():
                """A pass's (orig, dir), one pair per eye; under DoF the jitter
                and the disc drawn from the next sample's keys off ``k``."""
                nonlocal k
                jx, jy, uv = xx, yy, None
                if static.dof:
                    k, kj, kj2, kr = prng.split(k, 4)
                    jx, jy = xx + at(kj), yy + at(kj2)
                    uv = tuple(at(kd) for kd in prng.split(kr))  # both eyes draw the same
                return [screen_rays(cam, frame, W, H, jx, jy, e, dof=static.dof, disc_uv=uv) for e in eyes]

            def one_pass():
                with _mc_pass():
                    with span("c2rt.raygen"):
                        eye_rays = rays()
                    out = [trace_eye(o3, d3) for o3, d3 in eye_rays]
                    return _combine_stereo(*out) if static.stereo else out[0]

            if not static.dof:
                return one_pass()
            acc = torch.zeros(xx.shape + (3,), dtype=dt, device=dev)
            for _ in range(static.dof_samples):
                acc = acc + one_pass()
            return acc / static.dof_samples

        def add_taps(acc, selc=None):
            """AA taps 1-4, each from a key split off the frame's: at full
            width, or on the flagged lanes ``selc``."""
            xx, yy, k = xf, yf, key
            if selc is not None:
                xx, yy = (selc % width).to(dt), (selc // width).to(dt)
            for off in offsets:
                k, kk = prng.split(k)
                acc = acc + samples(xx + off[0], yy + off[1], kk, selc)
            return acc

        key, k0 = prng.split(key)
        img = samples(xf, yf, k0)
        if not static.aa_enabled:
            return img.reshape(height, width, 3)
        if not static.aa_adaptive:
            return (add_taps(img) / 5.0).reshape(height, width, 3)
        mask = aa_detect(img.reshape(height, width, 3)).reshape(-1)
        return _adaptive_taps(img, mask, add_taps, cap_mc, "flagship.mc_aa_count").reshape(height, width, 3)

    render.tap = None  # a Monte-Carlo frame has no single deterministic tap
    return render


def build_rows_renderer(static: SceneStatic, width: int, height: int, n_lanes: int, trace=round0):
    """The flagship renderer for ONE contiguous slice of the flat pixel
    grid: the per-shard body of the sharded renderer (parallel/mesh.py).

    Returns ``rows(packed, lin_base, mask=None, base=None) -> [n_lanes, 3]``
    rendering pixels [lin_base, lin_base + n_lanes).  Ray-gen happens in the
    kernel from the lane base (K1's lin-input form), so a lane does what the
    whole-frame kernel's lane of the same pixel does.  Lanes past the
    frame's last pixel render pixels below the frame; the caller slices
    them off.  ``rows.tap(packed, lin_base, aa_offset)`` is the single tap
    (the sharded adaptive-AA base pass).

    * quirk AA (``aa_adaptive`` off): every pixel averages the 5 taps;
    * adaptive AA: the caller computes the needs-AA mask on the WHOLE frame
      (the detect reads neighbours across slices) and passes this slice's
      ``mask``; the 4 extra taps lane-compact within the slice, through the
      ray-input form at the flagged lanes' GLOBAL pixel indices.
      ``base=None`` re-renders the base tap inside the graph, so unflagged
      pixels keep their gradient (gradient callers rely on this);
    * ``chunk_pixels`` is honoured per slice (slabs through the lin-input
      form at bases ``lin_base + C * s``; adaptive taps then run full width
      with the mask selecting).

    Deterministic Whitted scenes only (``supports(static)``, no DoF, stereo
    or GI)."""
    if not supports(static) or static.dof or static.stereo:
        raise ValueError("build_rows_renderer: deterministic Whitted scenes that the round-0 kernel covers only")
    n = n_lanes
    lay, slabs, finish = _pass(static, width, height, n, is_slab=n < width * height)
    a0, l0 = lay.off["aa"], lay.off["lin"]
    reuse = _texel_reuse_on(static, slabs)
    cap_aa, finish_aa = _compacted_taps(static, width, height, n, slabs)

    def lin_tap(packed, prm0, prm_tap, base, lanes, call, plan=False, texel_reuse=None):
        """One tap of ``lanes`` pixels from ``base`` through the lin-input
        form (``plan`` and ``texel_reuse`` as in ``trace_batch``)."""

        def k1():
            prm = prm_tap.clone()
            prm[l0] = float(exact_lane_base(base))
            return call(lay, prm, lin=(base, lanes)), _slice_dirs(packed, static, lay, prm_tap, base, lanes)

        return trace_batch(packed, static, prm0, finish, call, k1, plan, texel_reuse)

    def render_tap(packed, prm0, prm_tap, lin_base, call, **plan_kw):
        if slabs is None:
            return lin_tap(packed, prm0, prm_tap, lin_base, n, call, **plan_kw)
        C = slabs[0]
        return _over_slabs(slabs, n, lambda s: lin_tap(packed, prm0, prm_tap, lin_base + C * s, C, call))

    def rows(packed: ScenePacked, lin_base: int, mask=None, base=None):
        lin_base = exact_lane_base(lin_base)
        prm0 = lay.pack(packed)
        call = round0_call(packed, trace)

        def tap(prm, **plan_kw):
            return render_tap(packed, prm0, prm, lin_base, call, **plan_kw)

        def adaptive(base_tap):
            if mask is None:
                raise ValueError("rows: adaptive AA needs this slice of the whole frame's needs-AA mask")
            return (base_tap() if base is None else base), mask, cap_aa, lambda selc, aa: _pixel_tap(
                packed, static, lay, prm0, finish_aa, call, lin_base + selc, aa)

        return _deterministic_aa(static, n, prm0, a0, tap, reuse, adaptive)

    def tap(packed, lin_base, aa_offset=(0.0, 0.0)):
        prm0 = lay.pack(packed)
        return render_tap(packed, prm0, lay.pack(packed, aa_offset), exact_lane_base(lin_base),
                          round0_call(packed, trace))

    rows.tap = tap
    return rows
