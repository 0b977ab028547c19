"""The flagship forward renderer: round-0 kernel taps + torch glue.

Counterpart of the renderer half of chess2rt_tpu/ops/pallas_trace.py
(``combine_outputs``, ``build_bounce_finisher``, ``build_flagship_renderer``)
for the un-chunked, deterministic 5-tap Whitted frame:

    for each AA tap:   round0 (screen-tap)  ->  combine_outputs (deferred
                       bitmap quad gather, continuation carry)  ->  bounce
                       rounds: round0 (ray-input) on a block-compacted
                       buffer, full width when it overflows

Where JAX decided "all rounds dead" and "compacted buffer overflows" on the
device with ``lax.cond``, this port reads the two counts on the host
(``.item()``): one device sync per bounce round and one per tap.  That is
acceptable in bring-up; a later PR can keep the decision on the device.

Every round-0 call goes through one function, ``trace``: the wrapper
``round0`` by default (the CUDA kernel for CUDA tensors), or its plain
version ``round0_reference`` to render the same frame without the kernel.
When a gradient of the scene is wanted (decided once per frame by
``round0_call``), each call goes through ``round0_grad.diff_round0``
around ``trace``: K1's residual form forward, the leaf-pinned re-shade
backward, so the frame is differentiable in every ScenePacked leaf (the
in-place ``index_add_`` and aa-slot writes below are on tensors autograd
tracks).  A forward frame calls ``trace`` directly.
``bounce_rounds`` counts the bounce rounds run, so a caller can tell how
many kernel launches a frame should have made.
"""

from __future__ import annotations

import torch

from ..models.packed import REFLECTION, REFRACTION, TEX_BITMAP, ScenePacked, SceneStatic, leaves
from . import shade as S
from .round0 import BOUNCE_BLOCK, TILE_N, layout, round0
from .round0_grad import diff_round0

# bounce rounds run (each is one round-0 call); callers zero and read it
bounce_rounds = 0


def combine_outputs(packed: ScenePacked, static: SceneStatic, o, dirs_or_none=None):
    """Kernel outputs -> (direct color incl. deferred bitmap texels,
    continuation mask, attenuation factor, refl orig, refl dir)."""
    has_bitmap = TEX_BITMAP in static.tex_kinds_present
    has_refl = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    if static.has_env and dirs_or_none is not None:
        raise NotImplementedError(
            "combine_outputs: environment cubemaps are not ported yet (ROADMAP.md queue 1 item 10)"
        )
    win = o["win"]
    color = torch.stack([o["r"], o["g"], o["b"]], dim=-1)
    winc = torch.clamp_min(win, 0)
    onehot = S.node_onehot(static, winc) if (has_bitmap or has_refl) else None
    if has_bitmap:
        tex = S.bitmap_color(packed, static, winc, o["u"], o["v"], onehot)
        L = torch.stack([o["lr"], o["lg"], o["lb"]], dim=-1)
        is_bmp = (S.tex_kind_of(static, winc) == TEX_BITMAP) & (win >= 0)
        color = color + torch.where(is_bmp[..., None], tex * L, 0.0)
    if not has_refl:
        return color, None, None, None, None
    skind = S.shader_kind_of(static, winc)
    cont = (win >= 0) & ((skind == REFLECTION) | (skind == REFRACTION))
    atten = torch.where(cont[..., None], S.node_gather(onehot, packed.mat_color), 1.0)
    ro = torch.stack([o["rox"], o["roy"], o["roz"]], dim=-1)
    rd = torch.stack([o["rdx"], o["rdy"], o["rdz"]], dim=-1)
    return color, cont, atten, ro, rd


def round0_call(packed: ScenePacked, trace=round0):
    """The frame's round-0 call ``(lay, prm[, orig, dir]) -> outputs``:
    ``trace`` itself, or ``diff_round0`` around it when grad mode is on and
    a leaf of ``packed`` requires grad.  Decided once per frame, so a
    forward frame pays nothing per call for the gradient machinery."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves(packed)):
        return lambda lay, prm, *rays: diff_round0(lay, prm, packed, *rays, trace=trace)
    return trace


def _round(packed, static, lay, prm, carry, call):
    """One bounce round through the ray-input kernel."""
    global bounce_rounds
    bounce_rounds += 1
    color, at, a, o3, d3 = carry
    o = call(lay, prm, o3.contiguous(), d3.contiguous())
    c, cont, mult, ro, rd = combine_outputs(packed, static, o)
    color = color + torch.where(a[..., None], at * c, 0.0)
    cont = cont & a
    at = at * torch.where(cont[..., None], mult, 1.0)
    o3 = torch.where(cont[..., None], ro, o3)
    d3 = torch.where(cont[..., None], rd, d3)
    return color, at, cont, o3, d3


def build_bounce_finisher(static: SceneStatic, width: int, height: int, n_lanes: int):
    """Reflection/refraction bounce rounds for an ``n_lanes``-wide ray
    buffer: returns ``finish(packed, prm, color, cont, atten, ro, rd,
    call)``, with ``prm`` the frame's packed parameters at aa offset (0, 0)
    and ``call`` the frame's round-0 call (``round0_call``)."""
    from ..render.pipeline import compact_indices

    has_refl = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if has_refl else 1
    n = n_lanes
    lay = layout(static, width, height)
    block_bounce = has_refl and static.bounce_mode == "block" and n % BOUNCE_BLOCK == 0
    if block_bounce:
        nblk = n // BOUNCE_BLOCK
        lanes_per_tile = TILE_N // BOUNCE_BLOCK
        # the JAX package's capacity (~1/12 of the frame's blocks, rounded to
        # whole 1024-lane tiles), so both packages take the same branch
        cap_blk = static.bounce_block_capacity or -(-nblk // 12)
        cap_blk = max(lanes_per_tile, -(-cap_blk // lanes_per_tile) * lanes_per_tile)

    def fullwidth_bounces(packed, prm, color, atten, alive, orig, dir, n_rounds, call):
        """Bounce rounds at full width; all-dead rounds are skipped."""
        carry = (color, atten, alive, orig, dir)
        for _ in range(n_rounds):
            if not bool(carry[2].any()):  # host sync (see module docstring)
                break
            carry = _round(packed, static, lay, prm, carry, call)
        return carry[0]

    def block_bounces(packed, prm, color, atten0, alive, orig, dir, n_rounds, call):
        """Bounce rounds on a BLOCK-compacted buffer: whole 128-lane blocks
        with any live lane are gathered, rounds run through the ray-input
        kernel at that width, and results add back into their blocks.

        JAX ran its rounds at the fixed capacity ``cap_blk * 128`` with junk
        slots masked off; the host knows the live block count here, so the
        kernel runs at exactly ``count * 128`` lanes — the same values for
        every live lane, and nothing for the junk ones."""
        B = BOUNCE_BLOCK
        blk_alive = alive.reshape(nblk, B).any(dim=1)
        count = int(blk_alive.sum())  # host sync (see module docstring)
        if count > cap_blk:
            return fullwidth_bounces(packed, prm, color, atten0, alive, orig, dir, n_rounds, call)
        if count == 0:
            return color
        sel = compact_indices(blk_alive, nblk, cap_blk)[:count].long()

        def slab(x):
            return x.reshape((nblk, B) + x.shape[1:])[sel].reshape((count * B,) + x.shape[1:])

        carry = (
            torch.zeros((count * B, 3), dtype=color.dtype, device=color.device),
            slab(atten0), slab(alive), slab(orig), slab(dir),
        )
        for _ in range(n_rounds):
            if not bool(carry[2].any()):  # host sync (see module docstring)
                break
            carry = _round(packed, static, lay, prm, carry, call)
        out = color.reshape(nblk, B, 3).clone()
        out.index_add_(0, sel, carry[0].reshape(count, B, 3))
        return out.reshape(n, 3)

    def finish(packed, prm, color, cont, atten, ro, rd, call):
        if not has_refl:
            return color
        if block_bounce:
            return block_bounces(packed, prm, color, atten, cont, ro, rd, rounds - 1, call)
        return fullwidth_bounces(packed, prm, color, atten, cont, ro, rd, rounds - 1, call)

    return finish


def build_flagship_renderer(static: SceneStatic, width: int, height: int, trace=round0):
    """Flagship forward renderer: fn(packed) -> [H, W, 3] radiance.

    Covers the un-chunked, deterministic (non-MC, non-adaptive) frame, with
    or without the 5 AA taps; callers dispatch here through
    render/pipeline.render_frame, which raises for every other mode."""
    from ..render.pipeline import AA_KERNEL

    n = width * height
    lay = layout(static, width, height)
    finish = build_bounce_finisher(static, width, height, n)
    a0 = lay.off["aa"]

    def render_tap(packed: ScenePacked, prm0, prm_tap, call):
        o = call(lay, prm_tap)
        color, cont, atten, ro, rd = combine_outputs(packed, static, o)
        return finish(packed, prm0, color, cont, atten, ro, rd, call)

    def render(packed: ScenePacked):
        prm0 = lay.pack(packed)
        call = round0_call(packed, trace)
        if not static.aa_enabled:
            return render_tap(packed, prm0, prm0, call).reshape(height, width, 3)
        # the 5 taps' parameter vectors differ only in the aa slot
        offsets = torch.tensor(((0.0, 0.0),) + AA_KERNEL, dtype=torch.float32, device=prm0.device)
        prms = prm0.repeat(len(offsets), 1)
        prms[:, a0:a0 + 2] = offsets
        img = torch.zeros((n, 3), dtype=torch.float32, device=prm0.device)
        for k in range(len(offsets)):
            img = img + render_tap(packed, prm0, prms[k], call)
        return (img / 5.0).reshape(height, width, 3)

    render.tap = lambda packed, aa_offset=(0.0, 0.0): render_tap(
        packed, lay.pack(packed), lay.pack(packed, aa_offset), round0_call(packed, trace)
    )
    return render
