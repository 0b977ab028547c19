"""Frame rendering (renderer.d:83-189, :254-376).

Counterpart of chess2rt_tpu/render/pipeline.py.  Two paths render a
deterministic Whitted frame:

* the fused path (ops/flagship.py): K1, the hand-written round-0 kernel, per
  AA tap plus torch glue.  ``render_frame`` takes it for float32 frames of
  the scenes K1 covers (``ops/round0.supports``);
* the eager Whitted twin of the JAX package's XLA wavefront
  (``render_frame_wavefront``): ``trace_whitted`` runs maxTraceDepth + 1
  wavefront rounds over the whole ray batch with an ``alive`` mask, each
  round ``scene_closest`` (ops/geometry.py), ``shade_direct`` and the
  reflection / refraction spawn.  ``render_frame`` takes it for float64
  frames (on the device the scene is on; the card has float64) and for
  every scene K1 does not cover.  The JAX package computes it in XLA
  outside any Pallas call, so it is plain PyTorch here, and it is the
  reference path of those frames, as in JAX.

The JAX package's round loops translate as: ``lax.scan`` over rounds -> a Python loop
that skips a round whose wavefront is all dead (one host read of the
alive mask per round), ``fast_forward``'s ``while_loop`` -> the same loop
stopping at the first dead round, ``lax.cond`` compaction in
``continue_bounces`` -> a host decision on the live count.
``remat_rounds`` becomes ``torch.utils.checkpoint`` around each round when
a gradient is recorded (recomputed in the backward, shadow scans included:
torch has no counterpart of the JAX policy that saves only the shadow bits).
Everything stays differentiable by autograd in every ScenePacked leaf.

Not ported yet, each raising NotImplementedError naming its ROADMAP.md
item: GI (item 8), DoF and stereo (item 7, with the RNG), bump maps (item
9), environment cubemaps and compensated ray-gen (item 10).  ``key`` is
accepted for the JAX signatures and unused: the deterministic Whitted
path draws no random numbers.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.packed import LAMBERT, PHONG, REFLECTION, REFRACTION, ScenePacked, SceneStatic, pack_scene
from ..ops import geometry as G
from ..ops import shade as S
from ..ops.camera import begin_frame, screen_rays

INF = G.INF

# AA kernel offsets (renderer.d:235-242); sample 0 is the pass-2 sample.
AA_KERNEL = ((0.3, 0.3), (0.6, 0.0), (0.0, 0.6), (0.6, 0.6))


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------------------
# Whitted trace (renderer.d:325-376)
# --------------------------------------------------------------------------


def _whitted_round(packed, static, color, atten, alive, orig, dir, recursive):
    """One wavefront round: closest hit, direct shade, spawn the
    continuation.  Returns the updated carry (color, atten, alive, orig,
    dir)."""
    if static.has_bump:
        raise NotImplementedError("bump maps are not ported yet (ROADMAP.md queue 1 item 9: Bump)")
    eps = S.shadow_eps(orig.dtype)
    hit, win = G.scene_closest(packed, static, orig, dir)
    hitmask = alive & (win >= 0)
    winc = torch.clamp_min(win, 0)
    skind = S.shader_kind_of(static, winc)

    direct = S.shade_direct(packed, static, dir, hit, winc)
    is_direct = (skind == LAMBERT) | (skind == PHONG)
    color = color + atten * torch.where((hitmask & is_direct)[..., None], direct, 0.0)
    # a miss is black (environment.d:5-15); the cubemap skybox is the env
    # extension
    if static.has_env:
        raise NotImplementedError("environment cubemaps are not ported yet (ROADMAP.md queue 1 item 10)")

    if not recursive:
        return color, atten, torch.zeros_like(alive), orig, dir

    onehot = S.node_onehot(static, winc)
    N = S.faceforward(dir, hit["normal"])
    refl_dir = _norm(dir - 2.0 * dot(dir, N)[..., None] * N)
    new_orig = hit["p"] + N * eps
    new_dir = refl_dir

    if REFRACTION in static.shader_kinds_present:
        ior = S.node_gather(onehot, packed.mat_ior)
        cos_in = -dot(dir, hit["normal"])
        entering = cos_in > 0
        eta = torch.where(entering, 1.0 / ior, ior)
        n_face = torch.where(entering[..., None], hit["normal"], -hit["normal"])
        ci = torch.abs(cos_in)
        k = 1.0 - eta * eta * (1.0 - ci * ci)
        tir = k < 0
        # _safe_sqrt: a clamped derivative at the TIR boundary k = 0
        refr = eta[..., None] * dir + (eta * ci - G._safe_sqrt(torch.clamp_min(k, 0.0)))[..., None] * n_face
        refr_dir = torch.where(tir[..., None], refl_dir, _norm(refr))
        refr_orig = torch.where(tir[..., None], hit["p"] + n_face * eps, hit["p"] - n_face * eps)
        is_refr = skind == REFRACTION
        new_dir = torch.where(is_refr[..., None], refr_dir, new_dir)
        new_orig = torch.where(is_refr[..., None], refr_orig, new_orig)

    continuing = hitmask & ((skind == REFLECTION) | (skind == REFRACTION))
    atten = atten * torch.where(continuing[..., None], S.node_gather(onehot, packed.mat_color), 1.0)
    orig = torch.where(continuing[..., None], new_orig, orig)
    dir = torch.where(continuing[..., None], new_dir, dir)
    return color, atten, continuing, orig, dir


def trace_whitted(packed: ScenePacked, static: SceneStatic, orig, dir):
    """Radiance [N, 3] for a batch of primary rays.

    A scene without reflective or refractive nodes runs one round;
    otherwise ``_run_rounds``, or round 0 at full width and then
    ``continue_bounces`` when ``static.bounce_capacity`` is set.  (The JAX
    package's ``stats`` counters, read by its TPU benchmark only, are not
    ported.)"""
    recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if recursive else 1
    carry = (
        torch.zeros_like(orig),  # color
        torch.ones_like(orig),  # attenuation (the BRDF product)
        torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device),  # alive
        orig,
        dir,
    )
    if not recursive:
        return _whitted_round(packed, static, *carry, False)[0]

    if not _compacts(static, orig):
        return _run_rounds(packed, static, carry, rounds)[0]
    # round 0 at full width, then the live set through the compaction path
    carry = _whitted_round(packed, static, *carry, True)
    return continue_bounces(packed, static, *carry, n_rounds=rounds - 1)


def _compacts(static, orig) -> bool:
    """True when the bounce rounds after round 0 go through the
    ``static.bounce_capacity`` compaction (a flat batch wider than it)."""
    cap = static.bounce_capacity
    return bool(cap) and orig.dim() == 2 and cap < orig.shape[0]


def _one_round(packed, static):
    def run(color, atten, alive, orig, dir):
        return _whitted_round(packed, static, color, atten, alive, orig, dir, True)

    return run


def _run_rounds(packed, static, carry, n_rounds):
    """``n_rounds`` more rounds.  A round whose wavefront is all dead is the
    identity (every contribution is alive-masked), so it is skipped; with
    ``static.fast_forward`` the loop stops there, which is the same since
    the live set only shrinks.  Both read the alive mask on the host."""
    run = _one_round(packed, static)
    remat = static.remat_rounds and torch.is_grad_enabled()
    for _ in range(n_rounds):
        if not bool(carry[2].any()):
            if static.fast_forward:
                break
            continue
        carry = checkpoint(run, *carry, use_reentrant=False) if remat else run(*carry)
    return carry


def compact_indices(alive, n: int, cap: int):
    """sel[j] = flat index of the j-th live lane in ascending order; junk
    slots past the live count hold the out-of-range sentinel ``n``."""
    keys = torch.where(alive, torch.arange(n, dtype=torch.int32, device=alive.device), n)
    out = torch.sort(keys).values
    if cap <= n:
        return out[:cap]
    return torch.cat([out, torch.full((cap - n,), n, dtype=torch.int32, device=alive.device)])


def continue_bounces(packed, static, color, atten, alive, orig, dir, n_rounds):
    """``n_rounds`` more rounds on an already-shaded state, the live set
    compacted into a ``static.bounce_capacity``-lane buffer when it fits
    (decided on the host); when it overflows, full-width rounds.  Gather
    and index_add are differentiable, so gradients take either branch."""
    if n_rounds <= 0:
        return color
    n, cap = orig.shape[0], static.bounce_capacity
    count = int(alive.sum()) if _compacts(static, orig) else None  # host sync: JAX's lax.cond predicate
    if count is None or count > cap:
        out = _run_rounds(packed, static, (torch.zeros_like(color), atten, alive, orig, dir), n_rounds)
        return color + out[0]
    sel = compact_indices(alive, n, cap).long()
    lane_live = torch.arange(cap, device=alive.device) < count  # slots past the live set are dead
    # one merged row gather; junk slots clamp onto the last lane, as JAX's gather does
    g = torch.cat([atten, orig, dir], dim=-1)[sel.clamp_max(n - 1)]
    sub = (torch.zeros((cap, 3), dtype=color.dtype, device=color.device), g[:, 0:3], lane_live, g[:, 3:6], g[:, 6:9])
    out = _run_rounds(packed, static, sub, n_rounds)
    # the live slots scatter back; the junk ones (JAX's dropped out-of-range updates) are left out
    return color.index_add(0, sel[:count], out[0][:count])


# --------------------------------------------------------------------------
# Per-pixel sampling (renderer.d:254-313)
# --------------------------------------------------------------------------


def _check_ported(static: SceneStatic, who: str):
    """Raise for a frame whose mode is not ported yet, naming its ROADMAP item."""
    todo = (
        "GI (ROADMAP.md queue 1 item 8)" if static.gi_enabled
        else "DoF and stereo (ROADMAP.md queue 1 item 7)" if static.dof or static.stereo
        else "bump maps (ROADMAP.md queue 1 item 9)" if static.has_bump
        else "environment cubemaps (ROADMAP.md queue 1 item 10)" if static.has_env
        else "compensated ray-gen (ROADMAP.md queue 1 item 10)" if static.compensated_raygen
        else None
    )
    if todo is not None:
        raise NotImplementedError(f"{who}: {todo} is not ported yet")


def render_samples(packed: ScenePacked, static: SceneStatic, frame, x, y, key=None, dx=1.0, dy=1.0):
    """renderSample for a batch of (fractional) pixel coordinates -> [N, 3],
    the deterministic branch: one pinhole ray per coordinate through
    ``trace_whitted``.  The Monte-Carlo branch (DoF, GI, stereo) raises.
    (The JAX package's ``trace_fn`` / ``gi_trace_fn`` hooks serve its mesh
    layer's XLA per-shard sampler, not ported.)"""
    del key, dx, dy
    if static.dof or static.stereo or static.gi_enabled:
        raise NotImplementedError(
            "render_samples: the Monte-Carlo branch (DoF, stereo: ROADMAP.md queue 1 item 7; GI: item 8) "
            "is not ported yet"
        )
    o, d = screen_rays(packed.camera, frame, float(static.width), float(static.height), x, y)
    return trace_whitted(packed, static, o, d)


def aa_detect(img):
    """The reference's needs-AA detect pass (renderer.d:150-178): a pixel
    is flagged when any member of its clamped 5-point neighbourhood differs
    from the neighbourhood average by too_different's default 0.1 threshold
    (AAThreshold is never forwarded, the renderer.d:172 quirk).  Accumulated
    in f32 like the reference's Color.  [H, W, 3] -> [H, W] bool, detached
    from the graph (the mask is a discrete decision)."""
    from ..utils.color import too_different

    f32 = img.detach().to(torch.float32)
    neighs = [
        f32,
        torch.cat([f32[:, :1], f32[:, :-1]], dim=1),  # x-1 (clamped)
        torch.cat([f32[:, 1:], f32[:, -1:]], dim=1),  # x+1
        torch.cat([f32[:1, :], f32[:-1, :]], dim=0),  # y-1
        torch.cat([f32[1:, :], f32[-1:, :]], dim=0),  # y+1
    ]
    # the JAX package sums from Python's 0: ((((0 + a) + b) + c) + d) + e
    avg = (neighs[0] + neighs[1] + neighs[2] + neighs[3] + neighs[4]) / 5.0
    needs = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
    for nb in neighs:
        needs = needs | too_different(nb, avg)
    return needs


def _offsets(like):
    """AA_KERNEL in the frame's dtype (JAX rounds the offsets first)."""
    return torch.tensor(AA_KERNEL, dtype=like.dtype, device=like.device)


def _flat_pass(packed: ScenePacked, static: SceneStatic, frame, xf, yf, fn=render_samples):
    """``fn(packed, static, frame, x, y)`` over a flat pixel batch, in
    ``chunk_pixels`` slabs when that is set (pad lanes render pixel (0, 0)
    and are cut)."""
    n = xf.numel()
    c = static.chunk_pixels
    if not c or c >= n:
        return fn(packed, static, frame, xf, yf)
    pad = (-n) % c
    xs = torch.cat([xf, xf.new_zeros(pad)]).reshape(-1, c)
    ys = torch.cat([yf, yf.new_zeros(pad)]).reshape(-1, c)
    return torch.cat([fn(packed, static, frame, xs[i], ys[i]) for i in range(xs.shape[0])])[:n]


def _render_pixels(packed: ScenePacked, static: SceneStatic, frame, xf, yf):
    """Base sample plus the AA taps for one flat pixel batch."""
    img = render_samples(packed, static, frame, xf, yf)
    if static.aa_enabled:
        acc = img
        for off in _offsets(xf):
            acc = acc + render_samples(packed, static, frame, xf + off[0], yf + off[1])
        img = acc / 5.0
    return img


def render_frame_wavefront(packed: ScenePacked, static: SceneStatic, key=None):
    """The eager Whitted twin of the JAX package's XLA frame (its
    ``render_frame`` with ``use_pallas`` off) -> [H, W, 3] in the scene's
    dtype, on its device: quirk AA (5 taps everywhere), adaptive AA (the 4
    extra taps where ``aa_detect`` flags the base frame) and
    ``chunk_pixels`` slabs, which bound peak memory by the slab."""
    del key
    _check_ported(static, "render_frame_wavefront")
    dt = packed.dtype
    W, H = static.width, static.height
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=packed.device),
                            torch.arange(W, dtype=dt, device=packed.device), indexing="ij")
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    frame = begin_frame(packed.camera, W / H)

    if static.aa_enabled and static.aa_adaptive:
        base = _flat_pass(packed, static, frame, xf, yf)
        mask = aa_detect(base.reshape(H, W, 3)).reshape(-1)
        acc = base
        for off in _offsets(xf):
            acc = acc + _flat_pass(packed, static, frame, xf + off[0], yf + off[1])
        return torch.where(mask[:, None], acc / 5.0, base).reshape(H, W, 3)
    return _flat_pass(packed, static, frame, xf, yf, _render_pixels).reshape(H, W, 3)


def render_frame(packed: ScenePacked, static: SceneStatic, key=None):
    """Full-frame render -> [H, W, 3] on the scene's device: the fused path
    (K1) for float32 frames of the scenes ``ops/round0.supports`` covers,
    the eager Whitted twin (``render_frame_wavefront``) for every other
    frame it renders.  A covered scene with more CSG hits per ray than K1's
    ``round0.MAX_HITS`` raises in ``round0.scene_program``."""
    from ..ops.round0 import supports

    _check_ported(static, "render_frame")
    if packed.dtype != torch.float32 or not supports(static):
        return render_frame_wavefront(packed, static, key)
    from ..ops.flagship import build_flagship_renderer

    return build_flagship_renderer(static, static.width, static.height)(packed)


def render_scene(scene, dtype=torch.float32, key=None, fix=None, device=None):
    """Pack a host Scene and render one frame (the JAX package's
    ``render_scene_jax``).  ``device=None`` is the card (see
    ``models.packed.pack_scene``); ``fix`` maps the SceneStatic."""
    packed, static = pack_scene(scene, dtype=dtype, device=device)
    if fix is not None:
        static = fix(static)
    with torch.no_grad():
        return render_frame(packed, static, key)
