"""Frame rendering (renderer.d:83-189, :254-376).

Counterpart of chess2rt_tpu/render/pipeline.py.  Two paths render a
Whitted frame, deterministic or Monte-Carlo (depth of field, stereo):

* the fused path (ops/flagship.py): K1, the hand-written round-0 kernel, per
  AA tap (per sample and eye under DoF and stereo) plus torch glue.
  ``render_frame`` takes it for float32 frames of the scenes K1 covers
  (``ops/round0.supports``);
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
``continue_bounces`` -> a host decision on the live count.  Each host read
goes through ``utils/spans.read_any`` or ``read_count``, counted by site.
``remat_rounds`` becomes ``torch.utils.checkpoint`` around each round when
a gradient is recorded (recomputed in the backward, shadow scans included:
torch has no counterpart of the JAX policy that saves only the shadow bits).
Everything stays differentiable by autograd in every ScenePacked leaf.

The ray counters of the JAX package (``stats``: camera, shadow and bounce
rays, read by ``utils/diagnostics.frame_ray_stats`` for rays/s) are kept as
0-d tensors on the device and read once by their reader; a frame rendered
with them is the frame rendered without.  ``render_samples``' ``trace_fn``
and ``gi_trace_fn`` hooks let the mesh layer's per-shard sampler trace
through K1 (parallel/mesh.py).

The random streams are the JAX package's: ``key`` is a threefry key of
ops/prng.py (the default ``PRNGKey(0)``), split per sample, AA tap and
chunk slab in the JAX order, and every draw is ``prng.uniform``, bit-equal
to ``jax.random.uniform``, so a DoF, stereo or GI frame matches JAX's under
the same key.

GI (global illumination) frames path-trace: ``trace_path`` is the eager
twin of the JAX package's XLA path tracer (one path per ray, maxTraceDepth
+ 1 bounces, the Lambert hemisphere sample drawn from the path's key);
``render_frame`` sends the float32 frames of all-Lambert scenes
(``ops/round0.supports_gi``) to the fused GI renderer (ops/gi.py: K1's
want_hit ray-input form per bounce) and every other GI frame to the twin,
as JAX dispatches.  A GI scene with DoF renders DoF Whitted samples, as in
JAX.

The extensions: bump maps (``_whitted_round`` perturbs the winning normal
by ``ops/shade.apply_bump`` before shading and the continuation; GI ignores
bump, like the oracle's path tracer), the environment cubemap (a miss
samples ``ops/env.sample_cubemap``, in the Whitted rounds and as GI's miss
term) and the compensated ray-gen (``compensated_raygen``: df32 screen
corners, ops/df32.py, an opt-in of this path only: the fused paths refuse
it in ``supports``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.packed import LAMBERT, PHONG, REFLECTION, REFRACTION, ScenePacked, SceneStatic, pack_scene
from ..ops import geometry as G
from ..ops import prng
from ..ops import shade as S
from ..ops.camera import begin_frame, screen_rays
from ..ops.env import sample_cubemap
from ..utils.spans import read_any, read_count, span

INF = G.INF

# frames rendered by the eager twin (``render_frame_wavefront``); callers
# zero and read it, to tell that a frame took the fused path
wavefront_frames = 0

# AA kernel offsets (renderer.d:235-242); sample 0 is the pass-2 sample.
AA_KERNEL = ((0.3, 0.3), (0.6, 0.0), (0.0, 0.6), (0.6, 0.6))


def _norm(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------------------
# Whitted trace (renderer.d:325-376)
# --------------------------------------------------------------------------


def _count(stats, name, n):
    """Add ``n`` rays (a 0-d tensor on the device, or a number) to counter
    ``name``: no host read, the reader converts once."""
    stats[name] = stats.get(name, 0) + n


def _whitted_round(packed, static, color, atten, alive, orig, dir, recursive, stats=None, r=0):
    """One wavefront round: closest hit, direct shade, spawn the
    continuation.  Returns the updated carry (color, atten, alive, orig,
    dir).  ``stats`` counts the round's shadow rays (one per lit shading
    point per light, shader.d:88) and, after round 0 (``r``), its bounce
    rays (the live lanes)."""
    eps = S.shadow_eps(orig.dtype)
    hit, win = G.scene_closest(packed, static, orig, dir, tangents=static.has_bump)
    hitmask = alive & (win >= 0)
    winc = torch.clamp_min(win, 0)
    geom_normal = None
    if static.has_bump:
        # the bump hook (renderer.d:370-372): the winning normal is perturbed
        # before shading and before the continuation below; the geometric
        # normal stays the shadow origin's offset
        geom_normal = hit["normal"]
        hit = dict(hit, normal=S.apply_bump(packed, static, winc, hit))
    skind = S.shader_kind_of(static, winc)

    direct = S.shade_direct(packed, static, dir, hit, winc, geom_normal)
    is_direct = (skind == LAMBERT) | (skind == PHONG)
    color = color + atten * torch.where((hitmask & is_direct)[..., None], direct, 0.0)
    # a miss is black (environment.d:5-15), or the cubemap skybox of the env
    # extension
    if static.has_env:
        env = sample_cubemap(packed.env_cubemap, dir)
        color = color + atten * torch.where((alive & (win < 0))[..., None], env, 0.0)

    if stats is not None:
        _count(stats, "shadow", (hitmask & is_direct).sum() * static.n_lights)
        if r > 0:
            _count(stats, "bounce", alive.sum())

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


def trace_whitted(packed: ScenePacked, static: SceneStatic, orig, dir, stats=None):
    """Radiance [N, 3] for a batch of primary rays.

    A scene without reflective or refractive nodes runs one round;
    otherwise ``_run_rounds``, or round 0 at full width and then
    ``continue_bounces`` when ``static.bounce_capacity`` is set.

    ``stats`` (a dict) accumulates traced-ray counts: "camera" primary rays
    (a number), "shadow" and "bounce" rays (0-d tensors on the rays'
    device; see ``_whitted_round``).  With it, every round runs at full
    width, none skipped and nothing compacted, so counting reads nothing on
    the host (the JAX package's statically unrolled rounds)."""
    recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if recursive else 1
    carry = (
        torch.zeros_like(orig),  # color
        torch.ones_like(orig),  # attenuation (the BRDF product)
        torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device),  # alive
        orig,
        dir,
    )
    if stats is not None:
        _count(stats, "camera", float(orig[..., 0].numel()))
        for r in range(rounds):
            carry = _whitted_round(packed, static, *carry, recursive, stats, r)
        return carry[0]
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
        if not read_any("pipeline.rounds_alive", carry[2]):
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
    count = read_count("pipeline.compact_count", alive) if _compacts(static, orig) else None  # JAX's lax.cond
    if count is None or count > cap:
        out = _run_rounds(packed, static, (torch.zeros_like(color), atten, alive, orig, dir), n_rounds)
        return color + out[0]
    lane_live = torch.arange(cap, device=alive.device) < count  # slots past the live set are dead
    with span("c2rt.gather"):
        sel = compact_indices(alive, n, cap).long()
        # one merged row gather; junk slots clamp onto the last lane, as JAX's gather does
        g = torch.cat([atten, orig, dir], dim=-1)[sel.clamp_max(n - 1)]
    sub = (torch.zeros((cap, 3), dtype=color.dtype, device=color.device), g[:, 0:3], lane_live, g[:, 3:6], g[:, 6:9])
    out = _run_rounds(packed, static, sub, n_rounds)
    # the live slots scatter back; the junk ones (JAX's dropped out-of-range updates) are left out
    return color.index_add(0, sel[:count], out[0][:count])


# --------------------------------------------------------------------------
# GI path trace (renderer.d:378-463), Lambert BRDF (shader.d:107-135)
# --------------------------------------------------------------------------


def env_miss_term(packed: ScenePacked, static: SceneStatic, alive, win, dir, mult_eff):
    """GI's miss term: a live path that misses adds the environment cubemap
    in its direction, weighted by ``mult_eff`` (renderer.d:396-397; black,
    so nothing, without a cubemap).  Shared by ``trace_path`` and the fused
    GI tracer (ops/gi.py)."""
    return torch.where((alive & (win < 0))[..., None], mult_eff * sample_cubemap(packed.env_cubemap, dir), 0.0)


def hemisphere_bounce(mult, N, diffuse, u, v):
    """Lambert.spawnRay (shader.d:118-135): the uniform hemisphere direction
    ``w`` about ``N`` from the uniforms ``u``, ``v``, and the path
    multiplier times its BRDF weight, color_eval / pdf (diffuse / pi * cos
    over 1 / (2 pi)), in the JAX package's op order: (w, new mult).  The
    fused GI tracer's bounce kernel (csrc/gi_bounce.cu) computes the same,
    op for op in float32."""
    theta = 2 * torch.pi * u
    phi = torch.arccos(torch.clamp(2 * v - 1, -1.0, 1.0)) - torch.pi / 2
    w = torch.stack([torch.cos(theta) * torch.cos(phi), torch.sin(phi), torch.sin(theta) * torch.cos(phi)], dim=-1)
    w = torch.where(dot(w, N)[..., None] < 0, -w, w)
    color_eval = diffuse * (1 / torch.pi) * torch.clamp_min(dot(w, N), 0.0)[..., None]
    return w, mult * color_eval / (1 / (2 * torch.pi))


def trace_path(packed: ScenePacked, static: SceneStatic, orig, dir, key):
    """One GI path per input ray -> radiance [N, 3]: the eager twin of the
    JAX package's XLA ``trace_path``, maxTraceDepth + 1 bounces, ``key``
    (a threefry key) split in three per bounce for the hemisphere sample,
    as JAX's scan does, so the paths are JAX's under the same key.  Each
    bounce is ``scene_closest`` over every node, then:

    * ``gi_multiplier_quirk`` (default on): the reference drops the path
      multiplier at every recursion (renderer.d:356), so a bounce's terms
      are not weighted by its throughput;
    * ``gi_point_light_direct`` (the NEE extension): the point lights'
      direct term through a shadow ray each; without it the reference's
      direct term is exactly 0 (a point light's solid angle is 0,
      light.d:72-75);
    * a path that hits a Phong node adds solid red, unscaled, and ends: the
      reference asserts in Phong's BRDF (shader.d:252-261), and this is its
      bogus-BRDF marker (renderer.d:457);
    * a path that misses adds the environment cubemap (``env_miss_term``).

    Bump maps are ignored, as in the oracle's path tracer.

    A bounce whose paths are all dead adds nothing and changes nothing, so
    the loop stops there (one host read of the alive mask per bounce)."""
    for ns in static.nodes:  # Phong paints the marker below; no other shader has a BRDF to sample
        if ns.shader_kind not in (LAMBERT, PHONG):
            raise NotImplementedError(
                "GI requires BRDF eval/spawnRay; only Lambert has them (extension shaders have none)"
            )
    has_phong_gi = any(ns.shader_kind == PHONG for ns in static.nodes)
    eps = S.shadow_eps(orig.dtype)
    acc = torch.zeros_like(orig)
    mult = torch.ones_like(orig)
    alive = torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device)
    key = prng.as_key(key)
    for r in range(static.max_trace_depth + 1):
        if r and not read_any("pipeline.path_alive", alive):  # the rest of the bounces are no-ops
            break
        hit, win = G.scene_closest(packed, static, orig, dir)
        hitmask = alive & (win >= 0)
        winc = torch.clamp_min(win, 0)
        if has_phong_gi:
            phong_hit = hitmask & (S.shader_kind_of(static, winc) == PHONG)
            red = torch.tensor([1.0, 0.0, 0.0], dtype=orig.dtype, device=orig.device)
            acc = acc + torch.where(phong_hit[..., None], red, 0.0)
            hitmask = hitmask & ~phong_hit  # marker painted; path ends
        N = S.faceforward(dir, hit["normal"])
        diffuse = S.texture_color(packed, static, winc, hit["u"], hit["v"])
        mult_eff = torch.ones_like(mult) if static.gi_multiplier_quirk else mult
        if static.has_env:
            acc = acc + env_miss_term(packed, static, alive, win, dir, mult_eff)
        if static.gi_point_light_direct:
            shade_from = hit["p"] + N * eps
            for li in range(static.n_lights):
                lp = packed.light_pos[li]
                lc = packed.light_color[li] * packed.light_power[li]
                vis = G.test_visibility(packed, static, shade_from, torch.broadcast_to(lp, shade_from.shape))
                to_light = lp - hit["p"]
                ld = _norm(to_light)
                brdf = diffuse * (1 / torch.pi) * torch.clamp_min(dot(ld, N), 0.0)[..., None]
                term = lc * brdf / dot(to_light, to_light)[..., None]
                acc = acc + torch.where((hitmask & vis)[..., None], mult_eff * term, 0.0)
        key, k1, k2 = prng.split(key, 3)
        u = prng.uniform(k1, hit["u"].shape, orig.dtype, device=orig.device)
        v = prng.uniform(k2, hit["u"].shape, orig.dtype, device=orig.device)
        w, mult = hemisphere_bounce(mult, N, diffuse, u, v)
        orig = torch.where(hitmask[..., None], hit["p"] + N * eps, orig)
        dir = torch.where(hitmask[..., None], w, dir)
        alive = hitmask
    return acc


# --------------------------------------------------------------------------
# Per-pixel sampling (renderer.d:254-313)
# --------------------------------------------------------------------------


def render_samples(packed: ScenePacked, static: SceneStatic, frame, x, y, key=None, dx=1.0, dy=1.0,
                   stats=None, trace_fn=None, gi_trace_fn=None):
    """renderSample for a batch of (fractional) pixel coordinates -> [N, 3]
    (renderer.d:254-313).  Deterministic: one pinhole ray per coordinate
    through ``trace_whitted`` (two with stereo, combined).  With DoF, the
    Monte-Carlo loop: ``dof_samples`` samples, each splitting the key in
    four for the x and y jitter (scaled by ``dx``, ``dy``) and the disc
    sample, as JAX's ``lax.scan`` does; GI runs ``paths_per_pixel`` samples
    the same way, each one path through ``trace_path``.  Dispatch order as
    renderSample's: DoF first (a GI scene with DoF traces Whitted DoF
    samples), then GI (mono: stereo is ignored), then stereo.

    ``trace_fn(packed, orig, dir, stats)`` and ``gi_trace_fn(packed, orig,
    dir, key)`` replace the Whitted and the GI tracer while this function
    keeps its ray-gen and random streams: the mesh layer's per-shard
    sampler plugs K1 in this way (parallel/mesh.py).  ``stats`` counts the
    traced rays (``trace_whitted``); in the Monte-Carlo modes only the
    camera rays, a number known before the loop, as in JAX."""
    cam = packed.camera
    W, H = float(static.width), float(static.height)
    key = prng.as_key(key)

    def whitted(p, o, d, st=None):
        return trace_whitted(p, static, o, d, st)

    whitted = trace_fn or whitted

    def trace_one(xx, yy, k, st=None):
        if static.gi_enabled and not static.dof:
            o, d = screen_rays(cam, frame, W, H, xx, yy, 0.0)
            if gi_trace_fn is not None:
                return gi_trace_fn(packed, o, d, k)
            return trace_path(packed, static, o, d, k)
        if static.stereo:
            ol, dl = screen_rays(cam, frame, W, H, xx, yy, -1.0, dof=static.dof, key=k)
            orr, drr = screen_rays(cam, frame, W, H, xx, yy, +1.0, dof=static.dof, key=k)
            return _combine_stereo(whitted(packed, ol, dl, st), whitted(packed, orr, drr, st))
        o, d = screen_rays(cam, frame, W, H, xx, yy, 0.0, dof=static.dof, key=k)
        return whitted(packed, o, d, st)

    if not (static.dof or static.gi_enabled):
        return trace_one(x, y, key, stats)
    n_samples = static.dof_samples if static.dof else static.paths_per_pixel
    if stats is not None:
        _count(stats, "camera", float(x.numel() * n_samples * (2 if static.stereo else 1)))
    acc = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
    for _ in range(n_samples):
        key, kj, kj2, kr = prng.split(key, 4)
        jx = x + prng.uniform(kj, x.shape, x.dtype, device=x.device) * dx
        jy = y + prng.uniform(kj2, y.shape, y.dtype, device=y.device) * dy
        acc = acc + trace_one(jx, jy, kr)
    return acc / n_samples


def _combine_stereo(left, right):
    """Anaglyph combine (color.d:10-15): red from the left eye, green and
    blue from the right, each a quarter of its color and three quarters of
    its gray."""
    l = left * 0.25 + left.mean(-1, keepdim=True) * 0.75
    r = right * 0.25 + right.mean(-1, keepdim=True) * 0.75
    mask_l = torch.tensor([1.0, 0.0, 0.0], dtype=left.dtype, device=left.device)
    mask_r = torch.tensor([0.0, 1.0, 1.0], dtype=left.dtype, device=left.device)
    return l * mask_l + r * mask_r


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


def _flat_pass(packed: ScenePacked, static: SceneStatic, frame, xf, yf, key, fn=render_samples):
    """``fn(packed, static, frame, x, y, key)`` over a flat pixel batch, in
    ``chunk_pixels`` slabs when that is set: one key per slab from
    ``split(key, slabs)``, as JAX's chunked body (pad lanes render pixel
    (0, 0) and are cut)."""
    n = xf.numel()
    c = static.chunk_pixels
    if not c or c >= n:
        return fn(packed, static, frame, xf, yf, key)
    pad = (-n) % c
    xs = torch.cat([xf, xf.new_zeros(pad)]).reshape(-1, c)
    ys = torch.cat([yf, yf.new_zeros(pad)]).reshape(-1, c)
    keys = prng.split(key, xs.shape[0])
    return torch.cat([fn(packed, static, frame, xs[i], ys[i], keys[i]) for i in range(xs.shape[0])])[:n]


def _render_pixels(packed: ScenePacked, static: SceneStatic, frame, xf, yf, key):
    """Base sample plus the AA taps for one flat pixel batch, a key each."""
    key, k0 = prng.split(key)
    img = render_samples(packed, static, frame, xf, yf, k0)
    if static.aa_enabled:
        acc = img
        for off in _offsets(xf):
            key, kk = prng.split(key)
            acc = acc + render_samples(packed, static, frame, xf + off[0], yf + off[1], kk)
        img = acc / 5.0
    return img


def render_frame_wavefront(packed: ScenePacked, static: SceneStatic, key=None):
    """The eager twin of the JAX package's XLA frame (its ``render_frame``
    with ``use_pallas`` off; Whitted rounds, or ``trace_path`` for GI) ->
    [H, W, 3] in the scene's dtype, on its device: quirk AA (5 taps everywhere), adaptive AA (the 4
    extra taps where ``aa_detect`` flags the base frame) and
    ``chunk_pixels`` slabs, which bound peak memory by the slab; DoF and
    stereo with the JAX key streams (``key`` None is ``PRNGKey(0)``; an
    un-chunked adaptive frame splits as ``_render_pixels`` does, so its
    flagged pixels take the quirk path's values)."""
    global wavefront_frames
    wavefront_frames += 1
    key = prng.as_key(key)
    dt = packed.dtype
    W, H = static.width, static.height
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=packed.device),
                            torch.arange(W, dtype=dt, device=packed.device), indexing="ij")
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    frame = begin_frame(packed.camera, W / H, compensated=static.compensated_raygen)

    if static.aa_enabled and static.aa_adaptive:
        key, k0 = prng.split(key)
        base = _flat_pass(packed, static, frame, xf, yf, k0)
        mask = aa_detect(base.reshape(H, W, 3)).reshape(-1)
        acc = base
        for off in _offsets(xf):
            key, kk = prng.split(key)
            acc = acc + _flat_pass(packed, static, frame, xf + off[0], yf + off[1], kk)
        return torch.where(mask[:, None], acc / 5.0, base).reshape(H, W, 3)
    return _flat_pass(packed, static, frame, xf, yf, key, _render_pixels).reshape(H, W, 3)


def render_frame(packed: ScenePacked, static: SceneStatic, key=None):
    """Full-frame render -> [H, W, 3] on the scene's device, dispatched in
    the JAX package's order for float32 frames: the fused Whitted path (K1)
    for the scenes ``ops/round0.supports`` covers, DoF and stereo included,
    then the fused GI renderer (ops/gi.py) for the GI scenes
    ``ops/round0.supports_gi`` covers; the eager twin
    (``render_frame_wavefront``, ``trace_path`` for GI) for every other
    frame it renders, float64 included.  ``key`` (a threefry key of
    ops/prng.py; None is ``PRNGKey(0)``) seeds the Monte-Carlo frames.
    Under a running ``torch.profiler`` the call is the span ``c2rt.frame``
    (utils/spans.py)."""
    from ..ops.round0 import supports, supports_gi

    with span("c2rt.frame"):
        if packed.dtype == torch.float32 and supports(static):
            from ..ops.flagship import build_flagship_renderer

            return build_flagship_renderer(static, static.width, static.height)(packed, key)
        if packed.dtype == torch.float32 and supports_gi(static):
            from ..ops.gi import build_gi_renderer

            return build_gi_renderer(static, static.width, static.height)(packed, key)
        return render_frame_wavefront(packed, static, key)


def render_scene(scene, dtype=torch.float32, key=None, fix=None, device=None):
    """Pack a host Scene and render one frame (the JAX package's
    ``render_scene_jax``).  ``device=None`` is the card (see
    ``models.packed.pack_scene``); ``fix`` maps the SceneStatic."""
    packed, static = pack_scene(scene, dtype=dtype, device=device)
    if fix is not None:
        static = fix(static)
    with torch.no_grad():
        return render_frame(packed, static, key)
