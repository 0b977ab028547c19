"""The fused GI renderer: K1's want_hit ray-input form per bounce, then one
fused bounce kernel (or its torch glue).

Counterpart of chess2rt_tpu/ops/pallas_trace.py:2144-2434 (``supports_gi``,
here ``ops/round0.supports_gi``; ``build_gi_tracer``; ``build_gi_renderer``):
the global-illumination path tracer of all-Lambert scenes, mirroring the
twin ``render/pipeline.trace_path`` op for op with the same random streams,
so the two agree to the kernel's float differences.

    per path:    jittered camera rays (screen_rays)  ->  per bounce:
                 round0 (ray-input, want_hit: win, t, raw normal, diffuse,
                 light sum)  ->  deferred bitmap texels and the
                 environment's miss term in torch  ->  the NEE term
                 diffuse / pi * (L - ambient), the two draws, the
                 hemisphere sample and the path's next ray: one launch of
                 csrc/gi_bounce.cu (``gi_bounce``), or the torch glue
                 (``bounce_reference``)

* ``build_gi_tracer``: the kernel-backed ``trace_path`` for K path-slabs
  of C rays with a key each ([K * C, 3] rays, keys [K, 2]): each bounce one
  K1 call over all K * C lanes (``round0``, the CUDA kernel for CUDA
  tensors), then ``trace_path``'s key chain per slab (each slab's key split
  in three, two draws: for K > 1 one batched draw over the slabs,
  ``prng.uniform_keys``).  K1's light sum L includes the ambient term
  (``shade_direct``'s base) and uses the same faceforward normal and shadow
  origin as the twin's NEE, so the NEE term is diffuse / pi * (L - ambient).
* The bounce after K1 takes the fused kernel ``gi_bounce`` when the rays
  are on a CUDA device, ``trace`` is ``round0``, ``uniform`` is None and no
  gradient is recorded (``diff_round0``'s own test: grad mode on and a ray
  or a scene leaf requiring grad); it draws u and v inline, bit-equal to
  ``prng.uniform_keys``, and updates the path state in place.  Otherwise
  ``bounce_reference``, the same arithmetic as differentiable torch ops
  (the CPU, the plain frame, the GI step, ``gi_remat_paths``' recompute).
* ``build_gi_renderer``: the Monte-Carlo loop over ``paths_per_pixel``
  paths (each ``split(key, 4)``: the x and y jitter and the path), quirk AA
  (5 taps everywhere) or adaptive AA (the 4 extra taps at full width, the
  ``aa_detect`` mask selecting), un-chunked or in ``chunk_pixels`` slabs
  with the JAX package's per-slab key splits (slabs of exactly
  ``chunk_pixels`` lanes, pad lanes rendering pixel (0, 0), since a draw's
  values depend on its width).  ``gi_path_batch`` = K traces K paths per
  K1 launch: the sequential key chain is unrolled K times per batch, so
  slab j of batch i draws what path i * K + j draws one path at a time,
  and the batch's K slabs are summed into the frame; the frame equals the
  one-path frame but for that order of summation (the JAX package's own
  test holds the two within 1e-5, tests/test_gi.py:153-169).

Where JAX skipped an all-dead bounce with ``lax.cond``, the port reads the
alive mask on the host: one ``.any()`` per bounce after the first, over all
K * C lanes (``utils/spans.read_any``, counted by site).  Under a running
``torch.profiler`` each batch of K paths carries a ``c2rt.tap`` span, each
bounce a ``c2rt.round`` span and each fused bounce kernel a
``c2rt.gi_bounce`` span.  When a gradient is recorded, each K1
call goes through ``round0_grad.diff_round0`` (K1's residual form forward,
the leaf-pinned re-shade backward, which also recomputes the hit rows), and
``gi_remat_paths`` wraps each batch of K paths in
``torch.utils.checkpoint`` (recomputed in the backward instead of keeping
every bounce's rows; keys are host values and every decision is
deterministic, so the recompute takes the same branches and draws the same
bits).  ``bounce_rounds`` counts the bounce rounds run (one K1 call each),
so a K-path batch counts its rounds once; ``bounce_kernels`` and
``glue_bounces`` split them by the path that finished them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.packed import TEX_BITMAP, ScenePacked, SceneStatic, leaves
from . import prng
from . import shade as S
from .camera import begin_frame, screen_rays
from .round0 import layout, round0, supports_gi
from .round0_grad import diff_round0
from ..utils.spans import read_any, span

# GI bounce rounds run (each is one round-0 call), and of them the rounds
# finished by csrc/gi_bounce.cu (one launch each) and by the torch glue:
# bounce_rounds == bounce_kernels + glue_bounces.  Callers zero and read them.
bounce_rounds = 0
bounce_kernels = 0
glue_bounces = 0


def _draw(uniform, keys, C, dtype, device):
    """[K * C] uniforms, slab j the draw of C under ``keys[j]``: ``uniform``
    (None: ``prng.uniform``) for one key; for more, ``prng.uniform_keys`` (one
    launch), or with ``uniform`` given its K draws concatenated."""
    if len(keys) == 1:
        return (uniform or prng.uniform)(keys[0], (C,), dtype, device=device)
    if uniform is None:
        return prng.uniform_keys(keys, C, dtype, device=device)
    return torch.cat([uniform(k, (C,), dtype, device=device) for k in keys])


def bounce_reference(static: SceneStatic, o, diffuse, ambient, orig, dir, mult, acc, alive, u, v, eps: float):
    """One bounce round after K1 in torch, the plain version of
    ``gi_bounce``: from K1's rows ``o`` (``diffuse`` the [n, 3] albedo with
    the bitmap texels gathered, or None for K1's rows), the scene's
    ``ambient``, the path state (orig, dir, mult, acc [n, 3], alive [n]) and
    the uniforms ``u``, ``v`` [n]: the NEE term of the lanes that hit
    (``gi_point_light_direct``), the hemisphere sample and its weight (every
    lane) and the next ray of the lanes that hit.  Returns the new (orig,
    dir, mult, acc, alive); differentiable, nothing in place."""
    global glue_bounces
    from ..render.pipeline import hemisphere_bounce

    glue_bounces += 1
    normal = torch.stack([o["nx"], o["ny"], o["nz"]], dim=-1)
    if diffuse is None:
        diffuse = torch.stack([o["dr"], o["dg"], o["db"]], dim=-1)
    hitmask = alive & (o["win"] >= 0)
    N = S.faceforward(dir, normal)
    if static.gi_point_light_direct:
        mult_eff = torch.ones_like(mult) if static.gi_multiplier_quirk else mult
        nee = diffuse * (1.0 / torch.pi) * (torch.stack([o["lr"], o["lg"], o["lb"]], dim=-1) - ambient)
        acc = acc + torch.where(hitmask[..., None], mult_eff * nee, 0.0)
    w, mult = hemisphere_bounce(mult, N, diffuse, u, v)
    ts = torch.where(hitmask, o["t"], 0.0)
    p = orig + dir * ts[..., None]
    orig = torch.where(hitmask[..., None], p + N * eps, orig)
    dir = torch.where(hitmask[..., None], w, dir)
    return orig, dir, mult, acc, hitmask


# K1's rows that csrc/gi_bounce.cu reads, in its order (then the albedo, win
# and the ambient colour)
_ROWS = ("t", "nx", "ny", "nz", "lr", "lg", "lb")


def gi_bounce(static: SceneStatic, o, diffuse, ambient, orig, dir, mult, acc, alive, keys_u, keys_v, eps: float):
    """``bounce_reference`` in one launch of csrc/gi_bounce.cu, with the
    draws inline: u and v are ``prng.uniform_keys(keys_u, C)`` and
    ``prng.uniform_keys(keys_v, C)`` ([K, 2] keys, C = n / K lanes a slab),
    bit for bit.  Float32 CUDA tensors, K1's rows as ``round0`` returns
    them; the path state (orig, dir, mult, acc [n, 3], contiguous; alive
    [n] bool) is updated in place and returned as ``bounce_reference``
    returns it.  Records nothing for autograd: the tracer calls it only
    when no gradient is recorded.  A ``c2rt.gi_bounce`` span under a
    running profiler; ``bounce_kernels`` counts the launches."""
    global bounce_kernels
    from .. import cuda_build

    with span("c2rt.gi_bounce"):
        args, _hold = bounce_args(static, o, diffuse, ambient, orig, dir, mult, acc, alive, keys_u, keys_v, eps)
        cuda_build.launch("gi_bounce", "c2rt_gi_bounce", orig.device, *args)
        bounce_kernels += 1
    return orig, dir, mult, acc, alive


def bounce_args(static: SceneStatic, o, diffuse, ambient, orig, dir, mult, acc, alive, keys_u, keys_v, eps: float):
    """``gi_bounce``'s inputs checked and marshalled for csrc/gi_bounce.cu:
    (``c2rt_gi_bounce``'s arguments but the stream, the host arrays and
    tensors they point into, to be held until the launch)."""
    ku, kv = np.asarray(keys_u, dtype=np.uint32), np.asarray(keys_v, dtype=np.uint32)
    K, n, dev = ku.shape[0] if ku.ndim == 2 else 0, orig.shape[0], orig.device
    if ku.shape != (K, 2) or kv.shape != (K, 2) or not 1 <= K <= prng.MAX_KEYS or n % K:
        raise ValueError(f"gi_bounce: {n} lanes and keys {ku.shape}, {kv.shape}: want two [K, 2] tables, "
                         f"1 <= K <= {prng.MAX_KEYS} dividing the lanes")
    state = (orig, dir, mult, acc, alive)
    for name, x in zip(("orig", "dir", "mult", "acc", "alive"), state):
        shape, dtype = ((n,), torch.bool) if name == "alive" else ((n, 3), torch.float32)
        if x.dtype != dtype or x.shape != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"gi_bounce: {name} must be a contiguous {list(shape)} {dtype} tensor on {dev}")
    if diffuse is None:
        albedo, stride = [o[k].data_ptr() for k in ("dr", "dg", "db")], 1
    elif diffuse.dtype != torch.float32 or diffuse.shape != (n, 3) or not diffuse.is_contiguous():
        raise ValueError(f"gi_bounce: diffuse must be a contiguous [{n}, 3] float32 tensor")
    else:
        albedo, stride = [diffuse.data_ptr() + 4 * k for k in range(3)], 3
    ambient = ambient.to(device=dev, dtype=torch.float32).contiguous()
    # K1's rows, the albedo, win and the ambient colour (12), then the path state (5)
    ptrs = np.array([o[k].data_ptr() for k in _ROWS] + albedo + [o["win"].data_ptr(), ambient.data_ptr()]
                    + [x.data_ptr() for x in state], dtype=np.uint64)
    keys = np.array([ku, kv])  # [2, K, 2]: u's table, then v's
    flags = int(static.gi_multiplier_quirk) | 2 * int(static.gi_point_light_direct)
    at = keys.ctypes.data, ptrs.ctypes.data
    args = (at[0], at[0] + 8 * K, K, n // K, at[1], stride, at[1] + 8 * 12, eps, flags)
    return args, (keys, ptrs, ambient)


def build_gi_tracer(static: SceneStatic, width: int, height: int, trace=round0, uniform=None):
    """The kernel-backed ``trace_path``: ``tracer(packed, orig, dir, keys,
    prm=None) -> [K * C, 3]`` for K path-slabs of C rays, one path each,
    ``keys`` the slabs' threefry keys ([K, 2]; one key [2] is K = 1),
    ``prm`` the scene's packed parameters (``tracer.layout.pack(packed)``,
    packed on each call when None).  ``trace`` is K1's call (``round0``, or
    its plain version ``round0_reference``), ``uniform`` the draw (None:
    ``prng.uniform``, batched ``prng.uniform_keys``; with the plain version
    ``prng.uniform_reference``, its draws concatenated).  Each bounce ends
    in ``gi_bounce`` or ``bounce_reference``, as the module docstring says."""
    from ..render.pipeline import env_miss_term

    if not supports_gi(static):
        raise ValueError("build_gi_tracer: all-Lambert GI scenes without DoF only (see supports_gi())")
    lay = layout(static, width, height, want_hit=True)
    has_bitmap = TEX_BITMAP in static.tex_kinds_present

    def bitmap_diffuse(packed, o):
        """The diffuse albedo [n, 3] with the bitmap texels gathered (K1
        defers them)."""
        winc = torch.clamp_min(o["win"], 0)
        tex = S.bitmap_color(packed, static, winc, o["u"], o["v"], S.node_onehot(static, winc))
        diffuse = torch.stack([o["dr"], o["dg"], o["db"]], dim=-1)
        return torch.where((S.tex_kind_of(static, winc) == TEX_BITMAP)[..., None], tex, diffuse)

    def tracer(packed: ScenePacked, orig, dir, keys, prm=None):
        global bounce_rounds
        keys = np.asarray(keys, dtype=np.uint32)
        keys = prng.as_keys(keys[None] if keys.shape == (2,) else keys)
        if orig.shape[0] % keys.shape[0]:
            raise ValueError(f"GI tracer: {orig.shape[0]} rays do not split into {keys.shape[0]} path-slabs")
        C = orig.shape[0] // keys.shape[0]
        prm = lay.pack(packed) if prm is None else prm
        eps = S.shadow_eps(orig.dtype)
        fused = (orig.is_cuda and trace is round0 and uniform is None
                 and not (torch.is_grad_enabled() and any(t.requires_grad for t in (orig, dir, *leaves(packed)))))
        if fused:  # the path's own rays: the kernel updates them in place
            orig, dir = (x.clone(memory_format=torch.contiguous_format) for x in (orig, dir))
        acc = torch.zeros_like(orig)
        mult = torch.ones_like(orig)
        alive = torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device)
        for r in range(static.max_trace_depth + 1):
            if r and not read_any("gi.alive", alive):  # JAX's lax.cond predicate
                break
            bounce_rounds += 1
            with span("c2rt.round"):
                rays = (orig.contiguous(), dir.contiguous())
                o = diff_round0(lay, prm, packed, *rays, trace=trace)  # the plain call when nothing requires grad
                diffuse = bitmap_diffuse(packed, o) if has_bitmap else None
                if static.has_env:
                    mult_eff = torch.ones_like(mult) if static.gi_multiplier_quirk else mult
                    acc = acc + env_miss_term(packed, static, alive, o["win"], dir, mult_eff)
                sp = np.stack([prng.split(k, 3) for k in keys])  # per slab: its chain, u's key, v's key
                keys = sp[:, 0]
                state = (orig, dir, mult, acc, alive)
                if fused:
                    state = gi_bounce(static, o, diffuse, packed.ambient, *state, sp[:, 1], sp[:, 2], eps)
                else:
                    u = _draw(uniform, sp[:, 1], C, orig.dtype, orig.device)
                    v = _draw(uniform, sp[:, 2], C, orig.dtype, orig.device)
                    state = bounce_reference(static, o, diffuse, packed.ambient, *state, u, v, eps)
                orig, dir, mult, acc, alive = state
        return acc

    tracer.layout = lay
    return tracer


def build_gi_renderer(static: SceneStatic, width: int, height: int, trace=round0, uniform=None):
    """The fused GI renderer: fn(packed, key=None) -> [H, W, 3], ``key`` a
    threefry key (None is ``PRNGKey(0)``), mirroring the twin's
    ``render_samples`` Monte-Carlo loop and AA key for key.  ``trace`` and
    ``uniform`` as in ``build_gi_tracer``.  ``static.gi_path_batch`` = K
    traces K paths per launch (``paths_per_pixel`` a multiple of K, else
    ValueError).  Callers dispatch here through render/pipeline.render_frame
    for the scenes ``supports_gi`` covers."""
    from ..render.pipeline import AA_KERNEL, aa_detect

    tracer = build_gi_tracer(static, width, height, trace, uniform)
    n = width * height
    paths = static.paths_per_pixel
    K = static.gi_path_batch or 1
    if K < 1 or paths % K:
        raise ValueError(f"gi_path_batch {K} must divide paths_per_pixel {paths}")
    chunked = bool(static.chunk_pixels and static.chunk_pixels < n)
    C = static.chunk_pixels if chunked else n
    n_slabs = -(-n // C)

    def render(packed: ScenePacked, key=None):
        key = prng.as_key(key)
        dt, dev = packed.dtype, packed.device
        frame = begin_frame(packed.camera, width / height)
        prm = tracer.layout.pack(packed)
        lin = torch.arange(n, device=dev)
        xf, yf = (lin % width).to(dt), (lin // width).to(dt)
        offsets = torch.tensor(AA_KERNEL, dtype=dt, device=dev)
        remat = static.gi_remat_paths and torch.is_grad_enabled()

        def batch(xx, yy, kj, kj2, kr):
            """K paths of the C pixels (xx, yy): K jittered slabs traced in
            one call, summed over the slabs."""
            with span("c2rt.tap"):
                jx = (xx + _draw(uniform, kj, C, dt, dev).reshape(K, C)).reshape(K * C)
                jy = (yy + _draw(uniform, kj2, C, dt, dev).reshape(K, C)).reshape(K * C)
                o3, d3 = screen_rays(packed.camera, frame, float(width), float(height), jx, jy, 0.0)
                out = tracer(packed, o3, d3, kr, prm)
                return out if K == 1 else out.reshape(K, C, 3).sum(0)

        def samples(xx, yy, k):
            acc = torch.zeros(xx.shape + (3,), dtype=dt, device=dev)
            for _ in range(paths // K):
                ks = []
                for _ in range(K):  # the sequential chain, unrolled: path i * K + j's keys
                    k, kj, kj2, kr = prng.split(k, 4)
                    ks.append((kj, kj2, kr))
                kj, kj2, kr = (np.stack(x) for x in zip(*ks))
                if remat:
                    acc = acc + checkpoint(batch, xx, yy, kj, kj2, kr, use_reentrant=False)
                else:
                    acc = acc + batch(xx, yy, kj, kj2, kr)
            return acc / paths

        def padded(a):
            return torch.cat([a, a.new_zeros(n_slabs * C - n)]).reshape(n_slabs, C)

        def flat_pass(xx, yy, k):
            """``samples`` over the frame, slab by slab with a key each."""
            keys = prng.split(k, n_slabs)
            xs, ys = padded(xx), padded(yy)
            return torch.cat([samples(xs[i], ys[i], keys[i]) for i in range(n_slabs)])[:n]

        def with_aa(sampler, xx, yy, k):
            """The base sample plus the AA taps, a key each: quirk AA averages
            all 5, adaptive AA takes them where ``aa_detect`` flags the base
            (the mask only selects; the key stream is the quirk path's)."""
            k, k0 = prng.split(k)
            img = sampler(xx, yy, k0)
            if not static.aa_enabled:
                return img
            acc = img
            for off in offsets:
                k, kk = prng.split(k)
                acc = acc + sampler(xx + off[0], yy + off[1], kk)
            if not static.aa_adaptive:
                return acc / 5.0
            mask = aa_detect(img.reshape(height, width, 3)).reshape(-1)
            return torch.where(mask[:, None], acc / 5.0, img)

        if chunked and not (static.aa_enabled and static.aa_adaptive):
            # per slab: its base sample and AA taps (the twin's _render_pixels per slab)
            keys = prng.split(key, n_slabs)
            xs, ys = padded(xf), padded(yf)
            img = torch.cat([with_aa(samples, xs[i], ys[i], keys[i]) for i in range(n_slabs)])[:n]
        else:
            # the whole frame's passes (adaptive AA needs the whole base frame)
            img = with_aa(flat_pass if chunked else samples, xf, yf, key)
        return img.reshape(height, width, 3)

    return render
