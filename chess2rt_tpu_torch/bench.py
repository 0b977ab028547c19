"""Benchmark: rays/s on the flagship scene, the twin of the JAX package's
bench.py (its six modes, the same JSON lines).

Config: the flagship stand-in (``scenes.flagship_standin``: CSG, two bitmap
textures, Phong, transforms, and bench.py's mirror sphere at (0, 60, 360),
R 55) for lecture5.sdl, which is not in the repository, at 1920x1080,
maxTraceDepth 5, AA on (5 taps per pixel).  The GI modes take
``scenes.gi_standin`` for bench.py's ``build_gi`` (lecture4.sdl plus its far
bounce wall), with NEE.

Counted rays as bench.py counts them: camera/AA sample rays + shadow rays
(one per lit shading point per light) + reflection continuation rays, from
an instrumented, untimed pass of the eager twin
(``utils.diagnostics.frame_ray_stats``: the base AA tap times the 5 taps)
at a quarter of the linear size, scaled by the pixel ratio.

    python -m chess2rt_tpu_torch.bench                      # rays_per_sec_chip
    python -m chess2rt_tpu_torch.bench --grad [--size WxH] [--steps N]  # grad_rays_per_sec
    python -m chess2rt_tpu_torch.bench --grad --gi [--size WxH] [--steps N]  # gi_grad_paths_per_sec
    python -m chess2rt_tpu_torch.bench --sharded            # sharded_frame_ms
    python -m chess2rt_tpu_torch.bench --check              # kernel_check; exits 1 on failure
    python -m chess2rt_tpu_torch.bench --verify-counts      # count_extrapolation_delta

Every mode runs on the current CUDA device and raises without one;
``--device cpu`` runs it on the CPU, where every kernel's wrapper runs its
plain version (the tests do so at tiny sizes).  On a card, ``main`` and
``--sharded`` raise unless every frame launched K1 and none went through
the twin, and ``--check``'s ``kernels_launched`` says whether its kernel
path did (``null`` on the CPU).

Each mode prints ONE JSON line, the last line on stdout, with bench.py's
keys; ``vs_baseline`` is against the reference's derived ~250k total
rays/s (BASELINE.md: 640x480 incl. shadow rays / 2.417 s on 1 CPU core), a
CPU figure for another scene.  The line's value is bench.py's: from the
best call.  A comment line on stderr starts with the card's name and power
limit and gives that time per frame or step beside the median, the window's
(every timed call's work over their summed time) and every call's time,
and the warm call (the kernels are built at first use, in it) apart.

Timing follows bench.py: a call renders ``FRAMES_PER_CALL`` frames (or
``steps_per_call`` steps), each with the camera jittered by ~1e-4 units
from the frame's key (``prng.uniform``, bit-equal to ``jax.random.uniform``)
so that no frame repeats another, sums them into a checksum on the device
and reads it once: that read is the call's synchronisation.  One warm call,
then ``REPEATS`` timed calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .models import types as TT
from .models.packed import LEAF_NAMES, _resolve_device, from_leaves, leaves, pack_scene
from .ops import prng
from .ops import round0 as K1
from .ops import texel_hist as K2
from .render import pipeline
from .render.pipeline import render_frame, render_frame_wavefront
from .scenes import flagship_standin, gi_standin
from .utils.diagnostics import frame_ray_stats

REFERENCE_TOTAL_RAYS_PER_SEC = 250_000.0  # BASELINE.md derived row

WIDTH, HEIGHT = 1920, 1080
REPEATS = 3
FRAMES_PER_CALL = 4
ORACLE_SIZE = (96, 54)  # --check's float64 oracle frame


def build(width=WIDTH, height=HEIGHT, device=None):
    """The flagship stand-in (its mirror sphere is bench.py's), packed f32:
    (packed, static)."""
    return pack_scene(flagship_standin(TT, width, height), device=device)


def build_gi(width, height, paths=40, device=None):
    """The GI stand-in (bench.py's ``build_gi``: GI on, ``paths`` paths per
    pixel, depth 5, AA off) with NEE (``gi_point_light_direct``)."""
    packed, static = pack_scene(gi_standin(TT, width, height, paths=paths), device=device)
    return packed, dataclasses.replace(static, gi_point_light_direct=True)


def card_line(dev) -> str:
    """The device's name and, for a card, its power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    if dev.type != "cuda":
        return str(dev)
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        limit = res.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        limit = f"nvidia-smi not read: {e}"
    return f"{torch.cuda.get_device_name(dev)} ({limit})"


def _jittered(packed, key):
    """The camera moved by (uniform(key, (3,)) - 0.5) * 1e-4 units."""
    jit = (prng.uniform(key, (3,), device=packed.device) - 0.5) * 1e-4
    return dataclasses.replace(packed, camera=dataclasses.replace(packed.camera, pos=packed.camera.pos + jit))


def _timed(call, per_call, dev):
    """bench.py's timing of ``call(keys) -> float`` (the host read of the
    call's checksum): one warm call on ``split(PRNGKey(0), per_call)``, then
    REPEATS calls on ``split(fold_in(PRNGKey(0), i), per_call)``.  Returns
    the warm call's checksum and {"ms": bench.py's best ms per frame or
    step, "median_ms", "window_ms": the timed calls' summed time over their
    frames or steps, "calls_ms": every timed call's, "warm_s": the warm
    call's seconds}."""
    key = prng.PRNGKey(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first = call(prng.split(key, per_call))
    warm = time.perf_counter() - t0
    if not math.isfinite(first):
        raise AssertionError(f"the warm call's checksum is not finite: {first}")
    times = []
    for i in range(REPEATS):
        keys = prng.split(prng.fold_in(key, i), per_call)
        t0 = time.perf_counter()
        call(keys)
        times.append(time.perf_counter() - t0)
    ms = [1000.0 * t / per_call for t in times]
    return first, {"ms": min(ms), "median_ms": statistics.median(ms), "window_ms": sum(ms) / REPEATS,
                   "calls_ms": ms, "warm_s": warm}


def _comment(dev, text, t):
    print(f"# {card_line(dev)}: {text}: {t['ms']:.3f} ms (median {t['median_ms']:.3f}, window "
          f"{t['window_ms']:.3f}, calls "
          f"{', '.join('%.3f' % x for x in t['calls_ms'])}); warm call {t['warm_s']:.2f} s, untimed",
          file=sys.stderr)


def _require_k1(dev, k1_before, twin_before, frames, what):
    """On a card, raise unless ``frames`` frames since the counts
    ``k1_before`` and ``twin_before`` launched K1 at least once each and
    none went through the twin."""
    k1, twin = K1.launches - k1_before, pipeline.wavefront_frames - twin_before
    if dev.type == "cuda" and (k1 < frames or twin):
        raise AssertionError(f"{what}: {frames} frames launched K1 {k1} times and ran {twin} twin frames")


def _frames_call(render, packed, dev):
    """``call(keys)``: one jittered frame per key, summed on the device, one
    host read."""

    def call(keys):
        with torch.no_grad():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for k in keys:
                acc = acc + render(_jittered(packed, k), k).sum()
        return float(acc)

    return call


def _grad_leaves(packed):
    """Every floating leaf of ``packed`` as a fresh tensor that requires
    grad, in LEAF_NAMES order."""
    return [x.detach().clone().requires_grad_() if x.is_floating_point() else x for x in leaves(packed)]


def _value_and_grad(xs, static, key, target):
    """((render_frame(p) - target) ** 2).mean() at the leaves ``xs`` and its
    gradient in every leaf that requires grad (zeros where unused)."""
    p = from_leaves(xs)
    loss = ((render_frame(p, static, key) - target) ** 2).mean()
    wrt = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]


def _steps_call(packed, static, target, dev):
    """``call(keys)``: one gradient step per key with the camera jittered
    (the jittered position is the step's camera leaf), every gradient leaf
    in the checksum with weight 1e-30 (bench.py:201-205), one host read."""
    xs = _grad_leaves(packed)
    pos_at = LEAF_NAMES.index("camera.pos")

    def call(keys):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for k in keys:
            step = list(xs)
            step[pos_at] = _jittered(packed, k).camera.pos.detach().requires_grad_()
            loss, grads = _value_and_grad(step, static, k, target)
            acc = acc + loss + 1e-30 * sum(g.sum() for g in grads)
        return float(acc)

    return call


def _peak_gib(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def _peak_text(peak):
    return "peak memory not measured" if peak is None else f"peak {peak:.2f} GiB"


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def main(width=WIDTH, height=HEIGHT, device=None) -> dict:
    """rays_per_sec_chip (bench.py:401-506): the AA5 depth-5 frame through
    ``render_frame`` (K1's screen-tap form per tap, then the block-compacted
    ray-input rounds, ops/flagship.py), ``fast_forward``, bounce capacity
    2073600 // 16, block bounces.  Returns the printed line as "line" and
    what the comment line gives."""
    dev = _resolve_device(device, "bench.main")
    packed, static = build(width, height, dev)
    static = dataclasses.replace(static, fast_forward=True, bounce_capacity=2073600 // 16, bounce_mode="block")
    k1, twin = K1.launches, pipeline.wavefront_frames
    checksum, t = _timed(_frames_call(lambda p, k: render_frame(p, static, k), packed, dev), FRAMES_PER_CALL, dev)
    _require_k1(dev, k1, twin, (REPEATS + 1) * FRAMES_PER_CALL, "bench.main")
    if not checksum > 0:
        raise AssertionError(f"the frames' checksum {checksum} is not positive")

    # exact counts at a quarter of the linear size (the 5 taps included),
    # after the timed calls
    cw, ch = width // 4, height // 4
    quarter = frame_ray_stats(*build(cw, ch, dev))
    stats = {k: quarter[k] * (width * height) / (cw * ch) for k in ("camera", "shadow", "bounce")}
    total_rays = sum(stats.values())

    rays_per_sec = total_rays / (t["ms"] / 1000.0)
    line = {
        "metric": "rays_per_sec_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_TOTAL_RAYS_PER_SEC, 2),
    }
    print(json.dumps(line))
    _comment(dev, f"{width}x{height} depth-{static.max_trace_depth} AA5, {total_rays / 1e6:.1f}M rays (camera "
             f"{stats.get('camera', 0.0) / 1e6:.1f}M, shadow {stats.get('shadow', 0.0) / 1e6:.1f}M, bounce "
             f"{stats.get('bounce', 0.0) / 1e6:.1f}M); frame", t)
    return {"line": line, **t, "rays": stats, "total_rays": total_rays}


def main_grad(w=640, h=480, steps_per_call=8, device=None) -> dict:
    """grad_rays_per_sec (bench.py:152-236): a forward-plus-backward step,
    ``((render_frame(p) - 0) ** 2).mean()`` and its gradient in every leaf,
    AA off, bounce capacity w * h // 16, block bounces, texel gradients on
    (K1's residual form, ``diff_round0``'s backward, K2); the rays are
    ``frame_ray_stats`` at ``w`` x ``h``."""
    dev = _resolve_device(device, "bench.main_grad")
    packed, static = build(w, h, dev)
    static = dataclasses.replace(static, aa_enabled=False, bounce_capacity=w * h // 16, bounce_mode="block")
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    _reset_peak(dev)
    _, t = _timed(_steps_call(packed, static, target, dev), steps_per_call, dev)
    peak = _peak_gib(dev)

    total = frame_ray_stats(packed, static, prng.PRNGKey(0))["total"]
    line = {
        "metric": "grad_rays_per_sec",
        "value": round(total / (t["ms"] / 1000.0), 1),
        "unit": "rays/s (fwd+bwd)",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    _comment(dev, f"{w}x{h} fwd+bwd, {total / 1e6:.2f}M rays/frame, {_peak_text(peak)}; step", t)
    return {"line": line, **t, "total_rays": total, "peak_gib": peak}


def main_grad_gi(w=640, h=480, steps_per_call=4, paths=40, device=None) -> dict:
    """gi_grad_paths_per_sec (bench.py:84-149): the same step through the
    path-traced frame (the fused GI renderer, ops/gi.py: K1's residual form
    per bounce round, K2, the threefry draw), NEE, depth 5, ``paths`` paths
    per pixel; ``gi_remat_paths`` from 2^20 pixels, as bench.py:99 sets it."""
    dev = _resolve_device(device, "bench.main_grad_gi")
    packed, static = build_gi(w, h, paths, dev)
    static = dataclasses.replace(static, gi_remat_paths=(w * h) >= (1 << 20))
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    _reset_peak(dev)
    _, t = _timed(_steps_call(packed, static, target, dev), steps_per_call, dev)
    peak = _peak_gib(dev)

    camera_paths = w * h * paths
    line = {
        "metric": "gi_grad_paths_per_sec",
        "value": round(camera_paths / (t["ms"] / 1000.0), 1),
        "unit": "camera paths/s (fwd+bwd, NEE, depth 5)",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    _comment(dev, f"GI fwd+bwd at {w}x{h}, {paths} paths/px ({camera_paths / 1e6:.1f}M camera paths/frame), remat "
             f"{static.gi_remat_paths}, {_peak_text(peak)}; step", t)
    return {"line": line, **t, "peak_gib": peak}


def main_sharded(width=WIDTH, height=HEIGHT, device=None) -> dict:
    """sharded_frame_ms (bench.py:340-398): ``main``'s frame through
    ``make_sharded_render_fn`` on a one-entry mesh of the device (K1's
    lin-input form per shard)."""
    from .parallel import make_mesh, make_sharded_render_fn

    dev = _resolve_device(device, "bench.main_sharded")
    packed, static = build(width, height, dev)
    static = dataclasses.replace(static, fast_forward=True, bounce_capacity=2073600 // 16, bounce_mode="block")
    render = make_sharded_render_fn(static, make_mesh([dev]))
    k1, twin = K1.launches, pipeline.wavefront_frames
    checksum, t = _timed(_frames_call(render, packed, dev), FRAMES_PER_CALL, dev)
    _require_k1(dev, k1, twin, (REPEATS + 1) * FRAMES_PER_CALL, "bench.main_sharded")
    if not checksum > 0:
        raise AssertionError(f"the frames' checksum {checksum} is not positive")
    line = {
        "metric": "sharded_frame_ms",
        "value": round(t["ms"], 2),
        "unit": "ms/frame (1-device mesh, fused)",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    _comment(dev, f"sharded fused flagship {width}x{height}: frame", t)
    return {"line": line, **t}


def _close(a, b):
    return float(np.mean(np.abs(a - b) <= 2e-3 + 2e-3 * np.abs(b)))


def main_check(w=480, h=272, device=None) -> dict:
    """kernel_check (bench.py:239-337), the card's gate: the kernel path
    (``render_frame``, K1) against the path without a kernel
    (``render_frame_wavefront``, the counterpart of bench.py's XLA path) on
    the fixed and the adaptive-AA frame; the kernel path's frame of the
    stand-in at ``ORACLE_SIZE`` against the float64 oracle in u8; one
    gradient step through K1's residual form and K2, finite and nonzero.
    bench.py's thresholds, and on a card ``kernels_launched``: each of the
    kernel path's frames launched K1 and ran no twin frame, and the step
    launched K1's residual form and K2.  Prints the verdict line; the
    command line exits 1 when ``ok`` is false."""
    from .oracle.renderer import render_scene
    from .utils.color import srgb_u8

    dev = _resolve_device(device, "bench.main_check")
    packed, static = build(w, h, dev)
    static_p = dataclasses.replace(static, aa_enabled=False, bounce_capacity=w * h // 16, bounce_mode="block")
    static_x = dataclasses.replace(static, aa_enabled=False)
    key = prng.PRNGKey(0)
    launched = []  # per kernel-path frame and the step: did it go through its kernels

    def kernel_frame(p, sp):
        k1, twin = K1.launches, pipeline.wavefront_frames
        with torch.no_grad():
            img = render_frame(p, sp, key).cpu().numpy()
        launched.append(K1.launches > k1 and pipeline.wavefront_frames == twin)
        return img

    def frames(sp, sx):
        img = kernel_frame(packed, sp).astype(np.float64)
        with torch.no_grad():
            return img, render_frame_wavefront(packed, sx, key).double().cpu().numpy()

    img_p, img_x = frames(static_p, static_x)
    rel_checksum = abs(img_p.sum() - img_x.sum()) / max(abs(img_x.sum()), 1e-9)
    close = _close(img_p, img_x)
    img_pa, img_xa = frames(dataclasses.replace(static_p, aa_enabled=True, aa_adaptive=True),
                            dataclasses.replace(static_x, aa_enabled=True, aa_adaptive=True))
    adaptive_close = _close(img_pa, img_xa)

    # oracle anchor: the kernel path's frame against the float64 numpy
    # ground truth, in u8
    ow, oh = ORACLE_SIZE
    t0 = time.perf_counter()
    oref = srgb_u8(render_scene(flagship_standin(TT, ow, oh))).astype(int)
    oracle_s = time.perf_counter() - t0
    odev = srgb_u8(kernel_frame(*pack_scene(flagship_standin(TT, ow, oh), device=dev))).astype(int)
    oracle_within1 = float((np.abs(oref - odev) <= 1).mean())

    resid, k2 = K1.resid_launches, K2.launches
    loss, grads = _value_and_grad(_grad_leaves(packed), static_p, key,
                                  torch.zeros((h, w, 3), dtype=torch.float32, device=dev))
    grad_finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    grad_nonzero = sum(float(g.abs().sum()) for g in grads) > 0
    launched.append(K1.resid_launches > resid and K2.launches > k2)
    kernels_launched = all(launched) if dev.type == "cuda" else None  # the CPU has no kernel

    ok = bool(
        (rel_checksum < 5e-4)
        and (close > 0.99)
        and (adaptive_close > 0.99)
        and grad_finite
        and grad_nonzero
        and (oracle_within1 > 0.99)
        and kernels_launched is not False
    )
    line = {
        "metric": "kernel_check",
        "value": round(float(rel_checksum), 8),
        "unit": "rel_checksum_delta",
        "vs_baseline": None,
        "pixels_close": round(close, 5),
        "adaptive_close": round(adaptive_close, 5),
        "oracle_within1": round(oracle_within1, 5),
        "grad_finite": grad_finite,
        "grad_nonzero": grad_nonzero,
        "kernels_launched": kernels_launched,
        "ok": ok,
    }
    print(json.dumps(line))
    print(f"# {card_line(dev)}: kernel path against the twin at {w}x{h}, the oracle at {ow}x{oh} "
          f"({oracle_s:.2f} s of numpy float64)", file=sys.stderr)
    return {"line": line, "oracle_s": oracle_s}


def main_verify_counts(width=WIDTH, height=HEIGHT, device=None) -> dict:
    """count_extrapolation_delta (bench.py:509-553): the instrumented pass
    at a quarter of the linear size and at full size, the relative delta of
    the extrapolated (x16) against the true counts."""
    dev = _resolve_device(device, "bench.main_verify_counts")

    def counted(w, h):  # the base AA tap's counts (bench.py's instrumented pass)
        packed, static = build(w, h, dev)
        stats = frame_ray_stats(packed, dataclasses.replace(static, aa_enabled=False))
        return {k: stats[k] for k in ("camera", "shadow", "bounce")}

    quarter = counted(width // 4, height // 4)
    full = counted(width, height)
    scale = 16.0
    for k in sorted(full):
        extrap = quarter.get(k, 0.0) * scale
        delta = abs(extrap - full[k]) / max(full[k], 1.0)
        print(f"# {k}: full {full[k]:.0f} vs extrapolated {extrap:.0f} (delta {delta * 100:.3f}%)", file=sys.stderr)
    total_full = sum(full.values())
    total_ex = sum(quarter.values()) * scale
    line = {
        "metric": "count_extrapolation_delta",
        "value": round(abs(total_ex - total_full) / total_full, 6),
        "unit": "relative",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    print(f"# {card_line(dev)}: counts at {width}x{height} and {width // 4}x{height // 4}", file=sys.stderr)
    return {"line": line, "quarter": quarter, "full": full}


def cli(argv=None) -> int:
    """bench.py's dispatch (bench.py:554-576), plus ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m chess2rt_tpu_torch.bench")
    ap.add_argument("--grad", action="store_true", help="grad_rays_per_sec (640x480 by default)")
    ap.add_argument("--gi", action="store_true", help="with --grad: gi_grad_paths_per_sec")
    ap.add_argument("--size", default=None, help="WxH of --grad's frame (640x480)")
    ap.add_argument("--steps", type=int, default=None, help="steps per call of --grad")
    ap.add_argument("--sharded", action="store_true", help="sharded_frame_ms")
    ap.add_argument("--check", action="store_true", help="kernel_check; exits 1 on failure")
    ap.add_argument("--verify-counts", action="store_true", help="count_extrapolation_delta")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu)")
    args = ap.parse_args(argv)
    if args.grad:
        w, h = tuple(int(v) for v in args.size.split("x")) if args.size else (640, 480)
        if args.gi:
            steps = args.steps or (4 if w * h <= 640 * 480 else 1)
            main_grad_gi(w, h, steps, device=args.device)
        else:
            steps = args.steps or (8 if w * h <= 640 * 480 else 4)
            main_grad(w, h, steps, device=args.device)
    elif args.sharded:
        main_sharded(device=args.device)
    elif args.check:
        if not main_check(device=args.device)["line"]["ok"]:
            return 1
    elif args.verify_counts:
        main_verify_counts(device=args.device)
    else:
        main(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
