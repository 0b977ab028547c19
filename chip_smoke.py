#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (chess2rt_tpu_torch) once on one NVIDIA card.

    python chip_smoke.py                 # from the repository root
    python chip_smoke.py --profile       # also one frame under torch.profiler

The main path is the flagship forward frame: ``render_frame`` on the
flagship stand-in scene (chess2rt_tpu_torch/scenes.py) at 1920x1080, 5 AA
taps, maxTraceDepth 5, a mirror sphere, every round-0 call through the
hand-written CUDA kernel K1 (chess2rt_tpu_torch/csrc/round0.cu).  Phases,
in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: K1 from the checkout's sources, with nvcc;
3. K1 against its plain PyTorch version on the card: screen-tap and
   ray-input at 320x240, then at the main path's shapes (a 1080p tap and
   its block-compacted bounce rays);
4. the frame at 1080p: K1's launch count from this run, a finite frame
   with most pixels lit, and the same frame through the plain version;
5. timing with CUDA events: ms per frame and ms per 1080p K1 tap, kernel
   and plain side by side.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
SMALL = (320, 240)
AA = (0.3, 0.3)
# kernel-vs-plain limits, the repo's kernel-vs-reference limits
# (tests/test_fuzz.py): knife-edge lanes move with 1-ulp differences
WIN_LIMIT = 0.01  # fraction of lanes whose winning node differs
FRAC_LIMIT = 0.01  # fraction of lanes with d > 2e-3
MEDIAN_LIMIT = 2e-4  # median d
D_EDGE = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def lane_error(a, b):
    """|a - b|, relative to |b| where |b| > 1 (positions and UVs are
    hundreds of units on the stand-in's floor, where 1 ulp exceeds 2e-3)."""
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp_min(1.0)


def compare_round0(label, out, ref, names):
    """Hold K1's outputs against the plain version's; returns the largest
    absolute difference over lanes whose winning node agrees."""
    import torch

    agree = out["win"] == ref["win"]
    win_frac = 1.0 - agree.double().mean().item()
    worst = 0.0
    report = [f"win {win_frac:.2e}"]
    for k in names:
        a, b = out[k][agree], ref[k][agree]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: {k} has non-finite lanes")
        d = lane_error(a, b)
        frac = (d > D_EDGE).double().mean().item()
        med = d.median().item()
        worst = max(worst, (a.double() - b.double()).abs().max().item())
        report.append(f"{k} {frac:.1e}/{med:.1e}")
        if frac >= FRAC_LIMIT or med >= MEDIAN_LIMIT:
            raise AssertionError(f"{label}: {k}: {frac:.4f} of lanes above {D_EDGE}, median {med:.2e}")
    if win_frac >= WIN_LIMIT:
        raise AssertionError(f"{label}: win differs on {win_frac:.4f} of lanes")
    log(f"  {label}: n={out['win'].numel()} ok (frac>2e-3/median per key) {' '.join(report)}")
    return worst


def compare_frames(label, img, ref):
    d = (img.double() - ref.double()).abs().amax(-1)
    frac = (d > D_EDGE).double().mean().item()
    med = d.median().item()
    log(f"  {label}: pixels above {D_EDGE}: {frac:.2e}, median {med:.2e}, max {d.max().item():.3e}")
    if frac >= FRAC_LIMIT or med >= MEDIAN_LIMIT:
        raise AssertionError(f"{label}: {frac:.4f} of pixels above {D_EDGE}, median {med:.2e}")
    return d.max().item()


def jittered(packed, k):
    """The camera moved by ~1e-4 units: every timed frame renders anew."""
    rng = np.random.default_rng(k)
    import torch

    jit = torch.as_tensor((rng.uniform(size=3) - 0.5) * 1e-4, dtype=torch.float32,
                          device=packed.camera.pos.device)
    return dataclasses.replace(packed, camera=dataclasses.replace(packed.camera, pos=packed.camera.pos + jit))


def time_events(fn, reps, warm):
    """Median ms of ``fn(k)`` over ``reps`` runs after ``warm`` runs, by CUDA
    events around each call (host syncs inside count, as they stall the card)."""
    import torch

    times = []
    for k in range(warm + reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(k)
        end.record()
        torch.cuda.synchronize()
        if k >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times), times


def profile_frame(render):
    """One frame under torch.profiler: device time by kernel name, and the
    device's busy share of the frame's span (the rest is idle: host syncs,
    launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    render()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        render()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: frame {span_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / span_ms:.1%}), idle {1 - busy_ms / span_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path to smoke-test", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    dev = torch.device("cuda", 0)
    card = gpu_line()

    # ---- 1. device ---------------------------------------------------------
    log(f"phase 1 device: {card}")
    log(f"  torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    log(f"  nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # ---- 2. build ----------------------------------------------------------
    cuda_build.load()
    log(f"phase 2 build: {cuda_build.build_seconds:.2f} s")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. K1 against its plain version -------------------------------------
    log("phase 3 K1 vs plain (limits: win < 1%, lanes with d > 2e-3 < 1%, median d < 2e-4)")
    w, h = SMALL
    tp, ts = pack_scene(flagship_standin(T, w, h), device=dev)
    lay = R.layout(ts, w, h)
    prm = lay.pack(tp, AA)
    rng = np.random.default_rng(7)
    n = w * h
    orig = (np.array([0.0, 120.0, 220.0]) + rng.uniform(-150.0, 150.0, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    orig_t, dir_t = torch.from_numpy(orig).to(dev), torch.from_numpy(d).to(dev)
    compare_round0(f"{w}x{h} screen-tap", R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    compare_round0(f"{w}x{h} ray-input", R.round0(lay, prm, orig_t, dir_t),
                   R.round0_reference(lay, prm, orig_t, dir_t), lay.names)

    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    tap_k, tap_p = R.round0(lay, prm0), R.round0_reference(lay, prm0)
    max_err = compare_round0(f"{WIDTH}x{HEIGHT} screen-tap", tap_k, tap_p, lay.names)
    _, cont, _, ro, rd = F.combine_outputs(tp, ts, tap_p)
    blk = cont.reshape(-1, R.BOUNCE_BLOCK).any(1).nonzero().squeeze(1)
    o3 = ro.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous()
    d3 = rd.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous()
    max_err = max(max_err, compare_round0(
        f"bounce rays ({blk.numel()} live blocks)", R.round0(lay, prm0, o3, d3),
        R.round0_reference(lay, prm0, o3, d3), lay.names))
    del tap_k, tap_p, cont, ro, rd

    # ---- 4. the frame at 1080p -----------------------------------------------
    log(f"phase 4 frame {WIDTH}x{HEIGHT}, AA5, maxTraceDepth {ts.max_trace_depth}")
    R.launches = 0
    F.bounce_rounds = 0
    img = render_frame(tp, ts)
    torch.cuda.synchronize()
    launches, rounds = R.launches, F.bounce_rounds
    log(f"  K1 launches {launches}, bounce rounds {rounds}")
    if launches < 5 + rounds or rounds < 5:
        raise AssertionError(f"K1 launched {launches} times for 5 taps and {rounds} bounce rounds")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"frame {tuple(img.shape)} is not a finite {HEIGHT}x{WIDTH}x3 image")
    lit = (img.amax(-1) > 0).double().mean().item()
    log(f"  lit pixels {lit:.4f}, mean {img.mean().item():.6f}")
    if lit <= 0.5:
        raise AssertionError(f"only {lit:.2%} of pixels are lit")
    plain = F.build_flagship_renderer(ts, WIDTH, HEIGHT, trace=R.round0_reference)
    frame_err = compare_frames("kernel frame vs plain frame", img, plain(tp))
    del img

    # ---- 5. timing -------------------------------------------------------------
    log(f"phase 5 timing (CUDA events, median of 5 after 2 warm-ups) on {card}")
    kernel_ms, kernel_all = time_events(lambda k: render_frame(jittered(tp, k), ts), 5, 2)
    plain_ms, plain_all = time_events(lambda k: plain(jittered(tp, k)), 5, 2)
    log(f"  frame kernel path {kernel_ms:.3f} ms {['%.3f' % t for t in kernel_all]}")
    log(f"  frame plain path  {plain_ms:.3f} ms {['%.3f' % t for t in plain_all]}")
    k1_ms, _ = time_events(lambda k: R.round0(lay, prm0), 20, 3)
    k1_plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm0), 5, 1)
    log(f"  K1 per 1080p tap: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")
    ray_ms, _ = time_events(lambda k: R.round0(lay, prm0, o3, d3), 20, 3)
    ray_plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm0, o3, d3), 5, 1)
    log(f"  K1 per bounce round ({o3.shape[0]} rays): kernel {ray_ms:.3f} ms, plain {ray_plain_ms:.3f} ms")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if "--profile" in argv:
        profile_frame(lambda: render_frame(jittered(tp, 99), ts))

    kernels = {"kernels": [{
        "name": "round0 (K1, fused Whitted round)",
        "route": "cuda",
        "source": "chess2rt_tpu_torch/csrc/round0.cu",
        "replaces": "chess2rt_tpu/ops/pallas_trace.py:757",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]}
    log(json.dumps({"frame_ms": kernel_ms, "frame_plain_ms": plain_ms, "frame_max_abs_err": frame_err}))
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
