#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (chess2rt_tpu_torch) once on one NVIDIA card.

    python chip_smoke.py                 # from the repository root
    python chip_smoke.py --profile       # also one frame under torch.profiler

Two main paths, each driven with the launch counters zeroed just before
it and read just after:

* the flagship forward frame: ``render_frame`` on the flagship stand-in
  scene (chess2rt_tpu_torch/scenes.py) at 1920x1080, 5 AA taps,
  maxTraceDepth 5, a mirror sphere, every round-0 call through the
  hand-written CUDA kernel K1 (chess2rt_tpu_torch/csrc/round0.cu);
* the gradient step of the JAX package's grad bench (bench.py:173-179):
  the same scene at 640x480, AA off, block-compacted bounces, texel
  gradients on, ``((render_frame(p) - 0) ** 2).mean()`` differentiated in
  every ScenePacked leaf.  Every round-0 call runs K1's residual form,
  every bitmap gather's backward the texel-histogram kernel K2
  (chess2rt_tpu_torch/csrc/texel_hist.cu).

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: K1 and K2 from the checkout's sources, one nvcc each, in parallel;
3. K1 against its plain PyTorch version on the card: screen-tap and
   ray-input at 320x240, then at the main path's shapes (a 1080p tap and
   its block-compacted bounce rays);
4. the frame at 1080p: K1's launch count from this run, a finite frame
   with most pixels lit, and the same frame through the plain version;
5. timing with CUDA events: ms per frame and ms per 1080p K1 tap, kernel
   and plain side by side;
6. K1's residual form (want_hit and want_vis) against its plain version:
   320x240 screen-tap and ray-input, then the 640x480 step's tap and its
   block-compacted bounce rays;
7. K2 against its plain version on the step's own sorted texel
   cotangents (the tap's 307,200 rows of 12 channels into the stand-in's
   81,920 quad rows);
8. the 640x480 gradient step through the kernels, and through the plain
   versions: the same loss, every leaf's gradient at the rtol 5e-3 rule,
   K1's residual form once per round-0 call and K2 once per bitmap gather;
9. ``fit``: 5 Adam steps toward a target rendered from a perturbed scene,
   the loss falls;
10. timing: ms per gradient step (kernel and plain paths), K1's residual
    form and K2 beside their plain versions, peak device memory of a step.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
WIDTH, HEIGHT = 1920, 1080
SMALL = (320, 240)
GRAD_SIZE = (640, 480)  # the JAX package's grad bench (bench.py:152)
FIT_STEPS = 5
AA = (0.3, 0.3)
# kernel-vs-plain limits, the repo's kernel-vs-reference limits
# (tests/test_fuzz.py): knife-edge lanes move with 1-ulp differences
WIN_LIMIT = 0.01  # fraction of lanes whose winning node differs
FRAC_LIMIT = 0.01  # fraction of lanes with d > 2e-3
MEDIAN_LIMIT = 2e-4  # median d
D_EDGE = 2e-3
# gradients, kernel path vs plain path: per leaf |a - b| <= 2e-6 + rtol *
# max|b| + rtol * |b| (tests/test_pallas_grad.py:51-66, :108); scaling by
# the leaf's largest gradient keeps knife-edge lanes from failing it
GRAD_RTOL = 5e-3
# the camera angles' gradients are heavily cancelling sums over every pixel,
# fp-sensitive through the bitmap UVs: the repo holds them at rtol 0.1
# (tests/test_pallas_grad.py:130-139)
CAMERA_RTOL = 0.1
# the loss: the two paths' frames differ on < 1% of pixels (the limits above)
LOSS_RTOL = 1e-3
# pixels whose kernel and plain frames differ by more than this took a
# different float decision on the two paths (median difference ~6e-7)
GRAD_AGREE = 1e-5
# K2 vs its plain version: both sum f32 in another order
K2_LIMIT = 1e-4  # |a - b| <= K2_LIMIT * max(1, max|b|)


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
    absolute difference over lanes whose winning node agrees.  The 0/1
    shadow bits (``vis*``) are held to the same fraction of lanes and left
    out of that largest difference."""
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
        if not k.startswith("vis"):
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


def profile_run(label, run):
    """One run of ``run()`` under torch.profiler: device time by kernel name,
    and the device's busy share of the run's span (the rest is idle: host
    syncs, launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {label} {span_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / span_ms:.1%}), idle {1 - busy_ms / span_ms:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def scattered_rays(seed, n, dev):
    """n seeded rays through the stand-in's volume: origins scattered
    around it, directions uniform on the sphere."""
    import torch

    rng = np.random.default_rng(seed)
    orig = (np.array([0.0, 120.0, 220.0]) + rng.uniform(-150.0, 150.0, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(orig).to(dev), torch.from_numpy(d).to(dev)


def bounce_rays(tp, ts, tap):
    """The block-compacted continuation rays of a screen tap: the rays the
    first bounce round of the frame gives K1's ray-input form."""
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import round0 as R

    _, cont, _, ro, rd = F.combine_outputs(tp, ts, tap)
    blk = cont.reshape(-1, R.BOUNCE_BLOCK).any(1).nonzero().squeeze(1)
    o3 = ro.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous()
    d3 = rd.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous()
    return o3, d3, blk.numel()


def grad_step(render, packed, target, weight=None):
    """One gradient step: (loss, {leaf: gradient}, frame) of ((render(p) -
    target) ** 2 [* weight]).mean() in every ScenePacked leaf (zeros where
    a leaf has none)."""
    import torch
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, leaves

    p = grad_leaves_of(packed)
    xs = leaves(p)
    img = render(p)
    err = (img - target) ** 2
    loss = (err if weight is None else err * weight).mean()
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(x) if g is None else g
                           for k, x, g in zip(LEAF_NAMES, xs, grads)}, img.detach()


def grad_leaves_of(packed):
    """``packed`` with every leaf a fresh tensor that requires grad."""
    from chess2rt_tpu_torch.models.packed import from_leaves, leaves

    return from_leaves([x.detach().clone().requires_grad_() for x in leaves(packed)])


@contextlib.contextmanager
def plain_texel_vjp():
    """The texel VJP through K2's plain version: the plain gradient path."""
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.ops import texel_hist as K2

    kernel = S.texel_histogram
    S.texel_histogram = K2.texel_histogram_reference
    try:
        yield
    finally:
        S.texel_histogram = kernel


def compare_grads(label, got, want, enforce=True):
    """Every leaf's gradient from the kernel path against the plain path's:
    every gradient finite, each leaf zero on both paths or on neither, most
    leaves nonzero, and (``enforce``) each nonzero leaf at the GRAD_RTOL
    rule (CAMERA_RTOL for the camera leaves).  Logs every nonzero leaf's
    |a - b| / max|b| and returns the largest."""
    import torch

    nonzero, failed, report, worst = [], [], [], 0.0
    for k, b in want.items():
        a = got[k]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"{label}: the {k} gradient has non-finite entries")
        if bool(a.any()) != bool(b.any()):
            raise AssertionError(f"{label}: the {k} gradient is zero on one path only")
        if not bool(b.any()):
            continue
        nonzero.append(k)
        a, b = a.double(), b.double()
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale
        worst = max(worst, rel)
        report.append(f"{k} {rel:.1e}")
        rtol = CAMERA_RTOL if k.startswith("camera.") else GRAD_RTOL
        if ((a - b).abs() - (2e-6 + rtol * scale + rtol * b.abs())).max().item() > 0:
            failed.append(k)
    log(f"  {label}: {len(nonzero)} of {len(want)} leaves nonzero, all finite; |a - b| / max|b| per leaf: "
        + ", ".join(report))
    if 2 * len(nonzero) <= len(want):
        raise AssertionError(f"{label}: only {len(nonzero)} of {len(want)} leaves have a gradient")
    if failed:
        log(f"  {label}: outside the rule: {', '.join(failed)}")
        if enforce:
            raise AssertionError(f"{label}: {', '.join(failed)} outside the rtol {GRAD_RTOL} "
                                 f"(camera {CAMERA_RTOL}) rule")
    return worst


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

    dev = torch.device(DEVICE)
    card = gpu_line()

    # ---- 1. device ---------------------------------------------------------
    log(f"phase 1 device: {card}")
    log(f"  torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    log(f"  nvcc: {nvcc.stdout.strip().splitlines()[-1]}")

    # ---- 2. build ----------------------------------------------------------
    cuda_build.load_all()
    log(f"phase 2 build: {cuda_build.build_seconds:.2f} s ({', '.join(cuda_build.SOURCES.values())})")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- 3. K1 against its plain version -------------------------------------
    log("phase 3 K1 vs plain (limits: win < 1%, lanes with d > 2e-3 < 1%, median d < 2e-4)")
    w, h = SMALL
    tp, ts = pack_scene(flagship_standin(T, w, h), device=dev)
    lay = R.layout(ts, w, h)
    prm = lay.pack(tp, AA)
    orig_t, dir_t = scattered_rays(7, w * h, dev)
    compare_round0(f"{w}x{h} screen-tap", R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    compare_round0(f"{w}x{h} ray-input", R.round0(lay, prm, orig_t, dir_t),
                   R.round0_reference(lay, prm, orig_t, dir_t), lay.names)

    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    tap_k, tap_p = R.round0(lay, prm0), R.round0_reference(lay, prm0)
    max_err = compare_round0(f"{WIDTH}x{HEIGHT} screen-tap", tap_k, tap_p, lay.names)
    o3, d3, nblk = bounce_rays(tp, ts, tap_p)
    max_err = max(max_err, compare_round0(
        f"bounce rays ({nblk} live blocks)", R.round0(lay, prm0, o3, d3),
        R.round0_reference(lay, prm0, o3, d3), lay.names))
    del tap_k, tap_p

    # ---- 4. the frame at 1080p -----------------------------------------------
    log(f"phase 4 frame {WIDTH}x{HEIGHT}, AA5, maxTraceDepth {ts.max_trace_depth}")
    R.launches = R.resid_launches = 0
    F.bounce_rounds = 0
    img = render_frame(tp, ts)
    torch.cuda.synchronize()
    launches, resid, rounds = R.launches, R.resid_launches, F.bounce_rounds
    log(f"  K1 launches {launches} (residual form {resid}), bounce rounds {rounds}")
    if launches < 5 + rounds or rounds < 5:
        raise AssertionError(f"K1 launched {launches} times for 5 taps and {rounds} bounce rounds")
    if resid:
        raise AssertionError(f"the forward frame launched K1's residual form {resid} times")
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
        profile_run("frame", lambda: render_frame(jittered(tp, 99), ts))
    del tp, lay, prm0, o3, d3, plain

    kernels = [{
        "name": "round0 (K1, fused Whitted round: screen-tap and ray-input forms)",
        "route": "cuda",
        "source": "chess2rt_tpu_torch/csrc/round0.cu",
        "replaces": "chess2rt_tpu/ops/pallas_trace.py:757",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
    }]
    kernels += gradient_phases(argv, card, dev)
    log(json.dumps({"frame_ms": kernel_ms, "frame_plain_ms": plain_ms, "frame_max_abs_err": frame_err}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def gradient_phases(argv, card, dev):
    """Phases 6-10: the gradient slice.  Returns the kernels-line entries of
    K1's residual form and K2."""
    import torch
    from chess2rt_tpu_torch.grad import InverseProblem, fit
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene, replace_leaves
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    # ---- 6. K1's residual form against its plain version -----------------------
    log("phase 6 K1 residual form (want_hit, want_vis) vs plain (the phase 3 limits; "
        "vis bits: < 1% of the lanes where win agrees)")
    w, h = SMALL
    tp, ts = pack_scene(flagship_standin(T, w, h), device=dev)
    lay = R.layout(ts, w, h, want_hit=True, want_vis=True)
    prm = lay.pack(tp, AA)
    orig_t, dir_t = scattered_rays(8, w * h, dev)
    resid_err = compare_round0(f"{w}x{h} screen-tap", R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    resid_err = max(resid_err, compare_round0(f"{w}x{h} ray-input", R.round0(lay, prm, orig_t, dir_t),
                                              R.round0_reference(lay, prm, orig_t, dir_t), lay.names))

    gw, gh = GRAD_SIZE
    gp, gs = pack_scene(flagship_standin(T, gw, gh), device=dev)
    # the grad bench's configuration (bench.py:173-179); the stand-in
    # already has maxTraceDepth 5, block bounces and texel gradients on
    gs = dataclasses.replace(gs, aa_enabled=False)
    if not (gs.train_textures and gs.bounce_mode == "block" and gs.max_trace_depth == 5):
        raise AssertionError("the stand-in no longer has the grad bench's configuration")
    lay = R.layout(gs, gw, gh, want_hit=True, want_vis=True)
    prm0 = lay.pack(gp)
    tap_k, tap_p = R.round0(lay, prm0), R.round0_reference(lay, prm0)
    resid_err = max(resid_err, compare_round0(f"{gw}x{gh} step tap", tap_k, tap_p, lay.names))
    o3, d3, nblk = bounce_rays(gp, gs, tap_p)
    resid_err = max(resid_err, compare_round0(
        f"{gw}x{gh} step bounce rays ({nblk} live blocks)", R.round0(lay, prm0, o3, d3),
        R.round0_reference(lay, prm0, o3, d3), lay.names))
    del tap_k, tap_p

    # ---- 7. K2 against its plain version ---------------------------------------
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)  # bench.py:186
    seen = []

    def keep(keys, vals, n_texels):
        seen.append((keys, vals, n_texels))
        return K2.texel_histogram(keys, vals, n_texels)

    S.texel_histogram = keep
    try:
        grad_step(lambda p: render_frame(p, gs), gp, target)
    finally:
        S.texel_histogram = K2.texel_histogram
    n_quads = sum(bh * bw for bh, bw in gs.bitmap_sizes)
    keys, vals, n_texels = next(x for x in seen if x[0].numel() == gw * gh)
    log(f"phase 7 K2 vs plain on the step tap's sorted texel cotangents: {keys.numel()} rows, "
        f"{vals.shape[1]} channels, {n_texels} texel rows (limit {K2_LIMIT} * max(1, max|plain|))")
    if n_texels != n_quads or vals.shape[1] != 12 or not bool((keys[1:] >= keys[:-1]).all()):
        raise AssertionError(f"K2's inputs are not the sorted [N, 12] rows of {n_quads} quads")
    before = K2.launches
    hist_k = K2.texel_histogram(keys, vals, n_texels)
    if K2.launches != before + 1:
        raise AssertionError("texel_histogram did not launch K2")
    hist_p = K2.texel_histogram_reference(keys, vals, n_texels)
    k2_err = (hist_k - hist_p).abs().max().item()
    k2_scale = hist_p.abs().max().item()
    log(f"  max |K2 - plain| {k2_err:.3e}, max|plain| {k2_scale:.3e}, "
        f"texel rows with a sum {int(hist_p.any(1).sum())}")
    if not bool(torch.isfinite(hist_k).all()) or k2_err > K2_LIMIT * max(1.0, k2_scale):
        raise AssertionError(f"K2 differs from its plain version by {k2_err:.3e}")
    del seen, hist_k, hist_p

    # ---- 8. the gradient step ----------------------------------------------------
    log(f"phase 8 gradient step {gw}x{gh}, AA off, maxTraceDepth {gs.max_trace_depth}, every leaf")
    R.launches = R.resid_launches = K2.launches = 0
    F.bounce_rounds = 0
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, img_k = grad_step(lambda p: render_frame(p, gs), gp, target)
    torch.cuda.synchronize()
    step_launches, step_resid, step_k2, rounds = R.launches, R.resid_launches, K2.launches, F.bounce_rounds
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  K1 launches {step_launches} (residual form {step_resid}), bounce rounds {rounds}, "
        f"K2 launches {step_k2}; peak device memory {peak:.2f} GiB")
    # one round-0 call per tap and bounce round; each one's bitmap gather
    # runs K2 once in the backward
    if not (step_resid == step_launches == 1 + rounds and rounds >= 1):
        raise AssertionError(f"K1's residual form ran {step_resid} of {step_launches} times for 1 tap "
                             f"and {rounds} bounce rounds")
    if step_k2 != step_launches:
        raise AssertionError(f"K2 ran {step_k2} times for {step_launches} bitmap gathers")
    plain_render = F.build_flagship_renderer(gs, gw, gh, trace=R.round0_reference)
    R.launches = K2.launches = 0
    with plain_texel_vjp():
        loss_p, grads_p, img_p = grad_step(plain_render, gp, target)
    torch.cuda.synchronize()
    if R.launches or K2.launches:
        raise AssertionError("the plain gradient path launched a kernel")
    log(f"  loss kernel path {loss_k.item():.9g}, plain path {loss_p.item():.9g}")
    if not abs(loss_k.item() - loss_p.item()) <= LOSS_RTOL * abs(loss_p.item()):
        raise AssertionError(f"the two paths' losses differ by more than {LOSS_RTOL} of the loss")
    compare_grads("whole frame", grads_k, grads_p, enforce=False)
    # Knife-edge pixels, where the two forwards' float decisions differ (a
    # winner, a shadow bit or a texel), each follow their own path's pins.
    # At the horizon a pixel's derivative in plane_y or the UV scale grows
    # like 1 / dir_y, so a few such pixels can carry a whole scalar leaf.
    # The rule is held on the pixels where the two frames agree.
    agree = ((img_k - img_p).abs().amax(-1) <= GRAD_AGREE)[..., None].float()
    log(f"  pixels whose frames differ by more than {GRAD_AGREE}: {1 - agree.mean().item():.3e}")
    _, grads_k, _ = grad_step(lambda p: render_frame(p, gs), gp, target, agree)
    with plain_texel_vjp():
        _, grads_p, _ = grad_step(plain_render, gp, target, agree)
    grad_err = compare_grads("agreeing pixels", grads_k, grads_p)
    del grads_k, grads_p, img_k, img_p, agree

    # ---- 9. fit --------------------------------------------------------------
    log(f"phase 9 fit: {FIT_STEPS} Adam steps on mat_color toward a target from a perturbed scene")
    wrong = replace_leaves(gp, {"mat_color": gp.mat_color * 0.6 + 0.1})
    with torch.no_grad():
        fit_target = render_frame(wrong, gs)
    prob = InverseProblem(static=gs, target=fit_target, train_fields=("mat_color",), learning_rate=3e-2,
                          steps=FIT_STEPS)
    R.resid_launches = 0
    fitted, losses = fit(gp, prob)
    torch.cuda.synchronize()
    log(f"  losses {['%.6g' % v for v in losses]}, K1 residual launches {R.resid_launches}")
    if not (len(losses) == FIT_STEPS and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"fit did not lower the loss: {losses}")
    if R.resid_launches < FIT_STEPS or not bool(torch.isfinite(fitted.mat_color).all()):
        raise AssertionError("fit did not run the differentiable round 0")

    # ---- 10. timing ----------------------------------------------------------
    log(f"phase 10 timing (CUDA events, median of 5 after 2 warm-ups) on {card}")
    step_ms, step_all = time_events(lambda k: grad_step(lambda p: render_frame(p, gs), jittered(gp, k), target),
                                    5, 2)
    with plain_texel_vjp():
        step_plain_ms, plain_all = time_events(lambda k: grad_step(plain_render, jittered(gp, k), target), 5, 2)
    log(f"  gradient step kernel path {step_ms:.3f} ms {['%.3f' % t for t in step_all]}")
    log(f"  gradient step plain path  {step_plain_ms:.3f} ms {['%.3f' % t for t in plain_all]}")
    fwd_ms, _ = time_events(lambda k: ((render_frame(grad_leaves_of(jittered(gp, k)), gs) - target) ** 2).mean(), 5, 2)
    log(f"  of which the forward, recording the graph: {fwd_ms:.3f} ms (the backward the rest)")
    resid_ms, _ = time_events(lambda k: R.round0(lay, prm0), 20, 3)
    resid_plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm0), 5, 2)
    log(f"  K1 residual form per {gw}x{gh} tap: kernel {resid_ms:.3f} ms, plain {resid_plain_ms:.3f} ms")
    k2_ms, _ = time_events(lambda k: K2.texel_histogram(keys, vals, n_texels), 20, 3)
    k2_plain_ms, _ = time_events(lambda k: K2.texel_histogram_reference(keys, vals, n_texels), 20, 3)
    log(f"  K2 per {keys.numel()}-row histogram: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")
    log(f"  peak device memory of a step {peak:.2f} GiB")
    if "--profile" in argv:
        profile_run("gradient step", lambda: grad_step(lambda p: render_frame(p, gs), jittered(gp, 98), target))
    log(json.dumps({"grad_step_ms": step_ms, "grad_step_plain_ms": step_plain_ms, "grad_max_rel_err": grad_err,
                    "grad_step_peak_gib": peak, "fit_losses": losses}))

    return [
        {
            "name": "round0 residual form (K1 with want_hit and want_vis)",
            "route": "cuda",
            "source": "chess2rt_tpu_torch/csrc/round0.cu",
            "replaces": "chess2rt_tpu/ops/pallas_trace.py:757",
            "launches": step_resid,
            "max_abs_err": resid_err,
            "ms": resid_ms,
            "plain_ms": resid_plain_ms,
        },
        {
            "name": "texel_hist (K2, texel-gradient histogram)",
            "route": "cuda",
            "source": "chess2rt_tpu_torch/csrc/texel_hist.cu",
            "replaces": "chess2rt_tpu/ops/texel_hist.py:41",
            "launches": step_k2,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]

if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
