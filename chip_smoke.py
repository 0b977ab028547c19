#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (chess2rt_tpu_torch) once on one NVIDIA card.

    python chip_smoke.py                 # from the repository root
    python chip_smoke.py --profile       # also the frames and the step under torch.profiler

Main paths, each driven with the launch counters zeroed just before it and
read just after:

* the flagship forward frame: ``render_frame`` on the flagship stand-in
  scene (chess2rt_tpu_torch/scenes.py) at 1920x1080, 5 AA taps,
  maxTraceDepth 5, a mirror sphere, every round-0 call through the
  hand-written CUDA kernel K1 (chess2rt_tpu_torch/csrc/round0.cu);
* the gradient step of the JAX package's grad bench (bench.py:173-179):
  the same scene at 640x480, AA off, block-compacted bounces, texel
  gradients on, ``((render_frame(p) - 0) ** 2).mean()`` differentiated in
  every ScenePacked leaf.  Every round-0 call runs K1's residual form,
  every bitmap gather's backward the texel-histogram kernel K2
  (chess2rt_tpu_torch/csrc/texel_hist.cu);
* the pixel-slice paths: the 1080p frame sharded over a mesh of 4 entries
  of the one card (``parallel.make_sharded_render_fn``, K1's lin-input
  form), the frame in ``chunk_pixels`` slabs, the adaptive-AA frame, and
  the 640x480 gradient step sharded 4 ways
  (``parallel.make_sharded_value_and_grad``);
* the stage ladder of K1 (``ladder`` below, K3: the kernel cut
  after empty, raygen, scan and shadow, csrc/round0.cu built with
  -DC2RT_STAGE=k) at 1080p;
* the eager Whitted twin (``render_frame_wavefront``, plain PyTorch: the
  JAX package's XLA wavefront has no Pallas kernel) at 1080p in f32, and
  float64 frames through ``render_frame``, which sends them to the twin;
* the command line, ``python -m chess2rt_tpu_torch --file scene.sdl -o
  out.bmp``, on a scene file with the stand-in's features: its f32 frame
  goes through K1 (screen-tap and ray-input forms).

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: K1, K2 and K3's four stages from the checkout's sources, one nvcc
   each, in parallel; registers, stack and spill bytes of every library;
3. K1 against its plain PyTorch version on the card: screen-tap and
   ray-input at 320x240, on the stand-in and on the two CSG stress scenes
   (a 16-hit list and nested CsgDiffs: the shared-memory hit lists, which
   the stand-in's four-hit nodes never reach), then at the main path's
   shapes (a 1080p tap and its block-compacted bounce rays);
4. the frame at 1080p: K1's launch count from this run, a finite frame
   with most pixels lit, and the same frame through the plain version;
5. timing with CUDA events: ms per frame and ms per 1080p K1 tap, kernel
   and plain side by side;
6. K1's residual form (want_hit and want_vis) against its plain version:
   320x240 screen-tap and ray-input on the stand-in and the CSG stress
   scenes, then the 640x480 step's tap and its block-compacted bounce rays;
7. K2 against its plain version on the step's own sorted texel
   cotangents: the tap's 307,200 rows of 12 channels into the stand-in's
   81,920 quad rows, and the bounce round's rows; two calls on the tap's
   rows give the same bits;
8. the 640x480 gradient step through the kernels, and through the plain
   versions: the same loss, every leaf's gradient at the rtol 5e-3 rule,
   K1's residual form once per round-0 call and K2 once per bitmap gather;
9. ``fit``: 5 Adam steps toward a target rendered from a perturbed scene,
   the loss falls;
10. timing: ms per gradient step (kernel and plain paths), K1's residual
    form and K2 beside their plain versions, the texel VJP's sort and row
    gather beside K2, peak device memory of a step;
11. K1's lin-input form against its plain version at 320x240 in 4 slices,
    plain and residual rows, and the slices against the screen-tap launch
    (differing lanes counted, 0 expected);
12. the sharded 1080p frame (4 entries of the one card) against the single
    frame (max abs <= 2e-5) and the plain path; its time beside the single
    frame's; K1's lin-input form against its plain version at every
    shard's tap (518,400 lanes at its base);
13. the chunked 1080p frame (``chunk_pixels`` 262,144: 8 slabs) against the
    un-chunked frame, time and peak memory of both; the adaptive-AA frame
    against the plain path, flagged pixels, capacity, time, and the branch
    it took, held to that branch's launch counts;
14. the sharded 640x480 gradient step (4 entries) against the
    single-device step at the phase 8 rule, and the residual lin-input form
    against its plain version at every shard's tap; its time;
15. K3: every stage against its plain version at 320x240 and at 1080p, then
    the ladder at 1080p: ms per launch of empty, raygen, scan, shadow and the whole
    K1 (beside the times of the design before this one), registers and
    stack per stage;
16. the twin on the 1080p AA5 depth-5 stand-in in f32 against the phase 4
    fused frame (the frame limits), no K1 launch, its median ms (CUDA events,
    median of 3 after 2 warm-ups) beside phase 5's, its peak memory; with
    ``--profile`` its device-busy share;
17. float64 on the card: the stand-in at 320x240, AA off, through
    ``render_frame`` (the twin) against the port's float64 numpy oracle
    copy (max |d| < 1e-4, u8 equal on > 99.9% of pixels: the oracle re-casts
    CSG rays in 1e-6 steps), and a 64x48 AA5 frame of a CSG-free scene
    (``scenes.csg_free_scene``), u8-equal everywhere with max |d| < 1e-6;
    their times;
18. the CLI end to end: ``scenes.write_standin_sdl`` writes the scene file
    and its two BMP textures; ``app.main`` in this process with K1's counters
    zeroed (its f32 frame launches K1), then ``python -m chess2rt_tpu_torch
    --file ... -o ... --size 1920x1080 --stats -q`` as a subprocess, its BMP
    decoded and compared byte for byte with ``srgb_u8`` of this process's
    ``render_frame`` of the same file (0 differing bytes); the same with
    ``--dtype f64 --size 320x240``; ``--debug-pixel 160,120`` through
    ``app.main`` in this process; the wall time of each stage (load, device
    init, pack, render, write); then the CLI's render stage split in fresh
    processes (``first_frame_split``: import, device init, pack, K1's
    library load, the first matmul, batched inverse, sort and K1 launch,
    three frames), with CUDA's lazy module loading and with
    ``CUDA_MODULE_LOADING=EAGER``.

Every kernels-line entry carries ``bound_ms``, the least time the card could
take: the larger of ``bound_bytes_ms``, the bytes the call must move (inputs
read once, outputs written once) over 3.35 TB/s, and ``bound_ops_ms``, its
arithmetic over 67 TFLOP/s (f32 outside the tensor cores).  The bytes term
follows from the shapes alone; K1's arithmetic is ``k1_ops``'s count by
hand from the kernel's source (the tables below say what is counted).

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Without a card it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# the sharded frame against the single frame: the JAX package's gate between
# its sharded and single-chip fused frames (tests/test_parallel.py:166-174)
SHARD_LIMIT = 2e-5
MESH_ENTRIES = 4
CHUNK_PIXELS = 262144
# K3's ladder with the design before this one (one thread per ray, tables
# read through global memory, hit records sorted in local memory), queued
# back to back on an NVIDIA H100 80GB HBM3 at 700 W: what phase 15 prints
# beside the new times
PREVIOUS_LADDER_MS = {"empty": 0.0122, "raygen": 0.0128, "scan": 0.3227, "shadow": 0.7182, "full": 0.9616}
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

# K1's f32 arithmetic per lane, counted by hand from csrc/round0.cu, the
# function named on each line.  One per add, subtract, multiply, divide and
# sqrt, so a multiply-add is 2 and a 3-vector dot product 5; powf is 2.
# Compares, selects, fabs, negations, integer and address work are NOT
# counted, nor are the texture lookups and the CSG difference's normal
# probes (they depend on the lane).  Where the kernel does more than the
# function needs, the cheaper form is counted: a cube's closest hit is
# counted as the slab test the kernel's own shadow scans use, plus the hit
# point, and not as the six-face walk of cube_two_hits.  The count is a
# floor on the arithmetic, not the kernel's instruction mix.
#   plane_closest: -1/dy 1, t 2, px and pz 4
OPS_PLANE = 7
#   sphere_roots: h 3, A 5, B 6, C 7, D 4, sqrt 1, 1/(2A) 2, the two roots 4
OPS_SPHERE_ROOTS = 32
#   sphere_record: the hit point less the centre 9, rsq 7, the normal 3;
#   UVs: atan2_poly 17 (+2), asin_poly 21 (+4)
OPS_SPHERE_RECORD, OPS_SPHERE_UV = 19, 44
#   cube_slab_dists: half 1, per axis c -+ half 2, - o 2, 1/d 1, * 2;
#   the record: the hit point 6, UVs 2
OPS_CUBE_SLAB, OPS_CUBE_RECORD, OPS_CUBE_UV = 22, 6, 2
#   node_closest / node_min_dist, full matrix: o - f 3, two mulr 30, dlen 7,
#   d / dlen 3 (43); back: t 1, and for a record the normal 15 + 7 + 3
OPS_MATRIX = (69, 44)  # (closest-hit record, dist-only); an offset costs 3
#   round0_kernel: ray-gen (xpix, ypix 4, d 12, 1/len 7, d / len 3); the
#   hit point 6, faceforward 8, the shadow origin 6; per light the shadow
#   ray 13 (to 3, target 6, 1/target 1, dir 3), Lambert 25 (to 3, dist2 5,
#   rsq 2, dir 3, cos 5, w 1, += 6), Phong 37 (mdotn 5, R 9, rsq 7, cos_g 6,
#   powf * strength / dist2 4, += 6); diffuse * light 3; the mirror
#   continuation 24 (ddn 5, R 9, rsq 7, scale 3)
OPS_RAYGEN, OPS_HITPOINT, OPS_SHADOW_RAY, OPS_LIGHT, OPS_PHONG, OPS_OUT, OPS_CONT = 26, 20, 13, 25, 37, 3, 24


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


def _node_ops(static, expr_tables):
    """[(closest-hit ops, dist-only ops)] per node, from the tables above.
    Inside a CSG expression a sphere and a cube give both crossings."""
    from chess2rt_tpu_torch.ops.round0 import _needs_uv

    def leaf(kind, uv, both):
        k = 2 if both else 1
        if kind == "plane":
            return OPS_PLANE, OPS_PLANE
        if kind == "sphere":
            return OPS_SPHERE_ROOTS + k * (OPS_SPHERE_RECORD + uv * OPS_SPHERE_UV), OPS_SPHERE_ROOTS
        return OPS_CUBE_SLAB + k * (OPS_CUBE_RECORD + uv * OPS_CUBE_UV), OPS_CUBE_SLAB

    def walk(expr, uv, both):
        if expr[0] != "csg":
            return leaf(expr[0], uv, both)
        (lh, ld), (rh, rd) = walk(expr[2], uv, True), walk(expr[3], uv, True)
        return lh + rh, ld + rd  # the merge and the parity walk are compares

    out = []
    for ns, expr in zip(static.nodes, expr_tables):
        hit, dist = walk(expr, int(_needs_uv(ns)), False)
        if not ns.identity_transform:
            xh, xd = (3, 3) if ns.offset_only else OPS_MATRIX
            hit, dist = hit + xh, dist + xd
        out.append((hit, dist))
    return out


def k1_ops(lay, n, lit, stage="full", ray_input=False):
    """Arithmetic of one K1 launch on ``n`` lanes, as this run's data needs
    it.  Every lane scans every node for its closest hit and shades (missed
    lanes shade from t = 0).  A shadow scan stops at the first occluder:
    ``lit[l]`` is the share of lanes light l reaches (all nodes scanned),
    the others count one node, the least an occluded lane can need."""
    nodes = _node_ops(lay.static, lay.expr_tables)
    if stage == "empty":
        return 2.0 * n
    per = 0.0 if ray_input else OPS_RAYGEN
    if stage == "raygen":
        return (per + 4.0) * n
    per += sum(h for h, _ in nodes)
    if stage == "scan":
        return (per + 1.0) * n
    per += OPS_HITPOINT
    scan_all = sum(d for _, d in nodes)
    scan_one = min(d for _, d in nodes)
    for share in lit:
        per += OPS_SHADOW_RAY + share * scan_all + (1.0 - share) * scan_one
        if stage == "shadow":
            per += 1
        else:
            per += OPS_LIGHT + (OPS_PHONG if 1 in lay.static.shader_kinds_present else 0)  # 1: PHONG
    if stage == "full":
        per += OPS_OUT + (OPS_CONT if lay.has_cont else 0)
    return per * n


def bound(n_bytes, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms): the larger of bytes over the
    card's memory rate and operations over its f32 rate, and both terms."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * ops / PEAK_F32
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def k1_bound(lay, n, lit, stage="full", ray_input=False):
    """``bound`` of one K1 launch (or one K3 stage): the parameter vector,
    the scene program and the rays read once, every output row written once."""
    rows = 2 if stage != "full" else len(lay.names) + 1
    n_bytes = 4 * lay.n_prm + 4 * lay.program.size + (24 * n if ray_input else 0) + 4 * rows * n
    return bound(n_bytes, k1_ops(lay, n, lit, stage, ray_input))


def lit_shares(out, n_lights):
    """Per light, the share of lanes it reaches, from a residual-form
    launch's shadow bits."""
    return [out[f"vis{li}"].mean().item() for li in range(n_lights)]


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by, bound_bytes_ms,
                 bound_ops_ms, library_ms=None):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
            "library_ms": library_ms}


K1_SOURCE = "chess2rt_tpu_torch/csrc/round0.cu"
K1_REPLACES = "chess2rt_tpu/ops/pallas_trace.py:757"


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


def compare_stage(label, out, ref):
    """Hold one K3 stage's two rows against the plain version's (the phase 3
    limits per row); returns the largest absolute difference over lanes that
    hit on both (t = 1e30 on missed lanes)."""
    import torch
    from chess2rt_tpu_torch.ops.round0 import INF

    worst, report = 0.0, []
    for row, (a, b) in enumerate(zip(out, ref)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"K3 {label}: row {row} has non-finite lanes")
        d = lane_error(a, b)
        frac, med = (d > D_EDGE).double().mean().item(), d.median().item()
        both = (a < INF) & (b < INF)
        worst = max(worst, (a.double() - b.double()).abs()[both].max().item())
        report.append(f"row {row} {frac:.1e}/{med:.1e}")
        if frac >= FRAC_LIMIT or med >= MEDIAN_LIMIT:
            raise AssertionError(f"K3 {label}: row {row}: {frac:.4f} of lanes above {D_EDGE}, median {med:.2e}")
    log(f"  {label}: n={out[0].numel()} ok (frac>2e-3/median per row) {' '.join(report)}")
    return worst


def queued_ms(run, reps, busy):
    """ms per launch of ``reps`` calls of ``run`` enqueued behind a long
    matrix product (``busy`` squared), which keeps the device busy while
    the host enqueues them, so that they run back to back: the time from
    the first launch's start to the last one's end over ``reps`` is the
    kernel's own time."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.mm(busy, busy)  # ~1.1e12 operations at 8192 x 8192
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ladder(lay, prm, reps=20, warm=3):
    """ms per launch of every K3 stage and of the whole K1 ("full") on
    ``lay``'s frame, by CUDA events: ({stage: called_ms}, {stage: queued_ms}).

    * called: the median of ``reps`` single calls after ``warm``, an event
      before and after each.  A call costs the host some tens of
      microseconds (checks, allocation, the launch), which the device waits
      out, so the short stages read the wrapper's floor, not the kernel;
    * queued: ``queued_ms``, the kernel's own time."""
    import torch
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import round0_probe as K3

    runs = {stage: (lambda k=0, stage=stage: K3.round0_stage(lay, prm, stage)) for stage in K3.STAGES}
    runs["full"] = lambda k=0: R.round0(lay, prm)
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=prm.device)
    called, queued = {}, {}
    for name, run in runs.items():
        called[name], _ = time_events(run, reps, warm)
        queued[name] = queued_ms(run, reps, busy)
    return called, queued


def scattered_rays(seed, n, dev, center=(0.0, 120.0, 220.0), spread=150.0):
    """n seeded rays through a scene's volume (the stand-in's unless told
    otherwise): origins scattered around ``center``, directions uniform on
    the sphere."""
    import torch

    rng = np.random.default_rng(seed)
    orig = (np.array(center) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(orig).to(dev), torch.from_numpy(d).to(dev)


def compare_stress_scenes(dev, seed, residual):
    """K1 against its plain version on the two CSG stress scenes
    (scenes.csg_stress_scene) at SMALL, screen-tap and ray-input: the nodes
    whose hit lists are longer than four take the kernel's shared-memory
    lists and its pair-table network, and the nested CsgDiffs its replayed
    normal flips, none of which the stand-in reaches.  Every node must win
    some lane of the tap."""
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.scenes import csg_stress_scene

    w, h = SMALL
    for kind in ("deep16", "nested_diff"):
        tp, ts = pack_scene(csg_stress_scene(T, kind, w, h), device=dev)
        lay = R.layout(ts, w, h, want_hit=residual, want_vis=residual)
        prm = lay.pack(tp, AA)
        tap = R.round0(lay, prm)
        compare_round0(f"{kind} {w}x{h} screen-tap", tap, R.round0_reference(lay, prm), lay.names)
        winners = set(tap["win"].unique().tolist())
        if winners != set(range(-1, len(ts.nodes))):
            raise AssertionError(f"{kind}: the tap's winners {sorted(winners)} are not every node and a miss")
        orig_t, dir_t = scattered_rays(seed, w * h, dev, center=(0.0, 1.0, 0.0), spread=6.0)
        compare_round0(f"{kind} {w}x{h} ray-input", R.round0(lay, prm, orig_t, dir_t),
                       R.round0_reference(lay, prm, orig_t, dir_t), lay.names)


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


def step_texel_rows(render, packed, target):
    """[(sorted keys, cotangent rows, n_texels)] that one gradient step
    gives K2, one entry per bitmap gather (the tap's and every bounce
    round's), in the order of the backward."""
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.ops import texel_hist as K2

    seen = []

    def keep(keys, vals, n_texels):
        seen.append((keys, vals, n_texels))
        return K2.texel_histogram(keys, vals, n_texels)

    S.texel_histogram = keep
    try:
        grad_step(render, packed, target)
    finally:
        S.texel_histogram = K2.texel_histogram
    return seen


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
    log(f"phase 2 build: {cuda_build.build_seconds:.2f} s, one nvcc per library in parallel "
        f"({', '.join(cuda_build.SOURCES)})")
    for name in cuda_build.SOURCES:
        usage = cuda_build.ptxas_usage(name)
        if usage is None:
            raise AssertionError(f"no ptxas report for {name}")
        log(f"  ptxas {name}: {usage[0]} registers, {usage[1]} bytes stack, {usage[2]} bytes spill stores, "
            f"{usage[3]} bytes spill loads (the largest over its kernels)")

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
    compare_stress_scenes(dev, 17, residual=False)

    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    tap_k, tap_p = R.round0(lay, prm0), R.round0_reference(lay, prm0)
    max_err = compare_round0(f"{WIDTH}x{HEIGHT} screen-tap", tap_k, tap_p, lay.names)
    o3, d3, nblk = bounce_rays(tp, ts, tap_p)
    ray_err = compare_round0(
        f"bounce rays ({nblk} live blocks)", R.round0(lay, prm0, o3, d3),
        R.round0_reference(lay, prm0, o3, d3), lay.names)
    # the shadow scans' work (for the bounds): one residual-form launch each
    tap_bound = k1_bound(lay, WIDTH * HEIGHT, lit_shares(R.round0(lay, prm0, want_vis=True), ts.n_lights))
    ray_bound = k1_bound(lay, o3.shape[0], lit_shares(R.round0(lay, prm0, o3, d3, want_vis=True), ts.n_lights),
                         ray_input=True)
    del tap_k, tap_p

    # ---- 4. the frame at 1080p -----------------------------------------------
    log(f"phase 4 frame {WIDTH}x{HEIGHT}, AA5, maxTraceDepth {ts.max_trace_depth}")
    R.launches = R.resid_launches = R.ray_launches = R.lin_launches = 0
    F.bounce_rounds = 0
    img = render_frame(tp, ts)
    torch.cuda.synchronize()
    launches, resid, rounds = R.launches, R.resid_launches, F.bounce_rounds
    ray_launches = R.ray_launches
    log(f"  K1 launches {launches} (ray-input form {ray_launches}, residual form {resid}), bounce rounds {rounds}")
    if launches < 5 + rounds or rounds < 5:
        raise AssertionError(f"K1 launched {launches} times for 5 taps and {rounds} bounce rounds")
    if resid or R.lin_launches or ray_launches != rounds:
        raise AssertionError(f"the forward frame launched K1's residual form {resid} times, its lin-input form "
                             f"{R.lin_launches} times and its ray-input form {ray_launches} times")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"frame {tuple(img.shape)} is not a finite {HEIGHT}x{WIDTH}x3 image")
    lit = (img.amax(-1) > 0).double().mean().item()
    log(f"  lit pixels {lit:.4f}, mean {img.mean().item():.6f}")
    if lit <= 0.5:
        raise AssertionError(f"only {lit:.2%} of pixels are lit")
    plain = F.build_flagship_renderer(ts, WIDTH, HEIGHT, trace=R.round0_reference)
    frame_err = compare_frames("kernel frame vs plain frame", img, plain(tp))
    fused_frame = img  # phase 16 holds the twin to it
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
    n_rays = o3.shape[0]
    del tp, lay, prm0, o3, d3, plain

    kernels = [
        kernel_entry("round0 screen-tap form (K1, fused Whitted round, one 1080p tap)", K1_SOURCE, K1_REPLACES,
                     launches - ray_launches, max_err, k1_ms, k1_plain_ms, *tap_bound),
        kernel_entry(f"round0 ray-input form (K1, one bounce round of {n_rays} rays)", K1_SOURCE, K1_REPLACES,
                     ray_launches, ray_err, ray_ms, ray_plain_ms, *ray_bound),
    ]
    kernels += gradient_phases(argv, card, dev)
    kernels += slice_phases(argv, card, dev, kernel_ms, k1_ms)
    twin_phases(argv, card, dev, fused_frame, kernel_ms)
    del fused_frame
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
    compare_stress_scenes(dev, 18, residual=True)

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
    resid_bound = k1_bound(lay, gw * gh, lit_shares(tap_k, gs.n_lights))
    del tap_k, tap_p

    # ---- 7. K2 against its plain version ---------------------------------------
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)  # bench.py:186
    seen = step_texel_rows(lambda p: render_frame(p, gs), gp, target)
    n_quads = sum(bh * bw for bh, bw in gs.bitmap_sizes)
    keys, vals, n_texels = next(x for x in seen if x[0].numel() == gw * gh)
    bounce_rows = [x for x in seen if x[0].numel() != gw * gh]
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
    again = K2.texel_histogram(keys, vals, n_texels)
    log(f"  two calls on the same rows: bit-equal {bool(torch.equal(again, hist_k))}")
    if not torch.equal(again, hist_k):
        raise AssertionError("two calls of K2 on the same rows differ: its sums are not taken in a fixed order")
    if not bounce_rows:
        raise AssertionError("the step's bounce round gathered no texel")
    for bkeys, bvals, bn in bounce_rows:
        b_k, b_p = K2.texel_histogram(bkeys, bvals, bn), K2.texel_histogram_reference(bkeys, bvals, bn)
        b_err, b_scale = (b_k - b_p).abs().max().item(), b_p.abs().max().item()
        log(f"  the bounce round's {bkeys.numel()} rows: max |K2 - plain| {b_err:.3e}, max|plain| {b_scale:.3e}")
        if not bool(torch.isfinite(b_k).all()) or b_err > K2_LIMIT * max(1.0, b_scale):
            raise AssertionError(f"K2 differs from its plain version by {b_err:.3e} on the bounce round's rows")
        k2_err = max(k2_err, b_err)
    del seen, hist_k, hist_p, again, bounce_rows

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
    in_range = (keys >= 0) & (keys < n_texels)
    lib_keys, lib_vals = keys[in_range].long(), vals[in_range]
    k2_lib_ms, _ = time_events(
        lambda k: torch.zeros((n_texels, vals.shape[1]), dtype=vals.dtype, device=dev).index_add_(0, lib_keys, lib_vals),
        20, 3)
    log(f"  K2 per {keys.numel()}-row histogram: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"one index_add_ call {k2_lib_ms:.3f} ms")
    # what precedes K2 in the texel VJP (ops/shade.py _QuadGather.backward): a
    # stable sort of the keys and a gather of the cotangent rows, timed on
    # the same rows shuffled by a seeded permutation
    shuffle = torch.from_numpy(np.random.default_rng(10).permutation(keys.numel())).to(dev)
    kf, gf = keys[shuffle].contiguous(), vals[shuffle].contiguous()

    def sort_rows(k):
        sk, perm = torch.sort(kf, stable=True)
        return sk, gf[perm].contiguous()

    sort_ms, _ = time_events(sort_rows, 20, 3)
    log(f"  the texel VJP's torch.sort and row gather before K2, on the same {keys.numel()} rows: {sort_ms:.3f} ms")
    # K2 reads every key and cotangent row once and writes every texel row once; one add per value
    k2_bound = bound(keys.numel() * 4 + vals.numel() * 4 + n_texels * vals.shape[1] * 4, vals.numel())
    log(f"  peak device memory of a step {peak:.2f} GiB")
    if "--profile" in argv:
        profile_run("gradient step", lambda: grad_step(lambda p: render_frame(p, gs), jittered(gp, 98), target))
    log(json.dumps({"grad_step_ms": step_ms, "grad_step_plain_ms": step_plain_ms, "grad_max_rel_err": grad_err,
                    "grad_step_peak_gib": peak, "fit_losses": losses, "texel_sort_ms": sort_ms}))

    return [
        kernel_entry(f"round0 residual form (K1 with want_hit and want_vis, one {gw}x{gh} tap)", K1_SOURCE,
                     K1_REPLACES, step_resid, resid_err, resid_ms, resid_plain_ms, *resid_bound),
        kernel_entry(f"texel_hist (K2, texel-gradient histogram of {keys.numel()} rows)",
                     "chess2rt_tpu_torch/csrc/texel_hist.cu", "chess2rt_tpu/ops/texel_hist.py:41",
                     step_k2, k2_err, k2_ms, k2_plain_ms, *k2_bound, library_ms=k2_lib_ms),
    ]


def slice_phases(argv, card, dev, phase5_frame_ms, phase5_k1_ms):
    """Phases 11-15: the pixel-slice paths and the stage probes.  Returns
    the kernels-line entries of K1's lin-input form and K3's four stages."""
    import torch
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import round0_probe as K3
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn, make_sharded_value_and_grad
    from chess2rt_tpu_torch.render.pipeline import aa_detect, render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    mesh = make_mesh([dev] * MESH_ENTRIES)

    # ---- 11. K1's lin-input form against its plain version ----------------------
    log("phase 11 K1 lin-input form vs plain (the phase 3 limits), 4 slices, plain and residual rows")
    w, h = SMALL
    tp, ts = pack_scene(flagship_standin(T, w, h), device=dev)
    n_slice = w * h // 4
    small_err, differing = 0.0, 0
    for residual in (False, True):
        lay = R.layout(ts, w, h, want_hit=residual, want_vis=residual)
        full = R.round0(lay, lay.pack(tp, AA))
        parts = []
        for i in range(4):
            prm = lay.pack(tp, AA, i * n_slice)
            before = R.lin_launches
            out = R.round0(lay, prm, lin_input=True, n_lanes=n_slice)
            if R.lin_launches != before + 1:
                raise AssertionError("round0(lin_input=True) did not launch K1's lin-input form")
            label = f"{w}x{h} slice {i}" + (" residual" if residual else "")
            small_err = max(small_err, compare_round0(label, out, R.round0_reference(
                lay, prm, lin_input=True, n_lanes=n_slice), lay.names))
            parts.append(out)
        differing += sum(int((torch.cat([p[k] for p in parts]) != full[k]).sum()) for k in full)
    log(f"  slices concatenated vs the screen-tap launch: {differing} differing lane values (0 expected)")
    if differing:
        raise AssertionError(f"the lin-input slices differ from the screen-tap launch on {differing} lane values")

    # ---- 12. the sharded frame ------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    n = WIDTH * HEIGHT
    sharded = make_sharded_render_fn(ts, mesh)
    n_pad = n + (-n) % (len(mesh) * R.BOUNCE_BLOCK)  # parallel/mesh.py _fused_shard_setup
    C = n_pad // len(mesh)
    log(f"phase 12 sharded frame {WIDTH}x{HEIGHT}, AA5, maxTraceDepth {ts.max_trace_depth}: mesh of {len(mesh)} "
        f"entries of {dev}, {C} lanes ({C // R.BOUNCE_BLOCK} blocks) each, {n_pad - n} pad lanes")
    single = render_frame(tp, ts)
    R.launches = R.resid_launches = R.ray_launches = R.lin_launches = 0
    F.bounce_rounds = 0
    img = sharded(tp)
    torch.cuda.synchronize()
    shard_lin, shard_rays, rounds = R.lin_launches, R.ray_launches, F.bounce_rounds
    log(f"  K1 launches {R.launches}: lin-input form {shard_lin}, ray-input form {shard_rays}; "
        f"bounce rounds {rounds}")
    if shard_lin != 5 * len(mesh) or R.launches != shard_lin + shard_rays or shard_rays != rounds:
        raise AssertionError(f"the sharded frame launched the lin-input form {shard_lin} times for "
                             f"{len(mesh)} shards of 5 taps, and {R.launches} kernels in all")
    shard_err = (img - single).abs().max().item()
    log(f"  sharded vs single frame: max abs {shard_err:.3e} (limit {SHARD_LIMIT}), "
        f"equal: {bool(torch.equal(img, single))}, differing values {int((img != single).sum())}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not shard_err <= SHARD_LIMIT:
        raise AssertionError(f"the sharded frame differs from the single frame by {shard_err:.3e}")
    plain_frame = F.build_flagship_renderer(ts, WIDTH, HEIGHT, trace=R.round0_reference)(tp)
    compare_frames("sharded frame vs plain frame", img, plain_frame)
    single_ms, single_all = time_events(lambda k: render_frame(jittered(tp, k), ts), 5, 2)
    shard_ms, shard_all = time_events(lambda k: sharded(jittered(tp, k)), 5, 2)
    log(f"  timing (CUDA events, median of 5 after 2 warm-ups) on {card}")
    log(f"  single frame  {single_ms:.3f} ms {['%.3f' % t for t in single_all]} (phase 5: {phase5_frame_ms:.3f} ms)")
    log(f"  sharded frame {shard_ms:.3f} ms {['%.3f' % t for t in shard_all]}")
    lay = R.layout(ts, WIDTH, HEIGHT)
    # the main path's own shape: every shard's tap of C lanes at its base
    lin_err = 0.0
    for i in range(len(mesh)):
        prm_i = lay.pack(tp, AA, i * C)
        lin_err = max(lin_err, compare_round0(
            f"shard {i} tap ({C} lanes at base {i * C})", R.round0(lay, prm_i, lin_input=True, n_lanes=C),
            R.round0_reference(lay, prm_i, lin_input=True, n_lanes=C), lay.names))
    log(f"  K1 lin-input form vs plain, largest |a - b|: {lin_err:.3e} at the shard taps, {small_err:.3e} at "
        f"{SMALL[0]}x{SMALL[1]}")
    prm_lin = lay.pack(tp, (0.0, 0.0), C)
    lin_ms, _ = time_events(lambda k: R.round0(lay, prm_lin, lin_input=True, n_lanes=C), 20, 3)
    lin_plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm_lin, lin_input=True, n_lanes=C), 5, 1)
    lin_bound = k1_bound(lay, C, lit_shares(R.round0(lay, prm_lin, lin_input=True, n_lanes=C, want_vis=True),
                                            ts.n_lights))
    log(f"  K1 lin-input form per shard tap ({C} lanes): kernel {lin_ms:.3f} ms, plain {lin_plain_ms:.3f} ms")
    del img

    # ---- 13. the chunked and the adaptive frame ---------------------------------------
    tc = dataclasses.replace(ts, chunk_pixels=CHUNK_PIXELS)
    log(f"phase 13 chunked frame: chunk_pixels {CHUNK_PIXELS} ({-(-n // CHUNK_PIXELS)} slabs)")
    R.launches = R.ray_launches = R.lin_launches = 0
    chunked = render_frame(tp, tc)
    torch.cuda.synchronize()
    log(f"  K1 launches {R.launches}, all in the ray-input form: {R.ray_launches == R.launches}")
    if R.launches < 5 * -(-n // CHUNK_PIXELS) or R.ray_launches != R.launches:
        raise AssertionError("the chunked frame did not run every slab through K1's ray-input form")
    # a slab's rays come from screen_rays, the un-chunked tap's from the
    # kernel's own ray-gen: a few knife-edge pixels move, so the frames are
    # held to the frame limits and the share within SHARD_LIMIT is printed
    d = (chunked - single).abs().amax(-1)
    chunk_err = compare_frames("chunked vs un-chunked frame", chunked, single)
    log(f"  pixels within {SHARD_LIMIT} of the un-chunked frame: {(d <= SHARD_LIMIT).double().mean().item():.6f}")
    del chunked, d

    def peak_of(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    peak_single = peak_of(lambda: render_frame(tp, ts))
    peak_chunk = peak_of(lambda: render_frame(tp, tc))
    chunk_ms, chunk_all = time_events(lambda k: render_frame(jittered(tp, k), tc), 5, 2)
    log(f"  chunked frame {chunk_ms:.3f} ms {['%.3f' % t for t in chunk_all]} (single frame {single_ms:.3f} ms)")
    log(f"  peak device memory above the scene: un-chunked {peak_single:.3f} GiB, chunked {peak_chunk:.3f} GiB")

    ta = dataclasses.replace(ts, aa_adaptive=True)
    cap_aa = F._aa_capacity(-(-n // 32))
    base_tap = F.build_flagship_renderer(dataclasses.replace(ts, aa_enabled=False), WIDTH, HEIGHT)(tp)
    flagged = int(aa_detect(base_tap).sum())
    branch = "lane-compacted" if flagged <= cap_aa else "full-width (overflow)"
    log(f"  adaptive AA: {flagged} flagged pixels ({flagged / n:.4%}), capacity {cap_aa} lanes: {branch} taps")
    R.launches = R.resid_launches = R.ray_launches = R.lin_launches = 0
    F.bounce_rounds = 0
    adaptive = render_frame(tp, ta)
    torch.cuda.synchronize()
    screen_taps, ray_taps = R.launches - R.ray_launches, R.ray_launches - F.bounce_rounds
    log(f"  K1 launches {R.launches}: screen-tap form {screen_taps}, ray-input form {R.ray_launches} "
        f"({F.bounce_rounds} bounce rounds, {ray_taps} taps)")
    # compacted: the base tap on the screen, the 4 others as rays at the
    # flagged lanes; overflow: all 5 on the screen
    want = (1, 4) if flagged <= cap_aa else (5, 0)
    if (screen_taps, ray_taps) != want or R.lin_launches or R.resid_launches:
        raise AssertionError(f"the adaptive frame ran {screen_taps} screen taps and {ray_taps} ray-input taps, "
                             f"not the {want} of the {branch} branch")
    plain_adaptive = F.build_flagship_renderer(ta, WIDTH, HEIGHT, trace=R.round0_reference)(tp)
    adaptive_err = compare_frames("adaptive frame vs plain adaptive frame", adaptive, plain_adaptive)
    adaptive_ms, adaptive_all = time_events(lambda k: render_frame(jittered(tp, k), ta), 5, 2)
    log(f"  adaptive frame {adaptive_ms:.3f} ms {['%.3f' % t for t in adaptive_all]} "
        f"(quirk AA5 frame {single_ms:.3f} ms)")
    if "--profile" in argv:
        profile_run("sharded frame", lambda: sharded(jittered(tp, 97)))
        profile_run("chunked frame", lambda: render_frame(jittered(tp, 96), tc))
        profile_run("adaptive frame", lambda: render_frame(jittered(tp, 95), ta))
    del adaptive, plain_adaptive, base_tap, plain_frame, single

    # ---- 14. the sharded gradient step -------------------------------------------------
    gw, gh = GRAD_SIZE
    gp, gs = pack_scene(flagship_standin(T, gw, gh), device=dev)
    gs = dataclasses.replace(gs, aa_enabled=False)
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)
    log(f"phase 14 sharded gradient step {gw}x{gh}, AA off, {len(mesh)} entries, every leaf")
    step = make_sharded_value_and_grad(gs, mesh)
    R.launches = R.resid_launches = R.lin_launches = K2.launches = 0
    loss_s, grads_s = step(gp, target)
    torch.cuda.synchronize()
    step_lin, step_resid, step_k2 = R.lin_launches, R.resid_launches, K2.launches
    log(f"  K1 launches {R.launches} (lin-input form {step_lin}, residual form {step_resid}), K2 launches {step_k2}")
    if step_lin != len(mesh) or step_resid != R.launches or step_k2 != R.launches:
        raise AssertionError("the sharded step did not run K1's residual lin-input form once per shard "
                             "and K2 once per bitmap gather")
    glay = R.layout(gs, gw, gh, want_hit=True, want_vis=True)
    gC = (gw * gh + (-(gw * gh)) % (len(mesh) * R.BOUNCE_BLOCK)) // len(mesh)
    step_lin_err = 0.0
    for i in range(len(mesh)):
        prm_i = glay.pack(gp, (0.0, 0.0), i * gC)
        step_lin_err = max(step_lin_err, compare_round0(
            f"shard {i} residual tap ({gC} lanes at base {i * gC})",
            R.round0(glay, prm_i, lin_input=True, n_lanes=gC),
            R.round0_reference(glay, prm_i, lin_input=True, n_lanes=gC), glay.names))
    loss_1, grads_1, _ = grad_step(lambda p: render_frame(p, gs), gp, target)
    log(f"  loss sharded {loss_s.item():.9g}, single device {loss_1.item():.9g}")
    if not abs(loss_s.item() - loss_1.item()) <= LOSS_RTOL * abs(loss_1.item()):
        raise AssertionError("the sharded and the single-device loss differ")
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, leaves
    step_err = compare_grads("sharded vs single-device step", dict(zip(LEAF_NAMES, leaves(grads_s))), grads_1)
    step_ms, step_all = time_events(lambda k: step(jittered(gp, k), target), 5, 2)
    step1_ms, step1_all = time_events(lambda k: grad_step(lambda p: render_frame(p, gs), jittered(gp, k), target),
                                      5, 2)
    log(f"  sharded step {step_ms:.3f} ms {['%.3f' % t for t in step_all]}")
    log(f"  single step  {step1_ms:.3f} ms {['%.3f' % t for t in step1_all]}")
    del grads_s, grads_1

    # ---- 15. K3: the stage probes --------------------------------------------------------
    log(f"phase 15 K3 stage probes vs plain at 320x240 and {WIDTH}x{HEIGHT} (the phase 3 limits), then the ladder")
    w, h = SMALL
    sp, ss = pack_scene(flagship_standin(T, w, h), device=dev)
    slay = R.layout(ss, w, h)
    sprm = slay.pack(sp, AA)
    for stage in K3.STAGES:
        before = K3.launches[stage]
        out = K3.round0_stage(slay, sprm, stage)
        if K3.launches[stage] != before + 1:
            raise AssertionError(f"round0_stage did not launch the {stage} kernel")
        compare_stage(f"{stage} {w}x{h}", out, K3.round0_stage_reference(slay, sprm, stage))
    prm_aa = lay.pack(tp, AA)
    stage_err = {stage: compare_stage(f"{stage} {WIDTH}x{HEIGHT}", K3.round0_stage(lay, prm_aa, stage),
                                      K3.round0_stage_reference(lay, prm_aa, stage)) for stage in K3.STAGES}
    for stage in K3.STAGES:
        K3.launches[stage] = 0
    called, queued = ladder(lay, prm_aa, reps=20, warm=3)
    stage_launches = dict(K3.launches)
    lit = lit_shares(R.round0(lay, lay.pack(tp, AA), want_vis=True), ts.n_lights)
    entries = [kernel_entry(f"round0 lin-input form (K1, one shard tap of {C} lanes)", K1_SOURCE,
                            "chess2rt_tpu/ops/pallas_trace.py:1090", shard_lin, lin_err,
                            lin_ms, lin_plain_ms, *lin_bound)]
    log(f"  ladder at {WIDTH}x{HEIGHT} on {card}: ms per call (median of 20 after 3 warm-ups, the wrapper's host "
        f"work included) and ms per launch of 20 queued back to back behind a busy device (the kernel alone)")
    for stage in K3.STAGES:
        usage = cuda_build.ptxas_usage(f"round0_{stage}")
        plain_ms, _ = time_events(lambda k: K3.round0_stage_reference(lay, prm_aa, stage), 3, 1)
        stage_bound = k1_bound(lay, n, lit, stage)
        b_ms, b_by = stage_bound[:2]
        log(f"  {stage:7s} {called[stage]:.3f} ms per call, {queued[stage]:.4f} ms queued "
            f"(the design before: {PREVIOUS_LADDER_MS[stage]:.4f}; plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}); "
            f"registers {usage[0] if usage else 'not logged'}, stack {usage[1] if usage else 'not logged'} bytes, "
            f"launches {stage_launches[stage]}")
        if stage_launches[stage] < 1:
            raise AssertionError(f"the ladder did not launch the {stage} kernel")
        entries.append(kernel_entry(f"round0 stage probe: {stage} (K3, {WIDTH}x{HEIGHT})", K1_SOURCE,
                                    "demos/kernel_probe.py:45", stage_launches[stage], stage_err[stage],
                                    called[stage], plain_ms, *stage_bound))
    usage = cuda_build.ptxas_usage("round0")
    log(f"  full K1 {called['full']:.3f} ms per call, {queued['full']:.4f} ms queued (the design before: "
        f"{PREVIOUS_LADDER_MS['full']:.4f}; phase 5: {phase5_k1_ms:.3f} ms); registers "
        f"{usage[0] if usage else 'not logged'}, stack {usage[1] if usage else 'not logged'} bytes")
    log(json.dumps({
        "sharded_frame_ms": shard_ms, "single_frame_ms": single_ms, "sharded_frame_max_abs_err": shard_err,
        "chunked_frame_ms": chunk_ms, "chunked_frame_max_abs_err": chunk_err,
        "peak_gib_unchunked": peak_single, "peak_gib_chunked": peak_chunk,
        "adaptive_frame_ms": adaptive_ms, "adaptive_flagged": flagged, "adaptive_capacity": cap_aa,
        "adaptive_branch": branch, "adaptive_frame_max_abs_err": adaptive_err,
        "sharded_step_ms": step_ms, "single_step_ms": step1_ms, "sharded_step_max_rel_err": step_err,
        "lin_max_abs_err_small": small_err, "lin_residual_max_abs_err_step_shard": step_lin_err,
        "ladder_ms": called, "ladder_queued_ms": queued,
        "stage_registers": {k: (cuda_build.ptxas_usage(f"round0_{k}") or [None])[0] for k in K3.STAGES},
    }))
    return entries


def bmp_u8(path):
    """[h, w, 3] uint8 RGB of a BMP file (the port's decoder)."""
    from chess2rt_tpu_torch.imageio.bmp import load_bmp_file

    p = load_bmp_file(path).pixels_u32
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1).astype(np.uint8)


def run_cli(args, timeout=600):
    """``python -m chess2rt_tpu_torch *args`` from the repository root:
    (stdout, wall seconds); raises on a nonzero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "chess2rt_tpu_torch", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the CLI exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout, wall


def first_frame_split(path, dtype_name, size):
    """A fresh process's first frames of a scene file, stage by stage: what
    the CLI's render stage is made of.  Run as ``python chip_smoke.py
    --first-frame SCENE f32|f64 WxH``; prints one JSON line of wall seconds."""
    t = time.perf_counter()
    import torch

    out = {"import_torch": time.perf_counter() - t}
    dev = torch.device(DEVICE)
    t = time.perf_counter()
    torch.zeros((), device=dev)
    torch.cuda.synchronize()
    out["init"] = time.perf_counter() - t
    t = time.perf_counter()
    sys.path.insert(0, ROOT)
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scene import parse_scene_from_file

    out["import_port"] = time.perf_counter() - t
    w, h = (int(v) for v in size.split("x"))
    scene = parse_scene_from_file(path)
    scene.settings.frameWidth, scene.settings.frameHeight = w, h
    scene.camera.set_frame_size(w, h)
    t = time.perf_counter()
    packed, static = pack_scene(scene, dtype=torch.float64 if dtype_name == "f64" else torch.float32, device=dev)
    torch.cuda.synchronize()
    out["pack"] = time.perf_counter() - t
    t = time.perf_counter()
    if dtype_name == "f32":
        cuda_build.load("round0")
    out["k1_library"] = time.perf_counter() - t
    # the first call of each library the frames use, each on its own
    dt, first = packed.dtype, {}

    def first_call(name, fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[name] = time.perf_counter() - t

    first_call("matmul", lambda: torch.ones((3, 3), dtype=dt, device=dev) @ torch.ones((3, 3), dtype=dt, device=dev))
    first_call("inv_ex", lambda: torch.linalg.inv_ex(torch.eye(4, dtype=dt, device=dev).expand(8, 4, 4)))
    first_call("sort", lambda: torch.sort(torch.arange(1 << 17, dtype=torch.int32, device=dev)))
    if dtype_name == "f32":
        from chess2rt_tpu_torch.ops import round0 as R

        lay = R.layout(static, 64, 48)
        prm = lay.pack(packed)
        first_call("k1_64x48", lambda: R.round0(lay, prm))
    out["first_calls"] = first
    out["frames"] = []
    for _ in range(3):
        t = time.perf_counter()
        with torch.no_grad():
            render_frame(packed, static).cpu()
        out["frames"].append(time.perf_counter() - t)
    print(json.dumps(out))
    return 0


def run_first_frame(path, dtype_name, size, loading):
    """``first_frame_split`` in a fresh process with ``CUDA_MODULE_LOADING``
    set to ``loading``; its dict, plus the process's whole wall time."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-frame", path, dtype_name,
                          f"{size[0]}x{size[1]}"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_MODULE_LOADING=loading))
    if res.returncode != 0:
        raise AssertionError(f"the first-frame split exited {res.returncode}:\n{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["process"] = time.perf_counter() - t0
    return out


def compare_u8(label, got, want):
    """Count the bytes of two uint8 images that differ; 0 expected."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape}, want {want.shape}")
    differing = int((got != want).sum())
    log(f"  {label}: {differing} differing bytes of {got.size}")
    if differing:
        raise AssertionError(f"{label}: {differing} bytes differ")


def twin_phases(argv, card, dev, fused_frame, phase5_frame_ms):
    """Phases 16-18: the eager Whitted twin, float64 frames on the card and
    the CLI end to end."""
    import torch
    from chess2rt_tpu_torch import app
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.oracle import OracleRenderer
    from chess2rt_tpu_torch.render.pipeline import render_frame, render_frame_wavefront
    from chess2rt_tpu_torch.scene import parse_scene_from_file
    from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin, write_standin_sdl
    from chess2rt_tpu_torch.utils.color import srgb_u8

    def zero_counts():
        R.launches = R.resid_launches = R.ray_launches = R.lin_launches = 0
        F.bounce_rounds = 0

    # ---- 16. the twin at 1080p ------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    log(f"phase 16 twin frame {WIDTH}x{HEIGHT}, AA5, maxTraceDepth {ts.max_trace_depth}, f32 "
        f"(render_frame_wavefront, plain PyTorch)")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    twin = render_frame_wavefront(tp, ts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    twin_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if R.launches:
        raise AssertionError(f"the twin launched K1 {R.launches} times; it is the plain path")
    if tuple(twin.shape) != (HEIGHT, WIDTH, 3) or twin.dtype != torch.float32 or twin.device != dev:
        raise AssertionError(f"twin frame {tuple(twin.shape)} {twin.dtype} on {twin.device}")
    log(f"  first frame {first_s:.3f} s wall, peak device memory above the scene {twin_peak:.3f} GiB")
    twin_err = compare_frames("twin frame vs fused frame (phase 4)", twin, fused_frame)
    del twin
    # two warm-ups: the frame above and one more
    twin_ms, twin_all = time_events(lambda k: render_frame_wavefront(jittered(tp, k), ts), 3, 1)
    log(f"  twin frame {twin_ms:.3f} ms {['%.3f' % t for t in twin_all]} (fused frame, phase 5: "
        f"{phase5_frame_ms:.3f} ms; {twin_ms / phase5_frame_ms:.1f}x) on {card}")
    if "--profile" in argv:
        profile_run("twin frame", lambda: render_frame_wavefront(jittered(tp, 94), ts))
    del tp

    # ---- 17. float64 on the card ------------------------------------------------------------
    w, h = SMALL
    log(f"phase 17 float64 frames on the card: the stand-in at {w}x{h}, AA off, through render_frame, "
        f"against the port's float64 oracle")

    def f64_frame(scene):
        p64, s64 = pack_scene(scene, dtype=torch.float64, device=dev)
        zero_counts()
        img = render_frame(p64, s64)
        torch.cuda.synchronize()
        if R.launches or img.dtype != torch.float64 or img.device != dev:
            raise AssertionError(f"the f64 frame ({img.dtype} on {img.device}) launched K1 {R.launches} times")
        ms, all_ms = time_events(lambda k: render_frame(p64, s64), 3, 1)
        return img.cpu().numpy(), ms, all_ms

    def u8(x):
        return srgb_u8(np.asarray(x, np.float32))

    sc = flagship_standin(T, w, h)
    sc.settings.AAEnabled = False
    img64, f64_ms, f64_all = f64_frame(sc)
    t0 = time.perf_counter()
    gold = OracleRenderer(sc).render()
    oracle_s = time.perf_counter() - t0
    f64_err = float(np.abs(img64 - gold).max())
    f64_u8 = float((u8(img64) == u8(gold)).all(-1).mean())
    log(f"  stand-in {w}x{h} f64: {f64_ms:.3f} ms {['%.3f' % t for t in f64_all]}; against the oracle "
        f"({oracle_s:.2f} s on the host): max |d| {f64_err:.3e}, u8 equal on {f64_u8:.6f} of pixels")
    if not (f64_err < 1e-4 and f64_u8 > 0.999):
        raise AssertionError(f"f64 stand-in against the oracle: max |d| {f64_err:.3e}, u8 equal {f64_u8:.6f}")
    sc = csg_free_scene(T, 0, 64, 48)
    img64, free_ms, free_all = f64_frame(sc)
    gold = OracleRenderer(sc).render()
    free_err = float(np.abs(img64 - gold).max())
    free_diff = int((u8(img64) != u8(gold)).any(-1).sum())
    log(f"  CSG-free scene 64x48 AA5 f64: {free_ms:.3f} ms {['%.3f' % t for t in free_all]}; against the "
        f"oracle: max |d| {free_err:.3e}, {free_diff} pixels differ in u8")
    if free_err >= 1e-6 or free_diff:
        raise AssertionError(f"CSG-free f64 frame against the oracle: max |d| {free_err:.3e}, {free_diff} pixels")

    # ---- 18. the CLI end to end ------------------------------------------------------------
    log(f"phase 18 CLI: python -m chess2rt_tpu_torch on a scene file with the stand-in's features")
    with tempfile.TemporaryDirectory() as tmp:
        path = write_standin_sdl(tmp, WIDTH, HEIGHT)
        zero_counts()
        if app.main(["--file", path, "-o", os.path.join(tmp, "inproc.bmp"), "-q"]) != 0:
            raise AssertionError("app.main returned nonzero")
        torch.cuda.synchronize()
        cli_launches, cli_rays = R.launches, R.ray_launches
        log(f"  app.main in this process: K1 launches {cli_launches} (ray-input form {cli_rays}, "
            f"bounce rounds {F.bounce_rounds})")
        if cli_launches - cli_rays != 5 or cli_rays != F.bounce_rounds or cli_rays < 5:
            raise AssertionError(f"the CLI's f32 frame launched K1 {cli_launches} times ({cli_rays} ray-input)")

        def in_process(size, dtype):
            scene = parse_scene_from_file(path)
            scene.settings.frameWidth, scene.settings.frameHeight = size
            scene.camera.set_frame_size(*size)
            p, s = pack_scene(scene, dtype=dtype, device=dev)
            with torch.no_grad():
                return srgb_u8(render_frame(p, s).float().cpu().numpy())

        stages = {}
        for label, size, dtype, extra in (("f32", (WIDTH, HEIGHT), torch.float32, []),
                                          ("f64", SMALL, torch.float64, ["--dtype", "f64"])):
            out = os.path.join(tmp, f"cli_{label}.bmp")
            stdout, wall = run_cli(["--file", path, "-o", out, "--size", f"{size[0]}x{size[1]}", "--stats",
                                    "-q", *extra])
            line = next(x for x in stdout.splitlines() if x.startswith("Stages: "))
            stages[label] = {k: float(v.split()[0]) for k, v in
                             (part.split(" ", 1) for part in line[len("Stages: "):].split(", "))}
            stages[label]["process"] = wall
            log(f"  {label} {size[0]}x{size[1]}: {line} ({wall:.3f} s for the whole process)")
            compare_u8(f"{label} CLI BMP vs srgb_u8 of render_frame in this process", bmp_u8(out),
                       in_process(size, dtype))
        # the dump in this process (a third process would add ~10 s of start-up)
        dump = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(dump):
            rc = app.main(["--file", path, "--size", f"{w}x{h}", "--dtype", "f64", "-q",
                           "--debug-pixel", f"{w // 2},{h // 2}"])
        wall = time.perf_counter() - t0
        log(f"  app.main --dtype f64 --size {w}x{h} --debug-pixel {w // 2},{h // 2} ({wall:.3f} s):")
        for line in dump.getvalue().splitlines():
            log(f"    {line}")
        if rc != 0 or "Mouse click at" not in dump.getvalue() or "oracle (f64)" not in dump.getvalue():
            raise AssertionError("the debug-pixel dump is missing")
        # the render stage split: what a fresh process's first frame spends beyond a warm one
        first = {}
        for label, size in (("f32", (WIDTH, HEIGHT)), ("f64", SMALL)):
            for loading in ("LAZY", "EAGER"):
                r = run_first_frame(path, label, size, loading)
                first[f"{label}_{loading.lower()}"] = r
                log(f"  fresh process {label} {size[0]}x{size[1]}, CUDA_MODULE_LOADING={loading}: import torch "
                    f"{r['import_torch']:.3f}, init {r['init']:.3f}, import the port {r['import_port']:.3f}, pack "
                    f"{r['pack']:.3f}, K1 library {r['k1_library']:.3f}, first calls "
                    f"{', '.join('%s %.3f' % kv for kv in r['first_calls'].items())}, frames "
                    f"{', '.join('%.3f' % f for f in r['frames'])} s ({r['process']:.3f} s for the process)")
    log(json.dumps({
        "twin_frame_ms": twin_ms, "twin_frame_all_ms": twin_all, "twin_first_frame_s": first_s,
        "twin_peak_gib": twin_peak, "twin_frame_max_abs_err": twin_err,
        "f64_standin_ms": f64_ms, "f64_standin_oracle_max_abs": f64_err, "f64_standin_oracle_u8_equal": f64_u8,
        "f64_csg_free_ms": free_ms, "f64_csg_free_oracle_max_abs": free_err,
        "cli_k1_launches": cli_launches, "cli_stages_s": stages, "first_frame_split_s": first,
    }))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-frame"]:
        sys.exit(first_frame_split(*sys.argv[2:5]))
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
