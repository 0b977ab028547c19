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
  goes through K1 (screen-tap and ray-input forms);
* the Monte-Carlo frames: depth of field, stereo, and GI: the GI stand-in
  (``scenes.gi_standin``, NEE on) at 640x480 with 40 paths per pixel and
  maxTraceDepth 5 through ``render_frame`` (ops/gi.py: K1's want_hit
  ray-input form per bounce, the threefry draw, the texels), and its
  gradient step (K1's residual form and K2 in the backward);
* the scene extensions: ``scenes.bump_scene`` at 1920x1080 AA5 (every
  round-0 call in the bump hybrid, ops/bump_round0.py, on K1's residual
  form, in its fast and its reshade gate), the stand-in under a sky
  cubemap at 1920x1080 AA5 (the merged bitmap+cubemap gather), their
  640x480 gradient steps (K2 on the merged table), GI under the sky, and
  a frame with the compensated (df32) ray-gen through the twin;
* distribution: the per-shard sampler over 4 entries of the card
  (``parallel.make_sharded_render_fn`` and ``make_sharded_value_and_grad``
  on DoF, stereo, GI and float64 frames: K1's ray-input form or the fused
  GI tracer and the threefry draw per shard, keys folded per shard), the
  gradient step with ``pin_mode="node"``, two processes sharing the card
  over ``torch.distributed`` (``parallel.mp_dryrun.run_multiprocess_
  dryrun``, gloo), and the ray counters (``utils.diagnostics.
  frame_ray_stats``);
* the host apps: the interactive session (``gui.InteractiveSession``) on
  the stand-in's scene file at 1920x1080 AA5 driven by camera events
  (previews through K1's screen-tap and ray-input forms), the progressive
  viewer, the async renderer, ``python -m chess2rt_tpu_torch --interactive``
  on a pseudo-terminal, the four demo twins (``chess2rt_tpu_torch.demos``:
  K1's residual form, K2 and the draw under ``fit``) and the scaling recipe
  (K1's lin-input form);
* the DoF + cubemap showcase: ``demos.zaphod_skybox`` (the twin of
  demos/zaphod_skybox.py, BASELINE config #4) and ``render_frame`` on
  ``scenes.flagship_standin(dof=True, env=True)`` at 1920x1080 AA5 with 25
  samples: every pass through K1's ray-input form with the merged
  bitmap+cubemap gather, four threefry draws per pass;
* the bench twin, ``python -m chess2rt_tpu_torch.bench`` (the root
  bench.py's six modes): the 1080p frame (K1's screen-tap and ray-input
  forms), the sharded frame (the lin-input form), the 640x480 gradient
  step (the residual form, K2), the GI step (the residual form, K2, the
  draw), the card's gate ``--check`` and the ray-count extrapolation;
* the engine modes of ``SceneStatic``: ``gi_path_batch`` (the 640x480 GI
  frame, 8 paths per K1 launch over 2,457,600 lanes, its draws through the
  batched threefry kernel), ``bounce_mode`` (block, compact, full) and
  ``texel_tap_reuse`` on the 1080p AA5 frame, and ``texel_grad_mode`` on the
  640x480 step (histogram through K2, sorted and scatter without it).

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: K1, K2, the threefry draw and K3's four stages from the
   checkout's sources, one nvcc each, in parallel; registers, stack and
   spill bytes of every library;
3. K1 against its plain PyTorch version on the card: screen-tap and
   ray-input at 320x240, on the stand-in and on the four CSG stress scenes
   (16- and 40-hit lists, nested CsgDiffs, a 33-instruction nest: the hit
   lists, which the stand-in's four-hit nodes never reach), each with the
   lists in shared and in global memory (the same bits), then at the main
   path's shapes (a 1080p tap and its block-compacted bounce rays);
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
    ``CUDA_MODULE_LOADING=EAGER``;
19. the threefry draw (csrc/threefry.cu) bit-equal to its plain PyTorch
    version on the card, and the card's plain draw to the CPU's, in f32 and
    f64 at 2,073,600 lanes, with both times;
20. the DoF stand-in (``scenes.flagship_standin(dof=True)``): the kernel
    path against the plain path (plain K1, plain draws) at 640x480 with 4
    samples, then the 1080p AA5 frame with the reference's 25 samples: its
    ms (median of 3 after 1 warm-up), K1's and the draw's launch counts
    (125 ray-input taps plus the bounce rounds, 500 draws), peak memory,
    and the draws' share of the frame; K1's ray-input form against its
    plain version on the frame's DoF rays;
21. the stereo stand-in at 1080p AA5: kernel path against plain path, its
    ms;
22. the adaptive DoF frame at 1080p (4 samples): the flagged pixels, the
    capacity, the lane-compacted taps against the full-width ones; the
    chunked DoF frame (``chunk_pixels`` 262,144) against the un-chunked
    frame;
23. K1's want_hit form without the vis rows (GI's) against its plain
    version at 640x480: on the GI stand-in's jittered camera rays and on
    one bounce of its hemisphere rays, the light rows of unshaded lanes
    zero; its times per call and queued, and its bound;
24. the GI frame at 640x480: the kernel path against the plain path (plain
    K1, plain draws) and against the twin at 4 paths, the 40-path frame's
    ms (median of 3 after 1 warm-up), K1's, the draw's and the bounce
    rounds' counts and peak memory; the chunked (``chunk_pixels`` 65,536)
    and the adaptive-AA GI frames against the twin;
25. the GI gradient step at 640x480: the kernel path against the plain path
    at 4 paths (the phase 8 rule on the pixels whose frames agree), then
    the 40-path step's ms and peak memory with ``gi_remat_paths`` off and
    on (one timed step after the warm-up when a step takes over 20 s);
26. bump: K1's residual form against its plain version on
    ``scenes.bump_scene`` at 320x240 (screen-tap and ray-input) and on a
    1080p tap (its ms, queued ms and bound), then the AA5 bump frame with
    its mirror in both gates (``bump_csg`` False: the fast forward; True:
    the reshade forward): kernel path against plain path at 640x480, ms
    (median of 3 after 1 warm-up) and launch counts at 1080p, every
    round-0 call through the hybrid on K1's residual form, no twin frame;
27. the stand-in under a 64x64 sky cubemap (``flagship_standin(env=
    True)``, pitch -15) at 1080p AA5 depth 5: its share of pixels that
    miss, launch counts, kernel path against plain path, ms (median of 5
    after 2 warm-ups);
28. the 640x480 gradient steps of the mirror-free bump scene (both gates)
    and of the env stand-in, kernel path against plain path under phase
    8's rule, K2 on the env step's merged table (bitmap and cubemap quad
    rows) against its plain version, ms per step, K2's ms, queued ms,
    plain ms and one ``index_add_`` call on the merged rows;
29. the GI stand-in under the sky (``gi_standin(env=True)``, NEE) at
    640x480: 4 paths against the plain path and the twin, the 40-path
    frame's ms;
30. the compensated (df32) ray-gen: the stand-in at 640x480 AA5 through
    the twin (no K1 launch), against the plain-ray twin frame, its ms, and
    its rays against float64 rays beside the plain f32 rays.
31. the sharded DoF stand-in over 4 entries of the card: kernel path
    against plain path (plain K1, plain draws) at 640x480 with 4 samples,
    then the 1080p AA5 frame with 25 samples: launch counts (500 shard
    passes plus their bounce rounds, 2,000 draws), ms beside phase 20's;
    K1's ray-input form and the draw at one shard's 518,400 lanes against
    their plain versions, timed;
32. the sharded 1080p AA5 stereo frame: kernel path against plain path, ms;
33. the sharded GI frame at 640x480: kernel path against plain path at 4
    paths, the 40-path frame's ms beside phase 24's;
34. the sharded float64 stand-in at 320x240 (the sampler on the twin)
    against the port's float64 oracle at phase 17's rule;
35. the sharded DoF (4 samples) and GI (4 paths) steps at 640x480: kernel
    path against plain path at phase 8's rule on the pixels whose frames
    agree, ms per step;
36. the 640x480 gradient step with ``pin_mode="node"`` against "leaf":
    the same loss, every leaf at phase 8's rule, both ms;
37. ``run_multiprocess_dryrun(2, 640, 480)`` (the card by default): two ranks on
    the card (gloo, printed), their launch counts, against the in-process
    2-entry mesh (loss rtol 1e-5, leaves rtol 1e-4 atol 1e-6);
38. ``frame_ray_stats`` of the 1080p AA5 stand-in: the counts, the twin
    pass's ms, rays per second at phase 5's frame time;
39. ``InteractiveSession`` on ``scenes.write_standin_sdl`` at 1920x1080 AA5:
    20 scripted events (camera keys with and without Shift and Ctrl, a
    resize and back, ``r``, mouse-look, ``f2`` both ways, a click, ``f12``),
    each event's ms and launch counts (one screen tap plus its bounce
    rounds per preview), the median preview and full-refine ms beside phase
    5's frame, the stages of each (pack, render, transfer, upsample); the
    full frame after the script equal to ``render_frame`` of the moved
    camera bit for bit and within the frame limits of the plain path, the
    F12 BMP equal to the frame's u8; K1 against its plain version on the
    480x270 preview tap;
40. ``progressive_render`` at 1080p, bucket 48 (920 buckets) into a
    ``TerminalViewer`` on a StringIO: wall s, time to the first (prepass)
    blit, the final canvas equal to the full frame;
41. ``render_scene_async``: three passes and callbacks, each pass's ms, the
    AA pass equal to the full frame; a stop that lands before the first pass
    gives no frame; a scene the packer refuses re-raises from ``result()``;
42. ``python -m chess2rt_tpu_torch --interactive`` on the stand-in at
    960x540 in a fresh process on a pseudo-terminal (``drive_interactive``):
    ``w``, the idle refine, ``p``, ``q``; exit 0, the screenshot byte-equal
    to the in-process frame after ``w``, the wall s to the first blit;
43. the demo twins in process: ``inverse_render``, ``texture_recovery`` and
    ``bump_inverse`` at their defaults, ``gi_inverse`` at its default size
    with 8 steps: per-step ms, recovery errors, launches of K1, K2 and the
    draw; texture_recovery and bump_inverse meet the JAX demos' gates,
    gi_inverse's finite-difference check holds, inverse_render's loss,
    color and checker gates hold (its position error is printed beside its
    gate); K1's residual form at texture_recovery's tap, K2 on its texel
    rows and the draw at gi_inverse's width against their plain versions;
44. ``demos.pod_scaling`` at 1080p over the card's devices: forward and grad
    rays/s and ms, its JSON artifact's keys; K1's lin-input form at the
    one-shard 1080p tap against its plain version.
45. the DoF + cubemap frame: the kernel path against the plain path at
    640x480 AA5 with 4 samples, at full width and with the adaptive taps
    lane-compacted (and those against the full-width taps), each held to
    the launch rule (draws 4 per pass, K1's ray-input form once per pass
    and bounce round); the 1080p AA5 25-sample frame's ms (median of 3
    after 1 warm-up) beside phases 20 and 27, its peak memory and launch
    counts; K1's ray-input form on the frame's first pass of DoF rays
    against its plain version, timed, its miss share and bound; then
    ``demos.zaphod_skybox`` at 1080p with and without ``--adaptive-aa``:
    its BMP equal byte for byte to ``srgb_u8`` of ``render_frame`` in this
    process, its sky row lit, its first and steady frames' ms.
46. the bench twin's modes in this process at bench.py's defaults (``--grad
    --gi`` at 640x480, 40 paths, one step per call): each prints its one
    JSON line, logged with its comment line (the card, the best, median
    and every call's ms, the warm call) and its launch counts; each mode's
    path shows its kernels (main: K1's screen-tap and ray-input forms and
    no twin frame; ``--sharded``: the lin-input form; the steps: the
    residual form and K2; every timed mode: the jitter's draws), and
    ``--check`` is ok; then ``python -m chess2rt_tpu_torch.bench`` in a
    fresh process, its last line parsed;
47. the engine modes: the batched threefry draw (8 keys x 307,200 lanes,
    one launch) bit-equal to its plain version and to 8 single draws, in f32
    and f64, timed beside them, with its bound; the GI stand-in at 640x480
    with 4 paths and ``gi_path_batch`` 4, kernel path against plain path;
    the 40-path frame at K = 1 and K = 8 (K1 launches 240 and 30, draws 560
    and 70; K = 8 within rtol/atol 1e-5 of K = 1), their peak memory and ms
    interleaved (median of 3 after 1 warm-up each; with ``--profile`` the
    device-busy share of each); K1's want_hit form on 8 slabs of camera rays
    (2,457,600 lanes) against its plain version, timed, with its bound; the
    1080p AA5 frame under ``bounce_mode`` block, compact and full
    (``bounce_capacity`` 2,073,600 // 16), bit-equal, compact's overflows,
    ms interleaved; ``texel_tap_reuse`` off and on (capacity n / 8, the
    default, and n) on the same frame, bit-equal, the share of each tap's
    lanes whose texel changed and the overflows, ms interleaved; the 640x480 step under ``texel_grad_mode``
    histogram, sorted and scatter: K2 in histogram's backward only, the
    atlas gradients within atol 1e-6 rtol 1e-4 of histogram's
    (tests/test_inverse.py:219-241), ms interleaved.
49. the combine kernel (csrc/combine.cu) against ``combine_reference`` on
    the 1080p DoF + cubemap frame's first pass and its bounce round, bit
    for bit, also with missed lanes, NaN u and v and zero directions
    planted; per call and queued ms against its byte bound and the glue's;
    every ``combine_outputs`` call of the 1080p DoF + cubemap and AA5
    frames on the kernel.

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
import functools
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
# the threefry draw's integer operations per element (csrc/threefry.cu): the
# counter's two key adds 2, 20 rounds of add, rotate (one funnel shift) and
# xor 60, five key injections of three adds 15, the third key word 2, the
# bits to a float (xor or or-shift, or, subtract) 4.  Counted against the
# f32 rate above, the only non-tensor rate of the table (Hopper's 32-bit
# integer rate is half of it), so the bound stays a lower bound
OPS_THREEFRY = 83
# the Monte-Carlo phases (19-22): the draw's width (one 1080p frame), the
# DoF frame's samples at 640x480 (against the plain path) and at 1080p
# (the reference's default), the adaptive and chunked DoF frames' samples
MC_LANES = WIDTH * HEIGHT
MC_SMALL_SAMPLES, MC_SAMPLES, MC_ADAPTIVE_SAMPLES = 4, 25, 4
# the GI phases (23-25): bench.py's build_gi configuration (640x480, 40
# paths per pixel, maxTraceDepth 5, NEE, AA off), 4 paths against the plain
# path and the twin, the chunked frame's slab; a 40-path step longer than
# GI_LONG_STEP_S seconds is timed once after its warm-up
GI_SIZE, GI_PATHS, GI_SMALL_PATHS, GI_CHUNK, GI_LONG_STEP_S = (640, 480), 40, 4, 65536, 20.0
# Hopper's 32-bit integer rate (NVIDIA H100 SXM: half the f32 rate), the
# rate the threefry draw's work runs at; its bound is stated against both
PEAK_INT32 = 33.5e12
# the GI bounce kernel (csrc/gi_bounce.cu) per lane: bytes read (K1's 11
# rows, orig, dir, mult and acc, alive) and written (orig, dir, mult, acc,
# alive), and its f32 operations besides the two draws (faceforward 8, NEE
# 15, the sample's arithmetic 36 and its acos, two cos and two sin, ~20
# each, the weight and the next ray 24)
BOUNCE_BYTES, OPS_BOUNCE = (44 + 48 + 1) + (48 + 1), 183
# phase 48: the bounce kernel's widths, one path and gi_path_batch 8
BOUNCE_KS = (1, 8)
# the combine kernel (csrc/combine.cu) per lane: bytes read (win, K1's 14
# float rows, the direction) and written (colour, cont, atten, ro, rd), and
# its f32 operations (the bitmap plan 18, the cubemap plan 19, the bilerp
# 35, the blend 9)
COMBINE_BYTES, OPS_COMBINE = (4 + 56 + 12) + (12 + 1 + 36), 81


T0 = time.perf_counter()
# times of earlier phases that later phases print beside their own
MEASURED = {}


def log(msg: str) -> None:
    if msg.startswith("phase "):
        msg += f" [{time.perf_counter() - T0:.1f} s into the script]"
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


def k1_ops(lay, n, lit, stage="full", ray_input=False, scanned=1.0):
    """Arithmetic of one K1 launch on ``n`` lanes, as this run's data needs
    it.  Every lane scans every node for its closest hit.  ``scanned`` is
    the share of lanes that shade (with the vis rows every lane does, missed
    lanes from t = 0; without them only the lanes whose light sum is kept).
    A shadow scan stops at the first occluder: ``lit[l]`` is the share of
    all lanes that shade and that light l reaches (all nodes scanned), the
    other shading lanes count one node, the least an occluded lane can
    need."""
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
        per += scanned * OPS_SHADOW_RAY + share * scan_all + (scanned - share) * scan_one
        if stage == "shadow":
            per += 1
        else:
            per += scanned * (OPS_LIGHT + (OPS_PHONG if 1 in lay.static.shader_kinds_present else 0))  # 1: PHONG
    if stage == "full":
        per += OPS_OUT + (OPS_CONT if lay.has_cont else 0)
    return per * n


def bound(n_bytes, ops):
    """(bound_ms, bound_by, bytes_ms, ops_ms): the larger of bytes over the
    card's memory rate and operations over its f32 rate, and both terms."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * ops / PEAK_F32
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def k1_bound(lay, n, lit, stage="full", ray_input=False, scanned=1.0):
    """``bound`` of one K1 launch (or one K3 stage): the parameter vector,
    the scene program and the rays read once, every output row written once."""
    rows = 2 if stage != "full" else len(lay.names) + 1
    n_bytes = 4 * lay.n_prm + 4 * lay.program.size + (24 * n if ray_input else 0) + 4 * rows * n
    return bound(n_bytes, k1_ops(lay, n, lit, stage, ray_input, scanned))


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


STRESS_SCENES = ("deep16", "nested_diff", "deep40", "diff_nest")


def compare_stress_scenes(dev, seed, residual):
    """K1 against its plain version on the four CSG stress scenes
    (scenes.csg_stress_scene) at SMALL, screen-tap and ray-input, with the
    hit lists in shared memory and in global memory (the same bits both
    ways): the nodes whose hit lists are longer than four take the kernel's
    lists and its pair-table network (up to 40 slots, 39 instructions), and
    the nested CsgDiffs its replayed normal flips (a leaf under 16 of them,
    instructions past 31), none of which the stand-in reaches.  Every node
    must win some lane of the tap."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.scenes import csg_stress_scene

    w, h = SMALL
    for kind in STRESS_SCENES:
        tp, ts = pack_scene(csg_stress_scene(T, kind, w, h), device=dev)
        lay = R.layout(ts, w, h, want_hit=residual, want_vis=residual)
        prm = lay.pack(tp, AA)
        orig_t, dir_t = scattered_rays(seed, w * h, dev, center=(0.0, 1.0, 0.0), spread=6.0)
        log(f"  {kind}: list capacity {int(lay.program[R.H_LIST_CAP])}, placement "
            f"{R.list_placement(lay.program, lay.n_prm)} by the header")
        for form, rays in (("screen-tap", ()), ("ray-input", (orig_t, dir_t))):
            ref = R.round0_reference(lay, prm, *rays)
            out = {pl: R.round0(lay, prm, *rays, placement=pl) for pl in ("shared", "global")}
            compare_round0(f"{kind} {w}x{h} {form}", out["shared"], ref, lay.names)
            differ = [k for k in out["shared"] if not torch.equal(out["shared"][k], out["global"][k])]
            if differ:
                raise AssertionError(f"{kind} {form}: the global lists change {differ}")
            if form == "screen-tap":
                winners = set(out["shared"]["win"].unique().tolist())
                if winners != set(range(-1, len(ts.nodes))):
                    raise AssertionError(f"{kind}: the tap's winners {sorted(winners)} are not every node and a miss")
        log(f"  {kind}: global lists give the same bits as shared")


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


def gi_camera_rays(tp, w, h, prng_key_seed):
    """One path's jittered camera rays of a GI frame (the uniforms of
    ``split(PRNGKey(seed), 4)``'s first two keys), as the GI renderer makes
    them, on the scene's device."""
    import torch
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays

    n, dev = w * h, tp.device
    lin = torch.arange(n, device=dev)
    kj, kj2, _, _ = prng.split(prng.PRNGKey(prng_key_seed), 4)
    jx = (lin % w).float() + prng.uniform(kj, (n,), device=dev)
    jy = (lin // w).float() + prng.uniform(kj2, (n,), device=dev)
    frame = begin_frame(tp.camera, w / h)
    return tuple(x.contiguous() for x in screen_rays(tp.camera, frame, float(w), float(h), jx, jy, 0.0))


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


def compare_grads(label, got, want, enforce=True, min_nonzero=None):
    """Every leaf's gradient from the kernel path against the plain path's:
    every gradient finite, each leaf zero on both paths or on neither, most
    leaves nonzero (at least ``min_nonzero`` when given: a scene without
    textures leaves their leaves at zero), and (``enforce``) each nonzero
    leaf at the GRAD_RTOL rule (CAMERA_RTOL for the camera leaves).  Logs
    every nonzero leaf's |a - b| / max|b| and returns the largest."""
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
    if (2 * len(nonzero) <= len(want)) if min_nonzero is None else (len(nonzero) < min_nonzero):
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
    kernels += mc_phases(argv, card, dev, kernel_ms)
    kernels += gi_phases(argv, card, dev)
    kernels += feature_phases(argv, card, dev, kernel_ms)
    kernels += dist_phases(argv, card, dev, kernel_ms)
    kernels += app_phases(argv, card, dev, kernel_ms)
    kernels += skybox_phases(argv, card, dev)
    bench_phases(argv, card, dev)
    kernels += engine_phases(argv, card, dev)
    kernels += bounce_phases(argv, card, dev)
    kernels += combine_phases(argv, card, dev)
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


REPAINT = b"\x1b[H"  # TerminalViewer.blit homes the cursor once per repaint


def drive_interactive(args, keys, cwd, cols=40, rows=12, timeout=600, settle=1.0):
    """``python -m chess2rt_tpu_torch --interactive *args`` in a fresh
    process on a pseudo-terminal of ``cols`` x ``rows`` with ``cwd`` as its
    working directory.  ``keys`` is a list of (after, key): ``key`` is typed
    once the terminal has seen ``after`` repaints (an int), or ``settle``
    seconds after it has seen the text ``after`` (bytes): the viewer prints
    its key help, then switches the terminal to cbreak mode, which drops
    whatever was typed before.  One key at a time: the viewer reads its
    keys through Python's buffered stdin after a select on the descriptor,
    so a second key sent with the first waits for a third.  Returns
    {"rc", "output", "first_blit_s", "wall_s", "repaints"}; on the timeout
    the process group is killed and it raises."""
    import fcntl
    import pty
    import select
    import signal
    import struct
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", rows, cols, 0, 0))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "chess2rt_tpu_torch", "--interactive", *args], cwd=cwd,
                            stdin=slave, stdout=slave, stderr=slave, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")))
    os.close(slave)
    out, scanned, repaints, first, pending = bytearray(), 0, 0, None, list(keys)
    seen, searched = None, 0  # when the awaited text showed, and how far the output was searched for it
    try:
        while True:
            now = time.perf_counter()
            if now - t0 > timeout:
                raise AssertionError(f"--interactive did not finish in {timeout} s:\n{bytes(out[-2000:])!r}")
            while pending:
                after = pending[0][0]
                if isinstance(after, int):
                    if repaints < after:
                        break
                else:
                    if seen is None and out.find(after, max(0, searched - len(after) + 1)) >= 0:
                        seen = now
                    searched = len(out)
                    if seen is None or now - seen < settle:
                        break
                    seen = None
                os.write(master, pending.pop(0)[1])
            ready, _, _ = select.select([master], [], [], 0.1)
            if not ready:
                if proc.poll() is not None:
                    break
                continue
            try:
                chunk = os.read(master, 1 << 16)
            except OSError:  # the child closed the terminal
                break
            if not chunk:
                break
            out += chunk
            # a repaint split across two reads is counted once, when complete
            repaints += out.count(REPAINT, max(0, scanned - len(REPAINT) + 1))
            scanned = len(out)
            if first is None and repaints:
                first = time.perf_counter() - t0
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except BaseException:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        raise
    finally:
        os.close(master)
    return {"rc": rc, "output": bytes(out).decode("utf-8", "replace"), "first_blit_s": first,
            "wall_s": time.perf_counter() - t0, "repaints": repaints}


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


def bits(t):
    """A float tensor's bits as integers (bit-equality, NaNs included)."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def mc_phases(argv, card, dev, phase5_frame_ms):
    """Phases 19-22: the threefry draw, the DoF, stereo, adaptive DoF and
    chunked DoF frames.  Returns the kernels-line entries of the draw and of
    K1's ray-input form at the DoF frame's width."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
    from chess2rt_tpu_torch.render.pipeline import aa_detect, render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    def zero_counts():
        R.launches = R.resid_launches = R.ray_launches = R.lin_launches = 0
        F.bounce_rounds = 0
        prng.launches = 0

    def plain_renderer(static, w, h):
        return F.build_flagship_renderer(static, w, h, trace=R.round0_reference, uniform=prng.uniform_reference)

    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(20)

    # ---- 19. the threefry draw --------------------------------------------------------------
    n = MC_LANES
    log(f"phase 19 threefry draw: {n} lanes, kernel against plain on the card and against plain on the CPU")
    draw = {}
    for dt in (torch.float32, torch.float64):
        k = prng.fold_in(prng.PRNGKey(19), dt == torch.float64)
        zero_counts()
        out = prng.uniform(k, (n,), dt, device=dev)
        torch.cuda.synchronize()
        if prng.launches != 1:
            raise AssertionError(f"the draw launched the kernel {prng.launches} times")
        plain = prng.uniform_reference(k, (n,), dt, device=dev)
        cpu = prng.uniform_reference(k, (n,), dt, device="cpu")
        card_vs_plain = int((bits(out) != bits(plain)).sum())
        draw_err = (out.double() - plain.double()).abs().max().item()
        plain_vs_cpu = int((bits(plain).cpu() != bits(cpu)).sum())
        lo, hi = out.min().item(), out.max().item()
        ms, _ = time_events(lambda i: prng.uniform(k, (n,), dt, device=dev), 20, 3)
        q_ms = queued_ms(lambda: prng.uniform(k, (n,), dt, device=dev), 20, busy)
        plain_ms, _ = time_events(lambda i: prng.uniform_reference(k, (n,), dt, device=dev), 5, 1)
        rand_ms, _ = time_events(lambda i: torch.rand(n, dtype=dt, device=dev), 20, 3)
        name = str(dt).split(".")[-1]
        log(f"  {name}: kernel vs plain on the card {card_vs_plain} differing values, plain on the card vs plain "
            f"on the CPU {plain_vs_cpu}; range [{lo:.3e}, {hi:.6f}); kernel {ms:.4f} ms per call, {q_ms:.4f} ms "
            f"queued; plain {plain_ms:.3f} ms; torch.rand (Philox, another stream: no yardstick of the same "
            f"function) {rand_ms:.4f} ms")
        if card_vs_plain or plain_vs_cpu or not (0.0 <= lo and hi < 1.0):
            raise AssertionError(f"threefry {name}: {card_vs_plain} values differ from the plain draw, "
                                 f"{plain_vs_cpu} between the card and the CPU, range [{lo}, {hi}]")
        draw[name] = (ms, q_ms, plain_ms, draw_err, *bound(n * out.element_size(), n * OPS_THREEFRY),
                      1e3 * n * OPS_THREEFRY / PEAK_INT32)
    del out, plain, cpu

    # ---- 20. the DoF frame --------------------------------------------------------------------
    w, h = GRAD_SIZE
    tp, ts = pack_scene(flagship_standin(T, w, h, dof=True, samples=MC_SMALL_SAMPLES), device=dev)
    log(f"phase 20 DoF stand-in (focal plane {tp.camera.focal_plane_dist.item()}, disc radius "
        f"{tp.camera.disc_multiplier.item()}): {w}x{h} AA5 {MC_SMALL_SAMPLES} samples, kernel path vs plain path")
    zero_counts()
    img = render_frame(tp, ts, key)
    torch.cuda.synchronize()
    draws, rays, rounds = prng.launches, R.ray_launches, F.bounce_rounds
    taps = 5 * MC_SMALL_SAMPLES
    log(f"  K1 launches {R.launches} (ray-input {rays}, bounce rounds {rounds}), draws {draws}")
    if draws != 4 * taps or rays != R.launches or rays != taps + rounds or R.resid_launches:
        raise AssertionError(f"the {w}x{h} DoF frame: {draws} draws, K1 {R.launches} launches ({rays} ray-input, "
                             f"{rounds} bounce rounds) for {taps} taps")
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"DoF frame {tuple(img.shape)} is not a finite {h}x{w}x3 image")
    zero_counts()
    plain = plain_renderer(ts, w, h)(tp, key)
    torch.cuda.synchronize()
    if R.launches or prng.launches:
        raise AssertionError(f"the plain DoF path launched K1 {R.launches} times and the draw {prng.launches}")
    dof_small_err = compare_frames(f"DoF {w}x{h} kernel frame vs plain frame", img, plain)
    del img, plain

    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, dof=True, samples=MC_SAMPLES), device=dev)
    log(f"  DoF {WIDTH}x{HEIGHT} AA5, {MC_SAMPLES} samples")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    img = render_frame(tp, ts, key)
    torch.cuda.synchronize()
    dof_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    dof_draws, dof_rays, dof_rounds = prng.launches, R.ray_launches, F.bounce_rounds
    taps = 5 * MC_SAMPLES
    log(f"  K1 launches {R.launches} (ray-input {dof_rays}, bounce rounds {dof_rounds}), draws {dof_draws}, "
        f"peak device memory above the scene {dof_peak:.3f} GiB")
    if dof_draws != 4 * taps or dof_rays != R.launches or dof_rays != taps + dof_rounds:
        raise AssertionError(f"the 1080p DoF frame: {dof_draws} draws, K1 {R.launches} launches")
    if not bool(torch.isfinite(img).all()) or (img.amax(-1) > 0).double().mean().item() <= 0.5:
        raise AssertionError("the 1080p DoF frame is not finite or mostly black")
    dof_ms, dof_all = time_events(lambda i: render_frame(jittered(tp, i), ts, prng.fold_in(key, i)), 3, 1)
    def frame_draws(i):
        for j in range(dof_draws):
            prng.uniform(prng.fold_in(key, j), (MC_LANES,), device=dev)

    draws_ms, _ = time_events(frame_draws, 1, 1)
    MEASURED["dof_ms"] = dof_ms
    log(f"  DoF frame {dof_ms:.3f} ms {['%.3f' % t for t in dof_all]} (the deterministic frame, phase 5: "
        f"{phase5_frame_ms:.3f} ms; {dof_ms / phase5_frame_ms:.1f}x) on {card}; its {dof_draws} draws alone "
        f"{draws_ms:.3f} ms, {draws_ms / dof_ms:.1%} of the frame")
    # K1's ray-input form on the frame's first DoF rays (what every MC pass launches)
    frame = begin_frame(tp.camera, WIDTH / HEIGHT)
    lin = torch.arange(MC_LANES, device=dev)
    k1, k2 = prng.split(prng.PRNGKey(21))
    uv = (prng.uniform(k1, (MC_LANES,), device=dev), prng.uniform(k2, (MC_LANES,), device=dev))
    o3, d3 = screen_rays(tp.camera, frame, float(WIDTH), float(HEIGHT), (lin % WIDTH).float() + 0.5,
                         (lin // WIDTH).float() + 0.5, 0.0, dof=True, disc_uv=uv)
    o3, d3 = o3.contiguous(), d3.contiguous()
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    mc_err = compare_round0(f"ray-input on {MC_LANES} DoF rays", R.round0(lay, prm0, o3, d3),
                            R.round0_reference(lay, prm0, o3, d3), lay.names)
    mc_bound = k1_bound(lay, MC_LANES, lit_shares(R.round0(lay, prm0, o3, d3, want_vis=True), ts.n_lights),
                        ray_input=True)
    mc_ms, _ = time_events(lambda i: R.round0(lay, prm0, o3, d3), 20, 3)
    mc_q = queued_ms(lambda: R.round0(lay, prm0, o3, d3), 20, busy)
    mc_plain_ms, _ = time_events(lambda i: R.round0_reference(lay, prm0, o3, d3), 3, 1)
    log(f"  K1 ray-input on {MC_LANES} DoF rays: {mc_ms:.4f} ms per call, {mc_q:.4f} ms queued, plain "
        f"{mc_plain_ms:.3f} ms, bound {mc_bound[0]:.4f} ms ({mc_bound[1]})")
    if "--profile" in argv:
        profile_run("DoF frame", lambda: render_frame(jittered(tp, 95), ts, key))
    del img, o3, d3, uv, lin

    # ---- 21. the stereo frame -------------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, stereo=True), device=dev)
    log(f"phase 21 stereo stand-in {WIDTH}x{HEIGHT} AA5 (eye separation {tp.camera.stereo_separation.item()})")
    zero_counts()
    img = render_frame(tp, ts, key)
    torch.cuda.synchronize()
    st_launches, st_rays, st_rounds = R.launches, R.ray_launches, F.bounce_rounds
    log(f"  K1 launches {st_launches} (ray-input {st_rays}, bounce rounds {st_rounds}), draws {prng.launches}")
    if st_rays != st_launches or st_rays != 10 + st_rounds or prng.launches:
        raise AssertionError(f"the stereo frame: K1 {st_launches} launches ({st_rays} ray-input) for 10 eye taps "
                             f"and {st_rounds} bounce rounds, {prng.launches} draws")
    stereo_err = compare_frames("stereo kernel frame vs plain frame", img, plain_renderer(ts, WIDTH, HEIGHT)(tp, key))
    stereo_ms, stereo_all = time_events(lambda i: render_frame(jittered(tp, i), ts, key), 3, 1)
    log(f"  stereo frame {stereo_ms:.3f} ms {['%.3f' % t for t in stereo_all]} on {card}")
    del img

    # ---- 22. the adaptive and the chunked DoF frames --------------------------------------------
    sc = flagship_standin(T, WIDTH, HEIGHT, dof=True, samples=MC_ADAPTIVE_SAMPLES)
    sc.settings.adaptiveAA = True
    tp, ts = pack_scene(sc, device=dev)
    base = render_frame(tp, dataclasses.replace(ts, aa_enabled=False), key)
    flagged = int(aa_detect(base).sum())
    cap = F._aa_capacity(flagged)
    log(f"phase 22 adaptive DoF {WIDTH}x{HEIGHT}, {MC_ADAPTIVE_SAMPLES} samples: {flagged} pixels flagged "
        f"({flagged / MC_LANES:.2%}); the default capacity {F._aa_capacity(-(-MC_LANES // 32))} lanes")
    adaptive = {}
    for label, capacity in (("compact", cap), ("full width", 1024)):
        tsa = dataclasses.replace(ts, aa_capacity=capacity)
        zero_counts()
        out = render_frame(tp, tsa, key)
        torch.cuda.synchronize()
        launches, rays, rounds, draws = R.launches, R.ray_launches, F.bounce_rounds, prng.launches
        ms, all_ms = time_events(lambda i: render_frame(jittered(tp, i), tsa, key), 2, 0)
        adaptive[label] = (out, ms)
        log(f"  {label} (aa_capacity {capacity}): K1 launches {launches} (ray-input {rays}, bounce rounds "
            f"{rounds}), draws {draws}, {ms:.3f} ms {['%.3f' % t for t in all_ms]}")
    adaptive_err = compare_frames("adaptive DoF: compact taps vs full-width taps", adaptive["compact"][0],
                                  adaptive["full width"][0])
    base_ms = adaptive["full width"][1]
    sc = flagship_standin(T, WIDTH, HEIGHT, dof=True, samples=MC_ADAPTIVE_SAMPLES)
    tp, ts = pack_scene(sc, device=dev)
    whole = render_frame(tp, ts, key)
    tsc = dataclasses.replace(ts, chunk_pixels=CHUNK_PIXELS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    chunked = render_frame(tp, tsc, key)
    torch.cuda.synchronize()
    chunk_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    chunk_err = compare_frames(f"chunked DoF (chunk_pixels {CHUNK_PIXELS}) vs un-chunked", chunked, whole)
    chunk_ms, chunk_all = time_events(lambda i: render_frame(jittered(tp, i), tsc, key), 2, 0)
    log(f"  chunked DoF frame {chunk_ms:.3f} ms {['%.3f' % t for t in chunk_all]}, peak {chunk_peak:.3f} GiB")
    del whole, chunked, adaptive, base

    log(json.dumps({
        "draw_ms": {k: v[:3] for k, v in draw.items()}, "draw_bound_ms": {k: v[4] for k, v in draw.items()},
        "draw_int32_ops_ms": {k: v[8] for k, v in draw.items()},
        "dof_small_max_abs_err": dof_small_err,
        "dof_frame_ms": dof_ms, "dof_frame_all_ms": dof_all, "dof_draws": dof_draws, "dof_k1_launches": dof_rays,
        "dof_bounce_rounds": dof_rounds, "dof_peak_gib": dof_peak, "dof_draws_ms": draws_ms,
        "stereo_frame_ms": stereo_ms, "stereo_max_abs_err": stereo_err, "stereo_k1_launches": st_launches,
        "adaptive_dof_flagged": flagged, "adaptive_dof_capacity": cap, "adaptive_dof_max_abs_err": adaptive_err,
        "adaptive_dof_full_ms": base_ms, "chunked_dof_ms": chunk_ms, "chunked_dof_max_abs_err": chunk_err,
        "chunked_dof_peak_gib": chunk_peak,
    }))
    f32 = draw["float32"]
    return [
        {**kernel_entry("threefry uniform draw, f32 (2,073,600 lanes; no TPU kernel: XLA's threefry2x32)",
                        "chess2rt_tpu_torch/csrc/threefry.cu", "none: XLA's threefry2x32 (jax.random.uniform)",
                        dof_draws, f32[3], f32[0], f32[2], *f32[4:8]), "queued_ms": f32[1],
         "bound_int32_ops_ms": f32[8]},
        {**kernel_entry(f"round0 ray-input form (K1, one DoF pass of {MC_LANES} rays)", K1_SOURCE, K1_REPLACES,
                        dof_rays, mc_err, mc_ms, mc_plain_ms, *mc_bound), "queued_ms": mc_q},
    ]



def gi_phases(argv, card, dev):
    """Phases 23-25: K1's want_hit form, the GI frame and the GI gradient
    step.  Returns the kernels-line entry of K1's want_hit ray-input form."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render.pipeline import hemisphere_bounce, render_frame, render_frame_wavefront
    from chess2rt_tpu_torch.scenes import gi_standin

    w, h = GI_SIZE
    n = w * h
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(23)

    def zero_counts():
        R.launches = R.resid_launches = R.hit_launches = R.ray_launches = R.lin_launches = 0
        prng.launches = gi.bounce_rounds = gi.bounce_kernels = gi.glue_bounces = K2.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {"k1": R.launches, "k1_hit": R.hit_launches, "k1_resid": R.resid_launches, "k1_ray": R.ray_launches,
                "draws": prng.launches, "bounce_rounds": gi.bounce_rounds, "bounce_kernels": gi.bounce_kernels,
                "glue_bounces": gi.glue_bounces, "k2": K2.launches}

    def gi_scene(paths, **knobs):
        tp, ts = pack_scene(gi_standin(T, w, h, paths=paths), device=dev)
        return tp, dataclasses.replace(ts, gi_point_light_direct=True, **knobs)

    def check_frame_counts(label, c, ts, passes, step=False):
        """One K1 launch per bounce round, the want_hit form alone (with the
        vis rows under a gradient), at most maxTraceDepth + 1 rounds per
        pass, each finished by the bounce kernel (a frame) or the glue (a
        step); two draws per path pass and per glue round (the kernel draws
        inline); a step's backward runs K2 once per bounce round (each
        gathers the box's texels)."""
        rounds = c["bounce_rounds"]
        form = c["k1_resid"] if step else c["k1_hit"]
        glue = rounds if step else 0
        ok = (c["k1"] == c["k1_ray"] == form == rounds and passes <= rounds <= passes * (ts.max_trace_depth + 1)
              and c["glue_bounces"] == glue and c["bounce_kernels"] == rounds - glue
              and c["draws"] == 2 * passes + 2 * glue and c["k2"] == (rounds if step else 0))
        log(f"  {label}: K1 launches {c['k1']} (want_hit alone {c['k1_hit']}, residual {c['k1_resid']}, "
            f"ray-input {c['k1_ray']}), bounce rounds {rounds} (bounce kernel {c['bounce_kernels']}, glue "
            f"{c['glue_bounces']}), draws {c['draws']}, K2 {c['k2']}")
        if not ok:
            raise AssertionError(f"{label}: launch counts {c} for {passes} path passes")

    def plain_gi(ts):
        return gi.build_gi_renderer(ts, w, h, trace=R.round0_reference, uniform=prng.uniform_reference)

    # ---- 23. K1's want_hit form --------------------------------------------------------------
    tp, ts = gi_scene(GI_PATHS)
    lay = R.layout(ts, w, h, want_hit=True)
    log(f"phase 23 K1 want_hit form without the vis rows (GI's) vs plain at {w}x{h} on the GI stand-in "
        f"(list capacity {int(lay.program[R.H_LIST_CAP])}, {R.list_placement(lay.program, lay.n_prm)} lists)")
    prm = lay.pack(tp)
    cam_o, cam_d = gi_camera_rays(tp, w, h, 23)
    _, _, ku, kv = prng.split(key, 4)
    out_k, out_p = R.round0(lay, prm, cam_o, cam_d), R.round0_reference(lay, prm, cam_o, cam_d)
    hit_err = compare_round0(f"{n} jittered camera rays", out_k, out_p, lay.names)
    # one bounce: the plain rows' hit points and faceforward normals, a hemisphere sample each
    hitmask = out_p["win"] >= 0
    N = S.faceforward(cam_d, torch.stack([out_p["nx"], out_p["ny"], out_p["nz"]], -1))
    diffuse = torch.stack([out_p["dr"], out_p["dg"], out_p["db"]], -1)
    wdir, _ = hemisphere_bounce(torch.ones_like(diffuse), N, diffuse, prng.uniform(ku, (n,), device=dev),
                                prng.uniform(kv, (n,), device=dev))
    p = cam_o + cam_d * torch.where(hitmask, out_p["t"], 0.0)[:, None]
    b_o = torch.where(hitmask[:, None], p + N * 1e-3, cam_o).contiguous()
    b_d = torch.where(hitmask[:, None], wdir, cam_d).contiguous()
    b_k, b_p = R.round0(lay, prm, b_o, b_d), R.round0_reference(lay, prm, b_o, b_d)
    hit_err = max(hit_err, compare_round0(f"{n} hemisphere bounce rays", b_k, b_p, lay.names))
    for label, o in (("camera rays", out_k), ("bounce rays", b_k)):
        if bool(torch.stack([o["lr"], o["lg"], o["lb"]])[:, o["win"] < 0].any()):
            raise AssertionError(f"K1's want_hit form wrote light sums on missed lanes of the {label}")
    # the bound of this run's data: the lanes that shade (every hit: all Lambert) scan the light
    vis = R.round0(lay, prm, cam_o, cam_d, want_vis=True)
    shaded = (vis["win"] >= 0).float()
    lit = [(vis[f"vis{li}"] * shaded).mean().item() for li in range(ts.n_lights)]
    hit_bound = k1_bound(lay, n, lit, ray_input=True, scanned=shaded.mean().item())
    hit_ms, _ = time_events(lambda i: R.round0(lay, prm, cam_o, cam_d), 20, 3)
    hit_q = queued_ms(lambda: R.round0(lay, prm, cam_o, cam_d), 20, busy)
    hit_plain_ms, _ = time_events(lambda i: R.round0_reference(lay, prm, cam_o, cam_d), 3, 1)
    log(f"  K1 want_hit ray-input on {n} camera rays: {hit_ms:.4f} ms per call, {hit_q:.4f} ms queued, plain "
        f"{hit_plain_ms:.3f} ms; bound {hit_bound[0]:.4f} ms ({hit_bound[1]}; bytes {hit_bound[2]:.4f}, operations "
        f"{hit_bound[3]:.4f}); lanes that shade {shaded.mean().item():.4f}, lit {['%.4f' % x for x in lit]}")
    del out_k, out_p, b_k, b_p, vis

    # ---- 24. the GI frame ------------------------------------------------------------------------
    tp, ts = gi_scene(GI_SMALL_PATHS)
    log(f"phase 24 GI stand-in {w}x{h}, maxTraceDepth {ts.max_trace_depth}, NEE, AA off: kernel path vs plain "
        f"path and vs the twin at {GI_SMALL_PATHS} paths")
    zero_counts()
    img = render_frame(tp, ts, key)
    check_frame_counts(f"{GI_SMALL_PATHS}-path frame", counts(), ts, GI_SMALL_PATHS)
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"GI frame {tuple(img.shape)} is not a finite {h}x{w}x3 image")
    lit_px = (img.amax(-1) > 0).double().mean().item()
    log(f"  lit pixels {lit_px:.4f}, mean {img.mean().item():.6f}")
    if lit_px <= 0.5:
        raise AssertionError(f"only {lit_px:.2%} of the GI frame's pixels are lit")
    zero_counts()
    plain = plain_gi(ts)(tp, key)
    if any(v for k, v in counts().items() if k not in ("bounce_rounds", "glue_bounces")):
        raise AssertionError("the plain GI path launched a kernel")
    gi_err = compare_frames(f"GI {GI_SMALL_PATHS} paths kernel frame vs plain frame", img, plain)
    twin_err = compare_frames(f"GI {GI_SMALL_PATHS} paths kernel frame vs the twin", img,
                              render_frame_wavefront(tp, ts, key))
    del plain

    tp, ts = gi_scene(GI_PATHS)
    log(f"  GI {w}x{h}, {GI_PATHS} paths per pixel")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    img = render_frame(tp, ts, key)
    frame_counts = counts()
    gi_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    check_frame_counts(f"{GI_PATHS}-path frame", frame_counts, ts, GI_PATHS)
    if not bool(torch.isfinite(img).all()) or (img.amax(-1) > 0).double().mean().item() <= 0.5:
        raise AssertionError("the 40-path GI frame is not finite or mostly black")
    gi_ms, gi_all = time_events(lambda i: render_frame(jittered(tp, i), ts, prng.fold_in(key, i)), 3, 1)
    MEASURED["gi_ms"] = gi_ms
    log(f"  GI frame {gi_ms:.3f} ms {['%.3f' % t for t in gi_all]} on {card}; peak device memory above the scene "
        f"{gi_peak:.3f} GiB; {frame_counts['bounce_rounds']} bounce rounds, each a host read of the alive mask")
    if "--profile" in argv:
        profile_run("GI frame", lambda: render_frame(jittered(tp, 94), ts, key))
    del img

    variants = {}
    for label, knobs in (("chunked", {"chunk_pixels": GI_CHUNK}), ("adaptive", {"aa_enabled": True, "aa_adaptive": True})):
        tpv, tsv = gi_scene(GI_SMALL_PATHS, **knobs)
        passes = GI_SMALL_PATHS * (-(-n // GI_CHUNK) if label == "chunked" else 5)
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = render_frame(tpv, tsv, key)
        c = counts()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        check_frame_counts(f"{label} GI frame", c, tsv, passes)
        err = compare_frames(f"{label} GI frame ({GI_SMALL_PATHS} paths) fused vs the twin", out,
                             render_frame_wavefront(tpv, tsv, key))
        variants[label] = {"max_abs_err": err, "ms": ms, "peak_gib": peak}
        log(f"  {label}: {ms:.3f} ms on the host clock (one run), peak {peak:.3f} GiB")
        del out

    # ---- 25. the GI gradient step -------------------------------------------------------------------
    tp, ts = gi_scene(GI_SMALL_PATHS)
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    log(f"phase 25 GI gradient step {w}x{h}, {GI_SMALL_PATHS} paths, every leaf: kernel path vs plain path")
    zero_counts()
    loss_k, grads_k, img_k = grad_step(lambda p: render_frame(p, ts, key), tp, target)
    check_frame_counts(f"{GI_SMALL_PATHS}-path step", counts(), ts, GI_SMALL_PATHS, step=True)
    with plain_texel_vjp():
        loss_p, grads_p, img_p = grad_step(lambda p: plain_gi(ts)(p, key), tp, target)
    log(f"  loss kernel path {loss_k.item():.9g}, plain path {loss_p.item():.9g}")
    if not abs(loss_k.item() - loss_p.item()) <= LOSS_RTOL * abs(loss_p.item()):
        raise AssertionError(f"the two GI paths' losses differ by more than {LOSS_RTOL} of the loss")
    compare_grads("GI whole frame", grads_k, grads_p, enforce=False)
    agree = ((img_k - img_p).abs().amax(-1) <= GRAD_AGREE)[..., None].float()
    log(f"  pixels whose frames differ by more than {GRAD_AGREE}: {1 - agree.mean().item():.3e}")
    _, grads_k, _ = grad_step(lambda p: render_frame(p, ts, key), tp, target, agree)
    with plain_texel_vjp():
        _, grads_p, _ = grad_step(lambda p: plain_gi(ts)(p, key), tp, target, agree)
    gi_grad_err = compare_grads("GI agreeing pixels", grads_k, grads_p)
    del grads_k, grads_p, img_k, img_p, agree
    if "--profile" in argv:  # at 4 paths: the profiler's own work grows with the ~10^5 kernels per path
        profile_run(f"GI step, {GI_SMALL_PATHS} paths", lambda: grad_step(lambda p: render_frame(p, ts, key),
                                                                            jittered(tp, 93), target))

    tp, ts = gi_scene(GI_PATHS)
    steps = {}
    for remat in (False, True):
        st = dataclasses.replace(ts, gi_remat_paths=remat)
        label = f"{GI_PATHS}-path step, gi_remat_paths {'on' if remat else 'off'}"
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            grad_step(lambda p: render_frame(p, st, key), tp, target)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            log(f"  {label}: out of device memory ({str(e).splitlines()[0][:160]})")
            steps[label] = {"oom": True, "peak_gib": (torch.cuda.max_memory_allocated() - base_mem) / 2**30}
            torch.cuda.empty_cache()
            continue
        warm_s = time.perf_counter() - t0
        c = counts()
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        if c["k1_resid"] != c["k1"] or c["bounce_rounds"] < GI_PATHS * (2 if remat else 1) or not c["k2"]:
            raise AssertionError(f"{label}: launch counts {c}")
        reps = 3 if warm_s < GI_LONG_STEP_S else 1
        ms, all_ms = time_events(lambda i: grad_step(lambda p: render_frame(p, st, prng.fold_in(key, i)),
                                                     jittered(tp, i), target), reps, 0)
        steps[label] = {"ms": ms, "all_ms": all_ms, "warm_s": warm_s, "peak_gib": peak, "counts": c}
        log(f"  {label}: {ms:.3f} ms (median of {reps} after 1 warm-up of {warm_s:.1f} s) {['%.3f' % t for t in all_ms]} "
            f"on {card}; peak device memory above the scene {peak:.3f} GiB; K1 {c['k1']} (residual form), "
            f"K2 {c['k2']}, draws {c['draws']}, bounce rounds {c['bounce_rounds']}")
        torch.cuda.empty_cache()
    if all(v.get("oom") for v in steps.values()):
        raise AssertionError("no 40-path GI step fit in device memory")

    log(json.dumps({
        "gi_hit_max_abs_err": hit_err, "gi_small_max_abs_err": gi_err, "gi_twin_max_abs_err": twin_err,
        "gi_frame_ms": gi_ms, "gi_frame_all_ms": gi_all, "gi_frame_peak_gib": gi_peak, "gi_frame_counts": frame_counts,
        "gi_variants": variants, "gi_grad_max_rel_err": gi_grad_err, "gi_steps": steps,
    }))
    return [{**kernel_entry(f"round0 want_hit ray-input form (K1 without the vis rows, one GI bounce of {n} rays)",
                            K1_SOURCE, K1_REPLACES, frame_counts["k1_hit"], hit_err, hit_ms, hit_plain_ms,
                            *hit_bound), "queued_ms": hit_q}]


def feature_phases(argv, card, dev, phase5_frame_ms):
    """Phases 26-30: bump maps (the hybrid round 0 over K1's residual form),
    the environment cubemap (the merged gather, K2 on the merged table, GI's
    miss term) and the compensated ray-gen.  Returns the kernels-line
    entries of K1's residual form on a 1080p bump tap and of K2 on the
    merged table."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import bump_round0 as B
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
    from chess2rt_tpu_torch.render import pipeline as P
    from chess2rt_tpu_torch.scenes import bump_scene, flagship_standin, gi_standin

    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    gw, gh = GRAD_SIZE

    def zero_counts():
        R.launches = R.resid_launches = R.hit_launches = R.ray_launches = R.lin_launches = 0
        B.calls = F.bounce_rounds = gi.bounce_rounds = P.wavefront_frames = K2.launches = prng.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {"k1": R.launches, "k1_resid": R.resid_launches, "k1_hit": R.hit_launches, "k1_ray": R.ray_launches,
                "bump_calls": B.calls, "bounce_rounds": F.bounce_rounds, "gi_rounds": gi.bounce_rounds,
                "twin_frames": P.wavefront_frames, "k2": K2.launches, "draws": prng.launches}

    def check_whitted_counts(label, c, taps, bump, step=False, mirror=True):
        """Every round-0 call on the fused path (one per tap and bounce
        round, at least one bounce round per tap with a mirror), none in the
        twin; a bump scene's calls all in the hybrid on K1's residual form,
        another scene's in the plain form unless it is a gradient step."""
        rounds = c["bounce_rounds"]
        resid = c["k1"] if (bump or step) else 0
        ok = (c["k1"] == taps + rounds and c["k1_ray"] == rounds and c["k1_resid"] == resid
              and c["bump_calls"] == (c["k1"] if bump else 0) and c["twin_frames"] == 0
              and (rounds >= taps if mirror else rounds == 0))
        log(f"  {label}: K1 launches {c['k1']} (residual form {c['k1_resid']}, ray-input {c['k1_ray']}), "
            f"bump-hybrid calls {c['bump_calls']}, bounce rounds {rounds}, twin frames {c['twin_frames']}, K2 {c['k2']}")
        if not ok:
            raise AssertionError(f"{label}: launch counts {c} for {taps} taps")

    def frame_check(label, img, h, w, min_lit=0.5):
        if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: {tuple(img.shape)} is not a finite {h}x{w}x3 image")
        lit = (img.amax(-1) > 0).double().mean().item()
        log(f"  {label}: lit pixels {lit:.4f}, mean {img.mean().item():.6f}")
        if lit <= min_lit:
            raise AssertionError(f"{label}: only {lit:.2%} of pixels are lit")

    def step_compare(label, render, plain_render, gp, target, min_nonzero=None):
        """Phase 8's rule: the losses within LOSS_RTOL, then every leaf at the
        GRAD_RTOL rule over the pixels whose two frames agree."""
        loss_k, grads_k, img_k = grad_step(render, gp, target)
        with plain_texel_vjp():
            loss_p, grads_p, img_p = grad_step(plain_render, gp, target)
        log(f"  {label}: loss kernel path {loss_k.item():.9g}, plain path {loss_p.item():.9g}")
        if not abs(loss_k.item() - loss_p.item()) <= LOSS_RTOL * abs(loss_p.item()):
            raise AssertionError(f"{label}: the two paths' losses differ by more than {LOSS_RTOL} of the loss")
        compare_grads(f"{label} whole frame", grads_k, grads_p, enforce=False, min_nonzero=min_nonzero)
        agree = ((img_k - img_p).abs().amax(-1) <= GRAD_AGREE)[..., None].float()
        log(f"  {label}: pixels whose frames differ by more than {GRAD_AGREE}: {1 - agree.mean().item():.3e}")
        _, grads_k, _ = grad_step(render, gp, target, agree)
        with plain_texel_vjp():
            _, grads_p, _ = grad_step(plain_render, gp, target, agree)
        return compare_grads(f"{label} agreeing pixels", grads_k, grads_p, min_nonzero=min_nonzero), grads_k

    # ---- 26. bump: K1's residual form, the 1080p AA5 frame in both gates -------------------
    w, h = SMALL
    log("phase 26 bump_scene: K1's residual form vs plain (the phase 3 limits), then the AA5 bump frame "
        "(mirror, maxTraceDepth 2) in both gates: kernel vs plain at "
        f"{gw}x{gh}, ms and launch counts at {WIDTH}x{HEIGHT}")
    tp, ts = pack_scene(bump_scene(T, w, h), device=dev)
    lay = R.layout(ts, w, h, want_hit=True, want_vis=True)
    prm = lay.pack(tp, AA)
    orig_t, dir_t = scattered_rays(26, w * h, dev, center=(0.0, 50.0, -40.0), spread=70.0)
    bump_err = compare_round0(f"{w}x{h} screen-tap", R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    bump_err = max(bump_err, compare_round0(f"{w}x{h} ray-input", R.round0(lay, prm, orig_t, dir_t),
                                            R.round0_reference(lay, prm, orig_t, dir_t), lay.names))
    bump = {}
    for bump_csg in (False, True):
        gate = "reshade" if bump_csg else "fast"
        sp, ss = pack_scene(bump_scene(T, gw, gh, bump_csg=bump_csg), device=dev)
        if B._fast_bump_ok(ss) == bump_csg:
            raise AssertionError(f"bump_scene(bump_csg={bump_csg}) does not take the {gate} forward")
        zero_counts()
        img = P.render_frame(sp, ss)
        check_whitted_counts(f"{gate} gate {gw}x{gh} frame", counts(), 5, bump=True)
        err = compare_frames(f"{gate} gate {gw}x{gh} kernel frame vs plain frame", img,
                             F.build_flagship_renderer(ss, gw, gh, trace=R.round0_reference)(sp))
        bp, bs = pack_scene(bump_scene(T, WIDTH, HEIGHT, bump_csg=bump_csg), device=dev)
        if not bump_csg:
            lay = R.layout(bs, WIDTH, HEIGHT, want_hit=True, want_vis=True)
            prm0 = lay.pack(bp)
            tap_k = R.round0(lay, prm0)
            bump_err = max(bump_err, compare_round0(f"{WIDTH}x{HEIGHT} bump tap", tap_k, R.round0_reference(lay, prm0),
                                                    lay.names))
            tap_bound = k1_bound(lay, WIDTH * HEIGHT, lit_shares(tap_k, bs.n_lights))
            tap_ms, _ = time_events(lambda k: R.round0(lay, prm0), 20, 3)
            tap_q = queued_ms(lambda: R.round0(lay, prm0), 20, busy)
            tap_plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm0), 3, 1)
            log(f"  K1 residual form per {WIDTH}x{HEIGHT} bump tap: {tap_ms:.4f} ms per call, {tap_q:.4f} ms queued, "
                f"plain {tap_plain_ms:.3f} ms; bound {tap_bound[0]:.4f} ms ({tap_bound[1]}; bytes "
                f"{tap_bound[2]:.4f}, operations {tap_bound[3]:.4f})")
            del tap_k
        zero_counts()
        img = P.render_frame(bp, bs)
        c = counts()
        check_whitted_counts(f"{gate} gate {WIDTH}x{HEIGHT} frame", c, 5, bump=True)
        # the floor ends at 200 units (limit 200) and nothing lights a miss:
        # about half the frame is lit
        frame_check(f"{gate} gate {WIDTH}x{HEIGHT} frame", img, HEIGHT, WIDTH, min_lit=0.3)
        ms, all_ms = time_events(lambda k: P.render_frame(jittered(bp, k), bs), 3, 1)
        log(f"  {gate} gate {WIDTH}x{HEIGHT} AA5 bump frame {ms:.3f} ms {['%.3f' % t for t in all_ms]} on {card} "
            f"(the flagship frame of phase 5: {phase5_frame_ms:.3f} ms)")
        if "--profile" in argv:
            profile_run(f"bump frame, {gate} gate", lambda: P.render_frame(jittered(bp, 97), bs))
        bump[gate] = {"ms": ms, "all_ms": all_ms, "counts": c, "max_abs_err_small": err}
        del img
    fast_resid = bump["fast"]["counts"]["k1_resid"]

    # ---- 27. the environment frame -----------------------------------------------------------
    ep, es = pack_scene(flagship_standin(T, WIDTH, HEIGHT, env=True), device=dev)
    lay = R.layout(es, WIDTH, HEIGHT)
    miss = (R.round0(lay, lay.pack(ep))["win"] < 0).double().mean().item()
    log(f"phase 27 the stand-in under a 64x64 sky cubemap at {WIDTH}x{HEIGHT}, AA5, maxTraceDepth "
        f"{es.max_trace_depth}: the merged bitmap+cubemap gather in every tap and bounce round; "
        f"pixels that miss every node {miss:.4f} ({int(round(miss * WIDTH * HEIGHT))} of {WIDTH * HEIGHT})")
    if miss < 0.05:
        raise AssertionError(f"only {miss:.2%} of the env frame's pixels miss")
    zero_counts()
    img = P.render_frame(ep, es)
    env_counts = counts()
    check_whitted_counts(f"env {WIDTH}x{HEIGHT} frame", env_counts, 5, bump=False)
    frame_check(f"env {WIDTH}x{HEIGHT} frame", img, HEIGHT, WIDTH, min_lit=0.9)
    env_err = compare_frames("env kernel frame vs plain frame", img,
                             F.build_flagship_renderer(es, WIDTH, HEIGHT, trace=R.round0_reference)(ep))
    env_ms, env_all = time_events(lambda k: P.render_frame(jittered(ep, k), es), 5, 2)
    log(f"  env {WIDTH}x{HEIGHT} AA5 frame {env_ms:.3f} ms {['%.3f' % t for t in env_all]} on {card} "
        f"(the flagship frame of phase 5: {phase5_frame_ms:.3f} ms)")
    MEASURED["env_ms"] = env_ms
    if "--profile" in argv:
        profile_run("env frame", lambda: P.render_frame(jittered(ep, 96), es))
    del img, ep

    # ---- 28. the bump and env gradient steps -------------------------------------------------
    log(f"phase 28 the bump and env gradient steps at {gw}x{gh}, AA off, every leaf: kernel path vs plain path "
        f"(phase 8's rule); K2 on the env step's merged table vs its plain version.  The bump step's scene has no "
        f"mirror, as the JAX package's bump gradient test (tests/test_bump.py:253-278): the mirror's curvature turns "
        f"the two K1 builds' last bits into leaf-sized gradient differences on its pixels (the frames' bounce rounds "
        f"are held in phase 26)")
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)
    steps = {}
    for bump_csg in (False, True):
        gate = "reshade" if bump_csg else "fast"
        gp, gs = pack_scene(bump_scene(T, gw, gh, mirror=False, bump_csg=bump_csg, aa=False), device=dev)
        zero_counts()
        grad_step(lambda p: P.render_frame(p, gs), gp, target)
        c = counts()
        check_whitted_counts(f"bump step, {gate} gate", c, 1, bump=True, step=True, mirror=False)
        plain_render = F.build_flagship_renderer(gs, gw, gh, trace=R.round0_reference)
        # no texture leaves in the bump scene: 19 of the 38 leaves have a gradient
        err, _ = step_compare(f"bump step, {gate} gate", lambda p: P.render_frame(p, gs), plain_render, gp, target,
                              min_nonzero=19)
        ms, all_ms = time_events(lambda k: grad_step(lambda p: P.render_frame(p, gs), jittered(gp, k), target), 3, 1)
        log(f"  bump step, {gate} gate: {ms:.3f} ms {['%.3f' % t for t in all_ms]} on {card}")
        steps[f"bump_{gate}"] = {"ms": ms, "all_ms": all_ms, "max_rel_err": err, "counts": c}

    gp, gs = pack_scene(flagship_standin(T, gw, gh, env=True), device=dev)
    gs = dataclasses.replace(gs, aa_enabled=False)
    seen = step_texel_rows(lambda p: P.render_frame(p, gs), gp, target)
    n_quads = sum(bh * bw for bh, bw in gs.bitmap_sizes) + 6 * gp.env_cubemap.shape[1] ** 2
    keys, vals, n_texels = next(x for x in seen if x[0].numel() == gw * gh)
    env_rows = int((keys >= n_quads - 6 * gp.env_cubemap.shape[1] ** 2).sum())
    log(f"  K2 on the env step tap's merged table: {keys.numel()} rows ({env_rows} of them cubemap texels), "
        f"{vals.shape[1]} channels, {n_texels} texel rows (bitmap quads and cubemap quads)")
    if n_texels != n_quads or vals.shape[1] != 12 or not env_rows:
        raise AssertionError(f"K2's inputs are not the sorted [N, 12] rows of the {n_quads}-row merged table")
    merged_err = 0.0
    for mkeys, mvals, mn in seen:
        m_k, m_p = K2.texel_histogram(mkeys, mvals, mn), K2.texel_histogram_reference(mkeys, mvals, mn)
        m_err, m_scale = (m_k - m_p).abs().max().item(), m_p.abs().max().item()
        log(f"  {mkeys.numel()} rows: max |K2 - plain| {m_err:.3e}, max|plain| {m_scale:.3e}")
        if not bool(torch.isfinite(m_k).all()) or m_err > K2_LIMIT * max(1.0, m_scale):
            raise AssertionError(f"K2 differs from its plain version by {m_err:.3e} on the merged table")
        merged_err = max(merged_err, m_err)
    zero_counts()
    grad_step(lambda p: P.render_frame(p, gs), gp, target)
    env_step_counts = counts()
    check_whitted_counts("env step", env_step_counts, 1, bump=False, step=True)
    if env_step_counts["k2"] != env_step_counts["k1"]:
        raise AssertionError(f"K2 ran {env_step_counts['k2']} times for {env_step_counts['k1']} merged gathers")
    plain_render = F.build_flagship_renderer(gs, gw, gh, trace=R.round0_reference)
    env_grad_err, env_grads = step_compare("env step", lambda p: P.render_frame(p, gs), plain_render, gp, target)
    if not bool(env_grads["env_cubemap"].any()):
        raise AssertionError("the env step gave the cubemap no gradient")
    env_step_ms, env_step_all = time_events(
        lambda k: grad_step(lambda p: P.render_frame(p, gs), jittered(gp, k), target), 3, 1)
    log(f"  env step: {env_step_ms:.3f} ms {['%.3f' % t for t in env_step_all]} on {card}")
    steps["env"] = {"ms": env_step_ms, "all_ms": env_step_all, "max_rel_err": env_grad_err, "counts": env_step_counts}
    m_ms, _ = time_events(lambda k: K2.texel_histogram(keys, vals, n_texels), 20, 3)
    m_q = queued_ms(lambda: K2.texel_histogram(keys, vals, n_texels), 20, busy)
    m_plain_ms, _ = time_events(lambda k: K2.texel_histogram_reference(keys, vals, n_texels), 20, 3)
    lib_keys = keys.long()
    m_lib_ms, _ = time_events(
        lambda k: torch.zeros((n_texels, vals.shape[1]), dtype=vals.dtype, device=dev).index_add_(0, lib_keys, vals),
        20, 3)
    merged_bound = bound(keys.numel() * 4 + vals.numel() * 4 + n_texels * vals.shape[1] * 4, vals.numel())
    log(f"  K2 per {keys.numel()}-row merged histogram: {m_ms:.4f} ms per call, {m_q:.4f} ms queued, plain "
        f"{m_plain_ms:.3f} ms, one index_add_ call {m_lib_ms:.3f} ms; bound {merged_bound[0]:.4f} ms "
        f"({merged_bound[1]})")
    del seen, env_grads

    # ---- 29. GI with the environment ---------------------------------------------------------
    gi_w, gi_h = GI_SIZE
    key = prng.PRNGKey(29)

    def gi_env_scene(paths):
        sp, ss = pack_scene(gi_standin(T, gi_w, gi_h, paths=paths, env=True), device=dev)
        return sp, dataclasses.replace(ss, gi_point_light_direct=True)

    sp, ss = gi_env_scene(GI_SMALL_PATHS)
    log(f"phase 29 the GI stand-in under the sky cubemap at {gi_w}x{gi_h}, NEE: the miss term; kernel path vs "
        f"plain path and vs the twin at {GI_SMALL_PATHS} paths, then {GI_PATHS} paths timed")
    zero_counts()
    img = P.render_frame(sp, ss, key)
    c = counts()
    log(f"  {GI_SMALL_PATHS}-path frame: K1 launches {c['k1']} (want_hit alone {c['k1_hit']}), GI bounce rounds "
        f"{c['gi_rounds']}, draws {c['draws']}, twin frames {c['twin_frames']}")
    if not (c["k1"] == c["k1_hit"] == c["gi_rounds"] >= GI_SMALL_PATHS and c["twin_frames"] == 0):
        raise AssertionError(f"the env GI frame's launch counts {c}")
    frame_check(f"env GI {GI_SMALL_PATHS}-path frame", img, gi_h, gi_w)
    gi_env_err = compare_frames(
        f"env GI {GI_SMALL_PATHS} paths kernel frame vs plain frame", img,
        gi.build_gi_renderer(ss, gi_w, gi_h, trace=R.round0_reference, uniform=prng.uniform_reference)(sp, key))
    compare_frames(f"env GI {GI_SMALL_PATHS} paths kernel frame vs the twin", img,
                   P.render_frame_wavefront(sp, ss, key))
    dark = P.render_frame(sp, dataclasses.replace(ss, has_env=False), key)
    log(f"  the sky's share of the frame's mean: {img.mean().item():.6f} with it, {dark.mean().item():.6f} without")
    sp, ss = gi_env_scene(GI_PATHS)
    gi_env_ms, gi_env_all = time_events(lambda i: P.render_frame(jittered(sp, i), ss, prng.fold_in(key, i)), 3, 1)
    log(f"  env GI frame, {GI_PATHS} paths: {gi_env_ms:.3f} ms {['%.3f' % t for t in gi_env_all]} on {card}")
    if "--profile" in argv:
        profile_run("env GI frame", lambda: P.render_frame(jittered(sp, 95), ss, key))
    del img, dark

    # ---- 30. the compensated frame ----------------------------------------------------------------
    cp, cs = pack_scene(flagship_standin(T, gw, gh), device=dev)
    cs = dataclasses.replace(cs, compensated_raygen=True)
    log(f"phase 30 the compensated (df32) ray-gen: the stand-in at {gw}x{gh}, AA5, through the twin")
    if R.supports(cs):
        raise AssertionError("the fused path claims the compensated ray-gen")
    zero_counts()
    img = P.render_frame(cp, cs)
    c = counts()
    if c["twin_frames"] != 1 or c["k1"]:
        raise AssertionError(f"the compensated frame did not take the twin alone: {c}")
    frame_check("compensated frame", img, gh, gw)
    comp_err = compare_frames("compensated frame vs the plain-ray twin frame", img,
                              P.render_frame_wavefront(cp, dataclasses.replace(cs, compensated_raygen=False)))
    comp_ms, comp_all = time_events(lambda k: P.render_frame(jittered(cp, k), cs), 2, 1)
    lin = torch.arange(gw * gh, device=dev)
    x, y = (lin % gw).float() + 0.3, (lin // gw).float() + 0.6
    d_c = screen_rays(cp.camera, begin_frame(cp.camera, gw / gh, compensated=True), float(gw), float(gh), x, y)[1]
    d_f = screen_rays(cp.camera, begin_frame(cp.camera, gw / gh), float(gw), float(gh), x, y)[1]
    cam64 = dataclasses.replace(cp.camera, **{f.name: getattr(cp.camera, f.name).double()
                                              for f in dataclasses.fields(cp.camera)})
    d_64 = screen_rays(cam64, begin_frame(cam64, gw / gh), float(gw), float(gh), x.double(), y.double())[1]
    err_c, err_f = (d_c.double() - d_64).abs().max().item(), (d_f.double() - d_64).abs().max().item()
    log(f"  compensated frame {comp_ms:.3f} ms {['%.3f' % t for t in comp_all]} on {card}; its rays against float64 "
        f"rays: max |d| {err_c:.3e} (plain f32 rays {err_f:.3e})")
    if err_c > err_f:
        raise AssertionError("the compensated rays are further from float64 than the plain f32 rays")
    del img

    log(json.dumps({
        "bump_frames": bump, "bump_k1_max_abs_err": bump_err, "env_miss_share": miss, "env_frame_ms": env_ms,
        "env_frame_all_ms": env_all, "env_frame_max_abs_err": env_err, "env_frame_counts": env_counts,
        "steps": steps, "k2_merged_max_abs_err": merged_err, "gi_env_max_abs_err": gi_env_err,
        "gi_env_frame_ms": gi_env_ms, "gi_env_frame_all_ms": gi_env_all, "compensated_frame_ms": comp_ms,
        "compensated_max_abs_err": comp_err, "compensated_ray_err": err_c,
    }))
    return [
        {**kernel_entry(f"round0 residual form (K1 with want_hit and want_vis, one {WIDTH}x{HEIGHT} bump_scene tap "
                        "of the bump hybrid)", K1_SOURCE, K1_REPLACES, fast_resid, bump_err, tap_ms, tap_plain_ms,
                        *tap_bound), "queued_ms": tap_q},
        {**kernel_entry(f"texel_hist (K2 on the merged bitmap+cubemap table, {keys.numel()} rows into "
                        f"{n_texels} texel rows)", "chess2rt_tpu_torch/csrc/texel_hist.cu",
                        "chess2rt_tpu/ops/texel_hist.py:41", env_step_counts["k2"], merged_err, m_ms, m_plain_ms,
                        *merged_bound, library_ms=m_lib_ms), "queued_ms": m_q},
    ]


def zero_counts():
    """Every launch counter of the port's kernels, and the path counters, to 0."""
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render import pipeline as P

    R.launches = R.resid_launches = R.hit_launches = R.ray_launches = R.lin_launches = 0
    F.bounce_rounds = gi.bounce_rounds = prng.launches = K2.launches = P.wavefront_frames = 0
    F.compact_overflows = gi.bounce_kernels = gi.glue_bounces = 0


def counts():
    """The counters ``zero_counts`` zeroes, read after a synchronise."""
    import torch
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render import pipeline as P

    torch.cuda.synchronize()
    return {"k1": R.launches, "k1_ray": R.ray_launches, "k1_hit": R.hit_launches, "k1_resid": R.resid_launches,
            "k1_lin": R.lin_launches, "bounce_rounds": F.bounce_rounds, "gi_rounds": gi.bounce_rounds,
            "draws": prng.launches, "k2": K2.launches, "twin_frames": P.wavefront_frames,
            "compact_overflows": F.compact_overflows, "gi_kernels": gi.bounce_kernels, "gi_glue": gi.glue_bounces}


def dist_phases(argv, card, dev, phase5_frame_ms):
    """Phases 31-38: the per-shard sampler over 4 mesh entries of the card
    (DoF, stereo, GI and float64 frames; the DoF and GI steps), the
    node-pinned backward, two processes sharing the card over
    torch.distributed, and the ray counters.  Returns the kernels-line
    entries of K1's ray-input form and the threefry draw at one DoF shard's
    width."""
    import torch
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, leaves, pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import round0_grad as RG
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
    from chess2rt_tpu_torch.oracle.renderer import OracleRenderer
    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn, make_sharded_value_and_grad, mp_dryrun
    from chess2rt_tpu_torch.render import pipeline as P
    from chess2rt_tpu_torch.scenes import flagship_standin, gi_standin
    from chess2rt_tpu_torch.utils.color import srgb_u8
    from chess2rt_tpu_torch.utils.diagnostics import frame_ray_stats

    mesh = make_mesh([dev] * MESH_ENTRIES)
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(31)
    gw, gh = GRAD_SIZE
    out = {}

    @contextlib.contextmanager
    def plain_draws():
        """The threefry draw's plain version wherever the port draws."""
        kernel = prng.uniform
        prng.uniform = prng.uniform_reference
        try:
            yield
        finally:
            prng.uniform = kernel

    def plain_frame(ts, packed, k):
        zero_counts()
        with plain_draws():
            img = make_sharded_render_fn(ts, mesh, trace=R.round0_reference)(packed, k)
        c = counts()
        if c["k1"] or c["draws"] or c["k2"]:
            raise AssertionError(f"the plain sharded path launched a kernel: {c}")
        return img

    def check_whitted(label, c, taps):
        """One ray-input launch per shard pass and bounce round, four draws
        per DoF sample pass (jitter x, y and the disc's two), no other form."""
        log(f"  {label}: K1 launches {c['k1']} (ray-input {c['k1_ray']}, bounce rounds {c['bounce_rounds']}), "
            f"draws {c['draws']}")
        if c["k1"] != c["k1_ray"] or c["k1"] != taps + c["bounce_rounds"] or c["k1_resid"] or c["k1_lin"]:
            raise AssertionError(f"{label}: launch counts {c} for {taps} shard passes")

    def sharded_step(ts, packed, target, trace):
        """(loss, {leaf: gradient}) of the sharded step on ``trace``; the
        plain path draws and sums texels with the plain versions."""
        vg = make_sharded_value_and_grad(ts, mesh, trace=trace)
        if trace is R.round0:
            loss, g = vg(packed, target, key)
        else:
            with plain_draws(), plain_texel_vjp():
                loss, g = vg(packed, target, key)
        return loss, dict(zip(LEAF_NAMES, leaves(g)))

    def step_phase(label, ts, packed, frame_k, frame_p):
        """The sharded step on K1 against the plain path at phase 8's rule:
        the whole frame logged, then held on the pixels whose two frames
        agree (knife-edge pixels carry other leaves' whole gradient): there
        each path's target is its own frame, so their error and gradient
        vanish."""
        target = torch.zeros((ts.height, ts.width, 3), dtype=torch.float32, device=dev)
        zero_counts()
        loss_k, g_k = sharded_step(ts, packed, target, R.round0)
        c = counts()
        loss_p, g_p = sharded_step(ts, packed, target, R.round0_reference)
        log(f"  {label}: loss kernel path {loss_k.item():.9g}, plain path {loss_p.item():.9g}; K1 {c['k1']} "
            f"(residual form {c['k1_resid']}), K2 {c['k2']}, draws {c['draws']}")
        if not c["k1"] or c["k1_resid"] != c["k1"] or not c["k2"]:
            raise AssertionError(f"{label}: launch counts {c}")
        if not abs(loss_k.item() - loss_p.item()) <= LOSS_RTOL * abs(loss_p.item()):
            raise AssertionError(f"{label}: the two paths' losses differ by more than {LOSS_RTOL} of the loss")
        compare_grads(f"{label} whole frame", g_k, g_p, enforce=False)
        agree = ((frame_k - frame_p).abs().amax(-1) <= GRAD_AGREE).float()
        log(f"  pixels whose frames differ by more than {GRAD_AGREE}: {1 - agree.mean().item():.3e}")
        keep = agree[..., None] > 0
        _, g_k = sharded_step(ts, packed, torch.where(keep, target, frame_k), R.round0)
        _, g_p = sharded_step(ts, packed, torch.where(keep, target, frame_p), R.round0_reference)
        err = compare_grads(f"{label} agreeing pixels", g_k, g_p)
        ms, all_ms = time_events(lambda i: sharded_step(ts, jittered(packed, i), target, R.round0), 2, 0)
        log(f"  {label}: {ms:.3f} ms per step {['%.3f' % t for t in all_ms]} on {card}")
        return {"max_rel_err": err, "ms": ms, "counts": c}

    # ---- 31. the sharded DoF frame ------------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, gw, gh, dof=True, samples=MC_SMALL_SAMPLES), device=dev)
    log(f"phase 31 sharded DoF stand-in over {MESH_ENTRIES} entries of the card: {gw}x{gh} AA5 "
        f"{MC_SMALL_SAMPLES} samples, kernel path vs plain path (the per-shard sampler, keys folded per shard)")
    zero_counts()
    img = make_sharded_render_fn(ts, mesh)(tp, key)
    c = counts()
    taps = 5 * MC_SMALL_SAMPLES * MESH_ENTRIES
    check_whitted(f"{gw}x{gh} DoF frame", c, taps)
    if c["draws"] != 4 * taps:
        raise AssertionError(f"the sharded DoF frame drew {c['draws']} times for {taps} shard passes")
    dof_small_frame_k = img
    dof_small_err = compare_frames(f"sharded DoF {gw}x{gh} kernel frame vs plain frame", img,
                                   dof_small_frame_p := plain_frame(ts, tp, key))
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, dof=True, samples=MC_SAMPLES), device=dev)
    fn = make_sharded_render_fn(ts, mesh)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    img = fn(tp, key)
    dof_counts = counts()
    dof_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    taps = 5 * MC_SAMPLES * MESH_ENTRIES
    check_whitted(f"{WIDTH}x{HEIGHT} AA5 {MC_SAMPLES}-sample DoF frame", dof_counts, taps)
    if dof_counts["draws"] != 4 * taps:
        raise AssertionError(f"the 1080p sharded DoF frame drew {dof_counts['draws']} times")
    if not bool(torch.isfinite(img).all()) or (img.amax(-1) > 0).double().mean().item() <= 0.5:
        raise AssertionError("the 1080p sharded DoF frame is not finite or mostly black")
    dof_ms, dof_all = time_events(lambda i: fn(jittered(tp, i), prng.fold_in(key, i)), 3, 1)
    log(f"  sharded DoF {WIDTH}x{HEIGHT} AA5 {MC_SAMPLES} samples: {dof_ms:.3f} ms {['%.3f' % t for t in dof_all]} "
        f"on {card}; the single-device DoF frame (phase 20) {MEASURED.get('dof_ms', float('nan')):.3f} ms; peak "
        f"device memory above the scene {dof_peak:.3f} GiB")
    # K1's ray-input form and the draw at one shard's width: shard 0's first DoF pass
    C = WIDTH * HEIGHT // MESH_ENTRIES
    lin = torch.arange(C, device=dev)
    k1, k2 = prng.split(prng.fold_in(key, 0))
    uv = (prng.uniform(k1, (C,), device=dev), prng.uniform(k2, (C,), device=dev))
    frame = begin_frame(tp.camera, WIDTH / HEIGHT)
    o3, d3 = screen_rays(tp.camera, frame, float(WIDTH), float(HEIGHT), (lin % WIDTH).float() + 0.5,
                         (lin // WIDTH).float() + 0.5, 0.0, dof=True, disc_uv=uv)
    o3, d3 = o3.contiguous(), d3.contiguous()
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    ray_err = compare_round0(f"ray-input on one shard's {C} DoF rays", R.round0(lay, prm0, o3, d3),
                             R.round0_reference(lay, prm0, o3, d3), lay.names)
    ray_bound = k1_bound(lay, C, lit_shares(R.round0(lay, prm0, o3, d3, want_vis=True), ts.n_lights),
                         ray_input=True)
    ray_ms, _ = time_events(lambda i: R.round0(lay, prm0, o3, d3), 20, 3)
    ray_q = queued_ms(lambda: R.round0(lay, prm0, o3, d3), 20, busy)
    ray_plain_ms, _ = time_events(lambda i: R.round0_reference(lay, prm0, o3, d3), 3, 1)
    dk = prng.fold_in(key, 1)
    draw_k, draw_p = prng.uniform(dk, (C,), device=dev), prng.uniform_reference(dk, (C,), device=dev)
    draw_diff = int((bits(draw_k) != bits(draw_p)).sum())
    if draw_diff:
        raise AssertionError(f"the draw at {C} lanes: {draw_diff} values differ from the plain draw")
    draw_ms, _ = time_events(lambda i: prng.uniform(dk, (C,), device=dev), 20, 3)
    draw_q = queued_ms(lambda: prng.uniform(dk, (C,), device=dev), 20, busy)
    draw_plain_ms, _ = time_events(lambda i: prng.uniform_reference(dk, (C,), device=dev), 5, 1)
    draw_bound = bound(C * 4, C * OPS_THREEFRY)
    log(f"  K1 ray-input on {C} rays: {ray_ms:.4f} ms per call, {ray_q:.4f} ms queued, plain {ray_plain_ms:.3f} ms, "
        f"bound {ray_bound[0]:.4f} ms ({ray_bound[1]}); the draw at {C} lanes: {draw_ms:.4f} ms per call, "
        f"{draw_q:.4f} ms queued, plain {draw_plain_ms:.3f} ms, bound {draw_bound[0]:.4f} ms ({draw_bound[1]})")
    out.update(sharded_dof_small_max_abs_err=dof_small_err, sharded_dof_ms=dof_ms, sharded_dof_all_ms=dof_all,
               sharded_dof_counts=dof_counts, sharded_dof_peak_gib=dof_peak)
    del img, o3, d3, uv, lin, fn

    # ---- 32. the sharded stereo frame -------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, stereo=True), device=dev)
    log(f"phase 32 sharded stereo stand-in {WIDTH}x{HEIGHT} AA5 over {MESH_ENTRIES} entries")
    fn = make_sharded_render_fn(ts, mesh)
    zero_counts()
    img = fn(tp, key)
    c = counts()
    check_whitted("stereo frame", c, 10 * MESH_ENTRIES)
    if c["draws"]:
        raise AssertionError(f"the sharded stereo frame drew {c['draws']} times")
    st_err = compare_frames("sharded stereo kernel frame vs plain frame", img, plain_frame(ts, tp, key))
    st_ms, st_all = time_events(lambda i: fn(jittered(tp, i), key), 3, 1)
    log(f"  sharded stereo frame {st_ms:.3f} ms {['%.3f' % t for t in st_all]} on {card}")
    out.update(sharded_stereo_max_abs_err=st_err, sharded_stereo_ms=st_ms, sharded_stereo_counts=c)
    del img, fn

    # ---- 33. the sharded GI frame -------------------------------------------------------------------
    w, h = GI_SIZE

    def gi_scene(paths, **knobs):
        p, s = pack_scene(gi_standin(T, w, h, paths=paths), device=dev)
        return p, dataclasses.replace(s, gi_point_light_direct=True, **knobs)

    def check_gi(label, c, passes, step=False):
        rounds = c["gi_rounds"]
        form = c["k1_resid"] if step else c["k1_hit"]
        log(f"  {label}: K1 launches {c['k1']} (want_hit alone {c['k1_hit']}, residual {c['k1_resid']}), bounce "
            f"rounds {rounds} (bounce kernel {c['gi_kernels']}, glue {c['gi_glue']}), draws {c['draws']}, K2 {c['k2']}")
        glue = rounds if step else 0  # a frame's rounds end in the bounce kernel, which draws inline
        if not (c["k1"] == c["k1_ray"] == form == rounds and c["gi_glue"] == glue
                and c["gi_kernels"] == rounds - glue and c["draws"] == 2 * passes + 2 * glue):
            raise AssertionError(f"{label}: launch counts {c} for {passes} shard path passes")

    tp, ts = gi_scene(GI_SMALL_PATHS)
    log(f"phase 33 sharded GI stand-in {w}x{h} over {MESH_ENTRIES} entries, NEE, AA off: kernel path vs plain "
        f"path at {GI_SMALL_PATHS} paths")
    zero_counts()
    img = make_sharded_render_fn(ts, mesh)(tp, key)
    check_gi(f"{GI_SMALL_PATHS}-path frame", counts(), GI_SMALL_PATHS * MESH_ENTRIES)
    gi_small_frame_k = img
    gi_small_frame_p = plain_frame(ts, tp, key)
    gi_err = compare_frames(f"sharded GI {GI_SMALL_PATHS} paths kernel frame vs plain frame", img, gi_small_frame_p)
    tp, ts = gi_scene(GI_PATHS)
    fn = make_sharded_render_fn(ts, mesh)
    zero_counts()
    img = fn(tp, key)
    gi_counts = counts()
    check_gi(f"{GI_PATHS}-path frame", gi_counts, GI_PATHS * MESH_ENTRIES)
    if not bool(torch.isfinite(img).all()) or (img.amax(-1) > 0).double().mean().item() <= 0.5:
        raise AssertionError("the 40-path sharded GI frame is not finite or mostly black")
    gi_ms, gi_all = time_events(lambda i: fn(jittered(tp, i), prng.fold_in(key, i)), 3, 1)
    log(f"  sharded GI {w}x{h} {GI_PATHS} paths: {gi_ms:.3f} ms {['%.3f' % t for t in gi_all]} on {card}; the "
        f"single-device GI frame (phase 24) {MEASURED.get('gi_ms', float('nan')):.3f} ms")
    out.update(sharded_gi_small_max_abs_err=gi_err, sharded_gi_ms=gi_ms, sharded_gi_all_ms=gi_all,
               sharded_gi_counts=gi_counts)
    del img, fn

    # ---- 34. the sharded float64 frame ---------------------------------------------------------------
    sw, sh = SMALL
    sc = flagship_standin(T, sw, sh)
    sc.settings.AAEnabled = False
    p64, s64 = pack_scene(sc, dtype=torch.float64, device=dev)
    log(f"phase 34 sharded float64 stand-in {sw}x{sh}, AA off, over {MESH_ENTRIES} entries (the sampler on the "
        f"twin) against the port's float64 oracle")
    zero_counts()
    img64 = make_sharded_render_fn(s64, mesh)(p64)
    c = counts()
    if c["k1"] or img64.dtype != torch.float64:
        raise AssertionError(f"the sharded f64 frame ({img64.dtype}) launched K1 {c['k1']} times")
    gold = OracleRenderer(sc).render()
    img64 = img64.cpu().numpy()
    f64_err = float(np.abs(img64 - gold).max())
    f64_u8 = float((srgb_u8(img64.astype(np.float32)) == srgb_u8(gold.astype(np.float32))).all(-1).mean())
    f64_ms, f64_all = time_events(lambda i: make_sharded_render_fn(s64, mesh)(p64), 2, 1)
    log(f"  max |d| {f64_err:.3e}, u8 equal on {f64_u8:.6f} of pixels (phase 17's rule: < 1e-4, > 0.999); "
        f"{f64_ms:.3f} ms {['%.3f' % t for t in f64_all]}")
    if not (f64_err < 1e-4 and f64_u8 > 0.999):
        raise AssertionError(f"the sharded f64 frame against the oracle: max |d| {f64_err:.3e}, u8 {f64_u8:.6f}")
    out.update(sharded_f64_max_abs_err=f64_err, sharded_f64_u8_equal=f64_u8, sharded_f64_ms=f64_ms)

    # ---- 35. the sharded DoF and GI steps --------------------------------------------------------------
    log(f"phase 35 sharded steps over {MESH_ENTRIES} entries, every leaf: kernel path vs plain path (phase 8's rule)")
    tp, ts = pack_scene(flagship_standin(T, gw, gh, dof=True, samples=MC_SMALL_SAMPLES), device=dev)
    ts = dataclasses.replace(ts, aa_enabled=False)
    with torch.no_grad():
        fk = make_sharded_render_fn(ts, mesh)(tp, key)
        fp = plain_frame(ts, tp, key)
    out["sharded_dof_step"] = step_phase(f"DoF step {gw}x{gh} {MC_SMALL_SAMPLES} samples", ts, tp, fk, fp)
    tp, ts = gi_scene(GI_SMALL_PATHS)
    out["sharded_gi_step"] = step_phase(f"GI step {w}x{h} {GI_SMALL_PATHS} paths", ts, tp, gi_small_frame_k,
                                        gi_small_frame_p)
    del fk, fp, dof_small_frame_k, dof_small_frame_p, gi_small_frame_k, gi_small_frame_p

    # ---- 36. pin_mode="node" ---------------------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, gw, gh), device=dev)
    ts = dataclasses.replace(ts, aa_enabled=False)
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)
    log(f"phase 36 the {gw}x{gh} gradient step with pin_mode 'node' (the full re-scan backward) vs 'leaf'")
    node_call = functools.partial(RG.diff_round0, pin_mode="node")
    step = {}
    for mode in ("leaf", "node"):
        F.diff_round0 = node_call if mode == "node" else RG.diff_round0
        try:
            zero_counts()
            loss, grads, _ = grad_step(lambda p: P.render_frame(p, ts), tp, target)
            c = counts()
            ms, all_ms = time_events(lambda i: grad_step(lambda p: P.render_frame(p, ts), jittered(tp, i), target), 3, 1)
        finally:
            F.diff_round0 = RG.diff_round0
        if not c["k1"] or c["k1_resid"] != c["k1"]:
            raise AssertionError(f"the {mode}-pinned step: launch counts {c}")
        step[mode] = (loss, grads, ms, all_ms, c)
        log(f"  {mode}: loss {loss.item():.9g}, {ms:.3f} ms per step {['%.3f' % t for t in all_ms]} on {card}, "
            f"K1 {c['k1']} (residual form), K2 {c['k2']}")
    node_err = compare_grads("node vs leaf", step["node"][1], step["leaf"][1])
    if step["node"][0].item() != step["leaf"][0].item():
        raise AssertionError("the two pin modes' forward losses differ")
    out.update(node_step_ms=step["node"][2], leaf_step_ms=step["leaf"][2], node_max_rel_err=node_err,
               node_counts=step["node"][4])
    del step

    # ---- 37. two processes on the card -------------------------------------------------------------------
    log(f"phase 37 run_multiprocess_dryrun: 2 ranks on the one card, one sharded {gw}x{gh} step, against the "
        f"in-process 2-entry mesh (loss rtol 1e-5, leaves rtol 1e-4 atol 1e-6)")
    cuda_build.load_all()  # the ranks find every library built
    t0 = time.perf_counter()
    mp_loss, mp_grads, backend, mp_counts = mp_dryrun.run_multiprocess_dryrun(2, gw, gh, timeout=600)
    mp_s = time.perf_counter() - t0
    packed, static = mp_dryrun._build(gw, gh, dev)
    ref_loss, ref = make_sharded_value_and_grad(static, make_mesh([dev] * 2))(
        packed, torch.zeros((gh, gw, 3), device=dev), prng.PRNGKey(0))
    log(f"  backend {backend}; loss {mp_loss:.9g} (in-process {ref_loss.item():.9g}); the ranks' launches "
        f"{mp_counts}; {mp_s:.1f} s for both ranks, their start-up included")
    if backend != "gloo" or not (mp_counts["k1_lin"] and mp_counts["k1_resid"] and mp_counts["k2"]):
        raise AssertionError(f"the dryrun: backend {backend}, launches {mp_counts}")
    np.testing.assert_allclose(mp_loss, ref_loss.item(), rtol=1e-5)
    worst = 0.0
    for name, a, b in zip(LEAF_NAMES, mp_grads, leaves(ref)):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)
        if b.size and np.abs(b).any():
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    log(f"  every leaf within the rule; largest |a - b| / max|b| {worst:.2e}")
    out.update(mp_backend=backend, mp_loss=mp_loss, mp_ref_loss=ref_loss.item(), mp_counts=mp_counts, mp_s=mp_s,
               mp_max_rel_err=worst)

    # ---- 38. the ray counters --------------------------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    log(f"phase 38 frame_ray_stats of the {WIDTH}x{HEIGHT} AA5 stand-in (one twin pass, the counts x5)")
    zero_counts()
    stats = frame_ray_stats(tp, ts)
    c = counts()
    if c["k1"] or stats["camera"] != 5 * WIDTH * HEIGHT or not stats["shadow"] or not stats["bounce"]:
        raise AssertionError(f"frame_ray_stats: {stats}, launches {c}")
    stats_ms, stats_all = time_events(lambda i: frame_ray_stats(jittered(tp, i), ts), 2, 1)
    log(f"  {stats}; {stats_ms:.3f} ms per call {['%.3f' % t for t in stats_all]} (the twin); at phase 5's "
        f"{phase5_frame_ms:.3f} ms per fused frame: {stats['total'] / phase5_frame_ms * 1e3 / 1e6:.1f} M rays/s")
    out.update(ray_stats=stats, ray_stats_ms=stats_ms)

    log(json.dumps(out, default=str))
    return [
        {**kernel_entry(f"round0 ray-input form (K1, one sharded DoF pass of one shard: {C} rays)", K1_SOURCE,
                        K1_REPLACES, dof_counts["k1_ray"], ray_err, ray_ms, ray_plain_ms, *ray_bound),
         "queued_ms": ray_q},
        {**kernel_entry(f"threefry uniform draw, f32 (one shard's {C} lanes of the sharded DoF frame)",
                        "chess2rt_tpu_torch/csrc/threefry.cu", "none: XLA's threefry2x32 (jax.random.uniform)",
                        dof_counts["draws"], 0.0, draw_ms, draw_plain_ms, *draw_bound), "queued_ms": draw_q},
    ]


# the session's event script (phase 39): camera keys with and without Shift
# and Ctrl, a resize to half size and back (allowResize on), a reload (which
# restores the file's settings), mouse-look, F2 both ways, a click and F12;
# every event but the click and F12 renders a preview
SESSION_EVENTS = [("key", "w", None), ("key", "a", "shift"), ("resize", WIDTH // 2, HEIGHT // 2),
                  ("resize", WIDTH, HEIGHT), ("key", "r", None), ("key", "w", None), ("key", "d", None),
                  ("key", "up", "shift"), ("key", "s", "ctrl"), ("mouse", 12, -5), ("mouse", -20, 8),
                  ("key", "left", None), ("key", "right", "ctrl"), ("key", "f2", None), ("key", "f2", None),
                  ("key", "down", None), ("key", "a", None), ("key", "w", "ctrl"),
                  ("click", WIDTH // 2, HEIGHT // 2), ("key", "f12", None)]
BUCKET = 48
# the demo twins' arguments in phase 43: inverse_render, texture_recovery
# and bump_inverse at their defaults, gi_inverse at its default size with its
# steps cut (a 16-path step takes ~3 s on the card: its 200 steps are ~10
# minutes)
DEMO_ARGS = {"inverse_render": [], "texture_recovery": [], "bump_inverse": [], "gi_inverse": ["--steps", "8"]}
# phase 42's scene file: the stand-in at a quarter of the 1080p pixels, since
# the terminal viewer's repaints (one per bucket, twice) cost ~40 s at 1080p
CLI_SIZE = (960, 540)


def k1_entry(label, tp, ts, w, h, launches, want_hit=False, want_vis=False):
    """A kernels-line entry of K1's screen-tap form (with the residual rows
    when asked) on ``ts`` at ``w`` x ``h``: held against its plain version,
    both timed, and its bound."""
    from chess2rt_tpu_torch.ops import round0 as R

    lay = R.layout(ts, w, h, want_hit=want_hit, want_vis=want_vis)
    prm = lay.pack(tp)
    err = compare_round0(label, R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    ms, _ = time_events(lambda k: R.round0(lay, prm), 20, 3)
    plain_ms, _ = time_events(lambda k: R.round0_reference(lay, prm), 5, 1)
    lit = lit_shares(R.round0(lay, prm, want_vis=True), ts.n_lights)
    log(f"  K1 per {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return kernel_entry(f"round0 {label}", K1_SOURCE, K1_REPLACES, launches, err, ms, plain_ms,
                        *k1_bound(lay, w * h, lit))


def app_phases(argv, card, dev, phase5_frame_ms):
    """Phases 39-44: the host apps on the card: the interactive session on
    the stand-in's scene file at 1920x1080 AA5, the progressive viewer, the
    async renderer, ``--interactive`` in a fresh process on a
    pseudo-terminal, the four demo twins and the scaling recipe.  Returns
    the kernels-line entries of K1 (the session's preview tap, the demos'
    residual form, the recipe's lin-input form), K2 and the draw with these
    paths' launch counts."""
    import shutil
    import threading

    import torch
    import chess2rt_tpu_torch.models.packed as packed_mod
    from chess2rt_tpu_torch.demos import bump_inverse, gi_inverse, inverse_render, pod_scaling, texture_recovery
    from chess2rt_tpu_torch.gui import InteractiveSession
    from chess2rt_tpu_torch.gui.viewer import TerminalViewer, progressive_render
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render.async_render import render_scene_async
    from chess2rt_tpu_torch.render.buckets import get_buckets_list
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scene import parse_scene_from_file
    from chess2rt_tpu_torch.scenes import write_standin_sdl
    from chess2rt_tpu_torch.utils.color import srgb_u8

    tmp = tempfile.mkdtemp(prefix="c2rt_apps_")
    out, entries = {}, []
    try:
        path = write_standin_sdl(tmp, WIDTH, HEIGHT)

        def frame_of(scene):
            """``render_frame`` of a scene as the session packs it: numpy."""
            packed, static = pack_scene_on(scene)
            with torch.no_grad():
                return render_frame(packed, static).cpu().numpy()

        def pack_scene_on(scene):
            return packed_mod.pack_scene(scene, device=dev)

        # ---- 39. the session ---------------------------------------------------------------------------
        log(f"phase 39 InteractiveSession on the stand-in's scene file at {WIDTH}x{HEIGHT} AA5 (allowResize on): "
            f"{len(SESSION_EVENTS)} events, each timed on the host clock (its frame copied to the host)")
        s = InteractiveSession(path, device=dev)
        s.scene.settings.allowResize = True
        s.render(preview=True)
        s.render()  # warm
        preview_ms, preview_taps, shot = [], [], None
        # F12 writes output/img_<time>.bmp under the working directory, as the reference's RTDemo does
        with contextlib.chdir(tmp):
            for ev in SESSION_EVENTS:
                zero_counts()
                t = time.perf_counter()
                if ev[0] == "key":
                    res = s.handle_key(ev[1], ev[2])
                elif ev[0] == "mouse":
                    res = s.handle_mouse(ev[1], ev[2])
                elif ev[0] == "resize":
                    res = s.handle_resize(ev[1], ev[2])
                else:
                    res = s.handle_click(ev[1], ev[2])
                ms = 1e3 * (time.perf_counter() - t)
                c = counts()
                taps = c["k1"] - c["k1_ray"] - c["k1_lin"]
                log(f"  {ev}: {ms:.1f} ms, K1 {c['k1']} (screen taps {taps}, ray-input {c['k1_ray']}, bounce rounds "
                    f"{c['bounce_rounds']})")
                if ev[0] == "click":
                    if "Mouse click at" not in res or c["k1"]:
                        raise AssertionError(f"the click's trace: {res[:200]!r}, launches {c}")
                    continue
                if ev[1:2] == ("f12",):
                    shot = res
                    continue
                if not isinstance(res, np.ndarray) or res.shape[:2] != (s.scene.settings.frameHeight,
                                                                        s.scene.settings.frameWidth):
                    raise AssertionError(f"{ev} gave {type(res)} {getattr(res, 'shape', None)}")
                if taps != 1 or c["k1_ray"] != c["bounce_rounds"] or c["k1_resid"] or not np.isfinite(res).all():
                    raise AssertionError(f"{ev}: the preview's launches {c}")
                preview_ms.append(ms)
                preview_taps.append(taps)
            shot = os.path.join(tmp, shot)
        compare_u8("the F12 screenshot vs the preview frame's u8", bmp_u8(shot), srgb_u8(s.frame))
        zero_counts()
        full = s.render()
        c_full = counts()
        refine_all = []
        for _ in range(3):
            t = time.perf_counter()
            s.render()
            refine_all.append(1e3 * (time.perf_counter() - t))
        refine_ms = statistics.median(refine_all)
        log(f"  preview events: median {statistics.median(preview_ms):.1f} ms {['%.1f' % t for t in preview_ms]}; "
            f"the full refine {refine_ms:.1f} ms {['%.1f' % t for t in refine_all]} (phase 5's frame "
            f"{phase5_frame_ms:.1f} ms) on {card}; the refine's K1 launches {c_full}")
        if c_full["k1"] != 5 + c_full["bounce_rounds"] or c_full["k1_ray"] != c_full["bounce_rounds"]:
            raise AssertionError(f"the full refine's launches {c_full}")
        packed, static = pack_scene_on(s.scene)
        with torch.no_grad():
            want = render_frame(packed, static)
            plain = F.build_flagship_renderer(static, WIDTH, HEIGHT, trace=R.round0_reference)(packed)
        if not np.array_equal(full, want.cpu().numpy()):
            raise AssertionError("the session's full frame is not render_frame of the moved camera")
        log("  the full frame after the script equals render_frame of the moved camera, bit for bit")
        session_err = compare_frames("the full frame vs the plain path", torch.from_numpy(full).to(dev), plain)
        # where an event's time goes: the session's stages, each synchronised
        stages = {}
        for preview in (True, False):
            scale = s.preview_scale if preview else 1
            st_ms = {"pack": [], "render": [], "transfer": [], "upsample": []}
            for _ in range(3):
                t = time.perf_counter()
                p, st = pack_scene_on(s.scene)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if preview:
                    st = dataclasses.replace(st, width=st.width // scale, height=st.height // scale,
                                             aa_enabled=False)
                with torch.no_grad():
                    img = render_frame(p, st)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                img = img.cpu().numpy()
                t3 = time.perf_counter()
                if preview:
                    img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)[:HEIGHT, :WIDTH]
                t4 = time.perf_counter()
                for k, a, b in (("pack", t, t1), ("render", t1, t2), ("transfer", t2, t3), ("upsample", t3, t4)):
                    st_ms[k].append(1e3 * (b - a))
            stages["preview" if preview else "full"] = {k: statistics.median(v) for k, v in st_ms.items()}
        log(f"  stages (median of 3, ms): {json.dumps(stages)}")
        pst = dataclasses.replace(static, width=WIDTH // 4, height=HEIGHT // 4, aa_enabled=False)
        entries.append(k1_entry(f"screen-tap form (K1, one {WIDTH // 4}x{HEIGHT // 4} session preview tap)",
                                packed, pst, WIDTH // 4, HEIGHT // 4, sum(preview_taps)))
        out.update(session_preview_ms=preview_ms, session_refine_ms=refine_ms, session_refine_all_ms=refine_all,
                   session_full_max_abs_err=session_err, session_stages_ms=stages, session_refine_counts=c_full)
        del want, plain

        # ---- 40. progressive_render ----------------------------------------------------------------------
        n_buckets = len(get_buckets_list(WIDTH, HEIGHT, BUCKET))
        log(f"phase 40 progressive_render at {WIDTH}x{HEIGHT}, bucket {BUCKET} ({n_buckets} buckets), into a "
            f"TerminalViewer on a StringIO of 80x24")
        viewer = TerminalViewer(max_cols=80, max_rows=24, out=io.StringIO())
        blits, seen = [], {}
        blit = viewer.blit

        def timed_blit(frame):
            blits.append(time.perf_counter())
            seen["last"] = frame
            blit(frame)

        viewer.blit = timed_blit
        t = time.perf_counter()
        final = progressive_render(s, viewer, BUCKET)
        wall = time.perf_counter() - t
        first = blits[0] - t
        log(f"  {len(blits)} blits in {wall:.3f} s, the first (the prepass) after {first:.3f} s on {card}")
        if len(blits) != 1 + n_buckets or not np.array_equal(seen["last"], final) or not np.array_equal(final, full):
            raise AssertionError("progressive_render: its blits, or its final canvas against the full frame")
        log("  the final canvas equals the full frame, bit for bit")
        out.update(progressive_s=wall, progressive_first_blit_s=first, progressive_blits=len(blits))

        # ---- 41. render_scene_async ------------------------------------------------------------------------
        log(f"phase 41 render_scene_async of the moved scene at {WIDTH}x{HEIGHT} AA5: prepass (1/16), main, AA")
        stamps, frames = [], []
        zero_counts()
        t = time.perf_counter()
        h = render_scene_async(s.scene, callback=lambda f: (stamps.append(time.perf_counter()), frames.append(f)),
                               device=dev)
        last = h.result(300)
        c_async = counts()
        pass_ms = [1e3 * (b - a) for a, b in zip([t] + stamps[:-1], stamps)]
        log(f"  passes {h.passes_completed}, callbacks {len(frames)}, ms per pass {['%.1f' % m for m in pass_ms]} "
            f"on {card}; K1 launches {c_async}")
        if h.passes_completed != 3 or len(frames) != 3 or frames[0].shape != (HEIGHT // 16 * 16, WIDTH, 3):
            raise AssertionError(f"the async passes: {h.passes_completed}, shapes {[f.shape for f in frames]}")
        if not np.array_equal(last, full) or last is not frames[-1]:
            raise AssertionError("the async AA pass is not render_frame's frame")
        log("  the AA pass equals render_frame, bit for bit")
        # a stop that lands while the worker packs the scene: no pass runs
        box, ready = {}, threading.Event()
        real_pack = packed_mod.pack_scene

        def pack_then_stop(*a, **k):
            ready.wait(60)
            box["handle"].request_stop()
            return real_pack(*a, **k)

        packed_mod.pack_scene = pack_then_stop
        try:
            box["handle"] = stopped = render_scene_async(s.scene, device=dev)
            ready.set()
            stopped_frame = stopped.result(300)
        finally:
            packed_mod.pack_scene = real_pack
        if stopped_frame is not None or stopped.passes_completed or stopped.error is not None:
            raise AssertionError("a stop before the first pass still gave a frame")
        bad = parse_scene_from_file(path)
        bad.nodes[0].geometry = object()
        try:
            render_scene_async(bad, device=dev).result(300)
        except TypeError as e:
            log(f"  a stop before dispatch: no frame; a scene the packer refuses: result() re-raises {e!r}")
        else:
            raise AssertionError("result() did not re-raise the worker's error")
        out.update(async_pass_ms=pass_ms, async_counts=c_async)

        # ---- 42. --interactive in a fresh process --------------------------------------------------------------
        cw, ch = CLI_SIZE
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        cli_path = write_standin_sdl(cli_dir, cw, ch)
        n_blits = 1 + len(get_buckets_list(cw, ch, BUCKET))
        log(f"phase 42 python -m chess2rt_tpu_torch --interactive --file <stand-in.sdl at {cw}x{ch} AA5> on a "
            f"pseudo-terminal of 40x12: w, the idle refine, p, q")
        res = drive_interactive(["--file", cli_path, "-q"], [(b"[q/ESC] quit", b"w"), (2 * n_blits + 1, b"p"),
                                                              (b"saved ", b"q")], tmp, timeout=300)
        if res["rc"] != 0 or res["repaints"] != 2 * n_blits + 1:
            raise AssertionError(f"--interactive exited {res['rc']} after {res['repaints']} repaints:\n"
                                 f"{res['output'][-3000:]}")
        shot = os.path.join(tmp, res["output"].split("saved ")[1].split()[0])
        fresh = InteractiveSession(cli_path, device=dev)
        fresh.handle_key("w")
        compare_u8("the CLI's screenshot vs the in-process frame after w", bmp_u8(shot),
                   srgb_u8(fresh.render()))
        log(f"  exit 0 after {res['wall_s']:.1f} s, the first blit after {res['first_blit_s']:.1f} s "
            f"(the process's start, torch's import and the first frame included) on {card}")
        out.update(cli_wall_s=res["wall_s"], cli_first_blit_s=res["first_blit_s"])
        del s, fresh, full, last, frames

        # ---- 43. the demo twins --------------------------------------------------------------------------------
        log(f"phase 43 the demo twins in process, arguments {DEMO_ARGS}")
        demos = {}
        for name, mod in (("inverse_render", inverse_render), ("texture_recovery", texture_recovery),
                          ("bump_inverse", bump_inverse), ("gi_inverse", gi_inverse)):
            zero_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                r = mod.run(DEMO_ARGS[name])
            wall = time.perf_counter() - t
            c = counts()
            lines = printed.getvalue().strip().splitlines()
            log(f"  {name}: {lines[-2] if len(lines) > 1 else ''} / {lines[-1]}")
            log(f"    {len(r['losses'])} steps, {r['step_ms']:.1f} ms per step, {wall:.1f} s in all on {card}; "
                f"K1 {c['k1']} (residual {c['k1_resid']}, ray-input {c['k1_ray']}), K2 {c['k2']}, draws "
                f"{c['draws']}")
            if not r["losses"][-1] < r["losses"][0] or not c["k1"]:
                raise AssertionError(f"{name}: losses {r['losses'][0]} -> {r['losses'][-1]}, launches {c}")
            demos[name] = ({k: v for k, v in r.items() if k != "losses"}, c, r["losses"][0], r["losses"][-1])
        for name in ("texture_recovery", "bump_inverse"):
            if not demos[name][0]["ok"]:
                raise AssertionError(f"{name} did not recover under the JAX demo's gates")
        for name in ("gi_inverse",):
            if not demos[name][0]["fd_ok"]:
                raise AssertionError(f"{name}: the finite-difference check failed")
        ir = demos["inverse_render"][0]
        if not (demos["inverse_render"][3] < 0.05 * demos["inverse_render"][2] and ir["err_color"] < 0.1
                and ir["err_checker"] < 0.1):
            raise AssertionError(f"inverse_render: {ir}")
        # the position gate is reported, not enforced: on the lecture4 stand-in the ball's depth is recovered
        # more slowly than on lecture4 (PERF.md, section 6); its whole run is held to JAX's in
        # tests/test_torch_demos.py
        log(f"  inverse_render: loss gate, color and checker gates met; sphere position error {ir['err_pos']:.2f} "
            f"against the JAX demo's gate of 5.0 ({'met' if ir['err_pos'] < 5.0 else 'NOT met'}); exit code "
            f"{0 if ir['ok'] else 1}")
        out["demos"] = {k: v[:2] for k, v in demos.items()}
        tr_counts, gi_counts = demos["texture_recovery"][1], demos["gi_inverse"][1]

        # the kernels at the demos' shapes: K1's residual form at texture_recovery's 320x240 tap, K2 on one of
        # its steps' texel rows, the draw at gi_inverse's widest draw
        from chess2rt_tpu_torch.models import types as T
        from chess2rt_tpu_torch.scenes import flagship_standin

        sc = flagship_standin(T, 320, 240)
        sc.settings.AAEnabled = False
        tp, ts = pack_scene_on(sc)
        entries.append(k1_entry("residual form (K1 with want_hit and want_vis, one 320x240 texture_recovery tap)",
                                tp, ts, 320, 240, tr_counts["k1_resid"], want_hit=True, want_vis=True))
        tex = dataclasses.replace(tp, bitmap_atlas=torch.full_like(tp.bitmap_atlas, 0.5))
        rows = step_texel_rows(lambda p: render_frame(p, ts), tex, render_frame(tp, ts).detach())
        keys, vals, n_texels = max(rows, key=lambda r: r[0].numel())
        hist_k, hist_p = K2.texel_histogram(keys, vals, n_texels), K2.texel_histogram_reference(keys, vals, n_texels)
        k2_err, k2_scale = (hist_k - hist_p).abs().max().item(), hist_p.abs().max().item()
        if not bool(torch.isfinite(hist_k).all()) or k2_err > K2_LIMIT * max(1.0, k2_scale):
            raise AssertionError(f"K2 differs from its plain version by {k2_err:.3e} on texture_recovery's rows")
        k2_ms, _ = time_events(lambda k: K2.texel_histogram(keys, vals, n_texels), 20, 3)
        k2_plain_ms, _ = time_events(lambda k: K2.texel_histogram_reference(keys, vals, n_texels), 20, 3)
        in_range = (keys >= 0) & (keys < n_texels)
        lib_keys, lib_vals = keys[in_range].long(), vals[in_range]
        k2_lib_ms, _ = time_events(lambda k: torch.zeros((n_texels, vals.shape[1]), dtype=vals.dtype, device=dev)
                                   .index_add_(0, lib_keys, lib_vals), 20, 3)
        log(f"  K2 on texture_recovery's {keys.numel()} rows: max |K2 - plain| {k2_err:.3e}; kernel {k2_ms:.4f} ms, "
            f"plain {k2_plain_ms:.4f} ms, one index_add_ {k2_lib_ms:.4f} ms")
        entries.append(kernel_entry(f"texel_hist (K2, one texture_recovery step's {keys.numel()} texel rows)",
                                    "chess2rt_tpu_torch/csrc/texel_hist.cu", "chess2rt_tpu/ops/texel_hist.py:41",
                                    tr_counts["k2"], k2_err,  k2_ms, k2_plain_ms,
                                    *bound(keys.numel() * 4 + vals.numel() * 4 + n_texels * vals.shape[1] * 4,
                                           vals.numel()), library_ms=k2_lib_ms))
        n = 160 * 120  # one draw of gi_inverse's frame: a uniform per pixel of one path's bounce
        k = prng.fold_in(prng.PRNGKey(43), 1)
        draw_k = prng.uniform(k, (n,), device=dev)
        draw_p = prng.uniform_reference(k, (n,), device=dev)
        if not torch.equal(bits(draw_k), bits(draw_p)):
            raise AssertionError("the draw differs from its plain version at gi_inverse's width")
        draw_ms, _ = time_events(lambda i: prng.uniform(k, (n,), device=dev), 20, 3)
        draw_plain_ms, _ = time_events(lambda i: prng.uniform_reference(k, (n,), device=dev), 20, 3)
        log(f"  the draw at {n} lanes: bit-equal to its plain version; kernel {draw_ms:.4f} ms, plain "
            f"{draw_plain_ms:.4f} ms")
        entries.append(kernel_entry(f"threefry uniform draw, f32 ({n} lanes: one of gi_inverse's 160x120 draws)",
                                    "chess2rt_tpu_torch/csrc/threefry.cu",
                                    "none: XLA's threefry2x32 (jax.random.uniform)", gi_counts["draws"], 0.0,
                                    draw_ms, draw_plain_ms, *bound(n * 4, n * OPS_THREEFRY)))

        # ---- 44. the scaling recipe ------------------------------------------------------------------------------
        log(f"phase 44 pod_scaling at {WIDTH}x{HEIGHT} over the card's devices ({torch.cuda.device_count()})")
        art = os.path.join(tmp, "scaling.json")
        zero_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            scaling = pod_scaling.run(["--size", f"{WIDTH}x{HEIGHT}", "--out", art])
        c_scale = counts()
        got = json.load(open(art))
        for mode, rows in got["modes"].items():
            for r in rows:
                log(f"  {mode} at {r['devices']} device(s): {r['rays_per_sec']:.1f} rays/s, {r['step_ms']} ms, "
                    f"efficiency {r['efficiency']} on {card}")
        want_keys = {"platform", "size", "note", "modes"}
        row_keys = {"devices", "mode", "rays_per_sec", "step_ms", "efficiency"}
        if not (want_keys <= set(got) and set(got["modes"]) == {"forward", "grad"} and got["platform"] == ("gpu" if dev.type == "cuda" else "cpu")
                and all(set(r) == row_keys for rows in got["modes"].values() for r in rows)):
            raise AssertionError(f"pod_scaling's artifact: {sorted(got)}")
        if not c_scale["k1_lin"] or not c_scale["k2"]:
            raise AssertionError(f"pod_scaling's launches {c_scale}")
        log(f"  {time.perf_counter() - t:.1f} s in all; launches {c_scale}")
        out.update(scaling=scaling["modes"], scaling_counts=c_scale)
        fst = dataclasses.replace(static, fast_forward=True)
        C = -(-WIDTH * HEIGHT // 128) * 128
        flay = R.layout(fst, WIDTH, HEIGHT)
        fprm = flay.pack(packed)
        lin_err = compare_round0(f"lin-input form, the whole {WIDTH}x{HEIGHT} frame in one shard",
                                 R.round0(flay, fprm, lin_input=True, n_lanes=C),
                                 R.round0_reference(flay, fprm, lin_input=True, n_lanes=C), flay.names)
        lin_ms, _ = time_events(lambda i: R.round0(flay, fprm, lin_input=True, n_lanes=C), 20, 3)
        lin_plain_ms, _ = time_events(lambda i: R.round0_reference(flay, fprm, lin_input=True, n_lanes=C), 5, 1)
        lin_bound = k1_bound(flay, C, lit_shares(R.round0(flay, fprm, lin_input=True, n_lanes=C, want_vis=True),
                                                 fst.n_lights))
        entries.append(kernel_entry(f"round0 lin-input form (K1, pod_scaling's one-shard {WIDTH}x{HEIGHT} tap: "
                                    f"{C} lanes)", K1_SOURCE, K1_REPLACES, c_scale["k1_lin"], lin_err, lin_ms,
                                    lin_plain_ms, *lin_bound))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps(out, default=str))
    return entries


def skybox_phases(argv, card, dev):
    """Phase 45: the DoF + cubemap frame of demos/zaphod_skybox.py on the
    stand-in (``flagship_standin(dof=True, env=True)``), through K1's
    ray-input form and the draw, and the twin ``demos.zaphod_skybox`` end to
    end.  Returns the kernels-line entry of K1's ray-input form on the
    frame's first DoF rays."""
    import shutil

    import torch
    from chess2rt_tpu_torch.demos import zaphod_skybox
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
    from chess2rt_tpu_torch.render.pipeline import aa_detect, render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin
    from chess2rt_tpu_torch.utils.color import srgb_u8

    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(45)

    def plain_renderer(static, w, h):
        return F.build_flagship_renderer(static, w, h, trace=R.round0_reference, uniform=prng.uniform_reference)

    def mc_counts(label, c, samples):
        """Every DoF pass through K1's ray-input form, four draws per pass."""
        taps = 5 * samples
        log(f"  {label}: K1 launches {c['k1']} (ray-input {c['k1_ray']}, bounce rounds {c['bounce_rounds']}), "
            f"draws {c['draws']}, twin frames {c['twin_frames']}")
        if (c["draws"] != 4 * taps or c["k1_ray"] != c["k1"] or c["k1_ray"] != taps + c["bounce_rounds"]
                or c["k1_resid"] or c["twin_frames"]):
            raise AssertionError(f"{label}: launch counts {c} for {taps} DoF passes")

    # ---- 45. the DoF + cubemap frame -------------------------------------------------------------
    w, h = GRAD_SIZE
    tp, ts = pack_scene(flagship_standin(T, w, h, dof=True, env=True, samples=MC_SMALL_SAMPLES), device=dev)
    log(f"phase 45 the DoF + cubemap frame (flagship_standin(dof=True, env=True), demos/zaphod_skybox.py): "
        f"{w}x{h} AA5 {MC_SMALL_SAMPLES} samples, kernel path vs plain path, full width and adaptive")
    zero_counts()
    img = render_frame(tp, ts, key)
    small_counts = counts()
    mc_counts(f"{w}x{h} frame", small_counts, MC_SMALL_SAMPLES)
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the DoF + cubemap frame {tuple(img.shape)} is not a finite {h}x{w}x3 image")
    small_err = compare_frames(f"DoF + cubemap {w}x{h} kernel frame vs plain frame", img,
                               plain_renderer(ts, w, h)(tp, key))
    base = render_frame(tp, dataclasses.replace(ts, aa_enabled=False), key)
    flagged = int(aa_detect(base).sum())
    cap = F._aa_capacity(flagged)
    tsa = dataclasses.replace(ts, aa_adaptive=True, aa_capacity=cap)
    zero_counts()
    img_a = render_frame(tp, tsa, key)
    adaptive_counts = counts()
    log(f"  adaptive: {flagged} pixels flagged ({flagged / (w * h):.2%}), the 4 taps lane-compacted to {cap} lanes")
    mc_counts(f"adaptive {w}x{h} frame", adaptive_counts, MC_SMALL_SAMPLES)
    adaptive_err = compare_frames(f"adaptive DoF + cubemap {w}x{h} kernel frame vs plain frame", img_a,
                                  plain_renderer(tsa, w, h)(tp, key))
    compare_frames("adaptive (compacted taps) vs full-width taps", img_a, torch.where(
        aa_detect(base)[..., None], img, base))
    del img, img_a, base

    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, dof=True, env=True, samples=MC_SAMPLES), device=dev)
    log(f"  DoF + cubemap {WIDTH}x{HEIGHT} AA5, {MC_SAMPLES} samples")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    img = render_frame(tp, ts, key)
    c = counts()
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    mc_counts(f"{WIDTH}x{HEIGHT} frame", c, MC_SAMPLES)
    log(f"  peak device memory above the scene {peak:.3f} GiB")
    if not bool(torch.isfinite(img).all()) or (img.amax(-1) > 0).double().mean().item() <= 0.9:
        raise AssertionError("the 1080p DoF + cubemap frame is not finite or not lit")
    ms, all_ms = time_events(lambda i: render_frame(jittered(tp, i), ts, prng.fold_in(key, i)), 3, 1)
    dof_ms, env_ms = MEASURED.get("dof_ms"), MEASURED.get("env_ms")
    log(f"  DoF + cubemap frame {ms:.3f} ms {['%.3f' % t for t in all_ms]} on {card}; beside the DoF frame of "
        f"phase 20 ({dof_ms:.3f} ms, {ms / dof_ms:.2f}x) and the env frame of phase 27 ({env_ms:.3f} ms)")
    if "--profile" in argv:
        profile_run("DoF + cubemap frame", lambda: render_frame(jittered(tp, 94), ts, key))
    del img

    # K1's ray-input form on the frame's first DoF rays (its first pass)
    frame = begin_frame(tp.camera, WIDTH / HEIGHT)
    lin = torch.arange(MC_LANES, device=dev)
    _, k0 = prng.split(key)
    _, kj, kj2, kr = prng.split(k0, 4)
    k1, k2 = prng.split(kr)
    draw = lambda k: prng.uniform(k, (MC_LANES,), device=dev)  # noqa: E731
    o3, d3 = screen_rays(tp.camera, frame, float(WIDTH), float(HEIGHT), (lin % WIDTH).float() + draw(kj),
                         (lin // WIDTH).float() + draw(kj2), 0.0, dof=True, disc_uv=(draw(k1), draw(k2)))
    o3, d3 = o3.contiguous(), d3.contiguous()
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    out_k = R.round0(lay, prm0, o3, d3)
    miss = (out_k["win"] < 0).double().mean().item()
    k1_err = compare_round0(f"ray-input on the frame's first {MC_LANES} DoF rays", out_k,
                            R.round0_reference(lay, prm0, o3, d3), lay.names)
    del out_k
    k1_b = k1_bound(lay, MC_LANES, lit_shares(R.round0(lay, prm0, o3, d3, want_vis=True), ts.n_lights),
                    ray_input=True)
    k1_ms, _ = time_events(lambda i: R.round0(lay, prm0, o3, d3), 20, 3)
    k1_q = queued_ms(lambda: R.round0(lay, prm0, o3, d3), 20, busy)
    k1_plain_ms, _ = time_events(lambda i: R.round0_reference(lay, prm0, o3, d3), 3, 1)
    log(f"  the first pass's rays that miss every node {miss:.4f}; K1 ray-input on them: {k1_ms:.4f} ms per call, "
        f"{k1_q:.4f} ms queued, plain {k1_plain_ms:.3f} ms, bound {k1_b[0]:.4f} ms ({k1_b[1]}; bytes "
        f"{k1_b[2]:.4f}, operations {k1_b[3]:.4f})")
    if miss < 0.05:
        raise AssertionError(f"only {miss:.2%} of the DoF + cubemap rays miss")
    del o3, d3, lin

    # the twin end to end, with and without --adaptive-aa
    tmp = tempfile.mkdtemp(prefix="c2rt_skybox_")
    twin = {}
    try:
        for adaptive in (False, True):
            label = "--adaptive-aa" if adaptive else "default"
            path = os.path.join(tmp, f"sky_{adaptive}.bmp")
            zero_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                r = zaphod_skybox.run(["--size", f"{WIDTH}x{HEIGHT}", "-o", path]
                                      + (["--adaptive-aa"] if adaptive else []))
            wall = time.perf_counter() - t
            tc = counts()
            packed, static = zaphod_skybox.build(WIDTH, HEIGHT, adaptive_aa=adaptive, device=dev)
            want = srgb_u8(render_frame(packed, static, prng.PRNGKey(0)).float().cpu().numpy())
            compare_u8(f"zaphod_skybox {label}: its BMP vs srgb_u8 of render_frame in this process", bmp_u8(path),
                       want)
            tflagged = None
            if adaptive:
                tflagged = int(aa_detect(render_frame(packed, dataclasses.replace(static, aa_enabled=False),
                                                      prng.PRNGKey(0))).sum())
            for line in printed.getvalue().strip().splitlines():
                log(f"    {line}")
            log(f"  zaphod_skybox {label}: first frame {r['first_ms']:.1f} ms (kernels built earlier), steady "
                f"{r['steady_ms']:.1f} ms, {wall:.1f} s in all on {card}; launches {tc}"
                + (f"; {tflagged} pixels flagged against the default capacity "
                   f"{F._aa_capacity(-(-MC_LANES // 32))} lanes" if adaptive else ""))
            if not (r["sky"].min() > 0.05) or not tc["k1_ray"] or not tc["draws"] or tc["twin_frames"]:
                raise AssertionError(f"zaphod_skybox {label}: sky row {r['sky']}, launches {tc}")
            twin[label] = {"first_ms": r["first_ms"], "steady_ms": r["steady_ms"], "wall_s": wall,
                           "sky": r["sky"].tolist(), "counts": tc, "flagged": tflagged}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(json.dumps({
        "skybox_small_counts": small_counts, "skybox_small_max_abs_err": small_err,
        "skybox_adaptive_counts": adaptive_counts, "skybox_adaptive_max_abs_err": adaptive_err,
        "skybox_adaptive_flagged": flagged, "skybox_frame_ms": ms, "skybox_frame_all_ms": all_ms,
        "skybox_counts": c, "skybox_peak_gib": peak, "skybox_miss_share": miss, "skybox_twin": twin,
    }))
    return [{**kernel_entry(f"round0 ray-input form (K1, the DoF + cubemap frame's first pass of {MC_LANES} rays)",
                            K1_SOURCE, K1_REPLACES, c["k1_ray"], k1_err, k1_ms, k1_plain_ms, *k1_b),
             "queued_ms": k1_q}]


# phase 46: the bench twin's modes (the command line's flags, the function,
# its arguments) and the launch counters each path must show (zero_counts'
# names); --grad --gi takes one step per call
BENCH_MODES = (
    ("main", "main", (), ("k1", "k1_ray", "draws")),
    ("--sharded", "main_sharded", (), ("k1_lin", "draws")),
    ("--grad", "main_grad", (), ("k1_resid", "k2", "draws")),
    ("--grad --gi", "main_grad_gi", (GI_SIZE[0], GI_SIZE[1], 1, GI_PATHS), ("k1_resid", "k2", "draws")),
    ("--check", "main_check", (), ("k1", "k1_ray", "k1_resid", "k2", "twin_frames")),
    ("--verify-counts", "main_verify_counts", (), ()),
)


def bench_phases(argv, card, dev):
    """Phase 46: the six modes of ``python -m chess2rt_tpu_torch.bench`` (the
    twin of the root bench.py) in this process at bench.py's defaults, each
    with the launch counters zeroed just before it and read just after,
    then the command in a fresh process."""
    from chess2rt_tpu_torch import bench

    log(f"phase 46 the bench twin's modes in this process ({', '.join(m[0] for m in BENCH_MODES)}; --grad --gi "
        f"at {GI_SIZE[0]}x{GI_SIZE[1]}, {GI_PATHS} paths, one step per call), then python -m "
        f"chess2rt_tpu_torch.bench in a fresh process")
    results = {}
    for mode, name, args, needs in BENCH_MODES:
        zero_counts()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            r = getattr(bench, name)(*args, device=dev)
        wall = time.perf_counter() - t0
        c = counts()
        printed = out.getvalue().strip().splitlines()
        log(f"  {mode}: {printed[-1] if printed else '(nothing printed)'}")
        for text in err.getvalue().strip().splitlines():
            log(f"    {text}")
        log(f"    launches {c}; {wall:.1f} s in all")
        if len(printed) != 1 or json.loads(printed[0]) != r["line"]:
            raise AssertionError(f"bench {mode} printed {printed}, not its one JSON line")
        value = r["line"]["value"]
        if not (isinstance(value, float) and np.isfinite(value) and value >= 0):
            raise AssertionError(f"bench {mode}: value {value}")
        missing = [k for k in needs if not c[k]]
        if missing:
            raise AssertionError(f"bench {mode}: its path launched none of {missing} ({c})")
        results[mode] = {**r, "counts": c, "wall_s": wall}
    if not results["--check"]["line"]["ok"]:
        raise AssertionError(f"bench --check failed on the card: {results['--check']['line']}")
    c = results["main"]["counts"]
    if c["twin_frames"] or c["k1_resid"] or c["k1"] <= c["k1_ray"]:
        raise AssertionError(f"bench main: launches {c}: a twin frame, a residual form or no screen tap")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "chess2rt_tpu_torch.bench"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m chess2rt_tpu_torch.bench exited {res.returncode}:\n{res.stderr[-4000:]}")
    fresh = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"  fresh process: {json.dumps(fresh)}; {wall:.1f} s in all; {res.stderr.strip().splitlines()[-1]}")
    if fresh["metric"] != "rays_per_sec_chip" or not fresh["value"] > 0:
        raise AssertionError(f"python -m chess2rt_tpu_torch.bench printed {fresh}")
    log(json.dumps({"bench": results, "bench_fresh": fresh, "bench_fresh_wall_s": wall}))


# phase 47: the engine modes.  The GI frame's paths per launch, the batched
# draw's K (the GI frame's keys per draw) and the frames' repeats
ENGINE_K, ENGINE_SMALL_K, ENGINE_REPS = 8, 4, 3


def engine_phases(argv, card, dev):
    """Phase 47: the engine modes of ``SceneStatic`` on the card, each beside
    its default: the batched threefry draw, ``gi_path_batch`` on the 640x480
    GI frame, ``bounce_mode`` on the 1080p AA5 frame, ``texel_tap_reuse`` on
    the same frame and ``texel_grad_mode`` on the 640x480 step.  Returns the
    kernels-line entries of the batched draw and of K1's want_hit form at
    the batched frame's width."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin, gi_standin

    w, h = GI_SIZE
    C = w * h
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(47)
    out = {}

    def interleaved(label, runs, reps=ENGINE_REPS):
        """Median ms of each run (CUDA events around each call), the runs
        taking turns: one warm-up each, then ``reps`` rounds."""
        times = {name: [] for name in runs}
        for i in range(1 + reps):
            for name, run in runs.items():
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run(i)
                end.record()
                torch.cuda.synchronize()
                if i:
                    times[name].append(start.elapsed_time(end))
        res = {name: {"ms": statistics.median(t), "all_ms": t} for name, t in times.items()}
        log(f"  {label} on {card}: " + "; ".join(
            f"{name} {r['ms']:.3f} ms {['%.3f' % t for t in r['all_ms']]}" for name, r in res.items()))
        return res

    # ---- the batched draw ---------------------------------------------------------------------------------
    K = ENGINE_K
    keys = prng.split(key, K)
    log(f"phase 47 the engine modes: the batched threefry draw (uniform_keys), {K} keys x {C} lanes, against its "
        f"plain version and {K} single draws")
    draw_bits = {}
    for dt in (torch.float32, torch.float64):
        zero_counts()
        got = prng.uniform_keys(keys, C, dt, device=dev)
        if counts()["draws"] != 1:
            raise AssertionError("the batched draw did not launch its kernel once")
        plain = prng.uniform_keys_reference(keys, C, dt, device=dev)
        single = torch.cat([prng.uniform(k, (C,), dt, device=dev) for k in keys])
        diff = (int((bits(got) != bits(plain)).sum()), int((bits(got) != bits(single)).sum()))
        draw_bits[str(dt).split(".")[-1]] = diff
        if any(diff):
            raise AssertionError(f"batched draw {dt}: {diff[0]} values differ from the plain draw, {diff[1]} from "
                                 f"{K} single launches")
    draw_ms, _ = time_events(lambda i: prng.uniform_keys(keys, C, device=dev), 20, 3)
    draw_q = queued_ms(lambda: prng.uniform_keys(keys, C, device=dev), 20, busy)
    singles_q = queued_ms(lambda: [prng.uniform(k, (C,), device=dev) for k in keys], 20, busy)
    singles_ms, _ = time_events(lambda i: [prng.uniform(k, (C,), device=dev) for k in keys], 20, 3)
    draw_plain_ms, _ = time_events(lambda i: prng.uniform_keys_reference(keys, C, device=dev), 5, 1)
    draw_bound = bound(4 * K * C + 8 * K, K * C * OPS_THREEFRY)
    log(f"  f32 and f64 bit-equal to the plain draw and to {K} single launches; f32: {draw_ms:.4f} ms per call, "
        f"{draw_q:.4f} ms queued; {K} single launches {singles_ms:.4f} ms per call, {singles_q:.4f} ms queued; "
        f"plain {draw_plain_ms:.3f} ms; bound {draw_bound[0]:.4f} ms ({draw_bound[1]}), at the int32 rate "
        f"{1e3 * K * C * OPS_THREEFRY / PEAK_INT32:.4f} ms")
    out["draw"] = {"ms": draw_ms, "queued_ms": draw_q, "singles_ms": singles_ms, "singles_queued_ms": singles_q,
                   "plain_ms": draw_plain_ms, "bound_ms": draw_bound[0], "differing_bits": draw_bits}
    del got, plain, single

    # ---- gi_path_batch -------------------------------------------------------------------------------------
    def gi_scene(paths, **knobs):
        tp, ts = pack_scene(gi_standin(T, w, h, paths=paths), device=dev)
        return tp, dataclasses.replace(ts, gi_point_light_direct=True, **knobs)

    def gi_counts(label, c, ts, batches):
        """One K1 launch (want_hit alone) and one bounce kernel per bounce
        round over the batch's K slabs; two draws per batch of paths (the
        bounce kernel draws inline)."""
        rounds = c["gi_rounds"]
        log(f"  {label}: K1 launches {c['k1']} (want_hit alone {c['k1_hit']}), bounce rounds {rounds} (bounce "
            f"kernel {c['gi_kernels']}), draws {c['draws']} for {batches} batches of paths")
        if not (c["k1"] == c["k1_hit"] == c["k1_ray"] == c["gi_kernels"] == rounds and c["gi_glue"] == 0
                and c["draws"] == 2 * batches
                and batches <= rounds <= batches * (ts.max_trace_depth + 1) and not c["twin_frames"]):
            raise AssertionError(f"{label}: launch counts {c}")

    tp4, ts4 = gi_scene(GI_SMALL_PATHS, gi_path_batch=ENGINE_SMALL_K)
    log(f"  gi_path_batch: the GI stand-in {w}x{h}, {GI_SMALL_PATHS} paths, K={ENGINE_SMALL_K}: kernel path vs "
        f"plain path (plain K1, plain draws)")
    zero_counts()
    img = render_frame(tp4, ts4, key)
    gi_counts(f"K={ENGINE_SMALL_K} frame", counts(), ts4, GI_SMALL_PATHS // ENGINE_SMALL_K)
    plain = gi.build_gi_renderer(ts4, w, h, trace=R.round0_reference, uniform=prng.uniform_reference)(tp4, key)
    small_err = compare_frames(f"GI {GI_SMALL_PATHS} paths K={ENGINE_SMALL_K} kernel frame vs plain frame", img, plain)
    del img, plain, tp4

    tp, ts = gi_scene(GI_PATHS)
    tsk = dataclasses.replace(ts, gi_path_batch=K)
    log(f"  gi_path_batch: the {GI_PATHS}-path GI frame, K=1 and K={K}")
    gi_runs, frames = {}, {}
    for label, st in (("K=1", ts), (f"K={K}", tsk)):
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        frames[label] = render_frame(tp, st, key)
        c = counts()
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        gi_counts(f"{label} frame", c, st, GI_PATHS // (st.gi_path_batch or 1))
        gi_runs[label] = {"counts": c, "peak_gib": peak}
        log(f"    {label}: peak device memory above the scene {peak:.3f} GiB")
    rel = ((frames[f"K={K}"] - frames["K=1"]).abs() / (1e-5 + frames["K=1"].abs())).max().item()
    gap = (frames[f"K={K}"] - frames["K=1"]).abs().max().item()
    log(f"  K={K} frame vs K=1 frame: max |d| {gap:.3e}, max |d| / (1e-5 + |K=1|) {rel:.3e}")
    if not bool(((frames[f"K={K}"] - frames["K=1"]).abs() <= 1e-5 + 1e-5 * frames["K=1"].abs()).all()):
        raise AssertionError(f"the K={K} GI frame differs from the K=1 frame beyond rtol/atol 1e-5")
    if gi_runs[f"K={K}"]["counts"]["k1"] * K > gi_runs["K=1"]["counts"]["k1"]:
        raise AssertionError(f"K={K} launched K1 more than 1/{K} as often as K=1")
    del frames
    times = interleaved(f"GI frame {w}x{h}, {GI_PATHS} paths", {
        "K=1": lambda i: render_frame(jittered(tp, i), ts, prng.fold_in(key, i)),
        f"K={K}": lambda i: render_frame(jittered(tp, i), tsk, prng.fold_in(key, i))})
    for label in times:
        gi_runs[label].update(times[label])
    if "--profile" in argv:
        profile_run("GI frame K=1", lambda: render_frame(jittered(tp, 91), ts, key))
        profile_run(f"GI frame K={K}", lambda: render_frame(jittered(tp, 91), tsk, key))
    out["gi"] = {"small_max_abs_err": small_err, "k_vs_1_max_abs": gap, "runs": gi_runs}

    # K1's want_hit form at the batched frame's width: K slabs of jittered camera rays
    lay = R.layout(ts, w, h, want_hit=True)
    prm = lay.pack(tp)
    rays = [gi_camera_rays(tp, w, h, 470 + j) for j in range(K)]
    wo, wd = (torch.cat([r[i] for r in rays]).contiguous() for i in (0, 1))
    n_wide = wo.shape[0]
    wide_err = compare_round0(f"K1 want_hit on {n_wide} camera rays ({K} slabs)", R.round0(lay, prm, wo, wd),
                              R.round0_reference(lay, prm, wo, wd), lay.names)
    vis = R.round0(lay, prm, wo, wd, want_vis=True)
    shaded = (vis["win"] >= 0).float()
    lit = [(vis[f"vis{li}"] * shaded).mean().item() for li in range(ts.n_lights)]
    wide_bound = k1_bound(lay, n_wide, lit, ray_input=True, scanned=shaded.mean().item())
    wide_ms, _ = time_events(lambda i: R.round0(lay, prm, wo, wd), 10, 2)
    wide_q = queued_ms(lambda: R.round0(lay, prm, wo, wd), 10, busy)
    wide_plain_ms, _ = time_events(lambda i: R.round0_reference(lay, prm, wo, wd), 2, 1)
    log(f"  K1 want_hit ray-input on {n_wide} rays: {wide_ms:.4f} ms per call, {wide_q:.4f} ms queued, plain "
        f"{wide_plain_ms:.3f} ms; bound {wide_bound[0]:.4f} ms ({wide_bound[1]})")
    del vis, rays, wo, wd, tp

    # ---- bounce_mode -----------------------------------------------------------------------------------------
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)
    ts = dataclasses.replace(ts, bounce_capacity=WIDTH * HEIGHT // 16)  # bench.py's
    log(f"  bounce_mode: the {WIDTH}x{HEIGHT} AA5 frame, bounce_capacity {ts.bounce_capacity}: block, compact, full")
    modes = {m: dataclasses.replace(ts, bounce_mode=m) for m in ("block", "compact", "full")}
    bounce = {}
    ref = None
    for m, st in modes.items():
        zero_counts()
        img = render_frame(tp, st)
        c = counts()
        if not (c["k1"] > c["k1_ray"] == c["bounce_rounds"] > 0 and not c["twin_frames"]):
            raise AssertionError(f"bounce_mode {m}: launch counts {c}")
        ref = img if ref is None else ref
        differ = int((bits(img) != bits(ref)).sum())
        log(f"    {m}: K1 launches {c['k1']} (ray-input {c['k1_ray']}), bounce rounds {c['bounce_rounds']}, "
            f"compact overflows {c['compact_overflows']}; values differing from block {differ}")
        if differ:
            raise AssertionError(f"bounce_mode {m}: {differ} values differ from the block frame")
        bounce[m] = {"counts": c}
    times = interleaved(f"{WIDTH}x{HEIGHT} AA5 frame by bounce_mode",
                        {m: (lambda i, st=st: render_frame(jittered(tp, i), st)) for m, st in modes.items()})
    for m in bounce:
        bounce[m].update(times[m])
    out["bounce_mode"] = bounce

    # ---- texel_tap_reuse --------------------------------------------------------------------------------------
    log(f"  texel_tap_reuse: the {WIDTH}x{HEIGHT} AA5 frame, off and on at capacity n / 8 (the default) and n")
    variants = {"on": dataclasses.replace(ts, texel_tap_reuse=True),
                "on_cap_n": dataclasses.replace(ts, texel_tap_reuse=True, texel_reuse_capacity=WIDTH * HEIGHT)}
    img_off = render_frame(tp, ts)
    reuse = {}
    for name, st in variants.items():
        zero_counts()
        F.reuse_taps = F.reuse_changed = F.reuse_overflows = 0
        img_on = render_frame(tp, st)
        c = counts()
        differ = int((bits(img_on) != bits(img_off)).sum())
        share = F.reuse_changed / max(1, F.reuse_taps * WIDTH * HEIGHT)
        log(f"    {name}: {F.reuse_taps} taps reused the base tap's quads, changed lanes {F.reuse_changed} ({share:.4f} "
            f"of each tap's lanes on average), {F.reuse_overflows} overflowed to the full gather; K1 launches "
            f"{c['k1']}; values differing from off {differ}")
        if differ or F.reuse_taps != 4 or c["twin_frames"] or (name == "on_cap_n" and F.reuse_overflows):
            raise AssertionError(f"texel_tap_reuse {name}: {differ} values differ from off, {F.reuse_taps} taps "
                                 f"reused, {F.reuse_overflows} overflowed")
        reuse[name] = {"changed_share": share, "taps": F.reuse_taps, "overflows": F.reuse_overflows}
    times = interleaved(f"{WIDTH}x{HEIGHT} AA5 frame, texel_tap_reuse",
                        {"off": lambda i: render_frame(jittered(tp, i), ts),
                         **{name: (lambda i, st=st: render_frame(jittered(tp, i), st)) for name, st in variants.items()}})
    reuse["off"] = {}
    for name in times:
        reuse[name].update(times[name])
    out["texel_tap_reuse"] = reuse
    del img_on, img_off, tp

    # ---- texel_grad_mode -----------------------------------------------------------------------------------------
    gw, gh = GRAD_SIZE
    gp, gs = pack_scene(flagship_standin(T, gw, gh), device=dev)
    gs = dataclasses.replace(gs, aa_enabled=False, bounce_capacity=gw * gh // 16)  # the grad bench's
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)
    log(f"  texel_grad_mode: the {gw}x{gh} gradient step under histogram, sorted and scatter")
    grads, steps = {}, {}
    for m in ("histogram", "sorted", "scatter"):
        st = dataclasses.replace(gs, texel_grad_mode=m)
        zero_counts()
        loss, grads[m], _ = grad_step(lambda p: render_frame(p, st), gp, target)
        c = counts()
        if not c["k1_resid"] or bool(c["k2"]) != (m == "histogram"):
            raise AssertionError(f"texel_grad_mode {m}: launch counts {c}")
        steps[m] = {"loss": loss.item(), "counts": c}
    atlas = grads["histogram"]["bitmap_atlas"]
    for m in ("sorted", "scatter"):
        d = (grads[m]["bitmap_atlas"] - atlas).abs()
        # the mode moves the atlas gradient alone; other leaves may differ in the last bits where atomics sum
        others = {k: (g - grads["histogram"][k]).abs().max().item() / max(1e-30, g.abs().max().item())
                  for k, g in grads[m].items() if k != "bitmap_atlas" and g.numel()}
        ok = bool((d <= 1e-6 + 1e-4 * atlas.abs()).all())
        log(f"    {m}: atlas gradient vs histogram max |d| {d.max().item():.3e} (largest {atlas.abs().max().item():.3e}"
            f"); other leaves: {sum(v > 0 for v in others.values())} of {len(others)} differ, largest |d| / max "
            f"{max(others.values()):.2e}; K2 launches {steps[m]['counts']['k2']}")
        if not ok or max(others.values()) > 1e-5 or abs(steps[m]["loss"] - steps["histogram"]["loss"]) > 1e-6 * abs(
                steps["histogram"]["loss"]):
            raise AssertionError(f"texel_grad_mode {m}: the step differs from histogram's beyond atol 1e-6, rtol 1e-4 "
                                 f"(the atlas) or 1e-5 (the other leaves)")
        steps[m]["atlas_max_abs"] = d.max().item()
    times = interleaved(f"{gw}x{gh} step by texel_grad_mode", {
        m: (lambda i, m=m: grad_step(lambda p: render_frame(p, dataclasses.replace(gs, texel_grad_mode=m)),
                                     jittered(gp, i), target)) for m in steps})
    for m in steps:
        steps[m].update(times[m])
    out["texel_grad_mode"] = steps
    log(json.dumps({"engine_modes": out}))
    return [
        {**kernel_entry(f"threefry uniform draw, batched, f32 ({K} keys x {C} lanes, one launch: the K={K} GI frame's "
                        f"draws; no TPU kernel: XLA's vmapped threefry2x32)",
                        "chess2rt_tpu_torch/csrc/threefry.cu",
                        "none: XLA's threefry2x32 (jax.vmap of jax.random.uniform, pallas_trace.py:2201-2205)",
                        gi_runs[f"K={K}"]["counts"]["draws"], 0.0, draw_ms, draw_plain_ms, *draw_bound),
         "queued_ms": draw_q, "bound_int32_ops_ms": 1e3 * K * C * OPS_THREEFRY / PEAK_INT32},
        {**kernel_entry(f"round0 want_hit ray-input form (K1 without the vis rows, one bounce of the K={K} GI frame: "
                        f"{n_wide} rays)", K1_SOURCE, K1_REPLACES, gi_runs[f"K={K}"]["counts"]["k1_hit"], wide_err,
                        wide_ms, wide_plain_ms, *wide_bound), "queued_ms": wide_q},
    ]


def bounce_phases(argv, card, dev):
    """Phase 48: the GI bounce kernel (csrc/gi_bounce.cu) against its plain
    version ``gi.bounce_reference`` (with the draws it replaces) on the
    second bounce round of the 640x480 GI stand-in, one path and K = 8
    path-slabs; its time per call, queued and against its bound, and its
    launches in a 40-path frame.  Returns its kernels-line entries."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import TEX_BITMAP, pack_scene
    from chess2rt_tpu_torch.ops import gi, prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import gi_standin

    w, h = GI_SIZE
    C = w * h
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    tp, ts = pack_scene(gi_standin(T, w, h, paths=GI_PATHS), device=dev)
    ts = dataclasses.replace(ts, gi_point_light_direct=True)
    lay = R.layout(ts, w, h, want_hit=True)
    prm = lay.pack(tp)
    zero_counts()
    render_frame(tp, ts, prng.PRNGKey(48))
    frame_counts = counts()
    log(f"phase 48 the GI bounce kernel against bounce_reference on the GI stand-in {w}x{h}, NEE; a {GI_PATHS}-path "
        f"frame: {frame_counts['gi_kernels']} bounce kernels, {frame_counts['gi_glue']} glue rounds of "
        f"{frame_counts['gi_rounds']}")
    if not frame_counts["gi_kernels"] == frame_counts["gi_rounds"] > 0 or frame_counts["gi_glue"]:
        raise AssertionError(f"the GI frame's bounce rounds did not all take the kernel: {frame_counts}")
    entries, out = [], {}
    for K in BOUNCE_KS:
        n = K * C
        rays = [gi_camera_rays(tp, w, h, 480 + j) for j in range(K)]
        orig, dir = (torch.cat([r[i] for r in rays]).contiguous() for i in (0, 1))
        keys = prng.split(prng.PRNGKey(48 + K), 4 * K)
        state = (orig, dir, torch.ones_like(orig), torch.zeros_like(orig), torch.ones(n, dtype=torch.bool, device=dev))
        o = R.round0(lay, prm, orig, dir)
        u, v = prng.uniform_keys(keys[:K], C, device=dev), prng.uniform_keys(keys[K:2 * K], C, device=dev)
        state = tuple(x.contiguous() for x in gi.bounce_reference(ts, o, None, tp.ambient, *state, u, v, 1e-3))
        o = R.round0(lay, prm, state[0], state[1])
        winc = torch.clamp_min(o["win"], 0)
        tex = S.bitmap_color(tp, ts, winc, o["u"], o["v"], S.node_onehot(ts, winc))
        diffuse = torch.where((S.tex_kind_of(ts, winc) == TEX_BITMAP)[:, None], tex,
                              torch.stack([o["dr"], o["dg"], o["db"]], -1)).contiguous()
        ku, kv = keys[2 * K:3 * K], keys[3 * K:]

        def plain(i):
            uu, vv = prng.uniform_keys(ku, C, device=dev), prng.uniform_keys(kv, C, device=dev)
            return gi.bounce_reference(ts, o, diffuse, tp.ambient, *state, uu, vv, 1e-3)

        want = plain(0)
        got = gi.gi_bounce(ts, o, diffuse, tp.ambient, *(x.clone() for x in state), ku, kv, 1e-3)
        torch.cuda.synchronize()
        unequal = {name: int((bits(a) != bits(b)).any(-1).sum()) if a.dtype == torch.float32 else int((a != b).sum())
                   for name, a, b in zip(("orig", "dir", "mult", "acc", "alive"), got, want)}
        err = {name: ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
               for name, a, b in zip(("orig", "dir", "mult", "acc"), got, want)}
        log(f"  {n} lanes ({K} x {C}): lanes not bit-equal {unequal}; max |d| / max(|plain|, 1) "
            f"{ {k: float(f'{e:.3e}') for k, e in err.items()} }")
        if unequal["alive"] or max(err.values()) > 1e-5:
            raise AssertionError(f"the bounce kernel against bounce_reference at {n} lanes: {unequal}, {err}")
        scratch = tuple(x.clone() for x in state)
        ms, _ = time_events(lambda i: gi.gi_bounce(ts, o, diffuse, tp.ambient, *scratch, ku, kv, 1e-3), 20, 3)
        q = queued_ms(lambda: gi.gi_bounce(ts, o, diffuse, tp.ambient, *scratch, ku, kv, 1e-3), 20, busy)
        plain_ms, _ = time_events(plain, 20, 3)
        plain_q = queued_ms(lambda: plain(0), 20, busy)
        b = bound(n * BOUNCE_BYTES, n * (OPS_BOUNCE + 2 * OPS_THREEFRY))
        log(f"  {n} lanes: {ms:.4f} ms per call, {q:.4f} ms queued; plain (bounce_reference and its two draws) "
            f"{plain_ms:.4f} ms per call, {plain_q:.4f} ms queued; bound {b[0]:.4f} ms ({b[1]}; bytes {b[2]:.4f}, "
            f"operations {b[3]:.4f}): {100 * b[0] / q:.1f}% of it queued")
        out[n] = {"ms": ms, "queued_ms": q, "plain_ms": plain_ms, "plain_queued_ms": plain_q, "bound_ms": b[0],
                  "unequal_lanes": unequal, "max_rel_err": err}
        entries.append({**kernel_entry(
            f"gi_bounce (the GI bounce round after K1: NEE, two draws, hemisphere sample, next ray; {K} x {C} lanes)",
            "chess2rt_tpu_torch/csrc/gi_bounce.cu",
            "none: the GI tracer's glue (chess2rt_tpu/ops/pallas_trace.py:2159 build_gi_tracer, XLA)",
            frame_counts["gi_kernels"] if K == 1 else None, max(err.values()), ms, plain_ms, *b),
            "queued_ms": q, "plain_queued_ms": plain_q})
        del rays, orig, dir, state, o, diffuse, want, got, scratch
    log(json.dumps({"gi_bounce": out}))
    return entries


def combine_phases(argv, card, dev):
    """Phase 49: the combine kernel (csrc/combine.cu) against its plain
    version ``flagship.combine_reference`` on the 1080p DoF + cubemap
    frame's first pass (its 2,073,600 rays through K1's ray-input form) and
    on that pass's block-compacted bounce round, bit for bit, also with
    missed lanes, NaN u and v and zero directions planted; its time per
    call, queued and against its bound; and which path ran each
    ``combine_outputs`` call of a 1080p DoF + cubemap frame and of the
    1080p AA5 stand-in frame.  Returns its kernels-line entries."""
    import torch
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import flagship as F
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(49)
    tp, ts = pack_scene(flagship_standin(T, WIDTH, HEIGHT, dof=True, env=True), device=dev)
    log(f"phase 49 the combine kernel against combine_reference on the DoF + cubemap frame's first pass "
        f"({WIDTH}x{HEIGHT}) and its bounce round; the paths of the 1080p frames' calls")
    scenes = {"DoF + cubemap": (tp, ts), "AA5 stand-in": pack_scene(flagship_standin(T, WIDTH, HEIGHT), device=dev)}
    calls = {}
    for label, (p, s) in scenes.items():
        F.combine_kernels = F.combine_glue = F.bounce_rounds = 0
        render_frame(p, s, key)
        torch.cuda.synchronize()
        calls[label] = {"kernel": F.combine_kernels, "glue": F.combine_glue, "bounce_rounds": F.bounce_rounds}
        taps = 5 * (s.dof_samples if s.dof else 1)
        log(f"  {label} frame: {calls[label]} over {taps} passes")
        if F.combine_glue or F.combine_kernels != taps + F.bounce_rounds:
            raise AssertionError(f"the {label} frame's combine_outputs calls did not all take the kernel: {calls}")

    frame = begin_frame(tp.camera, WIDTH / HEIGHT)
    lin = torch.arange(MC_LANES, device=dev)
    _, k0 = prng.split(key)
    _, kj, kj2, kr = prng.split(k0, 4)
    k1, k2 = prng.split(kr)
    draw = lambda k: prng.uniform(k, (MC_LANES,), device=dev)  # noqa: E731
    o3, d3 = screen_rays(tp.camera, frame, float(WIDTH), float(HEIGHT), (lin % WIDTH).float() + draw(kj),
                         (lin // WIDTH).float() + draw(kj2), 0.0, dof=True, disc_uv=(draw(k1), draw(k2)))
    o3, d3 = o3.contiguous(), d3.contiguous()
    lay = R.layout(ts, WIDTH, HEIGHT)
    prm0 = lay.pack(tp)
    tap = R.round0(lay, prm0, o3, d3)
    _, cont, _, ro, rd = F.combine_reference(tp, ts, tap, d3)
    blk = cont.reshape(-1, R.BOUNCE_BLOCK).any(1).nonzero().squeeze(1)
    bo3, bd3 = (x.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous() for x in (ro, rd))
    bounce = R.round0(lay, prm0, bo3, bd3)
    del o3, lin, cont, ro, rd, bo3

    def planted(o, dirs):
        o = {k: v.clone() for k, v in o.items()}
        o["win"][::13] = -1
        o["u"][3::7] = float("nan")
        o["v"][5::11] = float("nan")
        dirs = dirs.clone()
        dirs[::5] = 0.0
        return o, dirs

    entries, out = [], {}
    for label, o, dirs in (("first pass", tap, d3), ("bounce round", bounce, bd3)):
        n = dirs.shape[0]
        unequal = {}
        for case, (oo, dd) in (("rows", (o, dirs)), ("planted", planted(o, dirs))):
            want = F.combine_reference(tp, ts, oo, dd)
            got = F.combine_kernel(tp, ts, oo, dd)
            torch.cuda.synchronize()
            for name, a, b in zip(("color", "cont", "atten", "ro", "rd"), got, want):
                if a.dtype == torch.bool:
                    bad = a != b
                else:
                    bad = ((bits(a) != bits(b)) & ~(torch.isnan(a) & torch.isnan(b))).any(-1)
                unequal[f"{case} {name}"] = int(bad.sum())
        log(f"  {label} ({n} lanes): lanes not bit-equal {unequal}")
        if any(unequal.values()):
            raise AssertionError(f"the combine kernel against combine_reference on the {label}: {unequal}")
        ms, _ = time_events(lambda i: F.combine_kernel(tp, ts, o, dirs), 20, 3)
        q = queued_ms(lambda: F.combine_kernel(tp, ts, o, dirs), 20, busy)
        plain_ms, _ = time_events(lambda i: F.combine_reference(tp, ts, o, dirs), 20, 3)
        plain_q = queued_ms(lambda: F.combine_reference(tp, ts, o, dirs), 20, busy)
        b = bound(n * COMBINE_BYTES, n * OPS_COMBINE)
        log(f"  {label}: {ms:.4f} ms per call, {q:.4f} ms queued; plain (combine_reference) {plain_ms:.4f} ms per "
            f"call, {plain_q:.4f} ms queued; bound {b[0]:.4f} ms ({b[1]}; bytes {b[2]:.4f}, operations {b[3]:.4f}): "
            f"{100 * b[0] / q:.1f}% of it queued")
        out[label] = {"lanes": n, "ms": ms, "queued_ms": q, "plain_ms": plain_ms, "plain_queued_ms": plain_q,
                      "bound_ms": b[0]}
        entries.append({**kernel_entry(
            f"combine (combine_outputs after K1: bitmap and cubemap texels planned, fetched and blended, the "
            f"bounce state; the DoF + cubemap frame's {label}, {n} lanes)",
            "chess2rt_tpu_torch/csrc/combine.cu",
            "none: the renderers' glue after K1 (chess2rt_tpu/ops/pallas_trace.py combine_outputs, XLA)",
            calls["DoF + cubemap"]["kernel"] if label == "first pass" else None, 0.0, ms, plain_ms, *b),
            "queued_ms": q, "plain_queued_ms": plain_q})
    log(json.dumps({"combine": out, "calls": calls}))
    return entries


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-frame"]:
        sys.exit(first_frame_split(*sys.argv[2:5]))
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
