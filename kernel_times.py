#!/usr/bin/env python3
"""Times the port's two hand-written kernels alone, beside an earlier commit's.

    python kernel_times.py [--parent DIR] [--rounds 3] [--reps 20]

from the repository root, on a machine with an NVIDIA card and nvcc.  A tool
beside chip_smoke.py, whose helpers it uses; not part of the package.

K1 (chess2rt_tpu_torch/csrc/round0.cu) is timed on the five shapes the main
paths give it (the 1080p screen tap, the bounce round of that tap's
block-compacted rays, the 640x480 residual tap with want_hit and want_vis,
one lin-input shard tap of a quarter of the 1080p frame, and the want_hit
ray-input form without the vis rows on the 640x480 GI stand-in's jittered
camera rays, the GI frame's bounce) and on 1080p taps
of the two CSG stress scenes, whose hit lists live in shared memory (the
stand-in's four-hit nodes merge in registers).  K2 (csrc/texel_hist.cu) is
timed on the 640x480 gradient step's own sorted texel cotangents, the tap's
and the bounce round's, beside one ``index_add_`` call.

With ``--parent DIR`` the package of an earlier commit, unpacked so that
``DIR/c2rt_parent`` is its ``chess2rt_tpu_torch`` directory (the package
uses relative imports only), is timed in the same process on the same
inputs; kernels compared across commits must share a process, because the
card's clocks differ between runs.

A time is milliseconds per launch of ``--reps`` launches queued back to back
behind a long matrix product (``chip_smoke.queued_ms``: the kernel alone,
not the wrapper's host work).  The packages take turns, ``--rounds`` times,
and the median round is printed, then one JSON object with every number,
the registers, stack and spills of this tree's builds, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import os
import statistics
import sys

import chip_smoke

THIS, PARENT = "chess2rt_tpu_torch", "c2rt_parent"


def k1_runs(pkg, dev, rays=None):
    """({shape: closure that launches ``pkg``'s K1 on it}, {"bounce": the
    bounce round's (orig, dir), "gi": the GI camera rays}).  Without
    ``rays`` they are made from this package's 1080p tap and GI stand-in."""
    T = importlib.import_module(f"{pkg}.models.types")
    pack_scene = importlib.import_module(f"{pkg}.models.packed").pack_scene
    R = importlib.import_module(f"{pkg}.ops.round0")
    scenes = importlib.import_module(f"{pkg}.scenes")
    w, h = chip_smoke.WIDTH, chip_smoke.HEIGHT

    tp, ts = pack_scene(scenes.flagship_standin(T, w, h), device=dev)
    lay = R.layout(ts, w, h)
    prm = lay.pack(tp, chip_smoke.AA)
    rays = rays or {"bounce": chip_smoke.bounce_rays(tp, ts, R.round0(lay, prm))[:2]}
    o3, d3 = rays["bounce"]
    lanes = w * h // chip_smoke.MESH_ENTRIES
    prm_lin = lay.pack(tp, chip_smoke.AA, lanes)
    gw, gh = chip_smoke.GRAD_SIZE
    gp, gs = pack_scene(scenes.flagship_standin(T, gw, gh), device=dev)
    glay = R.layout(dataclasses.replace(gs, aa_enabled=False), gw, gh, want_hit=True, want_vis=True)
    gprm = glay.pack(gp)
    runs = {
        f"{w}x{h} tap": lambda: R.round0(lay, prm),
        f"bounce round, {o3.shape[0]} rays": lambda: R.round0(lay, prm, o3, d3),
        f"{gw}x{gh} residual tap": lambda: R.round0(glay, gprm),
        f"shard tap, {lanes} lanes": lambda: R.round0(lay, prm_lin, lin_input=True, n_lanes=lanes),
    }
    if hasattr(scenes, "gi_standin"):  # an earlier commit may not have it
        iw, ih = chip_smoke.GI_SIZE
        ip, its = pack_scene(scenes.gi_standin(T, iw, ih), device=dev)
        ilay = R.layout(its, iw, ih, want_hit=True)
        rays.setdefault("gi", chip_smoke.gi_camera_rays(ip, iw, ih, 23))
        gi_o, gi_d = rays["gi"]
        iprm = ilay.pack(ip)
        runs[f"{iw}x{ih} GI want_hit rays"] = lambda: R.round0(ilay, iprm, gi_o, gi_d)
    placements = ("shared", "global") if "placement" in inspect.signature(R.round0).parameters else (None,)
    for kind in ("deep16", "nested_diff", "deep40", "diff_nest") if hasattr(scenes, "csg_stress_scene") else ():
        try:
            sp, ss = pack_scene(scenes.csg_stress_scene(T, kind, w, h), device=dev)
        except ValueError:  # a scene an earlier commit does not have
            continue
        slay = R.layout(ss, w, h)
        for pl in placements:
            label = f"{kind} {w}x{h} tap" + (f" ({pl} lists)" if pl and pl != "shared" else "")
            kw = {"placement": pl} if pl else {}
            runs[label] = lambda slay=slay, sprm=slay.pack(sp), kw=kw: R.round0(slay, sprm, **kw)
    return runs, rays


def median_rounds(runs_by_label, rounds, reps, busy):
    """{label: {shape: median over the rounds of queued ms}}; the labels
    take turns within a round."""
    times = {label: {shape: [] for shape in runs} for label, runs in runs_by_label.items()}
    for _ in range(rounds):
        for label, runs in runs_by_label.items():
            for shape, run in runs.items():
                run()
                times[label][shape].append(chip_smoke.queued_ms(run, reps, busy))
    return {label: {shape: statistics.median(v) for shape, v in by_shape.items()} for label, by_shape in times.items()}


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory that holds an earlier commit's package as c2rt_parent/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.ROOT)
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.models import types as T
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import texel_hist as K2
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import flagship_standin

    dev = torch.device(chip_smoke.DEVICE)
    card = chip_smoke.gpu_line()
    print(f"card: {card}", flush=True)
    cuda_build.load_all()
    result = {"card": card, "reps": args.reps, "rounds": args.rounds,
              "ptxas": {name: cuda_build.ptxas_usage(name) for name in cuda_build.SOURCES}}
    busy = torch.ones((8192, 8192), dtype=torch.float32, device=dev)

    # ---- K1 ----------------------------------------------------------------
    runs, rays = k1_runs(THIS, dev)
    by_label = {"this tree": runs}
    if args.parent:
        sys.path.insert(0, os.path.abspath(args.parent))
        parent_runs, _ = k1_runs(PARENT, dev, rays)
        by_label["parent"] = parent_runs
    result["k1"] = median_rounds(by_label, args.rounds, args.reps, busy)
    print(f"K1, ms per launch queued back to back (median of {args.rounds} rounds)")
    for label, med in result["k1"].items():
        print("  " + label.ljust(10) + " | ".join(f"{shape}: {ms:.4f}" for shape, ms in med.items()), flush=True)

    # ---- K2 ----------------------------------------------------------------
    gw, gh = chip_smoke.GRAD_SIZE
    gp, gs = pack_scene(flagship_standin(T, gw, gh), device=dev)
    gs = dataclasses.replace(gs, aa_enabled=False)
    target = torch.zeros((gh, gw, 3), dtype=torch.float32, device=dev)
    rows = chip_smoke.step_texel_rows(lambda p: render_frame(p, gs), gp, target)
    result["k2"] = {}
    for keys, vals, n_texels in sorted(rows, key=lambda x: -x[0].numel()):
        plain = K2.texel_histogram_reference(keys, vals, n_texels)
        err = (K2.texel_histogram(keys, vals, n_texels) - plain).abs().max().item()
        if err > chip_smoke.K2_LIMIT * max(1.0, plain.abs().max().item()):
            raise AssertionError(f"K2 differs from its plain version by {err:.3e}")
        in_range = (keys >= 0) & (keys < n_texels)
        lib_keys, lib_vals = keys[in_range].long(), vals[in_range]
        by_label = {
            "this tree": {"K2": lambda: K2.texel_histogram(keys, vals, n_texels)},
            "index_add_": {"K2": lambda: torch.zeros_like(plain).index_add_(0, lib_keys, lib_vals)},
        }
        if args.parent:
            parent_k2 = importlib.import_module(f"{PARENT}.ops.texel_hist")
            by_label["parent"] = {"K2": lambda: parent_k2.texel_histogram(keys, vals, n_texels)}
        shape = f"{keys.numel()} x {vals.shape[1]} into {n_texels}"
        result["k2"][shape] = {label: med["K2"]
                               for label, med in median_rounds(by_label, args.rounds, args.reps, busy).items()}
        print(f"K2 on {shape} (max |K2 - plain| {err:.2e}), ms per call queued back to back: "
              + ", ".join(f"{label} {ms:.4f}" for label, ms in result["k2"][shape].items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
