"""Scaling recipe, the twin of demos/pod_scaling.py: rays/s of the sharded
forward frame and of the sharded value-and-grad step at 1, 2, 4, ... mesh
entries, and efficiency against one.

ONE command, run identically in every process of a launch (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT in the environment; one process
without them):

    python -m chess2rt_tpu_torch.demos.pod_scaling --out SCALING.json

What it does:
  1. brings up torch.distributed from the launcher's environment
     (``parallel.distributed.initialize_distributed``; nothing without it),
  2. builds the flagship stand-in (``scenes.flagship_standin``: CSG, two
     bitmaps, the mirror sphere, depth 5, AA 5, at 1920x1080 by default)
     with block-compacted bounces,
  3. measures the sharded forward frame (``make_sharded_render_fn``: K1's
     lin-input form per shard) and the sharded value-and-grad step
     (``make_sharded_value_and_grad``: AA off, the shards' gradients
     summed) at mesh sizes 1, 2, 4, ... N,
  4. prints rays/s (``utils.diagnostics.frame_ray_stats``' counts over the
     best of ``--repeats`` wall times) and efficiency against one entry per
     size and, in the first process, writes the JSON artifact
     (the JAX package's SCALING_cpu.json shape).

The mesh takes N entries of the devices there are: every device of every
process after a multi-process bring-up (sizes below N take the first
entries), else the visible cards (``--device``: that device), repeated
round-robin when ``--devices`` exceeds them.  Entries that share a device
render one after the other, so their efficiency measures the sharding's
overhead, not added hardware; the artifact's ``note`` says so.

    python -m chess2rt_tpu_torch.demos.pod_scaling --device cpu --devices 2 --size 32x24 --repeats 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..models import types as TT
from ..models.packed import leaves, pack_scene
from ..ops import prng
from ..parallel import GridMesh, distributed, make_mesh, make_sharded_render_fn, make_sharded_value_and_grad
from ..scenes import flagship_standin
from ..utils.diagnostics import frame_ray_stats


def _meshes(counts, device):
    """{count: mesh} over the devices there are (see the module's text),
    and the number of distinct devices behind the largest."""
    spread = distributed.global_devices()
    if spread is not None:
        if counts[-1] > len(spread):
            raise ValueError(f"pod_scaling: {counts[-1]} devices asked, {len(spread)} in the launch")
        return {c: GridMesh((c,), tuple(d for _, d in spread[:c]), tuple(r for r, _ in spread[:c]))
                for c in counts}, len(spread)
    devices = list(make_mesh(None if device is None else [device]))
    return {c: make_mesh([devices[i % len(devices)] for i in range(c)]) for c in counts}, len(devices)


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch.demos.pod_scaling")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--devices", type=int, default=None,
                    help="the largest mesh (default: every device of the launch, or every visible card)")
    ap.add_argument("--device", default=None, help="torch device (default: the visible cards; cpu)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="the first process writes the JSON artifact here")
    args = ap.parse_args(argv)

    info = distributed.initialize_distributed(local_devices=[args.device] if args.device else None)
    if distributed.is_primary():
        print(f"# runtime: {info}", file=sys.stderr)

    w, h = (int(v) for v in args.size.split("x"))
    n_max = args.devices or info["global_devices"]
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64, 128, 256) if c <= n_max]
    if counts[-1] != n_max:
        counts.append(n_max)
    meshes, n_distinct = _meshes(counts, args.device)
    home = meshes[1].entries[0] if isinstance(meshes[1], GridMesh) else meshes[1][0]

    packed, static = pack_scene(flagship_standin(TT, w, h), device=home)
    static = dataclasses.replace(
        static,
        fast_forward=True,
        bounce_capacity=max(w * h // 16, 8192),
        bounce_mode="block",
    )
    static_grad = dataclasses.replace(static, aa_enabled=False, fast_forward=False)
    total_rays = frame_ray_stats(packed, static)["total"]
    grad_rays = frame_ray_stats(packed, static_grad)["total"]
    key = prng.PRNGKey(0)
    target = torch.zeros((h, w, 3), dtype=torch.float32, device=home)

    modes = {"forward": [], "grad": []}
    base = {}
    for c in counts:
        render = make_sharded_render_fn(static, meshes[c])
        vg = make_sharded_value_and_grad(static_grad, meshes[c])

        def run_fwd(k):
            with torch.no_grad():
                return float(render(packed, k).sum())

        def run_grad(k):
            loss, grads = vg(packed, target, k)
            # touch every leaf, so the whole backward is waited for
            return float(loss) + 0.0 * sum(float(g.sum()) for g in leaves(grads) if g.is_floating_point())

        for mode, step, rays in (("forward", run_fwd, total_rays), ("grad", run_grad, grad_rays)):
            if not abs(step(key)) >= 0.0:  # warm (the kernels' builds) + a finite checksum
                raise AssertionError(f"pod_scaling: the {mode} pass at {c} devices is not finite")
            times = []
            for i in range(args.repeats):
                t0 = time.perf_counter()
                step(prng.fold_in(key, i + 1))
                times.append(time.perf_counter() - t0)
            dt = min(times)
            rate = rays / dt
            base.setdefault(mode, rate)
            row = {
                "devices": c,
                "mode": mode,
                "rays_per_sec": round(rate, 1),
                "step_ms": round(dt * 1000, 2),
                "efficiency": round(rate / (base[mode] * c), 3),
            }
            modes[mode].append(row)
            if distributed.is_primary():
                print(json.dumps(row))

    on_card = home.type == "cuda"
    result = {
        "platform": "gpu" if on_card else "cpu",
        "device": torch.cuda.get_device_name(home) if on_card else "cpu",
        "size": args.size,
        "note": (f"{counts[-1]} mesh entries over {n_distinct} distinct device(s): entries that share a device "
                 f"render one after the other, so efficiency bounds the sharding's overhead, not added hardware"
                 if counts[-1] > n_distinct else ""),
        "modes": modes,
    }
    if distributed.is_primary():
        f, g = modes["forward"][-1], modes["grad"][-1]
        print(
            f"# forward {f['rays_per_sec']/1e6:.1f}M rays/s @ {counts[-1]} devices (eff {f['efficiency']}); "
            f"grad step {g['step_ms']} ms (eff {g['efficiency']})",
            file=sys.stderr,
        )
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(result, fh, indent=1)
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
