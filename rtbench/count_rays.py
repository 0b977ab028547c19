"""Counts a frame's rays by kind (camera, shadow, bounce) with the
reference, at a configuration's frame size, for the ``rays`` entry of its
``frames`` section (which ``k1_roofline_pct.frame`` reads):

    python3 -m rtbench.count_rays --config <name> --traffic <name> [--seed <n>] [--device cuda]

Camera rays are the AA taps' (and paths') primary rays; shadow rays one per
shaded lane and light; bounce rays the live lanes of every round after the
first (Whitted: mirror continuations; GI: the paths' next bounces).  The
counts are the mean per frame over one round of the traffic's camera walk
(its first P items, one per pose), which is what a traced run's P items
render; the seed moves only texels and the ~1e-4 jitter.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import check, generator, harness
from .reference import pipeline as RPL


def count(config: dict, traffic: dict, seed: int, device) -> dict:
    mode = config["frames"]
    inputs = generator.Inputs(seed, traffic, check.camera_basis(config, mode))
    total = {}
    with check.exact_float32(), torch.no_grad():
        packed, static = check.reference_scene(config, mode, seed, device)
        for i in range(len(inputs.poses)):
            key, jit = inputs.item(i)
            stats = {}
            RPL.render_frame(check._moved(packed, jit), static, key, stats)
            for k, v in stats.items():
                total[k] = total.get(k, 0.0) + float(v)
    return {k: int(round(v / len(inputs.poses))) for k, v in sorted(total.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.count_rays")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rays = count(harness.load_config(args.config), generator.load_traffic(args.traffic), args.seed,
                 torch.device(args.device))
    print(json.dumps({"config": args.config, "traffic": args.traffic, "rays": rays}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
