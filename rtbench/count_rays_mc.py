"""Counts a Monte-Carlo frame's rays by kind (camera, shadow, bounce) with the
reference, at a configuration's frame size, for the ``rays`` entry of its
``frames`` section (which ``k1_roofline_pct.frame`` reads):

    python3 -m rtbench.count_rays_mc --config <name> --traffic <name> [--seed <n>] [--device cuda]

``count_rays.py`` counts through the reference's ``stats``, which
``render_samples`` passes on only outside the Monte-Carlo modes: under DoF
it counts the camera rays alone.  Here every pass of the frame (each AA tap's
DoF samples, both eyes of a stereo pair) goes through ``render_samples``'
``trace_fn`` hook into the reference's own Whitted rounds with a counter of
their own, so the shadow and bounce rays of each pass are counted too: shadow
rays one per lit shading point and light, bounce rays the live lanes of
every round after the first, camera rays every pass's primary rays.  A round
whose lanes are all dead adds nothing, so the rounds stop at the first.  The
frame's key stream is the reference frame's (``_render_pixels``: the base
sample, then the four AA taps), so the rays counted are the rays it traces.
The counts are the mean per frame over one round of the traffic's camera
walk (its first P items, one per pose), which is what a traced run's P items
render; the seed moves only texels and the ~1e-4 jitter.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import check, generator, harness
from .reference import pipeline as RPL
from .reference import prng
from .reference.camera import begin_frame
from .reference.packed import REFLECTION, REFRACTION


def _counted_rounds(static, stats):
    """A ``trace_fn`` for ``render_samples``: ``trace_whitted``'s rounds at
    full width, counting into ``stats``, stopping at the first dead round."""

    def trace(packed, orig, dir, _stats=None):
        recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
        rounds = (static.max_trace_depth + 1) if recursive else 1
        carry = (torch.zeros_like(orig), torch.ones_like(orig),
                 torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device), orig, dir)
        RPL._count(stats, "camera", float(orig[..., 0].numel()))
        for r in range(rounds):
            if not bool(carry[2].any()):
                break
            carry = RPL._whitted_round(packed, static, *carry, recursive, stats, r)
        return carry[0]

    return trace


def frame_rays(packed, static, key) -> dict:
    """{kind: rays} of one un-chunked frame rendered under ``key``."""
    if static.chunk_pixels:
        raise ValueError("count_rays_mc counts un-chunked frames")
    stats = {}
    trace = _counted_rounds(static, stats)
    dt, W, H = packed.dtype, static.width, static.height
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=packed.device),
                            torch.arange(W, dtype=dt, device=packed.device), indexing="ij")
    xf, yf = xs.reshape(-1), ys.reshape(-1)
    frame = begin_frame(packed.camera, W / H, compensated=static.compensated_raygen)
    key, k0 = prng.split(prng.as_key(key))
    RPL.render_samples(packed, static, frame, xf, yf, k0, trace_fn=trace)
    if static.aa_enabled:
        for off in RPL._offsets(xf):
            key, kk = prng.split(key)
            RPL.render_samples(packed, static, frame, xf + off[0], yf + off[1], kk, trace_fn=trace)
    return {k: float(v) for k, v in stats.items()}


def count(config: dict, traffic: dict, seed: int, device) -> dict:
    mode = config["frames"]
    inputs = generator.Inputs(seed, traffic, check.camera_basis(config, mode))
    total = {}
    with check.exact_float32(), torch.no_grad():
        packed, static = check.reference_scene(config, mode, seed, device)
        for i in range(len(inputs.poses)):
            key, jit = inputs.item(i)
            for k, v in frame_rays(check._moved(packed, jit), static, key).items():
                total[k] = total.get(k, 0.0) + v
    return {k: int(round(v / len(inputs.poses))) for k, v in sorted(total.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.count_rays_mc")
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
