"""Texture recovery: reconstruct bitmap texel values from a rendered image,
the twin of demos/texture_recovery.py.

The showcase for the differentiable texel path (the deferred quad gather
forward, ops/shade.quad_gather_flat, and its backward: a sort, then the
texel-histogram kernel K2, csrc/texel_hist.cu): render the flagship
stand-in (``scenes.flagship_standin``: bitmap floor + bitmap box + mirror,
in place of lecture5.sdl, which is not in the repository) as the target,
replace the texture atlas with flat gray, then recover the visible texels
with Adam on pixel L2 through K1's residual form and the leaf-pinned
backward.

Only texels that the view actually samples receive gradient (standard
inverse rendering); recovery error is therefore reported over the texels
Adam touched, plus the re-rendered image error over ALL pixels.

    python -m chess2rt_tpu_torch.demos.texture_recovery                 # the card
    python -m chess2rt_tpu_torch.demos.texture_recovery --device cpu --size 160x120 --steps 60
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ..grad import InverseProblem, fit
from ..models import types as TT
from ..models.packed import pack_scene
from ..render.pipeline import render_frame
from ..scenes import flagship_standin


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch.demos.texture_recovery")
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu)")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))

    sc = flagship_standin(TT, w, h)
    sc.settings.AAEnabled = False
    packed, static = pack_scene(sc, device=args.device)

    with torch.no_grad():
        target = render_frame(packed, static)
    true_atlas = packed.bitmap_atlas

    # start from flat mid-gray: zero prior knowledge of either bitmap
    wrong = dataclasses.replace(packed, bitmap_atlas=torch.full_like(true_atlas, 0.5))

    prob = InverseProblem(
        static=static,
        target=target,
        train_fields=("bitmap_atlas",),
        learning_rate=args.lr,
        steps=args.steps,
    )
    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}", flush=True)  # noqa: E731
    t0 = time.perf_counter()
    fitted, losses = fit(wrong, prob, on_step=log)
    dt = time.perf_counter() - t0

    # visible-texel mask: texels whose value Adam actually moved
    moved = (fitted.bitmap_atlas - 0.5).abs() > 1e-4
    err = (fitted.bitmap_atlas - true_atlas).abs()
    mae_visible = float(err[moved].mean()) if bool(moved.any()) else float("nan")
    frac = float(moved.double().mean())

    with torch.no_grad():
        img = render_frame(fitted, static)
    img_mae = float((img - target).abs().mean())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e} in {len(losses)} steps "
        f"({dt:.1f}s, {1000*dt/len(losses):.1f} ms/step incl host loop); "
        f"visible texels {100*frac:.1f}% of atlas, MAE {mae_visible:.4f}; "
        f"re-rendered image MAE {img_mae:.5f}",
        flush=True,
    )
    ok = losses[-1] < losses[0] * 0.02 and mae_visible < 0.08 and img_mae < 0.01
    print("RECOVERED" if ok else "FAILED")
    return {"ok": ok, "losses": losses, "step_ms": 1e3 * dt / max(len(losses), 1), "mae_visible": mae_visible,
            "visible_frac": frac, "visible": moved.cpu().numpy(), "img_mae": img_mae}


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
