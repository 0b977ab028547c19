"""Inverse rendering demo (BASELINE config #5), the twin of
demos/inverse_render.py.

Renders a target frame from lecture4 + a red sphere, perturbs material
colors and the sphere positions, then recovers them with Adam on pixel L2
— optionally sharded over every visible card (--distributed).  Prints
recovery errors; exits nonzero on failure.  lecture4.sdl is not in the
repository: its floor and light come from ``scenes.gi_standin(gi=False)``.

    python -m chess2rt_tpu_torch.demos.inverse_render                 # the card
    python -m chess2rt_tpu_torch.demos.inverse_render --device cpu
    python -m chess2rt_tpu_torch.demos.inverse_render --distributed   # every card
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
from ..scenes import gi_standin


def scene(T, w: int, h: int):
    """lecture4's floor and light with the demo's red ball, AA off, built
    from either package's ``models.types`` module ``T``."""
    sc = gi_standin(T, w, h, gi=False)
    sc.nodes.append(
        T.Node(
            name="ball",
            geometry=T.Sphere(name="b", center=(0.0, 60.0, 350.0), R=40.0),
            shader=T.Lambert(name="red", color=(0.9, 0.1, 0.1)),
        )
    )
    return sc


def perturb(packed):
    """Material colors x0.4, every sphere shifted 10 units along x (~0.7 px
    at the ball's distance).  Light power is left alone: color x power is a
    non-identifiable product."""
    shift = torch.tensor([[10.0, 0.0, 0.0]], dtype=packed.sphere_center.dtype, device=packed.device)
    return dataclasses.replace(
        packed,
        mat_color=packed.mat_color * 0.4,
        checker_c2=packed.checker_c2 * 0.4,
        sphere_center=packed.sphere_center + shift,
    )


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch.demos.inverse_render")
    ap.add_argument("--size", default="64x48")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path prefix: each of the six fits saves and resumes at PREFIX.<phase>.<fields>")
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu)")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))

    sc = scene(TT, w, h)
    packed, static = pack_scene(sc, device=args.device)
    with torch.no_grad():
        target = render_frame(packed, static)
    wrong = perturb(packed)

    mesh = None
    if args.distributed:
        from ..parallel import make_mesh

        mesh = make_mesh(None if args.device is None else [args.device])
        print(f"mesh: {len(getattr(mesh, 'entries', mesh))} devices")

    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}")  # noqa: E731

    # Alternate color and geometry phases (block-coordinate descent):
    # colors take small steps, positions move in world units and need a
    # ~10x larger step; alternating stops either from overfitting to the
    # other's current error.
    losses = []
    fitted = wrong
    color_prob = InverseProblem(
        static=static, target=target, train_fields=("mat_color", "checker_c2"),
        learning_rate=5e-2, steps=args.steps // 3, mesh=mesh,
    )
    pos_prob = dataclasses.replace(color_prob, train_fields=("sphere_center",), learning_rate=0.5)
    t0 = time.perf_counter()
    for phase in range(3):
        for name, prob in (("color", color_prob), ("position", pos_prob)):
            if args.checkpoint:
                prob = dataclasses.replace(prob, checkpoint_path=f"{args.checkpoint}.{phase}.{name}")
            fitted, part = fit(fitted, prob, on_step=log)
            losses += part
        print(f"-- alternation {phase}: loss {losses[-1]:.3e}")
    dt = time.perf_counter() - t0

    # the floor's mat_color never touches the image (checker-textured,
    # shader.d:74-76) and keeps zero gradient — compare the ball's only
    ball_idx = len(sc.nodes) - 1
    err_color = float((fitted.mat_color[ball_idx] - packed.mat_color[ball_idx]).abs().max())
    err_checker = float((fitted.checker_c2 - packed.checker_c2).abs().max())
    err_pos = float((fitted.sphere_center - packed.sphere_center).abs().max())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}; ball color err {err_color:.3f}; "
        f"checker err {err_checker:.3f}; sphere pos err {err_pos:.2f} (from 10.0)"
    )
    ok = losses[-1] < losses[0] * 0.05 and err_color < 0.1 and err_checker < 0.1 and err_pos < 5.0
    print("RECOVERED" if ok else "FAILED")
    return {"ok": ok, "losses": losses, "step_ms": 1e3 * dt / max(len(losses), 1), "err_color": err_color,
            "err_checker": err_checker, "err_pos": err_pos}


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
