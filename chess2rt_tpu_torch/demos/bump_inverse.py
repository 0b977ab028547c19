"""Inverse rendering THROUGH the bump extension, the twin of
demos/bump_inverse.py: recover the BumpTexture strength and a surface
albedo from a target image, on the card, through the bump hybrid
(ops/bump_round0.py: the fast forward over K1's residual form, the
tangent-carrying leaf-pinned reshade backward).

Scene: ``scenes.bump_scene(mirror=False, bump_csg=False, aa=False)``, the
demos/bump_probe.py coverage scene with the CSG node left un-bumped, so
the hybrid takes its FAST forward (``_fast_bump_ok``) — the fit exercises
exactly the production bump path.  The demo perturbs ``bump_strength``
(x0.3) and the shared Lambert albedo (x0.6), recovers both with Adam on
pixel L2, and finishes with a central-difference check on the strength
scale (strength enters the perturbed normal linearly and the texel picks
don't depend on it, so with a fixed key the loss is a smooth
deterministic function of it).

    python -m chess2rt_tpu_torch.demos.bump_inverse                # the card
    python -m chess2rt_tpu_torch.demos.bump_inverse --device cpu

Exits nonzero unless both parameters recover.
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
from ..ops import prng
from ..ops.bump_round0 import _fast_bump_ok
from ..render.pipeline import render_frame
from ..scenes import bump_scene


def fd_check(packed, static, key):
    """Central-difference check of d(loss)/d(bump-strength scale): the
    autodiff side is the directional derivative along bump_strength (dL/ds
    at s=1 == <dL/dstrength, strength>), the gradient the fit follows."""

    def loss(p):
        return (render_frame(p, static, key) ** 2).mean()

    strength = packed.bump_strength.detach().clone().requires_grad_()
    loss(dataclasses.replace(packed, bump_strength=strength)).backward()
    g = float((strength.grad * packed.bump_strength).sum())
    # h must stay under the cos_t > 0 kink spacing: unlike light power
    # (linear in the shading), strength moves lighting CUTOFF thresholds,
    # so the loss is piecewise-smooth; the JAX demo's measured ladder at
    # 160x120 converged at 3e-4
    h = 3e-4
    with torch.no_grad():
        fd = (
            float(loss(dataclasses.replace(packed, bump_strength=packed.bump_strength * (1.0 + h))))
            - float(loss(dataclasses.replace(packed, bump_strength=packed.bump_strength * (1.0 - h))))
        ) / (2 * h)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    print(f"FD check (bump strength): autodiff {g:.6e} vs central-diff {fd:.6e} (rel {rel:.2e})")
    return rel < 2e-2 and g != 0.0, rel


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chess2rt_tpu_torch.demos.bump_inverse")
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None, help="torch device (default: the current CUDA device; cpu)")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))

    packed, static = pack_scene(bump_scene(TT, w, h, mirror=False, bump_csg=False, aa=False), device=args.device)
    if not _fast_bump_ok(static):
        raise AssertionError("demo scene must take the fast bump forward")
    key = prng.PRNGKey(7)
    with torch.no_grad():
        target = render_frame(packed, static, key)
    print(f"# device {packed.device}; {w}x{h}, bump hybrid fast path")

    wrong = dataclasses.replace(
        packed,
        bump_strength=packed.bump_strength * 0.3,
        mat_color=packed.mat_color * 0.6,
    )

    log = lambda i, l: (i % 25 == 0) and print(f"step {i}: loss {l:.3e}")  # noqa: E731
    prob = InverseProblem(
        static=static, target=target,
        train_fields=("bump_strength", "mat_color"),
        learning_rate=2e-2, steps=args.steps,
        # strength is O(8) while albedo is O(1): matching Adam scale
        update_scales={"bump_strength": 4.0},
    )
    t0 = time.perf_counter()
    fitted, losses = fit(wrong, prob, key=key, on_step=log)
    dt = time.perf_counter() - t0

    bumped = torch.tensor([ns.bump_idx >= 0 for ns in static.nodes], device=packed.device)
    err_strength = float(
        (fitted.bump_strength - packed.bump_strength).abs()[bumped].max()
        / packed.bump_strength.abs()[bumped].max()
    )
    err_albedo = float((fitted.mat_color - packed.mat_color).abs().max())
    print(
        f"loss {losses[0]:.3e} -> {losses[-1]:.3e}; bump strength rel err "
        f"{err_strength:.4f}; albedo err {err_albedo:.4f}"
    )

    fd_ok, fd_rel = fd_check(packed, static, key)
    ok = (
        losses[-1] < losses[0] * 0.02
        and err_strength < 0.02
        and err_albedo < 0.02
        and fd_ok
    )
    print("RECOVERED" if ok else "FAILED")
    return {"ok": ok, "fd_ok": fd_ok, "fd_rel": fd_rel, "losses": losses, "step_ms": 1e3 * dt / max(len(losses), 1),
            "err_strength": err_strength, "err_albedo": err_albedo}


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
