"""Inverse rendering: recover scene parameters from a target image.

Counterpart of chess2rt_tpu/grad/inverse.py: Adam on the pixel L2 loss
``((render_frame(p) - target) ** 2).mean()``, with gradients through the
differentiable flagship frame (ops/round0_grad.py, ops/shade.py) to the
trained ScenePacked leaves.  Discrete decisions (closest-hit winner, shadow
bits, checker parity) are piecewise constant, so their gradients are zero
(SURVEY.md §7.0).

Where the JAX package masked the untrained fields' gradients to zero and
ran optax Adam over every leaf, here only the trained leaves require grad
and sit in the optimizer: the same updates, since Adam's update of a zero
gradient is zero.  ``update_scales`` becomes a per-field learning rate
(Adam's update is linear in it), ``lr_decay_to`` the non-staircase
``optax.exponential_decay``.  A Monte-Carlo frame (DoF, stereo) draws
from ``key`` (ops/prng.py, None is ``PRNGKey(0)``): step i renders with
``fold_in(key, i)`` when ``resample_keys`` is on (the default: SGD on the
expected loss), else with ``key`` every step (the render becomes a smooth
deterministic function of the parameters), as in JAX.  With
``problem.mesh`` set, each step is ``parallel.make_sharded_value_and_grad``
over that mesh (the shards' gradients summed, across processes too), with
the same keys and checkpoints: every process saves its own (as in JAX), and
across processes all must resume at the same step.  The JAX option that steers TPU machinery
(``auto_pallas``) is not carried.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch

from ..models.packed import LEAF_NAMES, ScenePacked, SceneStatic, from_leaves, leaves
from ..ops import prng
from ..parallel import distributed as D
from ..render.pipeline import render_frame
from .checkpoint import load_checkpoint, save_checkpoint


@dataclass
class InverseProblem:
    """Configuration for a fit() run."""

    static: SceneStatic
    target: torch.Tensor  # [H, W, 3] float, on the scene's device
    train_fields: Sequence[str] = ("mat_color", "sphere_center")  # LEAF_NAMES keys (camera.* too)
    learning_rate: float = 1e-2
    steps: int = 200
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 50
    mesh: object = None  # a parallel.make_mesh / make_mesh_2d mesh: fit sharded over it
    # per-field multipliers of the Adam updates (effective step size
    # learning_rate * scale), for fields on very different scales
    update_scales: Optional[dict] = None
    # final-lr fraction of an exponential decay over `steps` (1.0: constant)
    lr_decay_to: float = 1.0
    # True: step i renders with fold_in(key, i); False: with key every step
    resample_keys: bool = True


def make_optimizer(params: Dict[str, torch.Tensor], problem: InverseProblem):
    """optax.adam's update (betas 0.9/0.999, eps 1e-8) over ``params`` ({train
    field: tensor}) with the problem's per-field ``update_scales``.  Returns
    (optimizer, schedule): ``schedule(step)`` sets every field's learning
    rate for that step, ``lr * scale * lr_decay_to ** (step / steps)``."""
    scales = dict(problem.update_scales or {})
    if set(scales) - set(params):
        raise ValueError(f"fit: update_scales for untrained fields {sorted(set(scales) - set(params))}")
    lr = problem.learning_rate
    opt = torch.optim.Adam(
        [{"params": [p], "lr": lr * scales.get(k, 1.0)} for k, p in params.items()],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
    )
    base_lrs = [g["lr"] for g in opt.param_groups]

    def schedule(step: int) -> None:
        decay = problem.lr_decay_to ** (step / max(problem.steps, 1))
        for g, base in zip(opt.param_groups, base_lrs):
            g["lr"] = base * decay

    return opt, schedule


def fit(
    packed: ScenePacked,
    problem: InverseProblem,
    key=None,
    on_step: Optional[Callable[[int, float], None]] = None,
):
    """Adam on pixel L2.  Returns (packed_optimized, losses)."""
    key = prng.as_key(key)
    trained = tuple(problem.train_fields)
    unknown = set(trained) - set(LEAF_NAMES)
    if unknown:
        raise ValueError(f"fit: unknown train_fields {sorted(unknown)}")
    static, target = problem.static, problem.target
    if "bitmap_atlas" not in trained and static.train_textures:
        # texel cotangents are the costliest part of the backward; with the
        # atlas untrained they would be thrown away, so stop them at the source
        static = dataclasses.replace(static, train_textures=False)

    xs = {k: v.detach().clone().requires_grad_(k in trained) for k, v in zip(LEAF_NAMES, leaves(packed))}
    packed = from_leaves(list(xs.values()))
    opt, schedule = make_optimizer({k: xs[k] for k in trained}, problem)
    start = 0
    if problem.checkpoint_path and os.path.exists(problem.checkpoint_path):
        start = load_checkpoint(problem.checkpoint_path, packed, opt)

    if problem.mesh is not None:
        from ..parallel.mesh import make_sharded_value_and_grad

        vg = make_sharded_value_and_grad(static, problem.mesh)
        if getattr(problem.mesh, "ranks", None) is not None:
            # a mesh across processes: every process saved its checkpoint
            # (shared or not), and all must resume at the same step, or
            # each step would sum gradients of different parameters
            starts = D.gather(start)
            if len(set(starts)) > 1:
                raise RuntimeError(f"fit: the processes resume at steps {starts}; each needs the same "
                                   f"checkpoint at {problem.checkpoint_path}")

    losses = []
    for i in range(start, problem.steps):
        schedule(i)
        opt.zero_grad(set_to_none=True)
        step_key = prng.fold_in(key, i) if problem.resample_keys else key
        if problem.mesh is None:
            loss = ((render_frame(packed, static, step_key) - target) ** 2).mean()
            loss.backward()
        else:
            loss, grads = vg(packed, target, step_key)
            for k, g in zip(LEAF_NAMES, leaves(grads)):
                if k in trained:
                    xs[k].grad = g.to(xs[k].device)
        opt.step()
        losses.append(loss.item())
        if on_step:
            on_step(i, losses[-1])
        if problem.checkpoint_path and (i + 1) % problem.checkpoint_every == 0:
            save_checkpoint(problem.checkpoint_path, packed, opt, step=i + 1)

    return from_leaves([x.detach() for x in xs.values()]), losses
