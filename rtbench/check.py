"""How ``correct`` is decided: what the timed path produced against the plain
reference (``rtbench/reference/``), at the timed sizes.

A frame cell keeps a sample of the window's frames, drawn from the seed, as
the client received them (on the host); the reference renders each again from
the same scene description, camera offset and key, and ``px_off`` is the
largest share, over the sampled frames, of pixels whose largest channel
differs by more than ``PIXEL_TOL``.  A step cell keeps a sample of the
window's steps (the loss the client read, the gradients and the frame on the
device); the reference computes each step's loss and gradients again by
autograd through its own frame.  Its numbers are ``loss_gap`` (the relative
gap of the losses), ``grad_gap`` (the median leaf's gap) and ``texel_gap``
(the worst gap of the texel tables, whose gradient K2 sums); see
``step_numbers``.

Each kept item is also held against the reference of the item after it, a
pose of the walk away, and has to fail the cell's limits there: ``vs_next``
is the least, over the kept items, of the largest number / limit against
that other item, and has to exceed 1.  A program that returned a stale item,
or traffic whose items the check could not tell apart, fails it.

The limits are per cell, in ``rtbench/checks/<workload>.json``, each set
between the readings of sound runs (lower) and of the lower-precision
control (upper); PERF.md gives the readings.  ``reference_outputs`` makes
the outputs of the reference itself in any dtype, which is how the control
(bfloat16 in the program's place) is read.
"""

import contextlib
import dataclasses
import json
import os

import torch

from . import scenes
from .reference import packed as RP
from .reference import pipeline as RPL
from .reference import types as RT

HERE = os.path.dirname(os.path.abspath(__file__))
# a pixel counts as off when a channel differs by more than this (the repo's
# frame limit, tests/test_fuzz.py:234-237: d > 2e-3)
PIXEL_TOL = 2e-3
# a leaf whose reference gradient norm is under this share of the median
# leaf's is nought to rounding and is left out of the gradient numbers (the
# atlas rows of absent maps, unused camera settings)
NOUGHT = 1e-3
# the leaves that hold texel tables: the gathers read them, and the program's
# K2 (csrc/texel_hist.cu) sums their gradient
TEXEL_LEAVES = ("bitmap_atlas", "bump_atlas", "env_cubemap")


def load_limits(workload: str) -> dict:
    """``checks/<workload>.json``: {number: {"limit": x, ...}}."""
    with open(os.path.join(HERE, "checks", f"{workload}.json")) as f:
        return json.load(f)["limits"]


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the reference's products, as the plain reference needs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_scene(config: dict, mode: dict, seed: int, device, dtype=None):
    """The reference's own scene from the same description: packed by its
    own packer in the configuration's precision, then rounded to ``dtype``
    (the control's) when that is given."""
    scene = scenes.build_scene(RT, config, mode, seed)
    stated = getattr(torch, config["dtype"])
    packed, static = RP.pack_scene(scene, dtype=stated, device=device)
    static = dataclasses.replace(static, **mode.get("settings", {}))
    if dtype is not None and dtype != stated:
        packed = RP.from_leaves([x.to(dtype) if x.is_floating_point() else x for x in RP.leaves(packed)])
    return packed, static


def _moved(packed, jit):
    pos = packed.camera.pos + torch.as_tensor(jit, dtype=torch.float32, device=packed.device).to(packed.dtype)
    return dataclasses.replace(packed, camera=dataclasses.replace(packed.camera, pos=pos))


def camera_basis(config: dict, mode: dict):
    """(right, up, front) of the configuration's camera, as ``Camera.move``
    takes a session move."""
    return scenes.build_scene(RT, config, mode, 0).camera._basis()


def reference_frame(packed, static, jit, key):
    with torch.no_grad():
        return RPL.render_frame(_moved(packed, jit), static, key)


def reference_step(packed, static, jit, key, target):
    """The step's loss and its gradient in every floating leaf, by autograd
    through the reference frame, in leaf order: (loss, [grads], names)."""
    xs = [x.detach().clone().requires_grad_() if x.is_floating_point() else x for x in RP.leaves(packed)]
    pos_at = RP.LEAF_NAMES.index("camera.pos")
    xs[pos_at] = _moved(packed, jit).camera.pos.detach().requires_grad_()
    loss = ((RPL.render_frame(RP.from_leaves(xs), static, key) - target) ** 2).mean()
    wrt = [x for x in xs if x.requires_grad]
    names = [n for n, x in zip(RP.LEAF_NAMES, xs) if x.requires_grad]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)], names


def frame_numbers(got: torch.Tensor, want: torch.Tensor) -> dict:
    """{"px_off": share of pixels whose largest channel is off by more than
    PIXEL_TOL} of one frame; a frame of another shape, or not finite, is
    wholly off."""
    got = got.to(device=want.device, dtype=torch.float32)
    want = want.to(torch.float32)
    if got.shape != want.shape:
        return {"px_off": 1.0}
    d = (got - want).abs().amax(-1)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    return {"px_off": float((d > PIXEL_TOL).float().mean())}


def step_numbers(got, ref, detail=None) -> dict:
    """One step (loss, grads, leaf names) against the reference's.  A leaf's
    gap is ``|g - g_ref|`` against the larger of its reference norm and the
    median leaf's; leaves whose reference gradient is nought to rounding
    (under NOUGHT of the median leaf's norm) are left out.  ``loss_gap`` is
    the relative gap of the losses; ``grad_gap`` the median leaf's gap,
    because the leaves that move silhouettes (the spheres, the plane, the
    camera, the bitmap scaling) are carried by knife-edge pixels, where two
    sound renderers each give the gradient of the surface they hit, and
    their gaps swing from 1e-3 to 1e2 with the seed; ``texel_gap`` the worst
    ``|g - g_ref| / |g_ref|`` of the TEXEL_LEAVES, the gradient that K2 sums,
    which a median over some 25 leaves would hardly see.  ``detail``, a
    list, receives each leaf's (gap, reference norm)."""
    loss, grads, names = got
    ref_loss, ref_grads, ref_names = ref
    ref = dict(zip(ref_names, ref_grads))
    if set(names) != set(ref):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "texel_gap": float("inf")}
    rl = float(ref_loss)
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    median = float(torch.tensor(sorted(norms.values())).median())
    dist = {n: float(torch.linalg.vector_norm(g.to(ref[n].device).double() - ref[n].double()))
            for n, g in zip(names, grads) if norms[n] >= NOUGHT * median}
    gaps = {n: d / max(norms[n], median) for n, d in dist.items()}
    out = {"loss_gap": abs(float(loss) - rl) / max(abs(rl), 1e-30),
           "grad_gap": float(torch.tensor(list(gaps.values())).median()) if gaps else float("inf"),
           "texel_gap": max((dist[n] / norms[n] for n in dist if n in TEXEL_LEAVES), default=float("inf"))}
    if detail is not None:
        detail.append({n: [gaps[n], norms[n]] for n in gaps})
    return {k: (v if v == v else float("inf")) for k, v in out.items()}


def reference_outputs(indices, loop: str, config: dict, mode: dict, inputs, device, dtype=None):
    """Yields (index, the reference's output) for items ``indices`` of the
    run's ``inputs`` (``generator.Inputs``): a frame, or a step's (loss,
    grads, leaf names); computed in ``dtype`` when that is given (the
    control), else in the configuration's precision."""
    with exact_float32():
        packed, static = reference_scene(config, mode, inputs.seed, device, dtype)
        target = torch.zeros((mode["height"], mode["width"], 3), dtype=packed.dtype, device=packed.device)
        for i in indices:
            key, jit = inputs.item(i)
            if loop == "frames":
                yield i, reference_frame(packed, static, jit, key)
            else:
                yield i, reference_step(packed, static, jit, key, target)


def _numbers(out, ref, loop, detail=None) -> dict:
    return frame_numbers(out, ref) if loop == "frames" else step_numbers(out, ref, detail)


def judge(kept: list, loop: str, config: dict, mode: dict, inputs, device, limits: dict, detail=None) -> dict:
    """The cell's numbers over the kept items [(index, output)]: each
    number's worst over the items, and ``vs_next``.  ``output`` is a frame
    (host or device tensor) or a step's (loss, grads, leaf names).
    ``detail``, a list, receives the step's per-leaf readings."""
    worst = {}
    refs = reference_outputs([i for i, _ in kept], loop, config, mode, inputs, device)
    for (_, out), (_, ref) in zip(kept, refs):
        for k, v in _numbers(out, ref, loop, detail).items():
            worst[k] = max(worst.get(k, 0.0), v)
    ref = None  # the last reference frees before the next ones are made
    nexts = reference_outputs([i + 1 for i, _ in kept], loop, config, mode, inputs, device)
    apart = []
    for (_, out), (_, other) in zip(kept, nexts):
        nums = _numbers(out, other, loop)
        apart.append(max((nums[k] / lim["limit"] for k, lim in limits.items() if k in nums and not lim.get("above")),
                         default=0.0))
    worst["vs_next"] = min(apart, default=0.0)
    return worst


def passes(found: dict, limits: dict) -> bool:
    """Every number within its limit: at most the limit, or above it where
    the limit says ``above``; a number not read fails."""
    for k, lim in limits.items():
        v = found.get(k)
        if v is None or v != v or not (v > lim["limit"] if lim.get("above") else v <= lim["limit"]):
            return False
    return True
