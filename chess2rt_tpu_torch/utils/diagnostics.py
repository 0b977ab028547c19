"""Observability and safety sweeps.

Counterpart of chess2rt_tpu/utils/diagnostics.py.  The reference's
introspection is a click-to-inspect pixel dump and wall-clock runs; here:

* ``wavefront_occupancy``: the live-lane fraction entering each wavefront
  round, the wavefront's efficiency;
* ``frame_ray_stats``: the traced-ray counters (camera, shadow, bounce) of
  one frame, for rays/s;
* ``assert_deterministic``: the same key gives a bit-identical frame (the
  reference seeds libc rand with the time, util/random.d:7-10);
* ``nan_sweep`` / ``debug_nans``: any NaN a torch operation produces while
  rendering raises at that operation (the counterpart of
  ``jax_debug_nans``), and ``torch.autograd.detect_anomaly`` watches a
  backward run inside;
* ``profile_trace``: ``torch.profiler`` around a call, with a Chrome trace
  written to a directory; the trace carries the program's ``c2rt.*`` spans
  (utils/spans.py).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.packed import REFLECTION, REFRACTION, ScenePacked, SceneStatic
from ..ops import prng
from ..ops.camera import begin_frame, screen_rays
from ..render.pipeline import _whitted_round, render_frame, render_samples


def _pixel_grid(packed: ScenePacked, static: SceneStatic):
    dt, dev = packed.dtype, packed.device
    ys, xs = torch.meshgrid(torch.arange(static.height, dtype=dt, device=dev),
                            torch.arange(static.width, dtype=dt, device=dev), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _primary_rays(packed: ScenePacked, static: SceneStatic):
    xs, ys = _pixel_grid(packed, static)
    frame = begin_frame(packed.camera, static.width / static.height)
    return screen_rays(packed.camera, frame, float(static.width), float(static.height), xs, ys)


def wavefront_occupancy(packed: ScenePacked, static: SceneStatic):
    """The live-lane fraction entering each wavefront round for the primary
    pixel grid: [1.0, f1, f2, ...], maxTraceDepth + 1 entries for a scene
    with mirrors or glass, else 1.  Every round runs at full width (the
    twin's rounds); one host read at the end."""
    orig, dir = _primary_rays(packed, static)
    recursive = bool({REFLECTION, REFRACTION} & static.shader_kinds_present)
    rounds = (static.max_trace_depth + 1) if recursive else 1
    carry = (torch.zeros_like(orig), torch.ones_like(orig),
             torch.ones(orig.shape[:-1], dtype=torch.bool, device=orig.device), orig, dir)
    fracs = []
    with torch.no_grad():
        for _ in range(rounds):
            fracs.append(carry[2].to(torch.float32).mean())
            carry = _whitted_round(packed, static, *carry, recursive)
    return [float(f) for f in torch.stack(fracs).cpu()]


def frame_ray_stats(packed: ScenePacked, static: SceneStatic, key=None):
    """Traced-ray counts of one frame: {"camera", "shadow", "bounce",
    "total"} as floats.  One ``render_samples`` pass over the pixel grid
    through the twin with ``stats`` (the base AA tap); with AA on every
    count is multiplied by the 5 taps, whose profiles are alike, as the JAX
    package does.  The counters stay on the device until this one read."""
    key = prng.as_key(key)
    xs, ys = _pixel_grid(packed, static)
    frame = begin_frame(packed.camera, static.width / static.height)
    stats = {}
    with torch.no_grad():
        render_samples(packed, static, frame, xs, ys, key, stats=stats)
    out = {k: float(v) for k, v in stats.items()}
    out["total"] = sum(out.values())
    if static.aa_enabled:
        out = {k: v * 5 for k, v in out.items()}
    return out


def assert_deterministic(packed: ScenePacked, static: SceneStatic, key=None):
    """Render the frame twice with the same key; raise unless the two are
    bit-identical.  Returns the frame as a numpy array."""
    with torch.no_grad():
        a = render_frame(packed, static, key).cpu().numpy()
        b = render_frame(packed, static, key).cpu().numpy()
    if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
        diff = int((a != b).sum())
        raise AssertionError(f"non-deterministic render: {diff} differing components")
    return a


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError at the first torch operation whose floating
    output holds a NaN, naming the operation."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans():
    """Inside, any NaN a torch operation produces raises at that operation,
    in the forward and (``torch.autograd.detect_anomaly``) in a backward.
    The hand-written kernels' rows are checked where torch first reads
    them.  Every check reads the device: a debugging mode, not a fast one."""
    with torch.autograd.detect_anomaly(), _NanCheck():
        yield


def nan_sweep(packed: ScenePacked, static: SceneStatic, key=None):
    """Render one frame under ``debug_nans``; returns it as a numpy array
    and raises on any NaN along the way, masked lanes included: the
    pipeline's masked arithmetic is NaN-free by construction (guarded
    divides), which this verifies."""
    with torch.no_grad(), debug_nans():
        out = render_frame(packed, static, key)
    return out.cpu().numpy()


def profile_trace(fn, *args, logdir=None):
    """Run ``fn(*args)`` under ``torch.profiler`` (the card's activity too
    when there is one) and write its Chrome trace into ``logdir`` (a new
    temporary directory when None); returns (result, logdir).

    Beside the aten ops and the card's kernels, the trace holds the
    program's own spans (utils/spans.py), host events on the same clock:
    ``c2rt.frame`` (a ``render_frame`` call), ``c2rt.tap`` (an AA tap or a
    pass of rays, a GI batch of paths), ``c2rt.round`` (a bounce round),
    ``c2rt.k1`` (K1's call), ``c2rt.gather``, ``c2rt.draw``,
    ``c2rt.sync.<site>`` (a host read of device data that waits for the
    card) and the backward's ``c2rt.bwd.k1`` (with ``c2rt.bwd.pins``,
    ``c2rt.bwd.reshade``, ``c2rt.bwd.vjp``) and ``c2rt.bwd.texel``.  Open
    ``trace.json`` in Perfetto or ``chrome://tracing`` and filter by
    ``c2rt.``: a gap in the card's row under a span is host time of that
    part of the program, a gap under ``c2rt.sync.*`` a wait for the card."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="chess2rt_profile_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out, logdir
