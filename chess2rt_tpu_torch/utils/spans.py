"""Spans and host-sync counts on the torch profiler's clock.

``span(name)`` marks a range of the program's host work (a frame, an AA
tap, a Monte-Carlo pass and its ray-gen, a bounce round, K1's call, a draw,
a gather, the environment's share of a gather, the backward's parts) in
the trace of a running ``torch.profiler.profile``, on the clock of the
device's kernels, so a reader of the trace can say in which part of the
program the host was while the device sat idle.  While no profiler records,
``span`` returns one shared no-op context: a flag test, nothing allocated.

The spans are ``torch._C._profiler._RecordFunctionFast`` ranges, a host
event of the FUNCTION scope.  ``torch.profiler.record_function`` is not
used: its user-scope ranges get a device-side twin
(``gpu_user_annotation``) in a CUDA trace, which a reader would count as
device work.

``sync(site)`` wraps one host read of device data (a ``.any()`` or a
``.sum()`` brought to the host, which waits for the device): it counts the
read in ``syncs[site]`` always, like the modules' launch counters, and
records the span ``c2rt.sync.<site>`` while a profiler records.  Sites are
the names of ``SYNC_SITES``; ``read_any`` and ``read_count`` are the two
reads the renderers make.  Callers zero ``syncs`` and read it.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# every host read of device data in the renderers, by site
SYNC_SITES = (
    "flagship.reuse_count",  # _reused_quads: the changed texel keys
    "flagship.full_alive",  # fullwidth_bounces: any live lane, per round
    "flagship.block_count",  # block_bounces: the live blocks
    "flagship.block_alive",  # block_bounces: any live lane, per round
    "flagship.compact_count",  # compact_bounces: the live lanes
    "flagship.compact_alive",  # compact_bounces: any live lane, per round
    "flagship.aa_count",  # _adaptive_taps: the flagged pixels
    "flagship.mc_aa_count",  # the Monte-Carlo renderer: the flagged pixels
    "gi.alive",  # the GI tracer: any live path, per bounce after the first
    "pipeline.rounds_alive",  # the twin's _run_rounds: any live lane, per round
    "pipeline.compact_count",  # the twin's continue_bounces: the live lanes
    "pipeline.path_alive",  # the twin's trace_path: any live path, per bounce
)
# host reads by site since the counters were last zeroed
syncs = dict.fromkeys(SYNC_SITES, 0)
_SYNC_SPANS = {site: "c2rt.sync." + site for site in SYNC_SITES}
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context recording ``name`` as a range of the running profiler's
    trace, or a no-op when none records."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def sync(site: str):
    """The context of one host read at ``site`` (one of ``SYNC_SITES``):
    counted, and spanned as ``c2rt.sync.<site>`` while a profiler records."""
    syncs[site] += 1
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(_SYNC_SPANS[site])
    return _OFF


def read_any(site: str, x: torch.Tensor) -> bool:
    """``bool(x.any())`` on the host, as a read at ``site``."""
    with sync(site):
        return bool(x.any())


def read_count(site: str, x: torch.Tensor) -> int:
    """``int(x.sum())`` on the host, as a read at ``site``."""
    with sync(site):
        return int(x.sum())
