"""The traced run's reduction: ``torch.profiler`` over a fixed number of
items, reduced to the device's operations, the host's CUDA runtime calls and
its CPU ops, on one time base (microseconds).

Each profiled item runs inside ``record_function(ITEM_SPAN)``; the profiled
window runs from the first item's start to the last one's end (an item ends
when its result is on the host, so the device is done).  ``busy_us`` is the
union of the device operations' intervals inside the window (kernels, copies
and fills: the device was doing something), so overlapping operations are
not counted twice.  No chrome trace is written.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

ITEM_SPAN = "rtbench.item"
# the CUDA runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Trace:
    n_items: int
    window_us: float
    busy_us: float
    kernels: list = field(default_factory=list)  # (name, start, end) device kernels
    copies: list = field(default_factory=list)  # (name, start, end) device copies and fills
    runtime: list = field(default_factory=list)  # (name, start, end) CUDA runtime calls on the host
    cpu_ops: list = field(default_factory=list)  # (name, start, end) other host ops
    idle_gaps: list = field(default_factory=list)  # (start, end) device idle inside the window


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_items(run_item, first: int, n: int, device) -> Trace:
    """Run ``run_item(i)`` for ``i`` in ``first .. first + n - 1`` under
    torch.profiler (CPU and, on a card, CUDA activity) and reduce the
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(first, first + n):
            with record_function(ITEM_SPAN):
                run_item(i)
    return reduce_events(prof.events(), n)


def reduce_events(events, n_items: int) -> Trace:
    """A Trace from a profiler's FunctionEvents (see the module's
    docstring)."""
    items = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == ITEM_SPAN and not _is_device(e)]
    if not items:
        raise RuntimeError("trace: no profiled item span found")
    t0, t1 = min(s for s, _ in items), max(e for _, e in items)
    kernels, copies, runtime, cpu_ops = [], [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t < t0 or s > t1 or e.name == ITEM_SPAN:
            continue
        rec = (e.name, max(s, t0), min(t, t1))
        if _is_device(e):
            (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(rec)
        elif e.name.startswith("cuda"):
            runtime.append(rec)
        else:
            cpu_ops.append(rec)
    busy = _union([(s, t) for _, s, t in kernels + copies])
    gaps, at = [], t0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if t1 > at:
        gaps.append((at, t1))
    return Trace(n_items=n_items, window_us=float(t1 - t0), busy_us=float(sum(t - s for s, t in busy)),
                 kernels=kernels, copies=copies, runtime=runtime, cpu_ops=cpu_ops, idle_gaps=gaps)


def top_device_ops(tr: Trace, k: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    tot = {}
    for name, s, t in tr.kernels + tr.copies:
        tot[name] = tot.get(name, 0.0) + (t - s)
    return [[name[:200], us / 1e6] for name, us in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def top_idle_gaps(tr: Trace, k: int = 10) -> list:
    """[[label, seconds]] of the longest idle gaps, each labelled by the
    innermost host op (a CUDA runtime call first, else the latest-starting
    CPU op) running at the gap's middle."""
    out = []
    for s, t in sorted(tr.idle_gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = (s + t) / 2
        label = "host: no op recorded"
        for pool in (tr.runtime, tr.cpu_ops):
            live = [(a, name) for name, a, b in pool if a <= mid <= b]
            if live:
                label = max(live)[1]
                break
        out.append([label[:200], (t - s) / 1e6])
    return out
