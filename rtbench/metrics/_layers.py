"""Shared arithmetic of the per-layer readers (``rtbench/metrics/<name>.py``),
each of which reads one metric from a traced run's reduction
(``rtbench/trace.py``) and returns None where it finds nothing to read."""

from __future__ import annotations

from rtbench.trace import SYNC_CALLS


def idle_pct(tr, ctx, loop):
    if ctx["loop"] != loop or tr.window_us <= 0 or not (tr.kernels or tr.copies):
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def launches_per_item(tr, ctx, loop):
    if ctx["loop"] != loop or not tr.kernels:
        return None
    return len(tr.kernels) / tr.n_items


def syncs_per_item(tr, ctx, loop):
    """Host-blocking CUDA runtime calls per item, less the harness's own
    (one per item: the frame's copy to the host, or the step's read)."""
    if ctx["loop"] != loop or not tr.kernels:
        return None
    n = sum(1 for name, _, _ in tr.runtime if name in SYNC_CALLS)
    return n / tr.n_items - ctx["harness_syncs_per_item"]


def matches(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def device_ms_per_item(tr, patterns, inside: bool) -> float:
    """Device ms per item of the kernels whose names match ``patterns``
    (``inside``) or of those that do not."""
    us = sum(t - s for name, s, t in tr.kernels if matches(name, patterns) == inside)
    return us / 1e3 / tr.n_items
