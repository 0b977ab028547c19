"""Shared arithmetic of the readers of the program's own spans (``c2rt.*``,
chess2rt_tpu_torch/utils/spans.py).  A traced run's reduction
(``rtbench/trace.py``) keeps them among its host ops, ``Trace.cpu_ops``,
clipped to the profiled window.  A family of spans (the names that start
with a prefix) is taken as the union of its intervals, so a span nested in
another of its family, or two at once on two threads (the backward runs on
autograd's device thread), count once.  A reader returns None where the
trace holds no device operation (a run on the CPU) or no ``c2rt.frame``
span (a program without spans)."""

from __future__ import annotations

from rtbench.trace import _union

FRAME = "c2rt.frame"
PROGRAM = "c2rt."
SYNC = "c2rt.sync."
BWD = "c2rt.bwd."


def readable(tr, ctx, loop) -> bool:
    return (ctx["loop"] == loop and bool(tr.kernels or tr.copies)
            and any(name == FRAME for name, _, _ in tr.cpu_ops))


def spans(tr, *prefixes) -> list:
    """The (start, end) of every span whose name starts with one of
    ``prefixes``."""
    return [(s, t) for name, s, t in tr.cpu_ops if name.startswith(prefixes)]


def union(tr, *prefixes) -> list:
    """The union of the families ``prefixes``: sorted disjoint [start, end]."""
    return _union(spans(tr, *prefixes))


def total(u) -> float:
    return float(sum(t - s for s, t in u))


def minus(a, b) -> list:
    """The parts of the union ``a`` outside the union ``b`` (both sorted and
    disjoint)."""
    out, j = [], 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < t:
            out.append([s, t])
    return out


def ms_per_item(tr, u) -> float:
    return total(u) / 1e3 / tr.n_items


def host_issue_ms(tr, *prefixes) -> float:
    """ms per item that the host spent inside the families ``prefixes`` and
    not blocked in one of the program's host reads (``c2rt.sync.*``)."""
    return ms_per_item(tr, minus(union(tr, *prefixes), union(tr, SYNC)))


def idle_in_program_pct(tr):
    """100 x the device's idle time during which the host was inside a
    ``c2rt.*`` span and not inside a ``c2rt.sync.*`` one, over the device's
    idle time in the window (None without idle time)."""
    idle = _union(tr.idle_gaps)
    if total(idle) <= 0:
        return None
    program = minus(union(tr, PROGRAM), union(tr, SYNC))
    return 100.0 * (total(idle) - total(minus(idle, program))) / total(idle)
