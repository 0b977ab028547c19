"""Tests of the readers of the program's spans (``rtbench/metrics/_spans.py``
and the seven metrics that read ``c2rt.*`` spans): each reader on hand-built
traces, and one traced run per loop through the harness on the CPU.

    python -m pytest rtbench/tests/test_span_metrics.py -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from rtbench import harness, trace
from rtbench.trace import ITEM_SPAN, Trace

FRAME_METRICS = ("host_issue_ms.frame", "sync_wait_ms.frame", "host_syncs_per_frame", "idle_in_program_pct.frame")
STEP_METRICS = ("host_issue_ms.step", "backward_host_ms.step", "idle_in_program_pct.step")
LOOP = {**dict.fromkeys(FRAME_METRICS, "frames"), **dict.fromkeys(STEP_METRICS, "steps")}
FRAME_CELL, STEP_CELL = "lecture5-1080p-frames", "lecture5-640-steps"


def _read(name, tr, loop=None):
    return harness.load_reader("metrics", name).read(tr, {"loop": loop or LOOP[name], "data": {}})


def _trace(cpu_ops, kernels=((0, 10), (50, 60)), window=100.0, n_items=1):
    """A reduced trace over [0, window] us: the device busy in ``kernels``,
    idle elsewhere, the host in ``cpu_ops`` ((name, start, end))."""
    gaps, at = [], 0.0
    for s, t in kernels:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if window > at:
        gaps.append((at, window))
    return Trace(n_items=n_items, window_us=window, busy_us=float(sum(t - s for s, t in kernels)),
                 kernels=[("k", s, t) for s, t in kernels], cpu_ops=list(cpu_ops), idle_gaps=gaps)


# a frame [0, 80] with a tap and a round nested in it, two reads (one inside
# the round), and an aten op: nested spans count once
FRAME_OPS = [("c2rt.frame", 0, 80), ("c2rt.tap", 5, 70), ("c2rt.round", 15, 45), ("aten::add", 16, 17),
             ("c2rt.sync.flagship.block_alive", 20, 30), ("c2rt.sync.flagship.full_alive", 60, 65)]
# a step: the forward [0, 50] and the backward on autograd's thread [40, 95],
# overlapping it, with its children and the texel VJP; one read
STEP_OPS = [("c2rt.frame", 0, 50), ("c2rt.sync.flagship.block_count", 10, 20), ("c2rt.bwd.k1", 40, 90),
            ("c2rt.bwd.pins", 45, 60), ("c2rt.bwd.reshade", 60, 70), ("c2rt.bwd.vjp", 70, 88),
            ("c2rt.bwd.texel", 80, 95)]


@pytest.mark.parametrize("name, ops, want", [
    ("host_issue_ms.frame", FRAME_OPS, (80 - 15) / 1e3),
    ("sync_wait_ms.frame", FRAME_OPS, 15 / 1e3),
    ("host_syncs_per_frame", FRAME_OPS, 2.0),
    # idle [10, 50] and [60, 100]; in the program outside a read: [10, 20], [30, 50], [65, 80]
    ("idle_in_program_pct.frame", FRAME_OPS, 100.0 * 45 / 80),
    # the union [0, 95] less the read's 10 us
    ("host_issue_ms.step", STEP_OPS, (95 - 10) / 1e3),
    ("backward_host_ms.step", STEP_OPS, (95 - 40) / 1e3),
    # in the program outside a read: [0, 10], [20, 95]; idle in it: [20, 50], [60, 95]
    ("idle_in_program_pct.step", STEP_OPS, 100.0 * 65 / 80),
])
def test_a_reader_on_a_hand_built_trace(name, ops, want):
    assert _read(name, _trace(ops)) == pytest.approx(want)
    # per item
    assert _read(name, _trace(ops, n_items=2)) == pytest.approx(want if name.startswith("idle") else want / 2)


@pytest.mark.parametrize("name", FRAME_METRICS + STEP_METRICS)
def test_a_reader_finds_nothing_to_read(name):
    ops = FRAME_OPS if LOOP[name] == "frames" else STEP_OPS
    other = "steps" if LOOP[name] == "frames" else "frames"
    assert _read(name, _trace(ops), loop=other) is None
    assert _read(name, _trace([op for op in ops if op[0] != "c2rt.frame"])) is None  # no spans: the parent
    assert _read(name, _trace(ops, kernels=())) is None  # no device operation: a run on the CPU


def _event(name, s, t, cuda=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                           device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU")


def test_the_spans_are_clipped_to_the_window():
    """Through ``trace.reduce_events``: the item [100, 200]; a frame and a
    read reaching past it count only inside it."""
    events = [_event(ITEM_SPAN, 100, 200), _event("c2rt.frame", 90, 210), _event("c2rt.sync.gi.alive", 195, 205),
              _event("k", 100, 110, cuda=True), _event("k", 190, 200, cuda=True)]
    tr = trace.reduce_events(events, 1)
    assert _read("host_issue_ms.frame", tr) == pytest.approx(95 / 1e3)
    assert _read("sync_wait_ms.frame", tr) == pytest.approx(5 / 1e3)
    assert _read("idle_in_program_pct.frame", tr) == pytest.approx(100.0)


@pytest.mark.parametrize("workload, names", [(FRAME_CELL, FRAME_METRICS), (STEP_CELL, STEP_METRICS)])
def test_a_traced_cpu_run_reads_every_span_metric(monkeypatch, workload, names):
    """One traced run through the harness at 32x24 on the CPU.  A CPU trace
    has no device operation, so every reader of a device trace returns None
    there; a stand-in copy of no length at the window's start lets the
    readers read the program's real spans."""
    reduce = trace.reduce_events

    def with_a_device_op(events, n_items):
        tr = reduce(events, n_items)
        start = tr.idle_gaps[0][0]
        tr.copies.append(("Memset (stand-in)", start, start))
        return tr

    monkeypatch.setattr(trace, "reduce_events", with_a_device_op)
    r = harness.run_cell(workload, 2**33 + 12345, 0.3, True, "cpu", time.perf_counter(), size=(32, 24),
                         log=lambda msg: None)
    assert r["correct"] is True
    for name in names:
        assert isinstance(r["metrics"][name]["value"], float), name
    assert r["metrics"][names[0]]["value"] > 0
    if workload == FRAME_CELL:
        assert r["metrics"]["host_syncs_per_frame"]["value"] > 0
    assert 0 < r["metrics"][names[-1]]["value"] <= 100
