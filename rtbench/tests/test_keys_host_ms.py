"""Tests of ``keys_host_ms.frame`` (``rtbench/metrics/keys_host_ms.frame.py``),
the union of the program's ``c2rt.keys`` spans per frame: the reader on
hand-built traces, and one traced run of the GI cell through the harness on
the card.

    python -m pytest rtbench/tests/test_keys_host_ms.py -q            # the CPU tests
    python -m pytest rtbench/tests/test_keys_host_ms.py -q -m gpu     # on the card
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import harness
from rtbench.trace import Trace

NAME, CELL = "keys_host_ms.frame", "lecture4-gi-640-frames"


def _read(tr, loop="frames"):
    return harness.load_reader("metrics", NAME).read(tr, {"loop": loop, "data": {}})


def _trace(cpu_ops, kernels=((0, 10), (50, 60)), window=100.0, n_items=1):
    """A reduced trace over [0, window] us, the device busy in ``kernels``,
    the host in ``cpu_ops`` ((name, start, end))."""
    return Trace(n_items=n_items, window_us=window, busy_us=float(sum(t - s for s, t in kernels)),
                 kernels=[("k", s, t) for s, t in kernels], cpu_ops=list(cpu_ops))


# a GI frame [0, 100]: the frame's split [2, 4], a path's split [5, 8] in its
# tap, two bounce rounds each with its split ([20, 23], [60, 62]) and, in the
# second, a read that does not overlap it; one span nested in another counts
# once
GI_OPS = [("c2rt.frame", 0, 100), ("c2rt.keys", 2, 4), ("c2rt.tap", 5, 95), ("c2rt.keys", 5, 8),
          ("c2rt.round", 10, 40), ("c2rt.keys", 20, 23), ("c2rt.keys", 21, 22), ("c2rt.k1", 11, 19),
          ("c2rt.round", 45, 90), ("c2rt.sync.gi.alive", 45, 50), ("c2rt.keys", 60, 62), ("c2rt.draw", 63, 64)]


def test_the_reader_takes_the_union_of_the_key_spans_per_frame():
    want = (2 + 3 + 3 + 2) / 1e3
    assert _read(_trace(GI_OPS)) == pytest.approx(want)
    assert _read(_trace(GI_OPS, n_items=2)) == pytest.approx(want / 2)


def test_the_reader_finds_nothing_to_read():
    assert _read(_trace(GI_OPS), loop="steps") is None
    assert _read(_trace(GI_OPS, kernels=())) is None  # no device operation: a run on the CPU
    assert _read(_trace([op for op in GI_OPS if op[0] != "c2rt.frame"])) is None  # no frame span
    assert _read(_trace([op for op in GI_OPS if op[0] != "c2rt.keys"])) is None  # the parent: no key span


def test_the_metric_is_reported_in_the_two_monte_carlo_cells():
    bench = harness.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    cells = [w["name"] for w in bench["workloads"] if harness.metrics_of([entry], w["name"])]
    assert cells == [CELL, "zaphod-dof-cubemap"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the program's CUDA kernels have no interpret mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_traced_gi_run_reads_the_key_spans(cuda):
    """A traced run at 32x24 on the card: the reader reads the program's
    real ``c2rt.keys`` spans, inside the frame's host issue."""
    r = harness.run_cell(CELL, 2**33 + 23023, 0.3, True, cuda, time.perf_counter(), size=(32, 24),
                         log=lambda msg: None)
    assert r["correct"] is True and r["failed"] == 0, r["check"]
    keys = r["metrics"][NAME]["value"]
    assert 0 < keys < r["metrics"]["host_issue_ms.frame"]["value"]
