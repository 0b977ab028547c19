"""The port's spans and host-sync counter (chess2rt_tpu_torch/utils/spans.py)
on small frames on the CPU, where ``round0`` runs its plain version: what a
running ``torch.profiler`` records of a frame, a GI frame and a gradient
step, and that with no profiler the spans record nothing while
``spans.syncs`` still counts every host read."""

import contextlib
import dataclasses
import functools
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_leaves, leaves, pack_scene
from chess2rt_tpu_torch.ops import flagship, gi
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin, gi_standin
from chess2rt_tpu_torch.utils import spans

torch.set_num_threads(2)

W, H = 32, 24
# each case a scene and the settings it renders under; the flagship cases
# are quirk-AA frames (five taps), each reaching other host-read sites
FLAGSHIP = {
    "block": {},
    "full": {"bounce_mode": "full"},
    "compact": {"bounce_mode": "compact", "bounce_capacity": 256},
    "reuse": {"texel_tap_reuse": True},
}
GI = {"gi": {}, "gi_batch": {"gi_path_batch": 2}}


def _scene(case):
    """(packed, static) of a case: the flagship stand-in, its float64
    frame (the eager twin), or the GI stand-in with two paths."""
    if case in GI:
        p, s = pack_scene(gi_standin(TT, 16, 12, paths=2), device="cpu")
        return p, dataclasses.replace(s, gi_point_light_direct=True, **GI[case])
    dtype = torch.float64 if case == "twin" else torch.float32
    p, s = pack_scene(flagship_standin(TT, W, H), dtype=dtype, device="cpu")
    return p, dataclasses.replace(s, **FLAGSHIP.get(case, {}))


def _counters():
    return {"syncs": dict(spans.syncs), "rounds": flagship.bounce_rounds, "gi_rounds": gi.bounce_rounds}


def _delta(before):
    after = _counters()
    return {"syncs": {k: v - before["syncs"][k] for k, v in after["syncs"].items() if v != before["syncs"][k]},
            "rounds": after["rounds"] - before["rounds"], "gi_rounds": after["gi_rounds"] - before["gi_rounds"]}


def _profiled(fn):
    """fn() under the CPU profiler: (the c2rt.* events as (name, start,
    end, is_user_annotation), the counters' change).  The profiler's raw
    events, since building its FunctionEvent tree takes seconds here."""
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("c2rt.")]
    return events, _delta(before)


def _count(events, name):
    return sum(e[0] == name for e in events)


def _frame(packed, static):
    with torch.no_grad():
        return render_frame(packed, static)


@functools.lru_cache(maxsize=None)
def _runs(case):
    """A case's frame rendered without a profiler, then under one: (the
    counters' change without, the c2rt.* events, the counters' change with)."""
    packed, static = _scene(case)
    before = _counters()
    _frame(packed, static)
    off = _delta(before)
    return (off, *_profiled(lambda: _frame(packed, static)))


@pytest.mark.parametrize("case", [*FLAGSHIP, "twin", *GI])
def test_a_frame_counts_its_host_reads_with_or_without_a_profiler(case):
    assert spans.span("c2rt.frame") is spans.span("c2rt.tap")  # the shared no-op
    off, events, on = _runs(case)
    assert off["syncs"] and off == on
    sync_spans = {e[0][len("c2rt.sync."):] for e in events if e[0].startswith("c2rt.sync.")}
    assert sync_spans == set(on["syncs"])
    assert all(_count(events, "c2rt.sync." + site) == n for site, n in on["syncs"].items())
    assert _count(events, "c2rt.frame") == 1
    assert not any(e[3] for e in events)


@pytest.mark.parametrize("case", list(FLAGSHIP))
def test_a_quirk_aa_frame_has_five_taps_and_a_span_per_bounce_round(case):
    _, events, d = _runs(case)
    assert _count(events, "c2rt.tap") == 5
    assert d["rounds"] > 0 and _count(events, "c2rt.round") == d["rounds"]
    assert _count(events, "c2rt.k1") == 5 + d["rounds"]
    assert _count(events, "c2rt.gather") > 0


@pytest.mark.parametrize("case", list(GI))
def test_a_gi_frame_has_a_span_per_bounce_round_and_batch(case):
    _, events, d = _runs(case)
    batches = 2 // (GI[case].get("gi_path_batch") or 1)  # two paths
    assert d["gi_rounds"] > batches and _count(events, "c2rt.round") == d["gi_rounds"]
    assert _count(events, "c2rt.tap") == batches
    assert _count(events, "c2rt.k1") == d["gi_rounds"]
    # the jitter's two draws per batch, the hemisphere's two per round
    assert _count(events, "c2rt.draw") == 2 * batches + 2 * d["gi_rounds"]
    assert d["syncs"] == {"gi.alive": d["gi_rounds"] - batches}


@pytest.mark.parametrize("case", list(GI))
def test_a_gi_frame_spans_each_key_derivation(case):
    """One ``c2rt.keys`` span per ``prng.split``: the frame's key (AA off),
    one split(k, 4) per path, and per executed round one split(k, 3) per
    path-slab of the batch."""
    _, events, d = _runs(case)
    K = GI[case].get("gi_path_batch") or 1
    assert _count(events, "c2rt.keys") == 1 + 2 + K * d["gi_rounds"]


def test_a_gradient_step_spans_the_backward():
    tp, ts = _scene("block")
    ts = dataclasses.replace(ts, aa_enabled=False)
    xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]

    def step():
        loss = (render_frame(from_leaves(xs), ts) ** 2).mean()
        return torch.autograd.grad(loss, [xs[LEAF_NAMES.index("bitmap_atlas")]])

    events, _ = _profiled(step)
    assert _count(events, "c2rt.frame") == 1
    outer = [e[1:3] for e in events if e[0] == "c2rt.bwd.k1"]
    assert outer and _count(events, "c2rt.bwd.texel") >= 1
    for child in ("c2rt.bwd.pins", "c2rt.bwd.reshade", "c2rt.bwd.vjp"):
        inner = [e[1:3] for e in events if e[0] == child]
        assert len(inner) == len(outer), child
        assert all(any(o[0] <= i[0] and i[1] <= o[1] for o in outer) for i in inner), child
    assert not any(e[3] for e in events)


def _traced_growth(n):
    """(current, peak) bytes that Python allocated over ``n`` off-path spans."""
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(n):
            with spans.span("c2rt.tap"), spans.span("c2rt.round"):
                pass
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return current - before, peak - before


def test_the_off_path_allocates_nothing():
    assert isinstance(spans.span("c2rt.tap"), contextlib.nullcontext)
    _traced_growth(10)
    # the loop's own bytes do not grow with its length: no span allocates
    assert _traced_growth(1000) == _traced_growth(20000)
