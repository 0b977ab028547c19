"""Tests of the DoF + cubemap cell (``zaphod-dof-cubemap``): its three readers
of the Monte-Carlo spans on hand-built traces, a run of the cell through the
harness at 32x24 on the CPU (the program's plain versions), a stale item
failing its check, the bfloat16 control failing its limits, and the ray
counter of Monte-Carlo frames (``rtbench/count_rays_mc.py``).

    python -m pytest rtbench/tests/test_zaphod_cell.py -q
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import check, count_rays, count_rays_mc, generator, harness, trace
from rtbench.port import Port
from rtbench.trace import Trace

torch.set_num_threads(2)

CELL, CONFIG = "zaphod-dof-cubemap", "zaphod-standin"
SIZE = (32, 24)
SEED = 2**33 + 20020
READERS = ("passes_per_frame", "raygen_host_ms.frame", "env_host_ms.frame")


def _read(name, tr, loop="frames"):
    return harness.load_reader("metrics", name).read(tr, {"loop": loop, "data": {}})


def _trace(cpu_ops, kernels=((0, 10), (50, 60)), window=100.0, n_items=1):
    """A reduced trace over [0, window] us, the device busy in ``kernels``,
    the host in ``cpu_ops`` ((name, start, end))."""
    return Trace(n_items=n_items, window_us=window, busy_us=float(sum(t - s for s, t in kernels)),
                 kernels=[("k", s, t) for s, t in kernels], cpu_ops=list(cpu_ops))


# a frame [0, 100] of two passes, each a ray-gen with a draw in it, then a
# tap whose environment part [20, 40] holds the nested gather [25, 35] and a
# read [30, 32]; the second pass's ray-gen holds a read [55, 57]
MC_OPS = [("c2rt.frame", 0, 100),
          ("c2rt.mc_pass", 0, 45), ("c2rt.raygen", 0, 15), ("c2rt.draw", 2, 6), ("c2rt.tap", 15, 45),
          ("c2rt.env", 20, 40), ("c2rt.gather", 25, 35), ("c2rt.sync.flagship.block_count", 30, 32),
          ("c2rt.mc_pass", 50, 95), ("c2rt.raygen", 50, 60), ("c2rt.sync.flagship.block_alive", 55, 57),
          ("c2rt.tap", 60, 95), ("c2rt.env", 65, 70)]


@pytest.mark.parametrize("name, want", [
    ("passes_per_frame", 2.0),
    # [0, 15] and [50, 60] less the read [55, 57]
    ("raygen_host_ms.frame", (15 + 10 - 2) / 1e3),
    # [20, 40] (the nested gather once) less the read [30, 32], and [65, 70]
    ("env_host_ms.frame", (20 - 2 + 5) / 1e3),
])
def test_a_reader_on_a_hand_built_trace(name, want):
    assert _read(name, _trace(MC_OPS)) == pytest.approx(want)
    assert _read(name, _trace(MC_OPS, n_items=2)) == pytest.approx(want / 2)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_to_read(name):
    assert _read(name, _trace(MC_OPS), loop="steps") is None
    assert _read(name, _trace(MC_OPS, kernels=())) is None  # no device operation: a run on the CPU
    assert _read(name, _trace([op for op in MC_OPS if op[0] != "c2rt.frame"])) is None  # no frame span
    # the parent: frames and reads, but no Monte-Carlo span
    old = [op for op in MC_OPS if op[0] in ("c2rt.frame", "c2rt.tap", "c2rt.gather", "c2rt.draw")
           or op[0].startswith("c2rt.sync.")]
    assert _read(name, _trace(old)) is None


def _with_samples(config, samples):
    return dict(config, scene=dict(config["scene"], args=dict(config["scene"]["args"], samples=samples)))


@pytest.fixture
def two_samples(monkeypatch):
    """The cell's configuration with 2 DoF samples in place of 25 (10 passes
    a frame): on the CPU a 25-sample frame's plain passes take seconds."""
    load = harness.load_config
    monkeypatch.setattr(harness, "load_config", lambda name: _with_samples(load(name), 2))


def _run(seconds=0.3, traced=False, port_factory=None):
    return harness.run_cell(CELL, SEED, seconds, traced, "cpu", time.perf_counter(), size=SIZE,
                            port_factory=port_factory, log=lambda msg: None)


def test_the_cell_finds_its_files_and_metrics():
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "frames-closed", 1)
    config = harness.load_config(CONFIG)
    assert config["scene"] == {"builder": "flagship_standin", "args": {"dof": True, "env": True, "samples": 25}}
    assert (config["frames"]["width"], config["frames"]["height"]) == (1920, 1080)
    assert set(config["frames"]["rays"]) == {"camera", "shadow", "bounce"}
    assert config["frames"]["rays"]["camera"] == 1920 * 1080 * 5 * 25
    e2e = {m["name"] for m in harness.metrics_of(bench["end_to_end"], CELL)}
    assert e2e == {"setup_s", "frame_ms"}
    per_layer = {m["name"] for m in harness.metrics_of(bench["per_layer"], CELL)}
    assert set(READERS) <= per_layer and "k1_roofline_pct.frame" in per_layer
    assert not any(n.endswith(".step") or n == "launches_per_step" for n in per_layer)


def test_the_cell_runs_correct_on_the_cpu(two_samples):
    r = _run()
    assert r["correct"] is True and r["failed"] == 0, r["check"]
    assert r["attempted"] >= 1 and r["check"]["vs_next"]["value"] > 1
    assert set(r["metrics"]) == {"setup_s", "frame_ms"}


class _Stale(Port):
    """The program returning the previous item's frame."""

    _prev = None

    def frame(self, jit, key):
        img = super().frame(jit, key).clone()
        prev, self._prev = self._prev, img
        return img if prev is None else prev


def test_a_stale_item_fails_the_check(two_samples):
    r = _run(seconds=1.0, port_factory=_Stale)
    assert r["correct"] is False
    assert r["check"]["px_off"]["value"] > r["check"]["px_off"]["limit"], r["check"]


def _inputs(config, size=SIZE):
    traffic = generator.load_traffic("frames-closed")
    mode = dict(config["frames"], width=size[0], height=size[1])
    return mode, generator.Inputs(SEED, traffic, check.camera_basis(config, mode))


def test_the_bfloat16_control_fails_the_limits():
    config = _with_samples(harness.load_config(CONFIG), 2)
    mode, inputs = _inputs(config)
    outs = list(check.reference_outputs([0], "frames", config, mode, inputs, "cpu", torch.bfloat16))
    limits = check.load_limits(CELL)
    nums = check.judge(outs, "frames", config, mode, inputs, "cpu", limits)
    assert nums["px_off"] > limits["px_off"]["limit"], nums
    assert not check.passes(nums, limits)


def _frame_rays(config, samples=None, size=SIZE):
    """(count_rays_mc's counts, the reference's own ``stats``) of one frame
    of ``config`` at ``size``, with ``samples`` DoF samples."""
    if samples is not None:
        config = _with_samples(config, samples)
    mode, inputs = _inputs(config, size)
    key, jit = inputs.item(0)
    packed, static = check.reference_scene(config, mode, SEED, "cpu")
    packed = check._moved(packed, jit)
    with torch.no_grad():
        stats = {}
        count_rays.RPL.render_frame(packed, static, key, stats)
        return count_rays_mc.frame_rays(packed, static, key), {k: float(v) for k, v in stats.items()}


def test_the_mc_ray_counter_counts_as_the_reference_on_a_frame_without_dof():
    mc, ref = _frame_rays(harness.load_config("lecture5-standin"))
    assert mc == ref and mc["shadow"] > 0 and mc["bounce"] > 0


def test_the_mc_ray_counter_counts_every_pass_of_a_dof_frame():
    w, h = SIZE
    mc, ref = _frame_rays(harness.load_config(CONFIG), samples=2)
    # the reference's own stats see only the camera rays of a DoF frame
    assert ref == {"camera": w * h * 5 * 2}
    assert mc["camera"] == w * h * 5 * 2
    # both lights light most shading points; the mirror sphere's bounces
    assert mc["camera"] < mc["shadow"] < 2 * mc["camera"] and 0 < mc["bounce"] < mc["camera"]


def test_the_traced_run_would_read_the_new_spans(monkeypatch, two_samples):
    """A traced run with a stand-in copy of no length at the window's start
    (a CPU trace has no device operation): the three readers read the
    program's real spans, 5 x 2 passes a frame."""
    reduce = trace.reduce_events

    def with_a_device_op(events, n_items):
        tr = reduce(events, n_items)
        start = tr.idle_gaps[0][0]
        tr.copies.append(("Memset (stand-in)", start, start))
        return tr

    monkeypatch.setattr(trace, "reduce_events", with_a_device_op)
    r = _run(traced=True)
    assert r["metrics"]["passes_per_frame"]["value"] == 10.0
    assert r["metrics"]["raygen_host_ms.frame"]["value"] > 0
    assert r["metrics"]["env_host_ms.frame"]["value"] > 0
