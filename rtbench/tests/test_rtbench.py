"""Tests of the benchmark (``rtbench/``): the harness's runs at 32x24 through
the program's plain versions, the files each cell is found by, the reference
against the program, the control and the faults failing ``correct``, the
import rules, and the refusal to measure without a card.

    python -m pytest rtbench/tests -q                  # the CPU tests
    python -m pytest rtbench/tests -q -m gpu           # on the card

Tests that need the card carry the ``gpu`` marker and decide in a fixture.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rtbench import check, generator, harness
from rtbench.port import Port

torch.set_num_threads(2)

ROOT = harness.ROOT
HERE = harness.HERE
SIZE = (32, 24)
SEED = 2**33 + 12345
FRAME_CELL, STEP_CELL, GI_CELL = "lecture5-1080p-frames", "lecture5-640-steps", "lecture4-gi-640-frames"


def _run(workload, seconds=0.3, traced=False, port_factory=None, size=SIZE, seed=SEED, device="cpu"):
    return harness.run_cell(workload, seed, seconds, traced, device, time.perf_counter(), size=size,
                            port_factory=port_factory, log=lambda msg: None)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the program's CUDA kernels have no interpret mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", [FRAME_CELL, STEP_CELL])
def test_a_run_prints_the_contract_keys(workload):
    r = _run(workload, seconds=1.5)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in harness.metrics_of(harness.load_benchmark()["end_to_end"], workload)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


def test_a_traced_run_reads_the_trace_on_the_cpu():
    r = _run(STEP_CELL, traced=True)
    # the CPU has no device operations, so no per-layer metric has anything to read
    assert r["metrics"] == {} and r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_cell_finds_its_files_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        config = harness.load_config(w["config"])
        traffic = generator.load_traffic(w["traffic"])
        assert config["name"] == w["config"] and traffic["loop"] in config
        assert check.load_limits(w["name"])
        for m in harness.metrics_of(bench["end_to_end"], w["name"]):
            assert callable(harness.load_reader("e2e", m["name"]).read)
        for m in harness.metrics_of(bench["per_layer"], w["name"]):
            assert callable(harness.load_reader("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert harness.load_config(c["name"])["reduced"] == c["reduced"]


def _inputs(workload, seed=SEED, size=SIZE):
    cell = harness.find(harness.load_benchmark()["workloads"], workload, "workload")
    cfg = harness.load_config(cell["config"])
    traffic = generator.load_traffic(cell["traffic"])
    mode = dict(cfg[traffic["loop"]], width=size[0], height=size[1])
    return cfg, traffic["loop"], mode, generator.Inputs(seed, traffic, check.camera_basis(cfg, mode))


def test_the_same_seed_gives_the_same_inputs():
    cfg = harness.load_config("lecture5-standin")
    mode = dict(cfg["frames"], width=32, height=24)
    a, _ = check.reference_scene(cfg, mode, SEED, "cpu")
    b, _ = check.reference_scene(cfg, mode, SEED, "cpu")
    c, _ = check.reference_scene(cfg, mode, SEED + 1, "cpu")
    assert torch.equal(a.bitmap_atlas, b.bitmap_atlas) and not torch.equal(a.bitmap_atlas, c.bitmap_atlas)
    assert torch.equal(a.node_matrix, c.node_matrix) and a.bitmap_atlas.shape == c.bitmap_atlas.shape
    _, _, _, inputs = _inputs(FRAME_CELL)
    _, _, _, again = _inputs(FRAME_CELL)
    _, _, _, other = _inputs(FRAME_CELL, seed=SEED + 1)
    for i in (0, 3, 255, 256, 1000):
        key, off = inputs.item(i)
        assert (key == generator.item_key(SEED, i)).all()
        assert (key == again.item(i)[0]).all() and (off == again.item(i)[1]).all()
        assert (off == inputs.poses[i % len(inputs.poses)] + generator.jitter(key, 1e-4)).all()
        # another seed: other keys and jitter, the same pose
        assert np.abs(off - other.item(i)[1]).max() <= 1e-4
    assert np.abs(generator.jitter(inputs.item(3)[0], 1e-4)).max() <= 0.5e-4


def test_the_walk_moves_the_camera_by_the_session_step():
    # the session's strafe (dMove = 32 along the camera's right vector, here
    # world x) between every two neighbouring items, and back to the start
    _, _, _, inputs = _inputs(FRAME_CELL)
    p = inputs.poses
    assert len(p) == 8 and not p[0].any()
    steps = np.diff(np.concatenate([p, p[:1]]), axis=0)
    assert np.allclose(np.abs(steps[:, 0]), 32.0) and np.allclose(steps[:, 1:], 0.0)
    # a round of the walk later, the same pose under another jitter
    assert 0 < np.abs(inputs.item(9)[1] - inputs.item(1)[1]).max() <= 1e-4


@pytest.mark.parametrize("workload,config,loop", [(FRAME_CELL, "lecture5-standin", "frames"),
                                                  (STEP_CELL, "lecture5-standin", "steps"),
                                                  (GI_CELL, "lecture4-gi-standin", "frames")])
def test_the_reference_agrees_with_the_program_at_32x24(workload, config, loop):
    cfg, loop, mode, inputs = _inputs(workload)
    assert cfg["name"] == config
    port = Port(cfg, mode, SEED, "cpu")
    kept = []
    for i in range(2):
        key, jit = inputs.item(i)
        if loop == "frames":
            kept.append((i, port.frame(jit, key).clone()))  # the frame buffer is reused
        else:
            loss, grads = port.step(jit, key)
            kept.append((i, (loss, grads, port.leaf_names)))
    limits = check.load_limits(workload)
    nums = check.judge(kept, loop, cfg, mode, inputs, "cpu", limits)
    if loop == "frames":
        assert nums["px_off"] <= 0.01
    else:
        # the plain K1 and the reference agree to rounding in the loss; a
        # leaf's gradient can differ on knife-edge pixels (the mirror sphere)
        assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 0.1
        assert nums["texel_gap"] <= limits["texel_gap"]["limit"]
    # each item fails the limits against the next item's reference
    assert nums["vs_next"] > 1.0


@pytest.mark.parametrize("workload", [FRAME_CELL, STEP_CELL, GI_CELL])
def test_the_bfloat16_control_fails_the_limits(workload):
    cfg, loop, mode, inputs = _inputs(workload)
    outs = list(check.reference_outputs([0], loop, cfg, mode, inputs, "cpu", torch.bfloat16))
    limits = check.load_limits(workload)
    nums = check.judge(outs, loop, cfg, mode, inputs, "cpu", limits)
    assert any(nums[k] > lim["limit"] for k, lim in limits.items() if not lim.get("above")), nums
    assert not check.passes(nums, limits)


class _Faulty(Port):
    """The program with a fault planted in what the timed path returns."""

    fault = None
    _prev = None

    def frame(self, jit, key):
        img = super().frame(jit, key)
        if self.fault == "altered":  # an answer altered where it is produced
            return img * 1.01 + 0.01
        if self.fault == "half":  # half of the batch (the frame's rows) left out
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
        if self.fault == "stale":  # the previous item's frame returned
            prev, self._prev = self._prev, img.clone()
            return img if prev is None else prev
        return img

    def loss_and_grads(self, jit, key):
        if self.fault == "half":  # the mean taken over half of the rows
            full, self.target = self.target, self.target[: self.target.shape[0] // 2]
            static = self.static
            try:
                xs = list(self._xs)
                xs[self._pos_at] = self._pos(jit).detach().requires_grad_()
                p = self._P.from_leaves(xs)
                img = self._pipeline.render_frame(p, static, key)[: full.shape[0] // 2]
                loss = ((img - self.target) ** 2).mean()
                wrt = [x for x in xs if x.requires_grad]
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)
                return loss.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
            finally:
                self.target = full
        loss, grads = super().loss_and_grads(jit, key)
        if self.fault == "altered":
            return loss * 1.01, [g * 1.01 for g in grads]
        if self.fault == "k2":  # K2's texel sum off by 2%: the atlas gradient alone
            at = self.leaf_names.index("bitmap_atlas")
            return loss, grads[:at] + [grads[at] * 1.02] + grads[at + 1:]
        if self.fault == "stale":  # the previous step's loss and gradients returned
            prev, self._prev = self._prev, (loss, grads)
            return (loss, grads) if prev is None else prev
        return loss, grads


@pytest.mark.parametrize("workload,fault", [(FRAME_CELL, "altered"), (FRAME_CELL, "half"), (FRAME_CELL, "stale"),
                                            (STEP_CELL, "altered"), (STEP_CELL, "half"), (STEP_CELL, "stale"),
                                            (STEP_CELL, "k2"), (GI_CELL, "altered"), (GI_CELL, "half"),
                                            (GI_CELL, "stale")])
def test_a_fault_in_the_timed_path_makes_correct_false(workload, fault):
    def factory(config, mode, seed, device):
        port = _Faulty(config, mode, seed, device)
        port.fault = fault
        return port

    r = _run(workload, port_factory=factory)
    assert r["correct"] is False, r["check"]


def test_a_frame_that_skips_the_kernel_counts_as_failed(monkeypatch):
    # on a card, an item whose K1 counter did not move is failed; here the
    # counter is made to read as a card's would, with the twin's counter moving
    class Twin(Port):
        calls = 0

        def counts(self):
            Twin.calls += 1
            return {"k1": 0, "twin": Twin.calls}

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "stand-in")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(harness, "card_line", lambda d: "stand-in")

    def factory(config, mode, seed, device):
        return Twin(config, mode, seed, "cpu")

    bench_dev = torch.device("cuda", 0)
    orig_judge = check.judge
    monkeypatch.setattr(check, "judge", lambda kept, loop, c, m, inputs, dev, limits, **kw:
                        orig_judge(kept, loop, c, m, inputs, "cpu", limits, **kw))
    r = harness.run_cell(FRAME_CELL, SEED, 0.2, False, bench_dev, time.perf_counter(), size=SIZE,
                         port_factory=factory, log=lambda msg: None)
    assert r["failed"] == r["attempted"] >= 1 and r["correct"] is False


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def _py_files(folder):
    for dirpath, _, files in os.walk(os.path.join(ROOT, folder)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for folder in ("rtbench", "chess2rt_tpu_torch"):
        for path in _py_files(folder):
            for name, level in _imports(path):
                if level == 0:
                    assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join("rtbench", "reference")):
        for name, level in _imports(path):
            top = name.split(".")[0]
            assert level <= 1, (path, name)  # nothing outside rtbench/reference
            assert level == 1 or top in ("torch", "numpy", "math", "typing", "dataclasses", "functools",
                                         "__future__"), (path, name)


def test_the_command_refuses_to_measure_without_a_card(monkeypatch, capsys):
    from rtbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", FRAME_CELL, "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_the_command_needs_the_program_beside_it(tmp_path):
    # a checkout that holds only BENCHMARK.json and rtbench/ cannot run
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "rtbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", FRAME_CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [FRAME_CELL, STEP_CELL, GI_CELL])
def test_a_small_run_on_the_card_is_correct(cuda, workload):
    r = _run(workload, seconds=1.0, traced=True, size=(160, 120), device=cuda)
    assert r["correct"] is True and r["failed"] == 0, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
