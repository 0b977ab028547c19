"""The port's bench twin (chess2rt_tpu_torch/bench.py) and entry point
(chess2rt_tpu_torch/entry.py) against the root bench.py and
__graft_entry__.py, on the flagship stand-in.

The root files read lecture5.sdl, which is not in the repository: the
JAX package's loader is patched to return ``flagship_standin`` (without its
mirror sphere for bench.py, whose ``build`` appends the same one).  Limits:
the ray counts as tests/test_torch_diagnostics.py holds them (camera
exactly, shadow and bounce within 0.1%), the extrapolation delta within
1e-3, the entry's frame at the frame limits (tests/test_fuzz.py).  JAX's
instrumented passes run eagerly (``jax.disable_jit``: the same operations,
without XLA's compile of the unrolled rounds); its entry frame compiles
once.  Every mode of the twin runs on the CPU at a tiny size.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.scene import loader as jax_loader
from chess2rt_tpu_torch import bench, entry
from chess2rt_tpu_torch.models.packed import to_numpy
from chess2rt_tpu_torch.parallel import mp_dryrun
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import ROOT, assert_frame_close, jax_leaves

torch.set_num_threads(2)

# the keys of bench.py's JSON line per metric (bench.py:135-143, :226-235,
# :320-335, :388-397, :493-499, :546-551); the twin's --check line names its
# metric kernel_check for bench.py's mosaic_check
KEYS = ("metric", "value", "unit", "vs_baseline")
CHECK_KEYS = KEYS + ("pixels_close", "adaptive_close", "oracle_within1", "grad_finite", "grad_nonzero",
                     "kernels_launched", "ok")
SIZE = (64, 48)


def _lecture5_standin(path):
    """lecture5.sdl's stand-in: the stand-in without the mirror sphere that
    bench.py's ``build`` adds."""
    sc = flagship_standin(JT)
    sc.nodes = [n for n in sc.nodes if n.name != "mirror_ball"]
    sc.shaders = [s for s in sc.shaders if s.name != "mirror"]
    sc.geometries = [g for g in sc.geometries if g.name != "mb"]
    return sc


def _load(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_bench():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loader, "parse_scene_from_file", _lecture5_standin)
        yield _load("bench")


@pytest.fixture(scope="module")
def jax_counts(root_bench):
    """The root bench.py's ``main_verify_counts`` at 64x48: {kind: (full,
    extrapolated)} and its printed delta."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(root_bench, "WIDTH", SIZE[0])
        mp.setattr(root_bench, "HEIGHT", SIZE[1])
        out, err = io.StringIO(), io.StringIO()
        with jax.disable_jit(), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            root_bench.main_verify_counts()
    counts = {k: (float(full), float(ex)) for k, full, ex in
              re.findall(r"# (\w+): full (\d+) vs extrapolated (\d+)", err.getvalue())}
    return counts, json.loads(out.getvalue().strip().splitlines()[-1])["value"]


def _one_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _assert_counts(got, want):
    """camera exactly, shadow and bounce within 0.1%."""
    assert set(got) == set(want) == {"camera", "shadow", "bounce"}
    assert got["camera"] == want["camera"]
    for k in ("shadow", "bounce"):
        assert want[k] > 0 and abs(got[k] - want[k]) <= 1e-3 * want[k], (k, got[k], want[k])


def test_builds_pack_as_the_root_bench(root_bench):
    """The twin's ``build`` packs bench.py's scene: the same leaves, bit for
    bit, and the same static."""
    import dataclasses

    jp, js = root_bench.build(32, 24)
    tp, ts = bench.build(32, 24, device="cpu")
    want, got = jax_leaves(jp), to_numpy(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def test_verify_counts_match_the_root_bench(jax_counts, capsys):
    counts, delta = jax_counts
    r = bench.main_verify_counts(*SIZE, device="cpu")
    line = _one_line(capsys)
    assert line == r["line"] and set(line) == set(KEYS) and line["metric"] == "count_extrapolation_delta"
    _assert_counts(r["full"], {k: full for k, (full, _) in counts.items()})
    _assert_counts({k: 16 * v for k, v in r["quarter"].items()}, {k: ex for k, (_, ex) in counts.items()})
    assert abs(line["value"] - delta) <= 1e-3, (line["value"], delta)


def test_main_counts_rays_as_the_root_bench(jax_counts, capsys):
    """``main``'s rays are bench.py's quarter-scale counts x 16 x 5 taps."""
    counts, _ = jax_counts
    r = bench.main(*SIZE, device="cpu")
    line = _one_line(capsys)
    _assert_counts(r["rays"], {k: 5 * ex for k, (_, ex) in counts.items()})
    assert r["total_rays"] == sum(r["rays"].values())
    assert line["value"] == round(r["total_rays"] / (r["ms"] / 1000.0), 1)
    assert line["vs_baseline"] == round(line["value"] / bench.REFERENCE_TOTAL_RAYS_PER_SEC, 2)


# each mode at a tiny size on the CPU
MODES = [
    ("rays_per_sec_chip", lambda: bench.main(32, 24, device="cpu")),
    ("grad_rays_per_sec", lambda: bench.cli(["--grad", "--size", "32x24", "--steps", "1", "--device", "cpu"])),
    ("gi_grad_paths_per_sec", lambda: bench.main_grad_gi(16, 12, steps_per_call=1, paths=2, device="cpu")),
    ("sharded_frame_ms", lambda: bench.main_sharded(32, 24, device="cpu")),
    ("kernel_check", lambda: bench.main_check(32, 24, device="cpu")),
    ("count_extrapolation_delta", lambda: bench.main_verify_counts(32, 24, device="cpu")),
]


@pytest.mark.parametrize("mode,call", MODES, ids=[m for m, _ in MODES])
def test_every_mode_prints_its_line(mode, call, capsys):
    """Each mode on the CPU at a tiny size prints one JSON line with
    bench.py's keys and a finite, positive value; ``--check`` passes, with
    no kernel to launch on the CPU.  ``--grad`` goes through the command
    line (bench.py has no --paths flag: GI at 16x12, 2 paths, 1 step)."""
    r = call()
    line = _one_line(capsys)
    assert line["metric"] == mode
    assert tuple(line) == (CHECK_KEYS if mode == "kernel_check" else KEYS)
    assert math.isfinite(line["value"]) and line["value"] > 0, line
    if mode == "kernel_check":
        assert r["line"] == line and line["ok"] is True and line["value"] < 5e-4, line
        assert line["kernels_launched"] is None


@pytest.mark.parametrize("argv,want,ok,rc", [
    ([], ("main", ()), True, 0),
    (["--size", "32x24"], ("main", ()), True, 0),
    (["--grad"], ("main_grad", (640, 480, 8)), True, 0),
    (["--grad", "--size", "1920x1080"], ("main_grad", (1920, 1080, 4)), True, 0),
    (["--grad", "--gi", "--size", "32x24", "--steps", "2"], ("main_grad_gi", (32, 24, 2)), True, 0),
    (["--grad", "--gi", "--size", "1920x1080"], ("main_grad_gi", (1920, 1080, 1)), True, 0),
    (["--sharded", "--size", "32x24"], ("main_sharded", ()), True, 0),
    (["--check"], ("main_check", ()), True, 0),
    (["--check"], ("main_check", ()), False, 1),
    (["--verify-counts", "--steps", "2"], ("main_verify_counts", ()), True, 0),
])
def test_cli_dispatches_as_the_root_bench(argv, want, ok, rc, monkeypatch):
    """bench.py's dispatch (bench.py:554-576): ``--size`` and ``--steps``
    reach ``--grad`` alone, with bench.py's step defaults; ``--check``
    exits 1 on a failed verdict; ``--device`` reaches every mode."""
    calls = []

    def stub(name):
        def run(*args, device=None):
            calls.append((name, args, device))
            return {"line": {"ok": ok}}
        return run

    for name in ("main", "main_grad", "main_grad_gi", "main_sharded", "main_check", "main_verify_counts"):
        monkeypatch.setattr(bench, name, stub(name))
    assert bench.cli(argv + ["--device", "cpu"]) == rc
    assert calls == [(*want, "cpu")]


def test_entry_matches_graft_entry(monkeypatch):
    """``entry.entry`` renders what ``__graft_entry__.entry`` renders (its
    lecture5.sdl the whole stand-in, mirror sphere included): the same
    leaves, and the frames at the frame limits; ``dryrun_multichip`` is the
    process dryrun's."""
    monkeypatch.setattr(jax_loader, "parse_scene_from_file", lambda path: flagship_standin(JT))
    jfn, (jp, jkey) = _load("__graft_entry__").entry()
    want = np.asarray(jax.jit(jfn)(jp, jkey))
    fn, (tp, key) = entry.entry(device="cpu")
    assert tp.device.type == "cpu" and (key == np.asarray(jkey)).all()
    for k, v in jax_leaves(jp).items():
        np.testing.assert_array_equal(to_numpy(tp)[k], v, err_msg=k)
    with torch.no_grad():
        got = fn(tp, key).numpy()
    assert got.shape == (120, 160, 3)
    assert_frame_close(got, want)
    assert entry.dryrun_multichip is mp_dryrun.dryrun_multichip
