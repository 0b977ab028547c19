"""Distribution in the port beyond one process's 1-D mesh: the sharded
Monte-Carlo and GI gradient steps against ``jax.value_and_grad`` of the JAX
package's sharded step, the 2-D (hosts, chips) mesh against the 1-D mesh,
``fit`` over a mesh with a checkpoint restart, and real OS processes over
``torch.distributed`` (gloo on the CPU): ``dryrun_multichip`` with its
two-process dryruns, 1-D and 2x2, against the in-process mesh, a failing
or slow rank, and the CLI's ``--distributed`` in two processes.

Limits:
* the sharded steps: the repo's frame-gradient rule (the loss to 1e-4;
  every scene leaf at rtol 5e-3 of its largest JAX gradient, the camera at
  rtol 0.1; tests/test_pallas_grad.py:108, :130-139), 4 shards, the same
  key, the port's K1 path (plain K1 on the CPU) and its twin path;
* the 2-D mesh: the frame bit-equal to the 1-D mesh's, the loss at rtol
  1e-6, the leaves at rtol 1e-5, atol 1e-7 (__graft_entry__.py:128-131);
* processes against the in-process mesh: the loss at rtol 1e-5, the leaves
  at rtol 1e-4, atol 1e-6 (__graft_entry__.py:159-163);
* a checkpoint restart: the losses equal exactly, in one process and
  across two.

Each process test has its own timeout (at most 120 s) that kills its ranks.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.parallel import mesh as JM
from chess2rt_tpu_torch.grad import InverseProblem, fit
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_numpy, leaves, replace_leaves, to_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.parallel import (
    initialize_distributed,
    is_primary,
    make_mesh,
    make_mesh_2d,
    make_sharded_render_fn,
    make_sharded_value_and_grad,
)
from chess2rt_tpu_torch.parallel import mp_dryrun
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin, gi_standin

from torch_port_cases import CAMERA_GRAD_LEAVES, compare_grads, jax_leaves

torch.set_num_threads(2)

W, H, SHARDS, KEY = 17, 11, 4, 3


def _dof_scene(T):
    """csg_free_scene (the class of lecture4.sdl) with DoF, 2 samples."""
    sc = csg_free_scene(T, 0, W, H)
    c = sc.camera
    c.dof, c.numSamples, c.focalPlaneDist, c.fNumber, c.discMultiplier = True, 2, 250.0, 2.0, 5.0
    return sc


STEPS = {
    "dof": (_dof_scene, {"aa_enabled": False}),
    "gi": (lambda T: gi_standin(T, W, H, paths=2), {"aa_enabled": False, "gi_point_light_direct": True}),
}


@functools.lru_cache(maxsize=None)
def _jax_step(case):
    """jax.value_and_grad of the JAX package's sharded step (its XLA
    sampler), and the port's scene on the JAX leaves."""
    build, knobs = STEPS[case]
    jp, js = jax_pack_scene(build(JT), dtype=jnp.float32)
    js = dataclasses.replace(js, use_pallas=False, **knobs)
    target = np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32)
    vg = JM.make_sharded_value_and_grad(js, JM.make_mesh(jax.devices()[:SHARDS]))
    loss, g = vg(jp, jnp.asarray(target), jax.random.PRNGKey(KEY))
    _, ts = torch_pack_scene(build(TT), device="cpu")
    ts = dataclasses.replace(ts, **knobs)
    return float(loss), jax_leaves(g), from_numpy(jax_leaves(jp), ts, device="cpu"), ts, target


@pytest.mark.parametrize("case", sorted(STEPS))
@pytest.mark.parametrize("tracer", ["K1", "twin"])
def test_sharded_step_matches_jax_value_and_grad(case, tracer):
    loss_j, want, tp, ts, target = _jax_step(case)
    kw = {} if tracer == "K1" else {"trace": None}
    loss, grads = make_sharded_value_and_grad(ts, make_mesh(["cpu"] * SHARDS), **kw)(
        tp, torch.from_numpy(target), prng.PRNGKey(KEY))
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-4)
    have = to_numpy(grads)
    scene = [k for k in LEAF_NAMES if not k.startswith("camera.")]
    compare_grads(have, want, scene, rtol=5e-3, skip_zero=True)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)


@pytest.fixture(scope="module")
def standin():
    tp, ts = torch_pack_scene(flagship_standin(TT, W, H, dof=True, samples=2), device="cpu")
    return tp, dataclasses.replace(ts, aa_enabled=False)


@pytest.mark.parametrize("mode", ["dof", "deterministic"])
def test_2d_mesh_frame_and_grads_match_1d(standin, mode):
    """Pixels tile the (2, 4) grid in row-major order, so the frame is the
    1-D mesh's bit for bit; the gradient sums per host row, then over rows."""
    tp, ts = standin
    if mode == "deterministic":
        ts = dataclasses.replace(ts, dof=False)
    grid = make_mesh_2d(["cpu"] * 8)
    assert grid.shape == (2, 4)
    line = make_mesh(["cpu"] * 8)
    key = prng.PRNGKey(KEY)
    img = make_sharded_render_fn(ts, grid)(tp, key)
    assert torch.equal(img, make_sharded_render_fn(ts, line)(tp, key))
    target = torch.zeros_like(img)
    l1, g1 = make_sharded_value_and_grad(ts, line)(tp, target, key)
    l2, g2 = make_sharded_value_and_grad(ts, grid)(tp, target, key)
    np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
    for name, a, b in zip(LEAF_NAMES, leaves(g2), leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_fit_over_a_mesh_restarts_exactly(standin, tmp_path):
    """``fit`` over a 2-D mesh (DoF, fresh keys per step) with a checkpoint
    after step 2, cut, resumed: the losses equal the uninterrupted run's
    exactly."""
    tp, ts = standin
    with torch.no_grad():
        target = make_sharded_render_fn(ts, make_mesh(["cpu"]))(tp, prng.PRNGKey(0))
    wrong = replace_leaves(tp, {"mat_color": tp.mat_color * 0.6 + 0.1})
    prob = InverseProblem(static=ts, target=target, train_fields=("mat_color",), learning_rate=3e-2, steps=4,
                          mesh=make_mesh_2d(["cpu"] * 4))
    whole, losses = fit(wrong, prob, key=prng.PRNGKey(1))
    assert len(losses) == 4 and np.isfinite(losses).all()
    prob = dataclasses.replace(prob, checkpoint_path=str(tmp_path / "fit.pt"), checkpoint_every=2)

    class Cut(Exception):
        pass

    def cut(i, loss):
        if i == 2:
            raise Cut

    with pytest.raises(Cut):
        fit(wrong, prob, key=prng.PRNGKey(1), on_step=cut)
    resumed, rest = fit(wrong, prob, key=prng.PRNGKey(1))
    assert rest == losses[2:]
    assert torch.equal(resumed.mat_color, whole.mat_color)


def test_dryrun_multichip():
    """The whole distributed training path (the port's __graft_entry__
    twin): Adam steps and a checkpoint restart on a 2-entry mesh, the 2-D
    mesh, the kernel path against the twin, and two gloo OS processes, 1-D
    (a device each) and 2x2 (two each, one host row per process), against
    the in-process mesh at the process rule; it raises on any
    disagreement."""
    out = mp_dryrun.dryrun_multichip(2, "cpu", timeout=120)
    assert len(out["losses"]) == 3 and out["mesh2d_shape"] == (1, 2)
    assert out["mp_1-D_loss"] == pytest.approx(out["loss"], rel=1e-5)
    assert out["mp_2x2_loss"] == pytest.approx(out["loss"], rel=1e-5)


def test_a_failing_or_slow_rank_fails_the_run_within_its_timeout():
    """A rank that cannot start (a bad size) fails the run with its output;
    a run past its timeout is killed, every rank with it."""
    with pytest.raises(RuntimeError, match="a rank failed"):
        mp_dryrun.run_multiprocess_dryrun(2, 0, 3, timeout=60, device="cpu")
    with pytest.raises(RuntimeError, match="timed out"):
        mp_dryrun.run_multiprocess_dryrun(2, 17, 3, timeout=0.5, device="cpu")


FIT_RANK = """
import dataclasses, json, os, sys
import torch
torch.set_num_threads(2)
from chess2rt_tpu_torch.grad import InverseProblem, fit
from chess2rt_tpu_torch.models import types as T
from chess2rt_tpu_torch.models.packed import pack_scene, replace_leaves
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.parallel import initialize_distributed, make_mesh, make_mesh_2d, make_sharded_render_fn
from chess2rt_tpu_torch.scenes import flagship_standin

addr, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_distributed(addr, 2, rank, local_devices=["cpu", "cpu"])
tp, ts = pack_scene(flagship_standin(T, 17, 11, dof=True, samples=2), device="cpu")
ts = dataclasses.replace(ts, aa_enabled=False)
with torch.no_grad():
    target = make_sharded_render_fn(ts, make_mesh(["cpu"]))(tp, prng.PRNGKey(0))
wrong = replace_leaves(tp, {"mat_color": tp.mat_color * 0.6 + 0.1})
prob = InverseProblem(static=ts, target=target, train_fields=("mat_color",), learning_rate=3e-2, steps=4,
                      mesh=make_mesh_2d(), checkpoint_every=2)
_, whole = fit(wrong, prob, key=prng.PRNGKey(1))

class Cut(Exception):
    pass

def cut(i, loss):
    if i == 2:
        raise Cut

# one path for both processes (a shared filesystem): both save, both resume
shared = dataclasses.replace(prob, checkpoint_path=os.path.join(work, "fit.pt"))
try:
    fit(wrong, shared, key=prng.PRNGKey(1), on_step=cut)
except Cut:
    pass
_, rest = fit(wrong, shared, key=prng.PRNGKey(1))
# a path of each process's own, and the second's checkpoint lost
own = dataclasses.replace(prob, checkpoint_path=os.path.join(work, f"rank{rank}.pt"))
try:
    fit(wrong, own, key=prng.PRNGKey(1), on_step=cut)
except Cut:
    pass
if rank == 1:
    os.remove(own.checkpoint_path)
try:
    fit(wrong, own, key=prng.PRNGKey(1))
    refused = None
except RuntimeError as e:
    refused = str(e)
print("RESULT " + json.dumps({"whole": whole, "rest": rest, "refused": refused}), flush=True)
"""


def test_fit_across_two_processes_restarts_exactly(standin, tmp_path):
    """``fit`` over the 2-D mesh of two gloo processes (two entries each):
    the losses meet the in-process (2, 2) mesh's at the process rule, every
    process saves the checkpoint and a restart from it reproduces the
    losses exactly; when one process has lost its checkpoint, both refuse
    to resume instead of summing gradients of different steps."""
    addr = f"localhost:{mp_dryrun.free_port()}"
    outs = mp_dryrun.run_ranks([[sys.executable, "-c", FIT_RANK, addr, str(r), str(tmp_path)] for r in range(2)],
                               timeout=120)
    got = [json.loads(o.split("RESULT ", 1)[1].splitlines()[0]) for o in outs]
    assert got[0]["whole"] == got[1]["whole"] and len(got[0]["whole"]) == 4
    for g in got:
        assert g["rest"] == g["whole"][2:]
        assert "resume at steps [2, 0]" in g["refused"]
    tp, ts = standin
    with torch.no_grad():
        target = make_sharded_render_fn(ts, make_mesh(["cpu"]))(tp, prng.PRNGKey(0))
    wrong = replace_leaves(tp, {"mat_color": tp.mat_color * 0.6 + 0.1})
    prob = InverseProblem(static=ts, target=target, train_fields=("mat_color",), learning_rate=3e-2, steps=4,
                          mesh=make_mesh_2d(["cpu"] * 4, hosts=2))
    _, losses = fit(wrong, prob, key=prng.PRNGKey(1))
    np.testing.assert_allclose(got[0]["whole"], losses, rtol=1e-5)


def test_initialize_distributed_without_a_launcher_is_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    info = initialize_distributed()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert not torch.distributed.is_initialized() and is_primary()


def test_cli_distributed_in_two_processes(tmp_path):
    """``python -m chess2rt_tpu_torch --distributed --device cpu`` under a
    launcher's environment in two processes: the first writes the BMP, equal
    byte for byte to the one-process render of the same file."""
    from chess2rt_tpu_torch.scenes import write_standin_sdl

    path = write_standin_sdl(str(tmp_path), 24, 16)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(mp_dryrun.free_port()))
    outs = mp_dryrun.run_ranks([["env", f"RANK={r}", sys.executable, "-m", "chess2rt_tpu_torch", "--file", path,
                                 "-o", str(tmp_path / f"out{r}.bmp"), "--device", "cpu", "--distributed", "-q"]
                                for r in range(2)], timeout=120, env=env)
    assert "backend gloo" in outs[0]
    assert (tmp_path / "out0.bmp").exists() and not (tmp_path / "out1.bmp").exists()
    single = tmp_path / "single.bmp"
    from chess2rt_tpu_torch import app

    assert app.main(["--file", path, "-o", str(single), "--device", "cpu", "-q"]) == 0
    assert (tmp_path / "out0.bmp").read_bytes() == single.read_bytes()
