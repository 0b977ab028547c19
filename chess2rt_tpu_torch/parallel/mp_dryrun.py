"""A real multi-process bring-up: N OS processes, a TCP rendezvous, one
sharded gradient step.

Counterpart of chess2rt_tpu/parallel/mp_dryrun.py.  ``run_multiprocess_
dryrun`` spawns N ranks; each brings up ``torch.distributed``
(``initialize_distributed``), builds the mesh over every rank's devices
(1-D, or the 2-D (hosts, chips) mesh with one host row per process) and
runs one ``make_sharded_value_and_grad`` step on the flagship stand-in
(``scenes.flagship_standin``, AA off; the JAX package reads lecture5.sdl,
which is not in the repository).  Summing the shards' gradients makes the
result independent of the shard count, so the caller holds rank 0's loss
and gradients to the in-process mesh's.

Entry points:

* ``python -m chess2rt_tpu_torch.parallel.mp_dryrun --coordinator HOST:PORT
  --num-processes N --process-id I --width W --height H --out F.npz
  [--mesh2d] [--devices-per-process K] [--device cuda|cpu]``: one rank;
* ``run_multiprocess_dryrun(...)``: spawns the ranks and returns rank 0's
  (loss, gradient leaves, backend, kernel launches);
* ``dryrun_multichip(n_devices, device)``: the whole distributed training
  path in one call (Adam steps on a mesh, a checkpoint restart, the 2-D
  mesh, the kernel path against the twin, the process dryruns);
* ``run_ranks(commands, timeout)``: the launcher under both, one OS process
  per command.

Every entry point runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``), and raises when there is no card.

Ranks on the CPU use gloo; on one card both ranks share it, and share K1's
build directory (libraries are written under a temporary name and renamed,
so concurrent builds cannot clash; callers build once before spawning).
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

from ..models.packed import _resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build(width: int, height: int, device):
    from ..models import types as T
    from ..models.packed import pack_scene
    from ..scenes import flagship_standin

    sc = flagship_standin(T, width, height)
    sc.settings.AAEnabled = False
    return pack_scene(sc, device=device)


def worker_main(argv=None) -> None:
    """One rank: bring up the process group, build the global mesh, run ONE
    sharded gradient step; rank 0 saves the loss and gradient leaves."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh2d", action="store_true",
                    help="the 2-D (hosts x chips) mesh, one host row per process")
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    dev = str(_resolve_device(None if args.device == "cuda" else "cpu", "mp_dryrun"))
    torch.set_num_threads(2)
    from ..models.packed import LEAF_NAMES, leaves
    from ..ops import prng
    from ..ops import round0 as R
    from ..ops import texel_hist as K2
    from .distributed import all_reduce_sum, backend, barrier, initialize_distributed, is_primary, shutdown
    from .mesh import make_mesh, make_mesh_2d, make_sharded_value_and_grad

    info = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                  local_devices=[dev] * args.devices_per_process)
    assert info["process_count"] == args.num_processes, info
    assert info["global_devices"] == args.num_processes * args.devices_per_process, info

    packed, static = _build(args.width, args.height, dev)
    if args.mesh2d:
        mesh = make_mesh_2d(hosts=args.num_processes)
        assert mesh.shape == (args.num_processes, args.devices_per_process), mesh.shape
    else:
        mesh = make_mesh()  # every process's devices
    vg = make_sharded_value_and_grad(static, mesh)
    target = torch.zeros((static.height, static.width, 3), dtype=torch.float32, device=dev)
    loss, grads = vg(packed, target, prng.PRNGKey(0))
    # every rank's kernel launches (K1 all forms, its residual and lin-input
    # forms, K2), summed over the ranks
    counts = torch.tensor([R.launches, R.resid_launches, R.lin_launches, K2.launches], dtype=torch.float64)
    counts = all_reduce_sum(counts)
    if is_primary():
        np.savez(args.out, loss=loss.item(), backend=backend(), launches=counts.numpy(),
                 **{f"g{i}": g.detach().cpu().numpy() for i, g in enumerate(leaves(grads))},
                 n_leaves=len(LEAF_NAMES))
    # every rank waits until rank 0 has written: a real cross-process
    # barrier, so no rank tears the group down under a slow save
    barrier()
    shutdown()


def free_port() -> int:
    """A free TCP port on localhost, from a socket bound to port 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(commands, timeout: float, env=None):
    """Run one OS process per command (the ranks of one job, the package's
    directory on PYTHONPATH, 2 OpenMP threads each) until all exit; returns
    their outputs.  Any rank that fails, or the job passing ``timeout``
    seconds, kills every rank and raises with the ranks' output: nothing
    hangs."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join([_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "2"
    work = tempfile.mkdtemp(prefix="c2rt_ranks_")
    procs, logs = [], []
    for rank, cmd in enumerate(commands):
        log = open(os.path.join(work, f"rank{rank}.log"), "w+")
        procs.append(subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)

    def outputs():
        for log in logs:
            log.seek(0)
        return [log.read() for log in logs]

    def tails():
        return "\n".join(f"rank {r} rc={p.poll()}:\n{o[-3000:]}" for r, (p, o) in enumerate(zip(procs, outputs())))

    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                raise RuntimeError("a rank failed:\n" + tails())
            if time.monotonic() > deadline:
                raise RuntimeError(f"timed out after {timeout} s:\n" + tails())
            time.sleep(0.05)
        if any(p.returncode for p in procs):
            raise RuntimeError("a rank failed:\n" + tails())
        return outputs()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def run_multiprocess_dryrun(num_processes: int = 2, width: int = 17, height: int = 3, timeout: float = 600,
                            devices_per_process: int = 1, mesh2d: bool = False, device=None):
    """Spawn ``num_processes`` ranks rendezvousing on a fresh localhost
    port (``run_ranks``); returns rank 0's (loss, [gradient leaves in
    LEAF_NAMES order], the process group's backend, the ranks' kernel
    launches summed: {"k1", "k1_resid", "k1_lin", "k2"}).  Each rank caps
    torch at 2 threads; nothing falls back to one process.

    ``devices_per_process`` > 1 with ``mesh2d``: the (hosts, chips) mesh
    across real process boundaries (the host stage of the gradient sum
    crosses processes, the chip stage stays in one).  ``device`` None runs
    every rank on the card (two ranks share one card under gloo) and raises
    without one; "cpu" runs them on the CPU."""
    import numpy as np

    device = _resolve_device(device, "run_multiprocess_dryrun").type
    coordinator = f"localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="c2rt_mp_") as work:
        out = os.path.join(work, "rank0.npz")
        run_ranks([[sys.executable, "-m", "chess2rt_tpu_torch.parallel.mp_dryrun", "--coordinator", coordinator,
                    "--num-processes", str(num_processes), "--process-id", str(rank), "--width", str(width),
                    "--height", str(height), "--out", out, "--devices-per-process", str(devices_per_process),
                    "--device", device] + (["--mesh2d"] if mesh2d else []) for rank in range(num_processes)],
                  timeout)
        data = dict(np.load(out))
    grads = [data[f"g{i}"] for i in range(int(data["n_leaves"]))]
    launches = dict(zip(("k1", "k1_resid", "k1_lin", "k2"), (int(x) for x in data["launches"])))
    return float(data["loss"]), grads, str(data["backend"]), launches


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600) -> dict:
    """The whole distributed training path over an ``n_devices``-entry mesh
    of ``device`` (None: the current card, raising without one; "cpu"),
    the port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``;
    raises on any disagreement and returns what it measured.

    * 3 Adam steps on a 1-D mesh, a checkpoint after step 1 (grad/
      checkpoint.py), whose restart reproduces steps 2 and 3's losses
      exactly;
    * the 2-D (hosts, chips) mesh's loss and gradients against the 1-D
      mesh's (loss rtol 1e-6; leaves rtol 1e-5, atol 1e-7);
    * the kernel path's loss against the twin's on the same mesh (rtol
      2e-2, the JAX package's fused-against-XLA rule), finite gradients;
    * with 2 or more entries, the 2-process dryrun, 1-D and 2x2, against
      the in-process mesh (loss rtol 1e-5; leaves rtol 1e-4, atol 1e-6),
      each run killed past ``timeout`` seconds."""
    import numpy as np
    import torch

    from ..grad.checkpoint import load_checkpoint, save_checkpoint
    from ..models.packed import leaves
    from ..ops import prng
    from .mesh import make_mesh, make_mesh_2d, make_sharded_value_and_grad

    dev = _resolve_device(device, "dryrun_multichip")
    mesh = make_mesh([dev] * n_devices)
    # a tiny frame whose pixel count the entry count does not divide (padding)
    width, height = 2 * n_devices + 1, 3
    packed, static = _build(width, height, dev)
    vg = make_sharded_value_and_grad(static, mesh)
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    key = prng.PRNGKey(0)

    def run(start, steps, state=None):
        """Adam (lr 1e-3) on every float leaf from a fresh copy, or from the
        checkpoint ``state``; returns the losses of steps [start, steps)."""
        from ..models.packed import from_leaves

        xs = [x.detach().clone() for x in leaves(packed)]
        params = [x for x in xs if x.is_floating_point()]
        opt = torch.optim.Adam(params, lr=1e-3)
        p = from_leaves(xs)
        if state is not None:
            assert load_checkpoint(state, p, opt) == start
        losses = []
        for step in range(start, steps):
            loss, grads = vg(p, target, prng.fold_in(key, step))
            for x, g in zip(xs, leaves(grads)):
                if x.is_floating_point():
                    x.grad = g
            opt.step()
            losses.append(loss.item())
            if step == 0 and state is None:
                save_checkpoint(ckpt, p, opt, step=1)
        return losses

    with tempfile.TemporaryDirectory(prefix="c2rt_dryrun_") as work:
        ckpt = os.path.join(work, "step1.pt")
        losses = run(0, 3)
        assert all(np.isfinite(losses)), losses
        resumed = run(1, 3, ckpt)
    assert resumed == losses[1:], f"the restart diverged: {resumed} != {losses[1:]}"
    out = {"losses": losses}

    l1, g1 = vg(packed, target, key)
    if n_devices >= 2:
        mesh2 = make_mesh_2d([dev] * n_devices)
        l2, g2 = make_sharded_value_and_grad(static, mesh2)(packed, target, key)
        np.testing.assert_allclose(l2.item(), l1.item(), rtol=1e-6)
        for a, b in zip(leaves(g2), leaves(g1)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-7)
        out["mesh2d_shape"] = mesh2.shape
    lt, _ = make_sharded_value_and_grad(static, mesh, trace=None)(packed, target, key)
    np.testing.assert_allclose(l1.item(), lt.item(), rtol=2e-2, atol=1e-6)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(g1) if g.is_floating_point())
    out["loss"], out["twin_loss"] = l1.item(), lt.item()

    if n_devices >= 2:
        ref = [g.cpu().numpy() for g in leaves(g1)]
        for label, kw in (("1-D", {}), ("2x2", {"devices_per_process": 2, "mesh2d": True})):
            mp_loss, mp_grads, _, _ = run_multiprocess_dryrun(2, width, height, timeout, device=dev.type, **kw)
            np.testing.assert_allclose(mp_loss, l1.item(), rtol=1e-5)
            assert len(mp_grads) == len(ref)
            for a, b in zip(mp_grads, ref):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
            out[f"mp_{label}_loss"] = mp_loss
    return out


if __name__ == "__main__":
    worker_main()
