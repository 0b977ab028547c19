"""Several processes, one mesh: process bring-up over ``torch.distributed``.

Counterpart of chess2rt_tpu/parallel/distributed.py.  The reference has no
process launcher (one OS process and a thread pool); the JAX package brings
up ``jax.distributed`` and builds a mesh over every chip of every host.
Here ``initialize_distributed`` brings up a ``torch.distributed`` process
group and records each process's devices, after which ``make_mesh()`` and
``make_mesh_2d()`` (parallel/mesh.py) span every process's devices: each
rank renders the shards it owns, and the frame and the gradients cross
processes by all-reduce.

The backend is chosen explicitly and printed:

* ``nccl`` where every rank has a card of its own (no two ranks of a host
  on one device);
* ``gloo`` on the CPU, and where ranks share a card: NCCL refuses two ranks
  on one device.  Gloo reduces CUDA tensors only in some builds, so the
  collectives here copy through the host under gloo.

Typical use (the same command in every process):

    from chess2rt_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed()        # RANK, WORLD_SIZE, MASTER_ADDR from the launcher
    mesh = make_mesh()              # every device of every process
    fn = make_sharded_render_fn(static, mesh)
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# this process's devices, the backend, and every process's devices as
# (rank, device) in rank order: set by initialize_distributed
_local: Optional[List[torch.device]] = None
_backend: Optional[str] = None
_global: Optional[List[Tuple[int, torch.device]]] = None


def _default_local_devices(rank: int) -> List[torch.device]:
    """One card per rank, by local rank; without a card it raises (the CPU
    only when the caller names it in ``local_devices``)."""
    if not torch.cuda.is_available():
        raise RuntimeError('initialize_distributed: no CUDA device; pass local_devices=["cpu"] to run on the CPU')
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return [torch.device("cuda", local_rank % torch.cuda.device_count())]


def _pick_backend(local: Sequence[torch.device], world: int) -> str:
    """nccl when this rank's devices are cards of its own: distinct, and
    enough of them on the host for every local rank (LOCAL_WORLD_SIZE, else
    the world size: one host); else gloo.  Every rank of a symmetric launch
    computes the same."""
    if any(d.type != "cuda" for d in local):
        return "gloo"
    indices = [d.index or 0 for d in local]
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if len(set(indices)) == len(indices) and torch.cuda.device_count() >= local_world * len(local):
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_devices: Optional[Sequence] = None,
) -> dict:
    """Bring up the process group; returns {process_index, process_count,
    local_devices, global_devices} (the JAX package's keys, as counts).

    With no arguments and none of RANK, WORLD_SIZE, MASTER_ADDR in the
    environment, it brings up nothing and reports one process.  An already
    initialized group (``torch.distributed.is_initialized()``) is kept.
    ``coordinator_address`` is ``host:port`` (else MASTER_ADDR and
    MASTER_PORT), ``num_processes`` and ``process_id`` the world size and
    rank (else WORLD_SIZE and RANK).  ``local_devices`` are this process's
    mesh entries (default: its card by LOCAL_RANK; without a card it
    raises).  A failure raises: nothing falls back to one process."""
    global _local, _backend, _global
    env = os.environ
    wanted = coordinator_address or num_processes or any(k in env for k in _LAUNCHER_VARS)
    if not dist.is_initialized() and wanted:
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
        addr = coordinator_address or f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        local = [torch.device(d) for d in (local_devices or _default_local_devices(rank))]
        if local[0].type == "cuda":
            torch.cuda.set_device(local[0])
        backend = _pick_backend(local, world)
        dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=600))
        _local, _backend = local, backend
        names = [None] * world
        dist.all_gather_object(names, [str(d) for d in local])
        _global = [(r, torch.device(d)) for r, ds in enumerate(names) for d in ds]
        print(f"initialize_distributed: rank {rank} of {world}, backend {backend}, "
              f"local devices {[str(d) for d in local]}", flush=True)
    elif dist.is_initialized() and _global is None:
        # a group brought up by the caller: record its devices once
        local = [torch.device(d) for d in (local_devices or _default_local_devices(dist.get_rank()))]
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, [str(d) for d in local])
        _local, _backend = local, dist.get_backend()
        _global = [(r, torch.device(d)) for r, ds in enumerate(names) for d in ds]
    one = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [torch.device("cpu")]
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": len(_local or one),
        "global_devices": len(_global or one),
    }


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True in the process that writes images, checkpoints and logs."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The process group's backend, None in one process."""
    return _backend if dist.is_initialized() else None


def global_devices() -> List[Tuple[int, torch.device]]:
    """Every process's mesh entries as (rank, device), in rank order; None
    until ``initialize_distributed`` brought up several processes."""
    return _global if dist.is_initialized() and process_count() > 1 else None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process (every rank gets it).  Under
    gloo a CUDA tensor is reduced through a host copy."""
    if _backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host)
        return host.to(t.device)
    dist.all_reduce(t)
    return t


def gather(value) -> list:
    """Every process's ``value`` (any picklable object) in rank order;
    ``[value]`` in one process."""
    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def barrier() -> None:
    """A real cross-process barrier (every rank waits for every other)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Tear the process group down (after a ``barrier``)."""
    global _local, _backend, _global
    if dist.is_initialized():
        dist.destroy_process_group()
    _local = _backend = _global = None
