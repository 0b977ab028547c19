"""Checkpoint / resume for an inverse-rendering run.

Counterpart of chess2rt_tpu/grad/checkpoint.py: a snapshot of the scene's
tensor leaves (models/packed.LEAF_NAMES keys) and the optimizer state,
written atomically (a temporary file, then ``os.replace``), so a run cut
off mid-write leaves the previous checkpoint intact.
"""

from __future__ import annotations

import os

import torch

from ..models.packed import LEAF_NAMES, ScenePacked, leaves


def save_checkpoint(path: str, packed: ScenePacked, optimizer: torch.optim.Optimizer, step: int) -> None:
    """Atomically write the scene leaves, the optimizer state and ``step``."""
    state = {
        "step": int(step),
        "leaves": {k: v.detach().cpu() for k, v in zip(LEAF_NAMES, leaves(packed))},
        "optimizer": optimizer.state_dict(),
    }
    tmp = f"{path}.{os.getpid()}.tmp"  # processes saving to one shared path do not clash
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, packed: ScenePacked, optimizer: torch.optim.Optimizer) -> int:
    """Copy a checkpoint written by save_checkpoint into ``packed``'s leaves
    (in place, so the optimizer keeps its parameters) and into
    ``optimizer``; returns the step it was saved at."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    saved = state["leaves"]
    missing = set(LEAF_NAMES) - set(saved)
    if missing:
        raise KeyError(f"checkpoint {path} is missing leaves {sorted(missing)}")
    with torch.no_grad():
        for k, v in zip(LEAF_NAMES, leaves(packed)):
            if tuple(saved[k].shape) != tuple(v.shape):
                raise ValueError(f"checkpoint {path}: {k} has shape {tuple(saved[k].shape)}, want {tuple(v.shape)}")
            v.copy_(saved[k])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
