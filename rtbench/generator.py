"""The one traffic generator: what a traffic file's parameters make from
``--seed``.

A traffic file (``rtbench/traffic/<name>.json``) names a closed loop of one
client, of frames or of gradient steps, and its parameters; this module turns
them and the seed into each item's threefry key and camera offset, the same
for the program and for the reference (``Inputs``).

The camera walks as the interactive session drives it: each item is one key
press of the traffic's ``walk`` (session moves ``[right, up, forward]`` in
world units, chess2rt_tpu_torch/gui/session.py ``CONTROLS``:
raytracer_demo.d:275-304's dMove = 32), taken in the camera's basis as
``Camera.move`` takes it, and after the last move the walk starts again.
The walk is the same for every seed, so every seed renders the same poses.
On top of its pose each item moves by a jitter, a frozen copy of
chess2rt_tpu_torch/bench.py ``_jittered`` at commit d735142:
``(uniform(key, (3,)) - 0.5) * jitter`` units under the item's key, under
which the frame or step is also rendered.  Item ``i`` of the window has the
key ``fold_in(PRNGKey(seed), i)`` and warm-up item ``j`` the key
``fold_in(fold_in(PRNGKey(seed), WARM_STREAM), j)``, so that no two items of
a run repeat each other and the same seed gives the same items.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .reference import prng

HERE = os.path.dirname(os.path.abspath(__file__))
WARM_STREAM = 0xFFFFFFFF
LOOPS = ("frames", "steps")


def load_traffic(name: str) -> dict:
    """The traffic file ``traffic/<name>.json``, checked."""
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    if t.get("loop") not in LOOPS:
        raise ValueError(f"traffic {name}: loop must be one of {LOOPS}, got {t.get('loop')!r}")
    if t.get("clients") != 1:
        raise ValueError(f"traffic {name}: the closed loop has one client")
    for k in ("warmup", "check_items", "trace_items"):
        if int(t.get(k, 0)) < 1:
            raise ValueError(f"traffic {name}: {k} must be at least 1")
    moves = np.asarray(t.get("walk", {}).get("moves", []), dtype=np.float64)
    if moves.ndim != 2 or moves.shape[1] != 3 or len(moves) < 2 or not moves.any(axis=1).all():
        raise ValueError(f"traffic {name}: walk.moves must be two or more non-zero [right, up, forward] moves")
    if np.abs(moves.sum(axis=0)).max() > 1e-9:
        raise ValueError(f"traffic {name}: the walk must end where it starts")
    return t


def seed_key(seed: int) -> np.ndarray:
    """The run's root key: ``PRNGKey`` of the seed's 64 low bits."""
    return prng.PRNGKey(int(seed) & 0xFFFFFFFFFFFFFFFF)


def item_key(seed: int, i: int) -> np.ndarray:
    """The key of item ``i`` of the measured window (and of the traced items
    after it)."""
    return prng.fold_in(seed_key(seed), i)


def warm_key(seed: int, j: int) -> np.ndarray:
    """The key of warm-up item ``j``."""
    return prng.fold_in(prng.fold_in(seed_key(seed), WARM_STREAM), j)


def jitter(key, scale: float) -> np.ndarray:
    """The camera's jitter for an item, as bench.py's ``_jittered`` draws it:
    ``(uniform(key, (3,)) - 0.5) * scale``, the three uniforms threefry's
    float32 draw (``prng.uniform_reference``) done in numpy, a few
    microseconds on the host."""
    b1, b2 = prng._threefry_np((key[:1], key[1:]), np.zeros(3, np.uint32), np.arange(3, dtype=np.uint32))
    u = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return (u - np.float32(0.5)) * np.float32(scale)


def walk_poses(moves, basis) -> np.ndarray:
    """[P, 3] world offsets of the walk's P poses from the camera's start:
    pose ``p`` is where the first ``p`` moves lead, each move ``(dx, dy,
    dz)`` taken along the camera's ``basis`` (right, up, front) as
    ``Camera.move`` takes it."""
    moves = np.asarray(moves, dtype=np.float64)
    world = moves @ np.stack([np.asarray(b, dtype=np.float64) for b in basis])
    return np.concatenate([np.zeros((1, 3)), np.cumsum(world, axis=0)[:-1]])


class Inputs:
    """A run's items: ``item(i)`` is the key and camera offset of item ``i``
    of the window (and of the traced items after it), ``warm(j)`` those of
    warm-up item ``j``.  ``poses`` are the traffic's walk in world offsets
    along the camera's ``basis`` (``walk_poses``); the offset is the pose,
    rounded to float32, plus the jitter."""

    def __init__(self, seed: int, traffic: dict, basis):
        self.seed, self.scale = int(seed), float(traffic["jitter"])
        self.poses = walk_poses(traffic["walk"]["moves"], basis).astype(np.float32)

    def _offset(self, i: int, key) -> np.ndarray:
        return self.poses[i % len(self.poses)] + jitter(key, self.scale)

    def item(self, i: int):
        key = item_key(self.seed, i)
        return key, self._offset(i, key)

    def warm(self, j: int):
        key = warm_key(self.seed, j)
        return key, self._offset(j, key)


class Reservoir:
    """A uniform sample of ``k`` of the items a window completes, drawn from
    the seed (reservoir sampling): which items are kept depends on the seed
    and on how many items there were, and on nothing else."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(int(seed) & 0xFFFFFFFFFFFFFFFF)
        self.k = k
        self.items = []  # (index, payload)
        self.seen = 0

    def offer(self, index: int, payload, keep=lambda p: p) -> None:
        """Offer item ``index``; ``keep(payload)`` (a copy of a reused
        buffer, say) is taken only when the item is kept."""
        if len(self.items) < self.k:
            self.items.append((index, keep(payload)))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (index, keep(payload))
        self.seen += 1

    def sample(self) -> list:
        return sorted(self.items, key=lambda t: t[0])
