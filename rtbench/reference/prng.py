"""Frozen copy of chess2rt_tpu_torch/ops/prng.py at commit d735142 for the
benchmark's plain reference (the CUDA draws left out: every draw is the plain
PyTorch threefry, and a dtype below float32 draws float32 and rounds).  It
imports nothing of the program.

The port's ``jax.random``: threefry2x32 keys and uniform draws, bit for
bit.

Counterpart of the calls the JAX package makes: ``PRNGKey(seed)``,
``split(key, n)``, ``fold_in(key, i)`` and ``uniform(key, shape, dtype)``
(f32 and f64), with jax's default implementation, threefry2x32 in its
partitionable form (jax/_src/prng.py ``threefry_seed``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; jax/_src/random.py ``_uniform``).
A copy of the algorithm, not an import of it: the port never imports JAX.

* Keys are tiny, so they live on the host as numpy ``uint32[2]`` arrays
  (numpy's unsigned arithmetic wraps exactly): deriving a key costs no
  device work and no sync.
* ``uniform`` draws by the plain PyTorch version alone, on any device (the
  port's CUDA draw and its batched form are left out).  It does the rounds
  in int64 masked to 32 bits (torch has no uint32 add or shift on every
  device); its values stay below 2**32, so a right shift never sees a sign
  bit.
* A draw is positional: element i of a flat draw depends on the key and i
  alone.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA



def _threefry_np(key, x0, x1):
    """threefry2x32 of the counter pairs (x0, x1) (uint32 arrays) under
    ``key``: the 20 rounds of jax/_src/prng.py ``_threefry2x32_lowering``."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The key of an integer seed (``threefry_seed``): its high and low 32
    bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & M32, seed & M32], dtype=np.uint32)


def as_key(key) -> np.ndarray:
    """``key`` (a key of this module, or any pair of uint32 values such as a
    JAX key converted by numpy) as a uint32[2] array; None is PRNGKey(0),
    the JAX package's default."""
    if key is None:
        return PRNGKey(0)
    out = np.asarray(key, dtype=np.uint32)
    if out.shape != (2,):
        raise ValueError(f"a threefry key is two uint32 values, got shape {out.shape}")
    return out


def _counters(n: int):
    """The 64-bit iota of n elements as (high, low) uint32 halves
    (``iota_2x32_shape``)."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(M32)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys, [num, 2] uint32 (``_threefry_split_foldlike``)."""
    b1, b2 = _threefry_np(key, *_counters(num))
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """The key folded with an integer (``_threefry_fold_in``): threefry of
    the counter (0, data mod 2**32)."""
    b1, b2 = _threefry_np(key, np.zeros(1, np.uint32), np.array([int(data) & M32], np.uint32))
    return np.array([b1[0], b2[0]], dtype=np.uint32)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"uniform: float32 or float64 only, got {dtype}")


def _threefry_torch(k1: int, k2: int, x0, x1):
    """The rounds on int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def uniform_reference(key, shape: Union[int, Sequence[int]], dtype=torch.float32, *, device) -> torch.Tensor:
    """The plain PyTorch version of ``uniform``, on any device."""
    _check_dtype(dtype)
    shape = _shape(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry_torch(int(key[0]), int(key[1]), i >> 32, i & M32)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        out = bits.to(torch.int32).view(torch.float32) - 1.0
    else:
        # (b1 << 32 | b2) >> 12, kept below 2**63
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        out = bits.view(torch.float64) - 1.0
    return out.reshape(shape)


def uniform(key, shape: Union[int, Sequence[int]], dtype=torch.float32, *, device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` under ``key``, as
    ``jax.random.uniform(key, shape, dtype)`` draws them, by the plain
    version on any device.  A dtype below float32 (the lower-precision
    control) draws float32 and rounds."""
    if dtype in (torch.float32, torch.float64):
        return uniform_reference(key, shape, dtype, device=device)
    return uniform_reference(key, shape, torch.float32, device=device).to(dtype)
