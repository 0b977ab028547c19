"""The port's ``jax.random``: threefry2x32 keys and uniform draws, bit for
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
  device work and no sync.  ``split`` and ``fold_in`` run threefry on
  Python ints (``_threefry_int``, all the keys of a split in one pass),
  since numpy's per-call cost would own its ~70 ufunc calls on a few
  elements.  ``_threefry_np``, the rounds on numpy arrays, is the plain
  version the tests hold them against.
* ``uniform`` draws on the device of the caller's choosing: the CUDA kernel
  csrc/threefry.cu on the card, its plain PyTorch version
  ``uniform_reference`` on the CPU, nothing else.  The plain version does
  the rounds in int64 masked to 32 bits (torch has no uint32 add or shift
  on every device); its values stay below 2**32, so a right shift never
  sees a sign bit.
* A draw is positional: element i of a flat draw depends on the key and i
  alone, so ``uniform(k, (n,))[sel]`` equals the draw of the lanes
  ``sel`` in the full-width frame (the lane-compacted adaptive-AA DoF taps
  rely on this, as JAX's do).
* ``uniform_keys`` is the batched draw, ``jax.vmap`` of ``uniform`` over a
  [K, 2] key array flattened: K slabs of C uniforms, slab j under key j, in
  one launch of csrc/threefry.cu's second kernel (the GI renderer's K
  path-slabs, ops/gi.py); its plain version ``uniform_keys_reference`` is K
  ``uniform_reference`` draws concatenated.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import numpy as np
import torch

from ..utils.spans import span

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# draws made by ``uniform`` and ``uniform_keys`` through the CUDA kernels,
# one per call; chip_smoke.py zeroes it before driving a path and reads it
# after
launches = 0
# the most keys one batched draw takes (csrc/threefry.cu MAX_KEYS)
MAX_KEYS = 256


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


def _threefry_int(k1: int, k2: int, x1: int, rep: int = 1):
    """threefry2x32 on Python ints of the counter pairs (0, x1) under the
    key (k1, k2), both words below 2**32: ``_threefry_np``'s rounds
    unrolled, each line a round (rotations 13, 15, 26, 6, then 17, 29, 16,
    24) or a key injection (the schedule k1, k2, k3 = k1 ^ k2 ^ parity,
    turned by one each time).

    The ints hold their pairs in lanes 64 bits apart, as many lanes as
    ``rep`` (1 in each) has, so one pass derives every key of a split.  A
    word sits in its lane's low 32 bits.  The high 32 bits are a guard: they
    take x0's carries (x0 only adds, and stays below 2**37 a lane), x1's
    carries and the bits a rotation moves out of the word or down from the
    lane above; x1 is masked back to its words after every step, and x0 at
    the end, so no lane reaches another.  Returns the lanes of (x0, x1),
    each word below 2**32."""
    m = M32 * rep
    k3 = (k1 ^ k2 ^ _PARITY) * rep
    k1, k2 = k1 * rep, k2 * rep
    x0 = k1; x1 = (x1 + k2) & m
    x0 += x1; x1 = ((x1 << 13 | x1 >> 19) ^ x0) & m
    x0 += x1; x1 = ((x1 << 15 | x1 >> 17) ^ x0) & m
    x0 += x1; x1 = ((x1 << 26 | x1 >> 6) ^ x0) & m
    x0 += x1; x1 = ((x1 << 6 | x1 >> 26) ^ x0) & m
    x0 += k2; x1 = (x1 + k3 + rep) & m
    x0 += x1; x1 = ((x1 << 17 | x1 >> 15) ^ x0) & m
    x0 += x1; x1 = ((x1 << 29 | x1 >> 3) ^ x0) & m
    x0 += x1; x1 = ((x1 << 16 | x1 >> 16) ^ x0) & m
    x0 += x1; x1 = ((x1 << 24 | x1 >> 8) ^ x0) & m
    x0 += k3; x1 = (x1 + k1 + 2 * rep) & m
    x0 += x1; x1 = ((x1 << 13 | x1 >> 19) ^ x0) & m
    x0 += x1; x1 = ((x1 << 15 | x1 >> 17) ^ x0) & m
    x0 += x1; x1 = ((x1 << 26 | x1 >> 6) ^ x0) & m
    x0 += x1; x1 = ((x1 << 6 | x1 >> 26) ^ x0) & m
    x0 += k1; x1 = (x1 + k2 + 3 * rep) & m
    x0 += x1; x1 = ((x1 << 17 | x1 >> 15) ^ x0) & m
    x0 += x1; x1 = ((x1 << 29 | x1 >> 3) ^ x0) & m
    x0 += x1; x1 = ((x1 << 16 | x1 >> 16) ^ x0) & m
    x0 += x1; x1 = ((x1 << 24 | x1 >> 8) ^ x0) & m
    x0 += k2; x1 = (x1 + k3 + 4 * rep) & m
    x0 += x1; x1 = ((x1 << 13 | x1 >> 19) ^ x0) & m
    x0 += x1; x1 = ((x1 << 15 | x1 >> 17) ^ x0) & m
    x0 += x1; x1 = ((x1 << 26 | x1 >> 6) ^ x0) & m
    x0 += x1; x1 = ((x1 << 6 | x1 >> 26) ^ x0) & m
    x0 += k3; x1 = (x1 + k1 + 5 * rep) & m
    return x0 & m, x1


@functools.lru_cache(maxsize=None)
def _lanes(num: int):
    """(``rep``, the counters): 1, and 0, 1, ..., num - 1, in num 64-bit
    lanes of an int."""
    return sum(1 << 64 * j for j in range(num)), sum(j << 64 * j for j in range(num))


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
    """``num`` new keys, [num, 2] uint32 (``_threefry_split_foldlike``):
    threefry of the counters (0, j), every key in one pass."""
    with span("c2rt.keys"):
        rep, iota = _lanes(num)
        b1, b2 = _threefry_int(int(key[0]) & M32, int(key[1]) & M32, iota, rep)
        # lane j's 8 bytes, little-endian: b1's word, then b2's
        words = bytearray((b2 << 32 | b1).to_bytes(8 * num, "little"))
        return np.frombuffer(words, "<u4").reshape(num, 2)


def fold_in(key, data: int) -> np.ndarray:
    """The key folded with an integer (``_threefry_fold_in``): threefry of
    the counter (0, data mod 2**32)."""
    with span("c2rt.keys"):
        return np.array(_threefry_int(int(key[0]) & M32, int(key[1]) & M32, int(data) & M32), dtype=np.uint32)


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
    """Uniforms in [0, 1) of ``shape`` and ``dtype`` under ``key``, as
    ``jax.random.uniform(key, shape, dtype)`` draws them, on ``device``:
    csrc/threefry.cu on a CUDA device (or a raise), ``uniform_reference``
    on the CPU.  There is no fallback between the two."""
    _check_dtype(dtype)
    dev = torch.device(device)
    with span("c2rt.draw"):
        if dev.type == "cpu":
            return uniform_reference(key, shape, dtype, device=dev)
        if dev.type != "cuda":
            raise RuntimeError(f"uniform: no kernel for device {dev}")
        return _uniform_cuda(key, _shape(shape), dtype, dev)


def _uniform_cuda(key, shape, dtype, dev):
    global launches
    from .. import cuda_build

    out = torch.empty(shape, dtype=dtype, device=dev)
    cuda_build.launch("threefry", "c2rt_uniform", dev, int(key[0]), int(key[1]), out.numel(), out.data_ptr(),
                      int(dtype == torch.float64))
    if out.numel():
        launches += 1
    return out


def as_keys(keys) -> np.ndarray:
    """``keys`` as a uint32[K, 2] array of threefry keys (K >= 1)."""
    out = np.asarray(keys, dtype=np.uint32)
    if out.ndim != 2 or out.shape[1] != 2 or out.shape[0] < 1:
        raise ValueError(f"keys: want a [K, 2] array of threefry keys, got shape {out.shape}")
    return out


def uniform_keys_reference(keys, C: int, dtype=torch.float32, *, device) -> torch.Tensor:
    """The plain PyTorch version of ``uniform_keys``: K ``uniform_reference``
    draws of C elements, concatenated."""
    return torch.cat([uniform_reference(k, (int(C),), dtype, device=device) for k in as_keys(keys)])


def uniform_keys(keys, C: int, dtype=torch.float32, *, device) -> torch.Tensor:
    """[K * C] uniforms in [0, 1): slab j is ``uniform(keys[j], (C,))``, as
    ``jax.vmap(lambda k: jax.random.uniform(k, (C,), dtype))(keys)`` draws
    them flattened, on ``device``: one launch of csrc/threefry.cu's batched
    kernel on a CUDA device (or a raise), ``uniform_keys_reference`` on the
    CPU."""
    _check_dtype(dtype)
    keys = as_keys(keys)
    dev = torch.device(device)
    with span("c2rt.draw"):
        if dev.type == "cpu":
            return uniform_keys_reference(keys, C, dtype, device=dev)
        if dev.type != "cuda":
            raise RuntimeError(f"uniform_keys: no kernel for device {dev}")
        if keys.shape[0] > MAX_KEYS:
            raise ValueError(f"uniform_keys: at most {MAX_KEYS} keys per draw, got {keys.shape[0]}")
        return _uniform_keys_cuda(keys, int(C), dtype, dev)


def _uniform_keys_cuda(keys, C, dtype, dev):
    global launches
    from .. import cuda_build

    K = keys.shape[0]
    out = torch.empty((K * C,), dtype=dtype, device=dev)
    table = np.ascontiguousarray(keys, dtype=np.uint32)
    cuda_build.launch("threefry", "c2rt_uniform_keys", dev, table.ctypes.data, K, C, out.data_ptr(),
                      int(dtype == torch.float64))
    if out.numel():
        launches += 1
    return out
