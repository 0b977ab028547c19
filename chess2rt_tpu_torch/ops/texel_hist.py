"""The texel-gradient histogram (K2): wrapper and plain version.

Counterpart of chess2rt_tpu/ops/texel_hist.py.  The VJP of the bilinear
quad gather (ops/shade.quad_gather_flat) sums the per-ray [N, C] cotangent
rows into the flat quad table by texel key.  The caller sorts the rows by
key; this sums each key's run:

    dq[t] = sum of sorted_vals[i] over the rows with sorted_keys[i] == t

with keys outside [0, n_texels) dropped (the JAX kernel's ``mode="drop"``
parity).

* ``texel_histogram`` launches csrc/texel_hist.cu for CUDA tensors (or
  raises) and runs the plain version for CPU tensors.  The kernel is a
  row-parallel segmented sum: a block sums the runs of a span of
  consecutive rows, and the runs that cross a span's edge go through a
  scratch table of two partial rows per span and a second launch of the
  same kernel (``plan`` sizes the spans and the scratch).  The sums are
  taken in a fixed order: two calls give the same bits.
* ``texel_histogram_reference`` is the plain version: an ``index_add_`` of
  the in-range rows into a zero table.
"""

from __future__ import annotations

import torch

MAX_CHANNELS = 16  # the JAX kernel's CH; csrc/texel_hist.cu MAX_C

# threads of a block (one row each per chunk), and how many blocks the rows
# are cut into at most: a block's span is the smallest multiple of
# BLOCK_THREADS that needs no more than TARGET_SPANS blocks (a short input
# still fills the card, and the second launch, one block of 1024 threads
# over the 2 * n_spans partial rows, walks them in one chunk)
BLOCK_THREADS = 256
TARGET_SPANS = 512

# calls of ``texel_histogram`` that launched the kernel (the CUDA path only)
launches = 0


def texel_histogram_reference(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor, n_texels: int):
    """The plain version: [n_texels, C] sums of the rows by key."""
    keep = (sorted_keys >= 0) & (sorted_keys < n_texels)
    out = torch.zeros((n_texels, sorted_vals.shape[1]), dtype=sorted_vals.dtype, device=sorted_vals.device)
    return out.index_add_(0, sorted_keys[keep].long(), sorted_vals[keep])


def _check(sorted_keys, sorted_vals):
    if sorted_keys.dtype != torch.int32:
        raise TypeError(f"texel_histogram: keys must be int32, got {sorted_keys.dtype}")
    if sorted_vals.dtype != torch.float32:
        raise TypeError(f"texel_histogram: values must be float32, got {sorted_vals.dtype}")
    if sorted_keys.dim() != 1 or sorted_vals.dim() != 2 or sorted_vals.shape[0] != sorted_keys.shape[0]:
        raise ValueError(
            f"texel_histogram: want keys [N] and values [N, C], got {tuple(sorted_keys.shape)} "
            f"and {tuple(sorted_vals.shape)}"
        )
    if not 0 < sorted_vals.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"texel_histogram: C = {sorted_vals.shape[1]} outside 1..{MAX_CHANNELS}")
    if sorted_keys.device != sorted_vals.device:
        raise ValueError(f"texel_histogram: keys on {sorted_keys.device}, values on {sorted_vals.device}")


def texel_histogram(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor, n_texels: int):
    """sorted_keys [N] int32 (ascending), sorted_vals [N, C <= 16] f32 ->
    [n_texels, C] f32.  CUDA tensors launch K2 or raise; CPU tensors run
    the plain version.  Unsorted keys give wrong sums on the card."""
    _check(sorted_keys, sorted_vals)
    dev = sorted_keys.device
    if dev.type == "cpu":
        return texel_histogram_reference(sorted_keys, sorted_vals, n_texels)
    if dev.type != "cuda":
        raise RuntimeError(f"texel_histogram: no kernel for device {dev}")
    return _texel_hist_cuda(sorted_keys.contiguous(), sorted_vals.contiguous(), n_texels)


def load_width(c: int, *pointers: int) -> int:
    """Floats per load of a [*, c] row: 4 (16-byte loads) when c is a
    multiple of 4 and every pointer is 16-byte aligned, 2 when c is even and
    every pointer 8-byte aligned, else 1."""
    for vec in (4, 2):
        if c % vec == 0 and all(ptr % (4 * vec) == 0 for ptr in pointers):
            return vec
    return 1


def plan(n: int):
    """(span, n_spans) for N rows: the rows one block owns (a multiple of
    BLOCK_THREADS) and the number of blocks.  The scratch for the runs that
    cross a span's edge holds 2 * n_spans keys and rows."""
    chunks = max(1, -(-n // (TARGET_SPANS * BLOCK_THREADS)))  # one row per thread per chunk
    span = chunks * BLOCK_THREADS
    return span, max(1, -(-n // span))


def _texel_hist_cuda(keys, vals, n_texels):
    global launches
    from .. import cuda_build

    n, c = vals.shape
    if n >= 2**31 - 1024 or n_texels * c >= 2**31:
        raise ValueError("texel_histogram: sizes exceed the kernel's int32 indices")
    out = torch.zeros((n_texels, c), dtype=torch.float32, device=keys.device)
    if n == 0 or n_texels <= 0:
        return out
    span, n_spans = plan(n)
    # one scratch buffer: the 2 * n_spans partial rows, then their int32 keys
    scratch = torch.empty((2 * n_spans * (c + 1),), dtype=torch.float32, device=keys.device)
    svals = scratch.data_ptr()
    skeys = svals + 4 * 2 * n_spans * c
    vec = load_width(c, vals.data_ptr(), out.data_ptr(), svals)
    cuda_build.launch("texel_hist", "c2rt_texel_hist", keys.device, keys.data_ptr(), vals.data_ptr(), out.data_ptr(),
                      n, c, n_texels, span, BLOCK_THREADS, vec, skeys, svals)
    launches += 1
    return out
