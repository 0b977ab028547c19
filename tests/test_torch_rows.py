"""``build_rows_renderer`` (the frame as contiguous pixel slices through K1's
lin-input form): the port's against the JAX package's, 3 slices of 256 lanes
at 32x24, AA5, the stand-in with its mirror sphere, at the repo's frame
limits; and the port's slices against its own ``render_frame``.  The JAX
renderer runs with eager glue and each kernel jitted on its own."""

import jax
import numpy as np
import torch

from chess2rt_tpu_torch.ops.flagship import build_rows_renderer
from chess2rt_tpu_torch.render.pipeline import render_frame

from torch_port_cases import H, W, assert_frame_close, forward_jax_kernels, jax_rows_slices, packed_pair

torch.set_num_threads(2)

N_LANES, N_SLICES = 256, 3


def _port_slices(ts, tp):
    rows = build_rows_renderer(ts, W, H, N_LANES)
    return torch.cat([rows(tp, i * N_LANES) for i in range(N_SLICES)]).reshape(H, W, 3)


def test_rows_match_jax_rows_renderer(monkeypatch):
    jp, js, tp, ts = packed_pair("standin")
    assert js.aa_enabled and not js.aa_adaptive and js.max_trace_depth == 5
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = np.asarray(jax_rows_slices(js, jp, N_LANES, N_SLICES)).reshape(H, W, 3)
    assert_frame_close(_port_slices(ts, tp).numpy(), ref)


def test_rows_concatenated_are_the_single_frame():
    """JAX's own gate between its sharded and single-chip frames is 2e-5
    (tests/test_parallel.py:166-174); the port's plain version is
    elementwise per lane, and its slices equal the whole frame."""
    _, _, tp, ts = packed_pair("standin")
    img, ref = _port_slices(ts, tp), render_frame(tp, ts)
    assert (img - ref).abs().max().item() <= 2e-5
    assert torch.equal(img, ref)


def test_rows_tap_is_one_tap_of_the_slice():
    import dataclasses

    _, _, tp, ts = packed_pair("standin")
    rows = build_rows_renderer(ts, W, H, N_LANES)
    one = build_rows_renderer(dataclasses.replace(ts, aa_enabled=False), W, H, N_LANES)
    assert torch.equal(rows.tap(tp, 256), one(tp, 256))
    assert not torch.equal(rows.tap(tp, 256, (0.3, 0.3)), one(tp, 256))
