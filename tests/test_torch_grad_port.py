"""Gradients of the port's flagship frame on their own (CPU, K1's plain
version): a finite-difference check through the frame, and the three
bounce-round modes (block compaction, full width, the overflow fallback)
giving the same gradients, which also covers the in-place aa-slot write
and ``index_add_`` of ops/flagship.py under autograd."""

import dataclasses

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, pack_scene
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops.flagship import combine_outputs
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import H, W, compare_grads, grad_leaves, port_grads

torch.set_num_threads(2)


def test_fd_check_light_color():
    """The directional derivative along light_color (an O(1) leaf f32
    central differences resolve) against autograd through the frame,
    eps 1e-3, rtol 1e-3 (tests/test_pallas_grad.py:141-158)."""
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)

    def loss(p):
        return (render_frame(p, ts) ** 2).mean()

    p, xs = grad_leaves(tp)
    loss(p).backward()
    eps = 1e-3
    with torch.no_grad():
        up = loss(dataclasses.replace(tp, light_color=tp.light_color + eps)).item()
        dn = loss(dataclasses.replace(tp, light_color=tp.light_color - eps)).item()
    np.testing.assert_allclose(xs["light_color"].grad.sum().item(), (up - dn) / (2 * eps), rtol=1e-3)


@pytest.fixture(scope="module")
def wide():
    """128x96 stand-in, AA off: 96 blocks of 128 lanes, more than one
    capacity unit (tests/test_torch_flagship.py:75-91)."""
    tp, ts = pack_scene(flagship_standin(TT, 128, 96), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    target = torch.from_numpy(np.random.default_rng(2).uniform(size=(96, 128, 3)).astype(np.float32))
    return tp, ts, target, _grads(tp, ts, target)


def _grads(tp, ts, target):
    p, xs = grad_leaves(tp)
    ((render_frame(p, ts) - target) ** 2).mean().backward()
    return port_grads(xs)


@pytest.mark.parametrize("mode", ["full", "overflow"])
def test_bounce_modes_give_the_same_gradients(wide, mode):
    tp, ts, target, block = wide
    if mode == "full":
        other = dataclasses.replace(ts, bounce_mode="full")
    else:
        # 8 blocks (the smallest capacity) cannot hold the mirror's blocks
        other = dataclasses.replace(ts, bounce_block_capacity=8)
        lay = R.layout(ts, 128, 96)
        _, cont, *_ = combine_outputs(tp, ts, R.round0(lay, lay.pack(tp)))
        assert cont.reshape(-1, R.BOUNCE_BLOCK).any(1).sum() > 8
    g = _grads(tp, other, target)
    assert np.abs(g["mat_color"]).max() > 0 and np.abs(block["bitmap_atlas"]).max() > 0
    compare_grads(g, block, LEAF_NAMES, rtol=5e-3, skip_zero=True)


def test_aa_taps_share_the_gradient():
    """With AA the five taps' parameter vectors are written in place
    (prms[:, aa] = offsets) from one packed vector: the frame's gradient is
    the mean of its taps' gradients."""
    from chess2rt_tpu_torch.ops.flagship import build_flagship_renderer
    from chess2rt_tpu_torch.render.pipeline import AA_KERNEL

    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    render = build_flagship_renderer(ts, W, H)
    p, xs = grad_leaves(tp)
    render(p).sum().backward()
    whole = port_grads(xs)
    taps = []
    for off in ((0.0, 0.0),) + AA_KERNEL:
        p, xs = grad_leaves(tp)
        (render.tap(p, off).sum() / 5.0).backward()
        taps.append(port_grads(xs))
    summed = {k: sum(t[k] for t in taps) for k in LEAF_NAMES}
    compare_grads(whole, summed, LEAF_NAMES, rtol=1e-4, atol=1e-6)
