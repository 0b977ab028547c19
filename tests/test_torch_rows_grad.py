"""Gradients through the pixel slices: the loss and every leaf's gradient
of a 3-slice 32x24 frame (AA off) from the port's ``build_rows_renderer``
(K1's lin-input form, the lin-input VJP) against ``jax.grad`` through the
JAX package's ``build_rows_renderer`` slices (glue eager, kernels jitted one
by one); and ``make_sharded_value_and_grad`` against the port's
single-device step.  The rule of PERF.md §2: loss within 1e-3; per leaf
rtol 5e-3, camera leaves 0.1, and the horizon leaves held as in
tests/test_torch_grad_frame.py (torch_port_cases.check_frame_grads)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_numpy, to_numpy
from chess2rt_tpu_torch.ops.flagship import build_rows_renderer
from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_value_and_grad
from chess2rt_tpu_torch.render.pipeline import render_frame

from torch_port_cases import (
    CAMERA_GRAD_LEAVES,
    HORIZON_LEAVES,
    H,
    W,
    compare_grads,
    eager_jax_kernels,
    grad_leaves,
    jax_kernel_trace,
    jax_leaves,
    jax_rows_slices,
    packed_pair,
    port_grads,
)

torch.set_num_threads(2)

N_LANES, N_SLICES = 256, 3
SCENE_LEAVES = [k for k in LEAF_NAMES if not k.startswith("camera.")]


def _target():
    return np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32)


def _single_device_step(tp, ts, target):
    p, xs = grad_leaves(tp)
    loss = ((render_frame(p, ts) - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    return loss.item(), port_grads(xs)


def test_rows_grads_match_jax_rows_renderer(monkeypatch):
    eager_jax_kernels(monkeypatch)
    jp, js, _, ts = packed_pair("standin")
    js = dataclasses.replace(js, aa_enabled=False)
    ts = dataclasses.replace(ts, aa_enabled=False)
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = _target()

    def jax_loss(q):
        flat = jax_rows_slices(js, q, N_LANES, N_SLICES)
        return ((flat.reshape(H, W, 3) - jnp.asarray(target)) ** 2).mean()

    with jax.disable_jit():
        loss_j, g = jax.value_and_grad(jax_loss)(jp)
    want = jax_leaves(g)

    def port(trace):
        kw = {} if trace is None else {"trace": trace}
        rows = build_rows_renderer(ts, W, H, N_LANES, **kw)
        p, xs = grad_leaves(tp)
        flat = torch.cat([rows(p, i * N_LANES) for i in range(N_SLICES)])
        loss = ((flat.reshape(H, W, 3) - torch.from_numpy(target)) ** 2).mean()
        loss.backward()
        assert abs(loss.item() - float(loss_j)) <= 1e-3 * abs(float(loss_j))
        return port_grads(xs)

    # 1. the port's glue and lin-input VJP on the JAX kernel's own forward rows
    have = port(_jax_lin_trace(jp, js))
    compare_grads(have, want, SCENE_LEAVES, rtol=5e-3, skip_zero=True)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)
    # 2. the port's own forward (K1's plain version)
    have = port(None)
    for k in LEAF_NAMES:
        assert np.isfinite(have[k]).all(), k
        assert np.abs(have[k]).any() == np.abs(want[k]).any(), k
    compare_grads(have, want, [k for k in SCENE_LEAVES if k not in HORIZON_LEAVES], rtol=5e-3, skip_zero=True)


def _jax_lin_trace(jp, js):
    """``jax_kernel_trace`` extended by the lin-input form: the JAX kernel's
    rows for the slice whose base the port packed into ``prm``."""
    from torch_port_cases import jax_round0_kernel

    rays = jax_kernel_trace(jp, js)

    def trace(lay, prm, orig=None, dir=None, *, lin_input=False, n_lanes=None):
        if not lin_input:
            return rays(lay, prm, orig, dir)
        a0, l0 = lay.off["aa"], lay.off["lin"]
        kern = jax_round0_kernel(js, W, H, n_lanes, lay.want_hit, lay.want_vis, lin_input=True)
        o = kern(jp, jnp.float32(prm[l0].item()), jnp.asarray(prm[a0:a0 + 2].detach().numpy()))
        return {k: torch.from_numpy(np.array(v)) for k, v in o.items()}

    return trace


@pytest.mark.parametrize("aa", ["off", "quirk", "adaptive"])
def test_sharded_step_is_the_single_device_step(aa):
    """The shards' losses and gradients, summed, against one backward through
    the whole frame: the same pixels through the same per-lane math, so only
    the order of the sums over pixels differs (rtol 1e-4 of each leaf's
    largest gradient)."""
    _, _, tp, ts = packed_pair("standin")
    ts = dataclasses.replace(ts, aa_enabled=aa != "off", aa_adaptive=aa == "adaptive")
    target = _target()
    loss, grads = make_sharded_value_and_grad(ts, make_mesh(["cpu"] * 3))(tp, torch.from_numpy(target))
    want_loss, want = _single_device_step(tp, ts, target)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    have = to_numpy(grads)
    compare_grads(have, want, LEAF_NAMES, rtol=1e-4, skip_zero=True, min_compared=20)
    for k in LEAF_NAMES:
        assert np.abs(have[k]).any() == np.abs(want[k]).any(), k


def test_pad_lanes_do_not_reach_the_loss():
    """Eight shards pad 768 pixels to 1024 lanes; the pad lanes (pixels below
    the frame) carry weight 0."""
    _, _, tp, ts = packed_pair("standin")
    ts = dataclasses.replace(ts, aa_enabled=False)
    target = _target()
    loss, grads = make_sharded_value_and_grad(ts, make_mesh(["cpu"] * 8))(tp, torch.from_numpy(target))
    want_loss, want = _single_device_step(tp, ts, target)
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    compare_grads(to_numpy(grads), want, LEAF_NAMES, rtol=1e-4, skip_zero=True, min_compared=20)
