"""The gradient slice as a whole, AA off (the grad bench's configuration,
bench.py:173-179, at 32x24): gradients of the pixel L2 loss through the
port's ``render_frame`` (K1's plain version on the CPU, the leaf-pinned
backward, the texel VJP) against ``jax.grad`` through the JAX fused
renderer.  AA5 is in tests/test_torch_grad_frame_aa.py; each costs ~60 s
of JAX interpret-mode compiles and eager glue on a CPU."""

import torch

from torch_port_cases import check_frame_grads

torch.set_num_threads(2)


def test_frame_grads_match_jax_fused_renderer(monkeypatch):
    check_frame_grads(False, monkeypatch)
