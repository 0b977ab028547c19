"""The gradient slice as a whole with 5-tap AA: gradients of the pixel L2
loss through the port's ``render_frame`` against ``jax.grad`` through the
JAX fused renderer at 32x24, as tests/test_torch_grad_frame.py does with
AA off."""

import torch

from torch_port_cases import check_frame_grads

torch.set_num_threads(2)


def test_aa_frame_grads_match_jax_fused_renderer(monkeypatch):
    check_frame_grads(True, monkeypatch)
