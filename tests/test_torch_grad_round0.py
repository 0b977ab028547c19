"""The round-0 VJP, screen-tap form: the port's ``diff_round0`` (K1's
plain version forward, leaf-pinned re-shade backward) against ``jax.vjp``
of the JAX package's ``build_diff_round0`` at 32x24, with the same seeded
cotangents, every ScenePacked leaf compared (camera included).  The
ray-input form is in tests/test_torch_grad_round0_rays.py."""

import torch

from torch_port_cases import check_round0_vjp

torch.set_num_threads(2)


def test_screen_tap_vjp_matches_jax(monkeypatch):
    check_round0_vjp("screen-tap", monkeypatch)
