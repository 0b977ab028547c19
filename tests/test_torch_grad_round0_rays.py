"""The round-0 VJP, ray-input form (the bounce rounds): the port's
``diff_round0`` against ``jax.vjp`` of the JAX package's
``build_diff_round0(..., n_rays=...)`` at 32x24 lanes, with the same
seeded cotangents; every ScenePacked leaf and the rays' ``orig`` and
``dir`` cotangents compared."""

import torch

from torch_port_cases import check_round0_vjp

torch.set_num_threads(2)


def test_ray_input_vjp_matches_jax(monkeypatch):
    check_round0_vjp("ray-input", monkeypatch)
