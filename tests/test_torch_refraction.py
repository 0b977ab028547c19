"""K1's refraction branch: the stand-in with its mirror sphere made of
glass (Refraction, ior 1.5), rays from all sides of the sphere so that they
enter it, leave it and meet total internal reflection.  The port's plain
version against the JAX package's Pallas kernel in interpret mode, at the
repo's kernel-vs-reference limits (see tests/test_torch_round0.py)."""

import torch

from torch_port_cases import check_ray_input

torch.set_num_threads(2)


def test_glass_sphere_matches_jax_kernel():
    check_ray_input("glass")
