"""K1 on seeded random scenes (nested CSG, transforms, checker and
procedure2 textures, mirrors): the port's plain version against the JAX
package's Pallas kernel in interpret mode, screen-tap and ray-input, at the
repo's kernel-vs-reference limits (see tests/test_torch_round0.py)."""

import pytest
import torch

from torch_port_cases import RANDOM_SEEDS, check_ray_input, check_screen_tap

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_screen_tap_matches_jax_kernel(seed):
    check_screen_tap(seed)


@pytest.mark.parametrize("seed", RANDOM_SEEDS)
def test_ray_input_matches_jax_kernel(seed):
    check_ray_input(seed)
