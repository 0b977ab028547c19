"""K1's residual forms on the stand-in with a glass sphere for its mirror
(the refraction and total-internal-reflection branch): the port's plain
version against the JAX kernel in interpret mode, as
tests/test_torch_residual.py does for the stand-in."""

import pytest
import torch

from torch_port_cases import check_residual_rows

torch.set_num_threads(2)


@pytest.mark.parametrize("form", ["screen-tap", "ray-input"])
def test_residual_rows_match_jax_kernel(form):
    check_residual_rows("glass", form)
