"""The benchmark cell ``zaphod-dof-cubemap``'s frame on the card: the 1080p
AA5 frame of 25 DoF samples under the 64x64 sky, rendered by the program as
the cell renders it (``rtbench.port.Port``: ``render_frame`` through the
Monte-Carlo renderer and K1's ray-input form), against the benchmark's plain
reference (``rtbench/reference``) at the cell's limit of ``correct``, and
the frame's counters: 125 passes, one K1 launch per pass and per bounce
round, four draws per pass.

These tests need an NVIDIA card and nvcc; they carry the ``gpu`` marker and
skip elsewhere.  They import no JAX, so run them there without the suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_zaphod.py -s
"""

import json

import pytest
import torch

from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R

pytestmark = pytest.mark.gpu

CELL, CONFIG = "zaphod-dof-cubemap", "zaphod-standin"
SEED = 2**31 + 20020


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no interpret mode)")
    return torch.device("cuda", 0)


def _counters():
    return {"passes": F.mc_passes, "env": F.env_gathers, "rounds": F.bounce_rounds, "k1": R.launches,
            "k1_ray": R.ray_launches, "draws": prng.launches}


@pytest.fixture(scope="module")
def cell(cuda):
    """The cell's first window item rendered by the program: (config, mode,
    inputs, the frame on the host, the counters' change)."""
    from rtbench import check, generator, harness
    from rtbench.port import Port

    config = harness.load_config(CONFIG)
    mode = config["frames"]
    inputs = generator.Inputs(SEED, generator.load_traffic("frames-closed"), check.camera_basis(config, mode))
    port = Port(config, mode, SEED, cuda)
    key, jit = inputs.item(0)
    port.render(jit, key)  # the kernels' first launches
    torch.cuda.synchronize()
    before = _counters()
    img = port.render(jit, key).cpu()
    counts = {k: v - before[k] for k, v in _counters().items()}
    port.free()
    return config, mode, inputs, img, counts


def test_the_cell_frame_agrees_with_the_reference(cuda, cell):
    from rtbench import check

    config, mode, inputs, img, _ = cell
    (_, ref), = check.reference_outputs([0], "frames", config, mode, inputs, cuda)
    ref = ref.cpu()
    d = (img.double() - ref.double()).abs().amax(-1)
    px_off = check.frame_numbers(img, ref)["px_off"]
    limit = check.load_limits(CELL)["px_off"]["limit"]
    print(json.dumps({"px_off": px_off, "limit": limit, "max_abs": d.max().item(),
                      "unequal_pixels": (d > 0).double().mean().item()}))
    assert bool(torch.isfinite(img).all()) and img.max().item() > 0.01
    assert px_off <= limit


def test_the_cell_frame_counts_its_passes_launches_and_draws(cell):
    counts = cell[4]
    print(json.dumps(counts))
    assert counts["passes"] == 5 * 25
    assert counts["draws"] == 4 * counts["passes"]
    # every K1 launch is the ray-input form: one per pass, one per bounce round
    assert counts["k1"] == counts["k1_ray"] == counts["passes"] + counts["rounds"]
    assert 0 < counts["rounds"] <= 5 * counts["passes"]
    # each K1 call's outputs read the sky
    assert counts["env"] == counts["k1"]
