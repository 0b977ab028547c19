"""K1's CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA card and nvcc; they carry the ``gpu`` marker and
skip elsewhere.  They import no JAX (the machine with the card has none),
so run them there without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Limits: the repo's kernel-vs-reference limits (tests/test_fuzz.py), as in
chip_smoke.py: the winning node differs on < 1% of lanes, and over lanes
where it agrees < 1% have d > 2e-3 and median(d) < 2e-4, with d the
absolute difference, relative to |plain| where |plain| > 1.
"""

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.models import types as T
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.scenes import flagship_standin, random_scene

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no interpret mode)")
    return torch.device("cuda", 0)


def _d(a, b):
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp_min(1.0)


def _assert_close(out, ref, names):
    agree = out["win"] == ref["win"]
    assert agree.double().mean().item() > 0.99
    for k in names:
        d = _d(out[k][agree], ref[k][agree])
        assert bool(torch.isfinite(d).all()), k
        assert (d > 2e-3).double().mean().item() < 0.01, k
        assert d.median().item() < 2e-4, k


SCENES = {
    "standin": lambda: flagship_standin(T, 160, 120),
    # the refraction and total-internal-reflection branch
    "glass": lambda: flagship_standin(T, 160, 120, glass=True),
    **{f"random{s}": (lambda s=s: random_scene(T, s, width=96, height=72)) for s in range(1000, 1012)},
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_screen_tap_and_ray_input_match_plain(cuda, name):
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height)
    prm = lay.pack(tp, (0.3, 0.6))
    before = R.launches
    _assert_close(R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    n = ts.width * ts.height
    rng = np.random.default_rng(len(name))
    scale = 150.0 if name in ("standin", "glass") else 6.0
    center = (0.0, 120.0, 220.0) if scale > 100 else (0.0, 0.0, 0.0)
    orig = torch.as_tensor(np.asarray(center) + rng.uniform(-scale, scale, (n, 3)), dtype=torch.float32)
    d = rng.normal(size=(n, 3))
    dir = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)
    orig, dir = orig.to(cuda), dir.to(cuda)
    _assert_close(R.round0(lay, prm, orig, dir), R.round0_reference(lay, prm, orig, dir), lay.names)
    assert R.launches == before + 2


def test_frame_matches_plain_frame(cuda):
    tp, ts = pack_scene(flagship_standin(T, 320, 240), device=cuda)
    R.launches, F.bounce_rounds = 0, 0
    img = F.build_flagship_renderer(ts, 320, 240)(tp)
    assert R.launches == 5 + F.bounce_rounds
    ref = F.build_flagship_renderer(ts, 320, 240, trace=R.round0_reference)(tp)
    d = (img - ref).abs().amax(-1).double()
    assert bool(torch.isfinite(img).all())
    assert (d > 2e-3).double().mean().item() < 0.01
    assert d.median().item() < 2e-4


def test_wrapper_checks_its_inputs(cuda):
    tp, ts = pack_scene(flagship_standin(T, 64, 48), device=cuda)
    lay = R.layout(ts, 64, 48)
    prm = lay.pack(tp)
    rays = torch.zeros((10, 3), device=cuda)
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays, rays[:5])
    with pytest.raises(TypeError):
        R.round0(lay, prm.double())
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays.t().contiguous().t(), rays)
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays.cpu(), rays.cpu())
    empty = R.round0(lay, prm, rays[:0], rays[:0])
    assert empty["win"].shape == (0,)
