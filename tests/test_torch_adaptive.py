"""Adaptive AA on one device: ``aa_detect`` against the JAX package's
(exact), and ``render_frame`` with ``aa_adaptive`` at 64x48 against the JAX
package's lane-compacted ``aa_fast`` renderer (eager glue, each kernel
jitted on its own): the compacted branch (``aa_capacity`` 2048 lanes for
the frame's ~1,600 flagged pixels) and the overflow branch (``aa_capacity``
1, which rounds to one 1024-lane tile, below the flagged count)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer
from chess2rt_tpu.render.pipeline import aa_detect as jax_aa_detect
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render.pipeline import aa_detect, render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import assert_frame_close, forward_jax_kernels

torch.set_num_threads(2)

W, H = 64, 48
CAPACITY = {"compacted": 2048, "overflow": 1}


def _scene():
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    return tp, dataclasses.replace(ts, aa_adaptive=True)


def _base(tp, ts):
    return F.build_flagship_renderer(dataclasses.replace(ts, aa_enabled=False), W, H)(tp)


def test_aa_detect_matches_jax_exactly():
    tp, ts = _scene()
    rng = np.random.default_rng(3)
    noise = rng.uniform(size=(H, W, 3)).astype(np.float32)
    # smooth regions with edges: the threshold is 0.1
    steps = (np.floor(noise * 3) / 3 + 0.02 * rng.normal(size=noise.shape)).astype(np.float32)
    for img in (noise, steps, _base(tp, ts).numpy()):
        got = aa_detect(torch.from_numpy(img))
        want = np.asarray(jax_aa_detect(jnp.asarray(img)))
        assert got.dtype == torch.bool and got.shape == (H, W)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(aa_detect(_base(tp, ts)).sum()) < W * H
    g = torch.from_numpy(noise).requires_grad_()
    assert not aa_detect(g).requires_grad


@pytest.mark.parametrize("branch", list(CAPACITY))
def test_adaptive_frame_matches_jax_aa_fast(branch, monkeypatch):
    jp, js = jax_pack_scene(flagship_standin(JT, W, H), dtype=jnp.float32)
    js = dataclasses.replace(js, aa_adaptive=True, aa_capacity=CAPACITY[branch])
    tp, ts = _scene()
    ts = dataclasses.replace(ts, aa_capacity=CAPACITY[branch])
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = np.asarray(build_flagship_renderer(js, W, H, interpret=True)(jp))
    assert_frame_close(render_frame(tp, ts).numpy(), ref)


def test_compacted_and_overflow_branches_agree():
    """The compacted taps run the ray-input form on rays from
    ``screen_rays``, the overflow branch the screen-tap form's own ray-gen:
    the JAX package's gate between them (tests/test_pallas.py:276, :290) is
    at most 3 pixels above 2e-3."""
    tp, ts = _scene()
    flagged = int(aa_detect(_base(tp, ts)).sum())
    assert 1024 < flagged <= 2048
    forms = {}

    def trace(lay, prm, *rays, **kw):
        forms.setdefault(branch, []).append(rays[0].shape[0] if rays else "tap")
        return R.round0(lay, prm, *rays, **kw)

    imgs = {}
    for branch, cap in CAPACITY.items():
        static = dataclasses.replace(ts, aa_capacity=cap)
        imgs[branch] = F.build_flagship_renderer(static, W, H, trace=trace)(tp)
    # one screen tap and four ray-input taps at the capacity, or five screen taps
    assert forms["compacted"].count("tap") == 1 and forms["compacted"].count(2048) >= 4
    assert forms["overflow"].count("tap") == 5 and 2048 not in forms["overflow"]
    d = (imgs["compacted"] - imgs["overflow"]).abs().amax(-1)
    assert int((d > 2e-3).sum()) <= 3 and d.median().item() < 2e-4
    assert (d <= 2e-5).double().mean().item() > 0.99


def test_unflagged_pixels_keep_the_base_tap():
    tp, ts = _scene()
    base = _base(tp, ts)
    mask = aa_detect(base)
    quirk = render_frame(tp, dataclasses.replace(ts, aa_adaptive=False))
    for cap in CAPACITY.values():
        img = render_frame(tp, dataclasses.replace(ts, aa_capacity=cap))
        assert torch.equal(img[~mask], base[~mask])
        assert not torch.equal(img[mask], base[mask])
    # on overflow the flagged pixels are the quirk frame's 5-tap average
    over = render_frame(tp, dataclasses.replace(ts, aa_capacity=1))
    assert (over[mask] - quirk[mask]).abs().max().item() <= 1e-6


def test_adaptive_chunked_runs_full_width_taps():
    tp, ts = _scene()
    img = render_frame(tp, dataclasses.replace(ts, chunk_pixels=1024))
    ref = render_frame(tp, dataclasses.replace(ts, aa_capacity=1))
    d = (img - ref).abs().amax(-1)
    assert int((d > 2e-3).sum()) <= 3 and d.median().item() < 2e-4
