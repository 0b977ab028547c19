"""K2, the texel-gradient histogram, and the texel VJP around it.

* ``texel_histogram``'s plain version (what the wrapper runs on CPU
  tensors) against the JAX package's Pallas kernel in interpret mode, on
  seeded sorted keys with duplicate runs and out-of-range keys.  Limit:
  |port - JAX| <= 2e-5 * max(1, max|JAX|) elementwise (the JAX kernel
  splits the f32 cotangents into bf16 hi and lo parts, texel_hist.py:122-130).
* ``quad_gather_flat``'s backward (sort, then K2) against a plain
  scatter-add of the unsorted cotangents.
* The ``train_textures`` switch of ``bitmap_plan``: off, the atlas gets no
  gradient (the JAX package's shade.py:203-205).
* The guarded derivatives of ops/geometry.py and Phong's pow stay finite
  at their singular points."""

import dataclasses

import numpy as np
import pytest
import torch

from chess2rt_tpu.ops.texel_hist import texel_histogram as jax_texel_histogram
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import geometry as G
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.ops import texel_hist as K2
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import grad_leaves

torch.set_num_threads(2)


def _sorted_rows(seed, n, n_texels, c):
    """Sorted keys with long duplicate runs, a few keys below 0 and at or
    above n_texels, and seeded f32 rows."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([
        rng.integers(0, n_texels, n - 40),
        np.full(20, 7),  # one long run
        rng.integers(-5, 0, 10),  # dropped below
        rng.integers(n_texels, n_texels + 9, 10),  # dropped above
    ]).astype(np.int32)
    keys.sort(kind="stable")
    vals = rng.normal(size=(n, c)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("c", [12, 6])
def test_plain_version_matches_jax_kernel(c):
    import jax.numpy as jnp

    n_texels = 3000
    keys, vals = _sorted_rows(c, 5000, n_texels, c)
    ref = np.asarray(jax_texel_histogram(jnp.asarray(keys), jnp.asarray(vals), n_texels, interpret=True))
    out = K2.texel_histogram(torch.from_numpy(keys), torch.from_numpy(vals), n_texels)
    assert out.shape == (n_texels, c) and out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max()
    assert err <= 2e-5 * max(1.0, np.abs(ref).max()), err
    assert np.abs(ref[7]).max() > 0  # the long run landed


def test_wrapper_checks_its_inputs():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        K2.texel_histogram(keys.long(), torch.zeros(4, 3), 5)
    with pytest.raises(TypeError):
        K2.texel_histogram(keys, torch.zeros(4, 3, dtype=torch.float64), 5)
    with pytest.raises(ValueError):
        K2.texel_histogram(keys, torch.zeros(4, 17), 5)
    with pytest.raises(ValueError):
        K2.texel_histogram(keys, torch.zeros(3, 3), 5)
    # rows no key names stay zero; the plain version is what CPU tensors run
    out = K2.texel_histogram(torch.tensor([1, 1, 3], dtype=torch.int32), torch.ones(3, 2), 5)
    torch.testing.assert_close(out, torch.tensor([[0, 0], [2, 2], [0, 0], [1, 1], [0, 0.0]]))


def test_quad_gather_backward_is_the_scatter_add():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(50, 12)).astype(np.float32)).requires_grad_()
    key = torch.from_numpy(rng.integers(0, 50, (7, 9)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(7, 9, 12)).astype(np.float32))
    out = S.quad_gather_flat(table, key)
    torch.testing.assert_close(out, table.detach()[key.long()], rtol=0, atol=0)
    (out * g).sum().backward()
    want = torch.zeros(50, 12).index_add_(0, key.reshape(-1).long(), g.reshape(-1, 12))
    torch.testing.assert_close(table.grad, want, rtol=1e-6, atol=1e-6)


def test_train_textures_off_gives_the_atlas_no_gradient():
    """The JAX package cuts the atlas from the gradient when train_textures
    is off (fit turns it off when the atlas is not trained); with it on,
    the atlas gets a texel gradient."""
    tp, ts = pack_scene(flagship_standin(TT, 32, 24), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    for train, want_grad in ((True, True), (False, False)):
        p, xs = grad_leaves(tp)
        (render_frame(p, dataclasses.replace(ts, train_textures=train)) ** 2).mean().backward()
        atlas = xs["bitmap_atlas"].grad
        assert (atlas is not None and bool(atlas.abs().max() > 0)) == want_grad, train
        assert xs["mat_color"].grad.abs().max() > 0


def test_guarded_derivatives_stay_finite():
    x = torch.tensor([0.0, 1e-12, 4.0], requires_grad=True)
    G._safe_sqrt(x).sum().backward()
    assert bool(torch.isfinite(x.grad).all()) and x.grad[2] == pytest.approx(0.25)
    s = torch.tensor([1.0, -1.0, 0.5], requires_grad=True)
    G._safe_arcsin(s).sum().backward()
    assert bool(torch.isfinite(s.grad).all()) and s.grad[2] == pytest.approx(1 / np.sqrt(0.75))
    y = torch.tensor([0.0, 1.0], requires_grad=True)
    xx = torch.tensor([0.0, 0.0], requires_grad=True)
    G._safe_arctan2(y, xx).sum().backward()
    assert bool(torch.isfinite(y.grad).all() and torch.isfinite(xx.grad).all())
    assert xx.grad[1] == pytest.approx(-1.0)
    # Phong: pow(max(cos_g, 0), exponent) behind the vis & cos_g > 0 select
    cos_g = torch.tensor([0.0, -0.5, 0.5], requires_grad=True)
    e = torch.tensor([30.0, 30.0, 30.0], requires_grad=True)
    torch.where(cos_g > 0, torch.pow(torch.clamp_min(cos_g, 0.0), e), 0.0).sum().backward()
    assert bool(torch.isfinite(e.grad).all() and torch.isfinite(cos_g.grad).all())
    assert e.grad[0] == 0 and e.grad[2] != 0
