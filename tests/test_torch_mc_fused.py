"""The fused Monte-Carlo renderer (ops/flagship.py, K1's plain version on
the CPU) on its own paths, and what rides on the key: the chunked DoF frame
against the un-chunked one, the adaptive DoF frame's lane-compacted taps
against its full-width ones, the DoF frame's gradient against ``jax.grad``
of the JAX XLA frame, a DoF ``fit`` against JAX's, and the command line's
``--seed``.

Limits, the JAX package's for its fused MC frames
(tests/test_pallas.py:343-351, :394, :420-422): at most 3 pixels above 2e-3
and a median below 2e-4.  Gradients: PERF.md section 2's rule
(tests/test_pallas_grad.py:51-66), per leaf |a - b| <= 2e-6 + rtol max|b| +
rtol |b|, rtol 5e-3 (0.1 for the camera's leaves), over the pixels whose
two frames agree to 1e-5 (a knife-edge pixel carries a whole leaf's
gradient).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import csg_free_scene

from torch_port_cases import CAMERA_GRAD_LEAVES, compare_grads, grad_leaves, jax_leaves, port_grads

torch.set_num_threads(2)


def _dof_scene(T, w, h, samples, aa=False, adaptive=False):
    sc = csg_free_scene(T, 0, w, h)
    c = sc.camera
    c.dof, c.numSamples, c.focalPlaneDist, c.fNumber, c.discMultiplier = True, samples, 250.0, 2.0, 5.0
    sc.settings.AAEnabled = aa
    sc.settings.adaptiveAA = adaptive
    return sc


def _close(a, b):
    d = (a.double() - b.double()).abs().amax(-1)
    assert (d > 2e-3).sum().item() <= 3, ((d > 2e-3).sum().item(), d.max().item())
    assert d.median().item() < 2e-4


def test_chunked_dof_matches_unchunked():
    """``chunk_pixels`` 2048 on a 3072-pixel frame: 2 slabs through the
    ray-input form, 1024 pad lanes re-tracing the last ray; the key stream
    is the frame's, so the frame is the un-chunked one."""
    tp, ts = torch_pack_scene(_dof_scene(TT, 64, 48, 2), device="cpu")
    key = prng.PRNGKey(11)
    whole = F.build_flagship_renderer(ts, 64, 48)(tp, key)
    ts_c = dataclasses.replace(ts, chunk_pixels=2048)
    assert F._chunk_slabs(ts_c, 64 * 48) == (2048, 2)
    _close(F.build_flagship_renderer(ts_c, 64, 48)(tp, key), whole)


def test_adaptive_dof_compact_and_overflow_match():
    """The adaptive DoF frame with more flagged pixels than one tile: at
    ``aa_capacity`` 4096 the 4 taps run lane-compacted (their uniforms
    drawn at full width and gathered), at the default capacity (one tile)
    they overflow to full width; the two frames agree."""
    tp, ts = torch_pack_scene(_dof_scene(TT, 64, 48, 2, aa=True, adaptive=True), device="cpu")
    key = prng.PRNGKey(3)
    base = F.build_flagship_renderer(dataclasses.replace(ts, aa_enabled=False), 64, 48)(tp, key)
    flagged = int(P.aa_detect(base).sum())
    assert R.TILE_N < flagged <= 4096, flagged

    def render(static):
        widths = []

        def trace(lay, prm, *rays, **kw):
            widths.append(rays[0].shape[0])
            return R.round0(lay, prm, *rays, **kw)

        return F.build_flagship_renderer(static, 64, 48, trace=trace)(tp, key), widths

    compact, w_c = render(dataclasses.replace(ts, aa_capacity=4096))
    full, w_f = render(ts)
    assert 4096 in w_c and 4096 not in w_f and set(w_f) <= {64 * 48} | set(w_f)
    assert max(w_f) == 64 * 48 and w_f.count(64 * 48) > w_c.count(64 * 48)
    _close(compact, full)
    # unflagged pixels keep the base frame's samples
    mask = P.aa_detect(base)
    assert torch.equal(compact[~mask], base[~mask])


def test_dof_gradient_matches_jax_grad():
    """((frame - target)**2 * w).mean() of the fused DoF frame (16x12, 2
    samples, AA off), differentiated in every leaf, against ``jax.grad`` of
    the JAX XLA frame under the same key."""
    w_, h_ = 16, 12
    jp, js = jax_pack_scene(_dof_scene(JT, w_, h_, 2), dtype=jnp.float32)
    _, ts = torch_pack_scene(_dof_scene(TT, w_, h_, 2), device="cpu")
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = np.random.default_rng(5).uniform(size=(h_, w_, 3)).astype(np.float32)
    jkey = jax.random.PRNGKey(2)

    def jax_step(p, w):
        def loss(p):
            img = jax_render_frame(p, js, jkey)
            return (((img - jnp.asarray(target)) ** 2) * w[..., None]).mean(), img

        (value, img), g = jax.value_and_grad(loss, has_aux=True)(p)
        return img, value, g

    step = jax.jit(jax_step)
    img_j = np.asarray(step(jp, jnp.ones((h_, w_), jnp.float32))[0])
    with torch.no_grad():
        img_t = P.render_frame(tp, ts, prng.PRNGKey(2)).numpy()
    agree = np.abs(img_t - img_j).max(-1) <= 1e-5
    assert agree.mean() > 0.9, agree.mean()
    agree = agree.astype(np.float32)
    _, loss_j, g = step(jp, jnp.asarray(agree))
    want = jax_leaves(g)

    p, xs = grad_leaves(tp)
    weight = torch.from_numpy(agree)[..., None]
    loss = (((P.render_frame(p, ts, prng.PRNGKey(2)) - torch.from_numpy(target)) ** 2) * weight).mean()
    loss.backward()
    have = port_grads(xs)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k in LEAF_NAMES:
        assert np.isfinite(have[k]).all(), k
    scene_leaves = [k for k in LEAF_NAMES if not k.startswith("camera.")]
    compare_grads(have, want, scene_leaves, rtol=5e-3, skip_zero=True, min_compared=5)
    # the DoF camera leaves: the focal plane and the disc move every ray
    for k in CAMERA_GRAD_LEAVES + ("camera.focal_plane_dist", "camera.disc_multiplier"):
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)


def test_dof_fit_matches_jax_fit():
    """Three Adam steps of a DoF fit (fold_in(key, i) per step) in two
    fields: the port's losses are JAX's within 1e-3."""
    from chess2rt_tpu.grad.inverse import InverseProblem as JaxProblem
    from chess2rt_tpu.grad.inverse import fit as jax_fit
    from chess2rt_tpu_torch.grad import InverseProblem, fit

    w_, h_ = 16, 12
    jp, js = jax_pack_scene(_dof_scene(JT, w_, h_, 2), dtype=jnp.float32)
    _, ts = torch_pack_scene(_dof_scene(TT, w_, h_, 2), device="cpu")
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = np.random.default_rng(6).uniform(size=(h_, w_, 3)).astype(np.float32)
    fields = ("mat_color", "sphere_center")
    _, losses_j = jax_fit(jp, JaxProblem(static=js, target=jnp.asarray(target), train_fields=fields,
                                         learning_rate=0.05, steps=3), key=jax.random.PRNGKey(8))
    _, losses = fit(tp, InverseProblem(static=ts, target=torch.from_numpy(target), train_fields=fields,
                                       learning_rate=0.05, steps=3), key=prng.PRNGKey(8))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-3)


def test_cli_seed_gives_the_in_process_frame(tmp_path):
    """``python -m chess2rt_tpu_torch --seed N`` on a DoF scene file writes
    the bytes of ``render_frame(..., PRNGKey(N))`` in this process; another
    seed, other bytes."""
    from chess2rt_tpu_torch import app
    from chess2rt_tpu_torch.imageio.bmp import load_bmp_file
    from chess2rt_tpu_torch.scene.loader import parse_scene_from_file
    from chess2rt_tpu_torch.scenes import write_standin_sdl
    from chess2rt_tpu_torch.utils.color import srgb_u8

    path = write_standin_sdl(str(tmp_path), 24, 16, aa=False, dof=True, samples=2)
    out = {}
    for seed in (5, 6):
        bmp = os.path.join(tmp_path, f"seed{seed}.bmp")
        assert app.main(["--file", path, "-o", bmp, "--device", "cpu", "--seed", str(seed), "-q"]) == 0
        px = load_bmp_file(bmp).pixels_u32
        out[seed] = np.stack([(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF], axis=-1).astype(np.uint8)
    tp, ts = torch_pack_scene(parse_scene_from_file(path), device="cpu")
    assert ts.dof and ts.dof_samples == 2
    with torch.no_grad():
        want = srgb_u8(P.render_frame(tp, ts, prng.PRNGKey(5)).numpy())
    assert out[5].shape == want.shape and np.array_equal(out[5], want)
    assert not np.array_equal(out[5], out[6])
