"""Gradients through the eager Whitted twin: ``torch.autograd.grad`` of
((render_frame_wavefront(p) - t)**2 * w).mean() against ``jax.grad`` of the
JAX package's XLA ``render_frame`` (``use_pallas`` off), f32, AA off, on the
32x24 stand-in (two bitmaps, two CSG nodes, a transformed cube, Phong, the
mirror), in every ScenePacked leaf.

The rule of PERF.md section 2 (tests/test_pallas_grad.py:51-66): per leaf
|a - b| <= 2e-6 + rtol * max|b| + rtol * |b|, rtol 5e-3 (0.1 for the camera
leaves, :130-139), with ``w`` the pixels whose two frames agree to 1e-5,
since a knife-edge pixel (a winner or shadow bit that flips between the two
float paths) carries a whole leaf's gradient.  Bilinear texturing has knife
edges the frames do not show: at a texel edge the color is continuous but
its slope jumps, and two f32 programs (JAX's forward and its gradient
program are compiled apart) may land on either side.  At 32x24 the stand-in
has 15 primary hits within 1e-3 texel of an edge; two of them alone move the
camera's yaw gradient by 40% of its total (a sum that cancels).  ``w`` leaves
those out too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, TEX_BITMAP, from_numpy
from chess2rt_tpu_torch.ops import geometry as G
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
from chess2rt_tpu_torch.render.pipeline import render_frame_wavefront

from torch_port_cases import CAMERA_GRAD_LEAVES, H, W, compare_grads, grad_leaves, jax_leaves, packed_pair, port_grads

torch.set_num_threads(2)

GRAD_AGREE = 1e-5


def _texel_edge_pixels(tp, ts, margin=1e-3):
    """[H, W] bool: primary hits on a bitmap-textured node whose bilinear
    fractions lie within ``margin`` of a texel edge."""
    with torch.no_grad():
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                                indexing="ij")
        orig, dir = screen_rays(tp.camera, begin_frame(tp.camera, W / H), float(W), float(H), xs.reshape(-1),
                                ys.reshape(-1))
        hit, win = G.scene_closest(tp, ts, orig, dir)
        winc = win.clamp_min(0)
        _, _, p, q = S.bitmap_plan(tp, ts, winc, hit["u"], hit["v"])
        frac = torch.minimum(torch.minimum(p, 1 - p), torch.minimum(q, 1 - q))[:, 0]
        edge = (win >= 0) & (S.tex_kind_of(ts, winc) == TEX_BITMAP) & (frac < margin)
    return edge.reshape(H, W).numpy()


def test_twin_gradients_match_jax_grad():
    jp, js, _, ts = packed_pair("standin")
    js = dataclasses.replace(js, aa_enabled=False)
    ts = dataclasses.replace(ts, aa_enabled=False)
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32)

    def jax_step(p, w):
        """(frame, loss, gradient) in one program, so one compile serves
        the frame that decides ``w`` and the gradient under it."""
        def loss(p):
            img = jax_render_frame(p, js)
            return (((img - jnp.asarray(target)) ** 2) * w[..., None]).mean(), img

        (value, img), g = jax.value_and_grad(loss, has_aux=True)(p)
        return img, value, g

    step = jax.jit(jax_step)
    img_j = np.asarray(step(jp, jnp.ones((H, W), jnp.float32))[0])
    with torch.no_grad():
        img_t = render_frame_wavefront(tp, ts).numpy()
    agree = np.abs(img_t - img_j).max(-1) <= GRAD_AGREE
    assert agree.mean() > 0.9, agree.mean()
    agree = (agree & ~_texel_edge_pixels(tp, ts)).astype(np.float32)
    _, loss_j, g = step(jp, jnp.asarray(agree))
    want = jax_leaves(g)

    p, xs = grad_leaves(tp)
    weight = torch.from_numpy(agree)[..., None]
    loss = (((render_frame_wavefront(p, ts) - torch.from_numpy(target)) ** 2) * weight).mean()
    loss.backward()
    have = port_grads(xs)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for k in LEAF_NAMES:
        assert np.isfinite(have[k]).all(), k
        assert np.abs(have[k]).any() == np.abs(want[k]).any(), k
    assert np.abs(have["bitmap_atlas"]).max() > 0  # the texel VJP ran
    scene_leaves = [k for k in LEAF_NAMES if not k.startswith("camera.")]
    compare_grads(have, want, scene_leaves, rtol=5e-3, skip_zero=True, min_compared=10)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)
