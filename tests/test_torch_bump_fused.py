"""The bump hybrid on the fused path (ops/bump_round0.py) against the JAX
package's (``pallas_grad.build_bump_round0`` inside its fused renderer):
frames in both gates, adaptive AA, a chunked frame, and gradients.

The JAX renderer runs with its glue eager and each Pallas kernel, leaf-pin
search and re-shade jitted on its own (``eager_jax_kernels``), compiled
once per scene structure for the whole file.  The port renders through
K1's plain version (the CPU path of ``round0``).

The gates are JAX's (tests/test_bump.py:201-221): ``bump_csg=True`` bumps
the CSG node, so the re-shade is the forward; ``bump_csg=False`` takes the
fast forward, whose record comes from the kernel's rows.  JAX's limits are
2e-5 and 1e-4.  With the mirror sphere the bounce rounds re-enter the
hybrid through the ray-input form, and the mirror's curvature amplifies
the two packages' last-bit differences (K1's, and the re-shade's in the
reshade gate) on a few of its pixels, where the f64 twin measures both
frames off by the same order (1e-5 to 5e-4 at 64x48): those pixels take
the repo's frame limits, every other pixel the gate's limit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer as jax_flagship
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy, pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import bump_round0 as B
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops.flagship import build_flagship_renderer
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import bump_scene

import torch_port_cases as C

torch.set_num_threads(2)

BW, BH = 64, 48
MIRROR = 4  # the mirror sphere's node index in bump_scene
GATE_ATOL = {True: 2e-5, False: 1e-4}  # tests/test_bump.py:221
GRAD_TOL = {True: 5e-4, False: 2e-3}  # tests/test_bump.py:278
GRAD_LEAVES = ("sphere_center", "sphere_r", "cube_center", "node_matrix", "light_pos", "mat_color", "plane_y",
               "camera.pos")


@pytest.fixture(autouse=True)
def _jax_kernels(monkeypatch):
    C.eager_jax_kernels(monkeypatch)


def _pair(mirror, bump_csg, **settings):
    """The JAX and port packings of one bump scene: (jp, js, tp, ts), the
    port's leaves carried across from the JAX package's."""
    jp, js = jax_pack_scene(bump_scene(JT, BW, BH, mirror=mirror, bump_csg=bump_csg, aa=False), dtype=jnp.float32)
    _, ts = torch_pack_scene(bump_scene(TT, BW, BH, mirror=mirror, bump_csg=bump_csg, aa=False), device="cpu")
    js, ts = dataclasses.replace(js, **settings), dataclasses.replace(ts, **settings)
    return jp, js, from_numpy(C.jax_leaves(jp), ts, device="cpu"), ts


def _jax_frame(jp, js):
    with jax.disable_jit():
        return np.asarray(jax_flagship(js, BW, BH, interpret=True)(jp))


def _assert_bump_frame(img, ref, tp, ts, bump_csg):
    """The frame limits everywhere and the gate's limit off the mirror's
    pixels (those whose round-0 winner is the mirror)."""
    C.assert_frame_close(img, ref)
    lay = R.layout(ts, BW, BH)
    win = R.round0_reference(lay, lay.pack(tp))["win"].reshape(BH, BW).numpy()
    off_mirror = win != MIRROR
    assert off_mirror.mean() > 0.8 and (~off_mirror).sum() > 50
    d = np.abs(img - ref).max(-1)
    assert d[off_mirror].max() <= GATE_ATOL[bump_csg], d[off_mirror].max()
    assert (d > GATE_ATOL[bump_csg]).mean() < 0.01, (d > GATE_ATOL[bump_csg]).mean()


@pytest.mark.parametrize("bump_csg", [True, False])
def test_fused_bump_frame_matches_jax(bump_csg):
    """render_frame on the bump scene with the mirror (maxTraceDepth 2)
    against JAX's fused bump renderer, in each gate; every round-0 call,
    bounce rounds included, goes through the hybrid."""
    jp, js, tp, ts = _pair(True, bump_csg)
    assert B._fast_bump_ok(ts) == (not bump_csg) and R.supports(ts)
    ref = _jax_frame(jp, js)
    B.calls = 0
    with torch.no_grad():
        img = render_frame(tp, ts).numpy()
    assert B.calls >= 2  # the screen tap and at least one bounce round
    _assert_bump_frame(img, ref, tp, ts, bump_csg)


def test_adaptive_aa_composes_with_bump():
    """Adaptive AA's lane-compacted taps re-enter the hybrid at the flagged
    pixels' width (tests/test_bump.py:231-250), fast gate."""
    jp, js, tp, ts = _pair(True, False, aa_enabled=True, aa_adaptive=True)
    ref = _jax_frame(jp, js)
    with torch.no_grad():
        img = render_frame(tp, ts).numpy()
        base = render_frame(tp, dataclasses.replace(ts, aa_enabled=False)).numpy()
    _assert_bump_frame(img, ref, tp, ts, False)
    assert (img != base).any()


@pytest.mark.parametrize("bump_csg", [True, False])
def test_chunked_bump_frame_matches_unchunked(bump_csg):
    """A chunked bump frame (rays from screen_rays into the ray-input form,
    slab by slab) against the un-chunked one, inside the frame limits (the
    JAX package's own gate between its chunked and un-chunked frames,
    tests/test_pallas.py:225-227)."""
    _, _, tp, ts = _pair(True, bump_csg, aa_enabled=True)
    with torch.no_grad():
        whole = build_flagship_renderer(ts, BW, BH, trace=R.round0_reference)(tp).numpy()
        chunked = build_flagship_renderer(dataclasses.replace(ts, chunk_pixels=1024), BW, BH,
                                          trace=R.round0_reference)(tp).numpy()
    C.assert_frame_close(chunked, whole)


def _grads(render, tp, target, weight):
    p, xs = C.grad_leaves(tp)
    loss = (((render(p) - torch.from_numpy(target)) ** 2) * torch.from_numpy(weight)).mean()
    loss.backward()
    return C.port_grads(xs)


def _assert_bump_grads(have, want, bump_csg):
    """tests/test_bump.py:264-278: per leaf |port - JAX| <= tol * the
    larger of the two gradients' largest entries."""
    for name in GRAD_LEAVES:
        a, b = have[name], want[name]
        assert np.isfinite(a).all(), name
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(a, b, atol=GRAD_TOL[bump_csg] * scale, err_msg=name)
    assert np.abs(have["sphere_center"]).sum() > 0


@pytest.mark.parametrize("bump_csg", [True, False])
def test_bump_gradients_match_jax(bump_csg):
    """jax.grad of the JAX fused bump renderer against the port's
    render_frame gradient on the bump scene (tests/test_bump.py:253-278's
    scene, loss and tolerances), the loss taken over the pixels whose two
    frames agree to 1e-5 (knife-edge pixels, where K1's last bits pick
    another texel of the derivative map, carry a leaf's gradient alone)."""
    jp, js, tp, ts = _pair(False, bump_csg)
    ref = _jax_frame(jp, js)
    with torch.no_grad():
        img = render_frame(tp, ts).numpy()
    weight = (np.abs(img - ref).max(-1) <= 1e-5).astype(np.float32)[..., None]
    assert weight.mean() > 0.95
    target = ref * 0.9
    render = jax_flagship(js, BW, BH, interpret=True)
    with jax.disable_jit():
        gj = jax.grad(lambda p: (((render(p) - target) ** 2) * weight).mean())(jp)
    have = _grads(lambda p: render_frame(p, ts), tp, target, weight)
    _assert_bump_grads(have, C.jax_leaves(gj), bump_csg)


def test_bump_hybrid_gradients_through_bounces_on_jax_rows():
    """The fast forward's autograd Function through the mirror's bounce
    rounds: the port's renderer on the JAX kernel's rows (its K1 on the
    same rays, so both sides pin the same structure) against jax.grad of
    the JAX fused renderer, every leaf at tests/test_bump.py:278's fast-gate
    tolerance."""
    jp, js, tp, ts = _pair(True, False)
    target = _jax_frame(jp, js) * 0.9
    render = jax_flagship(js, BW, BH, interpret=True)
    with jax.disable_jit():
        gj = jax.grad(lambda p: ((render(p) - target) ** 2).mean())(jp)
    # the JAX kernel's rows, ray-input calls padded to 4096 lanes (one compile for every bounce round)
    port = build_flagship_renderer(ts, BW, BH, trace=C.jax_kernel_trace(jp, js, BW, BH, 4096))
    have = _grads(port, tp, target, np.ones((BH, BW, 1), np.float32))
    _assert_bump_grads(have, C.jax_leaves(gj), False)

