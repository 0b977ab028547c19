"""GI gradients: the port's GI frame differentiated in every ScenePacked leaf
against ``jax.grad`` of the JAX package's two GI paths, and
``gi_remat_paths`` (the GI ``fit`` is in tests/test_torch_gi_fused.py).

Scene: ``scenes.gi_standin`` at 16x12, NEE on, 4 paths, maxTraceDepth 2
(the JAX fused GI runs its glue eagerly, one kernel call per bounce).  Loss
``(render_frame(p, key) ** 2).mean()`` under one key, as tests/test_gi.py's.

Limits.  tests/test_gi.py:171-221 holds the JAX package's two GI paths to
each other at max|a - b| / max|b| < 1e-4 per leaf with at least 10 leaves
nonzero, and ``gi_remat_paths`` to the same loss bit for bit and gradients
within 1e-5.  That rule holds here wherever the two sides make the same
forward decisions in the same precision:

* the port's GI renderer and its backward on the JAX kernel's own forward
  rows, against the JAX fused path (float32);
* the port's twin against the JAX XLA path in float64 (JAX under x64).

The port's ``render_frame`` (the fused path, K1's plain version) against the
JAX fused path has two forwards, each rounding its float32 u, v, t in its
own way: on this scene the JAX package's own two paths are 1e-4 to 2e-4
apart on the bitmap atlas (bilinear texel fractions), the cube's leaves and
the camera.  It is held to the repo's frame-gradient rule instead
(tests/test_pallas_grad.py:51-66, :108, :130-139, as tests/torch_port_cases
.check_frame_grads): per leaf |a - b| <= 2e-6 + rtol max|b| + rtol |b|,
rtol 5e-3, the camera leaves 0.1.
"""

import dataclasses
import functools

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
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import gi_standin

from torch_port_cases import CAMERA_GRAD_LEAVES, compare_grads, eager_jax_kernels, grad_leaves, jax_leaves, port_grads, x64

torch.set_num_threads(2)

GW, GH, PATHS, DEPTH, KEY = 16, 12, 4, 2, 3
RTOL = 1e-4


def _scene(T):
    sc = gi_standin(T, GW, GH, paths=PATHS)
    sc.settings.maxTraceDepth = DEPTH
    return sc


def _pair(dtype="float32"):
    jp, js = jax_pack_scene(_scene(JT), dtype=getattr(jnp, dtype))
    js = dataclasses.replace(js, gi_point_light_direct=True)
    _, ts = torch_pack_scene(_scene(TT), dtype=getattr(torch, dtype), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True)
    return jp, js, from_numpy(jax_leaves(jp), ts, device="cpu"), ts


def _jax_loss(render):
    return jax.value_and_grad(lambda p: (render(p) ** 2).mean())


@functools.lru_cache(maxsize=None)
def _jax_fused_grad():
    """(loss, leaves): jax.grad of the JAX fused GI renderer (interpret
    mode, glue eager, its kernels jitted one by one)."""
    import pytest
    from chess2rt_tpu.ops.pallas_trace import build_gi_renderer

    jp, js, _, _ = _pair()
    with pytest.MonkeyPatch.context() as mp:
        eager_jax_kernels(mp)
        with jax.disable_jit():
            f = build_gi_renderer(js, GW, GH, interpret=True)
            loss, g = _jax_loss(lambda p: f(p, jax.random.PRNGKey(KEY)))(jp)
    return float(loss), jax_leaves(g)


def _port(static, tp, render=P.render_frame):
    p, xs = grad_leaves(tp)
    loss = (render(p, static, prng.PRNGKey(KEY)) ** 2).mean()
    loss.backward()
    return loss.item(), port_grads(xs)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / (np.abs(b).max() + 1e-12))


def _hold_1e4(have, want):
    """Every leaf at max|a - b| / max|b| < 1e-4, the same leaves nonzero,
    at least 10 of them."""
    nonzero = 0
    for k in LEAF_NAMES:
        a, b = have[k], want[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        if b.size:
            assert np.abs(a).any() == np.abs(b).any(), k
            assert _rel(a, b) < RTOL, (k, _rel(a, b))
            nonzero += bool(np.abs(b).any())
    assert nonzero >= 10, nonzero


def _jax_rows_trace(jp, js):
    """K1's call for the port's GI renderer that runs the JAX package's
    kernel (interpret mode) on the JAX scene and hands its rows over."""
    from torch_port_cases import jax_round0_kernel

    def trace(lay, prm, orig, dir):
        kern = jax_round0_kernel(js, GW, GH, orig.shape[0], lay.want_hit, lay.want_vis)
        o = kern(jp, jnp.asarray(orig.detach().numpy()), jnp.asarray(dir.detach().numpy()))
        return {k: torch.from_numpy(np.array(v)) for k, v in o.items()}

    return trace


def test_gi_glue_on_jax_rows_matches_jax_fused_grad():
    """The port's GI renderer and its backward (the leaf-pinned re-shade of
    the want_hit rows, the deferred texels, the NEE and hemisphere terms) on
    the JAX kernel's forward rows, against jax.grad of the JAX fused GI
    renderer: the loss within 1e-5, every leaf within 1e-4."""
    from chess2rt_tpu_torch.ops.gi import build_gi_renderer

    jp, js, tp, ts = _pair()
    loss_j, want = _jax_fused_grad()
    fused = build_gi_renderer(ts, GW, GH, trace=_jax_rows_trace(jp, js))
    loss, have = _port(ts, tp, lambda p, static, key: fused(p, key))
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    _hold_1e4(have, want)


def test_gi_render_frame_gradient_matches_jax_fused_grad():
    """render_frame takes the fused GI path (K1's plain version on the CPU,
    the leaf-pinned re-shade of its want_hit rows in the backward): the loss
    within 1e-5 of the JAX fused path's, every gradient finite and nonzero
    where JAX's is, each leaf at the repo's frame-gradient rule."""
    _, _, tp, ts = _pair()
    assert R.supports_gi(ts)
    loss_j, want = _jax_fused_grad()
    gi.bounce_rounds = 0
    loss, have = _port(ts, tp)
    assert gi.bounce_rounds == PATHS * (DEPTH + 1)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    for k in LEAF_NAMES:
        assert np.isfinite(have[k]).all(), k
        assert np.abs(have[k]).any() == np.abs(want[k]).any(), k
    assert np.abs(have["bitmap_atlas"]).max() > 0  # the texel VJP ran
    scene = [k for k in LEAF_NAMES if not k.startswith("camera.")]
    compare_grads(have, want, scene, rtol=5e-3, skip_zero=True, min_compared=10)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)


def test_gi_twin_gradient_matches_jax_xla_grad_in_f64():
    """The twin (``trace_path``, float64) against jax.grad of the JAX XLA GI
    frame under x64: the loss within 1e-10, every leaf within 1e-4."""
    with x64():
        jp, js, tp, ts = _pair("float64")
        loss_j, g = jax.jit(_jax_loss(lambda p: jax_render_frame(p, js, jax.random.PRNGKey(KEY))))(jp)
        want = jax_leaves(g)
    loss, have = _port(ts, tp)  # float64 frames take the twin
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-10)
    _hold_1e4(have, want)


def test_want_hit_rows_reach_the_leaves():
    """diff_round0 with K1's want_hit layout (no vis rows) returns that
    layout's rows, and the re-shade recomputes each of t, the raw normal,
    the diffuse color and the light sum: a cotangent on any one of them
    alone reaches the leaves it depends on."""
    from chess2rt_tpu_torch.ops.round0_grad import diff_round0

    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays

    _, _, tp, ts = _pair()
    lay = R.layout(ts, GW, GH, want_hit=True)
    ys, xs = torch.meshgrid(torch.arange(GH) + 0.5, torch.arange(GW) + 0.5, indexing="ij")
    orig, dir = screen_rays(tp.camera, begin_frame(tp.camera, GW / GH), float(GW), float(GH), xs.reshape(-1),
                            ys.reshape(-1))
    depends = {"t": "plane_y", "nx": "sphere_center", "dr": "checker_c1", "lr": "light_power", "u": "node_offset"}
    for row, leaf in depends.items():
        p, xs = grad_leaves(tp)
        o = diff_round0(lay, lay.pack(p), p, orig, dir)
        assert set(o) == set(lay.names) | {"win"}
        keep = (o["win"] >= 0) & (o["t"] < R.INF)
        o[row][keep].sum().backward()
        assert np.abs(port_grads(xs)[leaf]).max() > 0, (row, leaf)


def test_gi_remat_paths_is_value_preserving():
    """gi_remat_paths recomputes each path in the backward: the same loss bit
    for bit, every gradient within 1e-5 of the leaf's largest, and the K1
    calls of every path made twice (forward and recompute)."""
    _, _, tp, ts = _pair()
    gi.bounce_rounds = 0
    loss0, g0 = _port(ts, tp)
    rounds = gi.bounce_rounds
    gi.bounce_rounds = 0
    loss1, g1 = _port(dataclasses.replace(ts, gi_remat_paths=True), tp)
    assert gi.bounce_rounds == 2 * rounds
    assert loss0 == loss1
    for k in LEAF_NAMES:
        if g0[k].size:
            assert np.isfinite(g1[k]).all(), k
            assert _rel(g1[k], g0[k]) < 1e-5, k
