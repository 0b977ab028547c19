"""The environment cubemap, GI's miss term and the compensated ray-gen in the
port, against the JAX package on the same seeded inputs.

* ``ops/env.py`` (quads, plan, bilinear sample and its texel VJP) against
  the JAX package's;
* the merged bitmap+cubemap gather of ``combine_outputs`` in a fused frame
  (K1's plain version) against the JAX package's fused renderer on the
  flagship stand-in under a gradient cubemap, the camera pitched so the
  frame has both texel hits and misses (tests/test_pallas.py:509-542 holds
  JAX to <= 3 pixels above 2e-3 on zaphod.sdl, which is not in the
  repository), and the ``env_cubemap`` and ``bitmap_atlas`` gradients of
  that frame (the texel VJP over the merged table) against ``jax.grad``;
* the env-only branch (a scene without bitmaps) against the JAX XLA frame;
* GI under tests/test_gi.py:68's uniform grey sky: the twin against the
  JAX XLA GI frame and the fused GI renderer against JAX's, atol 5e-4
  (tests/test_gi.py:275);
* ``ops/df32.py`` against the JAX package's and float64
  (tests/test_parity.py:139-155), and the compensated rays and frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import camera as JC
from chess2rt_tpu.ops import df32 as JDF
from chess2rt_tpu.ops import env as JE
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer as jax_flagship
from chess2rt_tpu.ops.pallas_trace import build_gi_renderer as jax_gi_renderer
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy, pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import camera as TC
from chess2rt_tpu_torch.ops import df32 as TDF
from chess2rt_tpu_torch.ops import env as TE
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin, gi_standin

import torch_port_cases as C

torch.set_num_threads(2)

EW, EH = 32, 24


def _gradient_cubemap():
    """tests/test_pallas.py:525's gradient cubemap: env pixels vary, so a
    wrong merged key shows."""
    return np.linspace(0.1, 0.9, 6 * 8 * 8 * 3, dtype=np.float32).reshape(6, 8, 8, 3)


def _dirs(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_env_ops_match_jax():
    """cubemap_quads, cubemap_plan and sample_cubemap on seeded directions
    (every face), and the sample's VJP in the cubemap's texels."""
    cm = _gradient_cubemap()
    d = _dirs()
    np.testing.assert_array_equal(TE.cubemap_quads(torch.from_numpy(cm)).numpy(),
                                  np.asarray(JE.cubemap_quads(jnp.asarray(cm))))
    kt, pt, qt = TE.cubemap_plan(torch.from_numpy(cm), torch.from_numpy(d))
    kj, pj, qj = JE.cubemap_plan(jnp.asarray(cm), jnp.asarray(d))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert len(np.unique(kt.numpy() // 64)) == 6
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    sj, vjp = jax.vjp(lambda c: JE.sample_cubemap(c, jnp.asarray(d)), jnp.asarray(cm))
    ct = torch.from_numpy(cm).requires_grad_()
    st = TE.sample_cubemap(ct, torch.from_numpy(d))
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), atol=1e-6)
    g = np.random.default_rng(4).normal(size=d.shape).astype(np.float32)
    st.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-5, atol=1e-5)


def _env_pair(aa=True, depth=2, small=False):
    """The flagship stand-in under the gradient cubemap, camera pitched to
    the horizon, in both packages (the port's leaves carried across), at
    maxTraceDepth ``depth`` (the mirror's bounce rounds; each costs the
    eager JAX glue a round).  ``small`` keeps only its two bitmap nodes
    and the mirror (a shorter scene program: the JAX kernels compile
    faster)."""
    def sc(T):
        s = flagship_standin(T, EW, EH, env=True)
        s.environment.cubemap = _gradient_cubemap()
        s.settings.AAEnabled = aa
        s.settings.maxTraceDepth = depth
        if small:
            s.nodes = [n for n in s.nodes if n.name in ("floor", "box", "mirror_ball")]
        return s

    jp, js = jax_pack_scene(sc(JT), dtype=jnp.float32)
    _, ts = torch_pack_scene(sc(TT), device="cpu")
    return jp, js, from_numpy(C.jax_leaves(jp), ts, device="cpu"), ts


def test_merged_env_frame_matches_jax_fused(monkeypatch):
    """The fused AA5 frame of a scene with bitmaps and a cubemap (the merged
    gather in every tap and bounce round) against the JAX fused renderer:
    <= 3 pixels above 2e-3 (tests/test_pallas.py:542), and the frame has
    both texel hits and cubemap misses."""
    jp, js, tp, ts = _env_pair()
    assert ts.has_env and R.supports(ts)
    C.forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = np.asarray(jax_flagship(js, EW, EH, interpret=True)(jp))
    with torch.no_grad():
        img = P.render_frame(tp, ts).numpy()
        lay = R.layout(ts, EW, EH)
        win = R.round0_reference(lay, lay.pack(tp))["win"].numpy()
    assert 0.05 < (win < 0).mean() < 0.6  # misses and hits
    assert np.isfinite(img).all()
    d = np.abs(img - ref).max(-1)
    assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
    C.assert_frame_close(img, ref)


def test_merged_env_gradients_match_jax(monkeypatch):
    """env_cubemap and bitmap_atlas gradients (one texel VJP over the merged
    quad table) and the scene's other leaves, port against jax.grad of the
    JAX fused renderer, on the pixels whose frames agree to 1e-5, at the
    rule of tests/test_pallas_grad.py:108 (rtol 5e-3 of the leaf's largest
    gradient; the camera angles at 0.1, :130-139)."""
    jp, js, tp, ts = _env_pair(aa=False, depth=1, small=True)
    # JAX's plain scatter texel VJP, which its own test holds to its K2
    # (histogram) mode at rtol 2e-5 (tests/test_pallas.py:545-572): no
    # interpret-mode K2 to compile
    js = dataclasses.replace(js, texel_grad_mode="scatter")
    C.eager_jax_kernels(monkeypatch)
    render = jax_flagship(js, EW, EH, interpret=True)
    with jax.disable_jit():
        ref = np.asarray(render(jp))
    with torch.no_grad():
        img = P.render_frame(tp, ts).numpy()
    weight = (np.abs(img - ref).max(-1) <= 1e-5).astype(np.float32)[..., None]
    assert weight.mean() > 0.9
    target = ref * 0.9 + 0.05
    with jax.disable_jit():
        gj = jax.grad(lambda p: (((render(p) - target) ** 2) * weight).mean())(jp)
    p, xs = C.grad_leaves(tp)
    loss = (((P.render_frame(p, ts) - torch.from_numpy(target)) ** 2) * torch.from_numpy(weight)).mean()
    loss.backward()
    have, want = C.port_grads(xs), C.jax_leaves(gj)
    assert np.abs(want["env_cubemap"]).sum() > 0 and np.abs(want["bitmap_atlas"]).sum() > 0
    names = [k for k in want if k not in C.CAMERA_GRAD_LEAVES]
    C.compare_grads(have, want, names, rtol=5e-3, skip_zero=True)
    C.compare_grads(have, want, C.CAMERA_GRAD_LEAVES, rtol=0.1, min_compared=1)


def test_env_only_branch_matches_jax_xla_frame():
    """A scene with a cubemap and no bitmaps (combine_outputs' env-only
    branch, in the screen tap and the mirror's bounce rounds): the fused
    frame and the twin against the JAX XLA frame."""
    def sc(T):
        s = csg_free_scene(T, 0, EW, EH)
        s.environment.cubemap = _gradient_cubemap()
        s.camera.pitch = -5.0
        return s

    jp, js = jax_pack_scene(sc(JT), dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, dataclasses.replace(js, use_pallas=False)))(jp))
    _, ts = torch_pack_scene(sc(TT), device="cpu")
    tp = from_numpy(C.jax_leaves(jp), ts, device="cpu")
    assert R.supports(ts)
    with torch.no_grad():
        C.assert_frame_close(P.render_frame(tp, ts).numpy(), ref)
        C.assert_frame_close(P.render_frame_wavefront(tp, ts).numpy(), ref)


def _gi_pair():
    """gi_standin at 16x12, 4 paths, depth 2, NEE on, under
    tests/test_gi.py:68's uniform grey sky."""
    def sc(T):
        s = gi_standin(T, 16, 12, paths=4)
        s.settings.maxTraceDepth = 2
        s.environment.cubemap = np.full((6, 4, 4, 3), 0.5, dtype=np.float32)
        return s

    jp, js = jax_pack_scene(sc(JT), dtype=jnp.float32)
    js = dataclasses.replace(js, gi_point_light_direct=True)
    _, ts = torch_pack_scene(sc(TT), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True)
    return jp, js, from_numpy(C.jax_leaves(jp), ts, device="cpu"), ts


def test_gi_env_frames_match_jax(monkeypatch):
    """The GI miss term: the twin against the JAX XLA GI frame and the fused
    GI renderer (K1's plain version) against JAX's fused one, under the
    same key, atol 5e-4; the sky lights the frame."""
    jp, js, tp, ts = _gi_pair()
    assert ts.has_env and R.supports_gi(ts)
    key = 5
    xla = np.asarray(jax.jit(lambda p, k: jax_render_frame(p, js, k))(jp, jax.random.PRNGKey(key)))
    C.forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        fused = np.asarray(jax_gi_renderer(js, 16, 12, interpret=True)(jp, jax.random.PRNGKey(key)))
    gi.bounce_rounds = 0
    with torch.no_grad():
        twin = P.render_frame_wavefront(tp, ts, prng.PRNGKey(key)).numpy()
        got = P.render_frame(tp, ts, prng.PRNGKey(key)).numpy()
    assert gi.bounce_rounds > 0  # render_frame took the fused GI path
    with torch.no_grad():
        dark = P.render_frame(tp, dataclasses.replace(ts, has_env=False), prng.PRNGKey(key)).numpy()
    assert got.mean() > dark.mean() + 0.05
    np.testing.assert_allclose(twin, xla, atol=5e-4)
    np.testing.assert_allclose(got, fused, atol=5e-4)


def _normal(x):
    """``x`` with its subnormal entries as 0: XLA on the CPU flushes them,
    eager PyTorch keeps them (a lo word of ~1e-42 next to a hi of ~1e-10)."""
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, 0.0, x)


def test_df32_matches_jax_and_float64():
    """ops/df32.py: sincos bit-equal to the JAX package's (up to the
    subnormals XLA flushes) and within
    1e-12 of float64 over the camera's angle range, sqrt and div
    (tests/test_parity.py:139-155)."""
    rad = np.pi / 180.0
    deg = np.linspace(-720, 720, 2001).astype(np.float32)
    st, ct = TDF.sincos(TDF.mul_f32(TDF.const(rad, like=torch.from_numpy(deg)), torch.from_numpy(deg)))
    sj, cj = JDF.sincos(JDF.mul_f32(JDF.const(rad, like=jnp.asarray(deg)), jnp.asarray(deg)))
    x64 = np.float64(deg) * rad
    for (t_hi, t_lo), (j_hi, j_lo), ref in ((st, sj, np.sin(x64)), (ct, cj, np.cos(x64))):
        np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
        np.testing.assert_array_equal(_normal(t_lo.numpy()), _normal(np.asarray(j_lo)))
        assert np.abs(np.float64(t_hi.numpy()) + np.float64(t_lo.numpy()) - ref).max() < 1e-12
    fov = np.linspace(1, 170, 64).astype(np.float32)
    t = TDF.tan(TDF.mul_f32(TDF.const(rad / 2), torch.from_numpy(fov)))
    t64 = np.tan(np.float64(fov) * rad / 2)
    assert (np.abs(np.float64(t[0].numpy()) + np.float64(t[1].numpy()) - t64) / t64).max() < 1e-12
    q = TDF.sqrt(TDF.const(2.0))
    assert abs(float(q[0]) + float(q[1]) - np.sqrt(np.float64(2.0))) < 1e-14
    r = TDF.div(TDF.const(1.0), TDF.const(3.0))
    assert abs(float(r[0]) + float(r[1]) - 1.0 / 3.0) < 1e-14


def test_compensated_rays_and_frame_match_jax():
    """The compensated (df32) ray-gen: screen_rays against the JAX
    package's compensated rays (the same bits), closer to float64 than the
    plain f32 rays, and the compensated frame (the twin: the fused path
    refuses it) against the JAX XLA compensated frame, on a CSG-free scene
    with the stand-in's camera and a checkered floor to its horizon."""
    sc_j, sc_t = csg_free_scene(JT, 0, EW, EH), csg_free_scene(TT, 0, EW, EH)
    sc_j.settings.compensatedRayGen = sc_t.settings.compensatedRayGen = True
    sc_j.settings.AAEnabled = sc_t.settings.AAEnabled = False
    jp, js = jax_pack_scene(sc_j, dtype=jnp.float32)
    _, ts = torch_pack_scene(sc_t, device="cpu")
    tp = from_numpy(C.jax_leaves(jp), ts, device="cpu")
    assert ts.compensated_raygen and not R.supports(ts)
    lin = np.arange(EW * EH)
    x, y = (lin % EW).astype(np.float32) + 0.3, (lin // EW).astype(np.float32) + 0.6
    fj = JC.begin_frame(jp.camera, EW / EH, compensated=True)
    _, dj = JC.screen_rays(jp.camera, fj, float(EW), float(EH), jnp.asarray(x), jnp.asarray(y))
    ft = TC.begin_frame(tp.camera, EW / EH, compensated=True)
    _, dt = TC.screen_rays(tp.camera, ft, float(EW), float(EH), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    # float64 rays of the same camera: the compensated rays are the closer
    tp64, _ = torch_pack_scene(sc_t, dtype=torch.float64, device="cpu")
    f64 = TC.begin_frame(tp64.camera, EW / EH)
    _, d64 = TC.screen_rays(tp64.camera, f64, float(EW), float(EH), torch.from_numpy(x).double(),
                            torch.from_numpy(y).double())
    _, dplain = TC.screen_rays(tp.camera, TC.begin_frame(tp.camera, EW / EH), float(EW), float(EH),
                               torch.from_numpy(x), torch.from_numpy(y))
    err_c = np.abs(dt.numpy() - d64.numpy()).max()
    assert err_c <= 6e-8 and err_c <= np.abs(dplain.numpy() - d64.numpy()).max()
    ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, js))(jp))
    with torch.no_grad():
        C.assert_frame_close(P.render_frame(tp, ts).numpy(), ref)
