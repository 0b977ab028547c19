"""The fused GI renderer (ops/gi.py, K1's want_hit ray-input form; its plain
version on the CPU) against the JAX package's fused GI renderer
(``build_gi_renderer(interpret=True)``) and against the port's twin, under
the same key: un-chunked, in ``chunk_pixels`` slabs (64 lanes: 3 slabs of a
16x12 frame, the JAX package's own chunked GI test, tests/test_gi.py:261-275)
and with adaptive AA; and a GI ``fit`` (the fused path) against JAX's.

Scene: ``scenes.gi_standin`` at 16x12, NEE on, maxTraceDepth 2 (the JAX
fused renderer runs its glue eagerly under ``jax.disable_jit()``, its kernel
jitted alone, as tests/test_torch_flagship_fused.py does).  Limit:
``assert_allclose(atol=5e-4)``, the JAX package's bound between its two GI
paths (tests/test_gi.py:275).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_gi_renderer as jax_gi_renderer
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import gi_standin

from torch_port_cases import forward_jax_kernels, jax_leaves

torch.set_num_threads(2)

GW, GH, DEPTH, KEY = 16, 12, 2, 5
CASES = {
    # name: (paths, AA: None off / "quirk" / "adaptive", chunk_pixels)
    "plain": (4, None, None),
    "chunked": (4, None, 64),
    "adaptive": (2, "adaptive", None),
}


def _scene(T, paths, aa):
    sc = gi_standin(T, GW, GH, paths=paths)
    sc.settings.maxTraceDepth = DEPTH
    sc.settings.AAEnabled = aa is not None
    sc.settings.adaptiveAA = aa == "adaptive"
    return sc


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_gi_matches_jax_fused_gi_and_the_twin(name, monkeypatch):
    paths, aa, chunk = CASES[name]
    jp, js = jax_pack_scene(_scene(JT, paths, aa), dtype=jnp.float32)
    js = dataclasses.replace(js, gi_point_light_direct=True, chunk_pixels=chunk)
    _, ts = torch_pack_scene(_scene(TT, paths, aa), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True, chunk_pixels=chunk)
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    assert R.supports_gi(ts)
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        want = np.asarray(jax_gi_renderer(js, GW, GH, interpret=True)(jp, jax.random.PRNGKey(KEY)))
    widths = []

    def trace(lay, prm, *rays, **kw):
        widths.append(rays[0].shape[0])
        return R.round0(lay, prm, *rays, **kw)

    with torch.no_grad():
        got = gi.build_gi_renderer(ts, GW, GH, trace=trace)(tp, prng.PRNGKey(KEY)).numpy()
        twin = P.render_frame_wavefront(tp, ts, prng.PRNGKey(KEY)).numpy()
    assert set(widths) == {chunk or GW * GH}
    assert np.isfinite(got).all() and got.max() > 0.01
    np.testing.assert_allclose(got, want, atol=5e-4)
    np.testing.assert_allclose(got, twin, atol=5e-4)


def test_gi_path_batch_renders_one_path_per_launch():
    """gi_path_batch=2 traces two paths per launch: the frame is the frame
    of one path per launch within 1e-5 (only the order in which the two
    slabs are summed differs; JAX's own test holds its batched frame to its
    one-path frame at this rule, tests/test_gi.py:153-169), in fewer bounce
    rounds, one K1 launch each (tests/test_torch_engine_modes.py holds the
    modes further)."""
    tp, ts = torch_pack_scene(_scene(TT, 4, None), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True)
    frames, rounds = [], []
    for static in (ts, dataclasses.replace(ts, gi_path_batch=2)):
        gi.bounce_rounds = 0
        with torch.no_grad():
            frames.append(P.render_frame(tp, static, prng.PRNGKey(KEY)))
        rounds.append(gi.bounce_rounds)
    np.testing.assert_allclose(frames[1].numpy(), frames[0].numpy(), rtol=1e-5, atol=1e-5)
    assert 0 < rounds[1] < rounds[0]


def test_gi_fit_matches_jax_fit():
    """Three Adam steps of a GI fit (fold_in(key, i) per step) in two
    fields: the port's losses (the fused GI path) are the JAX XLA fit's
    within 1e-4 relative."""
    from chess2rt_tpu.grad.inverse import InverseProblem as JaxProblem
    from chess2rt_tpu.grad.inverse import fit as jax_fit
    from chess2rt_tpu_torch.grad import InverseProblem, fit

    jp, js = jax_pack_scene(_scene(JT, 4, None), dtype=jnp.float32)
    js = dataclasses.replace(js, gi_point_light_direct=True)
    _, ts = torch_pack_scene(_scene(TT, 4, None), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True)
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = np.random.default_rng(6).uniform(0.0, 0.3, size=(GH, GW, 3)).astype(np.float32)
    fields = ("mat_color", "light_power")
    _, losses_j = jax_fit(jp, JaxProblem(static=js, target=jnp.asarray(target), train_fields=fields,
                                         learning_rate=0.05, steps=3), key=jax.random.PRNGKey(8))
    _, losses = fit(tp, InverseProblem(static=ts, target=torch.from_numpy(target), train_fields=fields,
                                       learning_rate=0.05, steps=3), key=prng.PRNGKey(8))
    assert len(losses) == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
