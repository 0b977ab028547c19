"""The ``texture_recovery`` and ``bump_inverse`` twins
(chess2rt_tpu_torch/demos/) against the JAX demos' loops on the same scenes.

The JAX demos read scene files that are not in the repository
(texture_recovery: lecture5.sdl) or build their scene in code
(bump_inverse: demos/bump_probe.build), so the JAX side here runs each
demo's perturbation, ``InverseProblem`` schedule and recovery numbers
through ``chess2rt_tpu.grad.fit`` on the twin's in-code scene built from
JAX's ``models.types``, on JAX's XLA path on the CPU (no interpret-mode
kernel).  One ``jax.jit(jax.value_and_grad)`` per demo (its frame as an
auxiliary output) gives the target, the first step and the finite
differences; ``fit`` compiles its own step.  Each demo's JAX results are
computed once (a module cache).  Limits:

* the first step: PERF.md section 2's step rule against
  ``jax.value_and_grad`` (loss within 1e-3 relative, every trained leaf
  within 5e-3 of its largest element plus 5e-3 relative);
* a short run of the twin's ``run(["--device", "cpu", ...])`` against the
  JAX loop: the loss at every step within rtol 2e-2, the recovery numbers
  close, and the same verdict;
* texture_recovery: the visible-texel mask (texels Adam moved) equal, but
  for texels whose first-step gradient is below 1e-4 of the largest in
  both packages;
* bump_inverse: ``bump_probe.build``'s packing equals
  ``scenes.bump_scene``'s leaf for leaf, and the finite-difference check
  along the bump strength (the JAX demo's ``fd_check``: autodiff against a
  central difference, h 3e-4) agrees.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chess2rt_tpu.grad import InverseProblem as JaxProblem
from chess2rt_tpu.grad import fit as jax_fit
from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu_torch.demos import bump_inverse, texture_recovery
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import bump_scene, flagship_standin

from torch_port_cases import (assert_frame_close, assert_step_rule, fd_printed, jax_leaves, jax_value_and_grad,
                              load_jax_demo, port_step)

torch.set_num_threads(2)

W, H = 32, 24
STEPS = 20
FD_H = 3e-4  # demos/bump_inverse.py fd_check's step


# --- texture_recovery (demos/texture_recovery.py:50-89) ---

def _texture_scene(T):
    sc = flagship_standin(T, W, H)
    sc.settings.AAEnabled = False
    return sc


@functools.lru_cache(maxsize=None)
def _jax_texture():
    jp, js = jax_pack_scene(_texture_scene(JT), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    vg = jax_value_and_grad(js)
    (_, target), _ = vg(jp, jnp.zeros((H, W, 3), jnp.float32), key)
    wrong = dataclasses.replace(jp, bitmap_atlas=jnp.full_like(jp.bitmap_atlas, 0.5))
    (loss0, _), g0 = vg(wrong, target, key)
    prob = JaxProblem(static=js, target=target, train_fields=("bitmap_atlas",), learning_rate=0.05, steps=STEPS)
    fitted, losses = jax_fit(wrong, prob)
    moved = np.asarray(jnp.abs(fitted.bitmap_atlas - 0.5) > 1e-4)
    err = np.abs(np.asarray(fitted.bitmap_atlas - jp.bitmap_atlas))
    (_, img), _ = vg(fitted, target, key)
    img_mae = float(jnp.abs(img - target).mean())
    mae_visible = float(err[moved].mean())
    return {"target": np.asarray(target), "loss0": float(loss0), "grad0": np.asarray(g0.bitmap_atlas),
            "losses": losses, "visible": moved, "mae_visible": mae_visible, "img_mae": img_mae,
            "ok": losses[-1] < losses[0] * 0.02 and mae_visible < 0.08 and img_mae < 0.01}


@functools.lru_cache(maxsize=None)
def _port_texture_step():
    tp, ts = pack_scene(_texture_scene(TT), device="cpu")
    with torch.no_grad():
        target = render_frame(tp, ts)
    wrong = dataclasses.replace(tp, bitmap_atlas=torch.full_like(tp.bitmap_atlas, 0.5))
    loss, grads = port_step(wrong, ts, target, ("bitmap_atlas",), prng.PRNGKey(0))
    return target.numpy(), loss, grads["bitmap_atlas"]


def test_texture_recovery_first_step_matches_jax_value_and_grad():
    want = _jax_texture()
    target, loss, grad = _port_texture_step()
    assert_frame_close(target, want["target"])
    assert_step_rule(loss, {"bitmap_atlas": grad}, want["loss0"], {"bitmap_atlas": want["grad0"]})


def test_texture_recovery_short_run_ends_where_jax_ends(capsys):
    want = _jax_texture()
    got = texture_recovery.run(["--device", "cpu", "--size", f"{W}x{H}", "--steps", str(STEPS)])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)
    assert got["losses"][-1] < 0.5 * got["losses"][0]
    # the texels Adam moved: the same, but for texels whose first-step
    # gradient is below 1e-4 of the largest in both packages (a bilinear
    # corner weight at the bitmap's far edge, zero in one and ~1e-9 in the
    # other: Adam's first step moves any texel with a nonzero gradient)
    grad = _port_texture_step()[2]
    faint = np.maximum(np.abs(grad), np.abs(want["grad0"])) < 1e-4 * np.abs(want["grad0"]).max()
    assert got["visible"].sum() > 1000
    np.testing.assert_array_equal(got["visible"] & ~faint, want["visible"] & ~faint)
    assert abs(got["mae_visible"] - want["mae_visible"]) < 2e-3, (got["mae_visible"], want["mae_visible"])
    assert abs(got["img_mae"] - want["img_mae"]) < 5e-4, (got["img_mae"], want["img_mae"])
    assert got["ok"] == want["ok"]


# --- bump_inverse (demos/bump_inverse.py:85-118) ---

def _bump_perturb(p):
    return dataclasses.replace(p, bump_strength=p.bump_strength * 0.3, mat_color=p.mat_color * 0.6)


@functools.lru_cache(maxsize=None)
def _jax_bump():
    jp, js = load_jax_demo("bump_probe").build(W, H, bump=True, csg_bump=False)
    js = dataclasses.replace(js, aa_enabled=False, use_pallas=False)  # the demo's --cpu
    key = jax.random.PRNGKey(7)
    vg = jax_value_and_grad(js)
    zeros = jnp.zeros((H, W, 3), jnp.float32)
    (_, target), g_true = vg(jp, zeros, key)
    # fd_check: d(mean(frame^2))/ds of bump_strength * s at s = 1
    g_fd = float((g_true.bump_strength * jp.bump_strength).sum())

    def scaled(s):
        return float(vg(dataclasses.replace(jp, bump_strength=jp.bump_strength * s), zeros, key)[0][0])

    fd = (scaled(jnp.float32(1.0 + FD_H)) - scaled(jnp.float32(1.0 - FD_H))) / (2 * FD_H)
    wrong = _bump_perturb(jp)
    (loss0, _), g0 = vg(wrong, target, key)
    prob = JaxProblem(static=js, target=target, train_fields=("bump_strength", "mat_color"), learning_rate=2e-2,
                      steps=STEPS, update_scales={"bump_strength": 4.0})
    fitted, losses = jax_fit(wrong, prob, key=key)
    bumped = np.asarray([ns.bump_idx >= 0 for ns in js.nodes])
    err_strength = float(jnp.abs(fitted.bump_strength - jp.bump_strength)[bumped].max()
                         / jnp.abs(jp.bump_strength)[bumped].max())
    err_albedo = float(jnp.abs(fitted.mat_color - jp.mat_color).max())
    fd_ok = abs(g_fd - fd) / max(abs(fd), 1e-12) < 2e-2 and g_fd != 0.0
    return {"packed": jp, "static": js, "target": np.asarray(target), "loss0": float(loss0),
            "grad0": {f: np.asarray(getattr(g0, f)) for f in ("bump_strength", "mat_color")},
            "fd": (g_fd, fd), "fd_ok": fd_ok, "losses": losses, "err_strength": err_strength,
            "err_albedo": err_albedo,
            "ok": (losses[-1] < losses[0] * 0.02 and err_strength < 0.02 and err_albedo < 0.02 and fd_ok)}


def test_bump_probe_build_packs_as_bump_scene():
    """The JAX demo's scene (bump_probe.build with the CSG node un-bumped,
    AA off as the demo sets it) and the twin's ``bump_scene(mirror=False,
    bump_csg=False, aa=False)`` pack to the same leaves and statics."""
    want = _jax_bump()
    jp, js = jax_pack_scene(bump_scene(JT, W, H, mirror=False, bump_csg=False, aa=False), dtype=jnp.float32)
    a, b = jax_leaves(want["packed"]), jax_leaves(jp)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert dataclasses.replace(js, use_pallas=False) == want["static"]


def test_bump_inverse_first_step_matches_jax_value_and_grad():
    want = _jax_bump()
    tp, ts = pack_scene(bump_scene(TT, W, H, mirror=False, bump_csg=False, aa=False), device="cpu")
    key = prng.PRNGKey(7)
    with torch.no_grad():
        target = render_frame(tp, ts, key)
    assert_frame_close(target.numpy(), want["target"])
    loss, grads = port_step(_bump_perturb(tp), ts, target, ("bump_strength", "mat_color"), key)
    assert_step_rule(loss, grads, want["loss0"], want["grad0"])


def test_bump_inverse_short_run_ends_where_jax_ends(capsys):
    want = _jax_bump()
    got = bump_inverse.run(["--device", "cpu", "--size", f"{W}x{H}", "--steps", str(STEPS)])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)
    assert got["losses"][-1] < 0.5 * got["losses"][0]
    assert abs(got["err_strength"] - want["err_strength"]) < 5e-3, (got["err_strength"], want["err_strength"])
    assert abs(got["err_albedo"] - want["err_albedo"]) < 5e-3, (got["err_albedo"], want["err_albedo"])
    # the finite-difference check: the same directional derivative, the
    # same central difference, the same verdict
    g, fd = fd_printed(capsys.readouterr().out, "bump strength")
    np.testing.assert_allclose(g, want["fd"][0], rtol=5e-3)
    np.testing.assert_allclose(fd, want["fd"][1], rtol=2e-2)
    assert got["fd_ok"] == want["fd_ok"] and got["ok"] == want["ok"]
