"""The torch twins of the JAX package's demos (chess2rt_tpu_torch/demos/)
on the CPU at tiny sizes:

* each twin's ``run`` with ``--device cpu`` and a few steps: its loss
  falls and its printed numbers are finite (the recovery gates need the
  demos' full sizes and step counts: ``chip_smoke.py`` phase 43 runs them
  on the card);
* ``inverse_render``'s first step against ``jax.value_and_grad`` of the JAX
  demo's loss on the same scene (``scenes.gi_standin(gi=False)`` plus the
  ball, built from JAX's ``models.types``) at 16x12, for both of its
  problems (the colors, the sphere positions): the step rule of PERF.md §2
  (loss within 1e-3, every trained leaf at rtol 5e-3); and its whole
  default run against the JAX demo's loop on the same scene: the same
  losses (rtol 2e-2) and recovery errors, so the same verdict;
* ``pod_scaling`` at 32x24 over two mesh entries of the CPU writes the
  JAX artifact's keys (SCALING_cpu.json);
* ``zaphod_skybox`` at 32x24 with 1 DoF sample writes the BMP of
  ``render_frame`` in this process under ``PRNGKey(0)`` byte for byte, its
  sky row lit, and its ``--xla`` frame (the eager twin) meets the frame
  limits against the fused one, AA quirk and adaptive;
* without a card and without ``--device``, every twin raises.

tests/test_torch_demo_fits.py and tests/test_torch_gi_inverse.py hold the
other fitting twins to the JAX demos' loops.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.demos import (bump_inverse, gi_inverse, inverse_render, pod_scaling, texture_recovery,
                                      zaphod_skybox)
from chess2rt_tpu_torch.imageio.bmp import load_bmp_file
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.utils.color import srgb_u8

from torch_port_cases import assert_frame_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("demo,argv", [
    (inverse_render, ["--size", "16x12", "--steps", "6"]),
    (texture_recovery, ["--size", "32x24", "--steps", "4"]),
    (bump_inverse, ["--size", "32x24", "--steps", "4"]),
    (gi_inverse, ["--size", "16x12", "--paths", "2", "--steps", "3"]),
    (gi_inverse, ["--size", "16x12", "--paths", "2", "--steps", "3", "--resample"]),
])
def test_twin_runs_and_its_loss_falls(demo, argv, capsys):
    out = demo.run(["--device", "cpu", *argv])
    assert out["losses"][-1] < out["losses"][0], out["losses"]
    assert all(np.isfinite(v) for k, v in out.items() if isinstance(v, float)), out
    printed = capsys.readouterr().out
    assert "RECOVERED" in printed or "FAILED" in printed
    if "fd_ok" in out:  # the finite-difference check holds at any size
        assert out["fd_ok"], printed


def test_inverse_render_checkpoints_resume(tmp_path, capsys):
    prefix = str(tmp_path / "ck")
    args = ["--device", "cpu", "--size", "16x12", "--checkpoint", prefix]
    first = inverse_render.run([*args, "--steps", "150"])  # 50 steps per fit: each saves at its end
    assert len(first["losses"]) == 300  # three alternations of two fits
    assert sorted(os.listdir(tmp_path)) == sorted(f"ck.{p}.{n}" for p in range(3) for n in ("color", "position"))
    # 51 steps per fit: each of the six resumes at its step 50 and runs one
    again = inverse_render.run([*args, "--steps", "153"])
    assert len(again["losses"]) == 6


def _jax_step(jp, js, target, fields):
    def loss(p):
        return ((jax_render_frame(p, js, jax.random.PRNGKey(0)) - target) ** 2).mean()

    value, grads = jax.value_and_grad(loss)(jp)
    return float(value), {f: np.asarray(getattr(grads, f)) for f in fields}


def _port_step(tp, ts, target, fields):
    xs = {f: getattr(tp, f).detach().clone().requires_grad_() for f in fields}
    loss = ((render_frame(dataclasses.replace(tp, **xs), ts) - target) ** 2).mean()
    loss.backward()
    return loss.item(), {f: x.grad.numpy() for f, x in xs.items()}


def test_inverse_render_first_step_matches_jax_value_and_grad():
    w, h = 16, 12
    jp, js = jax_pack_scene(inverse_render.scene(JT, w, h), dtype=jnp.float32)
    tp, ts = pack_scene(inverse_render.scene(TT, w, h), device="cpu")
    jtarget = jax_render_frame(jp, js, jax.random.PRNGKey(0))
    with torch.no_grad():
        ttarget = render_frame(tp, ts)
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget), atol=2e-3)
    jwrong = dataclasses.replace(jp, mat_color=jp.mat_color * 0.4, checker_c2=jp.checker_c2 * 0.4,
                                 sphere_center=jp.sphere_center + jnp.asarray([[10.0, 0.0, 0.0]]))
    twrong = inverse_render.perturb(tp)
    for f in ("mat_color", "checker_c2", "sphere_center"):
        np.testing.assert_array_equal(getattr(twrong, f).numpy(), np.asarray(getattr(jwrong, f)))
    for fields in (("mat_color", "checker_c2"), ("sphere_center",)):
        want_loss, want = _jax_step(jwrong, js, jtarget, fields)
        got_loss, got = _port_step(twrong, ts, ttarget, fields)
        assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss), (got_loss, want_loss)
        for f in fields:
            assert np.abs(want[f]).any(), f
            scale = np.abs(want[f]).max()
            np.testing.assert_allclose(got[f], want[f], rtol=5e-3, atol=2e-6 + 5e-3 * scale, err_msg=f)


def test_inverse_render_default_run_ends_where_jax_ends(capsys):
    """The whole default schedule (64x48, three alternations of 50 color
    and 50 position steps) on both packages: the JAX side is the loop of
    demos/inverse_render.py on the same scene.  Both end at the same losses
    and recovery errors, so the demo's verdict on this stand-in is JAX's."""
    from chess2rt_tpu.grad import InverseProblem as JaxProblem
    from chess2rt_tpu.grad import fit as jax_fit

    got = inverse_render.run(["--device", "cpu"])
    jp, js = jax_pack_scene(inverse_render.scene(JT, 64, 48), dtype=jnp.float32)
    target = jax_render_frame(jp, js, jax.random.PRNGKey(0))
    fitted = dataclasses.replace(jp, mat_color=jp.mat_color * 0.4, checker_c2=jp.checker_c2 * 0.4,
                                 sphere_center=jp.sphere_center + jnp.asarray([[10.0, 0.0, 0.0]]))
    color = JaxProblem(static=js, target=target, train_fields=("mat_color", "checker_c2"), learning_rate=5e-2,
                       steps=50)
    position = dataclasses.replace(color, train_fields=("sphere_center",), learning_rate=0.5)
    losses = []
    for _ in range(3):
        for prob in (color, position):
            fitted, part = jax_fit(fitted, prob)
            losses += part
    err_pos = float(jnp.abs(fitted.sphere_center - jp.sphere_center).max())
    err_color = float(jnp.abs(fitted.mat_color[-1] - jp.mat_color[-1]).max())
    np.testing.assert_allclose(got["losses"][::50], losses[::50], rtol=2e-2)
    assert abs(got["err_pos"] - err_pos) < 0.1, (got["err_pos"], err_pos)
    assert abs(got["err_color"] - err_color) < 5e-3, (got["err_color"], err_color)
    assert got["ok"] == (losses[-1] < 0.05 * losses[0] and err_color < 0.1 and err_pos < 5.0
                         and got["err_checker"] < 0.1)


def test_pod_scaling_writes_the_jax_artifact_keys(tmp_path, capsys):
    out = str(tmp_path / "scaling.json")
    pod_scaling.run(["--device", "cpu", "--devices", "2", "--size", "32x24", "--repeats", "1", "--out", out])
    got = json.load(open(out))
    want = json.load(open(os.path.join(ROOT, "SCALING_cpu.json")))
    assert set(want) <= set(got)
    assert set(got["modes"]) == set(want["modes"]) == {"forward", "grad"}
    for mode, rows in got["modes"].items():
        assert [r["devices"] for r in rows] == [1, 2]
        for r in rows:
            assert set(r) == set(want["modes"][mode][0]) and r["mode"] == mode
            assert r["rays_per_sec"] > 0 and r["step_ms"] > 0
        assert rows[0]["efficiency"] == 1.0
    assert got["platform"] == "cpu" and "2 mesh entries over 1 distinct device" in got["note"]


def _bmp_u8(path):
    p = load_bmp_file(path).pixels_u32
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1).astype(np.uint8)


@pytest.mark.parametrize("adaptive", [False, True])
def test_zaphod_skybox_writes_the_frame(adaptive, tmp_path, capsys):
    """The twin of demos/zaphod_skybox.py: the BMP is srgb_u8 of the frame
    render_frame gives in this process, the sky row is lit (the demo's
    assertion), and the --xla frame meets the frame limits against it."""
    flags = ["--device", "cpu", "--size", "32x24", "--samples", "1"] + (["--adaptive-aa"] if adaptive else [])
    out = zaphod_skybox.run([*flags, "-o", str(tmp_path / "sky.bmp")])
    packed, static = zaphod_skybox.build(32, 24, 1, adaptive, "cpu")
    assert static.dof and static.has_env and static.dof_samples == 1 and static.aa_adaptive == adaptive
    with torch.no_grad():
        frame = render_frame(packed, static, prng.PRNGKey(0)).numpy()
    np.testing.assert_array_equal(out["frame"], frame)
    np.testing.assert_array_equal(_bmp_u8(out["output"]), srgb_u8(frame))
    assert out["sky"].min() > 0.05 and out["first_ms"] > 0 and out["steady_ms"] > 0
    printed = capsys.readouterr().out
    assert "steady-state frame" in printed and "sky row mean RGB" in printed
    xla = zaphod_skybox.run([*flags, "--xla", "-o", str(tmp_path / "sky_xla.bmp")])
    assert_frame_close(xla["frame"], frame)


@pytest.mark.parametrize("demo", [inverse_render, texture_recovery, bump_inverse, gi_inverse, pod_scaling,
                                  zaphod_skybox])
def test_twins_raise_without_a_card(demo):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.run(["--size", "16x12"] + ([] if demo in (pod_scaling, zaphod_skybox) else ["--steps", "1"]))
