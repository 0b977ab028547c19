"""Inverse rendering in the port (grad/inverse.py, grad/checkpoint.py):
its Adam against optax's, a short fit on the flagship stand-in, and a
checkpoint resume.  optax is imported by this test only; the port uses
torch.optim.Adam."""

import dataclasses

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.grad import InverseProblem, fit
from chess2rt_tpu_torch.grad.inverse import make_optimizer
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene, replace_leaves
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import H, W

torch.set_num_threads(2)


def test_adam_matches_optax_with_scales_and_decay():
    """Three steps on a fixed toy loss, two fields with their own update
    scales, an exponential lr decay: the port's Adam against optax.adam
    with optax.exponential_decay, to 1e-6.  optax rounds its bias
    corrections to f32 (1 - 0.999 loses 1.3e-5 of itself), torch.optim.Adam
    keeps them in float64, so the two differ by ~1e-5 of an update: the
    updates here (<= 0.03) keep that under 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    x0 = {"mat_color": rng.normal(size=(4, 3)).astype(np.float32),
          "light_power": rng.uniform(1, 5, size=(2,)).astype(np.float32)}
    aim = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in x0.items()}
    scales = {"light_power": 3.0}
    prob = InverseProblem(static=None, target=None, train_fields=tuple(x0), learning_rate=0.01, steps=3,
                          update_scales=scales, lr_decay_to=0.1)

    def toy(x, aim):
        return sum(((x[k] - aim[k]) ** 3 * (1 + i)).sum() for i, k in enumerate(x0))

    xs = {k: torch.tensor(v, requires_grad=True) for k, v in x0.items()}
    aim_t = {k: torch.from_numpy(v) for k, v in aim.items()}
    opt, schedule = make_optimizer(xs, prob)
    for i in range(3):
        schedule(i)
        opt.zero_grad()
        toy(xs, aim_t).backward()
        opt.step()

    sched = optax.exponential_decay(0.01, transition_steps=3, decay_rate=0.1)
    tx = optax.adam(sched)
    params = {k: jnp.asarray(v) for k, v in x0.items()}
    state = tx.init(params)
    for _ in range(3):
        grads = jax.grad(lambda p: toy(p, aim))(params)
        updates, state = tx.update(grads, state, params)
        updates = {k: u * scales.get(k, 1.0) for k, u in updates.items()}
        params = optax.apply_updates(params, updates)
    for k in x0:
        np.testing.assert_allclose(xs[k].detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        assert not np.allclose(np.asarray(params[k]), x0[k])


@pytest.fixture(scope="module")
def standin():
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    with torch.no_grad():
        target = render_frame(tp, ts)
    wrong = replace_leaves(tp, {"mat_color": tp.mat_color * 0.6 + 0.1})
    return tp, ts, target, wrong


def test_fit_recovers_mat_color(standin):
    tp, ts, target, wrong = standin
    prob = InverseProblem(static=ts, target=target, train_fields=("mat_color",), learning_rate=3e-2, steps=10)
    fitted, losses = fit(wrong, prob)
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0]
    err0 = (wrong.mat_color - tp.mat_color).abs().mean()
    assert (fitted.mat_color - tp.mat_color).abs().mean() < err0
    torch.testing.assert_close(fitted.sphere_r, wrong.sphere_r, rtol=0, atol=0)  # untrained
    assert not fitted.mat_color.requires_grad


class _Cut(Exception):
    pass


def test_checkpoint_resumes_at_the_same_step(standin, tmp_path):
    """A run of 4 steps checkpointed every 2 and cut during its third step,
    resumed from its step-2 checkpoint, ends where an uninterrupted run
    ends (parameters, Adam moments and the lr schedule all resume); the
    same run over a 2-entry mesh follows it."""
    _, ts, target, wrong = standin
    prob = InverseProblem(static=ts, target=target, train_fields=("mat_color", "light_power"),
                          learning_rate=2e-2, steps=4, update_scales={"light_power": 10.0},
                          lr_decay_to=0.5)
    whole, losses = fit(wrong, prob)
    prob = dataclasses.replace(prob, checkpoint_path=str(tmp_path / "fit.pt"), checkpoint_every=2)
    first = []

    def cut(i, loss):
        if i == 2:
            raise _Cut
        first.append(loss)

    with pytest.raises(_Cut):
        fit(wrong, prob, on_step=cut)
    seen = []
    resumed, rest = fit(wrong, prob, on_step=lambda i, loss: seen.append(i))
    assert seen == [2, 3] and len(first) == 2
    np.testing.assert_allclose(first + rest, losses, rtol=1e-6)
    for name in ("mat_color", "light_power"):
        torch.testing.assert_close(getattr(resumed, name), getattr(whole, name), rtol=1e-6, atol=1e-7)
    # over a mesh of two CPU entries (the sharded step): the same trajectory,
    # the shards' gradients summed in another order
    from chess2rt_tpu_torch.parallel import make_mesh

    sharded, s_losses = fit(wrong, dataclasses.replace(prob, checkpoint_path=None, mesh=make_mesh(["cpu"] * 2)))
    np.testing.assert_allclose(s_losses, losses, rtol=1e-5)
    torch.testing.assert_close(sharded.mat_color, whole.mat_color, rtol=1e-5, atol=1e-6)
