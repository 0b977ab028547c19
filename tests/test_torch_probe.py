"""The stage probes of K1 (K3): each stage's plain version against
``demos/kernel_probe.py build_stage`` of the JAX package, at a 32x32 frame
(1024 pixels: one tile, no pad lanes, so the JAX checksum covers the same
lanes).  ``build_stage`` calls ``pl.pallas_call`` without ``interpret``; the
test passes ``interpret=True`` through a patched ``pallas_call`` and keeps
the two output rows, which are compared lane by lane (the repo's kernel
limits) and by their sum (relative 1e-4, the JAX probe's checksum)."""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops.round0_probe import STAGES, round0_stage, round0_stage_reference
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import lane_error

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
W = H = 32
AA = (0.3, 0.6)  # nonzero: the empty stage multiplies the lane index by it


@pytest.fixture(scope="module")
def kernel_probe():
    """demos/kernel_probe.py as a module (it imports bench.py from the
    repository root, which reads no file at import)."""
    sys.path.insert(0, str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location("kernel_probe_demo", ROOT / "demos" / "kernel_probe.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(ROOT))
    return module


def _jax_stage(kernel_probe, monkeypatch, stage):
    """(row a, row b, checksum) of the JAX stage kernel in interpret mode."""
    kept = {}
    real = kernel_probe.pl.pallas_call

    def pallas_call(kernel, **kw):
        call = real(kernel, interpret=True, **kw)

        def run(*args):
            outs = call(*args)
            kept["rows"] = outs
            return outs

        return run

    monkeypatch.setattr(kernel_probe.pl, "pallas_call", pallas_call)
    jp, js = jax_pack_scene(flagship_standin(JT, W, H), dtype=jnp.float32)
    run = kernel_probe.build_stage(js, W, H, stage)
    with jax.disable_jit():  # the pack runs eagerly, the kernel through interpret mode
        checksum = float(run(jp, jnp.asarray(AA, jnp.float32)))
    a, b = (np.asarray(r).reshape(-1) for r in kept["rows"])
    assert a.shape == (W * H,)
    return a, b, checksum


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax_kernel_probe(stage, kernel_probe, monkeypatch):
    ref_a, ref_b, checksum = _jax_stage(kernel_probe, monkeypatch, stage)
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    lay = R.layout(ts, W, H)
    out_a, out_b = round0_stage(lay, lay.pack(tp, AA), stage)
    assert out_a.shape == out_b.shape == (W * H,) and out_a.dtype == torch.float32
    for out, ref in ((out_a.numpy(), ref_a), (out_b.numpy(), ref_b)):
        assert np.isfinite(out).all()
        d = lane_error(out, ref)
        assert (d > 2e-3).mean() < 0.01, (stage, (d > 2e-3).mean(), d.max())
        assert np.median(d) < 2e-4, (stage, np.median(d))
    if stage in ("empty", "raygen"):
        # every lane is finite: hold the JAX probe's checksum too.  The scan
        # and shadow stages write t = 1e30 on missed lanes, which drowns it
        total = out_a.double().sum().item() + out_b.double().sum().item()
        assert abs(total - checksum) <= 1e-4 * abs(checksum), (total, checksum)
    else:
        hit = ref_b < R.INF if stage == "shadow" else ref_a < R.INF
        port_hit = (out_b if stage == "shadow" else out_a).numpy() < R.INF
        assert (hit != port_hit).mean() < 0.01
        both = hit & port_hit
        total = out_a.numpy()[both].astype(np.float64).sum() + out_b.numpy()[both].astype(np.float64).sum()
        want = ref_a[both].astype(np.float64).sum() + ref_b[both].astype(np.float64).sum()
        assert abs(total - want) <= 1e-4 * abs(want), (total, want)


def test_stage_rows_are_k1s_own():
    """The stages are cuts of K1: the scan stage's t and win are the residual
    form's, and the shadow stage counts the residual form's shadow bits."""
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp, AA)
    full = R.round0(lay, prm, want_hit=True, want_vis=True)
    t, win_u = round0_stage_reference(lay, prm, "scan")
    assert torch.equal(t, full["t"])
    assert torch.equal(win_u, full["win"].float() + full["u"])
    seen, t2 = round0_stage_reference(lay, prm, "shadow")
    assert torch.equal(t2, full["t"])
    assert torch.equal(seen, full["vis0"] + full["vis1"])
    v, v1 = round0_stage_reference(lay, prm, "empty")
    assert torch.equal(v, torch.arange(W * H).float() * prm[lay.off["aa"]]) and torch.equal(v1, v + 1.0)


def test_unknown_stage_raises():
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    lay = R.layout(ts, W, H)
    with pytest.raises(ValueError, match="stage"):
        round0_stage(lay, lay.pack(tp), "full")
