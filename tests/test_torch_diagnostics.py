"""The port's diagnostics (utils/diagnostics.py) and the ray counters of
``render_samples`` / ``trace_whitted`` against the JAX package's
(chess2rt_tpu/utils/diagnostics.py) on the flagship stand-in.

Limits: ``camera`` counts exactly, ``shadow`` and ``bounce`` within 0.1%
(a knife-edge lane may shade or continue on one side only), occupancy
fractions within 0.1%; the frames of the determinism and NaN sweeps (a DoF
frame of ``csg_free_scene``, the class of the JAX tests' lecture4.sdl) at
the frame limits (tests/test_fuzz.py:234-237); a frame rendered with the
counters bit-equal to the frame without.  JAX's ray counts and occupancy
run eagerly (``jax.disable_jit``: the same operations, without XLA's
20-30 s compile of the unrolled rounds); its determinism and NaN sweeps
compile once each.
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
from chess2rt_tpu.utils import diagnostics as JD
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops.camera import begin_frame
from chess2rt_tpu_torch.render.pipeline import render_samples
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin
from chess2rt_tpu_torch.utils import diagnostics as TD

from torch_port_cases import assert_frame_close

torch.set_num_threads(2)


def _pair(w, h, **kw):
    aa = kw.pop("aa", True)
    jp, js = jax_pack_scene(flagship_standin(JT, w, h, **kw), dtype=jnp.float32)
    tp, ts = torch_pack_scene(flagship_standin(TT, w, h, **kw), device="cpu")
    return jp, dataclasses.replace(js, aa_enabled=aa), tp, dataclasses.replace(ts, aa_enabled=aa)


def test_frame_ray_stats_match_jax():
    """32x24 AA5 depth 5 (the mirror sphere's bounces): every count x5."""
    jp, js, tp, ts = _pair(32, 24)
    with jax.disable_jit():
        want = JD.frame_ray_stats(jp, js)
    got = TD.frame_ray_stats(tp, ts)
    assert set(got) == set(want) == {"camera", "shadow", "bounce", "total"}
    assert got["camera"] == want["camera"] == 32 * 24 * 5
    for k in ("shadow", "bounce", "total"):
        assert want[k] > 0 and abs(got[k] - want[k]) <= 1e-3 * want[k], (k, got[k], want[k])


def test_wavefront_occupancy_matches_jax():
    jp, js, tp, ts = _pair(32, 24, aa=False)
    with jax.disable_jit():
        want = JD.wavefront_occupancy(jp, js)
    got = TD.wavefront_occupancy(tp, ts)
    assert len(got) == len(want) == ts.max_trace_depth + 1 and got[0] == 1.0
    assert 0.0 < got[1] < 0.7 and all(b <= a for a, b in zip(got, got[1:]))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("mode", ["deterministic", "dof", "stereo"])
def test_counters_do_not_perturb_the_frame(mode):
    """``render_samples`` with ``stats`` (every round at full width, nothing
    skipped or compacted) returns the same bits as without; the counts are
    0-d tensors until read, and the Monte-Carlo modes count camera rays
    only (samples x pixels)."""
    kw = {"dof": True, "samples": 2} if mode == "dof" else ({"stereo": True} if mode == "stereo" else {})
    tp, ts = torch_pack_scene(flagship_standin(TT, 24, 16, **kw), device="cpu")
    ts = dataclasses.replace(ts, bounce_capacity=64)  # the plain frame compacts its bounces
    lin = torch.arange(24 * 16)
    xs, ys = (lin % 24).float(), (lin // 24).float()
    frame = begin_frame(tp.camera, 24 / 16)
    key = prng.PRNGKey(2)
    stats = {}
    with torch.no_grad():
        plain = render_samples(tp, ts, frame, xs, ys, key)
        counted = render_samples(tp, ts, frame, xs, ys, key, stats=stats)
    assert torch.equal(plain, counted)
    if mode == "dof":
        assert stats == {"camera": 24 * 16 * 2}
    else:  # both eyes of a stereo pair are counted
        assert isinstance(stats["shadow"], torch.Tensor) and stats["shadow"].dim() == 0
        assert stats["camera"] == 24 * 16 * (2 if mode == "stereo" else 1) and float(stats["bounce"]) > 0


def _dof_pair():
    """csg_free_scene (the class of lecture4.sdl) with DoF, 2 samples, AA
    off, 16x12: the JAX and the port's scene."""
    def build(T):
        sc = csg_free_scene(T, 0, 16, 12)
        c = sc.camera
        c.dof, c.numSamples, c.focalPlaneDist, c.fNumber, c.discMultiplier = True, 2, 250.0, 2.0, 5.0
        sc.settings.AAEnabled = False
        return sc

    jp, js = jax_pack_scene(build(JT), dtype=jnp.float32)
    tp, ts = torch_pack_scene(build(TT), device="cpu")
    return jp, dataclasses.replace(js, use_pallas=False), tp, ts


def test_assert_deterministic_matches_jax_and_keys_matter():
    jp, js, tp, ts = _dof_pair()
    want = JD.assert_deterministic(jp, js, jax.random.PRNGKey(5))
    got = TD.assert_deterministic(tp, ts, prng.PRNGKey(5))
    assert_frame_close(got, want)
    with torch.no_grad():
        other = TD.render_frame(tp, ts, prng.PRNGKey(6)).numpy()
    assert (other != got).any()


def test_nan_sweep_matches_jax():
    """The DoF frame renders without a NaN in any torch operation, masked
    lanes included, as JAX's does under jax_debug_nans; so does the
    stand-in (CSG, bitmaps, the mirror); and the sweep does catch a NaN."""
    jp, js, tp, ts = _dof_pair()
    want = JD.nan_sweep(jp, js, jax.random.PRNGKey(5))
    got = TD.nan_sweep(tp, ts, prng.PRNGKey(5))
    assert np.isfinite(got).all()
    assert_frame_close(got, want)
    sp, ss = torch_pack_scene(flagship_standin(TT, 16, 12), device="cpu")
    assert np.isfinite(TD.nan_sweep(sp, dataclasses.replace(ss, aa_enabled=False))).all()
    with pytest.raises(FloatingPointError, match="NaN"):
        with TD.debug_nans():
            torch.zeros(3) / torch.zeros(3)


def test_profile_trace_writes_a_trace(tmp_path):
    tp, ts = torch_pack_scene(flagship_standin(TT, 8, 6), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    with torch.no_grad():
        out, logdir = TD.profile_trace(lambda: TD.render_frame(tp, ts), logdir=str(tmp_path / "prof"))
    assert out.shape == (6, 8, 3) and os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"c2rt.frame", "c2rt.tap", "c2rt.k1"} <= names
