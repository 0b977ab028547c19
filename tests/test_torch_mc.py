"""Depth of field and stereo against the JAX package: the eager twin
(``render_frame_wavefront``) and the fused renderer (K1's ray-input form,
its plain version on the CPU) against the JAX XLA ``render_frame`` under the
same key.

The JAX frames are jitted once per configuration (a module cache) and
shared by the twin's and the fused frame's tests.  Limits:

* the twin: the frame limits (tests/test_fuzz.py:234-237): < 1% of pixels
  above 2e-3 in their largest channel, median below 2e-4;
* the fused frame: the JAX package's own limit for its fused MC frames
  against XLA (tests/test_pallas.py:394, :439): at most 3 pixels above
  2e-3, AA off as there (and the adaptive DoF frame, whose 4 extra taps run
  lane-compacted, :343-351);
* the float64 twin against JAX in x64: max |d| <= 1e-6.

Scenes: ``csg_free_scene`` with the camera's DoF (focused on its objects,
a 5-unit disc; 1 sample, whose jitter and disc still split the key as
every sample does) and stereo pair, at 32x24; the stand-in's DoF and
stereo variants (bitmaps, CSG, the mirror) hold the fused frame to the
twin.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin

from torch_port_cases import H, W, assert_frame_close, x64

torch.set_num_threads(2)

KEY = 7
CASES = {
    # name: (scene, dof, stereo, AA: None off / "quirk" / "adaptive", chunk_pixels, GI)
    "dof": ("csg_free", True, False, None, 0, False),
    "stereo": ("csg_free", False, True, None, 0, False),
    "dof_stereo": ("csg_free", True, True, None, 0, False),
    "dof_adaptive": ("csg_free", True, False, "adaptive", 0, False),
    "dof_chunked": ("csg_free", True, False, None, 384, False),
    "gi_dof": ("csg_free", True, False, None, 0, True),
}


def _scene(T, name):
    kind, dof, stereo, aa, _, gi = CASES[name]
    sc = csg_free_scene(T, 0, W, H)
    c = sc.camera
    c.dof, c.numSamples, c.focalPlaneDist, c.fNumber, c.discMultiplier = dof, 1, 250.0, 2.0, 5.0
    c.stereoSeparation = 6.0 if stereo else 0.0
    sc.settings.AAEnabled = aa is not None
    sc.settings.adaptiveAA = aa == "adaptive"
    sc.settings.GIEnabled = gi
    return sc


def _fix(static, name):
    chunk = CASES[name][4]
    return dataclasses.replace(static, chunk_pixels=chunk) if chunk else static


@functools.lru_cache(maxsize=None)
def _jax_frame(name):
    jp, js = jax_pack_scene(_scene(JT, name), dtype=jnp.float32)
    js = _fix(js, name)
    return np.asarray(jax.jit(lambda p, k: jax_render_frame(p, js, k))(jp, jax.random.PRNGKey(KEY)))


def _port(name):
    tp, ts = torch_pack_scene(_scene(TT, name), device="cpu")
    return tp, _fix(ts, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_frame(name):
    tp, ts = _port(name)
    assert ts.dof or ts.stereo
    out = P.render_frame_wavefront(tp, ts, prng.PRNGKey(KEY)).numpy()
    ref = _jax_frame(name)
    assert_frame_close(out, ref)
    assert (ref.max(-1) > 0).mean() > 0.5


@pytest.mark.parametrize("name", ["dof", "stereo", "dof_stereo", "dof_adaptive"])
def test_fused_frame_matches_jax_frame(name):
    """render_frame's f32 path for these scenes is the fused renderer."""
    tp, ts = _port(name)
    out = P.render_frame(tp, ts, prng.PRNGKey(KEY)).numpy()
    d = np.abs(out.astype(np.float64) - _jax_frame(name)).max(-1)
    assert (d > 2e-3).sum() <= 3, ((d > 2e-3).sum(), d.max())
    assert np.median(d) < 2e-4


@pytest.mark.parametrize("mc", ["dof", "stereo"])
def test_standin_fused_frame_matches_twin(mc):
    """The stand-in (bitmaps, CSG, the mirror) in DoF (2 samples) and
    stereo: the fused frame against the twin's at the frame limits (the
    twin meets the JAX XLA frame on these features in
    tests/test_torch_whitted.py, and on DoF and stereo above)."""
    tp, ts = torch_pack_scene(flagship_standin(TT, W, H, dof=mc == "dof", stereo=mc == "stereo", samples=2),
                              device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    key = prng.PRNGKey(KEY)
    fused = P.render_frame(tp, ts, key).numpy()
    assert_frame_close(fused, P.render_frame_wavefront(tp, ts, key).numpy())
    assert (fused.max(-1) > 0).mean() > 0.5


def test_the_key_moves_the_frame():
    """Another key, another DoF frame; the same key, the same frame."""
    tp, ts = _port("dof")
    a = P.render_frame(tp, ts, prng.PRNGKey(KEY))
    assert torch.equal(a, P.render_frame(tp, ts, prng.PRNGKey(KEY)))
    assert (a - P.render_frame(tp, ts, prng.PRNGKey(KEY + 1))).abs().max() > 1e-2
    # the default key is JAX's PRNGKey(0)
    assert torch.equal(P.render_frame(tp, ts), P.render_frame(tp, ts, prng.PRNGKey(0)))


def test_twin_f64_dof_matches_jax():
    """The CSG-free scene's DoF frame in float64 against JAX in x64."""
    def scene(T):
        sc = _scene(T, "dof_chunked")
        sc.camera.numSamples = 2
        return sc

    with x64():
        jp, js = jax_pack_scene(scene(JT), dtype=jnp.float64)
        ref = np.asarray(jax.jit(lambda p, k: jax_render_frame(p, js, k))(jp, jax.random.PRNGKey(KEY)))
    tp, ts = torch_pack_scene(scene(TT), dtype=torch.float64, device="cpu")
    out = P.render_frame(tp, ts, prng.PRNGKey(KEY))
    assert out.dtype == torch.float64 and ts.dof
    assert np.abs(out.numpy() - ref).max() <= 1e-6
