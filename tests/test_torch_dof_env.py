"""Depth of field under the environment cubemap (the DoF + cubemap frame of
``demos/zaphod_skybox.py``) against the JAX package, on the flagship
stand-in with DoF and the sky (``flagship_standin(dof=True, env=True)``):
bitmaps, CSG, the mirror, and a frame of texel hits and cubemap misses.

* the fused frame (K1's ray-input form, its plain version on the CPU, with
  the merged bitmap+cubemap gather in every pass and bounce round) against
  the JAX XLA ``render_frame`` under the same key, to the JAX package's own
  fused-vs-XLA limit for this combination: at most 3 pixels above 2e-3 and
  a median below 2e-4 (tests/test_pallas.py:542), with AA off and with
  adaptive AA (the lane-compacted taps of ``aa_mc_fast``).  Where a frame
  has more than 3 such pixels (the adaptive one: 5, all on the horizon
  row), the JAX package's own fused frame (``build_flagship_renderer`` in
  interpret mode, its kernels jitted one by one) misses the limit on the
  same pixels, and the port's frame meets the limit against it: XLA's
  jitted frame is the odd one out there;
* the twin (``render_frame_wavefront``) against the same JAX frames at the
  frame limits (tests/test_fuzz.py:234-237);
* the sky of the showcase twin is the JAX demo's ``make_sky_cubemap`` bit
  for bit.

The JAX frames are jitted once per configuration (a module cache).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer as jax_flagship
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import flagship_standin, sky_cubemap

import torch_port_cases as C
from torch_port_cases import H, W, assert_frame_close

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = 7
AA = {"aa_off": (False, False), "adaptive": (True, True)}


def _scene(T, aa):
    sc = flagship_standin(T, W, H, dof=True, env=True, samples=2)
    sc.settings.AAEnabled, sc.settings.adaptiveAA = AA[aa]
    return sc


@functools.lru_cache(maxsize=None)
def _jax_frame(aa):
    jp, js = jax_pack_scene(_scene(JT, aa), dtype=jnp.float32)
    assert js.dof and js.has_env and js.aa_adaptive == AA[aa][1]
    return np.asarray(jax.jit(lambda p, k: jax_render_frame(p, js, k))(jp, jax.random.PRNGKey(KEY)))


def _port(aa):
    return torch_pack_scene(_scene(TT, aa), device="cpu")


def test_frame_has_bitmap_hits_and_misses():
    tp, ts = _port("aa_off")
    names = [n.name for n in _scene(TT, "aa_off").nodes]
    assert ts.dof and ts.has_env and ts.dof_samples == 2 and R.supports(ts)
    lay = R.layout(ts, W, H)
    with torch.no_grad():
        o = R.round0_reference(lay, lay.pack(tp))
    win = o["win"].numpy()
    bitmap_nodes = [names.index("floor"), names.index("box")]
    assert 0.05 < (win < 0).mean() < 0.6, (win < 0).mean()  # the sky
    assert np.isin(win, bitmap_nodes).mean() > 0.05  # texel hits


@pytest.mark.parametrize("aa", sorted(AA))
def test_fused_frame_matches_jax_frame(aa, monkeypatch):
    """render_frame's f32 path for this scene is the fused MC renderer; with
    adaptive AA its 4 taps run lane-compacted (``aa_mc_fast``)."""
    tp, ts = _port(aa)
    ran = []
    build = F.build_bounce_finisher

    def spy(static, width, height, n, is_slab=False):
        finish = build(static, width, height, n, is_slab)

        def counted(*args):
            ran.append(is_slab)
            return finish(*args)

        return counted

    monkeypatch.setattr(F, "build_bounce_finisher", spy)
    with torch.no_grad():
        out = P.render_frame(tp, ts, prng.PRNGKey(KEY)).numpy()
    # AA off: every pass at full width; adaptive: the 4 taps' 2 samples
    # each on the compacted lanes too
    assert ran.count(True) == (8 if aa == "adaptive" else 0) and ran.count(False) == 2, ran
    ref = _jax_frame(aa)
    assert np.isfinite(out).all()
    assert (ref.max(-1) > 0).mean() > 0.9
    d = np.abs(out.astype(np.float64) - ref).max(-1)
    assert np.median(d) < 2e-4
    over = d > 2e-3
    if over.sum() <= 3:
        return
    # The limit is missed (the adaptive frame: 5 pixels on the horizon row,
    # where the far floor meets the sky): JAX's own fused frame misses it
    # on the same pixels, and the port's frame meets it against that one.
    C.forward_jax_kernels(monkeypatch)
    jp, js = jax_pack_scene(_scene(JT, aa), dtype=jnp.float32)
    with jax.disable_jit():
        fused = np.asarray(jax_flagship(js, W, H, interpret=True)(jp, jax.random.PRNGKey(KEY)))
    np.testing.assert_array_equal(np.abs(fused.astype(np.float64) - ref).max(-1) > 2e-3, over)
    dj = np.abs(out.astype(np.float64) - fused).max(-1)
    assert (dj > 2e-3).sum() <= 3, ((dj > 2e-3).sum(), dj.max())
    assert np.median(dj) < 2e-4


@pytest.mark.parametrize("aa", sorted(AA))
def test_twin_matches_jax_frame(aa):
    tp, ts = _port(aa)
    with torch.no_grad():
        out = P.render_frame_wavefront(tp, ts, prng.PRNGKey(KEY)).numpy()
    assert_frame_close(out, _jax_frame(aa))


def test_twin_sky_is_the_jax_demos_cubemap():
    """demos/zaphod_skybox.py's make_sky_cubemap (its top level imports
    numpy alone) against scenes.sky_cubemap, bit for bit."""
    spec = importlib.util.spec_from_file_location("jax_zaphod_skybox", os.path.join(ROOT, "demos", "zaphod_skybox.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    want = demo.make_sky_cubemap(64)
    got = sky_cubemap(64)
    assert got.dtype == want.dtype and got.shape == want.shape == (6, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    tp, _ = _port("aa_off")
    np.testing.assert_array_equal(tp.env_cubemap.numpy(), want)
