"""The per-shard sampler of the port's mesh layer (parallel/mesh.py): sharded
DoF, stereo, GI and float64 frames against the JAX package's sharded XLA
sampler (``make_sharded_render_fn`` with ``use_pallas`` off) on 4 of the 8
virtual CPU devices of tests/conftest.py, under the same key and shard
count.

The port renders each frame twice: through its kernel-backed tracers (K1's
ray-input form and the bounce finisher, the fused GI tracer; on the CPU
K1's plain version) and through the twin's tracers (``trace=None``, the
counterpart of JAX's XLA sampler).  The frames are 17x11: 187 pixels, so 4
shards pad one pixel, which re-renders pixel (0, 0).  One JAX compile per
configuration, cached for the file.  Limits:

* float32 DoF and stereo on ``csg_free_scene`` (the class of lecture4.sdl,
  the scene of the JAX test) and GI on ``scenes.gi_standin``: ``atol
  5e-4``, the JAX package's bound between its fused and XLA sharded frames
  (tests/test_parallel.py:357, :376);
* the DoF flagship stand-in (CSG, bitmaps, the mirror; AA off, slabs):
  the frame limits
  (tests/test_fuzz.py:234-237, as tests/test_torch_mc.py holds the
  stand-in's single-device MC frames).  Its knife edges move with XLA's
  fused arithmetic: one pixel of the port's frame is 1.5e-3 off JAX's
  jitted frame, and JAX's own eager frame of the same scene differs from
  its jitted one by 1.7e-3.  The port's two tracers agree to 1e-5;
* float64 (the JAX x64 sampler): max |d| < 1e-6."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.parallel import mesh as JM
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn
from chess2rt_tpu_torch.parallel import mesh as M
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin, gi_standin

from torch_port_cases import assert_frame_close, jax_leaves, x64

torch.set_num_threads(2)

W, H, SHARDS, KEY = 17, 11, 4, 3


def _lecture4_like(T, dof=False, stereo=False):
    """``csg_free_scene`` (the class of lecture4.sdl, the JAX test's scene)
    with the camera's DoF (2 samples) or stereo pair, AA on."""
    sc = csg_free_scene(T, 0, W, H)
    c = sc.camera
    c.dof, c.numSamples, c.focalPlaneDist, c.fNumber, c.discMultiplier = dof, 2, 250.0, 2.0, 5.0
    c.stereoSeparation = 6.0 if stereo else 0.0
    return sc


CASES = {
    # DoF with adaptive AA and chunk_pixels slabs per shard (a 47-lane shard in 2 slabs)
    "dof adaptive chunked": (lambda T: _lecture4_like(T, dof=True), {"aa_adaptive": True, "chunk_pixels": 24}),
    "stereo quirk AA": (lambda T: _lecture4_like(T, stereo=True), {}),
    "standin dof chunked": (lambda T: flagship_standin(T, W, H, dof=True, samples=2),
                            {"aa_enabled": False, "chunk_pixels": 24}),
    "gi": (lambda T: gi_standin(T, W, H, paths=2), {"aa_enabled": False, "gi_point_light_direct": True}),
    "dof f64": (lambda T: _lecture4_like(T, dof=True), {"aa_enabled": False}),
}


@functools.lru_cache(maxsize=None)
def _jax_frame(case):
    """The JAX package's sharded XLA frame and the port's scene on its
    leaves."""
    build, knobs = CASES[case]
    f64 = case.endswith("f64")
    with x64(f64):
        jp, js = jax_pack_scene(build(JT), dtype=jnp.float64 if f64 else jnp.float32)
        js = dataclasses.replace(js, use_pallas=False, **knobs)
        mesh = JM.make_mesh(jax.devices()[:SHARDS])
        img = np.asarray(JM.make_sharded_render_fn(js, mesh)(jp, jax.random.PRNGKey(KEY)))
        leaves = jax_leaves(jp)
    _, ts = torch_pack_scene(build(TT), dtype=torch.float64 if f64 else torch.float32, device="cpu")
    ts = dataclasses.replace(ts, **knobs)
    return img, from_numpy(leaves, ts, device="cpu"), ts


@pytest.mark.parametrize("case", ["dof adaptive chunked", "stereo quirk AA", "gi"])
@pytest.mark.parametrize("tracer", ["K1", "twin"])
def test_sharded_mc_frame_matches_jax(case, tracer):
    img_j, tp, ts = _jax_frame(case)
    calls = []

    def trace(lay, prm, *rays, **kw):
        calls.append(rays[0].shape[0])
        return R.round0(lay, prm, *rays, **kw)

    img = make_sharded_render_fn(ts, make_mesh(["cpu"] * SHARDS), trace=trace if tracer == "K1" else None)(
        tp, prng.PRNGKey(KEY))
    assert tuple(img.shape) == img_j.shape == (H, W, 3) and img_j.max() > 0.01
    np.testing.assert_allclose(img.numpy(), img_j, atol=5e-4)
    # K1's ray-input form (its plain version here) traced every shard's rays,
    # in chunk_pixels slabs where set
    if tracer == "K1":
        assert max(calls) == (24 if ts.chunk_pixels else 47)
    else:
        assert not calls


def test_sharded_standin_dof_frame_meets_jax_at_the_frame_limits():
    img_j, tp, ts = _jax_frame("standin dof chunked")
    mesh = make_mesh(["cpu"] * SHARDS)
    img = make_sharded_render_fn(ts, mesh)(tp, prng.PRNGKey(KEY))
    assert_frame_close(img.numpy(), img_j)
    twin = make_sharded_render_fn(ts, mesh, trace=None)(tp, prng.PRNGKey(KEY))
    assert (img - twin).abs().max().item() < 1e-5


def test_sharded_f64_frame_matches_jax_x64():
    img_j, tp, ts = _jax_frame("dof f64")
    img = make_sharded_render_fn(ts, make_mesh(["cpu"] * SHARDS))(tp, prng.PRNGKey(KEY))
    assert img.dtype == torch.float64
    assert np.abs(img.numpy() - img_j).max() < 1e-6


def test_shard_keys_and_padding_are_jax_sharded_sampler():
    """The sampler pads to a multiple of the shard count only (not of 128 as
    the deterministic fused path does) and the padding pixels are (0, 0);
    each shard's key is fold_in(key, shard index): shard 2's slice of the
    frame equals a one-shard render of its pixels under that key."""
    xf, yf, n = M._pixel_coords(ts_of("gi"), SHARDS)
    jx, jy, jn = JM._pixel_coords(ts_of("gi"), SHARDS, np.float64)
    assert n == jn == W * H and xf.shape == (W * H + 1,)
    np.testing.assert_array_equal(xf, jx)
    np.testing.assert_array_equal(yf, jy)
    assert xf[-1] == yf[-1] == 0
    _, tp, ts = _jax_frame("gi")
    sample, C, n_pad = M._sampler_setup(ts, SHARDS, R.round0)
    assert (C, n_pad) == (47, 188)
    key = prng.PRNGKey(KEY)
    whole = make_sharded_render_fn(ts, make_mesh(["cpu"] * SHARDS))(tp, key).reshape(-1, 3)
    xs = torch.as_tensor(xf[2 * C:3 * C], dtype=torch.float32)
    ys = torch.as_tensor(yf[2 * C:3 * C], dtype=torch.float32)
    tf, gtf = M._fused_trace_fns(ts)
    part = M._sample_pixels(tp, ts, xs, ys, prng.fold_in(key, 2), trace_fn=tf, gi_trace_fn=gtf)
    assert torch.equal(part, whole[2 * C:3 * C])


def ts_of(case):
    return _jax_frame(case)[2]
