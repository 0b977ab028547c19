"""The engine modes of ``SceneStatic`` in the port against the JAX package:
``gi_path_batch`` (K GI paths per K1 launch, ops/gi.py, with the batched
threefry draw ``prng.uniform_keys``), ``bounce_mode="compact"`` (ops/
flagship.py), ``texel_tap_reuse`` (ops/flagship.py) and ``texel_grad_mode``
(ops/shade.py).

* the batched draw: bit-equal to ``jax.vmap(jax.random.uniform)`` over the
  keys, and csrc/threefry.cu's batched kernel compiled by the host's C++
  compiler through a small stand-in for ``cuda_runtime.h`` and run block
  by block, bit-equal to its plain version;
* ``gi_path_batch``: K = 4 against K = 1 on the GI stand-in at 16x12 with 8
  paths at rtol/atol 1e-5 (tests/test_gi.py:153-169's rule), un-chunked,
  chunked and with adaptive AA, and the launch and draw counts; against
  JAX's ``build_gi_renderer`` with K = 4 at atol 5e-4 (tests/test_gi.py:275;
  glue eager, kernel jitted alone, maxTraceDepth 2 as in
  tests/test_torch_gi_fused.py); the sharded sampler and the twin keep one
  path per launch; a 16x12 GI step with K = 2 (and remat) against K = 1 at
  the repo's frame-gradient rule (loss 1e-4, leaves rtol 5e-3, camera 0.1);
* ``bounce_mode``: compact against full and block, bit-equal, on the
  flagship stand-in at 32x24 with a capacity that fits, and at 256x192 with
  capacity 1 (rounded up to one 1024-lane tile, so it overflows only where
  more than 1024 lanes continue: ~1,800 there, 26 at 32x24); one compact
  frame against JAX's fused renderer at the frame limits (the stand-in's
  floor, box and mirror: without its CSG nodes JAX's kernel compiles in
  seconds);
* ``texel_tap_reuse``: on against off, bit-equal, on the flagship renderer,
  the rows renderer and the sharded frame, with a capacity that fits and
  with capacity 1 (overflow); the step's gradients equal to off at f32
  rounding;
* ``texel_grad_mode``: the gather's VJP in each mode against ``jax.vjp`` of
  JAX's ``quad_gather_flat``; the step's atlas gradient under "sorted" and
  "scatter" against "histogram" (tests/test_inverse.py:219-241: atol 1e-6,
  rtol 1e-4) and against ``jax.grad`` of JAX's ``render_frame`` with each
  mode on a textured scene without CSG (the frame-gradient rule on the
  pixels whose frames agree, off texel edges); an unknown mode raises.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import shade as JS
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer as jax_flagship_renderer
from chess2rt_tpu.ops.pallas_trace import build_gi_renderer as jax_gi_renderer
from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch import cuda_build
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, TEX_BITMAP, from_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import geometry as G
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import flagship_standin, gi_standin

from torch_port_cases import (CAMERA_GRAD_LEAVES, assert_frame_close, compare_grads, forward_jax_kernels,
                              grad_leaves, jax_leaves, port_grads, x64)

torch.set_num_threads(2)

GW, GH, PATHS, KEY = 16, 12, 8, 7


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# --------------------------------------------------------------------------
# The batched draw
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("C", [1000, 1023])
def test_uniform_keys_match_jax_vmap(C, dtype):
    keys = prng.split(prng.PRNGKey(11), 3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    with x64(dtype == torch.float64):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (C,), dtype=jdt))(jnp.asarray(keys))).reshape(-1)
    got = prng.uniform_keys_reference(keys, C, dtype, device="cpu")
    assert got.shape == (3 * C,) and got.dtype == dtype
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert torch.equal(prng.uniform_keys(keys, C, dtype, device="cpu"), got)
    single = torch.cat([prng.uniform(k, (C,), dtype, device="cpu") for k in keys])
    assert torch.equal(single, got)


def test_uniform_keys_checks_its_inputs():
    keys = prng.split(prng.PRNGKey(1), 2)
    with pytest.raises(ValueError):
        prng.uniform_keys(keys[0], 4, device="cpu")  # one key [2], not [K, 2]
    with pytest.raises(ValueError):
        prng.uniform_keys(np.zeros((0, 2), np.uint32), 4, device="cpu")
    with pytest.raises(TypeError):
        prng.uniform_keys(keys, 4, torch.float16, device="cpu")
    with pytest.raises(RuntimeError, match="no kernel"):
        prng.uniform_keys(keys, 4, device="meta")


SHIM = r"""
#pragma once
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx;
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline double __longlong_as_double(long long x) { double f; std::memcpy(&f, &x, 8); return f; }
"""

HARNESS = r"""
}  // namespace
extern "C" void host_uniform_keys(const unsigned* keys, int K, long long c, void* out, int f64) {
  KeyTable table{};
  for (int j = 0; j < K; ++j) {
    table.k[j][0] = keys[2 * j];
    table.k[j][1] = keys[2 * j + 1];
  }
  for (unsigned j = 0; j < (unsigned)K; ++j)
    for (long long b = 0; b * BLOCK < c; ++b)
      for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
        blockIdx.x = (unsigned)b;
        blockIdx.y = j;
        threadIdx.x = t;
        if (f64)
          uniform_keys_kernel<double>(table, c, static_cast<double*>(out));
        else
          uniform_keys_kernel<float>(table, c, static_cast<float*>(out));
      }
}
"""


@pytest.fixture(scope="module")
def host_uniform_keys(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("threefry_keys_host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    text = (Path(cuda_build.__file__).parent / "csrc" / cuda_build.SOURCES["threefry"][0]).read_text()
    (tmp / "threefry_host.cpp").write_text(text[: text.index("// ---- host side")] + HARNESS)
    lib = tmp / "libthreefry_keys_host.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{tmp}",
                          f"-I{Path(cuda_build.__file__).parent / 'csrc'}", "-o", str(lib),
                          str(tmp / "threefry_host.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).host_uniform_keys
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_uniform_keys_device_code_matches_plain_version(host_uniform_keys, dtype):
    for K, c in ((1, 1), (3, 257), (8, 1023)):
        keys = np.ascontiguousarray(prng.split(prng.fold_in(prng.PRNGKey(K), c), K), dtype=np.uint32)
        out = torch.full((K * c,), float("nan"), dtype=dtype)
        host_uniform_keys(keys.ctypes.data, K, c, out.data_ptr(), int(dtype == torch.float64))
        ref = prng.uniform_keys_reference(keys, c, dtype, device="cpu")
        assert np.array_equal(_bits(out.numpy()), _bits(ref.numpy())), (K, c)


# --------------------------------------------------------------------------
# gi_path_batch
# --------------------------------------------------------------------------


def _gi_pair(paths=PATHS, depth=None, **knobs):
    """(jax packed, jax static, port packed, port static) of the GI stand-in
    at GW x GH with NEE, the port's leaves the JAX scene's."""
    def sc(T):
        s = gi_standin(T, GW, GH, paths=paths)
        if depth is not None:
            s.settings.maxTraceDepth = depth
        return s

    jp, js = jax_pack_scene(sc(JT), dtype=jnp.float32)
    js = dataclasses.replace(js, gi_point_light_direct=True, **knobs)
    _, ts = torch_pack_scene(sc(TT), device="cpu")
    ts = dataclasses.replace(ts, gi_point_light_direct=True, **knobs)
    return jp, js, from_numpy(jax_leaves(jp), ts, device="cpu"), ts


def _counted_draws(monkeypatch):
    """Count the draws of one key (``prng.uniform``) and of K keys
    (``prng.uniform_keys``) that the GI renderer makes."""
    seen = {"one": 0, "batched": 0}
    one, batched = prng.uniform, prng.uniform_keys

    def count_one(*a, **kw):
        seen["one"] += 1
        return one(*a, **kw)

    def count_batched(*a, **kw):
        seen["batched"] += 1
        return batched(*a, **kw)

    monkeypatch.setattr(prng, "uniform", count_one)
    monkeypatch.setattr(prng, "uniform_keys", count_batched)
    return seen


GI_MODES = {"plain": {}, "chunked": {"chunk_pixels": 96}, "adaptive": {"aa_enabled": True, "aa_adaptive": True}}


@pytest.mark.parametrize("mode", sorted(GI_MODES))
def test_gi_path_batch_matches_one_path_per_launch(mode, monkeypatch):
    """K = 4 paths per launch against one: the frames within 1e-5 (the order
    of summation of the K slabs differs), K1 launched once per bounce round
    over K slabs, and for K = 4 every draw batched: 2 per batch of paths and
    2 per bounce round."""
    _, _, tp, ts = _gi_pair(**GI_MODES[mode])
    passes = (5 if mode == "adaptive" else 1) * (-(-GW * GH // 96) if mode == "chunked" else 1)
    frames, rounds = [], []
    for K in (None, 4):
        seen = _counted_draws(monkeypatch)
        gi.bounce_rounds = 0
        with torch.no_grad():
            frames.append(P.render_frame(tp, dataclasses.replace(ts, gi_path_batch=K), prng.PRNGKey(KEY)))
        rounds.append(gi.bounce_rounds)
        batches = passes * PATHS // (K or 1)
        assert seen["one" if K is None else "batched"] == 2 * batches + 2 * gi.bounce_rounds, seen
        assert seen["batched" if K is None else "one"] == 0, seen
        assert batches <= gi.bounce_rounds <= batches * (ts.max_trace_depth + 1)
    assert rounds[1] < rounds[0]
    assert frames[0].max().item() > 0.01
    np.testing.assert_allclose(frames[1].numpy(), frames[0].numpy(), rtol=1e-5, atol=1e-5)


def test_gi_path_batch_matches_jax_batched_renderer(monkeypatch):
    """The port's K = 4 frame (plain K1) against JAX's fused GI renderer
    with gi_path_batch=4 under the same key: atol 5e-4."""
    jp, js, tp, ts = _gi_pair(depth=2, gi_path_batch=4)
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        want = np.asarray(jax_gi_renderer(js, GW, GH, interpret=True)(jp, jax.random.PRNGKey(KEY)))
    widths = []

    def trace(lay, prm, *rays, **kw):
        widths.append(rays[0].shape[0])
        return R.round0(lay, prm, *rays, **kw)

    with torch.no_grad():
        got = gi.build_gi_renderer(ts, GW, GH, trace=trace)(tp, prng.PRNGKey(KEY)).numpy()
    assert set(widths) == {4 * GW * GH}
    assert np.isfinite(got).all() and got.max() > 0.01
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_gi_path_batch_rules():
    """paths_per_pixel must be a multiple of K; the per-shard sampler and
    the eager twin keep one path per launch, as in JAX (its mesh builds the
    tracer with K = 1), so their frames with gi_path_batch set are the
    frames without it, bit for bit."""
    _, _, tp, ts = _gi_pair(paths=4)
    with pytest.raises(ValueError, match="gi_path_batch"):
        gi.build_gi_renderer(dataclasses.replace(ts, gi_path_batch=3), GW, GH)
    tb = dataclasses.replace(ts, gi_path_batch=4)
    key = prng.PRNGKey(KEY)
    mesh = make_mesh(["cpu"] * 2)
    with torch.no_grad():
        assert torch.equal(make_sharded_render_fn(tb, mesh)(tp, key), make_sharded_render_fn(ts, mesh)(tp, key))
        assert torch.equal(P.render_frame_wavefront(tp, tb, key), P.render_frame_wavefront(tp, ts, key))


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_gi_path_batch_step_matches_one_path_step(remat):
    """A 16x12 GI step with K = 2 (with and without ``gi_remat_paths``, which
    checkpoints one batch of K paths) against K = 1: the repo's
    frame-gradient rule."""
    _, _, tp, ts = _gi_pair(paths=4)
    target = torch.from_numpy(np.random.default_rng(3).uniform(size=(GH, GW, 3)).astype(np.float32))
    out = []
    for st in (ts, dataclasses.replace(ts, gi_path_batch=2, gi_remat_paths=remat)):
        p, xs = grad_leaves(tp)
        loss = ((P.render_frame(p, st, prng.PRNGKey(KEY)) - target) ** 2).mean()
        loss.backward()
        out.append((loss.item(), port_grads(xs)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-4)
    scene = [k for k in LEAF_NAMES if not k.startswith("camera.")]
    compare_grads(out[1][1], out[0][1], scene, rtol=5e-3, skip_zero=True)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(out[1][1], out[0][1], [k], rtol=0.1, atol=0.0, min_compared=1)


# --------------------------------------------------------------------------
# bounce_mode="compact"
# --------------------------------------------------------------------------


def _flagship(w, h, **knobs):
    tp, ts = torch_pack_scene(flagship_standin(TT, w, h), device="cpu")
    return tp, dataclasses.replace(ts, aa_enabled=False, **knobs)


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_compact_bounces_match_full_and_block(case):
    """Lane-compacted bounce rounds against full-width and block-compacted
    ones, bit for bit; the overflow (capacity 1, one tile of 1024 lanes,
    against ~1,800 continuing lanes at 256x192) takes the full-width rounds
    and is counted."""
    w, h, cap = (32, 24, 500) if case == "fits" else (256, 192, 1)
    tp, ts = _flagship(w, h, bounce_capacity=cap)
    frames = {}
    for mode in ("block", "full", "compact"):
        F.compact_overflows = F.bounce_rounds = 0
        with torch.no_grad():
            frames[mode] = P.render_frame(tp, dataclasses.replace(ts, bounce_mode=mode))
        assert F.bounce_rounds > 0
        assert F.compact_overflows == (case == "overflow" and mode == "compact")
    assert torch.equal(frames["compact"], frames["full"])
    assert torch.equal(frames["compact"], frames["block"])


def test_compact_frame_matches_jax_fused(monkeypatch):
    """One compact frame against JAX's fused renderer in the same mode, at
    the frame limits: the stand-in's floor, box and mirror sphere (no CSG,
    whose kernel takes JAX ~20 s to compile per form) at 32x24, capacity
    500 (one 1024-lane tile)."""
    knobs = {"bounce_mode": "compact", "bounce_capacity": 500}
    jp, js = jax_pack_scene(_standin_part(JT, ("floor", "box", "mirror_ball"), 5), dtype=jnp.float32)
    js = dataclasses.replace(js, **knobs)
    tp, ts = torch_pack_scene(_standin_part(TT, ("floor", "box", "mirror_ball"), 5), device="cpu")
    tp, ts = from_numpy(jax_leaves(jp), ts, device="cpu"), dataclasses.replace(ts, **knobs)
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        want = np.asarray(jax_flagship_renderer(js, 32, 24, interpret=True)(jp))
    widths = []

    def trace(lay, prm, *rays, **kw):
        widths.append(rays[0].shape[0] if rays else None)
        return R.round0(lay, prm, *rays, **kw)

    F.compact_overflows = 0
    with torch.no_grad():
        got = F.build_flagship_renderer(ts, 32, 24, trace=trace)(tp).numpy()
    assert widths[0] is None and len(widths) > 1 and set(widths[1:]) == {R.TILE_N}
    assert F.compact_overflows == 0
    assert_frame_close(got, want)


# --------------------------------------------------------------------------
# texel_tap_reuse
# --------------------------------------------------------------------------


def _reuse_scene(w=32, h=24):
    tp, ts = torch_pack_scene(flagship_standin(TT, w, h), device="cpu")
    return tp, ts  # AA on (quirk), the mirror sphere, two bitmaps


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_texel_tap_reuse_is_bit_identical(case):
    """Reuse on against off: the flagship frame, the rows renderer's slices
    and the sharded frame over two entries, bit for bit; capacity n (fits)
    or 1 (every tap overflows to the full gather)."""
    tp, ts = _reuse_scene()
    n = 32 * 24
    on = dataclasses.replace(ts, texel_tap_reuse=True, texel_reuse_capacity=n if case == "fits" else 1)
    F.reuse_taps = F.reuse_changed = F.reuse_overflows = 0
    with torch.no_grad():
        assert torch.equal(P.render_frame(tp, on), P.render_frame(tp, ts))
        assert F.reuse_taps == 4 and 0 < F.reuse_changed < 4 * n
        assert F.reuse_overflows == (0 if case == "fits" else 4)
        half = n // 2
        rows_on = F.build_rows_renderer(on, 32, 24, half)
        rows_off = F.build_rows_renderer(ts, 32, 24, half)
        for base in (0, half):
            assert torch.equal(rows_on(tp, base), rows_off(tp, base))
        assert F.reuse_taps == 12
        mesh = make_mesh(["cpu"] * 2)
        assert torch.equal(make_sharded_render_fn(on, mesh)(tp), make_sharded_render_fn(ts, mesh)(tp))
        assert F.reuse_taps == 20


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_texel_tap_reuse_gradients_match_off(case):
    """The AA5 step's gradients with reuse equal those without it at f32
    rounding (the base tap's gather takes the unchanged lanes' cotangents,
    so the atlas sums in another order)."""
    tp, ts = _reuse_scene()
    on = dataclasses.replace(ts, texel_tap_reuse=True, texel_reuse_capacity=32 * 24 if case == "fits" else 1)
    target = torch.from_numpy(np.random.default_rng(4).uniform(size=(24, 32, 3)).astype(np.float32))
    out = []
    for st in (ts, on):
        p, xs = grad_leaves(tp)
        loss = ((P.render_frame(p, st) - target) ** 2).mean()
        loss.backward()
        out.append((loss.item(), port_grads(xs)))
    assert out[0][0] == out[1][0]
    assert np.abs(out[0][1]["bitmap_atlas"]).max() > 0
    for k in LEAF_NAMES:
        a, b = out[1][1][k], out[0][1][k]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * (np.abs(b).max() if b.size else 0.0), err_msg=k)


# --------------------------------------------------------------------------
# texel_grad_mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["histogram", "sorted", "scatter"])
def test_texel_grad_mode_vjp_matches_jax(mode):
    """The quad gather's VJP in each mode against jax.vjp of JAX's
    ``quad_gather_flat`` on the same table, keys (duplicated, with runs) and
    cotangents: rtol 1e-5 of the largest entry."""
    rng = np.random.default_rng(8)
    table = rng.uniform(size=(97, 12)).astype(np.float32)
    key = rng.integers(0, 97, 3000).astype(np.int32)
    key[100:400] = 5
    g = rng.normal(size=(3000, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JS.quad_gather_flat(mode, t, jnp.asarray(key)), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_()
    out = S.quad_gather_flat(t, torch.from_numpy(key), mode)
    assert torch.equal(out.detach(), torch.from_numpy(table)[torch.from_numpy(key).long()])
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _step(tp, ts, target):
    p, xs = grad_leaves(tp)
    loss = ((P.render_frame(p, ts) - target) ** 2).mean()
    loss.backward()
    return loss.item(), port_grads(xs)


def test_texel_grad_modes_match_histogram():
    """The step's atlas gradient under "sorted" and "scatter" against
    "histogram" (tests/test_inverse.py:219-241: atol 1e-6, rtol 1e-4); the
    mode moves nothing else."""
    tp, ts = _flagship(32, 24)
    target = torch.from_numpy(np.random.default_rng(6).uniform(size=(24, 32, 3)).astype(np.float32))
    loss_h, hist = _step(tp, ts, target)
    assert np.abs(hist["bitmap_atlas"]).sum() > 0
    for mode in ("sorted", "scatter"):
        loss, got = _step(tp, dataclasses.replace(ts, texel_grad_mode=mode), target)
        assert loss == loss_h
        np.testing.assert_allclose(got["bitmap_atlas"], hist["bitmap_atlas"], atol=1e-6, rtol=1e-4, err_msg=mode)
        for k in LEAF_NAMES:
            if k != "bitmap_atlas":
                assert np.array_equal(got[k], hist[k]), (mode, k)


def _standin_part(T, names, depth):
    """The stand-in at 32x24 with only the nodes ``names`` (and its two
    bitmaps), AA off, maxTraceDepth ``depth``: scenes without CSG, whose JAX
    programs compile in seconds."""
    sc = flagship_standin(T, 32, 24)
    sc.nodes = [nd for nd in sc.nodes if nd.name in names]
    sc.geometries = [nd.geometry for nd in sc.nodes]
    sc.shaders = [nd.shader for nd in sc.nodes]
    sc.textures = sc.textures[:2]
    sc.settings.AAEnabled = False
    sc.settings.maxTraceDepth = depth
    return sc


def _texel_edge_pixels(tp, ts, w, h, margin=1e-3):
    """[h, w] bool: primary hits on a bitmap node within ``margin`` of a
    texel edge, where the bilinear slope jumps (tests/test_torch_whitted_grad.py)."""
    with torch.no_grad():
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        orig, dir = screen_rays(tp.camera, begin_frame(tp.camera, w / h), float(w), float(h), xs.reshape(-1),
                                ys.reshape(-1))
        hit, win = G.scene_closest(tp, ts, orig, dir)
        winc = win.clamp_min(0)
        _, _, p, q = S.bitmap_plan(tp, ts, winc, hit["u"], hit["v"])
        frac = torch.minimum(torch.minimum(p, 1 - p), torch.minimum(q, 1 - q))[:, 0]
        edge = (win >= 0) & (S.tex_kind_of(ts, winc) == TEX_BITMAP) & (frac < margin)
    return edge.reshape(h, w).numpy()


@pytest.mark.parametrize("mode", ["histogram", "sorted", "scatter"])
def test_texel_grad_mode_matches_jax_grad(mode):
    """The port's fused frame in each mode against jax.grad of JAX's
    ``render_frame`` (its XLA path) in the same mode, on the stand-in's two
    bitmap-textured nodes alone (``_standin_part``): the atlas gradient at
    rtol 5e-3 of its largest (tests/test_pallas_grad.py:108), weighted to
    the pixels whose frames agree to 1e-5 and off texel edges."""
    jp, js = jax_pack_scene(_standin_part(JT, ("floor", "box"), 0), dtype=jnp.float32)
    js = dataclasses.replace(js, texel_grad_mode=mode)
    _, ts = torch_pack_scene(_standin_part(TT, ("floor", "box"), 0), device="cpu")
    ts = dataclasses.replace(ts, texel_grad_mode=mode)
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    key = jax.random.PRNGKey(0)
    ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, js, key))(jp))
    with torch.no_grad():
        img = P.render_frame(tp, ts).numpy()
    weight = (np.abs(img - ref).max(-1) <= 1e-5) & ~_texel_edge_pixels(tp, ts, 32, 24)
    assert weight.mean() > 0.9
    weight = weight.astype(np.float32)[..., None]
    target = np.random.default_rng(7).uniform(size=ref.shape).astype(np.float32)
    gj = jax.jit(jax.grad(lambda p: (((jax_render_frame(p, js, key) - target) ** 2) * weight).mean()))(jp)
    p, xs = grad_leaves(tp)
    (((P.render_frame(p, ts) - torch.from_numpy(target)) ** 2) * torch.from_numpy(weight)).mean().backward()
    compare_grads(port_grads(xs), jax_leaves(gj), ["bitmap_atlas"], rtol=5e-3, min_compared=1)


def test_unknown_texel_grad_mode_raises():
    tp, ts = _flagship(32, 24, texel_grad_mode="bogus")
    with pytest.raises(ValueError, match="texel_grad_mode"):
        with torch.no_grad():
            P.render_frame(tp, ts)
    with pytest.raises(ValueError, match="texel_grad_mode"):
        S.quad_gather_flat(torch.zeros((4, 12)), torch.zeros(3, dtype=torch.int32), "bogus")
