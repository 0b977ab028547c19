"""The eager Whitted twin (``render.pipeline.render_frame_wavefront``) in
float32: against the JAX package's XLA frame (its ``render_frame`` with
``use_pallas`` off, jitted on the CPU), against the port's fused frame
(K1's plain version on the CPU), and its round loops against each other.

Frame limits (tests/test_fuzz.py:234-237): per pixel the largest channel
error; < 1% of pixels above 2e-3 and a median below 2e-4.  Round-loop
equivalence as tests/test_wavefront.py holds it: a knife-edge tail of at
most max(2, 2e-4 of the frame) pixels above 2e-4.
"""

import dataclasses

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
from chess2rt_tpu_torch.oracle import OracleRenderer
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops.round0 import supports
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import csg_free_scene

from torch_port_cases import H, W, assert_frame_close, scene, u8

torch.set_num_threads(2)


def _scene(T, case):
    return csg_free_scene(T, 0, W, H) if case == "csg_free" else scene(T, case)


def _pair(case, **kw):
    """(JAX frame, port twin frame) of one scene at f32, static knobs ``kw``
    applied to both."""
    jp, js = jax_pack_scene(_scene(JT, case), dtype=jnp.float32)
    tp, ts = torch_pack_scene(_scene(TT, case), device="cpu")
    js, ts = dataclasses.replace(js, **kw), dataclasses.replace(ts, **kw)
    ref = np.asarray(jax.jit(lambda p: jax_render_frame(p, js))(jp))
    out = P.render_frame_wavefront(tp, ts)
    assert out.dtype == torch.float32 and tuple(out.shape) == (H, W, 3)
    return ref, out.numpy()


# the stand-in with AA, its glass variant without, a random scene each way
# (seed 1002 is a mirror plane over the horizon), the CSG-free scene
@pytest.mark.parametrize("case,aa", [("standin", True), ("glass", False), (1000, True), (1002, False),
                                     ("csg_free", False)])
def test_twin_matches_jax_xla_frame(case, aa):
    ref, out = _pair(case, aa_enabled=aa)
    assert_frame_close(out, ref)
    if case in ("standin", "glass", "csg_free"):
        assert (ref.max(-1) > 0).mean() > 0.5  # the frame shows the scene


@pytest.mark.parametrize("knob", [{"chunk_pixels": 200}, {"aa_adaptive": True}])
def test_chunked_and_adaptive_frames_match_jax(knob):
    """``chunk_pixels`` slabs (768 pixels in 4 slabs of 200, the last padded)
    and adaptive AA, each against the JAX frame with the same knob."""
    ref, out = _pair("csg_free", aa_enabled=True, **knob)
    assert_frame_close(out, ref)
    tp, ts = torch_pack_scene(_scene(TT, "csg_free"), device="cpu")
    whole = P.render_frame_wavefront(tp, ts).numpy()
    if "chunk_pixels" in knob:
        np.testing.assert_array_equal(out, whole)  # slabs change no pixel
    else:
        # the unflagged pixels keep their base sample, the flagged ones are the AA5 average
        base = P.render_frame_wavefront(tp, dataclasses.replace(ts, aa_enabled=False)).numpy()
        mask = P.aa_detect(torch.from_numpy(base)).numpy()
        assert 0 < mask.mean() < 1
        np.testing.assert_array_equal(out[mask], whole[mask])
        np.testing.assert_array_equal(out[~mask], base[~mask])


@pytest.mark.parametrize("case", ["standin", "glass", 1000])
def test_twin_matches_fused_frame(case):
    """The twin against the port's fused ``render_frame`` (K1's plain
    version on the CPU), as tests/test_fuzz.py holds the JAX kernel to the
    XLA path."""
    tp, ts = torch_pack_scene(_scene(TT, case), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=case != "glass")
    assert supports(ts)  # render_frame takes the fused path
    assert_frame_close(P.render_frame_wavefront(tp, ts).numpy(), P.render_frame(tp, ts).numpy())


def _assert_loops_equal(a, b, knife_edge_frac=2e-4):
    d = np.abs(a - b).max(-1)
    bad = (d > 2e-4).sum()
    assert bad <= max(2, knife_edge_frac * d.size), (bad, d.size, d.max())


@pytest.mark.parametrize("case", ["standin", "glass"])
def test_fast_forward_is_bit_equal(case):
    """The loop that stops at the first all-dead round and the default one
    that skips dead rounds run the same rounds."""
    tp, ts = torch_pack_scene(_scene(TT, case), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    a = P.render_frame_wavefront(tp, ts)
    b = P.render_frame_wavefront(tp, dataclasses.replace(ts, fast_forward=True))
    assert torch.equal(a, b)


@pytest.mark.parametrize("cap", [256, W * H // 2, 8])
def test_bounce_capacity_compaction_matches_full_width(cap):
    """Rounds after the first on a compacted live set (``bounce_capacity``)
    against full width; 8 lanes overflow (the mirror covers more), so that
    frame takes the full-width branch.  tests/test_wavefront.py:45-58 holds
    the JAX round loops so."""
    tp, ts = torch_pack_scene(_scene(TT, "standin"), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    full = P.render_frame_wavefront(tp, ts).numpy()
    calls = []
    real = P._run_rounds

    def spy(packed, static, carry, n_rounds):
        calls.append(carry[0].shape[0])
        return real(packed, static, carry, n_rounds)

    P._run_rounds = spy
    try:
        out = P.render_frame_wavefront(tp, dataclasses.replace(ts, bounce_capacity=cap)).numpy()
    finally:
        P._run_rounds = real
    assert calls == ([W * H] if cap == 8 else [cap])  # the branch taken
    _assert_loops_equal(out, full)


def test_empty_scene_renders_black():
    """No node: ``render_frame`` renders (every ray misses: black, as the
    oracle's frame).  The JAX package's render_frame raises on such a scene
    (a reshape of the empty node tables divides by zero)."""
    for dtype in (torch.float32, torch.float64):
        sc = scene(TT, "standin")
        sc.nodes = []
        tp, ts = torch_pack_scene(sc, dtype=dtype, device="cpu")
        img = P.render_frame(tp, ts)
        assert img.dtype == dtype and tuple(img.shape) == (H, W, 3)
        np.testing.assert_array_equal(img.numpy(), OracleRenderer(sc).render())
        assert not img.any()


def _chain_scene(T):
    """Random scene 1000 plus nine overlapping spheres in one union: 18 hits
    per ray."""
    sc = scene(T, 1000)
    geom = T.Sphere(name="s0", center=(0.0, 1.0, 0.0), R=1.0)
    for k in range(1, 9):
        geom = T.CsgUnion(name=f"u{k}", op="union", left=geom,
                          right=T.Sphere(name=f"s{k}", center=(0.3 * k - 1.2, 1.0, 0.0), R=1.0))
    sc.nodes.append(T.Node(name="chain", geometry=geom, shader=T.Lambert(name="chain", color=(1, 1, 1))))
    return sc


def test_render_frame_dispatch():
    """f32 scenes K1 covers take the fused path and f64 frames the twin.  A
    scene with more CSG hits per ray than K1's lists once held (16) is no
    exception: its f32 frame goes through K1 and meets the JAX XLA frame at
    the frame limits; in f64 the twin renders it."""
    taken = []
    real_fused, real_twin = F.build_flagship_renderer, P.render_frame_wavefront

    def fused(*a, **k):
        taken.append("fused")
        return real_fused(*a, **k)

    def twin(*a, **k):
        taken.append("twin")
        return real_twin(*a, **k)

    F.build_flagship_renderer, P.render_frame_wavefront = fused, twin
    try:
        for dtype in (torch.float32, torch.float64):
            tp, ts = torch_pack_scene(_scene(TT, 1000), dtype=dtype, device="cpu")
            P.render_frame(tp, ts)
        tp, ts = torch_pack_scene(_chain_scene(TT), device="cpu")
        assert supports(ts)
        out = P.render_frame(tp, ts).numpy()
        sc = _chain_scene(TT)
        tp, ts = torch_pack_scene(sc, dtype=torch.float64, device="cpu")
        img = P.render_frame(tp, ts)
    finally:
        F.build_flagship_renderer, P.render_frame_wavefront = real_fused, real_twin
    assert taken == ["fused", "twin", "fused", "twin"]
    # eager: XLA takes minutes to compile the 18-slot networks inlined in every round
    jp, js = jax_pack_scene(_chain_scene(JT), dtype=jnp.float32)
    with jax.disable_jit():
        assert_frame_close(out, np.asarray(jax_render_frame(jp, js)))
    assert (u8(img.numpy()) == u8(OracleRenderer(sc).render())).all(-1).mean() > 0.99