"""The slice as a whole: the port's ``render_frame`` on the flagship stand-in
(32x24, AA5, maxTraceDepth 5, a mirror sphere) against the JAX package's
XLA anchor (``render_frame`` with use_pallas off), and the port's own
bounce-round modes against each other.  The comparison with the JAX fused
renderer is in tests/test_torch_flagship_fused.py.  On the CPU the port's
round-0 wrapper runs its plain version."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chess2rt_tpu.render.pipeline import render_frame as jax_render_frame
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import H, W, assert_frame_close, packed_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def standin():
    return packed_pair("standin")


def test_standin_is_the_flagship_configuration(standin):
    _, _, tp, ts = standin
    assert (ts.width, ts.height, ts.max_trace_depth, ts.aa_enabled) == (W, H, 5, True)
    assert R.supports(ts) and not ts.use_pallas
    assert ts.bitmap_sizes == ((256, 256), (128, 128))
    kinds = {(ns.shader_kind, ns.tex_kind) for ns in ts.nodes}
    assert (R.REFLECTION, R.TEX_NONE) in kinds and (R.PHONG, R.TEX_PROC2) in kinds
    assert any(ns.geom[0] == "csg" and ns.geom[1] == "diff" for ns in ts.nodes)
    assert any(ns.geom[0] == "csg" and ns.geom[1] == "inter" for ns in ts.nodes)
    assert any(not (ns.identity_transform or ns.offset_only) for ns in ts.nodes)
    assert ts.n_lights == 2


def test_frame_matches_jax_xla_anchor(standin):
    jp, js, tp, ts = standin
    ref = np.asarray(jax_render_frame(jp, js, jax.random.PRNGKey(0)))
    img = render_frame(tp, ts).numpy()
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    assert (img.max(-1) > 0).mean() > 0.5
    assert_frame_close(img, ref)


def test_frame_is_the_mean_of_its_taps(standin):
    from chess2rt_tpu_torch.render.pipeline import AA_KERNEL

    _, _, tp, ts = standin
    render = F.build_flagship_renderer(ts, W, H)
    taps = [render.tap(tp, off) for off in ((0.0, 0.0),) + AA_KERNEL]
    want = sum(taps[1:], taps[0]) / 5.0
    torch.testing.assert_close(render(tp), want.reshape(H, W, 3), rtol=0, atol=1e-6)


def test_mirror_rounds_change_the_frame(standin):
    """The mirror sphere's bounce rounds add light: a depth-0 frame (no
    bounce rounds) differs from the depth-5 one on the mirror's pixels."""
    _, _, tp, ts = standin
    deep = render_frame(tp, ts)
    flat = render_frame(tp, dataclasses.replace(ts, max_trace_depth=0))
    changed = (deep - flat).abs().amax(-1) > 1e-3
    assert 0.01 < changed.float().mean() < 0.5


@pytest.mark.parametrize("mode", ["full", "overflow"])
def test_block_bounces_match_other_modes(mode):
    """Block compaction (the default) against full-width bounce rounds and
    against the full-width overflow fallback, at a frame large enough to
    hold more than one capacity unit of blocks (96 blocks of 128 lanes)."""
    w, h = 128, 96
    tp, ts = pack_scene(flagship_standin(TT, w, h), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    block = render_frame(tp, ts)
    if mode == "full":
        other = dataclasses.replace(ts, bounce_mode="full")
    else:
        # 8 blocks (the smallest capacity) cannot hold the mirror's blocks
        other = dataclasses.replace(ts, bounce_block_capacity=8)
        alive = _round0_continuations(tp, ts, w, h)
        assert alive.reshape(-1, R.BOUNCE_BLOCK).any(1).sum() > 8
    assert_frame_close(block.numpy(), render_frame(tp, other).numpy())


def _round0_continuations(tp, ts, w, h):
    lay = R.layout(ts, w, h)
    o = R.round0(lay, lay.pack(tp))
    _, cont, *_ = F.combine_outputs(tp, ts, o)
    return cont
