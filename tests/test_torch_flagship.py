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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pixel_rays_take_the_scenes_dtype(dtype):
    """``camera.pixel_rays`` computes in the camera's dtype; ``pack_scene``
    rounds every floating leaf to one dtype, so that is the scene's
    (``ScenePacked.dtype``, ``node_matrix``'s), at any lane base."""
    from chess2rt_tpu_torch.models.packed import leaves
    from chess2rt_tpu_torch.ops.camera import pixel_rays

    tp, _ = pack_scene(flagship_standin(TT, 8, 6), dtype=dtype, device="cpu")
    assert {x.dtype for x in leaves(tp) if x.is_floating_point()} == {dtype}
    o3, d3 = pixel_rays(tp.camera, 8, 6, 24 + torch.arange(12), (0.3, 0.3))
    assert o3.dtype == d3.dtype == tp.dtype == dtype and o3.shape == d3.shape == (12, 3)
    assert torch.allclose((d3 * d3).sum(-1), torch.ones(12, dtype=dtype))


# --------------------------------------------------------------------------
# The renderers' path census
# --------------------------------------------------------------------------

# each case: the stand-in's arguments, its frame size, the settings
# it renders under, and the renderer that draws it ("frame": render_frame,
# "rows": the rows renderer on the second half of the frame, "mesh": the
# sharded renderer on a one-entry mesh, whose Monte-Carlo frames go through
# the per-shard sampler and its ``trace_fn``)
CENSUS_CASES = {
    "quirk_mirror": ({}, (32, 24), {}, "frame"),
    "quirk_env": ({"env": True}, (32, 24), {}, "frame"),
    "chunked": ({}, (48, 40), {"chunk_pixels": 1024}, "frame"),
    "adaptive_compacted": ({}, (64, 48), {"aa_adaptive": True, "aa_capacity": 2048}, "frame"),
    "adaptive_overflow": ({}, (64, 48), {"aa_adaptive": True}, "frame"),
    "texel_reuse": ({}, (32, 24), {"texel_tap_reuse": True}, "frame"),
    "dof": ({"dof": True, "env": True, "samples": 2}, (32, 24), {}, "frame"),
    "dof_slabs": ({"dof": True, "env": True, "samples": 2}, (48, 40), {"chunk_pixels": 1024}, "frame"),
    "dof_adaptive_compacted": ({"dof": True, "samples": 2}, (32, 24), {"aa_adaptive": True}, "frame"),
    "stereo": ({"stereo": True}, (32, 24), {}, "frame"),
    "rows_quirk": ({"env": True}, (32, 24), {}, "rows"),
    "rows_adaptive": ({}, (32, 24), {"aa_adaptive": True}, "rows"),
    "mesh_trace_fn": ({"dof": True, "env": True, "samples": 2}, (16, 12), {}, "mesh"),
}

# each case's counters and c2rt.* spans (``census_run``): the host reads by
# site, the bounce rounds, Monte-Carlo passes, environment gathers, glue
# combines and reused taps, and K1's calls (c2rt.k1: round0's launch
# counters move only on the card); mesh's trace_fn batches carry their
# c2rt.tap span as every other ray batch does; c2rt.keys counts the key
# derivations, one per split or fold_in: the frame's key, 2 per DoF pass (its
# four keys, the disc's two) and 1 per AA tap (a split, or mesh's fold_in)
CENSUS = {
    "quirk_mirror": {
        "bounce_rounds": 5, "c2rt.frame": 1, "c2rt.gather": 15, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5, "c2rt.tap": 5, "combine_glue": 10,
        "sync.flagship.block_alive": 10, "sync.flagship.block_count": 5,
    },
    "quirk_env": {
        "bounce_rounds": 5, "c2rt.env": 10, "c2rt.frame": 1, "c2rt.gather": 15, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5, "c2rt.tap": 5, "combine_glue": 10,
        "env_gathers": 10, "sync.flagship.block_alive": 10, "sync.flagship.block_count": 5,
    },
    "chunked": {
        "bounce_rounds": 10, "c2rt.frame": 1, "c2rt.gather": 30, "c2rt.k1": 20, "c2rt.round": 10,
        "c2rt.sync.flagship.block_alive": 20, "c2rt.sync.flagship.block_count": 10, "c2rt.tap": 10,
        "combine_glue": 20, "sync.flagship.block_alive": 20, "sync.flagship.block_count": 10,
    },
    "adaptive_compacted": {
        "bounce_rounds": 5, "c2rt.frame": 1, "c2rt.gather": 16, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.aa_count": 1, "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5,
        "c2rt.tap": 5, "combine_glue": 10, "sync.flagship.aa_count": 1, "sync.flagship.block_alive": 10,
        "sync.flagship.block_count": 5,
    },
    "adaptive_overflow": {
        "bounce_rounds": 5, "c2rt.frame": 1, "c2rt.gather": 15, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.aa_count": 1, "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5,
        "c2rt.tap": 5, "combine_glue": 10, "sync.flagship.aa_count": 1, "sync.flagship.block_alive": 10,
        "sync.flagship.block_count": 5,
    },
    "texel_reuse": {
        "bounce_rounds": 5, "c2rt.frame": 1, "c2rt.gather": 15, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5,
        "c2rt.sync.flagship.reuse_count": 4, "c2rt.tap": 5, "combine_glue": 10, "reuse_taps": 4,
        "sync.flagship.block_alive": 10, "sync.flagship.block_count": 5, "sync.flagship.reuse_count": 4,
    },
    "dof": {
        "bounce_rounds": 10, "c2rt.draw": 40, "c2rt.env": 20, "c2rt.frame": 1, "c2rt.gather": 30, "c2rt.k1": 20,
        "c2rt.keys": 25, "c2rt.mc_pass": 10, "c2rt.raygen": 10, "c2rt.round": 10, "c2rt.sync.flagship.block_alive": 20,
        "c2rt.sync.flagship.block_count": 10, "c2rt.tap": 10, "combine_glue": 20, "env_gathers": 20, "mc_passes": 10,
        "sync.flagship.block_alive": 20, "sync.flagship.block_count": 10,
    },
    "dof_slabs": {
        "bounce_rounds": 20, "c2rt.draw": 40, "c2rt.env": 40, "c2rt.frame": 1, "c2rt.gather": 60, "c2rt.k1": 40,
        "c2rt.keys": 25, "c2rt.mc_pass": 10, "c2rt.raygen": 10, "c2rt.round": 20, "c2rt.sync.flagship.block_alive": 40,
        "c2rt.sync.flagship.block_count": 20, "c2rt.tap": 20, "combine_glue": 40, "env_gathers": 40, "mc_passes": 10,
        "sync.flagship.block_alive": 40, "sync.flagship.block_count": 20,
    },
    "dof_adaptive_compacted": {
        "bounce_rounds": 10, "c2rt.draw": 40, "c2rt.frame": 1, "c2rt.gather": 31, "c2rt.k1": 20, "c2rt.keys": 25,
        "c2rt.mc_pass": 10, "c2rt.raygen": 10, "c2rt.round": 10, "c2rt.sync.flagship.block_alive": 20,
        "c2rt.sync.flagship.block_count": 10, "c2rt.sync.flagship.mc_aa_count": 1, "c2rt.tap": 10, "combine_glue": 20,
        "mc_passes": 10, "sync.flagship.block_alive": 20, "sync.flagship.block_count": 10,
        "sync.flagship.mc_aa_count": 1,
    },
    "stereo": {
        "bounce_rounds": 10, "c2rt.frame": 1, "c2rt.gather": 30, "c2rt.k1": 20, "c2rt.keys": 5, "c2rt.mc_pass": 5,
        "c2rt.raygen": 5, "c2rt.round": 10, "c2rt.sync.flagship.block_alive": 20, "c2rt.sync.flagship.block_count": 10,
        "c2rt.tap": 10, "combine_glue": 20, "mc_passes": 5, "sync.flagship.block_alive": 20,
        "sync.flagship.block_count": 10,
    },
    "rows_quirk": {
        "bounce_rounds": 5, "c2rt.env": 10, "c2rt.gather": 15, "c2rt.k1": 10, "c2rt.round": 5,
        "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5, "c2rt.tap": 5, "combine_glue": 10,
        "env_gathers": 10, "sync.flagship.block_alive": 10, "sync.flagship.block_count": 5,
    },
    "rows_adaptive": {
        "bounce_rounds": 5, "c2rt.gather": 16, "c2rt.k1": 10, "c2rt.round": 5, "c2rt.sync.flagship.aa_count": 1,
        "c2rt.sync.flagship.block_alive": 10, "c2rt.sync.flagship.block_count": 5, "c2rt.tap": 5, "combine_glue": 10,
        "sync.flagship.aa_count": 1, "sync.flagship.block_alive": 10, "sync.flagship.block_count": 5,
    },
    "mesh_trace_fn": {
        "bounce_rounds": 10, "c2rt.draw": 40, "c2rt.env": 20, "c2rt.gather": 20, "c2rt.k1": 20, "c2rt.keys": 25,
        "c2rt.round": 10, "c2rt.sync.flagship.full_alive": 20, "c2rt.tap": 10, "combine_glue": 20, "env_gathers": 20,
        "sync.flagship.full_alive": 20,
    },
}


def _census_counters():
    from chess2rt_tpu_torch.utils import spans

    return {"bounce_rounds": F.bounce_rounds, "mc_passes": F.mc_passes, "env_gathers": F.env_gathers,
            "combine_glue": F.combine_glue, "reuse_taps": F.reuse_taps,
            **{f"sync.{k}": v for k, v in spans.syncs.items()}}


def census_run(case):
    """One census case under the CPU profiler: (the counters' change and
    the count of each ``c2rt.*`` span, zeros left out; the frame)."""
    from torch.profiler import ProfilerActivity, profile

    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.parallel.mesh import make_sharded_render_fn
    from chess2rt_tpu_torch.render.pipeline import aa_detect

    args, (w, h), settings, renderer = CENSUS_CASES[case]
    tp, ts = pack_scene(flagship_standin(TT, w, h, **args), device="cpu")
    ts = dataclasses.replace(ts, **settings)
    key = prng.PRNGKey(22)
    half = w * h // 2
    if renderer == "frame":
        def draw():
            return render_frame(tp, ts, key)
    elif renderer == "mesh":
        fn = make_sharded_render_fn(ts, (torch.device("cpu"),))

        def draw():
            return fn(tp, key)
    else:
        rows = F.build_rows_renderer(ts, w, h, half)
        mask = None
        if ts.aa_adaptive:
            with torch.no_grad():
                base = F.build_flagship_renderer(dataclasses.replace(ts, aa_enabled=False), w, h)(tp)
            mask = aa_detect(base).reshape(-1)[half:]

        def draw():
            return rows(tp, half, mask=mask)

    before = _census_counters()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        img = draw()
    counts = {k: v - before[k] for k, v in _census_counters().items() if v != before[k]}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("c2rt."):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts, img


@pytest.mark.parametrize("case", list(CENSUS_CASES))
def test_renderer_path_census(case):
    """Every branch of the renderers (the un-chunked quirk frame with its
    block bounces, chunk slabs, adaptive AA compacted and overflowing,
    texel_tap_reuse, DoF at full width, in slabs and adaptive-compacted,
    stereo, the rows renderer quirk and adaptive, and mesh's trace_fn on
    one shard) makes exactly its host reads, bounce rounds, passes, gathers
    and spans."""
    counts, img = census_run(case)
    assert counts == CENSUS[case]
    assert bool(torch.isfinite(img).all()) and img.max().item() > 0.05
