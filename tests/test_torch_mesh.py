"""The sharded frame and gradient step in one process
(chess2rt_tpu_torch/parallel/mesh.py): a mesh of three and of eight CPU
entries against the port's single-device ``render_frame``, quirk and
adaptive AA, ``chunk_pixels`` honoured per shard; and the shard sizes
against the JAX package's ``_fused_shard_setup`` (computed, not run)."""

import dataclasses

import pytest
import torch

from chess2rt_tpu.ops.pallas_trace import BOUNCE_BLOCK as JAX_BOUNCE_BLOCK
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.parallel import (
    make_mesh,
    make_sharded_render_fn,
    make_sharded_value_and_grad,
    render_frame_distributed,
)
from chess2rt_tpu_torch.parallel import mesh as M
from chess2rt_tpu_torch.render.pipeline import render_frame

from torch_port_cases import H, W, packed_pair

torch.set_num_threads(2)


def _cpu_mesh(k):
    return make_mesh(["cpu"] * k)


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("adaptive", [False, True], ids=["quirk AA", "adaptive AA"])
def test_sharded_frame_is_the_single_frame(shards, adaptive):
    """2e-5 is the JAX package's gate (tests/test_parallel.py:166-174); the
    plain version is elementwise per lane, so the frames are equal.  Eight
    shards pad the 768-pixel frame to 1024 lanes: the last two shards
    render nothing but pixels below the frame."""
    _, _, tp, ts = packed_pair("standin")
    ts = dataclasses.replace(ts, aa_adaptive=adaptive)
    img = make_sharded_render_fn(ts, _cpu_mesh(shards))(tp)
    ref = render_frame(tp, ts)
    assert img.shape == (H, W, 3)
    assert (img - ref).abs().max().item() <= 2e-5
    assert torch.equal(img, ref)


def test_render_frame_distributed_and_chunked_shards():
    """``chunk_pixels`` is honoured per shard: at 64x48 a 2-shard mesh has
    shards of 1536 lanes, and a chunk of 1000 pixels (rounded to one
    1024-lane tile) runs each as 2 lin-input slabs of 1024 lanes."""
    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.scenes import flagship_standin

    tp, ts = pack_scene(flagship_standin(TT, 64, 48), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    ref = render_frame(tp, ts)
    widths = []

    def trace(lay, prm, *rays, **kw):
        if kw.get("lin_input"):
            widths.append(kw["n_lanes"])
        return R.round0(lay, prm, *rays, **kw)

    chunked = dataclasses.replace(ts, chunk_pixels=1000)
    img = make_sharded_render_fn(chunked, _cpu_mesh(2), trace=trace)(tp)
    assert widths == [1024] * 4
    assert torch.equal(img, ref)
    assert torch.equal(render_frame_distributed(tp, ts, _cpu_mesh(3)), ref)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("size", [(32, 24), (48, 32), (1920, 1080), (7680, 4320)])
def test_shard_sizes_are_the_jax_mesh_layers(shards, size):
    """n_pad = n + (-n) % (n_shards * BOUNCE_BLOCK), C = n_pad // n_shards
    (chess2rt_tpu/parallel/mesh.py:152-155), and every shard base is a lane
    base the parameter vector holds exactly."""
    _, _, _, ts = packed_pair("standin")
    w, h = size
    ts = dataclasses.replace(ts, width=w, height=h)
    _, C, n_pad = M._fused_shard_setup(ts, _cpu_mesh(shards))
    n = w * h
    want_pad = n + (-n) % (shards * JAX_BOUNCE_BLOCK)
    assert (n_pad, C) == (want_pad, want_pad // shards)
    assert C % R.BOUNCE_BLOCK == 0 and n_pad >= n
    for i in range(shards):
        assert R.exact_lane_base(i * C) == i * C


def test_make_mesh_and_unported_modes():
    """The mesh constructors, and the modes the per-shard sampler now
    renders: DoF, stereo, GI and float64 frames (no mode raises), each
    equal to the sampler's own frame through the twin's tracers, and the
    2-D mesh's frame equal to the 1-D mesh's bit for bit."""
    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu_torch.models.packed import pack_scene
    from chess2rt_tpu_torch.ops import prng
    from chess2rt_tpu_torch.scenes import flagship_standin, gi_standin

    mesh = make_mesh(["cpu", "cpu"])
    assert mesh == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_mesh_2d()
    with pytest.raises(ValueError):
        make_mesh([])
    grid = M.make_mesh_2d(["cpu"] * 8)
    assert grid.shape == (2, 4) and len(grid.devices) == 2 and len(grid.devices[0]) == 4
    assert M.make_mesh_2d(["cpu"] * 4).shape == (2, 2) and M.make_mesh_2d(["cpu"] * 2).shape == (1, 2)
    with pytest.raises(ValueError, match="hosts"):
        M.make_mesh_2d(["cpu"] * 4, hosts=3)
    key = prng.PRNGKey(4)
    cases = [flagship_standin(TT, 12, 7, dof=True, samples=2), flagship_standin(TT, 12, 7, stereo=True),
             gi_standin(TT, 12, 7, paths=2)]
    for sc in cases:
        tp, ts = pack_scene(sc, device="cpu")
        ts = dataclasses.replace(ts, aa_enabled=False, gi_point_light_direct=ts.gi_enabled)
        img = make_sharded_render_fn(ts, mesh)(tp, key)
        twin = make_sharded_render_fn(ts, mesh, trace=None)(tp, key)
        assert img.shape == (7, 12, 3) and img.mean() > 0.01
        assert (img - twin).abs().max().item() < 5e-4
        assert torch.equal(make_sharded_render_fn(ts, M.make_mesh_2d(["cpu"] * 2))(tp, key), img)
        _, grads = make_sharded_value_and_grad(ts, mesh)(tp, torch.zeros_like(img), key)
        assert grads.mat_color.abs().max() > 0
    # float64 goes through the sampler and the twin: the single device's frame
    tp, ts = pack_scene(flagship_standin(TT, 12, 7), dtype=torch.float64, device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    f64 = make_sharded_render_fn(ts, make_mesh(["cpu"] * 3))(tp)
    assert f64.dtype == torch.float64
    assert (f64 - render_frame(tp, ts)).abs().max().item() < 1e-9


def test_mask_from_base_pads_with_unflagged_lanes():
    _, _, tp, ts = packed_pair("standin")
    base = torch.rand((1024, 3), generator=torch.Generator().manual_seed(0))
    mask = M._mask_from_base(base, ts)
    assert mask.shape == (1024,) and mask.dtype == torch.bool
    assert not bool(mask[W * H:].any()) and bool(mask[:W * H].any())
    assert M._frame_from_samples(base, ts).shape == (H, W, 3)
