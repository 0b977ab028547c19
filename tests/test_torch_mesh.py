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
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh([])
    _, _, tp, ts = packed_pair("standin")
    for change in ({"gi_enabled": True}, {"dof": True}, {"stereo": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_sharded_render_fn(dataclasses.replace(ts, **change), mesh)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_sharded_value_and_grad(dataclasses.replace(ts, **change), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_render_fn(ts, mesh)(dataclasses.replace(tp, node_matrix=tp.node_matrix.double()))


def test_mask_from_base_pads_with_unflagged_lanes():
    _, _, tp, ts = packed_pair("standin")
    base = torch.rand((1024, 3), generator=torch.Generator().manual_seed(0))
    mask = M._mask_from_base(base, ts)
    assert mask.shape == (1024,) and mask.dtype == torch.bool
    assert not bool(mask[W * H:].any()) and bool(mask[:W * H].any())
    assert M._frame_from_samples(base, ts).shape == (H, W, 3)
