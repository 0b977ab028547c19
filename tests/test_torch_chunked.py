"""``render_frame`` with ``chunk_pixels``: slabs of 1024 lanes through K1's
ray-input form (rays from ``screen_rays``), at 64x48 (3 slabs), against the
un-chunked port frame and against the JAX package's chunked fused renderer
(eager glue, each kernel jitted on its own)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import assert_frame_close, forward_jax_kernels

torch.set_num_threads(2)

W, H = 64, 48


def _scene(glass=False):
    return pack_scene(flagship_standin(TT, W, H, glass=glass), device="cpu")


def _assert_chunked_close(img, ref):
    """The JAX package's own gate between its chunked and whole-frame fused
    renders (tests/test_pallas.py:225-227): the slab's rays come from
    ``screen_rays`` instead of the kernel's ray-gen, so a few knife-edge
    pixels move; at most 3 pixels above 2e-3 and a median below 2e-4."""
    d = (img - ref).abs().amax(-1)
    assert int((d > 2e-3).sum()) <= 3, (int((d > 2e-3).sum()), d.max().item())
    assert d.median().item() < 2e-4
    return d


@pytest.mark.parametrize("glass", [False, True], ids=["mirror", "glass"])
@pytest.mark.parametrize("chunk", [1024, 2000], ids=["3 slabs", "2 slabs padded"])
def test_chunked_matches_unchunked(chunk, glass):
    """The chunked-versus-unchunked test for the scenes the port supports
    (chunk 2000 rounds to slabs of 2048: 4096 lanes for 3072 pixels, so the
    pad lanes' clamp and the final slice run)."""
    tp, ts = _scene(glass)
    ref = render_frame(tp, ts)
    img = render_frame(tp, dataclasses.replace(ts, chunk_pixels=chunk))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    d = _assert_chunked_close(img, ref)
    # most pixels agree to the last bits: only the ray-gen differs
    assert (d <= 2e-5).double().mean().item() > 0.99


def test_chunked_matches_jax_chunked_fused_renderer(monkeypatch):
    jp, js = jax_pack_scene(flagship_standin(JT, W, H), dtype=jax.numpy.float32)
    tp, ts = _scene()
    js = dataclasses.replace(js, chunk_pixels=1024)
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = np.asarray(build_flagship_renderer(js, W, H, interpret=True)(jp))
    img = render_frame(tp, dataclasses.replace(ts, chunk_pixels=1024))
    assert_frame_close(img.numpy(), ref)


def test_slab_overflow_takes_the_fullwidth_fallback():
    """With the smallest block capacity (one 1024-lane tile, 8 blocks) a
    4096-lane slab of a 128x96 frame with more live blocks than that
    overflows and runs its bounce rounds at slab width; the frame is the
    same."""
    tp, ts = pack_scene(flagship_standin(TT, 128, 96), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False, chunk_pixels=4096, bounce_block_capacity=32)
    widths = []

    def trace(lay, prm, *rays, **kw):
        widths.append(rays[0].shape[0])
        return R.round0(lay, prm, *rays, **kw)

    ref = F.build_flagship_renderer(ts, 128, 96, trace=trace)(tp)
    compacted = list(widths)
    widths.clear()
    tight = dataclasses.replace(ts, bounce_block_capacity=1)
    img = F.build_flagship_renderer(tight, 128, 96, trace=trace)(tp)
    # 3 slabs; the compacted frame's bounce rounds run below slab width,
    # the overflowing one's at slab width
    assert compacted.count(4096) == 3 and widths.count(4096) > 3, (compacted, widths)
    assert torch.equal(img, ref)


def test_each_slab_is_traced_at_slab_width():
    tp, ts = _scene()
    ts = dataclasses.replace(ts, aa_enabled=False, chunk_pixels=1000)
    first = []

    def trace(lay, prm, *rays, **kw):
        first.append(rays[0].shape[0])
        return R.round0(lay, prm, *rays, **kw)

    F.bounce_rounds = 0
    F.build_flagship_renderer(ts, W, H, trace=trace)(tp)
    assert first.count(1024) >= 3 and len(first) == 3 + F.bounce_rounds
