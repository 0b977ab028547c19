"""Adaptive AA per slice: the port's ``rows(..., mask=...)`` and ``rows(...,
mask=..., base=...)`` against the JAX package's ``build_rows_renderer``, at
64x48 in 2 slices of 1536 lanes (364 and 1,254 flagged pixels): compacted
(a capacity of 2048 lanes per slice) and overflow (one 1024-lane tile, below
the second slice's flagged count).  Both sides get the same mask, detected
on the port's whole base frame."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.render.pipeline import aa_detect
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import assert_frame_close, forward_jax_kernels, jax_rows_slices

torch.set_num_threads(2)

W, H = 64, 48
N_LANES, N_SLICES = 1536, 2
CAPACITY = {"compacted": 3072, "overflow": 1}  # frame-level; a slice gets its share


def _port(capacity):
    tp, ts = pack_scene(flagship_standin(TT, W, H), device="cpu")
    ts = dataclasses.replace(ts, aa_adaptive=True, aa_capacity=capacity)
    rows = F.build_rows_renderer(ts, W, H, N_LANES)
    base = torch.cat([rows.tap(tp, i * N_LANES) for i in range(N_SLICES)])
    mask = aa_detect(base.reshape(H, W, 3)).reshape(-1)
    return tp, ts, rows, base, mask


@pytest.mark.parametrize("given_base", [False, True], ids=["base in graph", "base given"])
@pytest.mark.parametrize("branch", list(CAPACITY))
def test_adaptive_rows_match_jax(branch, given_base, monkeypatch):
    tp, ts, rows, base, mask = _port(CAPACITY[branch])
    counts = [int(m.sum()) for m in mask.chunk(N_SLICES)]
    assert min(counts) <= 1024 < max(counts) <= 2048
    bases = base.chunk(N_SLICES) if given_base else [None] * N_SLICES
    img = torch.cat([rows(tp, i * N_LANES, mask=m, base=b)
                     for i, (m, b) in enumerate(zip(mask.chunk(N_SLICES), bases))])

    jp, js = jax_pack_scene(flagship_standin(JT, W, H), dtype=jnp.float32)
    js = dataclasses.replace(js, aa_adaptive=True, aa_capacity=CAPACITY[branch])
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = jax_rows_slices(js, jp, N_LANES, N_SLICES, masks=[m.numpy() for m in mask.chunk(N_SLICES)],
                              bases=[b.numpy() for b in bases] if given_base else None, width=W, height=H)
    assert_frame_close(img.reshape(H, W, 3).numpy(), np.asarray(ref).reshape(H, W, 3))


def test_slices_take_the_branch_their_own_count_decides():
    """A slice's capacity is its share of ``aa_capacity``; the compacted taps
    run the ray-input form at that width on the flagged lanes' global pixel
    indices, so the slices equal the whole frame's adaptive render."""
    tp, ts, _, _, mask = _port(1)
    widths = []

    def trace(lay, prm, *rays, **kw):
        widths.append(rays[0].shape[0] if rays else kw.get("n_lanes"))
        return R.round0(lay, prm, *rays, **kw)

    rows = F.build_rows_renderer(ts, W, H, N_LANES, trace=trace)
    per_slice = []
    for i, m in enumerate(mask.chunk(N_SLICES)):
        widths.clear()
        per_slice.append(rows(tp, i * N_LANES, mask=m))
        # slice 0 compacts (1 lin tap, 4 taps at 1024 lanes), slice 1 overflows (5 lin taps)
        assert widths.count(N_LANES) == (1 if i == 0 else 5), widths
    whole = F.build_flagship_renderer(dataclasses.replace(ts, aa_capacity=3072), W, H)(tp)
    d = (torch.cat(per_slice).reshape(H, W, 3) - whole).abs().amax(-1)
    assert int((d > 2e-3).sum()) <= 3 and d.median().item() < 2e-4
    # slice 0 took the whole frame's branch, with the same rays: equal
    assert torch.equal(per_slice[0], whole.reshape(-1, 3)[:N_LANES])


def test_mask_is_required():
    tp, ts, rows, _, _ = _port(None)
    with pytest.raises(ValueError, match="mask"):
        rows(tp, 0)
