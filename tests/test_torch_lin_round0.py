"""K1's lin-input form: the port's plain version against the JAX kernel
``build_round0_kernel(js, 32, 24, True, n_rays=256, lin_input=True)`` in
interpret mode, at lane bases 0, 256 and 512, with and without the residual
rows (``want_hit`` / ``want_vis``), at the repo's kernel limits
(torch_port_cases.assert_round0_close).  And: the three slices concatenated
are the screen-tap form's rows, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.ops import round0 as R

from torch_port_cases import AA, H, W, assert_round0_close, jax_round0_kernel, packed_pair, to_numpy

torch.set_num_threads(2)

N_LANES = 256
BASES = (0, 256, 512)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("base", BASES)
def test_lin_input_matches_jax_kernel(base, residual):
    jp, js, tp, ts = packed_pair("standin")
    kern = jax_round0_kernel(js, W, H, N_LANES, residual, residual, lin_input=True)
    ref = to_numpy(kern(jp, jnp.float32(base), jnp.asarray(AA, jnp.float32)))
    lay = R.layout(ts, W, H, want_hit=residual, want_vis=residual)
    out = to_numpy(R.round0(lay, lay.pack(tp, AA, base), lin_input=True, n_lanes=N_LANES))
    assert set(out) == set(ref) == set(lay.names) | {"win"}
    assert out["win"].shape == (N_LANES,)
    vis = [k for k in lay.names if k.startswith("vis")]
    assert_round0_close(out, ref, [k for k in lay.names if k not in vis])
    agree = out["win"] == ref["win"]
    for k in vis:
        assert (out[k][agree] != ref[k][agree]).mean() < 0.01, k


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_slices_are_the_screen_tap_rows_bit_for_bit(residual):
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H, want_hit=residual, want_vis=residual)
    full = R.round0(lay, lay.pack(tp, AA))
    parts = [R.round0(lay, lay.pack(tp, AA, b), lin_input=True, n_lanes=N_LANES) for b in BASES]
    assert W * H == N_LANES * len(BASES)
    for k in full:
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k]), k


def test_pad_lanes_lie_below_the_frame():
    """Lanes past the frame's last pixel compute pixels below it (as in the
    JAX kernel), finite, and leave the frame's lanes as they were."""
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    full = R.round0(lay, lay.pack(tp, AA))
    out = R.round0(lay, lay.pack(tp, AA, 512), lin_input=True, n_lanes=384)
    for k in ("r", "g", "b", "win"):
        assert torch.equal(out[k][:256], full[k][512:]), k
        assert bool(torch.isfinite(out[k].float()).all()), k


def test_lane_base_must_be_exact_in_f32():
    """The kernel reads the base back from the f32 parameter vector: every
    multiple of 128 below 2^31 is exact (an 8K frame's shard bases lie above
    2^24), an odd number above 2^24 is refused."""
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    l0 = lay.off["lin"]
    for base in (0, 128 * 7, 2**24 + 128, 33_177_600 - 128, 2**31 - 128):
        assert int(lay.pack(tp, AA, base)[l0].item()) == base
    for bad in (2**24 + 1, -128, 2**31, 1.5):
        with pytest.raises(ValueError, match="lane base"):
            lay.pack(tp, AA, bad)
    assert R.exact_lane_base(np.int64(256)) == 256
