"""K1's residual forms (``want_hit`` and ``want_vis``), the rows the
gradient's backward pins its discrete decisions to: the port's plain
version against the JAX kernel in interpret mode, in the screen-tap and
ray-input forms, on the flagship stand-in (its glass variant is in
tests/test_torch_residual_glass.py).  Limits: check_residual_rows."""

import pytest
import torch

from chess2rt_tpu_torch.ops import round0 as R

from torch_port_cases import AA, H, HIT_ROWS, W, check_residual_rows, packed_pair

torch.set_num_threads(2)


@pytest.mark.parametrize("form", ["screen-tap", "ray-input"])
def test_residual_rows_match_jax_kernel(form):
    check_residual_rows("standin", form)


def test_residual_rows_leave_the_primal_rows_as_they_were():
    """The residual form adds rows and changes none: its primal rows equal
    the plain call's, lane for lane."""
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp, AA)
    plain = R.round0(lay, prm)
    resid = R.round0(lay, prm, want_hit=True, want_vis=True)
    assert len(resid) == len(plain) + len(HIT_ROWS) + ts.n_lights
    for k in plain:
        torch.testing.assert_close(resid[k], plain[k], rtol=0, atol=0)
    hit = R.layout(ts, W, H, want_hit=True)
    assert hit.names[-len(HIT_ROWS):] == HIT_ROWS and not hit.want_vis
