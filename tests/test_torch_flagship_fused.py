"""The slice against the JAX fused renderer: the port's ``render_frame`` on
the flagship stand-in (32x24, AA5, maxTraceDepth 5, a mirror sphere) against
``build_flagship_renderer(static, 32, 24, interpret=True)``, the same
round-0 kernel, deferred bitmap gather and block-compacted bounce rounds
in JAX.

The JAX renderer runs with its glue eager and each of its Pallas kernels
jitted on its own: the same functions on the same inputs, but two
interpret-mode kernel compiles instead of one program that inlines the
kernel eleven times (screen tap, five block rounds, five overflow-fallback
rounds), which alone takes ~100 s to compile on a CPU."""

import jax
import numpy as np
import torch

from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer
from chess2rt_tpu_torch.render.pipeline import render_frame

from torch_port_cases import H, W, assert_frame_close, forward_jax_kernels, packed_pair

torch.set_num_threads(2)


def test_frame_matches_jax_fused_renderer(monkeypatch):
    jp, js, tp, ts = packed_pair("standin")
    assert not js.has_bump  # build_trace_round0 takes the bump hybrid otherwise
    forward_jax_kernels(monkeypatch)
    with jax.disable_jit():
        ref = np.asarray(build_flagship_renderer(js, W, H, interpret=True)(jp))
    img = render_frame(tp, ts).numpy()
    assert_frame_close(img, ref)
