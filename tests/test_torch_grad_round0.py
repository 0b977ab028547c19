"""The round-0 VJP, screen-tap form: the port's ``diff_round0`` (K1's
plain version forward, leaf-pinned re-shade backward) against ``jax.vjp``
of the JAX package's ``build_diff_round0`` at 32x24, with the same seeded
cotangents, every ScenePacked leaf compared (camera included); and
``pin_mode="node"`` (the full re-scan backward) against the leaf mode and
against JAX's node mode.  The ray-input form is in
tests/test_torch_grad_round0_rays.py."""

import jax
import numpy as np
import torch

from torch_port_cases import check_round0_vjp, eager_jax_kernels, grad_leaves, jax_kernel_trace, jax_leaves, port_grads

torch.set_num_threads(2)

# the leaves tests/test_pallas_grad.py:26-41 compares
CHECK_LEAVES = ("mat_color", "mat_exponent", "mat_strength", "light_pos", "light_power", "light_color",
                "sphere_center", "sphere_r", "cube_center", "plane_y", "checker_c1", "checker_c2", "bitmap_atlas",
                "ambient")


def test_screen_tap_vjp_matches_jax(monkeypatch):
    check_round0_vjp("screen-tap", monkeypatch)


def test_node_pin_mode_matches_leaf_mode_and_jax(monkeypatch):
    """tests/test_pallas_grad.py:175-204 on the stand-in at 48x32 (CSG
    difference with its eaten-surface flip, transforms, cube faces, both
    sphere roots, the plane): loss = sum over the float rows of mean(row**2)
    of the screen-tap form at aa (0, 0), per leaf ``rtol 1e-4, atol 1e-4 *
    max|b|``, at least 4 nonzero leaves:

    * the port's node mode against its leaf mode (K1's plain version),
      every leaf;
    * the port's node mode, on its own plain K1 and on the JAX kernel's
      forward rows (``jax_kernel_trace``: the same pins), against jax.grad
      of JAX's ``build_diff_round0(pin_mode="node")`` (interpret mode), on
      the JAX test's leaves (CHECK_LEAVES, without the camera, whose yaw
      gradient is a sum cancelling to 1e-7 of the pitch's and moves by
      2e-3 to 5e-3 between the two packages' float paths)."""
    from chess2rt_tpu.ops import pallas_grad
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES
    from chess2rt_tpu_torch.ops import round0 as R
    from chess2rt_tpu_torch.ops.round0_grad import diff_round0
    from chess2rt_tpu_torch.scenes import flagship_standin
    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu.models import types as JT
    from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
    from chess2rt_tpu_torch.models.packed import from_numpy, pack_scene

    w, h = 48, 32
    eager_jax_kernels(monkeypatch)
    jp, js = jax_pack_scene(flagship_standin(JT, w, h), dtype=jax.numpy.float32)
    _, ts = pack_scene(flagship_standin(TT, w, h), device="cpu")
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    kern = pallas_grad.build_diff_round0(js, w, h, interpret=True, pin_mode="node")

    def jax_loss(p):
        o = kern(p, (0.0, 0.0))
        return sum((v**2).mean() for k, v in o.items() if k != "win")

    with jax.disable_jit():
        want = jax_leaves(jax.grad(jax_loss)(jp))
    lay = R.layout(ts, w, h)

    def port(mode, trace=R.round0):
        p, xs = grad_leaves(tp)
        o = diff_round0(lay, lay.pack(p, (0.0, 0.0)), p, pin_mode=mode, trace=trace)
        sum((v**2).mean() for k, v in o.items() if k != "win").backward()
        return port_grads(xs)

    node = port("node")
    cases = ((node, port("leaf"), LEAF_NAMES), (node, want, CHECK_LEAVES),
             (port("node", jax_kernel_trace(jp, js, w, h)), want, CHECK_LEAVES))
    for got, ref, names in cases:
        compared = 0
        for name in names:
            a, b = got[name], ref[name]
            if b.size == 0:
                continue
            scale = np.abs(b).max() + 1e-12
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
            compared += bool(np.abs(b).any())
        assert compared >= 4
