"""K1, the fused round-0 kernel: the port's plain PyTorch version
(``round0_reference``, which ``round0`` runs for CPU tensors) against the
JAX package's Pallas kernel in interpret mode, in both forms the flagship
frame uses: screen-tap (in-kernel ray-gen) and ray-input (bounce rounds).
Every output key is checked at the repo's kernel-vs-reference limits.
This file holds the flagship stand-in; tests/test_torch_fuzz.py the
seeded random scenes, tests/test_torch_refraction.py the glass sphere."""

import torch

from chess2rt_tpu_torch.ops import round0 as R

from torch_port_cases import AA, H, W, check_ray_input, check_screen_tap, packed_pair

torch.set_num_threads(2)


def test_screen_tap_matches_jax_kernel():
    check_screen_tap("standin")


def test_ray_input_matches_jax_kernel():
    check_ray_input("standin")


def test_ray_input_reproduces_screen_tap():
    """Screen-tap rays fed back through the ray-input form give the same
    lanes (the bounce rounds and round 0 share one kernel)."""
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp, AA)
    p = prm.__getitem__
    ox, oy, oz, dx, dy, dz = R._raygen(p, lay.off, W, H, W * H, prm.device)
    tap = R.round0(lay, prm)
    rays = R.round0(lay, prm, torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1))
    for k in tap:
        torch.testing.assert_close(rays[k], tap[k], rtol=0, atol=0)
