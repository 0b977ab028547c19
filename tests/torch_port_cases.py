"""Shared inputs and limits for the tests that hold chess2rt_tpu_torch (the
PyTorch/CUDA port) to chess2rt_tpu (the JAX reference).

Both packages build the same scene from the same code and seed, and the
JAX side runs on the CPU as its own fast-tier tests run it: Pallas kernels
in interpret mode.  Data crosses between the two as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops.pallas_trace import build_round0_kernel
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.scenes import flagship_standin, random_scene

W, H = 32, 24
RANDOM_SEEDS = (1000, 1001, 1002, 1003)


def scene(T, case):
    """``case`` is "standin", "glass" (the stand-in with a glass sphere for
    its mirror) or a random-scene seed."""
    if case in ("standin", "glass"):
        return flagship_standin(T, W, H, glass=case == "glass")
    return random_scene(T, case, width=W, height=H)


def packed_pair(case):
    """(jax_packed, jax_static, torch_packed, torch_static) of one scene."""
    jp, js = jax_pack_scene(scene(JT, case), dtype=jnp.float32)
    tp, ts = torch_pack_scene(scene(TT, case))
    return jp, js, tp, ts


def jax_leaves(jp) -> dict:
    """A JAX ScenePacked as the {name: numpy array} that from_numpy takes."""
    out = {
        f.name: np.asarray(getattr(jp, f.name))
        for f in dataclasses.fields(jp)
        if f.name != "camera"
    }
    for f in dataclasses.fields(jp.camera):
        out[f"camera.{f.name}"] = np.asarray(getattr(jp.camera, f.name))
    return out


def seeded_rays(seed: int, n: int, center, spread: float):
    """n rays from a numpy generator: origins scattered around ``center``,
    unit directions."""
    rng = np.random.default_rng(seed)
    orig = np.asarray(center, np.float64) + rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return orig.astype(np.float32), d.astype(np.float32)


def lane_error(a, b):
    """Per-lane error of output ``a`` against reference ``b``: the absolute
    difference, relative to |b| where |b| > 1.  Colors and directions are
    O(1), so for them this is the absolute difference; positions and UVs
    (hundreds of units on the stand-in's floor) are held to the same 2e-3
    as a fraction of their size, since 1 ulp there exceeds 2e-3."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


def assert_round0_close(out, ref, keys):
    """The repo's kernel-vs-reference limits (tests/test_fuzz.py): knife-edge
    silhouettes move with 1-ulp differences, so a few lanes may differ.
    ``win`` differs on < 1% of lanes; over lanes where it agrees, < 1% of
    lanes have d > 2e-3 and median(d) < 2e-4, for every output key."""
    win_o, win_r = np.asarray(out["win"]), np.asarray(ref["win"])
    agree = win_o == win_r
    assert (~agree).mean() < 0.01, f"win differs on {(~agree).mean():.2%} of lanes"
    for k in keys:
        d = lane_error(out[k], ref[k])[agree]
        assert np.isfinite(d).all(), k
        assert (d > 2e-3).mean() < 0.01, (k, (d > 2e-3).mean(), d.max())
        assert np.median(d) < 2e-4, (k, np.median(d))


def assert_frame_close(img, ref):
    """The repo's frame limits (tests/test_fuzz.py): per pixel the largest
    channel error; < 1% of pixels above 2e-3 and a median below 2e-4."""
    img = np.asarray(img)
    ref = np.asarray(ref)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    d = np.abs(img.astype(np.float64) - ref).max(-1)
    assert (d > 2e-3).mean() < 0.01, ((d > 2e-3).mean(), d.max())
    assert np.median(d) < 2e-4, np.median(d)


def to_numpy(outs: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in outs.items()}


AA = (0.3, 0.3)


def rays_for(case, n):
    if case in ("standin", "glass"):
        # around the camera and over the scene's objects (units of the stand-in)
        return seeded_rays(7, n, center=(0.0, 120.0, 220.0), spread=150.0)
    return seeded_rays(case, n, center=(0.0, 0.0, 0.0), spread=6.0)


def check_screen_tap(case):
    """K1's screen-tap form: the port's plain version against the JAX
    kernel in interpret mode, every output key."""
    jp, js, tp, ts = packed_pair(case)
    ref = jax.jit(build_round0_kernel(js, W, H, interpret=True))(jp, jnp.asarray(AA, jnp.float32))
    lay = R.layout(ts, W, H)
    out = R.round0(lay, lay.pack(tp, AA))
    assert set(out) == set(ref)
    assert out["win"].dtype == torch.int32 and out["win"].shape == (W * H,)
    assert_round0_close(to_numpy(out), to_numpy(ref), lay.names)


def check_ray_input(case):
    """K1's ray-input form on seeded numpy rays, as check_screen_tap."""
    n = W * H
    orig, dir = rays_for(case, n)
    jp, js, tp, ts = packed_pair(case)
    ref = jax.jit(build_round0_kernel(js, W, H, interpret=True, n_rays=n))(
        jp, jnp.asarray(orig), jnp.asarray(dir)
    )
    lay = R.layout(ts, W, H)
    out = R.round0(lay, lay.pack(tp), torch.from_numpy(orig), torch.from_numpy(dir))
    assert set(out) == set(ref)
    assert_round0_close(to_numpy(out), to_numpy(ref), lay.names)
    assert (to_numpy(out)["win"] >= 0).any()
