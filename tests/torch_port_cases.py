"""Shared inputs and limits for the tests that hold chess2rt_tpu_torch (the
PyTorch/CUDA port) to chess2rt_tpu (the JAX reference).

Both packages build the same scene from the same code and seed, and the
JAX side runs on the CPU as its own fast-tier tests run it: Pallas kernels
in interpret mode.  Data crosses between the two as numpy arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import os
import re

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
    tp, ts = torch_pack_scene(scene(TT, case), device="cpu")
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


@contextlib.contextmanager
def x64(on: bool = True):
    """jax_enable_x64 for the block, restored after: xdist runs a file's
    tests one after the other in one worker, so a leaked flag would change
    the next test's dtypes."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def u8(img):
    """sRGB bytes of a float frame, as the BMP writer quantizes it."""
    from chess2rt_tpu_torch.utils.color import srgb_u8

    return srgb_u8(np.asarray(img, dtype=np.float32)).astype(int)


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


HIT_ROWS = ("t", "nx", "ny", "nz", "dr", "dg", "db")


def check_residual_rows(case, form):
    """K1's residual form (want_hit and want_vis): the port's plain version
    against the JAX kernel.  Every primal row and t, nx, ny, nz, dr, dg, db
    at the repo's kernel-vs-reference limits (assert_round0_close); each
    shadow bit vis{l} differs on < 1% of the lanes where ``win`` agrees."""
    jp, js, tp, ts = packed_pair(case)
    lay = R.layout(ts, W, H, want_hit=True, want_vis=True)
    if form == "screen-tap":
        kern = build_round0_kernel(js, W, H, interpret=True, want_hit=True, want_vis=True)
        ref = jax.jit(kern)(jp, jnp.asarray(AA, jnp.float32))
        out = R.round0(R.layout(ts, W, H), lay.pack(tp, AA), want_hit=True, want_vis=True)
    else:
        orig, dir = rays_for(case, W * H)
        kern = build_round0_kernel(js, W, H, interpret=True, n_rays=W * H, want_hit=True, want_vis=True)
        ref = jax.jit(kern)(jp, jnp.asarray(orig), jnp.asarray(dir))
        out = R.round0(lay, lay.pack(tp), torch.from_numpy(orig), torch.from_numpy(dir))
    assert set(out) == set(ref) == set(lay.names) | {"win"}
    assert list(lay.names[-len(HIT_ROWS) - ts.n_lights:]) == [*HIT_ROWS] + [f"vis{i}" for i in range(ts.n_lights)]
    out, ref = to_numpy(out), to_numpy(ref)
    vis = [k for k in lay.names if k.startswith("vis")]
    assert_round0_close(out, ref, [k for k in lay.names if k not in vis])
    agree = out["win"] == ref["win"]
    for k in vis:
        assert set(np.unique(out[k])) <= {0.0, 1.0}, k
        assert (out[k][agree] != ref[k][agree]).mean() < 0.01, k
    assert (out["t"][out["win"] < 0] >= R.INF).all()


# --------------------------------------------------------------------------
# Gradients: the port's leaves against the JAX package's
# --------------------------------------------------------------------------


def grad_leaves(tp):
    """The port scene with every leaf a fresh tensor that requires grad:
    returns (packed, {LEAF_NAMES key: tensor})."""
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_leaves, leaves

    xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]
    return from_leaves(xs), dict(zip(LEAF_NAMES, xs))


def port_grads(xs: dict) -> dict:
    """{leaf: numpy gradient} of grad_leaves' tensors (zeros where none),
    carried across by models/packed.to_numpy."""
    from chess2rt_tpu_torch.models.packed import from_leaves, to_numpy

    return to_numpy(from_leaves([torch.zeros_like(x) if x.grad is None else x.grad for x in xs.values()]))


def compare_grads(got: dict, want: dict, names, rtol, atol=2e-6, skip_zero=False, min_compared=3):
    """The rule of tests/test_pallas_grad.py:51-66: per leaf,
    |got - want| <= atol + rtol * max|want| + rtol * |want|, with at least
    ``min_compared`` leaves whose JAX gradient is nonzero.  Scaling by the
    leaf's largest JAX gradient keeps knife-edge lanes (winner or shadow
    flips between two float paths) from failing the comparison."""
    compared = 0
    for name in names:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.shape == b.shape, name
        if b.size == 0 or (skip_zero and not np.abs(b).any()):
            continue
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol + rtol * scale, err_msg=name)
        compared += bool(np.abs(b).any())
    assert compared >= min_compared, compared


def jax_round0_kernel(static, width, height, n_rays, want_hit, want_vis, lin_input=False):
    """The JAX package's K1 in interpret mode, jitted, one compile per
    scene structure and form (the AA, chunk and capacity settings do not
    reach the kernel)."""
    static = dataclasses.replace(static, aa_enabled=True, aa_adaptive=False, aa_capacity=None, chunk_pixels=None,
                                 bounce_block_capacity=None)
    return _jax_round0_kernel(static, width, height, n_rays, want_hit, want_vis, lin_input)


@functools.lru_cache(maxsize=None)
def _jax_round0_kernel(static, width, height, n_rays, want_hit, want_vis, lin_input):
    return jax.jit(build_round0_kernel(static, width, height, interpret=True, n_rays=n_rays, want_hit=want_hit,
                                       want_vis=want_vis, lin_input=lin_input))


def eager_jax_kernels(monkeypatch):
    """Run the JAX package's differentiable round 0 with its glue eager
    (callers wrap it in jax.disable_jit()) and each Pallas kernel, the
    leaf-pin search and the re-shade jitted on their own: the same
    functions on the same inputs, without compiling a program that inlines
    the interpret-mode kernel at every call site.  Kernels are cached by
    scene structure, so renderers of one scene share their compiles."""
    from chess2rt_tpu.ops import pallas_grad

    def jitted(fn):
        def run(*args, **kw):
            with jax.disable_jit(False):
                return fn(*args, **kw)

        return run

    def build(static, width, height, interpret=False, n_rays=None, want_hit=False, want_vis=False,
              lin_input=False):
        assert interpret
        return jitted(jax_round0_kernel(static, width, height, n_rays, want_hit, want_vis, lin_input))

    monkeypatch.setattr(pallas_grad, "build_round0_kernel", build)
    monkeypatch.setattr(pallas_grad, "reshade",
                        jitted(jax.jit(pallas_grad.reshade, static_argnames=("static", "want_hit", "bump"))))
    monkeypatch.setattr(pallas_grad, "compute_leaf_pins",
                        jitted(jax.jit(pallas_grad.compute_leaf_pins, static_argnames=("static",))))


def forward_jax_kernels(monkeypatch):
    """For forward frames: the JAX renderers' round-0 calls
    (``build_trace_round0``, a custom VJP that a forward pass never enters)
    become the plain kernel, jitted on its own and shared between call
    sites.  Callers run the renderer under ``jax.disable_jit()``, so its
    glue, ``lax.map`` slabs and ``lax.cond`` branches run eagerly."""
    from chess2rt_tpu.ops import pallas_grad

    def build(static, width, height, interpret=False, n_rays=None, want_hit=False, lin_input=False):
        assert interpret
        kern = jax_round0_kernel(static, width, height, n_rays, want_hit, False, lin_input)

        def run(*args):
            with jax.disable_jit(False):
                return kern(*args)

        return run

    monkeypatch.setattr(pallas_grad, "build_trace_round0", build)


def jax_rows_slices(js, jp, n_lanes, n_slices, masks=None, bases=None, width=W, height=H):
    """A frame as slices of the JAX package's ``build_rows_renderer`` (the
    per-shard body of its mesh layer), one call per slice: the [n_slices *
    n_lanes, 3] rows as a JAX array, differentiable in ``jp``.  Run it under
    ``jax.disable_jit()`` after ``forward_jax_kernels`` (forward) or
    ``eager_jax_kernels`` (gradients).  ``masks`` / ``bases`` are the
    adaptive-AA inputs of each slice (numpy arrays or None)."""
    from chess2rt_tpu.ops.pallas_trace import build_rows_renderer

    rows = build_rows_renderer(js, width, height, True, n_lanes)
    out = []
    for i in range(n_slices):
        mask = None if masks is None else jnp.asarray(masks[i])
        base = None if bases is None else jnp.asarray(bases[i])
        out.append(rows(jp, i * n_lanes, mask=mask, base=base))
    return jnp.concatenate(out)


def check_round0_vjp(form, monkeypatch):
    """The round-0 VJP: the port's diff_round0 against jax.vjp of
    build_diff_round0(js, 32, 24, interpret=True), both given the same
    seeded cotangents on every float output key.  Every ScenePacked leaf
    is compared (and orig, dir in the ray-input form) at rtol 2e-3, atol
    2e-6 + 2e-3 * max|JAX| (tests/test_pallas_grad.py:51-66), at least 3
    nonzero leaves."""
    from chess2rt_tpu.ops import pallas_grad
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_numpy
    from chess2rt_tpu_torch.ops.round0_grad import diff_round0

    eager_jax_kernels(monkeypatch)
    jp, js, _, ts = packed_pair("standin")
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    n = W * H
    lay = R.layout(ts, W, H)
    p, xs = grad_leaves(tp)
    if form == "screen-tap":
        f = pallas_grad.build_diff_round0(js, W, H, interpret=True)
        out_j, vjp = jax.vjp(lambda q: f(q, AA), jp)
        out_t = diff_round0(lay, lay.pack(p, AA), p)
    else:
        orig, dir = rays_for("standin", n)
        f = pallas_grad.build_diff_round0(js, W, H, interpret=True, n_rays=n)
        out_j, vjp = jax.vjp(f, jp, jnp.asarray(orig), jnp.asarray(dir))
        o3 = torch.from_numpy(orig).requires_grad_()
        d3 = torch.from_numpy(dir).requires_grad_()
        out_t = diff_round0(lay, lay.pack(p), p, o3, d3)
    assert set(out_t) == set(out_j)
    rng = np.random.default_rng(11)
    cot = {k: rng.normal(size=(n,)).astype(np.float32) for k in lay.names}
    got = vjp({**{k: jnp.asarray(v) for k, v in cot.items()}, "win": np.zeros((n,), jax.dtypes.float0)})
    torch.autograd.backward([out_t[k] for k in lay.names], [torch.from_numpy(cot[k]) for k in lay.names])
    want = jax_leaves(got[0])
    have = port_grads(xs)
    names = list(LEAF_NAMES)
    if form == "ray-input":
        want.update(orig=np.asarray(got[1]), dir=np.asarray(got[2]))
        have.update(orig=o3.grad.numpy(), dir=d3.grad.numpy())
        names += ["orig", "dir"]
    compare_grads(have, want, names, rtol=2e-3)


CAMERA_GRAD_LEAVES = ("camera.pos", "camera.yaw", "camera.pitch", "camera.fov")
# leaves whose frame gradient is dominated by the floor's grazing lanes near
# the horizon (their texel coordinates, directly or seen in the mirror)
HORIZON_LEAVES = ("plane_y", "sphere_center", "sphere_r", "bitmap_scaling", "bitmap_atlas")


def jax_kernel_trace(jp, js, width=W, height=H, lanes=R.TILE_N):
    """A ``trace`` for the port's flagship renderer that runs the JAX
    package's K1 (interpret mode) on the JAX scene ``jp`` and hands its rows
    to the port: the port's glue and backward on the JAX forward's own
    discrete decisions.  Ray-input calls are padded to ``lanes`` (one
    1024-lane tile by default; lanes are independent), so one compile
    serves every bounce round."""
    def kernel(n_rays, want_hit, want_vis):
        return jax_round0_kernel(js, width, height, n_rays, want_hit, want_vis)

    def trace(lay, prm, orig=None, dir=None):
        if orig is None:
            a0 = lay.off["aa"]
            o = kernel(None, lay.want_hit, lay.want_vis)(jp, jnp.asarray(prm[a0:a0 + 2].detach().numpy()))
            return {k: torch.from_numpy(np.array(v)) for k, v in o.items()}
        n = orig.shape[0]
        pad = lanes - n
        assert pad >= 0
        o3 = np.concatenate([orig.detach().numpy(), np.zeros((pad, 3), np.float32)])
        d3 = np.concatenate([dir.detach().numpy(), np.tile(np.float32([0, 0, 1]), (pad, 1))])
        o = kernel(lanes, lay.want_hit, lay.want_vis)(jp, jnp.asarray(o3), jnp.asarray(d3))
        return {k: torch.from_numpy(np.array(v)[:n]) for k, v in o.items()}

    return trace


def check_frame_grads(aa_enabled, monkeypatch):
    """The slice as a whole: gradients of ((render_frame(p) - target)**2)
    .mean() from the port against jax.grad through the JAX fused renderer
    build_flagship_renderer(js, 32, 24, interpret=True), glue eager and
    kernels jitted one by one.

    1. The port's renderer on the JAX kernel's forward rows (``trace``):
       every non-camera leaf at rtol 5e-3 with skip_zero
       (tests/test_pallas_grad.py:108), at least 3 leaves; the camera
       leaves at rtol 0.1 (:130-139).
    2. The port's own ``render_frame`` (K1's plain version): the same loss
       to 1e-4, finite gradients on every leaf, and the same rule on every
       leaf but HORIZON_LEAVES and the camera, whose gradients a handful of
       knife-edge lanes dominate: there the two forward kernels' u, v
       differ in the last bits, which picks other texels (< 1% of lanes,
       within the kernel limits; 1e-2 to 2e-1 of those leaves' gradients
       at 32x24)."""
    from chess2rt_tpu.ops.pallas_trace import build_flagship_renderer
    from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_numpy
    from chess2rt_tpu_torch.ops.flagship import build_flagship_renderer as port_renderer
    from chess2rt_tpu_torch.render.pipeline import render_frame

    eager_jax_kernels(monkeypatch)
    jp, js, _, ts = packed_pair("standin")
    js = dataclasses.replace(js, aa_enabled=aa_enabled)
    ts = dataclasses.replace(ts, aa_enabled=aa_enabled)
    assert not js.has_bump and js.train_textures and js.bounce_mode == "block"
    tp = from_numpy(jax_leaves(jp), ts, device="cpu")
    target = np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32)
    with jax.disable_jit():
        f = build_flagship_renderer(js, W, H, interpret=True)
        loss_j, g = jax.value_and_grad(lambda q: ((f(q) - jnp.asarray(target)) ** 2).mean())(jp)
    want = jax_leaves(g)
    scene = [k for k in LEAF_NAMES if not k.startswith("camera.")]

    def port(render):
        p, xs = grad_leaves(tp)
        loss = ((render(p) - torch.from_numpy(target)) ** 2).mean()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
        have = port_grads(xs)
        assert np.abs(have["bitmap_atlas"]).max() > 0  # the texel VJP ran
        return have

    have = port(port_renderer(ts, W, H, trace=jax_kernel_trace(jp, js)))
    compare_grads(have, want, scene, rtol=5e-3, skip_zero=True)
    for k in CAMERA_GRAD_LEAVES:
        compare_grads(have, want, [k], rtol=0.1, atol=0.0, min_compared=1)

    have = port(lambda p: render_frame(p, ts))
    for k in LEAF_NAMES:
        assert np.isfinite(have[k]).all(), k
        assert np.abs(have[k]).any() == np.abs(want[k]).any(), k
    compare_grads(have, want, [k for k in scene if k not in HORIZON_LEAVES], rtol=5e-3, skip_zero=True)


# --- the demo twins' fits against the JAX demos' loops ---

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_demo(name):
    """demos/<name>.py of the JAX package as a module (demos/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}", os.path.join(ROOT, "demos", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_value_and_grad(js):
    """jit(value_and_grad) of the demos' pixel L2 through JAX's
    ``render_frame``, the frame as aux: vg(p, target, key) -> ((loss,
    frame), grads).  One compile gives a demo's target (a zero target's
    aux), its first step and its finite differences."""
    from chess2rt_tpu.render.pipeline import render_frame

    def loss(p, target, key):
        img = render_frame(p, js, key)
        return ((img - target) ** 2).mean(), img

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def port_step(tp, ts, target, fields, key):
    """The port's pixel L2 and its gradients in the trained ``fields`` at
    ``tp``: (loss, {field: numpy gradient})."""
    from chess2rt_tpu_torch.render.pipeline import render_frame

    xs = {f: getattr(tp, f).detach().clone().requires_grad_() for f in fields}
    loss = ((render_frame(dataclasses.replace(tp, **xs), ts, key) - target) ** 2).mean()
    loss.backward()
    return loss.item(), {f: x.grad.numpy() for f, x in xs.items()}


def assert_step_rule(got_loss, got, want_loss, want):
    """PERF.md section 2's step rule (tests/test_pallas_grad.py:51-66): the
    loss within 1e-3 relative, every trained leaf within 2e-6 plus 5e-3 of
    its largest element plus 5e-3 relative."""
    assert abs(got_loss - want_loss) <= 1e-3 * abs(want_loss), (got_loss, want_loss)
    for f, w in want.items():
        assert np.abs(w).any(), f
        scale = np.abs(w).max()
        np.testing.assert_allclose(got[f], w, rtol=5e-3, atol=2e-6 + 5e-3 * scale, err_msg=f)


def fd_printed(text, what):
    """(autodiff, central difference) of a demo's printed ``FD check
    (what): autodiff A vs central-diff B`` line."""
    m = re.search(rf"FD check \({re.escape(what)}\): autodiff (\S+) vs central-diff (\S+)", text)
    assert m, text[-2000:]
    return float(m.group(1)), float(m.group(2))
