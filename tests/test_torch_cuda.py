"""The hand-written kernels against their plain PyTorch versions, on the
card: K1 (csrc/round0.cu) in its screen-tap, ray-input, residual and
lin-input forms (and want_hit alone, the GI form) on the stand-in, the
GI stand-in, the seeded fuzz scenes and the four CSG stress scenes (16- and 40-hit lists, nested CsgDiffs, a 33-instruction
CsgDiff nest), with its hit lists in shared and in global memory, K2
(csrc/texel_hist.cu) on the shapes a row-parallel segmented sum can get
wrong, K3's four stages (round0.cu built with -DC2RT_STAGE=k), the round-0
gradient through each form, the threefry draw (csrc/threefry.cu) bit for
bit, and the sharded, chunked, adaptive, DoF, stereo and GI frames and
the GI gradient step at small sizes; the per-shard sampler's DoF, stereo
and GI frames, ``pin_mode="node"``, two ranks sharing the card, the
bench twin's gate (``python -m chess2rt_tpu_torch.bench --check``), the
engine modes: the batched threefry draw, ``gi_path_batch``,
``bounce_mode="compact"``, ``texel_tap_reuse`` and ``texel_grad_mode``, and
the GI bounce kernel (csrc/gi_bounce.cu) against ``gi.bounce_reference`` for
one round and over the GI cell's 640x480 frame, and the combine kernel
(csrc/combine.cu) against ``flagship.combine_reference`` bit for bit on one
call and over DoF + cubemap and AA5 frames.

These tests need an NVIDIA card and nvcc; they carry the ``gpu`` marker and
skip elsewhere.  They import no JAX (the machine with the card has none),
so run them there without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Limits: the repo's kernel-vs-reference limits (tests/test_fuzz.py), as in
chip_smoke.py: the winning node differs on < 1% of lanes, and over lanes
where it agrees < 1% have d > 2e-3 and median(d) < 2e-4, with d the
absolute difference, relative to |plain| where |plain| > 1.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.models import types as T
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_leaves, leaves, pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops import texel_hist as K2
from chess2rt_tpu_torch.ops.round0_grad import diff_round0
from chess2rt_tpu_torch.scenes import csg_stress_scene, flagship_standin, gi_standin, random_scene

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no interpret mode)")
    return torch.device("cuda", 0)


def _d(a, b):
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp_min(1.0)


def _assert_close(out, ref, names):
    agree = out["win"] == ref["win"]
    assert agree.double().mean().item() > 0.99
    for k in names:
        d = _d(out[k][agree], ref[k][agree])
        assert bool(torch.isfinite(d).all()), k
        assert (d > 2e-3).double().mean().item() < 0.01, k
        assert d.median().item() < 2e-4, k


SCENES = {
    "standin": lambda: flagship_standin(T, 160, 120),
    # the refraction and total-internal-reflection branch
    "glass": lambda: flagship_standin(T, 160, 120, glass=True),
    **{f"random{s}": (lambda s=s: random_scene(T, s, width=96, height=72)) for s in range(1000, 1012)},
    # 16- and 40-hit lists, CsgDiff nodes nested on both sides, a 33-instruction nest
    "deep16": lambda: csg_stress_scene(T, "deep16", 96, 72),
    "nested_diff": lambda: csg_stress_scene(T, "nested_diff", 96, 72),
    "deep40": lambda: csg_stress_scene(T, "deep40", 96, 72),
    "diff_nest": lambda: csg_stress_scene(T, "diff_nest", 96, 72),
    # the GI stand-in: all Lambert, a bitmap, a six-hit CSG node in the lists
    "gi": lambda: gi_standin(T, 96, 72),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_screen_tap_and_ray_input_match_plain(cuda, name):
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height)
    prm = lay.pack(tp, (0.3, 0.6))
    before = R.launches
    _assert_close(R.round0(lay, prm), R.round0_reference(lay, prm), lay.names)
    n = ts.width * ts.height
    orig, dir = _rays(name, n, cuda)
    _assert_close(R.round0(lay, prm, orig, dir), R.round0_reference(lay, prm, orig, dir), lay.names)
    assert R.launches == before + 2


def test_frame_matches_plain_frame(cuda):
    tp, ts = pack_scene(flagship_standin(T, 320, 240), device=cuda)
    R.launches, F.bounce_rounds = 0, 0
    img = F.build_flagship_renderer(ts, 320, 240)(tp)
    assert R.launches == 5 + F.bounce_rounds
    ref = F.build_flagship_renderer(ts, 320, 240, trace=R.round0_reference)(tp)
    d = (img - ref).abs().amax(-1).double()
    assert bool(torch.isfinite(img).all())
    assert (d > 2e-3).double().mean().item() < 0.01
    assert d.median().item() < 2e-4


def test_wrapper_checks_its_inputs(cuda):
    tp, ts = pack_scene(flagship_standin(T, 64, 48), device=cuda)
    lay = R.layout(ts, 64, 48)
    prm = lay.pack(tp)
    rays = torch.zeros((10, 3), device=cuda)
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays, rays[:5])
    with pytest.raises(TypeError):
        R.round0(lay, prm.double())
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays.t().contiguous().t(), rays)
    with pytest.raises(ValueError):
        R.round0(lay, prm, rays.cpu(), rays.cpu())
    empty = R.round0(lay, prm, rays[:0], rays[:0])
    assert empty["win"].shape == (0,)


def _rays(name, n, cuda):
    rng = np.random.default_rng(len(name))
    scale = 150.0 if name in ("standin", "glass") else 6.0
    center = (0.0, 120.0, 220.0) if scale > 100 else (0.0, 0.0, 0.0)
    orig = torch.as_tensor(np.asarray(center) + rng.uniform(-scale, scale, (n, 3)), dtype=torch.float32)
    d = rng.normal(size=(n, 3))
    dir = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)
    return orig.to(cuda), dir.to(cuda)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_residual_rows_match_plain(cuda, name):
    """want_hit and want_vis: every row at the limits above; each shadow bit
    differs on < 1% of the lanes where win agrees."""
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height, want_hit=True, want_vis=True)
    prm = lay.pack(tp, (0.3, 0.6))
    before = R.resid_launches
    for rays in ((), _rays(name, ts.width * ts.height, cuda)):
        out, ref = R.round0(lay, prm, *rays), R.round0_reference(lay, prm, *rays)
        vis = [k for k in lay.names if k.startswith("vis")]
        _assert_close(out, ref, [k for k in lay.names if k not in vis])
        agree = out["win"] == ref["win"]
        for k in vis:
            assert (out[k][agree] != ref[k][agree]).double().mean().item() < 0.01, k
        # the vis rows are defined on every lane: also where the light sum is
        # thrown away (missed lanes, mirror and glass winners)
        direct = torch.tensor([ns.shader_kind in (0, 1) for ns in ts.nodes], device=cuda)  # LAMBERT, PHONG
        unlit = agree & ((ref["win"] < 0) | ~direct[ref["win"].clamp_min(0).long()])
        if int(unlit.sum()) > 100:
            for k in vis:
                assert (out[k][unlit] != ref[k][unlit]).double().mean().item() < 0.01, k
    assert R.resid_launches == before + 2


def _sorted_keys(kind, n, n_texels, rng):
    span = K2.plan(n)[0]
    if kind == "one key":
        return np.full(n, 5)
    if kind == "distinct":
        return np.arange(n)
    if kind.startswith("edge"):  # runs that end exactly on, one before and one after a span's edge
        cut = span + {"edge on": 0, "edge before": -1, "edge after": 1}[kind]
        return np.repeat([3, 4, 9, 10], [cut, span, n - span - cut - 7, 7])
    if kind == "out of range":  # dropped keys at the head and at the tail
        return np.concatenate([rng.integers(-9, 0, n // 4), rng.integers(0, n_texels, n // 2),
                               rng.integers(n_texels, n_texels + 9, n - n // 4 - n // 2)])
    if kind == "long run":  # one run over many spans among short ones
        return np.concatenate([rng.integers(0, 50, n // 4), np.full(n // 2, 50), rng.integers(51, n_texels, n - n // 4 - n // 2)])
    return rng.integers(0, n_texels, n) // rng.integers(1, 40)


_CHUNK, _SPANS = K2.BLOCK_THREADS, K2.TARGET_SPANS
K2_SHAPES = [
    # 200,000 rows: spans of two chunks
    *[(kind, 200_000, 12) for kind in
      ("one key", "distinct", "edge on", "edge before", "edge after", "out of range", "long run", "random")],
    # around one chunk, around the size where a span grows to two chunks, a non-multiple
    *[("random", n, 12) for n in (1, 2, _CHUNK - 1, _CHUNK, _CHUNK + 1, 3 * _CHUNK, _CHUNK * _SPANS - 1,
                                  _CHUNK * _SPANS, _CHUNK * _SPANS + 1, 100_003)],
    *[("one key", n, 6) for n in (_CHUNK, _CHUNK + 1, 2 * _CHUNK, 5 * _CHUNK + 9)],
    *[("long run", 40_000, c) for c in (1, 5, 6, 16)],
    ("long run", 3 * _CHUNK * _SPANS + 1000, 1),  # spans of four chunks
]


@pytest.mark.parametrize("kind,n,c", K2_SHAPES, ids=[f"{k}-{n}x{c}" for k, n, c in K2_SHAPES])
def test_texel_hist_shapes_match_plain(cuda, kind, n, c):
    """K2 where a row-parallel segmented sum can go wrong: runs at the edges
    of a block's span and of its chunks, one run over every span, no run
    longer than a row, sizes around a chunk and a span, dropped keys at both
    ends, every load width.  |a - b| <= 1e-4 * max(1, max|b|), and two calls
    give the same bits."""
    rng = np.random.default_rng(n + c)
    n_texels = max(60, n // 3)
    keys = torch.as_tensor(np.sort(_sorted_keys(kind, n, n_texels, rng)), dtype=torch.int32, device=cuda)
    assert keys.numel() == n
    vals = torch.as_tensor(rng.normal(size=(n, c)), dtype=torch.float32, device=cuda)
    out = K2.texel_histogram(keys, vals, n_texels)
    ref = K2.texel_histogram_reference(keys, vals, n_texels)
    assert out.shape == (n_texels, c) and bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert torch.equal(out.any(1), ref.any(1))  # rows no key names stay zero
    assert torch.equal(K2.texel_histogram(keys, vals, n_texels), out)


def test_texel_hist_empty_and_unaligned_rows(cuda):
    empty = K2.texel_histogram(torch.zeros(0, dtype=torch.int32, device=cuda), torch.zeros((0, 12), device=cuda), 7)
    assert empty.shape == (7, 12) and not bool(empty.any())
    # rows that start 4 bytes off a 16-byte boundary take the scalar loads
    rng = np.random.default_rng(0)
    n = 3000
    keys = torch.as_tensor(np.sort(rng.integers(0, 40, n)), dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(rng.normal(size=n * 12 + 1), dtype=torch.float32, device=cuda)
    vals = flat[1:].view(n, 12)
    assert vals.is_contiguous() and vals.data_ptr() % 16 != 0
    ref = K2.texel_histogram_reference(keys, vals, 40)
    assert (K2.texel_histogram(keys, vals, 40) - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("c", [12, 6])
def test_texel_hist_matches_plain(cuda, c):
    """K2 against texel_histogram_reference: sorted keys with long runs and
    out-of-range keys; |a - b| <= 1e-4 * max(1, max|b|)."""
    rng = np.random.default_rng(c)
    n, n_texels = 200_000, 81_920
    keys = np.concatenate([rng.integers(-3, n_texels + 3, n - 50_000), np.zeros(50_000, np.int64)])
    keys = torch.as_tensor(np.sort(keys), dtype=torch.int32, device=cuda)
    vals = torch.as_tensor(rng.normal(size=(n, c)), dtype=torch.float32, device=cuda)
    before = K2.launches
    out = K2.texel_histogram(keys, vals, n_texels)
    ref = K2.texel_histogram_reference(keys, vals, n_texels)
    assert K2.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    assert out.shape == (n_texels, c)


@pytest.mark.parametrize("form", ["screen-tap", "ray-input"])
def test_round0_grads_match_plain(cuda, form):
    """diff_round0 through K1 against diff_round0 through the plain version
    at 160x120, the same seeded cotangents: every leaf at rtol 2e-3, atol
    2e-6 + 2e-3 * max|plain| (tests/test_pallas_grad.py:51-66)."""
    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    lay = R.layout(ts, 160, 120)
    n = 160 * 120
    rays = () if form == "screen-tap" else _rays("standin", n, cuda)
    rng = np.random.default_rng(3)
    cot = {k: torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda) for k in lay.names}
    grads = []
    for trace in (R.round0, R.round0_reference):
        xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]
        p = from_leaves(xs)
        r = [x.detach().clone().requires_grad_() for x in rays]
        o = diff_round0(lay, lay.pack(p, (0.3, 0.3)), p, *r, trace=trace)
        torch.autograd.backward([o[k] for k in lay.names], [cot[k] for k in lay.names])
        grads.append({k: x.grad for k, x in zip(LEAF_NAMES, xs)} | {f"ray{i}": x.grad for i, x in enumerate(r)})
    compared = 0
    for k, b in grads[1].items():
        a = grads[0][k]
        if b is None:
            assert a is None, k
            continue
        assert bool(torch.isfinite(a).all()), k
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-6 + 2e-3 * scale, msg=k)
        compared += scale > 0
    assert compared >= 3


# --------------------------------------------------------------------------
# The pixel-slice paths: K1's lin-input form, K3's stages, the sharded,
# chunked and adaptive frames
# --------------------------------------------------------------------------


def _frame_close(img, ref):
    d = (img.double() - ref.double()).abs().amax(-1)
    assert bool(torch.isfinite(img).all())
    assert (d > 2e-3).double().mean().item() < 0.01 and d.median().item() < 2e-4


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_lin_input_matches_plain_and_screen_tap(cuda, residual):
    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    lay = R.layout(ts, 160, 120, want_hit=residual, want_vis=residual)
    full = R.round0(lay, lay.pack(tp, (0.3, 0.3)))
    n = 160 * 120 // 4
    before = R.lin_launches
    parts = []
    for i in range(4):
        prm = lay.pack(tp, (0.3, 0.3), i * n)
        out = R.round0(lay, prm, lin_input=True, n_lanes=n)
        _assert_close(out, R.round0_reference(lay, prm, lin_input=True, n_lanes=n),
                      [k for k in lay.names if not k.startswith("vis")])
        parts.append(out)
    assert R.lin_launches == before + 4
    # the same kernel, the same lanes: bit for bit the screen-tap launch
    for k in full:
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k]), k


@pytest.mark.parametrize("name", ["deep16", "nested_diff", "random1003", "glass"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_lin_input_matches_plain_on_csg_scenes(cuda, name, residual):
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height, want_hit=residual, want_vis=residual)
    n = ts.width * ts.height // 2
    full = R.round0(lay, lay.pack(tp, (0.3, 0.3)))
    parts = []
    for i in range(2):
        prm = lay.pack(tp, (0.3, 0.3), i * n)
        parts.append(R.round0(lay, prm, lin_input=True, n_lanes=n))
        _assert_close(parts[-1], R.round0_reference(lay, prm, lin_input=True, n_lanes=n),
                      [k for k in lay.names if not k.startswith("vis")])
    for k in full:
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k]), k


def test_tables_beyond_shared_memory_are_refused(cuda, monkeypatch):
    """The kernel keeps the scene's tables in a block's shared memory: the
    wrapper's limit refuses a larger scene before any launch, and the launch
    itself refuses what the card cannot hold."""
    from chess2rt_tpu_torch import cuda_build

    tp, ts = pack_scene(flagship_standin(T, 64, 48), device=cuda)
    lay = R.layout(ts, 64, 48)
    assert R.round0(lay, lay.pack(tp))["win"].numel() == 64 * 48
    lib = cuda_build.load("round0")
    prm = torch.zeros(60_000, dtype=torch.float32, device=cuda)
    prog = torch.zeros(10_000, dtype=torch.int32, device=cuda)
    out = torch.zeros((3, 128), dtype=torch.float32, device=cuda)
    win = torch.zeros(128, dtype=torch.int32, device=cuda)
    err = lib.c2rt_round0(prm.data_ptr(), prog.data_ptr(), prm.numel(), prog.numel(), 1, None, None, None,
                          out.data_ptr(), win.data_ptr(), 128, 64, 48, None)
    torch.cuda.synchronize()
    assert err == 1  # cudaErrorInvalidValue: 280,000 bytes of tables, refused before the launch
    with pytest.raises(ValueError, match="shared memory"):
        R.check_table_bytes(60_000, 10_000)


def test_lin_input_lane_base_above_2_pow_24(cuda):
    """An 8K frame's last shards start above 2^24: the f32 lin slot holds
    every multiple of 128, and the kernel's lanes are those of the ray-input
    form on the same pixels' rays."""
    from chess2rt_tpu_torch.ops.camera import pixel_rays

    w, h = 7680, 4320
    tp, ts = pack_scene(flagship_standin(T, w, h), device=cuda)
    lay = R.layout(ts, w, h)
    base = 2**24 + 128 * 5  # an odd multiple of 128
    out = R.round0(lay, lay.pack(tp, (0.0, 0.0), base), lin_input=True, n_lanes=4096)
    o3, d3 = pixel_rays(tp.camera, w, h, base + torch.arange(4096, device=cuda), (0.0, 0.0))
    ref = R.round0(lay, lay.pack(tp), o3.contiguous(), d3.contiguous())
    _assert_close(out, ref, lay.names)
    shifted = R.round0(lay, lay.pack(tp, (0.0, 0.0), base + 128), lin_input=True, n_lanes=4096)
    assert torch.equal(shifted["win"][:-128], out["win"][128:])
    assert torch.equal(shifted["r"][:-128], out["r"][128:])


@pytest.mark.parametrize("stage", ["empty", "raygen", "scan", "shadow"])
def test_stage_matches_plain(cuda, stage):
    from chess2rt_tpu_torch.ops import round0_probe as K3

    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    lay = R.layout(ts, 160, 120)
    prm = lay.pack(tp, (0.3, 0.6))
    before = K3.launches[stage]
    out = K3.round0_stage(lay, prm, stage)
    assert K3.launches[stage] == before + 1
    ref = K3.round0_stage_reference(lay, prm, stage)
    for a, b in zip(out, ref):
        d = _d(a, b)
        assert bool(torch.isfinite(a).all())
        assert (d > 2e-3).double().mean().item() < 0.01 and d.median().item() < 2e-4


def test_sharded_chunked_and_adaptive_frames(cuda):
    import dataclasses

    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn
    from chess2rt_tpu_torch.render.pipeline import render_frame

    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    ref = render_frame(tp, ts)
    sharded = make_sharded_render_fn(ts, make_mesh([cuda] * 3))(tp)
    assert (sharded - ref).abs().max().item() <= 2e-5
    _frame_close(render_frame(tp, dataclasses.replace(ts, chunk_pixels=4096)), ref)
    ta = dataclasses.replace(ts, aa_adaptive=True, aa_capacity=8192)
    plain = F.build_flagship_renderer(ta, 160, 120, trace=R.round0_reference)(tp)
    _frame_close(render_frame(tp, ta), plain)
    _frame_close(render_frame(tp, dataclasses.replace(ta, aa_capacity=1)), plain)
    sharded_a = make_sharded_render_fn(ta, make_mesh([cuda] * 3))(tp)
    _frame_close(sharded_a, plain)


def test_sharded_step_matches_single_device_step(cuda):
    import dataclasses

    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_value_and_grad
    from chess2rt_tpu_torch.render.pipeline import render_frame

    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    ts = dataclasses.replace(ts, aa_enabled=False)
    target = torch.zeros((120, 160, 3), device=cuda)
    loss, grads = make_sharded_value_and_grad(ts, make_mesh([cuda] * 4))(tp, target)
    xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in leaves(tp)]
    want = ((render_frame(from_leaves(xs), ts) - target) ** 2).mean()
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    compared = 0
    for k, g, x in zip(LEAF_NAMES, leaves(grads), xs):
        if x.grad is None or not bool(x.grad.any()):
            continue
        scale = x.grad.abs().max().item()
        assert (g - x.grad).abs().max().item() <= 1e-3 * scale + 2e-6, k
        compared += 1
    assert compared >= 20


def test_ladder_times_every_stage_and_the_whole_kernel(cuda):
    import chip_smoke  # the repository root: run pytest as ``python -m pytest`` from there
    from chess2rt_tpu_torch.ops import round0_probe as K3

    tp, ts = pack_scene(flagship_standin(T, 320, 240), device=cuda)
    lay = R.layout(ts, 320, 240)
    for times in chip_smoke.ladder(lay, lay.pack(tp, (0.3, 0.3)), reps=3, warm=1):
        assert set(times) == {*K3.STAGES, "full"}
        assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_twin_on_the_card_matches_the_cpu(cuda, dtype):
    """The eager Whitted twin (plain PyTorch) on the card against the same
    frame on the CPU: f32 at the frame limits, f64 within 1e-9.  No kernel
    launches: the twin is the plain path of float64 and uncovered scenes."""
    import dataclasses

    from chess2rt_tpu_torch.render.pipeline import render_frame_wavefront

    frames = []
    for dev in (cuda, "cpu"):
        tp, ts = pack_scene(flagship_standin(T, 64, 48), dtype=dtype, device=dev)
        before = R.launches
        frames.append(render_frame_wavefront(tp, dataclasses.replace(ts, aa_enabled=False)).cpu())
        assert R.launches == before
    d = (frames[0].double() - frames[1].double()).abs().amax(-1)
    if dtype == torch.float64:
        assert d.max().item() <= 1e-9
    else:
        assert (d > 2e-3).double().mean().item() < 0.01 and d.median().item() < 2e-4


def test_f64_render_frame_on_the_card_meets_the_oracle(cuda):
    """``render_frame`` keeps a float64 frame on the card (the twin) and it
    meets the float64 oracle u8-exactly on a CSG-free scene."""
    from chess2rt_tpu_torch.oracle import OracleRenderer
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import csg_free_scene
    from chess2rt_tpu_torch.utils.color import srgb_u8

    sc = csg_free_scene(T, 1, 48, 32)
    tp, ts = pack_scene(sc, dtype=torch.float64, device=cuda)
    img = render_frame(tp, ts)
    assert img.device.type == "cuda" and img.dtype == torch.float64
    gold = OracleRenderer(sc).render()
    img = img.cpu().numpy()
    assert np.abs(img - gold).max() < 1e-6
    np.testing.assert_array_equal(srgb_u8(img.astype(np.float32)), srgb_u8(gold.astype(np.float32)))


@pytest.mark.parametrize("name", ["deep16", "nested_diff", "deep40", "diff_nest"])
def test_list_placements_give_the_same_bits(cuda, name):
    """The hit lists in global memory against shared memory: residual rows
    on, screen-tap and ray-input, every output bit-equal."""
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height, want_hit=True, want_vis=True)
    prm = lay.pack(tp, (0.3, 0.6))
    assert R.list_placement(lay.program, lay.n_prm) == "shared"
    for rays in ((), _rays(name, ts.width * ts.height, cuda)):
        shared = R.round0(lay, prm, *rays, placement="shared")
        glob = R.round0(lay, prm, *rays, placement="global")
        for k in shared:
            assert torch.equal(shared[k], glob[k]), k
        _assert_close(shared, R.round0_reference(lay, prm, *rays), [k for k in lay.names if not k.startswith("vis")])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hit_rows_match_plain(cuda, name):
    """want_hit without want_vis (the GI form): every row at the limits
    above, screen-tap and ray-input; the light rows of unshaded lanes are
    the zeros the plain version writes."""
    tp, ts = pack_scene(SCENES[name](), device=cuda)
    lay = R.layout(ts, ts.width, ts.height, want_hit=True)
    prm = lay.pack(tp, (0.3, 0.6))
    before = R.hit_launches
    for rays in ((), _rays(name, ts.width * ts.height, cuda)):
        out, ref = R.round0(lay, prm, *rays), R.round0_reference(lay, prm, *rays)
        _assert_close(out, ref, lay.names)
        direct = torch.tensor([ns.shader_kind in (0, 1) for ns in ts.nodes], device=cuda)  # LAMBERT, PHONG
        unlit = (out["win"] < 0) | ~direct[out["win"].clamp_min(0).long()]
        for k in ("lr", "lg", "lb"):
            assert not bool(out[k][unlit].any()), k
    assert R.hit_launches == before + 2


def _gi_scene(w, h, paths):
    import dataclasses

    tp, ts = pack_scene(gi_standin(T, w, h, paths=paths), device=torch.device("cuda", 0))
    return tp, dataclasses.replace(ts, gi_point_light_direct=True)


@pytest.mark.parametrize("mode", ["plain", "chunked", "adaptive"])
def test_gi_frame_matches_plain_frame(cuda, mode):
    """The fused GI frame through K1's want_hit ray-input form, the bounce
    kernel and the threefry draw against the plain path (plain K1, plain
    draws, the glue): the frame limits; one K1 launch and one bounce kernel
    per bounce round, two draws per path (the bounce kernel draws inline),
    and every round of the plain path the glue's."""
    import dataclasses

    from chess2rt_tpu_torch.ops import gi

    tp, ts = _gi_scene(96, 72, 3)
    if mode == "chunked":
        ts = dataclasses.replace(ts, chunk_pixels=2048)
    if mode == "adaptive":
        ts = dataclasses.replace(ts, aa_enabled=True, aa_adaptive=True)
    key = prng.PRNGKey(5)
    R.launches = R.ray_launches = R.hit_launches = prng.launches = gi.bounce_rounds = 0
    gi.bounce_kernels = gi.glue_bounces = 0
    img = gi.build_gi_renderer(ts, 96, 72)(tp, key)
    assert R.launches == R.ray_launches == R.hit_launches == gi.bounce_rounds == gi.bounce_kernels > 0
    assert gi.glue_bounces == 0
    passes = (5 if mode == "adaptive" else 1) * (-(-96 * 72 // 2048) if mode == "chunked" else 1) * ts.paths_per_pixel
    assert prng.launches == 2 * passes
    gi.bounce_rounds = gi.bounce_kernels = gi.glue_bounces = 0
    ref = gi.build_gi_renderer(ts, 96, 72, trace=R.round0_reference, uniform=prng.uniform_reference)(tp, key)
    assert gi.glue_bounces == gi.bounce_rounds > 0 and gi.bounce_kernels == 0
    _frame_close(img, ref)
    assert img.max().item() > 0.01


def test_gi_step_matches_plain_step(cuda):
    """The GI gradient step through K1's residual form (the want_hit rows and
    the shadow bits) and K2 against the plain path: the loss within 1e-3,
    every leaf finite and nonzero on both paths or on neither, the nonzero
    leaves at rtol 5e-3 of the leaf's largest (the camera's 0.1)."""
    from chess2rt_tpu_torch.ops import gi

    tp, ts = _gi_scene(64, 48, 2)
    key = prng.PRNGKey(6)
    out = []
    for trace, draw in ((R.round0, None), (R.round0_reference, prng.uniform_reference)):
        xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]
        gi.bounce_rounds = gi.bounce_kernels = gi.glue_bounces = 0
        loss = (gi.build_gi_renderer(ts, 64, 48, trace=trace, uniform=draw)(from_leaves(xs), key) ** 2).mean()
        assert gi.glue_bounces == gi.bounce_rounds > 0 and gi.bounce_kernels == 0  # a recorded gradient: the glue
        loss.backward()
        out.append((loss.item(), {k: x.grad for k, x in zip(LEAF_NAMES, xs)}))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    nonzero = 0
    for k, b in out[1][1].items():
        a = out[0][1][k]
        if b is None or not b.numel():
            continue
        assert bool(torch.isfinite(a).all()), k
        assert bool(a.any()) == bool(b.any()), k
        rtol = 0.1 if k.startswith("camera.") else 5e-3
        torch.testing.assert_close(a, b, rtol=rtol, atol=2e-6 + rtol * b.abs().max().item(), msg=k)
        nonzero += bool(b.any())
    assert nonzero >= 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003])
def test_threefry_draw_matches_plain_bit_for_bit(cuda, dtype, n):
    key = prng.fold_in(prng.PRNGKey(n), 3)
    before = prng.launches
    out = prng.uniform(key, (n,), dtype, device=cuda)
    assert prng.launches == before + 1
    view = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(out.view(view), prng.uniform_reference(key, (n,), dtype, device=cuda).view(view))
    assert torch.equal(out.cpu().view(view), prng.uniform_reference(key, (n,), dtype, device="cpu").view(view))
    assert prng.uniform(key, (0,), dtype, device=cuda).shape == (0,)


@pytest.mark.parametrize("mode", ["dof", "stereo", "dof_adaptive", "dof_chunked"])
def test_mc_frame_matches_plain_frame(cuda, mode):
    """DoF and stereo frames through K1's ray-input form and the threefry
    draw against the plain path (plain K1, plain draws), at the frame
    limits."""
    import dataclasses

    sc = flagship_standin(T, 96, 72, dof=mode != "stereo", stereo=mode == "stereo", samples=3)
    sc.settings.adaptiveAA = mode == "dof_adaptive"
    tp, ts = pack_scene(sc, device=cuda)
    if mode == "dof_chunked":
        ts = dataclasses.replace(ts, chunk_pixels=2048)
    key = prng.PRNGKey(5)
    R.launches = R.ray_launches = prng.launches = 0
    img = F.build_flagship_renderer(ts, 96, 72)(tp, key)
    assert R.ray_launches and R.launches == R.ray_launches and (prng.launches > 0) == (mode != "stereo")
    ref = F.build_flagship_renderer(ts, 96, 72, trace=R.round0_reference, uniform=prng.uniform_reference)(tp, key)
    d = (img - ref).abs().amax(-1).double()
    assert bool(torch.isfinite(img).all())
    assert (d > 2e-3).double().mean().item() < 0.01
    assert d.median().item() < 2e-4


@pytest.mark.parametrize("bump_csg", [True, False], ids=["reshade", "fast"])
@pytest.mark.parametrize("form", ["screen-tap", "ray-input", "lin-input"])
def test_bump_hybrid_matches_plain(cuda, form, bump_csg):
    """The bump hybrid (ops/bump_round0.py) through K1's residual form
    against the same hybrid on K1's plain version, in each form and gate:
    every row of the caller's layout; one residual launch per call."""
    from chess2rt_tpu_torch.ops.bump_round0 import bump_round0
    from chess2rt_tpu_torch.scenes import bump_scene

    w, h = 160, 120
    tp, ts = pack_scene(bump_scene(T, w, h, mirror=True, bump_csg=bump_csg, aa=False), device=cuda)
    lay = R.layout(ts, w, h)
    rays, kw = (), {}
    if form == "ray-input":
        rays = _rays("standin", w * h, cuda)
    prm = lay.pack(tp, (0.3, 0.6))
    if form == "lin-input":
        base, lanes = 4096, 8192
        prm = lay.pack(tp, (0.3, 0.6), base)
        kw = {"lin_input": True, "lin_base": base, "n_lanes": lanes}
    before = R.resid_launches
    out = bump_round0(lay, prm, tp, *rays, **kw)
    assert R.resid_launches == before + 1
    ref = bump_round0(lay, prm, tp, *rays, trace=R.round0_reference, **kw)
    assert set(out) == set(lay.names) | {"win"}
    _assert_close(out, ref, lay.names)


@pytest.mark.parametrize("scene", ["bump_fast", "bump_reshade", "env"])
def test_bump_and_env_frames_match_plain(cuda, scene):
    """render_frame of the bump scene (each gate) and of the stand-in under
    the sky cubemap (the merged gather) against the plain path: the frame
    limits; every round-0 call on the fused path."""
    from chess2rt_tpu_torch.render import pipeline as P
    from chess2rt_tpu_torch.scenes import bump_scene

    w, h = 160, 120
    sc = (flagship_standin(T, w, h, env=True) if scene == "env"
          else bump_scene(T, w, h, mirror=True, bump_csg=scene == "bump_reshade"))
    tp, ts = pack_scene(sc, device=cuda)
    R.launches = R.resid_launches = F.bounce_rounds = P.wavefront_frames = 0
    img = P.render_frame(tp, ts)
    assert P.wavefront_frames == 0 and R.launches == 5 + F.bounce_rounds
    assert R.resid_launches == (0 if scene == "env" else R.launches)
    ref = F.build_flagship_renderer(ts, w, h, trace=R.round0_reference)(tp)
    d = (img - ref).abs().amax(-1).double()
    assert bool(torch.isfinite(img).all())
    assert (d > 2e-3).double().mean().item() < 0.01
    assert d.median().item() < 2e-4


def test_texel_hist_on_the_merged_table(cuda):
    """K2 on the texel rows of the env step's merged gather (bitmap quads
    and cubemap quads in one table) against its plain version, and the
    env_cubemap gradient of the step nonzero on both paths."""
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.render import pipeline as P

    w, h = 160, 120
    tp, ts = pack_scene(flagship_standin(T, w, h, env=True), device=cuda)
    ts = dataclasses.replace(ts, aa_enabled=False)
    seen = []

    def keep(keys, vals, n_texels):
        seen.append((keys, vals, n_texels))
        return K2.texel_histogram(keys, vals, n_texels)

    S.texel_histogram = keep
    try:
        xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]
        (P.render_frame(from_leaves(xs), ts) ** 2).mean().backward()
    finally:
        S.texel_histogram = K2.texel_histogram
    n_rows = sum(bh * bw for bh, bw in ts.bitmap_sizes) + 6 * 64 * 64
    assert seen and all(n == n_rows for _, _, n in seen)
    assert bool(xs[LEAF_NAMES.index("env_cubemap")].grad.any())
    for keys, vals, n in seen:
        out, ref = K2.texel_histogram(keys, vals, n), K2.texel_histogram_reference(keys, vals, n)
        assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("mode", ["dof", "stereo", "gi"])
def test_sharded_mc_frame_matches_plain(cuda, mode, monkeypatch):
    """The per-shard sampler over 4 mesh entries of the card (parallel/
    mesh.py): K1's ray-input form (the fused GI tracer for GI) and the
    threefry draw per shard, against the same sampler on K1's plain version
    and the plain draw: the frame limits; K1 and the draw launched."""
    from chess2rt_tpu_torch.ops import gi
    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_render_fn

    w, h = 160, 120
    sc = (gi_standin(T, w, h, paths=2) if mode == "gi"
          else flagship_standin(T, w, h, dof=mode == "dof", stereo=mode == "stereo", samples=2))
    tp, ts = pack_scene(sc, device=cuda)
    ts = dataclasses.replace(ts, gi_point_light_direct=ts.gi_enabled)
    mesh = make_mesh([cuda] * 4)
    key = prng.PRNGKey(9)
    R.launches = prng.launches = gi.bounce_rounds = 0
    img = make_sharded_render_fn(ts, mesh)(tp, key)
    assert R.launches > 0 and (prng.launches > 0 or mode == "stereo")
    monkeypatch.setattr(prng, "uniform", prng.uniform_reference)
    R.launches = 0
    ref = make_sharded_render_fn(ts, mesh, trace=R.round0_reference)(tp, key)
    assert R.launches == 0
    d = (img - ref).abs().amax(-1).double()
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0.01
    assert (d > 2e-3).double().mean().item() < 0.01
    assert d.median().item() < 2e-4


def test_node_pin_mode_matches_leaf_mode(cuda):
    """diff_round0(pin_mode="node") through K1's residual form (the vis rows
    only) against the leaf mode on the card: the rule of
    tests/test_pallas_grad.py:203-204 on every leaf."""
    w, h = 160, 120
    tp, ts = pack_scene(flagship_standin(T, w, h), device=cuda)
    lay = R.layout(ts, w, h)

    def grads(mode):
        xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in leaves(tp)]
        p = from_leaves(xs)
        o = diff_round0(lay, lay.pack(p, (0.0, 0.0)), p, pin_mode=mode)
        sum((v ** 2).mean() for k, v in o.items() if k != "win").backward()
        return [x.grad for x in xs]

    before = R.resid_launches
    node, leaf = grads("node"), grads("leaf")
    assert R.resid_launches == before + 2
    compared = 0
    for name, a, b in zip(LEAF_NAMES, node, leaf):
        if b is None or b.numel() == 0:
            continue
        scale = b.abs().max().item() + 1e-12
        assert (a - b).abs().max().item() <= 1e-4 * scale + 1e-4 * scale, name
        compared += bool(b.abs().max().item() > 0)
    assert compared >= 4


def test_two_ranks_share_the_card(cuda):
    """run_multiprocess_dryrun with both ranks on the one card (gloo, since
    NCCL refuses two ranks on one device) against the in-process 2-entry
    mesh: the loss at rtol 1e-5, the leaves at rtol 1e-4, atol 1e-6."""
    from chess2rt_tpu_torch import cuda_build
    from chess2rt_tpu_torch.parallel import make_mesh, make_sharded_value_and_grad, mp_dryrun

    cuda_build.load_all()  # both ranks find the libraries built
    loss, grads, backend, _ = mp_dryrun.run_multiprocess_dryrun(2, 64, 48, timeout=300)
    assert backend == "gloo"
    packed, static = mp_dryrun._build(64, 48, cuda)
    ref_loss, ref = make_sharded_value_and_grad(static, make_mesh([cuda] * 2))(
        packed, torch.zeros((48, 64, 3), device=cuda), prng.PRNGKey(0))
    np.testing.assert_allclose(loss, ref_loss.item(), rtol=1e-5)
    for name, a, b in zip(LEAF_NAMES, grads, leaves(ref)):
        np.testing.assert_allclose(a, b.cpu().numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_session_and_async_render_on_the_card(cuda, tmp_path):
    """The interactive session and the async renderer default to the card:
    a preview event launches K1 once per screen tap, the full frame is
    ``render_frame``'s bit for bit, and the async AA pass equals it."""
    from chess2rt_tpu_torch.gui import InteractiveSession
    from chess2rt_tpu_torch.render.async_render import render_scene_async
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import write_standin_sdl

    s = InteractiveSession(write_standin_sdl(str(tmp_path), 160, 120))
    assert s.device.type == "cuda"
    R.launches = R.ray_launches = F.bounce_rounds = 0
    preview = s.handle_key("w", "shift")
    assert preview.shape == (120, 160, 3) and np.isfinite(preview).all()
    assert R.launches - R.ray_launches == 1 and R.ray_launches == F.bounce_rounds
    full = s.render()
    packed, static = pack_scene(s.scene)
    with torch.no_grad():
        np.testing.assert_array_equal(full, render_frame(packed, static).cpu().numpy())
    h = render_scene_async(s.scene)
    np.testing.assert_array_equal(h.result(300), full)
    assert h.passes_completed == 3 and h.error is None


@pytest.mark.parametrize("name,argv", [
    ("inverse_render", ["--size", "32x24", "--steps", "9"]),
    ("texture_recovery", ["--size", "64x48", "--steps", "5"]),
    ("bump_inverse", ["--size", "64x48", "--steps", "5"]),
    ("gi_inverse", ["--size", "32x24", "--paths", "2", "--steps", "3"]),
])
def test_demo_twins_on_the_card(cuda, name, argv, capsys):
    """Each demo twin on the card at a small size: its loss falls, its
    finite-difference check (where it has one) holds, and its steps went
    through K1's residual form."""
    import importlib

    demo = importlib.import_module(f"chess2rt_tpu_torch.demos.{name}")
    R.resid_launches = 0
    out = demo.run(argv)
    assert out["losses"][-1] < out["losses"][0]
    assert out.get("fd_ok", True)
    assert R.resid_launches >= len(out["losses"])


def test_bench_check_on_the_card(cuda, capsys):
    """The bench twin's gate (``python -m chess2rt_tpu_torch.bench --check``)
    at its defaults on the card: ok, through K1 and K2."""
    from chess2rt_tpu_torch import bench

    R.launches = R.resid_launches = K2.launches = 0
    r = bench.main_check()
    assert r["line"]["ok"] and r["line"]["kernels_launched"] is True, r["line"]
    assert R.launches and R.resid_launches and K2.launches
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(r["line"])


def test_bench_gate_fails_without_its_kernels(cuda, monkeypatch, capsys):
    """With the bench twin's kernel path swapped for the twin (no K1), the
    gate reports ``kernels_launched`` false and fails, and ``main`` and
    ``main_sharded`` raise."""
    from chess2rt_tpu_torch import bench
    from chess2rt_tpu_torch import parallel
    from chess2rt_tpu_torch.render.pipeline import render_frame_wavefront

    monkeypatch.setattr(bench, "render_frame", render_frame_wavefront)
    line = bench.main_check(96, 54)["line"]
    assert line["kernels_launched"] is False and line["ok"] is False, line
    with pytest.raises(AssertionError, match="launched K1 0 times"):
        bench.main(96, 54)
    monkeypatch.setattr(parallel, "make_sharded_render_fn",
                        lambda static, m: lambda p, k: render_frame_wavefront(p, static, k))
    with pytest.raises(AssertionError, match="launched K1 0 times"):
        bench.main_sharded(96, 54)
    capsys.readouterr()


# --- the engine modes: gi_path_batch, bounce_mode="compact", texel_tap_reuse, texel_grad_mode ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K, c", [(1, 257), (3, 1023), (8, 100_003)])
def test_batched_draw_matches_plain_bit_for_bit(cuda, dtype, K, c):
    """csrc/threefry.cu's batched draw: one launch, bit-equal to its plain
    version on the card and on the CPU and to K single draws."""
    keys = prng.split(prng.fold_in(prng.PRNGKey(c), K), K)
    before = prng.launches
    out = prng.uniform_keys(keys, c, dtype, device=cuda)
    assert prng.launches == before + 1 and out.shape == (K * c,)
    view = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(out.view(view), prng.uniform_keys_reference(keys, c, dtype, device=cuda).view(view))
    assert torch.equal(out.cpu().view(view), prng.uniform_keys_reference(keys, c, dtype, device="cpu").view(view))
    single = torch.cat([prng.uniform(k, (c,), dtype, device=cuda) for k in keys])
    assert torch.equal(out.view(view), single.view(view))


def test_gi_path_batch_frame_on_the_card(cuda):
    """K = 4 paths per K1 launch: within 1e-5 of one path per launch, the
    jitter's draws batched (2 per batch), one bounce kernel per bounce round
    over the K slabs, and the kernel path at the frame limits of the plain
    path (plain K1, plain draws)."""
    import dataclasses

    from chess2rt_tpu_torch.ops import gi

    tp, ts = _gi_scene(96, 72, 8)
    key = prng.PRNGKey(7)
    frames = []
    for K in (None, 4):
        st = dataclasses.replace(ts, gi_path_batch=K)
        R.launches = R.hit_launches = prng.launches = gi.bounce_rounds = gi.bounce_kernels = 0
        frames.append(gi.build_gi_renderer(st, 96, 72)(tp, key))
        assert R.launches == R.hit_launches == gi.bounce_rounds == gi.bounce_kernels > 0
        assert prng.launches == 2 * 8 // (K or 1)
    torch.testing.assert_close(frames[1], frames[0], rtol=1e-5, atol=1e-5)
    st = dataclasses.replace(ts, gi_path_batch=4)
    ref = gi.build_gi_renderer(st, 96, 72, trace=R.round0_reference, uniform=prng.uniform_reference)(tp, key)
    _frame_close(frames[1], ref)


@pytest.mark.parametrize("cap", [4096, 1], ids=["fits", "overflow"])
def test_compact_bounces_on_the_card(cuda, cap):
    """Lane-compacted bounce rounds through K1's ray-input form, bit-equal
    to block and full-width rounds; capacity 1 (one 1024-lane tile) overflows
    at 256x192 and takes the full-width rounds, counted."""
    import dataclasses

    tp, ts = pack_scene(flagship_standin(T, 256, 192), device=cuda)
    ts = dataclasses.replace(ts, aa_enabled=False, bounce_capacity=cap)
    frames = {}
    for mode in ("block", "full", "compact"):
        F.compact_overflows = R.ray_launches = 0
        frames[mode] = F.build_flagship_renderer(dataclasses.replace(ts, bounce_mode=mode), 256, 192)(tp)
        assert R.ray_launches > 0
        assert F.compact_overflows == (cap == 1 and mode == "compact")
    assert torch.equal(frames["compact"], frames["block"]) and torch.equal(frames["compact"], frames["full"])


@pytest.mark.parametrize("cap", [None, 160 * 120, 1], ids=["default", "fits", "overflow"])
def test_texel_tap_reuse_on_the_card(cuda, cap):
    """AA taps 1-4 reusing the base tap's texel quads: the flagship frame and
    the rows renderer's slices bit-equal to reuse off, with the changed lanes
    re-gathered lane-compacted (capacity n) or in a full gather (capacity 1)."""
    import dataclasses

    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    on = dataclasses.replace(ts, texel_tap_reuse=True, texel_reuse_capacity=cap)
    F.reuse_taps = F.reuse_overflows = 0
    assert torch.equal(F.build_flagship_renderer(on, 160, 120)(tp), F.build_flagship_renderer(ts, 160, 120)(tp))
    assert F.reuse_taps == 4 and F.reuse_overflows == {1: 4, 160 * 120: 0}.get(cap, F.reuse_overflows)
    rows_on, rows_off = F.build_rows_renderer(on, 160, 120, 9600), F.build_rows_renderer(ts, 160, 120, 9600)
    for base in (0, 9600):
        assert torch.equal(rows_on(tp, base), rows_off(tp, base))


def test_texel_grad_modes_on_the_card(cuda):
    """The step's atlas gradient under "sorted" and "scatter" (torch
    scatters, no K2) against "histogram" (K2): atol 1e-6, rtol 1e-4
    (tests/test_inverse.py:219-241); every other leaf at f32 rounding."""
    import dataclasses

    tp, ts = pack_scene(flagship_standin(T, 160, 120), device=cuda)
    ts = dataclasses.replace(ts, aa_enabled=False)
    grads = {}
    for mode in ("histogram", "sorted", "scatter"):
        xs = [x.detach().clone().requires_grad_() for x in leaves(tp)]
        K2.launches = 0
        st = dataclasses.replace(ts, texel_grad_mode=mode)
        (F.build_flagship_renderer(st, 160, 120)(from_leaves(xs)) ** 2).mean().backward()
        assert bool(K2.launches) == (mode == "histogram")
        grads[mode] = {k: x.grad for k, x in zip(LEAF_NAMES, xs)}
    hist = grads["histogram"]
    assert bool(hist["bitmap_atlas"].any())
    for mode in ("sorted", "scatter"):
        for k, g in grads[mode].items():
            if k == "bitmap_atlas":
                torch.testing.assert_close(g, hist[k], rtol=1e-4, atol=1e-6)
            elif g is not None:  # the mode moves only the atlas; atomics elsewhere may reorder sums
                torch.testing.assert_close(g, hist[k], rtol=1e-5, atol=1e-7 + 1e-5 * hist[k].abs().max().item())


# --- the GI bounce kernel (csrc/gi_bounce.cu) ---


def _bounce_inputs(dev, K, nee, quirk, w=160, h=120):
    """The second bounce round of K jittered camera slabs of the GI stand-in
    under the sky cubemap (its bitmap box, CSG node and cubemap) at w x h:
    (packed, static, K1's rows, the albedo with the bitmap texels gathered,
    the path state after one glue round)."""
    from chess2rt_tpu_torch.models.packed import TEX_BITMAP
    from chess2rt_tpu_torch.ops import gi
    from chess2rt_tpu_torch.ops import shade as S
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays

    tp, ts = pack_scene(gi_standin(T, w, h, paths=K, env=True), device=dev)
    ts = dataclasses.replace(ts, gi_point_light_direct=nee, gi_multiplier_quirk=quirk)
    lay = R.layout(ts, w, h, want_hit=True)
    prm = lay.pack(tp)
    n = w * h
    lin = torch.arange(n, device=dev)
    keys = prng.split(prng.PRNGKey(1900 + K), 4)
    x = torch.cat([(lin % w).float() + prng.uniform(prng.fold_in(keys[0], j), (n,), device=dev) for j in range(K)])
    y = torch.cat([(lin // w).float() + prng.uniform(prng.fold_in(keys[1], j), (n,), device=dev) for j in range(K)])
    orig, dir = (r.contiguous() for r in screen_rays(tp.camera, begin_frame(tp.camera, w / h), float(w), float(h),
                                                     x, y, 0.0))
    state = (orig, dir, torch.ones_like(orig), torch.zeros_like(orig), torch.ones(K * n, dtype=torch.bool, device=dev))
    o = R.round0(lay, prm, orig, dir)
    u, v = (prng.uniform_keys(prng.split(k, K), n, device=dev) for k in keys[2:])
    state = tuple(x.contiguous() for x in gi.bounce_reference(ts, o, None, tp.ambient, *state, u, v, 1e-3))
    o = R.round0(lay, prm, state[0], state[1])
    winc = torch.clamp_min(o["win"], 0)
    tex = S.bitmap_color(tp, ts, winc, o["u"], o["v"], S.node_onehot(ts, winc))
    diffuse = torch.where((S.tex_kind_of(ts, winc) == TEX_BITMAP)[:, None], tex,
                          torch.stack([o["dr"], o["dg"], o["db"]], -1)).contiguous()
    return tp, ts, o, diffuse, state


@pytest.mark.parametrize("albedo", ["gathered", "k1_rows"])
@pytest.mark.parametrize("nee,quirk", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["nee", "nee_no_quirk", "no_nee", "no_nee_no_quirk"])
@pytest.mark.parametrize("K", [1, 8])
def test_gi_bounce_matches_bounce_reference(cuda, K, nee, quirk, albedo):
    """One bounce round: csrc/gi_bounce.cu against ``gi.bounce_reference``
    on the same K1 rows and path state, the reference's draws through
    ``prng.uniform_keys``: one launch, the state updated in place; alive
    equal; dir bit-equal on all but 1e-4 of the lanes (so the inline draws
    are ``uniform_keys``' bits: a draw one ulp off moves most lanes'
    directions); orig, dir, mult and acc within 4 float32 ulps of
    max(|reference|, 1), and mult within 4 ulps of its value at cosine 1."""
    from chess2rt_tpu_torch.ops import gi

    tp, ts, o, diffuse, state = _bounce_inputs(cuda, K, nee, quirk)
    diffuse = diffuse if albedo == "gathered" else None
    C = o["t"].shape[0] // K
    ku, kv = prng.split(prng.PRNGKey(1910 + K), K), prng.split(prng.PRNGKey(1920 + K), K)
    u, v = prng.uniform_keys(ku, C, device=cuda), prng.uniform_keys(kv, C, device=cuda)
    want = gi.bounce_reference(ts, o, diffuse, tp.ambient, *state, u, v, 1e-3)
    got = tuple(x.clone() for x in state)
    before, draws = gi.bounce_kernels, prng.launches
    out = gi.gi_bounce(ts, o, diffuse, tp.ambient, *got, ku, kv, 1e-3)
    assert gi.bounce_kernels == before + 1 and prng.launches == draws
    assert all(a is b for a, b in zip(out, got))
    albedo_rows = torch.stack([o["dr"], o["dg"], o["db"]], -1) if diffuse is None else diffuse
    ulp = torch.finfo(torch.float32).eps
    report = {}
    for name, a, b in zip(("orig", "dir", "mult", "acc"), got[:4], want[:4]):
        d = (a - b).abs()
        scale = b.abs().clamp_min(1.0)
        if name == "mult":
            scale = b.abs() + 2 * (state[2] * albedo_rows).abs()
        err = torch.where(d == 0, 0.0, d / scale).max().item()
        report[name] = (int((a != b).any(-1).sum()), err)
        assert bool(torch.isfinite(a).all() == torch.isfinite(b).all()), name
        assert err <= 4 * ulp, (name, report)
    assert torch.equal(got[4], want[4])
    assert report["dir"][0] <= 1e-4 * K * C, report
    print(json.dumps({"K": K, "nee": nee, "quirk": quirk, "albedo": albedo, "unequal_lanes_and_err": report}))


def _cell_scene(dev):
    """The GI cell's scene (BENCHMARK.json's lecture4-gi-standin, bench.py
    build_gi): the lecture4 stand-in (``gi_standin(gi=False)``: the
    checkered floor, one light), GI on, 40 paths, depth 5, AA off, the far
    bounce wall, NEE, at 640x480."""
    from chess2rt_tpu_torch.scenes import GI_WALL

    sc = gi_standin(T, 640, 480, paths=40, gi=False)
    sc.settings.GIEnabled = True
    center, r, white = GI_WALL
    wall = T.Node(name="wall", geometry=T.Sphere(name="w", center=center, R=r), shader=T.Lambert(name="white",
                                                                                                color=white))
    sc.nodes.append(wall)
    sc.geometries.append(wall.geometry)
    sc.shaders.append(wall.shader)
    tp, ts = pack_scene(sc, device=dev)
    return tp, dataclasses.replace(ts, gi_point_light_direct=True)


def test_gi_cell_frame_through_the_bounce_kernel(cuda):
    """The GI cell's 640x480 40-path frame through the bounce kernel against
    the same frame through the glue with the same bits
    (``uniform=prng.uniform``): ``px_off``, the share of pixels whose
    largest channel differs by more than 2e-3 (rtbench/check.py), under the
    cell's limit 0.005; 240 bounce rounds, every one the kernel's on the
    first path and the glue's on the second."""
    from chess2rt_tpu_torch.ops import gi

    tp, ts = _cell_scene(cuda)
    key = prng.PRNGKey(1930)
    frames, rounds = [], []
    for kw in ({}, {"uniform": prng.uniform}):
        gi.bounce_rounds = gi.bounce_kernels = gi.glue_bounces = 0
        with torch.no_grad():
            frames.append(gi.build_gi_renderer(ts, 640, 480, **kw)(tp, key))
        rounds.append((gi.bounce_rounds, gi.bounce_kernels, gi.glue_bounces))
    assert rounds == [(240, 240, 0), (240, 0, 240)]
    d = (frames[0].double() - frames[1].double()).abs().amax(-1)
    px_off = (d > 2e-3).double().mean().item()
    print(json.dumps({"px_off": px_off, "max_abs": d.max().item(), "unequal_pixels": (d > 0).double().mean().item()}))
    assert bool(torch.isfinite(frames[0]).all()) and frames[0].max().item() > 0.01
    assert px_off < 0.005


def _same_bits(a, b):
    """Equal bit for bit, a NaN matching a NaN."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a.view(torch.int32)[~na], b.view(torch.int32)[~nb]))


@pytest.mark.parametrize("rows", ["pass", "bounce", "planted"])
def test_combine_kernel_is_combine_reference(cuda, rows):
    """csrc/combine.cu against ``flagship.combine_reference`` bit for bit
    (a NaN matching a NaN) on the 1080p DoF + cubemap frame's first pass
    (2,073,600 rays through K1's ray-input form), on that pass's
    block-compacted bounce round, and on the bounce round with missed
    lanes, NaN u and v, zero directions and negative zeros planted; one
    launch, counted."""
    from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays

    w, h = 1920, 1080
    tp, ts = pack_scene(flagship_standin(T, w, h, dof=True, env=True), device=cuda)
    n = w * h
    lin = torch.arange(n, device=cuda)
    kj, kj2, k1, k2 = prng.split(prng.PRNGKey(2101), 4)
    draw = lambda k: prng.uniform(k, (n,), device=cuda)  # noqa: E731
    o3, d3 = screen_rays(tp.camera, begin_frame(tp.camera, w / h), float(w), float(h), (lin % w).float() + draw(kj),
                         (lin // w).float() + draw(kj2), 0.0, dof=True, disc_uv=(draw(k1), draw(k2)))
    lay = R.layout(ts, w, h)
    prm = lay.pack(tp)
    o, dirs = R.round0(lay, prm, o3.contiguous(), d3.contiguous()), d3.contiguous()
    if rows != "pass":
        _, cont, _, ro, rd = F.combine_reference(tp, ts, o, dirs)
        blk = cont.reshape(-1, R.BOUNCE_BLOCK).any(1).nonzero().squeeze(1)
        bo3, dirs = (x.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous() for x in (ro, rd))
        o = R.round0(lay, prm, bo3, dirs)
        assert 0 < dirs.shape[0] < n
    if rows == "planted":
        o = {k: v.clone() for k, v in o.items()}
        o["win"][::13] = -1
        o["u"][3::7] = float("nan")
        o["v"][5::11] = float("nan")
        o["r"][3::19] = o["lr"][3::19] = -0.0
        dirs = dirs.clone()
        dirs[::5] = 0.0
    want = F.combine_reference(tp, ts, o, dirs)
    before = F.combine_kernels
    got = F.combine_kernel(tp, ts, o, dirs)
    torch.cuda.synchronize()
    assert F.combine_kernels == before + 1
    for name, a, b in zip(("color", "cont", "atten", "ro", "rd"), got, want):
        assert _same_bits(a, b), name
    win = o["win"]
    assert bool((win < 0).any()) and bool(want[1].any())
    if rows == "planted":
        assert bool(torch.isnan(want[0]).any())


@pytest.mark.parametrize("scene", ["dof_sky", "aa5_1080p"])
def test_frames_through_the_combine_kernel_are_the_glue_frames(cuda, monkeypatch, scene):
    """Frames through ``render_frame`` with every ``combine_outputs`` call
    on csrc/combine.cu against the same frames with the calls routed to
    ``combine_reference``, bit for bit: the DoF + cubemap frame at 640x360
    (25 samples, AA 5) and the 1080p AA5 stand-in frame."""
    from chess2rt_tpu_torch.render.pipeline import render_frame

    if scene == "dof_sky":
        tp, ts = pack_scene(flagship_standin(T, 640, 360, dof=True, env=True), device=cuda)
        taps = 125
    else:
        tp, ts = pack_scene(flagship_standin(T, 1920, 1080), device=cuda)
        taps = 5
    key = prng.PRNGKey(2102)
    F.combine_kernels = F.combine_glue = F.bounce_rounds = 0
    got = render_frame(tp, ts, key)
    assert (F.combine_kernels, F.combine_glue) == (taps + F.bounce_rounds, 0)
    monkeypatch.setattr(F, "combine_outputs", F.combine_reference)
    F.combine_kernels = F.combine_glue = F.bounce_rounds = 0
    want = render_frame(tp, ts, key)
    assert (F.combine_kernels, F.combine_glue) == (0, taps + F.bounce_rounds)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


def test_combine_kernel_takes_scenes_of_any_size(cuda):
    """The combine kernel on a scene of 1,106 nodes and 72 bitmaps (the
    stand-in under its sky with 1,100 small spheres, 70 with a bitmap of
    their own) against ``combine_reference`` bit for bit on random rows:
    its node and texture tables go by device pointer, so no size of scene
    leaves the card for the glue."""
    rng = np.random.default_rng(21)
    sc = flagship_standin(T, 64, 48, env=True)
    mirror = next(n.shader for n in sc.nodes if n.name == "mirror_ball")
    plain = next(n.shader for n in sc.nodes if n.name == "diff")
    for j in range(1100):
        if j < 70:
            data = rng.random((2 + j % 7, 3 + j % 5, 3)).astype(np.float32)
            tex = T.BitmapTexture(name=f"tex{j}", scaling=float(rng.uniform(0.01, 0.5)), data=data)
            shader = T.Lambert(name=f"sh{j}", color=(1.0, 1.0, 1.0), texture=tex)
        else:
            shader = mirror if j % 3 == 0 else plain
        geom = T.Sphere(name=f"ball{j}", center=tuple(rng.uniform(-100, 100, 3)), R=1.0)
        sc.nodes.append(T.Node(name=f"ball{j}", geometry=geom, shader=shader))
    tp, ts = pack_scene(sc, device=cuda)
    assert (len(ts.nodes), len(ts.bitmap_sizes)) == (1106, 72)
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(2121)
    o = {k: torch.rand(n, generator=g, device=cuda) for k in F._COMBINE_ROWS}
    for k in ("u", "v"):
        o[k] = o[k] * 6 - 3
        o[k][5::23] = float("nan")
    o["win"] = torch.randint(-1, len(ts.nodes), (n,), generator=g, device=cuda, dtype=torch.int32)
    dirs = torch.randn(n, 3, generator=g, device=cuda)
    dirs[::9] = 0.0
    F.combine_kernels = F.combine_glue = 0
    got = F.combine_outputs(tp, ts, o, dirs)
    assert (F.combine_kernels, F.combine_glue) == (1, 0)
    want = F.combine_reference(tp, ts, o, dirs)
    for name, a, b in zip(("color", "cont", "atten", "ro", "rd"), got, want):
        assert _same_bits(a, b), name
