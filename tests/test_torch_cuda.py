"""The hand-written kernels against their plain PyTorch versions, on the
card: K1 (csrc/round0.cu) in its screen-tap, ray-input, residual and
lin-input forms on the stand-in, the seeded fuzz scenes and the two CSG
stress scenes (a 16-hit list, nested CsgDiffs), K2 (csrc/texel_hist.cu) on
the shapes a row-parallel segmented sum can get wrong, K3's four stages
(round0.cu built with -DC2RT_STAGE=k), the round-0 gradient through each
form, and the sharded, chunked and adaptive frames at small sizes.

These tests need an NVIDIA card and nvcc; they carry the ``gpu`` marker and
skip elsewhere.  They import no JAX (the machine with the card has none),
so run them there without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Limits: the repo's kernel-vs-reference limits (tests/test_fuzz.py), as in
chip_smoke.py: the winning node differs on < 1% of lanes, and over lanes
where it agrees < 1% have d > 2e-3 and median(d) < 2e-4, with d the
absolute difference, relative to |plain| where |plain| > 1.
"""

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch.models import types as T
from chess2rt_tpu_torch.models.packed import LEAF_NAMES, from_leaves, leaves, pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops import texel_hist as K2
from chess2rt_tpu_torch.ops.round0_grad import diff_round0
from chess2rt_tpu_torch.scenes import csg_stress_scene, flagship_standin, random_scene

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
    # a 16-hit list (the kernel's MAX_HITS) and CsgDiff nodes nested on both sides
    "deep16": lambda: csg_stress_scene(T, "deep16", 96, 72),
    "nested_diff": lambda: csg_stress_scene(T, "nested_diff", 96, 72),
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
    err = lib.c2rt_round0(prm.data_ptr(), prog.data_ptr(), prm.numel(), prog.numel(), None, None, out.data_ptr(),
                          win.data_ptr(), 128, 64, 48, None)
    torch.cuda.synchronize()
    assert err == 1  # cudaErrorInvalidValue: 280,000 bytes of tables, refused before the launch
    with pytest.raises(ValueError, match="shared memory"):
        R.check_table_bytes(60_000, 10_000)


def test_lin_input_lane_base_above_2_pow_24(cuda):
    """An 8K frame's last shards start above 2^24: the f32 lin slot holds
    every multiple of 128, and the kernel's lanes are those of the ray-input
    form on the same pixels' rays."""
    from chess2rt_tpu_torch.ops.round0_grad import _gen_rays_lin

    w, h = 7680, 4320
    tp, ts = pack_scene(flagship_standin(T, w, h), device=cuda)
    lay = R.layout(ts, w, h)
    base = 2**24 + 128 * 5  # an odd multiple of 128
    out = R.round0(lay, lay.pack(tp, (0.0, 0.0), base), lin_input=True, n_lanes=4096)
    o3, d3 = _gen_rays_lin(tp, w, h, (0.0, 0.0), base, 4096)
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
