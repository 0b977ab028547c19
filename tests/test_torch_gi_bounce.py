"""The GI bounce round after K1 (ops/gi.py): its torch glue
``bounce_reference``, the fused kernel csrc/gi_bounce.cu and the tracer's
choice between them, on the CPU.

* ``bounce_reference`` inside the tracer gives bit for bit what the
  tracer's glue gave before it was moved into one function (a copy of that
  tracer below), with K = 1 and 4 path-slabs, NEE on and off,
  ``gi_multiplier_quirk`` on and off, and the environment's miss term;
* csrc/gi_bounce.cu's device code compiled by the host's C++ compiler
  through a small stand-in for ``cuda_runtime.h`` (no contraction, as
  ``-fmad=false`` builds it for the card) and run block by block on the
  arguments ``gi.bounce_args`` marshals, against ``bounce_reference`` with
  the draws of ``prng.uniform_keys_reference``: ``alive``, ``acc`` and
  ``orig`` equal, ``dir`` within 4 float32 ulps of 1 and ``mult`` within 4
  ulps of its value at cosine 1 (the host's libm against torch's sin, cos
  and acos);
* the dispatch: on the CPU, with ``trace=round0_reference``, with
  ``uniform`` given and with a leaf requiring grad, every round is the
  glue's (``gi.glue_bounces`` == ``gi.bounce_rounds``, no kernel);
* ``bounce_args`` refuses what the kernel cannot take, and the kernel's
  constants and C signature match the Python side.

Scene: ``scenes.gi_standin`` at 16x12 (its bitmap box, CSG node and, with
``env``, the sky cubemap), K1 through its plain version.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch import cuda_build
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import TEX_BITMAP, from_leaves, leaves, pack_scene
from chess2rt_tpu_torch.ops import gi, prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops import shade as S
from chess2rt_tpu_torch.ops.camera import begin_frame, screen_rays
from chess2rt_tpu_torch.render import pipeline as P
from chess2rt_tpu_torch.scenes import gi_standin

torch.set_num_threads(2)

W, H, KEY = 16, 12, 11
CSRC = Path(cuda_build.__file__).parent / "csrc"
# name: (path-slabs K, NEE, gi_multiplier_quirk, environment cubemap)
CASES = {
    "nee": (1, True, True, False),
    "nee_k4": (4, True, True, False),
    "no_nee": (1, False, True, False),
    "no_quirk_k4": (4, True, False, False),
    "env": (1, True, True, True),
    "env_no_quirk_k4": (4, True, False, True),
}


def _case(name):
    K, nee, quirk, env = CASES[name]
    tp, ts = pack_scene(gi_standin(TT, W, H, paths=K, env=env), device="cpu")
    return K, tp, dataclasses.replace(ts, gi_point_light_direct=nee, gi_multiplier_quirk=quirk)


def _camera_rays(tp, K, key):
    """K jittered slabs of the frame's camera rays ([K * W * H, 3] each)."""
    n = W * H
    lin = torch.arange(n)
    x = ((lin % W).float() + prng.uniform_reference(prng.fold_in(key, 1), (n,), device="cpu")).repeat(K)
    y = ((lin // W).float() + prng.uniform_reference(prng.fold_in(key, 2), (n,), device="cpu")).repeat(K)
    return screen_rays(tp.camera, begin_frame(tp.camera, W / H), float(W), float(H), x, y, 0.0)


def _parent_tracer(static, trace=R.round0_reference):
    """The tracer as it was before its glue moved into ``bounce_reference``
    (one-key draws through ``prng.uniform_reference``, batched through
    ``prng.uniform_keys_reference``), op for op."""
    lay = R.layout(static, W, H, want_hit=True)

    def hit_of(packed, o):
        win = o["win"]
        normal = torch.stack([o["nx"], o["ny"], o["nz"]], dim=-1)
        diffuse = torch.stack([o["dr"], o["dg"], o["db"]], dim=-1)
        winc = torch.clamp_min(win, 0)
        tex = S.bitmap_color(packed, static, winc, o["u"], o["v"], S.node_onehot(static, winc))
        diffuse = torch.where((S.tex_kind_of(static, winc) == TEX_BITMAP)[..., None], tex, diffuse)
        return win, normal, diffuse, torch.stack([o["lr"], o["lg"], o["lb"]], dim=-1)

    def draw(keys, C):
        if len(keys) == 1:
            return prng.uniform_reference(keys[0], (C,), device="cpu")
        return prng.uniform_keys_reference(keys, C, device="cpu")

    def tracer(packed, orig, dir, keys):
        C = orig.shape[0] // keys.shape[0]
        prm = lay.pack(packed)
        eps = S.shadow_eps(orig.dtype)
        acc = torch.zeros_like(orig)
        mult = torch.ones_like(orig)
        alive = torch.ones(orig.shape[:-1], dtype=torch.bool)
        for r in range(static.max_trace_depth + 1):
            if r and not bool(alive.any()):
                break
            o = trace(lay, prm, orig.contiguous(), dir.contiguous())
            win, normal, diffuse, L = hit_of(packed, o)
            hitmask = alive & (win >= 0)
            N = S.faceforward(dir, normal)
            mult_eff = torch.ones_like(mult) if static.gi_multiplier_quirk else mult
            if static.has_env:
                acc = acc + P.env_miss_term(packed, static, alive, win, dir, mult_eff)
            if static.gi_point_light_direct:
                nee = diffuse * (1.0 / torch.pi) * (L - packed.ambient)
                acc = acc + torch.where(hitmask[..., None], mult_eff * nee, 0.0)
            sp = np.stack([prng.split(k, 3) for k in keys])
            keys = sp[:, 0]
            u = draw(sp[:, 1], C)
            v = draw(sp[:, 2], C)
            w, mult = P.hemisphere_bounce(mult, N, diffuse, u, v)
            ts = torch.where(hitmask, o["t"], 0.0)
            p = orig + dir * ts[..., None]
            orig = torch.where(hitmask[..., None], p + N * eps, orig)
            dir = torch.where(hitmask[..., None], w, dir)
            alive = hitmask
        return acc

    return tracer


@pytest.mark.parametrize("name", sorted(CASES))
def test_bounce_reference_is_the_inline_glue(name):
    K, tp, ts = _case(name)
    keys = prng.split(prng.PRNGKey(KEY), K)
    orig, dir = _camera_rays(tp, K, prng.PRNGKey(KEY))
    gi.bounce_rounds = gi.glue_bounces = gi.bounce_kernels = 0
    with torch.no_grad():
        got = gi.build_gi_tracer(ts, W, H, trace=R.round0_reference)(tp, orig, dir, keys)
        want = _parent_tracer(ts)(tp, orig, dir, keys)
    assert gi.glue_bounces == gi.bounce_rounds > 1 and gi.bounce_kernels == 0
    if ts.gi_point_light_direct or ts.has_env:
        assert want.abs().max().item() > 0.01
    else:  # the reference's GI without NEE is black (tests/test_gi.py:46-55)
        assert not bool(want.any())
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# csrc/gi_bounce.cu's device code on the CPU
# --------------------------------------------------------------------------

SHIM = r"""
#pragma once
#include <math.h>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx;
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline double __longlong_as_double(long long x) { double f; std::memcpy(&f, &x, 8); return f; }
"""

# c2rt_gi_bounce with the launch replaced by a loop over the blocks
HARNESS = r"""
}  // namespace
extern "C" void host_gi_bounce(const unsigned* keys_u, const unsigned* keys_v, int K, long long c,
                               const void* const* rows, long long diffuse_stride, void* const* path, float eps,
                               int flags) {
  KeyTable tu{}, tv{};
  for (int j = 0; j < K; ++j) {
    tu.k[j][0] = keys_u[2 * j];
    tu.k[j][1] = keys_u[2 * j + 1];
    tv.k[j][0] = keys_v[2 * j];
    tv.k[j][1] = keys_v[2 * j + 1];
  }
  const auto f = [&](int r) { return static_cast<const float*>(rows[r]); };
  const Hit h{f(0), {f(1), f(2), f(3)}, {f(4), f(5), f(6)}, {f(7), f(8), f(9)}, diffuse_stride,
              static_cast<const int*>(rows[10]), f(11)};
  const Path p{static_cast<float*>(path[0]), static_cast<float*>(path[1]), static_cast<float*>(path[2]),
               static_cast<float*>(path[3]), static_cast<unsigned char*>(path[4])};
  for (unsigned j = 0; j < (unsigned)K; ++j)
    for (long long b = 0; b * BLOCK < c; ++b)
      for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
        blockIdx.x = (unsigned)b;
        blockIdx.y = j;
        threadIdx.x = t;
        gi_bounce_kernel(tu, tv, c, h, p, eps, flags & 1, (flags >> 1) & 1);
      }
}
"""


@pytest.fixture(scope="module")
def host_bounce(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("gi_bounce_host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    text = (CSRC / cuda_build.SOURCES["gi_bounce"][0]).read_text()
    (tmp / "gi_bounce_host.cpp").write_text(text[: text.index("// ---- host side")] + HARNESS)
    lib = tmp / "libgi_bounce_host.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{tmp}",
                          f"-I{CSRC}", "-o", str(lib), str(tmp / "gi_bounce_host.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).host_gi_bounce
    (argtypes,) = [a for name, a, _ in cuda_build._EXPORTS["gi_bounce"] if name == "c2rt_gi_bounce"]
    fn.argtypes = argtypes[:-1]  # no stream
    return fn


def _round_inputs(K, tp, ts):
    """The inputs of a second bounce round: K1's rows, the albedo with the
    bitmap texels gathered, and the path state after one glue round from
    the camera (misses dead, mult and acc moved)."""
    C = W * H
    lay = R.layout(ts, W, H, want_hit=True)
    prm = lay.pack(tp)
    orig, dir = _camera_rays(tp, K, prng.PRNGKey(KEY))
    state = (orig, dir, torch.ones_like(orig), torch.zeros_like(orig), torch.ones(K * C, dtype=torch.bool))
    keys = prng.split(prng.PRNGKey(KEY + 1), 2 * K)
    with torch.no_grad():
        o = R.round0_reference(lay, prm, orig, dir)
        u, v = (prng.uniform_keys_reference(k, C, device="cpu") for k in (keys[:K], keys[K:]))
        state = gi.bounce_reference(ts, o, None, tp.ambient, *state, u, v, 1e-3)
        o = R.round0_reference(lay, prm, state[0], state[1])
        winc = torch.clamp_min(o["win"], 0)
        tex = S.bitmap_color(tp, ts, winc, o["u"], o["v"], S.node_onehot(ts, winc))
        gathered = torch.where((S.tex_kind_of(ts, winc) == TEX_BITMAP)[:, None], tex,
                               torch.stack([o["dr"], o["dg"], o["db"]], -1))
    alive = state[4]
    assert 0 < alive.double().mean().item() < 1 and bool((o["win"][alive] >= 0).any())
    return o, gathered, state


@pytest.mark.parametrize("gathered", [True, False], ids=["gathered", "k1_rows"])
@pytest.mark.parametrize("name", ["nee", "nee_k4", "no_nee", "no_quirk_k4"])
def test_kernel_device_code_matches_bounce_reference(host_bounce, name, gathered):
    K, tp, ts = _case(name)
    C = W * H
    o, diffuse, state = _round_inputs(K, tp, ts)
    diffuse = diffuse if gathered else None
    ku, kv = prng.split(prng.PRNGKey(KEY + 2), K), prng.split(prng.PRNGKey(KEY + 3), K)
    u, v = prng.uniform_keys_reference(ku, C, device="cpu"), prng.uniform_keys_reference(kv, C, device="cpu")
    with torch.no_grad():
        want = gi.bounce_reference(ts, o, diffuse, tp.ambient, *state, u, v, 1e-3)
    got = tuple(x.clone() for x in state)
    args, _hold = gi.bounce_args(ts, o, diffuse, tp.ambient, *got, ku, kv, 1e-3)
    host_bounce(*args)
    albedo = torch.stack([o["dr"], o["dg"], o["db"]], -1) if diffuse is None else diffuse
    # a unit direction's components err by ulps of 1, and the weight
    # 2 * mult * diffuse * cosine by ulps of its value at cosine 1
    scale = {"dir": torch.ones_like(want[1]), "mult": want[2].abs() + 2 * (state[2] * albedo).abs()}
    for name_, a, b in zip(("orig", "dir", "mult", "acc", "alive"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name_
        if name_ in scale:
            d = (a - b).abs()
            err = torch.where(d == 0, 0.0, d / scale[name_]).max().item()  # a weight of 0 stays 0
            assert err <= 4 * torch.finfo(torch.float32).eps, (name_, err)
        else:
            assert torch.equal(a, b), name_
    assert not torch.equal(got[0], state[0]) and not torch.equal(got[2], state[2])


# --------------------------------------------------------------------------
# The dispatch
# --------------------------------------------------------------------------


def _frame(tp, ts, **kw):
    return gi.build_gi_renderer(ts, W, H, **kw)(tp, prng.PRNGKey(KEY))


@pytest.mark.parametrize("mode", ["cpu", "plain_trace", "uniform", "grad", "remat"])
def test_glue_path_counts_every_round(mode):
    """Every round the CPU tracer runs is the glue's: the default call,
    the plain K1 and plain draws, and a recorded gradient (with and
    without ``gi_remat_paths``, whose recompute counts again)."""
    _, tp, ts = _case("nee")
    kw = {"plain_trace": {"trace": R.round0_reference}, "uniform": {"uniform": prng.uniform_reference}}.get(mode, {})
    if mode == "remat":
        ts = dataclasses.replace(ts, gi_remat_paths=True)
    gi.bounce_rounds = gi.glue_bounces = gi.bounce_kernels = 0
    if mode in ("grad", "remat"):
        xs = [x.detach().clone().requires_grad_() if x.is_floating_point() else x for x in leaves(tp)]
        _frame(from_leaves(xs), ts, **kw).sum().backward()
        assert any(x.grad is not None and bool(x.grad.any()) for x in xs if x.is_floating_point())
    else:
        with torch.no_grad():
            _frame(tp, ts, **kw)
    assert gi.glue_bounces == gi.bounce_rounds > 0 and gi.bounce_kernels == 0
    if mode == "remat":  # the checkpointed batch ran again in the backward
        assert gi.bounce_rounds >= 2 * ts.paths_per_pixel


def test_bounce_args_checks_its_inputs():
    K, tp, ts = _case("nee_k4")
    o, diffuse, state = _round_inputs(K, tp, ts)
    keys = prng.split(prng.PRNGKey(3), K)
    args, _ = gi.bounce_args(ts, o, diffuse, tp.ambient, *state, keys, keys, 1e-3)
    assert args[2:4] == (K, W * H) and args[5] == 3 and args[8] == 3
    assert gi.bounce_args(ts, o, None, tp.ambient, *state, keys, keys, 1e-3)[0][5] == 1
    quirkless = dataclasses.replace(ts, gi_multiplier_quirk=False, gi_point_light_direct=False)
    assert gi.bounce_args(quirkless, o, None, tp.ambient, *state, keys, keys, 1e-3)[0][8] == 0
    bad = {
        "keys": lambda s: (s, keys, keys[:1]),
        "slabs": lambda s: (s, prng.split(prng.PRNGKey(3), 5), prng.split(prng.PRNGKey(3), 5)),
        "too_many_keys": lambda s: (s, np.zeros((prng.MAX_KEYS + 1, 2), np.uint32),
                                    np.zeros((prng.MAX_KEYS + 1, 2), np.uint32)),
        "f64": lambda s: ((s[0].double(), *s[1:]), keys, keys),
        "strided": lambda s: ((s[0], s[1], s[2].t().contiguous().t(), *s[3:]), keys, keys),
        "alive": lambda s: ((*s[:4], s[4].to(torch.uint8)), keys, keys),
    }
    for label, make in bad.items():
        st, ku, kv = make(state)
        with pytest.raises(ValueError, match="gi_bounce"):
            gi.bounce_args(ts, o, diffuse, tp.ambient, *st, ku, kv, 1e-3)
    with pytest.raises(ValueError, match="diffuse"):
        gi.bounce_args(ts, o, diffuse[:, :2], tp.ambient, *state, keys, keys, 1e-3)


def test_kernel_constants_match_the_python_side():
    header = (CSRC / "threefry.cuh").read_text()
    assert int(re.search(r"constexpr int MAX_KEYS = (\d+);", header).group(1)) == prng.MAX_KEYS
    text = (CSRC / "gi_bounce.cu").read_text()
    assert '#include "threefry.cuh"' in text and '#include "threefry.cuh"' in (CSRC / "threefry.cu").read_text()
    assert "threefry2x32(uint32_t" not in (CSRC / "threefry.cu").read_text()  # the rounds live in the header
    params = re.search(r"int c2rt_gi_bounce\((.*?)\)", text, re.S).group(1).split(",")
    (argtypes,) = [a for fn, a, _ in cuda_build._EXPORTS["gi_bounce"] if fn == "c2rt_gi_bounce"]
    assert len(params) == len(argtypes) == 10
    # rows: K1's rows in the kernel's order, then the albedo, win and the ambient colour
    assert gi._ROWS == ("t", "nx", "ny", "nz", "lr", "lg", "lb")
    assert cuda_build.SOURCES["gi_bounce"] == ("gi_bounce.cu", ("-fmad=false",))
