"""``combine_outputs`` after K1 (ops/flagship.py): its torch glue
``combine_reference``, the fused kernel csrc/combine.cu and the choice
between them, on the CPU.

* csrc/combine.cu's device code compiled by the host's C++ compiler
  through a small stand-in for ``cuda_runtime.h`` (no contraction, as
  ``-fmad=false`` builds it for the card) and run block by block on the
  arguments ``flagship.combine_args`` marshals, bit-equal to
  ``combine_reference`` on K1's rows from ``round0_reference``: with
  bitmaps and a cubemap, bitmaps alone, the cubemap alone and neither,
  each with and without a mirror; on a screen tap, on a block-compacted
  bounce buffer, on rows of stride 3, and on rows with missed lanes, NaN
  u and v and zero directions (NaN and -0.0 in the colour compared bit
  for bit);
* scenes past any table a kernel argument could hold (1,100 more nodes,
  70 bitmaps of their own) and a scene with no node, on rows drawn at
  random, bit-equal to the glue;
* the dispatch: rows on a CUDA device (a CPU tensor that says so) take the
  kernel on a forward call, also with leaves that require grad under
  ``no_grad``; a recorded gradient, ``texel_plan``, ``texel_reuse`` and
  the CPU take the glue, each counted; whole Monte-Carlo (DoF + sky) and
  5-tap frames with ``combine_outputs`` on the host build bit-equal to the
  glue's;
* ``combine_args`` refuses wrong shapes, dtypes and devices, and the
  kernel's C signature matches the Python side.
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
from chess2rt_tpu_torch.models.packed import from_leaves, leaves, pack_scene
from chess2rt_tpu_torch.ops import flagship as F
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops.camera import pixel_rays
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import csg_free_scene, flagship_standin, sky_cubemap

torch.set_num_threads(2)

W, H = 32, 24
CSRC = Path(cuda_build.__file__).parent / "csrc"


def _scene(parts, mirror=True):
    """A scene with ``parts``: "bitmap_env" (the stand-in under its sky),
    "bitmap" (the stand-in), "env" (the bitmap-free scene under the sky) or
    "none"; ``mirror`` False drops the mirror sphere."""
    if parts.startswith("bitmap"):
        sc = flagship_standin(TT, W, H, env=parts == "bitmap_env")
    else:
        sc = csg_free_scene(TT, 7, W, H)
        if parts == "env":
            sc.environment.cubemap = sky_cubemap(16)
    if not mirror:
        sc.nodes = [n for n in sc.nodes if n.name != "mirror_ball"]
    return pack_scene(sc, device="cpu")


def _tap(tp, ts):
    """K1's screen tap (its plain version) and the directions of its rays."""
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp)
    aa = prm[lay.off["aa"]:lay.off["aa"] + 2]
    dirs = pixel_rays(tp.camera, W, H, torch.arange(W * H), aa)[1] if ts.has_env else None
    return R.round0_reference(lay, prm), dirs


def _bounce(tp, ts, o):
    """K1's rows of the first bounce round on the block-compacted buffer of
    the tap ``o``'s continuing lanes (``build_bounce_finisher``'s blocks),
    and the rays' directions."""
    _, cont, _, ro, rd = F.combine_reference(tp, ts, o, None)
    blk = cont.reshape(-1, R.BOUNCE_BLOCK).any(1).nonzero().squeeze(1)
    assert 0 < blk.numel() < cont.numel() // R.BOUNCE_BLOCK
    o3, d3 = (x.reshape(-1, R.BOUNCE_BLOCK, 3)[blk].reshape(-1, 3).contiguous() for x in (ro, rd))
    lay = R.layout(ts, W, H)
    return R.round0_reference(lay, lay.pack(tp), o3, d3), d3


def _perturbed(o, dirs):
    """``o`` and ``dirs`` with missed lanes, NaN u and v, zero directions
    and negative zeros planted (the rows a dead or junk lane can carry)."""
    o = {k: v.clone() for k, v in o.items()}
    o["win"][::13] = -1
    for k, step in (("u", 7), ("v", 11)):
        if k in o:
            o[k][step // 2::step] = float("nan")
    for k in ("r", "lr"):  # -0.0 + 0.0 is 0.0
        if k in o:
            o[k][3::19] = -0.0
    if dirs is not None:
        dirs = dirs.clone()
        dirs[::5] = 0.0
        dirs[2::17, 1] = -0.0
    return o, dirs


def _strided(o, dirs):
    """``o``'s float rows as the columns of one [n, rows] tensor (stride
    rows), ``dirs`` as every other row of a [2n, 3] tensor."""
    names = [k for k in o if k != "win"]
    cols = torch.stack([o[k] for k in names], -1).unbind(-1)
    out = dict(zip(names, cols), win=o["win"])
    if dirs is not None:
        dirs = torch.stack([dirs, torch.full_like(dirs, 9.0)], 1).reshape(-1, 3)[::2]
    return out, dirs


def _same_bits(a, b):
    """Equal bit for bit, any NaN matching any NaN."""
    if a is None or b is None:
        return a is None and b is None
    a, b = a.detach(), b.detach()
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return bool(torch.equal(na, nb) and torch.equal(a.view(bits)[~na], b.view(bits)[~nb]))


# --------------------------------------------------------------------------
# csrc/combine.cu's device code on the CPU
# --------------------------------------------------------------------------

SHIM = r"""
#pragma once
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx;
"""

# c2rt_combine with the launch replaced by a loop over the blocks
HARNESS = r"""
}  // namespace
extern "C" int host_combine(const unsigned* nodes, int n_nodes, const int* tex, int n_tex, const int* dims,
                            long long n, const void* const* rows, const long long* strides, void* const* outs,
                            int flags) {
  Scene sc;
  In in;
  Out out;
  unpack(nodes, n_nodes, tex, n_tex, dims, rows, strides, outs, sc, in, out);
  for (long long b = 0; b * BLOCK < n; ++b)
    for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = t;
      combine_kernel(sc, n, in, out, flags);
    }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_combine(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("combine_host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    text = (CSRC / cuda_build.SOURCES["combine"][0]).read_text()
    (tmp / "combine_host.cpp").write_text(text[: text.index("// ---- host side")] + HARNESS)
    lib = tmp / "libcombine_host.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{tmp}",
                          "-o", str(lib), str(tmp / "combine_host.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).host_combine
    (argtypes,) = [a for name, a, _ in cuda_build._EXPORTS["combine"] if name == "c2rt_combine"]
    fn.argtypes = argtypes[:-1]  # no stream
    fn.restype = ctypes.c_int
    return fn


def _run_host(fn, tp, ts, o, dirs):
    args, out, _hold = F.combine_args(tp, ts, o, dirs)
    assert fn(*args) == 0
    return out


# (the scene's parts, a mirror, K1's rows): a bounce round needs the mirror
CASES = [(parts, mirror, rows) for parts in ("bitmap_env", "bitmap", "env", "none") for mirror in (True, False)
         for rows in ("tap", "bounce", "perturbed", "strided") if mirror or rows != "bounce"]


@pytest.mark.parametrize("parts,mirror,rows", CASES,
                         ids=[f"{p}-{'mirror' if m else 'no_mirror'}-{r}" for p, m, r in CASES])
def test_kernel_device_code_is_combine_reference(host_combine, parts, mirror, rows):
    tp, ts = _scene(parts, mirror)
    o, dirs = _tap(tp, ts)
    if rows == "bounce":
        o, dirs = _bounce(tp, ts, o)
        if ts.has_env:
            dirs = dirs.clone()
    elif rows == "perturbed":
        o, dirs = _perturbed(o, dirs)
    elif rows == "strided":
        o, dirs = _strided(o, dirs)
    with torch.no_grad():
        want = F.combine_reference(tp, ts, o, dirs)
    got = _run_host(host_combine, tp, ts, o, dirs)
    for name, a, b in zip(("color", "cont", "atten", "ro", "rd"), got, want):
        assert _same_bits(a, b), (name, parts, mirror, rows)
    if rows == "perturbed" and ts.has_env:  # a miss with a zero direction: NaN texel fractions reach the colour
        assert bool(torch.isnan(want[0]).any())
    if mirror and rows != "bounce":  # a tap's mirror lanes continue
        assert bool(want[1].any())


def test_kernel_reads_both_tables_in_one_call(host_combine):
    """The merged table on the stand-in's tap under its sky: lanes of every
    kind (a bitmap hit, another hit, a miss on the sky, a mirror hit) and
    keys on both sides of the bitmap rows."""
    tp, ts = _scene("bitmap_env")
    o, dirs = _tap(tp, ts)
    got = _run_host(host_combine, tp, ts, o, dirs)
    win = o["win"]
    kinds = torch.tensor([ts.nodes[w].tex_kind if w >= 0 else -1 for w in win.tolist()])
    assert bool((win < 0).any()) and bool((kinds == 3).any()) and bool(((kinds != 3) & (win >= 0)).any())
    assert bool(got[1].any())
    rgb = torch.stack([o["r"], o["g"], o["b"]], -1)
    assert bool((got[0] != rgb)[win < 0].any()) and bool((got[0] != rgb)[kinds == 3].any())


def _wide_scene(extra):
    """The stand-in under its sky with ``extra`` more small spheres: the
    first 70 with a bitmap of their own (2-8 x 3-7 texels), every third of
    the rest a mirror; ``extra`` 0 gives a scene with no node."""
    sc = flagship_standin(TT, W, H, env=True)
    if extra == 0:
        sc.nodes = []
        return pack_scene(sc, device="cpu")
    rng = np.random.default_rng(21)
    mirror = next(n.shader for n in sc.nodes if n.name == "mirror_ball")
    plain = next(n.shader for n in sc.nodes if n.name == "diff")
    for j in range(extra):
        if j < 70:
            data = rng.random((2 + j % 7, 3 + j % 5, 3)).astype(np.float32)
            tex = TT.BitmapTexture(name=f"tex{j}", scaling=float(rng.uniform(0.01, 0.5)), data=data)
            shader = TT.Lambert(name=f"sh{j}", color=(1.0, 1.0, 1.0), texture=tex)
        else:
            shader = mirror if j % 3 == 0 else plain
        geom = TT.Sphere(name=f"ball{j}", center=tuple(rng.uniform(-100, 100, 3)), R=1.0)
        sc.nodes.append(TT.Node(name=f"ball{j}", geometry=geom, shader=shader))
    return pack_scene(sc, device="cpu")


def _random_rows(n_nodes, n=4096):
    """K1's rows drawn at random for a scene of ``n_nodes`` nodes (winners
    over the whole table and misses, u and v past [0, 1), some NaN) and
    directions, some zero."""
    g = torch.Generator().manual_seed(2121)
    o = {k: torch.rand(n, generator=g) for k in F._COMBINE_ROWS}
    for k in ("u", "v"):
        o[k] = o[k] * 6 - 3
        o[k][5::23] = float("nan")
    o["win"] = torch.randint(-1, max(n_nodes, 1), (n,), generator=g, dtype=torch.int32)
    dirs = torch.randn(n, 3, generator=g)
    dirs[::9] = 0.0
    return o, dirs


@pytest.mark.parametrize("extra", [1100, 0], ids=["1106_nodes_72_bitmaps", "no_node"])
def test_kernel_takes_scenes_of_any_size(host_combine, extra):
    """The node words and the bitmaps' sizes go by pointer: a scene of
    1,106 nodes and 72 bitmaps, and one with no node under the sky, bit-
    equal to the glue on random rows."""
    tp, ts = _wide_scene(extra)
    assert (len(ts.nodes), len(ts.bitmap_sizes)) == ((1106, 72) if extra else (0, 0))
    o, dirs = _random_rows(len(ts.nodes))
    with torch.no_grad():
        want = F.combine_reference(tp, ts, o, dirs)
    got = _run_host(host_combine, tp, ts, o, dirs)
    for name, a, b in zip(("color", "cont", "atten", "ro", "rd"), got, want):
        assert _same_bits(a, b), name
    if extra:  # bitmaps of the new nodes were read, and mirrors continue
        new = (o["win"] >= 6) & (o["win"] < 76)
        assert bool(new.any()) and bool(want[1].any())


# --------------------------------------------------------------------------
# The dispatch
# --------------------------------------------------------------------------


def _counts():
    return F.combine_kernels, F.combine_glue


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: the one look the
    dispatch takes at where the rows are."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("mode", ["card", "card_no_grad", "cpu", "grad", "f64", "texel_plan", "texel_reuse"])
def test_dispatch_counts_each_path(mode):
    """Rows on the card take the kernel on a forward call, also with leaves
    that require grad when grad mode is off, and f64 rows, which the
    kernel's marshalling refuses; a recorded gradient, ``texel_plan`` and
    ``texel_reuse`` take the glue on the card too.  On the CPU (f32 or f64)
    every call is the glue's, counted, with the glue's bits and its
    gradient."""
    tp, ts = _scene("bitmap_env")
    o, dirs = _tap(tp, ts)
    kw = {}
    if mode in ("grad", "card_no_grad"):
        xs = [x.detach().clone().requires_grad_() if x.is_floating_point() else x for x in leaves(tp)]
        tp = from_leaves(xs)
    elif mode == "f64":
        o = {k: v.double() if v.is_floating_point() else v for k, v in o.items()}
        dirs = dirs.double()
    elif mode == "texel_plan":
        kw = {"texel_plan": True}
    elif mode == "texel_reuse":
        with torch.no_grad():
            kw = {"texel_reuse": F.combine_reference(tp, ts, o, dirs, texel_plan=True)[5]}
    card = {**o, "win": o["win"].as_subclass(_OnCard)}
    plan, reuse = kw.get("texel_plan", False), kw.get("texel_reuse")
    with torch.set_grad_enabled(mode != "card_no_grad"):
        assert F._combine_on_kernel(tp, card, dirs, plan, reuse) == (mode not in ("grad", "texel_plan", "texel_reuse"))
        assert not F._combine_on_kernel(tp, o, dirs, plan, reuse)
    if mode == "f64":  # on the card the kernel refuses it, as K1 does
        with pytest.raises(ValueError, match="float32"):
            F.combine_args(tp, ts, o, dirs)
    if mode.startswith("card"):
        return
    F.combine_kernels = F.combine_glue = F.env_gathers = 0
    out = F.combine_outputs(tp, ts, o, dirs, **kw)
    assert F.env_gathers == 1 and _counts() == (0, 1)
    if mode == "grad":
        out[0].sum().backward()
        assert tp.bitmap_scaling.grad is not None and bool(tp.bitmap_scaling.grad.any())
    with torch.no_grad():
        want = F.combine_reference(tp, ts, o, dirs, **kw)
    assert all(_same_bits(a, b) for a, b in zip(out[:5], want[:5]))


@pytest.mark.parametrize("scene", ["dof_sky", "aa5"])
def test_frames_through_the_kernel_are_the_glue_frames(host_combine, monkeypatch, scene):
    """Whole frames through ``render_frame`` with every ``combine_outputs``
    call on the host build against the same frames with the calls routed to
    ``combine_reference``, bit for bit: the Monte-Carlo renderer's DoF +
    sky frame (2 samples, AA 5: 10 passes and their bounce rounds) and the
    stand-in's 5-tap frame (screen taps, block bounce rounds)."""
    sc = flagship_standin(TT, W, H, dof=scene == "dof_sky", env=scene == "dof_sky", samples=2)
    tp, ts = pack_scene(sc, device="cpu")
    key = prng.PRNGKey(21)
    host_calls = []

    def on_host(packed, static, o, dirs=None, texel_plan=False, texel_reuse=None):
        assert not texel_plan and texel_reuse is None
        host_calls.append(o["win"].shape[0])
        return _run_host(host_combine, packed, static, o, dirs)

    with torch.no_grad():
        monkeypatch.setattr(F, "combine_outputs", F.combine_reference)
        F.combine_kernels = F.combine_glue = 0
        want = render_frame(tp, ts, key)
        glue = _counts()
        monkeypatch.setattr(F, "combine_outputs", on_host)
        F.combine_kernels = F.combine_glue = 0
        got = render_frame(tp, ts, key)
    calls = 20 if scene == "dof_sky" else 10  # every pass or tap, and its bounce round
    assert glue == (0, calls) and _counts() == (0, 0) and len(host_calls) == calls
    assert torch.equal(got, want) and want.max().item() > 0.05


# --------------------------------------------------------------------------
# The marshalling
# --------------------------------------------------------------------------


def test_combine_args_checks_its_inputs():
    tp, ts = _scene("bitmap_env")
    o, dirs = _tap(tp, ts)
    n = W * H
    args, out, _ = F.combine_args(tp, ts, o, dirs)
    assert args[1] == len(ts.nodes) and args[3] == len(ts.bitmap_sizes) and args[5] == n and args[9] == 7
    assert [x.shape for x in out] == [(n, 3), (n,), (n, 3), (n, 3), (n, 3)] and out[1].dtype == torch.bool
    assert F.combine_args(tp, ts, o, None)[0][9] == 5  # no directions: no sky
    bad = {
        "row_f64": lambda o, d: ({**o, "u": o["u"].double()}, d),
        "row_short": lambda o, d: ({**o, "lr": o["lr"][:-1]}, d),
        "row_2d": lambda o, d: ({**o, "r": o["r"][:, None]}, d),
        "row_device": lambda o, d: ({**o, "rdx": o["rdx"].to("meta")}, d),
        "win_i64": lambda o, d: ({**o, "win": o["win"].long()}, d),
        "dirs_shape": lambda o, d: (o, d[:, :2]),
        "dirs_f64": lambda o, d: (o, d.double()),
        "dirs_device": lambda o, d: (o, d.to("meta")),
    }
    for label, make in bad.items():
        with pytest.raises(ValueError, match="combine"):
            F.combine_args(tp, ts, *make(o, dirs))
    with pytest.raises(ValueError, match="mat_color"):
        F.combine_args(dataclasses.replace(tp, mat_color=tp.mat_color.double()), ts, o, dirs)
    with pytest.raises(ValueError, match="texel_grad_mode"):  # as the glue's gather refuses it
        F.combine_args(tp, dataclasses.replace(ts, texel_grad_mode="bogus"), o, dirs)


def test_kernel_signature_matches_the_python_side():
    text = (CSRC / "combine.cu").read_text()
    params = re.search(r"int c2rt_combine\((.*?)\)", text, re.S).group(1).split(",")
    (argtypes,) = [a for fn, a, _ in cuda_build._EXPORTS["combine"] if fn == "c2rt_combine"]
    assert len(params) == len(argtypes) == 11
    assert F._COMBINE_ROWS == ("r", "g", "b", "lr", "lg", "lb", "u", "v", "rox", "roy", "roz", "rdx", "rdy", "rdz")
    assert cuda_build.SOURCES["combine"] == ("combine.cu", ("-fmad=false",))
