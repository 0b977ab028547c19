"""The host side of the two hand-written kernels, and K1's device code run
on the CPU.

* K2's wrapper: how ``plan`` cuts N rows into spans and sizes the scratch,
  which load width ``load_width`` picks, what an empty input gives.
* K1's scene program: its table offsets, every node's hit-list length and
  the list capacity, the CsgDiff list every leaf carries, the shared-memory
  limit and the lists' placement, and the constants that ops/round0.py,
  ops/texel_hist.py and cuda_build.py share with the CUDA sources (read
  from the source text).
* csrc/round0.cu's device code compiled by the host's C++ compiler through
  a small stand-in for ``cuda_runtime.h`` and run thread by thread (tables
  in global memory, so no barrier is needed), against ``round0_reference``
  on the stand-in, the seeded fuzz scenes and the four CSG stress scenes, in
  every form, with and without the residual rows, with the hit lists in
  (emulated) shared and in global memory, at the repo's
  kernel-vs-reference limits.  This checks the kernel's logic (the tags,
  the winner-only record, the replayed CsgDiff flips, the register merge,
  the skipped scans), not its speed; the card tests check the build itself.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chess2rt_tpu_torch import cuda_build
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import round0 as R
from chess2rt_tpu_torch.ops import round0_probe as K3
from chess2rt_tpu_torch.ops import texel_hist as K2
from chess2rt_tpu_torch.scenes import csg_stress_scene, flagship_standin, gi_standin, random_scene

torch.set_num_threads(2)

CSRC = Path(cuda_build.__file__).parent / "csrc"
W, H = 32, 24


# --------------------------------------------------------------------------
# K2: the wrapper's plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 255, 256, 257, 15_232, 131_072, 131_073, 307_200, 2_073_600, 2**31 - 2000])
def test_plan_covers_the_rows_with_few_equal_spans(n):
    span, n_spans = K2.plan(n)
    assert span % K2.BLOCK_THREADS == 0 and span >= K2.BLOCK_THREADS
    assert n_spans <= K2.TARGET_SPANS
    assert (n_spans - 1) * span < n <= n_spans * span
    # no smaller multiple of the block would do with this many spans
    assert span == K2.BLOCK_THREADS or (span - K2.BLOCK_THREADS) * K2.TARGET_SPANS < n


def test_plan_of_the_gradient_steps_rows():
    """The 640x480 step: 400 blocks of 768 rows for the tap, one chunk per
    block for the bounce round; the second launch's 2 * n_spans partial rows
    fit one block of 1024 threads."""
    assert K2.plan(307_200) == (768, 400)
    assert K2.plan(15_232) == (256, 60)
    assert 2 * K2.TARGET_SPANS <= 1024


@pytest.mark.parametrize("c,pointers,want", [
    (12, (256, 512, 1024), 4),
    (16, (256,), 4),
    (6, (256, 512), 2),
    (5, (256, 512), 1),
    (1, (256,), 1),
    (12, (256, 520), 2),  # one pointer only 8-byte aligned
    (12, (256, 516), 1),  # one pointer only 4-byte aligned
    (6, (260, 512), 1),
])
def test_load_width_follows_channels_and_alignment(c, pointers, want):
    assert K2.load_width(c, *pointers) == want


def test_empty_input_gives_a_zero_table():
    out = K2.texel_histogram(torch.zeros(0, dtype=torch.int32), torch.zeros((0, 12)), 7)
    assert out.shape == (7, 12) and not bool(out.any())


def test_texel_hist_constants_match_the_cuda_source():
    text = (CSRC / "texel_hist.cu").read_text()
    assert int(re.search(r"constexpr int MAX_C = (\d+);", text).group(1)) == K2.MAX_CHANNELS
    # the C function takes what the wrapper and the ctypes binding pass
    params = re.search(r"int c2rt_texel_hist\((.*?)\)", text, re.S).group(1).split(",")
    (argtypes,) = [a for fn, a, _ in cuda_build._EXPORTS["texel_hist"] if fn == "c2rt_texel_hist"]
    assert len(params) == len(argtypes) == 12
    assert K2.BLOCK_THREADS % 32 == 0 and K2.BLOCK_THREADS <= 1024


# --------------------------------------------------------------------------
# K1: the scene program
# --------------------------------------------------------------------------

SCENES = {
    "standin": lambda: flagship_standin(TT, W, H),
    "glass": lambda: flagship_standin(TT, W, H, glass=True),
    "deep16": lambda: csg_stress_scene(TT, "deep16", W, H),
    "nested_diff": lambda: csg_stress_scene(TT, "nested_diff", W, H),
    "deep40": lambda: csg_stress_scene(TT, "deep40", W, H),
    "diff_nest": lambda: csg_stress_scene(TT, "diff_nest", W, H),
    # the GI stand-in: all Lambert, a bitmap, a six-hit CSG node in the lists
    "gi": lambda: gi_standin(TT, W, H),
    **{f"random{s}": (lambda s=s: random_scene(TT, s, width=W, height=H)) for s in range(1000, 1008)},
}


def _packed(name):
    return pack_scene(SCENES[name](), device="cpu")


@pytest.mark.parametrize("name,longest", [("standin", 4), ("deep16", 16), ("nested_diff", 8), ("deep40", 40),
                                          ("diff_nest", 34)])
def test_header_holds_table_lengths_and_longest_list(name, longest):
    _, ts = _packed(name)
    lay = R.layout(ts, W, H)
    prog = lay.program
    # the tables follow the header in order and the diff table ends the program
    light_tab, node_tab, instr_tab, pair_tab, diff_tab = (
        prog[h] for h in (R.H_LIGHT_TAB, R.H_NODE_TAB, R.H_INSTR_TAB, R.H_PAIR_TAB, R.H_DIFF_TAB))
    assert light_tab == R.HEADER and node_tab == light_tab + ts.n_lights
    assert instr_tab == node_tab + R.NODE_STRIDE * len(ts.nodes)
    assert (pair_tab - instr_tab) % R.INSTR_STRIDE == 0 and (diff_tab - pair_tab) % 2 == 0
    leaves = [k for k in range((pair_tab - instr_tab) // R.INSTR_STRIDE)
              if prog[instr_tab + R.INSTR_STRIDE * k] != R.OP_CSG]
    assert prog.size - diff_tab == sum(prog[instr_tab + R.INSTR_STRIDE * k + 3] for k in leaves)
    # the list capacity is the longest list, and every scene here keeps its lists in shared memory
    assert _longest_list(prog) == longest == prog[R.H_LIST_CAP]
    assert R.check_table_bytes(prog.size, lay.n_prm) == 4 * (prog.size + lay.n_prm)
    assert R.list_placement(prog, lay.n_prm) == "shared"


def _longest_list(prog):
    """The longest hit list of any node (the node record's last field)."""
    node_tab = prog[R.H_NODE_TAB]
    return max(prog[node_tab + R.NODE_STRIDE * i + R.NODE_STRIDE - 1] for i in range(prog[R.H_NODES]))


def _diffs_above(expr, start):
    """[(leaf instruction, the CsgDiff instructions above it, ascending)] of
    an expression emitted from instruction ``start`` on, all relative to
    the node's first instruction, and the number of instructions emitted."""
    if expr[0] != "csg":
        return [(start, [])], 1
    left, n_left = _diffs_above(expr[2], start)
    right, n_right = _diffs_above(expr[3], start + n_left)
    here = start + n_left + n_right
    above = [here] if expr[1] == "diff" else []
    return [(k, d + above) for k, d in left + right], n_left + n_right + 1


def _leaf_diffs(prog, k):
    """The diff list of instruction ``k`` (absolute), read from the diff table."""
    ins = prog[prog[R.H_INSTR_TAB] + R.INSTR_STRIDE * k:][: R.INSTR_STRIDE]
    return prog[ins[2]: ins[2] + ins[3]].tolist()


@pytest.mark.parametrize("name", ["standin", "nested_diff", "deep16", "random1003", "random1005", "diff_nest"])
def test_leaves_carry_the_diffs_above_them(name):
    _, ts = _packed(name)
    lay = R.layout(ts, W, H)
    prog = lay.program
    instr_tab, node_tab = prog[R.H_INSTR_TAB], prog[R.H_NODE_TAB]
    seen_diff = False
    for i, expr in enumerate(lay.expr_tables):
        start = prog[node_tab + R.NODE_STRIDE * i + 7]
        want, count = _diffs_above(expr, 0)
        assert count == prog[node_tab + R.NODE_STRIDE * i + 8] < R.TAG_KEPT  # the tag's instruction field
        for rel, diffs in want:
            assert prog[instr_tab + R.INSTR_STRIDE * (start + rel)] != R.OP_CSG
            assert _leaf_diffs(prog, start + rel) == diffs, (i, rel)
            seen_diff |= bool(diffs)
    if name in ("standin", "nested_diff", "diff_nest"):
        assert seen_diff


def test_nested_diff_leaves_sit_under_two_diffs():
    """And the long nest's leaves under up to 16, past instruction 31."""
    for name, most, last in (("nested_diff", 2, None), ("diff_nest", 16, 32)):
        _, ts = _packed(name)
        prog = R.layout(ts, W, H).program
        instr_tab = prog[R.H_INSTR_TAB]
        n_instr = (prog[R.H_PAIR_TAB] - instr_tab) // R.INSTR_STRIDE
        lists = [_leaf_diffs(prog, k) for k in range(n_instr) if prog[instr_tab + R.INSTR_STRIDE * k] != R.OP_CSG]
        assert max(len(d) for d in lists) == most
        if last is not None:
            assert max(max(d, default=0) for d in lists) == last


def test_tables_beyond_shared_memory_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="shared memory"):
        R.check_table_bytes(60_000, 10_000)
    # tables at the limit leave a block room for lists of 27 slots; a node of
    # TAG_KEPT instructions could not fit in the tables at all
    assert R.SHARED_BLOCK_BYTES - R.MAX_TABLE_BYTES == 27 * 8 * R.BLOCK_THREADS
    assert 4 * R.INSTR_STRIDE * R.TAG_KEPT > R.MAX_TABLE_BYTES
    # a scene whose own tables are too large: layout() refuses it
    _, ts = _packed("deep16")
    n_bytes = 4 * (R.layout(ts, W, H).program.size + R.layout(ts, W, H).n_prm)
    monkeypatch.setattr(R, "MAX_TABLE_BYTES", n_bytes - 4)
    R.layout.cache_clear()
    try:
        with pytest.raises(ValueError, match="shared memory"):
            R.layout(ts, W, H)
    finally:
        R.layout.cache_clear()


def test_seventeen_hits_are_refused_and_sixteen_are_not():
    """Neither is refused now that K1 sizes its lists per scene (it held 16
    slots once): 16 and 17 hits encode with their own list capacity, and a
    list that does not fit in a block's shared memory beside the tables
    goes to global memory."""

    def chain(n_spheres, plane):
        sc = TT.Scene()
        geom = TT.Sphere(name="s0", center=(0.0, 0.0, 5.0), R=1.0)
        for k in range(1, n_spheres):
            geom = TT.CsgUnion(name=f"u{k}", op="union", left=geom,
                               right=TT.Sphere(name=f"s{k}", center=(float(k), 0.0, 5.0), R=1.0))
        if plane:
            geom = TT.CsgUnion(name="up", op="union", left=geom, right=TT.Plane(name="p", y=-1.0))
        sc.nodes = [TT.Node(name="n", geometry=geom, shader=TT.Lambert(name="l"))]
        return pack_scene(sc, device="cpu")[1]

    for n_spheres, plane, want in ((8, False, 16), (8, True, 17), (20, True, 41)):
        lay = R.layout(chain(n_spheres, plane), 8, 8)
        assert _longest_list(lay.program) == lay.program[R.H_LIST_CAP] == want
        assert R.list_placement(lay.program, lay.n_prm) == "shared"
    # the same list beside tables that leave it no room
    prog = R.layout(chain(20, True), 8, 8).program
    room = R.SHARED_BLOCK_BYTES - 8 * 41 * R.BLOCK_THREADS
    assert R.list_placement(prog, room // 4 - prog.size) == "shared"
    assert R.list_placement(prog, room // 4 - prog.size + 1) == "global"


def _enum(text, first):
    body = re.search(r"enum \{\s*" + first + r"\b(.*?)\};", text, re.S)
    return [first] + [w for w in re.findall(r"\b[A-Z][A-Z0-9_]*\b", body.group(1))]


def test_program_constants_match_the_cuda_source():
    text = (CSRC / "round0.cu").read_text()

    def const(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", text).group(1))

    assert const("PROGRAM_VERSION") == R.PROGRAM_VERSION
    assert const("TAG_BITS") == R.TAG_BITS and 2 * R.TAG_BITS + 3 <= 31  # leaf, which, dropped; bit 31 the side
    assert const("NODE_STRIDE") == R.NODE_STRIDE and const("INSTR_STRIDE") == R.INSTR_STRIDE
    assert const("BLOCK") == R.BOUNCE_BLOCK == R.BLOCK_THREADS == 128
    header = _enum(text, "H_VERSION")
    assert [getattr(R, name) for name in header] == list(range(len(header))) and len(header) <= R.HEADER
    flags = dict(re.findall(r"\b(F_[A-Z_]+) = (\d+)", re.search(r"enum \{ F_PHONG.*?\};", text, re.S).group(0)))
    assert {k: int(v) for k, v in flags.items()} == {k: getattr(R, k) for k in flags} and len(flags) == 7
    # the four-slot network that the register merge unrolls
    assert re.findall(r"^\s*C2RT_CE\((\d), (\d)\)$", text, re.M) == [(str(i), str(j)) for i, j in R._oddeven_pairs(4)]
    # the lists' bytes per slot and thread: a float distance and a 32-bit tag
    assert "8 * list_cap * BLOCK" in text and "unsigned& tag(int m)" in text
    params = re.search(r"int c2rt_round0\((.*?)\)", text, re.S).group(1).split(",")
    for name in ("round0", *[f"round0_{s}" for s in K3.STAGES]):
        (argtypes,) = [a for fn, a, _ in cuda_build._EXPORTS[name] if fn == "c2rt_round0"]
        assert len(params) == len(argtypes) == 14


def test_every_library_has_a_source_and_a_binding():
    assert set(cuda_build.SOURCES) == set(cuda_build._EXPORTS)
    for name, (source, flags) in cuda_build.SOURCES.items():
        assert (CSRC / source).exists(), name
    # the stage probes' flags, and gi_bounce.cu's: no product fused into an add, as in the torch glue it mirrors
    assert {f for _, f in cuda_build.SOURCES.values() if f} == {(f"-DC2RT_STAGE={k}",) for k in (1, 2, 3, 4)} | {
        ("-fmad=false",)}


# --------------------------------------------------------------------------
# K1's device code on the CPU
# --------------------------------------------------------------------------

SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx, blockDim, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
"""

HARNESS = r"""
}  // namespace
#include <vector>
// lists == null: the lists in a block's "shared" memory, a buffer laid out
// as the kernel's dynamic allocation (tables, then the lists) that every
// thread of a block shares; else the global [2 * list_cap, n] scratch
extern "C" int host_round0(const float* prm, const int* prog, int n_prm, int n_prog, int list_cap,
                           const float* orig, const float* dir, float* lists, float* out, int* win, int n,
                           int width, int height) {
  const int n_tiles = (n + BLOCK - 1) / BLOCK;
  std::vector<int> block(n_prog + n_prm + 2 * list_cap * BLOCK, 0x7fc00000);
  tables = block.data();
  gridDim.x = n_tiles;
  blockDim.x = BLOCK;
  for (unsigned b = 0; b < (unsigned)n_tiles; ++b)
    for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      if (lists == nullptr)
        round0_kernel<false>(prm, prog, n_prm, n_prog, orig, dir, lists, out, win, n, width, height);
      else
        round0_kernel<true>(prm, prog, n_prm, n_prog, orig, dir, lists, out, win, n, width, height);
    }
  tables = nullptr;
  return 0;
}
"""

BUILDS = {
    "kernel": (),
    # is_inside's register stack cut to 2 levels: the long nest reaches the
    # levels kept in the lists
    "stack2": ("-DC2RT_STACK_WORD=2",),
    **{stage: (f"-DC2RT_STAGE={k}",) for stage, k in cuda_build.STAGES.items()},
}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """{build: ctypes function} of round0.cu's device code compiled for the
    host, one shared library per set of flags."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("round0_host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    text = (CSRC / "round0.cu").read_text()
    (tmp / "round0_host.cpp").write_text(text[: text.index("// ---- host side")] + HARNESS)
    procs = {}
    for name, flags in BUILDS.items():
        cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{tmp}", "-DC2RT_TABLES_SHARED=0",
               *flags, "-o", str(tmp / f"lib{name}.so"), str(tmp / "round0_host.cpp")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        fn = ctypes.CDLL(str(tmp / f"lib{name}.so")).host_round0
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci]
        fns[name] = fn
    return fns


def _run(fn, lay, prm, orig=None, dir=None, n=None, rows=None, placement=None):
    """What ``_round0_cuda`` does, with the host build in the kernel's place."""
    prog = torch.from_numpy(lay.program)
    if orig is not None:
        n = orig.shape[0]
    elif n is None:
        n = lay.width * lay.height
    out = torch.full((len(lay.names) if rows is None else rows, n), float("nan"))
    win = torch.full((n,), -7, dtype=torch.int32)
    lists = R.list_scratch(lay, n, "cpu", placement)
    if lists is not None:
        lists.fill_(float("nan"))
    fn(prm.data_ptr(), prog.data_ptr(), lay.n_prm, prog.numel(), int(lay.program[R.H_LIST_CAP]),
       None if orig is None else orig.data_ptr(), None if dir is None else dir.data_ptr(),
       None if lists is None else lists.data_ptr(), out.data_ptr(), win.data_ptr(), n, lay.width, lay.height)
    if rows is not None:
        return out
    res = dict(zip(lay.names, out.unbind(0)))
    res["win"] = win
    return res


def _rays(name, n):
    rng = np.random.default_rng(len(name))
    big = name in ("standin", "glass")
    center, spread = ((0.0, 120.0, 220.0), 150.0) if big else ((0.0, 1.0, 0.0), 6.0)
    orig = torch.as_tensor(np.asarray(center) + rng.uniform(-spread, spread, (n, 3)), dtype=torch.float32)
    d = rng.normal(size=(n, 3))
    return orig, torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)


def _d(a, b):
    a, b = a.double(), b.double()
    return (a - b).abs() / b.abs().clamp_min(1.0)


def _assert_close(out, ref, names):
    """The repo's kernel-vs-reference limits (tests/test_fuzz.py), the vis
    bits as chip_smoke.py holds them."""
    agree = out["win"] == ref["win"]
    assert agree.double().mean().item() > 0.99
    for k in names:
        assert bool(torch.isfinite(out[k]).all()), k
        if k.startswith("vis"):
            assert (out[k][agree] != ref[k][agree]).double().mean().item() < 0.01, k
            continue
        d = _d(out[k][agree], ref[k][agree])
        assert (d > 2e-3).double().mean().item() < 0.01, k
        assert d.median().item() < 2e-4, k


@pytest.mark.parametrize("residual", [(False, False), (True, False), (True, True)], ids=["plain", "hit", "residual"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_code_matches_plain_version(host_kernels, name, residual):
    """Screen-tap, ray-input and lin-input forms, with the plain rows, with
    want_hit alone (GI's form: without F_VIS the kernel skips the shadow
    scans of unshaded lanes and writes zeros to their light rows, as the
    plain version does) and with both residual flags; with the vis rows the
    bits hold on every lane, also where the light sum is thrown away."""
    tp, ts = _packed(name)
    lay = R.layout(ts, W, H, want_hit=residual[0], want_vis=residual[1])
    prm = lay.pack(tp, (0.3, 0.6))
    tap = _run(host_kernels["kernel"], lay, prm)
    _assert_close(tap, R.round0_reference(lay, prm), lay.names)
    orig, dir = _rays(name, W * H)
    _assert_close(_run(host_kernels["kernel"], lay, prm, orig, dir), R.round0_reference(lay, prm, orig, dir),
                  lay.names)
    half = W * H // 2
    parts = [_run(host_kernels["kernel"], lay, lay.pack(tp, (0.3, 0.6), i * half), n=half) for i in range(2)]
    for k in tap:  # the same code on the same lanes
        assert torch.equal(torch.cat([p[k] for p in parts]), tap[k]), k


def test_device_code_reaches_every_node_of_the_stress_scenes(host_kernels):
    for name in ("deep16", "nested_diff", "deep40", "diff_nest"):
        tp, ts = _packed(name)
        lay = R.layout(ts, W, H)
        win = _run(host_kernels["kernel"], lay, lay.pack(tp))["win"]
        assert set(win.tolist()) == set(range(-1, len(ts.nodes))), name


@pytest.mark.parametrize("name", ["deep16", "nested_diff", "deep40", "diff_nest"])
def test_device_code_gives_the_same_bits_with_either_list_placement(host_kernels, name):
    """The lists in global memory against shared memory, residual rows on,
    screen-tap and ray-input: the same code on the same lanes.  The long
    nest also through the build whose is_inside keeps 2 levels in a
    register and the rest in the lists."""
    tp, ts = _packed(name)
    lay = R.layout(ts, W, H, want_hit=True, want_vis=True)
    prm = lay.pack(tp, (0.3, 0.6))
    orig, dir = _rays(name, W * H)
    for rays in ((), (orig, dir)):
        shared = _run(host_kernels["kernel"], lay, prm, *rays)
        builds = [("kernel", "global")] + ([("stack2", "shared"), ("stack2", "global")] if "diff" in name else [])
        for build, placement in builds:
            other = _run(host_kernels[build], lay, prm, *rays, placement=placement)
            for k in shared:
                assert torch.equal(other[k], shared[k]), (build, placement, k)
    _assert_close(shared, R.round0_reference(lay, prm, orig, dir), lay.names)


@pytest.mark.parametrize("stage", K3.STAGES)
@pytest.mark.parametrize("name", ["standin", "nested_diff", "random1003"])
def test_stage_cuts_match_plain_version(host_kernels, name, stage):
    tp, ts = _packed(name)
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp, (0.3, 0.6))
    out = _run(host_kernels[stage], lay, prm, rows=2)
    for a, b in zip(out, K3.round0_stage_reference(lay, prm, stage)):
        d = _d(a, b)
        assert bool(torch.isfinite(a).all())
        assert (d > 2e-3).double().mean().item() < 0.01 and d.median().item() < 2e-4
