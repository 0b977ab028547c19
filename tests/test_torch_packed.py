"""The port's scene packing against the JAX package's, and the port's
hygiene: it never imports JAX, and its CUDA path raises instead of falling
back where there is no kernel."""

import dataclasses
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from chess2rt_tpu.ops.pallas_trace import _make_packer
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import from_numpy, to_numpy
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import round0 as R

from torch_port_cases import RANDOM_SEEDS, H, W, jax_leaves, packed_pair, scene

torch.set_num_threads(2)

CASES = ("standin",) + RANDOM_SEEDS


def _torch_leaves(tp) -> dict:
    out = {f.name: getattr(tp, f.name).numpy() for f in dataclasses.fields(tp) if f.name != "camera"}
    for f in dataclasses.fields(tp.camera):
        out[f"camera.{f.name}"] = getattr(tp.camera, f.name).numpy()
    return out


@pytest.mark.parametrize("case", CASES)
def test_pack_scene_matches_jax(case):
    """Both packers round the same float64 host values to f32 once: the
    leaves are equal, and so are the static structures."""
    jp, js, tp, ts = packed_pair(case)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    jl, tl = jax_leaves(jp), _torch_leaves(tp)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert jl[k].shape == tl[k].shape, k
        assert jl[k].dtype == tl[k].dtype, k
        np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_from_numpy_carries_jax_leaves(case):
    jp, _, tp, ts = packed_pair(case)
    carried = from_numpy(jax_leaves(jp), ts, device="cpu")
    tl, cl = _torch_leaves(tp), _torch_leaves(carried)
    for k in tl:
        np.testing.assert_array_equal(cl[k], tl[k], err_msg=k)
    # to_numpy is its inverse, keyed the same way
    back = to_numpy(carried)
    assert set(back) == set(jax_leaves(jp))
    for k, v in jax_leaves(jp).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_from_numpy_rejects_missing_leaves():
    jp, _, _, ts = packed_pair("standin")
    leaves = jax_leaves(jp)
    del leaves["ambient"]
    with pytest.raises(ValueError, match="ambient"):
        from_numpy(leaves, ts, device="cpu")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("aa", [(0.0, 0.0), (0.6, 0.3)])
def test_make_packer_matches_jax(case, aa):
    """Same slots, same order, same values.  The 3x3 inverses come from
    different LAPACK paths, hence the 1e-6 tolerance."""
    jp, js, tp, ts = packed_pair(case)
    jpack, joff, jexpr, jn = _make_packer(js, W, H)
    tpack, toff, texpr, tn = R.make_packer(ts, W, H)
    assert (joff, jexpr, jn) == (toff, texpr, tn)
    want = np.asarray(jpack(jp, aa))
    got = tpack(tp, aa).numpy()
    assert got.dtype == np.float32 and got.shape == (tn,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _decode(program, n_nodes):
    """Rebuild each node's offset-rewritten expression tree from the scene
    program's postfix instructions (the walk csrc/round0.cu makes)."""
    instr_tab, pair_tab = program[R.H_INSTR_TAB], program[R.H_PAIR_TAB]
    node_tab = program[R.H_NODE_TAB]
    ops = {v: k for k, v in R.CSG_OPS.items()}
    leaves = {R.OP_PLANE: "plane", R.OP_SPHERE: "sphere", R.OP_CUBE: "cube"}
    trees = []
    for i in range(n_nodes):
        rec = program[node_tab + R.NODE_STRIDE * i: node_tab + R.NODE_STRIDE * (i + 1)]
        start, count, nh = rec[7], rec[8], rec[9]
        stack = []
        for k in range(start, start + count):
            ins = program[instr_tab + R.INSTR_STRIDE * k: instr_tab + R.INSTR_STRIDE * (k + 1)]
            if ins[0] == R.OP_CSG:
                right, left = stack.pop(), stack.pop()
                # the right operand's range is exactly its own postfix
                assert ins[3] - ins[2] == right[2]
                pairs = program[pair_tab + 2 * ins[4]: pair_tab + 2 * (ins[4] + ins[5])]
                assert [tuple(p) for p in pairs.reshape(-1, 2)] == R._oddeven_pairs(ins[6] + ins[7])
                assert (ins[6], ins[7]) == (left[1], right[1])
                stack.append((("csg", ops[ins[1]], left[0], right[0]), left[1] + right[1],
                              left[2] + right[2] + 1))
            else:
                hits = 1 if ins[0] == R.OP_PLANE else 2
                stack.append(((leaves[ins[0]], int(ins[1])), hits, 1))
        (tree, hits, size), = stack
        assert hits == nh and size == count
        trees.append(tree)
    return trees


@pytest.mark.parametrize("case", CASES)
def test_scene_program_encodes_the_structure(case):
    _, _, _, ts = packed_pair(case)
    lay = R.layout(ts, W, H)
    prog = lay.program
    assert prog.dtype == np.int32
    assert prog[R.H_VERSION] == R.PROGRAM_VERSION
    assert (prog[R.H_NODES], prog[R.H_LIGHTS]) == (len(ts.nodes), ts.n_lights)
    assert [prog[R.H_CAM], prog[R.H_AMBIENT], prog[R.H_AA], prog[R.H_LIN]] == [
        lay.off["cam"], lay.off["ambient"], lay.off["aa"], lay.off["lin"]
    ]
    lights = prog[prog[R.H_LIGHT_TAB]: prog[R.H_LIGHT_TAB] + ts.n_lights]
    assert list(lights) == [lay.off[f"light{li}"] for li in range(ts.n_lights)]
    assert _decode(prog, len(ts.nodes)) == list(lay.expr_tables)
    for i, ns in enumerate(ts.nodes):
        rec = prog[prog[R.H_NODE_TAB] + R.NODE_STRIDE * i:][: R.NODE_STRIDE]
        xk = R.X_IDENT if ns.identity_transform else (R.X_OFFSET if ns.offset_only else R.X_MATRIX)
        assert rec[0] == xk
        assert rec[2:5].tolist() == [lay.off[f"n{i}_mat"], ns.shader_kind, ns.tex_kind]
    flags = prog[R.H_FLAGS]
    assert bool(flags & R.F_EMIT_L) == lay.emit_L
    assert bool(flags & R.F_CONT) == lay.has_cont


def test_scene_program_refuses_lists_beyond_max_hits():
    """Nothing is refused for its list length now that K1's lists are sized
    per scene (they held 16 slots once): twenty spheres under one union make
    40 hits, and the program encodes them, its list capacity 40, its
    instruction indices inside the hit tags' field, in shared memory."""
    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu_torch.models.packed import pack_scene

    sc = TT.Scene()
    geom = TT.Sphere(name="s0", center=(0.0, 0.0, 5.0), R=1.0)
    for k in range(1, 20):
        geom = TT.CsgUnion(name=f"u{k}", op="union", left=geom,
                           right=TT.Sphere(name=f"s{k}", center=(float(k), 0.0, 5.0), R=1.0))
    sc.nodes = [TT.Node(name="n", geometry=geom, shader=TT.Lambert(name="l"))]
    _, st = pack_scene(sc, device="cpu")
    lay = R.layout(st, 8, 8)
    prog = lay.program
    assert _decode(prog, 1) == list(lay.expr_tables)
    assert prog[R.H_LIST_CAP] == 40 and prog[prog[R.H_NODE_TAB] + 8] == 39 < R.TAG_KEPT
    assert R.list_placement(prog, lay.n_prm) == "shared"
    out = R.round0(lay, lay.pack(*pack_scene(sc, device="cpu")[:1]))
    assert set(out["win"].tolist()) <= {-1, 0}


def test_port_never_imports_jax():
    """Importing the port, and every module the slice runs, leaves JAX
    unloaded (the machine with the card has no JAX)."""
    code = (
        "import sys\n"
        "import chess2rt_tpu_torch\n"
        "import chess2rt_tpu_torch.cuda_build, chess2rt_tpu_torch.scenes\n"
        "import chess2rt_tpu_torch.models.packed, chess2rt_tpu_torch.ops.camera\n"
        "import chess2rt_tpu_torch.ops.round0, chess2rt_tpu_torch.ops.shade\n"
        "import chess2rt_tpu_torch.ops.flagship, chess2rt_tpu_torch.render.pipeline\n"
        "import chess2rt_tpu_torch.utils.color, chess2rt_tpu_torch.utils.vec\n"
        "import chess2rt_tpu_torch.exceptions, chess2rt_tpu_torch.ops.prng\n"
        "import chess2rt_tpu_torch.ops.geometry, chess2rt_tpu_torch.app, chess2rt_tpu_torch.native\n"
        "import chess2rt_tpu_torch.scene, chess2rt_tpu_torch.scene.loader, chess2rt_tpu_torch.scene.sdlang\n"
        "import chess2rt_tpu_torch.oracle, chess2rt_tpu_torch.oracle.renderer\n"
        "import chess2rt_tpu_torch.imageio, chess2rt_tpu_torch.imageio.bmp, chess2rt_tpu_torch.imageio.bitmap\n"
        "import chess2rt_tpu_torch.imageio.buffer, chess2rt_tpu_torch.imageio.image\n"
        "import chess2rt_tpu_torch.utils.structlog, chess2rt_tpu_torch.render\n"
        "import chess2rt_tpu_torch.parallel, chess2rt_tpu_torch.grad\n"
        "import chess2rt_tpu_torch.demos.zaphod_skybox, chess2rt_tpu_torch.demos.gi_inverse\n"
        "import chess2rt_tpu_torch.demos.texture_recovery, chess2rt_tpu_torch.demos.bump_inverse\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'chess2rt_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'chess2rt_tpu' not in sys.modules\n"
        "print('clean')\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_round0_refuses_devices_without_a_kernel():
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp).to("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        R.round0(lay, prm)


def test_cuda_path_raises_without_the_toolkit():
    """The CUDA path builds and launches the kernel or raises: without
    nvcc it raises, it never runs the plain version instead."""
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present here; tests/test_torch_cuda.py covers the card")
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    before = R.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        R._round0_cuda(lay, lay.pack(tp))
    assert R.launches == before


def test_unported_forms_raise_with_their_roadmap_item():
    _, _, tp, ts = packed_pair("standin")
    lay = R.layout(ts, W, H)
    prm = lay.pack(tp)
    # the lin-input form is ported: it needs its lane count
    with pytest.raises(ValueError, match="n_lanes"):
        R.round0(lay, prm, lin_input=True)
    assert R.round0(lay, prm, lin_input=True, n_lanes=128)["win"].shape == (128,)
    # the residual forms are ported: they add their rows
    out = R.round0(lay, prm, want_hit=True, want_vis=True)
    assert {"t", "nx", "dr", "vis0", "vis1"} <= set(out)
    from chess2rt_tpu_torch.ops.round0_grad import diff_round0

    # both pin modes are ported: node mode's forward is the plain call too
    node, ref = diff_round0(lay, prm, tp, pin_mode="node"), R.round0(lay, prm)
    assert set(node) == set(ref) and all(torch.equal(node[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="pin_mode"):
        diff_round0(lay, prm, tp, pin_mode="tile")
    with pytest.raises(ValueError, match="n_lanes"):
        diff_round0(lay, prm, tp, lin_input=True)


def test_render_frame_raises_for_unported_modes():
    """What render_frame still refuses, and the modes that are ported: bump
    maps (both gates of the fused hybrid), the environment cubemap and the
    compensated ray-gen (the twin) render."""
    from chess2rt_tpu_torch.render.pipeline import render_frame
    from chess2rt_tpu_torch.scenes import bump_scene, flagship_standin

    _, _, tp, ts = packed_pair("standin")
    # GI is ported; the stand-in's mirror has no BRDF to sample, which the
    # JAX package refuses too
    with pytest.raises(NotImplementedError, match="only Lambert"):
        render_frame(tp, dataclasses.replace(ts, gi_enabled=True))
    # adaptive AA, chunk_pixels, DoF and stereo are ported: they render
    for change in ({"aa_adaptive": True}, {"chunk_pixels": 256, "aa_enabled": False},
                   {"dof": True, "dof_samples": 2, "aa_enabled": False}, {"stereo": True, "aa_enabled": False}):
        assert render_frame(tp, dataclasses.replace(ts, **change)).shape == (H, W, 3)
    # bump maps (ROADMAP item 9), the environment and the compensated
    # ray-gen (item 10) are ported: they render
    for bump_csg in (True, False):
        bp, bs = torch_pack_scene(bump_scene(TT, W, H, mirror=True, bump_csg=bump_csg, aa=False), device="cpu")
        assert bs.has_bump and R.supports(bs)
        img = render_frame(bp, bs)
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    ep, es = torch_pack_scene(flagship_standin(TT, W, H, env=True), device="cpu")
    assert es.has_env and R.supports(es)
    assert render_frame(ep, dataclasses.replace(es, aa_enabled=False)).shape == (H, W, 3)
    cs = dataclasses.replace(ts, compensated_raygen=True, aa_enabled=False)
    assert not R.supports(cs)  # the opt-in of the twin only
    assert render_frame(tp, cs).shape == (H, W, 3)
    # float64 frames are ported: the eager Whitted twin renders them
    tp64, ts64 = torch_pack_scene(scene(TT, "standin"), dtype=torch.float64, device="cpu")
    img = render_frame(tp64, dataclasses.replace(ts64, aa_enabled=False))
    assert img.dtype == torch.float64 and img.shape == (H, W, 3)


def test_color_torch_paths_match_jax_package_numpy():
    """The host modules' torch branches (the JAX package's had jnp ones)
    against the JAX package's numpy branches."""
    from chess2rt_tpu.utils import color as JC
    from chess2rt_tpu_torch.utils import color as TC

    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, (64, 3)).astype(np.float32)
    x[0] = (0.0, 1.0, np.nan)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(TC.srgb_u8(t).numpy(), JC.srgb_u8(x))
    np.testing.assert_array_equal(TC.to_rgb32(t[1:]).numpy(), JC.to_rgb32(x[1:]))
    y = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(TC.combine_stereo(t[1:], torch.from_numpy(y[1:])).numpy(),
                               JC.combine_stereo(x[1:], y[1:]), rtol=1e-6)
    np.testing.assert_array_equal(TC.too_different(t, torch.from_numpy(y)).numpy(),
                                  JC.too_different(x, y))


def test_vec_rotations_torch_match_numpy():
    from chess2rt_tpu_torch.utils import vec

    for rot in (vec.rotate_x, vec.rotate_y, vec.rotate_z):
        want = rot(0.7)
        got = rot(torch.tensor(0.7, dtype=torch.float64), xp=torch)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_entry_points_default_to_the_card_not_the_cpu(monkeypatch, tmp_path):
    """pack_scene, from_numpy and the process dryruns (run_multiprocess_
    dryrun, dryrun_multichip, the rank's command line) run on the current
    CUDA device unless the caller names another, and raise when there is no
    card, as does initialize_distributed without local_devices: they do not
    carry on on the CPU."""
    import inspect

    from chess2rt_tpu_torch.models import packed as TP

    from chess2rt_tpu_torch.models import types as TT
    from chess2rt_tpu_torch.models.packed import pack_scene
    from torch_port_cases import scene

    for fn in (pack_scene, from_numpy):
        assert inspect.signature(fn).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert TP._resolve_device(None, "pack_scene") == torch.device("cuda", 0)
    assert TP._resolve_device("cpu", "pack_scene") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jp, _, _, ts = packed_pair("standin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_scene(scene(TT, "standin"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy(jax_leaves(jp), ts)

    from chess2rt_tpu_torch.parallel import distributed, mp_dryrun

    for fn in (mp_dryrun.run_multiprocess_dryrun, mp_dryrun.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp_dryrun.worker_main(["--coordinator", "localhost:1", "--num-processes", "1", "--process-id", "0",
                               "--width", "4", "--height", "2", "--out", str(tmp_path / "rank0.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed._default_local_devices(0)
