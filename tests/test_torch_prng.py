"""The port's random numbers (``ops/prng.py``) against ``jax.random``, bit
for bit, and the camera's stereo and depth-of-field rays against the JAX
package's ``camera.screen_rays``.

* keys: ``PRNGKey``, ``split`` into 1, 2, 4 and 7 keys and ``fold_in`` at 0,
  1 and 2**31 - 1, over several seeds (jax 0.9's default threefry2x32 in
  its partitionable form);
* the two forms of a key derivation, threefry on Python ints
  (``_threefry_int``: a key a pass, or a split's keys in one pass) and on
  numpy arrays (``_threefry_np``, the plain version), against each other
  and ``jax.random``, at few keys and at 255-257; a split into no keys;
* ``uniform`` in f32 and, under x64, f64 over the shapes (), (7,), (3, 5)
  and (1 << 20,); a draw is positional: the full-width draw gathered at
  some lanes is what those lanes hold;
* csrc/threefry.cu's device code compiled by the host's C++ compiler
  through a small stand-in for ``cuda_runtime.h`` and run thread by
  thread, bit-equal to the plain version (the card's build is held the
  same way by chip_smoke.py phase 19);
* ``screen_rays`` with the stereo offsets, DoF from a key and DoF from
  given disc uniforms: max |d| <= 1e-6 in f32, <= 1e-12 in f64, d taken
  relative to |JAX| above magnitude 1 (tests/torch_port_cases.py
  ``lane_error``; the origins sit 165 units up);
* ``fit``'s per-step keys: ``fold_in(key, i)``, or ``key`` itself without
  ``resample_keys``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chess2rt_tpu.models import types as JT
from chess2rt_tpu.models.packed import pack_scene as jax_pack_scene
from chess2rt_tpu.ops import camera as JC
from chess2rt_tpu_torch import cuda_build
from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene as torch_pack_scene
from chess2rt_tpu_torch.ops import camera as TC
from chess2rt_tpu_torch.ops import prng
from chess2rt_tpu_torch.scenes import flagship_standin

from torch_port_cases import x64

torch.set_num_threads(2)

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
SHAPES = [(), (7,), (3, 5), (1 << 20,)]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.PRNGKey(seed)
    assert mine.dtype == np.uint32 and np.array_equal(mine, np.asarray(key))
    for num in (1, 2, 4, 7):
        assert np.array_equal(prng.split(mine, num), np.asarray(jax.random.split(key, num))), num
    for data in (0, 1, 2**31 - 1):
        assert np.array_equal(prng.fold_in(mine, data), np.asarray(jax.random.fold_in(key, data))), data
    # keys of keys: a split key folded, a folded key split
    k = prng.split(mine, 4)[3]
    assert np.array_equal(prng.split(prng.fold_in(k, 9), 3),
                          np.asarray(jax.random.split(jax.random.fold_in(jax.random.split(key, 4)[3], 9), 3)))


M32 = prng.M32
# keys of words at the ends of the 32-bit range, and of seeds above 2**32 (a
# high word); splits into the few keys the renderers take and into many
# (lanes past the 256th); fold_in's data at the ends of the 32-bit range and
# below 0 (taken mod 2**32, as fold_in takes it)
WORD_KEYS = [(0, 0), (0, M32), (M32, 0), (M32, M32)]
HIGH_SEEDS = [2**32 + 5, 2**33 + 12345, 2**63 - 1]
NUMS = [1, 2, 3, 4, 255, 256, 257]
FOLD_DATA = [0, 1, 2**31 - 1, 2**32 - 1, -3]


@pytest.mark.parametrize("words, seed", [(w, None) for w in WORD_KEYS] + [(None, s) for s in HIGH_SEEDS],
                         ids=[f"words{w}" for w in WORD_KEYS] + [f"seed{s}" for s in HIGH_SEEDS])
def test_the_two_forms_match_each_other_and_jax(words, seed):
    if seed is None:
        key = np.array(words, np.uint32)
    else:
        key = prng.PRNGKey(seed)
        with x64():
            assert np.array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    jkey = jnp.asarray(key)
    k1, k2 = (int(w) for w in key)
    for num in NUMS:
        scalar = np.array([prng._threefry_int(k1, k2, j) for j in range(num)], np.uint32)  # a key a pass
        vector = np.stack(prng._threefry_np(key, *prng._counters(num)), axis=-1)
        have = prng.split(key, num)
        assert have.dtype == np.uint32 and have.shape == (num, 2)
        assert np.array_equal(scalar, vector) and np.array_equal(have, vector), num
        assert np.array_equal(have, np.asarray(jax.random.split(jkey, num))), num
    for data in FOLD_DATA:
        x1 = data & M32
        scalar = np.array(prng._threefry_int(k1, k2, x1), np.uint32)
        vector = np.concatenate(prng._threefry_np(key, np.zeros(1, np.uint32), np.array([x1], np.uint32)))
        have = prng.fold_in(key, data)
        assert have.dtype == np.uint32 and have.shape == (2,)
        assert np.array_equal(scalar, vector) and np.array_equal(have, vector), data
        assert np.array_equal(have, np.asarray(jax.random.fold_in(jkey, x1))), data


def test_a_split_into_no_keys_is_empty():
    key = prng.PRNGKey(23)
    have = prng.split(key, 0)
    assert have.dtype == np.uint32 and have.shape == (0, 2)
    assert np.asarray(jax.random.split(jnp.asarray(key), 0)).shape == (0, 2)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_f32_matches_jax(shape):
    for seed in (0, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
        have = prng.uniform(np.asarray(key), shape, torch.float32, device="cpu")
        assert have.dtype == torch.float32 and tuple(have.shape) == shape
        assert np.array_equal(_bits(have.numpy()), _bits(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_f64_matches_jax(shape):
    with x64():
        key = jax.random.PRNGKey(3)
        want = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float64))
        assert np.array_equal(prng.PRNGKey(3), np.asarray(key))
    have = prng.uniform(prng.PRNGKey(3), shape, torch.float64, device="cpu")
    assert have.dtype == torch.float64
    assert np.array_equal(_bits(have.numpy()), _bits(want))


def test_draw_is_positional():
    """uniform(k, (n,))[sel] is what JAX's full-width draw holds at sel, and
    a shaped draw is the flat draw reshaped."""
    key = prng.split(prng.PRNGKey(11), 3)[2]
    n = 5000
    sel = torch.from_numpy(np.random.default_rng(0).choice(n, 300, replace=False))
    full = prng.uniform(key, (n,), device="cpu")
    want = np.asarray(jax.random.uniform(jnp.asarray(key), (n,), dtype=jnp.float32))[sel.numpy()]
    assert np.array_equal(_bits(full[sel].numpy()), _bits(want))
    assert torch.equal(prng.uniform(key, (50, 100), device="cpu").reshape(-1), full)


def test_as_key_and_the_device_rules():
    assert np.array_equal(prng.as_key(None), prng.PRNGKey(0))
    assert np.array_equal(prng.as_key(jax.random.PRNGKey(4)), prng.PRNGKey(4))
    with pytest.raises(ValueError):
        prng.as_key(np.zeros(3, np.uint32))
    with pytest.raises(TypeError):
        prng.uniform(prng.PRNGKey(0), (3,), torch.float16, device="cpu")
    with pytest.raises(RuntimeError, match="no kernel"):
        prng.uniform(prng.PRNGKey(0), (3,), device="meta")


# --------------------------------------------------------------------------
# csrc/threefry.cu's device code on the CPU
# --------------------------------------------------------------------------

SHIM = r"""
#pragma once
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

HARNESS = r"""
}  // namespace
extern "C" void host_uniform(unsigned k1, unsigned k2, long long n, void* out, int f64) {
  for (long long b = 0; b * BLOCK < n; ++b)
    for (unsigned t = 0; t < (unsigned)BLOCK; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = t;
      if (f64)
        uniform_kernel<double>(k1, k2, n, static_cast<double*>(out));
      else
        uniform_kernel<float>(k1, k2, n, static_cast<float*>(out));
    }
}
"""


@pytest.fixture(scope="module")
def host_uniform(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("threefry_host")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    text = (Path(cuda_build.__file__).parent / "csrc" / cuda_build.SOURCES["threefry"][0]).read_text()
    (tmp / "threefry_host.cpp").write_text(text[: text.index("// ---- host side")] + HARNESS)
    lib = tmp / "libthreefry_host.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{tmp}",
                          f"-I{Path(cuda_build.__file__).parent / 'csrc'}", "-o", str(lib),
                          str(tmp / "threefry_host.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    fn = ctypes.CDLL(str(lib)).host_uniform
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_threefry_device_code_matches_plain_version(host_uniform, dtype):
    cases = ((1, prng.PRNGKey(0)), (257, prng.fold_in(prng.PRNGKey(9), 2)), (4099, prng.split(prng.PRNGKey(1))[1]))
    for n, key in cases:
        out = torch.full((n,), float("nan"), dtype=dtype)
        host_uniform(int(key[0]), int(key[1]), n, out.data_ptr(), int(dtype == torch.float64))
        ref = prng.uniform_reference(key, (n,), dtype, device="cpu")
        assert np.array_equal(_bits(out.numpy()), _bits(ref.numpy())), n


# --------------------------------------------------------------------------
# The camera: stereo and depth of field
# --------------------------------------------------------------------------


def _cameras(dtype):
    def sc(T):
        return flagship_standin(T, 32, 24, dof=True, stereo=True)

    jp, _ = jax_pack_scene(sc(JT), dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    tp, _ = torch_pack_scene(sc(TT), dtype=dtype, device="cpu")
    return jp.camera, tp.camera


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["stereo_left", "stereo_right", "dof_key", "dof_disc_uv", "dof_stereo"])
def test_screen_rays_match_jax(case, dtype):
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    npdt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(len(case))
    x, y = rng.uniform(0, 32, 300).astype(npdt), rng.uniform(0, 24, 300).astype(npdt)
    stereo = {"stereo_left": -1.0, "stereo_right": 1.0, "dof_stereo": 1.0}.get(case, 0.0)
    dof = case.startswith("dof")
    key = prng.fold_in(prng.PRNGKey(13), len(case))
    with x64(dtype == torch.float64):
        jcam, tcam = _cameras(dtype)
        jf, tf = JC.begin_frame(jcam, 32 / 24), TC.begin_frame(tcam, 32 / 24)
        if case == "dof_disc_uv":
            uv = rng.uniform(size=(2, 300)).astype(npdt)
            jo, jd = JC.screen_rays(jcam, jf, 32.0, 24.0, jnp.asarray(x), jnp.asarray(y), stereo, dof=True,
                                    disc_uv=(jnp.asarray(uv[0]), jnp.asarray(uv[1])))
            to, td = TC.screen_rays(tcam, tf, 32.0, 24.0, torch.from_numpy(x), torch.from_numpy(y), stereo, dof=True,
                                    disc_uv=(torch.from_numpy(uv[0]), torch.from_numpy(uv[1])))
        else:
            jo, jd = JC.screen_rays(jcam, jf, 32.0, 24.0, jnp.asarray(x), jnp.asarray(y), stereo, dof=dof,
                                    key=jnp.asarray(key))
            to, td = TC.screen_rays(tcam, tf, 32.0, 24.0, torch.from_numpy(x), torch.from_numpy(y), stereo, dof=dof,
                                    key=key)
        jo, jd = np.asarray(jo), np.asarray(jd)
    assert to.dtype == dtype and jo.dtype == npdt
    # d relative to |JAX| above magnitude 1, the repo's d: origins sit 165 units up, where an f32 ulp is 1.5e-5
    assert (np.abs(to.numpy() - jo) / np.maximum(np.abs(jo), 1.0)).max() <= tol
    assert np.abs(td.numpy() - jd).max() <= tol
    if stereo:  # the eye moved off the camera's position
        assert np.abs(to.numpy() - tcam.pos.numpy()).max() > 1.0


def test_fit_keys_follow_jax_fold_in(monkeypatch):
    """``fit`` renders step i with fold_in(key, i), JAX's sequence
    (chess2rt_tpu/grad/inverse.py), or with ``key`` every step when
    ``resample_keys`` is off."""
    from chess2rt_tpu_torch.grad import InverseProblem, fit
    from chess2rt_tpu_torch.grad import inverse as I

    seen = []
    real = I.render_frame

    def recording(packed, static, key=None):
        seen.append(np.array(key))
        return real(packed, static, key)

    monkeypatch.setattr(I, "render_frame", recording)
    tp, ts = torch_pack_scene(flagship_standin(TT, 8, 6), device="cpu")
    ts = dataclasses.replace(ts, aa_enabled=False)
    target = torch.zeros((6, 8, 3))
    jkey = jax.random.PRNGKey(17)
    for resample in (True, False):
        seen.clear()
        fit(tp, InverseProblem(static=ts, target=target, steps=3, resample_keys=resample), key=prng.PRNGKey(17))
        want = [np.asarray(jax.random.fold_in(jkey, i) if resample else jkey) for i in range(3)]
        assert [k.tolist() for k in seen] == [w.tolist() for w in want]
