"""Builds the hand-written CUDA kernels (csrc/) with nvcc and binds them
with ctypes.

The pattern of chess2rt_tpu/native.py without its numpy fallback: each
source is built at first use into its own shared library in ``build/``,
named by a hash of that source and the flags, and loaded once per process.
The missing libraries are built together, one ``nvcc`` per source, all
started at once.  Nothing is built or loaded at import time.  A missing
``nvcc`` or a failed build raises: there is no CUDA path without the kernel.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` (a plain C interface, so no PyTorch headers and no
ninja).  No ``--use_fast_math``: it changes division, sqrt and sin, and
moves knife-edge winners.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# kernel name -> its source in csrc/
SOURCES = {"round0": "round0.cu", "texel_hist": "texel_hist.cu"}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# exported C functions of each library: (name, argtypes, restype)
_EXPORTS = {
    "round0": (
        ("c2rt_round0", [_vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp], _ci),
        ("c2rt_program_version", [], _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
    "texel_hist": (
        ("c2rt_texel_hist", [_vp, _vp, _vp, _ci, _ci, _ci, _vp], _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
}

_lock = threading.Lock()
_libs = {}
# wall seconds of this process's parallel build (0.0 when every library was
# already on disk), and nvcc's -Xptxas -v report (registers, stack, spills)
# per kernel
build_seconds = 0.0
build_log = {}


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cuda_build: nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libc2rt_{name}_{h.hexdigest()[:16]}.so")


def _build_missing() -> None:
    """Build every library not yet on disk, one nvcc per source, in parallel."""
    global build_seconds
    missing = [k for k in SOURCES if not os.path.exists(_lib_path(k))]
    if not missing:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for k in missing:
        tmp = f"{_lib_path(k)}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, SOURCES[k])]
        procs[k] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for k, (tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[k]} ({proc.returncode}):\n{err[-4000:]}")
            continue
        os.replace(tmp, _lib_path(k))
        build_log[k] = err
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("cuda_build: nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name`` (every missing one is built on
    first use) with its argtypes set."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _build_missing()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes, restype in _EXPORTS[name]:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


def load_all() -> None:
    """Build (in parallel) and load every kernel's library."""
    for name in SOURCES:
        load(name)


def error_string(name: str, err: int) -> str:
    return f"{err} ({load(name).c2rt_error_string(err).decode()})"
