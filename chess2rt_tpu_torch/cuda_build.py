"""Builds the hand-written CUDA kernels (csrc/) with nvcc and binds them
with ctypes.

The pattern of chess2rt_tpu/native.py without its numpy fallback: the
shared library is built at first use into ``build/``, named by a hash of
the sources and the flags, and loaded once per process.  Nothing is built
or loaded at import time.  A missing ``nvcc`` or a failed build raises:
there is no CUDA path without the kernel.

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
SOURCES = ("round0.cu",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
# seconds the build took in this process (0.0 when the library was already
# on disk), and nvcc's -Xptxas -v report of registers and spills
build_seconds = 0.0
build_log = ""


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cuda_build: nvcc not found (set CUDA_HOME)")
    return found


def _lib_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libc2rt_cuda_{h.hexdigest()[:16]}.so")


def _build(path: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, "-Xptxas", "-v", "-o", tmp]
    cmd += [os.path.join(_CSRC, name) for name in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"cuda_build: nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, path)
    return res.stderr


def load() -> ctypes.CDLL:
    """The kernels' shared library (built on first use) with argtypes set."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        t0 = time.perf_counter()
        if not os.path.exists(path):
            build_log = _build(path)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.c2rt_round0.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.c2rt_round0.restype = ci
        lib.c2rt_program_version.argtypes = []
        lib.c2rt_program_version.restype = ci
        lib.c2rt_error_string.argtypes = [ci]
        lib.c2rt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def error_string(err: int) -> str:
    return f"{err} ({load().c2rt_error_string(err).decode()})"
