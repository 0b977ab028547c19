"""Builds the hand-written CUDA kernels (csrc/) with nvcc and binds them
with ctypes.

The pattern of chess2rt_tpu/native.py without its numpy fallback: each
library is built at first use into ``build/``, named by a hash of its
source and its flags, and loaded once per process.  A source can give
several libraries: the stage probes (K3) are csrc/round0.cu compiled with
``-DC2RT_STAGE=k``.  A library's name hashes its source, the headers of
csrc/ (``threefry.cuh``) and its flags.  The missing libraries are built
together, one ``nvcc`` per library, all started at once.  Nothing is built
or loaded at import time.  A missing
``nvcc`` or a failed build raises: there is no CUDA path without the kernel.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` (a plain C interface, so no PyTorch headers and no
ninja).  No ``--use_fast_math``: it changes division, sqrt and sin, and
moves knife-edge winners.  csrc/gi_bounce.cu and csrc/combine.cu add
``-fmad=false``: they mirror torch glue whose every op is a kernel of its
own, so no product is fused into an add there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# the stage probes of K1 (ops/round0_probe.py), by C2RT_STAGE value
STAGES = {"empty": 1, "raygen": 2, "scan": 3, "shadow": 4}
# library name -> (its source in csrc/, its own flags)
SOURCES = {
    "round0": ("round0.cu", ()),
    "texel_hist": ("texel_hist.cu", ()),
    "threefry": ("threefry.cu", ()),
    "gi_bounce": ("gi_bounce.cu", ("-fmad=false",)),
    "combine": ("combine.cu", ("-fmad=false",)),
    **{f"round0_{stage}": ("round0.cu", (f"-DC2RT_STAGE={k}",)) for stage, k in STAGES.items()},
}
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# exported C functions of each library: (name, argtypes, restype)
_ROUND0_EXPORTS = (
    ("c2rt_round0", [_vp, _vp, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp], _ci),
    ("c2rt_program_version", [], _ci),
    ("c2rt_stage", [], _ci),
    ("c2rt_error_string", [_ci], ctypes.c_char_p),
)
_EXPORTS = {
    "round0": _ROUND0_EXPORTS,
    **{f"round0_{stage}": _ROUND0_EXPORTS for stage in STAGES},
    "texel_hist": (
        ("c2rt_texel_hist", [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp], _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
    "threefry": (
        ("c2rt_uniform", [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, _vp, _ci, _vp], _ci),
        ("c2rt_uniform_keys", [_vp, _ci, ctypes.c_longlong, _vp, _ci, _vp], _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
    "gi_bounce": (
        ("c2rt_gi_bounce", [_vp, _vp, _ci, ctypes.c_longlong, _vp, ctypes.c_longlong, _vp, ctypes.c_float, _ci, _vp],
         _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
    "combine": (
        ("c2rt_combine", [_vp, _ci, _vp, _ci, _vp, ctypes.c_longlong, _vp, _vp, _vp, _ci, _vp], _ci),
        ("c2rt_error_string", [_ci], ctypes.c_char_p),
    ),
}

_lock = threading.Lock()
_libs = {}
# wall seconds of this process's parallel build (0.0 when every library was
# already on disk), and nvcc's -Xptxas -v report (registers, stack, spills)
# per library built by this process (every build also leaves it on disk)
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
    source, flags = SOURCES[name]
    h = hashlib.sha256()
    for part in (source, *sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))):
        with open(os.path.join(_CSRC, part), "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + flags).encode())
    return os.path.join(BUILD_DIR, f"libc2rt_{name}_{h.hexdigest()[:16]}.so")


def _build_missing() -> None:
    """Build every library not yet on disk, one nvcc per library, in parallel."""
    global build_seconds
    missing = [k for k in SOURCES if not os.path.exists(_lib_path(k))]
    if not missing:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for k in missing:
        tmp = f"{_lib_path(k)}.{os.getpid()}.tmp"
        source, flags = SOURCES[k]
        cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *flags, "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, source)]
        procs[k] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for k, (tmp, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k} ({SOURCES[k][0]}, {proc.returncode}):\n{err[-4000:]}")
            continue
        with open(_lib_path(k) + ".ptxas", "w") as f:
            f.write(err)
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


def launch(name: str, symbol: str, device, *args) -> None:
    """Call ``symbol`` of library ``name`` (built and loaded on first use)
    with ``args`` and the current stream of the CUDA ``device`` appended,
    that device current; a non-zero return raises with the library's error
    string.  Every kernel wrapper launches through here."""
    with torch.cuda.device(device):
        err = getattr(load(name), symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}.{symbol}: kernel launch failed: {error_string(name, err)}")


def ptxas_usage(name: str):
    """(registers, stack bytes, spill store bytes, spill load bytes) of
    library ``name``, the largest over its kernels, from nvcc's report at
    its build (kept beside the library); None when there is no report."""
    import re

    text = build_log.get(name)
    if not text and os.path.exists(_lib_path(name) + ".ptxas"):
        with open(_lib_path(name) + ".ptxas") as f:
            text = f.read()
    if not text:
        return None
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", text)]
    st = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
    ld = [int(x) for x in re.findall(r"(\d+) bytes spill loads", text)]
    return max(regs, default=0), max(stack, default=0), max(st, default=0), max(ld, default=0)
