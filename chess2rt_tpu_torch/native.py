"""ctypes bridge to the native C++ framebuffer codec (native/framebuffer.cpp).

Copy of chess2rt_tpu/native.py for the port.  It compiles the repository's
``native/framebuffer.cpp`` on first use (g++ -O3) into the port's
git-ignored ``chess2rt_tpu_torch/build/``, never into ``native/``; every
entry point falls back to the pure-numpy implementation when the toolchain
or build is unavailable, and tests/test_torch_scene_io.py holds the two
paths byte-equal.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native")
_BUILD = os.path.join(_HERE, "build")
_LIB_PATH = os.path.join(_BUILD, "libc2rt_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    src = os.path.join(_SRC, "framebuffer.cpp")
    if not os.path.exists(src):
        return False
    # one temporary name per process: concurrent first uses (test workers)
    # each build their own and the last atomic rename wins
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = os.path.join(_SRC, "framebuffer.cpp")
        stale = (
            os.path.exists(_LIB_PATH)
            and os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
        )
        if not os.path.exists(_LIB_PATH) or stale:
            _build()  # on failure a still-present (stale) lib is kept
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.c2rt_srgb_quantize.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
            ]
            lib.c2rt_bmp_size.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
            lib.c2rt_bmp_size.restype = ctypes.c_int64
            lib.c2rt_bmp_encode.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.c2rt_bmp_encode.restype = ctypes.c_int64
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def srgb_quantize(rgb: np.ndarray) -> np.ndarray | None:
    """float [...,3] -> u8, via native code; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(rgb, dtype=np.float32)
    out = np.empty(flat.size, dtype=np.uint8)
    lib.c2rt_srgb_quantize(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flat.size // 3,
    )
    return out.reshape(flat.shape)


def bmp_encode(rgb: np.ndarray, pad_rows: bool = False) -> bytes | None:
    """float [h, w, 3] -> BMP bytes via native code; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(rgb, dtype=np.float32)
    h, w = img.shape[:2]
    cap = lib.c2rt_bmp_size(w, h, int(pad_rows))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.c2rt_bmp_encode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w,
        h,
        int(pad_rows),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:n].tobytes()
