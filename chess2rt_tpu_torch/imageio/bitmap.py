"""Bitmap facade: extension-dispatched image load/save + image utilities
(reference rt/bitmap.d).

The BMP paths delegate to the byte-compatible codec in bmp.py; EXR mirrors
the reference's explicit not-implemented stubs (bitmap.d:170-178 throw
NotImplementedException).  `differentiate` is the finite-difference
height->(dx, dy) map intended for bump mapping (bitmap.d:139-154) — the
reference ships no concrete bump texture (its modifyNormal hook is a
no-op, texture.d:10-12), so this utility is the building block a future
bump extension consumes.
"""

from __future__ import annotations

import os

import numpy as np

from ..exceptions import NotImplementedException, UnknownImageTypeException
from .bmp import load_bmp_file, save_bmp_file


def load_exr(path_or_bytes):
    """Parity stub (bitmap.d:170-173)."""
    raise NotImplementedException("EXR loading is not implemented")


def save_exr(img, path=None):
    """Parity stub (bitmap.d:175-178)."""
    raise NotImplementedException("EXR saving is not implemented")


def load_image(path: str) -> np.ndarray:
    """Extension dispatch (bitmap.d:65-80) -> float32 [h, w, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        return load_bmp_file(path).to_float_rgb()
    if ext == ".exr":
        return load_exr(path)
    raise UnknownImageTypeException(ext)


def save_image(path: str, rgb: np.ndarray) -> None:
    """Extension dispatch (bitmap.d:83-103)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        return save_bmp_file(path, rgb)
    if ext == ".exr":
        return save_exr(rgb, path)
    raise UnknownImageTypeException(ext)


def intensity(rgb: np.ndarray) -> np.ndarray:
    """(r+g+b)/3, the reference Color.intensity (color.d:141-144)."""
    return rgb.mean(axis=-1)


def differentiate(rgb: np.ndarray) -> np.ndarray:
    """Finite-difference derivative map: red = d(intensity)/dx,
    green = d/dy, blue = 0, with wrap-around neighbours (bitmap.d:139-154:
    me - right, me - bottom)."""
    lum = intensity(np.asarray(rgb, dtype=np.float32))
    right = np.roll(lum, -1, axis=1)
    bottom = np.roll(lum, -1, axis=0)
    out = np.zeros(lum.shape + (3,), dtype=np.float32)
    out[..., 0] = lum - right
    out[..., 1] = lum - bottom
    return out
