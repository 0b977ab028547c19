"""Color pipeline: sRGB quantization, gamma decompression, stereo combine.

Bit-exact re-statement of the reference's color handling
(source/rt/color.d, source/rt/bitmap.d):

* The reference converts float colors to 8-bit via a **4097-entry cached
  sRGB LUT** built at startup (color.d:209-228).  The LUT quantizes the
  input to i = int(x * 4096) and stores `convertTo8bit_sRGB(i / 4096f)`.
  Quirk preserved on purpose: the linear segment multiplies by **12.02**
  (not the standard 12.92) — color.d:201.
* Byte rounding is `floor(x * 255.0f)` (color.d:216-219), not round().
* Texture gamma decompression (bitmap.d:116-136) uses the standard sRGB
  decode (x/12.92, ((x+.055)/1.055)^2.4) in float32.

Host numpy arrays and torch tensors go through the same LUT, so u8
comparisons are apples-to-apples.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# sRGB compression LUT (color.d:194-228)
# ---------------------------------------------------------------------------


def _build_srgb_lut() -> np.ndarray:
    i = np.arange(4097, dtype=np.float32)
    xq = (i / np.float32(4096.0)).astype(np.float32)
    # linear segment in float32 with the reference's 12.02 constant
    lin = (xq * np.float32(12.02)).astype(np.float32)
    # power segment computed in float64 then narrowed to float32, exactly as
    # D evaluates `1.055 * x^^(1/2.4) - 0.055` (double) assigned to a float
    powv = (1.055 * np.power(xq.astype(np.float64), 1.0 / 2.4) - 0.055).astype(np.float32)
    y = np.where(xq <= np.float32(0.0031308), lin, powv)
    b = np.floor(y * np.float32(255.0)).astype(np.int64)
    b = np.clip(b, 0, 255)
    # boundary branches of convertTo8bit_sRGB: x <= 0 -> 0, x >= 1 -> 255
    b = np.where(xq <= 0.0, 0, b)
    b = np.where(xq >= 1.0, 255, b)
    return b.astype(np.uint8)


SRGB_COMPRESS_LUT: np.ndarray = _build_srgb_lut()


def srgb_u8(x):
    """float [0..1] color -> uint8, via the reference's cached sRGB transform.

    Matches convertTo8bit_sRGB_Cached (color.d:209-214): x<=0 -> 0,
    x>=1 -> 255, else LUT[int(x * 4096.0f)].  Works on numpy arrays or
    torch tensors (the result stays on the tensor's device).
    """
    if isinstance(x, np.ndarray) or np.isscalar(x):
        xf = np.asarray(x, dtype=np.float32)
        idx = np.clip((xf * np.float32(4096.0)).astype(np.int32), 0, 4096)
        val = SRGB_COMPRESS_LUT[idx]
        val = np.where(xf <= 0.0, np.uint8(0), val)
        return np.where(xf >= 1.0, np.uint8(255), val)
    torch = _torch()
    xf = x.to(torch.float32)
    lut = torch.as_tensor(SRGB_COMPRESS_LUT, device=xf.device)
    # NaN -> index 0 (numpy's int cast is platform-defined there anyway)
    idx = torch.nan_to_num(xf * 4096.0, nan=0.0).clamp(0.0, 4096.0).to(torch.int64)
    val = lut[idx]
    val = torch.where(xf <= 0.0, torch.zeros_like(val), val)
    return torch.where(xf >= 1.0, torch.full_like(val, 255), val)


def to_rgb32(rgb, red_shift=16, green_shift=8, blue_shift=0):
    """Color.toRGB32 (color.d:154-162): pack sRGB-compressed bytes into u32."""
    if isinstance(rgb, np.ndarray):
        r, g, b = (srgb_u8(rgb[..., k]).astype(np.uint32) for k in range(3))
    else:
        # torch has no uint32 shifts on every device: widen to int64
        r, g, b = (srgb_u8(rgb[..., k]).to(_torch().int64) for k in range(3))
    return (b << blue_shift) | (g << green_shift) | (r << red_shift)


# ---------------------------------------------------------------------------
# Gamma decompression for texture bitmaps (bitmap.d:116-136)
# ---------------------------------------------------------------------------


def decompress_gamma_srgb(x: np.ndarray) -> np.ndarray:
    """sRGB -> linear, float32, matching Bitmap.decompressGamma_sRGB."""
    x = np.asarray(x, dtype=np.float32)
    lo = x / np.float32(12.92)
    hi = np.power((x + np.float32(0.055)) / np.float32(1.055), np.float32(2.4), dtype=np.float32)
    out = np.where(x <= np.float32(0.04045), lo, hi).astype(np.float32)
    out = np.where(x == 0.0, np.float32(0.0), out)
    out = np.where(x == 1.0, np.float32(1.0), out)
    return out


def decompress_gamma(x: np.ndarray, gamma: float) -> np.ndarray:
    """Power-law decode, matching Bitmap.decompressGamma."""
    x = np.asarray(x, dtype=np.float32)
    out = np.power(x, np.float32(gamma), dtype=np.float32)
    out = np.where(x == 0.0, np.float32(0.0), out)
    out = np.where(x == 1.0, np.float32(1.0), out)
    return out


# ---------------------------------------------------------------------------
# Stereo anaglyph + AA difference predicate (color.d:10-23, :77-83)
# ---------------------------------------------------------------------------


def adjust_saturation(rgb, amount):
    """0 = grayscale, 1 = unchanged (color.d:77-83); intensity = mean(r,g,b)."""
    mid = rgb.mean(axis=-1, keepdims=True)
    return rgb * amount + mid * (1.0 - amount)


def combine_stereo(left, right):
    """Anaglyph combine (color.d:10-15): desaturate 0.25, left->R, right->GB."""
    l = adjust_saturation(left, 0.25)
    r = adjust_saturation(right, 0.25)
    if isinstance(left, np.ndarray):
        mask_l = np.asarray([1.0, 0.0, 0.0], dtype=l.dtype)
        mask_r = np.asarray([0.0, 1.0, 1.0], dtype=r.dtype)
    else:
        mask_l = _torch().tensor([1.0, 0.0, 0.0], dtype=l.dtype, device=l.device)
        mask_r = _torch().tensor([0.0, 1.0, 1.0], dtype=r.dtype, device=r.device)
    return l * mask_l + r * mask_r


def too_different(lhs, rhs, threshold=0.1):
    """Any channel differs by more than `threshold` (color.d:18-23).

    NB: the renderer's AA-detect pass calls this with the default 0.1
    threshold; the `AAThreshold` setting is never forwarded
    (renderer.d:172) — preserved.
    """
    xp = np if isinstance(lhs, np.ndarray) else _torch()
    return xp.any(xp.abs(lhs - rhs) > threshold, axis=-1)


def _torch():
    import torch

    return torch
