"""BMP codec, byte-compatible with the reference's imageio/bmp.d.

Loader (loadBmpImpl, bmp.d:60-193):
  * BITMAPCOREHEADER (12) through BITMAPV5INFOHEADER (124) DIB headers.
  * 1/2/4/8 bpp palettized, 24 bpp BGR, 32 bpp BGRA.
  * Scanlines are stored bottom-up (positive height): the first row in the
    file is the bottom row of the image.  Rows are padded to 4 bytes.
  * Pixels are packed as u32 `a<<24 | r<<16 | g<<8 | b` exactly like
    `WinPaletteElement.opCast!uint` (bmp.d:415-421); 24-bpp pixels have no
    alpha contribution.

Writer (saveBmp, bmp.d:195-237):
  * Always 24-bpp with a BITMAPINFOHEADER (V1), 72 DPI (2835 ppm).
  * Quirk preserved: the reference writer emits **no row padding** and its
    fileSize field also excludes padding.  For frame widths that are a
    multiple of 4 (every multiple-of-4 width, incl. 640) the output is also
    spec-valid; `pad_rows=True` opts into spec-compliant padding.
  * Color floats are converted with the cached-sRGB-LUT transform
    (Color.toRGB32, color.d:154-162) — see utils/color.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..utils.color import srgb_u8
from .buffer import Buffer
from .image import Image, image_from_2d

_FILE_HEADER = struct.Struct("<2sIHHI")  # signature, fileSize, res1, res2, offsetToPixelArray

# DIB header sizes (bmp.d DIBVersion)
V0, V1, V2, V3, V4, V5 = 12, 40, 52, 56, 108, 124
_SUPPORTED_VERSIONS = (V0, V1, V2, V3, V4, V5)


@dataclass
class DibHeader:
    version: int = V1
    width: int = 0
    height: int = 0
    color_planes: int = 1
    bpp: int = 24
    compression: int = 0
    size_of_pixel_array: int = 0
    ppm_x: int = 0
    ppm_y: int = 0
    colors_used: int = 0
    colors_important: int = 0
    bit_masks: tuple = (0, 0, 0, 0)  # r, g, b, a
    color_space_type: bytes = b"\x00\x00\x00\x00"
    color_space_endpoints: tuple = (0,) * 9
    gamma: tuple = (0, 0, 0)
    intent: int = 0
    profile_data: int = 0
    profile_size: int = 0
    reserved: int = 0


@dataclass
class BmpImage:
    """Decoded BMP: u32 pixels `[h, w]` with y=0 at the top of the image."""

    file_size: int = 0
    offset_to_pixel_array: int = 0
    dib: DibHeader = field(default_factory=DibHeader)
    pixels_u32: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.uint32))

    @property
    def width(self) -> int:
        return self.pixels_u32.shape[1]

    @property
    def height(self) -> int:
        return self.pixels_u32.shape[0]

    @property
    def image(self) -> Image:
        """The decoded pixels as the reference's 2-D container
        (``Image!uint``, image.d:18-60) — zero-copy view."""
        return image_from_2d(self.pixels_u32)

    def to_float_rgb(self) -> np.ndarray:
        """u32 pixels -> float32 `[h, w, 3]` rgb in [0, 1]: convertTo
        (image.d:3-16) with the Color(uint) converter (color.d:60-66)."""

        def to_color(p):
            r = ((p >> 16) & 0xFF).astype(np.float32)
            g = ((p >> 8) & 0xFF).astype(np.float32)
            b = (p & 0xFF).astype(np.float32)
            return np.stack([r, g, b], axis=-1) * np.float32(1.0 / 255.0)

        return self.image.convert_to(to_color).as_2d()


def load_bmp(data: bytes) -> BmpImage:
    # header parsing streams through the reference's buffer container
    # (UntypedBuffer reads that advance the window, bmp.d:60-91)
    buf = Buffer(wrap=data)
    signature, file_size, _r1, _r2, offset = buf.read("<2sIHHI")
    if signature != b"BM":
        raise ValueError("Only files beginning with 'BM' are supported!")

    version = buf.read("<i")
    if version not in _SUPPORTED_VERSIONS:
        raise ValueError(f"Unsupported DIB header size: {version}")

    dib = DibHeader(version=version)
    if version == V0:
        dib.width, dib.height, dib.color_planes, dib.bpp = buf.read("<hhHH")
    else:
        (
            dib.width,
            dib.height,
            dib.color_planes,
            dib.bpp,
            dib.compression,
            dib.size_of_pixel_array,
            dib.ppm_x,
            dib.ppm_y,
            dib.colors_used,
            dib.colors_important,
        ) = buf.read("<iiHHIIiiII")
    if version >= V2:
        masks = list(buf.read("<III"))
        if version >= V3:
            masks.append(buf.read("<I"))
        else:
            masks.append(0)
        dib.bit_masks = tuple(masks)
    if version >= V4:
        dib.color_space_type = buf.read_array(4)
        dib.color_space_endpoints = buf.read("<9i")
        dib.gamma = buf.read("<III")
    if version >= V5:
        dib.intent, dib.profile_data, dib.profile_size, dib.reserved = buf.read("<IIII")

    if dib.color_planes != 1:
        raise ValueError(f"Only .bmp files with 1 color plane are supported. Not: {dib.color_planes}")
    if dib.bpp not in (1, 2, 4, 8, 16, 24, 32, 64):
        raise ValueError(f"Unsupported bpp: {dib.bpp}")

    # Palette (only used for indexing at <= 8 bpp; bmp.d:92-115)
    palette = None
    if dib.bpp in (1, 2, 4, 8):
        if version == V0:
            palette_size = 2**dib.bpp
            entry_size = 3
        else:
            palette_size = dib.colors_used if dib.colors_used else 2**dib.bpp
            entry_size = 4
        raw = np.frombuffer(buf.read_array(palette_size * entry_size), np.uint8).reshape(
            palette_size, entry_size
        )
        bgr = raw[:, :3].astype(np.uint32)
        a = raw[:, 3].astype(np.uint32) if entry_size == 4 else np.zeros(palette_size, np.uint32)
        palette = bgr[:, 0] | (bgr[:, 1] << 8) | (bgr[:, 2] << 16) | (a << 24)

    w, h = dib.width, dib.height
    if h < 0:
        raise ValueError("Top-down BMPs are not supported (matches the reference loader)")
    row_padded = ((dib.bpp * w + 31) // 32) * 4

    img = BmpImage(file_size=file_size, offset_to_pixel_array=offset, dib=dib)
    rows = np.frombuffer(data, np.uint8, count=row_padded * h, offset=offset).reshape(h, row_padded)
    # first file row is the image's bottom row -> flip so y=0 is top
    rows = rows[::-1]

    if dib.bpp == 24:
        px = rows[:, : w * 3].reshape(h, w, 3).astype(np.uint32)
        img.pixels_u32 = px[:, :, 0] | (px[:, :, 1] << 8) | (px[:, :, 2] << 16)
    elif dib.bpp == 32:
        px = rows[:, : w * 4].reshape(h, w, 4).astype(np.uint32)
        img.pixels_u32 = px[:, :, 0] | (px[:, :, 1] << 8) | (px[:, :, 2] << 16) | (px[:, :, 3] << 24)
    elif dib.bpp <= 8:
        # Unpacks bpp-sized fields MSB-first within each byte, like the
        # reference (bmp.d:168-187) — but with sane stream handling.  The
        # reference reads `width` *bytes* per row (readArray!ubyte(width))
        # with no padding skip, and writes the unpacked pixels to
        # x = i*(8/bpp)..: for bpp == 8 with width % 4 == 0 (e.g. the
        # data/bmp_test 1920x1080 fixture) that is coincidentally correct,
        # but for bpp < 8 it over-consumes the stream 8/bpp-fold and writes
        # past the scanline slice (out-of-bounds in a release build, a
        # RangeError otherwise) — the reference cannot actually load its own
        # 1/4-bpp fixtures.  We read ceil(width/(8/bpp)) bytes per padded
        # row instead; behavior is identical wherever the reference's is
        # well-defined (tests/test_bmp.py::test_bmp_test_fixtures).
        bpp = dib.bpp
        per_byte = 8 // bpp
        mask = (1 << bpp) - 1
        packed = rows[:, : (w + per_byte - 1) // per_byte]
        shifts = np.arange(per_byte - 1, -1, -1, dtype=np.uint8) * bpp
        idx = (packed[:, :, None] >> shifts[None, None, :]) & mask
        idx = idx.reshape(h, -1)[:, :w]
        img.pixels_u32 = palette[idx]
    else:
        raise ValueError(f"bpp {dib.bpp} not implemented (matches the reference loader)")

    return img


def load_bmp_file(path: str) -> BmpImage:
    with open(path, "rb") as f:
        return load_bmp(f.read())


def _dpi_to_ppm(dpi: float) -> int:
    # bmp.d dpiToPPM: lrint(dpi * 100 / 2.54)
    import math

    v = dpi * 100.0 / 2.54
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def save_bmp(rgb: np.ndarray, pad_rows: bool = False, use_native: bool = True) -> bytes:
    """Encode float32 rgb `[h, w, 3]` (y=0 top) as a 24-bpp V1 BMP.

    Byte-for-byte identical to the reference saveBmp (bmp.d:195-237) when
    `pad_rows=False` (its default behavior: no scanline padding).

    Uses the native C++ encoder (native/framebuffer.cpp) when available —
    byte-identical output, asserted by tests/test_native.py — with this
    numpy implementation as the fallback/oracle.
    """
    rgb = np.asarray(rgb)
    if use_native:
        from ..native import bmp_encode

        encoded = bmp_encode(rgb, pad_rows=pad_rows)
        if encoded is not None:
            return encoded
    h, w = rgb.shape[:2]
    row_bytes = w * 3
    pad = (-row_bytes) % 4 if pad_rows else 0
    file_size = 14 + 40 + (row_bytes + pad) * h

    # assembled through the reference's growable buffer (UntypedBuffer
    # writes with doubling growth, bmp.d:195-237 + buffer.d:170-186)
    out = Buffer()
    out.write_struct("<2sIHHI", b"BM", file_size, 0, 0, 14 + 40)
    ppm = _dpi_to_ppm(72.0)
    out.write_struct("<iiiHHIIiiII", 40, w, h, 1, 24, 0, file_size - 54, ppm, ppm, 0, 0)

    r = srgb_u8(rgb[..., 0])
    g = srgb_u8(rgb[..., 1])
    b = srgb_u8(rgb[..., 2])
    rows = np.stack([b, g, r], axis=-1).reshape(h, row_bytes)  # BGR byte order
    if pad:
        rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], axis=1)
    out.write(rows[::-1].tobytes())  # bottom-up scanlines
    return bytes(out)


def save_bmp_file(path: str, rgb: np.ndarray, pad_rows: bool = False) -> None:
    with open(path, "wb") as f:
        f.write(save_bmp(rgb, pad_rows=pad_rows))
