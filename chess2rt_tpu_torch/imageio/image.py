"""2-D pixel container (reference ``imageio/image.d:18-60``).

``Image`` reproduces the reference's container surface — width/height over
a FLAT pixel array, (x, y) indexing through scanlines, capacity-reusing
``alloc``, ``empty`` — plus the free-function ``convertTo`` as
:meth:`Image.convert_to`.  Storage is a numpy array (the idiomatic flat
``C[]``), so it interoperates zero-copy with the device pipeline and the
BMP codec, which hands decoded u32 pixels out as an ``Image``
(`imageio/bmp.py` ``BmpImage.image``).
"""

from __future__ import annotations

import numpy as np


class Image:
    """``Image!C``: width, height, flat ``pixels`` (image.d:18-60)."""

    def __init__(self, width: int = 0, height: int = 0, dtype=np.uint32):
        self.width = 0
        self.height = 0
        self.pixels = np.empty(0, dtype)
        if width and height:
            self.alloc(width, height)

    # aliases (image.d:24-25)
    @property
    def w(self) -> int:
        return self.width

    @property
    def h(self) -> int:
        return self.height

    def alloc(self, width: int, height: int) -> None:
        """Resize, REUSING the backing store when it is already large
        enough (image.d:33-42) — the GUI resize path reallocates through
        this on window-size changes."""
        self.width = width
        self.height = height
        if self.pixels.size < width * height:
            self.pixels = np.empty(width * height, self.pixels.dtype)

    def __getitem__(self, xy):
        x, y = xy
        return self.scanline(y)[x]

    def __setitem__(self, xy, value):
        x, y = xy
        self.scanline(y)[x] = value

    def scanline(self, y: int) -> np.ndarray:
        """Row view (image.d:49-53): mutating it mutates the image."""
        assert 0 <= y < self.height
        return self.pixels[self.width * y : self.width * (y + 1)]

    @property
    def empty(self) -> bool:
        return self.pixels.size == 0

    def as_2d(self) -> np.ndarray:
        """[h, w(, c)] view of the live region (channel dims preserved)."""
        return self.pixels[: self.width * self.height].reshape(
            self.height, self.width, *self.pixels.shape[1:]
        )

    def convert_to(self, converter_or_dtype) -> "Image":
        """``convertTo!(To)`` (image.d:3-16): a new Image with every pixel
        converted — pass a numpy dtype for a cast, or a callable applied
        to the pixel array."""
        out = Image()
        if callable(converter_or_dtype) and not isinstance(converter_or_dtype, type):
            px = converter_or_dtype(self.as_2d())
            px = np.asarray(px)
            out.pixels = px.reshape(-1, *px.shape[2:])
        else:
            out.pixels = self.pixels[: self.width * self.height].astype(converter_or_dtype)
        out.width = self.width
        out.height = self.height
        return out


def image_from_2d(arr_2d: np.ndarray) -> Image:
    """Wrap an existing [h, w(, c)] array as an Image (zero-copy)."""
    img = Image()
    img.height, img.width = arr_2d.shape[:2]
    img.pixels = arr_2d.reshape(arr_2d.shape[0] * arr_2d.shape[1], *arr_2d.shape[2:])
    return img
