"""GuiDemo parity: the toy radial-gradient circle and ARGB pixel helpers
(reference gui/gui_demo.d).

The reference's GuiDemo is an SDL toy drawing a noisy radial gradient
(yellow core, green->pink beams, purple background — gui_demo.d:64-118)
and pulsing its size; here `draw_circle` renders the same picture into a
float RGB array (vectorized) and `demo_frames` yields the pulse animation.
ARGB reproduces the packed-pixel struct (gui_demo.d:245-260).
"""

from __future__ import annotations

import numpy as np

# NamedColors used by the demo (rt/color.d:233-244; 8-bit ctor /255)
RED = np.array([1.0, 0.0, 0.0], np.float32)
PURPLE = np.array([188, 94, 235], np.float32) / 255.0
YELLOW = np.array([1.0, 1.0, 0.0], np.float32)
GREEN = np.array([0.0, 1.0, 0.0], np.float32)
PINK = np.array([255, 87, 165], np.float32) / 255.0

DIRS = 360 * 10
BEAM_WIDTH = 40
BEAM_LENGTH = 40.0


def draw_circle(width: int, height: int, diameter_to_width_ratio: float = 0.5, seed: int = 0):
    """Float [h, w, 3] version of drawCircle (gui_demo.d:64-118): yellow
    disc, jagged green->pink gradient beams, purple outside."""
    rng = np.random.default_rng(seed)
    radius = diameter_to_width_ratio * min(width, height) / 2
    cx, cy = width / 2, height / 2

    # per-direction random beam lengths in BEAM_WIDTH chunks (gui_demo.d:82-83)
    n_chunks = -(-DIRS // BEAM_WIDTH)
    beams = np.repeat(rng.uniform(0.0, BEAM_LENGTH, size=n_chunks), BEAM_WIDTH)[:DIRS]

    ys, xs = np.mgrid[0:height, 0:width]
    dx = cx - xs
    dy = ys - cy
    dist = np.sqrt(dx * dx + dy * dy)
    tan = np.arctan2(dy, dx)
    idx = ((DIRS - 1) * (tan + np.pi) / (2 * np.pi)).astype(np.int64)
    edge = beams[np.clip(idx, 0, DIRS - 1)]
    delta = dist - radius

    t = np.clip(np.where(edge > 0, delta / np.where(edge > 0, edge, 1.0), 1.0), 0.0, 1.0)[..., None]
    beam_color = GREEN + (PINK - GREEN) * t
    out = np.where((delta < edge)[..., None], beam_color, PURPLE[None, None])
    out = np.where((dist < radius)[..., None], YELLOW[None, None], out)
    return out.astype(np.float32)


def demo_frames(width: int, height: int, n: int = 60, speed: float = 0.005, size0: float = 0.5):
    """The pulsing-size update loop (gui_demo.d:38-46): size bounces in
    [0, 1] at `speed` per frame; yields (size, frame) pairs."""
    size, v = size0, speed
    for _ in range(n):
        if size <= 0.0 or size >= 1.0:
            v = -v
        size = float(np.clip(size + v, 0.0, 1.0))
        yield size, draw_circle(width, height, size)


class ARGB:
    """Packed a<<24|r<<16|g<<8|b pixel (gui_demo.d:245-260)."""

    __slots__ = ("value",)

    def __init__(self, value=0, r=None, g=None, b=None):
        if r is not None:
            self.value = ((r & 0xFF) << 16) | ((g & 0xFF) << 8) | (b & 0xFF)
        else:
            self.value = int(value) & 0xFFFFFFFF

    @property
    def a(self):
        return (self.value >> 24) & 0xFF

    @property
    def r(self):
        return (self.value >> 16) & 0xFF

    @property
    def g(self):
        return (self.value >> 8) & 0xFF

    @property
    def b(self):
        return self.value & 0xFF
