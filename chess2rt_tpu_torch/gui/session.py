"""Interactive render session: RTDemo's control surface, headless.

Counterpart of chess2rt_tpu/gui/session.py.  The reference's GUI stack
(gui/{app_sceleton,gui_base,sdl2_gui,raytracer_demo}.d) is an SDL2 window
around four capabilities: camera-drive (WASD/arrows/mouse with Shift/Ctrl
modifiers), R = scene reload, F12 = screenshot, left-click = pixel debug
dump.  This class provides the identical control surface over a pluggable
display callback, so a thin local viewer (gui/viewer.py: a terminal
preview, or an SDL window where pysdl2 is importable) can wrap it.

Frames render on the card (``device=None``: the current CUDA device; it
raises without one, like ``pack_scene``) through ``render_frame``, which
sends the float32 frames K1 covers to the fused path; they leave as numpy
``[H, W, 3]`` arrays, since the viewers consume numpy.

Control table = raytracer_demo.d:275-304 verbatim:
  key (+modifier) -> (move_x, move_y, move_z, d_yaw, d_roll, d_pitch)
  with dMove = 32 world units and dRotate = 4 degrees; relative mouse
  motion maps to (yaw, pitch) at 0.2 deg/px (raytracer_demo.d:273, :322).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.packed import _resolve_device

_DM, _DR = 32.0, 4.0
MOUSE_SPEED = 0.2

# (key, modifier) -> (vx, vy, vz, yaw, roll, pitch); modifier in
# (None, "shift", "ctrl").  First match wins, like the reference's find.
CONTROLS = {
    ("right", "ctrl"): (0, 0, 0, 0, _DR, 0),
    ("right", "shift"): (0, 0, 0, -_DR, 0, 0),
    ("right", None): (_DM, 0, 0, 0, 0, 0),
    ("d", "ctrl"): (0, 0, 0, 0, _DR, 0),
    ("d", "shift"): (0, 0, 0, -_DR, 0, 0),
    ("d", None): (_DM, 0, 0, 0, 0, 0),
    ("left", "ctrl"): (0, 0, 0, 0, -_DR, 0),
    ("left", "shift"): (0, 0, 0, _DR, 0, 0),
    ("left", None): (-_DM, 0, 0, 0, 0, 0),
    ("a", "ctrl"): (0, 0, 0, 0, -_DR, 0),
    ("a", "shift"): (0, 0, 0, _DR, 0, 0),
    ("a", None): (-_DM, 0, 0, 0, 0, 0),
    ("down", "ctrl"): (0, -_DM, 0, 0, 0, 0),
    ("down", "shift"): (0, 0, 0, 0, 0, -_DR),
    ("down", None): (0, 0, -_DM, 0, 0, 0),
    ("s", "ctrl"): (0, -_DM, 0, 0, 0, 0),
    ("s", "shift"): (0, 0, 0, 0, 0, -_DR),
    ("s", None): (0, 0, -_DM, 0, 0, 0),
    ("up", "ctrl"): (0, _DM, 0, 0, 0, 0),
    ("up", "shift"): (0, 0, 0, 0, 0, _DR),
    ("up", None): (0, 0, _DM, 0, 0, 0),
    ("w", "ctrl"): (0, _DM, 0, 0, 0, 0),
    ("w", "shift"): (0, 0, 0, 0, 0, _DR),
    ("w", None): (0, 0, _DM, 0, 0, 0),
}


class InteractiveSession:
    """Headless RTDemo: drive the camera, re-render, screenshot, inspect.

    display: optional callback receiving the float [H, W, 3] frame after
    every render (the GuiBase.display role).  Every render packs the scene
    and renders it anew, so a new frame size or AA mode (``f2``, a resize,
    ``r``) never meets the previous one's state: the JAX session's
    per-scale jit cache has no counterpart here."""

    def __init__(self, scene_path: str, display: Optional[Callable] = None, dtype=None,
                 preview_scale: int = 4, device=None):
        self.device = _resolve_device(device, "InteractiveSession")
        self.scene_path = scene_path
        self.display = display
        self.dtype = dtype if dtype is not None else torch.float32
        self.preview_scale = preview_scale
        self.frame = None
        self.reload()

    # -- scene lifecycle (R key, raytracer_demo.d:221-222) -----------------

    def reload(self) -> None:
        from ..scene.loader import parse_scene_from_file

        self.scene = parse_scene_from_file(self.scene_path)

    def _render(self, preview: bool) -> np.ndarray:
        from ..models.packed import pack_scene
        from ..render.pipeline import render_frame

        scale = self.preview_scale if preview else 1
        packed, static = pack_scene(self.scene, dtype=self.dtype, device=self.device)
        if preview:
            # the prepass role (renderer.d:110-127): coarse low-res render;
            # the packed camera keeps the full frame's aspect, as in JAX
            static = dataclasses.replace(
                static,
                width=max(1, static.width // scale),
                height=max(1, static.height // scale),
                aa_enabled=False,
            )
        with torch.no_grad():
            img = render_frame(packed, static).cpu().numpy()
        if preview:
            img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
            h, w = self.scene.settings.frameHeight, self.scene.settings.frameWidth
            ph, pw = max(0, h - img.shape[0]), max(0, w - img.shape[1])
            if ph or pw:  # non-divisible frame sizes: edge-repeat the rim
                img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
            img = img[:h, :w]
        return img

    def render(self, preview: bool = False) -> np.ndarray:
        from ..utils.structlog import get_logger

        with get_logger().frame(scene=self.scene_path, preview=preview) as rec:
            self.frame = self._render(preview)
            rec["width"], rec["height"] = self.frame.shape[1], self.frame.shape[0]
        if self.display is not None:
            self.display(self.frame)
        return self.frame

    # -- input (raytracer_demo.d:268-340) ----------------------------------

    def handle_key(self, key: str, modifier: Optional[str] = None, preview: bool = True):
        """One key event.  Returns the new frame for camera keys, None for
        unknown keys.  'r' reloads the scene; 'f12' saves a screenshot."""
        key = key.lower()
        if key == "r":
            self.reload()
            return self.render(preview=preview)
        if key == "f12":
            return self.screenshot()
        if key == "f2":
            # EXTENSION key (not in the reference table): toggle adaptiveAA
            # — the full-quality render resamples only needs-AA pixels
            # (the coarse preview is AA-off either way)
            self.scene.settings.adaptiveAA = not getattr(
                self.scene.settings, "adaptiveAA", False
            )
            return self.render(preview=preview)
        move = CONTROLS.get((key, modifier)) or CONTROLS.get((key, None))
        if move is None:
            return None
        vx, vy, vz, d_yaw, d_roll, d_pitch = move
        self.scene.camera.move(vx, vy, vz)
        self.scene.camera.rotate(d_yaw, d_roll, d_pitch)
        return self.render(preview=preview)

    def handle_mouse(self, dx: int, dy: int, preview: bool = True):
        """Relative mouse-look (raytracer_demo.d:322: yaw -dx*0.2,
        pitch -dy*0.2)."""
        self.scene.camera.rotate(-dx * MOUSE_SPEED, 0.0, -dy * MOUSE_SPEED)
        return self.render(preview=preview)

    def handle_resize(self, width: int, height: int, preview: bool = True):
        """Window resize (raytracer_demo.d:126-143 updateToWindowSize):
        gated on allowResize and not fullscreen; re-targets the frame size
        (the framebuffer re-alloc role) and — only with dynamicAspectRatio
        — the camera frame, then re-renders.  Returns the new frame, or
        None when resizing is disabled."""
        s = self.scene.settings
        if not s.allowResize or s.fullscreen:
            return None
        if (width, height) == (s.frameWidth, s.frameHeight):
            return None
        s.frameWidth, s.frameHeight = int(width), int(height)
        if s.dynamicAspectRatio:
            self.scene.camera.set_frame_size(int(width), int(height))
        return self.render(preview=preview)

    def handle_click(self, x: int, y: int) -> str:
        """Left-click pixel inspection (raytracer_demo.d:240-266), traced on
        the session's device."""
        from ..app import debug_pixel

        return debug_pixel(self.scene, x, y, device=self.device)

    # -- screenshot (F12, raytracer_demo.d:227-238) -------------------------

    def screenshot(self, path: Optional[str] = None) -> str:
        import os

        from ..app import screenshot_name
        from ..imageio.bmp import save_bmp_file

        if self.frame is None:
            self.render()
        path = path or screenshot_name()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_bmp_file(path, self.frame)
        return path

    # -- main loop (app_sceleton.d:5-40) ------------------------------------

    def run(self, events, full_render_after: float = 0.0):
        """Drive the session from an iterable of events:
        ("key", name, modifier) | ("mouse", dx, dy) | ("click", x, y) |
        ("resize", w, h) | ("quit",).  A full-quality render lands after
        the last event."""
        for ev in events:
            if ev[0] == "quit":
                break
            if ev[0] == "key":
                self.handle_key(ev[1], ev[2] if len(ev) > 2 else None)
            elif ev[0] == "mouse":
                self.handle_mouse(ev[1], ev[2])
            elif ev[0] == "click":
                print(self.handle_click(ev[1], ev[2]))
            elif ev[0] == "resize":
                self.handle_resize(ev[1], ev[2])
        if full_render_after >= 0:
            return self.render(preview=False)
        return self.frame
