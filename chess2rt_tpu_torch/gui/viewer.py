"""Runnable progressive viewers for InteractiveSession.

Counterpart of chess2rt_tpu/gui/viewer.py; numpy frames in, so everything
here but ``interactive_main`` (which takes ``device``) is the JAX copy.

The reference's display stack is an SDL2 window that blits the framebuffer
while the render thread fills it bucket by bucket after a coarse prepass
(rt/renderer.d:110-127 prepass, gui/sdl2_gui.d:139-155 draw,
gui/raytracer_demo.d:102-124 render-on-demand).  This module supplies real
consumers for the session's display role:

* ``TerminalViewer`` — dependency-free 24-bit ANSI renderer using
  half-block characters (two pixels per character cell), works over SSH.
* ``SDL2Viewer`` — a real window when ``pysdl2`` is importable (never a
  hard dependency).
* ``progressive_render`` — the reference's visible behavior: coarse
  prepass fill first, then full-quality buckets landing in the zigzag
  order of render/buckets.py.
* ``interactive_main`` — the ``--interactive`` CLI loop: WASD/arrow
  camera drive (uppercase = Shift variant, Ctrl-key = Ctrl variant),
  ``r`` reload, ``p`` screenshot, ``q``/ESC quit.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np

from ..render.buckets import get_buckets_list
from ..utils.color import srgb_u8


class TerminalViewer:
    """24-bit ANSI half-block display.  Each character shows two vertically
    stacked pixels (fg = upper, bg = lower), so a WxH frame needs W columns
    x H/2 rows of text."""

    def __init__(self, max_cols: Optional[int] = None, max_rows: Optional[int] = None, out=None):
        self.out = out if out is not None else sys.stdout
        if max_cols is None or max_rows is None:
            try:
                ts = os.get_terminal_size()
                max_cols = max_cols or ts.columns
                max_rows = max_rows or ts.lines - 2
            except OSError:
                max_cols = max_cols or 80
                max_rows = max_rows or 24
        self.max_cols = max_cols
        self.max_rows = max_rows
        self._first = True

    def _downscale(self, frame: np.ndarray) -> np.ndarray:
        h, w, _ = frame.shape
        tw = self.max_cols
        th = self.max_rows * 2
        sx = max(1, -(-w // tw))
        sy = max(1, -(-h // th))
        s = max(sx, sy)
        if s == 1:
            return frame
        ph = -(-h // s) * s - h
        pw = -(-w // s) * s - w
        f = np.pad(frame, ((0, ph), (0, pw), (0, 0)), mode="edge")
        return f.reshape(f.shape[0] // s, s, f.shape[1] // s, s, 3).mean(axis=(1, 3))

    def render_ansi(self, frame: np.ndarray) -> str:
        """Frame -> ANSI string (no cursor control)."""
        img = self._downscale(np.asarray(frame, dtype=np.float32))
        u8 = srgb_u8(img)
        if u8.shape[0] % 2:
            u8 = np.concatenate([u8, u8[-1:]], axis=0)
        top = u8[0::2]
        bot = u8[1::2]
        lines = []
        for tr, br in zip(top, bot):
            parts = []
            for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
                parts.append(f"\x1b[38;2;{r1};{g1};{b1}m\x1b[48;2;{r2};{g2};{b2}m▀")
            parts.append("\x1b[0m")
            lines.append("".join(parts))
        return "\n".join(lines)

    def blit(self, frame: np.ndarray) -> None:
        """Full repaint (home cursor + draw), the SDL2Gui.draw role."""
        prefix = "\x1b[2J\x1b[H" if self._first else "\x1b[H"
        self._first = False
        self.out.write(prefix + self.render_ansi(frame) + "\x1b[0m\n")
        self.out.flush()

    def close(self) -> None:
        self.out.write("\x1b[0m\n")
        self.out.flush()


class SDL2Viewer:
    """Real window via pysdl2, when importable (never required).

    Beyond the blit role it exposes ``poll_events()``: SDL input translated
    into the InteractiveSession event tuples — key presses with
    Shift/Ctrl modifiers, relative mouse-look while the right button is
    held (raytracer_demo.d:311-322), left-click pixel inspection
    (raytracer_demo.d:213-214), window resize (raytracer_demo.d:126-143 —
    the surface is re-fetched after SDL reallocates it), and quit."""

    _KEYNAMES = {
        "W": "w", "A": "a", "S": "s", "D": "d",
        "Up": "up", "Down": "down", "Left": "left", "Right": "right",
        "R": "r", "P": "p", "Q": "q", "Escape": "esc", "F12": "f12",
    }

    def __init__(self, width: int, height: int, title: str = "chess2rt_tpu_torch", resizable: bool = True):
        import sdl2  # noqa: F401  (ImportError -> caller falls back)
        import sdl2.ext

        sdl2.ext.init()
        self._sdl2 = sdl2
        flags = sdl2.SDL_WINDOW_RESIZABLE if resizable else 0
        self.window = sdl2.ext.Window(title, size=(width, height), flags=flags)
        self.window.show()
        self.surface = self.window.get_surface()

    def blit(self, frame: np.ndarray) -> None:
        import sdl2.ext

        u8 = srgb_u8(np.asarray(frame, dtype=np.float32))
        view = sdl2.ext.pixels3d(self.surface, transpose=False)
        h = min(view.shape[0], u8.shape[0])
        w = min(view.shape[1], u8.shape[1])
        view[:h, :w, 0] = u8[:h, :w, 2]  # BGRA surface
        view[:h, :w, 1] = u8[:h, :w, 1]
        view[:h, :w, 2] = u8[:h, :w, 0]
        self.window.refresh()

    def _modifier(self):
        sdl2 = self._sdl2
        mod = sdl2.SDL_GetModState()
        if mod & sdl2.KMOD_CTRL:
            return "ctrl"
        if mod & sdl2.KMOD_SHIFT:
            return "shift"
        return None

    def poll_events(self):
        """Drain the SDL queue -> session event tuples (gui/session.run)."""
        sdl2 = self._sdl2
        out = []
        ev = sdl2.SDL_Event()
        while sdl2.SDL_PollEvent(ev):
            if ev.type == sdl2.SDL_QUIT:
                out.append(("quit",))
            elif ev.type == sdl2.SDL_KEYDOWN:
                name = sdl2.SDL_GetKeyName(ev.key.keysym.sym).decode()
                key = self._KEYNAMES.get(name)
                if key:
                    out.append(("key", key, self._modifier()))
            elif ev.type == sdl2.SDL_MOUSEMOTION and (
                ev.motion.state & sdl2.SDL_BUTTON_RMASK
            ):
                out.append(("mouse", int(ev.motion.xrel), int(ev.motion.yrel)))
            elif ev.type == sdl2.SDL_MOUSEBUTTONDOWN and ev.button.button == sdl2.SDL_BUTTON_LEFT:
                out.append(("click", int(ev.button.x), int(ev.button.y)))
            elif ev.type == sdl2.SDL_WINDOWEVENT and ev.window.event in (
                sdl2.SDL_WINDOWEVENT_RESIZED,
                sdl2.SDL_WINDOWEVENT_SIZE_CHANGED,
            ):
                out.append(("resize", int(ev.window.data1), int(ev.window.data2)))
        return out

    def on_resized(self) -> None:
        """Re-fetch the window surface after SDL reallocated it
        (sdl2_gui.d:85-110 setSize: surface/texture recreation)."""
        self.surface = self.window.get_surface()

    def close(self) -> None:
        self.window.close()


def make_viewer(width: int, height: int, prefer_sdl: bool = True, resizable: bool = True):
    """SDL2 window when available, ANSI terminal otherwise.  ``resizable``
    should follow GlobalSettings.allowResize (raytracer_demo.d:126-143)."""
    if prefer_sdl:
        try:
            return SDL2Viewer(width, height, resizable=resizable)
        except Exception:
            pass
    return TerminalViewer()


def progressive_render(session, viewer, bucket_size: int = 48, delay: float = 0.0):
    """Reference-shaped progressive display: coarse prepass flat-fill
    (renderer.d:110-127), then full-quality buckets landing in zigzag
    order (renderer.d:194-213).  Returns the final full frame."""
    preview = session._render(preview=True)
    viewer.blit(preview)
    full = session._render(preview=False)
    h, w, _ = full.shape
    canvas = np.array(preview[:h, :w], copy=True)
    for b in get_buckets_list(w, h, bucket_size):
        canvas[b.y0 : b.y1, b.x0 : b.x1] = full[b.y0 : b.y1, b.x0 : b.x1]
        viewer.blit(canvas)
        if delay:
            time.sleep(delay)
    session.frame = full
    return full


# --------------------------------------------------------------------------
# Interactive loop (the --interactive CLI surface)
# --------------------------------------------------------------------------

_ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}
_CTRL = {chr(ord(k) - 96): k for k in "wasd"}  # ^W..^D -> ctrl variants


def _read_key(timeout: float = 0.5):
    """One keypress from raw stdin: returns (key, modifier) or None.
    Uppercase letters = Shift; ^W/^A/^S/^D = Ctrl; ESC-[-X = arrows
    (ESC alone = quit)."""
    import select

    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if not r:
        return None
    ch = sys.stdin.read(1)
    if ch == "\x1b":
        r, _, _ = select.select([sys.stdin], [], [], 0.05)
        if not r:
            return ("esc", None)
        if sys.stdin.read(1) == "[":
            code = sys.stdin.read(1)
            if code in _ARROWS:
                return (_ARROWS[code], None)
        return None
    if ch in _CTRL:
        return (_CTRL[ch], "ctrl")
    if ch.isalpha() and ch.isupper():
        return (ch.lower(), "shift")
    return (ch, None)


def sdl_interactive_main(session, viewer, bucket_size: int = 48) -> int:
    """Window-driven interactive loop: SDL input (keys, right-drag
    mouse-look, left-click inspect, resize) routed into the session's
    handlers — the raytracer_demo.d:190-340 event loop."""
    dirty = False
    while True:
        events = viewer.poll_events()
        if not events:
            if dirty:
                progressive_render(session, viewer, bucket_size)
                dirty = False
            time.sleep(0.01)
            continue
        for ev in events:
            if ev[0] == "quit":
                viewer.close()
                return 0
            if ev[0] == "key":
                if ev[1] in ("q", "esc"):
                    viewer.close()
                    return 0
                if ev[1] == "p":
                    print(f"saved {session.screenshot()}", flush=True)
                    continue
                frame = session.handle_key(ev[1], ev[2], preview=True)
            elif ev[0] == "mouse":
                frame = session.handle_mouse(ev[1], ev[2], preview=True)
            elif ev[0] == "click":
                print(session.handle_click(ev[1], ev[2]), flush=True)
                continue
            elif ev[0] == "resize":
                # ALWAYS re-fetch the surface: SDL reallocated it whether or
                # not the session accepts the new size (allowResize off) —
                # blitting through the stale surface is a use-after-free
                viewer.on_resized()
                frame = session.handle_resize(ev[1], ev[2], preview=True)
            else:
                frame = None
            if frame is not None:
                viewer.blit(frame)
                dirty = True


def interactive_main(scene_path: str, dtype=None, prefer_sdl: bool = True, bucket_size: int = 48,
                     device=None) -> int:
    """``python -m chess2rt_tpu_torch --interactive``: progressive display +
    the RTDemo control table (gui/session.CONTROLS), rendered on ``device``
    (None: the current CUDA device; it raises without one).  With a real
    SDL window the loop is event-driven (mouse-look, click inspection,
    resize); on a bare terminal it falls back to the raw-tty key loop."""
    import termios
    import tty

    from .session import InteractiveSession

    session = InteractiveSession(scene_path, dtype=dtype, device=device)
    s = session.scene.settings
    viewer = make_viewer(
        s.frameWidth, s.frameHeight, prefer_sdl, resizable=s.allowResize and not s.fullscreen
    )
    progressive_render(session, viewer, bucket_size)

    if isinstance(viewer, SDL2Viewer):
        return sdl_interactive_main(session, viewer, bucket_size)

    print("\n[wasd/arrows] move  [Shift]=rotate  [Ctrl]=roll/up-down  "
          "[r]eload  [p]=screenshot  [q/ESC] quit", flush=True)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    dirty = False
    try:
        tty.setcbreak(fd)
        # tty.setcbreak leaves IXON flow control on: Ctrl-S (bound to
        # move-down in the control table) would freeze the terminal as
        # XOFF instead of reaching _read_key
        attrs = termios.tcgetattr(fd)
        attrs[0] &= ~termios.IXON
        termios.tcsetattr(fd, termios.TCSANOW, attrs)
        while True:
            ev = _read_key()
            if ev is None:
                if dirty:  # idle: refine the last preview to full quality
                    progressive_render(session, viewer, bucket_size)
                    dirty = False
                continue
            key, mod = ev
            if key in ("q", "esc"):
                break
            if key == "p":
                path = session.screenshot()
                print(f"\nsaved {path}", flush=True)
                continue
            frame = session.handle_key(key, mod, preview=True)
            if frame is not None:
                viewer.blit(frame)
                dirty = True
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        viewer.close()
    return 0
