"""Async render dispatch (renderSceneAsync parity, renderer.d:23-44).

Counterpart of chess2rt_tpu/render/async_render.py.  The reference spawns
a render thread that walks a multi-pass pipeline — coarse prepass
flat-fill (renderer.d:110-127), 1-sample main pass (:133-141), AA resample
(:183-186) — publishing the framebuffer to the GUI after each pass and
checking the ``needsRendering`` stop request BETWEEN passes (renderer.d:129,
:147, :180).  This wrapper reproduces that structure on the card: each
pass is one ``render_frame``, the callback fires per pass with the
progressively-refined frame (a numpy array, copied off the card before the
callback sees it), and ``request_stop`` cancels cooperatively at pass
granularity — exactly the reference's cancellation grain.

``torch.no_grad`` and the current CUDA device are per thread, so the worker
sets both itself.  Whatever the worker raises (a kernel's build on first
use included) is kept and re-raised by ``RenderHandle.result()``."""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..models.packed import _resolve_device


class RenderHandle:
    def __init__(self):
        self._done = threading.Event()
        self._stop = threading.Event()
        self.frame: Optional[np.ndarray] = None
        self.passes_completed = 0
        self.error: Optional[BaseException] = None

    @property
    def is_rendering(self) -> bool:
        return not self._done.is_set()

    def request_stop(self) -> None:
        """Cooperative cancellation (the needsRendering flag's stop role)."""
        self._stop.set()

    def result(self, timeout=None) -> np.ndarray:
        self._done.wait(timeout)
        if self.error is not None:
            raise self.error
        return self.frame


def render_scene_async(
    scene,
    callback: Optional[Callable[[np.ndarray], None]] = None,
    dtype=None,
    key=None,
    prepass_scale: int = 16,
    device=None,
) -> RenderHandle:
    """Kick off a progressive multi-pass render on a worker thread; returns
    immediately with a RenderHandle (isRendering semantics, renderer.d:23-44).
    ``device=None`` is the current CUDA device (it raises here, in the
    caller's thread, without one); ``key`` is a threefry key of ops/prng.py
    (None: ``PRNGKey(0)``).

    Pass schedule (mirrors renderRT, renderer.d:83-189):
      1. prepass: 1 ray per ``prepass_scale``-pixel block, flat-filled —
         skipped when the scene disables prepassEnabled; with prepassOnly
         the render stops after it;
      2. main: full-resolution base sample (AA off);
      3. AA: the 5-tap supersample — skipped when AAEnabled is off.
    ``callback`` (the GUI display role) receives the frame after every
    completed pass; ``request_stop()`` takes effect between passes."""
    device = _resolve_device(device, "render_scene_async")
    handle = RenderHandle()

    def work():
        try:
            from ..models.packed import pack_scene
            from .pipeline import render_frame

            if device.type == "cuda":
                torch.cuda.set_device(device)
            if handle._stop.is_set():
                return
            packed, static = pack_scene(scene, dtype=dtype or torch.float32, device=device)

            def publish(img):
                handle.frame = img
                handle.passes_completed += 1
                if callback is not None:
                    callback(handle.frame)

            def run_pass(st):
                with torch.no_grad():
                    return render_frame(packed, st, key).cpu().numpy()

            # PASS 1: coarse prepass flat-fill (renderer.d:110-127)
            if getattr(scene.settings, "prepassEnabled", True) and prepass_scale > 1:
                if handle._stop.is_set():
                    return
                s = prepass_scale
                coarse = dataclasses.replace(
                    static,
                    width=max(1, static.width // s),
                    height=max(1, static.height // s),
                    aa_enabled=False,
                )
                img = run_pass(coarse)
                img = np.repeat(np.repeat(img, s, axis=0), s, axis=1)[: static.height, : static.width]
                publish(img)
                if getattr(scene.settings, "prepassOnly", False):
                    return

            # PASS 2: full-res base sample (renderer.d:133-141)
            if handle._stop.is_set():
                return
            publish(run_pass(dataclasses.replace(static, aa_enabled=False)))

            # PASS 3/4: AA supersample (renderer.d:183-186)
            if static.aa_enabled:
                if handle._stop.is_set():
                    return
                publish(run_pass(static))
        except BaseException as e:  # surfaced via result()
            handle.error = e
        finally:
            handle._done.set()

    threading.Thread(target=work, name="chess2rt-render", daemon=True).start()
    return handle
