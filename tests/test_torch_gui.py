"""The port's interactive session, async renderer and ``--interactive`` CLI
(gui/session.py, render/async_render.py, gui/viewer.py, app.py) against
the JAX package's, on the flagship stand-in as a scene file
(``scenes.write_standin_sdl``: CSG, two BMP textures, Phong, the mirror,
AA5, depth 5) at 32x24, ``device="cpu"``.

* The same event script (camera keys with and without Shift/Ctrl,
  mouse-look, an unknown key) leaves both cameras in the same state,
  exactly, and the preview and full frames agree at the frame limits
  (tests/torch_port_cases.py::assert_frame_close).  The JAX session
  renders its XLA path (two compiles, the file's only ones).
* ``f2``, resize and reload change the same state as JAX's, with both
  sessions' renders recorded instead of run; the port's frames after them
  are its ``render_frame`` of the new static, bit for bit.
* The async pass schedule (prepass, ``prepassOnly``, ``prepassEnabled``
  off, AA off, a stop before dispatch) is JAX's, with the JAX frames
  stubbed, and each port pass's frame is its ``render_frame`` of that
  pass's static; an error in the worker is re-raised by ``result()``.
* ``python -m chess2rt_tpu_torch --interactive --device cpu`` on a
  pseudo-terminal (``chip_smoke.drive_interactive``) exits 0 on ``q``, and
  its ``p`` screenshot equals the in-process full frame after the same key.
* Without a card and without a device, the session, the async renderer
  and the viewer's loop raise (the CLI's ``--interactive``:
  tests/test_torch_app.py).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from chess2rt_tpu.gui.session import InteractiveSession as JaxSession
from chess2rt_tpu.render import async_render as jax_async
from chess2rt_tpu.scene.loader import parse_scene_from_file as jax_parse
from chess2rt_tpu_torch.gui import CONTROLS, InteractiveSession
from chess2rt_tpu_torch.gui.session import MOUSE_SPEED
from chess2rt_tpu_torch.gui.viewer import interactive_main
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.render.async_render import render_scene_async
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scene import parse_scene_from_file
from chess2rt_tpu_torch.scenes import write_standin_sdl
from chess2rt_tpu_torch.utils.color import srgb_u8

from torch_port_cases import H, W, assert_frame_close

torch.set_num_threads(2)

EVENTS = [("key", "w", None), ("key", "a", "shift"), ("key", "s", "ctrl"), ("mouse", 5, -3),
          ("key", "up", None), ("key", "left", "ctrl"), ("key", "D", None), ("key", "x", None)]


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    return write_standin_sdl(str(tmp_path_factory.mktemp("scene")), W, H)


def _camera(session):
    return {k: tuple(np.asarray(v, float).ravel()) for k, v in dataclasses.asdict(session.scene.camera).items()}


def _play(session):
    """The event script; returns each event's return value."""
    out = []
    for ev in EVENTS:
        if ev[0] == "key":
            out.append(session.handle_key(ev[1], ev[2]))
        else:
            out.append(session.handle_mouse(ev[1], ev[2]))
    return out


def test_controls_are_jax():
    from chess2rt_tpu.gui import session as jax_session

    assert CONTROLS == jax_session.CONTROLS and MOUSE_SPEED == jax_session.MOUSE_SPEED


def test_event_script_camera_state_and_frames_match_jax(scene_file):
    j = JaxSession(scene_file)  # its XLA frames: two compiles (the preview and the full frame)
    want_frames = _play(j)
    want_camera, want_full = _camera(j), np.asarray(j.render(preview=False))
    s = InteractiveSession(scene_file, device="cpu")
    frames = _play(s)
    assert _camera(s) == want_camera
    assert [f is None for f in frames] == [f is None for f in want_frames] == [False] * 7 + [True]
    for f in frames[:-1]:
        assert f.shape == (H, W, 3) and f.dtype == np.float32
    assert_frame_close(frames[-2], np.asarray(want_frames[-2]))  # the preview: 8x6 upsampled x4
    full = s.render(preview=False)
    assert_frame_close(full, want_full)
    # the full frame is render_frame of the moved camera, bit for bit
    packed, static = pack_scene(s.scene, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(full, render_frame(packed, static).numpy())


class _Recording:
    """Replaces a session's render: records the preview flag and the frame
    size and AA mode it would render."""

    def __init__(self, session):
        self.session, self.calls = session, []
        session.render = self

    def __call__(self, preview=False):
        st = self.session.scene.settings
        self.calls.append((preview, st.frameWidth, st.frameHeight, bool(getattr(st, "adaptiveAA", False))))
        return "frame"


def _settings(session):
    st = session.scene.settings
    return (st.frameWidth, st.frameHeight, bool(getattr(st, "adaptiveAA", False)), _camera(session))


@pytest.mark.parametrize("allow,fullscreen,dynamic,size", [
    (False, False, False, (40, 30)),   # resizing disabled
    (True, True, False, (40, 30)),     # fullscreen blocks it
    (True, False, False, (W, H)),      # the same size: nothing to do
    (True, False, False, (40, 20)),    # the frame resizes, the camera keeps its aspect
    (True, False, True, (40, 20)),     # dynamicAspectRatio: the camera follows
])
def test_f2_resize_and_reload_change_what_jax_changes(scene_file, allow, fullscreen, dynamic, size):
    sessions = [InteractiveSession(scene_file, device="cpu"), JaxSession(scene_file)]
    recs = [_Recording(s) for s in sessions]
    trace = []
    for s in sessions:
        st = s.scene.settings
        st.allowResize, st.fullscreen, st.dynamicAspectRatio = allow, fullscreen, dynamic
        got = [s.handle_key("f2"), _settings(s), s.handle_resize(*size), _settings(s), s.handle_key("w"),
               s.handle_key("f2", preview=False), _settings(s), s.handle_key("r"), _settings(s)]
        trace.append(got)
    assert trace[0] == trace[1]
    assert recs[0].calls == recs[1].calls
    resized = allow and not fullscreen and size != (W, H)
    assert (trace[0][2] == "frame") == resized
    assert trace[0][3][:2] == (size if resized else (W, H))
    assert trace[0][8][:3] == (W, H, False)  # reload: the file's settings again


def test_f2_and_resize_frames_are_render_frame_of_the_new_static(scene_file):
    s = InteractiveSession(scene_file, device="cpu")
    s.scene.settings.allowResize = True
    adaptive = s.handle_key("f2", preview=False)
    packed, static = pack_scene(s.scene, device="cpu")
    assert static.aa_adaptive
    with torch.no_grad():
        np.testing.assert_array_equal(adaptive, render_frame(packed, static).numpy())
    resized = s.handle_resize(40, 20, preview=False)
    assert resized.shape == (20, 40, 3)
    packed, static = pack_scene(s.scene, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(resized, render_frame(packed, static).numpy())


def _fake_jax_render_frame(packed, static, key):
    return jax.numpy.zeros((static.height, static.width, 3), jax.numpy.float32)


@pytest.mark.parametrize("settings,passes", [
    ({}, 3),                                    # prepass, main, AA
    ({"prepassOnly": True}, 1),
    ({"prepassEnabled": False}, 2),
    ({"AAEnabled": False}, 2),
])
def test_async_pass_schedule_is_jax(scene_file, monkeypatch, settings, passes):
    monkeypatch.setattr("chess2rt_tpu.render.pipeline.render_frame", _fake_jax_render_frame)
    scenes = []
    for parse in (parse_scene_from_file, jax_parse):
        sc = parse(scene_file)
        for k, v in settings.items():
            setattr(sc.settings, k, v)
        scenes.append(sc)
    shapes = [[], []]
    got = render_scene_async(scenes[0], callback=lambda f: shapes[0].append((f.shape, f.copy())), device="cpu",
                             prepass_scale=4)
    want = jax_async.render_scene_async(scenes[1], callback=lambda f: shapes[1].append((np.shape(f), None)),
                                        prepass_scale=4)
    frame, _ = got.result(300), want.result(300)
    assert got.passes_completed == want.passes_completed == passes
    assert [a for a, _ in shapes[0]] == [a for a, _ in shapes[1]]
    assert not got.is_rendering and got.error is None
    # every pass is the port's render_frame of that pass's static
    packed, static = pack_scene(scenes[0], device="cpu")
    statics = []
    if scenes[0].settings.prepassEnabled:
        statics.append(dataclasses.replace(static, width=W // 4, height=H // 4, aa_enabled=False))
    if not scenes[0].settings.prepassOnly:
        statics.append(dataclasses.replace(static, aa_enabled=False))
        if static.aa_enabled:
            statics.append(static)
    for (shape, img), st in zip(shapes[0], statics):
        with torch.no_grad():
            ref = render_frame(packed, st).numpy()
        if st.width != W:
            ref = np.repeat(np.repeat(ref, 4, axis=0), 4, axis=1)[:H, :W]
        np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(frame, shapes[0][-1][1])


def test_async_stop_before_dispatch_and_errors(scene_file, monkeypatch):
    import threading

    import chess2rt_tpu.models.packed as jax_packed
    import chess2rt_tpu_torch.models.packed as port_packed

    for mod, parse, start in ((port_packed, parse_scene_from_file, lambda sc: render_scene_async(sc, device="cpu")),
                              (jax_packed, jax_parse, jax_async.render_scene_async)):
        box, ready = {}, threading.Event()

        def pack_then_stop(*a, pack=mod.pack_scene, box=box, ready=ready, **k):
            ready.wait(60)
            box["handle"].request_stop()  # the stop lands while the scene packs, before any pass
            return pack(*a, **k)

        monkeypatch.setattr(mod, "pack_scene", pack_then_stop)
        box["handle"] = h = start(parse(scene_file))
        ready.set()
        assert h.result(300) is None
        assert h.passes_completed == 0 and h.error is None and not h.is_rendering
    # a scene the packer refuses: the worker's error comes back through result()
    monkeypatch.undo()
    sc = parse_scene_from_file(scene_file)
    sc.nodes[0].geometry = object()
    h = render_scene_async(sc, device="cpu")
    with pytest.raises(TypeError):
        h.result(300)
    assert not h.is_rendering and h.frame is None


def test_interactive_cli_on_a_terminal(scene_file, tmp_path):
    import chip_smoke  # the repository root: run pytest as ``python -m pytest`` from there

    res = chip_smoke.drive_interactive(["--file", scene_file, "--device", "cpu", "-q"],
                                       [(b"[q/ESC] quit", b"w"), (5, b"p"), (b"saved ", b"q")], str(tmp_path), timeout=240)
    assert res["rc"] == 0, res["output"][-2000:]
    assert res["repaints"] == 5  # prepass + 1 bucket, the w preview, prepass + 1 bucket again
    shot = res["output"].split("saved ")[1].split()[0]
    got = chip_smoke.bmp_u8(os.path.join(str(tmp_path), shot))
    s = InteractiveSession(scene_file, device="cpu")
    s.handle_key("w")
    np.testing.assert_array_equal(got, srgb_u8(s.render(preview=False)))


def test_entry_points_raise_without_a_card(scene_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sc = parse_scene_from_file(scene_file)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractiveSession(scene_file)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_scene_async(sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interactive_main(scene_file)
