"""The port's host-side apps against the JAX package's, exactly: the bucket
list (render/buckets.py), the chess data model (chess/), the GuiDemo toy
(gui/demo.py), the terminal viewer's ANSI string, the viewer fallback and
``progressive_render``'s blit order (gui/viewer.py).  None of these
renders a frame, so nothing here compiles JAX: the progressive test drives
both packages' ``progressive_render`` with a session whose frames are
seeded numpy arrays.
"""

import io

import numpy as np
import pytest
import torch

from chess2rt_tpu import chess as jax_chess
from chess2rt_tpu.chess.board import STARTING_POSITION as JAX_START
from chess2rt_tpu.gui import demo as jax_demo
from chess2rt_tpu.gui import viewer as jax_viewer
from chess2rt_tpu.render.buckets import get_buckets_list as jax_buckets
from chess2rt_tpu_torch import chess
from chess2rt_tpu_torch.chess.board import STARTING_POSITION
from chess2rt_tpu_torch.gui import demo, viewer
from chess2rt_tpu_torch.render.buckets import Bucket, get_buckets_list

torch.set_num_threads(2)


@pytest.mark.parametrize("size", [(1, 1), (47, 48), (48, 48), (49, 97), (64, 48), (640, 480), (1920, 1080),
                                  (1921, 1081)])
@pytest.mark.parametrize("bucket", [7, 16, 32, 48, 64])
def test_bucket_list_is_jax(size, bucket):
    got = get_buckets_list(*size, bucket)
    assert got == [tuple(b) for b in jax_buckets(*size, bucket)]
    assert all(isinstance(b, Bucket) for b in got)
    # the buckets tile the frame once each
    cover = np.zeros(size[::-1], int)
    for b in got:
        cover[b.y0:b.y1, b.x0:b.x1] += 1
    assert (cover == 1).all()


def test_zigzag_order():
    bs = get_buckets_list(96, 96, 32)
    assert [(b.x0, b.y0) for b in bs] == [(0, 0), (32, 0), (64, 0), (64, 32), (32, 32), (0, 32),
                                          (0, 64), (32, 64), (64, 64)]
    assert len(get_buckets_list(1920, 1080, 48)) == 40 * 23


@pytest.mark.parametrize("byte", range(128))
def test_piece_bitfield_is_jax(byte):
    if (byte & 0b111) > 6 or (byte >> 4) > 5:  # no such piece type or army: both raise
        for mod in (chess, jax_chess):
            with pytest.raises(ValueError):
                mod.Piece.from_byte(byte)
        return
    p, q = chess.Piece.from_byte(byte), jax_chess.Piece.from_byte(byte)
    assert (p.to_byte(), p.to_char(), str(p)) == (q.to_byte(), q.to_char(), str(q))
    assert chess.Piece.from_byte(p.to_byte()) == p


def test_board_round_trip_is_jax():
    assert STARTING_POSITION == JAX_START
    b, jb = chess.Board(STARTING_POSITION), jax_chess.Board(JAX_START)
    assert str(b) == str(jb)
    assert chess.Board(str(b)).__str__() == str(b)
    for sq in ("a1", "e1", "d8", "h7", "c4"):
        assert b[sq].to_byte() == jb[sq].to_byte()
    assert str(b["e1"]) == "Classic White King" and str(b["d8"]) == "Classic Black Queen"
    for col in chess.Col:
        for row in range(1, 9):
            assert b.at(col, row).to_byte() == jb.at(col, row).to_byte()
    with pytest.raises(ValueError):
        chess.Board("." * 63)
    with pytest.raises(ValueError):
        chess.Piece.from_char("x")


@pytest.mark.parametrize("w,h,ratio,seed", [(64, 48, 0.5, 0), (33, 17, 0.9, 3), (100, 100, 0.1, 7)])
def test_draw_circle_is_jax(w, h, ratio, seed):
    got = demo.draw_circle(w, h, ratio, seed)
    want = jax_demo.draw_circle(w, h, ratio, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_demo_frames_and_argb_are_jax():
    for (s1, f1), (s2, f2) in zip(demo.demo_frames(24, 16, n=12, speed=0.1, size0=0.95),
                                  jax_demo.demo_frames(24, 16, n=12, speed=0.1, size0=0.95)):
        assert s1 == s2
        np.testing.assert_array_equal(f1, f2)
    for v in (0, 0x12345678, 0xFFFFFFFF, -1, 1 << 33):
        a, b = demo.ARGB(v), jax_demo.ARGB(v)
        assert (a.value, a.a, a.r, a.g, a.b) == (b.value, b.a, b.r, b.g, b.b)
    a, b = demo.ARGB(r=300, g=7, b=9), jax_demo.ARGB(r=300, g=7, b=9)
    assert (a.value, a.r, a.g, a.b) == (b.value, b.r, b.g, b.b)


@pytest.mark.parametrize("h,w,cols,rows", [(4, 3, 10, 10), (24, 32, 40, 12), (97, 130, 31, 9), (480, 640, 80, 24)])
def test_render_ansi_is_jax(h, w, cols, rows):
    rng = np.random.default_rng(h * w)
    frame = rng.uniform(-0.1, 1.2, (h, w, 3)).astype(np.float32)
    got = viewer.TerminalViewer(max_cols=cols, max_rows=rows, out=io.StringIO()).render_ansi(frame)
    want = jax_viewer.TerminalViewer(max_cols=cols, max_rows=rows, out=io.StringIO()).render_ansi(frame)
    assert got == want


def test_blit_writes_what_jax_writes():
    frames = [np.full((6, 8, 3), v, np.float32) for v in (0.0, 0.5, 1.0)]
    outs = []
    for mod in (viewer, jax_viewer):
        out = io.StringIO()
        v = mod.TerminalViewer(max_cols=8, max_rows=4, out=out)
        for f in frames:
            v.blit(f)
        v.close()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].startswith("\x1b[2J\x1b[H") and outs[0].count("\x1b[H") == 3


def test_make_viewer_falls_back_to_terminal():
    v = viewer.make_viewer(64, 48, prefer_sdl=True)  # no pysdl2 here
    assert isinstance(v, viewer.TerminalViewer)
    assert isinstance(viewer.make_viewer(64, 48, prefer_sdl=False), viewer.TerminalViewer)


class _FakeSession:
    """A session whose preview and full frames are seeded arrays."""

    def __init__(self, h, w):
        rng = np.random.default_rng(1)
        self.frames = {True: rng.uniform(size=(h, w, 3)).astype(np.float32),
                       False: rng.uniform(size=(h, w, 3)).astype(np.float32)}
        self.frame = None

    def _render(self, preview):
        return self.frames[preview]


class _Recorder:
    def __init__(self):
        self.blits = []

    def blit(self, frame):
        self.blits.append(np.array(frame, copy=True))


@pytest.mark.parametrize("h,w,bucket", [(48, 64, 32), (50, 70, 16), (24, 32, 48)])
def test_progressive_render_blits_buckets_in_zigzag_order(h, w, bucket):
    got, want = _Recorder(), _Recorder()
    session, jax_session = _FakeSession(h, w), _FakeSession(h, w)
    full = viewer.progressive_render(session, got, bucket)
    jax_viewer.progressive_render(jax_session, want, bucket)
    buckets = get_buckets_list(w, h, bucket)
    assert len(got.blits) == len(want.blits) == 1 + len(buckets)
    for a, b in zip(got.blits, want.blits):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.blits[0], session.frames[True])
    np.testing.assert_array_equal(got.blits[-1], full)
    assert session.frame is full
    # blit k differs from blit k-1 only inside bucket k-1, and that bucket now holds the full frame
    for k, b in enumerate(buckets, 1):
        changed = np.abs(got.blits[k] - got.blits[k - 1]).max(-1) > 0
        inside = np.zeros((h, w), bool)
        inside[b.y0:b.y1, b.x0:b.x1] = True
        assert not changed[~inside].any()
        np.testing.assert_array_equal(got.blits[k][inside], full[inside])
