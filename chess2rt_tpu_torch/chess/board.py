"""8x8 chess board with ASCII import/printing (reference chess/board.d)."""

from __future__ import annotations

from enum import IntEnum

from .piece import Piece


class Row(IntEnum):
    r1, r2, r3, r4, r5, r6, r7, r8 = range(8)


class Col(IntEnum):
    a, b, c, d, e, f, g, h = range(8)


class Board:
    """Piece[64], row 0 of the ASCII layout = rank 8 (board.d:29-33)."""

    def __init__(self, ascii_repr: str = "." * 64):
        ascii_repr = ascii_repr.replace("\n", "")
        if len(ascii_repr) != 64:
            raise ValueError("board needs exactly 64 squares")
        self._board = [Piece.from_char(c) for c in ascii_repr]

    def at(self, col: int, row: int) -> Piece:
        """Indexing by (Col, Row): board[(8 - r) * 8 + c] with r starting at
        1 — the reference's quirky algebra (board.d:15-18: `opIndex(c, r)`
        is called with `r = digit` so rank 1 maps to row index 7)."""
        return self._board[(8 - row) * 8 + col]

    def __getitem__(self, square: str) -> Piece:
        """Algebraic indexing `b["a1"]` (board.d:20-27)."""
        col = ord(square[0]) - ord("a")
        row = ord(square[1]) - ord("0")
        return self.at(col, row)

    def __str__(self):
        rows = []
        for r in range(8):
            rows.append("".join(p.to_char() for p in self._board[r * 8 : r * 8 + 8]))
        return "\n".join(rows)


STARTING_POSITION = (
    "rnbqkbnr"
    "pppppppp"
    "........"
    "........"
    "........"
    "........"
    "PPPPPPPP"
    "RNBQKBNR"
)
