"""Chess piece bitfield (reference chess/piece.d).

Vestigial in the reference — never imported by the renderer (SURVEY.md
§2.8: the "chess game" the repo is named for was never built) — but the
data model is reproduced for inventory completeness: a 1-byte bitfield
    bit 7 | 6 5 4  | 3     | 2 1 0
    resv  | army   | color | piece type
with Chess2 army types and the ASCII piece representation.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class PieceType(IntEnum):
    Empty = 0
    Pawn = 1
    Knight = 2
    Bishop = 3
    Rook = 4
    Queen = 5
    King = 6


class PieceColor(IntEnum):
    White = 0
    Black = 1


class ArmyType(IntEnum):
    """Chess2 army variants (piece.d:25-34)."""

    Classic = 0
    Nemesis = 1
    Empowered = 2
    Reaper = 3
    TwoKings = 4
    Animals = 5


_CHAR_TO_BITS = {
    ".": 0,
    "P": 1, "N": 2, "B": 3, "R": 4, "Q": 5, "K": 6,
    "p": 8 + 1, "n": 8 + 2, "b": 8 + 3, "r": 8 + 4, "q": 8 + 5, "k": 8 + 6,
}
_BITS_TO_CHAR = {v: k for k, v in _CHAR_TO_BITS.items()}


@dataclass(frozen=True)
class Piece:
    piece_type: PieceType = PieceType.Empty
    color: PieceColor = PieceColor.White
    army: ArmyType = ArmyType.Classic

    @classmethod
    def from_byte(cls, b: int) -> "Piece":
        """Unpack the bitfield (piece.d:44-50, :106-111)."""
        return cls(
            PieceType(b & 0b111),
            PieceColor((b >> 3) & 0b1),
            ArmyType((b >> 4) & 0b111),
        )

    @classmethod
    def from_char(cls, c: str) -> "Piece":
        """ASCII piece -> Piece (piece.d:190-213); unknown chars raise."""
        if c not in _CHAR_TO_BITS:
            raise ValueError(f"not a piece character: {c!r}")
        return cls.from_byte(_CHAR_TO_BITS[c])

    def to_byte(self) -> int:
        return int(self.piece_type) | (int(self.color) << 3) | (int(self.army) << 4)

    def to_char(self) -> str:
        """Piece -> ASCII, '@' for invalid colored-piece codes like the
        reference's fall-through (piece.d:163-186)."""
        return _BITS_TO_CHAR.get(self.to_byte() & 0b1111, "@")

    def __str__(self):
        return f"{self.army.name} {self.color.name} {self.piece_type.name}"
