from .board import Board, Col, Row
from .piece import ArmyType, Piece, PieceColor, PieceType

__all__ = ["Board", "Col", "Row", "Piece", "PieceColor", "PieceType", "ArmyType"]
