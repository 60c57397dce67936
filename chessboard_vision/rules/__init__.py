"""Chess rules layer: engine, GameState, FEN generation.

Replaces the reference's dependency on the external ``python-chess`` package
(reference game_state.py:1) with an in-framework rules engine exposing the
same API surface the vision stack needs.
"""

from chessboard_vision.rules import chesslib as chess
from chessboard_vision.rules.game_state import GameState
from chessboard_vision.rules.pgn import game_to_pgn, san
from chessboard_vision.rules.fen import (
    PIECE_TO_FEN,
    get_chess_square,
    map_detections_to_board,
    generate_fen,
    occupancy_to_fen,
    classify_piece_colors,
    occupancy_to_colored_fen,
)

__all__ = [
    "chess",
    "GameState",
    "PIECE_TO_FEN",
    "get_chess_square",
    "map_detections_to_board",
    "generate_fen",
    "occupancy_to_fen",
    "classify_piece_colors",
    "occupancy_to_colored_fen",
    "game_to_pgn",
    "san",
]
