"""Session layer: noise FSM, game orchestration, Lichess wiring."""

from chessboard_vision.session.noise import NoiseHandler, NoiseState
from chessboard_vision.session.game_session import GameSession

__all__ = ["NoiseHandler", "NoiseState", "GameSession", "LichessSession"]


def __getattr__(name):
    # LichessSession pulls in the HTTP client (requests); import it on
    # first use so the vision session imports without it.
    if name == "LichessSession":
        from chessboard_vision.session.lichess_session import LichessSession

        return LichessSession
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
