"""Network layer: Lichess Board API client."""

from chessboard_vision.net.lichess_client import LichessClient

__all__ = ["LichessClient"]
