"""chessboard_vision — a JAX/XLA/Pallas chessboard-vision framework.

A from-scratch rebuild of the capabilities of hericmr/chessboard-vision:
real-time digitization of a physical chessboard from camera frames into FEN
and live Lichess play. The per-frame compute path (enhancement, homography
warp + 8x8 slicing, per-square occupancy detection, temporal change
detection) runs as fused, batched JAX/XLA/Pallas kernels so one frame->FEN
step is a single XLA call, batched over N camera streams and shardable over
a device mesh. Chess rules, the noise/stability state machines, calibration
tooling, and the Lichess Board API client run host-side.

Layer map (mirrors reference layers, see SURVEY.md §1):
  ops/        — low-level device array ops (color, filters, warp, hough, ...)
  models/     — enhancer / change-detector / piece-detector / pipeline models
  rules/      — chess rules engine (python-chess equivalent), GameState, FEN
  session/    — noise FSM, GameSession orchestrator, LichessSession
  net/        — Lichess Board API HTTP client
  parallel/   — multi-stream batching, device-mesh sharding
  reference/  — NumPy/OpenCV oracle implementations used for parity tests
  utils/      — config persistence, logging, profiling
  tools/      — calibration CLIs and drivers
  native/     — C++ host runtime (frame ring buffer etc.), ctypes-loaded
"""

__version__ = "0.3.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import chessboard_vision` free of
    jax/cv2 imports): the BASELINE-named convenience entry points plus the
    main classes."""
    _api = {
        "enhance_frame", "extract_grid", "detect_pieces", "detect_changes",
        "frame_to_fen", "frame_to_full_fen", "generate_fen", "occupancy_to_fen",
        "occupancy_to_colored_fen", "digitize_video",
    }
    if name in _api:
        from chessboard_vision import api

        return getattr(api, name)
    if name == "VisionPipeline":
        from chessboard_vision.models.pipeline import VisionPipeline

        return VisionPipeline
    if name == "GameSession":
        from chessboard_vision.session.game_session import GameSession

        return GameSession
    if name == "BoardGeometry":
        from chessboard_vision.geometry import BoardGeometry

        return BoardGeometry
    raise AttributeError(f"module 'chessboard_vision' has no attribute {name!r}")
