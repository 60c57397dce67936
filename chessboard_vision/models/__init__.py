"""Model layer: stateful vision models over the ops kernels.

Each model carries its temporal state as an explicit pytree (threaded
through jitted step functions) instead of Python-side mutable dicts — the
reference's per-square dict state (piece_detector.py:40-50,
change_detector.py:29-34) becomes (64, ...) tensors.
"""

from chessboard_vision.models.piece_detector import PieceDetectorModel, PieceState
from chessboard_vision.models.change_detector import ChangeDetectorModel
from chessboard_vision.models.pipeline import VisionPipeline, PipelineState, StepOutputs

__all__ = [
    "PieceDetectorModel",
    "PieceState",
    "ChangeDetectorModel",
    "VisionPipeline",
    "PipelineState",
    "StepOutputs",
]
