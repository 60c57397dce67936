"""NumPy/OpenCV oracle backend.

Behavioral re-implementations of the reference pipeline stages
(frame_enhancer.py, change_detector.py, piece_detector.py in
the reference repository) used as (a) the parity oracle for the device kernels and
(b) a CPU fallback backend behind the backend registry — mirroring the
reference's own Cython-else-Python alias seam (frame_enhancer.py:184-190).
"""

from chessboard_vision.reference.enhancer import ImageEnhancerCV
from chessboard_vision.reference.change_detector import ChangeDetectorCV
from chessboard_vision.reference.piece_detector import PieceDetectorCV

__all__ = ["ImageEnhancerCV", "ChangeDetectorCV", "PieceDetectorCV"]
