"""Low-level device array ops (JAX/XLA/Pallas).

Each op mirrors the exact arithmetic of the OpenCV call it replaces in the
reference pipeline (bit-exact where the FEN-parity path requires it,
<=1-intensity-level tolerance on enhancement-only stages). All ops are pure
functions over jnp arrays, jit-safe, and batchable over leading axes.
"""

from chessboard_vision.ops.color import (
    bgr2gray,
    bgr2hsv,
    hsv2bgr,
    bgr2lab,
    lab2bgr,
    planar_bgr2lab,
    planar_lab2bgr,
    convert_scale_abs,
)
from chessboard_vision.ops.filters import (
    gaussian_blur,
    gaussian_kernel_u8,
    filter2d_int,
    normalize_minmax,
    sharpen,
    sobel3,
)
from chessboard_vision.ops.threshold import otsu_threshold, otsu_binarize

__all__ = [
    "bgr2gray",
    "bgr2hsv",
    "hsv2bgr",
    "bgr2lab",
    "lab2bgr",
    "planar_bgr2lab",
    "planar_lab2bgr",
    "convert_scale_abs",
    "gaussian_blur",
    "gaussian_kernel_u8",
    "filter2d_int",
    "normalize_minmax",
    "sharpen",
    "sobel3",
    "otsu_threshold",
    "otsu_binarize",
]
