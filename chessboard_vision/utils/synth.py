"""Synthetic camera frames rendered with numpy alone.

Drives the vision path without a camera or OpenCV: a top-down board with
round pieces drawn from an (8, 8) [file, rank] occupancy grid, projected
into a camera frame through the inverse of the calibration homography
(bilinear, like cv2.warpPerspective). Used by bench.py, the profiling
tool and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

from chessboard_vision.geometry import get_perspective_transform

LIGHT = (181, 217, 240)
DARK = (99, 136, 181)
WHITE_PIECE = (235, 235, 245)
BLACK_PIECE = (40, 36, 30)
OUTLINE = (20, 20, 20)


def _draw_piece(img, cx, cy, radius, color):
    """Filled disc with a 2 px dark outline, centred on (cx, cy)."""
    r0 = radius + 1
    y0, y1 = max(cy - r0, 0), min(cy + r0 + 1, img.shape[0])
    x0, x1 = max(cx - r0, 0), min(cx + r0 + 1, img.shape[1])
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    patch = img[y0:y1, x0:x1]
    patch[d2 <= radius * radius] = color
    patch[(d2 <= r0 * r0) & (d2 >= (radius - 1) ** 2)] = OUTLINE


def draw_board(img, occupancy, x0: int, y0: int, board_px: int) -> None:
    """Draw the board and its pieces into ``img`` (HWC) with the top-left
    corner at (x0, y0). Rank 8 is the top row; ranks 1-4 hold white pieces."""
    occ = np.asarray(occupancy, bool).reshape(8, 8)
    sq = board_px // 8
    for row in range(8):
        for col in range(8):
            img[y0 + row * sq : y0 + (row + 1) * sq, x0 + col * sq : x0 + (col + 1) * sq] = (
                LIGHT if (row + col) % 2 == 0 else DARK
            )
    for f in range(8):
        for r in range(8):
            if occ[f, r]:
                cx = x0 + f * sq + sq // 2
                cy = y0 + (7 - r) * sq + sq // 2
                _draw_piece(img, cx, cy, int(sq * 0.36), WHITE_PIECE if r <= 3 else BLACK_PIECE)


def add_noise(img, rng, sigma: float) -> np.ndarray:
    return np.clip(img.astype(np.float64) + rng.normal(0, sigma, img.shape), 0, 255).astype(np.uint8)


def initial_occupancy() -> np.ndarray:
    occ = np.zeros((8, 8), bool)
    occ[:, :2] = occ[:, 6:] = True
    return occ


def bench_frame(rng, h: int, w: int):
    """Axis-aligned board of side min(h, w) - 100 centred in an (h, w)
    frame, initial position. Returns (HWC u8 frame, (x0, y0, board_px))."""
    frame = np.full((h, w, 3), 60, np.uint8)
    bs = min(h, w) - 100
    x0, y0 = (w - bs) // 2, (h - bs) // 2
    draw_board(frame, initial_occupancy(), x0, y0, bs)
    return add_noise(frame, rng, 2.5), (x0, y0, bs)


def perspective_frame(occupancy, corners, rng=None, frame_size=(720, 1280),
                      board_px: int = 800, bg: int = 60,
                      frame_noise: float = 2.0) -> np.ndarray:
    """A camera frame of the board seen at ``corners`` (TL, TR, BL, BR).
    With ``rng``: texture noise on the board, then ``frame_noise`` sensor
    noise on the frame."""
    board = np.zeros((board_px, board_px, 3), np.uint8)
    draw_board(board, occupancy, 0, 0, board_px)
    if rng is not None:
        board = add_noise(board, rng, 3.0)
    src = np.float64([[0, 0], [board_px, 0], [0, board_px], [board_px, board_px]])
    inv = get_perspective_transform(np.asarray(corners, np.float64).reshape(4, 2), src)
    h, w = frame_size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    den = inv[2, 0] * xx + inv[2, 1] * yy + inv[2, 2]
    u = (inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]) / den
    v = (inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]) / den
    inside = (u >= 0) & (v >= 0) & (u <= board_px - 1) & (v <= board_px - 1)
    u0 = np.clip(np.floor(u).astype(np.int64), 0, board_px - 2)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, board_px - 2)
    fu = np.clip(u - u0, 0, 1)[..., None]
    fv = np.clip(v - v0, 0, 1)[..., None]
    b = board.astype(np.float64)
    top = b[v0, u0] * (1 - fu) + b[v0, u0 + 1] * fu
    bot = b[v0 + 1, u0] * (1 - fu) + b[v0 + 1, u0 + 1] * fu
    warped = np.rint(top * (1 - fv) + bot * fv)
    frame = np.full((h, w, 3), bg, np.float64)
    frame[inside] = warped[inside]
    frame = frame.astype(np.uint8)
    if rng is not None and frame_noise > 0:
        frame = add_noise(frame, rng, frame_noise)
    return frame
