"""Parity tests: geometry + device warp/split vs the OpenCV reference path.

The reference per-frame geometry is cv2.warpPerspective (board_detection.py
:61-71) followed by dict-of-crops splitting (grid_extractor.py). Here the
whole thing is a precomputed-gather device op; we assert:
- corner reorder and homography match cv2
- warp output within 1 intensity level of cv2.warpPerspective (<1% pixels)
- square extraction is exactly the reference crop for every square, for both
  linear and smart (irregular) grids, with and without 180-degree flip
- the baked-in reflect border + valid blur equals per-crop cv2.GaussianBlur
"""

import cv2
import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.ops import warp as W
from chessboard_vision.ops.filters import gaussian_blur_valid

CORNERS = np.array([[173, 133], [1100, 110], [150, 650], [1131, 680]])


def _frame(rng):
    return rng.integers(0, 256, (720, 1280, 3), np.uint8)


def _ref_warp(img, corners, flip=False):
    pts = geo.reorder(corners)
    bs = 620
    pts2 = np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]])
    M = cv2.getPerspectiveTransform(np.float32(pts).reshape(4, 2), pts2)
    warped = cv2.warpPerspective(img, M, (bs, bs))
    if flip:
        warped = cv2.rotate(warped, cv2.ROTATE_180)
    return warped


def _ref_split(warped, grid_x=None, grid_y=None):
    """Reference split_board semantics -> {(file, rank): crop}."""
    out = {}
    if grid_x is None:
        h, w = warped.shape[:2]
        sh, sw = h // 8, w // 8
        for r in range(8):
            for c in range(8):
                out[(c, 7 - r)] = warped[r * sh : (r + 1) * sh, c * sw : (c + 1) * sw]
    else:
        for r in range(8):
            for c in range(8):
                out[(c, 7 - r)] = warped[
                    grid_y[r] : grid_y[r + 1], grid_x[c] : grid_x[c + 1]
                ]
    return out


class TestReorderAndHomography:
    def test_reorder_matches_reference_rule(self):
        got = geo.reorder(CORNERS)
        assert got[0, 0].tolist() == [173, 133]  # TL
        assert got[1, 0].tolist() == [1100, 110]  # TR
        assert got[2, 0].tolist() == [150, 650]  # BL
        assert got[3, 0].tolist() == [1131, 680]  # BR

    def test_homography_matches_cv2(self):
        pts = geo.reorder(CORNERS)
        M, bs = geo.warp_matrix(pts)
        assert bs == 620
        pts2 = np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]])
        M_cv = cv2.getPerspectiveTransform(np.float32(pts).reshape(4, 2), pts2)
        assert np.allclose(M, M_cv, atol=1e-9)


class TestWarp:
    def test_warp_close_to_cv2(self, rng):
        img = _frame(rng)
        g = geo.BoardGeometry.from_calibration(CORNERS)
        dg = W.DeviceGeometry.from_host(g)
        ours = np.asarray(W.frame_to_board(img, dg)).astype(int)
        ref = _ref_warp(img, CORNERS).astype(int)
        d = np.abs(ours - ref)
        assert d.max() <= 1
        assert (d > 0).mean() < 0.01

    def test_warp_flipped(self, rng):
        img = _frame(rng)
        g = geo.BoardGeometry.from_calibration(CORNERS, orientation_flipped=True)
        dg = W.DeviceGeometry.from_host(g)
        ours = np.asarray(W.frame_to_board(img, dg)).astype(int)
        ref = _ref_warp(img, CORNERS, flip=True).astype(int)
        assert np.abs(ours - ref).max() <= 1


class TestSquares:
    def test_linear_split_exact(self, rng):
        img = _frame(rng)
        g = geo.BoardGeometry.from_calibration(CORNERS, blur_pad=0)
        dg = W.DeviceGeometry.from_host(g)
        board = np.asarray(W.frame_to_board(img, dg))
        squares = np.asarray(W.extract_squares(board, dg))
        ref = _ref_split(board)
        assert squares.shape == (64, 77, 77, 3)
        for (f, r), crop in ref.items():
            sq = r * 8 + f
            assert np.array_equal(squares[sq], crop), (f, r)

    def test_smart_grid_split_exact(self, rng):
        img = _frame(rng)
        # Irregular grid lines (like a refined smart grid)
        gx = [0, 75, 155, 232, 310, 389, 466, 543, 620]
        gy = [0, 80, 157, 233, 308, 387, 464, 542, 620]
        g = geo.BoardGeometry.from_calibration(
            CORNERS, grid_lines_x=gx, grid_lines_y=gy, blur_pad=0
        )
        dg = W.DeviceGeometry.from_host(g)
        board = np.asarray(W.frame_to_board(img, dg))
        squares = np.asarray(W.extract_squares(board, dg))
        ref = _ref_split(board, gx, gy)
        for (f, r), crop in ref.items():
            sq = r * 8 + f
            h, w = crop.shape[:2]
            assert g.squares.heights[sq] == h and g.squares.widths[sq] == w
            assert np.array_equal(squares[sq, :h, :w], crop), (f, r)
            assert g.squares.mask[sq, :h, :w].all()
            assert not g.squares.mask[sq, h:, :].any()
            assert not g.squares.mask[sq, :, w:].any()

    def test_padded_extraction_blur_matches_per_crop_cv2(self, rng):
        """reflect-101 border baked into the gather + valid blur == cv2 blur per crop."""
        img = _frame(rng)
        gx = [0, 75, 155, 232, 310, 389, 466, 543, 620]
        gy = [0, 80, 157, 233, 308, 387, 464, 542, 620]
        g = geo.BoardGeometry.from_calibration(
            CORNERS, grid_lines_x=gx, grid_lines_y=gy, blur_pad=2
        )
        dg = W.DeviceGeometry.from_host(g)
        board = np.asarray(W.frame_to_board(img, dg))
        gray = cv2.cvtColor(board, cv2.COLOR_BGR2GRAY)
        squares_gray = np.asarray(W.extract_squares(gray, dg))  # (64, H+4, W+4)
        blurred = np.asarray(gaussian_blur_valid(squares_gray, 5))  # (64, H, W)
        ref = _ref_split(gray, gx, gy)
        for (f, r), crop in ref.items():
            sq = r * 8 + f
            h, w = crop.shape[:2]
            ref_blur = cv2.GaussianBlur(crop, (5, 5), 0)
            assert np.array_equal(blurred[sq, :h, :w], ref_blur), (f, r)

    def test_masked_reductions(self, rng):
        gx = [0, 75, 155, 232, 310, 389, 466, 543, 620]
        gy = [0, 80, 157, 233, 308, 387, 464, 542, 620]
        g = geo.BoardGeometry.from_calibration(
            CORNERS, grid_lines_x=gx, grid_lines_y=gy, blur_pad=0
        )
        dg = W.DeviceGeometry.from_host(g)
        board = rng.integers(0, 256, (620, 620), np.uint8)
        squares = np.asarray(W.extract_squares(board, dg))
        mu = np.asarray(W.masked_mean(squares, dg.sq_mask, dg.sq_counts))
        sd = np.asarray(W.masked_std(squares, dg.sq_mask, dg.sq_counts))
        ref = _ref_split(board, gx, gy)
        for (f, r), crop in ref.items():
            sq = r * 8 + f
            assert abs(mu[sq] - crop.mean()) < 1e-2
            assert abs(sd[sq] - crop.std()) < 1e-2


class TestSmartGridRefine:
    def test_refine_grid_matches_reference_algorithm(self, rng):
        # Build a synthetic board with visible grid lines slightly off-linear
        board = np.full((620, 620, 3), 180, np.uint8)
        gx_true = [0, 76, 153, 235, 309, 390, 465, 541, 620]
        gy_true = [0, 79, 156, 230, 312, 388, 467, 543, 620]
        for x in gx_true[1:8]:
            board[:, x - 1 : x + 1] = 30
        for y in gy_true[1:8]:
            board[y - 1 : y + 1, :] = 30
        gx, gy = geo.refine_grid(board)
        # Peaks should land on/adjacent to the painted lines
        for found, true in zip(gx[1:8], gx_true[1:8]):
            assert abs(found - true) <= 2
        for found, true in zip(gy[1:8], gy_true[1:8]):
            assert abs(found - true) <= 2
        assert gx[0] == 0 and gx[8] == 620


def test_from_config_honors_display_size():
    """"display_size": [w, h] in calibration.json overrides the reference's
    fixed 1280x720 capture assumption (sessions at other resolutions)."""
    from chessboard_vision import geometry as geo

    cfg = {
        "corners": [[100, 50], [1800, 60], [90, 1000], [1810, 1010]],
        "display_size": [1920, 1080],
    }
    g = geo.BoardGeometry.from_config(cfg)
    assert (g.src_w, g.src_h) == (1920, 1080)
    assert g.board_size == 1080 - 100
