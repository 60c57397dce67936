"""Piece-color classification (light/dark) -> colored FEN.

The reference sketched a piece-type FEN API (fen_generator.py:5-10) but
never shipped a classifier; rules.classify_piece_colors +
StepOutputs.center_mean close that gap. Covers the classifier unit
behavior, colored-FEN serialization, and e2e parity against center means
computed from the cv2 oracle path.
"""

import cv2
import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.rules import classify_piece_colors, occupancy_to_colored_fen

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS


def test_classifier_two_clusters():
    means = np.zeros(64)
    occ = np.zeros(64, bool)
    occ[:8] = True
    means[:4] = [200.0, 210.0, 190.0, 205.0]  # light
    means[4:8] = [60.0, 55.0, 70.0, 65.0]  # dark
    out = classify_piece_colors(means, occ)
    assert list(out[:4]) == [1, 1, 1, 1]
    assert list(out[4:8]) == [0, 0, 0, 0]
    assert (out[8:] == -1).all()


def test_classifier_one_color_army_falls_back_to_midpoint():
    """Otsu always splits; a tight single cluster must NOT be split."""
    occ = np.zeros(64, bool)
    occ[:6] = True
    means = np.zeros(64)
    means[:6] = [200, 205, 210, 198, 202, 207]  # all light, spread < min_gap
    out = classify_piece_colors(means, occ)
    assert (out[:6] == 1).all()
    means[:6] = [60, 65, 70, 58, 62, 67]  # all dark
    out = classify_piece_colors(means, occ)
    assert (out[:6] == 0).all()


def test_classifier_ratio_mode_survives_glare():
    """Absolute means cross over under glare; center/corner ratios do not."""
    occ = np.zeros(64, bool)
    occ[:4] = True
    # squares 0-1: normal light; 2-3: dark pieces under a glare blob that
    # lifts their absolute center mean above the clean light pieces' level.
    center = np.zeros(64)
    corner = np.zeros(64)
    center[:2] = [200.0, 205.0]
    corner[:2] = [150.0, 160.0]
    center[2:4] = [210.0, 215.0]  # glare-lifted dark pieces
    corner[2:4] = [235.0, 240.0]  # background lifted even more
    # absolute classification gets the glared dark pieces wrong
    out_abs = classify_piece_colors(center, occ)
    assert list(out_abs[2:4]) == [1, 1]
    # ratio classification stays correct
    out = classify_piece_colors(center, occ, corner)
    assert list(out[:2]) == [1, 1]
    assert list(out[2:4]) == [0, 0]


def test_classifier_edge_cases():
    assert (classify_piece_colors(np.zeros(64), np.zeros(64, bool)) == -1).all()
    occ = np.zeros(64, bool)
    occ[10] = True
    m = np.zeros(64)
    m[10] = 220.0
    assert classify_piece_colors(m, occ)[10] == 1
    m[10] = 30.0
    assert classify_piece_colors(m, occ)[10] == 0


def test_colored_fen_serialization():
    occ = initial_occupancy()  # [file, rank]
    colors = np.full(64, -1, np.int8)
    for sq in range(64):
        f, r = sq % 8, sq // 8
        if occ[f, r]:
            colors[sq] = 1 if r <= 1 else 0
    fen = occupancy_to_colored_fen(occ, colors)
    assert fen.split()[0] == "pppppppp/pppppppp/8/8/8/8/PPPPPPPP/PPPPPPPP"


def _oracle_region_means(frame, corners):
    """Center-disc + corner means from the cv2 path (warp -> split -> gray)."""
    pts = geo.reorder(corners)
    bs = 620
    M = cv2.getPerspectiveTransform(
        np.float32(pts).reshape(4, 2),
        np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]]),
    )
    board = cv2.warpPerspective(frame, M, (bs, bs))
    squares = geo.split_board_dict(board)
    means = np.zeros(64)
    corner_means = np.zeros(64)
    for (f, r), img in squares.items():
        gray = cv2.GaussianBlur(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), (5, 5), 0)
        h, w = gray.shape
        yy, xx = np.mgrid[:h, :w]
        cs = min(h, w) // 4
        disk = ((xx - w // 2) ** 2 + (yy - h // 2) ** 2) <= cs * cs
        corner = np.zeros((h, w), bool)
        corner[:cs, :cs] = corner[:cs, w - cs :] = True
        corner[h - cs :, :cs] = corner[h - cs :, w - cs :] = True
        means[r * 8 + f] = gray[disk].mean()
        corner_means[r * 8 + f] = gray[corner].mean()
    return means, corner_means


def test_colored_fen_e2e_and_oracle_parity(rng):
    """Initial position: ranks 1-2 light, 7-8 dark; pipeline center means
    and oracle center means classify to the same colored FEN."""
    occ_grid = initial_occupancy()
    frame = make_board_frame(occ_grid, rng)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, hough_backend="exact")
    state = pipe.init_state()
    state, out = pipe.step(state, frame)

    occ64 = np.asarray(out.occupancy)
    assert occupancy_to_set(out.occupancy) == {
        (f, r) for f in range(8) for r in range(8) if occ_grid[f, r]
    }
    colors = classify_piece_colors(out.center_mean, occ64, np.asarray(out.corner_mean))
    fen = occupancy_to_colored_fen(occ64.reshape(8, 8).T, colors)
    assert fen.split()[0] == "pppppppp/pppppppp/8/8/8/8/PPPPPPPP/PPPPPPPP"

    ref_means, ref_corners = _oracle_region_means(frame, DEFAULT_CORNERS)
    ref_colors = classify_piece_colors(ref_means, occ64, ref_corners)
    ref_fen = occupancy_to_colored_fen(occ64.reshape(8, 8).T, ref_colors)
    assert ref_fen == fen
    # the means themselves agree closely (<=1-level gray path differences)
    assert np.abs(ref_means[occ64] - np.asarray(out.center_mean)[occ64]).max() < 3.0
    assert np.abs(ref_corners[occ64] - np.asarray(out.corner_mean)[occ64]).max() < 3.0
