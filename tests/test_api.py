"""Top-level convenience API (chessboard_vision.api) — the
BASELINE-named entry points, parity-checked against the oracle paths."""

import numpy as np
import pytest

import chessboard_vision as cbv

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame


@pytest.fixture(scope="module")
def frame_pair():
    rng = np.random.default_rng(77)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    return make_board_frame(occ0, rng), make_board_frame(occ1, rng), occ1


def test_lazy_exports():
    assert cbv.VisionPipeline.__name__ == "VisionPipeline"
    assert cbv.GameSession.__name__ == "GameSession"
    with pytest.raises(AttributeError):
        cbv.nonexistent_thing


def test_extract_grid(frame_pair):
    f0, _, _ = frame_pair
    squares = cbv.extract_grid(f0, DEFAULT_CORNERS)
    assert set(squares) == {(f, r) for f in range(8) for r in range(8)}
    sq = squares[(0, 0)]
    assert sq.ndim == 3 and sq.shape[2] == 3 and min(sq.shape[:2]) > 60


def test_enhance_frame(frame_pair):
    f0, _, _ = frame_pair
    small = f0[:240, :320]
    out = cbv.enhance_frame(small)
    assert out.shape == small.shape and out.dtype == np.uint8
    assert not np.array_equal(out, small)


def test_detect_pieces_and_fen(frame_pair):
    f0, f1, occ1 = frame_pair
    occ = cbv.detect_pieces(f1, DEFAULT_CORNERS, reference_frame=f0)
    want = {(f, r) for f in range(8) for r in range(8) if occ1[f, r]}
    assert occ == want
    fen = cbv.frame_to_fen(f1, DEFAULT_CORNERS, reference_frame=f0)
    assert fen.split()[0] == "PPPPPPPP/PPPPPPPP/8/8/4P3/8/PPPP1PPP/PPPPPPPP"


def test_detect_changes(frame_pair):
    f0, f1, _ = frame_pair
    changed = cbv.detect_changes(f1, DEFAULT_CORNERS, reference_frame=f0)
    # The move squares must be flagged; noise must not flood the board.
    assert (4, 1) in changed and (4, 3) in changed
    assert len(changed) <= 8


def test_generate_fen_reference_api():
    # reference fen_generator API: labeled detections -> board map -> FEN
    detections = [
        {"center": (30, 30), "class": "white-rook", "conf": 0.9},
        {"center": (100, 30), "class": "black-king", "conf": 0.8},
    ]
    from chessboard_vision.api import map_detections_to_board

    board_map = map_detections_to_board(detections, board_size=620)
    fen = cbv.generate_fen(board_map)
    assert fen.split()[0] == "Rk6/8/8/8/8/8/8/8"


def test_digitize_video_one_call(tmp_path):
    """api.digitize_video: video file -> moves + FEN + PGN in one call."""
    import cv2
    import chessboard_vision as cbv
    from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

    rng = np.random.default_rng(11)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True
    frames = [make_board_frame(occ0, rng) for _ in range(8)]
    frames += [make_board_frame(occ1, rng) for _ in range(26)]
    path = str(tmp_path / "game.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()

    out = cbv.digitize_video(path, corners=DEFAULT_CORNERS, skip_frames=1)
    assert out["moves"] == ["e2e4"]
    assert out["fen"].split()[0].endswith("PPPP1PPP/RNBQKBNR")
    assert "1. e4 *" in out["pgn"]
    assert out["frames"] > 20
