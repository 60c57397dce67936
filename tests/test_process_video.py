"""Recorded-video processing tool (tools/process_video.py).

Builds a real video file (MJPG avi) from fixture frames — a scripted
e2e4 — and runs the tool's pipeline over it: reference capture from the
leading frames, SKIP_FRAMES cadence, move commit, JSONL timeline.

Also drives the COMMITTED MJPG file tests/data/game_clip.avi (a scripted
two-move game on the hard 'photographic' renderer with a textured-hand
interlude) against its pinned timeline — real recorded-video bytes in the
repo, not frames synthesized at test time. Regenerate with:
    python tests/test_process_video.py --regen
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest

from chessboard_vision.tools.process_video import parse_corners, run
from chessboard_vision.rules import chess

from fixtures import (
    DEFAULT_CORNERS,
    add_hand_sprite,
    make_board_frame,
    make_hard_board_frame,
)

HERE = os.path.dirname(os.path.abspath(__file__))
GAME_CLIP = os.path.join(HERE, "data", "game_clip.avi")
GAME_TIMELINE = os.path.join(HERE, "data", "game_clip_timeline.json")
DRIFT_CLIP = os.path.join(HERE, "data", "drift_clip.avi")
DRIFT_TIMELINE = os.path.join(HERE, "data", "drift_clip_timeline.json")

# Mid-footage camera bump for the drift clip: large enough that the
# unhealed geometry genuinely misreads the board (a 12 px bump measured
# as still readable — the cascade sees through it), while staying under
# the monitor's 80 px misdetection ceiling and inside the frame.
DRIFT_BUMP = np.array([28.0, 18.0])
DRIFT_CORNERS_B = np.asarray(DEFAULT_CORNERS, np.float64) + DRIFT_BUMP


def _occ(board):
    occ = np.zeros((8, 8), bool)
    for sq in chess.SQUARES:
        if board.piece_at(sq) is not None:
            occ[chess.square_file(sq), chess.square_rank(sq)] = True
    return occ


def test_parse_corners():
    assert parse_corners("1,2 3,4 5,6 7,8") == [[1, 2], [3, 4], [5, 6], [7, 8]]
    with pytest.raises(ValueError):
        parse_corners("1,2 3,4")


@pytest.mark.slow
def test_video_to_moves(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)

    board = chess.Board()
    frames = [make_board_frame(_occ(board), rng) for _ in range(4)]
    board.push_uci("e2e4")
    # skip_frames=2 halves the frames the session sees; stability needs
    # ~20 processed frames -> 56 raw frames of the new position.
    frames += [make_board_frame(_occ(board), rng) for _ in range(56)]

    path = str(tmp_path / "clip.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()

    config = {
        "corners": [list(map(int, c)) for c in np.asarray(DEFAULT_CORNERS)],
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    }
    out = str(tmp_path / "timeline.jsonl")
    moves, fen, n = run(path, config, skip_frames=2, out_path=out)
    assert moves == ["e2e4"]
    assert fen == board.fen()
    assert n >= 25

    lines = [json.loads(l) for l in open(out)]
    assert lines[0]["move"] == "e2e4"
    assert lines[-1]["final_fen"] == fen


@pytest.mark.slow
def test_compare_oracle_report(tmp_path):
    """--compare-oracle replays the same clip through the cv2 oracle
    decision loop and reports full decision agreement on a clean scripted
    game (the one-command validation bridge for user
    footage; reference test_piece_detector.py:49-116 is the human-judged
    path this operationalizes)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(13)

    board = chess.Board()
    frames = [make_board_frame(_occ(board), rng) for _ in range(4)]
    board.push_uci("e2e4")
    frames += [make_board_frame(_occ(board), rng) for _ in range(56)]

    path = str(tmp_path / "clip.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()

    out = str(tmp_path / "timeline.jsonl")
    moves, fen, n, report = run(
        path, _clip_config(), skip_frames=2, out_path=out, compare_oracle=True
    )
    assert moves == ["e2e4"]
    assert report["move_lists_match"], report
    assert report["fen_match"], report
    assert report["oracle_moves"] == ["e2e4"]
    assert report["frames_compared"] == n
    assert report["square_agreement_pct"] >= 99.0, report
    assert report["first_divergent_move"] is None
    # the report also lands in the JSONL timeline
    lines = [json.loads(l) for l in open(out)]
    assert "oracle_comparison" in lines[-1]
    assert lines[-1]["oracle_comparison"]["fen_match"]


def _game_clip_frames():
    """Deterministic scripted 2-move game (e2e4, e7e5) on the hard
    renderer, with a textured-hand reach between the moves."""
    rng = np.random.default_rng(21)
    board = chess.Board()
    frames = [make_hard_board_frame(_occ(board), rng, t=0.3) for _ in range(4)]
    board.push_uci("e2e4")
    frames += [make_hard_board_frame(_occ(board), rng, t=0.3) for _ in range(28)]
    hand = add_hand_sprite(make_hard_board_frame(_occ(board), rng, t=0.3), rng)
    frames += [hand, hand.copy()]
    board.push_uci("e7e5")
    frames += [make_hard_board_frame(_occ(board), rng, t=0.3) for _ in range(28)]
    return frames, board


def _clip_config():
    return {
        "corners": [list(map(int, c)) for c in np.asarray(DEFAULT_CORNERS)],
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    }


def _decoded_clip_hash(path):
    import cv2

    cap = cv2.VideoCapture(path)
    h = hashlib.sha256()
    while True:
        ok, img = cap.read()
        if not ok:
            break
        h.update(img.tobytes())
    cap.release()
    return h.hexdigest()


@pytest.mark.slow
def test_committed_game_clip_matches_pinned_timeline():
    """The committed MJPG file plays frame-to-FEN to the pinned timeline
    (BASELINE's 'recorded game footage' clause on actual video bytes)."""
    if not os.path.exists(GAME_CLIP):
        pytest.skip("committed clip missing (regen: python tests/test_process_video.py --regen)")
    with open(GAME_TIMELINE) as fh:
        pinned = json.load(fh)
    if _decoded_clip_hash(GAME_CLIP) != pinned["decoded_sha256"]:
        # A different OpenCV/libjpeg build decodes different pixels; a
        # mismatch would say nothing about this code (same policy as the
        # 'video' regression clip).
        pytest.skip("MJPG decodes differently from the pinning environment")
    out_moves, fen, n = run(GAME_CLIP, _clip_config(), skip_frames=1)
    assert out_moves == pinned["moves"]
    assert fen == pinned["final_fen"]
    assert n == pinned["frames_processed"]


def _drift_clip_frames():
    """Scripted game with a mid-footage CAMERA BUMP: e2e4 at the original
    corners, then every later frame is shot from the bumped rig, and e7e5
    is only readable after the session self-heals its geometry
    (the drift path on recorded video bytes)."""
    rng = np.random.default_rng(31)
    board = chess.Board()
    frames = [make_board_frame(_occ(board), rng) for _ in range(7)]
    board.push_uci("e2e4")
    frames += [make_board_frame(_occ(board), rng) for _ in range(26)]
    # the bump: same position, shifted corners
    frames += [
        make_board_frame(_occ(board), rng, corners=DRIFT_CORNERS_B)
        for _ in range(18)
    ]
    board.push_uci("e7e5")
    frames += [
        make_board_frame(_occ(board), rng, corners=DRIFT_CORNERS_B)
        for _ in range(26)
    ]
    return frames, board


def _drift_config():
    return {
        **_clip_config(),
        "auto_recalibrate": True,
        "drift_check_interval": 6,
        "drift_confirm_checks": 2,
    }


def _run_drift_clip():
    """process_video over the drift clip with --auto-recalibrate
    semantics; returns (moves, fen, n, session) so callers can assert the
    geometry really was rebuilt."""
    from chessboard_vision.session.game_session import GameSession

    session = GameSession(headless=True)
    session.MOVE_COOLDOWN = 0.0
    moves, fen, n = run(
        DRIFT_CLIP, _drift_config(), skip_frames=1, session=session
    )
    return moves, fen, n, session


@pytest.mark.slow
def test_drift_clip_recalibrates_and_matches_pinned_timeline():
    """The committed drift-bump MJPG plays frame-to-FEN through
    process_video with auto-recalibration: e2e4 commits at the original
    corners, the bump is detected and the geometry rebuilt mid-footage,
    and e7e5 commits at the NEW corners — all against a pinned timeline."""
    if not (os.path.exists(DRIFT_CLIP) and os.path.exists(DRIFT_TIMELINE)):
        pytest.skip("committed drift clip/timeline missing (regen: python tests/test_process_video.py --regen drift)")
    with open(DRIFT_TIMELINE) as fh:
        pinned = json.load(fh)
    if _decoded_clip_hash(DRIFT_CLIP) != pinned["decoded_sha256"]:
        pytest.skip("MJPG decodes differently from the pinning environment")
    out_moves, fen, n, session = _run_drift_clip()
    assert out_moves == pinned["moves"]
    assert fen == pinned["final_fen"]
    assert n == pinned["frames_processed"]
    # the session's corners must have moved to (about) the bumped rig
    got = np.asarray(session.config["corners"], np.float64)
    assert np.abs(got - DRIFT_CORNERS_B).max() <= 2.0, got - DRIFT_CORNERS_B


if __name__ == "__main__":
    if "--regen" in sys.argv:
        # Direct-script runs bypass tests/conftest.py: pin the CPU
        # platform before any jax use, so the regenerated timelines come
        # from the same backend the tests run on.
        import jax

        jax.config.update("jax_platforms", "cpu")
        import cv2

        picked = [a for a in sys.argv[1:] if not a.startswith("-")]
        do_game = not picked or "game" in picked
        do_drift = not picked or "drift" in picked
        os.makedirs(os.path.dirname(GAME_CLIP), exist_ok=True)

        def write_mjpg(path, clip_frames):
            h, w = clip_frames[0].shape[:2]
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
            assert vw.isOpened()
            try:
                vw.set(cv2.VIDEOWRITER_PROP_QUALITY, 85)
            except AttributeError:
                pass
            for f in clip_frames:
                vw.write(f)
            vw.release()
            print(f"wrote {path} ({len(clip_frames)} frames, "
                  f"{os.path.getsize(path) / 1e6:.1f} MB)")

        if do_game:
            frames, board = _game_clip_frames()
            write_mjpg(GAME_CLIP, frames)
            out_moves, fen, n = run(GAME_CLIP, _clip_config(), skip_frames=1)
            expected_final = board.fen()
            assert out_moves == ["e2e4", "e7e5"], out_moves
            assert fen == expected_final, (fen, expected_final)
            payload = {
                "moves": out_moves,
                "final_fen": fen,
                "frames_processed": n,
                "decoded_sha256": _decoded_clip_hash(GAME_CLIP),
            }
            with open(GAME_TIMELINE, "w") as fh:
                json.dump(payload, fh, indent=1)
            print(f"pinned timeline -> {GAME_TIMELINE}: {payload['moves']} {fen}")

        if do_drift:
            dframes, dboard = _drift_clip_frames()
            write_mjpg(DRIFT_CLIP, dframes)

            # Oracle discipline: WITHOUT auto-recalibration the bumped half
            # of the footage must NOT produce the second move — proving the
            # bump actually breaks detection and the committed timeline's
            # e7e5 is the drift healer's doing.
            from chessboard_vision.session.game_session import GameSession

            base_session = GameSession(headless=True)
            base_session.MOVE_COOLDOWN = 0.0
            base_moves, _, _ = run(
                DRIFT_CLIP, _clip_config(), skip_frames=1, session=base_session
            )
            assert "e7e5" not in base_moves, (
                f"bump did not break detection (moves without healing: {base_moves})"
            )
            print(f"without auto-recalibrate: {base_moves} (e7e5 unreadable, as intended)")

            out_moves, fen, n, session = _run_drift_clip()
            expected_final = dboard.fen()
            assert out_moves == ["e2e4", "e7e5"], out_moves
            assert fen == expected_final, (fen, expected_final)
            got = np.asarray(session.config["corners"], np.float64)
            assert np.abs(got - DRIFT_CORNERS_B).max() <= 2.0, got - DRIFT_CORNERS_B
            payload = {
                "moves": out_moves,
                "final_fen": fen,
                "frames_processed": n,
                "decoded_sha256": _decoded_clip_hash(DRIFT_CLIP),
            }
            with open(DRIFT_TIMELINE, "w") as fh:
                json.dump(payload, fh, indent=1)
            print(f"pinned timeline -> {DRIFT_TIMELINE}: {payload['moves']} {fen}")
