"""Auto-recalibration on calibration drift (session/drift.py).

Beyond reference scope: the reference's geometry is write-once (manual 'c'
only re-captures visual references, play_lichess.py:65-67). Here a bumped
camera is detected by periodic auto corner detection and the session
rebuilds its geometry mid-game, preserving game state — verified by
playing a move through the vision path AFTER the bump.
"""

import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame  # noqa: E402

from chessboard_vision.session.drift import DriftMonitor  # noqa: E402
from chessboard_vision.session.game_session import GameSession  # noqa: E402


BUMP = np.array([[12, 7]] * 4, np.float64)  # a rigid camera nudge


def _config(**extra):
    cfg = {
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "white",
        "orientation_flipped": False,
    }
    cfg.update(extra)
    return cfg


class TestDriftMonitor:
    def test_bump_reported_once_with_bias_cancelled(self, rng=None):
        rng = np.random.default_rng(3)
        occ = initial_occupancy()
        mon = DriftMonitor(np.asarray(DEFAULT_CORNERS, np.float64), confirm=2)
        # baseline + steady checks at the calibrated corners: no drift
        for _ in range(3):
            assert mon.check(make_board_frame(occ, rng)) is None
        bumped = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP
        # first bumped check only arms the pending detection
        assert mon.check(make_board_frame(occ, rng, corners=bumped)) is None
        new = mon.check(make_board_frame(occ, rng, corners=bumped))
        assert new is not None
        # relative shift applied to the CALIBRATED corners (detector bias
        # cancels): within a pixel of the true bumped corners
        assert np.abs(new - bumped).max() <= 1.5, new - bumped
        # re-based: the same bumped scene reports nothing further
        for _ in range(3):
            assert mon.check(make_board_frame(occ, rng, corners=bumped)) is None

    def test_unstable_detections_never_confirm(self):
        rng = np.random.default_rng(4)
        occ = initial_occupancy()
        mon = DriftMonitor(np.asarray(DEFAULT_CORNERS, np.float64), confirm=2)
        assert mon.check(make_board_frame(occ, rng)) is None  # baseline
        base = np.asarray(DEFAULT_CORNERS, np.float64)
        # detections jump around (hand/occlusion): pending never agrees twice
        for k in range(6):
            wobble = base + BUMP * (1 + 2 * (k % 2))
            assert mon.check(make_board_frame(occ, rng, corners=wobble)) is None


class TestSessionAutoRecalibration:
    def test_move_commits_after_camera_bump(self):
        """Full loop: calibrate -> bump the camera -> session detects drift,
        rebuilds geometry mid-game -> a move played at the NEW corners is
        still resolved to e2e4 (game state preserved across recalibration)."""
        rng = np.random.default_rng(5)
        session = GameSession(headless=True)
        session.configure(_config(
            auto_recalibrate=True,
            drift_check_interval=5,
            drift_confirm_checks=2,
        ))
        session.STABILITY_REQUIRED = 4
        session.MOVE_COOLDOWN = 0.0

        occ = initial_occupancy()
        session.capture_reference_frame(make_board_frame(occ, rng))

        for _ in range(6):  # healthy frames at the original corners
            assert session.on_frame(make_board_frame(occ, rng)) is None

        bumped = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP
        old_corners = [list(map(int, c)) for c in np.asarray(DEFAULT_CORNERS)]
        # enough bumped frames to hit >= 2 drift checks (interval 5)
        for _ in range(12):
            session.on_frame(make_board_frame(occ, rng, corners=bumped))
        assert session.config["corners"] != old_corners, "no recalibration"
        got = np.asarray(session.config["corners"], np.float64)
        assert np.abs(got - bumped).max() <= 2.0

        # play e2e4 at the NEW corners; the rebuilt pipeline must see it
        occ_after = occ.copy()
        occ_after[4, 1] = False
        occ_after[4, 3] = True
        move = None
        for _ in range(14):
            move = session.on_frame(
                make_board_frame(occ_after, rng, corners=bumped)
            ) or move
        assert move is not None and move.uci() == "e2e4"
        assert session.game.board.fullmove_number >= 1


class TestMultiStreamAutoRecalibration:
    def test_one_rig_bumped_other_keeps_playing(self):
        """Stream 0's camera gets bumped; the batched session rebuilds in
        per-stream-geometry mode and BOTH streams then commit moves at
        their (new/old) corners — games preserved across the rebuild."""
        from chessboard_vision import geometry as geo
        from chessboard_vision.parallel.session import MultiStreamSession

        rng = np.random.default_rng(6)
        g = geo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS))
        sess = MultiStreamSession(
            g, n_streams=2,
            auto_recalibrate=True, drift_check_interval=4, drift_confirm=2,
        )
        sess.STABILITY_REQUIRED = 4
        sess.MOVE_COOLDOWN = 0.0

        occ = initial_occupancy()
        def frames(occ0, occ1, c0=DEFAULT_CORNERS, c1=DEFAULT_CORNERS):
            return np.stack([
                make_board_frame(occ0, rng, corners=c0),
                make_board_frame(occ1, rng, corners=c1),
            ])

        sess.capture_reference(frames(occ, occ))
        for _ in range(5):
            assert sess.on_frames(frames(occ, occ)) == [None, None]

        bumped = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP
        for _ in range(10):  # >= 2 drift checks at interval 4
            sess.on_frames(frames(occ, occ, c0=bumped))
        assert sess.ms._stream_plans is not None, "no per-stream rebuild"
        got = np.asarray(sess.geometries[0].src_corners, np.float64)
        assert np.abs(got - bumped).max() <= 2.0

        # both streams play e2e4 at their current corners
        occ_after = occ.copy()
        occ_after[4, 1] = False
        occ_after[4, 3] = True
        committed = [None, None]
        for _ in range(14):
            moves = sess.on_frames(frames(occ_after, occ_after, c0=bumped))
            committed = [m or c for m, c in zip(moves, committed)]
        assert [m and m.uci() for m in committed] == ["e2e4", "e2e4"]


def test_checkpoint_after_recalibration_resumes_with_new_corners(tmp_path):
    """The drift and checkpoint features compose: a session that
    auto-recalibrated saves the UPDATED corners in its checkpoint; a fresh
    process resuming it builds the shifted geometry and keeps seeing the
    board (move committed at the bumped corners post-resume)."""
    rng = np.random.default_rng(9)
    session = GameSession(headless=True)
    session.configure(_config(
        auto_recalibrate=True, drift_check_interval=5, drift_confirm_checks=2,
    ))
    session.STABILITY_REQUIRED = 4
    session.MOVE_COOLDOWN = 0.0

    occ = initial_occupancy()
    session.capture_reference_frame(make_board_frame(occ, rng))
    bumped = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP
    for _ in range(12):
        session.on_frame(make_board_frame(occ, rng, corners=bumped))
    got = np.asarray(session.config["corners"], np.float64)
    assert np.abs(got - bumped).max() <= 2.0, "bump not recalibrated"

    ckpt = str(tmp_path / "drifted.npz")
    session.save_checkpoint(ckpt)

    fresh = GameSession(headless=True)
    fresh.STABILITY_REQUIRED = 4
    fresh.MOVE_COOLDOWN = 0.0
    fresh.resume_checkpoint(ckpt)
    assert np.abs(
        np.asarray(fresh.config["corners"], np.float64) - bumped
    ).max() <= 2.0

    occ_after = occ.copy()
    occ_after[4, 1] = False
    occ_after[4, 3] = True
    move = None
    for _ in range(14):
        move = fresh.on_frame(
            make_board_frame(occ_after, rng, corners=bumped)
        ) or move
    assert move is not None and move.uci() == "e2e4"


def test_huge_shift_is_treated_as_misdetection():
    """Gate 2's upper bound: a 'shift' beyond max_px is a contour
    misdetection (locked onto another rectangle), not a bump — never
    confirmed no matter how consistent."""
    rng = np.random.default_rng(10)
    occ = initial_occupancy()
    mon = DriftMonitor(
        np.asarray(DEFAULT_CORNERS, np.float64), confirm=2, max_px=80.0
    )
    assert mon.check(make_board_frame(occ, rng)) is None  # baseline
    far = np.asarray(DEFAULT_CORNERS, np.float64) + np.array([[120, 0]] * 4)
    for _ in range(4):
        assert mon.check(make_board_frame(occ, rng, corners=far)) is None


def test_enhanced_session_survives_per_stream_rebuild():
    """with_enhancer composes with drift recalibration: a bumped rig
    forces the batched session into per-stream-geometry mode, where the
    enhancer's color warp must ride PER-STREAM tile plans (the round-4
    extraction path) — both streams keep committing moves after the
    rebuild with the enhancement still fused in."""
    from chessboard_vision import geometry as geo
    from chessboard_vision.parallel.session import MultiStreamSession

    rng = np.random.default_rng(13)
    g = geo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS))
    sess = MultiStreamSession(
        g, n_streams=2,
        auto_recalibrate=True, drift_check_interval=4, drift_confirm=2,
        with_enhancer=True,
        enhancer_profile={"contrast": 1.05, "brightness": 3},
    )
    sess.STABILITY_REQUIRED = 4
    sess.MOVE_COOLDOWN = 0.0
    assert sess.ms.pipe.with_enhancer

    occ = initial_occupancy()

    def frames(occ0, occ1, c0=DEFAULT_CORNERS, c1=DEFAULT_CORNERS):
        return np.stack([
            make_board_frame(occ0, rng, corners=c0),
            make_board_frame(occ1, rng, corners=c1),
        ])

    sess.capture_reference(frames(occ, occ))
    for _ in range(5):
        assert sess.on_frames(frames(occ, occ)) == [None, None]

    bumped = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP
    for _ in range(10):  # >= 2 drift checks at interval 4
        sess.on_frames(frames(occ, occ, c0=bumped))
    assert sess.ms._stream_plans is not None, "no per-stream rebuild"
    assert sess.ms.pipe.with_enhancer, "enhancer lost across the rebuild"

    occ_after = occ.copy()
    occ_after[4, 1] = False
    occ_after[4, 3] = True
    committed = [None, None]
    for _ in range(14):
        moves = sess.on_frames(frames(occ_after, occ_after, c0=bumped))
        committed = [m or c for m, c in zip(moves, committed)]
    assert [m and m.uci() for m in committed] == ["e2e4", "e2e4"]
