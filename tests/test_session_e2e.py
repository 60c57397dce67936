"""Full-session end-to-end: synthetic camera clip -> committed legal move.

Drives GameSession.on_frame with rendered frames (calibration config ->
pipeline -> noise FSM -> stability gate -> move inference -> board push)
and checks the move lands on the rules board — the whole stack minus real
camera and network.
"""

import numpy as np
import pytest

from chessboard_vision.session.game_session import GameSession
from chessboard_vision.rules import chess

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS


def make_config():
    return {
        "corners": DEFAULT_CORNERS.tolist(),
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    }


@pytest.fixture(scope="module")
def session_and_frames():
    rng = np.random.default_rng(77)
    s = GameSession(headless=True)
    s.MOVE_COOLDOWN = 0.0  # no wall-clock wait in tests
    assert s.on_calibration_requested(None, config=make_config())
    occ0 = initial_occupancy()
    frame0 = make_board_frame(occ0, rng)
    s.capture_reference_frame(frame0)
    return s, rng, occ0


def test_move_detected_and_committed(session_and_frames):
    s, rng, occ0 = session_and_frames
    # Warm-up stable frames on the initial position: no move inferred.
    for _ in range(5):
        move = s.on_frame(make_board_frame(occ0, rng))
        assert move is None

    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2 -> e4

    committed = None
    for i in range(40):
        committed = s.on_frame(make_board_frame(occ1, rng))
        if committed:
            break
    assert committed is not None, "move was never committed"
    assert committed.uci() == "e2e4"
    assert s.game.board.move_stack[-1].uci() == "e2e4"
    assert s.game.get_turn_name() == "black"


def test_second_move_by_black(session_and_frames):
    s, rng, occ0 = session_and_frames
    occ2 = occ0.copy()
    occ2[4, 1] = False
    occ2[4, 3] = True
    occ2[4, 6] = False
    occ2[4, 4] = True  # e7 -> e5

    committed = None
    for _ in range(40):
        committed = s.on_frame(make_board_frame(occ2, rng))
        if committed:
            break
    assert committed is not None and committed.uci() == "e7e5"
    assert s.game.get_turn_name() == "white"


def test_hand_occlusion_blocks_commit(session_and_frames):
    s, rng, occ0 = session_and_frames
    # Current position after e4 e5
    occ = occ0.copy()
    occ[4, 1] = False
    occ[4, 3] = True
    occ[4, 6] = False
    occ[4, 4] = True
    base = make_board_frame(occ, rng)
    hand = base.copy()
    hand[200:560, 400:900] = (120, 110, 100)
    for _ in range(6):
        move = s.on_frame(hand)
        assert move is None
    assert s.noise.is_blocked() or s.stable_count < s.STABILITY_REQUIRED
    # Recover with clean frames; no phantom move appears.
    for _ in range(25):
        move = s.on_frame(make_board_frame(occ, rng))
        assert move is None


@pytest.mark.slow
def test_session_with_enhancer_config_key():
    """BASELINE config-5 (full session loop) with config-1 semantics
    (5-stage enhancement) applied: the "use_enhancer" calibration key
    builds the fused enhanced pipeline, and the session still detects and
    commits a move end-to-end. The reference constructed its enhancer but
    never wired it into the loop (SURVEY.md §3.5)."""
    rng = np.random.default_rng(78)
    s = GameSession(headless=True)
    s.MOVE_COOLDOWN = 0.0
    cfg = make_config()
    cfg["use_enhancer"] = True
    cfg["enhancer_profile"] = {"contrast": 1.05, "brightness": 2}
    assert s.on_calibration_requested(None, config=cfg)
    assert s.pipeline.with_enhancer
    assert s.pipeline.enhancer_profile["contrast"] == 1.05

    occ0 = initial_occupancy()
    s.capture_reference_frame(make_board_frame(occ0, rng))
    for _ in range(5):
        assert s.on_frame(make_board_frame(occ0, rng)) is None

    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    committed = None
    for _ in range(40):
        committed = s.on_frame(make_board_frame(occ1, rng))
        if committed:
            break
    assert committed is not None and committed.uci() == "e2e4"
    assert s.game.board.move_stack[-1].uci() == "e2e4"


def test_frame_based_cooldown_replaces_wall_clock():
    """With cooldown_frames set, the post-move cooldown counts SOURCE
    frames instead of wall seconds — the recorded-footage semantic
    (processing faster than realtime must not drop the next move, and a
    huge wall cooldown must not gate at all)."""
    rng = np.random.default_rng(79)
    s = GameSession(headless=True)
    s.MOVE_COOLDOWN = 1e9  # wall clock would block forever
    s.cooldown_frames = 5  # ...but the frames basis rules
    assert s.on_calibration_requested(None, config=make_config())
    occ0 = initial_occupancy()
    s.capture_reference_frame(make_board_frame(occ0, rng))
    for _ in range(3):
        assert s.on_frame(make_board_frame(occ0, rng)) is None

    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    committed = None
    for _ in range(40):
        committed = s.on_frame(make_board_frame(occ1, rng))
        if committed:
            break
    assert committed is not None and committed.uci() == "e2e4"

    occ2 = occ1.copy()
    occ2[4, 6] = False
    occ2[4, 4] = True  # e7e5
    committed = None
    for _ in range(45):
        committed = s.on_frame(make_board_frame(occ2, rng))
        if committed:
            break
    assert committed is not None and committed.uci() == "e7e5"


def test_frame_based_cooldown_suppresses_within_window():
    """A second stable position inside the cooldown window does not
    commit until the window has passed."""
    rng = np.random.default_rng(80)
    s = GameSession(headless=True)
    s.cooldown_frames = 10**6  # nothing after the first move may commit
    assert s.on_calibration_requested(None, config=make_config())
    occ0 = initial_occupancy()
    s.capture_reference_frame(make_board_frame(occ0, rng))
    for _ in range(3):
        assert s.on_frame(make_board_frame(occ0, rng)) is None

    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    committed = None
    for _ in range(40):
        committed = s.on_frame(make_board_frame(occ1, rng))
        if committed:
            break
    assert committed is not None and committed.uci() == "e2e4"

    occ2 = occ1.copy()
    occ2[4, 6] = False
    occ2[4, 4] = True  # e7e5 — inside the window: must NOT commit
    for _ in range(45):
        assert s.on_frame(make_board_frame(occ2, rng)) is None
