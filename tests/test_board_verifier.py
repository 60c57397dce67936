"""Board-verifier tests (the working replacement for the reference's
orphan board_verifiers.py)."""

from chessboard_vision.rules import GameState
from chessboard_vision.session.board_verifier import (
    InitialBoardVerifier,
    IncrementalBoardVerifier,
    expected_initial_occupancy,
)


def test_initial_verifier_accepts_perfect_setup():
    ok, conf, report = InitialBoardVerifier().verify(expected_initial_occupancy())
    assert ok and conf == 1.0
    assert report["missing"] == [] and report["phantom"] == []


def test_initial_verifier_rejects_bad_setup():
    occ = expected_initial_occupancy()
    for sq in [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0)]:
        occ.discard(sq)
    ok, conf, report = InitialBoardVerifier().verify(occ)
    assert not ok
    assert len(report["missing"]) == 8


def test_initial_verifier_tolerates_one_error():
    occ = expected_initial_occupancy()
    occ.add((4, 4))  # one phantom piece
    ok, conf, _ = InitialBoardVerifier(threshold=0.90).verify(occ)
    assert ok and abs(conf - 63 / 64) < 1e-9


def test_incremental_verifier():
    gs = GameState()
    v = IncrementalBoardVerifier(gs.board)
    occ = v.expected_occupancy()
    ok, diff = v.verify_move(occ)
    assert ok and diff == 0
    occ.discard((4, 1))
    ok, diff = v.verify_move(occ)
    assert not ok and diff == 1
    ok, diff = v.verify_move(occ, tolerance=1)
    assert ok
