"""Deterministic repro of the vision-thread vs stream-thread race.

Mirrors reference test_race_condition.py: a mock Lichess client whose
make_move spawns a thread calling _sync_moves("e2e4") mid-commit (the
server echoing our move while we still hold the commit path). The
board_lock + double-checked _sync_moves must leave exactly one move on the
board and last_lichess_moves == "e2e4".
"""

import threading
import time

from chessboard_vision.rules import GameState, chess
from chessboard_vision.session.lichess_session import LichessSession
from chessboard_vision.session.noise import NoiseHandler


class MockLichessClient:
    """make_move succeeds and concurrently fires the server echo."""

    def __init__(self):
        self.sent = []
        self.session = None
        self.my_color = "white"
        self.echo_threads = []

    def make_move(self, uci):
        self.sent.append(uci)

        def echo():
            # Server echoes the move list while the vision thread is still
            # inside its commit critical section.
            self.session._sync_moves(uci)

        t = threading.Thread(target=echo)
        t.start()
        self.echo_threads.append(t)
        time.sleep(0.05)  # let the echo thread reach the lock
        return True

    def is_my_turn(self, moves_str):
        return len(moves_str.split()) % 2 == 0 if moves_str else True

    def get_last_move(self, moves_str):
        moves = moves_str.split() if moves_str else []
        return moves[-1] if moves else None


def make_session():
    s = LichessSession(client=MockLichessClient(), headless=True)
    s.lichess.session = s
    s.game = GameState()
    s.noise = NoiseHandler()
    # Vision stack not needed: we drive _process_stable_move directly.
    s.pipeline = None
    s._refresh_next = False
    s.stable_count = 0
    s.stable_occupancy = None
    s.last_move_time = 0.0
    return s


def test_commit_vs_stream_echo_race():
    s = make_session()
    s._refresh_references = lambda: None  # vision refresh not under test

    # Vision sees e2->e4 and has been stable long enough.
    occ = s.game.get_board_occupancy()
    occ.discard((4, 1))
    occ.add((4, 3))
    s.stable_occupancy = set(occ)
    s.stable_count = s.STABILITY_REQUIRED  # will increment to REQUIRED+1

    move = s._process_stable_move(occ, noise_state=None)
    for t in s.lichess.echo_threads:
        t.join(timeout=2)

    assert move is not None and move.uci() == "e2e4"
    assert s.lichess.sent == ["e2e4"]
    # Exactly one move on the board; no double-apply from the echo.
    assert len(s.game.board.move_stack) == 1
    assert s.game.board.peek().uci() == "e2e4"
    assert s.last_lichess_moves == "e2e4"
    assert s.waiting_for_opponent


def test_opponent_move_applies_via_sync():
    s = make_session()
    s._sync_moves("e2e4 e7e5")
    assert len(s.game.board.move_stack) == 2
    assert s.game.board.peek().uci() == "e7e5"
    assert not s.waiting_for_opponent  # our turn again (white)


def test_sync_is_idempotent():
    s = make_session()
    s._sync_moves("e2e4")
    fen1 = s.game.get_fen()
    s._sync_moves("e2e4")
    assert s.game.get_fen() == fen1
    assert len(s.game.board.move_stack) == 1


def test_not_my_turn_rejects_local_move():
    s = make_session()
    s.waiting_for_opponent = True
    assert not s.on_move_detected(chess.Move.from_uci("e2e4"))
    assert s.lichess.sent == []
