"""Session/net behavior fixes from the round-2 deep review.

Covers: castling inference (the reference's pair matching finds 4 legal
candidates for a castling diff and can never commit one — fixed via the
exact 2v/2a pattern), from-position sync, sync abort on bad server moves,
finished-at-join detection, dead-stream reconnect budget, seek semantics,
and the noise FSM's lifted-square refresh.
"""

import json
import logging
from unittest import mock

import pytest

from chessboard_vision.rules import chess
from chessboard_vision.rules.game_state import GameState
from chessboard_vision.session.game_session import GameSession
from chessboard_vision.session.lichess_session import LichessSession
from chessboard_vision.session.noise import NoiseHandler, NoiseState
from chessboard_vision.net.lichess_client import LichessClient


def _bare_session():
    s = GameSession.__new__(GameSession)
    s.game = GameState()
    s.log = logging.getLogger("test")
    return s


class TestCastlingInference:
    def _ready_to_castle(self):
        s = _bare_session()
        s.game.set_fen("r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N1B/PPPPQPPP/RNB1K2R w KQkq - 0 1")
        return s

    def test_kingside_castle_inferred(self):
        s = self._ready_to_castle()
        move = s._infer_move({(4, 0), (7, 0)}, {(6, 0), (5, 0)}, set())
        assert move is not None and move.uci() == "e1g1"

    def test_non_castling_2v2a_still_ambiguous_or_none(self):
        s = self._ready_to_castle()
        # arbitrary 2v/2a diff that is NOT the castling pattern
        move = s._infer_move({(0, 1), (1, 1)}, {(0, 2), (1, 2)}, set())
        assert move is None  # two independent pawn pushes: ambiguous

    def test_queenside_castle_inferred(self):
        s = _bare_session()
        s.game.set_fen("r3kbnr/pppqpppp/2npb3/8/8/2NPB3/PPPQPPPP/R3KBNR w KQkq - 0 1")
        move = s._infer_move({(4, 0), (0, 0)}, {(2, 0), (3, 0)}, set())
        assert move is not None and move.uci() == "e1c1"


def _bare_lichess_session():
    s = LichessSession.__new__(LichessSession)
    s.game = GameState()
    s.log = logging.getLogger("test")
    s.last_lichess_moves = ""
    s._initial_fen = None
    s.lichess = mock.MagicMock()
    s.lichess.is_my_turn.return_value = True
    import threading

    s.board_lock = threading.RLock()
    s.waiting_for_opponent = False
    return s


class TestSyncMoves:
    def test_sync_from_initial_fen(self):
        s = _bare_lichess_session()
        s._initial_fen = "4k3/8/8/8/8/8/4P3/4K3 w - - 0 1"
        s._sync_moves("e2e4")
        assert s.game.get_fen().split()[0] == "4k3/8/8/8/4P3/8/8/4K3"
        assert s.last_lichess_moves == "e2e4"

    def test_bad_server_move_aborts_sync(self):
        s = _bare_lichess_session()
        s._sync_moves("e2e5")  # illegal from the start position
        # NOT marked synced: the next event retries instead of silently
        # playing on a desynced board
        assert s.last_lichess_moves == ""

    def test_finished_at_join_sets_stop(self):
        s = _bare_lichess_session()
        import threading

        s.stop_event = threading.Event()
        s.my_color = None

        events = [{
            "type": "gameFull",
            "state": {"moves": "e2e4 e7e5", "status": "mate"},
        }]
        s.lichess.stream_game_with_reconnect.return_value = iter(events)
        s.lichess.my_color = "white"
        s.game_id = "g"
        s._stream_task()
        assert s.stop_event.is_set()
        assert s.last_lichess_moves == "e2e4 e7e5"


class TestReconnectBudget:
    @mock.patch("chessboard_vision.net.lichess_client.time.sleep")
    @mock.patch("chessboard_vision.net.lichess_client.requests.get")
    def test_dead_stream_reconnects_max_retries_times(self, get, sleep):
        resp = mock.MagicMock(status_code=200)
        resp.iter_lines.return_value = []  # dead: no events ever
        get.return_value = resp
        c = LichessClient(token="t")
        got = list(c.stream_game_with_reconnect("gid", max_retries=3))
        assert got == []
        # initial attempt + 3 reconnects = 4 stream attempts
        assert get.call_count == 4
        # no parting sleep after the budget is spent
        assert sleep.call_count == 3


class TestSeek:
    @mock.patch("chessboard_vision.net.lichess_client.time.sleep")
    @mock.patch("chessboard_vision.net.lichess_client.requests.post")
    @mock.patch("chessboard_vision.net.lichess_client.requests.get")
    def test_seek_polls_for_new_game(self, get, post, _sleep):
        post.return_value = mock.MagicMock(status_code=200)
        ongoing = [[], [{"gameId": "new1"}]]  # before seek, after match
        get.side_effect = [
            mock.MagicMock(status_code=200, json=lambda g=g: {"nowPlaying": g})
            for g in ongoing
        ]
        c = LichessClient(token="t")
        gid = c.seek_game(rated=True)
        assert gid == "new1"
        # lowercase literal, not Python bool repr
        assert post.call_args.kwargs["data"]["rated"] == "true"


class TestNoiseLiftedRefresh:
    def test_lifted_refreshes_on_noise_to_pending(self):
        h = NoiseHandler()
        # enter MOVE_PENDING once with square A, commit-reset, then a
        # noise burst clears into a NEW pending cycle with square B
        h.process({(0, 0)})
        assert h.last_lifted_square == (0, 0)
        h.process({(1, 1), (2, 2), (3, 3), (4, 4), (5, 5)})  # noise
        assert h.state == NoiseState.NOISE_ACTIVE
        for _ in range(NoiseHandler.COOLDOWN_FRAMES):
            state, data = h.process({(7, 7)})
        assert h.state == NoiseState.MOVE_PENDING
        assert h.last_lifted_square == (7, 7)


class TestAutoClaimDraws:
    def test_claimable_draw_is_claimed_once(self):
        """auto_claim_draws: a synced position that is a claimable draw
        (threefold via knight shuffles) sends exactly one draw claim to
        the API — and only when it is our turn."""
        s = _bare_lichess_session()
        s.auto_claim_draws = True
        shuffle = "g1f3 g8f6 f3g1 f6g8"
        s._sync_moves(f"{shuffle} {shuffle}")
        s.lichess.handle_draw_offer.assert_called_once_with(True)
        # re-syncing the same move list is a no-op (early exit)
        s._sync_moves(f"{shuffle} {shuffle}")
        s.lichess.handle_draw_offer.assert_called_once()

    def test_no_claim_when_not_claimable_or_disabled(self):
        s = _bare_lichess_session()
        s.auto_claim_draws = True
        s._sync_moves("e2e4 e7e5")
        s.lichess.handle_draw_offer.assert_not_called()
        s2 = _bare_lichess_session()  # default: disabled
        shuffle = "g1f3 g8f6 f3g1 f6g8"
        s2._sync_moves(f"{shuffle} {shuffle}")
        s2.lichess.handle_draw_offer.assert_not_called()

    def test_no_claim_on_terminal_sync(self):
        """The terminal gameState's sync must not claim a draw in a game
        the server already ended."""
        s = _bare_lichess_session()
        s.auto_claim_draws = True
        s._final_status = "outoftime"
        shuffle = "g1f3 g8f6 f3g1 f6g8"
        s._sync_moves(f"{shuffle} {shuffle}")
        s.lichess.handle_draw_offer.assert_not_called()

    def test_claim_post_runs_outside_board_lock(self):
        """The draw-claim HTTP POST must NOT hold board_lock (a blocking
        request under the lock would stall the vision thread's per-frame
        inference for up to the client timeout)."""
        import threading

        s = _bare_lichess_session()
        s.auto_claim_draws = True
        lock_free = []

        def probe_lock(accept):
            # from ANOTHER thread (RLock is reentrant, so probing from
            # this one would always succeed): can the lock be taken
            # while the POST is in flight?
            def probe():
                ok = s.board_lock.acquire(timeout=1)
                lock_free.append(ok)
                if ok:
                    s.board_lock.release()

            t = threading.Thread(target=probe)
            t.start()
            t.join()

        s.lichess.handle_draw_offer.side_effect = probe_lock
        shuffle = "g1f3 g8f6 f3g1 f6g8"
        s._sync_moves(f"{shuffle} {shuffle}")
        s.lichess.handle_draw_offer.assert_called_once_with(True)
        assert lock_free == [True]


class TestServerResult:
    """to_pgn's Result tag comes from the SERVER's adjudication — a final
    position that merely allows a draw claim proves nothing about how the
    game ended (it may have been lost on time or resigned)."""

    def _pgn_ready(self):
        s = _bare_lichess_session()
        s.player_color = "white"
        s.game_id = "abc123"
        s.clock_history = {}
        s.lichess.clock = None  # no %clk snapshots in these tests
        return s

    def test_result_from_final_status(self):
        s = self._pgn_ready()
        s._sync_moves("e2e4 e7e5")
        s._final_status = "resign"
        s._winner = "black"
        pgn = s.to_pgn()
        assert '[Result "0-1"]' in pgn
        assert '[Termination "resign"]' in pgn

    def test_draw_status_and_no_status(self):
        s = self._pgn_ready()
        s._sync_moves("e2e4 e7e5")
        s._final_status = "draw"
        s._winner = None
        assert '[Result "1/2-1/2"]' in s.to_pgn()
        s2 = self._pgn_ready()  # still running: no adjudication
        s2._final_status = None
        s2._winner = None
        s2._sync_moves("e2e4 e7e5")
        assert '[Result "*"]' in s2.to_pgn()

    def test_terminal_gamestate_carries_final_move(self):
        """The terminal gameState event CARRIES the final move (e.g. the
        mate); the stream handler must sync it before stopping."""
        import threading

        s = self._pgn_ready()
        s.stop_event = threading.Event()
        s.my_color = "white"
        s.auto_decline_draws = False
        s.draw_offered_by_opponent = False
        events = [
            {"type": "gameState", "status": "started",
             "moves": "f2f3 e7e5 g2g4"},
            {"type": "gameState", "status": "mate", "winner": "black",
             "moves": "f2f3 e7e5 g2g4 d8h4"},
        ]
        s.lichess.stream_game_with_reconnect.return_value = iter(events)
        s._stream_task()
        assert s.game.board.is_checkmate()
        assert s._final_status == "mate" and s._winner == "black"
        pgn = s.to_pgn()
        assert '[Result "0-1"]' in pgn
        assert "Qh4#" in pgn
