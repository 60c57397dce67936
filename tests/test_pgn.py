"""PGN export (rules/pgn.py): SAN correctness + movetext formatting."""

import pytest

from chessboard_vision.rules.chesslib import Board, Move
from chessboard_vision.rules.pgn import game_to_pgn, san


def _san_seq(uci_moves, fen=None):
    board = Board(fen) if fen else Board()
    out = []
    for u in uci_moves:
        m = Move.from_uci(u)
        out.append(san(board, m))
        board.push(m)
    return out


class TestSan:
    def test_basic_and_captures(self):
        assert _san_seq(["e2e4", "d7d5", "e4d5", "g8f6", "b1c3"]) == [
            "e4", "d5", "exd5", "Nf6", "Nc3",
        ]

    def test_en_passant_is_plain_pawn_capture(self):
        sans = _san_seq(["e2e4", "a7a6", "e4e5", "d7d5", "e5d6"])
        assert sans[-1] == "exd6"

    def test_castling_both_sides(self):
        sans = _san_seq(
            ["e2e4", "e7e5", "g1f3", "b8c6", "f1c4", "g8f6", "e1g1"]
        )
        assert sans[-1] == "O-O"
        sans = _san_seq(
            ["d2d4", "d7d5", "b1c3", "b8c6", "c1f4", "c8f5", "d1d2", "d8d7",
             "e1c1"]
        )
        assert sans[-1] == "O-O-O"

    def test_knight_file_disambiguation(self):
        # Nbd2: knights on b1 and f3 can both reach d2.
        sans = _san_seq(["g1f3", "d7d5", "d2d3", "c7c5", "b1d2"])
        assert sans[-1] == "Nbd2"

    def test_rank_disambiguation(self):
        # Rooks on a1 and a5 -> R1a3 (same file, ranks differ).
        fen = "1k6/8/8/R7/8/8/8/R3K3 w - - 0 1"
        assert _san_seq(["a1a3"], fen=fen) == ["R1a3"]

    def test_check_and_mate_suffixes(self):
        sans = _san_seq(["e2e4", "e7e5", "d1h5", "b8c6", "h5f7"])
        assert sans[-1] == "Qxf7+" or sans[-1] == "Qxf7#"
        # Scholar's mate proper: Bc4 first so Qxf7 is mate.
        sans = _san_seq(
            ["e2e4", "e7e5", "f1c4", "b8c6", "d1h5", "g8f6", "h5f7"]
        )
        assert sans[-1] == "Qxf7#"

    def test_promotion_san(self):
        fen = "8/P6k/8/8/8/8/7K/8 w - - 0 1"
        assert _san_seq(["a7a8q"], fen=fen) == ["a8=Q"]


class TestGameToPgn:
    def test_full_document(self):
        pgn = game_to_pgn(
            ["e2e4", "e7e5", "f1c4", "b8c6", "d1h5", "g8f6", "h5f7"],
            headers={"White": "vision", "Black": "opponent"},
        )
        assert '[White "vision"]' in pgn
        assert '[Result "1-0"]' in pgn
        assert "1. e4 e5 2. Bc4 Nc6 3. Qh5 Nf6 4. Qxf7# 1-0" in pgn.replace(
            "\n", " "
        ).replace("1.", "1.", 1) or "4. Qxf7#" in pgn

    def test_in_progress_result_star(self):
        pgn = game_to_pgn(["e2e4", "c7c5"])
        assert '[Result "*"]' in pgn
        assert pgn.rstrip().endswith("*")

    def test_black_to_move_start_fen(self):
        fen = "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 1"
        pgn = game_to_pgn(["c7c5"], start_fen=fen)
        assert '[SetUp "1"]' in pgn and f'[FEN "{fen}"]' in pgn
        assert "1... c5" in pgn

    def test_illegal_sequence_rejected(self):
        with pytest.raises(ValueError, match="illegal"):
            game_to_pgn(["e2e5"])

    def test_long_game_wraps_at_80_cols(self):
        moves = ["g1f3", "g8f6", "f3g1", "f6g8"] * 12
        pgn = game_to_pgn(moves)
        body = pgn.split("\n\n", 1)[-1] if "\n\n" in pgn else pgn
        assert all(len(line) <= 80 for line in pgn.splitlines())


def test_session_to_pgn():
    """GameSession.to_pgn serializes the live game with the session's
    color in the header."""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from fixtures import DEFAULT_CORNERS
    from chessboard_vision.session.game_session import GameSession
    from chessboard_vision.rules.chesslib import Move

    s = GameSession(headless=True)
    s.configure({
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "white",
        "orientation_flipped": False,
    })
    s.game.board.push(Move.from_uci("e2e4"))
    s.game.board.push(Move.from_uci("e7e5"))
    pgn = s.to_pgn(headers={"Black": "opponent"})
    assert '[White "chessboard_vision"]' in pgn
    assert '[Black "opponent"]' in pgn
    assert "1. e4 e5 *" in pgn


def test_session_to_pgn_from_position():
    """A session whose game was seeded mid-position (checkpoint resume /
    Lichess from-position) exports SetUp/FEN tags and replays legally."""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from fixtures import DEFAULT_CORNERS
    from chessboard_vision.session.game_session import GameSession
    from chessboard_vision.rules.chesslib import Move

    fen = "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 1"
    s = GameSession(headless=True)
    s.configure({
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "black",
        "orientation_flipped": False,
    })
    s.game.set_fen(fen)
    s.game.board.push(Move.from_uci("c7c5"))
    pgn = s.to_pgn()
    assert '[SetUp "1"]' in pgn and f'[FEN "{fen}"]' in pgn
    assert "1... c5" in pgn


def test_pgn_tag_escaping():
    pgn = game_to_pgn(["e2e4"], headers={"Event": 'club "blitz" night'})
    assert '[Event "club \\"blitz\\" night"]' in pgn


def test_multistream_to_pgn():
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from fixtures import DEFAULT_CORNERS
    from chessboard_vision import geometry as geo
    from chessboard_vision.parallel.session import MultiStreamSession
    from chessboard_vision.rules.chesslib import Move

    g = geo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS))
    sess = MultiStreamSession(g, n_streams=2)
    sess.streams[1].game.board.push(Move.from_uci("d2d4"))
    assert "1. d4 *" in sess.to_pgn(1)
    assert sess.to_pgn(0).rstrip().endswith("*")


def test_lichess_session_pgn_clock_annotations():
    """LichessSession.to_pgn emits standard %clk comments from the
    stream's clock snapshots (mover's remaining time after each move)."""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from fixtures import DEFAULT_CORNERS
    from unittest import mock
    from chessboard_vision.session.lichess_session import LichessSession
    from chessboard_vision.rules.chesslib import Move

    client = mock.MagicMock()
    s = LichessSession(client=client, headless=True)
    s.configure({
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "white",
        "orientation_flipped": False,
    })
    s.game_id = "abc12345"
    s.game.board.push(Move.from_uci("e2e4"))
    s.game.board.push(Move.from_uci("e7e5"))
    s.clock_history = {1: (292_000, 300_000), 2: (292_000, 287_000)}
    pgn = s.to_pgn()
    assert '[Site "https://lichess.org/abc12345"]' in pgn
    assert "e4 {[%clk 0:04:52]}" in pgn
    assert "e5 {[%clk 0:04:47]}" in pgn


def test_lichess_session_pgn_clock_black_to_move_start():
    """From-position game whose start FEN has BLACK to move: the odd-
    numbered moves are black's, so %clk snapshots must attach to black's
    clock (not a hardcoded odd=white parity)."""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from fixtures import DEFAULT_CORNERS
    from unittest import mock
    from chessboard_vision.session.lichess_session import LichessSession
    from chessboard_vision.rules.chesslib import Move

    client = mock.MagicMock()
    s = LichessSession(client=client, headless=True)
    s.configure({
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "black",
        "orientation_flipped": False,
    })
    fen = "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 1"
    s._initial_fen = fen
    s.game.set_fen(fen)
    s.game.board.push(Move.from_uci("e7e5"))  # move 1: black
    s.game.board.push(Move.from_uci("g1f3"))  # move 2: white
    s.clock_history = {1: (300_000, 292_000), 2: (287_000, 292_000)}
    pgn = s.to_pgn()
    # Move 1 (black, e5) shows black's clock 4:52; move 2 (white, Nf3)
    # shows white's clock 4:47.
    assert "e5 {[%clk 0:04:52]}" in pgn
    assert "Nf3 {[%clk 0:04:47]}" in pgn


def test_san_round_trip_random_playouts():
    """Property test: san() and parse_san() are inverses over hundreds of
    random legal positions (incl. castling, promotions, en passant as
    they arise) — the writer is self-verified without an external chess
    library."""
    import numpy as np
    from chessboard_vision.rules.chesslib import Board
    from chessboard_vision.rules.pgn import parse_san

    rng = np.random.default_rng(12)
    total = 0
    for game in range(12):
        board = Board()
        for ply in range(120):
            legal = list(board.legal_moves)
            if not legal:
                break
            move = legal[int(rng.integers(len(legal)))]
            token = san(board, move)
            back = parse_san(board, token)
            assert (back.from_square, back.to_square, back.promotion or None) == (
                move.from_square, move.to_square, move.promotion or None
            ), (game, ply, token, move.uci())
            board.push(move)
            total += 1
    assert total > 500


def test_stalemate_result():
    # Black to move, stalemated: king a8, white Qc7+Kb6 pattern.
    fen = "k7/2Q5/1K6/8/8/8/8/8 b - - 0 1"
    pgn = game_to_pgn([], start_fen=fen)
    assert '[Result "1/2-1/2"]' in pgn


def test_threefold_repetition_result():
    """A fully digitized game ending in threefold repetition exports
    1/2-1/2 under claim_draws."""
    moves = ["g1f3", "g8f6", "f3g1", "f6g8"] * 2
    pgn = game_to_pgn(moves, claim_draws=True)
    assert '[Result "1/2-1/2"]' in pgn
    assert pgn.rstrip().endswith("1/2-1/2")
    # one shuffle short of the third occurrence: still ongoing
    assert '[Result "*"]' in game_to_pgn(moves[:4], claim_draws=True)


def test_claimable_draw_not_adjudicated_by_default():
    """A claim RIGHT is not an outcome: without claim_draws a final
    claimable position stays '*' (the game may have ended on time or by
    resignation — only the caller knows)."""
    moves = ["g1f3", "g8f6", "f3g1", "f6g8"] * 2
    assert '[Result "*"]' in game_to_pgn(moves)
    fen = "k7/8/8/8/8/8/8/K6R w - - 99 80"
    assert '[Result "*"]' in game_to_pgn(["h1h2"], start_fen=fen)
    # an explicit result always wins
    pgn = game_to_pgn(moves, result="0-1")
    assert '[Result "0-1"]' in pgn


def test_fifty_move_result():
    fen = "k7/8/8/8/8/8/8/K6R w - - 99 80"
    pgn = game_to_pgn(["h1h2"], start_fen=fen, claim_draws=True)
    assert '[Result "1/2-1/2"]' in pgn


def test_automatic_draws_need_no_claim():
    """FIDE 9.6 AUTOMATIC terminations (seventy-five moves, fivefold
    repetition) adjudicate even without claim_draws."""
    fen = "k7/8/8/8/8/8/8/K6R w - - 149 110"
    assert '[Result "1/2-1/2"]' in game_to_pgn(["h1h2"], start_fen=fen)
    moves = ["g1f3", "g8f6", "f3g1", "f6g8"] * 4  # fivefold (start counts)
    assert '[Result "1/2-1/2"]' in game_to_pgn(moves)


def test_insufficient_material_result():
    # White king captures the last black rook -> K vs K, dead position.
    fen = "8/8/8/8/8/2k5/8/1Kr5 w - - 10 60"
    pgn = game_to_pgn(["b1c1"], start_fen=fen)
    assert '[Result "1/2-1/2"]' in pgn
