"""Correctness tests for the in-framework chess rules engine.

Perft node counts are the gold standard for move-generator correctness;
positions and counts are the standard public vectors (startpos, Kiwipete,
en-passant/promotion-heavy positions).
"""

import pytest

from chessboard_vision.rules import chesslib as chess
from chessboard_vision.rules.chesslib import Board, Move, perft


class TestBasics:
    def test_startpos_fen_roundtrip(self):
        b = Board()
        assert b.fen() == chess.STARTING_FEN
        b2 = Board(b.fen())
        assert b2.fen() == b.fen()

    def test_square_mapping(self):
        assert chess.square(0, 0) == 0  # a1
        assert chess.square(7, 7) == 63  # h8
        assert chess.square_name(chess.square(4, 1)) == "e2"
        assert chess.parse_square("e4") == chess.square(4, 3)

    def test_move_uci_roundtrip(self):
        m = Move.from_uci("e2e4")
        assert m.uci() == "e2e4"
        p = Move.from_uci("e7e8q")
        assert p.promotion == chess.QUEEN

    def test_push_pop(self):
        b = Board()
        b.push_uci("e2e4")
        b.push_uci("e7e5")
        assert b.fullmove_number == 2
        b.pop()
        b.pop()
        assert b.fen() == chess.STARTING_FEN

    def test_illegal_uci_raises(self):
        b = Board()
        with pytest.raises(ValueError):
            b.push_uci("e2e5")

    def test_piece_at_and_symbols(self):
        b = Board()
        p = b.piece_at(chess.parse_square("e1"))
        assert p.piece_type == chess.KING and p.color == chess.WHITE
        assert p.symbol() == "K"
        assert b.piece_at(chess.parse_square("e4")) is None

    def test_is_capture_and_en_passant(self):
        b = Board()
        b.push_uci("e2e4")
        b.push_uci("d7d5")
        m = Move.from_uci("e4d5")
        assert b.is_capture(m)
        # En passant setup
        b = Board("rnbqkbnr/ppp1pppp/8/8/3pP3/8/PPPP1PPP/RNBQKBNR b KQkq e3 0 2")
        ep = Move.from_uci("d4e3")
        assert b.is_en_passant(ep)
        assert b.is_capture(ep)

    def test_castling_flags_in_fen(self):
        b = Board()
        for uci in ["e2e4", "e7e5", "g1f3", "b8c6", "f1c4", "g8f6", "e1g1"]:
            b.push_uci(uci)
        assert "K" not in b.fen().split()[2]
        assert b.piece_at(chess.parse_square("g1")).piece_type == chess.KING
        assert b.piece_at(chess.parse_square("f1")).piece_type == chess.ROOK

    def test_promotion_auto_queen_shape(self):
        b = Board("8/P7/8/8/8/8/7k/K7 w - - 0 1")
        moves = {m.uci() for m in b.legal_moves}
        assert "a7a8q" in moves and "a7a8n" in moves
        b.push_uci("a7a8q")
        assert b.piece_at(chess.parse_square("a8")).piece_type == chess.QUEEN

    def test_check_detection(self):
        b = Board("rnb1kbnr/pppp1ppp/8/4p3/6Pq/5P2/PPPPP2P/RNBQKBNR w KQkq - 1 3")
        assert b.is_check()
        # Only legal replies block/avoid check.
        for m in b.legal_moves:
            b.push(m)
            b.pop()


PERFT_VECTORS = [
    # (fen, depth, nodes) — standard public perft positions
    (chess.STARTING_FEN, 1, 20),
    (chess.STARTING_FEN, 2, 400),
    (chess.STARTING_FEN, 3, 8902),
    (chess.STARTING_FEN, 4, 197281),
    # Kiwipete
    ("r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1", 1, 48),
    ("r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1", 2, 2039),
    ("r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1", 3, 97862),
    # Position 3 (en passant / pins)
    ("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", 1, 14),
    ("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", 2, 191),
    ("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", 3, 2812),
    ("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", 4, 43238),
    # Position 4 (promotions / castling)
    ("r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1", 1, 6),
    ("r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1", 2, 264),
    ("r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1", 3, 9467),
    # Position 5
    ("rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8", 1, 44),
    ("rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8", 2, 1486),
    ("rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8", 3, 62379),
]


@pytest.mark.parametrize("fen,depth,expected", PERFT_VECTORS)
def test_perft(fen, depth, expected):
    assert perft(Board(fen), depth) == expected


class TestDrawAdjudication:
    """50-move rule, threefold repetition, insufficient material
    (the python-chess surface the reference
    inherited via `import chess`, reference game_state.py:1)."""

    def test_threefold_repetition_knight_shuffle(self):
        b = Board()
        assert not b.is_repetition(2)
        shuffle = ["g1f3", "g8f6", "f3g1", "f6g8"]
        for uci in shuffle:  # start position seen 2nd time
            b.push_uci(uci)
        assert b.is_repetition(2) and not b.is_repetition(3)
        assert not b.can_claim_threefold_repetition()
        for uci in shuffle:  # 3rd time
            b.push_uci(uci)
        assert b.can_claim_threefold_repetition()
        assert b.can_claim_draw()
        # pop rewinds the count
        b.pop()
        assert not b.can_claim_threefold_repetition()

    def test_repetition_key_ignores_uncapturable_ep_square(self):
        # After 1.e4 the FEN carries ep e3, but no black pawn can take:
        # the position is repetition-equivalent to the same placement
        # without the ep square (FIDE 9.2.2).
        with_ep = Board("rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq e3 0 1")
        without = Board("rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 1")
        assert with_ep._position_key() == without._position_key()
        # ...but a capturable ep square DOES distinguish positions.
        cap = Board("rnbqkbnr/ppp1pppp/8/8/3pP3/8/PPPP1PPP/RNBQKBNR b KQkq e3 0 2")
        nocap = Board("rnbqkbnr/ppp1pppp/8/8/3pP3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 2")
        assert cap._position_key() != nocap._position_key()

    def test_fifty_moves(self):
        b = Board("k7/8/8/8/8/8/8/K6R w - - 99 80")
        assert not b.is_fifty_moves()
        b.push_uci("h1h2")
        assert b.is_fifty_moves() and b.can_claim_draw()
        # a pawn move or capture resets the clock
        b2 = Board("k7/7p/8/8/8/8/8/K6R b - - 99 80")
        b2.push_uci("h7h6")
        assert b2.halfmove_clock == 0 and not b2.can_claim_draw()

    def test_insufficient_material(self):
        assert Board("k7/8/8/8/8/8/8/K7 w - - 0 1").is_insufficient_material()
        assert Board("k7/8/8/8/8/8/8/KB6 w - - 0 1").is_insufficient_material()
        assert Board("kn6/8/8/8/8/8/8/K7 w - - 0 1").is_insufficient_material()
        # two knights (helpmates exist): not a dead position
        assert not Board("kn6/8/8/8/8/8/8/KN6 w - - 0 1").is_insufficient_material()
        # bishops on the same square color (b8, c1 both dark): dead
        assert Board("kb6/8/8/8/8/8/8/K1B5 w - - 0 1").is_insufficient_material()
        # opposite-color bishops (b8 dark, b1 light): not dead
        assert not Board("kb6/8/8/8/8/8/8/KB6 w - - 0 1").is_insufficient_material()
        assert not Board("k7/p7/8/8/8/8/8/K7 w - - 0 1").is_insufficient_material()

    def test_automatic_draw_predicates(self):
        """FIDE 9.6 AUTOMATIC forms — seventy-five moves and fivefold
        repetition — end the game without a claim (python-chess mirror:
        is_game_over() is True even with claim_draw=False)."""
        b = Board("k7/8/8/8/8/8/8/K6R w - - 149 110")
        assert not b.is_seventyfive_moves()
        b.push_uci("h1h2")
        assert b.is_seventyfive_moves()
        assert b.is_game_over()
        # a mate delivered on the 150th halfmove still wins
        m = Board("k7/8/1K6/8/8/8/8/7R w - - 149 110")
        m.push_uci("h1h8")
        assert m.is_checkmate() and not m.is_seventyfive_moves()

        b = Board()
        shuffle = ["g1f3", "g8f6", "f3g1", "f6g8"]
        for _ in range(3):
            for u in shuffle:
                b.push_uci(u)
        assert not b.is_fivefold_repetition()  # 4th occurrence
        assert not b.is_game_over()
        for u in shuffle:
            b.push_uci(u)
        assert b.is_fivefold_repetition()
        assert b.is_game_over()

    def test_checkmate_stalemate_predicates(self):
        # fool's mate: 1.f3 e5 2.g4 Qh4#
        assert Board(
            "rnb1kbnr/pppp1ppp/8/4p3/6Pq/5P2/PPPPP2P/RNBQKBNR w KQkq - 1 3"
        ).is_checkmate()
        assert Board("k7/2Q5/1K6/8/8/8/8/8 b - - 0 1").is_stalemate()
        b = Board()
        assert not b.is_checkmate() and not b.is_stalemate()
        assert not b.is_game_over()
        assert Board("k7/8/8/8/8/8/8/KB6 w - - 0 1").is_game_over()
