"""GameState occupancy->move resolution tests.

Mirrors the coverage of reference test_game_state.py (10 tests): initial
occupancy, normal move, illegal rejection with state preservation, turn
switching, capture (1 vanished / 0 appeared), both castlings, en passant,
and reset — all on FEN-seeded positions with no camera/CV involvement.
"""

from chessboard_vision.rules import chess, GameState


def occ_after(gs, remove=(), add=()):
    occ = gs.get_board_occupancy()
    for sq in remove:
        occ.discard(sq)
    for sq in add:
        occ.add(sq)
    return occ


class TestGameState:
    def test_initial_occupancy(self):
        gs = GameState()
        occ = gs.get_board_occupancy()
        assert len(occ) == 32
        assert (0, 0) in occ and (4, 0) in occ  # a1, e1
        assert (4, 3) not in occ  # e4 empty

    def test_normal_move(self):
        gs = GameState()
        vision = occ_after(gs, remove=[(4, 1)], add=[(4, 3)])  # e2 -> e4
        move, status = gs.process_occupancy_change(vision)
        assert status == "move_confirmed"
        assert move.uci() == "e2e4"
        assert gs.get_board_occupancy() == vision

    def test_illegal_move_rejected_state_preserved(self):
        gs = GameState()
        fen_before = gs.get_fen()
        vision = occ_after(gs, remove=[(4, 1)], add=[(4, 4)])  # e2 -> e5
        move, status = gs.process_occupancy_change(vision)
        assert move is None and status == "illegal_move"
        assert gs.get_fen() == fen_before

    def test_turn_switching(self):
        gs = GameState()
        assert gs.get_turn_name() == "white"
        gs.process_occupancy_change(occ_after(gs, remove=[(4, 1)], add=[(4, 3)]))
        assert gs.get_turn_name() == "black"
        gs.process_occupancy_change(occ_after(gs, remove=[(4, 6)], add=[(4, 4)]))
        assert gs.get_turn_name() == "white"

    def test_capture_one_vanished_zero_appeared(self):
        gs = GameState()
        gs.set_fen("rnbqkbnr/ppp1pppp/8/3p4/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2")
        # exd5: e4 vanishes, lands on occupied d5
        vision = occ_after(gs, remove=[(4, 3)])
        move, status = gs.process_occupancy_change(vision)
        assert status == "capture_confirmed"
        assert move.uci() == "e4d5"

    def test_kingside_castling(self):
        gs = GameState()
        gs.set_fen("rnbqk2r/pppp1ppp/5n2/2b1p3/2B1P3/5N2/PPPP1PPP/RNBQK2R w KQkq - 4 4")
        vision = occ_after(gs, remove=[(4, 0), (7, 0)], add=[(6, 0), (5, 0)])
        move, status = gs.process_occupancy_change(vision)
        assert status == "castling_confirmed"
        assert move.uci() == "e1g1"

    def test_queenside_castling(self):
        gs = GameState()
        gs.set_fen("r3kbnr/pppqpppp/2np4/8/3P1B2/2N5/PPPQPPPP/R3KBNR w KQkq - 6 5")
        vision = occ_after(gs, remove=[(4, 0), (0, 0)], add=[(2, 0), (3, 0)])
        move, status = gs.process_occupancy_change(vision)
        assert status == "castling_confirmed"
        assert move.uci() == "e1c1"

    def test_en_passant(self):
        gs = GameState()
        gs.set_fen("rnbqkbnr/ppp1p1pp/8/3pPp2/8/8/PPPP1PPP/RNBQKBNR w KQkq f6 0 3")
        # exf6 ep: e5 and f5 vanish, f6 appears
        vision = occ_after(gs, remove=[(4, 4), (5, 4)], add=[(5, 5)])
        move, status = gs.process_occupancy_change(vision)
        assert status == "en_passant_confirmed"
        assert move.uci() == "e5f6"

    def test_ambiguous_capture_rejected(self):
        gs = GameState()
        # White knight on e5 can capture on d7 and f7, both occupied.
        gs.set_fen("rnbqkbnr/pppppppp/8/4N3/8/8/PPPPPPPP/RNBQKB1R w KQkq - 0 1")
        vision = occ_after(gs, remove=[(4, 4)])
        move, status = gs.process_occupancy_change(vision)
        assert move is None and status == "ambiguous_capture"

    def test_auto_queen_promotion(self):
        gs = GameState()
        gs.set_fen("8/P7/8/8/8/7k/8/K7 w - - 0 1")
        vision = occ_after(gs, remove=[(0, 6)], add=[(0, 7)])
        move, status = gs.process_occupancy_change(vision)
        assert status == "move_confirmed"
        assert move.promotion == chess.QUEEN

    def test_no_valid_change(self):
        gs = GameState()
        move, status = gs.process_occupancy_change(gs.get_board_occupancy())
        assert move is None and status == "no_valid_change"

    def test_reset(self):
        gs = GameState()
        gs.process_occupancy_change(occ_after(gs, remove=[(4, 1)], add=[(4, 3)]))
        gs.reset()
        assert gs.get_fen() == chess.STARTING_FEN
        assert len(gs.get_board_occupancy()) == 32

    def test_legal_moves_from(self):
        gs = GameState()
        moves = gs.get_legal_moves_from(4, 1)  # e2
        assert {m.uci() for m in moves} == {"e2e3", "e2e4"}


class TestFen:
    def test_get_chess_square(self):
        from chessboard_vision.rules import get_chess_square

        name, (gx, gy) = get_chess_square(10, 10, 620)
        assert name == "a8" and (gx, gy) == (0, 0)
        name, _ = get_chess_square(615, 615, 620)
        assert name == "h1"
        name, (gx, gy) = get_chess_square(5000, 10, 620)
        assert gx == -1

    def test_generate_fen_startpos(self):
        from chessboard_vision.rules import generate_fen, map_detections_to_board

        # Place two kings via labeled detections
        dets = [
            {"center": (4 * 77 + 38, 7 * 77 + 38), "class": "white-king", "conf": 0.9},
            {"center": (4 * 77 + 38, 0 * 77 + 38), "class": "black-king", "conf": 0.9},
        ]
        bm = map_detections_to_board(dets, 620)
        fen = generate_fen(bm)
        assert fen.split()[0] == "4k3/8/8/8/8/8/8/4K3"

    def test_conflict_resolution_keeps_highest_conf(self):
        from chessboard_vision.rules import map_detections_to_board

        dets = [
            {"center": (38, 38), "class": "white-pawn", "conf": 0.5},
            {"center": (40, 40), "class": "black-queen", "conf": 0.9},
        ]
        bm = map_detections_to_board(dets, 620)
        assert bm[(0, 0)]["fen"] == "q"

    def test_occupancy_to_fen(self):
        import numpy as np
        from chessboard_vision.rules import occupancy_to_fen

        occ = np.zeros((8, 8), dtype=bool)
        occ[4, 0] = True  # e1
        occ[4, 7] = True  # e8
        fen = occupancy_to_fen(occ)
        assert fen.split()[0] == "4P3/8/8/8/8/8/8/4P3"
