"""Headless end-to-end demo: synthetic camera clip -> moves -> FEN.

Drives the full stack without camera or network: renders a scripted game
as perspective-projected frames, runs GameSession.on_frame over them, and
prints each committed move plus the final FEN. This is the framework's
standard verification surface (see .claude/skills/verify/SKILL.md).

Run: JAX_PLATFORMS=cpu python -m chessboard_vision.tools.demo_pipeline
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from chessboard_vision.session.game_session import GameSession
from chessboard_vision.rules import chess

CORNERS = [[260, 80], [1020, 95], [240, 640], [1035, 655]]


def _occupancy_of(board):
    occ = np.zeros((8, 8), bool)
    for sq in chess.SQUARES:
        if board.piece_at(sq) is not None:
            occ[chess.square_file(sq), chess.square_rank(sq)] = True
    return occ


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--moves", default="e2e4 e7e5 g1f3 b8c6", help="scripted UCI moves")
    ap.add_argument("--frames-per-position", type=int, default=26)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    # fixture generator lives with the tests; resolve relative to the
    # repo, not the cwd (the module runs from anywhere)
    import os

    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    sys.path.insert(0, os.path.join(repo_root, "tests"))
    from fixtures import make_board_frame

    rng = np.random.default_rng(args.seed)
    session = GameSession(headless=True)
    session.MOVE_COOLDOWN = 0.0
    config = {
        "corners": CORNERS,
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    }
    assert session.on_calibration_requested(None, config=config)

    script = chess.Board()
    frame0 = make_board_frame(_occupancy_of(script), rng)
    session.capture_reference_frame(frame0)

    committed = []
    t0 = time.time()
    n_frames = 0
    for uci in args.moves.split():
        script.push_uci(uci)
        occ = _occupancy_of(script)
        got = None
        for _ in range(args.frames_per_position + 15):
            n_frames += 1
            got = session.on_frame(make_board_frame(occ, rng))
            if got:
                break
        if got is None:
            print(f"FAILED to detect scripted move {uci}")
            print(f"session FEN: {session.game.get_fen()}")
            return 1
        committed.append(got.uci())
        print(f"detected + committed: {got.uci()}")
        if got.uci() != uci:
            print(f"MISMATCH: scripted {uci}")
            return 1

    dt = time.time() - t0
    print(f"\nall {len(committed)} scripted moves detected correctly")
    print(f"final FEN: {session.game.get_fen()}")
    print(f"script FEN: {script.fen()}")
    print(f"{n_frames} frames in {dt:.1f}s ({n_frames / dt:.1f} fps incl. render)")
    print("\nPGN:\n" + session.to_pgn(headers={"Event": "demo_pipeline"}))
    if session.game.get_fen() != script.fen():
        print("FEN MISMATCH")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
