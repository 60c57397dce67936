"""Process a recorded video file: frames -> moves -> FEN timeline.

The reference only supports live cameras (play_lichess.py:16-18 /
test_piece_detector.py); this tool runs the same session pipeline over
recorded footage — the standard way to digitize an already-filmed game
or to build regression clips from real material.

Usage:
  python -m chessboard_vision.tools.process_video game.mp4 \
      --calibration calibration.json --out timeline.jsonl

Emits each committed move as it is detected and (optionally) a JSONL
timeline: {"frame": i, "move": "e2e4", "fen": "..."} per committed move
plus a final summary record. Frame skipping matches the reference's
SKIP_FRAMES=2 cadence (play_lichess.py:12,52-56) by default.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from chessboard_vision.session.game_session import GameSession
from chessboard_vision.utils.config import load_json_config
from chessboard_vision.utils.logging import get_logger

log = get_logger("process_video")


def parse_corners(text: str):
    """'x1,y1 x2,y2 x3,y3 x4,y4' -> [[x,y], ...]."""
    pts = []
    for tok in text.split():
        x, y = tok.split(",")
        pts.append([int(x), int(y)])
    if len(pts) != 4:
        raise ValueError("need exactly 4 corners")
    return pts


def run(
    video_path: str,
    config: dict,
    skip_frames: int = 2,
    reference_frames: int = 3,
    out_path: str | None = None,
    max_frames: int | None = None,
    session: GameSession | None = None,
    cooldown_seconds: float = 0.0,
    compare_oracle: bool = False,
):
    """Process the video; returns (moves, final_fen, frames_processed)
    — or (moves, final_fen, frames_processed, report) with
    compare_oracle=True.

    cooldown_seconds > 0 enables a post-move cooldown measured in VIDEO
    time (converted to processed frames via the file's FPS and
    skip_frames) — wall-clock cooldowns are meaningless offline, where
    processing can run orders of magnitude faster than realtime.

    compare_oracle replays the SAME processed frames through the cv2
    oracle decision loop (reference/replay_session.py) in parallel and
    returns a decision-agreement report (per-frame occupancy agreement,
    move-list diff, FEN match) — the one-command validation bridge for
    user footage that the README's parity policy points to.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")

    cooldown_frames = None
    if cooldown_seconds > 0:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        cooldown_frames = max(1, int(cooldown_seconds * fps / max(skip_frames, 1)))
    if session is None:
        session = GameSession(headless=True)
        if cooldown_frames is not None:
            session.cooldown_frames = cooldown_frames
        else:
            session.MOVE_COOLDOWN = 0.0  # no cooldown: the stability gate debounces
    if not session.on_calibration_requested(None, config=config):
        cap.release()
        raise ValueError("calibration config rejected (missing corners?)")

    oracle = None
    per_frame_matches = []
    if compare_oracle:
        from chessboard_vision.reference.replay_session import (
            OracleReplaySession,
        )

        oracle = OracleReplaySession(config, cooldown_frames=cooldown_frames)

    # Reference capture from the first frames (reference
    # game_session.capture_reference does 10 warmup reads on live cameras;
    # recorded footage is stable from frame 0).
    ref = None
    for _ in range(max(reference_frames, 1)):
        ok, img = cap.read()
        if not ok:
            raise ValueError("video ended before a reference frame was read")
        ref = img
    session.capture_reference_frame(ref)
    if oracle is not None:
        oracle.capture_reference(ref)

    out_f = open(out_path, "w") if out_path else None
    moves = []
    i = 0
    processed = 0
    try:
        while True:
            ok, img = cap.read()
            if not ok:
                break
            i += 1
            if skip_frames > 1 and i % skip_frames:
                continue
            processed += 1
            move = session.on_frame(img)
            if oracle is not None:
                from chessboard_vision.models.pipeline import occupancy_to_set

                omove = oracle.on_frame(img)
                if omove is not None:
                    log.info("frame %d: oracle committed %s", i, omove.uci())
                pipe_occ = occupancy_to_set(session.last_outputs.occupancy)
                per_frame_matches.append(
                    64 - len(pipe_occ ^ oracle.last_occupancy)
                )
            if move is not None:
                moves.append(move.uci())
                fen = session.game.get_fen()
                log.info("frame %d: %s -> %s", i, move.uci(), fen)
                print(f"[{i}] {move.uci()}  {fen}")
                if out_f:
                    out_f.write(
                        json.dumps({"frame": i, "move": move.uci(), "fen": fen}) + "\n"
                    )
            if max_frames and processed >= max_frames:
                break
        final_fen = session.game.get_fen()
        if out_f:
            out_f.write(
                json.dumps(
                    {"final_fen": final_fen, "moves": moves, "frames": processed}
                )
                + "\n"
            )
        if oracle is not None:
            from chessboard_vision.reference.replay_session import (
                agreement_report,
            )

            report = agreement_report(moves, final_fen, oracle, per_frame_matches)
            if out_f:
                out_f.write(json.dumps({"oracle_comparison": report}) + "\n")
            return moves, final_fen, processed, report
        return moves, final_fen, processed
    finally:
        if out_f:
            out_f.close()
        cap.release()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("video", help="video file path (any OpenCV-readable format)")
    ap.add_argument("--calibration", default="calibration.json",
                    help="calibration JSON (corners etc.)")
    ap.add_argument("--corners", default=None,
                    help="override: 'x1,y1 x2,y2 x3,y3 x4,y4' (TL TR BL BR)")
    ap.add_argument("--skip-frames", type=int, default=2,
                    help="process every Nth frame (reference SKIP_FRAMES)")
    ap.add_argument("--out", default=None, help="JSONL timeline output path")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pgn", default=None, metavar="FILE",
                    help="write the digitized game as PGN")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="detect mid-footage camera bumps and rebuild "
                    "geometry (session/drift.py)")
    ap.add_argument("--cooldown-seconds", type=float, default=0.0,
                    help="post-move cooldown in VIDEO seconds (converted "
                    "to source frames via the file's FPS; wall-clock "
                    "cooldowns are meaningless when processing runs "
                    "faster than realtime). 0 = no cooldown (default, "
                    "the 20-frame stability gate alone debounces)")
    ap.add_argument("--compare-oracle", action="store_true",
                    help="also replay the video through the cv2 oracle "
                    "decision loop and print a decision-agreement report "
                    "(per-frame occupancy agreement, move-list diff, FEN "
                    "match) — one-command validation of the device pipeline "
                    "against the OpenCV reference on YOUR footage")
    args = ap.parse_args(argv)

    if args.corners:
        config = {
            "corners": parse_corners(args.corners),
            "player_color": "white",
            "orientation_flipped": False,
            "grid_lines_x": None,
            "grid_lines_y": None,
        }
    else:
        config = load_json_config(args.calibration)
        if config is None:
            print(f"no calibration at {args.calibration}; pass --corners", file=sys.stderr)
            return 2

    if args.auto_recalibrate:
        config = {**config, "auto_recalibrate": True}
    result = run(
        args.video, config, skip_frames=args.skip_frames,
        out_path=args.out, max_frames=args.max_frames,
        cooldown_seconds=args.cooldown_seconds,
        compare_oracle=args.compare_oracle,
    )
    moves, fen, n = result[:3]
    print(f"\n{len(moves)} moves over {n} processed frames")
    print(f"final FEN: {fen}")
    if args.compare_oracle:
        report = result[3]
        print("\noracle comparison (cv2 decision loop on the same frames):")
        print(f"  per-square occupancy agreement: "
              f"{report['square_agreement_pct']}%")
        print(f"  frames fully agreeing:          "
              f"{report['frame_full_agreement_pct']}%")
        print(f"  move lists match: {report['move_lists_match']} "
              f"(pipeline {len(report['pipeline_moves'])} vs oracle "
              f"{len(report['oracle_moves'])} moves"
              + (f"; first divergence at move index "
                 f"{report['first_divergent_move']}"
                 if report["first_divergent_move"] is not None else "")
              + ")")
        print(f"  final FEN match: {report['fen_match']}")
        if not report["fen_match"]:
            print(f"    pipeline: {report['pipeline_final_fen']}")
            print(f"    oracle: {report['oracle_final_fen']}")
    if args.pgn:
        from chessboard_vision.rules.pgn import game_to_pgn

        with open(args.pgn, "w") as f:
            f.write(game_to_pgn(moves,  # run() returns UCI strings
                                headers={"Event": "digitized recording"},
                                claim_draws=True))  # the clip is the whole game
        print(f"PGN written to {args.pgn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
