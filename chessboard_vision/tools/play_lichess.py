"""Play on Lichess from a physical board (the main driver).

Equivalent of reference play_lichess.py: camera init, calibration phase,
Lichess connect, frame loop with skipping, 'c' re-captures the reference.
When the native runtime is available, capture runs on its own thread
through the SPSC frame ring (drop-oldest), decoupling camera jitter from
the pipeline tick.

Run: python -m chessboard_vision.tools.play_lichess
"""

from __future__ import annotations

import argparse
import threading

import numpy as np

from chessboard_vision.session.lichess_session import LichessSession
from chessboard_vision import native

CAMERA_ID = 0
WIDTH, HEIGHT = 1280, 720
SKIP_FRAMES = 2


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--camera", type=int, default=CAMERA_ID)
    ap.add_argument("--no-ring", action="store_true", help="poll camera inline")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume a session checkpoint (skips calibration + "
                    "reference capture)")
    ap.add_argument("--checkpoint", default="session_checkpoint.npz",
                    metavar="CKPT", help="path the 'k' key saves to")
    ap.add_argument("--pgn", default=None, metavar="FILE",
                    help="write the game as PGN on exit")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="detect camera bumps (periodic corner "
                    "re-detection) and rebuild geometry mid-game "
                    "(session/drift.py); same as \"auto_recalibrate\": "
                    "true in calibration.json")
    args = ap.parse_args(argv)

    cap = cv2.VideoCapture(args.camera)
    cap.set(3, WIDTH)
    cap.set(4, HEIGHT)
    if not cap.isOpened():
        print("failed to open camera")
        return 1

    session = LichessSession()
    if args.auto_recalibrate:
        session.default_config_overrides = {"auto_recalibrate": True}
    if args.resume:
        session.resume_checkpoint(args.resume)
        print(f"resumed from {args.resume}: {session.game.get_fen()}")
    elif not session.on_calibration_requested(cap):
        print("calibration cancelled")
        cap.release()
        return 1
    if not session.connect_and_setup():
        cap.release()
        return 1

    print(f"playing as: {session.my_color or 'awaiting stream...'}")
    print("'q' quits, 'c' re-captures the visual reference, "
          f"'k' checkpoints to {args.checkpoint}\n")

    use_ring = native.AVAILABLE and not args.no_ring
    ring = None
    stop = threading.Event()
    capture_thread = None
    if use_ring:
        ring = native.FrameRing((HEIGHT, WIDTH, 3), n_slots=4)

        def capture_loop():
            warned = False
            while not stop.is_set():
                ok, img = cap.read()
                if not ok:
                    continue
                if img.shape != (HEIGHT, WIDTH, 3):
                    if not warned:
                        print(f"[ring] camera delivers {img.shape}, expected "
                              f"{(HEIGHT, WIDTH, 3)}; frames dropped — use "
                              "--no-ring or fix the camera mode")
                        warned = True
                    continue
                ring.push(np.ascontiguousarray(img))

        capture_thread = threading.Thread(target=capture_loop, daemon=True)
        capture_thread.start()

    frame_count = 0
    try:
        while not session.stop_event.is_set():
            if use_ring:
                ring.skip_to_latest()
                seq, img = ring.pop()
                if not seq:
                    # Keep the GUI event loop + keyboard alive while the
                    # ring is empty (a dead capture thread must not turn
                    # this into an unkillable busy spin).
                    if cv2.waitKey(15) & 0xFF == ord("q"):
                        break
                    continue
            else:
                ok, img = cap.read()
                if not ok:
                    break
                frame_count += 1
                if SKIP_FRAMES > 1 and frame_count % SKIP_FRAMES != 0:
                    cv2.imshow("Camera", img)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
                    continue

            session.on_frame(img)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("c"):
                print("[re-reference]")
                session.capture_reference_frame(img)
            if key == ord("k"):
                session.save_checkpoint(args.checkpoint)
                print(f"[checkpoint] {args.checkpoint}")
    finally:
        stop.set()
        if capture_thread is not None:
            # cap.read() and cap.release() racing is not thread-safe;
            # let the capture loop observe stop first.
            capture_thread.join(timeout=2.0)
        if args.pgn and session.game is not None:
            try:
                with open(args.pgn, "w") as f:
                    f.write(session.to_pgn())
                print(f"[pgn] {args.pgn}")
            except Exception as e:  # never mask the shutdown path
                print(f"[pgn] export failed: {e}")
        session.on_exit()
        cap.release()
        cv2.destroyAllWindows()
        if ring:
            ring.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
