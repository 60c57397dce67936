"""Change-detector sensitivity calibrator (trackbar UI).

Equivalent of reference calibrate_sensitivity.py: tune z-threshold
("Sensitivity" mapped 3.0 - v/20 like the reference :116-118), initial
variance, alpha, and the change-detector blur kernel (:62-118) over a live
intensity-colored overlay, with the lifted-piece legal-destination preview
(:176-201) and a hand-test mode that counts noise events (:337-346).
Saves sensitivity_settings.json — and unlike the reference (whose runtime
never read that file, SURVEY.md §5 quirk), this framework's pipeline
consumes it via VisionPipeline(change_settings=...), including
blur_kernel.

Run: python -m chessboard_vision.tools.calibrate_sensitivity
"""

from __future__ import annotations

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.rules import GameState
from chessboard_vision.utils.config import (
    CALIBRATION_FILE,
    SENSITIVITY_FILE,
    load_json_config,
    save_json_config,
)

INTENSITY_COLORS = {1: (80, 190, 250), 2: (0, 140, 255), 3: (0, 0, 255)}  # LEVE/PARCIAL/TOTAL


def lifted_square_and_destinations(game: GameState, vision_occupied) -> tuple:
    """Lifted-piece preview (reference calibrate_sensitivity.py:176-201):
    when exactly one piece of the game position is visually missing (and
    nothing extra appeared), return it and its legal destination squares."""
    expected = game.get_board_occupancy()
    missing = expected - set(vision_occupied)
    extra = set(vision_occupied) - expected
    if len(missing) != 1 or extra:
        return None, []
    lifted = next(iter(missing))
    from_sq = lifted[1] * 8 + lifted[0]
    dests = [
        (m.to_square % 8, m.to_square // 8)
        for m in game.board.legal_moves
        if m.from_square == from_sq
    ]
    return lifted, dests


def main(camera_id: int = 0):
    import cv2

    config = load_json_config(CALIBRATION_FILE)
    if config is None:
        print("run calibration first (tools.calibration_module)")
        return 1
    cap = cv2.VideoCapture(camera_id)
    if not cap.isOpened():
        print("failed to open camera")
        return 1

    win = "Sensitivity"
    cv2.namedWindow(win)
    saved = load_json_config(SENSITIVITY_FILE, {}) or {}
    cv2.createTrackbar("Sensitivity", win, int((3.0 - saved.get("z_threshold", 2.5)) * 20), 50, lambda v: None)
    cv2.createTrackbar("Init var", win, int(saved.get("initial_variance", 100)), 1000, lambda v: None)
    cv2.createTrackbar("Alpha x100", win, int(saved.get("alpha", 0.1) * 100), 50, lambda v: None)
    cv2.createTrackbar("Blur", win, int(saved.get("blur_kernel", 5)), 15, lambda v: None)

    pipe = None
    state = None
    current = None
    pending = None
    pending_stable = 0
    game = GameState()
    noise_events = 0
    hand_test = False
    print("'s' saves, 'r' recalibrates reference, 'h' toggles hand-test, 'q' quits")

    while True:
        ok, frame = cap.read()
        if not ok:
            break
        z = 3.0 - cv2.getTrackbarPos("Sensitivity", win) / 20.0
        var0 = max(cv2.getTrackbarPos("Init var", win), 1)
        alpha = max(cv2.getTrackbarPos("Alpha x100", win), 1) / 100.0
        blur = max(cv2.getTrackbarPos("Blur", win), 1)
        blur += 1 - blur % 2  # odd kernel, like the reference's trackbar mapping
        settings = {"z_threshold": z, "initial_variance": var0, "alpha": alpha,
                    "blur_kernel": blur}
        # Debounced rebuild (see calibrate_piece_detector): thresholds are
        # compile-time constants, so a rebuild = a fresh XLA compile;
        # rebuilding per trackbar notch would freeze the UI mid-drag.
        if settings != pending:
            pending = dict(settings)
            pending_stable = 0
        else:
            pending_stable += 1
        if settings != current and (pipe is None or pending_stable >= 15):
            # the baked-in square border must cover the blur kernel: rebuild
            # geometry when the kernel outgrows it
            if current is None or blur != current["blur_kernel"]:
                geometry = geo.BoardGeometry.from_config(
                    config, blur_pad=max(2, blur // 2)
                )
            current = dict(settings)
            pipe = VisionPipeline(geometry, change_settings=settings)
            state = pipe.capture_reference(pipe.init_state(), frame)

        state, out = pipe.step(state, frame)
        vis = pipe.warp_board(frame)
        bs = pipe.geometry.board_size
        sq = bs // 8
        intensity = np.asarray(out.change_intensity)
        pct = np.asarray(out.change_pct)
        n_changed = 0
        for s in range(64):
            if intensity[s] > 0:
                n_changed += 1
                f, r = s % 8, s // 8
                col, row = f, 7 - r
                x1, y1 = col * sq, row * sq
                overlay = vis.copy()
                cv2.rectangle(overlay, (x1, y1), (x1 + sq, y1 + sq), INTENSITY_COLORS[int(intensity[s])], -1)
                cv2.addWeighted(overlay, 0.4, vis, 0.6, 0, vis)
                cv2.putText(vis, f"{pct[s]:.0f}%", (x1 + 5, y1 + 20),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        if hand_test and n_changed > 3:
            noise_events += 1

        # Lifted-piece legal-destination preview (reference :176-201):
        # highlight the lifted square and circle its legal destinations.
        lifted, dests = lifted_square_and_destinations(
            game, occupancy_to_set(out.occupancy)
        )
        if lifted is not None:
            lf, lr = lifted
            x1, y1 = lf * sq, (7 - lr) * sq
            cv2.rectangle(vis, (x1, y1), (x1 + sq, y1 + sq), (0, 255, 255), 2)
            for df, dr in dests:
                cx, cy = df * sq + sq // 2, (7 - dr) * sq + sq // 2
                cv2.circle(vis, (cx, cy), sq // 5, (0, 255, 0), 2)

        cv2.putText(vis, f"z={z:.2f} var={var0} a={alpha:.2f} blur={blur} changed={n_changed}"
                    + (f" noise_events={noise_events}" if hand_test else ""),
                    (10, bs - 12), cv2.FONT_HERSHEY_SIMPLEX, 0.55, (0, 255, 0), 2)
        cv2.imshow(win, vis)
        key = cv2.waitKey(1) & 0xFF
        if key == ord("q"):
            break
        if key == ord("s"):
            save_json_config(SENSITIVITY_FILE, current)
            print(f"saved {SENSITIVITY_FILE}: {current}")
        elif key == ord("r"):
            state = pipe.capture_reference(state, frame)
        elif key == ord("h"):
            hand_test = not hand_test
            noise_events = 0
    cap.release()
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
