"""Piece-detector calibrator (trackbar UI) + stats export.

Equivalent of reference calibrate_piece_detector.py (:139-335): tune Hough
radius percentages, param1/param2, and the center-diff threshold over the
live warped board with per-method color coding; exports
piece_detector_settings.json and piece_stats.txt. Like the reference tool
(which assigns detector attributes directly, bypassing load_settings), the
live tuning uses VisionPipeline(detector_overrides=...) — the saved JSON's
hough params remain ignored by the runtime loader (the preserved
reference quirk, piece_detector.py:58-65).

Run: python -m chessboard_vision.tools.calibrate_piece_detector
"""

from __future__ import annotations

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline
from chessboard_vision.ops.piece import METHOD_NAMES
from chessboard_vision.utils.config import (
    CALIBRATION_FILE,
    PIECE_SETTINGS_FILE,
    load_json_config,
    save_json_config,
)

METHOD_COLORS = {
    1: (0, 255, 0),      # hough
    2: (255, 200, 0),    # tower_top
    3: (0, 200, 255),    # center_diff
    4: (255, 0, 255),    # symmetry
}


def export_stats(path, out, settings):
    import datetime

    radius = np.asarray(out.radius)
    method = np.asarray(out.method)
    conf = np.asarray(out.confidence)
    # raw occupancy: method/radius/conf describe THIS frame's detection;
    # smoothing-held squares would export "method=None r=0px" nonsense
    has = np.asarray(out.raw_occupancy)
    lines = [
        f"piece detector stats — {datetime.datetime.now():%Y-%m-%d %H:%M}",
        f"settings: {settings}",
        f"occupied: {int(has.sum())}/64",
    ]
    for s in range(64):
        if has[s]:
            f, r = s % 8, s // 8
            lines.append(
                f"  {'abcdefgh'[f]}{r + 1}: r={int(radius[s])}px "
                f"method={METHOD_NAMES[int(method[s])]} conf={conf[s]:.2f}"
            )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"exported {path}")


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

    win = "Piece Detector"
    cv2.namedWindow(win)
    saved = load_json_config(PIECE_SETTINGS_FILE, {}) or {}
    cv2.createTrackbar("Min radius %", win, int(saved.get("min_radius", 20)), 50, lambda v: None)
    cv2.createTrackbar("Max radius %", win, int(saved.get("max_radius", 55)), 80, lambda v: None)
    cv2.createTrackbar("Param1", win, int(saved.get("param1", 100)), 200, lambda v: None)
    cv2.createTrackbar("Param2", win, int(saved.get("param2", 25)), 60, lambda v: None)
    cv2.createTrackbar("Center diff", win, int(saved.get("center_diff", 40)), 100, lambda v: None)

    geometry = geo.BoardGeometry.from_config(config)
    pipe = None
    state = None
    current = None
    pending = None
    pending_stable = 0
    out = None
    print("'s' saves settings, 'e' exports piece_stats.txt, 'q' quits")

    while True:
        ok, frame = cap.read()
        if not ok:
            break
        settings = {
            "min_radius": max(cv2.getTrackbarPos("Min radius %", win), 5),
            "max_radius": max(cv2.getTrackbarPos("Max radius %", win), 10),
            "param1": max(cv2.getTrackbarPos("Param1", win), 20),
            "param2": max(cv2.getTrackbarPos("Param2", win), 5),
            "center_diff": max(cv2.getTrackbarPos("Center diff", win), 5),
        }
        # Debounced rebuild: thresholds are compile-time constants of the
        # jitted step, so a rebuild costs a fresh XLA compile — rebuilding
        # on every trackbar notch would freeze the UI for the whole drag.
        # Only rebuild once the sliders have been still for ~0.5 s.
        if settings != pending:
            pending = dict(settings)
            pending_stable = 0
        else:
            pending_stable += 1
        if settings != current and (pipe is None or pending_stable >= 15):
            current = dict(settings)
            pipe = VisionPipeline(
                geometry,
                piece_settings=settings,  # loader honors only min/max radius (quirk)
                detector_overrides={
                    "hough_param1": settings["param1"],
                    "hough_param2": settings["param2"],
                    "center_diff_threshold": settings["center_diff"],
                },
            )
            state = pipe.capture_reference(pipe.init_state(), frame)

        state, out = pipe.step(state, frame, use_delta=False)
        vis = pipe.warp_board(frame)
        bs = pipe.geometry.board_size
        sq = bs // 8
        method = np.asarray(out.method)
        radius = np.asarray(out.radius)
        conf = np.asarray(out.confidence)
        occ = np.asarray(out.raw_occupancy)
        for s in range(64):
            if occ[s]:
                f, r = s % 8, s // 8
                col, row = f, 7 - r
                cx, cy = col * sq + sq // 2, row * sq + sq // 2
                color = METHOD_COLORS.get(int(method[s]), (200, 200, 200))
                cv2.circle(vis, (cx, cy), int(radius[s]), color, 2)
                cv2.putText(vis, f"{conf[s]:.2f}", (cx - 18, cy - int(radius[s]) - 4),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
        cv2.putText(vis, f"minR={settings['min_radius']}% maxR={settings['max_radius']}% "
                    f"p1={settings['param1']} p2={settings['param2']} "
                    f"cd={settings['center_diff']} occupied={int(occ.sum())}",
                    (10, bs - 12), cv2.FONT_HERSHEY_SIMPLEX, 0.55, (0, 255, 0), 2)
        cv2.imshow(win, vis)
        key = cv2.waitKey(1) & 0xFF
        if key == ord("q"):
            break
        if key == ord("s"):
            save_json_config(PIECE_SETTINGS_FILE, current)
            print(f"saved {PIECE_SETTINGS_FILE}: {current}")
        elif key == ord("e") and out is not None:
            export_stats("piece_stats.txt", out, current)
    cap.release()
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
