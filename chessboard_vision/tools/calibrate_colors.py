"""Color-profile calibrator: trackbar UI over the live camera.

Equivalent of reference calibrate_colors.py: tune the 8 color-profile
parameters (hue shift, sat/val scale, contrast, brightness, radical mode,
target hue, hue window) with live Original | Enhanced | Gray preview and a
center-pixel probe; 's' saves color_profile.json. The enhancement math is
the framework's own (models/enhancer.apply_color_profile), so what you see
is exactly what the pipeline computes.

Run: python -m chessboard_vision.tools.calibrate_colors
"""

from __future__ import annotations

import numpy as np

from chessboard_vision.utils.config import COLOR_PROFILE_FILE, save_json_config

TRACKBARS = [
    # (name, max, to_param, from_default)
    ("Hue shift", 180, lambda v: v - 90, 90),
    ("Sat x10", 30, lambda v: v / 10.0, 10),
    ("Val x10", 30, lambda v: v / 10.0, 10),
    ("Contrast x10", 30, lambda v: v / 10.0, 10),
    ("Brightness", 200, lambda v: v - 100, 100),
    ("Radical", 1, lambda v: v, 0),
    ("Target hue", 179, lambda v: v, 0),
    ("Hue window", 90, lambda v: v, 20),
]


def profile_from_trackbars(values):
    keys = [
        "hue_shift", "sat_scale", "val_scale", "contrast",
        "brightness", "radical_mode", "target_hue", "hue_window",
    ]
    return {k: conv(v) for (name, _m, conv, _d), k, v in zip(TRACKBARS, keys, values)}


def main(camera_id: int = 0):
    import cv2

    from chessboard_vision.models.enhancer import ImageEnhancerJax

    cap = cv2.VideoCapture(camera_id)
    if not cap.isOpened():
        print("failed to open camera")
        return 1
    win = "Color Calibration"
    cv2.namedWindow(win)
    for name, vmax, _conv, default in TRACKBARS:
        cv2.createTrackbar(name, win, default, vmax, lambda v: None)

    print("'s' saves color_profile.json, 'q' quits")
    enhancer = ImageEnhancerJax()
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        values = [cv2.getTrackbarPos(name, win) for name, *_ in TRACKBARS]
        profile = profile_from_trackbars(values)
        enhancer.profile = profile
        enhanced = enhancer.apply_color_profile(frame)
        gray = cv2.cvtColor(enhanced, cv2.COLOR_BGR2GRAY)
        h, w = frame.shape[:2]
        probe = enhanced[h // 2, w // 2]
        cv2.putText(enhanced, f"probe BGR={tuple(int(x) for x in probe)}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 2)
        triptych = np.hstack([frame, enhanced, cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)])
        scale = 1440 / triptych.shape[1]
        triptych = cv2.resize(triptych, None, fx=scale, fy=scale)
        cv2.imshow(win, triptych)
        key = cv2.waitKey(1) & 0xFF
        if key == ord("q"):
            break
        if key == ord("s"):
            save_json_config(COLOR_PROFILE_FILE, profile)
            print(f"saved {COLOR_PROFILE_FILE}: {profile}")
    cap.release()
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
