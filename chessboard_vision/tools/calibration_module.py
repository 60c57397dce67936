"""Interactive board calibration (4-corner click UI + smart grid).

Behavioral equivalent of reference calibration_module.py: click the four
corners, verify the warp live, choose orientation ('w'/'b'), optionally
refine the grid ('g' — Canny projection profiles), save with 's'.
Produces the same calibration.json schema (corners, player_color,
orientation_flipped, grid_lines_x/y).
"""

from __future__ import annotations

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.utils.config import CALIBRATION_FILE, load_json_config, save_json_config


class CalibrationModule:
    def __init__(self):
        self.points = []

    def run(self, cap, allow_load: bool = True):
        """Interactive calibration; returns the config dict or None."""
        import cv2

        if allow_load:
            saved = load_json_config(CALIBRATION_FILE)
            if saved is not None:
                ans = input(f"Load saved calibration from {CALIBRATION_FILE}? (y/n): ").strip().lower()
                if ans == "y":
                    print("[calib] configuration loaded")
                    return saved

        print("Click the 4 board corners (TL, TR, BL, BR). 'r' resets, 'q' quits.")
        cv2.namedWindow("Calibration")
        cv2.setMouseCallback("Calibration", self._mouse_callback)
        while True:
            ok, img = cap.read()
            if not ok:
                print("[calib] camera failure")
                return None
            display = img.copy()
            for i, pt in enumerate(self.points):
                cv2.circle(display, tuple(pt), 5, (0, 0, 255), -1)
                cv2.putText(display, str(i + 1), (pt[0] + 10, pt[1]),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
            if len(self.points) == 4:
                pts = np.array(self.points, np.int32).reshape((-1, 1, 2))
                cv2.polylines(display, [pts], True, (0, 255, 0), 2)
                cv2.putText(display, "Press ENTER to confirm", (50, 50),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            cv2.imshow("Calibration", display)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                cv2.destroyAllWindows()
                return None
            if key == ord("r"):
                self.points = []
            elif key == 13 and len(self.points) == 4:
                break
        return self._configure_details(cap, np.array(self.points))

    def _mouse_callback(self, event, x, y, flags, param):
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN and len(self.points) < 4:
            self.points.append([x, y])

    def _configure_details(self, cap, corners):
        import cv2

        ordered = geo.reorder(corners.reshape((4, 1, 2)))
        flipped = False
        grid_x = grid_y = None
        print("\n-- verification: 'w'=white, 'b'=black (flip), 'g'=smart grid, "
              "'s'=save, 'q'=cancel --")
        M, bs = geo.warp_matrix(ordered)
        while True:
            ok, img = cap.read()
            if not ok:
                break
            warped = cv2.warpPerspective(img, M, (bs, bs))
            if flipped:
                warped = cv2.rotate(warped, cv2.ROTATE_180)
            display = warped.copy()
            gx = grid_x or geo.linear_grid_lines(bs)
            gy = grid_y or geo.linear_grid_lines(bs)
            for x in gx:
                cv2.line(display, (int(x), 0), (int(x), bs), (0, 255, 0), 1)
            for y in gy:
                cv2.line(display, (0, int(y)), (bs, int(y)), (0, 255, 0), 1)
            if grid_x:
                cv2.putText(display, "SMART GRID", (10, 30),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            cv2.imshow("Verification", display)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                cv2.destroyAllWindows()
                return None
            if key == ord("w"):
                if flipped:
                    # refined grid lines belong to the other orientation;
                    # a 180-degree flip mirrors every asymmetric line
                    grid_x, grid_y = None, None
                flipped = False
            elif key == ord("b"):
                if not flipped:
                    grid_x, grid_y = None, None
                flipped = True
            elif key == ord("g"):
                grid_x, grid_y = geo.refine_grid(warped)
                print(f"[calib] smart grid: x={grid_x} y={grid_y}")
            elif key == ord("s"):
                config = {
                    "corners": corners.tolist(),
                    "player_color": "black" if flipped else "white",
                    "orientation_flipped": flipped,
                    "grid_lines_x": [int(v) for v in grid_x] if grid_x else None,
                    "grid_lines_y": [int(v) for v in grid_y] if grid_y else None,
                }
                save_json_config(CALIBRATION_FILE, config)
                cv2.destroyAllWindows()
                return config


def main():
    """Console entry: open the default camera and run the click UI
    (reference play_lichess.py:16-18 camera settings)."""
    import cv2

    cap = cv2.VideoCapture(0)
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)
    try:
        config = CalibrationModule().run(cap)
        print("[calib] done" if config else "[calib] cancelled")
    finally:
        cap.release()


if __name__ == "__main__":
    main()
