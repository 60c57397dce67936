"""Standalone enhancement demo (webcam loop).

Equivalent of reference frame_enhancer.py main(): run the full enhancement
pipeline + Otsu analysis on live camera frames, with an FPS HUD, showing
Original / Enhanced / Binary windows. Exercises the device enhancer
(CLAHE-on-LAB-L, bilateral, sharpen, normalize) end-to-end.

Run: python -m chessboard_vision.tools.enhance_demo
"""

from __future__ import annotations

from chessboard_vision.models.enhancer import ImageEnhancerJax
from chessboard_vision.utils.profiling import FpsCounter


def main(camera_id: int = 0):
    import cv2

    cap = cv2.VideoCapture(camera_id)
    if not cap.isOpened():
        print("failed to open camera")
        return 1
    enhancer = ImageEnhancerJax(load_profile_file=True)
    fps = FpsCounter()
    print("enhancement demo — 'q' quits")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        enhanced = enhancer.process_pipeline(frame)
        _, binary = enhancer.prepare_analysis(enhanced)
        fps.update()
        cv2.putText(frame, f"FPS: {fps.fps:.0f}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
        cv2.imshow("Original", frame)
        cv2.imshow("Enhanced", enhanced)
        cv2.imshow("Analysis (Otsu)", binary)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break
    cap.release()
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
