"""Calibration-drift detection — the self-healing the reference lacks.

The reference's calibration is write-once: a bumped camera silently breaks
detection until the operator notices and re-clicks the four corners
(reference calibration_module.py:15-79; the only runtime recovery is the
manual 'c' re-reference, play_lichess.py:65-67, which re-captures visual
references but NOT geometry). Here a periodic host-side check re-runs the
automatic corner detector (geometry.find_chessboard_corners — the same
Canny -> dilate -> largest-4-point-contour pipeline the reference uses for
initial auto-calibration, board_detection.py:4-27) on the live frame and
watches for the detected corners to MOVE. A confirmed, consistent shift
triggers GameSession's auto-recalibration: new geometry + resample plans,
fresh visual references, game state preserved.

The detector has a constant outset bias (~6 px at 720p: the dilated
contour wraps the board's outer edge), so absolute detections cannot be
compared against the clicked calibration corners. Instead the FIRST
successful detection becomes the baseline; drift is measured relative to
it, and on confirmation the RELATIVE shift is applied to the calibrated
corners — the bias cancels exactly (measured: a synthetic 12,7 px bump
reads back as exactly 12,7 px of relative shift).

Detection is deliberately conservative — three gates before reporting:
1. the detector must find a board at all (busy scenes return nothing);
2. the shift must exceed ``threshold_px`` (mean corner displacement) but
   stay under ``max_px`` (a huge "shift" is a misdetection — e.g. the
   contour locked onto a different rectangle — not a bump);
3. ``confirm`` consecutive checks must agree with EACH OTHER within
   ``threshold_px`` (a hand crossing the board yields unstable corners;
   a real bump yields the same new corners every check).

Host-side; the cadence (every ``drift_check_interval`` frames, only when
the noise FSM is idle) keeps it off the hot path entirely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.utils.logging import get_logger


class DriftMonitor:
    """Tracks detected-corner displacement relative to a baseline detection."""

    def __init__(
        self,
        corners: np.ndarray,
        threshold_px: float = 4.0,
        max_px: float = 80.0,
        confirm: int = 2,
    ):
        self.corners = np.asarray(corners, np.float64).reshape(4, 2)
        self.threshold_px = float(threshold_px)
        self.max_px = float(max_px)
        self.confirm = int(confirm)
        self._baseline: Optional[np.ndarray] = None
        self._pending: Optional[np.ndarray] = None
        self._agree = 0
        self.log = get_logger("drift")

    @staticmethod
    def _mean_disp(a: np.ndarray, b: np.ndarray) -> float:
        return float(np.mean(np.linalg.norm(a - b, axis=-1)))

    def check(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """Run one drift check on a raw camera frame.

        Returns the new (4, 2) calibration corners when drift is
        confirmed, else None. On confirmation the monitor re-bases, so a
        single bump reports exactly once.
        """
        detected = geo.find_chessboard_corners(frame)
        if detected is None or np.asarray(detected).size != 8:
            self._pending, self._agree = None, 0  # gate 1: no board found
            return None
        det = np.asarray(detected, np.float64).reshape(4, 2)

        if self._baseline is None:
            self._baseline = det  # detector's own (biased) view at calibration
            return None

        disp = self._mean_disp(det, self._baseline)
        if disp <= self.threshold_px or disp > self.max_px:  # gate 2
            self._pending, self._agree = None, 0
            return None

        if (
            self._pending is not None
            and self._mean_disp(det, self._pending) <= self.threshold_px
        ):
            self._agree += 1  # gate 3: consecutive checks agree
        else:
            self._pending = det
            self._agree = 1
        if self._agree < self.confirm:
            self.log.info(
                "possible calibration drift: %.1f px (check %d/%d)",
                disp, self._agree, self.confirm,
            )
            return None

        self.log.warning(
            "calibration drift confirmed: corners moved %.1f px", disp
        )
        # Apply the relative shift; the detector's constant bias cancels.
        self.corners = self.corners + (det - self._baseline)
        self._baseline = det
        self._pending, self._agree = None, 0
        return self.corners.copy()
