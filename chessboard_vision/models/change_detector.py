"""Stateful change-detector model (host-facing wrapper over ops/change).

Mirrors the reference ChangeDetector surface (change_detector.py):
calibrate / update_all_references / detect_changes(_detailed) /
classify_hand_pattern / focus squares — with the per-square dict state held
as device tensors and every call a single fused device op.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from chessboard_vision.ops import change as change_ops

SquareTuple = Tuple[int, int]


from chessboard_vision.ops.layout import (  # noqa: E402
    positions_to_mask as _mask_from_positions,
)


class ChangeDetectorModel:
    def __init__(self, valid_mask=None, counts=None, shape=(64, 77, 77)):
        self.z_threshold = 2.5
        self.initial_variance = 100.0
        self.alpha = 0.1
        self.blur_kernel = 5
        self.shape = shape
        self.valid_mask = (
            jnp.asarray(valid_mask) if valid_mask is not None else jnp.ones(shape, bool)
        )
        self.counts = (
            jnp.asarray(counts)
            if counts is not None
            else jnp.full((shape[0],), shape[1] * shape[2], jnp.int32)
        )
        self.state = change_ops.init_state(shape)
        self.is_calibrated = False
        self.focus_squares: set = set()

    # -- configuration ---------------------------------------------------

    def set_focus_squares(self, squares):
        self.focus_squares = set(squares)

    def clear_focus(self):
        self.focus_squares = set()

    def get_focus_count(self):
        return len(self.focus_squares) if self.focus_squares else 64

    def _focus_device_mask(self) -> jnp.ndarray:
        if self.focus_squares:
            return jnp.asarray(_mask_from_positions(self.focus_squares))
        return jnp.ones((64,), bool)

    # -- model API (gray: (64, H, W) u8 preprocessed squares) -----------

    def calibrate(self, gray):
        self.state = change_ops.calibrate(jnp.asarray(gray), self.initial_variance)
        self.is_calibrated = True

    def update_all_references(self, gray):
        if not self.is_calibrated:
            self.calibrate(gray)
            return
        self.state = change_ops.update_references(
            self.state, jnp.asarray(gray), self.alpha, self._focus_device_mask()
        )

    def detect_changes_detailed(self, gray) -> Dict[SquareTuple, dict]:
        """Dict API matching the reference (only significant squares)."""
        if not self.is_calibrated:
            return {}
        det = change_ops.detect(
            self.state, jnp.asarray(gray), self.z_threshold, self.valid_mask, self.counts
        )
        focus = np.asarray(self._focus_device_mask())
        sig = np.asarray(det.significant)
        out = {}
        for f in range(8):
            for r in range(8):
                sq = r * 8 + f
                if focus[sq] and sig[sq]:
                    out[(f, r)] = {
                        "z_score": float(det.z_peak[sq]),
                        "pct_changed": float(det.pct_changed[sq]),
                        "intensity": change_ops.INTENSITY_NAMES[int(det.intensity[sq])],
                    }
        return out

    def detect_changes(self, gray) -> Dict[SquareTuple, float]:
        return {
            pos: info["pct_changed"]
            for pos, info in self.detect_changes_detailed(gray).items()
            if info["intensity"] in ("PARCIAL", "TOTAL")
        }

    def classify_hand_pattern(self, detailed: Dict[SquareTuple, dict]) -> dict:
        n = len(detailed)
        n_total = sum(1 for v in detailed.values() if v["intensity"] == "TOTAL")
        if n_total >= 2 or n >= 4 or n > 2:
            return {"is_hand": True, "is_move": False, "move_candidates": set()}
        cands = set(detailed.keys())
        return {"is_hand": False, "is_move": n == 2, "move_candidates": cands}
