"""Enhancer parity: each stage and the full pipeline vs the cv2 oracle.

Tolerance policy: CLAHE/bilateral/LAB round-trips are enhancement-only
stages held to small per-pixel differences (tie-rounding + exp ulp);
sharpen/normalize/Otsu are exact given identical inputs.
"""

import cv2
import numpy as np

from chessboard_vision.models.enhancer import ImageEnhancerJax
from chessboard_vision.ops import enhance as enh_ops
from chessboard_vision.reference import ImageEnhancerCV

import jax.numpy as jnp


def _board_like(rng, h=240, w=240):
    img = np.zeros((h, w, 3), np.uint8)
    sq = h // 8
    for r in range(8):
        for c in range(8):
            img[r * sq : (r + 1) * sq, c * sq : (c + 1) * sq] = (
                (181, 217, 240) if (r + c) % 2 == 0 else (99, 136, 181)
            )
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return img


class TestClahe:
    def test_clahe_within_one(self, rng):
        for shape in [(240, 240), (77, 77), (100, 130)]:
            x = rng.integers(0, 256, shape, np.uint8)
            ours = np.asarray(enh_ops.clahe(jnp.asarray(x), 3.0, 8)).astype(int)
            ref = cv2.createCLAHE(3.0, (8, 8)).apply(x).astype(int)
            d = np.abs(ours - ref)
            assert d.max() <= 1, shape
            assert (d > 0).mean() < 0.05

    def test_clahe_other_clip(self, rng):
        x = rng.integers(0, 256, (160, 160), np.uint8)
        ours = np.asarray(enh_ops.clahe(jnp.asarray(x), 2.0, 8)).astype(int)
        ref = cv2.createCLAHE(2.0, (8, 8)).apply(x).astype(int)
        assert np.abs(ours - ref).max() <= 1


class TestBilateral:
    def test_bilateral_within_one(self, rng):
        x = _board_like(rng, 120, 120)
        planar = jnp.asarray(np.moveaxis(x, -1, 0))
        ours = np.moveaxis(np.asarray(enh_ops.bilateral_planar(planar, 9, 75.0, 75.0)), 0, -1)
        ref = cv2.bilateralFilter(x, d=9, sigmaColor=75, sigmaSpace=75)
        d = np.abs(ours.astype(int) - ref.astype(int))
        assert d.max() <= 1
        assert (d > 0).mean() < 0.02


class TestFullEnhancer:
    def test_stages_and_pipeline_close_to_oracle(self, rng):
        frame = _board_like(rng, 240, 240)
        ours = ImageEnhancerJax()
        ref = ImageEnhancerCV()

        o1 = ours.correct_lighting(frame).astype(int)
        r1 = ref.correct_lighting(frame).astype(int)
        assert np.abs(o1 - r1).max() <= 3  # LAB roundtrip + CLAHE ties

        o_full = ours.process_pipeline(frame).astype(int)
        r_full = ref.process_pipeline(frame).astype(int)
        d = np.abs(o_full - r_full)
        # compounding of <=1-level stage diffs through sharpen (9x gain)
        assert np.percentile(d, 99) <= 12
        assert d.mean() < 2.0

    def test_prepare_analysis_consistent(self, rng):
        frame = _board_like(rng, 160, 160)
        ours = ImageEnhancerJax()
        gray, binary = ours.prepare_analysis(frame)
        g_ref = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        _, b_ref = cv2.threshold(
            cv2.GaussianBlur(g_ref, (5, 5), 0), 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU
        )
        assert np.array_equal(gray, g_ref)
        assert np.array_equal(binary, b_ref)

    def test_color_profile_radical_mode(self, rng):
        frame = _board_like(rng, 80, 80)
        profile = {
            "hue_shift": 10,
            "sat_scale": 1.3,
            "val_scale": 0.9,
            "contrast": 1.2,
            "brightness": 5,
            "radical_mode": 1,
            "target_hue": 100,
            "hue_window": 25,
        }
        ours = ImageEnhancerJax(profile=profile)
        ref = ImageEnhancerCV(profile=profile)
        o = ours.apply_color_profile(frame).astype(int)
        r = ref.apply_color_profile(frame).astype(int)
        assert np.abs(o - r).max() <= 2
