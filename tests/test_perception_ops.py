"""Parity tests for the perception ops: Canny (bit-exact), Hough + piece
cascade (decision parity vs the cv2 oracle), change detection (bit-exact).
"""

import cv2
import numpy as np
import jax.numpy as jnp

from chessboard_vision.ops.canny import canny
from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops import piece as piece_ops
from chessboard_vision.ops import change as change_ops
from chessboard_vision.reference import PieceDetectorCV, ChangeDetectorCV

from fixtures import make_square


def full_masks(n=64, size=77):
    h = np.full(n, size)
    return piece_ops.PieceMasks.build(h, h, size, size)


def full_hough_params(n=64, size=77):
    h = np.full(n, size)
    return hough_ops.HoughParams.from_geometry(h, h)  # (params, bounds)


class TestCanny:
    def test_bit_exact_vs_cv2(self, rng):
        imgs = np.stack(
            [make_square(rng, radius=rng.integers(14, 38) if i % 3 else None,
                         contrast=int(rng.integers(30, 110)), noise=int(rng.integers(2, 14)))
             for i in range(16)]
        )
        ours = np.asarray(canny(jnp.asarray(imgs), 50, 100))
        for i in range(16):
            ref = cv2.Canny(imgs[i], 50, 100) > 0
            assert np.array_equal(ours[i], ref), i

    def test_batched_shape(self, rng):
        imgs = np.stack([make_square(rng, radius=25) for _ in range(4)])
        e = canny(jnp.asarray(imgs), 50, 100)
        assert e.shape == (4, 77, 77) and e.dtype == bool


class TestHoughDecisionParity:
    def test_found_matches_cv2(self, rng):
        """Circle-found decision agrees with cv2.HoughCircles on a spread of
        piece-like and empty squares (decision-level parity target)."""
        n = 64
        imgs = []
        expect_kinds = []
        for i in range(n):
            kind = i % 4
            if kind == 3:
                imgs.append(make_square(rng, radius=None, noise=int(rng.integers(2, 12))))
            else:
                imgs.append(
                    make_square(
                        rng,
                        radius=int(rng.integers(16, 40)),
                        contrast=int(rng.integers(40, 110)),
                        noise=int(rng.integers(2, 14)),
                        off=(int(rng.integers(-8, 9)), int(rng.integers(-8, 9))),
                    )
                )
        imgs = np.stack(imgs)
        params, bounds = full_hough_params()
        circ = hough_ops.hough_circles(jnp.asarray(imgs), params, bounds)
        found, cx, cy, r, small = hough_ops.best_circle_near_center(
            circ, params_heights(), params_widths()
        )
        found = np.asarray(found)

        det = PieceDetectorCV()
        agree = 0
        for i in range(n):
            ref_found, ref_center, ref_r, ref_kind = det._detect_circle_unified(imgs[i])
            agree += int(bool(ref_found) == bool(found[i]))
        assert agree >= n - 2, f"hough decision agreement {agree}/{n}"


def params_heights():
    return jnp.full((64,), 77, jnp.int32)


def params_widths():
    return jnp.full((64,), 77, jnp.int32)


class TestPieceCascadeParity:
    def test_cascade_decisions_match_oracle(self, rng):
        n = 64
        imgs = []
        for i in range(n):
            kind = i % 5
            if kind == 4:
                imgs.append(make_square(rng, radius=None, noise=int(rng.integers(1, 10))))
            elif kind == 3:
                # low-contrast center blob (center_diff / symmetry territory)
                imgs.append(make_square(rng, radius=22, contrast=50, noise=3))
            else:
                imgs.append(
                    make_square(
                        rng,
                        radius=int(rng.integers(16, 40)),
                        contrast=int(rng.integers(40, 110)),
                        noise=int(rng.integers(2, 12)),
                        off=(int(rng.integers(-6, 7)), int(rng.integers(-6, 7))),
                    )
                )
        # detect_piece takes the RAW square (it preprocesses internally);
        # our device cascade takes the preprocessed gray. Emulate both.
        raw = np.stack(imgs)
        pre = np.stack([cv2.GaussianBlur(im, (5, 5), 0) for im in raw])
        det = piece_ops.detect_pieces(jnp.asarray(pre), full_masks(), *full_hough_params())
        has = np.asarray(det.has_piece)
        oracle = PieceDetectorCV()
        agree = 0
        mismatches = []
        for i in range(n):
            ref = oracle.detect_piece(raw[i])
            if bool(ref["has_piece"]) == bool(has[i]):
                agree += 1
            else:
                mismatches.append((i, ref["method"], int(has[i])))
        assert agree >= n - 2, f"cascade agreement {agree}/{n}: {mismatches}"

    def test_std_prefilter_and_aux_values(self, rng):
        flat = np.full((64, 77, 77), 128, np.uint8)  # perfectly uniform
        det = piece_ops.detect_pieces(jnp.asarray(flat), full_masks(), *full_hough_params())
        assert not np.asarray(det.has_piece).any()
        assert np.allclose(np.asarray(det.std), 0.0)

    def test_center_diff_and_symmetry_values_match_oracle(self, rng):
        img = make_square(rng, radius=24, contrast=70, noise=4)
        pre = cv2.GaussianBlur(img, (5, 5), 0)
        batch = np.broadcast_to(pre, (64, 77, 77)).copy()
        det = piece_ops.detect_pieces(jnp.asarray(batch), full_masks(), *full_hough_params())
        oracle = PieceDetectorCV()
        g = oracle._preprocess_square(img)
        ref_diff, _, _ = oracle._detect_center_vs_border(g)
        ref_sym = oracle._analyze_radial_symmetry(g)
        assert abs(float(det.center_border_diff[0]) - ref_diff) < 0.05
        assert abs(float(det.symmetry[0]) - ref_sym) < 0.01
        assert abs(float(det.std[0]) - np.std(g)) < 0.01


class TestChangeDetector:
    def _squares_dict(self, arr):
        return {(f, r): arr[r * 8 + f] for f in range(8) for r in range(8)}

    def test_detect_matches_oracle_exactly(self, rng):
        size = 50
        base = rng.integers(0, 256, (64, size, size, 3), np.uint8)
        cur = base.copy()
        cur[5] = 255 - cur[5]  # flip one square hard
        cur[9] = np.clip(cur[9].astype(int) + 30, 0, 255).astype(np.uint8)

        oracle = ChangeDetectorCV()
        oracle.calibrate(self._squares_dict(base))
        ref_detailed = oracle.detect_changes_detailed(self._squares_dict(cur))

        # device path
        import chessboard_vision.ops as O

        pre_base = np.stack([cv2.GaussianBlur(cv2.cvtColor(s, cv2.COLOR_BGR2GRAY), (5, 5), 0) for s in base])
        pre_cur = np.stack([cv2.GaussianBlur(cv2.cvtColor(s, cv2.COLOR_BGR2GRAY), (5, 5), 0) for s in cur])
        state = change_ops.calibrate(jnp.asarray(pre_base), 100)
        valid = jnp.ones((64, size, size), bool)
        counts = jnp.full((64,), size * size, jnp.int32)
        det = change_ops.detect(state, jnp.asarray(pre_cur), 2.5, valid, counts)

        for f in range(8):
            for r in range(8):
                sq = r * 8 + f
                in_ref = (f, r) in ref_detailed
                assert bool(det.significant[sq]) == in_ref, (f, r)
                if in_ref:
                    info = ref_detailed[(f, r)]
                    assert change_ops.INTENSITY_NAMES[int(det.intensity[sq])] == info["intensity"]
                    assert abs(float(det.pct_changed[sq]) - info["pct_changed"]) < 1e-3
                    assert abs(float(det.z_peak[sq]) - info["z_score"]) < 1e-4

    def test_ema_update_matches_oracle_bitwise(self, rng):
        size = 40
        frames = [rng.integers(0, 256, (64, size, size, 3), np.uint8) for _ in range(4)]
        oracle = ChangeDetectorCV()
        oracle.calibrate(self._squares_dict(frames[0]))

        def pre(arr):
            return np.stack(
                [cv2.GaussianBlur(cv2.cvtColor(s, cv2.COLOR_BGR2GRAY), (5, 5), 0) for s in arr]
            )

        state = change_ops.calibrate(jnp.asarray(pre(frames[0])), 100)
        mask = jnp.ones((64,), bool)
        for fr in frames[1:]:
            oracle.update_all_references(self._squares_dict(fr))
            state = change_ops.update_references(state, jnp.asarray(pre(fr)), 0.1, mask)
        for f in range(8):
            for r in range(8):
                sq = r * 8 + f
                # state stores the model FLAT per square (layout
                # unambiguity) — row-major flatten matches the oracle's 2-D.
                assert np.array_equal(
                    np.asarray(state.means[sq]), oracle.means[(f, r)].ravel()
                ), (f, r)
                assert np.array_equal(
                    np.asarray(state.variances[sq]),
                    oracle.variances[(f, r)].ravel(),
                )

    def test_flat_and_3d_inputs_equivalent(self, rng):
        """change ops accept (64, H, W) and pre-flattened (64, H*W)
        inputs interchangeably (the pipeline flattens once and passes
        flat; direct callers may pass 3-D) with identical results."""
        import jax.numpy as jnp

        g3 = jnp.asarray(rng.integers(0, 256, (64, 11, 13), np.uint8))
        v3 = jnp.asarray(rng.random((64, 11, 13)) > 0.1)
        counts = v3.sum((1, 2)).astype(jnp.int32)
        gf = change_ops.flatten_pixels(g3)
        vf = change_ops.flatten_pixels(v3)
        s3 = change_ops.calibrate(g3, 50.0)
        sf = change_ops.calibrate(gf, 50.0)
        for a, b in zip(s3, sf):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        g2 = jnp.asarray(rng.integers(0, 256, (64, 11, 13), np.uint8))
        mask = jnp.ones((64,), bool)
        u3 = change_ops.update_references(s3, g2, 0.2, mask)
        uf = change_ops.update_references(sf, change_ops.flatten_pixels(g2), 0.2, mask)
        for a, b in zip(u3, uf):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        d3 = change_ops.detect(u3, g2, 2.0, v3, counts)
        df = change_ops.detect(uf, change_ops.flatten_pixels(g2), 2.0, vf, counts)
        for a, b in zip(d3, df):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_hand_pattern_device(self):
        intensity = jnp.zeros((64,), jnp.int32)
        intensity = intensity.at[3].set(3).at[10].set(3)  # two TOTAL
        hand, move, _ = change_ops.classify_hand_pattern(intensity, jnp.ones((64,), bool))
        assert bool(hand) and not bool(move)
        intensity = jnp.zeros((64,), jnp.int32).at[3].set(2).at[10].set(1)
        hand, move, cand = change_ops.classify_hand_pattern(intensity, jnp.ones((64,), bool))
        assert not bool(hand) and bool(move) and int(jnp.sum(cand)) == 2


class TestChangeUncalibratedGate:
    def test_uncalibrated_model_reports_nothing(self, rng):
        """init_state (means/vars 0) must not produce inf/NaN z-scores or
        phantom TOTAL changes — the reference returns no results before
        calibrate() (change_detector.py:105-110)."""
        import jax.numpy as jnp

        state = change_ops.init_state(shape=(64, 20, 20))
        gray = jnp.asarray(rng.integers(0, 256, (64, 20, 20), np.uint8))
        valid = jnp.ones((64, 20, 20), bool)
        counts = jnp.full((64,), 400, jnp.int32)
        det = change_ops.detect(state, gray, 2.5, valid, counts)
        assert not np.asarray(det.significant).any()
        assert (np.asarray(det.intensity) == 0).all()
        assert np.isfinite(np.asarray(det.z_peak)).all()
        # after calibration the same frame is the background: still quiet
        state = change_ops.calibrate(gray, 100.0)
        det2 = change_ops.detect(state, gray, 2.5, valid, counts)
        assert not np.asarray(det2.significant).any()


class TestBitplaneHysteresis:
    """The uint32 bitplane packing behind hysteresis propagation
    — the dilation chain must be per-image
    exact through the packed representation."""

    def test_pack_unpack_roundtrip(self, rng):
        from chessboard_vision.ops.canny import _pack_bits, _unpack_bits

        for n in (1, 31, 32, 64, 65):
            x = rng.random((n, 9, 11)) < 0.3
            p = _pack_bits(jnp.asarray(x))
            assert p.shape == (-(-n // 32), 9, 11) and p.dtype == jnp.uint32
            assert np.array_equal(np.asarray(_unpack_bits(p, n)), x)

    def test_packed_dilate_matches_per_image(self, rng):
        from chessboard_vision.ops.canny import (
            _dilate3, _pack_bits, _unpack_bits)

        x = rng.random((40, 13, 17)) < 0.2
        packed = np.asarray(_unpack_bits(_dilate3(_pack_bits(jnp.asarray(x))), 40))
        plain = np.asarray(_dilate3(jnp.asarray(x)))
        assert np.array_equal(packed, plain)

    def test_bounded_rounds_match_fixpoint_when_converged(self, rng):
        """On images whose weak chains are short, rounds=2 equals the
        exact fixpoint — the production fast path's calibration premise."""
        imgs = np.stack([make_square(rng, radius=25, noise=6) for _ in range(8)])
        exact = np.asarray(canny(jnp.asarray(imgs), 50, 100))
        bounded = np.asarray(canny(jnp.asarray(imgs), 50, 100, hysteresis_rounds=2))
        assert np.array_equal(exact, bounded)
