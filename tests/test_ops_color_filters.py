"""Parity tests: JAX ops vs the OpenCV oracle.

Bit-exactness is asserted for every op on the detection (FEN-parity) path:
bgr2gray, bgr2hsv, gaussian_blur, sharpen/filter2d, normalize, otsu,
convert_scale_abs. Enhancement-only conversions (hsv2bgr, lab round-trip)
are held to <=1 intensity level.
"""

import cv2
import numpy as np
import pytest

from chessboard_vision import ops
from chessboard_vision.ops import color as color_mod
import jax.numpy as jnp


def _rand_img(rng, h=77, w=77, c=3):
    return rng.integers(0, 256, (h, w, c) if c else (h, w), np.uint8)


class TestColor:
    def test_bgr2gray_exact(self, rng):
        for _ in range(3):
            img = _rand_img(rng)
            ours = np.asarray(ops.bgr2gray(img))
            assert np.array_equal(ours, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))

    def test_bgr2gray_batched(self, rng):
        imgs = rng.integers(0, 256, (5, 32, 32, 3), np.uint8)
        ours = np.asarray(ops.bgr2gray(imgs))
        for i in range(5):
            assert np.array_equal(ours[i], cv2.cvtColor(imgs[i], cv2.COLOR_BGR2GRAY))

    def test_bgr2hsv_exact(self, rng):
        img = _rand_img(rng, 100, 100)
        ours = np.asarray(ops.bgr2hsv(img))
        assert np.array_equal(ours, cv2.cvtColor(img, cv2.COLOR_BGR2HSV))

    def test_hsv2bgr_within_one(self, rng):
        img = _rand_img(rng, 100, 100)
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        ours = np.asarray(ops.hsv2bgr(hsv)).astype(int)
        ref = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).astype(int)
        assert np.abs(ours - ref).max() <= 1

    def test_bgr2lab_within_one(self, rng):
        img = _rand_img(rng, 100, 100)
        ours = np.asarray(ops.bgr2lab(img)).astype(int)
        ref = cv2.cvtColor(img, cv2.COLOR_BGR2LAB).astype(int)
        d = np.abs(ours - ref)
        assert d.max() <= 1
        assert (d > 0).mean() < 0.001  # near-exact

    def test_lab2bgr_close(self, rng):
        img = _rand_img(rng, 64, 64)
        lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
        ours = np.asarray(ops.lab2bgr(lab)).astype(int)
        ref = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR).astype(int)
        assert np.abs(ours - ref).max() <= 2

    def test_gamma_fixed_exhaustive(self):
        """The polynomial _gamma_fixed reproduces cv2's inverse-gamma
        fixed-point table EXACTLY on all 256 inputs (the pow form it
        replaced only matched up to round-to-int ties)."""
        got = np.asarray(color_mod._gamma_fixed(jnp.arange(256, dtype=jnp.uint8)))
        assert np.array_equal(got, color_mod._GTAB)

    def test_cbrt_fixed_exhaustive(self):
        """fast_cbrt (division-free Newton on the inverse cbrt) stays in
        the same +-1 fixed-point envelope as the pow-chain jnp.cbrt it
        replaced, over the ENTIRE Lab cube-root table domain."""
        idx = jnp.arange(color_mod._CBRT_N, dtype=jnp.int32)
        got = np.asarray(color_mod._cbrt_fixed(idx))
        d = np.abs(got - color_mod._CBRT_TAB)
        assert d.max() <= 1
        assert (d > 0).mean() < 0.005  # 23/6121 off-by-one measured

    def test_fast_cbrt_accuracy_and_edge_lanes(self):
        """Relative error <= 5e-7 over the Lab domain; zero / denormal
        inputs (the unselected lanes of a surrounding where) stay finite."""
        t = np.linspace(0.0088, 3.0, 200_001).astype(np.float32)
        got = np.asarray(color_mod.fast_cbrt(jnp.asarray(t))).astype(np.float64)
        rel = np.abs(got - np.cbrt(t.astype(np.float64))) / np.cbrt(t.astype(np.float64))
        assert rel.max() < 5e-7
        edge = np.asarray(color_mod.fast_cbrt(jnp.asarray([0.0, 1e-38, 1e-20], np.float32)))
        assert np.isfinite(edge).all()

    def test_srgb_gamma_dense_grid(self):
        """The sqrt(sqrt(cbrt(u^5))) encode-gamma matches the f64 pow
        ground truth at u8 rounding on a dense grid (rare +-1 flips only,
        same class as the pow form it replaced)."""
        u = np.linspace(0.0, 1.0, 1_000_001).astype(np.float32)
        got = np.round(np.asarray(color_mod._srgb_gamma(jnp.asarray(u))) * 255)
        ref64 = np.where(
            u.astype(np.float64) <= 0.0031308,
            u.astype(np.float64) * 12.92,
            1.055 * u.astype(np.float64) ** (1 / 2.4) - 0.055,
        )
        d = np.abs(got - np.round(ref64 * 255))
        assert d.max() <= 1
        assert (d > 0).mean() < 1e-4

    def test_convert_scale_abs_exact(self, rng):
        img = _rand_img(rng)
        for alpha, beta in [(1.0, 0.0), (1.37, -12.5), (0.5, 0.25), (2.2, 30.0)]:
            ours = np.asarray(ops.convert_scale_abs(img, alpha, beta))
            ref = cv2.convertScaleAbs(img, alpha=alpha, beta=beta)
            assert np.array_equal(ours, ref), (alpha, beta)


class TestFilters:
    @pytest.mark.parametrize("ksize", [3, 5, 7, 9])
    def test_gaussian_blur_exact(self, rng, ksize):
        x = _rand_img(rng, 77, 77, c=0)
        ours = np.asarray(ops.gaussian_blur(x, ksize))
        ref = cv2.GaussianBlur(x, (ksize, ksize), 0)
        assert np.array_equal(ours, ref), ksize

    def test_gaussian_blur_batched(self, rng):
        xs = rng.integers(0, 256, (64, 77, 77), np.uint8)
        ours = np.asarray(ops.gaussian_blur(xs, 5))
        for i in range(0, 64, 17):
            assert np.array_equal(ours[i], cv2.GaussianBlur(xs[i], (5, 5), 0))

    def test_gaussian_blur_nonsquare(self, rng):
        x = rng.integers(0, 256, (60, 90), np.uint8)
        assert np.array_equal(
            np.asarray(ops.gaussian_blur(x, 5)), cv2.GaussianBlur(x, (5, 5), 0)
        )

    def test_sharpen_exact(self, rng):
        img = _rand_img(rng)
        k = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]])
        assert np.array_equal(np.asarray(ops.sharpen(img)), cv2.filter2D(img, -1, k))

    def test_sharpen_gray_exact(self, rng):
        x = _rand_img(rng, 50, 50, c=0)
        k = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]])
        assert np.array_equal(np.asarray(ops.sharpen(x)), cv2.filter2D(x, -1, k))

    def test_normalize_minmax_exact(self, rng):
        img = _rand_img(rng)
        ours = np.asarray(ops.normalize_minmax(img))
        ref = cv2.normalize(img, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
        assert np.array_equal(ours, ref)
        # low-contrast image
        img2 = (rng.integers(90, 140, (40, 40, 3))).astype(np.uint8)
        ours2 = np.asarray(ops.normalize_minmax(img2))
        ref2 = cv2.normalize(img2, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
        assert np.array_equal(ours2, ref2)

    def test_normalize_minmax_constant_image(self):
        # mx == mn: naive scale math gives 0*inf = NaN, whose u8 cast is
        # platform-dependent; cv2's saturate_cast(NaN) yields 0 (all-alpha)
        img = np.full((20, 30, 3), 137, np.uint8)
        ours = np.asarray(ops.normalize_minmax(img))
        ref = cv2.normalize(img, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)
        assert np.array_equal(ours, ref)
        assert ours.max() == 0

    def test_sobel3_exact(self, rng):
        x = _rand_img(rng, 40, 40, c=0)
        dx, dy = ops.sobel3(x)
        ref_dx = cv2.Sobel(x, cv2.CV_32F, 1, 0, ksize=3, borderType=cv2.BORDER_REPLICATE)
        ref_dy = cv2.Sobel(x, cv2.CV_32F, 0, 1, ksize=3, borderType=cv2.BORDER_REPLICATE)
        assert np.array_equal(np.asarray(dx, np.float32), ref_dx)
        assert np.array_equal(np.asarray(dy, np.float32), ref_dy)


class TestOtsu:
    def test_otsu_exact(self, rng):
        for _ in range(5):
            x = _rand_img(rng, 77, 77, c=0)
            gb = cv2.GaussianBlur(x, (5, 5), 0)
            t_ref, b_ref = cv2.threshold(gb, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
            t, b = ops.otsu_binarize(gb)
            assert float(t) == t_ref
            assert np.array_equal(np.asarray(b), b_ref)

    def test_otsu_bimodal(self):
        x = np.zeros((50, 50), np.uint8)
        x[:25] = 200
        t_ref, b_ref = cv2.threshold(x, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        t, b = ops.otsu_binarize(x)
        assert float(t) == t_ref
        assert np.array_equal(np.asarray(b), b_ref)


class TestPlanarLab:
    """planar_bgr2lab / planar_lab2bgr: the transpose-free enhanced-path
    forms must be BIT-equal to the HWC forms per pixel (they share the
    channel-math core)."""

    def test_planar_bgr2lab_bitequal(self, rng):
        img = rng.integers(0, 256, (64, 96, 3), np.uint8)
        hwc = np.asarray(ops.bgr2lab(jnp.asarray(img)))
        pl = np.asarray(ops.planar_bgr2lab(jnp.asarray(np.moveaxis(img, -1, 0))))
        assert np.array_equal(np.moveaxis(pl, 0, -1), hwc)

    def test_planar_lab2bgr_bitequal(self, rng):
        lab = rng.integers(0, 256, (64, 96, 3), np.uint8)
        hwc = np.asarray(ops.lab2bgr(jnp.asarray(lab)))
        pl = np.asarray(ops.planar_lab2bgr(jnp.asarray(np.moveaxis(lab, -1, 0))))
        assert np.array_equal(np.moveaxis(pl, 0, -1), hwc)

    def test_planar_batch_axis(self, rng):
        imgs = rng.integers(0, 256, (2, 3, 32, 48), np.uint8)
        out = np.asarray(ops.planar_bgr2lab(jnp.asarray(imgs)))
        for k in range(2):
            one = np.asarray(ops.planar_bgr2lab(jnp.asarray(imgs[k])))
            assert np.array_equal(out[k], one)
