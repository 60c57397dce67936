"""Bilateral filter: the XLA form against the cv2 oracle, and the Triton
kernel (ops/pallas/bilateral.py) against the XLA form.

The kernel runs here in Pallas's interpret mode; its compiled form is
checked on the card by tests/test_card.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chessboard_vision import platform
from chessboard_vision.ops.enhance import bilateral_planar
from chessboard_vision.ops.pallas import bilateral as pb


@pytest.mark.parametrize("shape", [(3, 40, 70), (3, 16, 32), (3, 21, 33)])
def test_triton_interpret_matches_xla(rng, shape):
    # 40x70 spans several tiles with ragged edges; 16x32 is exactly one
    # tile; 21x33 is one tile plus a sliver in each direction.
    x = jnp.asarray(rng.integers(0, 256, shape, np.uint8))
    got = np.asarray(pb.bilateral_planar_triton(x, interpret=True))
    assert np.array_equal(got, np.asarray(bilateral_planar(x)))


def test_round_half_even_matches_jnp_round():
    x = np.concatenate([
        np.arange(0, 256, 0.5, dtype=np.float32),
        np.array([2.4999, 2.5001, 254.49, 0.0], np.float32),
    ])
    got = np.asarray(pb._round_half_even(jnp.asarray(x)))
    assert np.array_equal(got, np.round(x))


@pytest.mark.parametrize("shape", [(120, 120), (77, 77), (100, 130)])
def test_xla_bilateral_matches_cv2(rng, shape):
    cv2 = pytest.importorskip("cv2")
    h, w = shape
    img = np.zeros((h, w, 3), np.uint8)
    sq = max(h // 8, 1)
    for r in range(0, h, sq):
        for c in range(0, w, sq):
            img[r : r + sq, c : c + sq] = (181, 217, 240) if (r // sq + c // sq) % 2 == 0 else (99, 136, 181)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    ours = np.moveaxis(np.asarray(bilateral_planar(jnp.asarray(np.moveaxis(img, -1, 0)))), 0, -1)
    ref = cv2.bilateralFilter(img, d=9, sigmaColor=75, sigmaSpace=75)
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.02


def test_platform_bilateral_is_xla_off_cuda(rng):
    x = jnp.asarray(rng.integers(0, 256, (3, 64, 128), np.uint8))
    assert np.array_equal(np.asarray(platform.bilateral(x)), np.asarray(bilateral_planar(x)))
