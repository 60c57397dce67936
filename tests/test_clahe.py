"""CLAHE (ops/enhance.clahe): per-tile histograms against np.bincount and
the full operator against the cv2 oracle (reference frame_enhancer.py:101-120).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chessboard_vision.ops.enhance import clahe, tile_histograms


@pytest.mark.parametrize("shape", [(620, 620), (720, 1280), (77, 77)])
def test_clahe_matches_cv2(rng, shape):
    cv2 = pytest.importorskip("cv2")
    x = rng.integers(0, 256, shape, np.uint8)
    ref = cv2.createCLAHE(3.0, (8, 8)).apply(x).astype(int)
    d = np.abs(np.asarray(clahe(jnp.asarray(x))).astype(int) - ref)
    assert d.max() <= 1
    assert (d > 0).mean() < 2e-3


@pytest.mark.parametrize("shape", [(624, 624), (720, 1280)])
def test_tile_histograms_match_bincount(rng, shape):
    H, W = shape
    th, tw = H // 8, W // 8
    pad = rng.integers(0, 256, shape, np.uint8)
    hist = np.asarray(tile_histograms(jnp.asarray(pad), 8))
    ref = np.stack([
        np.bincount(pad[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw].ravel(), minlength=256)
        for ty in range(8)
        for tx in range(8)
    ])
    assert np.array_equal(hist, ref)
