"""Conv circle-detector backend: decision agreement vs the exact
voting backend. Small square sizes keep the CPU conv cheap; the full-scale
calibration (the 3-clip regression set at 77px squares) lives in
tests/test_regression_clip.py::test_exact_vs_conv_backend_agreement."""

import numpy as np
import pytest
import jax.numpy as jnp

from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops import hough_conv as hc

from fixtures import make_square


def test_conv_backend_agrees_with_exact(rng):
    size = 48
    h = np.full(64, size)
    params, bounds = hough_ops.HoughParams.from_geometry(h, h)
    plan, dims = hc.ConvHoughPlan.build(h, h)

    imgs = []
    for i in range(64):
        if i % 4 == 3:
            imgs.append(make_square(rng, radius=None, noise=int(rng.integers(1, 10)), size=size))
        else:
            imgs.append(
                make_square(
                    rng,
                    radius=int(rng.integers(11, 24)),
                    contrast=int(rng.integers(45, 110)),
                    noise=int(rng.integers(2, 10)),
                    off=(int(rng.integers(-5, 6)), int(rng.integers(-5, 6))),
                    size=size,
                )
            )
    imgs = jnp.asarray(np.stack(imgs))

    circ = hough_ops.hough_circles(imgs, params, bounds)
    ef, _, _, _, _ = hough_ops.best_circle_near_center(
        circ, jnp.full((64,), size), jnp.full((64,), size)
    )
    cc = hc.find_circle(imgs, plan, dims)
    agree = (np.asarray(cc.found) == np.asarray(ef)).sum()
    assert agree >= 58, f"conv-vs-exact agreement {agree}/64"


def test_conv_scores_separate_cleanly(rng):
    size = 48
    h = np.full(64, size)
    plan, dims = hc.ConvHoughPlan.build(h, h)
    clean = np.stack(
        [make_square(rng, radius=16, contrast=90, noise=3, size=size) for _ in range(32)]
        + [make_square(rng, radius=None, noise=3, size=size) for _ in range(32)]
    )
    cc = hc.find_circle(jnp.asarray(clean), plan, dims)
    scores = np.asarray(cc.score)
    assert scores[:32].min() > 50  # strong circles (proposal stage)
    assert scores[32:].max() < 30  # flat squares
    votes = np.asarray(cc.votes)
    assert votes[:32].min() > 25  # verification: cv2-semantics ray votes
    assert votes[32:].max() <= 25
    found = np.asarray(cc.found)
    assert found[:32].all() and not found[32:].any()


@pytest.mark.parametrize("n_streams", [1, 3])
def test_score_matmul_matches_f32_numpy(rng, n_streams):
    """The score product (bf16 operands, f32 accumulation) against an f32
    numpy product, alone and under vmap over streams with the basis
    unbatched (the batched pipeline's form)."""
    from card_checks import check_score_matmul

    planes = rng.standard_normal((n_streams, 64, 384)) if n_streams > 1 else rng.standard_normal((64, 384))
    check_score_matmul(rng.standard_normal((300, 384)), planes, n_streams)
