"""Headless coverage for the calibrator tools' supporting logic.

The trackbar UIs need a camera, but everything they drive is testable:
the lifted-piece legal-destination preview, the change-detector blur
kernel plumbing (geometry blur_pad + pipeline change_settings), and the
detector_overrides seam (reference calibrate_piece_detector.py sets
detector attributes directly; VisionPipeline(detector_overrides=...) is
that seam).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.ops.piece import METHOD_CENTER_DIFF, METHOD_HOUGH
from chessboard_vision.rules import GameState
from chessboard_vision.tools.calibrate_sensitivity import (
    lifted_square_and_destinations,
)

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS


def test_lifted_piece_preview():
    game = GameState()
    occ = game.get_board_occupancy()

    # nothing lifted
    lifted, dests = lifted_square_and_destinations(game, occ)
    assert lifted is None and dests == []

    # e2 pawn lifted -> destinations e3, e4
    lifted, dests = lifted_square_and_destinations(game, occ - {(4, 1)})
    assert lifted == (4, 1)
    assert set(dests) == {(4, 2), (4, 3)}

    # g1 knight lifted -> f3, h3
    lifted, dests = lifted_square_and_destinations(game, occ - {(6, 0)})
    assert lifted == (6, 0)
    assert set(dests) == {(5, 2), (7, 2)}

    # two missing or an extra square -> no preview
    assert lifted_square_and_destinations(game, occ - {(4, 1), (3, 1)})[0] is None
    assert lifted_square_and_destinations(game, (occ - {(4, 1)}) | {(4, 4)})[0] is None


def test_blur_kernel_plumbing(rng):
    frame = make_board_frame(initial_occupancy(), rng)
    g3 = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS, blur_pad=3)

    # kernel 7 needs pad >= 3: default-pad geometry must refuse loudly
    g2 = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    with pytest.raises(ValueError, match="blur_pad"):
        VisionPipeline(g2, change_settings={"blur_kernel": 7})
    with pytest.raises(ValueError, match="odd"):
        VisionPipeline(g3, change_settings={"blur_kernel": 6})

    # wider-pad geometry + kernel 5 == default geometry + kernel 5 exactly
    # (the center crop recovers the 5-kernel border semantics)
    pipe_a = VisionPipeline(g2, hough_backend="exact")
    pipe_b = VisionPipeline(g3, hough_backend="exact")
    sa, oa = pipe_a.step(pipe_a.init_state(), jnp.asarray(frame))
    sb, ob = pipe_b.step(pipe_b.init_state(), jnp.asarray(frame))
    for field in oa._fields:
        assert np.array_equal(np.asarray(getattr(oa, field)), np.asarray(getattr(ob, field))), field

    # kernel 7 changes only the change-detector branch, not detection
    pipe_c = VisionPipeline(g3, hough_backend="exact", change_settings={"blur_kernel": 7})
    sc, oc = pipe_c.step(pipe_c.init_state(), jnp.asarray(frame))
    assert np.array_equal(np.asarray(ob.occupancy), np.asarray(oc.occupancy))
    assert np.array_equal(np.asarray(ob.method), np.asarray(oc.method))


def test_detector_overrides(rng):
    frame = make_board_frame(initial_occupancy(), rng)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    truth = {(f, r) for f in range(8) for r in range(8) if initial_occupancy()[f, r]}

    base = VisionPipeline(g, hough_backend="exact")
    _, out = base.step(base.init_state(), jnp.asarray(frame))
    assert occupancy_to_set(out.occupancy) == truth
    assert (np.asarray(out.method)[np.asarray(out.occupancy)] == METHOD_HOUGH).any()

    # an absurd param2 starves the Hough voter: no square may report hough
    strict = VisionPipeline(
        g, hough_backend="exact",
        detector_overrides={"hough_param2": 10_000, "center_diff_threshold": 5},
    )
    _, out2 = strict.step(strict.init_state(), jnp.asarray(frame))
    m2 = np.asarray(out2.method)
    assert not (m2 == METHOD_HOUGH).any()
    # ...and the cascade falls through to center_diff on piece squares
    assert (m2[np.asarray(out2.occupancy)] == METHOD_CENTER_DIFF).any()
