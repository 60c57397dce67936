"""Session checkpoint/resume (utils/checkpoint.py + GameSession methods).

The e2e test interrupts a session mid-game, resumes it in a FRESH
session object (pipeline rebuilt from the stored config), and checks the
continued game reaches the exact same FEN as an uninterrupted session
fed the identical frame sequence.
"""

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest

from chessboard_vision.utils.checkpoint import load_tree, save_tree
from chessboard_vision.session.game_session import GameSession
from chessboard_vision.rules import chess

from fixtures import DEFAULT_CORNERS, make_board_frame


class Inner(NamedTuple):
    a: jnp.ndarray
    b: jnp.ndarray


class Outer(NamedTuple):
    x: Inner
    y: jnp.ndarray


def test_tree_roundtrip(tmp_path):
    t = Outer(
        Inner(jnp.arange(6, dtype=jnp.uint8).reshape(2, 3), jnp.ones((4,), jnp.float32)),
        jnp.asarray(True),
    )
    p = str(tmp_path / "c.npz")
    save_tree(p, t, {"k": [1, 2], "s": "v"})
    out, meta = load_tree(p, t)
    assert meta == {"k": [1, 2], "s": "v"}
    np.testing.assert_array_equal(np.asarray(out.x.a), np.asarray(t.x.a))
    np.testing.assert_array_equal(np.asarray(out.y), np.asarray(t.y))


def test_tree_legacy_scalar_leaf_broadcasts(tmp_path):
    """A checkpoint leaf saved as a scalar loads into a widened vector
    template (ChangeModelState.calibrated went () -> (64,); old
    checkpoints must stay resumable)."""
    old = Inner(jnp.zeros((2, 3)), jnp.asarray(True))  # b saved as scalar
    p = str(tmp_path / "c.npz")
    save_tree(p, old, {})
    new_tmpl = Inner(jnp.zeros((2, 3)), jnp.zeros((64,), bool))
    out, _ = load_tree(p, new_tmpl)
    assert np.asarray(out.b).shape == (64,)
    assert np.asarray(out.b).all()


def test_tree_legacy_3d_change_leaf_flattens(tmp_path):
    """A checkpoint saved when the change model stored (64, H, W) loads
    into the flat (64, H*W) template (the layout-unambiguity redesign,
    ops/change.ChangeModelState) with identical row-major values."""
    rng = np.random.default_rng(0)
    old_means = rng.uniform(0, 255, (64, 7, 5)).astype(np.float32)
    old = Inner(jnp.asarray(old_means), jnp.ones((64,), bool))
    p = str(tmp_path / "c.npz")
    save_tree(p, old, {})
    new_tmpl = Inner(jnp.zeros((64, 35), jnp.float32), jnp.zeros((64,), bool))
    out, _ = load_tree(p, new_tmpl)
    np.testing.assert_array_equal(
        np.asarray(out.a), old_means.reshape(64, 35)
    )


def test_tree_shape_mismatch_raises(tmp_path):
    t = Inner(jnp.zeros((2, 3)), jnp.zeros((4,)))
    p = str(tmp_path / "c.npz")
    save_tree(p, t, {})
    bad = Inner(jnp.zeros((3, 3)), jnp.zeros((4,)))
    with pytest.raises(ValueError, match="different geometry"):
        load_tree(p, bad)


def _occ(board):
    occ = np.zeros((8, 8), bool)
    for sq in chess.SQUARES:
        if board.piece_at(sq) is not None:
            occ[chess.square_file(sq), chess.square_rank(sq)] = True
    return occ


CONFIG = {
    "corners": [list(map(int, c)) for c in np.asarray(DEFAULT_CORNERS)],
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}


def _drive(session, frames):
    got = []
    for f in frames:
        mv = session.on_frame(f)
        if mv is not None:
            got.append(mv.uci())
    return got


@pytest.mark.slow
def test_session_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(3)
    board = chess.Board()
    f_ref = make_board_frame(_occ(board), rng)
    board.push_uci("e2e4")
    frames_1 = [make_board_frame(_occ(board), rng) for _ in range(30)]
    board.push_uci("e7e5")
    frames_2 = [make_board_frame(_occ(board), rng) for _ in range(30)]

    def fresh():
        s = GameSession(headless=True)
        s.MOVE_COOLDOWN = 0.0
        assert s.on_calibration_requested(None, config=CONFIG)
        return s

    # Uninterrupted baseline.
    s0 = fresh()
    s0.capture_reference_frame(f_ref)
    moves0 = _drive(s0, frames_1) + _drive(s0, frames_2)
    assert moves0 == ["e2e4", "e7e5"]

    # Interrupted: checkpoint after move 1, resume in a NEW session
    # (configured straight from the checkpoint's stored config).
    s1 = fresh()
    s1.capture_reference_frame(f_ref)
    assert _drive(s1, frames_1) == ["e2e4"]
    ckpt = str(tmp_path / "mid.npz")
    s1.save_checkpoint(ckpt)

    s2 = GameSession(headless=True)
    s2.MOVE_COOLDOWN = 0.0
    meta = s2.resume_checkpoint(ckpt)
    assert meta["fen"] == s1.game.get_fen()
    assert _drive(s2, frames_2) == ["e7e5"]
    assert s2.game.get_fen() == s0.game.get_fen()
