"""Multi-stream checkpoint/resume: the batched twin of
tests/test_checkpoint.py's resume-identity guarantee — a resumed
MultiStreamSession behaves bit-identically to the uninterrupted one."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame  # noqa: E402

import jax  # noqa: E402

from chessboard_vision import geometry as geo  # noqa: E402
from chessboard_vision.parallel.session import MultiStreamSession  # noqa: E402


def _build():
    g = geo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS))
    sess = MultiStreamSession(g, n_streams=2)
    sess.STABILITY_REQUIRED = 4
    sess.MOVE_COOLDOWN = 0.0
    return sess


def test_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(7)
    occ = initial_occupancy()
    occ_e4 = occ.copy()
    occ_e4[4, 1] = False
    occ_e4[4, 3] = True

    # Pre-render every frame so both runs see identical pixels.
    ref = np.stack([make_board_frame(occ, np.random.default_rng(70)) for _ in range(2)])
    phase1 = [
        np.stack([
            make_board_frame(occ_e4, np.random.default_rng(100 + t)),
            make_board_frame(occ, np.random.default_rng(200 + t)),
        ])
        for t in range(6)
    ]
    occ2 = occ_e4.copy()
    occ2[4, 6] = False  # black replies e7e5 on stream 0
    occ2[4, 4] = True
    phase2 = [
        np.stack([
            make_board_frame(occ2, np.random.default_rng(300 + t)),
            make_board_frame(occ_e4, np.random.default_rng(400 + t)),
        ])
        for t in range(7)
    ]

    sess = _build()
    sess.capture_reference(ref)
    committed1 = []
    for fr in phase1:
        committed1.append(sess.on_frames(fr))
    assert any(m and m.uci() == "e2e4" for m, _ in committed1), committed1

    ckpt = str(tmp_path / "ms.npz")
    sess.save_checkpoint(ckpt)
    snap_state = jax.tree.map(np.asarray, sess.state)

    # Continue the ORIGINAL session through phase 2.
    moves_orig = [sess.on_frames(fr) for fr in phase2]

    # Resume a FRESH session from the checkpoint and replay phase 2.
    sess2 = _build()
    meta = sess2.resume_checkpoint(ckpt)
    assert meta["n"] == 2
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, sess2.state)),
                    jax.tree.leaves(snap_state)):
        assert np.array_equal(a, b)
    assert sess2.streams[0].game.get_fen() == meta["streams"][0]["fen"]
    moves_res = [sess2.on_frames(fr) for fr in phase2]

    # Identical decisions and final state on both paths.
    assert [
        [m and m.uci() for m in tick] for tick in moves_orig
    ] == [[m and m.uci() for m in tick] for tick in moves_res]
    assert any(m and m.uci() == "e7e5" for m, _ in moves_res), moves_res
    assert any(m and m.uci() == "e2e4" for _, m in moves_res), moves_res
    for i in range(2):
        assert sess2.streams[i].game.get_fen() == sess.streams[i].game.get_fen()
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, sess2.state)),
                    jax.tree.leaves(jax.tree.map(np.asarray, sess.state))):
        assert np.array_equal(a, b)


def test_resume_rejects_stream_count_mismatch(tmp_path):
    rng = np.random.default_rng(8)
    occ = initial_occupancy()
    sess = _build()
    sess.capture_reference(
        np.stack([make_board_frame(occ, rng) for _ in range(2)])
    )
    ckpt = str(tmp_path / "ms.npz")
    sess.save_checkpoint(ckpt)

    g = geo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS))
    other = MultiStreamSession(g, n_streams=4)
    import pytest

    with pytest.raises(ValueError, match="2 streams"):
        other.resume_checkpoint(ckpt)
