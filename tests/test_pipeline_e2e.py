"""End-to-end parity: the fused device pipeline vs the cv2 oracle path.

Drives synthetic board frames (rendered from occupancy grids, perspective-
projected into a 1280x720 'camera' frame) through both:
  oracle:  cv2.warpPerspective -> reference split -> PieceDetectorCV
  ours:    VisionPipeline.step (one jitted call)
and asserts identical reported occupancy each frame — the FEN-parity
requirement from BASELINE.md — including across a move sequence with the
delta-cache/smoothing state machine engaged.
"""

import cv2
import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.reference import PieceDetectorCV
from chessboard_vision.rules import occupancy_to_fen

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS


def oracle_split(warped):
    out = {}
    h, w = warped.shape[:2]
    sh, sw = h // 8, w // 8
    for row in range(8):
        for col in range(8):
            out[(col, 7 - row)] = warped[row * sh : (row + 1) * sh, col * sw : (col + 1) * sw]
    return out


class OraclePath:
    """The reference per-frame path: warp -> split -> detect_all_pieces."""

    def __init__(self, corners):
        pts = geo.reorder(corners)
        bs = 620
        pts2 = np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]])
        self.M = cv2.getPerspectiveTransform(np.float32(pts).reshape(4, 2), pts2)
        self.bs = bs
        self.det = PieceDetectorCV()

    def warp(self, frame):
        return cv2.warpPerspective(frame, self.M, (self.bs, self.bs))

    def capture_reference(self, frame):
        self.det.update_references(oracle_split(self.warp(frame)))

    def step(self, frame, squares_to_check=None):
        squares = oracle_split(self.warp(frame))
        results, changes = self.det.detect_all_pieces(
            squares, use_delta=True, squares_to_check=squares_to_check
        )
        occ = {pos for pos, info in results.items() if info["has_piece"]}
        return occ, changes


def test_single_frame_occupancy_parity(rng):
    occ_grid = initial_occupancy()
    frame = make_board_frame(occ_grid, rng)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g)
    state = pipe.init_state()

    oracle = OraclePath(DEFAULT_CORNERS)

    state, out = pipe.step(state, frame)
    occ_ours = occupancy_to_set(out.occupancy)
    results, changes_ref = oracle.det.detect_all_pieces(
        oracle_split(oracle.warp(frame)), use_delta=True
    )
    occ_ref = {pos for pos, info in results.items() if info["has_piece"]}
    assert occ_ours == occ_ref
    # On the clean fixture both must equal the true grid
    truth = {(f, r) for f in range(8) for r in range(8) if occ_grid[f, r]}
    assert occ_ref == truth


def test_sequence_parity_with_state_machine(rng):
    """A short 'clip': reference capture, stable frames, a move (e2->e4),
    then a hand-occlusion frame. Occupancy + visual-change parity on every
    frame, and final FEN parity."""
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g)
    state = pipe.init_state()
    oracle = OraclePath(DEFAULT_CORNERS)

    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2 -> e4

    frame0 = make_board_frame(occ0, rng)
    state = pipe.capture_reference(state, frame0)
    oracle.capture_reference(frame0)

    frames = [make_board_frame(occ0, rng) for _ in range(3)]
    frames += [make_board_frame(occ1, rng) for _ in range(6)]
    # hand occlusion: big gray blob over the middle
    hand = make_board_frame(occ1, rng)
    hand[250:520, 450:800] = (120, 110, 100)
    frames.append(hand)
    # enough clean frames for the 5-frame presence smoothing to settle.
    # Post-hand frames force a full rescan (squares_to_check = all 64),
    # emulating the session's smart-scan forcing — without it, a hand-frame
    # detection stays cached forever (the square never "changes" again
    # because the visual reference was rightly not updated during the
    # unstable hand frame). That lock-in is faithful reference behavior
    # (piece_detector.py:376-436); the session layer's forced-scan set is
    # what clears it in the real app.
    frames += [make_board_frame(occ1, rng) for _ in range(6)]
    all_squares = {(f, r) for f in range(8) for r in range(8)}

    for i, fr in enumerate(frames):
        s2c = all_squares if i > 10 else None
        state, out = pipe.step(state, fr, squares_to_check=s2c)
        occ_ours = occupancy_to_set(out.occupancy)
        chg_ours = occupancy_to_set(out.visual_changes)
        occ_ref, chg_ref = oracle.step(fr, squares_to_check=s2c)
        assert occ_ours == occ_ref, f"frame {i}: occupancy mismatch"
        assert chg_ours == chg_ref, f"frame {i}: visual-change mismatch"

    # Final occupancy -> FEN parity
    final_mask = np.zeros((8, 8), bool)
    for f, r in occupancy_to_set(out.occupancy):
        final_mask[f, r] = True
    assert occupancy_to_fen(final_mask) == occupancy_to_fen(occ1)


def test_smart_scan_parity(rng):
    """squares_to_check forcing matches the oracle's behavior."""
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g)
    state = pipe.init_state()
    oracle = OraclePath(DEFAULT_CORNERS)

    occ0 = initial_occupancy()
    f0 = make_board_frame(occ0, rng)
    state = pipe.capture_reference(state, f0)
    oracle.capture_reference(f0)

    s2c = {(4, 1), (4, 2), (4, 3), (0, 0), (3, 6)}
    for i in range(4):
        fr = make_board_frame(occ0, rng)
        state, out = pipe.step(state, fr, squares_to_check=s2c)
        occ_ref, chg_ref = oracle.step(fr, squares_to_check=s2c)
        assert occupancy_to_set(out.occupancy) == occ_ref, f"frame {i}"
        assert occupancy_to_set(out.visual_changes) == chg_ref, f"frame {i}"


def test_step_many_matches_sequential_steps(rng):
    """The chunked scan step (one dispatch per K frames — the throughput
    path) is bit-identical to K sequential step() calls: outputs AND all
    carried state (delta cache, smoothing history, EMA background model)."""
    import jax
    import jax.numpy as jnp
    from chessboard_vision.ops import static_resample as sr

    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, donate_state=False)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True

    f0 = make_board_frame(occ0, rng)
    state_seq = pipe.capture_reference(pipe.init_state(), f0)
    state_chunk = jax.tree.map(lambda x: x.copy(), state_seq)

    frames = [make_board_frame(occ0, rng) for _ in range(2)]
    frames += [make_board_frame(occ1, rng) for _ in range(3)]
    planar = np.stack([sr.to_planar(f) for f in frames])

    outs_seq = []
    for i in range(len(frames)):
        state_seq, o = pipe.step(state_seq, jnp.asarray(planar[i]))
        outs_seq.append(o)
    state_chunk, outs = pipe.step_many(state_chunk, jnp.asarray(planar))

    for i in range(len(frames)):
        for field in outs._fields:
            a = np.asarray(getattr(outs_seq[i], field))
            b = np.asarray(getattr(outs, field))[i]
            assert np.array_equal(a, b), f"frame {i} field {field}"
    for la, lb in zip(jax.tree.leaves(state_seq), jax.tree.leaves(state_chunk)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))


def test_step_many_nested_scan_matches_flat(rng):
    """step_many(inner_chunk=K/2) — the scan-of-scans form every chunked
    dispatch uses — is bit-identical to the flat scan: outputs and carried
    state."""
    import jax
    import jax.numpy as jnp
    from chessboard_vision.ops import static_resample as sr

    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, donate_state=False)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True

    f0 = make_board_frame(occ0, rng)
    state_flat = pipe.capture_reference(pipe.init_state(), f0)
    state_nest = jax.tree.map(lambda x: x.copy(), state_flat)

    frames = [make_board_frame(occ0, rng) for _ in range(2)]
    frames += [make_board_frame(occ1, rng) for _ in range(2)]
    planar = jnp.asarray(np.stack([sr.to_planar(f) for f in frames]))

    state_flat, outs_flat = pipe.step_many(state_flat, planar)
    state_nest, outs_nest = pipe.step_many(state_nest, planar, inner_chunk=2)

    for field in outs_flat._fields:
        assert np.array_equal(
            np.asarray(getattr(outs_flat, field)),
            np.asarray(getattr(outs_nest, field)),
        ), field
    for la, lb in zip(jax.tree.leaves(state_flat), jax.tree.leaves(state_nest)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))


def test_nested_scan_recursion_bounds_flat_lengths():
    """nested_scan recurses through its OUTER scan too: at k = 512 /
    inner = 16 the outer loop has 32 groups, which as a flat scan would
    itself be longer than inner.
    Spy on jax.lax.scan to assert every emitted flat scan is < 32 long,
    and that outputs/state equal the flat form."""
    import jax
    import jax.numpy as jnp
    from unittest import mock
    from chessboard_vision.models.pipeline import nested_scan

    def body(c, x):
        c = c + x
        return c, c * 2

    xs = jnp.arange(517, dtype=jnp.int32)  # 32 groups of 16 + remainder 5
    want_state, want_outs = jax.lax.scan(body, jnp.int32(0), xs)

    lengths = []
    real_scan = jax.lax.scan

    def spy(f, init, xs_, *a, **k):
        lengths.append(jax.tree.leaves(xs_)[0].shape[0])
        return real_scan(f, init, xs_, *a, **k)

    with mock.patch.object(jax.lax, "scan", side_effect=spy):
        got_state, got_outs = nested_scan(body, jnp.int32(0), xs, 517, inner=16)

    assert lengths and max(lengths) < 32, lengths
    assert int(got_state) == int(want_state)
    np.testing.assert_array_equal(np.asarray(got_outs), np.asarray(want_outs))


def test_step_many_nested_scan_remainder(rng):
    """Non-multiple chunk lengths run the nested scan plus a short flat
    remainder scan (nested_scan), bit-identical to the flat form — the
    guard that K=40-style chunks never fall back to a flat scan >= 32."""
    import jax
    import jax.numpy as jnp
    from chessboard_vision.ops import static_resample as sr

    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, donate_state=False)
    occ = initial_occupancy()
    f0 = make_board_frame(occ, rng)
    state_flat = pipe.capture_reference(pipe.init_state(), f0)
    state_nest = jax.tree.map(lambda x: x.copy(), state_flat)

    frames = [make_board_frame(occ, rng) for _ in range(5)]
    planar = jnp.asarray(np.stack([sr.to_planar(f) for f in frames]))

    state_flat, outs_flat = pipe.step_many(state_flat, planar)
    # 5 = 2 + 2 + 1: two inner groups and a 1-frame remainder
    state_nest, outs_nest = pipe.step_many(state_nest, planar, inner_chunk=2)

    for field in outs_flat._fields:
        assert np.array_equal(
            np.asarray(getattr(outs_flat, field)),
            np.asarray(getattr(outs_nest, field)),
        ), field
    for la, lb in zip(jax.tree.leaves(state_flat), jax.tree.leaves(state_nest)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))


def test_flipped_orientation(rng):
    """orientation_flipped geometry reports the same logical occupancy for a
    180-rotated physical setup."""
    occ = np.zeros((8, 8), bool)
    occ[4, 0] = occ[4, 7] = occ[0, 0] = True  # e1, e8, a1
    # Render flipped: the physical board appears rotated; the flipped
    # geometry should undo it. Rotating the occupancy grid 180 degrees maps
    # (f, r) -> (7-f, 7-r).
    occ_rot = occ[::-1, ::-1].copy()
    frame = make_board_frame(occ_rot, rng)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS, orientation_flipped=True)
    pipe = VisionPipeline(g)
    state = pipe.init_state()
    state, out = pipe.step(state, frame)
    truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
    assert occupancy_to_set(out.occupancy) == truth
