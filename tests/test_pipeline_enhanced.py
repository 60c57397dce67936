"""with_enhancer=True: the fused enhancement stage ahead of detection.

Covers the fused enhancement stage (reference frame_enhancer.py:161-181 as a
first-class batched stage fused into the per-frame XLA call, SURVEY §3.5):
  - the board-tile matmul color warp vs the exact gather warp
  - the integer-coordinate board->squares extraction plan (bit-exact)
  - e2e occupancy parity vs the cv2-enhanced oracle path
    (cv2.warpPerspective -> ImageEnhancerCV.process_pipeline -> split ->
    PieceDetectorCV)
  - planar fast path vs HWC exact path decision agreement
"""

import cv2
import numpy as np
import jax.numpy as jnp

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.ops import matmul_resample as mr
from chessboard_vision.ops import warp as warp_ops
from chessboard_vision.ops.static_resample import to_planar
from chessboard_vision.reference import ImageEnhancerCV, PieceDetectorCV

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS


def test_board_tile_warp_matches_gather_warp(rng):
    """Matmul tile warp == exact bilinear gather warp within 1 u8 level."""
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    frame = make_board_frame(initial_occupancy(), rng)

    qx, qy, starts, T = g.board_tile_query_coords()
    plan, dims = mr.build_plan(qx, qy, g.src_h, g.src_w)
    ours = np.asarray(
        mr.warp_board_color(jnp.asarray(to_planar(frame)), plan, dims, starts, g.board_size)
    )
    exact = np.asarray(
        warp_ops.warp_bilinear(jnp.asarray(frame), jnp.asarray(g.warp_X), jnp.asarray(g.warp_Y))
    )
    exact_planar = np.moveaxis(exact, -1, 0)
    d = np.abs(ours.astype(int) - exact_planar.astype(int))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.01


def test_board_extract_plan_bit_exact(rng):
    """The integer-coords extraction plan reproduces board[sq_iy, sq_ix]."""
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    s = g.squares
    board = rng.integers(0, 256, (g.board_size, g.board_size), np.uint8)
    plan, dims = mr.build_plan(
        s.ix.astype(np.float32), s.iy.astype(np.float32),
        g.board_size + 1, g.board_size + 1,
    )
    padded = jnp.pad(jnp.asarray(board), ((0, 1), (0, 1)), mode="edge")
    ours = np.asarray(mr.resample_gray_u8(padded, plan, dims))
    ref = board[s.iy, s.ix]
    assert np.array_equal(ours, ref)


class EnhancedOraclePath:
    """Reference semantics: warp -> enhance (cv2) -> split -> detect."""

    def __init__(self, corners):
        pts = geo.reorder(corners)
        bs = 620
        pts2 = np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]])
        self.M = cv2.getPerspectiveTransform(np.float32(pts).reshape(4, 2), pts2)
        self.bs = bs
        self.enh = ImageEnhancerCV()
        self.det = PieceDetectorCV()

    def _squares(self, frame):
        board = cv2.warpPerspective(frame, self.M, (self.bs, self.bs))
        board = self.enh.process_pipeline(board)
        sh = self.bs // 8
        return {
            (c, 7 - r): board[r * sh : (r + 1) * sh, c * sh : (c + 1) * sh]
            for r in range(8)
            for c in range(8)
        }

    def capture_reference(self, frame):
        self.det.update_references(self._squares(frame))

    def step(self, frame):
        results, changes = self.det.detect_all_pieces(self._squares(frame), use_delta=True)
        occ = {pos for pos, info in results.items() if info["has_piece"]}
        return occ, changes


def test_enhanced_occupancy_parity_vs_cv2_oracle(rng):
    occ_grid = initial_occupancy()
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g, with_enhancer=True, hough_backend="exact")
    state = pipe.init_state()
    oracle = EnhancedOraclePath(DEFAULT_CORNERS)

    f0 = make_board_frame(occ_grid, rng)
    # HWC input keeps the warp stage bit-comparable with cv2.
    state = pipe.capture_reference(state, jnp.asarray(f0))
    oracle.capture_reference(f0)

    truth = {(f, r) for f in range(8) for r in range(8) if occ_grid[f, r]}
    for i in range(3):
        fr = make_board_frame(occ_grid, rng)
        state, out = pipe.step(state, jnp.asarray(fr))
        occ_ref, _ = oracle.step(fr)
        occ_ours = occupancy_to_set(out.occupancy)
        assert occ_ours == occ_ref, f"frame {i}"
        assert occ_ours == truth, f"frame {i}"


def test_enhanced_planar_fast_path_matches_hwc(rng):
    """The matmul-warp fast path reaches the same decisions as the exact
    HWC path (warp rounding differs by <=1 level; enhancement + cascade
    decisions must not flip on the fixture)."""
    occ_grid = initial_occupancy()
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe_a = VisionPipeline(g, with_enhancer=True, hough_backend="exact")
    pipe_b = VisionPipeline(g, with_enhancer=True, hough_backend="exact")

    f0 = make_board_frame(occ_grid, rng)
    sa = pipe_a.capture_reference(pipe_a.init_state(), jnp.asarray(f0))
    sb = pipe_b.capture_reference(pipe_b.init_state(), jnp.asarray(to_planar(f0)))

    for i in range(2):
        fr = make_board_frame(occ_grid, rng)
        sa, oa = pipe_a.step(sa, jnp.asarray(fr))
        sb, ob = pipe_b.step(sb, jnp.asarray(to_planar(fr)))
        assert occupancy_to_set(oa.occupancy) == occupancy_to_set(ob.occupancy), f"frame {i}"
