"""Shared fixture for the 2-process fleet vision test: a small-geometry
MultiStreamPipeline plus deterministic per-stream frames, used by BOTH the
single-process reference run (tests/test_distributed.py) and the fleet
workers (tests/_dist_worker.py) so occupancy can be compared bit-for-bit
across process layouts.
"""

from __future__ import annotations

import numpy as np

N_STREAMS = 8
PROCESSES = 2
STREAMS_PER_PROC = N_STREAMS // PROCESSES

# Small rig: 320x240 capture, margin 80 -> 160x160 board, 20 px squares.
# Big enough that the detector cascade operates normally, small enough
# that per-worker compiles stay cheap.
FLEET_CORNERS = np.array([[40, 20], [280, 24], [36, 210], [284, 216]])
FRAME_SIZE = (240, 320)  # (H, W)
DISPLAY_SIZE = (320, 240)  # (W, H)
MARGIN = 80


def make_fleet_pipeline(mesh):
    from chessboard_vision.geometry import BoardGeometry
    from chessboard_vision.parallel.multistream import MultiStreamPipeline

    g = BoardGeometry.from_calibration(
        FLEET_CORNERS, display_size=DISPLAY_SIZE, margin=MARGIN
    )
    return MultiStreamPipeline(g, n_streams=N_STREAMS, mesh=mesh)


def stream_frames(gi: int):
    """(reference_frame, step_frame) for global stream ``gi``, planar u8.

    Stream gi's game: the pawn on file gi%8 leaves its home square — each
    rig sees a different board, so cross-process shard mixups can't pass.
    """
    from chessboard_vision.ops.static_resample import to_planar

    from fixtures import initial_occupancy, make_board_frame

    rng = np.random.default_rng(1000 + gi)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[gi % 8, 1] = False
    f0 = make_board_frame(occ0, rng, corners=FLEET_CORNERS, frame_size=FRAME_SIZE)
    f1 = make_board_frame(occ1, rng, corners=FLEET_CORNERS, frame_size=FRAME_SIZE)
    return to_planar(f0), to_planar(f1)
