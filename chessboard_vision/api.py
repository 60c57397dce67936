"""Top-level convenience API — the BASELINE-named entry points.

BASELINE.json names the public surface a reference user expects:
``enhance_frame, extract_grid, detect_pieces, detect_changes, FEN
generation``. These are one-call host-convenience wrappers (numpy HWC
in/out) over the fused device pipeline; production code uses
`models.pipeline.VisionPipeline` / `session.GameSession` directly, where
the whole frame->FEN step is one XLA call and state is threaded
explicitly.

Pipelines are cached per (corners, grid, settings) key, so repeated
calls with one rig's calibration reuse the compiled step.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.rules.fen import (  # noqa: F401  (re-exports)
    generate_fen,
    map_detections_to_board,
    occupancy_to_colored_fen,
    occupancy_to_fen,
)

SquareTuple = Tuple[int, int]

_pipelines: dict = {}


_enhancers: dict = {}


def enhance_frame(frame: np.ndarray, profile: Optional[dict] = None) -> np.ndarray:
    """5-stage enhancement of an HWC BGR u8 frame (reference
    frame_enhancer.process_pipeline: color profile -> CLAHE-on-LAB-L ->
    bilateral -> sharpen -> min-max normalize). Enhancers are cached per
    profile so repeated calls reuse the compiled pipeline."""
    from chessboard_vision.models.enhancer import ImageEnhancerJax

    key = json.dumps(profile, sort_keys=True) if profile else None
    if key not in _enhancers:
        _enhancers[key] = ImageEnhancerJax(profile=profile)
    return _enhancers[key].process_pipeline(frame)


def extract_grid(
    frame: np.ndarray,
    corners,
    grid_x=None,
    grid_y=None,
) -> Dict[SquareTuple, np.ndarray]:
    """Warp the frame to the top-down board and split into 64 square
    images keyed (file, rank), a1=(0, 0) — reference
    GridExtractor.split_board semantics (linear or smart-grid lines)."""
    import cv2

    pts = geo.reorder(corners)
    g = geo.BoardGeometry.from_calibration(corners)
    bs = g.board_size
    M = cv2.getPerspectiveTransform(
        np.float32(np.asarray(pts, np.float64)).reshape(4, 2),
        np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]]),
    )
    warped = cv2.warpPerspective(frame, M, (bs, bs))
    return geo.split_board_dict(warped, grid_x, grid_y)


def _pipeline_for(corners, settings: Optional[dict]):
    """Cached pipeline per calibration. donate_state=False: these
    stateless convenience calls feed a cached/shared PipelineState into
    step(), which with donation would delete the cached buffers after the
    first call on an accelerator (the production path threads its own state and
    keeps donation on)."""
    key = (
        json.dumps(np.asarray(corners).tolist()),
        json.dumps(settings, sort_keys=True) if settings else None,
    )
    if key not in _pipelines:
        from chessboard_vision.models.pipeline import VisionPipeline

        g = geo.BoardGeometry.from_calibration(corners)
        pipe = VisionPipeline(g, piece_settings=settings, donate_state=False)
        _pipelines[key] = (pipe, pipe.init_state())
    return _pipelines[key]


def detect_pieces(
    frame: np.ndarray,
    corners,
    reference_frame: Optional[np.ndarray] = None,
    settings: Optional[dict] = None,
) -> Set[SquareTuple]:
    """Occupied squares of one HWC BGR frame: the full per-square cascade
    (Hough circle / center-diff / ring symmetry — reference
    piece_detector.detect_all_pieces) as one fused device step.

    Stateless convenience: temporal smoothing and the delta cache are
    disabled (single-frame semantics). reference_frame, when given,
    provides the visual reference the center-diff method compares
    against."""
    pipe, state = _pipeline_for(corners, settings)
    if reference_frame is not None:
        state = pipe.capture_reference(state, reference_frame)
    _, out = pipe.step(state, frame, use_smoothing=False, use_delta=False)
    from chessboard_vision.models.pipeline import occupancy_to_set

    return occupancy_to_set(out.occupancy)


def detect_changes(
    frame: np.ndarray,
    corners,
    reference_frame: np.ndarray,
    settings: Optional[dict] = None,
) -> Set[SquareTuple]:
    """Squares whose content changed vs the reference frame (the EMA
    z-score background model, reference change_detector semantics),
    single-shot: calibrate on the reference, detect on the frame."""
    pipe, state = _pipeline_for(corners, settings)
    state = pipe.capture_reference(state, reference_frame)
    _, out = pipe.step(state, frame, use_smoothing=False, use_delta=False)
    # change_intensity: 0 = none, 1/2/3 = LEVE/PARCIAL/TOTAL (reference
    # change_detector.detect_changes_detailed intensity classes).
    changed = np.asarray(out.change_intensity) > 0
    return {(int(i) % 8, int(i) // 8) for i in np.nonzero(changed)[0]}


def frame_to_fen(
    frame: np.ndarray,
    corners,
    reference_frame: Optional[np.ndarray] = None,
    settings: Optional[dict] = None,
) -> str:
    """One frame -> occupancy FEN (placement field uses 'P' per piece)."""
    occ = detect_pieces(frame, corners, reference_frame, settings)
    mask = np.zeros((8, 8), bool)
    for f, r in occ:
        mask[f, r] = True
    return occupancy_to_fen(mask)


def frame_to_full_fen(
    frame: np.ndarray,
    corners,
    calibration_frames,
    calibration_board=None,
    frames=None,
    settings: Optional[dict] = None,
) -> str:
    """Frame(s) -> FULL FEN placement via the piece-TYPE classifier.

    calibration_frames: one frame (or list) of a KNOWN position
    (calibration_board, default the initial setup) — per-type radius
    centroids are fitted there (rules.piece_types; the capability the
    reference's fen_generator API waits for). frames: optional extra
    frames of the target position to average radii over (detected radii
    jitter a few px per frame). Unknown squares degrade to the colored-FEN
    pawn placeholder.
    """
    from chessboard_vision.rules import chess, classify_piece_colors
    from chessboard_vision.rules.piece_types import (
        PieceTypeClassifier,
        average_extents,
        average_radii,
        mask_radii_by_method,
        occupancy_to_full_fen,
    )

    if calibration_board is None:
        calibration_board = chess.Board()
    if not isinstance(calibration_frames, (list, tuple)):
        calibration_frames = [calibration_frames]
    target_frames = [frame] + list(frames or [])

    pipe, state = _pipeline_for(corners, settings)
    all_sq = {(f, r) for f in range(8) for r in range(8)}

    def features_over(st, frs):
        rads, exts, out = [], [], None
        for fr in frs:
            st, out = pipe.step(
                st, fr, squares_to_check=all_sq,
                use_smoothing=False, use_delta=False,
            )
            rads.append(mask_radii_by_method(out.radius, out.method))
            exts.append(np.asarray(out.profile_extent))
        return (
            st,
            average_radii(np.stack(rads)),
            average_extents(np.stack(exts)),
            out,
        )

    state = pipe.capture_reference(state, calibration_frames[0])
    state, cal_radii, cal_extents, _ = features_over(state, calibration_frames)
    clf = PieceTypeClassifier()
    clf.calibrate(cal_radii, calibration_board, extents=cal_extents)

    state = pipe.capture_reference(state, target_frames[0])
    state, radii, extents, out = features_over(state, target_frames)
    occ = np.asarray(out.occupancy)
    colors = classify_piece_colors(
        np.asarray(out.center_mean), occ, np.asarray(out.corner_mean)
    )
    chars = clf.classify(radii, occ, colors, extents=extents)
    return occupancy_to_full_fen(occ.reshape(8, 8).T, chars, piece_colors=colors)


def digitize_video(
    video_path: str,
    corners=None,
    config: Optional[dict] = None,
    skip_frames: int = 2,
    max_frames: Optional[int] = None,
    auto_recalibrate: bool = False,
    pgn_headers: Optional[dict] = None,
) -> dict:
    """One-call recorded-footage digitizer: video file -> moves/FEN/PGN.

    Wraps tools.process_video.run + rules.pgn.game_to_pgn. Pass either the
    4 calibration ``corners`` (TL, TR, BL, BR) or a full calibration
    ``config`` dict. Returns {"moves": [uci...], "fen": str, "pgn": str,
    "frames": int}.
    """
    from chessboard_vision.rules.pgn import game_to_pgn
    from chessboard_vision.tools.process_video import run

    if config is None:
        if corners is None:
            raise ValueError("pass corners or a calibration config")
        config = {
            "corners": np.asarray(corners).tolist(),
            "player_color": "white",
            "orientation_flipped": False,
        }
    if auto_recalibrate:
        config = {**config, "auto_recalibrate": True}
    moves, fen, n = run(
        video_path, config, skip_frames=skip_frames, max_frames=max_frames
    )
    return {
        "moves": list(moves),
        "fen": fen,
        # claim_draws: the recording IS the whole game, so a final
        # claimable-draw position is the game's actual ending.
        "pgn": game_to_pgn(moves, headers=pgn_headers, claim_draws=True),
        "frames": n,
    }
