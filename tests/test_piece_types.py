"""Piece-TYPE classification (rules/piece_types.py): radius-centroid model
calibrated on the initial position, upgrading colored FEN to full FEN.

The reference's fen_generator waits for exactly this classifier
(fen_generator.py:5-10; SURVEY.md orphan) — these tests drive it end to
end through the vision pipeline on renders with per-type base radii
(fixtures.PIECE_RADIUS_FRAC, modeled on reference piece_stats.txt).
"""

import numpy as np
import pytest

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline
from chessboard_vision.rules import chess, classify_piece_colors
from chessboard_vision.rules.piece_types import (
    PieceTypeClassifier,
    average_radii,
    occupancy_to_full_fen,
)

from fixtures import DEFAULT_CORNERS, board_render_maps, make_board_frame

MIDGAME_FEN = "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 4 3"


def test_calibrate_and_classify_synthetic():
    board = chess.Board()
    radius = np.zeros(64)
    base = {1: 18, 2: 21, 3: 24, 4: 26, 5: 29, 6: 32}  # PAWN..KING px
    for sq in range(64):
        p = board.piece_at(sq)
        if p is not None:
            radius[sq] = base[p.piece_type] + (0.5 if p.color else -0.5)
    clf = PieceTypeClassifier()
    cents = clf.calibrate(radius, board)
    assert len(cents) == 12  # all (color, type) classes seen

    # Same radii, occupancy/colors from the board -> exact round trip.
    occ = np.zeros(64, bool)
    colors = np.full(64, -1, np.int8)
    for sq in range(64):
        p = board.piece_at(sq)
        if p is not None:
            occ[sq] = True
            colors[sq] = 1 if p.color else 0
    chars = clf.classify(radius, occ, colors)
    for sq in range(64):
        p = board.piece_at(sq)
        assert chars[sq] == (p.symbol() if p else "")


def test_unresolved_square_degrades_to_placeholder():
    clf = PieceTypeClassifier()
    clf.centroids = {(1, 1): 18.0}
    occ = np.zeros(64, bool)
    occ[0] = occ[1] = True
    colors = np.zeros(64, np.int8)
    colors[0] = 1
    colors[1] = 0  # dark: no centroids for color 0 -> '?'
    radius = np.zeros(64)
    radius[0] = 18
    chars = clf.classify(radius, occ, colors)
    assert chars[0] == "P" and chars[1] == "?"
    mask = np.zeros((8, 8), bool)
    mask[0, 0] = mask[1, 0] = True
    fen = occupancy_to_full_fen(mask, chars, piece_colors=colors)
    assert fen.split()[0].endswith("/Pp6")  # '?' degraded by color


@pytest.mark.slow
def test_full_fen_through_vision(rng):
    """Initial-position calibration -> mid-game full-FEN readout, entirely
    through the fused pipeline (radius + occupancy + color outputs)."""
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    pipe = VisionPipeline(g)
    all_squares = {(f, r) for f in range(8) for r in range(8)}

    AVG_FRAMES = 4  # radius jitters a few px/frame; average like the
    # session's 20-frame stability window does (see piece_types.average_radii)

    def stepped_radii(state, occ_m, col_m, rad_m):
        rads = []
        out = None
        for _ in range(AVG_FRAMES):
            # use_delta=False: full re-detect — the delta cache would hold
            # stale radii for visually-unchanged squares.
            state, out = pipe.step(
                state,
                make_board_frame(occ_m, rng, piece_colors=col_m, piece_radii=rad_m),
                squares_to_check=all_squares, use_delta=False,
            )
            rads.append(np.asarray(out.radius))
        return state, average_radii(np.stack(rads)), out

    start = chess.Board()
    occ0, col0, rad0 = board_render_maps(start)
    f0 = make_board_frame(occ0, rng, piece_colors=col0, piece_radii=rad0)
    state = pipe.capture_reference(pipe.init_state(), f0)
    state, radii0, _ = stepped_radii(state, occ0, col0, rad0)
    clf = PieceTypeClassifier()
    cents = clf.calibrate(radii0, start)
    assert len(cents) == 12, f"only {len(cents)} classes resolved: {cents}"

    target = chess.Board(MIDGAME_FEN)
    occ1, col1, rad1 = board_render_maps(target)
    frame1 = make_board_frame(occ1, rng, piece_colors=col1, piece_radii=rad1)
    # fresh reference on the new position so every circle re-resolves
    state = pipe.capture_reference(state, frame1)
    state, radii1, out1 = stepped_radii(state, occ1, col1, rad1)
    occ = np.asarray(out1.occupancy)
    colors = classify_piece_colors(
        np.asarray(out1.center_mean), occ, np.asarray(out1.corner_mean)
    )
    chars = clf.classify(radii1, occ, colors)
    mask = occ.reshape(8, 8).T
    got = occupancy_to_full_fen(mask, chars, piece_colors=colors).split()[0]
    want = target.fen().split()[0]
    assert got == want, f"\ngot  {got}\nwant {want}\nchars={chars.reshape(8, 8)}"


@pytest.mark.slow
def test_session_full_fen_and_verify(rng):
    """Live-session surface: calibrate_piece_types at the start position,
    commit a move from vision, then full_fen()/verify_position() agree
    with the rules board at piece-type granularity."""
    from chessboard_vision.session.game_session import GameSession

    s = GameSession(headless=True)
    s.MOVE_COOLDOWN = 0.0
    assert s.on_calibration_requested(None, config={
        "corners": DEFAULT_CORNERS.tolist(),
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    })
    start = chess.Board()
    occ0, col0, rad0 = board_render_maps(start)

    def frame(board_maps):
        o, c, r = board_maps
        return make_board_frame(o, rng, piece_colors=c, piece_radii=r)

    s.capture_reference_frame(frame((occ0, col0, rad0)))
    for _ in range(6):
        s.on_frame(frame((occ0, col0, rad0)))
    cents = s.calibrate_piece_types()
    assert cents is not None and len(cents) == 12

    after = chess.Board()
    after.push_uci("e2e4")
    maps1 = board_render_maps(after)
    committed = None
    for _ in range(40):
        committed = s.on_frame(frame(maps1))
        if committed:
            break
    assert committed is not None and committed.uci() == "e2e4"

    # refill the radius window on the new position; a full window also
    # auto-refreshes the centroids with rules-labeled samples (the radius
    # readout's neighborhood bias: crowded home squares read smaller than
    # isolated mid-board placements)
    for _ in range(s._radius_window.maxlen + 2):
        s.on_frame(frame(maps1))
    match, got, want = s.verify_position()
    assert match is True, f"\ngot  {got}\nwant {want}"
    assert want == after.fen().split()[0]


@pytest.mark.slow
def test_promotion_full_fen_sees_queen_on_e8(rng):
    """The queen-for-pawn radius swap through vision:
    after e7e8q commits from frames, full_fen()/verify_position() must
    read a QUEEN on e8 off the detected circle radius — a piece-TYPE
    change at constant occupancy is exactly what occupancy-FEN clips
    cannot see. The start position carries a white queen elsewhere so
    the radius model has a queen centroid to match."""
    from chessboard_vision.session.game_session import GameSession

    fen0 = "k7/4P3/8/8/8/8/1Q6/4K3 w - - 0 1"
    s = GameSession(headless=True)
    s.MOVE_COOLDOWN = 0.0
    assert s.on_calibration_requested(None, config={
        "corners": DEFAULT_CORNERS.tolist(),
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
    })
    s.game.set_fen(fen0)
    start = chess.Board(fen0)
    maps0 = board_render_maps(start)

    def frame(maps):
        o, c, r = maps
        return make_board_frame(o, rng, piece_colors=c, piece_radii=r)

    s.capture_reference_frame(frame(maps0))
    for _ in range(6):
        s.on_frame(frame(maps0))
    cents = s.calibrate_piece_types()
    assert cents is not None and (1, chess.QUEEN) in cents

    after = chess.Board(fen0)
    after.push_uci("e7e8q")
    maps1 = board_render_maps(after)
    committed = None
    for _ in range(40):
        committed = s.on_frame(frame(maps1))
        if committed:
            break
    assert committed is not None and committed.uci() == "e7e8q"

    for _ in range(s._radius_window.maxlen + 2):
        s.on_frame(frame(maps1))
    match, got, want = s.verify_position()
    assert want == after.fen().split()[0]
    assert match is True, f"\ngot  {got}\nwant {want}"
    # e8 (rank 8, file e) reads as 'Q' through the vision radius — not a
    # pawn placeholder and not the pre-promotion 'P'.
    assert got.split("/")[0] == "k3Q3", got


def test_knight_without_circle_is_classified_by_extent():
    """A square the cascade resolved WITHOUT a circle (radius masked to 0)
    must still be typed from its ring-coverage extent — not degrade to
    '?' -> pawn placeholder."""
    board = chess.Board()
    base_r = {1: 18, 2: 21, 3: 24, 4: 26, 5: 29, 6: 32}
    base_e = {1: 1.2, 2: 1.5, 3: 2.1, 4: 2.6, 5: 3.2, 6: 3.8}
    radius = np.zeros(64)
    extent = np.full(64, -1.0)
    for sq in range(64):
        p = board.piece_at(sq)
        if p is not None:
            radius[sq] = base_r[p.piece_type]
            extent[sq] = base_e[p.piece_type]
    clf = PieceTypeClassifier()
    clf.calibrate(radius, board, extents=extent)
    assert len(clf.extent_centroids) == 12

    occ = np.zeros(64, bool)
    colors = np.full(64, -1, np.int8)
    for sq in range(64):
        p = board.piece_at(sq)
        if p is not None:
            occ[sq] = True
            colors[sq] = 1 if p.color else 0
    # knights on b1/g1: no circle resolved this window (radius 0), but a
    # valid knight-sized extent
    rad2 = radius.copy()
    rad2[1] = rad2[6] = 0.0
    chars = clf.classify(rad2, occ, colors, extents=extent)
    assert chars[1] == "N" and chars[6] == "N"
    # and with NO extents supplied the same squares degrade (the old
    # radius-only behavior) — the feature is doing the work
    chars_old = clf.classify(rad2, occ, colors)
    assert chars_old[1] == "?" and chars_old[6] == "?"


def test_close_radii_split_by_extent():
    """Knight/bishop bases ~1 px apart: the integer Hough radius reads
    them identically, the sub-pixel extent still separates them."""
    clf = PieceTypeClassifier()
    clf.centroids = {(1, chess.KNIGHT): 22.0, (1, chess.BISHOP): 23.0}
    clf.extent_centroids = {(1, chess.KNIGHT): 1.70, (1, chess.BISHOP): 2.05}
    occ = np.zeros(64, bool)
    occ[1] = occ[2] = True
    colors = np.full(64, -1, np.int8)
    colors[1] = colors[2] = 1
    radius = np.zeros(64)
    radius[1] = radius[2] = 22.0  # the tied integer reading
    extent = np.full(64, -1.0)
    extent[1], extent[2] = 1.72, 2.03
    chars = clf.classify(radius, occ, colors, extents=extent)
    assert chars[1] == "N" and chars[2] == "B", chars[[1, 2]]


def test_mask_radii_by_method():
    from chessboard_vision.rules.piece_types import mask_radii_by_method

    radius = np.array([20, 25, 25, 25, 25])
    method = np.array([1, 2, 3, 4, 0])  # hough, tower_top, cdiff, sym, none
    got = mask_radii_by_method(radius, method)
    assert got.tolist() == [20, 25, 0, 0, 0]


@pytest.mark.slow
def test_knight_typed_through_vision_when_hough_is_off(rng):
    """End-to-end case: with the Hough stage effectively
    disabled (param2 far above any attainable vote count), every piece
    square resolves via center_diff/symmetry — masked radius 0 — yet
    full-FEN classification still reads knights (and every other type)
    from the profile extent."""
    from chessboard_vision.rules.piece_types import (
        average_extents,
        mask_radii_by_method,
    )

    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    # center_diff_threshold lowered through the calibrator seam: with the
    # circle stage off, a bright piece on a light square (center-border
    # contrast ~18 gray levels) must still pass the presence gate.
    pipe = VisionPipeline(g, detector_overrides={
        "hough_param2": 10_000, "center_diff_threshold": 12.0,
    })
    all_squares = {(f, r) for f in range(8) for r in range(8)}

    def features(state, maps, frames=3):
        o, c, r = maps
        rads, exts, out = [], [], None
        for _ in range(frames):
            state, out = pipe.step(
                state,
                make_board_frame(o, rng, piece_colors=c, piece_radii=r),
                squares_to_check=all_squares, use_delta=False,
            )
            rads.append(mask_radii_by_method(out.radius, out.method))
            exts.append(np.asarray(out.profile_extent))
        return (
            state,
            average_radii(np.stack(rads)),
            average_extents(np.stack(exts)),
            out,
        )

    start = chess.Board()
    maps0 = board_render_maps(start)
    f0 = make_board_frame(maps0[0], rng, piece_colors=maps0[1], piece_radii=maps0[2])
    state = pipe.capture_reference(pipe.init_state(), f0)
    state, radii0, extents0, out0 = features(state, maps0)
    # Hough is really off: no measured circle anywhere
    assert radii0.max() == 0.0
    assert np.asarray(out0.method)[np.asarray(out0.occupancy)].min() >= 3

    clf = PieceTypeClassifier()
    clf.calibrate(radii0, start, extents=extents0)
    assert not clf.centroids  # no radius feature available at all
    assert len(clf.extent_centroids) == 12

    occ = np.asarray(out0.occupancy)
    colors = classify_piece_colors(
        np.asarray(out0.center_mean), occ, np.asarray(out0.corner_mean)
    )
    chars = clf.classify(radii0, occ, colors, extents=extents0)

    # With the circle stage off, PRESENCE on a handful of white-on-light
    # squares legitimately fails the cascade's std>=15 prefilter (the
    # faint +18-gray disc is exactly what the outline-driven Hough stage
    # exists to catch; the reference cascade behaves the same). The claim
    # under test is the TYPING: every square the cascade did resolve must
    # be typed correctly from the extent alone — never '?', never the
    # wrong piece.
    light_sq = {sq for sq in range(64) if (sq // 8 + sq % 8) % 2 == 1}
    missed = {sq for sq in range(64) if start.piece_at(sq) and not occ[sq]}
    assert missed <= {
        sq for sq in light_sq
        if start.piece_at(sq) and start.piece_at(sq).color
    }, f"unexpected misses: {missed}"
    n_typed = 0
    for sq in range(64):
        p = start.piece_at(sq)
        if p is None or not occ[sq]:
            continue
        assert chars[sq] == p.symbol(), (sq, chars[sq], p.symbol())
        n_typed += 1
    assert n_typed >= 24  # the full black side + most of white
    # knight squares specifically were typed, not '?'-degraded: g1 (the
    # detected white knight) and both black knights
    for sq, want in ((6, "N"), (57, "n"), (62, "n")):
        assert occ[sq] and chars[sq] == want, (sq, chars[sq])
