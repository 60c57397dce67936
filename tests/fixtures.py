"""Synthetic board/square fixtures for parity tests.

make_square: one 77x77 chess-square-like image (optionally with a circular
piece, noise, off-center placement). make_board_frame: a full 1280x720
camera-like frame containing a perspective-projected board rendered from an
occupancy grid — lets the vision path be driven end-to-end without a camera.
"""

from __future__ import annotations

import cv2
import numpy as np

DEFAULT_CORNERS = np.array([[260, 80], [1020, 95], [240, 640], [1035, 655]])


def make_square(rng, radius=None, contrast=80, noise=8, off=(0, 0), size=77, base=120, blur=True):
    img = np.full((size, size), float(base))
    if radius:
        yy, xx = np.mgrid[:size, :size]
        m = (yy - size // 2 - off[1]) ** 2 + (xx - size // 2 - off[0]) ** 2 <= radius**2
        img[m] += contrast
    img += rng.normal(0, noise, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if blur:
        img = cv2.GaussianBlur(img, (5, 5), 0)
    return img


def render_board_image(
    occupancy,
    rng=None,
    board_px=800,
    light=(181, 217, 240),
    dark=(99, 136, 181),
    white_piece=(235, 235, 245),
    black_piece=(40, 36, 30),
    noise=3.0,
    piece_colors=None,
    piece_radii=None,
):
    """Top-down BGR board image from an (8, 8) [file, rank] occupancy grid.

    Pieces are filled circles (the physical pieces the reference detects are
    round-based; README and piece_detector.py:1-10). Rank 8 is the top row.
    piece_radii: optional (8, 8) of per-square radius fractions (physical
    sets have per-type base diameters — reference piece_stats.txt).
    """
    occ = np.asarray(occupancy, dtype=bool).reshape(8, 8)
    sq = board_px // 8
    img = np.zeros((board_px, board_px, 3), np.float64)
    for row in range(8):  # row 0 = rank 8
        for col in range(8):
            color = light if (row + col) % 2 == 0 else dark
            img[row * sq : (row + 1) * sq, col * sq : (col + 1) * sq] = color
    for f in range(8):
        for r in range(8):
            if occ[f, r]:
                row, col = 7 - r, f
                cx = col * sq + sq // 2
                cy = row * sq + sq // 2
                if piece_colors is not None and piece_colors[f, r] is not None:
                    pc = piece_colors[f, r]
                else:
                    pc = white_piece if r <= 3 else black_piece
                frac = 0.36
                if piece_radii is not None and piece_radii[f, r]:
                    frac = float(piece_radii[f, r])
                cv2.circle(img, (cx, cy), int(sq * frac), pc, -1)
                cv2.circle(img, (cx, cy), int(sq * frac), (20, 20, 20), 2)
    if rng is not None and noise > 0:
        img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_board_frame(
    occupancy,
    rng=None,
    corners=DEFAULT_CORNERS,
    frame_size=(720, 1280),
    bg=60,
    **render_kw,
):
    """Project a rendered board into a 1280x720 'camera' frame at ``corners``.

    corners order: TL, TR, BL, BR (same convention as calibration clicks).
    """
    board = render_board_image(occupancy, rng=rng, **render_kw)
    bp = board.shape[0]
    src = np.float32([[0, 0], [bp, 0], [0, bp], [bp, bp]])
    dst = np.float32(np.asarray(corners, np.float64))
    M = cv2.getPerspectiveTransform(src, dst)
    frame = np.full((*frame_size, 3), bg, np.uint8)
    warped = cv2.warpPerspective(board, M, (frame_size[1], frame_size[0]))
    mask = (
        cv2.warpPerspective(np.full((bp, bp), 255, np.uint8), M, (frame_size[1], frame_size[0]))
        > 127
    )
    frame[mask] = warped[mask]
    if rng is not None:
        frame = np.clip(
            frame.astype(np.float64) + rng.normal(0, 2.0, frame.shape), 0, 255
        ).astype(np.uint8)
    return frame


def initial_occupancy():
    occ = np.zeros((8, 8), bool)
    occ[:, :2] = True
    occ[:, 6:] = True
    return occ


def render_board_image_hard(
    occupancy,
    rng,
    board_px=800,
    t=0.0,
    light=(150, 190, 215),
    dark=(70, 105, 150),
    white_piece=(228, 230, 238),
    black_piece=(48, 44, 38),
    piece_colors=None,
):
    """A 'hard' board render: photographic-texture stand-in for recorded
    footage (no camera in this environment). Adds the failure modes the
    decision boundary is calibrated against:

    - wood-grain square texture (two sine fields per square, random phase)
    - radially shaded pieces with per-frame center jitter (+-3 px) and
      radius jitter spanning 30-36% of the square (near the 20%/55% Hough
      band interior but off the clean fixture's fixed 36%)
    - a directional shadow ramp and a drifting specular glare blob,
      parameterized by ``t`` so clips can move light across frames
    - heavier sensor noise (sigma 4)
    """
    occ = np.asarray(occupancy, dtype=bool).reshape(8, 8)
    sq = board_px // 8
    yy, xx = np.mgrid[:board_px, :board_px]
    img = np.zeros((board_px, board_px, 3), np.float64)

    gy, gx = np.mgrid[:sq, :sq]
    for row in range(8):
        for col in range(8):
            base = np.array(light if (row + col) % 2 == 0 else dark, float)
            phase = rng.uniform(0, 2 * np.pi) if rng is not None else 1.0
            grain = 6.0 * np.sin(gx / 3.5 + phase) + 4.0 * np.sin(
                (gx + 2 * gy) / 9.0 + 1.7 * phase
            )
            img[row * sq : (row + 1) * sq, col * sq : (col + 1) * sq] = (
                base[None, None, :] + grain[..., None]
            )

    for f in range(8):
        for r in range(8):
            if not occ[f, r]:
                continue
            row, col = 7 - r, f
            if rng is not None:
                jx, jy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
                rad = int(sq * (0.30 + 0.06 * rng.random()))
            else:
                jx = jy = 0
                rad = int(sq * 0.33)
            cx = col * sq + sq // 2 + jx
            cy = row * sq + sq // 2 + jy
            if piece_colors is not None and piece_colors[f, r] is not None:
                pc = piece_colors[f, r]
            else:
                pc = white_piece if r <= 3 else black_piece
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            m = d2 <= rad * rad
            shade = 1.0 - 0.25 * np.sqrt(np.clip(d2, 0, rad * rad)) / max(rad, 1)
            img[m] = np.asarray(pc, float) * shade[m][:, None]
            cv2.circle(img, (cx, cy), rad, (25, 25, 25), 2, lineType=cv2.LINE_AA)

    ang = 0.4 + 0.2 * t
    ramp = 0.78 + 0.22 * (
        (xx * np.cos(ang) + yy * np.sin(ang)) / (board_px * 1.5) + 0.5
    )
    img *= np.clip(ramp, 0.0, 1.05)[..., None]
    gx0 = board_px * (0.30 + 0.25 * np.sin(t))
    gy0 = board_px * (0.35 + 0.20 * np.cos(0.7 * t))
    sigma = board_px / 7.0
    glare = 55.0 * np.exp(-((xx - gx0) ** 2 + (yy - gy0) ** 2) / (2 * sigma * sigma))
    img += glare[..., None]
    if rng is not None:
        img += rng.normal(0, 4.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_hard_board_frame(
    occupancy, rng, corners=DEFAULT_CORNERS, frame_size=(720, 1280), bg=60, t=0.0, **kw
):
    """make_board_frame with the hard renderer (see render_board_image_hard)."""
    board = render_board_image_hard(occupancy, rng, t=t, **kw)
    bp = board.shape[0]
    src = np.float32([[0, 0], [bp, 0], [0, bp], [bp, bp]])
    dst = np.float32(np.asarray(corners, np.float64))
    M = cv2.getPerspectiveTransform(src, dst)
    frame = np.full((*frame_size, 3), bg, np.uint8)
    warped = cv2.warpPerspective(board, M, (frame_size[1], frame_size[0]))
    mask = (
        cv2.warpPerspective(np.full((bp, bp), 255, np.uint8), M, (frame_size[1], frame_size[0]))
        > 127
    )
    frame[mask] = warped[mask]
    if rng is not None:
        frame = np.clip(
            frame.astype(np.float64) + rng.normal(0, 2.0, frame.shape), 0, 255
        ).astype(np.uint8)
    return frame


# -- camera realism (round-3 verdict item 6) --------------------------------


def add_hand_sprite(frame, rng=None, center=(620, 380), angle=1.9, scale=1.6):
    """Composite a textured hand + forearm with a soft drop shadow.

    Replaces the flat gray rectangle the round-2 clips used for occlusion:
    a palm ellipse, five finger capsules and a forearm, skin-tone shaded
    with a lighting gradient and sensor noise, plus an offset blurred
    shadow that darkens the board around the silhouette (the part a flat
    rectangle cannot exercise: soft partial-square darkening around the
    occluder). Mutates and returns ``frame``.
    """
    h, w = frame.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    mask = np.zeros((h, w), np.uint8)
    L = int(260 * scale)
    x2 = int(cx + L * np.cos(angle))
    y2 = int(cy + L * np.sin(angle))
    cv2.line(mask, (cx, cy), (x2, y2), 255, int(58 * scale))
    cv2.ellipse(
        mask, (cx, cy), (int(46 * scale), int(58 * scale)),
        np.degrees(angle), 0, 360, 255, -1,
    )
    for i, fa in enumerate(np.linspace(-0.55, 0.55, 5)):
        fl = int((100 - 16 * abs(i - 2)) * scale)
        fx = int(cx + fl * np.cos(angle + np.pi + fa))
        fy = int(cy + fl * np.sin(angle + np.pi + fa))
        cv2.line(mask, (cx, cy), (fx, fy), 255, int(15 * scale))
    mask = cv2.GaussianBlur(mask, (9, 9), 0)

    # soft drop shadow, offset toward the light's opposite side
    sh = np.roll(mask, (26, 18), axis=(0, 1)).astype(np.float32) / 255.0
    sh = cv2.GaussianBlur(sh, (31, 31), 0)
    frame[:] = np.clip(
        frame.astype(np.float32) * (1.0 - 0.45 * sh[..., None]), 0, 255
    ).astype(np.uint8)

    hard = mask > 110
    yy, xx = np.mgrid[:h, :w]
    shade = 1.0 - 0.25 * np.clip((yy - cy) / (1.5 * L), -0.8, 0.8)
    skin = np.empty((h, w, 3), np.float32)
    skin[..., 0] = 118.0  # B
    skin[..., 1] = 146.0  # G
    skin[..., 2] = 198.0  # R
    skin *= shade[..., None]
    if rng is not None:
        skin += rng.normal(0, 5.0, skin.shape)
    frame[hard] = np.clip(skin[hard], 0, 255).astype(np.uint8)
    return frame


def apply_barrel(frame, k1=0.04):
    """Mild radial (barrel) lens distortion of a rendered frame.

    dst pixel p_d samples src at c + (p_d - c) * (1 + k1 * (r/rn)^2) with
    rn the half-diagonal, so straight board edges bow outward slightly —
    the homography-only geometry then samples a few px off near the board
    rim, which is exactly the error a real lens adds.
    """
    h, w = frame.shape[:2]
    cx, cy = w / 2.0, h / 2.0
    rn = float(np.hypot(cx, cy))
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    dx = (xx - cx) / rn
    dy = (yy - cy) / rn
    f = 1.0 + k1 * (dx * dx + dy * dy)
    mapx = (cx + dx * f * rn).astype(np.float32)
    mapy = (cy + dy * f * rn).astype(np.float32)
    return cv2.remap(frame, mapx, mapy, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)


def barrel_point(p, k1=0.04, frame_size=(720, 1280)):
    """Where source point ``p`` lands in the apply_barrel output — used to
    fold the distortion into the calibration corners (the rig is
    calibrated on the distorted image, like a real camera)."""
    h, w = frame_size
    cx, cy = w / 2.0, h / 2.0
    rn = float(np.hypot(cx, cy))
    vx, vy = (p[0] - cx) / rn, (p[1] - cy) / rn
    rs = float(np.hypot(vx, vy))
    if rs == 0.0:
        return (cx, cy)
    rd = rs
    for _ in range(8):  # invert rd*(1+k1*rd^2) = rs (Newton)
        rd -= (rd * (1.0 + k1 * rd * rd) - rs) / (1.0 + 3.0 * k1 * rd * rd)
    s = rd / rs
    return (cx + vx * s * rn, cy + vy * s * rn)


def apply_motion_blur(frame, length=5, angle=0.3):
    """Slight directional (camera shake) blur via a normalized line PSF."""
    k = np.zeros((length, length), np.float32)
    c = (length - 1) / 2.0
    for t in np.linspace(-c, c, 4 * length):
        x = int(round(c + t * np.cos(angle)))
        y = int(round(c + t * np.sin(angle)))
        if 0 <= x < length and 0 <= y < length:
            k[y, x] += 1.0
    k /= k.sum()
    return cv2.filter2D(frame, -1, k)


# Per-type base radii (fraction of a square): a typical Staunton spread —
# distinct enough for the radius classifier, inside the detector's
# 20%-55% Hough band (reference piece_stats.txt measured 23-35 px radii
# at 77 px squares = 0.30-0.45).
PIECE_RADIUS_FRAC = {
    "p": 0.22, "n": 0.27, "b": 0.32, "r": 0.37, "q": 0.43, "k": 0.50,
}


def board_render_maps(board):
    """(occ, colors, radii) (8, 8) render maps from a rules Board: true
    piece colors and per-type base radii."""
    from chessboard_vision.rules import chess

    occ = np.zeros((8, 8), bool)
    colors = np.empty((8, 8), object)
    colors[:] = None
    radii = np.zeros((8, 8), np.float64)
    for sq in range(64):
        piece = board.piece_at(sq)
        if piece is None:
            continue
        f, r = chess.square_file(sq), chess.square_rank(sq)
        occ[f, r] = True
        colors[f, r] = (235, 235, 245) if piece.color else (40, 36, 30)
        radii[f, r] = PIECE_RADIUS_FRAC[piece.symbol().lower()]
    return occ, colors, radii
