"""Batched per-square piece-presence cascade.

Device equivalent of reference piece_detector.py detect_piece
(:272-345): uniformity prefilter (std < 15), unified Hough circle search,
center-vs-corner intensity difference (>40), radial ring-variance symmetry
(>0.6) — evaluated for all 64 squares in one fused batch; the sequential
cascade becomes masked selects. Geometry-dependent masks (center disk,
corner patches, rings) are precomputed host-side per square from the grid
(variable sizes supported via validity masks).

Method codes (cascade order preserved): 0 none, 1 hough, 2 tower_top,
3 center_diff, 4 symmetry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops import hough_conv as hough_conv_ops

METHOD_NONE, METHOD_HOUGH, METHOD_TOWER_TOP, METHOD_CENTER_DIFF, METHOD_SYMMETRY = range(5)
METHOD_NAMES = [None, "hough", "tower_top", "center_diff", "symmetry"]


class PieceMasks(NamedTuple):
    """Per-square constant masks/denominators for the non-Hough methods."""

    valid: jnp.ndarray  # (64, H, W) bool interior mask
    counts: jnp.ndarray  # (64,) i32
    center_disk: jnp.ndarray  # (64, H, W) bool
    center_counts: jnp.ndarray  # (64,) i32
    corners: jnp.ndarray  # (64, H, W) bool
    corner_counts: jnp.ndarray  # (64,) i32
    rings: jnp.ndarray  # (64, 4, H, W) bool
    ring_counts: jnp.ndarray  # (64, 4) i32
    heights: jnp.ndarray  # (64,) i32
    widths: jnp.ndarray  # (64,) i32
    valid_flat: jnp.ndarray  # (64, H*W) bool — pre-flattened `valid` for
    #   the flat-state visual-reference compare (consts are jit args: an
    #   in-step flatten of a constant re-tiles it every frame)

    @classmethod
    def build(cls, heights, widths, pad_h: int, pad_w: int) -> "PieceMasks":
        """Host-side construction. (pad_h, pad_w) are the tensor dims H, W."""
        heights = np.asarray(heights, np.int64)
        widths = np.asarray(widths, np.int64)
        H, W = pad_h, pad_w
        yy, xx = np.mgrid[:H, :W]
        valid = np.zeros((64, H, W), bool)
        center = np.zeros((64, H, W), bool)
        corners = np.zeros((64, H, W), bool)
        rings = np.zeros((64, 4, H, W), bool)
        for s in range(64):
            h, w = int(heights[s]), int(widths[s])
            md = min(h, w)
            cy, cx = h // 2, w // 2
            v = (yy < h) & (xx < w)
            valid[s] = v
            radius = md // 4
            center[s] = (((xx - cx) ** 2 + (yy - cy) ** 2) <= radius * radius) & v
            cs = md // 4
            cm = np.zeros((H, W), bool)
            cm[:cs, :cs] = cm[:cs, w - cs : w] = True
            cm[h - cs : h, :cs] = cm[h - cs : h, w - cs : w] = True
            corners[s] = cm & v
            dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            for k, ratio in enumerate((0.15, 0.25, 0.35, 0.45)):
                r = md * ratio
                rings[s, k] = (dist >= r - 5) & (dist <= r + 5) & v
        return cls(
            valid=jnp.asarray(valid),
            counts=jnp.asarray(valid.sum((1, 2)).astype(np.int32)),
            center_disk=jnp.asarray(center),
            center_counts=jnp.asarray(center.sum((1, 2)).astype(np.int32)),
            corners=jnp.asarray(corners),
            corner_counts=jnp.asarray(corners.sum((1, 2)).astype(np.int32)),
            rings=jnp.asarray(rings),
            ring_counts=jnp.asarray(rings.sum((2, 3)).astype(np.int32)),
            heights=jnp.asarray(heights.astype(np.int32)),
            widths=jnp.asarray(widths.astype(np.int32)),
            valid_flat=jnp.asarray(valid.reshape(64, -1)),
        )


class PieceDetections(NamedTuple):
    has_piece: jnp.ndarray  # (64,) bool
    method: jnp.ndarray  # (64,) i32 code
    confidence: jnp.ndarray  # (64,) f32
    center_x: jnp.ndarray  # (64,) f32
    center_y: jnp.ndarray  # (64,) f32
    radius: jnp.ndarray  # (64,) i32
    std: jnp.ndarray  # (64,) f32
    center_border_diff: jnp.ndarray  # (64,) f32
    symmetry: jnp.ndarray  # (64,) f32
    center_mean: jnp.ndarray  # (64,) f32 — mean gray over the center disk
    border_mean: jnp.ndarray  # (64,) f32 — mean gray over the corner
    #   patches (warp_ops.masked_mean; the pipeline reuses them for
    #   StepOutputs' piece-color features instead of re-stating the
    #   reductions).
    extent: jnp.ndarray  # (64,) f32 — ring-coverage piece-size profile
    #   in [0, 4] (-1 = invalid/low-contrast); see the comment at its
    #   computation. Feeds the piece-TYPE classifier
    #   (rules/piece_types.py) as a sub-pixel size feature that does not
    #   need the Hough stage to have resolved a circle.


# Shared with the pipeline's StepOutputs color features: detect_pieces
# returns its center/border means and the pipeline reuses them — one
# statement of each reduction, no duplicate pass over gray.
from chessboard_vision.ops.warp import masked_mean as _masked_mean  # noqa: E402


def detect_pieces(
    gray: jnp.ndarray,
    masks: PieceMasks,
    hough_params: hough_ops.HoughParams,
    hough_bounds: hough_ops.HoughBounds,
    std_threshold: float = 15.0,
    center_diff_threshold: float = 40.0,
    circle_threshold: float = 0.6,
    hough_param1: int = 100,
    hough_param2: int = 25,
    hough_backend: str = "exact",
    conv_plan: hough_conv_ops.ConvHoughPlan = None,
    conv_dims: hough_conv_ops.ConvHoughDims = None,
) -> PieceDetections:
    """Raw per-square cascade on preprocessed (blurred gray) squares.

    gray: (64, H, W) u8 — the _preprocess output (bgr2gray + gaussian 5x5).
    hough_backend: 'exact' = the cv2-faithful voting transform (scatter
    votes + the Canny fixpoint); 'conv' = the annular-correlation
    matmul detector (ops/hough_conv.py), decision-calibrated.
    """
    gf = gray.astype(jnp.float32)
    v = masks.valid
    n = masks.counts.astype(jnp.float32)

    # Separate reductions, deliberately: fusing all seven pass-1 masked
    # sums (valid/center/corner/4 rings) into one variadic lax.reduce
    # sped up this stage but perturbed the surrounding canny fusions by
    # more, so XLA is left to group the separate forms.

    # Uniformity prefilter: population std over the valid crop.
    mu = jnp.sum(gf * v, axis=(-2, -1)) / n
    d2 = jnp.where(v, (gf - mu[:, None, None]) ** 2, 0.0)
    std = jnp.sqrt(jnp.sum(d2, axis=(-2, -1)) / n)
    std_ok = std >= std_threshold

    # Method 1: Hough circles (unified large/small).
    if hough_backend == "conv":
        cc = hough_conv_ops.find_circle(
            gray, conv_plan, conv_dims,
            param1=hough_param1, param2=hough_param2,
        )
        min_dim_f = jnp.minimum(masks.heights, masks.widths).astype(jnp.float32)
        h_found, h_cx, h_cy, h_r = cc.found, cc.cx, cc.cy, cc.radius
        h_small = h_r.astype(jnp.float32) < min_dim_f * 0.20
    else:
        circles = hough_ops.hough_circles(
            gray, hough_params, hough_bounds, param1=hough_param1, param2=hough_param2
        )
        h_found, h_cx, h_cy, h_r, h_small = hough_ops.best_circle_near_center(
            circles, masks.heights, masks.widths
        )

    # Method 2: center vs corner-border intensity difference.
    center_mean = _masked_mean(gf, masks.center_disk, masks.center_counts)
    border_mean = _masked_mean(gf, masks.corners, masks.corner_counts)
    cb_diff = jnp.abs(center_mean - border_mean)
    cb_found = cb_diff > center_diff_threshold

    # Method 3: radial ring-variance symmetry.
    ring_means = jnp.sum(
        gf[:, None] * masks.rings, axis=(-2, -1)
    ) / jnp.maximum(masks.ring_counts.astype(jnp.float32), 1.0)  # (64, 4)
    rmu = jnp.mean(ring_means, axis=-1)
    ring_var = jnp.mean((ring_means - rmu[:, None]) ** 2, axis=-1)
    symmetry = jnp.minimum(1.0, ring_var / 500.0)
    sym_found = symmetry > circle_threshold

    # Piece-size profile extent (piece-TYPE feature, rules/piece_types.py):
    # per ring, the fraction of pixels CLOSER to the piece intensity
    # (center_mean) than to the background (border_mean) — which reduces
    # to one compare against the midpoint, in the direction of the
    # contrast sign. Summed over the 4 rings this is a MONOTONE sub-pixel
    # size readout in [0, 4], available every frame and independent of
    # whether the Hough stage resolved a circle (center_diff/symmetry
    # squares carry only the min_dim//3 fallback radius below). The
    # binary vote — unlike a linear (ring-border)/(center-border) mix —
    # is robust to third intensities (the dark rim real pieces and the
    # fixtures both have) and to low-contrast pairings (light piece on a
    # light square), which otherwise skew the readout by the SQUARE's
    # color: a one-class-off bias on half the board (measured on the
    # start position). Low-contrast squares (|center - border| < 8,
    # typically empty) report -1 so hosts can filter.
    denom = center_mean - border_mean
    mid = 0.5 * (center_mean + border_mean)
    piece_side = jnp.where(
        (denom >= 0.0)[:, None, None],
        gf > mid[:, None, None],
        gf < mid[:, None, None],
    )
    ring_cov = jnp.sum(
        piece_side[:, None] * masks.rings, axis=(-2, -1)
    ) / jnp.maximum(masks.ring_counts.astype(jnp.float32), 1.0)
    extent = jnp.where(
        jnp.abs(denom) >= 8.0,
        jnp.sum(ring_cov, axis=-1),
        -1.0,
    ).astype(jnp.float32)

    # Cascade combine.
    has = std_ok & (h_found | cb_found | sym_found)
    method = jnp.where(
        ~std_ok,
        METHOD_NONE,
        jnp.where(
            h_found,
            jnp.where(h_small, METHOD_TOWER_TOP, METHOD_HOUGH),
            jnp.where(
                cb_found, METHOD_CENTER_DIFF, jnp.where(sym_found, METHOD_SYMMETRY, METHOD_NONE)
            ),
        ),
    ).astype(jnp.int32)

    conf = jnp.where(
        method == METHOD_HOUGH,
        0.9,
        jnp.where(
            method == METHOD_TOWER_TOP,
            0.75,
            jnp.where(
                method == METHOD_CENTER_DIFF,
                jnp.minimum(1.0, cb_diff / 80.0),
                jnp.where(method == METHOD_SYMMETRY, symmetry, 0.0),
            ),
        ),
    ).astype(jnp.float32)

    min_dim = jnp.minimum(masks.heights, masks.widths)
    fallback_cx = (masks.widths // 2).astype(jnp.float32)
    fallback_cy = (masks.heights // 2).astype(jnp.float32)
    use_hough = (method == METHOD_HOUGH) | (method == METHOD_TOWER_TOP)
    cx = jnp.where(use_hough, h_cx, fallback_cx)
    cy = jnp.where(use_hough, h_cy, fallback_cy)
    radius = jnp.where(use_hough, h_r, (min_dim // 3)).astype(jnp.int32)

    return PieceDetections(
        has_piece=has,
        method=method,
        confidence=conf,
        center_x=cx,
        center_y=cy,
        radius=radius,
        std=std,
        center_border_diff=cb_diff,
        symmetry=symmetry,
        center_mean=center_mean,
        border_mean=border_mean,
        extent=extent,
    )
