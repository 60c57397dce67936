"""Stateful piece-detector model: delta cache + temporal smoothing.

Device-state equivalent of reference piece_detector.py detect_all_pieces
(:348-440): per-square visual-delta gating, raw-result caching, 5-frame
presence smoothing, and reference updates only when the raw detection
agrees with the stable one. The per-square Python dicts become (64, ...)
tensors; the whole update is one jitted call.

On device the delta gate no longer skips compute (all 64 squares are detected
every call — uniform batched work is cheaper than divergence), but the
*state semantics* (which result is reported, when caches/references
update) are reproduced exactly, so outputs match the reference
per-frame, including its smart-scan behavior.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops import piece as piece_ops

HISTORY = 5
MIN_PRESENCE = 0.6
CHANGE_THRESHOLD = 25  # mean-abs-diff gate (piece_detector.py:50)


class PieceState(NamedTuple):
    ref_gray: jnp.ndarray  # (64, H*W) u8 visual reference (preprocessed),
    #   stored FLAT: 2-D row-major has no layout-permutation freedom, so
    #   the donated scan carry never pays a relayout copy against the
    #   update select (the change model's means/variances got the same
    #   treatment). Legacy
    #   3-D checkpoints reshape on load (utils/checkpoint.py).
    has_ref: jnp.ndarray  # (64,) bool
    cache_has: jnp.ndarray  # (64,) bool raw cached result
    cache_method: jnp.ndarray  # (64,) i32
    cache_conf: jnp.ndarray  # (64,) f32
    cache_cx: jnp.ndarray  # (64,) f32
    cache_cy: jnp.ndarray  # (64,) f32
    cache_radius: jnp.ndarray  # (64,) i32
    has_cache: jnp.ndarray  # (64,) bool
    hist: jnp.ndarray  # (64, HISTORY) i32 sliding window of raw has_piece
    hist_len: jnp.ndarray  # (64,) i32


def init_state(shape=(64, 77, 77)) -> PieceState:
    n = shape[0]
    p = 1
    for d in shape[1:]:
        p *= int(d)
    return PieceState(
        ref_gray=jnp.zeros((n, p), jnp.uint8),
        has_ref=jnp.zeros((n,), bool),
        cache_has=jnp.zeros((n,), bool),
        cache_method=jnp.zeros((n,), jnp.int32),
        cache_conf=jnp.zeros((n,), jnp.float32),
        cache_cx=jnp.zeros((n,), jnp.float32),
        cache_cy=jnp.zeros((n,), jnp.float32),
        cache_radius=jnp.zeros((n,), jnp.int32),
        has_cache=jnp.zeros((n,), bool),
        hist=jnp.zeros((n, HISTORY), jnp.int32),
        hist_len=jnp.zeros((n,), jnp.int32),
    )


class DetectAllOutputs(NamedTuple):
    has_piece: jnp.ndarray  # (64,) bool — smoothed (reported) occupancy
    raw_has_piece: jnp.ndarray  # (64,) bool — this frame's raw/cached result
    visual_changes: jnp.ndarray  # (64,) bool — delta vs visual reference
    method: jnp.ndarray  # (64,) i32
    confidence: jnp.ndarray  # (64,) f32
    center_x: jnp.ndarray  # (64,) f32
    center_y: jnp.ndarray  # (64,) f32
    radius: jnp.ndarray  # (64,) i32
    center_mean: jnp.ndarray  # (64,) f32 — THIS frame's center-disk mean
    border_mean: jnp.ndarray  # (64,) f32 — THIS frame's corner-patch mean
    #   (always fresh, never cached: they feed the piece-color classifier
    #   which must see the current image)
    extent: jnp.ndarray  # (64,) f32 — THIS frame's ring-coverage size
    #   profile (ops/piece.py). Always fresh like the means: it is an
    #   intensity feature of the current image, consumed averaged over the
    #   session's stability window (where the square is static anyway), so
    #   caching it would add a PieceState leaf for nothing — and keeping
    #   the state pytree unchanged keeps old checkpoints loadable.


def _mean_diff_exceeds(gray_flat, ref_flat, counts, valid_flat, threshold):
    """mean(|gray - ref|) > threshold with integer-exact comparison
    (flat (.., P) operands; the sum is order-exact integers, so the flat
    form is bit-equal to the old 3-D one)."""
    d = jnp.abs(gray_flat.astype(jnp.int32) - ref_flat.astype(jnp.int32))
    s = jnp.sum(d * valid_flat, axis=-1)
    return s > threshold * counts


def _push_history(hist, hist_len, value):
    """Sliding window append (list append + pop(0) at size HISTORY)."""
    full = hist_len >= HISTORY
    shifted = jnp.roll(hist, -1, axis=-1).at[:, -1].set(value)
    appended = hist.at[jnp.arange(hist.shape[0]), jnp.minimum(hist_len, HISTORY - 1)].set(
        jnp.where(full, hist[:, -1], value)
    )
    new_hist = jnp.where(full[:, None], shifted, appended)
    new_len = jnp.minimum(hist_len + 1, HISTORY)
    return new_hist, new_len


def _stable_detection(hist, hist_len):
    """<3 frames: last value; else presence >= 60% (piece_detector.py:111-122)."""
    idx = jnp.maximum(hist_len - 1, 0)
    last = jnp.take_along_axis(hist, idx[:, None], axis=-1)[:, 0] > 0
    pos = jax.lax.broadcasted_iota(jnp.int32, hist.shape, 1)
    valid = pos < hist_len[:, None]
    presence = jnp.sum(hist * valid, axis=-1).astype(jnp.float32) / jnp.maximum(
        hist_len, 1
    ).astype(jnp.float32)
    return jnp.where(hist_len < 3, last, presence >= MIN_PRESENCE)


@partial(
    jax.jit,
    static_argnames=(
        "bounds", "use_smoothing", "use_delta", "hough_backend", "conv_dims",
        "hough_param1", "hough_param2", "center_diff_threshold",
    ),
)
def detect_all(
    state: PieceState,
    gray: jnp.ndarray,
    masks: piece_ops.PieceMasks,
    params: hough_ops.HoughParams,
    bounds: hough_ops.HoughBounds,
    s2c_mask: jnp.ndarray,  # (64,) bool
    s2c_given: jnp.ndarray,  # () bool — whether squares_to_check was provided
    use_smoothing: bool = True,
    use_delta: bool = True,
    hough_backend: str = "exact",
    conv_plan=None,
    conv_dims=None,
    hough_param1: int = 100,
    hough_param2: int = 25,
    center_diff_threshold: float = 40.0,
    gray_flat: Optional[jnp.ndarray] = None,
) -> Tuple[PieceState, DetectAllOutputs]:
    """One detect_all_pieces step. gray: (64, H, W) u8 preprocessed squares.

    gray_flat: optional pre-flattened (64, H*W) view of the SAME gray —
    the pipeline passes the flatten it already materializes for the
    change model so the flat ref compare/update shares it (a second
    in-step flatten would re-tile it every frame)."""
    if gray_flat is None:
        gray_flat = gray.reshape(gray.shape[0], -1)
    changed = _mean_diff_exceeds(
        gray_flat, state.ref_gray, masks.counts, masks.valid_flat,
        CHANGE_THRESHOLD,
    ) | ~state.has_ref
    visual_changes = changed

    forced = s2c_given & s2c_mask
    delta_path = (~s2c_given) | use_delta
    should = forced | (~forced & delta_path & (~state.has_cache | changed))
    use_fresh = should | ~state.has_cache

    fresh = piece_ops.detect_pieces(
        gray, masks, params, bounds,
        hough_backend=hough_backend, conv_plan=conv_plan, conv_dims=conv_dims,
        hough_param1=hough_param1, hough_param2=hough_param2,
        center_diff_threshold=center_diff_threshold,
    )

    raw_has = jnp.where(use_fresh, fresh.has_piece, state.cache_has)
    raw_method = jnp.where(use_fresh, fresh.method, state.cache_method)
    raw_conf = jnp.where(use_fresh, fresh.confidence, state.cache_conf)
    raw_cx = jnp.where(use_fresh, fresh.center_x, state.cache_cx)
    raw_cy = jnp.where(use_fresh, fresh.center_y, state.cache_cy)
    raw_radius = jnp.where(use_fresh, fresh.radius, state.cache_radius)

    hist, hist_len = _push_history(state.hist, state.hist_len, raw_has.astype(jnp.int32))

    if use_smoothing:
        stable = _stable_detection(hist, hist_len)
        reported = stable
        is_stable_update = raw_has == stable
    else:
        reported = raw_has
        is_stable_update = jnp.ones_like(raw_has)

    ref_update = should & is_stable_update
    new_state = PieceState(
        ref_gray=jnp.where(ref_update[:, None], gray_flat, state.ref_gray),
        has_ref=state.has_ref | ref_update,
        cache_has=raw_has,
        cache_method=raw_method,
        cache_conf=raw_conf,
        cache_cx=raw_cx,
        cache_cy=raw_cy,
        cache_radius=raw_radius,
        has_cache=state.has_cache | use_fresh,
        hist=hist,
        hist_len=hist_len,
    )
    outputs = DetectAllOutputs(
        has_piece=reported,
        raw_has_piece=raw_has,
        visual_changes=visual_changes,
        method=raw_method,
        confidence=raw_conf,
        center_x=raw_cx,
        center_y=raw_cy,
        radius=raw_radius,
        center_mean=fresh.center_mean,
        border_mean=fresh.border_mean,
        extent=fresh.extent,
    )
    return new_state, outputs


def _flat(gray: jnp.ndarray) -> jnp.ndarray:
    """(64, H, W) or already-flat (64, P) gray -> (64, P)."""
    return gray if gray.ndim == 2 else gray.reshape(gray.shape[0], -1)


def update_references(state: PieceState, gray: jnp.ndarray) -> PieceState:
    """Force-refresh all visual references and clear the result cache
    (reference update_references, piece_detector.py:447-453)."""
    return state._replace(
        ref_gray=_flat(gray),
        has_ref=jnp.ones_like(state.has_ref),
        has_cache=jnp.zeros_like(state.has_cache),
    )


class PieceDetectorModel:
    """Host-facing wrapper: dict-of-squares API over the device state.

    Mirrors the reference PieceDetector surface for drop-in use by host
    code and tests; the hot path uses the functional `detect_all` directly.
    """

    def __init__(self, heights, widths, settings: Optional[dict] = None):
        heights = np.asarray(heights)
        widths = np.asarray(widths)
        min_ratio, max_ratio = 0.20, 0.55
        if settings:
            if "min_radius" in settings:
                min_ratio = settings["min_radius"] / 100.0
            if "max_radius" in settings:
                max_ratio = settings["max_radius"] / 100.0
        self.masks = piece_ops.PieceMasks.build(
            heights, widths, int(heights.max()), int(widths.max())
        )
        self.params, self.bounds = hough_ops.HoughParams.from_geometry(
            heights, widths, min_ratio=min_ratio, max_ratio=max_ratio
        )
        self.state = init_state((64, int(heights.max()), int(widths.max())))

    def detect_all_pieces(self, gray, squares_to_check=None, use_smoothing=True, use_delta=True):
        """gray: (64, H, W) u8 preprocessed squares (chess-index order)."""
        if squares_to_check is None:
            s2c_mask = jnp.zeros((64,), bool)
            s2c_given = jnp.asarray(False)
        else:
            from chessboard_vision.ops.layout import positions_to_mask

            s2c_mask = jnp.asarray(positions_to_mask(squares_to_check))
            s2c_given = jnp.asarray(True)
        self.state, out = detect_all(
            self.state,
            jnp.asarray(gray),
            self.masks,
            self.params,
            self.bounds,
            s2c_mask,
            s2c_given,
            use_smoothing=use_smoothing,
            use_delta=use_delta,
        )
        return out

    def update_references(self, gray):
        self.state = update_references(self.state, jnp.asarray(gray))

    def calibrate_reference(self, gray):
        """Set references AND prime the result cache from a fresh detection
        (reference calibrate_reference, piece_detector.py:70-80)."""
        gray = jnp.asarray(gray)
        fresh = piece_ops.detect_pieces(gray, self.masks, self.params, self.bounds)
        self.state = self.state._replace(
            ref_gray=_flat(gray),
            has_ref=jnp.ones_like(self.state.has_ref),
            cache_has=fresh.has_piece,
            cache_method=fresh.method,
            cache_conf=fresh.confidence,
            cache_cx=fresh.center_x,
            cache_cy=fresh.center_y,
            cache_radius=fresh.radius,
            has_cache=jnp.ones_like(self.state.has_cache),
        )

    def get_occupied_squares(self, gray, use_smoothing=True):
        """Set of occupied (file, rank) tuples (piece_detector.py:442-445)."""
        out = self.detect_all_pieces(gray, use_smoothing=use_smoothing)
        import numpy as _np

        has = _np.asarray(out.has_piece)
        return {(sq % 8, sq // 8) for sq in range(64) if has[sq]}
