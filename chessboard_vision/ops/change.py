"""Batched per-square change detection (EMA background model + z-scores).

Device equivalent of the reference's per-square running-Gaussian model
(change_detector.py:67-167 and its Cython twin): all 64 squares are one
(64, H, W) float32 tensor and a frame's full update/detect is a handful of
fused element-wise ops — no per-square Python loop.

Numerical parity: the reference stores means/variances as float32 and does
f32 arithmetic; these ops use the same dtype and operation order, so CPU
results are bit-identical and accelerator results match to f32 rounding.
Percent-changed threshold comparisons are done on integer counts
(count*100 vs threshold*total), which is exactly equivalent to the
reference's float comparison against 5/15/75 (see tests).

Intensity codes: 0 = below 5% (ignored), 1 = LEVE, 2 = PARCIAL, 3 = TOTAL.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

INTENSITY_NONE, INTENSITY_LEVE, INTENSITY_PARCIAL, INTENSITY_TOTAL = 0, 1, 2, 3
INTENSITY_NAMES = ["NONE", "LEVE", "PARCIAL", "TOTAL"]


class ChangeModelState(NamedTuple):
    """Background-model state carried through the pipeline pytree.

    means/variances are stored FLAT per square — (64, H*W), not
    (64, H, W). A 2-D (squares, pixels) tensor has one sensible layout
    (row-major), while for the 3-D form XLA may give the parameter a
    layout with the square axis second-minor ({2,0,1}) against the
    EMA-update fusion's row-major output, and the donated step carry then
    pays two relayout copies every step. Flat shapes make the layout
    unambiguous with no jit-level Format pinning (which the persistent
    compilation cache cannot tell apart)."""

    means: jnp.ndarray  # (64, P) f32, P = H*W
    variances: jnp.ndarray  # (64, P) f32
    calibrated: jnp.ndarray  # (64,) bool (per-square, so the
    #   stream-folded batched pipeline can merge the leading axes)


def flatten_pixels(x: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) -> (..., H*W); already-flat inputs pass through."""
    return x.reshape(x.shape[:-2] + (-1,)) if x.ndim >= 3 else x


def init_state(shape=(64, 77, 77)) -> ChangeModelState:
    n, p = shape[0], int(np.prod(shape[1:]))
    return ChangeModelState(
        means=jnp.zeros((n, p), jnp.float32),
        variances=jnp.zeros((n, p), jnp.float32),
        calibrated=jnp.zeros((n,), bool),
    )


def calibrate(gray: jnp.ndarray, initial_variance: float) -> ChangeModelState:
    """Initialize the model from preprocessed (blurred gray) squares.

    gray: (64, H, W) or (64, P) u8/f32 — the _preprocess output per square.
    """
    g = flatten_pixels(gray).astype(jnp.float32)
    return ChangeModelState(
        means=g,
        variances=jnp.full(g.shape, jnp.float32(initial_variance)),
        calibrated=jnp.ones((g.shape[0],), bool),
    )


def update_references(
    state: ChangeModelState,
    gray: jnp.ndarray,
    alpha: float,
    update_mask: jnp.ndarray,
) -> ChangeModelState:
    """EMA update of mean/variance on squares where update_mask is True.

    Matches reference update_all_references (change_detector.py:67-92):
    new_mean = (1-a)*m + a*x; new_var = max((1-a)*v + a*(x-new_mean)^2, 10).
    """
    a = jnp.float32(alpha)
    one_m_a = jnp.float32(1.0) - a
    g = flatten_pixels(gray).astype(jnp.float32)
    new_mean = one_m_a * state.means + a * g
    diff = g - new_mean
    new_var = jnp.maximum(one_m_a * state.variances + a * (diff * diff), jnp.float32(10.0))
    m = update_mask.reshape(-1, 1)
    return ChangeModelState(
        means=jnp.where(m, new_mean, state.means),
        variances=jnp.where(m, new_var, state.variances),
        calibrated=state.calibrated,
    )


class ChangeDetections(NamedTuple):
    z_peak: jnp.ndarray  # (64,) f32 peak z-score per square
    changed_counts: jnp.ndarray  # (64,) i32 pixels above z threshold
    pct_changed: jnp.ndarray  # (64,) f32
    intensity: jnp.ndarray  # (64,) i32 code (0..3)
    significant: jnp.ndarray  # (64,) bool  (pct >= 5%)


def detect(
    state: ChangeModelState,
    gray: jnp.ndarray,
    z_threshold: float,
    valid_mask: jnp.ndarray,
    counts: jnp.ndarray,
) -> ChangeDetections:
    """Z-score change detection over all squares at once.

    Matches reference detect_changes_detailed (change_detector.py:105-167):
    z = |x - mean| / sqrt(var); changed where z > threshold; intensity from
    percent-changed with integer-exact threshold comparisons.

    valid_mask: (64, H, W) or (64, P) bool interior mask (variable-size
    squares); counts: (64,) i32 true pixel counts.
    """
    g = flatten_pixels(gray).astype(jnp.float32)
    valid_mask = flatten_pixels(valid_mask)
    # Uncalibrated model (init_state zeros) -> no detections, like the
    # reference's "if not self.reference_images: return {}" guard
    # (change_detector.py:105-110); without it z = |g|/0 is inf/NaN and
    # every square reports a phantom TOTAL change.
    std = jnp.sqrt(jnp.maximum(state.variances, jnp.float32(1e-12)))
    z = jnp.where(
        state.calibrated[:, None], jnp.abs(g - state.means) / std, 0.0
    )
    changed = (z > jnp.float32(z_threshold)) & valid_mask
    # One variadic reduce computes the changed-count sum AND the z-peak max
    # in a single pass over z: as two separate jnp reductions, XLA emitted
    # two reduce fusions that each recomputed z from (g, means, variances)
    # — ~2x the memory traffic. Bit-equal by
    # construction: integer sum and max are order-exact and see the same
    # per-pixel z values either way.
    zm = jnp.where(valid_mask, z, -jnp.inf)
    ccount, z_peak = jax.lax.reduce(
        (changed.astype(jnp.int32), zm),
        (jnp.int32(0), jnp.float32(-jnp.inf)),
        lambda acc, x: (acc[0] + x[0], jnp.maximum(acc[1], x[1])),
        (z.ndim - 1,),
    )
    total = counts.astype(jnp.int32)
    pct = ccount.astype(jnp.float32) * 100.0 / total.astype(jnp.float32)

    # int32-exact: ccount, total <= H*W (~6e3), so 100x products stay tiny.
    c100 = ccount * 100
    significant = c100 >= 5 * total  # pct >= 5
    total_i = c100 > 75 * total  # pct > 75
    parcial = c100 > 15 * total  # pct > 15
    intensity = jnp.where(
        total_i,
        INTENSITY_TOTAL,
        jnp.where(parcial, INTENSITY_PARCIAL, INTENSITY_LEVE),
    )
    intensity = jnp.where(significant, intensity, INTENSITY_NONE).astype(jnp.int32)
    return ChangeDetections(
        z_peak=z_peak,
        changed_counts=ccount,
        pct_changed=pct,
        intensity=intensity,
        significant=significant,
    )


def classify_hand_pattern(intensity: jnp.ndarray, focus_mask: jnp.ndarray):
    """Hand-vs-move heuristic on the intensity codes (device version).

    Matches reference classify_hand_pattern (change_detector.py:169-201):
    >=2 TOTAL squares or >=4 changed squares (or >2) -> hand; exactly 2
    candidates -> move. focus_mask restricts which squares count.
    Returns (is_hand, is_move, candidate_mask).
    """
    active = (intensity > 0) & focus_mask
    n_active = jnp.sum(active)
    n_total = jnp.sum((intensity == INTENSITY_TOTAL) & focus_mask)
    is_hand = (n_total >= 2) | (n_active >= 4) | (n_active > 2)
    is_move = (~is_hand) & (n_active == 2)
    return is_hand, is_move, active
