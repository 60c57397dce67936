"""Otsu thresholding matching cv2.threshold(THRESH_BINARY + THRESH_OTSU).

Used by the reference's prepare_analysis stage (frame_enhancer.py:148-159).
OpenCV scans thresholds t=0..255 maximizing between-class variance and keeps
the FIRST maximum (strict '>' comparison) — reproduced here exactly; the
binary image is (x > t) * 255.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def otsu_threshold(x: jnp.ndarray) -> jnp.ndarray:
    """Return the Otsu threshold (float32 scalar) of a u8 image."""
    # one-hot compare+reduce histogram (one fused reduction)
    flat = x.reshape(-1).astype(jnp.int32)
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, 256), 1)
    hist_i = jnp.sum((flat[:, None] == bins).astype(jnp.int32), axis=0)
    # Moments with exact integer accumulation (cv2 accumulates in double;
    # a plain f32 cumsum of hist*level drifts once the weighted sum passes
    # 2^24 — boards are ~0.4-1 Mpx, sums reach ~1e8). Counts fit i32
    # directly; the first moment splits level = 16*q + r so each i32
    # cumsum stays < 2^31, recombined in f32 (only the final conversion
    # rounds, at 2^-24 relative — below any realistic variance tie).
    levels_i = jnp.arange(256, dtype=jnp.int32)
    q1 = jnp.cumsum(hist_i).astype(jnp.float32)  # counts <= t, exact
    s_hi = jnp.cumsum(hist_i * (levels_i // 16)).astype(jnp.float32)
    s_lo = jnp.cumsum(hist_i * (levels_i % 16)).astype(jnp.float32)
    s1 = 16.0 * s_hi + s_lo
    n = q1[-1]
    total = s1[-1]
    q2 = n - q1
    m1 = s1 / jnp.maximum(q1, 1e-38)
    m2 = (total - s1) / jnp.maximum(q2, 1e-38)
    var = q1 * q2 * (m1 - m2) ** 2
    var = jnp.where((q1 == 0) | (q2 == 0), -1.0, var)
    # argmax returns the first maximum, matching OpenCV's '>' scan.
    return jnp.argmax(var).astype(jnp.float32)


def otsu_binarize(x: jnp.ndarray):
    """(threshold, binary) like cv2.threshold(x, 0, 255, BINARY+OTSU)."""
    t = otsu_threshold(x)
    binary = (x.astype(jnp.float32) > t).astype(jnp.uint8) * jnp.uint8(255)
    return t, binary
