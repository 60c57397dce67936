"""Canny edge detection on device, bit-exact vs cv2.Canny (L1, aperture 3).

Needed by the Hough circle stage (cv2.HoughCircles runs Canny internally
with thresholds (param1/2, param1) — reference piece_detector.py:232-241)
and by smart-grid refinement. Matches OpenCV exactly (verified on random
and structured images): Sobel-3 with replicate border, L1 magnitude,
direction-quantized NMS with OpenCV's exact >/>= tie rules (strict > on
both diagonal neighbors), and 8-connected hysteresis.

Hysteresis is a fixpoint loop of masked 3x3 dilations inside
``lax.while_loop`` — converges in O(longest weak chain) iterations.
The dilations run on BITPLANES: hysteresis is per-image-independent
boolean logic, so the (N, H, W) strong/weak batch packs into
ceil(N/32) uint32 planes and every masked dilation is | & on (H, W)
words carrying 32 images per lane element. The production 8-dilation
bounded chain's HBM traffic drops ~24x (each unpacked dilation was a
~2.9 MB bandwidth-bound fusion); results are
bit-identical by construction (per-bit | & == per-square | &).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from chessboard_vision.ops.filters import sobel3

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's fixed-point constant


def _shift2(x, dy, dx):
    """Shift a (..., H, W) array, filling vacated cells with zero/False.

    Pad + static slice (not roll + .at[].set, whose boundary zero-fills
    are dynamic-update-slices that need not fuse; the pad/slice form
    fuses into its consumer)."""
    h, w = x.shape[-2], x.shape[-1]
    pt, pb = max(dy, 0), max(-dy, 0)
    pl, pr = max(dx, 0), max(-dx, 0)
    pad = [(0, 0)] * (x.ndim - 2) + [(pt, pb), (pl, pr)]
    xp = jnp.pad(x, pad)
    return xp[..., pb : pb + h, pr : pr + w]


def _pack_bits(x: jnp.ndarray) -> jnp.ndarray:
    """(N, H, W) bool -> (ceil(N/32), H, W) uint32 bitplanes.

    Image s lives in bit s % 32 of plane s // 32; padding images are
    zero (never strong, never weak — inert under dilation). Bits are
    disjoint so the sum below is a bitwise OR."""
    n, h, w = x.shape
    k = -(-n // 32)
    xp = jnp.pad(x, ((0, k * 32 - n), (0, 0), (0, 0)))
    b = xp.astype(jnp.uint32).reshape(k, 32, h, w)
    sh = jnp.arange(32, dtype=jnp.uint32).reshape(1, 32, 1, 1)
    return jnp.sum(b << sh, axis=1, dtype=jnp.uint32)


def _unpack_bits(p: jnp.ndarray, n: int) -> jnp.ndarray:
    """(K, H, W) uint32 bitplanes -> (n, H, W) bool."""
    k, h, w = p.shape
    sh = jnp.arange(32, dtype=jnp.uint32).reshape(1, 32, 1, 1)
    bits = (p[:, None] >> sh) & jnp.uint32(1)
    return bits.reshape(k * 32, h, w)[:n].astype(bool)


def _dilate3(x: jnp.ndarray) -> jnp.ndarray:
    """8-connected dilation of a (..., H, W) bool map or uint32 bitplane
    stack (bitwise OR dilates all 32 packed images at once).

    Separable shifted-OR form (pad + static slices + ORs): pure elementwise
    ops that XLA fuses and that batch cleanly under vmap at any rank,
    including the >3-D shapes the vmapped multi-stream pipeline produces.
    """
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    xp = jnp.pad(x, pad)

    def sl(a, lo, size, axis):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(lo, lo + size)
        return a[tuple(idx)]

    v = sl(xp, 0, h, -2) | sl(xp, 1, h, -2) | sl(xp, 2, h, -2)  # (… H, W+2)
    return sl(v, 0, w, -1) | sl(v, 1, w, -1) | sl(v, 2, w, -1)  # (… H, W)


def canny(img: jnp.ndarray, low: int, high: int, max_iters: int = 256,
          hysteresis_rounds: int = -1):
    """cv2.Canny(img, low, high) for u8 (..., H, W) images -> bool edges.

    hysteresis_rounds: -1 runs the exact fixpoint (bit-exact vs cv2);
    k >= 0 unrolls exactly k propagation rounds of 4 dilations each with no
    while_loop/convergence check — weak pixels further than 4k steps from a
    strong pixel are dropped. The bounded variant is the conv backend's
    (fixed cost, no loop-carry overhead); decision impact on the circle
    detector is calibrated in tests/test_hough_conv.py.
    """
    dx, dy = sobel3(img)
    mag = jnp.abs(dx) + jnp.abs(dy)

    def nb(dy_, dx_):
        return _shift2(mag, -dy_, -dx_)  # value of neighbor at (+dy_, +dx_)

    c = mag
    ax = jnp.abs(dx)
    # int32 is ample: |dx|,|dy| <= 1020 for Sobel-3 on u8, so the largest
    # intermediate (ax << 16) is ~6.7e7 << 2^31.
    ay = jnp.abs(dy).astype(jnp.int32) << 15
    tg22x = ax.astype(jnp.int32) * _TG22
    tg67x = tg22x + (ax.astype(jnp.int32) << 16)
    horiz = ay < tg22x
    vert = (~horiz) & (ay > tg67x)
    s_pos = (dx ^ dy) >= 0  # gradient signs agree -> main diagonal

    keep_h = (c > nb(0, -1)) & (c >= nb(0, 1))
    keep_v = (c > nb(-1, 0)) & (c >= nb(1, 0))
    keep_d_pos = (c > nb(-1, -1)) & (c > nb(1, 1))
    keep_d_neg = (c > nb(-1, 1)) & (c > nb(1, -1))
    keep_d = jnp.where(s_pos, keep_d_pos, keep_d_neg)
    keep = jnp.where(horiz, keep_h, jnp.where(vert, keep_v, keep_d))

    cand = (c > low) & keep
    strong = cand & (c > high)
    weak = cand & ~strong

    # Flatten leading batch dims and PACK into uint32 bitplanes: the
    # propagation is per-image-independent boolean logic, so 32 images
    # ride each word and the dilation chain runs on ceil(N/32) (H, W)
    # planes instead of N — the production 8-dilation bounded chain was
    # 8 bandwidth-bound ~2.9 MB fusions at (64, 122, 122). Bit-identical:
    # per-bit | & == per-image | &.
    shape = strong.shape
    strong = strong.reshape((-1,) + shape[-2:])
    weak = weak.reshape((-1,) + shape[-2:])
    n = strong.shape[0]
    strong = _pack_bits(strong)
    weak = _pack_bits(weak)

    if hysteresis_rounds >= 0:
        edges = strong
        for _ in range(hysteresis_rounds):
            for _ in range(4):
                edges = edges | (_dilate3(edges) & weak)
        return _unpack_bits(edges, n).reshape(shape)

    def cond(carry):
        cur, changed, i = carry
        return changed & (i < max_iters)

    def body(carry):
        cur, _, i = carry
        # Several propagation steps per while-iteration: same fixpoint
        # (each step still only crosses weak pixels), but the convergence
        # check and loop-carry overhead amortize 4x.
        new = cur
        for _ in range(4):
            new = new | (_dilate3(new) & weak)
        return new, jnp.any(new != cur), i + 4

    edges, _, _ = jax.lax.while_loop(cond, body, (strong, jnp.asarray(True), 0))
    return _unpack_bits(edges, n).reshape(shape)
