"""Device-side perspective warp and square extraction.

Replaces the reference's per-frame cv2.warpPerspective (board_detection.py:61)
+ GridExtractor.split_board (grid_extractor.py) with gathers driven by
calibration-time constant maps (see geometry.py). The bilinear arithmetic
matches OpenCV 5's float path (verified <=1 level on <1% of pixels against
cv2.warpPerspective, from ulp-level coordinate differences).

The hot-path design: frame (u8, H x W x 3) -> warped board and/or directly
the (64, Hs, Ws, 3) squares tensor, all inside jit, so one frame->squares
step is a single XLA program with no host round-trips.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.geometry import BoardGeometry


class DeviceGeometry(NamedTuple):
    """BoardGeometry constants as device arrays (a jit-friendly pytree)."""

    warp_X: jnp.ndarray  # (B, B) f32
    warp_Y: jnp.ndarray  # (B, B) f32
    sq_iy: jnp.ndarray  # (64, Hp, Wp) i32
    sq_ix: jnp.ndarray  # (64, Hp, Wp) i32
    sq_mask: jnp.ndarray  # (64, H, W) bool
    sq_mask_flat: jnp.ndarray  # (64, H*W) bool — pre-flattened for the
    #   change detector (whose model is stored flat, ops/change.py);
    #   consts are jit ARGUMENTS, so flattening sq_mask inside the step
    #   would re-tile it every frame.
    sq_counts: jnp.ndarray  # (64,) i32  true pixel counts per square
    sq_heights: jnp.ndarray  # (64,) i32
    sq_widths: jnp.ndarray  # (64,) i32

    @classmethod
    def from_host(cls, geom: BoardGeometry) -> "DeviceGeometry":
        s = geom.squares
        return cls(
            warp_X=jnp.asarray(geom.warp_X),
            warp_Y=jnp.asarray(geom.warp_Y),
            sq_iy=jnp.asarray(s.iy),
            sq_ix=jnp.asarray(s.ix),
            sq_mask=jnp.asarray(s.mask),
            sq_mask_flat=jnp.asarray(s.mask.reshape(s.mask.shape[0], -1)),
            sq_counts=jnp.asarray(s.counts),
            sq_heights=jnp.asarray(s.heights),
            sq_widths=jnp.asarray(s.widths),
        )

    @property
    def pad(self) -> int:
        # (Hp - H) // 2; static because shapes are static under jit.
        return (self.sq_iy.shape[1] - self.sq_mask.shape[1]) // 2


def warp_bilinear(img: jnp.ndarray, X: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
    """Inverse-map bilinear warp with constant-0 border (cv2 semantics).

    img: (H, W) or (H, W, C) u8. X, Y: (outH, outW) f32 source coords.
    """
    H, W = img.shape[0], img.shape[1]
    chan = img.ndim == 3
    ix = jnp.floor(X).astype(jnp.int32)
    iy = jnp.floor(Y).astype(jnp.int32)
    fx = (X - ix.astype(jnp.float32))
    fy = (Y - iy.astype(jnp.float32))
    if chan:
        fx = fx[..., None]
        fy = fy[..., None]

    def tap(dy, dx):
        yy = iy + dy
        xx = ix + dx
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = img[jnp.clip(yy, 0, H - 1), jnp.clip(xx, 0, W - 1)].astype(jnp.float32)
        m = inb[..., None] if chan else inb
        return v * m

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = p00 + fx * (p01 - p00)
    bot = p10 + fx * (p11 - p10)
    val = top + fy * (bot - top)
    return jnp.clip(jnp.round(val), 0, 255).astype(jnp.uint8)


def extract_squares(board: jnp.ndarray, g: DeviceGeometry) -> jnp.ndarray:
    """Slice the warped board into the (64, Hp, Wp[, C]) squares tensor.

    Includes the per-square reflect-101 border baked into the maps (so a
    following valid-mode blur matches per-crop OpenCV exactly) — reference
    split_board semantics (grid_extractor.py:123-163) with a1 = index 0.
    """
    return board[g.sq_iy, g.sq_ix]


def frame_to_board(frame: jnp.ndarray, g: DeviceGeometry) -> jnp.ndarray:
    """Warp a raw camera frame to the top-down board (orientation-flip baked in)."""
    return warp_bilinear(frame, g.warp_X, g.warp_Y)


def frame_to_squares(frame: jnp.ndarray, g: DeviceGeometry) -> jnp.ndarray:
    """frame -> warped board -> squares tensor, one fused device program."""
    return extract_squares(frame_to_board(frame, g), g)


# ---------------------------------------------------------------------------
# Masked reductions for variable-size squares
# ---------------------------------------------------------------------------


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray, counts: jnp.ndarray) -> jnp.ndarray:
    """Mean over each square's valid region. x: (64, H, W) f32-able."""
    s = jnp.sum(x.astype(jnp.float32) * mask, axis=(-2, -1))
    return s / counts.astype(jnp.float32)


def masked_std(x: jnp.ndarray, mask: jnp.ndarray, counts: jnp.ndarray) -> jnp.ndarray:
    """Population std over each square's valid region (np.std semantics)."""
    xf = x.astype(jnp.float32)
    n = counts.astype(jnp.float32)
    mu = jnp.sum(xf * mask, axis=(-2, -1)) / n
    d2 = jnp.where(mask, (xf - mu[:, None, None]) ** 2, 0.0)
    return jnp.sqrt(jnp.sum(d2, axis=(-2, -1)) / n)


def interior(x: jnp.ndarray, g: DeviceGeometry) -> jnp.ndarray:
    """Strip the blur border: (64, Hp, Wp[,C]) -> (64, H, W[,C])."""
    p = g.pad
    H, W = g.sq_mask.shape[1], g.sq_mask.shape[2]
    return x[:, p : p + H, p : p + W]
