"""Gather-free bilinear resampling with calibration-time static indices.

Off the production path: the pipeline warps planar frames with the banded
matmuls of ops/matmul_resample.py. This plan is the host-side resampler's
parity reference (native/__init__.py) and keeps ``to_planar``. Since the
warp's sample positions are calibration constants, the gather
``out[j] = src[idx[j]]`` is re-expressed as static-structure ops:

  host planner (once per calibration):
    sort the static query indices; compute for every *source* pixel the
    slot of its first-occurrence query (unused sources get distinct dump
    slots); compute per-query duplicate back-shifts (bounded by L, the max
    multiplicity); keep the inverse permutation.
  device executor (per frame):
    1. one flat scatter-set  src -> sorted-query buffer   (distinct idx)
    2. <=L shifted selects to fill duplicate queries      (static masks)
    3. one flat scatter-set to un-sort into query order   (permutation)

The four bilinear taps ride along by packing B,G,R of the tap-neighborhood
into one int32 per pixel, so the whole warp+square-extraction is 4
scatters + fills + 1 unpermute + an elementwise lerp, bit-identical to
the gather path (same f32 lerp and rounding).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class ResamplePlan(NamedTuple):
    """Host-precomputed static structure for one set of query positions."""

    # device (jnp) constants:
    slot_of_src: jnp.ndarray  # (n_src,) i32: source flat idx -> buffer slot
    dup_masks: tuple  # tuple of (M,) bool masks, one per shift 1..L
    inv_perm: jnp.ndarray  # (M,) i32: sorted-order slot -> query position
    fx: jnp.ndarray  # (M,) f32 fractional x per query
    fy: jnp.ndarray  # (M,) f32
    oob: jnp.ndarray  # (M, 4) bool out-of-bounds per tap (border = 0)
    # static python ints:
    n_src: int
    n_queries: int
    buf_len: int

    @classmethod
    def build(cls, X: np.ndarray, Y: np.ndarray, src_h: int, src_w: int) -> "ResamplePlan":
        """X, Y: float32 source coordinates per query (any shape, flattened).

        Matches ops/warp.warp_bilinear semantics: floor/frac taps, taps
        outside the source contribute 0.
        """
        X = np.asarray(X, np.float32).reshape(-1)
        Y = np.asarray(Y, np.float32).reshape(-1)
        M = X.size
        ix = np.floor(X).astype(np.int64)
        iy = np.floor(Y).astype(np.int64)
        fx = (X - ix).astype(np.float32)
        fy = (Y - iy).astype(np.float32)

        # Tap 00 anchor; taps 01/10/11 are +1 in x/y and arrive via
        # pre-shifted copies of the source, so one query set serves all 4.
        oob = np.zeros((M, 4), bool)
        taps = [(0, 0), (0, 1), (1, 0), (1, 1)]
        for t, (dy, dx) in enumerate(taps):
            yy = iy + dy
            xx = ix + dx
            oob[:, t] = ~((yy >= 0) & (yy < src_h) & (xx >= 0) & (xx < src_w))
        # Tap shifts are relative to the (clamped) anchor: when the anchor
        # itself is outside the source, alignment breaks — zero all taps
        # for those (border-of-frame) queries.
        anchor_oob = ~((iy >= 0) & (iy < src_h) & (ix >= 0) & (ix < src_w))
        oob |= anchor_oob[:, None]
        # Clamp the anchor so the flat index is valid; oob taps are zeroed.
        iyc = np.clip(iy, 0, src_h - 1)
        ixc = np.clip(ix, 0, src_w - 1)
        idx = (iyc * src_w + ixc).astype(np.int64)
        n_src = src_h * src_w

        perm = np.argsort(idx, kind="stable")
        idx_s = idx[perm]
        first = np.ones(M, bool)
        if M > 1:
            first[1:] = idx_s[1:] != idx_s[:-1]
        first_pos_of = np.where(first, np.arange(M), 0)
        first_pos_of = np.maximum.accumulate(first_pos_of)
        dupshift = np.arange(M) - first_pos_of
        L = int(dupshift.max()) if M else 0

        # Source -> slot map. Unused sources spread across distinct dump
        # slots after the live region (collision-free scatter).
        used_src = idx_s[first]
        slot_of_src = np.full(n_src, -1, np.int64)
        slot_of_src[used_src] = np.where(first)[0]
        unused = slot_of_src < 0
        n_unused = int(unused.sum())
        slot_of_src[unused] = M + np.arange(n_unused)
        buf_len = M + n_unused

        dup_masks = tuple(
            jnp.asarray(dupshift == k) for k in range(1, L + 1)
        )
        return cls(
            slot_of_src=jnp.asarray(slot_of_src.astype(np.int32)),
            dup_masks=dup_masks,
            inv_perm=jnp.asarray(perm.astype(np.int32)),
            fx=jnp.asarray(fx),
            fy=jnp.asarray(fy),
            oob=jnp.asarray(oob),
            n_src=n_src,
            n_queries=M,
            buf_len=buf_len,
        )


def _static_take(flat_src: jnp.ndarray, plan: ResamplePlan) -> jnp.ndarray:
    """out[j] = flat_src[static_idx[j]] via scatter + dup-fill + unpermute."""
    buf = jnp.zeros((plan.buf_len,), flat_src.dtype)
    buf = buf.at[plan.slot_of_src].set(flat_src)
    buf = buf[: plan.n_queries]
    for k, mask in enumerate(plan.dup_masks, start=1):
        buf = jnp.where(mask, jnp.roll(buf, k), buf)
    out = jnp.zeros((plan.n_queries,), flat_src.dtype)
    return out.at[plan.inv_perm].set(buf)


def _pack_bgr(frame_planar: jnp.ndarray) -> jnp.ndarray:
    """(3, H, W) u8 -> (H*W,) i32 with B | G<<8 | R<<16."""
    x = frame_planar.astype(jnp.int32)
    return (x[0] + (x[1] << 8) + (x[2] << 16)).reshape(-1)


def _unpack_bgr(packed: jnp.ndarray):
    b = packed & 0xFF
    g = (packed >> 8) & 0xFF
    r = (packed >> 16) & 0xFF
    return b, g, r


def resample_bgr(frame_planar: jnp.ndarray, plan: ResamplePlan, src_w: int):
    """Bilinear-resample a planar BGR frame at the plan's query positions.

    Returns three (M,) u8 arrays (b, g, r), bit-identical to
    ops.warp.warp_bilinear on the HWC frame at those positions for all
    queries whose floor-anchor lies inside the source (always true for
    calibrations whose corners sit inside the frame). Queries with an
    out-of-source anchor return 0 (cv2 would blend the 1-px border
    partially) — the planner counts them in ``ResamplePlan`` oob stats.
    """
    packed = _pack_bgr(frame_planar)
    # Pre-shift for the 3 non-anchor taps (+1 x, +1 y, +1 both): shifting
    # the flat source by -1 / -src_w aligns tap value onto the anchor index.
    p00 = packed
    p01 = jnp.roll(packed, -1)
    p10 = jnp.roll(packed, -src_w)
    p11 = jnp.roll(packed, -(src_w + 1))

    taps = []
    for t, p in enumerate((p00, p01, p10, p11)):
        v = _static_take(p, plan)
        taps.append(jnp.where(plan.oob[:, t], 0, v))
    t00, t01, t10, t11 = taps

    outs = []
    for c in range(3):
        c00 = ((t00 >> (8 * c)) & 0xFF).astype(jnp.float32)
        c01 = ((t01 >> (8 * c)) & 0xFF).astype(jnp.float32)
        c10 = ((t10 >> (8 * c)) & 0xFF).astype(jnp.float32)
        c11 = ((t11 >> (8 * c)) & 0xFF).astype(jnp.float32)
        top = c00 + plan.fx * (c01 - c00)
        bot = c10 + plan.fx * (c11 - c10)
        val = top + plan.fy * (bot - top)
        outs.append(jnp.clip(jnp.round(val), 0, 255).astype(jnp.uint8))
    return outs[0], outs[1], outs[2]


def to_planar(frame_hwc) -> np.ndarray:
    """Host helper: HWC BGR (camera layout) -> planar (3, H, W).

    Done host-side: an (H, W, 3) u8 frame has a minor dimension of 3,
    which device layouts handle poorly, so frames are shipped planar.
    """
    return np.ascontiguousarray(np.moveaxis(np.asarray(frame_hwc), -1, 0))
