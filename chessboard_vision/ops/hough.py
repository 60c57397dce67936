"""Batched gradient Hough circle transform on device.

Device equivalent of the per-square cv2.HoughCircles calls in reference
piece_detector.py:210-270 (HOUGH_GRADIENT, dp=1.2, minDist=min_dim//3,
param1=100, param2=25, radii 20-55% of the square). All 64 squares are
processed as one batch: device Canny -> fixed-point ray voting into per-
square accumulators via one scatter-add per radius -> local-maxima center
candidates -> greedy top-K selection with minDist suppression -> OpenCV's
run-based radius estimation, reformulated as a sorted-distances + binary-
search run decomposition (a ~30-step fori_loop instead of a 5929-step scan).

Parity: cv2's internal accumulator is not bit-reproducible (its float
rounding and tie ordering differ), so parity is validated at the decision
level — same found/not-found and center-within-30%-window outcomes on
realistic fixtures (see SURVEY.md §7 hard-parts plan and tests).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.ops.canny import canny
from chessboard_vision.ops.filters import sobel3

_SHIFT = 10
_ONE = 1 << _SHIFT


class HoughBounds(NamedTuple):
    """Static (python-int) loop/shape bounds — passed as a static jit arg."""

    r_lo: int
    r_hi: int
    acc_h: int  # max arows + 2
    acc_w: int  # max acols + 2


class HoughParams(NamedTuple):
    """Per-square device scalars for the circle search.

    The matching static ``HoughBounds`` lives in ``.bounds`` builders; the
    two are produced together by ``from_geometry``.
    """

    min_radius: jnp.ndarray  # (64,) i32
    max_radius: jnp.ndarray  # (64,) i32
    min_dist: jnp.ndarray  # (64,) f32
    arows: jnp.ndarray  # (64,) i32 accumulator rows (ceil(h/dp))
    acols: jnp.ndarray  # (64,) i32

    @classmethod
    def from_geometry(
        cls, heights, widths, dp=1.2, min_ratio=0.20, max_ratio=0.55
    ):
        heights = np.asarray(heights)
        widths = np.asarray(widths)
        min_dim = np.minimum(heights, widths)
        min_r = (min_dim * min_ratio).astype(np.int32)
        max_r = (min_dim * max_ratio).astype(np.int32)
        idp = 1.0 / dp
        arows = np.ceil(heights * idp).astype(np.int32)
        acols = np.ceil(widths * idp).astype(np.int32)
        params = cls(
            min_radius=jnp.asarray(min_r),
            max_radius=jnp.asarray(max_r),
            min_dist=jnp.asarray((min_dim // 3).astype(np.float32)),
            arows=jnp.asarray(arows),
            acols=jnp.asarray(acols),
        )
        bounds = HoughBounds(
            r_lo=int(min_r.min()),
            r_hi=int(max_r.max()),
            acc_h=int(arows.max()) + 2,
            acc_w=int(acols.max()) + 2,
        )
        return params, bounds


class HoughCircles(NamedTuple):
    """Top-K circles per square (fixed K, masked by ``found``)."""

    found: jnp.ndarray  # (64, K) bool
    cx: jnp.ndarray  # (64, K) f32 full-resolution center x
    cy: jnp.ndarray  # (64, K) f32
    radius: jnp.ndarray  # (64, K) f32
    votes: jnp.ndarray  # (64, K) i32


def _vote(edges, dx, dy, p: HoughParams, b: HoughBounds, dp: float):
    """Fixed-point ray voting (the cv2 scheme): one scatter-add per radius."""
    n_sq, H, W = edges.shape
    idp = jnp.float32(1.0 / dp)
    vx = dx.astype(jnp.float32)
    vy = dy.astype(jnp.float32)
    mag = jnp.sqrt(vx * vx + vy * vy)
    safe_mag = jnp.maximum(mag, 1.0)
    sx = jnp.rint(vx * idp * _ONE / safe_mag).astype(jnp.int32)
    sy = jnp.rint(vy * idp * _ONE / safe_mag).astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    x0 = jnp.rint(xs.astype(jnp.float32) * idp * _ONE).astype(jnp.int32)
    y0 = jnp.rint(ys.astype(jnp.float32) * idp * _ONE).astype(jnp.int32)
    voter = edges & ((dx != 0) | (dy != 0))

    acw = b.acc_w
    flat_cells = b.acc_h * acw
    arows = p.arows[:, None, None]
    acols = p.acols[:, None, None]
    rmin = p.min_radius[:, None, None]
    rmax = p.max_radius[:, None, None]

    # One vmapped 1-D scatter-add per radius chunk. NB: the vmap-of-1D form
    # lowers to a batched scatter; a 2-D `.at[iota[:, None], idx].add`
    # form lowers to a generic scatter, which was far slower.
    n_radii = b.r_hi - b.r_lo + 1
    chunk = 8  # radii per scatter: memory (64 x 2*chunk*H*W i32) vs call count

    def scatter_chunk(acc_1d, idx_1d, val_1d):
        return acc_1d.at[idx_1d].add(val_1d)

    scatter_b = jax.vmap(scatter_chunk)

    def body(ci, acc):
        targets = []
        valids = []
        for j in range(chunk):
            r = b.r_lo + ci * chunk + j
            in_range = (r >= rmin) & (r <= rmax) & (r <= b.r_hi)
            for sgn in (1, -1):
                x2 = (x0 + sgn * r * sx) >> _SHIFT
                y2 = (y0 + sgn * r * sy) >> _SHIFT
                inb = (x2 >= 0) & (x2 < acols) & (y2 >= 0) & (y2 < arows)
                valid = voter & in_range & inb
                flat = jnp.clip((y2 + 1) * acw + (x2 + 1), 0, flat_cells - 1)
                targets.append(flat.reshape(n_sq, -1))
                valids.append(valid.reshape(n_sq, -1))
        idx = jnp.concatenate(targets, axis=1)
        val = jnp.concatenate(valids, axis=1).astype(jnp.int32)
        return scatter_b(acc, idx, val)

    acc = jnp.zeros((n_sq, flat_cells), jnp.int32)
    n_chunks = (n_radii + chunk - 1) // chunk
    acc = jax.lax.fori_loop(0, n_chunks, body, acc)
    return acc.reshape(n_sq, b.acc_h, acw)


def _center_candidates(acc, p: HoughParams, param2: int):
    """Local maxima above threshold (cells inside each square's accum)."""
    v = acc[:, 1:-1, 1:-1]
    left = acc[:, 1:-1, :-2]
    right = acc[:, 1:-1, 2:]
    up = acc[:, :-2, 1:-1]
    down = acc[:, 2:, 1:-1]
    ah, aw = v.shape[1], v.shape[2]
    cx = jax.lax.broadcasted_iota(jnp.int32, (ah, aw), 1)
    cy = jax.lax.broadcasted_iota(jnp.int32, (ah, aw), 0)
    inside = (cx < p.acols[:, None, None]) & (cy < p.arows[:, None, None])
    cand = (
        (v > param2)
        & (v > left)
        & (v >= right)
        & (v > up)
        & (v >= down)
        & inside
    )
    return jnp.where(cand, v, -1)  # (64, ah, aw)


def _radius_support(sorted_d, s_idx0, dr: float, n_runs: int):
    """OpenCV's greedy run scan over descending sorted distances.

    sorted_d: (..., N) ascending with -inf for invalid entries.
    s_idx0: (...) index of the largest valid distance (run start).
    Returns (r_best, max_count) per lane.
    """
    neg_inf = jnp.float32(-jnp.inf)
    N = sorted_d.shape[-1]

    def body(_, state):
        s_idx, r_best, max_count, done = state
        start_d = jnp.take_along_axis(sorted_d, s_idx[..., None], axis=-1)[..., 0]
        thresh = start_d - jnp.float32(dr)
        # first index with value >= thresh
        j_first = jnp.sum(sorted_d < thresh[..., None], axis=-1)
        j = j_first - 1  # trigger index (largest with value < thresh)
        j_safe = jnp.clip(j, 0, N - 1)
        trig_d = jnp.take_along_axis(sorted_d, j_safe[..., None], axis=-1)[..., 0]
        has_trigger = (j >= 0) & (trig_d > neg_inf) & ~done
        count = s_idx - j
        mid = jnp.clip((j + s_idx) // 2 + 1, 0, N - 1)
        r_cur = jnp.take_along_axis(sorted_d, mid[..., None], axis=-1)[..., 0]
        take = has_trigger & (
            (count.astype(jnp.float32) * r_best >= max_count.astype(jnp.float32) * r_cur)
            | ((r_best < 1e-7) & (count >= max_count))
        )
        r_best = jnp.where(take, r_cur, r_best)
        max_count = jnp.where(take, count, max_count)
        s_idx = jnp.where(has_trigger, j_safe, s_idx)
        done = done | ~has_trigger
        return s_idx, r_best, max_count, done

    init = (
        s_idx0,
        jnp.zeros(s_idx0.shape, jnp.float32),
        jnp.zeros(s_idx0.shape, jnp.int32),
        jnp.zeros(s_idx0.shape, bool),
    )
    _, r_best, max_count, _ = jax.lax.fori_loop(0, n_runs, body, init)
    return r_best, max_count


@partial(jax.jit, static_argnames=("b", "dp", "param1", "param2", "top_k"))
def hough_circles(
    gray: jnp.ndarray,
    p: HoughParams,
    b: HoughBounds,
    dp: float = 1.2,
    param1: int = 100,
    param2: int = 25,
    top_k: int = 4,
) -> HoughCircles:
    """Find up to top_k circles per square. gray: (64, H, W) u8 (pre-blurred)."""
    n_sq, H, W = gray.shape
    edges = canny(gray, max(param1 // 2, 1), param1)
    dx, dy = sobel3(gray, border="reflect101")
    acc = _vote(edges, dx, dy, p, b, dp)
    cand = _center_candidates(acc, p, param2)  # (64, ah, aw) votes or -1
    ah, aw = cand.shape[1], cand.shape[2]

    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    rmin2 = (p.min_radius.astype(jnp.float32) ** 2)[:, None, None]
    rmax2 = (p.max_radius.astype(jnp.float32) ** 2)[:, None, None]
    n_runs = int(np.ceil((b.r_hi - b.r_lo) / dp)) + 4

    def step(carry, _):
        cand_v, = carry
        flat = cand_v.reshape(n_sq, -1)
        best = jnp.argmax(flat, axis=-1)
        votes = jnp.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
        exists = votes > param2
        by = (best // aw).astype(jnp.float32)
        bx = (best % aw).astype(jnp.float32)
        ccx = (bx + 0.5) * dp
        ccy = (by + 0.5) * dp

        d2 = (xs[None] - ccx[:, None, None]) ** 2 + (ys[None] - ccy[:, None, None]) ** 2
        valid = edges & (d2 >= rmin2) & (d2 <= rmax2)
        dvals = jnp.where(valid, jnp.sqrt(d2), -jnp.inf).reshape(n_sq, -1)
        sorted_d = jnp.sort(dvals, axis=-1)
        has_any = sorted_d[:, -1] > -jnp.inf
        s_idx0 = jnp.full((n_sq,), H * W - 1, jnp.int32)
        r_best, max_count = _radius_support(sorted_d, s_idx0, dp, n_runs)
        support_ok = (max_count > param2) & has_any

        accept = exists & support_ok
        # Suppress: accepted -> minDist disk; rejected-but-picked -> single cell.
        gx = jax.lax.broadcasted_iota(jnp.float32, (ah, aw), 1)
        gy = jax.lax.broadcasted_iota(jnp.float32, (ah, aw), 0)
        gcx = (gx + 0.5) * dp
        gcy = (gy + 0.5) * dp
        cell_d2 = (gcx[None] - ccx[:, None, None]) ** 2 + (gcy[None] - ccy[:, None, None]) ** 2
        in_disk = cell_d2 < (p.min_dist**2)[:, None, None]
        flat_idx = jax.lax.broadcasted_iota(jnp.int32, (ah, aw), 0) * aw + jax.lax.broadcasted_iota(
            jnp.int32, (ah, aw), 1
        )
        is_picked = flat_idx[None] == best[:, None, None]
        suppress = jnp.where(accept[:, None, None], in_disk, is_picked)
        new_cand = jnp.where(suppress, -1, cand_v)

        out = (accept, ccx, ccy, r_best, votes)
        return (new_cand,), out

    (_,), outs = jax.lax.scan(step, (cand,), None, length=top_k)
    found, ccx, ccy, radius, votes = outs  # each (K, 64)
    return HoughCircles(
        found=found.T, cx=ccx.T, cy=ccy.T, radius=radius.T, votes=votes.T
    )


def best_circle_near_center(
    circles: HoughCircles, heights, widths, center_window: float = 0.3
):
    """Reference selection (piece_detector.py:243-268): among found circles,
    keep those whose center is within center_window*min_dim of the square
    center, pick the closest. Returns (found, cx, cy, radius_int, is_small)
    with is_small = radius < 20% of min_dim ('tower_top').
    """
    h = heights.astype(jnp.float32)
    w = widths.astype(jnp.float32)
    min_dim = jnp.minimum(h, w)
    cx0 = jnp.floor(w / 2)[:, None]
    cy0 = jnp.floor(h / 2)[:, None]
    d = jnp.sqrt((circles.cx - cx0) ** 2 + (circles.cy - cy0) ** 2)
    in_win = circles.found & (d < (min_dim * center_window)[:, None])
    d_masked = jnp.where(in_win, d, jnp.inf)
    pick = jnp.argmin(d_masked, axis=-1)
    found = jnp.any(in_win, axis=-1)
    sel = lambda a: jnp.take_along_axis(a, pick[:, None], axis=-1)[:, 0]
    r_int = jnp.floor(sel(circles.radius)).astype(jnp.int32)
    is_small = r_int.astype(jnp.float32) < min_dim * 0.20
    return found, sel(circles.cx), sel(circles.cy), r_int, is_small
