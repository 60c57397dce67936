"""Circle detection as a matmul: gradient-weighted annular correlation.

The fast backend for the Hough stage. The exact transform (ops/hough.py)
scatters one vote per edge pixel and radius and iterates Canny's
hysteresis to a fixpoint; this backend reformulates HOUGH_GRADIENT's
geometry as convolutions that run as one dense matrix product:

An edge pixel p with unit gradient g votes for centers c with |p-c| ~ r
and (p-c) parallel to g. Relaxing the parallel constraint to an angular
weighting makes the vote separable. The weight is cos(2*theta) (theta =
angle between g and u = (c-p)/|c-p|): +1 for radially-aligned gradients
(true circle edges), -1 for tangential ones — so straight edges crossing
the annulus CANCEL instead of accumulating (a plain cos^2 weight scores
~81 on this suite's empty squares purely from warped square-border lines;
cos(2*theta) drops them to ~0 while leaving circle scores untouched).
It expands into two planes:

  cos 2theta = (g.u)^2 - (g.t)^2          (t = u rotated 90 deg)
             = (gx^2-gy^2)(ux^2-uy^2) + (2 gx gy)(2 ux uy)

so  score(c, r) = sum_p edge(p) cos(2*theta) [| |c-p| - r | <= delta]
              = conv(e*(gx^2-gy^2), K1_r) + conv(e*2*gx*gy, K2_r)

with static ring kernels K1=ux^2-uy^2, K2=2*ux*uy on the annulus. Two
batched convolutions over (64 squares, radii) replace 84M scattered
votes. Output is restricted to the center window the reference
cascade actually inspects (piece_detector.py:249-256: centers within 30%
of the square center).

Decision thresholds are calibrated against the exact backend
(ops/hough.py) on fixtures — see tests/test_hough_conv.py. Both backends
expose the same interface; models select via the backend seam
(the reference's Cython-else-Python alias pattern, frame_enhancer.py:184).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.ops.canny import canny
from chessboard_vision.ops.filters import sobel3

def score_matmul(basis: jnp.ndarray, planes_flat: jnp.ndarray) -> jnp.ndarray:
    """(Mq, K) bf16 basis x (64, K) bf16 planes -> (Mq, 64) f32 scores.

    Under vmap over streams the basis stays unbatched, so XLA folds the
    stream axis into the N dimension and reads the basis once per tick.
    """
    return jax.lax.dot_general(
        basis, planes_flat, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


class ConvHoughDims(NamedTuple):
    """Static (python-int) shape parameters — passed as a static jit arg."""

    ksize: int
    win_h: int
    win_w: int
    pad: int
    downsample: int
    woy: tuple  # (64,) static window row offsets (accumulator units)
    wox: tuple  # (64,) static window col offsets
    union_y0: int  # union-window top (accumulator units) across squares
    union_x0: int
    union_h: int  # Yu: union-window rows the basis matmul produces
    union_w: int  # Xu
    hysteresis_rounds: int = -1  # -1 exact fixpoint; k>=0 bounded


class ConvHoughPlan(NamedTuple):
    """Device constants for the conv circle search (paired with ConvHoughDims)."""

    kernels: jnp.ndarray  # (2, R, K, K) f32 ring kernels (ux^2-uy^2, 2*ux*uy)
    radii: jnp.ndarray  # (R,) f32 bin center radii
    r_valid: jnp.ndarray  # (64, R) bool — radius inside square's [minR,maxR]
    r_min: jnp.ndarray  # (64,) f32 per-square min radius (full-res px)
    r_max: jnp.ndarray  # (64,) f32 per-square max radius
    win_offset_y: jnp.ndarray  # (64,) i32 window top in square coords
    win_offset_x: jnp.ndarray  # (64,) i32
    win_mask: jnp.ndarray  # (Wy, Wx, 64) bool — centers within 30% of center
    #   (square axis LAST to match the transposed score matmul)
    basis: jnp.ndarray  # (Mq, 2*Hq*Wq) bf16 — ring kernels unrolled so
    #   the whole accumulator is ONE matmul (see find_circle). Stored
    #   output-major: scores come out (Mq, 64), and under vmap over
    #   streams the unbatched basis lets the streams fold into N.
    #   ROW-PRUNED: rows exist only for (r, y, x) cells that at least one
    #   square's circular center window + radius range accepts (~78% of
    #   the rectangular unroll — the matmul is bound by reading this
    #   constant, so dead rows were pure streamed waste).
    kvalid: jnp.ndarray  # (Mq, 64) bool — kept row valid for square s
    #   (folds r_valid + window membership + circular mask; pad rows all
    #   False). Square axis LAST like win_mask.
    kept_code: jnp.ndarray  # (Mq,) i32 — kept row's original flat
    #   (r * Yu + y) * Xu + x code for center/radius decode.

    @classmethod
    def build(
        cls,
        heights,
        widths,
        min_ratio: float = 0.20,
        max_ratio: float = 0.55,
        r_step: float = 3.0,
        delta: float = 1.2,
        center_window: float = 0.3,
        downsample: int = 3,
        plane_h: int = None,
        plane_w: int = None,
        hysteresis_rounds: int = -1,
    ):
        """Kernels and windows live in accumulator space: the F planes are
        sum-pooled by ``downsample`` (the dp analog — cv2 uses dp=1.2), so
        ring kernels shrink by the same factor and the conv cost drops
        ~downsample^4. Radii/coordinates reported back in full resolution."""
        heights = np.asarray(heights)
        widths = np.asarray(widths)
        q = downsample
        min_dim = np.minimum(heights, widths)
        minR = (min_dim * min_ratio).astype(np.int64)
        maxR = (min_dim * max_ratio).astype(np.int64)
        r_lo, r_hi = int(minR.min()), int(maxR.max())
        radii = np.arange(r_lo, r_hi + 1, r_step, dtype=np.float64)
        R = len(radii)

        r_hi_ds = r_hi / q
        K = 2 * (int(np.ceil(r_hi_ds + delta))) + 1
        c = K // 2
        yy, xx = np.mgrid[:K, :K]
        dy = (yy - c).astype(np.float64)
        dx = (xx - c).astype(np.float64)
        dist = np.sqrt(dy * dy + dx * dx)
        with np.errstate(invalid="ignore", divide="ignore"):
            ux = np.where(dist > 0, dx / dist, 0.0)
            uy = np.where(dist > 0, dy / dist, 0.0)
        kernels = np.zeros((2, R, K, K), np.float32)
        for i, r in enumerate(radii):
            ring = (np.abs(dist - r / q) <= delta) & (dist > 0)
            kernels[0, i] = (ring * (ux * ux - uy * uy)).astype(np.float32)
            kernels[1, i] = (ring * 2.0 * ux * uy).astype(np.float32)

        r_valid = (radii[None, :] >= minR[:, None]) & (radii[None, :] <= maxR[:, None])

        # Center window (accumulator units): 30% of min_dim around center.
        win = (min_dim * center_window / q).astype(np.int64)
        Wy = int(2 * win.max() + 1)
        Wx = Wy
        cy_ds = (heights // 2) // q
        cx_ds = (widths // 2) // q
        sq_plane_h = heights // q
        sq_plane_w = widths // q
        woy = np.clip(cy_ds - win, 0, np.maximum(sq_plane_h - Wy, 0)).astype(np.int64)
        wox = np.clip(cx_ds - win, 0, np.maximum(sq_plane_w - Wx, 0)).astype(np.int64)
        mask = np.zeros((64, Wy, Wx), bool)
        for s in range(64):
            ys = woy[s] + np.arange(Wy)
            xs = wox[s] + np.arange(Wx)
            d = np.sqrt(
                (ys[:, None] - cy_ds[s]) ** 2.0 + (xs[None, :] - cx_ds[s]) ** 2.0
            )
            inb = (
                (ys[:, None] >= 0)
                & (ys[:, None] < heights[s] // q)
                & (xs[None, :] >= 0)
                & (xs[None, :] < widths[s] // q)
            )
            mask[s] = (d < min_dim[s] * center_window / q) & inb
        # Unroll the ring kernels into one static basis matrix so the whole
        # accumulator becomes a single matmul. The conv's receptive field
        # (K up to ~33) covers the entire downsampled plane (~26 px), i.e.
        # every output cell depends on every input cell — exactly a dense
        # matmul, which streams the basis at memory bandwidth.
        # Rows index the flattened input (c, py, px); columns the flattened
        # output (r, y, x) restricted to the union of the per-square center
        # windows. Out-of-plane taps are zeroed (== the conv's zero pad).
        if plane_h is None:
            plane_h_full = int(heights.max())
        else:
            plane_h_full = int(plane_h)
        if plane_w is None:
            plane_w_full = int(widths.max())
        else:
            plane_w_full = int(plane_w)
        Hq, Wq = plane_h_full // q, plane_w_full // q
        y0, x0 = int(woy.min()), int(wox.min())
        Yu = int(woy.max()) + Wy - y0
        Xu = int(wox.max()) + Wx - x0
        dy = np.arange(Hq)[:, None] - (y0 + np.arange(Yu))[None, :] + c  # (Hq, Yu)
        dxm = np.arange(Wq)[:, None] - (x0 + np.arange(Xu))[None, :] + c  # (Wq, Xu)
        vy = (dy >= 0) & (dy < K)
        vx = (dxm >= 0) & (dxm < K)
        t = kernels[:, :, np.clip(dy, 0, K - 1).reshape(-1), :]  # (2,R,Hq*Yu,K)
        t = t[:, :, :, np.clip(dxm, 0, K - 1).reshape(-1)]  # (2,R,Hq*Yu,Wq*Xu)
        t = t.reshape(2, R, Hq, Yu, Wq, Xu)
        t = t * vy[None, None, :, :, None, None]
        t = t * vx[None, None, None, None, :, :]
        basis = np.ascontiguousarray(t.transpose(1, 3, 5, 0, 2, 4)).reshape(
            R * Yu * Xu, 2 * Hq * Wq
        )
        # Row pruning: a union cell (r, yu, xu) is worth scoring only if
        # SOME square accepts it — radius in that square's [minR, maxR]
        # band AND the cell inside its circular 30% center window. The
        # rectangular (R, Yu, Xu) unroll carries ~22% dead rows (circle
        # vs bounding square, plus per-square radius bands), and the
        # score matmul is HBM-bound on this constant. The argmax runs
        # over the compressed rows directly (order preserved: kept rows
        # stay (r, y, x)-lexicographic, so first-max tie-breaking matches
        # the dense form per square).
        yy_u = y0 + np.arange(Yu)
        xx_u = x0 + np.arange(Xu)
        by = yy_u[None, :] - woy[:, None]  # (64, Yu) window-relative row
        bx = xx_u[None, :] - wox[:, None]  # (64, Xu)
        in_win = (
            ((by >= 0) & (by < Wy))[:, :, None]
            & ((bx >= 0) & (bx < Wx))[:, None, :]
        )  # (64, Yu, Xu)
        cell_ok = np.zeros((64, Yu, Xu), bool)
        for s in range(64):
            byc = np.clip(by[s], 0, Wy - 1)
            bxc = np.clip(bx[s], 0, Wx - 1)
            cell_ok[s] = in_win[s] & mask[s][byc[:, None], bxc[None, :]]
        valid_full = (
            r_valid[:, :, None, None] & cell_ok[:, None, :, :]
        )  # (64, R, Yu, Xu)
        valid_full = valid_full.reshape(64, R * Yu * Xu).T  # (M, 64)
        kept = np.flatnonzero(valid_full.any(axis=1))
        basis = basis[kept]
        kvalid = valid_full[kept]
        kept_code = kept.astype(np.int32)

        plan = cls(
            kernels=jnp.asarray(kernels),
            radii=jnp.asarray(radii.astype(np.float32)),
            r_valid=jnp.asarray(r_valid),
            r_min=jnp.asarray(minR.astype(np.float32)),
            r_max=jnp.asarray(maxR.astype(np.float32)),
            win_offset_y=jnp.asarray(woy.astype(np.int32)),
            win_offset_x=jnp.asarray(wox.astype(np.int32)),
            win_mask=jnp.asarray(mask.transpose(1, 2, 0)),
            basis=jnp.asarray(basis, jnp.bfloat16),
            kvalid=jnp.asarray(kvalid),
            kept_code=jnp.asarray(kept_code),
        )
        dims = ConvHoughDims(
            ksize=K, win_h=Wy, win_w=Wx, pad=c, downsample=q,
            woy=tuple(int(v) for v in woy), wox=tuple(int(v) for v in wox),
            union_y0=y0, union_x0=x0, union_h=Yu, union_w=Xu,
            hysteresis_rounds=hysteresis_rounds,
        )
        return plan, dims


class ConvCircle(NamedTuple):
    found: jnp.ndarray  # (64,) bool
    cx: jnp.ndarray  # (64,) f32
    cy: jnp.ndarray  # (64,) f32
    radius: jnp.ndarray  # (64,) i32
    score: jnp.ndarray  # (64,) f32 peak annular support (proposal stage)
    votes: jnp.ndarray  # (64,) f32 cv2-semantics ray votes at the peak


@partial(jax.jit, static_argnames=("dims", "param1", "param2", "vote_tol"))
def find_circle(
    gray: jnp.ndarray,
    plan: ConvHoughPlan,
    dims: ConvHoughDims,
    param1: int = 100,
    param2: int = 25,
    vote_tol: float = 2.5,
) -> ConvCircle:
    """Best circle near each square's center. gray: (64, H, W) u8 pre-blurred.

    Two stages, both batched over the 64 squares:
    1. PROPOSE — the annular-correlation matmul scores every (center,
       radius) in the window; argmax picks one candidate per square.
    2. VERIFY — cv2's own accumulator semantics evaluated at just that
       candidate: an edge pixel p with unit gradient g votes iff
       minR <= |p-c| <= maxR and p's gradient ray passes within
       ``vote_tol`` px of c (|cross(c-p, g)| <= tol — the lateral miss
       distance; tol absorbs the q-cell center quantization ~q/2 plus
       cv2's dp cell). found = votes > param2, the SAME decision rule
       and threshold as the exact backend (ops/hough.py param2=25).
       Evaluating it at one center per square is a fused reduction — no
       scatter — and is what makes the correlation's line/texture
       responses harmless: a straight edge puts < 2*tol*thickness ~ 10
       aligned pixels on any single ray intersection, far below 25,
       while a true circle contributes a large fraction of its
       circumference (calibration: tests/test_regression_clip.py
       backend-agreement suite over the clean/hard/shadow clips).
    """
    n_sq, H, W = gray.shape
    edges = canny(gray, max(param1 // 2, 1), param1,
                  hysteresis_rounds=dims.hysteresis_rounds)
    dx, dy = sobel3(gray, border="reflect101")
    gx = dx.astype(jnp.float32)
    gy = dy.astype(jnp.float32)
    mag2 = gx * gx + gy * gy
    inv = jnp.where(mag2 > 0, jax.lax.rsqrt(jnp.maximum(mag2, 1e-12)), 0.0)
    e = edges.astype(jnp.float32)
    gxn = gx * inv
    gyn = gy * inv

    # Sum-pool to accumulator resolution (vote mass preserved). The two
    # cos-2theta planes are pooled SEPARATELY and concatenated only at
    # the small pooled size, so no full-resolution (2, 64, H, W)
    # intermediate is materialized. Column order (c-major, then py, px)
    # matches the basis unroll.
    q = dims.downsample

    def pool_flat(p):
        if q > 1:
            Hc, Wc = (H // q) * q, (W // q) * q
            p = p[:, :Hc, :Wc].reshape(n_sq, Hc // q, q, Wc // q, q).sum((2, 4))
        # Cast to bf16 BEFORE the flatten: the cast commutes with reshape
        # (same values either side), the pool-sum above stays f32, and
        # every downstream layout copy moves half the bytes.
        return p.astype(jnp.bfloat16).reshape(n_sq, -1)

    planes_flat = jnp.concatenate(
        [pool_flat(e * (gxn * gxn - gyn * gyn)), pool_flat(e * 2.0 * gxn * gyn)],
        axis=1,
    )

    R = plan.kernels.shape[1]
    Wy, Wx = dims.win_h, dims.win_w
    Yu, Xu = dims.union_h, dims.union_w

    # ONE matmul computes every (square, radius, center) score inside
    # the union of the per-square center windows: the ring kernels are
    # pre-unrolled into `basis` (rows = flattened input cells, cols =
    # flattened output cells), because at these shapes the receptive field
    # covers the whole downsampled plane — the conv is dense. bf16 operands
    # with f32 accumulation: ring sums are ~1e2 with a >50x threshold
    # margin, far above bf16 noise (decision-parity tested vs the exact
    # voting backend in tests/test_hough_conv.py).
    score_m = score_matmul(plan.basis, planes_flat)
    # The basis rows are PRE-PRUNED to the union of the per-square
    # windows' live (r, y, x) cells (ConvHoughPlan.build); kvalid folds
    # r_valid + window membership + circular mask per square. Kept rows
    # stay (r, y, x)-lexicographic, so jnp.argmax's first-max tie-break
    # picks the same winner as the dense window form did.
    flat = jnp.where(plan.kvalid, score_m, -jnp.inf)
    best = jnp.argmax(flat, axis=0)
    best_score = jnp.max(flat, axis=0)
    # Decode via the kept-row code table: a 64-element gather (far below
    # the serialized-gather cliff; the per-pixel path stays gather-free).
    code = plan.kept_code[best]
    ri = code // (Yu * Xu)
    rest = code % (Yu * Xu)
    by = rest // Xu
    bx = rest % Xu
    # Map accumulator cells back to full-resolution pixel coords (cell center).
    cy = ((dims.union_y0 + by).astype(jnp.float32) + 0.5) * q
    cx = ((dims.union_x0 + bx).astype(jnp.float32) + 0.5) * q
    radius = jnp.round(plan.radii[ri]).astype(jnp.int32)

    # VERIFY: cv2 vote count at the proposed center (full resolution).
    ys = jax.lax.broadcasted_iota(jnp.float32, (n_sq, H, W), 1)
    xs = jax.lax.broadcasted_iota(jnp.float32, (n_sq, H, W), 2)
    dyc = ys - cy[:, None, None]
    dxc = xs - cx[:, None, None]
    dist = jnp.sqrt(dyc * dyc + dxc * dxc)
    in_range = (dist >= plan.r_min[:, None, None]) & (dist <= plan.r_max[:, None, None])
    cross = jnp.abs(dxc * gyn - dyc * gxn)
    votes = jnp.sum(e * in_range * (cross <= vote_tol), axis=(-2, -1))
    found = votes > param2
    return ConvCircle(
        found=found, cx=cx, cy=cy, radius=radius, score=best_score, votes=votes
    )
