"""Bilinear resampling as banded matmuls: warp + square extraction.

The production implementation of the static warp for planar frames (the
direct gather warp, ops/warp.py, serves HWC frames). This formulation
uses only matmuls, elementwise ops, and static slices:

  0. Static per-square source regions (python-loop lax.slice — the region
     rectangles are calibration constants).
  1. Row-select matmul: a one-hot (vertical-band) matrix pulls, for every
     (square, output-row), the B consecutive source rows its samples touch.
  2. Column-weight matmul: per (square, output-row), a two-banded weight
     matrix performs the horizontal lerp.
  3. An elementwise vertical lerp over the B band rows finishes bilinear.

All selection matrices are built on the fly from compact static index
arrays (compare-with-iota), so nothing big lives in the executable. The
fast path samples the *grayscale* frame (gray conversion is linear, so
this equals channel-wise warping up to per-channel u8 rounding — <=1
intensity level vs the 'exact' HWC path, which keeps bit parity for the
oracle tests).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class MatmulResamplePlan(NamedTuple):
    """Device constants (compact static index/weight arrays)."""

    row_base: jnp.ndarray  # (64, Qr) i32 band start row (region-local)
    col_ix: jnp.ndarray  # (64, Qr, Qc) i32 left source col (region-local)
    fx: jnp.ndarray  # (64, Qr, Qc) f32
    fy: jnp.ndarray  # (64, Qr, Qc) f32
    uy_off: jnp.ndarray  # (64, Qr, Qc) i32 floor-row offset within band
    zero_mask: jnp.ndarray  # (64, Qr, Qc) bool -> output forced 0
    col_base: jnp.ndarray  # (64, Qc) i32 column-band start (region-local)
    ux_off: jnp.ndarray  # (64, Qr, Qc) i32 floor-col offset within col band
    # Precomputed lerp weights (calibration constants — building them on
    # device every step took iota/compare fusions and 5-D
    # (64, Qr, B, BC, Qc) tap tensors with 2-wide minor dims). hw is pre-tiled over
    # the band rows in B-MAJOR order (row index b*Qr + j), so every tap
    # of the unrolled lerp is a static contiguous slice.
    # Stored as TUPLES of per-tap (64, ..., Qc) arrays, not stacked 4-D
    # tensors: XLA gave the stacked constants a layout with the square
    # axis second-minor and re-laid them out every step; separate 3-D
    # constants keep their natural layout.
    hw: tuple  # BC x (64, B*Qr, Qc) f32 horizontal tap weights
    vw: tuple  # B x (64, Qr, Qc) f32 vertical tap weights


class MatmulResampleDims(NamedTuple):
    q_rows: int
    q_cols: int
    band: int  # B: band rows per output row (incl. +1 tap)
    region_h: int  # RH
    region_w: int  # RW
    src_h: int
    src_w: int
    ry0: Tuple[int, ...]  # (64,) region row starts (static)
    rx0: Tuple[int, ...]  # (64,) region col starts (static)
    col_band: int = 0  # BC: cols per output col shared across ALL rows
    # (0 = too wide, use the per-row path)


def build_plan(qx: np.ndarray, qy: np.ndarray, src_h: int, src_w: int):
    """qx/qy: (64, Qr, Qc) f32 source coords per padded-square pixel."""
    qx = np.asarray(qx, np.float32)
    qy = np.asarray(qy, np.float32)
    n_sq, Qr, Qc = qx.shape
    ix = np.floor(qx).astype(np.int64)
    iy = np.floor(qy).astype(np.int64)
    fx = (qx - ix).astype(np.float32)
    fy = (qy - iy).astype(np.float32)

    # Out-of-source anchors produce 0 (interior calibrations never hit this).
    bad = (ix < 0) | (ix + 1 >= src_w) | (iy < 0) | (iy + 1 >= src_h)
    big = np.iinfo(np.int64).max

    # Per-square source regions.
    iy_v = np.where(bad, big, iy)
    ix_v = np.where(bad, big, ix)
    ry_min = np.minimum(iy_v.min(axis=(1, 2)), src_h - 2)
    ry_max = np.maximum(np.where(bad, -1, iy).max(axis=(1, 2)) + 1, 1)
    rx_min = np.minimum(ix_v.min(axis=(1, 2)), src_w - 2)
    rx_max = np.maximum(np.where(bad, -1, ix).max(axis=(1, 2)) + 1, 1)
    RH = int(_round_up(int((ry_max - ry_min).max()) + 2, 8))
    # contraction-dim alignment: multiples of 8 suffice (128 would double
    # the on-the-fly ColW tensor for ~126px squares)
    RW = int(_round_up(int((rx_max - rx_min).max()) + 2, 8))
    RH = min(RH, src_h)
    RW = min(RW, src_w)
    ry0 = np.clip(ry_min, 0, src_h - RH)
    rx0 = np.clip(rx_min, 0, src_w - RW)

    # Vertical band per (square, out-row), region-local.
    iy_loc = iy - ry0[:, None, None]
    row_min = np.where(bad, big, iy_loc).min(axis=2)
    row_min = np.clip(row_min, 0, RH - 2)
    B = int(np.where(bad, 0, iy_loc - row_min[:, :, None]).max()) + 2
    row_base = np.clip(row_min, 0, RH - B)
    uy_off = np.clip(np.where(bad, 0, iy_loc - row_base[:, :, None]), 0, B - 2)

    ix_loc = np.clip(ix - rx0[:, None, None], 0, RW - 2)
    ix_loc = np.where(bad, 0, ix_loc)

    # Horizontal band per (square, out-COLUMN), shared across all rows —
    # lets the horizontal lerp run as ONE per-square column-select matmul
    # instead of a per-(square,row) batch of M=2 matmuls (degenerate
    # matmul shapes). BC is the per-column source-col drift over the square's
    # height (the homography's x-shear) + 2 taps; falls back to the
    # per-row path when shear is pathological (BC > 16).
    col_min = np.where(bad, big, ix_loc).min(axis=1)  # (64, Qc)
    col_min = np.clip(col_min, 0, RW - 2)
    BC = int(np.where(bad, 0, ix_loc - col_min[:, None, :]).max()) + 2
    col_base = np.clip(col_min, 0, RW - BC)
    ux_off = np.clip(np.where(bad, 0, ix_loc - col_base[:, None, :]), 0, BC - 2)

    # Precomputed lerp weights (see MatmulResamplePlan.hw/vw). All f32
    # arithmetic so the weights are bit-identical to the on-device
    # (1 - fx)/(fx) construction they replace.
    one = np.float32(1.0)
    zero = np.float32(0.0)
    hw = np.zeros((BC, n_sq, B * Qr, Qc), np.float32)
    for c in range(BC):
        w = np.where(c == ux_off, one - fx, zero) + np.where(c == ux_off + 1, fx, zero)
        hw[c] = np.tile(w.astype(np.float32), (1, B, 1))  # row b*Qr+j = w[:, j]
    vw = np.zeros((B, n_sq, Qr, Qc), np.float32)
    for b in range(B):
        vw[b] = np.where(b == uy_off, one - fy, zero) + np.where(b == uy_off + 1, fy, zero)

    plan = MatmulResamplePlan(
        row_base=jnp.asarray(row_base.astype(np.int32)),
        col_ix=jnp.asarray(ix_loc.astype(np.int32)),
        fx=jnp.asarray(fx),
        fy=jnp.asarray(fy),
        uy_off=jnp.asarray(uy_off.astype(np.int32)),
        zero_mask=jnp.asarray(bad),
        col_base=jnp.asarray(col_base.astype(np.int32)),
        ux_off=jnp.asarray(ux_off.astype(np.int32)),
        hw=tuple(jnp.asarray(hw[c]) for c in range(BC)),
        vw=tuple(jnp.asarray(vw[b]) for b in range(B)),
    )
    dims = MatmulResampleDims(
        q_rows=Qr,
        q_cols=Qc,
        band=B,
        region_h=RH,
        region_w=RW,
        src_h=src_h,
        src_w=src_w,
        ry0=tuple(int(v) for v in ry0),
        rx0=tuple(int(v) for v in rx0),
        col_band=BC if BC <= 16 else 0,
    )
    return plan, dims


def resample(gray: jnp.ndarray, plan: MatmulResamplePlan, dims: MatmulResampleDims):
    """gray: (src_h, src_w) u8/f32 -> (64, Qr, Qc) f32 bilinear samples."""
    n_sq, Qr, Qc = plan.fx.shape
    B, RH, RW = dims.band, dims.region_h, dims.region_w
    gf = gray.astype(jnp.float32)

    # 0. Static region slices (calibration constants -> plain lax.slice).
    regions = jnp.stack(
        [
            jax.lax.slice(gf, (dims.ry0[s], dims.rx0[s]), (dims.ry0[s] + RH, dims.rx0[s] + RW))
            for s in range(n_sq)
        ]
    )  # (64, RH, RW)

    BC = dims.col_band
    if BC:
        # 1a. Row-select matmul, B-MAJOR rows:
        #     Band[s, b*Qr+j, v] = regions[s, row_base[s,j]+b, v]
        # B-major keeps every later tap access a static CONTIGUOUS slice
        # (j-major interleaved the 2-wide tap dim into the second-minor
        # dimension, which cost relayout copies every step).
        rows_iota = jax.lax.broadcasted_iota(jnp.int32, (n_sq, B, Qr, RH), 3)
        want = plan.row_base[:, None, :, None] + jax.lax.broadcasted_iota(
            jnp.int32, (n_sq, B, Qr, RH), 1
        )
        rowsel = (rows_iota == want).astype(jnp.float32).reshape(n_sq, B * Qr, RH)
        band = jax.lax.dot_general(
            rowsel, regions, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (64, B*Qr, RW)

        # 2a. Column-SELECT matmul: the 0/1 one-hot is shared across all
        # rows of a square (the col band covers the homography's x-shear
        # over the square height), so this is ONE per-square
        # (B*Qr, RW) @ (RW, BC*Qc) matmul. The selection matrix is exact
        # (0/1) and the samples are integer-valued u8, so the products are
        # exact at any matmul precision (TF32 included); the fractional
        # lerp runs elementwise in f32 below.
        # Tap-major, Qc-minor layout: Qc must stay the minor dim — a
        # (..., Qc, BC) layout puts BC=2-4 minor.
        v_iota = jax.lax.broadcasted_iota(jnp.int32, (n_sq, RW, BC * Qc), 1)
        wantc = (
            plan.col_base[:, None, :]
            + jax.lax.broadcasted_iota(jnp.int32, (n_sq, BC, Qc), 1)
        ).reshape(n_sq, 1, BC * Qc)
        colsel = (v_iota == wantc).astype(jnp.float32)
        cb = jax.lax.dot_general(
            band, colsel, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # (64, B*Qr, BC*Qc) — stays 3-D; taps are lane/sublane blocks

        # 3a. Bilinear lerp with PRECOMPUTED weights (plan.hw/plan.vw) and
        # static tap slices. Fixed-order unrolled sums (taps are small
        # statics): a reduce over a tap axis can be tiled/reassociated
        # differently by the scan vs single-step programs, flipping
        # .5-boundary u8 rounds and breaking step_many's scan-exactness.
        g = jnp.zeros((n_sq, B * Qr, Qc), jnp.float32)
        for c in range(BC):
            tap = jax.lax.slice(cb, (0, 0, c * Qc), (n_sq, B * Qr, (c + 1) * Qc))
            g = g + tap * plan.hw[c]
        out = jnp.zeros((n_sq, Qr, Qc), jnp.float32)
        for b in range(B):
            row = jax.lax.slice(g, (0, b * Qr, 0), (n_sq, (b + 1) * Qr, Qc))
            out = out + row * plan.vw[b]
        return jnp.where(plan.zero_mask, 0.0, out)

    # 1b/2b. Per-row column-weight matmul (fallback for pathological
    # shear where the shared column band would be too wide).
    rows_iota = jax.lax.broadcasted_iota(jnp.int32, (n_sq, Qr, B, RH), 3)
    want = plan.row_base[:, :, None, None] + jax.lax.broadcasted_iota(
        jnp.int32, (n_sq, Qr, B, RH), 2
    )
    rowsel = (rows_iota == want).astype(jnp.float32).reshape(n_sq, Qr * B, RH)
    band = jax.lax.dot_general(
        rowsel, regions, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # (64, Qr*B, RW)
    band = band.reshape(n_sq, Qr, B, RW)
    v_iota = jax.lax.broadcasted_iota(jnp.int32, (n_sq, Qr, RW, Qc), 2)
    ci = plan.col_ix[:, :, None, :]
    fxw = plan.fx[:, :, None, :]
    colw = jnp.where(v_iota == ci, 1.0 - fxw, 0.0) + jnp.where(
        v_iota == ci + 1, fxw, 0.0
    )
    # Fractional weights: HIGHEST keeps the f32 products exact where the
    # default f32 dot would round its operands (TF32 on GPUs).
    g = jax.lax.dot_general(
        band.reshape(n_sq * Qr, B, RW),
        colw.reshape(n_sq * Qr, RW, Qc),
        (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).reshape(n_sq, Qr, B, Qc)

    # 3b. Vertical lerp over the band rows.
    b_iota = jax.lax.broadcasted_iota(jnp.int32, (n_sq, Qr, B, Qc), 2)
    uy = plan.uy_off[:, :, None, :]
    fyw = plan.fy[:, :, None, :]
    wv = jnp.where(b_iota == uy, 1.0 - fyw, 0.0) + jnp.where(b_iota == uy + 1, fyw, 0.0)
    out = jnp.sum(g * wv, axis=2)
    return jnp.where(plan.zero_mask, 0.0, out)


def resample_gray_u8(gray_frame: jnp.ndarray, plan, dims) -> jnp.ndarray:
    """u8 output with the pipeline's round-clip convention."""
    return jnp.clip(jnp.round(resample(gray_frame, plan, dims)), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Board-level color warp (the with_enhancer path)
# ---------------------------------------------------------------------------


def assemble_board_from_tiles(tiles: jnp.ndarray, starts, board_size: int) -> jnp.ndarray:
    """Invert BoardGeometry.board_tile_query_coords's overlapping 8x8 tiling.

    tiles: (64, T, T); tile t = r*8+c covers board rows
    starts[r]:starts[r]+T, cols starts[c]:starts[c]+T. Each board pixel is
    taken from the tile that *owns* it (row block r owns rows
    [r*T, (r+1)*T) clipped to B), so the overlap rows/cols of the last
    tiles are dropped. Static slices + concatenate only — no gathers.
    """
    B = board_size
    T = tiles.shape[-1]
    row_blocks = []
    for r in range(8):
        o0, o1 = r * T, min((r + 1) * T, B)
        lr0 = o0 - starts[r]
        cols = []
        for c in range(8):
            p0, p1 = c * T, min((c + 1) * T, B)
            lc0 = p0 - starts[c]
            t = tiles[r * 8 + c]
            cols.append(t[lr0 : lr0 + (o1 - o0), lc0 : lc0 + (p1 - p0)])
        row_blocks.append(jnp.concatenate(cols, axis=1))
    return jnp.concatenate(row_blocks, axis=0)


def warp_board_color(
    planar_frame: jnp.ndarray, plan: MatmulResamplePlan, dims: MatmulResampleDims,
    starts, board_size: int,
) -> jnp.ndarray:
    """(3, Hf, Wf) u8 frame -> (3, B, B) u8 warped board, matmuls only.

    Channel-wise bilinear via the tile plan (build_plan over
    board_tile_query_coords) + static reassembly. Same arithmetic as the
    exact HWC gather warp (ops/warp.warp_bilinear) up to f32 associativity:
    <=1 intensity level on <1% of pixels.
    """
    out = []
    for c in range(planar_frame.shape[0]):
        tiles = jnp.clip(jnp.round(resample(planar_frame[c], plan, dims)), 0, 255)
        out.append(assemble_board_from_tiles(tiles.astype(jnp.uint8), starts, board_size))
    return jnp.stack(out)
