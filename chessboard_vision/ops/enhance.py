"""Enhancement kernels: CLAHE and bilateral filter.

The reference's enhancement pipeline (frame_enhancer.py:101-181) applies
CLAHE (clip 3.0, 8x8 tiles) to the LAB L channel, a bilateral filter
(d=9, sigma 75/75), a 3x3 sharpen, and min-max normalization. Parity:
within 1 intensity level of OpenCV (tie-rounding in LUT/weight math);
structure and constants match exactly.

CLAHE builds its per-tile histograms with one scatter-add and applies the
LUTs with four table gathers per pixel. The bilateral is a 69-tap shifted
accumulation with on-the-fly Gaussian weights.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def clahe_luts_from_hist(
    hist: jnp.ndarray, area: int, clip_abs: int
) -> jnp.ndarray:
    """(n_tiles, 256) i32 histograms -> (n_tiles, 256) f32 integer-valued
    LUTs: clip + OpenCV's two-phase excess redistribution + scaled CDF
    (the CLAHE mid phase)."""
    n_tiles = hist.shape[0]
    excess = jnp.sum(jnp.maximum(hist - clip_abs, 0), axis=-1)
    hist = jnp.minimum(hist, clip_abs)
    batch = excess // 256
    resid = excess - batch * 256
    hist = hist + batch[:, None]
    step = jnp.maximum(256 // jnp.maximum(resid, 1), 1)
    bins = jax.lax.broadcasted_iota(jnp.int32, (n_tiles, 256), 1)
    bump = ((bins % step[:, None]) == 0) & ((bins // step[:, None]) < resid[:, None])
    hist = hist + bump.astype(jnp.int32)

    cdf = jnp.cumsum(hist, axis=-1)
    scale = jnp.float32(255.0 / area)
    return jnp.clip(jnp.round(cdf.astype(jnp.float32) * scale), 0, 255)


def tile_histograms(pad: jnp.ndarray, tiles: int) -> jnp.ndarray:
    """(tiles*th, tiles*tw) u8 -> (tiles*tiles, 256) i32 per-tile
    histograms, as one scatter-add of ones at (tile, value)."""
    Hp, Wp = pad.shape
    th, tw = Hp // tiles, Wp // tiles
    ty = jax.lax.broadcasted_iota(jnp.int32, (Hp, Wp), 0) // th
    tx = jax.lax.broadcasted_iota(jnp.int32, (Hp, Wp), 1) // tw
    bins = (ty * tiles + tx) * 256 + pad.astype(jnp.int32)
    hist = jnp.zeros((tiles * tiles * 256,), jnp.int32).at[bins.reshape(-1)].add(1)
    return hist.reshape(tiles * tiles, 256)


def lut_mix(img: jnp.ndarray, luts: jnp.ndarray, th: int, tw: int, tiles: int) -> jnp.ndarray:
    """f32 bilinear mix of the four neighbour-tile LUTs at each pixel's
    value, in OpenCV's order of operations (CLAHE_Interpolation_Body): two
    horizontal lerps, then the vertical one."""
    H, W = img.shape
    inv_th = np.float32(1.0 / th)
    inv_tw = np.float32(1.0 / tw)
    tyf = jax.lax.broadcasted_iota(jnp.float32, (H, 1), 0) * inv_th - 0.5
    txf = jax.lax.broadcasted_iota(jnp.float32, (1, W), 1) * inv_tw - 0.5
    ty1 = jnp.floor(tyf)
    tx1 = jnp.floor(txf)
    ya = tyf - ty1
    xa = txf - tx1
    ty1 = ty1.astype(jnp.int32)
    tx1 = tx1.astype(jnp.int32)
    ty2 = jnp.minimum(ty1 + 1, tiles - 1)
    tx2 = jnp.minimum(tx1 + 1, tiles - 1)
    ty1 = jnp.maximum(ty1, 0)
    tx1 = jnp.maximum(tx1, 0)
    flat = luts.reshape(-1)
    v = img.astype(jnp.int32)

    def lut(ty, tx):
        return flat[(ty * tiles + tx) * 256 + v]

    top = lut(ty1, tx1) * (1.0 - xa) + lut(ty1, tx2) * xa
    bot = lut(ty2, tx1) * (1.0 - xa) + lut(ty2, tx2) * xa
    return top * (1.0 - ya) + bot * ya


def clahe_lut_inputs(img: jnp.ndarray, clip_limit: float = 3.0, tiles: int = 8):
    """(luts, th, tw) for ``img``: histograms of the reflect-101 padded
    image (OpenCV pads to a multiple of the tile grid), clipped and
    redistributed into per-tile LUTs."""
    H, W = img.shape
    th = -(-H // tiles)
    tw = -(-W // tiles)
    pad = jnp.pad(img, ((0, th * tiles - H), (0, tw * tiles - W)), mode="reflect")
    area = th * tw
    clip_abs = max(int(clip_limit * area / 256), 1)
    return clahe_luts_from_hist(tile_histograms(pad, tiles), area, clip_abs), th, tw


@partial(jax.jit, static_argnames=("clip_limit", "tiles"))
def clahe(img: jnp.ndarray, clip_limit: float = 3.0, tiles: int = 8) -> jnp.ndarray:
    """cv2.createCLAHE(clip, (tiles, tiles)).apply for u8 (H, W) images:
    LUTs from the padded image's tile histograms, mixed per pixel of the
    unpadded image and rounded half-to-even."""
    luts, th, tw = clahe_lut_inputs(img, clip_limit, tiles)
    res = lut_mix(img, luts, th, tw, tiles)
    return jnp.clip(jnp.round(res), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Bilateral filter
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("d", "sigma_color", "sigma_space"))
def bilateral_planar(
    img: jnp.ndarray, d: int = 9, sigma_color: float = 75.0, sigma_space: float = 75.0
) -> jnp.ndarray:
    """cv2.bilateralFilter for u8 planar (3, H, W) images (69 taps of the
    9x9 window inside the disk of radius d//2).

    Space weights on that disk; color weight from the L1 color distance,
    exp evaluated per tap (OpenCV tabulates the same function; parity
    within 1 level from ulp differences).
    """
    radius = d // 2
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)

    C, H, W = img.shape
    pad = jnp.pad(img, ((0, 0), (radius, radius), (radius, radius)), mode="reflect")
    center = img.astype(jnp.float32)

    num = jnp.zeros((C, H, W), jnp.float32)
    den = jnp.zeros((H, W), jnp.float32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            rr = dy * dy + dx * dx
            if np.sqrt(rr) > radius:
                continue
            sw = float(np.exp(rr * gs))
            nb = pad[:, radius + dy : radius + dy + H, radius + dx : radius + dx + W].astype(
                jnp.float32
            )
            cd = jnp.sum(jnp.abs(nb - center), axis=0)
            w = sw * jnp.exp(cd * cd * gc)
            num = num + w[None] * nb
            den = den + w
    out = num / den[None]
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

