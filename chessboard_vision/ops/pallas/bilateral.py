"""Bilateral filter (d=9, sigma 75/75) as a Pallas kernel on the Triton route.

The bilateral is the enhancement pipeline's heaviest stencil: 69
circle-masked taps, each with a per-pixel color-distance exp weight that
all three channels share. One program owns a (BH, BW) output tile: it
loads the 69 shifted neighborhoods of the reflect-padded input straight
from global memory (the halo is re-read through L1/L2), computes each
tap's weight once for the three channels, and keeps num/den in
registers. The tap order and arithmetic are those of
ops/enhance.bilateral_planar, so the two agree up to exp-evaluation ulps.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Output tile and warps: the fastest of the tiles measured at (3, 980, 980)
# on an H100 (PERF.md).
BLOCK_H = 16
BLOCK_W = 32
NUM_WARPS = 8


def _taps(d: int, sigma_space: float):
    """(dy, dx, space weight) for every tap inside the d//2 disk, in the
    dy-major order of ops/enhance.bilateral_planar."""
    radius = d // 2
    gs = -0.5 / (sigma_space * sigma_space)
    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            rr = dy * dy + dx * dx
            if np.sqrt(rr) > radius:
                continue
            out.append((dy, dx, float(np.exp(rr * gs))))
    return tuple(out)


def _round_half_even(x):
    """jnp.round for values in [0, 256), from floor (the Triton route has
    no round primitive): a .5 tie goes to the even neighbour."""
    r = jnp.floor(x + 0.5)
    odd = jnp.floor(r * 0.5) != r * 0.5
    return jnp.where((r - x == 0.5) & odd, r - 1.0, r)


def _kernel(x_ref, o_ref, *, taps, radius, gc, height, width):
    y0 = pl.program_id(0) * BLOCK_H
    x0 = pl.program_id(1) * BLOCK_W

    def load(c, dy, dx):
        blk = x_ref[c, pl.ds(y0 + radius + dy, BLOCK_H), pl.ds(x0 + radius + dx, BLOCK_W)]
        return blk.astype(jnp.float32)

    center = [load(c, 0, 0) for c in range(3)]
    num = [jnp.zeros((BLOCK_H, BLOCK_W), jnp.float32) for _ in range(3)]
    den = jnp.zeros((BLOCK_H, BLOCK_W), jnp.float32)
    for dy, dx, sw in taps:
        nb = [load(c, dy, dx) for c in range(3)]
        cd = jnp.abs(nb[0] - center[0]) + jnp.abs(nb[1] - center[1]) + jnp.abs(nb[2] - center[2])
        w = sw * jnp.exp(cd * cd * gc)
        num = [num[c] + w * nb[c] for c in range(3)]
        den = den + w
    rows = y0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_H, BLOCK_W), 0)
    cols = x0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_H, BLOCK_W), 1)
    inside = (rows < height) & (cols < width)
    for c in range(3):
        res = jnp.clip(_round_half_even(num[c] / den), 0, 255).astype(jnp.int32).astype(jnp.uint8)
        plgpu.store(
            o_ref.at[c, pl.ds(y0, BLOCK_H), pl.ds(x0, BLOCK_W)], res, mask=inside
        )


@partial(jax.jit, static_argnames=("d", "sigma_color", "sigma_space", "interpret"))
def bilateral_planar_triton(
    img: jnp.ndarray,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    interpret: bool = False,
) -> jnp.ndarray:
    """Drop-in for ops.enhance.bilateral_planar on (3, H, W) u8."""
    C, H, W = img.shape
    radius = d // 2
    gh = pl.cdiv(H, BLOCK_H)
    gw = pl.cdiv(W, BLOCK_W)
    # Reflect-101 halo, then zero fill so every tile's loads stay in range
    # (those pixels only feed outputs the masked store drops).
    padded = jnp.pad(img, ((0, 0), (radius, radius), (radius, radius)), mode="reflect")
    padded = jnp.pad(padded, ((0, 0), (0, gh * BLOCK_H - H), (0, gw * BLOCK_W - W)))
    kernel = partial(
        _kernel, taps=_taps(d, sigma_space), radius=radius,
        gc=-0.5 / (sigma_color * sigma_color), height=H, width=W,
    )
    return pl.pallas_call(
        kernel,
        grid=(gh, gw),
        out_shape=jax.ShapeDtypeStruct((C, H, W), jnp.uint8),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="bilateral_planar",
    )(padded)
