"""Kernel parity checks that need the GPU.

Each check runs the production function on the default device (the card)
and compares it with its plain reference: the same JAX function compiled
for the host CPU, or numpy. The ``gpu``-marked tests call these at small
and real widths; chip_smoke.py calls them in its kernel phases. Each
returns the measured deviation and raises AssertionError past its
tolerance. No OpenCV here: the card's machine need not have it.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision import platform
from chessboard_vision.ops import enhance as enh
from chessboard_vision.ops import hough_conv as hc


def _cpu(fn, *args):
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jax.jit(fn)(*[jnp.asarray(a) for a in args]))


def check_bilateral(shape, seed: int = 0) -> dict:
    """The enhancer's bilateral (the Triton kernel where compiled for CUDA)
    vs the plain XLA form compiled for the same device: <= 1 level (exp
    ulps move a round across .5), on < 1e-4 of the values."""
    x = jnp.asarray(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))
    got = np.asarray(jax.jit(platform.bilateral)(x)).astype(int)
    want = np.asarray(enh.bilateral_planar(x)).astype(int)
    d = np.abs(got - want)
    res = {"max_diff": int(d.max()), "frac_diff": float((d > 0).mean())}
    assert res["max_diff"] <= 1 and res["frac_diff"] < 1e-4, res
    return res


def check_clahe(shape, seed: int = 0) -> dict:
    """CLAHE on the card: tile histograms equal np.bincount exactly, and
    the output equals the CPU compile of the same function except where
    the CPU's f32 LUT mix lies within 1e-3 of a .5 tie (the two compiles
    contract the lerp's multiply-adds differently, a few ulps of 255),
    and there by at most 1 level."""
    x = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    H, W = shape
    th, tw = -(-H // 8), -(-W // 8)
    pad = np.pad(x, ((0, th * 8 - H), (0, tw * 8 - W)), mode="reflect")
    hist = np.asarray(jax.jit(enh.tile_histograms, static_argnums=1)(jnp.asarray(pad), 8))
    ref_hist = np.stack([
        np.bincount(pad[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw].ravel(), minlength=256)
        for ty in range(8) for tx in range(8)
    ])
    assert np.array_equal(hist, ref_hist), "tile histograms differ from np.bincount"
    got = np.asarray(enh.clahe(jnp.asarray(x))).astype(int)

    def mix(img):
        luts, th_, tw_ = enh.clahe_lut_inputs(img)
        return enh.lut_mix(img, luts, th_, tw_, 8)

    ref_mix = _cpu(mix, x).astype(np.float64)
    want = np.clip(np.round(ref_mix), 0, 255).astype(int)
    near_tie = np.abs(ref_mix - np.floor(ref_mix) - 0.5) < 1e-3
    d = np.abs(got - want)
    res = {"max_diff": int(d.max()), "n_diff": int((d > 0).sum()),
           "n_diff_off_tie": int(((d > 0) & ~near_tie).sum())}
    assert res["max_diff"] <= 1 and res["n_diff_off_tie"] == 0, res
    return res


def check_score_matmul(basis, planes, n_streams: int = 1) -> dict:
    """The Hough score product (bf16 operands, f32 accumulation) vs an f32
    numpy product. bf16 x bf16 products are exact in f32, so only the
    summation order differs: the bound is K * eps_f32 * sum |terms|.
    With n_streams > 1 the product runs under vmap over streams with the
    basis unbatched, as the batched pipeline runs it."""
    basis = jnp.asarray(basis, jnp.bfloat16)
    planes = jnp.asarray(planes, jnp.bfloat16)
    b32 = np.asarray(basis.astype(jnp.float32))
    k = b32.shape[1]
    if n_streams > 1:
        got = np.asarray(jax.jit(jax.vmap(hc.score_matmul, in_axes=(None, 0)))(basis, planes))
    else:
        got = np.asarray(jax.jit(hc.score_matmul)(basis, planes))[None]
        planes = planes[None]
    worst = 0.0
    for s in range(got.shape[0]):
        p32 = np.asarray(planes[s].astype(jnp.float32))
        want = b32 @ p32.T
        bound = k * np.finfo(np.float32).eps * (np.abs(b32) @ np.abs(p32).T) + 1e-30
        worst = max(worst, float((np.abs(got[s] - want) / bound).max()))
    res = {"err_over_bound": worst}
    assert worst <= 1.0, res
    return res
