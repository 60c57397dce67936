"""Spatial filters matching OpenCV u8 arithmetic.

Covers the reference's cv2 filter calls: GaussianBlur (change_detector.py
_preprocess, piece_detector.py _preprocess_square, frame_enhancer.py
prepare_analysis), filter2D sharpen (frame_enhancer.py sharpen), normalize
MINMAX (frame_enhancer.py normalize_intensity), and Sobel (for the Hough
gradient stage).

Gaussian on u8 is reproduced bit-exactly via the same 8-bit fixed-point
separable scheme OpenCV uses (kernel quantized to 1/256 steps, combined
rounding shift of 16 bits). Borders are BORDER_REFLECT_101 (OpenCV default),
which equals numpy/jnp 'reflect' padding.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _reflect101_pad(x: jnp.ndarray, r: int, axes=(-2, -1)) -> jnp.ndarray:
    pad = [(0, 0)] * x.ndim
    for ax in axes:
        pad[ax % x.ndim] = (r, r)
    return jnp.pad(x, pad, mode="reflect")


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, normalized).

    For sigma<=0 and ksize in {1,3,5,7} OpenCV uses fixed small-kernel
    tables; otherwise sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        9: [v / 256.0 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)],
    }
    if sigma <= 0 and ksize in small:
        return np.array(small[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(i**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_kernel_u8(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """The 8-bit fixed-point kernel OpenCV's u8 path uses (ints, sum 256)."""
    return np.round(gaussian_kernel(ksize, sigma) * 256).astype(np.int64)


def _sl2(x, lo, size, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, lo + size)
    return x[tuple(idx)]


@partial(jax.jit, static_argnums=(1,))
def _gauss_u8(x, kq):
    r = len(kq) // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = _reflect101_pad(x.astype(jnp.int32), r)
    tmp = sum(kq[i] * _sl2(xp, i, w, -1) for i in range(len(kq)))
    out = sum(kq[i] * _sl2(tmp, i, h, -2) for i in range(len(kq)))
    return ((out + (1 << 15)) >> 16).astype(jnp.uint8)


def gaussian_blur(x: jnp.ndarray, ksize: int, sigma: float = 0.0) -> jnp.ndarray:
    """Exact cv2.GaussianBlur for u8 single-channel images (..., H, W)."""
    kq = tuple(int(v) for v in gaussian_kernel_u8(ksize, sigma))
    return _gauss_u8(x, kq)


@partial(jax.jit, static_argnums=(1,))
def _gauss_u8_valid(x, kq):
    k = len(kq)
    h = x.shape[-2] - (k - 1)
    w = x.shape[-1] - (k - 1)
    xi = x.astype(jnp.int32)
    tmp = sum(kq[i] * _sl2(xi, i, w, -1) for i in range(k))
    out = sum(kq[i] * _sl2(tmp, i, h, -2) for i in range(k))
    return ((out + (1 << 15)) >> 16).astype(jnp.uint8)


def gaussian_blur_valid(
    x: jnp.ndarray, ksize: int, sigma: float = 0.0, pad: int = None
) -> jnp.ndarray:
    """Gaussian blur in 'valid' mode: input already carries its border.

    Used on the squares tensor, whose per-square reflect-101 border is baked
    into the extraction gather (geometry.build_square_maps with
    pad >= ksize//2) so the result equals cv2.GaussianBlur run on each true
    crop. With pad omitted (or == ksize//2) the output simply shrinks by
    ksize-1; a larger ``pad`` (border wider than this kernel needs — e.g.
    geometry built for a bigger change-detector blur kernel) center-crops
    the excess so the output is always the true crop's size.
    """
    kq = tuple(int(v) for v in gaussian_kernel_u8(ksize, sigma))
    out = _gauss_u8_valid(x, kq)
    if pad is not None:
        off = pad - ksize // 2
        if off < 0:
            raise ValueError(f"pad {pad} too small for kernel {ksize}")
        if off:
            out = out[..., off : out.shape[-2] - off, off : out.shape[-1] - off]
    return out


def filter2d_int(x: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Exact cv2.filter2D for u8 images with an integer kernel.

    ``x`` is (..., H, W) or (..., H, W, C); kernel is a small 2-D int array.
    Correlation (not convolution), BORDER_REFLECT_101, saturating u8 output.
    """
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    chan = x.ndim >= 3 and x.shape[-1] <= 4
    axes = (-3, -2) if chan else (-2, -1)
    h = x.shape[axes[0]]
    w = x.shape[axes[1]]
    xp = _reflect101_pad(x.astype(jnp.int32), ry, axes=(axes[0],))
    xp = _reflect101_pad(xp, rx, axes=(axes[1],))

    def sl(dy, dx):
        idx = [slice(None)] * x.ndim
        idx[axes[0]] = slice(dy, dy + h)
        idx[axes[1]] = slice(dx, dx + w)
        return xp[tuple(idx)]

    acc = None
    for dy in range(kh):
        for dx in range(kw):
            c = int(kernel[dy, dx])
            if c == 0:
                continue
            term = c * sl(dy, dx)
            acc = term if acc is None else acc + term
    return jnp.clip(acc, 0, 255).astype(jnp.uint8)


_SHARPEN_KERNEL = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]])


def sharpen(x: jnp.ndarray) -> jnp.ndarray:
    """The reference's 3x3 sharpen (frame_enhancer.py:40-42), exact."""
    return filter2d_int(x, _SHARPEN_KERNEL)


def normalize_minmax(x: jnp.ndarray, alpha: float = 0.0, beta: float = 255.0) -> jnp.ndarray:
    """Exact cv2.normalize(..., NORM_MINMAX) on u8 (joint min/max over all).

    Constant images (mx == mn) produce all-alpha, matching cv2's
    saturate_cast of the 0*inf NaN to 0 — the naive scale formula would
    propagate NaN into the u8 cast (platform-dependent)."""
    xf = x.astype(jnp.float32)
    mn = jnp.min(xf)
    mx = jnp.max(xf)
    scale = (beta - alpha) / jnp.maximum(mx - mn, 1e-38)
    out = jnp.where(mx > mn, (xf - mn) * scale + alpha, jnp.float32(alpha))
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def sobel3(x: jnp.ndarray, border: str = "replicate"):
    """3x3 Sobel dx, dy on u8 (..., H, W) -> int32 pair.

    border='replicate' matches the Sobel inside cv2.Canny; 'reflect101'
    matches a plain cv2.Sobel call (default border), used by the Hough
    voting stage.
    """
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * x.ndim
    pad[-2] = pad[-1] = (1, 1)
    mode = "edge" if border == "replicate" else "reflect"
    xp = jnp.pad(x.astype(jnp.int32), pad, mode=mode)

    def sl(dy, dx):
        idx = [slice(None)] * x.ndim
        idx[-2] = slice(dy, dy + h)
        idx[-1] = slice(dx, dx + w)
        return xp[tuple(idx)]

    p00, p01, p02 = sl(0, 0), sl(0, 1), sl(0, 2)
    p10, p12 = sl(1, 0), sl(1, 2)
    p20, p21, p22 = sl(2, 0), sl(2, 1), sl(2, 2)
    dx = (p02 + 2 * p12 + p22) - (p00 + 2 * p10 + p20)
    dy = (p20 + 2 * p21 + p22) - (p00 + 2 * p01 + p02)
    return dx, dy
