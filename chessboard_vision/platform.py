"""Implementation choices that depend on the platform JAX compiles for.

Every such choice lives here, decided from what the process observes, not
from user options. Each was measured on an H100 (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from chessboard_vision.ops.enhance import bilateral_planar
from chessboard_vision.ops.pallas.bilateral import bilateral_planar_triton


def default_hough_backend() -> str:
    """The Hough backend ``hough_backend='auto'`` resolves to: the
    annular-correlation ``conv`` on accelerators, where it agrees with the
    exact transform and runs far faster; the ``exact`` voting transform on
    the CPU, which is bit-for-bit with the cv2 oracle the parity tests
    compare against."""
    return "exact" if jax.default_backend() == "cpu" else "conv"


def bilateral(img: jnp.ndarray) -> jnp.ndarray:
    """The enhancer's bilateral (d=9, sigma 75/75) on (3, H, W) u8: the
    Triton kernel where the program is compiled for CUDA, the XLA form
    everywhere else. Both produce the same values up to exp ulps."""
    return jax.lax.platform_dependent(
        img, cuda=bilateral_planar_triton, default=bilateral_planar
    )
