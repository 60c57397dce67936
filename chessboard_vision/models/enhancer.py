"""Image enhancer model: the reference's 5-stage pipeline on device.

Behavioral equivalent of reference frame_enhancer.py ImageEnhancer:
(0) HSV color-profile remap, (1) CLAHE clip=3.0 8x8 on LAB-L,
(2) bilateral d=9 sigma 75/75, (3) 3x3 sharpen, (4) min-max normalize;
plus prepare_analysis (gray -> Gaussian 5x5 -> Otsu). The whole
process_pipeline is ONE jitted device call on a planar (3, H, W) frame.

Backend seam (reference frame_enhancer.py:184-190's Cython-else-Python
alias): models.backend selects this device enhancer or the cv2 oracle.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision import platform
from chessboard_vision.ops import color as color_ops
from chessboard_vision.ops import enhance as enh_ops
from chessboard_vision.ops.filters import gaussian_blur, sharpen, normalize_minmax
from chessboard_vision.ops.threshold import otsu_binarize
from chessboard_vision.ops.static_resample import to_planar
from chessboard_vision.utils.config import COLOR_PROFILE_FILE, load_json_config

DEFAULT_PROFILE = {
    "hue_shift": 0,
    "sat_scale": 1.0,
    "val_scale": 1.0,
    "contrast": 1.0,
    "brightness": 0,
    "radical_mode": 0,
    "target_hue": 0,
    "hue_window": 20,
}


def _hwc(planar):
    return jnp.moveaxis(planar, 0, -1)


def _planar(hwc):
    return jnp.moveaxis(hwc, -1, 0)


def apply_color_profile(planar: jnp.ndarray, profile: dict) -> jnp.ndarray:
    """HSV remap stage (reference frame_enhancer.py:56-99) on (3, H, W) u8."""
    if not profile:
        return planar
    p = {**DEFAULT_PROFILE, **profile}
    x = color_ops.convert_scale_abs(planar, p["contrast"], p["brightness"])
    hsv = color_ops.bgr2hsv(_hwc(x)).astype(jnp.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    if p["radical_mode"]:
        h_dist = jnp.abs(h - p["target_hue"])
        h_dist = jnp.minimum(h_dist, 180.0 - h_dist)
        mask = h_dist < p["hue_window"]
        s = jnp.where(mask, s * 2.0, s * 0.5)
    h = jnp.mod(h + p["hue_shift"], 180.0)
    s = s * p["sat_scale"]
    v = v * p["val_scale"]
    h = jnp.clip(h, 0, 179)
    s = jnp.clip(s, 0, 255)
    v = jnp.clip(v, 0, 255)
    hsv_u8 = jnp.stack([h, s, v], axis=-1).astype(jnp.uint8)
    return _planar(color_ops.hsv2bgr(hsv_u8))


def enhance_planar(
    planar: jnp.ndarray,
    profile: Optional[dict] = None,
    clahe_clip: float = 3.0,
    clahe_tiles: int = 8,
) -> jnp.ndarray:
    """The full 5-stage enhancement on a (3, H, W) u8 planar image.

    Free-function form of the reference process_pipeline
    (frame_enhancer.py:161-181): color profile -> CLAHE on LAB-L ->
    bilateral -> sharpen -> min-max normalize. Pure and jit-safe — used by
    ImageEnhancerJax and fused ahead of detection by
    VisionPipeline(with_enhancer=True).
    """
    x = apply_color_profile(planar, profile or {})
    # Planar-native Lab round trip: bit-equal to the HWC forms per pixel
    # and transpose-free by construction.
    lab = color_ops.planar_bgr2lab(x)
    l_enh = enh_ops.clahe(lab[0], clahe_clip, clahe_tiles)
    lab2 = jnp.concatenate([l_enh[None], lab[1:]], axis=0)
    x = color_ops.planar_lab2bgr(lab2)
    x = platform.bilateral(x)
    x = sharpen(x)
    return normalize_minmax(x)


class ImageEnhancerJax:
    """Drop-in enhancer with the reference ImageEnhancer API (device-backed)."""

    def __init__(
        self,
        clahe_clip_limit: float = 3.0,
        tile_grid_size=(8, 8),
        profile: Optional[dict] = None,
        load_profile_file: bool = False,
    ):
        self.clip = float(clahe_clip_limit)
        self.tiles = int(tile_grid_size[0])
        if profile is None and load_profile_file:
            profile = load_json_config(COLOR_PROFILE_FILE, {})
        self.profile = dict(profile) if profile else {}
        self._pipeline_j = jax.jit(self._pipeline_impl)
        self._analysis_j = jax.jit(self._analysis_impl)

    # -- stages (device) --------------------------------------------------

    def _correct_lighting(self, planar):
        lab = color_ops.planar_bgr2lab(planar)
        l_enh = enh_ops.clahe(lab[0], self.clip, self.tiles)
        lab2 = jnp.concatenate([l_enh[None], lab[1:]], axis=0)
        return color_ops.planar_lab2bgr(lab2)

    def _pipeline_impl(self, planar):
        return enhance_planar(
            planar, self.profile, self.clip, self.tiles
        )

    def _analysis_impl(self, planar):
        gray = color_ops.bgr2gray(_hwc(planar))
        blurred = gaussian_blur(gray, 5)
        _, binary = otsu_binarize(blurred)
        return gray, binary

    # -- reference-compatible API (HWC numpy in/out) ----------------------

    def apply_color_profile(self, frame):
        out = apply_color_profile(jnp.asarray(to_planar(frame)), self.profile)
        return np.asarray(_hwc(out))

    def correct_lighting(self, frame):
        return np.asarray(_hwc(self._correct_lighting(jnp.asarray(to_planar(frame)))))

    def reduce_noise(self, frame):
        return np.asarray(
            _hwc(platform.bilateral(jnp.asarray(to_planar(frame))))
        )

    def sharpen(self, frame):
        return np.asarray(_hwc(sharpen(jnp.asarray(to_planar(frame)))))

    def normalize_intensity(self, frame):
        return np.asarray(_hwc(normalize_minmax(jnp.asarray(to_planar(frame)))))

    def prepare_analysis(self, frame):
        gray, binary = self._analysis_j(jnp.asarray(to_planar(frame)))
        return np.asarray(gray), np.asarray(binary)

    def process_pipeline(self, frame):
        out = self._pipeline_j(jnp.asarray(to_planar(frame)))
        return np.asarray(_hwc(out))

    # device-native entry (planar in, planar out, fully fused)
    def process_planar(self, planar: jnp.ndarray) -> jnp.ndarray:
        return self._pipeline_j(planar)
