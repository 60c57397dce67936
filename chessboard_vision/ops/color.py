"""Color-space conversions matching OpenCV's u8 arithmetic.

The reference pipeline converts colors via cv2.cvtColor (frame_enhancer.py,
piece_detector.py, change_detector.py). OpenCV's u8 conversions are
fixed-point with small lookup tables; we reproduce them so the device path is
bit-exact (gray, BGR->HSV) or within 1 intensity level (HSV->BGR, LAB
round-trip — enhancement-only stages).

Convention: images are (..., H, W, 3) u8 in BGR channel order (OpenCV's),
or (..., H, W) u8 for grayscale. Outputs keep u8 unless noted.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# BGR -> GRAY
# OpenCV 5 u8 path: Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
# (verified bit-exact against cv2.cvtColor COLOR_BGR2GRAY).
# ---------------------------------------------------------------------------

_R2Y, _G2Y, _B2Y, _GRAY_SHIFT = 9798, 19235, 3735, 15


def bgr2gray(bgr: jnp.ndarray) -> jnp.ndarray:
    """Exact cv2.COLOR_BGR2GRAY for u8 images."""
    x = bgr.astype(jnp.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(jnp.uint8)


def planar_bgr2gray(planar: jnp.ndarray) -> jnp.ndarray:
    """Exact cv2.COLOR_BGR2GRAY for (..., 3, H, W) planar u8 frames (the
    pipeline's device frame layout).

    Channels are sliced BEFORE the i32 conversion: converting the whole
    (..., 3, H, W) frame first made XLA materialize the full-resolution
    s32 copy in the vmapped (multi-stream) program (199 MB per tick at
    8x1080p), where slice-then-convert fuses to the u8 gray output
    directly. Same integer arithmetic, bit-identical."""
    b = planar[..., 0, :, :].astype(jnp.int32)
    g = planar[..., 1, :, :].astype(jnp.int32)
    r = planar[..., 2, :, :].astype(jnp.int32)
    y = (r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# BGR -> HSV (u8, H in [0,180))
# OpenCV fixed-point with 12-bit division tables (verified bit-exact).
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


def _round_div(num: int, den: jnp.ndarray) -> jnp.ndarray:
    """round(num / den) for positive i32 den, 0 where den == 0 — exact
    integer form of cv2's sdiv/hdiv tables without a per-pixel gather
    (it stays elementwise and fuses). No .5 ties exist
    for these numerators (2*num has only 2^k*3*5*17 factors; a den <= 255
    can never make the doubled quotient odd), so floor((2n + d)/(2d))
    equals the tables' np.round exactly."""
    d = jnp.maximum(den, 1)
    return jnp.where(den > 0, (2 * num + d) // (2 * d), 0)


def bgr2hsv(bgr: jnp.ndarray) -> jnp.ndarray:
    """Exact cv2.COLOR_BGR2HSV for u8 images (gather-free fixed point)."""
    x = bgr.astype(jnp.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = jnp.maximum(jnp.maximum(b, g), r)
    vmin = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - vmin
    sdiv = _round_div(255 << _HSV_SHIFT, v)
    s = (diff * sdiv + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    vr = v == r
    vg = jnp.logical_and(~vr, v == g)
    h0 = jnp.where(vr, g - b, jnp.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    hdiv = _round_div((180 << _HSV_SHIFT) // 6, diff)
    h = (h0 * hdiv + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = jnp.where(h < 0, h + 180, h)
    return jnp.stack([h, s, v], axis=-1).astype(jnp.uint8)


# Sector -> (b, g, r) source index into the value table [v, p, q, t].
_HSV_SECTOR = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.int32
)


def hsv2bgr(hsv: jnp.ndarray) -> jnp.ndarray:
    """cv2.COLOR_HSV2BGR for u8 (float path; parity within 1 level).

    The sector lookup runs as compare-selects (18 elementwise wheres),
    not a per-pixel gather, so it fuses with its neighbours; this sits on
    the per-frame path whenever a color profile is active."""
    h = hsv[..., 0].astype(jnp.float32) * jnp.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    sector = jnp.floor(h)
    frac = h - sector
    sector = jnp.mod(sector.astype(jnp.int32), 6)
    tab = (v, v * (1 - s), v * (1 - s * frac), v * (1 - s * (1 - frac)))

    def chan(idx_of_sector):
        out = jnp.zeros_like(v)
        for sec in range(6):
            out = jnp.where(sector == sec, tab[idx_of_sector[sec]], out)
        return out

    bgr = jnp.stack(
        [chan(_HSV_SECTOR[:, c]) for c in range(3)], axis=-1
    )
    return jnp.clip(jnp.round(bgr * 255.0), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# BGR -> LAB (u8), OpenCV fixed-point with sRGB gamma (verified max-1-level,
# ~1e-4 of pixels off by 1 from table-rounding ties).
# ---------------------------------------------------------------------------

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _srgb_inv_gamma(u):
    return np.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


_i = np.arange(256) / 255.0
_GTAB = np.round(_srgb_inv_gamma(_i) * 255 * (1 << _GAMMA_SHIFT)).astype(np.int32)
del _i

_CBRT_N = 3 * 255 * (1 << _GAMMA_SHIFT) + 1
_t = np.arange(_CBRT_N) / (255.0 * (1 << _GAMMA_SHIFT))
_fx = np.where(_t < 0.008856, _t * 7.787 + 0.13793103448275862, np.cbrt(_t))
_CBRT_TAB = np.round(_fx * (1 << _LAB_SHIFT2)).astype(np.int32)
del _t, _fx

_XYZ_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_WHITE = np.array([0.950456, 1.0, 1.088754])
_LAB_C = np.round((_XYZ_M / _WHITE[:, None]) * (1 << _LAB_SHIFT)).astype(np.int64)
for _r in range(3):
    _LAB_C[_r, 2] = (1 << _LAB_SHIFT) - _LAB_C[_r, 0] - _LAB_C[_r, 1]
del _r
_LSCALE = (116 * 255 + 50) // 100
_LSHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# Degree-12 Chebyshev-fit of ((u+0.055)/1.055)^2.4 * 2040 on u in
# [13/255, 1], power basis in s = (u - mid)/half (small, well-conditioned
# coefficients). Fit max error 4.2e-5 table units vs the k>=13 margins'
# floor of 1.6e-3 — round-to-int EXACTLY reproduces _GTAB on every input
# (tests/test_ops_color_filters.py exhausts all 256). k=11,12 sit 7.5e-5
# from a rounding boundary and are selected exactly instead.
_GPOLY_MID = 0.5254902243614197
_GPOLY_INV_HALF = 2.107438087463379
_GPOLY = (
    486.3310546875, 954.09912109375, 545.9364624023438, 59.50480270385742,
    -7.3005690574646, 1.8855336904525757, -0.6479948163032532,
    0.35910487174987793, -0.2089959681034088, -0.04430370032787323,
    0.06115362048149109, 0.09049854427576065, -0.06590192019939423,
)


def _gamma_fixed(x_u8: jnp.ndarray) -> jnp.ndarray:
    """The sRGB inverse-gamma fixed-point table, computed directly.

    Equivalent to _GTAB[x] but gather-free, so it fuses with the
    surrounding elementwise conversion. A 12-FMA Horner polynomial
    instead of pow (= exp(2.4*log u)); reproduces _GTAB exactly on all
    256 inputs (exhaustive test).
    """
    x = x_u8.astype(jnp.float32)
    u = x * jnp.float32(1.0 / 255.0)
    s = (u - jnp.float32(_GPOLY_MID)) * jnp.float32(_GPOLY_INV_HALF)
    acc = jnp.full_like(s, _GPOLY[-1])
    for c in _GPOLY[-2::-1]:
        acc = acc * s + jnp.float32(c)
    out = jnp.where(x_u8 <= 10, u * jnp.float32(255 * (1 << _GAMMA_SHIFT) / 12.92), acc)
    out = jnp.where(x_u8 == 11, jnp.float32(_GTAB[11]), out)
    out = jnp.where(x_u8 == 12, jnp.float32(_GTAB[12]), out)
    return jnp.round(out).astype(jnp.int32)


def fast_cbrt(t: jnp.ndarray) -> jnp.ndarray:
    """f32 cube root for non-negative inputs, division-free.

    Instead of jnp.cbrt's transcendental chain, this is a
    bit-trick seed + 4 Newton steps on the INVERSE cbrt (y -> y*(4/3 -
    t/3*y^3), no divides), then t*y^2. Max relative error 3.7e-7 over
    [0.0089, 3] (the Lab domain) — the same +-1 fixed-point envelope as
    the pow form (exhaustive table test). Inputs are clamped to 1e-20 so
    the unselected lanes of a surrounding jnp.where never overflow.
    """
    t = jnp.maximum(t.astype(jnp.float32), jnp.float32(1e-20))
    bits = jax.lax.bitcast_convert_type(t, jnp.int32)
    y = jax.lax.bitcast_convert_type(
        jnp.int32(0x548C2B4B) - bits // 3, jnp.float32
    )
    third = jnp.float32(1.0 / 3.0)
    four_thirds = jnp.float32(4.0 / 3.0)
    tt = third * t
    for _ in range(4):
        y = y * (four_thirds - tt * (y * y * y))
    return t * (y * y)


def _cbrt_fixed(idx: jnp.ndarray) -> jnp.ndarray:
    """The Lab cube-root fixed-point table, computed directly (gather-free)."""
    t = idx.astype(jnp.float32) * jnp.float32(1.0 / (255 * (1 << _GAMMA_SHIFT)))
    f = jnp.where(
        t < 0.008856,
        t * jnp.float32(7.787) + jnp.float32(0.13793103448275862),
        fast_cbrt(t),
    )
    return jnp.round(f * (1 << _LAB_SHIFT2)).astype(jnp.int32)


def _bgr2lab_channels(b_u8, g_u8, r_u8):
    """Per-channel BGR u8 -> (L, a, b) i32 pre-clip: the layout-free core
    shared by the HWC and planar forms (identical expression tree, so the
    two layouts produce bit-equal values)."""
    B = _gamma_fixed(b_u8)
    G = _gamma_fixed(g_u8)
    R = _gamma_fixed(r_u8)
    C = _LAB_C
    fX = _cbrt_fixed(_descale(R * int(C[0, 0]) + G * int(C[0, 1]) + B * int(C[0, 2]), _LAB_SHIFT))
    fY = _cbrt_fixed(_descale(R * int(C[1, 0]) + G * int(C[1, 1]) + B * int(C[1, 2]), _LAB_SHIFT))
    fZ = _cbrt_fixed(_descale(R * int(C[2, 0]) + G * int(C[2, 1]) + B * int(C[2, 2]), _LAB_SHIFT))
    L = _descale(_LSCALE * fY + _LSHIFT, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return L, a, bb


def bgr2lab(bgr: jnp.ndarray) -> jnp.ndarray:
    """cv2.COLOR_BGR2LAB for u8 (fixed-point; parity within 1 level)."""
    x = bgr.astype(jnp.int32)
    L, a, bb = _bgr2lab_channels(x[..., 0], x[..., 1], x[..., 2])
    lab = jnp.stack([L, a, bb], axis=-1)
    return jnp.clip(lab, 0, 255).astype(jnp.uint8)


def planar_bgr2lab(planar: jnp.ndarray) -> jnp.ndarray:
    """bgr2lab on (..., 3, H, W) planar u8, bit-equal to the HWC form
    per pixel. Lets planar pipelines skip the moveaxis round trip; the
    planar form makes transpose-free conversion a structural guarantee
    rather than a fusion decision."""
    x = planar.astype(jnp.int32)
    L, a, bb = _bgr2lab_channels(
        x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    )
    lab = jnp.stack([L, a, bb], axis=-3)
    return jnp.clip(lab, 0, 255).astype(jnp.uint8)


_XYZ_INV = np.linalg.inv(_XYZ_M)


def _srgb_gamma(u):
    # u^(1/2.4) = sqrt(sqrt(cbrt(u^5))): two hardware sqrts + the
    # division-free fast_cbrt instead of pow's exp/log chain. Same
    # u8-rounding accuracy class as the pow form (dense-grid test).
    u5 = u * u
    u5 = u5 * u5 * u
    p = jnp.sqrt(jnp.sqrt(fast_cbrt(u5)))
    return jnp.where(
        u <= 0.0031308, u * jnp.float32(12.92), 1.055 * p - 0.055
    )


def _lab2bgr_channels(l_u8, a_u8, b_u8):
    """Per-channel Lab u8 -> (B, G, R) f32 in [0, 1] pre-quantization:
    the layout-free core shared by the HWC and planar forms."""
    L = l_u8.astype(jnp.float32) * jnp.float32(100.0 / 255.0)
    a = a_u8.astype(jnp.float32) - 128.0
    b = b_u8.astype(jnp.float32) - 128.0
    fY = (L + 16.0) / 116.0
    fX = fY + a / 500.0
    fZ = fY - b / 200.0

    def finv(f):
        return jnp.where(f > 6.0 / 29.0, f**3, (f - 16.0 / 116.0) / 7.787)

    X = finv(fX) * _WHITE[0]
    Y = finv(fY) * _WHITE[1]
    Z = finv(fZ) * _WHITE[2]
    Minv = jnp.asarray(_XYZ_INV, jnp.float32)
    R = Minv[0, 0] * X + Minv[0, 1] * Y + Minv[0, 2] * Z
    G = Minv[1, 0] * X + Minv[1, 1] * Y + Minv[1, 2] * Z
    B = Minv[2, 0] * X + Minv[2, 1] * Y + Minv[2, 2] * Z
    return B, G, R


def lab2bgr(lab: jnp.ndarray) -> jnp.ndarray:
    """cv2.COLOR_LAB2BGR for u8 (float path; parity within ~1 level)."""
    B, G, R = _lab2bgr_channels(lab[..., 0], lab[..., 1], lab[..., 2])
    rgb = jnp.stack([B, G, R], axis=-1)
    rgb = _srgb_gamma(jnp.clip(rgb, 0.0, 1.0))
    return jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)


def planar_lab2bgr(planar: jnp.ndarray) -> jnp.ndarray:
    """lab2bgr on (..., 3, H, W) planar u8, bit-equal to the HWC form
    per pixel (see planar_bgr2lab)."""
    B, G, R = _lab2bgr_channels(
        planar[..., 0, :, :], planar[..., 1, :, :], planar[..., 2, :, :]
    )
    rgb = jnp.stack([B, G, R], axis=-3)
    rgb = _srgb_gamma(jnp.clip(rgb, 0.0, 1.0))
    return jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# convertScaleAbs: saturate(round(|x*alpha + beta|)) (verified bit-exact with
# round-half-even, which cvRound uses).
# ---------------------------------------------------------------------------


def convert_scale_abs(x: jnp.ndarray, alpha: float = 1.0, beta: float = 0.0) -> jnp.ndarray:
    v = jnp.abs(x.astype(jnp.float32) * jnp.float32(alpha) + jnp.float32(beta))
    return jnp.clip(jnp.round(v), 0, 255).astype(jnp.uint8)
