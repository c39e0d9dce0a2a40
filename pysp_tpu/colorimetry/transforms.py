"""Device-side color transforms (jittable, vmappable).

Reference behavior: /root/reference/colorize/transform.py — the de-tint row-normalized
camera->RGB conversion (:21-53), cam->XYZ via wide-gamut PCS (:55-74), cam->lin-sRGB
(:76-87), sRGB gamma (:89-111), Oklab round-trip (:114-162).

Deliberate divergence from the reference: RGB<->CIELAB used cv2.cvtColor there
(debayer/ahd.py:58-62); here it is the closed-form CIE formula with D65 white, which is
what OpenCV computes for float inputs — implemented in ``rgb_to_lab`` so the whole AHD
pipeline stays on-device in one XLA program.

All 3x3 matrix plumbing happens in float32 on device so camera matrices can live in the
RawFrame pytree (vmappable over bursts with per-frame matrices).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from .spaces import LinRgbColorspace

Array = jnp.ndarray


def mat3_apply(img: Array, mat: Array) -> Array:
    """Apply a 3x3 matrix to the last axis of an image, unrolled to elementwise ops.

    Not a matmul on purpose: nine scalar multiply-adds are exact f32 work that
    fuses with the surrounding elementwise pipeline, where a K=3 dot would be
    a separate (and, at default precision, possibly reduced-precision) kernel.
    """
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    out0 = mat[0, 0] * r + mat[0, 1] * g + mat[0, 2] * b
    out1 = mat[1, 0] * r + mat[1, 1] * g + mat[1, 2] * b
    out2 = mat[2, 0] * r + mat[2, 1] * g + mat[2, 2] * b
    return jnp.stack([out0, out1, out2], axis=-1)

# Base (unadapted, D65-white) RGB->XYZ matrices, computed once on host in float64.
_REC709_TO_XYZ = np.asarray(LinRgbColorspace.REC709.mat_to_xyz(), np.float64)
_REC2020_TO_XYZ = np.asarray(LinRgbColorspace.REC2020.mat_to_xyz(), np.float64)
_D65_XYZ = np.array([0.31272 / 0.32903, 1.0, (1 - 0.31272 - 0.32903) / 0.32903])

# NumPy at module scope (device constants are materialized lazily inside jit traces).
_BRADFORD_NP = np.array(
    [
        [0.8951000, 0.2664000, -0.1614000],
        [-0.7502000, 1.7135000, 0.0367000],
        [0.0389000, -0.0685000, 1.0296000],
    ],
    dtype=np.float64,
)
_BRADFORD_INV_NP = np.linalg.inv(_BRADFORD_NP)


def _mm(a: Array, b: Array) -> Array:
    """f32 matrix product at full precision (default precision may use TF32)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def clip_rgb(rgb: Array) -> Array:
    """Clip an RGB image to [0,1] (transform.py:6-19)."""
    return jnp.clip(rgb, 0.0, 1.0)


def bradford_adapt(current_xyz: Array, target_xyz: Array) -> Array:
    """Bradford adaptation matrix, on-device (helpers_cam_mat.py:7-20)."""
    bradford = jnp.asarray(_BRADFORD_NP, jnp.float32)
    bradford_inv = jnp.asarray(_BRADFORD_INV_NP, jnp.float32)
    lms_curr = _mm(bradford, current_xyz)
    lms_targ = _mm(bradford, target_xyz)
    scale = lms_targ / lms_curr
    return _mm(bradford_inv, scale[:, None] * bradford)


def _dest_to_xyz_adapted(dest_base: Array, dest_white: Array, cam_white: Array) -> Array:
    """Destination RGB->XYZ matrix Bradford-adapted to the camera white.

    Mirrors ArbitraryRgbColorspace.mat_to_xyz(destination_whitepoint=cam_white)
    (rgb_space.py:37-50): ``adapt @ base``.
    """
    return _mm(bradford_adapt(dest_white, cam_white), dest_base)


def cam_to_rgb_norm_matrix(
    cam_mat: Array, cam_white: Array, dest_base: Array, dest_white: Array
) -> Array:
    """The 3x3 camera->destination matrix of cam_to_rgb_norm (transform.py:21-53):
    ``inv(row_normalize(cam_mat @ (RGB->XYZ adapted to camera white)))``."""
    mat_rgb_to_xyz_d_cam = _dest_to_xyz_adapted(dest_base, dest_white, cam_white)
    color_mat = _mm(cam_mat, mat_rgb_to_xyz_d_cam)
    color_sum = jnp.sum(color_mat, axis=1, keepdims=True)
    color_mat = color_mat / color_sum
    return jnp.linalg.inv(color_mat)


def cam_to_lin_srgb_matrix(cam_mat: Array, cam_white: Array) -> Array:
    """Camera->linear-sRGB 3x3 (the matrix cam_to_lin_srgb applies)."""
    return cam_to_rgb_norm_matrix(
        cam_mat,
        cam_white,
        jnp.asarray(_REC709_TO_XYZ, jnp.float32),
        jnp.asarray(_D65_XYZ, jnp.float32),
    )


def cam_to_rgb_norm(
    rgb: Array,
    cam_mat: Array,
    cam_white: Array,
    dest_base: Array,
    dest_white: Array,
    clip_highlights: bool = True,
) -> Array:
    """Camera-space RGB -> destination linear RGB with de-tint normalization.

    Reference behavior (transform.py:21-53): build ``cam_mat @ (RGB->XYZ adapted to
    camera white)``, row-normalize so camera r=g=b maps to output r=g=b, invert, apply.
    """
    if clip_highlights:
        rgb = clip_rgb(rgb)

    color_mat = cam_to_rgb_norm_matrix(cam_mat, cam_white, dest_base, dest_white)
    return mat3_apply(rgb, color_mat).astype(jnp.float32)


def cam_to_lin_srgb(
    rgb: Array, cam_mat: Array, cam_white: Array, clip_highlights: bool = True
) -> Array:
    """Camera-space RGB -> linear sRGB (transform.py:76-87)."""
    dest_base = jnp.asarray(_REC709_TO_XYZ, jnp.float32)
    dest_white = jnp.asarray(_D65_XYZ, jnp.float32)
    return cam_to_rgb_norm(rgb, cam_mat, cam_white, dest_base, dest_white, clip_highlights)


def cam_to_clean_xyz(
    rgb: Array, cam_mat: Array, cam_white: Array, clip_highlights: bool = True
) -> Array:
    """Camera RGB -> XYZ through a wide-gamut PCS (transform.py:55-74). PCS = Rec2020."""
    dest_base = jnp.asarray(_REC2020_TO_XYZ, jnp.float32)
    dest_white = jnp.asarray(_D65_XYZ, jnp.float32)
    rgb_norm = cam_to_rgb_norm(rgb, cam_mat, cam_white, dest_base, dest_white, clip_highlights)
    return mat3_apply(rgb_norm, dest_base).astype(jnp.float32)


def lin_srgb_to_srgb(rgb: Array) -> Array:
    """Linear sRGB -> sRGB gamma encode (transform.py:89-99). Clips to [0,1] first."""
    rgb = clip_rgb(rgb)
    return jnp.where(
        rgb <= 0.0031308,
        rgb * 12.92,
        1.055 * jnp.power(jnp.maximum(rgb, 1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_to_lin_srgb(srgb: Array) -> Array:
    """sRGB -> linear sRGB gamma decode (transform.py:101-111). Clips to [0,1] first."""
    srgb = clip_rgb(srgb)
    return jnp.where(
        srgb <= 0.04045,
        srgb / 12.92,
        jnp.power((srgb + 0.055) / 1.055, 2.4),
    )


def lin_srgb_to_oklab(lin_srgb: Array) -> Array:
    """Linear sRGB -> Oklab (transform.py:114-140; Björn Ottosson's constants)."""
    r, g, b = lin_srgb[..., 0], lin_srgb[..., 1], lin_srgb[..., 2]

    l = 0.4122214708 * r + 0.5363325363 * g + 0.0514459929 * b
    m = 0.2119034982 * r + 0.6806995451 * g + 0.1073969566 * b
    s = 0.0883024619 * r + 0.2817188376 * g + 0.6299787005 * b

    lp = jnp.cbrt(l)
    mp = jnp.cbrt(m)
    sp = jnp.cbrt(s)

    ok_l = 0.2104542553 * lp + 0.7936177850 * mp - 0.0040720468 * sp
    ok_a = 1.9779984951 * lp - 2.4285922050 * mp + 0.4505937099 * sp
    ok_b = 0.0259040371 * lp + 0.7827717662 * mp - 0.8086757660 * sp
    return jnp.stack([ok_l, ok_a, ok_b], axis=-1)


def oklab_to_lin_srgb(oklab: Array) -> Array:
    """Oklab -> linear sRGB (transform.py:142-162). No clamping applied."""
    ok_l, ok_a, ok_b = oklab[..., 0], oklab[..., 1], oklab[..., 2]

    lp = ok_l + 0.3963377774 * ok_a + 0.2158037573 * ok_b
    mp = ok_l - 0.1055613458 * ok_a - 0.0638541728 * ok_b
    sp = ok_l - 0.0894841775 * ok_a - 1.2914855480 * ok_b

    l = lp**3
    m = mp**3
    s = sp**3

    r = 4.0767416621 * l - 3.3077115913 * m + 0.2309699292 * s
    g = -1.2684380046 * l + 2.6097574011 * m - 0.3413193965 * s
    b = -0.0041960863 * l - 0.7034186147 * m + 1.7076147010 * s
    return jnp.stack([r, g, b], axis=-1)


# --- CIELAB (cv2.cvtColor-compatible float path) -------------------------------------
# OpenCV's float32 RGB2Lab: linear RGB in [0,1] -> XYZ via the fixed matrix below,
# whitepoint-normalized (D65), then the CIE f() with the 0.008856 linear toe.
# L in [0,100], a/b roughly [-127,127].
_CV2_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_CV2_LAB_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)


def rgb_to_lab_channels(r: Array, g: Array, b: Array):
    """Channelwise RGB [0,1] -> CIELAB (cv2 float semantics; see rgb_to_lab).

    Identical math/op-order to rgb_to_lab on separate 2D arrays (no channel
    stacking)."""

    def decode(x):
        x = jnp.clip(x, 0.0, 1.0)
        base = jnp.maximum((x + 0.055) / 1.055, 1e-12)
        p = jnp.power(base, 2.4)
        return jnp.where(x <= 0.04045, x / 12.92, p)

    r, g, b = decode(r), decode(g), decode(b)
    m = _CV2_RGB_TO_XYZ
    wt = _CV2_LAB_WHITE

    def f(t):
        return jnp.where(
            t > 0.008856,
            jnp.cbrt(jnp.maximum(t, 1e-12)),
            7.787 * t + 16.0 / 116.0,
        )

    tx = (m[0, 0] * r + m[0, 1] * g + m[0, 2] * b) / wt[0]
    ty = (m[1, 0] * r + m[1, 1] * g + m[1, 2] * b) / wt[1]
    tz = (m[2, 0] * r + m[2, 1] * g + m[2, 2] * b) / wt[2]

    fx, fy, fz = f(tx), f(ty), f(tz)
    lum = jnp.where(ty > 0.008856, 116.0 * fy - 16.0, 903.3 * ty)
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return lum, a, bb


def rgb_to_lab(rgb: Array) -> Array:
    """RGB [0,1] -> CIELAB, matching cv2.cvtColor(RGB2LAB) float semantics.

    cv2 treats float input as gamma-encoded sRGB: it clamps to [0,1], then applies the
    sRGB decode before the XYZ matrix. The reference feeds *linear* RGB into cvtColor
    (debayer/ahd.py:58-62), so the effective AHD homogeneity metric runs on clamped,
    double-linearized values — replicated here for behavioral parity.
    """
    lum, a, b = rgb_to_lab_channels(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return jnp.stack([lum, a, b], axis=-1)
