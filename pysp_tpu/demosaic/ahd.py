"""AHD ("Best") demosaic — Hirakawa–Parks 2005 Adaptive Homogeneity-Directed.

Reference behavior: /root/reference/debayer/ahd.py:14-170. Stages:
directional green interpolation H/V with the blended 5-tap filter (:89-106), full-res
R/B reconstruction via phase-kernel upsampling of (channel - G) plus green HF
re-injection (:120-127), CIELAB homogeneity maps for both directions (:32-67, HDR mode
uses luma-L + Reinhard-tonemapped chroma :52-59), 3x3 box-blurred maps with binary
direction select (:133-145), and iterative chroma-median postprocessing (:148-165).

Everything is shifts/stencils/medians on static shapes — the full pipeline compiles to
one XLA program and is vmappable over burst frames.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..colorimetry.transforms import (
    cam_to_lin_srgb_matrix,
    rgb_to_lab_channels,
)
from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import DevelopedImage, RawFrame
from ..ops.phase_kernels import BayerPatternPosition
from ..ops.stencil import box_sum3, gaussian_blur3, median5, pad_reflect
from .eag import resample_channel
from .homogeneity import homogeneity_map_channels

Array = jnp.ndarray

# Blended 5-tap green filter (ahd.py:97-102): h_optimal from the paper, h_fast is its
# power-of-two variant; 12.5% optimal reduces maze artifacts without pink fringing.
_H_OPTIMAL = np.array([-0.2569, 0.4339, 0.5138, 0.4339, -0.2569], dtype=np.float64)
_H_FAST = np.array([-0.25, 0.5, 0.5, 0.5, -0.25], dtype=np.float64)
_RATIO_OPTIMAL = 0.125
_H = _H_OPTIMAL * _RATIO_OPTIMAL + _H_FAST * (1 - _RATIO_OPTIMAL)
_H = (_H / _H.sum()).astype(np.float32)


def _build_homogeneity_map(
    r: Array, g: Array, b: Array, frame: RawFrame, is_vertical: bool
) -> Array:
    """LAB homogeneity for one direction (ahd.py:32-67).

    Note the reference multiplies WB in a second time here (the candidate planes
    already carry WB from the interpolation stage) — replicated for parity.
    """
    wb = frame.wb_reciprocal()
    # Channelwise end-to-end (no (H, W, 3) stacks mid-pipeline):
    # cam->lin-sRGB is the 3x3 from cam_to_lin_srgb_matrix, clip_highlights=False.
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    rr, gg, bb = r * wb[0], g * wb[1], b * wb[2]
    ir = mat[0, 0] * rr + mat[0, 1] * gg + mat[0, 2] * bb
    ig = mat[1, 0] * rr + mat[1, 1] * gg + mat[1, 2] * bb
    ib = mat[2, 0] * rr + mat[2, 1] * gg + mat[2, 2] * bb

    if frame.is_hdr:
        # HDR: keep unbounded luma as L*, tonemap chroma (ahd.py:52-59)
        luma = 0.2126 * ir + 0.7152 * ig + 0.0722 * ib
        ir = ir / (1.0 + ir)
        ig = ig / (1.0 + ig)
        ib = ib / (1.0 + ib)
        lum, la, lb = rgb_to_lab_channels(ir, ig, ib)
        lum = luma
    else:
        lum, la, lb = rgb_to_lab_channels(ir, ig, ib)

    return homogeneity_map_channels(lum, la, lb, is_vertical)


def postprocess_color_channels(r: Array, g: Array, b: Array):
    """One chroma-median stage on separate channels (ahd.py:148-161)."""
    r = median5(r - g) + g
    b = median5(b - g) + g
    g = (median5(g - r) + median5(g - b) + r + b) * 0.5
    return r, g, b


def postprocess_color(image: Array) -> Array:
    """One chroma-median stage (ahd.py:148-161): median5 on color differences."""
    r, g, b = postprocess_color_channels(image[..., 0], image[..., 1], image[..., 2])
    return jnp.stack([r, g, b], axis=-1)


def _ahd_directional(frame: RawFrame):
    """Horizontal and vertical (r, g, b) candidates and the per-pixel pick
    (1.0 = horizontal) of AHD's direction decision."""
    r0, g1_0, b0, g2_0 = bayer_to_rgbg(frame.bayer)
    wb = frame.wb_reciprocal()

    # Pad planes 1px (BORDER_REFLECT) and pre-apply WB (ahd.py:77-80)
    r = pad_reflect(r0, 1) * wb[0]
    g1 = pad_reflect(g1_0, 1) * wb[1]
    b = pad_reflect(b0, 1) * wb[2]
    g2 = pad_reflect(g2_0, 1) * wb[1]

    h = [float(v) for v in _H]

    # Directional green estimates at R sites (ahd.py:97-103)
    gh_r = (
        r[1:-1, :-2] * h[0]
        + g1[1:-1, :-2] * h[1]
        + r[1:-1, 1:-1] * h[2]
        + g1[1:-1, 1:-1] * h[3]
        + r[1:-1, 2:] * h[4]
    )
    gv_r = (
        r[:-2, 1:-1] * h[0]
        + g2[:-2, 1:-1] * h[1]
        + r[1:-1, 1:-1] * h[2]
        + g2[1:-1, 1:-1] * h[3]
        + r[2:, 1:-1] * h[4]
    )

    # Directional green estimates at B sites (ahd.py:105-106)
    gh_b = (
        b[1:-1, :-2] * h[0]
        + g2[1:-1, 1:-1] * h[1]
        + b[1:-1, 1:-1] * h[2]
        + g2[1:-1, 2:] * h[3]
        + b[1:-1, 2:] * h[4]
    )
    gv_b = (
        b[:-2, 1:-1] * h[0]
        + g1[1:-1, 1:-1] * h[1]
        + b[1:-1, 1:-1] * h[2]
        + g1[2:, 1:-1] * h[3]
        + b[2:, 1:-1] * h[4]
    )

    g1_c = g1[1:-1, 1:-1]
    g2_c = g2[1:-1, 1:-1]

    # Full-resolution green fields (ahd.py:105-106)
    g_h = rgbg_to_bayer(gh_r, g1_c, gh_b, g2_c)
    g_v = rgbg_to_bayer(gv_r, g1_c, gv_b, g2_c)

    # R/B reconstruction: phase-kernel upsample of channel-G difference + G HF
    # re-injection (ahd.py:120-127)
    delta_gh_hf = g_h - gaussian_blur3(g_h)
    delta_gv_hf = g_v - gaussian_blur3(g_v)

    r_c = r[1:-1, 1:-1]
    b_c = b[1:-1, 1:-1]

    r_h = resample_channel(r_c, gh_r, delta_gh_hf, BayerPatternPosition.TOP_LEFT)
    r_v = resample_channel(r_c, gv_r, delta_gv_hf, BayerPatternPosition.TOP_LEFT)
    b_h = resample_channel(b_c, gh_b, delta_gh_hf, BayerPatternPosition.BOTTOM_RIGHT)
    b_v = resample_channel(b_c, gv_b, delta_gv_hf, BayerPatternPosition.BOTTOM_RIGHT)

    # Direction decision on box-blurred homogeneity (ahd.py:129-145).
    # Unnormalized sums, not cv2.blur's x(1/9): the counts are integers, so the
    # sums compare exactly (ops.stencil.box_sum3) — decisions are deterministic
    # across compilations; the 1/9 was monotone and changed nothing else.
    map_h = box_sum3(_build_homogeneity_map(r_h, g_h, b_h, frame, False))
    map_v = box_sum3(_build_homogeneity_map(r_v, g_v, b_v, frame, True))
    pick = (map_h < map_v).astype(jnp.float32)
    return (r_h, g_h, b_h), (r_v, g_v, b_v), pick


def ahd_direction_pick(frame: RawFrame) -> Array:
    """AHD's per-pixel H/V decision (1.0 = horizontal), as the develop takes it.

    Exact ties between the two homogeneity counts may fall either way between
    two compilations (DIVERGENCES.md), so comparing picks across devices shows
    how much of a develop's difference those ties explain."""
    return _ahd_directional(frame)[2]


def demosaic_ahd_channels(frame: RawFrame, postprocess_stages: int = 1):
    """AHD demosaic returning separate (r, g, b) channels — the develop hot path
    (develop stacks the channels once, at the very end)."""
    (r_h, g_h, b_h), (r_v, g_v, b_v), pick = _ahd_directional(frame)
    inv = 1.0 - pick
    out_r = r_h * pick + r_v * inv
    out_g = g_h * pick + g_v * inv
    out_b = b_h * pick + b_v * inv

    for _ in range(max(int(postprocess_stages), 0)):
        out_r, out_g, out_b = postprocess_color_channels(out_r, out_g, out_b)

    return out_r, out_g, out_b


def demosaic_ahd(frame: RawFrame, postprocess_stages: int = 1) -> DevelopedImage:
    r, g, b = demosaic_ahd_channels(frame, postprocess_stages)
    return DevelopedImage(
        image=jnp.stack([r, g, b], axis=-1).astype(jnp.float32),
        wb_coeff=frame.wb_reciprocal(),
        cam_mat=frame.cam_mat,
        cam_white=frame.cam_white,
        ev=frame.ev,
        wb_applied=True,
        wb_normalized=False,
    )
