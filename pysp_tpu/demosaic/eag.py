"""Edge-assisted Gaussian ("Fast") demosaic.

Reference behavior: /root/reference/debayer/edge_assisted_gaussian.py. Green is filled
to full resolution by edge-weighted bilinear interpolation (:10-124); R/B are recovered
by photosite-phase Gaussian upsampling of the (channel - G) difference plus re-injection
of green high frequencies (:126-201).

All stages are shifts + 3x3 correlations, expressed so XLA fuses them into one program.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import DevelopedImage, RawFrame
from ..ops.phase_kernels import BayerPatternPosition, get_rgbg_kernel
from ..ops.stencil import filter2d, gaussian_blur3, pad_reflect

Array = jnp.ndarray


def simple_delta_mix_bilinear(top: Array, bottom: Array, left: Array, right: Array) -> Array:
    """Direction-weighted bilinear infill (edge_assisted_gaussian.py:10-49).

    More change top-bottom => blend more along top-bottom axis to preserve the edge
    running left-right (and vice versa); equal weights where the neighborhood is flat.
    """
    delta_y = jnp.abs(top - bottom)
    delta_x = jnp.abs(left - right)
    sum_delta = delta_y + delta_x

    avg_x = (left + right) * 0.5
    avg_y = (top + bottom) * 0.5

    strength_y = jnp.where(sum_delta != 0, delta_y / jnp.where(sum_delta != 0, sum_delta, 1.0), 0.5)
    strength_x = 1.0 - strength_y

    return avg_y * strength_x + avg_x * strength_y


def _eag_g_phases(
    g1: Array, g2: Array, use_bilinear_weighting: bool = True
) -> Tuple[Array, Array]:
    """Interpolated G at the R and B photosites, as quarter-res phase planes.

    The polyphase core of ``resample_g_to_full_resolution`` (same slices, same
    border reflection on the quarter-res planes), kept un-interleaved so the
    fused Fast develop can stay in phase space end to end."""
    g1p = pad_reflect(g1, 1)
    g2p = pad_reflect(g2, 1)

    h, w = g1.shape[-2], g1.shape[-1]

    # G value at the B photosite (bottom-right of quad): greens at N/S from g1, W/E from g2
    b_t = g1p[..., 1 : 1 + h, 1 : 1 + w]
    b_b = g1p[..., 2 : 2 + h, 1 : 1 + w]
    b_l = g2p[..., 1 : 1 + h, 1 : 1 + w]
    b_r = g2p[..., 1 : 1 + h, 2 : 2 + w]

    # G value at the R photosite (top-left of quad)
    r_t = g2p[..., 0:h, 1 : 1 + w]
    r_b = g2p[..., 1 : 1 + h, 1 : 1 + w]
    r_l = g1p[..., 1 : 1 + h, 0:w]
    r_r = g1p[..., 1 : 1 + h, 1 : 1 + w]

    if not use_bilinear_weighting:
        r = (r_t + r_b + r_l + r_r) * 0.25
        b = (b_t + b_b + b_l + b_r) * 0.25
    else:
        r = simple_delta_mix_bilinear(r_t, r_b, r_l, r_r)
        b = simple_delta_mix_bilinear(b_t, b_b, b_l, b_r)
    return r, b


def resample_g_to_full_resolution(
    g1: Array, g2: Array, use_bilinear_weighting: bool = True
) -> Array:
    """Fill G to sensor resolution from the two green phases (edge_assisted_gaussian.py:51-124).

    Original photosites are preserved; the missing R/B positions are interpolated from
    the 4 cardinal greens (reflect padding hides the borders).
    """
    r, b = _eag_g_phases(g1, g2, use_bilinear_weighting)
    return rgbg_to_bayer(r, g1, b, g2)


def _phase_upsample(plane: Array, position: BayerPatternPosition) -> Array:
    """Upsample a quarter-res plane to full res with the 4 phase kernels."""
    k_tl, k_tr, k_bl, k_br = get_rgbg_kernel(position)
    return rgbg_to_bayer(
        filter2d(plane, k_tl),
        filter2d(plane, k_tr),
        filter2d(plane, k_br),
        filter2d(plane, k_bl),
    )


def resample_channel(
    subpixel: Array,
    g_at_subpixel: Array,
    g_hf_pass: Array,
    position: BayerPatternPosition,
) -> Array:
    """Full-res channel from quarter-res samples via G-difference upsampling
    (edge_assisted_gaussian.py:126-143).

    The reference computes ``up(sub - g) + (up(g) + hf)`` — but ``up`` (the
    photosite-phase convolution) is linear, so this is algebraically
    ``up(sub) + hf``: the green channel cancels exactly. Computed in the reduced
    form (half the convolutions); difference vs the reference is one float32
    rounding order (~1e-7), far inside every fidelity gate."""
    del g_at_subpixel  # cancels by linearity
    return _phase_upsample(subpixel, position) + g_hf_pass


def resample_rb(r: Array, b: Array, g_upscaled: Array) -> Tuple[Array, Array]:
    """Resample R and B to full resolution (edge_assisted_gaussian.py:145-159)."""
    g_hf_cut = g_upscaled - gaussian_blur3(g_upscaled)
    g_r, _g1, g_b, _g2 = bayer_to_rgbg(g_upscaled)
    return (
        resample_channel(r, g_r, g_hf_cut, BayerPatternPosition.TOP_LEFT),
        resample_channel(b, g_b, g_hf_cut, BayerPatternPosition.BOTTOM_RIGHT),
    )


def resample_r(r: Array, g_upscaled: Array) -> Array:
    """Resample R alone (edge_assisted_gaussian.py:172-186)."""
    g_hf_cut = g_upscaled - gaussian_blur3(g_upscaled)
    g_r = bayer_to_rgbg(g_upscaled)[0]
    return resample_channel(r, g_r, g_hf_cut, BayerPatternPosition.TOP_LEFT)


def resample_b(b: Array, g_upscaled: Array) -> Array:
    """Resample B alone (edge_assisted_gaussian.py:161-170)."""
    g_hf_cut = g_upscaled - gaussian_blur3(g_upscaled)
    g_b = bayer_to_rgbg(g_upscaled)[2]
    return resample_channel(b, g_b, g_hf_cut, BayerPatternPosition.BOTTOM_RIGHT)


def _blur3_phases(quad):
    """``gaussian_blur3`` of the full-res interleave, computed per phase.

    Separable [a, b, a] passes in phase space: for output row-phase 0 the
    vertical taps are (P1[i-1], P0[i], P1[i]); for row-phase 1 they are
    (P0[i], P1[i], P0[i+1]). The full-res reflect101 border maps full row -1
    to full row +1 — which in phase space is the OPPOSITE-parity plane's row 0,
    i.e. a replicate pad on the shifted plane (same for columns). Values match
    the interleaved ``gaussian_blur3`` to conv-association order (~1 ulp)."""
    import math

    from ..ops.stencil import GAUSSIAN3_SIGMA1, pad_replicate, shift2d

    # GAUSSIAN3_SIGMA1 = outer(g, g) for the 1-D taps g = (s1, c1, s1)
    c1 = math.sqrt(float(GAUSSIAN3_SIGMA1[1, 1]))
    s1 = float(GAUSSIAN3_SIGMA1[0, 1]) / c1

    def pass_axis(q, axis):
        (p00, p01), (p10, p11) = q

        def up1(p):  # p[i-1] with replicate border
            return shift2d(p, -1, 0, pad_replicate) if axis == 0 else shift2d(p, 0, -1, pad_replicate)

        def dn1(p):  # p[i+1] with replicate border
            return shift2d(p, 1, 0, pad_replicate) if axis == 0 else shift2d(p, 0, 1, pad_replicate)

        if axis == 0:
            o00 = s1 * up1(p10) + c1 * p00 + s1 * p10
            o01 = s1 * up1(p11) + c1 * p01 + s1 * p11
            o10 = s1 * p00 + c1 * p10 + s1 * dn1(p00)
            o11 = s1 * p01 + c1 * p11 + s1 * dn1(p01)
        else:
            o00 = s1 * up1(p01) + c1 * p00 + s1 * p01
            o10 = s1 * up1(p11) + c1 * p10 + s1 * p11
            o01 = s1 * p00 + c1 * p01 + s1 * dn1(p00)
            o11 = s1 * p10 + c1 * p11 + s1 * dn1(p10)
        return ((o00, o01), (o10, o11))

    return pass_axis(pass_axis(quad, 0), 1)


def _phase_upsample_quad(plane: Array, position: BayerPatternPosition):
    """``_phase_upsample`` without the interleave: the 4 phase planes directly."""
    k_tl, k_tr, k_bl, k_br = get_rgbg_kernel(position)
    return (
        (filter2d(plane, k_tl), filter2d(plane, k_tr)),
        (filter2d(plane, k_bl), filter2d(plane, k_br)),
    )


def develop_channels_eag(
    frame: RawFrame, clip_highlights: bool, gamma_encode: bool
):
    """Fused Fast develop: the whole EAG pipeline + color tail in phase space.

    The unfused path interleaves full-res G (one relayout), deinterleaves it
    again for the R/B guides, interleaves the upsampled R and B (two more
    relayouts), and runs blur3 + the color tail at full resolution — each
    relayout a full-frame pass of pure data movement. Here every stage stays
    on the four CFA phase planes:
    G fill and blur3 are phase stencils, the photosite-phase R/B convolutions
    already produce phases, the (pointwise) color tail runs per phase, and the
    full-res image is assembled ONCE per channel. Same taps as the unfused
    path up to conv/association rounding order (parity-gated in
    tests/test_demosaic.py)."""
    from ..colorimetry.transforms import cam_to_lin_srgb_matrix
    from ..ops.polyphase import quad_to_bayer
    from ..pipeline.develop import _color_tail_channels

    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    wb = frame.wb_reciprocal()

    gr, gb = _eag_g_phases(g1, g2)
    w1 = wb[1]
    gq = ((gr * w1, g1 * w1), (g2 * w1, gb * w1))
    gblur = _blur3_phases(gq)
    ghf = tuple(
        tuple(gq[py][px] - gblur[py][px] for px in (0, 1)) for py in (0, 1)
    )

    rq = _phase_upsample_quad(r * wb[0], BayerPatternPosition.TOP_LEFT)
    bq = _phase_upsample_quad(b * wb[2], BayerPatternPosition.BOTTOM_RIGHT)

    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    tailed = [[[None, None], [None, None]] for _ in range(3)]
    for py in (0, 1):
        for px in (0, 1):
            ir, ig, ib = _color_tail_channels(
                rq[py][px] + ghf[py][px],
                gq[py][px],
                bq[py][px] + ghf[py][px],
                mat,
                clip_highlights,
                gamma_encode,
            )
            for k, v in ((0, ir), (1, ig), (2, ib)):
                tailed[k][py][px] = v
    return tuple(
        quad_to_bayer((tuple(tailed[k][0]), tuple(tailed[k][1]))) for k in range(3)
    )


def demosaic_eag_channels(frame: RawFrame):
    """Fast demosaic returning separate (r, g, b) channels (the develop hot path)."""
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    wb = frame.wb_reciprocal()

    g_up = resample_g_to_full_resolution(g1, g2) * wb[1]
    r_up, b_up = resample_rb(r * wb[0], b * wb[2], g_up)
    return r_up, g_up, b_up


def demosaic_eag(frame: RawFrame) -> DevelopedImage:
    """Fast demosaic entry point (edge_assisted_gaussian.py:188-201)."""
    r_up, g_up, b_up = demosaic_eag_channels(frame)
    wb = frame.wb_reciprocal()

    rgb = jnp.stack([r_up, g_up, b_up], axis=-1)
    return DevelopedImage(
        image=rgb.astype(jnp.float32),
        wb_coeff=wb,
        cam_mat=frame.cam_mat,
        cam_white=frame.cam_white,
        ev=frame.ev,
        wb_applied=True,
        wb_normalized=False,
    )
