"""Bayer-domain noise reduction — the native stand-in for libraw FBDD.

The reference's alternate loader exists "mainly for Bayer-domain denoising"
(image.py:331-339: libraw postprocess with FBDD full NR); that path needs the
optional rawpy dependency here. This module supplies a native pre-demosaic
denoiser instead: an a-trous (undecimated) B3-spline wavelet soft-threshold on
the four CFA phase planes — the classic shift-invariant shrinkage used by raw
processors, and a good fit for a fused device program (every step is separable
shift-and-add the XLA fuser handles; no gathers, no sorts, vmappable).

Method per plane:
  smooth_{l+1} = B3 * smooth_l with taps dilated 2^l   (kernel [1,4,6,4,1]/16)
  detail_l     = smooth_l - smooth_{l+1}
  detail_l    <- garrote-shrink(detail_l, t_l)   (d * max(0, 1 - t^2/d^2))
  result       = smooth_L + sum_l detail_l

The noise scale is estimated in-graph from the finest detail band with the
Gaussian mean-absolute-deviation identity sigma = E|d| * sqrt(pi/2) (no
median/sort — see the stencil design notes); per-level thresholds follow the
known B3 a-trous noise decay (0.889, 0.200, 0.086, 0.041 per level for unit
input noise). Non-negative garrote shrinkage (Gao 1998) was chosen over soft
thresholding by a measured sweep: it is unbiased for large coefficients, so
edges keep their amplitude, and its PSNR is flat across a 2x threshold range
(soft thresholding peaked sharply and subtracted t from every edge).
"""
from __future__ import annotations

import math

import jax.numpy as jnp

from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import RawFrame
from ..ops.stencil import pad_reflect, shift2d

Array = jnp.ndarray

# relative noise std of each a-trous detail level (B3 spline, unit input noise)
_LEVEL_SIGMA = (0.8907, 0.2007, 0.0855, 0.0412, 0.0202)


def _b3_smooth(x: Array, dilation: int) -> Array:
    """Separable dilated B3-spline smoothing ([1,4,6,4,1]/16 per axis),
    reflect borders, as shifts+adds that fuse with their neighbours."""
    w = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)

    def pass1(v, axis):
        acc = None
        for k, wk in enumerate(w):
            off = (k - 2) * dilation
            dy, dx = (off, 0) if axis == 0 else (0, off)
            term = wk * shift2d(v, dy, dx, pad_reflect)
            acc = term if acc is None else acc + term
        return acc

    return pass1(pass1(x, 0), 1)


def _denoise_plane(
    plane: Array, strength: float, levels: int, axis_name=None, core_rows=None
) -> Array:
    smooth = plane
    details = []
    for lvl in range(levels):
        nxt = _b3_smooth(smooth, 1 << lvl)
        details.append(smooth - nxt)
        smooth = nxt

    # noise scale from the finest band: sigma_0 = E|d0| * sqrt(pi/2); divide
    # out the band's own gain to get the input-referred sigma. Under spatial
    # sharding the estimate must stay GLOBAL (pmean across equal row shards,
    # halo rows excluded) or shards would shrink with different thresholds.
    d0 = jnp.abs(details[0])
    if core_rows is not None:
        d0 = d0[core_rows[0] : core_rows[1]]
    sigma = jnp.mean(d0) * math.sqrt(math.pi / 2.0)
    if axis_name is not None:
        from jax import lax

        sigma = lax.pmean(sigma, axis_name)
    sigma = sigma / _LEVEL_SIGMA[0]

    out = smooth
    for lvl, d in enumerate(details):
        t = (1.5 * strength) * sigma * _LEVEL_SIGMA[min(lvl, len(_LEVEL_SIGMA) - 1)]
        out = out + d * jnp.maximum(0.0, 1.0 - (t * t) / jnp.maximum(d * d, 1e-20))
    return out


def denoise_bayer_wavelet(
    frame: RawFrame,
    strength: float = 1.0,
    levels: int = 3,
    axis_name=None,
    core_rows=None,
) -> RawFrame:
    """Edge-preserving Bayer-domain NR on the CFA phase planes.

    ``strength`` scales the shrinkage thresholds (0 disables; ~1 targets the
    estimated noise floor); ``levels`` is the number of a-trous scales.
    """
    if strength <= 0.0 or levels <= 0:
        return frame
    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    cr = None if core_rows is None else (core_rows[0] // 2, core_rows[1] // 2)
    planes = [
        _denoise_plane(p, float(strength), int(levels), axis_name, cr)
        for p in (r, g1, b, g2)
    ]
    out = rgbg_to_bayer(planes[0], planes[1], planes[2], planes[3])
    return frame.replace(bayer=jnp.clip(out, 0.0, None).astype(frame.bayer.dtype))
