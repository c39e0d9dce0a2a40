"""Sharpening: unsharp mask and Richardson-Lucy deconvolution.

Reference behavior: /root/reference/filter/sharpen/unsharp.py (per-channel high-pass
:6-22, Oklab-L-only variant :24-43) and gauss_rt_deconv.py (symmetric-Gaussian-PSF RL
:29-37, Oklab-L variant :39-63, linearity-preserving YUV-luma variant :65-99).

RL iterations run under lax.fori_loop so 20 iterations stay one compiled program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..colorimetry.transforms import lin_srgb_to_oklab, oklab_to_lin_srgb
from .blur import blur_gaussian

Array = jnp.ndarray


def unsharp_mask_per_channel(image: Array, radius: float, amount: float) -> Array:
    """Naive per-channel unsharp (unsharp.py:6-22). Unclipped output."""
    high_pass = image - blur_gaussian(image, radius)
    return image + high_pass * amount


def unsharp_mask_lab(lin_srgb: Array, radius: float, amount: float) -> Array:
    """Oklab-L-only unsharp to avoid color fringing (unsharp.py:24-43)."""
    lab = lin_srgb_to_oklab(lin_srgb)
    sharpened_l = unsharp_mask_per_channel(lab[..., 0], radius, amount)
    lab = lab.at[..., 0].set(sharpened_l)
    return oklab_to_lin_srgb(lab)


def gaussian_rt_deconvolution(
    image: Array, sigma: float, iterations: int = 20
) -> Array:
    """Richardson-Lucy with a symmetric Gaussian PSF (gauss_rt_deconv.py:7-37)."""
    image = jnp.asarray(image)

    def body(_, estimate):
        blurred = blur_gaussian(estimate, sigma)
        factor = blur_gaussian(image / (blurred + 1e-25), sigma)
        return estimate * factor

    return jax.lax.fori_loop(0, iterations, body, image)


def gaussian_rt_deconvolution_lab(
    lin_srgb: Array, radius: float, iterations: int = 20
) -> Array:
    """RL on the Oklab L channel only (gauss_rt_deconv.py:39-63)."""
    lab = lin_srgb_to_oklab(lin_srgb)
    l_sharp = gaussian_rt_deconvolution(lab[..., 0], radius, iterations)
    lab = lab.at[..., 0].set(l_sharp)
    return oklab_to_lin_srgb(lab)


def gaussian_rt_deconvolution_yuv(
    lin_srgb: Array, radius: float, iterations: int = 20
) -> Array:
    """RL on linear luma, per-pixel gain applied to RGB (gauss_rt_deconv.py:65-99)."""
    y = (
        0.299 * lin_srgb[..., 0]
        + 0.587 * lin_srgb[..., 1]
        + 0.114 * lin_srgb[..., 2]
    )
    y_mod = gaussian_rt_deconvolution(y, radius, iterations)
    scale = y_mod / y
    return lin_srgb * scale[..., None]
