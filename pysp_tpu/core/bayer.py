"""Bayer plane (de)swizzling and pattern canonicalization.

The reference deswizzles with NumPy strided views (`/root/reference/bayer_chan_mixer.py:4-43`);
here the same deswizzle is a pair of single-axis strided slices, and the re-interleave a
pair of minor-axis stack+reshapes, which XLA fuses into neighbouring ops.

Plane order matches the reference: (R, G1, B, G2) where G1 is the top-right green and
G2 the bottom-left green of an RGGB quad.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..const import BayerPattern

Array = jnp.ndarray


def bayer_to_rgbg(bayer: Array) -> Tuple[Array, Array, Array, Array]:
    """Deinterleave an RGGB mosaic (..., H, W) into quarter-res planes (R, G1, B, G2).

    Reference behavior: bayer_chan_mixer.py:4-21.

    Done as two single-axis strided slices (rows, then columns), one shuffle
    per axis, in place of a reshape-to-quads transpose.
    """
    evens = bayer[..., 0::2, :]
    odds = bayer[..., 1::2, :]
    r = evens[..., :, 0::2]
    g1 = evens[..., :, 1::2]
    g2 = odds[..., :, 0::2]
    b = odds[..., :, 1::2]
    return r, g1, b, g2


def rgbg_to_bayer(r: Array, g1: Array, b: Array, g2: Array) -> Array:
    """Re-interleave quarter-res planes into an RGGB mosaic (bayer_chan_mixer.py:23-43).

    Columns interleave via a minor-axis stack+reshape, rows likewise — one
    single-axis shuffle each (see bayer_to_rgbg note).
    """
    h2, w2 = r.shape[-2], r.shape[-1]
    even_rows = jnp.stack([r, g1], axis=-1).reshape(*r.shape[:-2], h2, w2 * 2)
    odd_rows = jnp.stack([g2, b], axis=-1).reshape(*r.shape[:-2], h2, w2 * 2)
    return jnp.stack([even_rows, odd_rows], axis=-2).reshape(
        *r.shape[:-2], h2 * 2, w2 * 2
    )


def bayer_to_planes(bayer: Array) -> Array:
    """Mosaic (..., H, W) -> planes (..., 4, H/2, W/2) in (R, G1, B, G2) order."""
    r, g1, b, g2 = bayer_to_rgbg(bayer)
    return jnp.stack([r, g1, b, g2], axis=-3)


def planes_to_bayer(planes: Array) -> Array:
    """Planes (..., 4, H/2, W/2) -> mosaic (..., H, W)."""
    r = planes[..., 0, :, :]
    g1 = planes[..., 1, :, :]
    b = planes[..., 2, :, :]
    g2 = planes[..., 3, :, :]
    return rgbg_to_bayer(r, g1, b, g2)


def reversible_transform_rggb(sensor: Array, pattern: BayerPattern | int) -> Array:
    """Rotate/flip a mosaic so its CFA reads RGGB; applying twice round-trips.

    Reference behavior: image.py:143-152 (same transform is its own inverse:
    rot180 / horizontal flip / vertical flip).

    Deliberate divergence: the reference flips GRBG on axis 0 and GBRG on axis 1,
    which yields BGGR for even-sized sensors, not RGGB (swapped axes). Here the
    intended canonicalization is implemented: GRBG needs a horizontal flip
    (axis 1), GBRG a vertical flip (axis 0). Verified by construction in
    tests/test_core.py.

    Works on (H, W) mosaics and (H, W, C) demosaiced images alike — the reference
    reuses it on demosaiced output at image.py:181.
    """
    pattern = BayerPattern(pattern)
    if pattern == BayerPattern.Rggb:
        return sensor
    if pattern == BayerPattern.Bggr:
        return jnp.rot90(sensor, k=2, axes=(0, 1))
    if pattern == BayerPattern.Gbrg:
        return jnp.flip(sensor, axis=0)
    if pattern == BayerPattern.Grbg:
        return jnp.flip(sensor, axis=1)
    raise NotImplementedError(f"{pattern} not implemented!")
