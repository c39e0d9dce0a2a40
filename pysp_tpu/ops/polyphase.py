"""Polyphase (per-CFA-phase) plane split and assembly.

The Draft and Fast develops run their stencils on the four quarter-res phase
planes and assemble the full-resolution mosaic once, at the end.

Representation: a "quad" is a tuple of 4 planes indexed by (row_parity, col_parity):
``quad[py][px]`` with shape (H/2, W/2). Note this differs from the (R, G1, B, G2)
order of core.bayer.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Array = jnp.ndarray
Quad = Tuple[Tuple[Array, Array], Tuple[Array, Array]]


def bayer_to_quad(bayer: Array) -> Quad:
    """Mosaic (H, W) -> phases quad[py][px]."""
    evens = bayer[..., 0::2, :]
    odds = bayer[..., 1::2, :]
    return (
        (evens[..., :, 0::2], evens[..., :, 1::2]),
        (odds[..., :, 0::2], odds[..., :, 1::2]),
    )


def quad_to_bayer(quad: Quad) -> Array:
    """Phases quad[py][px] -> mosaic (H, W)."""
    (p00, p01), (p10, p11) = quad
    h2, w2 = p00.shape[-2], p00.shape[-1]
    even = jnp.stack([p00, p01], axis=-1).reshape(*p00.shape[:-2], h2, w2 * 2)
    odd = jnp.stack([p10, p11], axis=-1).reshape(*p00.shape[:-2], h2, w2 * 2)
    return jnp.stack([even, odd], axis=-2).reshape(*p00.shape[:-2], h2 * 2, w2 * 2)
