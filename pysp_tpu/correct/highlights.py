"""Highlight reconstruction: rebuild clipped channels from unclipped ones.

Additive over the reference: its develop clips highlights at saturation
(image.py:331-339 passes ``no_auto_bright``/clipped highlights to libraw;
colorize/transform.py:29 clips camera RGB at 1.0), which renders any pixel with
at least one clipped channel as flat white (or, unclipped, as a magenta/cyan
cast). libraw itself offers highlight *reconstruction* modes the reference
never exposes — this module is the equivalent capability, on the device.

Method (own design — documented in DIVERGENCES.md, not a parity item):

1. Work on the WB-applied camera-space channels the demosaic emits. Channel
   ``c`` clips at ``L_c = wb_gain_c * lim_sat`` there (pre-WB everything clips
   at ``lim_sat``); a neutral subject clips G first (gains are G-normalized, so
   stored G is the largest), which is why R/B usually carry usable structure
   under a blown G.
2. Per channel, compute the chroma ratio ``rho_c = v_c / I`` against the
   all-unclipped intensity ``I = mean_c(v_c / L_c)``, valid only where NO
   channel clips. Propagate ``rho_c`` into the clipped region with a
   valid-aware pyramid fill (each level halves resolution with a normalized
   2x2 reduction, so arbitrarily large blown regions get their ratio from the
   nearest valid ring at SOME scale) plus a few harmonic smoothing sweeps.
3. Re-estimate intensity inside the clipped region from channels that are
   still unclipped there: ``I_est = mean_u(v_u / rho_u)``. Fully-clipped
   pixels have no witness, so take the lower bound ``max_c(v_c / rho_c)``
   (the scene is at least as bright as the clip levels) — these continue the
   boundary chroma neutrally instead of inventing color.
4. ``v'_c = max(v_c, rho_c * I_est)`` inside the clipped mask only; unclipped
   pixels are bit-untouched.

The output exceeds the clip levels (that is the point); the develop pipeline
compresses it back below 1.0 with a soft knee before gamma when
``DevelopConfig.highlights == "reconstruct"`` (see pipeline/develop.py).

Everything is shift/reshape arithmetic — jittable, static-shaped, vmappable.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.stencil import pad_replicate, shift2d

Array = jnp.ndarray


def _down2(x: Array, v: Array) -> Tuple[Array, Array]:
    """Valid-aware 2x2 reduction: normalized sum of valid samples per quad."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        x = pad_replicate(x, (0, h % 2, 0, w % 2))
        v = pad_replicate(v, (0, h % 2, 0, w % 2))
        h, w = x.shape[-2], x.shape[-1]
    xs = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2).sum((-3, -1))
    vs = v.reshape(*v.shape[:-2], h // 2, 2, w // 2, 2).sum((-3, -1))
    return xs / jnp.maximum(vs, 1.0), jnp.minimum(vs, 1.0)


def _up2(x: Array, h: int, w: int) -> Array:
    """Nearest 2x upsample cropped to (h, w) — a fill seed, smoothing follows."""
    up = jnp.repeat(jnp.repeat(x, 2, axis=-2), 2, axis=-1)
    return up[..., :h, :w]


def masked_fill_pyramid(
    x: Array, valid: Array, levels: int = 6, smooth_iterations: int = 2
) -> Array:
    """Fill invalid pixels from valid ones at the nearest available scale.

    A multiscale complement to bad_pixels.masked_fill_inpaint (whose
    valid-front marching reaches ``fill_iterations`` px — fine for hot pixels,
    useless for 500-px blown skies). Valid data is untouched; invalid pixels
    get the normalized mean of the nearest valid content at the finest scale
    that has any, then ``smooth_iterations`` harmonic sweeps relax the seams.
    """
    v = valid.astype(x.dtype)
    x0 = x * v

    # downsample stack (static python loop: shapes halve each level)
    stack = [(x0, v)]
    for _ in range(levels):
        if min(stack[-1][0].shape[-2:]) <= 1:
            break
        stack.append(_down2(*stack[-1]))

    # coarsest: anything still invalid falls back to the global valid mean
    xc, vc = stack[-1]
    gmean = jnp.sum(x0, axis=(-2, -1), keepdims=True) / jnp.maximum(
        jnp.sum(v, axis=(-2, -1), keepdims=True), 1.0
    )
    filled = jnp.where(vc > 0, xc, gmean)

    # composite back up: valid data wins, holes take the coarser fill
    for xf, vf in reversed(stack[:-1]):
        h, w = xf.shape[-2], xf.shape[-1]
        filled = jnp.where(vf > 0, xf, _up2(filled, h, w))

    def smooth_body(_, y):
        acc = (
            shift2d(y, -1, 0, pad_replicate)
            + shift2d(y, 1, 0, pad_replicate)
            + shift2d(y, 0, -1, pad_replicate)
            + shift2d(y, 0, 1, pad_replicate)
        ) * 0.25
        return jnp.where(valid, y, acc)

    return jax.lax.fori_loop(0, smooth_iterations, smooth_body, filled)


def reconstruct_highlights_channels(
    r: Array,
    g: Array,
    b: Array,
    wb_gains: Array,
    lim_sat: Array,
    threshold: float = 0.95,
    levels: int = 6,
) -> Tuple[Array, Array, Array]:
    """Reconstruct clipped channels of WB-applied camera RGB (see module doc).

    ``wb_gains`` are the reciprocal WB multipliers (1/neutral, G-normalized)
    that the demosaic pre-applied; ``lim_sat`` is the frame's saturation
    ceiling (1.0 for single exposures, >1 for HDR stacks).
    """
    eps = 1e-6
    vals = [r, g, b]
    gains = [wb_gains[i].astype(r.dtype) for i in range(3)]
    limits = [gains[i] * lim_sat for i in range(3)]
    clipped = [vals[i] >= threshold * limits[i] for i in range(3)]
    none_clipped = jnp.logical_not(clipped[0] | clipped[1] | clipped[2])

    # all-unclipped intensity (clip-level-normalized so channels are comparable)
    intensity = (
        vals[0] / limits[0] + vals[1] / limits[1] + vals[2] / limits[2]
    ) * (1.0 / 3.0)

    rhos = []
    for i in range(3):
        rho = vals[i] / jnp.maximum(intensity, eps)
        rhos.append(masked_fill_pyramid(rho, none_clipped, levels=levels))

    # intensity witnesses: unclipped channels back-project through their ratio
    est_num = jnp.zeros_like(intensity)
    est_den = jnp.zeros_like(intensity)
    lower_bound = jnp.zeros_like(intensity)
    for i in range(3):
        witness = jnp.logical_not(clipped[i]).astype(r.dtype)
        proj = vals[i] / jnp.maximum(rhos[i], eps)
        est_num = est_num + witness * proj
        est_den = est_den + witness
        lower_bound = jnp.maximum(lower_bound, proj)

    i_est = jnp.where(est_den > 0, est_num / jnp.maximum(est_den, 1.0), lower_bound)

    out = []
    for i in range(3):
        rec = jnp.maximum(vals[i], rhos[i] * i_est)
        out.append(jnp.where(clipped[i], rec, vals[i]))
    return out[0], out[1], out[2]


def compress_highlights(x: Array, knee: float = 0.85) -> Array:
    """Soft-knee compression of super-white linear values into [0, 1].

    Identity below ``knee``; above it an exponential shoulder asymptotes to 1,
    so reconstructed highlight structure renders with tonal separation instead
    of re-clipping. C1-continuous at the knee.
    """
    span = 1.0 - knee
    shoulder = knee + span * (1.0 - jnp.exp(-(x - knee) / span))
    return jnp.where(x <= knee, x, shoulder)
