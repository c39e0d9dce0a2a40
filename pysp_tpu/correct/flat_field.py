"""Flat-field (shading) correction + dark/bias frame subtraction.

Reference behavior: /root/reference/raw_correction.py:25-63 — per plane
``chan * mean(flat_chan) / flat_chan``; infinities replaced with the channel max,
negatives clamped to 0, optional clamp at 1. Dark/bias-frame subtraction are stubs in
the reference (:7-23); here they are implemented with the obvious semantics
(black-level-corrected frame subtraction, clamped at 0).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.frame import RawFrame

Array = jnp.ndarray


def flat_frame_correction(
    frame: RawFrame,
    flat: RawFrame,
    clamp_high: bool = False,
    axis_name=None,
    core_rows=None,
) -> RawFrame:
    """Per-plane flat division; returns a corrected frame (raw_correction.py:25-63).

    The per-plane math is pointwise in the mosaic layout — each photosite divides
    by its own flat value and scales by its CFA plane's flat mean — so the means
    come from dimension-split reductions and broadcast back through a 2x2 phase
    select, keeping the whole op one fused elementwise pass over the mosaic, where
    a plane-stack formulation would pay two full CFA (de)interleave passes; the
    elementwise math is identical and the per-plane reductions differ only by
    association order (ulps).

    Spatial sharding: with ``axis_name``, the per-plane flat statistics reduce
    collectively across equal-size row shards (``core_rows`` excludes exchanged
    halo rows from the reductions so overlaps don't double-count) — the scale
    factor stays the GLOBAL flat mean.
    """
    import jax
    from jax import lax

    bayer, flat_b = frame.bayer, flat.bayer
    h_par = (jnp.arange(bayer.shape[-2]) % 2)[:, None]
    w_par = (jnp.arange(bayer.shape[-1]) % 2)[None, :]

    def _per_phase(x, red, collective=None):
        # Per-CFA-phase reduction, phase-selected back to mosaic broadcast shape.
        # The dimension-split reshape is free (no data movement) and the reduce
        # reads x once.
        xr = x if core_rows is None else x[..., core_rows[0] : core_rows[1], :]
        h2, w2 = xr.shape[-2] // 2, xr.shape[-1] // 2
        q = xr.reshape(*xr.shape[:-2], h2, 2, w2, 2)
        v = red(q)  # (..., 2, 2) phase scalars
        if axis_name is not None and collective is not None:
            v = collective(v, axis_name)
        vals = [[v[..., i : i + 1, j : j + 1] for j in (0, 1)] for i in (0, 1)]
        return jnp.where(
            h_par == 0,
            jnp.where(w_par == 0, vals[0][0], vals[0][1]),
            jnp.where(w_par == 0, vals[1][0], vals[1][1]),
        )

    def _mean(q):
        return jnp.mean(q, axis=(-4, -2))

    mean_map = _per_phase(flat_b, _mean, collective=lax.pmean)

    def _fast(bayer, flat_b, mean_map):
        # All-positive flat: the division is finite everywhere, so the
        # inf-replacement machinery (extra passes over the output) vanishes —
        # identical results by construction.
        out = jnp.maximum(bayer * mean_map / flat_b, 0.0)
        if clamp_high:
            out = jnp.minimum(out, 1.0)
        return out

    def _general(bayer, flat_b, mean_map):
        out = bayer * mean_map / flat_b

        finite = jnp.isfinite(out)
        neg_inf = jnp.where(finite, out, -jnp.inf)
        # inf -> per-plane max of the finite values
        max_map = _per_phase(
            neg_inf, lambda q: jnp.max(q, axis=(-4, -2)), collective=lax.pmax
        )
        # All-infinite plane (completely black flat): leave the channel untouched
        any_map = _per_phase(
            finite,
            lambda q: jnp.any(q, axis=(-4, -2)),
            collective=lambda v, ax: lax.pmax(v.astype(jnp.int32), ax) > 0,
        )

        out = jnp.where(finite, out, max_map)
        out = jnp.maximum(out, 0.0)
        if clamp_high:
            out = jnp.minimum(out, 1.0)
        return jnp.where(any_map, out, bayer)

    all_pos = jnp.all(flat_b > 0)
    if axis_name is not None:
        # the branch choice must be device-invariant: _general runs collectives,
        # so shards disagreeing on the predicate would deadlock inside cond
        all_pos = lax.pmin(all_pos.astype(jnp.int32), axis_name) > 0
    out = jax.lax.cond(all_pos, _fast, _general, bayer, flat_b, mean_map)
    return frame.replace(bayer=out)


def dark_frame_subtraction(frame: RawFrame, dark: RawFrame) -> RawFrame:
    """Remove dark-current noise (reference stub raw_correction.py:7-14; implemented)."""
    return frame.replace(bayer=jnp.maximum(frame.bayer - dark.bayer, 0.0))


def bias_frame_subtraction(frame: RawFrame, bias: RawFrame) -> RawFrame:
    """Remove fixed-pattern read noise (reference stub raw_correction.py:16-23;
    implemented)."""
    return frame.replace(bayer=jnp.maximum(frame.bayer - bias.bayer, 0.0))
