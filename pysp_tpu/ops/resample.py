"""Gather-based resampling: bilinear / Lanczos4 remap, fractional crops.

Replaces cv2.remap (INTER_LINEAR at corr_ca/ca_removal.py:100-128, INTER_LANCZOS4 at
dng_warp_corr/chan_distortion_corr.py:94-97) and the reference's vectorized
``bilinear_sample`` (corr_ca/roi/helper.py:38-95) with XLA gathers.

Coordinate convention matches cv2.remap: ``map_x``/``map_y`` give the float source
sample position for every destination pixel. Callers clip coordinates into range
(as the reference does), so edge behavior is clamp-to-edge.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


def _gather2d(img: Array, yi: Array, xi: Array) -> Array:
    """img[(yi, xi)] with indices clamped to the image bounds; img (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    yi = jnp.clip(yi, 0, h - 1)
    xi = jnp.clip(xi, 0, w - 1)
    flat = img.reshape(*img.shape[:-2], h * w)
    idx = yi * w + xi
    return jnp.take(flat, idx.reshape(-1), axis=-1).reshape(
        *img.shape[:-2], *idx.shape
    )


def remap_bilinear(img: Array, map_x: Array, map_y: Array) -> Array:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) with clamp-to-edge sampling."""
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = (map_x - x0).astype(img.dtype)
    fy = (map_y - y0).astype(img.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    i00 = _gather2d(img, y0i, x0i)
    i01 = _gather2d(img, y0i, x0i + 1)
    i10 = _gather2d(img, y0i + 1, x0i)
    i11 = _gather2d(img, y0i + 1, x0i + 1)

    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def _lanczos4_weight_planes(frac: Array) -> list:
    """8 Lanczos (a=4) tap weights for taps at offsets -3..4 from floor(coord).

    Weights normalized to sum 1 (cv2 does the same). frac shape (...,); output is a
    list of 8 arrays shaped like ``frac``. The normalization sum accumulates taps
    in ascending order, so the gather and select-chain remaps stay bit-identical.
    """
    eps = 1e-7
    planes = []
    for k in range(8):
        t = frac - jnp.float32(k - 3)  # distance from sample point to this tap
        pit = jnp.pi * t
        small = jnp.abs(t) < eps
        safe = jnp.where(small, 1.0, pit)
        sinc = jnp.where(small, 1.0, jnp.sin(safe) / safe)
        safe4 = jnp.where(small, 1.0, pit / 4.0)
        sinc4 = jnp.where(small, 1.0, jnp.sin(safe4) / safe4)
        planes.append(jnp.where(jnp.abs(t) < 4.0, sinc * sinc4, 0.0))
    total = planes[0]
    for k in range(1, 8):
        total = total + planes[k]
    return [w / total for w in planes]


def _lanczos4_weights(frac: Array) -> Array:
    """Stacked (…, 8) view of :func:`_lanczos4_weight_planes`."""
    return jnp.stack(_lanczos4_weight_planes(frac), axis=-1)


def remap_lanczos4(img: Array, map_x: Array, map_y: Array) -> Array:
    """cv2.remap(img, map_x, map_y, INTER_LANCZOS4) equivalent (separable 8x8 taps).

    cv2 quantizes fractional positions to 1/32 with fixed-point tables; this computes
    exact continuous weights, so results differ from cv2 by the quantization error
    (~1e-3) — ours is the more accurate resampler.
    """
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = (map_x - x0).astype(img.dtype)
    fy = (map_y - y0).astype(img.dtype)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    wx = _lanczos4_weights(fx)  # (..., 8)
    wy = _lanczos4_weights(fy)

    out = jnp.zeros(jnp.broadcast_shapes(map_x.shape, map_y.shape), img.dtype)
    # separable accumulation: rows then columns, 64 gathers fused by XLA
    for j in range(8):
        row_acc = jnp.zeros_like(out)
        for i in range(8):
            row_acc = row_acc + wx[..., i] * _gather2d(
                img, y0i + (j - 3), x0i + (i - 3)
            )
        out = out + wy[..., j] * row_acc
    return out


def _delta_fields(
    map_x: Array, map_y: Array, h: int, w: int,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
):
    """Integer floor-index displacements from the identity grid, clipped into
    the caller-guaranteed static bounds, plus the fractional phases."""
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    rows = jnp.arange(h, dtype=jnp.int32)[:, None]
    cols = jnp.arange(w, dtype=jnp.int32)[None, :]
    dyv = jnp.clip(y0.astype(jnp.int32) - rows, dy_bounds[0], dy_bounds[1])
    dxv = jnp.clip(x0.astype(jnp.int32) - cols, dx_bounds[0], dx_bounds[1])
    return dyv, dxv, fx, fy


def remap_bilinear_bounded(
    img: Array, map_x: Array, map_y: Array,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
) -> Array:
    """remap_bilinear for displacement-bounded smooth maps — BIT-IDENTICAL.

    When floor(map) - identity lies in the STATIC inclusive ranges
    ``dy_bounds``/``dx_bounds`` (true for lens-distortion and CA warps), each
    corner VALUE is selected (`where`-chains over clamped shifts of ``img``)
    instead of gathered — pure shift/compare/select work that XLA fuses. Selection
    picks exact values, so the lerps below reproduce remap_bilinear bit for
    bit. Deltas outside the bounds are clipped (callers must supply true
    bounds; remap_bilinear remains the reference for unbounded maps).
    """
    from .stencil import pad_replicate, shift2d

    h, w = img.shape[-2], img.shape[-1]
    dyv, dxv, fx, fy = _delta_fields(map_x, map_y, h, w, dy_bounds, dx_bounds)
    fx = fx.astype(img.dtype)
    fy = fy.astype(img.dtype)

    # Linear (not quadratic) in the bound sizes: resolve the horizontal select
    # once per candidate row shift s and x-tap, then pick rows by the vertical
    # delta — 2(SY+1)SX + 4SY selects instead of 4·SY·SX.
    def hsel(s: int, dx_tap: int) -> Array:
        o = shift2d(img, s, dx_bounds[0] + dx_tap, pad_replicate)
        for b in range(dx_bounds[0] + 1, dx_bounds[1] + 1):
            o = jnp.where(dxv == b, shift2d(img, s, b + dx_tap, pad_replicate), o)
        return o

    h0 = {s: hsel(s, 0) for s in range(dy_bounds[0], dy_bounds[1] + 2)}
    h1 = {s: hsel(s, 1) for s in range(dy_bounds[0], dy_bounds[1] + 2)}

    def vsel(rows: dict, dy_tap: int) -> Array:
        out = rows[dy_bounds[0] + dy_tap]
        for a in range(dy_bounds[0] + 1, dy_bounds[1] + 1):
            out = jnp.where(dyv == a, rows[a + dy_tap], out)
        return out

    i00 = vsel(h0, 0)
    i01 = vsel(h1, 0)
    i10 = vsel(h0, 1)
    i11 = vsel(h1, 1)
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def remap_lanczos4_bounded(
    img: Array, map_x: Array, map_y: Array,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
) -> Array:
    """remap_lanczos4 for displacement-bounded maps — BIT-IDENTICAL.

    Reassociated so cost is linear, not quadratic, in the bound sizes: the
    8-tap horizontal pass is evaluated once per candidate row shift s (using
    every pixel's own horizontal taps/phase), then each vertical tap selects
    its row result by the pixel's vertical delta. Accumulation order matches
    remap_lanczos4 exactly (zeros-seeded, taps ascending).
    """
    from .stencil import pad_replicate, shift2d

    h, w = img.shape[-2], img.shape[-1]
    dyv, dxv, fx, fy = _delta_fields(map_x, map_y, h, w, dy_bounds, dx_bounds)
    wx = _lanczos4_weights(fx.astype(img.dtype))
    wy = _lanczos4_weights(fy.astype(img.dtype))

    def hrow(s: int) -> Array:
        """sum_i wx_i * img[clamp(r+s), clamp(c + dxv + i - 3)]."""

        def taps(b: int) -> Array:
            acc = jnp.zeros((h, w), img.dtype)
            for i in range(8):
                acc = acc + wx[..., i] * shift2d(
                    img, s, b + i - 3, pad_replicate
                )
            return acc

        out = taps(dx_bounds[0])
        for b in range(dx_bounds[0] + 1, dx_bounds[1] + 1):
            out = jnp.where(dxv == b, taps(b), out)
        return out

    rows = {
        s: hrow(s) for s in range(dy_bounds[0] - 3, dy_bounds[1] + 5)
    }
    out = jnp.zeros((h, w), img.dtype)
    for j in range(8):
        row_acc = rows[dy_bounds[0] + j - 3]
        for a in range(dy_bounds[0] + 1, dy_bounds[1] + 1):
            row_acc = jnp.where(dyv == a, rows[a + j - 3], row_acc)
        out = out + wy[..., j] * row_acc
    return out


def remap_bounded(
    img: Array, map_x: Array, map_y: Array,
    dy_bounds: Tuple[int, int], dx_bounds: Tuple[int, int],
    kind: str = "bilinear",
) -> Array:
    """Displacement-bounded remap (``kind`` "bilinear" or "lanczos4"): the
    select-chain remaps, bit-identical to the gather remaps when the bounds
    hold."""
    fn = remap_lanczos4_bounded if kind == "lanczos4" else remap_bilinear_bounded
    return fn(img, map_x, map_y, dy_bounds, dx_bounds)


def bilinear_sample(
    image: Array, offset: Tuple[float, float], width: int, height: int
) -> Array:
    """Fractional crop via bilinear interpolation (corr_ca/roi/helper.py:38-95).

    ``offset`` is (y, x) of the crop corner through pixel centers.
    """
    off_y, off_x = offset
    ys = jnp.arange(height, dtype=jnp.float32) + off_y
    xs = jnp.arange(width, dtype=jnp.float32) + off_x
    map_y, map_x = jnp.meshgrid(ys, xs, indexing="ij")
    return remap_bilinear(image, map_x, map_y)


def identity_map(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: (map_x, map_y) identity coordinate fields."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    return xs, ys
