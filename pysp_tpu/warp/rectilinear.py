"""DNG 1.4 WarpRectilinear coordinate tables + fused resample.

Reference behavior: /root/reference/dng_warp_corr/dng_warp_rectilinear_coords.pyx —
the radial polynomial ``f = kr0 + kr1 r^2 + kr2 r^4 + kr3 r^6`` plus tangential
``kt0/kt1`` terms, normalized by the max corner distance m, with ``scale`` lerping
identity<->full warp; grid variant (:18-40) and seed/prior variant (:44-65) that lets
warps compose with a single resample (``stack_warp_prior``,
chan_distortion_corr.py:11-41).

The reference runs this as an OpenMP Cython kernel then a separate cv2.remap; here the
table is broadcast arithmetic that XLA fuses straight into the gather — one pass over
HBM instead of two.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax.numpy as jnp

from ..ops.resample import remap_bilinear, remap_lanczos4

Array = jnp.ndarray


def _warp_coords(
    seed_x: Array,
    seed_y: Array,
    coeffs: Array,  # (6,): kr0 kr1 kr2 kr3 kt0 kt1
    m: Array,
    center_x: Array,
    center_y: Array,
    scale: float,
) -> Tuple[Array, Array]:
    kr0, kr1, kr2, kr3, kt0, kt1 = (coeffs[i] for i in range(6))

    dx = (seed_x - center_x) / m
    dy = (seed_y - center_y) / m
    r2 = dx * dx + dy * dy
    f = kr0 + r2 * (kr1 + r2 * (kr2 + r2 * kr3))

    dxr = f * dx
    dyr = f * dy
    dxt = kt0 * (2 * dx * dy) + kt1 * (r2 + 2 * dx * dx)
    dyt = kt1 * (2 * dx * dy) + kt0 * (r2 + 2 * dy * dy)

    xp = center_x + m * (dxr + dxt)
    yp = center_y + m * (dyr + dyt)

    out_x = seed_x + (xp - seed_x) * scale
    out_y = seed_y + (yp - seed_y) * scale
    return out_x, out_y


def _geometry(width: int, height: int, cam_center_norm: Tuple[float, float]):
    cx = (width - 1) * cam_center_norm[0]
    cy = (height - 1) * cam_center_norm[1]
    max_dist_x = max(abs(-cx), abs(width - 1 - cx))
    max_dist_y = max(abs(-cy), abs(height - 1 - cy))
    m = (max_dist_x**2 + max_dist_y**2) ** 0.5
    return cx, cy, m


def compute_remapping_table(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
) -> Tuple[Array, Array]:
    """(map_x, map_y) warp tables from the pixel grid (.pyx:67-80)."""
    cx, cy, m = _geometry(width, height, cam_center_norm)
    ys = jnp.arange(height, dtype=jnp.float32)[:, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]
    seed_x = jnp.broadcast_to(xs, (height, width))
    seed_y = jnp.broadcast_to(ys, (height, width))
    return _warp_coords(
        seed_x, seed_y, jnp.asarray(coeffs, jnp.float32),
        jnp.float32(m), jnp.float32(cx), jnp.float32(cy), scale,
    )


def compute_remapping_table_window(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
    row0,
    n_rows: int,
) -> Tuple[Array, Array]:
    """Warp tables for output rows [row0, row0+n_rows) of a FULL frame.

    Same values as ``compute_remapping_table(...)[row0:row0+n_rows]`` but built
    directly at the absolute rows (``row0`` may be a traced scalar) — the
    spatial row-sharding primitive: geometry (center, corner normalization)
    stays that of the full ``height`` x ``width`` frame, so per-shard maps
    re-base by integer row offsets exactly.
    """
    cx, cy, m = _geometry(width, height, cam_center_norm)
    ys = (jnp.arange(n_rows, dtype=jnp.float32) + row0)[:, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]
    seed_x = jnp.broadcast_to(xs, (n_rows, width))
    seed_y = jnp.broadcast_to(ys, (n_rows, width))
    return _warp_coords(
        seed_x, seed_y, jnp.asarray(coeffs, jnp.float32),
        jnp.float32(m), jnp.float32(cx), jnp.float32(cy), scale,
    )


def compute_offset_remapping_table(
    seed_x: Array,
    seed_y: Array,
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
) -> Tuple[Array, Array]:
    """Warp tables from a prior coordinate field (.pyx:82-96) — warp composition."""
    cx, cy, m = _geometry(width, height, cam_center_norm)
    return _warp_coords(
        seed_x, seed_y, jnp.asarray(coeffs, jnp.float32),
        jnp.float32(m), jnp.float32(cx), jnp.float32(cy), scale,
    )


def _floor_disp_minmax(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
):
    """Memoizing front end for :func:`_floor_disp_minmax_impl` — a warp's
    bounds are queried repeatedly while tracing (per channel and across
    retraces), and each query is a full f64 sweep of the frame."""
    return _floor_disp_minmax_impl(
        tuple(float(v) for v in coeffs),
        width,
        height,
        (float(cam_center_norm[0]), float(cam_center_norm[1])),
        float(scale),
    )


@functools.lru_cache(maxsize=256)
def _floor_disp_minmax_impl(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float,
):
    """EXACT floor-displacement extrema of the map over the output frame.

    Sweeps EVERY pixel in f64 (blockwise, ~256 rows at a
    time, so 24 MP frames never materialize a full-frame f64 field) and
    reduces min/max of ``floor(map) - index`` per axis. An exact sweep needs
    only margin 1 — the f32 device map can floor at most one integer away from
    the f64 value — where a coarse grid sweep would need a wider margin (and
    longer select chains) to cover the gaps between its samples.
    """
    import numpy as np

    cx, cy, m = _geometry(width, height, cam_center_norm)
    k = np.asarray(coeffs, np.float64)
    xs = np.arange(width, dtype=np.float64)[None, :]
    dy_lo = dy_hi = dx_lo = dx_hi = None
    for b0 in range(0, height, 256):
        b1 = min(b0 + 256, height)
        sy = np.arange(b0, b1, dtype=np.float64)[:, None]
        dx = (xs - cx) / m
        dy = (sy - cy) / m
        r2 = dx * dx + dy * dy
        f = k[0] + r2 * (k[1] + r2 * (k[2] + r2 * k[3]))
        dxt = k[4] * (2 * dx * dy) + k[5] * (r2 + 2 * dx * dx)
        dyt = k[5] * (2 * dx * dy) + k[4] * (r2 + 2 * dy * dy)
        xp = cx + m * (f * dx + dxt)
        yp = cy + m * (f * dy + dyt)
        out_x = np.clip(xs + (xp - xs) * scale, 0, width - 1)
        out_y = np.clip(sy + (yp - sy) * scale, 0, height - 1)
        fdy = np.floor(out_y) - sy
        fdx = np.floor(out_x) - xs
        dy_lo = fdy.min() if dy_lo is None else min(dy_lo, fdy.min())
        dy_hi = fdy.max() if dy_hi is None else max(dy_hi, fdy.max())
        dx_lo = fdx.min() if dx_lo is None else min(dx_lo, fdx.min())
        dx_hi = fdx.max() if dx_hi is None else max(dx_hi, fdx.max())
    return (int(dy_lo), int(dy_hi)), (int(dx_lo), int(dx_hi))


def displacement_bounds(
    coeffs,
    width: int,
    height: int,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    margin: int = 1,
    cap: int = 17,
):
    """Static floor-index displacement bounds of the rectilinear map.

    Evaluated host-side at trace time over EVERY output pixel
    (``_floor_disp_minmax``), so ``margin`` only needs to absorb the
    f32-vs-f64 floor crossing (1 px). Returns ((dy_lo, dy_hi), (dx_lo, dx_hi))
    for the bounded remaps, or None when either range exceeds ``cap``
    (select-chain cost grows with the range; huge warps fall back to the
    gather path).
    """
    (fy_lo, fy_hi), (fx_lo, fx_hi) = _floor_disp_minmax(
        coeffs, width, height, cam_center_norm, scale
    )
    dyb = (fy_lo - margin, fy_hi + margin)
    dxb = (fx_lo - margin, fx_hi + margin)
    if max(dyb[1] - dyb[0], dxb[1] - dxb[0]) > 2 * cap:
        return None
    return dyb, dxb


def warp_channel_rectilinear(
    channel: Array,
    coeffs,
    cam_center_norm: Tuple[float, float],
    scale: float = 1.0,
    prior: Optional[Tuple[Array, Array]] = None,
    interpolation: str = "lanczos4",
    bounds=None,
) -> Array:
    """Fused table + resample for one channel (chan_distortion_corr.py:86-98).

    Coordinates are clipped into the image bounds exactly like the reference's
    np.clip before cv2.remap (:94-97). When the warp's displacement bounds are
    statically known (always, for a bare coefficient warp; via ``bounds`` for
    prior-composed tables) the gather-free bounded remap runs instead.
    """
    h, w = channel.shape[-2], channel.shape[-1]
    if prior is None:
        map_x, map_y = compute_remapping_table(coeffs, w, h, cam_center_norm, scale)
        if bounds is None:
            bounds = displacement_bounds(coeffs, w, h, cam_center_norm, scale)
    else:
        map_x, map_y = compute_offset_remapping_table(
            prior[0], prior[1], coeffs, w, h, cam_center_norm, scale
        )
    map_x = jnp.clip(map_x, 0, w - 1)
    map_y = jnp.clip(map_y, 0, h - 1)
    if bounds is not None:
        from ..ops.resample import remap_bounded

        return remap_bounded(
            channel, map_x, map_y, bounds[0], bounds[1], kind=interpolation
        )
    remap = remap_lanczos4 if interpolation == "lanczos4" else remap_bilinear
    return remap(channel, map_x, map_y)
