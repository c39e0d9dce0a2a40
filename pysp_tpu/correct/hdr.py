"""HDR exposure stacking, Bayer-domain and RGB-domain.

Reference behavior: /root/reference/raw_hdr.py — EV-normalize each frame
(``2^(ev - target)``), weight by the tent curve ``0.5 - |x - 0.5|`` times a noise bias
``1.6^(-0.1*|ev_offset * wb_plane_weight|)`` (WB-aware per-plane weighting in the raw
variant, :127-137), weighted-average, and fall back to the brightest frame where total
weight is zero (:143-148).

Shape: inputs are batched pytrees (leading frame axis N) so the whole fuse is
one fused reduction — no per-frame Python loop, vmappable and shardable over the batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..colorimetry.transforms import cam_to_lin_srgb
from ..core.frame import DevelopedImage, RawFrame

Array = jnp.ndarray


def fuse_exposures_to_raw(
    frames: RawFrame, target_ev: Optional[float] = None
) -> Tuple[RawFrame, Array]:
    """Fuse a batched RawFrame (leading axis N on every leaf) into one HDR raw.

    Returns (HDR frame, per-pixel contribution counts). The output keeps the first
    frame's color metadata, ``lim_sat = max(ev_offsets)`` and the HDR flag set
    (raw_hdr.py:85-158).
    """
    evs = frames.ev  # (N,)
    if target_ev is None:
        target = jnp.mean(evs)
    else:
        target = jnp.asarray(target_ev, jnp.float32)

    ev_offsets = 2.0 ** (evs - target)  # (N,)

    # The per-photosite WB noise bias depends only on (frame, CFA phase) — 4
    # scalars per frame. The first formulation materialized it full-res via a
    # rgbg_to_bayer interleave (a relayout pass at 5x24 MP). Broadcasting the tiny (N, 2, 2) bias table by row/column-parity selects
    # keeps everything in the native (N, H, W) layout and fuses into the single
    # reduction pass. The scalar math per element is unchanged (same multiply/
    # abs/pow on the same values), so the fuse stays bit-identical to the
    # reference transcription.
    n, h, w = frames.bayer.shape
    wb = 1.0 / frames.wb_neutral[0]  # first frame's reciprocal multipliers (3,)
    wpat = jnp.stack(
        [jnp.stack([wb[0], wb[1]]), jnp.stack([wb[1], wb[2]])]
    )  # (2, 2): RGGB mosaic [[r, g], [g, b]]

    off = ev_offsets[:, None, None]
    bias22 = 1.6 ** (-0.1 * jnp.abs(ev_offsets[:, None, None] * wpat[None]))  # (N,2,2)
    row_odd = (jnp.arange(h, dtype=jnp.int32) & 1)[:, None] == 1  # (H,1)
    col_odd = (jnp.arange(w, dtype=jnp.int32) & 1)[None, :] == 1  # (1,W)
    sel = lambda a, b_: jnp.where(col_odd, b_, a)  # noqa: E731
    bias = jnp.where(
        row_odd,
        sel(bias22[:, 1:2, 0:1], bias22[:, 1:2, 1:2]),
        sel(bias22[:, 0:1, 0:1], bias22[:, 0:1, 1:2]),
    )  # (N, H, W) by broadcast — never materialized standalone
    weights = (0.5 - jnp.abs(frames.bayer - 0.5)) * bias

    # ONE variadic reduce pass over the (N, H, W) stack for all four outputs:
    # jnp.sum twice + a dynamic-slice fallback + a count pass would each re-read
    # the 480 MB burst (5x24 MP). The brightest-frame fallback folds into the same pass
    # as a one-hot select summed over N (exactly one nonzero term — adding f32
    # zeros is exact, so that value is bit-identical to the sliced frame). The
    # weighted sums may associate in a different order than jnp.sum's lowering
    # (measured ~4e-7 vs the transcription at N=5; gate is 1e-5).
    idx_max = jnp.argmax(ev_offsets)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, frames.bayer.shape, 0)
    sel_pix = jnp.where(iota_n == idx_max, frames.bayer, 0.0)
    zero = jnp.zeros((), frames.bayer.dtype)

    sum_weight, sum_pixel, max_pix, debug_counts = jax.lax.reduce(
        (
            weights,
            frames.bayer * weights * off,
            sel_pix,
            (weights > 0).astype(jnp.int32),
        ),
        (zero, zero, zero, jnp.zeros((), jnp.int32)),
        lambda a, b: (a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3]),
        (0,),
    )
    max_exposure = max_pix * jnp.max(ev_offsets)

    fused = jnp.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)

    first = lambda leaf: jnp.take(leaf, 0, axis=0)  # noqa: E731
    hdr = RawFrame(
        bayer=fused.astype(jnp.float32),
        cam_mat=first(frames.cam_mat),
        cam_white=first(frames.cam_white),
        wb_neutral=first(frames.wb_neutral),
        ev=target,
        lim_sat=jnp.max(ev_offsets),
        is_hdr=True,
        source_pattern=frames.source_pattern,
    )
    return hdr, debug_counts


def fuse_exposures_from_debayer(
    images: DevelopedImage, target_ev: Optional[float] = None
) -> Tuple[Array, Array]:
    """Fuse batched demosaiced images to linear sRGB HDR (raw_hdr.py:7-83).

    ``images`` carries a leading batch axis on every leaf; WB must be applied (the
    standard demosaic output state). Weights are computed on the WB-undone pixels, the
    accumulation on the WB-applied pixels, exactly like the reference's
    wb_undo/wb_apply dance (:54-65).
    """
    evs = images.ev
    if target_ev is None:
        target = jnp.mean(evs)
    else:
        target = jnp.asarray(target_ev, jnp.float32)

    ev_offsets = 2.0 ** (evs - target)  # (N,)
    off = ev_offsets[:, None, None, None]

    undone = images.image / images.wb_coeff[:, None, None, :3]
    weights = 0.5 - jnp.abs(undone - 0.5)
    bias = 1.6 ** (-0.1 * off)
    weights = weights * bias

    sum_weight = jnp.sum(weights, axis=0)
    sum_pixel = jnp.sum(images.image * weights * off, axis=0)

    idx_max = jnp.argmax(ev_offsets)
    max_exposure = jax.lax.dynamic_index_in_dim(
        images.image, idx_max, axis=0, keepdims=False
    ) * jnp.max(ev_offsets)

    fused = jnp.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)
    debug_counts = jnp.sum((weights > 0).astype(jnp.int32), axis=0)

    lin = cam_to_lin_srgb(
        fused.astype(jnp.float32),
        jnp.take(images.cam_mat, 0, axis=0),
        jnp.take(images.cam_white, 0, axis=0),
        clip_highlights=False,
    )
    return lin, debug_counts
