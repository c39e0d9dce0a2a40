"""Blind in-raw chromatic aberration: model fitting orchestration + removal.

Reference behavior: /root/reference/corr_ca/ca_removal.py (roughly following
DOI 10.1109/ACCESS.2021.3096201):
- fit (:15-46): structural instability -> per-channel radial scale pairs -> model fit
- removal (:48-132): upsample G alone; warp G onto the R/B grids (inverse model +
  bilinear remap), G-guided upsample of R/B, forward-warp back onto the G grid,
  re-sample at the Bayer phase and overwrite the raw planes.

Fitting is host-side (ROI screening + scalar fits); removal is one jittable device
program per channel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ...core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ...core.frame import RawFrame
from ...demosaic.eag import resample_b, resample_g_to_full_resolution, resample_r
from ...ops.resample import remap_bilinear
from .instability import compute_structural_instability
from .models import CaCorrectionModel, Poly5CorrectionModel, ReversibleModelMixin
from .solver import get_scale_pairs_using_pooled_tiler

Array = jnp.ndarray


def compute_ca_lens_models_for_raw(
    frame: RawFrame,
    init_model_r: Optional[CaCorrectionModel] = None,
    init_model_b: Optional[CaCorrectionModel] = None,
    max_distortion_additional_scale: float = 0.004,
) -> Tuple[Optional[CaCorrectionModel], Optional[CaCorrectionModel]]:
    """Fit R->G and B->G alignment models from a single raw (ca_removal.py:15-46).

    Passing ``None`` for a model skips that channel; by default fresh Poly5 models are
    fitted for both (the reference's mutable-default instances are avoided).
    """
    if init_model_r is None:
        init_model_r = Poly5CorrectionModel()
    if init_model_b is None:
        init_model_b = Poly5CorrectionModel()

    si = np.asarray(compute_structural_instability(frame))

    init_model_r.compute_coefficients(
        get_scale_pairs_using_pooled_tiler(
            si[:, :, 0], si[:, :, 1], max_reach=max_distortion_additional_scale
        )
    )
    init_model_b.compute_coefficients(
        get_scale_pairs_using_pooled_tiler(
            si[:, :, 2], si[:, :, 1], max_reach=max_distortion_additional_scale
        )
    )
    return init_model_r, init_model_b


def _maps_from_offsets(coords: Array, h: int, w: int):
    """Center-relative (dy, dx) coordinate field -> clipped (map_x, map_y)."""
    map_x = jnp.clip(coords[..., 1] + (w - 1) / 2.0, 0, w - 1)
    map_y = jnp.clip(coords[..., 0] + (h - 1) / 2.0, 0, h - 1)
    return map_x, map_y


def _remap_by_offsets(
    channel: Array, coords: Array, bound_px: Optional[int] = None
) -> Array:
    """cv2.remap with the reference's center-relative coordinate plumbing
    (ca_removal.py:100-128): coords[..., 0] is dy, [..., 1] is dx.

    With ``bound_px`` (a static displacement bound in pixels) the gather-free
    bounded remap runs — bit-identical to the gather remap."""
    h, w = channel.shape[-2], channel.shape[-1]
    map_x, map_y = _maps_from_offsets(coords, h, w)
    if bound_px is not None:
        from ...ops.resample import remap_bounded

        b = (-bound_px, bound_px)
        return remap_bounded(channel, map_x, map_y, b, b, kind="bilinear")
    return remap_bilinear(channel, map_x, map_y)


def _model_bound_px(model, h: int, w: int, cap: int = 12) -> Optional[int]:
    """Static per-axis displacement bound of a radial model's remap, in px.

    |dy| = |y|·|f(r)/r - 1| <= r_corner·max_r|f(r) - r| for both the forward
    and Newton-inverted maps; evaluated on a dense host radius sweep at trace
    time (model coefficients are host floats). None when the model misbehaves
    or the bound exceeds ``cap`` (select-chain cost grows with it)."""
    try:
        import jax

        # the models' radial maps are jnp code; under a jit trace even
        # concrete-input ops become tracers, so force compile-time eval
        with jax.ensure_compile_time_eval():
            rs = jnp.asarray(np.linspace(1e-4, 1.0, 4096), jnp.float32)
            fwd = np.asarray(model.get_distorted(rs), np.float64)
            inv = np.asarray(model.estimate_undistorted(rs), np.float64)
    except Exception:
        return None
    rs64 = np.asarray(rs, np.float64)
    dev = max(np.abs(fwd - rs64).max(), np.abs(inv - rs64).max())
    if not np.isfinite(dev):
        return None
    r_corner = float(np.hypot((h - 1) / 2.0, (w - 1) / 2.0))
    bound = int(np.ceil(dev * r_corner)) + 2
    return bound if bound <= cap else None


def remove_ca_from_raw(
    frame: RawFrame,
    lens_model_r: Optional[CaCorrectionModel],
    lens_model_b: Optional[CaCorrectionModel],
) -> RawFrame:
    """Align R/B onto G in the mosaic; returns a corrected frame (ca_removal.py:48-132).

    Models must be reversible (forward + inverse radial maps)."""
    if lens_model_r is None and lens_model_b is None:
        return frame

    for name, model in (("Red", lens_model_r), ("Blue", lens_model_b)):
        if model is not None and not isinstance(model, ReversibleModelMixin):
            raise ValueError(
                f"{name} lens model is not reversible so green cannot be re-aligned "
                "to remove error. Use a reversible model and try again."
            )

    if frame.bayer.ndim == 3:
        import jax

        return jax.lax.map(
            lambda f: remove_ca_from_raw(f, lens_model_r, lens_model_b), frame
        )

    r, g1, b, g2 = bayer_to_rgbg(frame.bayer)
    g_resampled = resample_g_to_full_resolution(g1, g2)
    wb = frame.wb_reciprocal()

    fh, fw = g_resampled.shape[-2], g_resampled.shape[-1]

    if lens_model_r is not None:
        bound_r = _model_bound_px(lens_model_r, fh, fw)
        coords_g_at_r = lens_model_r.get_undistorted_coordinates(g_resampled)
        g_at_r = _remap_by_offsets(g_resampled, coords_g_at_r, bound_r)

        r_resampled = resample_r(r * wb[0], g_at_r)

        coords_r_at_g = lens_model_r.get_distorted_coordinates(r_resampled)
        r_at_g = _remap_by_offsets(r_resampled, coords_r_at_g, bound_r)

        r = bayer_to_rgbg(r_at_g)[0] / wb[0]

    if lens_model_b is not None:
        bound_b = _model_bound_px(lens_model_b, fh, fw)
        coords_g_at_b = lens_model_b.get_undistorted_coordinates(g_resampled)
        g_at_b = _remap_by_offsets(g_resampled, coords_g_at_b, bound_b)

        b_resampled = resample_b(b * wb[2], g_at_b)

        coords_b_at_g = lens_model_b.get_distorted_coordinates(b_resampled)
        b_at_g = _remap_by_offsets(b_resampled, coords_b_at_g, bound_b)

        b = bayer_to_rgbg(b_at_g)[2] / wb[2]

    return frame.replace(bayer=rgbg_to_bayer(r, g1, b, g2))
