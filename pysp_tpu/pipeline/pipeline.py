"""Statically-composed develop pipeline: corrections + HDR + demosaic in ONE jit.

The reference composes its pipeline as separate user calls mutating the raw in place
(README.md:55-76; SURVEY.md §3): repair_bad_pixels / flat_frame_correction /
fuse_exposures_to_raw, then demosaic().to_lin_srgb(). Here the same composition is a
frozen ``PipelineConfig`` used as a static jit argument, so the whole flow — per-frame
sensor corrections, Bayer-domain HDR fuse, demosaic, color tail — compiles to a single
XLA program: no host round-trips between stages, intermediates fused where XLA can.

Burst semantics: a batched ``RawFrame`` (leading axis N on every leaf) runs per-frame
corrections under ``lax.map`` (sequential on device — one frame already saturates the
chip; see develop_burst), then either fuses to one HDR frame (``fuse_hdr``) or
develops every frame.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.frame import RawFrame
from .develop import DevelopConfig, develop

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline composition knobs (hashable — a static jit argument).

    Stage order matches the reference's canonical flow (examples/full_pipeline.py):
    dark subtract -> flat field -> hot-pixel heal -> HDR fuse -> develop.
    """

    develop: DevelopConfig = DevelopConfig()
    # dark-frame subtraction (pass ``dark=`` at call time)
    dark_frame: bool = False
    # flat-field division (pass ``flat=`` at call time)
    flat_field: bool = False
    flat_clamp_high: bool = False
    # hot-pixel detect (median method) + diffusion heal, per frame
    repair_hot_pixels: bool = False
    hot_pixel_multiplier: float = 1.5
    hot_pixel_quantile: float = 0.9999
    # fillable cluster radius for masked_fill_inpaint (was 32 Jacobi sweeps)
    hot_pixel_iterations: int = 4
    # burst-consensus masks: flag pixels hot in >= this ratio of frames (None = per-frame)
    hot_pixel_shared_ratio: Optional[float] = None
    # Bayer-domain wavelet NR (correct/denoise.py); 0 = off, ~1 = noise floor
    denoise_strength: float = 0.0
    denoise_levels: int = 3
    # Bayer-domain HDR fuse of the (batched) input burst
    fuse_hdr: bool = False
    # EV the fuse normalizes to (None = mean of the burst's EVs)
    hdr_target_ev: Optional[float] = None

    @property
    def enables_per_frame_corrections(self) -> bool:
        """True iff ``_correct_one`` would apply at least one correction.

        The single source of truth for "does the config enable any per-frame
        correction": ``develop_pipeline`` uses it to skip the burst ``lax.map``
        (an identity scan body still materializes the carry — a full read+write
        copy of the burst), and any flag added to ``_correct_one`` must be added
        here or bursts would silently skip it while single frames apply it.
        """
        return (
            self.dark_frame
            or self.flat_field
            or self.repair_hot_pixels
            or self.denoise_strength > 0.0
        )


def _correct_one(
    frame: RawFrame,
    cfg: PipelineConfig,
    flat: Optional[RawFrame],
    dark: Optional[RawFrame],
    masks: Optional[Array],
    axis_name=None,
    core_rows=None,
) -> RawFrame:
    # Keep PipelineConfig.enables_per_frame_corrections in sync with the flags
    # consulted here — it gates whether bursts run this function at all.
    # ``axis_name``/``core_rows``: spatial row-sharding support — every global
    # statistic (flat means, hot-pixel quantile, denoise sigma) reduces
    # collectively over the shards' core rows (parallel/spatial_pipeline.py).
    from ..correct.bad_pixels import find_erroneous_pixels_median, repair_bad_pixels
    from ..correct.flat_field import dark_frame_subtraction, flat_frame_correction

    if cfg.dark_frame:
        frame = dark_frame_subtraction(frame, dark)
    if cfg.flat_field:
        frame = flat_frame_correction(
            frame,
            flat,
            clamp_high=cfg.flat_clamp_high,
            axis_name=axis_name,
            core_rows=core_rows,
        )
    if cfg.repair_hot_pixels:
        if masks is None:
            masks = find_erroneous_pixels_median(
                frame,
                cfg.hot_pixel_multiplier,
                cfg.hot_pixel_quantile,
                axis_name=axis_name,
                core_rows=core_rows,
            )
        frame = repair_bad_pixels(frame, masks, cfg.hot_pixel_iterations)
    if cfg.denoise_strength > 0.0:
        from ..correct.denoise import denoise_bayer_wavelet

        frame = denoise_bayer_wavelet(
            frame,
            cfg.denoise_strength,
            cfg.denoise_levels,
            axis_name=axis_name,
            core_rows=core_rows,
        )
    return frame


@partial(jax.jit, static_argnames=("cfg",))
def develop_pipeline(
    frames: RawFrame,
    cfg: PipelineConfig = PipelineConfig(),
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
) -> Array:
    """Run the composed pipeline as one XLA program.

    ``frames``: a single RawFrame, or a batched one (leading axis N on every leaf).
    Returns sRGB (H, W, 3) — or (N, H, W, 3) for a burst without ``fuse_hdr``.
    """
    from ..correct.bad_pixels import find_erroneous_pixels_median
    from ..correct.hdr import fuse_exposures_to_raw

    is_burst = frames.bayer.ndim == 3
    if cfg.fuse_hdr and not is_burst:
        raise ValueError("fuse_hdr requires a batched burst (leading frame axis)")

    shared_masks = None
    if (
        cfg.repair_hot_pixels
        and cfg.hot_pixel_shared_ratio is not None
        and is_burst
    ):
        # consensus across the burst (find_shared_pixels semantics, in-graph)
        per_frame = jax.lax.map(
            lambda f: find_erroneous_pixels_median(
                f, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile
            ),
            frames,
        )
        n = frames.bayer.shape[0]
        need = jnp.ceil(n * cfg.hot_pixel_shared_ratio)
        shared_masks = jnp.sum(per_frame.astype(jnp.int32), axis=0) >= need

    def correct(f):
        return _correct_one(f, cfg, flat, dark, shared_masks)

    # static: does the config enable any per-frame correction at all? If not, the
    # burst lax.map below would scan an identity body — XLA materializes the scan
    # carry, i.e. a full read+write copy of the burst (480 MB at 24 MP x5)
    # for nothing.
    any_corrections = cfg.enables_per_frame_corrections

    if is_burst:
        corrected = jax.lax.map(correct, frames) if any_corrections else frames
        if cfg.fuse_hdr:
            fused, _counts = fuse_exposures_to_raw(corrected, cfg.hdr_target_ev)
            return develop.__wrapped__(fused, cfg.develop)
        return jax.lax.map(
            lambda f: develop.__wrapped__(f, cfg.develop), corrected
        )

    return develop.__wrapped__(correct(frames), cfg.develop)
