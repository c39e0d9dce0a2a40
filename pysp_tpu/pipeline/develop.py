"""The develop pipeline: one jitted XLA program from normalized Bayer to sRGB.

This is the fused equivalent of the reference's canonical user flow
(README.md:55-63 / SURVEY.md §3.2):

    image.demosaic(quality) -> .to_lin_srgb() -> lin_srgb_to_srgb(...)

``DevelopConfig`` is a frozen, hashable dataclass used as a static jit argument, so the
compiled program specializes per configuration (the analog of the reference's
keyword-argument knobs; SURVEY.md §5 config row).

Batched develops: ``develop_burst`` vmaps over a leading frame axis — per-frame color
matrices and EVs ride along as vmapped pytree leaves.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..colorimetry.transforms import lin_srgb_to_srgb
from ..const import BayerPattern, QualityDemosaic
from ..core.bayer import reversible_transform_rggb
from ..core.frame import DevelopedImage, RawFrame
from ..demosaic import demosaic

Array = jnp.ndarray


@dataclasses.dataclass(frozen=True)
class DevelopConfig:
    """Static develop knobs (hashable — used as a static jit argument)."""

    quality: QualityDemosaic = QualityDemosaic.Best
    postprocess_stages: int = 1
    clip_highlights: bool = True
    gamma_encode: bool = True
    # "clip" = reference behavior (saturate at 1.0, blown areas render white);
    # "reconstruct" = rebuild clipped channels from unclipped ones + soft-knee
    # compress (correct/highlights.py) — a libraw capability the reference
    # never exposes.
    highlights: str = "clip"


def develop_to_image(frame: RawFrame, cfg: DevelopConfig) -> DevelopedImage:
    """Demosaic + un-canonicalize to the source pattern orientation (image.py:177-183)."""
    dev = demosaic(frame, cfg.quality, cfg.postprocess_stages)
    if frame.source_pattern != BayerPattern.Rggb:
        dev = dev.replace(
            image=reversible_transform_rggb(dev.image, frame.source_pattern)
        )
    return dev


def _demosaic_channels(frame: RawFrame, cfg: DevelopConfig):
    from ..demosaic.ahd import demosaic_ahd_channels
    from ..demosaic.draft import demosaic_draft_channels
    from ..demosaic.eag import demosaic_eag_channels

    if cfg.quality == QualityDemosaic.Best:
        return demosaic_ahd_channels(frame, cfg.postprocess_stages)
    if cfg.quality == QualityDemosaic.Fast:
        return demosaic_eag_channels(frame)
    if cfg.quality == QualityDemosaic.Draft:
        return demosaic_draft_channels(frame)
    raise NotImplementedError(f"Quality mode not implemented: {cfg.quality}")


def _color_tail_channels(
    r: Array, g: Array, b: Array, mat: Array,
    clip_highlights: bool, gamma_encode: bool,
):
    """Channelwise color tail: clip -> cam->lin-sRGB matrix -> sRGB gamma
    (cam_to_rgb_norm semantics, transform.py:21-53 + gamma :89-111)."""
    if clip_highlights:
        r = jnp.clip(r, 0.0, 1.0)
        g = jnp.clip(g, 0.0, 1.0)
        b = jnp.clip(b, 0.0, 1.0)
    ir = mat[0, 0] * r + mat[0, 1] * g + mat[0, 2] * b
    ig = mat[1, 0] * r + mat[1, 1] * g + mat[1, 2] * b
    ib = mat[2, 0] * r + mat[2, 1] * g + mat[2, 2] * b

    if gamma_encode:
        def gamma(x):
            x = jnp.clip(x, 0.0, 1.0)
            return jnp.where(
                x <= 0.0031308,
                x * 12.92,
                1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055,
            )

        ir, ig, ib = gamma(ir), gamma(ig), gamma(ib)
    return ir, ig, ib


@partial(jax.jit, static_argnames=("cfg",))
def develop(frame: RawFrame, cfg: DevelopConfig = DevelopConfig()) -> Array:
    """Full develop: demosaic -> camera->lin-sRGB -> (optional) gamma encode.

    Channelwise end-to-end with ONE channel stack at the very end, so every
    stage reads and writes plain 2D planes (see README design notes).
    Matches the stacked API path (demosaic().to_lin_srgb() + gamma) op for op.
    """
    from ..colorimetry.transforms import cam_to_lin_srgb_matrix

    if cfg.highlights == "reconstruct":
        from ..correct.highlights import (
            compress_highlights,
            reconstruct_highlights_channels,
        )

        r, g, b = _demosaic_channels(frame, cfg)
        r, g, b = reconstruct_highlights_channels(
            r, g, b, frame.wb_reciprocal(), frame.lim_sat
        )
        mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
        # no pre-matrix clip: super-white survives the matrix, then a soft
        # knee brings it under 1.0 with tonal separation before gamma
        ir, ig, ib = _color_tail_channels(r, g, b, mat, False, False)
        ir, ig, ib = (
            compress_highlights(jnp.maximum(c, 0.0)) for c in (ir, ig, ib)
        )
        if cfg.gamma_encode:
            from ..colorimetry.transforms import lin_srgb_to_srgb as _gamma

            ir, ig, ib = _gamma(ir), _gamma(ig), _gamma(ib)
        out = jnp.stack([ir, ig, ib], axis=-1).astype(jnp.float32)
        if frame.source_pattern != BayerPattern.Rggb:
            out = reversible_transform_rggb(out, frame.source_pattern)
        return out

    srgb = None
    if cfg.quality == QualityDemosaic.Draft and frame.bayer.ndim == 2:
        from ..demosaic.draft import develop_channels_draft

        # Polyphase fused Draft: tail at quarter res, one full-res assembly
        # (~1-ulp association delta against the separable upsample).
        srgb = develop_channels_draft(frame, cfg.clip_highlights, cfg.gamma_encode)

    if srgb is None and cfg.quality == QualityDemosaic.Fast and frame.bayer.ndim == 2:
        from ..demosaic.eag import develop_channels_eag

        # Polyphase fused Fast: the whole EAG + tail in phase space, one
        # full-res assembly per channel (no mid-pipeline interleaves).
        srgb = develop_channels_eag(frame, cfg.clip_highlights, cfg.gamma_encode)

    if srgb is None:
        r, g, b = _demosaic_channels(frame, cfg)
        mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
        ir, ig, ib = _color_tail_channels(
            r, g, b, mat, cfg.clip_highlights, cfg.gamma_encode
        )
    else:
        ir, ig, ib = srgb

    out = jnp.stack([ir, ig, ib], axis=-1).astype(jnp.float32)
    if frame.source_pattern != BayerPattern.Rggb:
        out = reversible_transform_rggb(out, frame.source_pattern)
    return out


@partial(jax.jit, static_argnames=("cfg",))
def develop_burst(frames: RawFrame, cfg: DevelopConfig = DevelopConfig()) -> Array:
    """Develop a burst: every pytree leaf of ``frames`` carries a leading batch axis.

    Frames run through lax.map (sequentially on-device), not vmap: one 24MP-class
    frame already fills the device, and sequential mapping keeps each frame on
    the single-frame program's layouts."""
    return jax.lax.map(lambda f: develop.__wrapped__(f, cfg), frames)


@partial(jax.jit, static_argnames=("cfg",))
def develop_with_stats(frame: RawFrame, cfg: DevelopConfig = DevelopConfig()):
    """Develop + structured per-stage statistics, one fused program.

    The observability the reference lacks (SURVEY.md §5): sensor clip fractions and
    output saturation stats ride along as scalars — negligible extra compute, no
    extra HBM passes.
    """
    from ..utils.tracing import bayer_stats, rgb_stats

    stats = {"sensor": bayer_stats(frame.bayer, frame.lim_sat)}
    out = develop.__wrapped__(frame, cfg)
    stats["output"] = rgb_stats(out)
    return out, stats
