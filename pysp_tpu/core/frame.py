"""Core pytree containers: RawFrame (Bayer-domain) and DevelopedImage (RGB-domain).

These replace the reference's mutable classes (`/root/reference/base_types/image_base.py`)
with immutable dataclass pytrees so the full develop pipeline is one jittable,
vmappable function. Device-relevant state (pixels, matrices, scalars) are leaves;
behavioral switches (HDR flag, source pattern) are static fields so the compiled
program specializes on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..const import BayerPattern

Array = jnp.ndarray


def _static(default):
    """A meta field: part of the pytree's structure (and so of jit's cache
    key), never a leaf."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with a functional ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


@_pytree_dataclass
class RawFrame:
    """A normalized Bayer frame plus the color metadata needed to develop it.

    Equivalent of the reference's RawRggbBayerData (image_base.py:66-124): the mosaic is
    already canonicalized to RGGB and normalized to [0,1]. ``cam_mat`` / ``wb_neutral``
    come from the (host-side) white-balance solver: ``cam_mat`` is the optimal XYZ->cam
    matrix and ``wb_neutral`` the camera neutral point, so reciprocal multipliers are
    ``1 / wb_neutral`` (cam_wb.py:236-243).
    """

    bayer: Array                      # (H, W) float32 in [0,1] (RGGB order)
    cam_mat: Array                    # (3, 3) XYZ -> camera matrix (optimal blend)
    cam_white: Array                  # (3,) scene illuminant XYZ (optimal_mat.xyz)
    wb_neutral: Array                 # (3,) camera neutral; reciprocal = WB gains
    ev: Array                         # () exposure value
    lim_sat: Array                    # () saturation ceiling (>1 for HDR stacks)
    is_hdr: bool = _static(False)
    source_pattern: BayerPattern = _static(BayerPattern.Rggb)

    @property
    def height(self) -> int:
        return self.bayer.shape[-2]

    @property
    def width(self) -> int:
        return self.bayer.shape[-1]

    def wb_reciprocal(self) -> Array:
        """Reciprocal neutral multipliers (reference: cam_wb.py:236-243)."""
        return 1.0 / self.wb_neutral

    @classmethod
    def synthetic(
        cls,
        bayer: Array,
        cam_mat: Optional[Array] = None,
        cam_white: Optional[Array] = None,
        wb_neutral: Optional[Array] = None,
        ev: float = 10.0,
        lim_sat: float = 1.0,
        is_hdr: bool = False,
        source_pattern: BayerPattern = BayerPattern.Rggb,
    ) -> "RawFrame":
        """Build a frame with identity color metadata — for tests and benchmarks."""
        if cam_mat is None:
            cam_mat = jnp.eye(3, dtype=jnp.float32)
        if cam_white is None:
            # D65 whitepoint at Y=1
            cam_white = jnp.array([0.95043, 1.0, 1.08890], dtype=jnp.float32)
        if wb_neutral is None:
            wb_neutral = jnp.ones(3, dtype=jnp.float32)
        return cls(
            bayer=jnp.asarray(bayer, jnp.float32),
            cam_mat=jnp.asarray(cam_mat, jnp.float32),
            cam_white=jnp.asarray(cam_white, jnp.float32),
            wb_neutral=jnp.asarray(wb_neutral, jnp.float32),
            ev=jnp.asarray(ev, jnp.float32),
            lim_sat=jnp.asarray(lim_sat, jnp.float32),
            is_hdr=is_hdr,
            source_pattern=source_pattern,
        )


@_pytree_dataclass
class DevelopedImage:
    """Post-demosaic RGB container (reference: RawDemosaicData, image_base.py:19-64).

    ``image`` is camera-space RGB. WB application state is tracked functionally:
    ``wb_apply`` / ``wb_undo`` return new instances instead of mutating.
    """

    image: Array                      # (H, W, 3) camera-space RGB
    wb_coeff: Array                   # (3,) reciprocal multipliers used at demosaic
    cam_mat: Array                    # (3, 3) XYZ -> camera matrix
    cam_white: Array                  # (3,) scene illuminant XYZ
    ev: Array                         # ()
    wb_applied: bool = _static(True)
    wb_normalized: bool = _static(False)

    def wb_apply(self) -> "DevelopedImage":
        """Apply WB coefficients if not already applied (image_base.py:45-50)."""
        if self.wb_applied:
            return self
        return self.replace(image=self.image * self.wb_coeff[:3], wb_applied=True)

    def wb_undo(self) -> "DevelopedImage":
        """Return to pure camera space, removing normalization (image_base.py:52-60)."""
        if not self.wb_applied:
            return self
        image = self.image
        if self.wb_normalized:
            image = image * jnp.max(self.wb_coeff)
        image = image / self.wb_coeff[:3]
        return self.replace(image=image, wb_applied=False, wb_normalized=False)

    def to_lin_srgb(self, clip_highlights: bool = True) -> Array:
        """WB-apply then convert camera RGB to linear sRGB (image_base.py:62-64)."""
        from ..colorimetry.transforms import cam_to_lin_srgb

        applied = self.wb_apply()
        return cam_to_lin_srgb(applied.image, self.cam_mat, self.cam_white, clip_highlights)
