"""Demosaic dispatch (reference: image.py:156-183)."""
from __future__ import annotations

from ..const import QualityDemosaic
from ..core.frame import DevelopedImage, RawFrame
from .ahd import demosaic_ahd
from .draft import demosaic_draft
from .eag import demosaic_eag

__all__ = [
    "demosaic",
    "demosaic_ahd",
    "demosaic_draft",
    "demosaic_eag",
]


def demosaic(
    frame: RawFrame,
    quality: QualityDemosaic = QualityDemosaic.Best,
    postprocess_steps: int = 1,
) -> DevelopedImage:
    """Demosaic a canonical-RGGB frame at the requested quality tier.

    Matches the reference dispatch (image.py:169-176). Un-canonicalization back to the
    source pattern happens in the develop pipeline, mirroring image.py:181.
    """
    if quality == QualityDemosaic.Best:
        return demosaic_ahd(frame, postprocess_stages=postprocess_steps)
    if quality == QualityDemosaic.Fast:
        return demosaic_eag(frame)
    if quality == QualityDemosaic.Draft:
        return demosaic_draft(frame)
    raise NotImplementedError(f"Quality mode not implemented: {quality}")
