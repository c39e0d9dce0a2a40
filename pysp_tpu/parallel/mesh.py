"""Device mesh helpers for batched / spatially-sharded develops.

The reference has no multi-device execution of any kind (SURVEY.md §2.10); this layer
is an additive capability: a ('batch', 'spatial') mesh where the batch axis
data-parallels burst frames and the spatial axis shards a single large sensor's rows
with halo exchange. The cards of one host reach each other all to all (NVLink), so
the mesh shape follows the algorithm alone.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

BATCH_AXIS = "batch"
SPATIAL_AXIS = "spatial"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('batch', 'spatial') mesh.

    With no shape, all devices go to the batch axis (the common burst-develop case).
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices), 1)
    need = shape[0] * shape[1]
    assert need <= len(devices), f"mesh shape {shape} needs {need} devices"
    arr = np.asarray(devices[:need]).reshape(shape)
    return Mesh(arr, (BATCH_AXIS, SPATIAL_AXIS))
