"""DNG OpcodeList3 parsing + WarpRectilinear application (host parse, device warp).

Reference behavior: /root/reference/dng_warp_corr/chan_distortion_corr.py — opcode
stream walk (:102-121), big-endian WarpRectilinear decode (plane count, 6 doubles per
plane kr0-3 + kt0-1, optical center; :67-84), per-plane warp (:86-98), and
``stack_warp_prior`` composition so a custom (e.g. CA) remap and the DNG warp resample
ONCE (:11-41).

Also provides an opcode *encoder* for synthetic test DNGs.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.resample import identity_map
from .rectilinear import warp_channel_rectilinear

Array = jnp.ndarray

OPCODE_WARP_RECTILINEAR = 1


def stack_warp_prior(
    image_shape: Tuple[int, int],
    remap_r: Optional[Tuple[Array, Array]],
    remap_g: Optional[Tuple[Array, Array]],
    remap_b: Optional[Tuple[Array, Array]],
) -> List[Tuple[Array, Array]]:
    """Combine per-channel (map_x, map_y) fields, identity-filling missing channels
    (chan_distortion_corr.py:11-41)."""
    h, w = image_shape
    ident = None
    out = []
    for remap in (remap_r, remap_g, remap_b):
        if remap is None:
            if ident is None:
                ix, iy = identity_map(h, w)
                ident = (jnp.asarray(ix), jnp.asarray(iy))
            out.append(ident)
        else:
            out.append((jnp.asarray(remap[0]), jnp.asarray(remap[1])))
    return out


def decode_warp_rectilinear(data: bytes, n_planes_expected: int):
    """Decode a WarpRectilinear operator block; None if malformed
    (chan_distortion_corr.py:67-84)."""
    if len(data) < 4:
        return None
    count_planes = int.from_bytes(data[:4], byteorder="big")
    if len(data) != 4 + 6 * 8 * count_planes + 16 or count_planes != n_planes_expected:
        return None
    coefficients = []
    for idx in range(count_planes):
        coefficients.append(
            struct.unpack(">6d", data[4 + 48 * idx : 4 + 48 * (idx + 1)])
        )
    center = struct.unpack(
        ">2d", data[4 + 48 * count_planes : 4 + 48 * count_planes + 16]
    )
    return coefficients, center


def iter_opcodes(block: bytes):
    """Yield (opcode_id, version, flags, data) from an OpcodeList block
    (chan_distortion_corr.py:102-121)."""
    count = int.from_bytes(block[:4], byteorder="big")
    offset = 4
    for _ in range(count):
        opcode_id = int.from_bytes(block[offset : offset + 4], "big")
        version = int.from_bytes(block[offset + 4 : offset + 8], "big")
        flags = int.from_bytes(block[offset + 8 : offset + 12], "big")
        var_len = int.from_bytes(block[offset + 12 : offset + 16], "big")
        offset += 16
        yield opcode_id, version, flags, block[offset : offset + var_len]
        offset += var_len


def apply_opcode_3_warp(
    image: Array,
    opcode_block: bytes,
    scale: float = 1.0,
    prior: Optional[Sequence[Tuple[Array, Array]]] = None,
    interpolation: str = "lanczos4",
) -> Array:
    """Apply WarpRectilinear operators from an OpcodeList3 block to an (H, W, C) image.

    Unlike the reference (in-place mutation, chan_distortion_corr.py:43-121), returns a
    new image. Unknown opcodes are skipped.
    """
    image = jnp.asarray(image)
    h, w, c = image.shape

    for opcode_id, _ver, _flags, data in iter_opcodes(opcode_block):
        if opcode_id != OPCODE_WARP_RECTILINEAR:
            continue
        decoded = decode_warp_rectilinear(data, c)
        if decoded is None:
            continue
        coefficients, center = decoded
        planes = []
        for idx, coeff in enumerate(coefficients):
            chan_prior = None if prior is None else prior[idx]
            planes.append(
                warp_channel_rectilinear(
                    image[:, :, idx],
                    coeff,
                    center,
                    scale=scale,
                    prior=chan_prior,
                    interpolation=interpolation,
                )
            )
        image = jnp.stack(planes, axis=-1)
    return image


def encode_warp_rectilinear(
    coefficients: Sequence[Sequence[float]],
    center: Tuple[float, float],
    version: int = 0x01030000,
    flags: int = 0,
) -> bytes:
    """Encode one WarpRectilinear opcode into an OpcodeList3 block (test fixture
    generator; inverse of decode_warp_rectilinear)."""
    body = struct.pack(">L", len(coefficients))
    for coeff in coefficients:
        assert len(coeff) == 6
        body += struct.pack(">6d", *coeff)
    body += struct.pack(">2d", *center)

    block = struct.pack(">L", 1)  # one opcode
    block += struct.pack(">LLLL", OPCODE_WARP_RECTILINEAR, version, flags, len(body))
    block += body
    return block
