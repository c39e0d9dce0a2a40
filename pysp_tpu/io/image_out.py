"""Developed-image output: PNG (8/16-bit), 16-bit TIFF, and JPEG via Pillow.

The reference has no output path at all (users got a NumPy array). PNG and TIFF
need nothing beyond the standard library: the native stored-deflate writer when
it is built, otherwise the zlib writer here. Pillow is optional, for JPEG only.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import tiff as T


def to_uint8(srgb: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(srgb, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def to_uint16(srgb: np.ndarray) -> np.ndarray:
    return np.clip(
        np.asarray(srgb, np.float32) * 65535.0 + 0.5, 0, 65535
    ).astype(np.uint16)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode (H, W, 3) or (H, W) uint8/uint16 pixels as a zlib-compressed PNG
    (filter type 0 on every row) with the standard library alone."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"encode_png supports 1 or 3 channels, got {c}")
    if img.dtype == np.uint16:
        depth, raw = 16, img.astype(">u2")
    elif img.dtype == np.uint8:
        depth, raw = 8, img
    else:
        raise ValueError(f"encode_png takes uint8 or uint16, got {img.dtype}")
    rows = np.ascontiguousarray(raw).view(np.uint8).reshape(h, -1)
    scanlines = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if c == 3 else 0, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(scanlines.tobytes(), level))
        + chunk(b"IEND", b"")
    )


def _write_png(path: str, pixels: np.ndarray, fast: bool) -> None:
    from . import native

    if fast and native.has_png():
        data = native.png_encode(pixels)
    else:
        data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)


def save_image(path: str, srgb: np.ndarray, fast_png: bool = True) -> None:
    """Save an sRGB float image ([0,1], (H, W, 3)) by extension: .png (8-bit),
    .tif/.tiff as built-in uncompressed 16-bit RGB TIFF, anything else
    (.jpg, ...) through Pillow.

    ``fast_png=True`` (default) uses the native stored-deflate PNG writer when
    built — bit-identical pixels through any decoder, no compression pass, at
    larger files. ``fast_png=False``, or a tree without the native build,
    writes a zlib-compressed PNG with the standard library.
    """
    lower = path.lower()
    if lower.endswith((".tif", ".tiff")):
        save_tiff16(path, srgb)
        return
    if lower.endswith(".png"):
        _write_png(path, to_uint8(srgb), fast_png)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"writing {path!r} needs Pillow; use .png or .tif for output "
            "without it"
        ) from e
    Image.fromarray(to_uint8(srgb), mode="RGB").save(path)


def save_png16(path: str, srgb: np.ndarray) -> None:
    """Write a 16-bit RGB PNG (native fast writer when built, else zlib)."""
    _write_png(path, to_uint16(srgb), fast=True)


def save_tiff16(path: str, srgb: np.ndarray) -> None:
    """Write an uncompressed 16-bit RGB TIFF with the built-in writer."""
    img = to_uint16(srgb)
    h, w, _ = img.shape
    ifd0 = {
        T.TAG_IMAGE_WIDTH: (T.TYPE_LONG, [w]),
        T.TAG_IMAGE_LENGTH: (T.TYPE_LONG, [h]),
        T.TAG_BITS_PER_SAMPLE: (T.TYPE_SHORT, [16, 16, 16]),
        T.TAG_COMPRESSION: (T.TYPE_SHORT, [1]),
        T.TAG_PHOTOMETRIC: (T.TYPE_SHORT, [2]),  # RGB
        T.TAG_SAMPLES_PER_PIXEL: (T.TYPE_SHORT, [3]),
        T.TAG_ROWS_PER_STRIP: (T.TYPE_LONG, [h]),
    }
    strip = np.ascontiguousarray(img.astype("<u2")).tobytes()
    blob = T.TiffWriter().write(ifd0, None, None, strip_data=strip, strip_in_sub=False)
    with open(path, "wb") as f:
        f.write(blob)
