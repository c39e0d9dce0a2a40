"""IO layer: TIFF writer/parser round trips, metadata extraction, DNG load-to-develop."""
import numpy as np
import pytest

from pysp_tpu.const import BayerPattern, QualityDemosaic
from pysp_tpu.io import tiff as T
from pysp_tpu.io.metadata import (
    compute_ev,
    compute_ev_from_tiff,
    exif_get_as_shot_neutral,
    exif_get_color_mat_sources,
    get_image_area_from_tiff,
    get_opcode_3_block,
)
from pysp_tpu.io.raw_loader import load_raw_dng
from pysp_tpu.pipeline.develop import DevelopConfig, develop


def make_bayer_u16(h=32, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(200, 4000, (h, w)).astype(np.uint16)


def test_write_read_roundtrip():
    bayer = make_bayer_u16()
    blob = T.write_synthetic_dng(bayer)
    tf = T.read_tiff(blob)

    raw = tf.find_raw_ifd()
    assert raw is not None
    data = tf.read_strips(raw)
    np.testing.assert_array_equal(data, bayer)

    # IFD0 carries the color tags
    ifd0 = tf.ifds[0]
    assert ifd0.get(T.TAG_COLOR_MATRIX_1) is not None
    assert ifd0.get(T.TAG_DNG_VERSION).as_ints() == [1, 4, 0, 0]
    assert ifd0.exif_ifd is not None


def test_metadata_extraction():
    bayer = make_bayer_u16()
    opcode_blob = b"\x00\x00\x00\x00"  # zero opcodes
    blob = T.write_synthetic_dng(
        bayer,
        active_area=(2, 2, 29, 37),
        crop_origin=(2, 2),
        crop_size=(24, 20),
        opcode_list_3=opcode_blob,
        exposure_time=(1, 200),
        f_number=(4, 1),
        iso=400,
    )

    tf = T.read_tiff(blob)
    mats = exif_get_color_mat_sources(tf)
    assert len(mats) == 2
    assert mats[0].mat.shape == (3, 3)
    assert abs(mats[0].mat[0, 0] - 0.77) < 1e-3

    neutral = exif_get_as_shot_neutral(tf)
    np.testing.assert_allclose(neutral, [0.5, 1.0, 0.6], atol=1e-4)

    active, crop = get_image_area_from_tiff(blob)
    assert active == [2, 2, 29, 37]
    assert crop == ([2, 2], [24, 20])

    assert get_opcode_3_block(blob) == opcode_blob

    ev = compute_ev_from_tiff(blob)
    assert abs(ev - compute_ev(400, 1 / 200, 4.0)) < 1e-6


def test_ev_formula():
    # ISO 100, 1s, f/1.0 -> EV log2(100/100) = ... EV = log2(100*1/(100*1)) = 0
    assert compute_ev(100, 1.0, 1.0) == pytest.approx(0.0)
    assert compute_ev(100, 1 / 100, 2.8) == pytest.approx(np.log2(100 * 2.8**2 / 1))


@pytest.mark.parametrize(
    "cfa,pattern",
    [
        ((0, 1, 1, 2), BayerPattern.Rggb),
        ((2, 1, 1, 0), BayerPattern.Bggr),
        ((1, 0, 2, 1), BayerPattern.Grbg),
        ((1, 2, 0, 1), BayerPattern.Gbrg),
    ],
)
def test_load_raw_patterns(cfa, pattern):
    bayer = make_bayer_u16()
    blob = T.write_synthetic_dng(bayer, cfa_pattern=cfa)
    frame = load_raw_dng(blob)
    assert frame.source_pattern == pattern
    assert frame.bayer.shape == bayer.shape
    assert float(frame.bayer.max()) <= 1.0 and float(frame.bayer.min()) >= 0.0


def test_load_normalization_values():
    bayer = make_bayer_u16()
    blob = T.write_synthetic_dng(bayer, black_level=256, white_level=4095)
    frame = load_raw_dng(blob)
    # spot check one photosite (RGGB: (0,0) is R)
    want = np.clip(float(bayer[0, 0]) - 256, 0, 4095) / 4095
    assert abs(float(frame.bayer[0, 0]) - want) < 1e-6


def test_load_active_area_and_crop():
    bayer = make_bayer_u16(40, 48)
    blob = T.write_synthetic_dng(
        bayer, active_area=(4, 4, 35, 43), crop_origin=(2, 2), crop_size=(24, 16)
    )
    frame = load_raw_dng(blob)
    # active area -> 32x40, then crop at (2,2) size (24w,16h) -> 16x24
    assert frame.bayer.shape == (16, 24)


def test_load_odd_crop_rejected():
    bayer = make_bayer_u16()
    blob = T.write_synthetic_dng(bayer, crop_origin=(1, 2), crop_size=(10, 10))
    with pytest.raises(NotImplementedError):
        load_raw_dng(blob)


def test_end_to_end_dng_develop():
    """The canonical pipeline: synthetic DNG -> load -> develop -> sRGB."""
    bayer = make_bayer_u16(64, 64, seed=3)
    blob = T.write_synthetic_dng(bayer)
    frame = load_raw_dng(blob)
    out = np.asarray(develop(frame, DevelopConfig(quality=QualityDemosaic.Fast)))
    assert out.shape == (64, 64, 3)
    assert np.all(np.isfinite(out))
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_ljpeg_compressed_dng():
    """Lossless-JPEG (compression 7) DNG decode via the native library."""
    from pysp_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("native libdng_fast.so not built")

    bayer = make_bayer_u16(48, 56, seed=9)
    blob_c = T.write_synthetic_dng(bayer, compression=7)
    blob_u = T.write_synthetic_dng(bayer, compression=1)
    assert blob_c != blob_u

    tf = T.read_tiff(blob_c)
    got = tf.read_strips(tf.find_raw_ifd())
    np.testing.assert_array_equal(got, bayer)

    f_c = load_raw_dng(blob_c)
    f_u = load_raw_dng(blob_u)
    np.testing.assert_allclose(np.asarray(f_c.bayer), np.asarray(f_u.bayer))


def test_ljpeg_threaded_tile_decode_parity():
    """dng_ljpeg_decode_tiles (host-thread-parallel, one native call) is
    byte-identical to the serial per-tile loop — tiles, edge-truncated tiles,
    and 2-component scans (VERDICT r4 item 5)."""
    import pytest

    from pysp_tpu.io import native

    if not native.available() or not native.has_ljpeg_tiles():
        pytest.skip("rebuilt libdng_fast.so needed")

    h, w, th, tw = 40, 40, 16, 24  # tiles_x=2, last column truncated, last row too
    bayer = make_bayer_u16(h, w, seed=51)
    tiles_x = -(-w // tw)
    tiles_y = -(-h // th)
    data = b"\x00" * 13  # arbitrary prefix: offsets must be honored
    offsets, counts = [], []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile = np.zeros((th, tw), np.uint16)
            ys, xs = (
                min(th, h - ty * th),
                min(tw, w - tx * tw),
            )
            tile[:ys, :xs] = bayer[ty * th : ty * th + ys, tx * tw : tx * tw + xs]
            # encode as a 2-component scan (the common DNG CFA layout): the
            # decoder's pw = W * NC column spanning must land identically
            enc = native.ljpeg_encode(tile.reshape(th, tw // 2, 2))
            offsets.append(len(data))
            counts.append(len(enc))
            data += enc
    got = native.ljpeg_decode_tiles(data, offsets, counts, h, w, th, tw)

    # serial oracle: the same per-tile loop read_strips runs
    want = np.zeros((h, w), np.uint16)
    for idx, (o, c) in enumerate(zip(offsets, counts)):
        piece = native.ljpeg_decode(data[o : o + c])
        if piece.ndim == 3:
            ph, pw, pc = piece.shape
            piece = piece.reshape(ph, pw * pc)
        ty, tx = divmod(idx, tiles_x)
        y0, x0 = ty * th, tx * tw
        ys, xs = min(th, h - y0), min(tw, w - x0)
        want[y0 : y0 + ys, x0 : x0 + xs] = piece[:ys, :xs]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bayer)


def test_ljpeg_multi_strip_threaded_matches_serial(monkeypatch):
    """read_strips takes the threaded path for multi-strip LJ92 and matches
    the serial path bit-for-bit through the whole TiffFile surface."""
    import pytest

    from pysp_tpu.io import native

    if not native.available() or not native.has_ljpeg_tiles():
        pytest.skip("rebuilt libdng_fast.so needed")

    h, w, rps = 64, 48, 16
    bayer = make_bayer_u16(h, w, seed=52)
    blob = T.write_synthetic_dng(bayer, compression=7)
    tf = T.read_tiff(blob)
    raw = tf.find_raw_ifd()

    data = bytes(tf.data)
    offsets, counts = [], []
    for i in range(h // rps):
        enc = native.ljpeg_encode(bayer[i * rps : (i + 1) * rps])
        offsets.append(len(data))
        counts.append(len(enc))
        data += enc
    tf.data = data
    raw.tags[T.TAG_STRIP_OFFSETS] = T.TiffTag(
        T.TAG_STRIP_OFFSETS, T.TYPE_LONG, len(offsets), offsets
    )
    raw.tags[T.TAG_STRIP_BYTE_COUNTS] = T.TiffTag(
        T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, len(counts), counts
    )
    raw.tags[T.TAG_ROWS_PER_STRIP] = T.TiffTag(
        T.TAG_ROWS_PER_STRIP, T.TYPE_LONG, 1, [rps]
    )

    got_threaded = tf.read_strips(raw)
    monkeypatch.setattr(native, "has_ljpeg_tiles", lambda: False)
    got_serial = tf.read_strips(raw)
    np.testing.assert_array_equal(got_threaded, got_serial)
    np.testing.assert_array_equal(got_threaded, bayer)


def test_native_ljpeg_roundtrip_edge_cases():
    from pysp_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("native libdng_fast.so not built")

    rng = np.random.default_rng(10)
    # worst-case random data, 1 and 2 components, extreme diffs
    for img in [
        rng.integers(0, 65536, (33, 47), np.int64).astype(np.uint16),
        rng.integers(0, 65536, (16, 24, 2), np.int64).astype(np.uint16),
        np.array([[0, 65535], [65535, 0]], np.uint16),
    ]:
        blob = native.ljpeg_encode(img)
        back = native.ljpeg_decode(blob)
        np.testing.assert_array_equal(back, img)


def test_native_normalize_matches_python():
    from pysp_tpu.io import native
    from pysp_tpu.io.raw_loader import _normalize_host

    if not native.available():
        import pytest

        pytest.skip("native libdng_fast.so not built")

    rng = np.random.default_rng(11)
    mosaic = rng.integers(0, 4096, (64, 80), np.int64).astype(np.uint16)
    black = np.array([256, 255, 254, 257], np.float64)
    sat = np.array([4095, 4094, 4093, 4092], np.float64)
    got = native.normalize_mosaic(mosaic, black, sat)
    want = _normalize_host(mosaic, black, sat)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_develop_with_stats():
    from pysp_tpu.pipeline.develop import develop_with_stats

    bayer = make_bayer_u16(32, 32, seed=4)
    frame = load_raw_dng(T.write_synthetic_dng(bayer))
    out, stats = develop_with_stats(frame, DevelopConfig(quality=QualityDemosaic.Draft))
    assert out.shape == (32, 32, 3)
    assert 0.0 <= float(stats["sensor"]["clip_high_frac"]) <= 1.0
    assert stats["output"]["mean_rgb"].shape == (3,)


def test_load_burst():
    from pysp_tpu.io.raw_loader import load_burst
    from pysp_tpu.pipeline.develop import develop_burst

    blobs = [
        T.write_synthetic_dng(make_bayer_u16(32, 32, seed=20 + i),
                              exposure_time=(1, 100 + i))
        for i in range(4)
    ]
    batch = load_burst(blobs)
    assert batch.bayer.shape == (4, 32, 32)
    assert batch.ev.shape == (4,)
    out = np.asarray(develop_burst(batch, DevelopConfig(quality=QualityDemosaic.Draft)))
    assert out.shape == (4, 32, 32, 3)


def test_cli_develop_and_info(tmp_path):
    import json
    import subprocess
    import sys
    import os

    bayer = make_bayer_u16(48, 48, seed=30)
    src = tmp_path / "shot.dng"
    src.write_bytes(T.write_synthetic_dng(bayer))
    dst = tmp_path / "out.png"

    # the child process runs on the CPU backend, as the suite does
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pysp_tpu.cli", "develop", str(src),
         "-o", str(dst), "--quality", "fast"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert dst.exists()
    from PIL import Image

    img = Image.open(dst)
    assert img.size == (48, 48)

    r = subprocess.run(
        [sys.executable, "-m", "pysp_tpu.cli", "info", str(src)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    meta = json.loads(r.stdout)
    assert meta["size"] == [48, 48]
    assert meta["n_color_matrices"] == 2


def test_save_tiff16_roundtrip(tmp_path):
    from pysp_tpu.io.image_out import save_tiff16

    rng = np.random.default_rng(31)
    srgb = rng.random((16, 20, 3)).astype(np.float32)
    path = tmp_path / "out.tif"
    save_tiff16(str(path), srgb)

    tf = T.read_tiff(str(path))
    ifd = tf.ifds[0]
    assert ifd.get(T.TAG_PHOTOMETRIC).as_ints()[0] == 2
    raw = np.frombuffer(
        tf.data[
            ifd.get(T.TAG_STRIP_OFFSETS).as_ints()[0] :
            ifd.get(T.TAG_STRIP_OFFSETS).as_ints()[0]
            + ifd.get(T.TAG_STRIP_BYTE_COUNTS).as_ints()[0]
        ],
        dtype="<u2",
    ).reshape(16, 20, 3)
    np.testing.assert_allclose(raw / 65535.0, srgb, atol=1e-4)


def test_big_endian_tiff_parse():
    """Reader handles MM (big-endian) containers."""
    import struct

    # hand-build a tiny big-endian TIFF: one IFD with ImageWidth
    out = b"MM\x00\x2a" + struct.pack(">L", 8)
    entries = struct.pack(">HHL4s", 256, 3, 1, struct.pack(">H", 123) + b"\x00\x00")
    out += struct.pack(">H", 1) + entries + struct.pack(">L", 0)
    tf = T.read_tiff(out)
    assert tf.endian == ">"
    assert tf.ifds[0].get(256).as_ints() == [123]


def test_multi_strip_dng_read():
    """Multi-strip organization: 4 strips of 8 rows, plus the tile assembly path."""
    bayer = make_bayer_u16(32, 40, seed=50)
    blob = T.write_synthetic_dng(bayer)
    tf = T.read_tiff(blob)
    raw = tf.find_raw_ifd()
    base = raw.get(T.TAG_STRIP_OFFSETS).as_ints()[0]
    per = 8 * 40 * 2

    # carve the single strip into 4 by mutating the parsed IFD
    raw.tags[T.TAG_STRIP_OFFSETS] = T.TiffTag(
        T.TAG_STRIP_OFFSETS, T.TYPE_LONG, 4, [base + i * per for i in range(4)]
    )
    raw.tags[T.TAG_STRIP_BYTE_COUNTS] = T.TiffTag(
        T.TAG_STRIP_BYTE_COUNTS, T.TYPE_LONG, 4, [per] * 4
    )
    raw.tags[T.TAG_ROWS_PER_STRIP] = T.TiffTag(
        T.TAG_ROWS_PER_STRIP, T.TYPE_LONG, 1, [8]
    )
    np.testing.assert_array_equal(tf.read_strips(raw), bayer)

    # tile organization: 2x2 grid of 16x20 tiles over the same data, re-ordered
    tiles = [
        bayer[ty * 16 : ty * 16 + 16, tx * 20 : tx * 20 + 20]
        for ty in range(2)
        for tx in range(2)
    ]
    flat = np.concatenate([t.reshape(-1) for t in tiles])
    got = T._assemble_tiles(flat, 32, 40, 16, 20, 4)
    np.testing.assert_array_equal(got, bayer)


def test_panasonic_iso_quirk():
    """ISO from maker tag 0x0017 when ISOSpeedRatings is absent (image.py:68-70)."""
    ifd0 = {
        T.TAG_MAKE: (T.TYPE_ASCII, b"Panasonic\x00"),
        0x0017: (T.TYPE_SHORT, [800]),
    }
    exif = {
        T.TAG_EXPOSURE_TIME: (T.TYPE_RATIONAL, [(1, 50)]),
        T.TAG_F_NUMBER: (T.TYPE_RATIONAL, [(2, 1)]),
    }
    blob = T.TiffWriter().write(ifd0, None, exif)
    ev = compute_ev_from_tiff(blob)
    assert abs(ev - compute_ev(800, 1 / 50, 2.0)) < 1e-6


def test_linearization_table_applied():
    """DNG LinearizationTable LUT maps stored values before black/white levels."""
    h, w = 16, 20
    stored = np.full((h, w), 100, np.uint16)
    table = np.zeros(256, np.uint16)
    table[100] = 2304  # LUT: stored 100 -> linear 2304
    blob = T.write_synthetic_dng(stored, linearization_table=table)
    frame = load_raw_dng(blob)
    np.testing.assert_allclose(
        np.asarray(frame.bayer), (2304 - 256) / 4095, rtol=1e-6
    )


def test_native_codec_fuzz_roundtrips():
    """Randomized roundtrips across precisions/components (LJ92) and trees/
    vpred seeds (NEF) — VERDICT r1 item 8. Adversarial content: full-range
    noise, constant blocks, alternating extremes (max-magnitude diffs)."""
    from pysp_tpu.io import native

    if not native.available():
        pytest.skip("native libdng_fast.so not built")

    rng = np.random.default_rng(99)
    for precision in (8, 10, 12, 14, 16):
        top = (1 << precision) - 1
        for n_comp in (1, 2, 3):
            h, w = int(rng.integers(3, 24)), int(rng.integers(3, 24))
            imgs = [
                rng.integers(0, top + 1, (h, w, n_comp)),
                np.full((h, w, n_comp), top),
                np.zeros((h, w, n_comp), int),
                np.indices((h, w))[0][..., None].repeat(n_comp, -1) % 2 * top,
            ]
            for img in imgs:
                img = img.astype(np.uint16)
                blob = native.ljpeg_encode(img, precision=precision)
                back = native.ljpeg_decode(blob)
                if back.ndim == 2:
                    back = back[..., None]
                np.testing.assert_array_equal(back, img, err_msg=f"p{precision}c{n_comp}")

    # tree 3 (14-bit lossy) has no 14-bit diff category: its curve domain keeps
    # residuals within 13 bits, so the fuzz range is capped there
    for tree, bits, top in (
        (0, 12, 4095), (2, 12, 4095), (3, 14, 8191), (5, 14, 16383)
    ):
        for _ in range(3):
            h, w = int(rng.integers(2, 20)) * 2, int(rng.integers(2, 20)) * 2
            img = rng.integers(0, top + 1, (h, w)).astype(np.uint16)
            img[0, :] = top  # max-magnitude first-row diffs
            img[1, :] = 0
            vpred = rng.integers(0, top + 1, 4).astype(np.uint16)
            blob = native.nef_encode(img, tree, vpred)
            curve = np.arange(1 << bits, dtype=np.uint16)
            back = native.nef_decode(blob, h, w, tree, vpred, 0, curve)
            np.testing.assert_array_equal(back, img, err_msg=f"tree{tree}")


# --- fast PNG writer (native stored-deflate) -------------------------------------------
def test_fast_png_round_trip_and_fallback(tmp_path):
    """save_image's fast PNG path: any PNG decoder reads back identical pixels;
    the zlib writer (``fast_png=False``, or no native build) gives the same."""
    import io as _io

    from PIL import Image

    from pysp_tpu.io import native
    from pysp_tpu.io.image_out import save_image, to_uint8

    rng = np.random.default_rng(21)
    srgb = rng.random((37, 53, 3)).astype(np.float32)

    p_fast = str(tmp_path / "fast.png")
    p_pil = str(tmp_path / "pil.png")
    save_image(p_fast, srgb)                       # native when built
    save_image(p_pil, srgb, fast_png=False)        # stdlib zlib path
    a = np.asarray(Image.open(p_fast))
    b = np.asarray(Image.open(p_pil))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, to_uint8(srgb))

    if native.has_png():
        # odd geometries + block boundaries (65535-byte stored blocks)
        for shape in ((1, 1, 3), (2, 3, 3), (101, 217, 3), (5552, 4, 3)):
            img = rng.integers(0, 256, shape).astype(np.uint8)
            back = np.asarray(Image.open(_io.BytesIO(native.png_encode(img))))
            np.testing.assert_array_equal(back, img)


def test_fast_png16(tmp_path):
    """16-bit PNG: PIL reads the 16-bit samples back exactly (a mode PIL
    cannot itself write for RGB)."""
    from PIL import Image

    from pysp_tpu.io.image_out import save_png16, to_uint16

    import struct
    import zlib

    rng = np.random.default_rng(23)
    srgb = rng.random((21, 35, 3)).astype(np.float32)
    p = str(tmp_path / "hi.png")
    save_png16(p, srgb)
    want = to_uint16(srgb)

    # PIL opens 16-bit RGB PNGs but downconverts to 8-bit: the high bytes
    # must match (proves a valid, decodable file) ...
    arr = np.asarray(Image.open(p))
    assert arr.dtype == np.uint8
    np.testing.assert_array_equal(arr, (want >> 8).astype(np.uint8))

    # ... and a hand zlib-decode of the IDAT proves the full 16-bit samples
    # are stored exactly (big-endian, filter 0)
    data = open(p, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        ln, tag = struct.unpack(">L4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
    raw = zlib.decompress(idat)
    h, w, _ = want.shape
    stride = 1 + w * 3 * 2
    rows = []
    for r in range(h):
        row = raw[r * stride:(r + 1) * stride]
        assert row[0] == 0  # filter: None
        rows.append(np.frombuffer(row[1:], ">u2").reshape(w, 3))
    np.testing.assert_array_equal(np.stack(rows), want)


def _png_rows(data: bytes) -> tuple:
    """(IHDR fields, raw filtered scanlines) of a PNG, parsed by hand."""
    import struct
    import zlib

    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        ln, tag = struct.unpack(">L4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + ln]
        assert zlib.crc32(tag + body) == struct.unpack(">L", data[pos + 8 + ln:pos + 12 + ln])[0]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    return ihdr, zlib.decompress(idat)


@pytest.mark.parametrize(
    "dtype, shape",
    [
        (np.uint8, (1, 1, 3)),
        (np.uint8, (7, 13, 3)),
        (np.uint8, (9, 5)),
        (np.uint16, (3, 11, 3)),
        (np.uint16, (6, 1, 3)),
        (np.uint16, (5, 9)),
    ],
)
def test_zlib_png_writer_round_trip(dtype, shape):
    """The stdlib PNG writer (the fallback when the native writer is not
    built): valid chunks, exact 8/16-bit samples, odd widths, 1 or 3 channels."""
    import io as _io

    from PIL import Image

    from pysp_tpu.io.image_out import encode_png

    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = encode_png(img)
    (w, h, depth, color, _, _, _), raw = _png_rows(data)
    c = 3 if len(shape) == 3 else 1
    assert (h, w, depth, color) == (shape[0], shape[1], 8 * img.itemsize, 2 if c == 3 else 0)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c * img.itemsize)
    assert not rows[:, 0].any()  # filter type 0 on every row
    got = rows[:, 1:].copy().view(">u2" if dtype == np.uint16 else np.uint8)
    np.testing.assert_array_equal(got.reshape(shape), img)
    back = np.asarray(Image.open(_io.BytesIO(data)))
    if dtype == np.uint8:
        np.testing.assert_array_equal(back, img)
    elif c == 3:  # Pillow reads 16-bit RGB as its high bytes
        np.testing.assert_array_equal(back, (img >> 8).astype(np.uint8))
    else:
        np.testing.assert_array_equal(back.astype(np.uint16), img)
