"""Integration tests: one per BASELINE.json benchmark config.

These exercise the exact end-to-end compositions the driver benchmarks, on small
shapes (the perf numbers come from bench.py on the GPU; these gate correctness).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu import (
    DevelopConfig,
    QualityDemosaic,
    RawFrame,
    Poly3CorrectionModel,
    develop,
    find_erroneous_pixels_median,
    flat_frame_correction,
    fuse_exposures_to_raw,
    remove_ca_from_raw,
    repair_bad_pixels,
)
from pysp_tpu.colorimetry.wb import CameraWhiteBalanceController
from pysp_tpu.colorimetry.spaces import MatXyzToCamera
from pysp_tpu.colorimetry.illuminants import StandardIlluminantSeries, xy_to_xyz
from pysp_tpu.io.raw_loader import frame_from_parts
from pysp_tpu.io.tiff import write_synthetic_dng
from pysp_tpu.io.raw_loader import load_raw_dng
from pysp_tpu.pipeline.develop import develop_burst
from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear
from pysp_tpu.utils.testing import make_scene, mosaic_rggb
from pysp_tpu.const import BayerPattern


def _dng_frame(h=48, w=48, seed=0):
    rng = np.random.default_rng(seed)
    return load_raw_dng(
        write_synthetic_dng(rng.integers(300, 3900, (h, w)).astype(np.uint16))
    )


def test_config1_draft_develop():
    """Config 1: single DNG, Draft debayer -> to_lin_srgb -> lin_srgb_to_srgb."""
    frame = _dng_frame()
    out = np.asarray(develop(frame, DevelopConfig(quality=QualityDemosaic.Draft)))
    assert out.shape == (48, 48, 3) and np.isfinite(out).all()


def test_config2_fast_with_temperature_wb():
    """Config 2: Fast debayer + WB from temperature (Planckian/D-series blend)."""
    rng = np.random.default_rng(1)
    base = np.array([[0.7, -0.1, -0.05], [-0.2, 1.1, 0.1], [0.02, -0.2, 1.2]])
    mats = [
        MatXyzToCamera(base @ np.diag([1.1, 1.0, 0.8]), xy_to_xyz((0.44758, 0.40745)),
                       StandardIlluminantSeries.STANDALONE),
        MatXyzToCamera(base @ np.diag([0.9, 1.0, 1.15]), xy_to_xyz((0.31272, 0.32903)),
                       StandardIlluminantSeries.SERIES_DAYLIGHT),
    ]
    ctrl = CameraWhiteBalanceController(mats, np.array([0.5, 1.0, 0.6]))
    ctrl.update_by_temperature(5200, allow_cross_blend=True)

    bayer = mosaic_rggb(make_scene(48, 48, seed=1))
    frame = frame_from_parts(bayer, BayerPattern.Rggb, ctrl, ev=10.0)
    out = np.asarray(develop(frame, DevelopConfig(quality=QualityDemosaic.Fast)))
    assert out.shape == (48, 48, 3) and np.isfinite(out).all()


def test_config3_best_with_healing_and_flat_field():
    """Config 3: AHD + postprocess + bad-pixel healing + flat-field correction."""
    rng = np.random.default_rng(2)
    bayer = mosaic_rggb(make_scene(48, 48, seed=2))
    bayer[10, 10] = 1.0  # hot pixel
    frame = RawFrame.synthetic(bayer)

    flat = RawFrame.synthetic((0.85 + 0.15 * rng.random((48, 48))).astype(np.float32))
    frame = flat_frame_correction(frame, flat)

    masks = find_erroneous_pixels_median(frame, quantile=0.999)
    frame = repair_bad_pixels(frame, masks)

    out = np.asarray(
        develop(frame, DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1))
    )
    assert out.shape == (48, 48, 3) and np.isfinite(out).all()


def test_config4_hdr_stack_to_srgb():
    """Config 4: 5 bracketed raws -> Bayer-space HDR -> AHD develop -> sRGB."""
    frames = [
        RawFrame.synthetic(
            np.clip(mosaic_rggb(make_scene(48, 48, seed=3)) * (0.4 + 0.3 * i), 0, 1),
            ev=8.0 + i,
        )
        for i in range(5)
    ]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    hdr, counts = fuse_exposures_to_raw(batch)
    assert hdr.is_hdr and float(hdr.lim_sat) > 1.0
    assert int(np.asarray(counts).max()) <= 5

    out = np.asarray(develop(hdr, DevelopConfig(quality=QualityDemosaic.Best)))
    assert out.shape == (48, 48, 3) and np.isfinite(out).all()


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _config5_gate(n, h, w, psnr_floor=55.0):
    """Config 5 as a numeric gate: CA-corrected Best-quality burst must match the
    per-frame develop path (same arithmetic, different program — only documented
    homogeneity tie flips allowed), and the warp+prior composition must equal the
    analytically composed single resample exactly."""
    model = Poly3CorrectionModel(0.01)
    frames = []
    for i in range(n):
        f = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=10 + i)))
        f = remove_ca_from_raw(f, model, model)
        frames.append(f)
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    cfg = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)
    out = np.asarray(develop_burst(batch, cfg))
    assert out.shape == (n, h, w, 3) and np.isfinite(out).all()

    # burst == per-frame develop (separately compiled program: FMA-contraction
    # tie flips in the AHD homogeneity decision are the only allowed divergence)
    for i in (0, n // 2, n - 1):
        want = np.asarray(develop(frames[i], cfg))
        p = _psnr(out[i], want)
        frac = np.mean(np.abs(out[i] - want) > 1e-4)
        assert p > psnr_floor, (i, p)
        assert frac < 0.01, (i, frac)

    # warp + CA-prior composition: a shifted prior seeds the warp polynomial
    # (out = warp(prior(p)), ONE resample — reference seed-variant,
    # dng_warp_rectilinear_coords.pyx:82-96 via chan_distortion_corr.py:11-41).
    # Gate vs an independent float64 NumPy transcription of the seeded table.
    from pysp_tpu.ops.resample import remap_bilinear

    coeffs = [(1.005, -0.01, 0.002, 0.0, 0.0003, -0.0002)] * 3
    center = (0.5, 0.5)
    block = encode_warp_rectilinear(coeffs, center)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    shift = 1.5
    prior = [(xs + shift, ys)] * 3

    got_w = np.asarray(
        apply_opcode_3_warp(out[0], block, prior=prior, interpolation="bilinear")
    )

    def np_seeded_table(sx, sy, k):
        kr0, kr1, kr2, kr3, kt0, kt1 = k
        cx, cy = (w - 1) * center[0], (h - 1) * center[1]
        m = np.hypot(max(cx, w - 1 - cx), max(cy, h - 1 - cy))
        dx = (sx.astype(np.float64) - cx) / m
        dy = (sy.astype(np.float64) - cy) / m
        r2 = dx * dx + dy * dy
        f = kr0 + r2 * (kr1 + r2 * (kr2 + r2 * kr3))
        xp = cx + m * (f * dx + kt0 * 2 * dx * dy + kt1 * (r2 + 2 * dx * dx))
        yp = cy + m * (f * dy + kt1 * 2 * dx * dy + kt0 * (r2 + 2 * dy * dy))
        return xp, yp

    mx, my = np_seeded_table(xs + shift, ys, coeffs[0])
    mx = np.clip(mx, 0, w - 1).astype(np.float32)
    my = np.clip(my, 0, h - 1).astype(np.float32)
    for c in range(3):
        want_c = np.asarray(remap_bilinear(out[0][..., c], mx, my))
        # f32 (device table) vs f64 transcription: sub-1e-3-px coordinate noise
        np.testing.assert_allclose(got_w[..., c], want_c, atol=2e-3)


def test_config5_burst_with_warp_and_ca():
    """Config 5 (default suite): numeric gate at moderate shape."""
    _config5_gate(4, 96, 128)


@pytest.mark.slow
def test_config5_realistic_scale():
    """Config 5 at the benchmarked scale (16 x 1000x1504, Best)."""
    _config5_gate(16, 1000, 1504)
