"""Filters: Gaussian blur vs reference transcription, unsharp, RL deconvolution."""
import numpy as np
import pytest

from pysp_tpu.filters.blur import (
    blur_gaussian,
    get_1d_gaussian_filter,
    get_gaussian_filter_window_size,
)
from pysp_tpu.filters.sharpen import (
    gaussian_rt_deconvolution,
    gaussian_rt_deconvolution_lab,
    gaussian_rt_deconvolution_yuv,
    unsharp_mask_lab,
    unsharp_mask_per_channel,
)


def _ref_blur(image, sigma):
    """Transcription of blur_gaussian.py:57-102 (2-pass separable, symmetric pad)."""
    filt = get_1d_gaussian_filter(sigma)
    border = filt.shape[0] // 2
    padded = np.pad(
        image,
        [(border, border), (border, border)] + [(0, 0)] * (image.ndim - 2),
        mode="symmetric",
    )
    pshape = list(image.shape)
    pshape[0] += 2 * border
    h_pass = np.zeros(pshape, np.float32)
    for i, c in enumerate(filt):
        h_pass += padded[:, i : i + image.shape[1]] * c
    v_pass = np.zeros_like(image, dtype=np.float32)
    for i, c in enumerate(filt):
        v_pass += h_pass[i : i + image.shape[0]] * c
    return v_pass


def test_window_size():
    assert get_gaussian_filter_window_size(1.0) == 7
    assert get_gaussian_filter_window_size(0.1) == 3
    assert get_gaussian_filter_window_size(2.0) % 2 == 1


def test_blur_matches_reference():
    rng = np.random.default_rng(0)
    img = rng.random((24, 30)).astype(np.float32)
    for sigma in [0.5, 1.0, 2.3]:
        got = np.asarray(blur_gaussian(img, sigma))
        want = _ref_blur(img, sigma)
        np.testing.assert_allclose(got, want, atol=2e-5)

    rgb = rng.random((16, 18, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(blur_gaussian(rgb, 1.5)), _ref_blur(rgb, 1.5), atol=2e-5
    )


def test_unsharp_sharpens_edges():
    x = np.zeros((16, 32), np.float32)
    x[:, 16:] = 1.0
    out = np.asarray(unsharp_mask_per_channel(x, 1.0, 0.5))
    # overshoot on both sides of the edge
    assert out[:, 14:16].min() < 0.0 or out[:, 14:16].min() < x[:, 14:16].min()
    assert out[:, 16:18].max() > 1.0
    # flat regions untouched (up to gain ~= sum(filter)^2)
    np.testing.assert_allclose(out[:, :4], x[:, :4], atol=5e-3)


def test_unsharp_lab_preserves_gray_axis():
    rng = np.random.default_rng(1)
    g = rng.random((12, 12, 1)).astype(np.float32).repeat(3, -1)
    out = np.asarray(unsharp_mask_lab(g, 1.0, 0.4))
    np.testing.assert_allclose(out[..., 0], out[..., 1], atol=1e-4)
    np.testing.assert_allclose(out[..., 1], out[..., 2], atol=1e-4)


def test_rl_deconvolution_recovers_blur():
    """RL with the true PSF should sharpen a blurred step edge."""
    x = np.zeros((24, 48), np.float32)
    x[:, 24:] = 0.8
    x += 0.1
    blurred = np.asarray(blur_gaussian(x, 1.5))
    restored = np.asarray(gaussian_rt_deconvolution(blurred, 1.5, iterations=20))
    err_blurred = np.abs(blurred[:, 4:-4] - x[:, 4:-4]).mean()
    err_restored = np.abs(restored[:, 4:-4] - x[:, 4:-4]).mean()
    assert err_restored < err_blurred * 0.85, (err_blurred, err_restored)
    # edge transition is visibly steeper after restoration
    grad_blur = np.abs(np.diff(blurred[12])).max()
    grad_rest = np.abs(np.diff(restored[12])).max()
    assert grad_rest > grad_blur * 1.3, (grad_blur, grad_rest)


def test_rl_variants_shapes_and_finiteness():
    rng = np.random.default_rng(2)
    rgb = (0.2 + 0.6 * rng.random((16, 16, 3))).astype(np.float32)
    for fn in (gaussian_rt_deconvolution_lab, gaussian_rt_deconvolution_yuv):
        out = np.asarray(fn(rgb, 1.0, iterations=5))
        assert out.shape == rgb.shape
        assert np.all(np.isfinite(out))


# ---------------------------------------------------------------------------
# RL deconvolution vs a NumPy transcription of gauss_rt_deconv.py:29-37
# ---------------------------------------------------------------------------
def _ref_rl(image, sigma, iterations):
    estimate = image.astype(np.float32)
    for _ in range(iterations):
        blurred = _ref_blur(estimate, sigma)
        estimate = estimate * _ref_blur(image / (blurred + 1e-25), sigma)
    return estimate


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("sigma", [0.8, 1.5, 2.5])
def test_rl_deconvolution_matches_reference(sigma, ndim):
    """The fori_loop RL equals the reference's loop on 2D planes and (H, W, C)
    images, borders included (symmetric padding on every blur)."""
    rng = np.random.default_rng(31)
    h, w = 40, 56
    base = (
        0.4
        + 0.3 * np.sin(np.arange(w) / 7.0)[None, :]
        + 0.2 * np.cos(np.arange(h) / 5.0)[:, None]
    )
    img = base if ndim == 2 else np.stack([base, 0.8 * base, 0.6 * base], -1)
    img = np.clip(img + rng.normal(0, 0.02, img.shape), 0.01, 1.0).astype(np.float32)
    got = np.asarray(gaussian_rt_deconvolution(img, sigma, iterations=6))
    want = _ref_rl(img, sigma, 6)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
