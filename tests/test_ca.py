"""Chromatic-aberration subsystem: models, instability, ROI, matcher, removal."""
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.core.frame import RawFrame
from pysp_tpu.correct.ca.instability import compute_structural_instability
from pysp_tpu.correct.ca.matcher import template_match
from pysp_tpu.correct.ca.models import (
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
    lensfun_poly3_remap_coords,
    radius_field,
)
from pysp_tpu.correct.ca.removal import (
    compute_ca_lens_models_for_raw,
    remove_ca_from_raw,
)
from pysp_tpu.correct.ca.roi import PooledChannel, RoiDetector, quarter_res_pool
from pysp_tpu.ops.resample import remap_bilinear


# --- models --------------------------------------------------------------------------
@pytest.mark.parametrize(
    "model,true_coeffs",
    [
        (Poly3CorrectionModel, (0.02,)),
        (Poly5CorrectionModel, (0.015, -0.008)),
        (PtLensCorrectionModel, (0.01, -0.02, 0.015)),
    ],
)
def test_model_fit_roundtrip(model, true_coeffs):
    truth = model(*true_coeffs)
    r_ud = np.linspace(0.1, 1.0, 40)
    r_d = np.asarray(truth.get_distorted(jnp.asarray(r_ud)))
    fitted = model()
    assert fitted.compute_coefficients(np.stack([r_d, r_ud], axis=1))
    np.testing.assert_allclose(fitted.get_coefficients(), true_coeffs, atol=1e-5)


def test_newton_inversion():
    m = Poly5CorrectionModel(0.02, -0.01)
    r_ud = jnp.linspace(0.05, 1.0, 50)
    r_d = m.get_distorted(r_ud)
    back = np.asarray(m.estimate_undistorted(r_d))
    np.testing.assert_allclose(back, np.asarray(r_ud), atol=1e-5)


def test_radius_field_matches_reference_quadrant_construction():
    """Direct full-res radius == the reference's mirrored quadrant table
    (generic.py:19-39)."""
    h, w = 12, 16
    # reference transcription: top-left quadrant, then values equal |pos-center|
    radius = np.zeros((h // 2, w // 2), np.float32)
    radius[:, :] = (np.arange(w // 2)[::-1] + 0.5) ** 2
    radius += ((np.arange(h // 2)[::-1] + 0.5) ** 2)[:, None]
    radius = np.sqrt(radius)
    radius = radius / radius[0, 0]

    ours = np.asarray(radius_field((h, w)))
    np.testing.assert_allclose(ours[: h // 2, : w // 2], radius, atol=1e-6)
    # mirror symmetry
    np.testing.assert_allclose(ours, ours[::-1], atol=1e-7)
    np.testing.assert_allclose(ours, ours[:, ::-1], atol=1e-7)


def test_coordinate_fields_roundtrip():
    """Forward (distort) then inverse (undistort) coordinate mapping cancels."""
    m = Poly3CorrectionModel(0.03)
    img = jnp.zeros((16, 20))
    fwd = np.asarray(m.get_distorted_coordinates(img))
    inv = np.asarray(m.get_undistorted_coordinates(img))
    # at each pixel: fwd scales delta by f(r)/r, inv by f^-1(r)/r; composing the radial
    # scale factors should give ~1 where r maps to itself
    cy, cx = (16 - 1) / 2, (20 - 1) / 2
    ys = np.arange(16)[:, None] - cy
    xs = np.arange(20)[None, :] - cx
    scale_fwd = fwd[..., 0] / np.where(ys == 0, 1, ys)  # dy/delta_y
    scale_fwd = np.where(np.broadcast_to(ys == 0, fwd[..., 0].shape), np.nan, scale_fwd)
    r = np.asarray(radius_field((16, 20)))
    f_over_r = np.asarray(m.get_distorted(jnp.asarray(r))) / r
    finv_over_r = np.asarray(m.estimate_undistorted(jnp.asarray(r))) / r
    # f(f^-1(r)) = r  =>  (f∘f^-1 scale) ~ 1
    np.testing.assert_allclose(
        np.asarray(m.get_distorted(m.estimate_undistorted(jnp.asarray(r)))), r,
        atol=1e-5,
    )
    # spot check the field equals delta * f(r)/r
    np.testing.assert_allclose(
        fwd[..., 1], np.broadcast_to(xs, (16, 20)) * f_over_r, atol=1e-4
    )
    np.testing.assert_allclose(
        inv[..., 1], np.broadcast_to(xs, (16, 20)) * finv_over_r, atol=1e-4
    )


def test_lensfun_poly3_identity():
    mx, my = lensfun_poly3_remap_coords((10, 14), 0.0, 0.0, 1.0)
    xs, ys = np.meshgrid(np.arange(14, dtype=np.float32), np.arange(10, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(mx), xs, atol=1e-4)
    np.testing.assert_allclose(np.asarray(my), ys, atol=1e-4)


# --- instability ---------------------------------------------------------------------
def test_instability_matches_reference_transcription():
    rng = np.random.default_rng(0)
    bayer = rng.random((16, 20)).astype(np.float32)
    wb_neutral = np.array([0.5, 1.0, 0.8], np.float32)
    frame = RawFrame.synthetic(bayer, wb_neutral=wb_neutral)
    got = np.asarray(compute_structural_instability(frame))

    # transcription of instability.py:7-60
    wb = 1.0 / wb_neutral
    m = np.zeros_like(bayer)
    m[0::2, 0::2] = bayer[0::2, 0::2] * wb[0]
    m[0::2, 1::2] = bayer[0::2, 1::2] * wb[1]
    m[1::2, 0::2] = bayer[1::2, 0::2] * wb[1]
    m[1::2, 1::2] = bayer[1::2, 1::2] * wb[2]
    padded = np.pad(m, 4, mode="symmetric")

    def si_bayer(offsets, bayer_offset):
        max_y, max_x = 8, 10
        stack = []
        for ox, oy in offsets:
            xs = ox + 4 + bayer_offset[0]
            ys = oy + 4 + bayer_offset[1]
            stack.append(padded[ys::2, xs::2][:max_y, :max_x])
        stack = np.stack(stack, -1)
        return stack.max(-1) - stack.min(-1)

    def merge(r, g1, b, g2):
        out = np.zeros((16, 20), np.float32)
        out[0::2, 0::2] = r
        out[0::2, 1::2] = g1
        out[1::2, 1::2] = b
        out[1::2, 0::2] = g2
        return out

    rr_r = si_bayer([(0, 0), (0, -2), (0, 2), (-2, 0), (2, 0)], (0, 0))
    rr_g = si_bayer([(-1, 0), (1, 0), (0, -1), (0, 1)], (0, 0))
    rr_b = si_bayer([(-1, -1), (1, -1), (1, 1), (-1, 1)], (0, 0))
    g0_r = si_bayer([(-1, 0), (-1, -2), (-1, 2), (1, -2), (1, 0), (1, 2)], (1, 0))
    g0_g = si_bayer([(0, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)], (1, 0))
    g0_b = si_bayer([(0, -1), (0, 1), (-2, -1), (-2, 1), (2, -1), (2, 1)], (1, 0))
    g1_r = si_bayer([(0, -1), (-2, -1), (2, -1), (0, 1), (-2, 1), (2, 1)], (0, 1))
    g1_g = si_bayer([(0, 0), (-1, 1), (1, 1), (-1, -1), (1, -1)], (0, 1))
    g1_b = si_bayer([(-1, 0), (1, 0), (-1, -2), (1, -2), (-1, 2), (1, 2)], (0, 1))
    b_r = si_bayer([(-1, -1), (1, -1), (-1, 1), (1, 1)], (1, 1))
    b_g = si_bayer([(-1, 0), (1, 0), (0, -1), (0, 1)], (1, 1))
    b_b = si_bayer([(0, 0), (-2, 0), (2, 0), (0, -2), (0, 2)], (1, 1))

    want = np.dstack(
        [
            merge(rr_r, g0_r, b_r, g1_r),
            merge(rr_g, g0_g, b_g, g1_g),
            merge(rr_b, g0_b, b_b, g1_b),
        ]
    )
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- ROI + matcher -------------------------------------------------------------------
def test_quarter_res_pool():
    x = np.arange(30).reshape(5, 6).astype(np.float32)
    got = quarter_res_pool(x)
    assert got.shape == (2, 3)
    assert got[0, 0] == x[0, 0] + x[1, 0] + x[0, 1] + x[1, 1]


def _circles_image(h=256, w=256, radii=(60, 90, 110), amp=8.0):
    """Concentric bright rings: tangential edges, perpendicular to the radius."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r = np.hypot(yy - cy, xx - cx)
    img = np.zeros((h, w), np.float32)
    for rad in radii:
        img += amp * np.exp(-0.5 * ((r - rad) / 1.2) ** 2)
    return img


def test_roi_detector_finds_ring_features():
    img = _circles_image()
    pool = PooledChannel(img)
    det = RoiDetector(pool, default_threshold=1.0)
    total = sum(len(b) for b in det.bins)
    assert total > 8, total


def test_template_match_recovers_shift():
    rng = np.random.default_rng(1)
    target = rng.random((64, 64)).astype(np.float32)
    # take a tile from a known position, search along a segment crossing it
    true_pos = np.array([24.0, 30.0])
    tile = target[24:40, 30:46]
    start = true_pos + np.array([-3.0, -3.0])
    end = true_pos + np.array([3.0, 3.0])
    got = template_match(target, tile, start, end)
    np.testing.assert_allclose(got, true_pos, atol=0.3)


def test_template_match_subpixel():
    # smooth target; tile sampled at fractional offset
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    target = np.sin(xx / 3.1) * np.cos(yy / 4.3)
    from pysp_tpu.correct.ca.matcher import _bilinear_patch

    true_pos = np.array([20.35, 25.6])
    tile = _bilinear_patch(
        target, np.array([true_pos[0]], np.float32), np.array([true_pos[1]], np.float32),
        12, 12,
    )[0]
    start = true_pos + np.array([-2.0, -2.0])
    end = true_pos + np.array([2.0, 2.0])
    got = template_match(target, tile, start, end)
    np.testing.assert_allclose(got, true_pos, atol=0.05)


# --- removal -------------------------------------------------------------------------
def _mosaic_from_rgb(rgb):
    h, w, _ = rgb.shape
    m = np.zeros((h, w), np.float32)
    m[0::2, 0::2] = rgb[0::2, 0::2, 0]
    m[0::2, 1::2] = rgb[0::2, 1::2, 1]
    m[1::2, 0::2] = rgb[1::2, 0::2, 1]
    m[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return m


def test_remove_ca_improves_alignment():
    """Distort R radially, correct with the true model, check R re-aligns with G."""
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w]
    r_px = np.hypot(yy - (h - 1) / 2, xx - (w - 1) / 2)
    img = (0.2 + sum(0.5 * np.exp(-0.5 * ((r_px - rad) / 2.5) ** 2)
                     for rad in (25, 40, 52))).astype(np.float32)
    rgb_clean = np.dstack([img, img, img]).astype(np.float32)

    # Synthesize CA: content moves from undistorted to distorted radius, i.e.
    # R_ca(p) = img(f^-1(p)) — the inverse coordinate field. k1 large enough that
    # the geometric displacement (~3 px at mid radius) dominates resampling softness.
    k1 = 0.08
    model = Poly3CorrectionModel(k1)
    coords = np.asarray(model.get_undistorted_coordinates(jnp.zeros((h, w))))
    map_x = np.clip(coords[..., 1] + (w - 1) / 2, 0, w - 1).astype(np.float32)
    map_y = np.clip(coords[..., 0] + (h - 1) / 2, 0, h - 1).astype(np.float32)
    r_distorted = np.asarray(remap_bilinear(jnp.asarray(img), map_x, map_y))

    rgb_ca = rgb_clean.copy()
    rgb_ca[..., 0] = r_distorted
    bayer = _mosaic_from_rgb(rgb_ca)
    frame = RawFrame.synthetic(bayer)

    corrected = remove_ca_from_raw(frame, model, None)
    fixed = np.asarray(corrected.bayer)

    # measure R-plane misalignment against the clean R before/after
    clean_r = rgb_clean[0::2, 0::2, 0]
    before = np.abs(bayer[0::2, 0::2] - clean_r)[4:-4, 4:-4].mean()
    after = np.abs(fixed[0::2, 0::2] - clean_r)[4:-4, 4:-4].mean()
    assert after < before * 0.5, (before, after)
    # G planes untouched
    np.testing.assert_array_equal(fixed[0::2, 1::2], bayer[0::2, 1::2])


def test_blind_fit_pipeline_recovers_distortion_sign():
    """Full blind pipeline on a ring scene with synthetic R-channel CA."""
    h = w = 256
    img = _circles_image(h, w, radii=(60, 85, 105), amp=0.6) + 0.1
    rgb = np.dstack([img, img, img]).astype(np.float32)

    k1 = 0.02
    model_true = Poly3CorrectionModel(k1)
    coords = np.asarray(model_true.get_undistorted_coordinates(jnp.zeros((h, w))))
    map_x = np.clip(coords[..., 1] + (w - 1) / 2, 0, w - 1).astype(np.float32)
    map_y = np.clip(coords[..., 0] + (h - 1) / 2, 0, h - 1).astype(np.float32)
    rgb_ca = rgb.copy()
    rgb_ca[..., 0] = np.asarray(remap_bilinear(jnp.asarray(img), map_x, map_y))

    frame = RawFrame.synthetic(_mosaic_from_rgb(rgb_ca))
    model_r, _ = compute_ca_lens_models_for_raw(
        frame,
        init_model_r=Poly3CorrectionModel(),
        init_model_b=None,
        max_distortion_additional_scale=0.03,
    )
    k1_fit = float(model_r.get_coefficients()[0])
    # blind fit from Bayer-domain instability: expect the right sign and order
    assert 0.002 < k1_fit < 0.08, k1_fit


def test_scale_pairs_device_matches_host():
    """Batched device template matching == per-tile host loop (within f32 eps)."""
    from pysp_tpu.correct.ca.roi import PooledChannel, RoiDetector
    from pysp_tpu.correct.ca.solver import get_radius_scale_factors_from_bins

    import jax.numpy as jnp
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel
    from pysp_tpu.ops.resample import remap_bilinear
    from pysp_tpu.utils.testing import ring_chart

    size = 384
    img = ring_chart(size, size, radii=(70, 110, 150), amp=0.5, base=0.25).astype(np.float32)
    model = Poly3CorrectionModel(0.03)
    coords = np.asarray(model.get_undistorted_coordinates(jnp.zeros((size, size))))
    mx = np.clip(coords[..., 1] + (size - 1) / 2, 0, size - 1).astype(np.float32)
    my = np.clip(coords[..., 0] + (size - 1) / 2, 0, size - 1).astype(np.float32)
    distorted = np.asarray(remap_bilinear(jnp.asarray(img), mx, my))

    pool = PooledChannel(distorted)
    detector = RoiDetector(pool, default_threshold=16)

    dev = get_radius_scale_factors_from_bins(detector, pool, img, max_reach=0.05, device=True)
    host = get_radius_scale_factors_from_bins(detector, pool, img, max_reach=0.05, device=False)
    assert dev.shape == host.shape and len(dev) > 4
    # f32 device positions vs f64 host positions: ~1e-4 px (documented in matcher)
    np.testing.assert_allclose(dev, host, atol=2e-4)


def test_remove_ca_apply_matches_cv2_transcription():
    """North-star per-stage gate: the full CA-apply path (G upsample -> inverse-warp
    G -> G-guided R/B upsample -> forward-warp -> Bayer re-sample) vs a NumPy/cv2
    transcription of the reference (corr_ca/ca_removal.py:48-132), >= 50 dB.

    Both sides use the same Poly5 radial model (the coordinate math itself is
    transcription-gated in test_coordinate_fields_roundtrip); the gate isolates the
    remap + resample composition.
    """
    import cv2

    import golden_ref as ref
    from pysp_tpu.correct.ca.models import Poly5CorrectionModel
    from pysp_tpu.correct.ca.removal import remove_ca_from_raw

    rng = np.random.default_rng(17)
    h = w = 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        0.4
        + 0.25 * np.sin(xx / 8) * np.cos(yy / 11)
        + 0.15 * ((xx + 2 * yy) % 23 > 11)
        + rng.normal(0, 0.005, (h, w))
    ).astype(np.float32)
    bayer = np.clip(base, 0.02, 0.98)
    wb = np.array([0.5, 1.0, 0.6], np.float32)
    frame = RawFrame.synthetic(bayer, wb_neutral=wb)

    model_r = Poly5CorrectionModel(0.004, -0.001)
    model_b = Poly5CorrectionModel(-0.003, 0.0008)

    got = np.asarray(remove_ca_from_raw(frame, model_r, model_b).bayer)

    # --- transcription (cv2.remap INTER_LINEAR + golden EAG resamples) ---
    def remap_off(chan, coords):
        ch, cw = chan.shape
        mx = np.clip(coords[..., 1] + (cw - 1) / 2.0, 0, cw - 1).astype(np.float32)
        my = np.clip(coords[..., 0] + (ch - 1) / 2.0, 0, ch - 1).astype(np.float32)
        return cv2.remap(chan, mx, my, cv2.INTER_LINEAR)

    def resample_chan(x, g_full, pos):
        g_hf = g_full - cv2.GaussianBlur(g_full, (3, 3), 1.0)
        g_sub = ref.split(g_full)[0 if pos == 0 else 2]
        return ref.ref_resample_channel(x, g_sub, g_hf, pos)

    wbr = 1.0 / wb
    r, g1, b, g2 = ref.split(bayer)
    g_res = ref.ref_resample_g_full(g1, g2)

    coords = np.asarray(model_r.get_undistorted_coordinates(jnp.asarray(g_res)))
    g_at_r = remap_off(g_res, coords)
    r_res = resample_chan(r * wbr[0], g_at_r, 0)
    coords = np.asarray(model_r.get_distorted_coordinates(jnp.asarray(r_res)))
    r_new = ref.split(remap_off(r_res, coords))[0] / wbr[0]

    coords = np.asarray(model_b.get_undistorted_coordinates(jnp.asarray(g_res)))
    g_at_b = remap_off(g_res, coords)
    b_res = resample_chan(b * wbr[2], g_at_b, 3)
    coords = np.asarray(model_b.get_distorted_coordinates(jnp.asarray(b_res)))
    b_new = ref.split(remap_off(b_res, coords))[2] / wbr[2]

    want = ref.merge(r_new, g1, b_new, g2)

    mse = np.mean((got.astype(np.float64) - want.astype(np.float64)) ** 2)
    p = np.inf if mse == 0 else 10 * np.log10(1.0 / mse)
    assert p > 50, p


def test_remove_ca_batched_frames_matches_per_frame():
    """remove_ca_from_raw on a batched RawFrame == the per-frame calls: the
    burst runs the per-frame program under lax.map (per-frame WB included)."""
    import jax

    from test_demosaic import make_scene, mosaic_rggb

    model = Poly3CorrectionModel(0.008)
    frames = []
    for i in range(3):
        rgb = make_scene(48, 64, seed=90 + i)
        frames.append(
            RawFrame.synthetic(
                mosaic_rggb(rgb),
                wb_neutral=np.array([0.5 + 0.05 * i, 1.0, 0.6], np.float32),
            )
        )
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    got = np.asarray(remove_ca_from_raw(batch, model, model).bayer)
    for i in range(3):
        want = np.asarray(remove_ca_from_raw(frames[i], model, model).bayer)
        np.testing.assert_allclose(got[i], want, atol=1e-6)
