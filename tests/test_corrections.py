"""Sensor-space corrections: bad pixels, flat field, HDR stacking."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.core.bayer import bayer_to_planes, planes_to_bayer
from pysp_tpu.core.frame import RawFrame
from pysp_tpu.correct.bad_pixels import (
    diffusion_inpaint,
    find_erroneous_pixels_median,
    find_erroneous_pixels_threshold,
    find_shared_pixels,
    repair_bad_pixels,
)
from pysp_tpu.correct.flat_field import (
    dark_frame_subtraction,
    flat_frame_correction,
)
from pysp_tpu.correct.hdr import fuse_exposures_from_debayer, fuse_exposures_to_raw
from pysp_tpu.demosaic import demosaic_eag
from pysp_tpu.pipeline.develop import DevelopConfig, develop
from pysp_tpu.const import QualityDemosaic


def _smooth_bayer(h=32, w=32, seed=0, base=0.4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = base + 0.1 * np.sin(xx / 7) + 0.05 * np.cos(yy / 9)
    return (img + rng.normal(0, 0.002, (h, w))).astype(np.float32)


def test_threshold_detection_finds_hot_pixels():
    bayer = _smooth_bayer()
    # plant hot pixels on the R plane (even rows/cols) and G1 plane
    bayer[4, 4] = 0.99   # R site
    bayer[10, 13] = 0.99  # G1 site (even row, odd col)
    frame = RawFrame.synthetic(bayer)

    masks = np.asarray(find_erroneous_pixels_threshold(frame, min_delta=0.1))
    assert masks.shape == (4, 16, 16)
    assert masks[0, 2, 2]          # R plane hot pixel
    assert masks[1, 5, 6]          # G1 plane hot pixel
    assert masks.sum() == 2        # nothing else


def test_threshold_matches_reference_numpy():
    bayer = _smooth_bayer(seed=5)
    bayer[6, 8] = 0.9
    frame = RawFrame.synthetic(bayer)
    got = np.asarray(find_erroneous_pixels_threshold(frame))

    # reference transcription (raw_bad_pixel_corr.py:43-61)
    def ref_chan(chan, min_delta=0.025, min_count=5):
        padded = np.pad(chan, (1, 1), mode="reflect")
        neigh = [
            padded[:-2, 1:-1], padded[1:-1, 2:], padded[2:, 1:-1], padded[1:-1, :-2],
            padded[:-2, :-2], padded[:-2, 2:], padded[2:, 2:], padded[2:, :-2],
        ]
        higher = np.greater(chan - min_delta, np.array(neigh))
        return np.sum(higher, axis=0) > min_count

    planes = np.asarray(bayer_to_planes(jnp.asarray(bayer)))
    for i in range(4):
        np.testing.assert_array_equal(got[i], ref_chan(planes[i]))


def test_median_detection_and_repair_cycle():
    bayer = _smooth_bayer(seed=1)
    bayer[8, 8] = 1.0
    bayer[20, 21] = 0.98
    frame = RawFrame.synthetic(bayer)

    masks = find_erroneous_pixels_median(frame, multiplier=1.5, quantile=0.99)
    assert bool(masks[0, 4, 4])  # (8,8) is an R site

    repaired = repair_bad_pixels(frame, masks)
    fixed = np.asarray(repaired.bayer)
    # hot pixel healed to neighborhood level
    assert abs(fixed[8, 8] - 0.45) < 0.1
    # untouched pixels preserved
    untouched = ~np.asarray(planes_to_bayer(jnp.broadcast_to(masks[:, None], (4, 1, 16, 16))[:, 0]))
    np.testing.assert_allclose(fixed[untouched], bayer[untouched], atol=1e-6)


def test_find_shared_pixels():
    m1 = np.zeros((4, 8, 8), bool)
    m2 = np.zeros((4, 8, 8), bool)
    m3 = np.zeros((4, 8, 8), bool)
    m1[0, 1, 1] = m2[0, 1, 1] = m3[0, 1, 1] = True  # in all 3
    m1[2, 3, 3] = True  # only in 1
    shared = np.asarray(find_shared_pixels([m1, m2, m3], min_ratio=0.5))
    assert shared[0, 1, 1]
    assert not shared[2, 3, 3]
    assert find_shared_pixels([], 0.5) is None
    assert find_shared_pixels([m1, np.zeros((4, 4, 4), bool)]) is None


def test_masked_fill_inpaint():
    from pysp_tpu.correct.bad_pixels import masked_fill_inpaint

    rng = np.random.default_rng(4)
    chan = jnp.asarray(rng.random((24, 24)).astype(np.float32))
    mask = jnp.zeros((24, 24), bool)
    # isolated pixel: converged solution == average of its 4 valid neighbors
    mask = mask.at[5, 7].set(True)
    # 2x2 cluster
    mask = mask.at[14:16, 10:12].set(True)
    out = np.asarray(masked_fill_inpaint(chan, mask))
    c = np.asarray(chan)
    want_iso = (c[4, 7] + c[6, 7] + c[5, 6] + c[5, 8]) / 4
    np.testing.assert_allclose(out[5, 7], want_iso, rtol=1e-6)
    # cluster pixels land within the neighborhood's value range
    lo, hi = c[12:18, 8:14].min(), c[12:18, 8:14].max()
    assert (out[14:16, 10:12] >= lo - 1e-6).all()
    assert (out[14:16, 10:12] <= hi + 1e-6).all()
    # untouched pixels bit-preserved
    m = np.asarray(mask)
    np.testing.assert_array_equal(out[~m], c[~m])


def test_diffusion_inpaint_flat_region():
    chan = jnp.full((16, 16), 0.7)
    chan = chan.at[5, 5].set(5.0)
    mask = jnp.zeros((16, 16), bool).at[5, 5].set(True)
    out = np.asarray(diffusion_inpaint(chan, mask, 16))
    assert abs(out[5, 5] - 0.7) < 1e-3
    np.testing.assert_allclose(out[~np.asarray(mask)], 0.7)


def test_flat_field_matches_reference_numpy():
    rng = np.random.default_rng(2)
    bayer = _smooth_bayer(seed=2)
    flat = (0.8 + 0.2 * rng.random((32, 32))).astype(np.float32)

    frame = RawFrame.synthetic(bayer)
    flat_frame = RawFrame.synthetic(flat)
    got = np.asarray(flat_frame_correction(frame, flat_frame).bayer)

    # reference transcription (raw_correction.py:41-56)
    def ref_correct(chan, chan_flat):
        mean_chan = np.mean(chan_flat)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (chan * mean_chan) / chan_flat
        if np.isinf(out).all():
            return np.copy(chan)
        max_out = np.max(np.ma.masked_invalid(out))
        out[out == np.inf] = max_out
        out[out < 0] = 0
        return out

    planes = np.asarray(bayer_to_planes(jnp.asarray(bayer)))
    flat_planes = np.asarray(bayer_to_planes(jnp.asarray(flat)))
    want = np.stack([ref_correct(planes[i], flat_planes[i]) for i in range(4)])
    got_planes = np.asarray(bayer_to_planes(jnp.asarray(got)))
    np.testing.assert_allclose(got_planes, want, atol=1e-5)


def test_flat_field_zero_flat_leaves_image():
    bayer = _smooth_bayer(seed=3)
    frame = RawFrame.synthetic(bayer)
    flat_frame = RawFrame.synthetic(np.zeros_like(bayer))
    got = np.asarray(flat_frame_correction(frame, flat_frame).bayer)
    np.testing.assert_allclose(got, bayer, atol=1e-6)


def _stack_frames(frames):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)


def test_hdr_raw_fuse_matches_reference_numpy():
    rng = np.random.default_rng(4)
    evs = [8.0, 10.0, 12.0]
    wb_neutral = np.array([0.5, 1.0, 0.7], np.float32)
    bayers = [
        np.clip(_smooth_bayer(seed=10 + i) * (0.5 + 0.3 * i), 0, 1) for i in range(3)
    ]
    # Force zero-weight pixels in EVERY frame so the brightest-frame fallback
    # (the in-reduce one-hot select) actually executes: the tent weight
    # 0.5 - |x - 0.5| is exactly 0 at x==0.0 and x==1.0 only.
    for b in bayers:
        b[2:6, 2:6] = 0.0  # black block (dead pixels / hard shadow)
        b[10:14, 20:24] = 1.0  # saturated block
    frames = [
        RawFrame.synthetic(b, wb_neutral=wb_neutral, ev=e)
        for b, e in zip(bayers, evs)
    ]
    hdr, counts = fuse_exposures_to_raw(_stack_frames(frames))

    # reference transcription (raw_hdr.py:110-156)
    target = np.mean(evs)
    offsets = [2 ** (e - target) for e in evs]
    wb = 1.0 / wb_neutral
    h2, w2 = 16, 16
    noise_w = np.zeros((32, 32), np.float32)
    noise_w[0::2, 0::2] = wb[0]
    noise_w[0::2, 1::2] = wb[1]
    noise_w[1::2, 1::2] = wb[2]
    noise_w[1::2, 0::2] = wb[1]

    sum_pixel = np.zeros((32, 32), np.float32)
    sum_weight = np.zeros((32, 32), np.float32)
    for b, off in zip(bayers, offsets):
        bias = 1.6 ** (-0.1 * np.abs(off * noise_w))
        weights = (0.5 - np.abs(b - 0.5)) * bias
        sum_weight += weights
        sum_pixel += b * weights * off
    max_exp = bayers[int(np.argmax(offsets))] * max(offsets)
    with np.errstate(divide="ignore", invalid="ignore"):
        fused = sum_pixel / sum_weight
    fused = np.where(sum_weight == 0, max_exp, fused)

    np.testing.assert_allclose(np.asarray(hdr.bayer), fused, atol=1e-5)
    assert hdr.is_hdr
    assert float(hdr.lim_sat) == max(offsets)
    assert abs(float(hdr.ev) - target) < 1e-6

    # Fallback coverage: the forced blocks have sum_weight == 0 in every frame,
    # so those pixels must carry the brightest frame's EV-scaled value exactly
    # and report zero contributions in the debug counts.
    fallback = sum_weight == 0
    assert fallback.any(), "test data must exercise the zero-weight fallback"
    np.testing.assert_array_equal(
        np.asarray(hdr.bayer)[fallback], max_exp[fallback]
    )
    counts_np = np.asarray(counts)
    assert (counts_np[fallback] == 0).all()
    # and non-fallback pixels count every contributing frame
    want_counts = sum(
        ((0.5 - np.abs(b - 0.5)) * (1.6 ** (-0.1 * np.abs(off * noise_w))) > 0)
        for b, off in zip(bayers, offsets)
    )
    np.testing.assert_array_equal(counts_np, want_counts)


def test_hdr_then_develop():
    """BASELINE config 4 shape: HDR stack -> AHD develop -> sRGB."""
    evs = [9.0, 10.0, 11.0]
    frames = [
        RawFrame.synthetic(
            np.clip(_smooth_bayer(seed=20 + i) * (0.6 + 0.2 * i), 0, 1), ev=e
        )
        for i, e in enumerate(evs)
    ]
    hdr, _ = fuse_exposures_to_raw(_stack_frames(frames))
    out = np.asarray(develop(hdr, DevelopConfig(quality=QualityDemosaic.Best)))
    assert out.shape == (32, 32, 3)
    assert np.all(np.isfinite(out))


def test_hdr_debayer_fuse_runs():
    evs = [9.0, 11.0]
    frames = [
        RawFrame.synthetic(
            np.clip(_smooth_bayer(seed=30 + i), 0, 1),
            wb_neutral=np.array([0.5, 1.0, 0.7], np.float32),
            ev=e,
        )
        for i, e in enumerate(evs)
    ]
    images = [demosaic_eag(f) for f in frames]
    batch = _stack_frames(images)
    lin, counts = fuse_exposures_from_debayer(batch)
    assert lin.shape == (32, 32, 3)
    assert np.all(np.isfinite(np.asarray(lin)))
    assert int(np.asarray(counts).max()) <= 2


def test_multisect_quantile_matches_order_statistics():
    """The count-multisection quantile lands within one order-statistic gap of
    numpy's quantile, per plane (the detector's documented tolerance)."""
    from pysp_tpu.correct.bad_pixels import _bisect_quantile

    rng = np.random.default_rng(3)
    delta = jnp.asarray(
        np.abs(rng.standard_normal((4, 64, 96))).astype(np.float32) ** 2
    )
    for q in (0.9, 0.99, 0.9999):
        got = np.asarray(_bisect_quantile(delta, q))
        flat = np.sort(np.asarray(delta).reshape(4, -1), axis=1)
        n = flat.shape[1]
        k = q * (n - 1)
        lo_stat = flat[np.arange(4), int(np.floor(k))]
        hi_stat = flat[np.arange(4), min(int(np.floor(k)) + 1, n - 1)]
        # within the bracketing order statistics, plus the final bracket width
        # (4 passes of 16-way narrow the initial range by 17^4)
        slack = (flat[:, -1] - flat[:, 0]) / 17.0**4 + 1e-6
        assert np.all(got >= lo_stat - slack), (q, got, lo_stat)
        assert np.all(got <= hi_stat + slack), (q, got, hi_stat)


def test_compact_mask_indices_matches_nonzero():
    """The scatter-free compaction (block gather + matmul prefix sum) is
    bit-identical to jnp.nonzero(size=K) on empty, sparse, dense, overflowing,
    and non-block-aligned masks."""
    from pysp_tpu.correct.bad_pixels import compact_mask_indices

    rng = np.random.default_rng(5)
    for n, k, density in (
        (70_000, 512, 1e-4),
        (1000, 16, 0.02),
        (1024, 8, 0.5),  # overflow: more sites than slots
        (333, 333, 0.0),  # empty, size not a block multiple
        (512, 4, 1.0),  # all set
    ):
        m = jnp.asarray(rng.random(n) < density)
        got = np.asarray(compact_mask_indices(m, k))
        want = np.asarray(jnp.nonzero(m, size=k, fill_value=n)[0])
        np.testing.assert_array_equal(got, want, err_msg=f"n={n} k={k} d={density}")


def test_sparse_inpaint_matches_dense():
    """The compacted-site fill is bit-identical to the dense masked fill on
    isolated pixels, borders/corners, clusters, and unreachable blobs."""
    from pysp_tpu.correct.bad_pixels import (
        masked_fill_inpaint,
        masked_fill_inpaint_sparse,
    )

    rng = np.random.default_rng(11)
    chan = jnp.asarray(rng.random((4, 48, 64)).astype(np.float32))
    mask = np.zeros((4, 48, 64), bool)
    # isolated scatter incl. borders and corners
    mask[(rng.random((4, 48, 64)) < 2e-3)] = True
    mask[0, 0, 0] = mask[1, 47, 63] = mask[2, 0, 30] = mask[3, 20, 0] = True
    # a 3x3 cluster and a blob too big for 4 fill passes to reach its core
    mask[0, 10:13, 10:13] = True
    mask[1, 20:33, 20:33] = True
    mask = jnp.asarray(mask)

    dense = np.asarray(masked_fill_inpaint(chan, mask))
    sparse = np.asarray(masked_fill_inpaint_sparse(chan, mask, max_sites=1024))
    np.testing.assert_array_equal(sparse, dense)


def _ref_heal(planes, mask, fill_iterations=4, smooth_iterations=2):
    """NumPy transcription of the mask-aware heal: normalized 4-neighbour fill,
    plane-mean seed for unreached sites, harmonic smoothing; replicate border."""
    planes = planes.astype(np.float32)

    def nb_sum(a):
        ap = np.pad(a, ((0, 0), (1, 1), (1, 1)), mode="edge")
        return ap[:, :-2, 1:-1] + ap[:, 2:, 1:-1] + ap[:, 1:-1, :-2] + ap[:, 1:-1, 2:]

    v = (~mask).astype(np.float32)
    x = planes * v
    for _ in range(fill_iterations):
        xs, vs = nb_sum(x), nb_sum(v)
        x = np.where(v > 0, x, xs / np.maximum(vs, 1.0))
        v = np.minimum(v + vs, 1.0)
    x = np.where(v > 0, x, planes.mean(axis=(1, 2), keepdims=True))
    for _ in range(smooth_iterations):
        x = np.where(mask, nb_sum(x) * 0.25, planes)
    return np.where(mask, x, planes)


@pytest.mark.parametrize(
    "case", ["isolated", "scattered", "over_max_sites", "border_clusters"]
)
def test_repair_bad_pixels_matches_reference(case):
    """repair_bad_pixels (sparse branch below its site bound, dense above)
    against the NumPy heal, across mask densities and border clusters."""
    from pysp_tpu.core.bayer import bayer_to_planes, planes_to_bayer
    from pysp_tpu.correct.bad_pixels import repair_bad_pixels

    rng = np.random.default_rng(23)
    h, w = 256, 384
    frame = RawFrame.synthetic(rng.random((h, w)).astype(np.float32))
    shape = (4, h // 2, w // 2)
    density = {"isolated": 5e-4, "scattered": 2e-2, "over_max_sites": 0.12,
               "border_clusters": 0.0}[case]
    mask = rng.random(shape) < density
    if case == "border_clusters":
        mask[0, :3, :3] = True  # corner
        mask[1, -2:, 40:44] = True  # bottom edge
        mask[2, 60:63, -3:] = True  # right edge
        mask[3, 10:25, 0:15] = True  # too big for 4 fill passes
    n_sites = int(mask.sum())
    assert (n_sites > 8192) == (case == "over_max_sites")

    got = np.asarray(repair_bad_pixels(frame, jnp.asarray(mask)).bayer)
    planes = np.asarray(bayer_to_planes(frame.bayer))
    want = np.asarray(planes_to_bayer(jnp.asarray(_ref_heal(planes, mask))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_repair_dense_fallback_on_huge_mask():
    """repair_bad_pixels falls back to the dense fill when the site count
    exceeds the sparse bound — same healed result either way."""
    from pysp_tpu.core.bayer import bayer_to_planes, planes_to_bayer
    from pysp_tpu.correct.bad_pixels import masked_fill_inpaint, repair_bad_pixels

    rng = np.random.default_rng(12)
    bayer = rng.random((512, 512)).astype(np.float32)
    frame = RawFrame.synthetic(bayer)
    # > 32768 flagged sites forces the dense branch of the lax.cond
    mask = jnp.asarray(rng.random((4, 256, 256)) < 0.6)
    assert int(jnp.sum(mask)) > 32768

    got = np.asarray(repair_bad_pixels(frame, mask).bayer)
    planes = bayer_to_planes(frame.bayer)
    want = np.asarray(planes_to_bayer(masked_fill_inpaint(planes, mask)))
    np.testing.assert_array_equal(got, want)
