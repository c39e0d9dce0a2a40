"""Row-sharded CA + develop + warp (parallel/spatial_pipeline.py).

Closes SURVEY item 63's partial (VERDICT r4 missing #1): CA removal and the
DNG rectilinear warp gain a spatial path, so a single large frame can use the
mesh for everything past decode. Gates: the windowed coordinate primitives
are bit-identical to slices of the monolithic tables, and interior rows of
the sharded config-5-shaped pipeline match the monolithic composition on the
virtual 8-device mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.const import QualityDemosaic
from pysp_tpu.core.frame import RawFrame
from pysp_tpu.parallel.mesh import make_mesh
from pysp_tpu.parallel.spatial_pipeline import (
    develop_frame_spatial,
    required_spatial_halo,
)
from pysp_tpu.pipeline.develop import DevelopConfig, develop
from pysp_tpu.pipeline.pipeline import PipelineConfig, develop_pipeline
from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

from test_demosaic import make_scene, mosaic_rggb, psnr

requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

WARP_COEFFS = (1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)


# ---------------------------------------------------------------------------
# windowed coordinate primitives == slices of the monolithic tables
# ---------------------------------------------------------------------------
def test_ca_window_coordinates_match_slices():
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel

    model = Poly3CorrectionModel(0.012)
    h, w = 96, 64
    probe = jnp.zeros((h, w), jnp.float32)
    full_fwd = np.asarray(model.get_distorted_coordinates(probe))
    full_inv = np.asarray(model.get_undistorted_coordinates(probe))
    for r0, n in ((0, 16), (30, 32), (70, 26)):
        win_fwd = np.asarray(
            model.get_distorted_coordinates_window(n, r0, (h, w))
        )
        win_inv = np.asarray(
            model.get_undistorted_coordinates_window(n, r0, (h, w))
        )
        np.testing.assert_array_equal(win_fwd, full_fwd[r0 : r0 + n])
        np.testing.assert_array_equal(win_inv, full_inv[r0 : r0 + n])


def test_warp_table_window_matches_slices():
    from pysp_tpu.warp.rectilinear import (
        compute_remapping_table,
        compute_remapping_table_window,
    )

    h, w = 80, 112
    fx, fy = compute_remapping_table(WARP_COEFFS, w, h, (0.5, 0.5), 0.9)
    fx, fy = np.asarray(fx), np.asarray(fy)
    for r0, n in ((0, 20), (24, 40), (56, 24)):
        wx, wy = compute_remapping_table_window(
            WARP_COEFFS, w, h, (0.5, 0.5), 0.9, r0, n
        )
        np.testing.assert_array_equal(np.asarray(wx), fx[r0 : r0 + n])
        np.testing.assert_array_equal(np.asarray(wy), fy[r0 : r0 + n])


def test_window_coordinates_accept_traced_row0():
    """row0 is a shard index inside shard_map — the windows must trace."""
    from pysp_tpu.correct.ca.models import Poly5CorrectionModel

    model = Poly5CorrectionModel(0.004, -0.001)
    h, w = 64, 48

    @jax.jit
    def f(r0):
        return model.get_distorted_coordinates_window(16, r0, (h, w))

    got = np.asarray(f(jnp.int32(24)))
    want = np.asarray(
        model.get_distorted_coordinates(jnp.zeros((h, w), jnp.float32))
    )[24:40]
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# sharded single-frame pipeline vs the monolithic composition
# ---------------------------------------------------------------------------
def _monolithic(frame, cfg, model_r, model_b, warp_block, interp, flat=None,
                dark=None):
    from pysp_tpu.correct.ca.removal import remove_ca_from_raw
    from pysp_tpu.pipeline.pipeline import _correct_one

    f = _correct_one(frame, cfg, flat, dark, None)
    if model_r is not None or model_b is not None:
        f = remove_ca_from_raw(f, model_r, model_b)
    img = develop(f, cfg.develop)
    if warp_block is not None:
        want = apply_opcode_3_warp(img, warp_block, interpolation=interp)
    else:
        want = img
    return np.asarray(want)


@requires_multi
def test_frame_spatial_config5_parity():
    """CA + Best develop + rectilinear warp row-sharded over 4 devices matches
    the monolithic pipeline on interior rows (the VERDICT item's done-gate)."""
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel

    h, w = 256, 96
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=90)))
    model = Poly3CorrectionModel(0.01)
    warp_block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Best))

    mesh = make_mesh((1, 4))
    got = np.asarray(
        develop_frame_spatial(
            frame, mesh, cfg, ca_model_r=model, ca_model_b=model,
            warp_block=warp_block, warp_interpolation="bilinear",
        )
    )
    want = _monolithic(frame, cfg, model, model, warp_block, "bilinear")
    assert got.shape == want.shape == (h, w, 3)
    assert np.isfinite(got).all()
    # edge rows differ within the stencil/displacement reach of the GLOBAL
    # edge (CFA-reflect policy, develop_spatial docstring); interior exact
    edge = 32
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], atol=3e-5)
    assert psnr(got, want) > 40


@requires_multi
def test_frame_spatial_lanczos_warp_parity():
    h, w = 192, 64
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=91)))
    warp_block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.45, 0.55))
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast))

    mesh = make_mesh((1, 2))
    got = np.asarray(
        develop_frame_spatial(
            frame, mesh, cfg, warp_block=warp_block,
            warp_interpolation="lanczos4",
        )
    )
    want = _monolithic(frame, cfg, None, None, warp_block, "lanczos4")
    edge = 32
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], atol=3e-5)


@requires_multi
def test_frame_spatial_corrections_global_stats():
    """flat + dark + hot pixels + denoise under the spatial mesh: the global
    statistics (flat means, quantile threshold, denoise sigma) must come out
    collective — interior parity with the monolithic pipeline proves it."""
    rng = np.random.default_rng(92)
    h, w = 256, 64
    bayer = np.asarray(mosaic_rggb(make_scene(h, w, seed=92))) * 0.6 + 0.1
    # hot pixels in different shards' rows: a per-shard quantile would pick
    # different thresholds and flip masks
    for (y, x) in ((8, 9), (77, 30), (150, 11), (233, 50)):
        bayer[y, x] = 1.0
    frame = RawFrame.synthetic(np.asarray(bayer, np.float32))
    flat = RawFrame.synthetic(
        np.clip(
            1.0 - 0.3 * (np.linspace(0, 1, h)[:, None] ** 2)
            - 0.05 * rng.random((h, w)),
            0.2,
            1,
        ).astype(np.float32)
    )
    dark = RawFrame.synthetic(
        (0.01 * rng.random((h, w))).astype(np.float32)
    )

    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Draft),
        flat_field=True,
        dark_frame=True,
        repair_hot_pixels=True,
        denoise_strength=0.8,
    )
    mesh = make_mesh((1, 4))
    got = np.asarray(
        develop_frame_spatial(frame, mesh, cfg, flat=flat, dark=dark)
    )
    want = np.asarray(develop_pipeline(frame, cfg, flat=flat, dark=dark))
    edge = 40
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], atol=3e-5)


@requires_multi
def test_frame_spatial_gather_path_small_blocks():
    """halo >= rows_local triggers the all_gather assembly; parity holds."""
    h, w = 128, 64
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=93)))
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast))
    mesh = make_mesh((1, 8))  # rows_local = 16 < any config-5 halo
    warp_block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    got = np.asarray(
        develop_frame_spatial(
            frame, mesh, cfg, warp_block=warp_block,
            warp_interpolation="bilinear",
        )
    )
    want = _monolithic(frame, cfg, None, None, warp_block, "bilinear")
    edge = 24
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], atol=3e-5)


@requires_multi
def test_frame_spatial_rejects_bad_inputs():
    frame = RawFrame.synthetic(mosaic_rggb(make_scene(64, 48, seed=94)))
    mesh = make_mesh((1, 4))
    with pytest.raises(ValueError, match="fuse_hdr"):
        develop_frame_spatial(
            frame, mesh, PipelineConfig(fuse_hdr=True)
        )
    batch = jax.tree_util.tree_map(
        lambda x: jnp.stack([x, x]), frame
    )
    with pytest.raises(ValueError, match="ONE frame"):
        develop_frame_spatial(batch, mesh, PipelineConfig())


def test_required_spatial_halo_accounting():
    cfg = PipelineConfig(repair_hot_pixels=True, denoise_strength=1.0)
    halo = required_spatial_halo(cfg, (None, None), [], "lanczos4")
    assert halo % 2 == 0
    base = required_spatial_halo(PipelineConfig(), (None, None), [], "bilinear")
    assert halo > base
    # a CA bound and a warp op both widen it
    with_ca = required_spatial_halo(
        PipelineConfig(), (5, None), [], "bilinear"
    )
    assert with_ca > base
    with_warp = required_spatial_halo(
        PipelineConfig(),
        (None, None),
        [((WARP_COEFFS,) * 3, (0.5, 0.5), ((-6, 6), (-6, 6)), "lanczos4")],
        "lanczos4",
    )
    assert with_warp > base


@requires_multi
def test_pipeline_sharded_batch_x_spatial_parity():
    """develop_pipeline_sharded on a ('batch','spatial') mesh: frames
    data-parallel AND rows halo-sharded; every frame matches the monolithic
    composition on interior rows (the full item-63 done-gate)."""
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded

    n, h, w = 4, 128, 64
    model = Poly3CorrectionModel(0.01)
    warp_block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))
    frames = [
        RawFrame.synthetic(mosaic_rggb(make_scene(h, w, seed=95 + i)),
                           ev=9.0 + 0.1 * i)
        for i in range(n)
    ]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    cfg = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast))

    mesh = make_mesh((2, 4))
    got = np.asarray(
        develop_pipeline_sharded(
            batch, mesh, cfg, ca_model_r=model, ca_model_b=model,
            warp_block=warp_block, warp_interpolation="bilinear",
        )
    )
    assert got.shape == (n, h, w, 3) and np.isfinite(got).all()
    edge = 32
    for i in (0, 3):
        want = _monolithic(frames[i], cfg, model, model, warp_block, "bilinear")
        np.testing.assert_allclose(
            got[i, edge:-edge], want[edge:-edge], atol=3e-5
        )


@requires_multi
def test_pipeline_spatial_consensus_masks():
    """Burst-consensus hot pixels under ('batch','spatial'): counts psum over
    'batch', quantiles psum over 'spatial' — matches the monolithic pipeline."""
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded

    n, h, w = 4, 64, 48
    frames = []
    for i in range(n):
        b = np.asarray(mosaic_rggb(make_scene(h, w, seed=100 + i))) * 0.6 + 0.1
        b[9, 13] = 1.0  # hot everywhere -> consensus keeps it
        if i < 1:
            b[41, 5] = 1.0  # hot in 1/4 frames -> consensus drops it
        frames.append(RawFrame.synthetic(np.asarray(b, np.float32)))
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Draft),
        repair_hot_pixels=True,
        hot_pixel_shared_ratio=0.6,
    )
    mesh = make_mesh((2, 2))
    got = np.asarray(develop_pipeline_sharded(batch, mesh, cfg))
    want = np.asarray(develop_pipeline(batch, cfg))
    edge = 16
    np.testing.assert_allclose(
        got[:, edge:-edge], want[:, edge:-edge], atol=3e-5
    )
