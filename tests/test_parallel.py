"""Multi-device sharding on the 8-device virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.const import QualityDemosaic
from pysp_tpu.core.frame import RawFrame
from pysp_tpu.parallel.mesh import make_mesh
from pysp_tpu.parallel.spatial import develop_burst_sharded, develop_spatial
from pysp_tpu.pipeline.develop import DevelopConfig, develop

from test_demosaic import make_scene, mosaic_rggb, psnr


requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@requires_multi
def test_spatial_sharded_develop_matches_monolithic():
    rgb = make_scene(128, 64, seed=7)
    bayer = mosaic_rggb(rgb)
    frame = RawFrame.synthetic(bayer)
    cfg = DevelopConfig(quality=QualityDemosaic.Best)

    mesh = make_mesh((1, 4))
    got = np.asarray(develop_spatial(frame, cfg, mesh, halo=16))
    want = np.asarray(develop(frame, cfg))

    assert got.shape == want.shape
    # interior rows exact; global edge rows may differ within the stencil reach
    interior = np.s_[16:-16, :]
    np.testing.assert_allclose(got[interior], want[interior], atol=2e-5)
    assert psnr(got, want) > 45


@requires_multi
def test_spatial_sharded_draft_and_fast():
    rgb = make_scene(64, 48, seed=8)
    frame = RawFrame.synthetic(mosaic_rggb(rgb))
    mesh = make_mesh((1, 2))
    for q in (QualityDemosaic.Draft, QualityDemosaic.Fast):
        cfg = DevelopConfig(quality=q)
        got = np.asarray(develop_spatial(frame, cfg, mesh, halo=16))
        want = np.asarray(develop(frame, cfg))
        np.testing.assert_allclose(got[16:-16], want[16:-16], atol=2e-5)


@requires_multi
def test_burst_sharded_develop():
    frames = []
    for i in range(8):
        rgb = make_scene(32, 32, seed=10 + i)
        frames.append(RawFrame.synthetic(mosaic_rggb(rgb), ev=9.0 + i * 0.1))
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    mesh = make_mesh((8, 1))
    cfg = DevelopConfig(quality=QualityDemosaic.Fast)
    got = np.asarray(develop_burst_sharded(batch, cfg, mesh))
    assert got.shape == (8, 32, 32, 3)

    for i in (0, 3, 7):
        want = np.asarray(develop(frames[i], cfg))
        np.testing.assert_allclose(got[i], want, atol=2e-5)


@requires_multi
def test_combined_mesh_axes():
    """2x4 mesh: burst sharded over batch while rows shard spatially."""
    mesh = make_mesh((2, 4))
    assert mesh.shape["batch"] == 2 and mesh.shape["spatial"] == 4

    rgb = make_scene(64, 32, seed=20)
    frame = RawFrame.synthetic(mosaic_rggb(rgb))
    cfg = DevelopConfig(quality=QualityDemosaic.Fast)
    got = np.asarray(develop_spatial(frame, cfg, mesh, halo=8))
    want = np.asarray(develop(frame, cfg))
    np.testing.assert_allclose(got[8:-8], want[8:-8], atol=2e-5)


# ---------------------------------------------------------------------------
# Full pipeline under the mesh (VERDICT r3 item 4)
# ---------------------------------------------------------------------------
@requires_multi
def test_pipeline_sharded_config5_parity():
    """Config-5 semantics (corrections + CA + Best + warp) batch-sharded must
    match the unsharded per-frame composition on every frame."""
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel
    from pysp_tpu.correct.ca.removal import remove_ca_from_raw
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded
    from pysp_tpu.pipeline.pipeline import PipelineConfig, _correct_one
    from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

    n, h, w = 8, 48, 64
    model = Poly3CorrectionModel(0.01)
    warp_block = encode_warp_rectilinear(
        [(1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)] * 3, (0.5, 0.5)
    )
    rng = np.random.default_rng(40)
    frames = []
    for i in range(n):
        rgb = make_scene(h, w, seed=40 + i)
        frames.append(
            RawFrame.synthetic(mosaic_rggb(rgb), ev=9.0 + 0.05 * i)
        )
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    flat = RawFrame.synthetic(
        np.clip(1.0 - 0.2 * rng.random((h, w)), 0.2, 1).astype(np.float32)
    )

    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Fast),
        flat_field=True,
    )
    mesh = make_mesh((8, 1))
    got = np.asarray(
        develop_pipeline_sharded(
            batch, mesh, cfg, ca_model_r=model, ca_model_b=model,
            warp_block=warp_block, warp_interpolation="bilinear", flat=flat,
        )
    )
    assert got.shape == (n, h, w, 3) and np.isfinite(got).all()

    for i in (0, 3, 7):
        f = _correct_one(frames[i], cfg, flat, None, None)
        f = remove_ca_from_raw(f, model, model)
        img = develop(f, cfg.develop)
        want = np.asarray(
            apply_opcode_3_warp(img, warp_block, interpolation="bilinear")
        )
        np.testing.assert_allclose(got[i], want, atol=3e-5)


@requires_multi
def test_pipeline_sharded_consensus_masks_psum():
    """Burst-consensus hot-pixel masks reduce across the sharded frame axis:
    a pixel hot in >= ratio of ALL frames heals on every shard."""
    from pysp_tpu.correct.bad_pixels import find_erroneous_pixels_median
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded
    from pysp_tpu.pipeline.pipeline import PipelineConfig, develop_pipeline

    n, h, w = 8, 32, 32
    frames = []
    for i in range(n):
        b = np.asarray(mosaic_rggb(make_scene(h, w, seed=60 + i)))
        b = b * 0.6 + 0.1
        b[9, 13] = 1.0  # hot in every frame -> consensus keeps it
        if i < 3:
            b[21, 5] = 1.0  # hot in 3/8 frames only -> consensus drops it
        frames.append(RawFrame.synthetic(np.asarray(b, np.float32)))
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Draft),
        repair_hot_pixels=True,
        hot_pixel_shared_ratio=0.6,
    )
    mesh = make_mesh((4, 1))
    got = np.asarray(develop_pipeline_sharded(batch, mesh, cfg))
    want = np.asarray(develop_pipeline(batch, cfg))
    np.testing.assert_allclose(got, want, atol=3e-5)


@requires_multi
def test_hdr_sharded_config4_parity():
    """Config-4 under the mesh: psum HDR fuse + spatially sharded develop
    matches the unsharded develop_pipeline on interior rows."""
    from pysp_tpu.parallel.pipeline_sharded import develop_hdr_sharded
    from pysp_tpu.pipeline.pipeline import PipelineConfig, develop_pipeline

    n, h, w = 4, 64, 48
    frames = []
    for i in range(n):
        b = np.clip(
            np.asarray(mosaic_rggb(make_scene(h, w, seed=70 + i)))
            * (0.5 + 0.2 * i),
            0,
            1,
        )
        frames.append(
            RawFrame.synthetic(np.asarray(b, np.float32), ev=9.0 + i)
        )
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)

    cfg = PipelineConfig(
        develop=DevelopConfig(quality=QualityDemosaic.Fast), fuse_hdr=True
    )
    mesh = make_mesh((2, 4))
    halo = 8
    got = np.asarray(develop_hdr_sharded(batch, mesh, cfg, halo=halo))
    want = np.asarray(develop_pipeline(batch, cfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got[halo:-halo], want[halo:-halo], atol=3e-5)
    # whole-frame PSNR is dominated by the 2*halo edge rows (25% of this tiny
    # frame), where the sharded path's CFA-reflect padding legitimately differs
    # from the monolithic develop's internal border modes (develop_spatial
    # docstring); interior rows above are gated exactly.
    assert psnr(got, want) > 38


@requires_multi
def test_pipeline_sharded_rejects_fuse_hdr():
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded
    from pysp_tpu.pipeline.pipeline import PipelineConfig

    frames = [
        RawFrame.synthetic(np.asarray(mosaic_rggb(make_scene(16, 16, seed=80 + i))))
        for i in range(2)
    ]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    with pytest.raises(ValueError, match="fuse_hdr"):
        develop_pipeline_sharded(
            batch, make_mesh((2, 1)), PipelineConfig(fuse_hdr=True)
        )
