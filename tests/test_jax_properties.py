"""JAX-native properties: differentiability, vmap, shape robustness, determinism."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu import DevelopConfig, QualityDemosaic, RawFrame, develop
from pysp_tpu.pipeline.develop import develop_burst
from pysp_tpu.utils.testing import make_scene, mosaic_rggb


@pytest.mark.parametrize("quality", [QualityDemosaic.Draft, QualityDemosaic.Fast,
                                     QualityDemosaic.Best])
def test_develop_is_differentiable(quality):
    """The whole develop is one differentiable program — e.g. for gradient-based
    calibration fitting (medians/selects have well-defined subgradients)."""
    bayer = mosaic_rggb(make_scene(32, 32, seed=0))
    frame = RawFrame.synthetic(bayer)
    cfg = DevelopConfig(quality=quality)

    def loss(b):
        out = develop(frame.replace(bayer=b), cfg)
        return jnp.mean((out - 0.5) ** 2)

    g = jax.grad(loss)(frame.bayer)
    g = np.asarray(g)
    assert g.shape == bayer.shape
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0  # gradient actually flows


def test_develop_odd_even_shapes():
    """Any even-sized mosaic works (sensors are not powers of two)."""
    rng = np.random.default_rng(1)
    cases = [((30, 42), QualityDemosaic.Draft), ((64, 32), QualityDemosaic.Fast),
             ((50, 50), QualityDemosaic.Best)]
    for shape, q in cases:
        frame = RawFrame.synthetic(rng.random(shape).astype(np.float32))
        out = np.asarray(develop(frame, DevelopConfig(quality=q)))
        assert out.shape == (*shape, 3)
        assert np.isfinite(out).all()


def test_develop_deterministic():
    bayer = mosaic_rggb(make_scene(32, 32, seed=2))
    frame = RawFrame.synthetic(bayer)
    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    a = np.asarray(develop(frame, cfg))
    b = np.asarray(develop(frame, cfg))
    np.testing.assert_array_equal(a, b)


def test_burst_matches_single():
    frames = [
        RawFrame.synthetic(mosaic_rggb(make_scene(32, 32, seed=3 + i)), ev=9.0 + i)
        for i in range(3)
    ]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    got = np.asarray(develop_burst(batch, cfg))
    for i, f in enumerate(frames):
        want = np.asarray(develop(f, cfg))
        # the lax.map body may compile with slightly different op scheduling than
        # the standalone program; isolated homogeneity-tie pixels can flip (ulp)
        np.testing.assert_allclose(got[i], want, atol=1e-4)


@pytest.mark.parametrize("quality", [QualityDemosaic.Draft, QualityDemosaic.Fast,
                                     QualityDemosaic.Best])
def test_develop_gradient_matches_finite_difference(quality):
    """The default config's develop is differentiable as it stands (no kernel
    without a VJP on any path): d(mean sRGB)/d(exposure gain) from jax.grad
    agrees with a central finite difference."""
    bayer = mosaic_rggb(make_scene(32, 48, seed=3)) * 0.6
    frame = RawFrame.synthetic(bayer, wb_neutral=np.array([0.5, 1.0, 0.7], np.float32))
    cfg = DevelopConfig(quality=quality)

    def mean_out(log_gain):
        return jnp.mean(develop(frame.replace(bayer=frame.bayer * jnp.exp(log_gain)), cfg))

    g = float(jax.grad(mean_out)(0.0))
    eps = 1e-2
    fd = float((mean_out(eps) - mean_out(-eps)) / (2 * eps))
    assert np.isfinite(g) and g > 0
    assert abs(g - fd) <= 0.02 * abs(fd), (g, fd)
