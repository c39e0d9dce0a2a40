"""Displacement-bounded select-chain remaps (ops/resample.py) against the gathers.

``remap_bounded`` selects each tap's value from clamped shifts of the image
instead of gathering it. With true bounds the selected values are the gathered
ones, so results match the gather remaps up to FMA-contraction noise (XLA may
contract a*(1-f)+b*f differently in the two programs): a few ulp for bilinear,
~1e-5 for the 64-tap lanczos4 sums.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.ops.resample import (
    remap_bilinear,
    remap_bilinear_bounded,
    remap_bounded,
    remap_lanczos4,
    remap_lanczos4_bounded,
)

ATOL = {"bilinear": 5e-7, "lanczos4": 2e-5}
GATHER = {"bilinear": remap_bilinear, "lanczos4": remap_lanczos4}


def _bounds(mx, my):
    h, w = mx.shape[-2], mx.shape[-1]
    yy, xx = np.mgrid[0:h, 0:w]
    fdy = np.floor(my) - yy
    fdx = np.floor(mx) - xx
    return (int(fdy.min()), int(fdy.max())), (int(fdx.min()), int(fdx.max()))


def _radial_jitter_maps(h, w, k1=0.04, jitter=0.9, seed=0):
    """Smooth radial map + per-pixel jitter, clipped to the image (edge clips
    exercise the clamp-to-edge taps)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) / cy) ** 2 + ((xx - cx) / cx) ** 2
    s = 1.0 + k1 * r2
    my = np.clip(cy + (yy - cy) * s + rng.uniform(-jitter, jitter, (h, w)), 0, h - 1)
    mx = np.clip(cx + (xx - cx) * s + rng.uniform(-jitter, jitter, (h, w)), 0, w - 1)
    mx, my = mx.astype(np.float32), my.astype(np.float32)
    dyb, dxb = _bounds(mx, my)
    return jnp.asarray(mx), jnp.asarray(my), dyb, dxb


def _shift_maps(h, w):
    """One-sided shift map: every displacement positive (asymmetric bounds)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    my = np.clip(yy + 2.3 + 0.8 * np.sin(xx / 9.0), 0, h - 1).astype(np.float32)
    mx = np.clip(xx + 4.1 + 0.8 * np.cos(yy / 7.0), 0, w - 1).astype(np.float32)
    dyb, dxb = _bounds(mx, my)
    return jnp.asarray(mx), jnp.asarray(my), dyb, dxb


CASES = {
    "radial": lambda: (48, 200, _radial_jitter_maps(48, 200)),
    "asymmetric": lambda: (40, 160, _shift_maps(40, 160)),
    "tall": lambda: (260, 36, _radial_jitter_maps(260, 36, k1=0.06, seed=3)),
    "strong": lambda: (52, 140, _radial_jitter_maps(52, 140, k1=0.12, seed=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
def test_remap_bounded_matches_gather(kind, case):
    h, w, (mx, my, dyb, dxb) = CASES[case]()
    img = jnp.asarray(np.random.default_rng(1).random((h, w), np.float32))
    want = np.asarray(GATHER[kind](img, mx, my))
    got = np.asarray(remap_bounded(img, mx, my, dyb, dxb, kind=kind))
    np.testing.assert_allclose(got, want, atol=ATOL[kind], rtol=0)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
def test_remap_bounded_dispatch(kind):
    """remap_bounded is exactly the select-chain remap of its kind."""
    h, w = 24, 130
    img = jnp.asarray(np.random.default_rng(5).random((h, w), np.float32))
    mx, my, dyb, dxb = _radial_jitter_maps(h, w, seed=6)
    fn = remap_bilinear_bounded if kind == "bilinear" else remap_lanczos4_bounded
    want = np.asarray(fn(img, mx, my, dyb, dxb))
    got = np.asarray(remap_bounded(img, mx, my, dyb, dxb, kind=kind))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["shared_maps", "per_channel_maps", "shared_image"])
@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
def test_remap_bounded_channel_stack(kind, layout):
    """Stacked channels: (C, H, W) images under shared (H, W) maps, per-channel
    (C, H, W) maps, or one (H, W) image under (C, H, W) maps (the CA G-warp
    pattern). Every channel matches its own 2-D gather remap."""
    rng = np.random.default_rng(11)
    h, w, c = 40, 150, 3
    maps = [_radial_jitter_maps(h, w, k1=0.02 + 0.02 * i, seed=13 + i) for i in range(c)]
    if layout == "shared_maps":
        maps = [maps[0]] * c
    dyb = (min(m[2][0] for m in maps), max(m[2][1] for m in maps))
    dxb = (min(m[3][0] for m in maps), max(m[3][1] for m in maps))
    if layout == "shared_image":
        img = jnp.asarray(rng.random((h, w), np.float32))
        imgs = [img] * c
    else:
        img = jnp.asarray(rng.random((c, h, w), np.float32))
        imgs = [img[i] for i in range(c)]
    if layout == "shared_maps":
        mx, my = maps[0][0], maps[0][1]
    else:
        mx = jnp.stack([m[0] for m in maps])
        my = jnp.stack([m[1] for m in maps])

    got = np.asarray(remap_bounded(img, mx, my, dyb, dxb, kind=kind))
    assert got.shape == (c, h, w)
    for i in range(c):
        want = np.asarray(GATHER[kind](imgs[i], maps[i][0], maps[i][1]))
        np.testing.assert_allclose(got[i], want, atol=ATOL[kind], rtol=0)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos4"])
def test_remap_bounded_inside_shard_map(kind):
    """Row-sharded remap under shard_map: a vertical-identity map needs no row
    halo, so every shard's output equals the same rows of the monolithic
    gather remap."""
    from jax.sharding import PartitionSpec as P

    from pysp_tpu.parallel.mesh import make_mesh

    h, w = 64, 140
    img = jnp.asarray(np.random.default_rng(7).random((h, w), np.float32))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mx = np.clip(xx + 3.0 * np.sin(yy / 5.0), 0, w - 1).astype(np.float32)
    my = yy.astype(np.float32)
    _, dxb = _bounds(mx, my)
    mx, my = jnp.asarray(mx), jnp.asarray(my)

    sharded = jax.shard_map(
        lambda im, a, b: remap_bounded(im, a, b, (0, 0), dxb, kind=kind),
        mesh=make_mesh((1, 2)),
        in_specs=(P("spatial"), P("spatial"), P("spatial")),
        out_specs=P("spatial"),
    )
    got = np.asarray(jax.jit(sharded)(img, mx, my))
    # the gather reference clamps rows to the whole frame, the shard to its
    # block; with a vertical-identity map no tap ever leaves its row
    want = np.asarray(GATHER[kind](img, mx, my))
    np.testing.assert_allclose(got, want, atol=ATOL[kind], rtol=0)


@pytest.mark.parametrize(
    "coeffs, center",
    [
        ((1.01, -0.013, 0.0025, 0.0, 0.0004, -0.0003), (0.45, 0.55)),
        ((1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001), (0.5, 0.5)),
        ((0.99, 0.02, -0.004, 0.001, 0.0, 0.0), (0.3, 0.6)),
    ],
)
def test_displacement_bounds_exact_containment(coeffs, center):
    """Every f32 device floor displacement sits inside the host f64 full-sweep
    bounds, and the bounds are within margin + 1 of the true extrema."""
    from pysp_tpu.warp.rectilinear import compute_remapping_table, displacement_bounds

    h, w = 256, 512
    mx, my = compute_remapping_table(coeffs, w, h, center)
    mxn = np.asarray(jnp.clip(mx, 0, w - 1), np.float64)
    myn = np.asarray(jnp.clip(my, 0, h - 1), np.float64)
    fdy = np.floor(myn) - np.arange(h)[:, None]
    fdx = np.floor(mxn) - np.arange(w)[None, :]

    dyb, dxb = displacement_bounds(coeffs, w, h, center)
    assert dyb[0] <= fdy.min() and fdy.max() <= dyb[1]
    assert dxb[0] <= fdx.min() and fdx.max() <= dxb[1]
    assert fdy.min() - dyb[0] <= 1 and dyb[1] - fdy.max() <= 1
    assert fdx.min() - dxb[0] <= 1 and dxb[1] - fdx.max() <= 1
