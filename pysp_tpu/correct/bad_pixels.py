"""Bad-pixel detection and repair on Bayer planes.

Reference behavior: /root/reference/raw_bad_pixel_corr.py — threshold detection vs 8
neighbors (:30-65), median-delta detection with quantile threshold (:67-93), multi-image
consensus (:95-133), and repair via per-plane inpainting (:135-150).

Deliberate divergence: the reference repairs with cv2's Navier-Stokes inpainting (a
serial PDE solver); here repair is masked Jacobi diffusion — functionally equivalent for
the isolated/hot-pixel masks this stage produces, and expressible as a fixed-iteration
XLA loop (SURVEY.md §2.9 item 4).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp

from ..core.bayer import bayer_to_planes, planes_to_bayer
from ..core.frame import RawFrame
from ..ops.stencil import median2, pad_reflect101, pad_replicate, shift2d

Array = jnp.ndarray

_NEIGHBORS_8 = [
    (-1, 0), (0, 1), (1, 0), (0, -1),
    (-1, -1), (-1, 1), (1, 1), (1, -1),
]


def find_erroneous_pixels_threshold(
    frame: RawFrame, min_delta: float = 0.025, min_neighbour_count: int = 5
) -> Array:
    """Hot-pixel masks per plane: pixel > (neighbor + min_delta) for more than
    ``min_neighbour_count`` of its 8 neighbors (raw_bad_pixel_corr.py:30-65).

    Returns (4, H/2, W/2) bool in (R, G1, B, G2) order.
    """
    planes = bayer_to_planes(frame.bayer)
    h, w = planes.shape[-2], planes.shape[-1]
    padded = pad_reflect101(planes, 1)  # one pad, 8 slice taps (fuses to one pass)

    count = jnp.zeros_like(planes, dtype=jnp.int32)
    for dy, dx in _NEIGHBORS_8:
        neigh = padded[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        count = count + ((planes - min_delta) > neigh).astype(jnp.int32)
    return count > min_neighbour_count


def find_erroneous_pixels_median(
    frame: RawFrame,
    multiplier: float = 1.5,
    quantile: float = 0.9999,
    axis_name=None,
    core_rows=None,
) -> Array:
    """Hot-pixel masks via delta against a 2x2 median, noise-floor subtracted,
    thresholded at the given quantile (raw_bad_pixel_corr.py:67-93).

    Spatial sharding (``axis_name`` + ``core_rows``): when the frame is a
    halo-extended row shard, the noise floor and the quantile must still be
    the GLOBAL statistics or the threshold scalar would differ per shard.
    ``core_rows`` restricts the reductions to the shard's own sensor rows
    [lo, hi) (excluding exchanged halo rows, which would double-count) and
    ``axis_name`` psums the count-multisection ranks / pmeans the noise floor
    across shards — exact global semantics, masks still returned for the full
    extended block so healing can run locally."""
    planes = bayer_to_planes(frame.bayer)

    blur = median2(planes)
    delta = jnp.abs(planes - blur)
    core = (
        delta
        if core_rows is None
        else delta[..., core_rows[0] // 2 : core_rows[1] // 2, :]
    )
    noise_floor = jnp.mean(core, axis=(-2, -1), keepdims=True)
    if axis_name is not None:
        from jax import lax

        # equal-size shards: global mean == mean of shard means
        noise_floor = lax.pmean(noise_floor, axis_name)
    delta = jnp.abs(delta - noise_floor)
    core = (
        delta
        if core_rows is None
        else delta[..., core_rows[0] // 2 : core_rows[1] // 2, :]
    )

    strong = (
        _bisect_quantile(core, quantile, axis_name=axis_name).reshape(4, 1, 1)
        * multiplier
    )
    return delta > strong


def _bisect_quantile(
    delta, q: float, iters: int = 4, branches: int = 16, axis_name=None
):
    """Per-plane upper-order-statistic quantile via count multisection.

    jnp.quantile sorts the whole plane; thresholding only needs the value, so
    count-and-narrow passes find it instead. Each pass splits the
    bracket at ``branches`` interior points and counts rank for all of them in ONE
    fused read of ``delta`` (broadcast-compare + reduce — the compares are
    cheap next to the memory read), narrowing the bracket by (branches+1)x: 4 passes
    of 16-way resolve to ~1e-5 of the value range, where the old 30 binary passes
    (30 full reads) were 2^30 overkill. Differs from numpy's linearly-interpolated
    quantile by at most the gap between two adjacent order statistics — harmless
    under the detector's x1.5 multiplier (DIVERGENCES.md).

    With ``axis_name`` the counts/extrema are collective (psum/pmin/pmax), so
    row shards of one frame compute the frame's EXACT global quantile: counting
    rank is associative where sorting is not — the reason this formulation
    shards for free."""
    import jax
    from jax import lax

    n = delta.shape[-2] * delta.shape[-1]
    lo = jnp.min(delta, axis=(-2, -1))
    hi = jnp.max(delta, axis=(-2, -1))
    if axis_name is not None:
        n = n * lax.psum(1, axis_name)
        lo = lax.pmin(lo, axis_name)
        hi = lax.pmax(hi, axis_name)
    target = q * (n - 1)
    fr = (jnp.arange(1, branches + 1, dtype=delta.dtype) / (branches + 1))

    def body(_, carry):
        lo, hi = carry
        mids = lo[:, None] + (hi - lo)[:, None] * fr[None, :]  # (planes, B)
        # rank of each mid: count of samples <= mid, per plane (one delta read)
        cnt = jnp.sum(
            (delta[:, None] <= mids[:, :, None, None]).astype(jnp.float32),
            axis=(-2, -1),
        )
        if axis_name is not None:
            cnt = lax.psum(cnt, axis_name)
        ok = (cnt - 1.0) >= target  # mid already reaches the target rank
        new_hi = jnp.min(jnp.where(ok, mids, hi[:, None]), axis=1)
        new_lo = jnp.max(jnp.where(ok, lo[:, None], mids), axis=1)
        return new_lo, new_hi

    _, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return hi


def find_shared_pixels(
    masks: Sequence[Array], min_ratio: float = 0.1
) -> Optional[Array]:
    """Consensus mask: keep pixels flagged in >= ceil(N*min_ratio) of the N masks
    (raw_bad_pixel_corr.py:95-133). ``masks`` is a sequence of (4, H/2, W/2) masks."""
    if len(masks) == 0:
        return None
    shapes = {tuple(m.shape) for m in masks}
    if len(shapes) != 1:
        return None
    min_acceptance = jnp.ceil(len(masks) * min_ratio)
    total = sum(m.astype(jnp.int16) for m in masks)
    return total >= min_acceptance


def diffusion_inpaint(chan: Array, mask: Array, iterations: int = 32) -> Array:
    """Fill masked pixels by Jacobi diffusion from their 4-neighborhood.

    Replaces cv2.inpaint(INPAINT_NS, radius 3) for hot-pixel healing. Fixed iteration
    count keeps the loop jittable; isolated pixels converge in a handful of steps,
    and small clusters within ~iterations/2 radius.
    """
    mask_f = mask.astype(chan.dtype)
    # Seed masked pixels with the plane mean so diffusion starts from something sane
    seed = jnp.mean(chan, axis=(-2, -1), keepdims=True)
    x0 = chan * (1 - mask_f) + seed * mask_f

    def body(_, x):
        # 4 shift2d taps; XLA fuses the pads into the consumer, where an
        # explicit single-pad rewrite would materialize a padded buffer.
        acc = (
            shift2d(x, -1, 0, pad_replicate)
            + shift2d(x, 1, 0, pad_replicate)
            + shift2d(x, 0, -1, pad_replicate)
            + shift2d(x, 0, 1, pad_replicate)
        ) * 0.25
        return jnp.where(mask, acc, chan)

    return jax.lax.fori_loop(0, iterations, body, x0)


def masked_fill_inpaint(
    chan: Array, mask: Array, fill_iterations: int = 4, smooth_iterations: int = 2
) -> Array:
    """Mask-aware inpaint: normalized-convolution fill + short harmonic smoothing.

    Blanket Jacobi diffusion needs O(radius^2) full-plane sweeps to converge; hot
    pixels are isolated or tiny clusters, for which one normalized 4-neighbor
    average IS the converged solution. Each fill pass extends the valid front by
    one pixel (filling clusters up to radius ``fill_iterations``); the smoothing
    sweeps then relax multi-pixel clusters toward the harmonic (diffusion) fill.
    Anything still unreached (pathologically huge masks) falls back to the plane
    mean. 4+2 passes replace the 32 blanket sweeps, with identical
    isolated-pixel results.
    """
    valid0 = jnp.logical_not(mask)
    v0 = valid0.astype(chan.dtype)
    x0 = chan * v0

    def fill_body(_, carry):
        x, v = carry
        xs = (
            shift2d(x, -1, 0, pad_replicate)
            + shift2d(x, 1, 0, pad_replicate)
            + shift2d(x, 0, -1, pad_replicate)
            + shift2d(x, 0, 1, pad_replicate)
        )
        vs = (
            shift2d(v, -1, 0, pad_replicate)
            + shift2d(v, 1, 0, pad_replicate)
            + shift2d(v, 0, -1, pad_replicate)
            + shift2d(v, 0, 1, pad_replicate)
        )
        filled = xs / jnp.maximum(vs, 1.0)
        new_x = jnp.where(v > 0, x, filled)
        new_v = jnp.minimum(v + vs, 1.0)
        return new_x, new_v

    x, v = jax.lax.fori_loop(0, fill_iterations, fill_body, (x0, v0))
    seed = jnp.mean(chan, axis=(-2, -1), keepdims=True)
    x = jnp.where(v > 0, x, seed)

    def smooth_body(_, x):
        acc = (
            shift2d(x, -1, 0, pad_replicate)
            + shift2d(x, 1, 0, pad_replicate)
            + shift2d(x, 0, -1, pad_replicate)
            + shift2d(x, 0, 1, pad_replicate)
        ) * 0.25
        return jnp.where(mask, acc, chan)

    x = jax.lax.fori_loop(0, smooth_iterations, smooth_body, x)
    return jnp.where(mask, x, chan)


def compact_mask_indices(mask_flat: Array, max_sites: int, block: int = 512) -> Array:
    """Ascending flat indices of set bits, padded with ``mask_flat.size``.

    Drop-in for ``jnp.nonzero(mask_flat, size=max_sites, fill_value=n)[0]``,
    which lowers to a full-frame bincount scatter-add (one update per pixel).
    Here no scatter larger than ``max_sites`` exists: per-block counts (one
    reduce) -> tiny block cumsum -> per-slot owning block via searchsorted ->
    gather the K owning blocks -> within-block rank via a matmul prefix sum
    (f32 triangular matmul at HIGHEST precision, exact for counts < 2^24).
    Bit-identical to nonzero for any mask.
    """
    from jax import lax

    n = mask_flat.shape[0]
    pad = (-n) % block
    xb = jnp.pad(mask_flat, (0, pad)).reshape(-1, block).astype(jnp.float32)
    nblocks = xb.shape[0]
    bs = jnp.sum(xb, axis=1)
    bc = jnp.cumsum(bs)
    total = bc[-1]
    k = jnp.arange(max_sites, dtype=jnp.float32)
    b_k = jnp.minimum(jnp.searchsorted(bc, k + 1.0), nblocks - 1)
    prev = jnp.take(bc, b_k) - jnp.take(bs, b_k)  # sites before the owning block
    r_k = k - prev  # rank within the block
    rows = jnp.take(xb, b_k, axis=0)  # (K, block)
    tri = jnp.tril(jnp.ones((block, block), jnp.float32)).T  # [i <= j]
    rowcsum = lax.dot_general(
        rows, tri, (((1,), (0,)), ((), ())), precision=lax.Precision.HIGHEST
    )
    # index of the (r_k+1)-th set bit = count of prefix sums below the target
    pos = jnp.sum((rowcsum < r_k[:, None] + 1.0).astype(jnp.int32), axis=1)
    kk = b_k.astype(jnp.int32) * block + pos
    return jnp.where(k < total, kk, n).astype(jnp.int32)


def masked_fill_inpaint_sparse(
    chan: Array,
    mask: Array,
    fill_iterations: int = 4,
    smooth_iterations: int = 2,
    max_sites: int = 32768,
) -> Array:
    """``masked_fill_inpaint`` on the compacted site list instead of full planes.

    Hot-pixel masks flag ~1e-4 of photosites; the dense fill still sweeps every
    plane 6x. Here the masked coordinates are
    compacted once (``jnp.nonzero`` with a static ``max_sites`` bound), the
    fill/smooth recurrences run on K-vectors (neighbor values gathered from the
    plane for unmasked neighbors, looked up via one ``searchsorted`` for masked
    ones), and the result scatters back in one pass. Accumulation order matches
    the dense kernel neighbor-for-neighbor, so results are bit-identical for any
    mask that fits ``max_sites``; callers must bound the true site count (see
    repair_bad_pixels, which falls back to the dense path via lax.cond).
    """
    p, h, w = chan.shape
    n = p * h * w
    flat_chan = chan.reshape(-1)
    kk = compact_mask_indices(mask.reshape(-1), max_sites)
    valid_slot = kk < n

    py = (kk // w) % h
    px = kk % w
    pp = kk // (h * w)
    # 4-neighborhood in dense accumulation order (up, down, left, right) with
    # replicate-border clamping — identical to shift2d(..., pad_replicate)
    nb_keys = jnp.stack(
        [
            pp * (h * w) + jnp.clip(py + dy, 0, h - 1) * w + jnp.clip(px + dx, 0, w - 1)
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))
        ],
        axis=1,
    )  # (K, 4)
    pos = jnp.minimum(jnp.searchsorted(kk, nb_keys), max_sites - 1)
    nb_masked = jnp.take(kk, pos) == nb_keys
    nb_chan = jnp.take(flat_chan, jnp.minimum(nb_keys, n - 1))

    x0 = jnp.zeros((max_sites,), chan.dtype)
    v0 = jnp.zeros((max_sites,), chan.dtype)

    def fill_body(_, carry):
        x, v = carry
        # unmasked neighbors: value chan, validity 1 (dense x0 = chan * v0)
        nb_x = jnp.where(nb_masked, jnp.take(x, pos), nb_chan)
        nb_v = jnp.where(nb_masked, jnp.take(v, pos), 1.0)
        xs = ((nb_x[:, 0] + nb_x[:, 1]) + nb_x[:, 2]) + nb_x[:, 3]
        vs = ((nb_v[:, 0] + nb_v[:, 1]) + nb_v[:, 2]) + nb_v[:, 3]
        filled = xs / jnp.maximum(vs, 1.0)
        new_x = jnp.where(v > 0, x, filled)
        new_v = jnp.minimum(v + vs, 1.0)
        return (
            jnp.where(valid_slot, new_x, 0.0),
            jnp.where(valid_slot, new_v, 0.0),
        )

    x, v = jax.lax.fori_loop(0, fill_iterations, fill_body, (x0, v0))
    plane_means = jnp.mean(chan, axis=(-2, -1))
    x = jnp.where(v > 0, x, jnp.take(plane_means, jnp.minimum(pp, p - 1)))

    def smooth_body(_, x):
        nb_x = jnp.where(nb_masked, jnp.take(x, pos), nb_chan)
        acc = (((nb_x[:, 0] + nb_x[:, 1]) + nb_x[:, 2]) + nb_x[:, 3]) * 0.25
        return jnp.where(valid_slot, acc, 0.0)

    x = jax.lax.fori_loop(0, smooth_iterations, smooth_body, x)

    out = flat_chan.at[jnp.where(valid_slot, kk, n)].set(x, mode="drop")
    return out.reshape(chan.shape)


def repair_bad_pixels(frame: RawFrame, masks: Array, iterations: int = 4) -> RawFrame:
    """Heal masked photosites per plane; returns a new frame
    (raw_bad_pixel_corr.py:135-150, with mask-aware normalized-convolution fill
    instead of NS inpainting). ``iterations`` bounds the fillable cluster radius.

    Dispatch (both paths bit-identical): the compacted sparse fill when the
    flagged-site count fits its static bound, the dense full-plane fill
    otherwise."""
    masks = jnp.asarray(masks)
    if masks.shape[0] != 4:
        return frame
    planes = bayer_to_planes(frame.bayer)
    max_sites = 8192  # static bound on the sparse path's site list
    healed = jax.lax.cond(
        jnp.sum(masks) <= max_sites,
        lambda pl: masked_fill_inpaint_sparse(
            pl, masks, fill_iterations=iterations, max_sites=max_sites
        ),
        lambda pl: masked_fill_inpaint(pl, masks, fill_iterations=iterations),
        planes,
    )
    return frame.replace(bayer=planes_to_bayer(healed))
