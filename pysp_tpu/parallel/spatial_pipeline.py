"""Row-sharded CA removal + develop + DNG warp for a single large frame.

Closes SURVEY item 63's last edge (VERDICT r4 missing #1): the batch axis
covers bursts, but ONE 61-150 MP frame previously got one chip for everything
past the demosaic — CA removal and the rectilinear warp had no spatial path.

Why sharding these is well-defined: the CA/warp coordinate maps are
absolute-coordinate fields of the FULL frame's geometry
(/root/reference/corr_ca/ca_removal.py:100-128,
/root/reference/dng_warp_corr/chan_distortion_corr.py:86-98) with host-static
displacement bounds (warp/rectilinear.displacement_bounds,
correct/ca/removal._model_bound_px). A row shard [r0, r1) therefore needs
exactly ``halo = displacement bound + resample reach`` source rows beyond its
block, and per-shard maps re-base by integer row offsets
(models.get_*_coordinates_window / rectilinear.compute_remapping_table_window
build each shard's window of the full-frame field directly — bit-identical
values to slicing the monolithic tables).

Semantics under the mesh:
- corrections: every global statistic (flat means, the hot-pixel quantile,
  the denoise sigma) reduces collectively over the shards' core rows
  (``_correct_one(axis_name=..., core_rows=...)``) — counting rank is
  associative where sorting is not, so the count-multisection quantile shards
  exactly.
- CA + warp: remaps run shard-locally with the GLOBAL static displacement
  bounds (one traced program serves every shard; per-shard zone tables would
  need shard-dependent statics). Windowed maps, clipped into the frame then
  re-based into the block.
- develop: the stencil pipeline runs on the halo-extended block exactly as in
  spatial.develop_spatial.
- interior rows match the monolithic pipeline; global top/bottom edges follow
  the CFA-reflection policy (divergence bounded by stencil reach — same
  caveat as develop_spatial, gated in tests/test_parallel_spatial.py).

Halo assembly: neighbor ``ppermute`` when the halo fits in one neighbor block,
``all_gather`` otherwise (tiny test frames; the memory cost is trivial exactly
when that path triggers).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core.bayer import bayer_to_rgbg, rgbg_to_bayer
from ..core.frame import RawFrame
from ..demosaic.eag import resample_b, resample_g_to_full_resolution, resample_r
from ..ops.resample import remap_bounded
from ..pipeline.develop import develop
from ..pipeline.pipeline import PipelineConfig, _correct_one
from .mesh import SPATIAL_AXIS
from .spatial import _cfa_reflect_rows

Array = jnp.ndarray


# ---------------------------------------------------------------------------
# host-side static setup
# ---------------------------------------------------------------------------

def _ceil_even(v: float) -> int:
    n = int(-(-v // 1))
    return n + (n & 1)


def _ca_bound(model, full_h: int, full_w: int) -> Optional[int]:
    """Static displacement bound (px) of one CA model's remaps on the full
    frame, or None when the model's displacement has no usable static bound."""
    from ..correct.ca.removal import _model_bound_px

    return _model_bound_px(model, full_h, full_w, cap=24)


def _warp_setup(
    warp_block: bytes,
    full_h: int,
    full_w: int,
    scale: float,
    interpolation: str,
):
    """Host-parse an OpcodeList3 block into per-op static warp plans.

    Returns a list of (coeffs_per_plane, center, (dyb, dxb), kind); raises if
    any warp's displacement bounds are unavailable (no static halo exists)."""
    from ..warp.opcodes import (
        OPCODE_WARP_RECTILINEAR,
        decode_warp_rectilinear,
        iter_opcodes,
    )
    from ..warp.rectilinear import displacement_bounds

    ops = []
    for opcode_id, _ver, _flags, data in iter_opcodes(warp_block):
        if opcode_id != OPCODE_WARP_RECTILINEAR:
            continue
        decoded = decode_warp_rectilinear(data, 3)
        if decoded is None:
            continue
        coefficients, center = decoded
        unique = list(
            dict.fromkeys(tuple(float(v) for v in co) for co in coefficients)
        )
        bs = [
            displacement_bounds(co, full_w, full_h, center, scale)
            for co in unique
        ]
        if any(b is None for b in bs):
            raise ValueError(
                "warp displacement bounds unavailable (beyond cap): no static "
                "halo exists for spatial sharding; use the monolithic path"
            )
        dyb = (min(b[0][0] for b in bs), max(b[0][1] for b in bs))
        dxb = (min(b[1][0] for b in bs), max(b[1][1] for b in bs))
        ops.append((coefficients, center, (dyb, dxb), interpolation))
    return ops


def required_spatial_halo(
    cfg: PipelineConfig,
    ca_bounds,
    warp_ops,
    interpolation: str,
) -> int:
    """Static sensor-row halo covering every stage's reach (host accounting).

    Backwards from the output: each stage's garbage creeps inward from the
    block edge by (its displacement bound + stencil reach); the block keeps
    its full extended shape through all stages and crops once at the end, so
    the halo is the SUM of stage reaches.
    """
    h = 4  # slack
    if cfg.dark_frame or cfg.flat_field:
        h += 0  # pointwise
    if cfg.repair_hot_pixels:
        # median2 detect (2) + masked fill/smooth passes (3x3 on half-res)
        h += 2 * (cfg.hot_pixel_iterations + 2) + 4
    if cfg.denoise_strength > 0.0:
        # dilated B3: reach 2*2^l per level per axis, half-res planes
        h += 4 * ((1 << cfg.denoise_levels) - 1) + 4
    for bound in ca_bounds:
        if bound is not None:
            # inverse warp + EAG guide/channel resamples + forward warp
            h += 2 * bound + 16
    h += 16  # develop stencil reach (spatial.develop_spatial's default)
    reach = 4 if interpolation == "lanczos4" else 1
    for _co, _ce, (dyb, _dxb), _kind in warp_ops:
        h += max(abs(dyb[0]), abs(dyb[1])) + reach + 2
    return _ceil_even(h)


# ---------------------------------------------------------------------------
# windowed device stages
# ---------------------------------------------------------------------------

def _window_maps(model, direction: str, hb: int, b0, full_shape):
    """Block-local (map_x, map_y) of a CA model's map for absolute rows
    [b0, b0+hb): same values as slicing the monolithic clipped maps, then
    re-based into the block (clip to the block only binds in the halo margin,
    which is discarded)."""
    full_h, full_w = full_shape
    if direction == "inv":
        coords = model.get_undistorted_coordinates_window(hb, b0, full_shape)
    else:
        coords = model.get_distorted_coordinates_window(hb, b0, full_shape)
    mx = jnp.clip(coords[..., 1] + (full_w - 1) / 2.0, 0, full_w - 1)
    my = jnp.clip(coords[..., 0] + (full_h - 1) / 2.0, 0, full_h - 1)
    my = jnp.clip(my - b0, 0, hb - 1)
    return mx, my


def _remove_ca_window(
    bayer_ext: Array,
    model_r,
    model_b,
    wb: Array,
    full_shape: Tuple[int, int],
    b0,
    bound_r: Optional[int],
    bound_b: Optional[int],
) -> Array:
    """remove_ca_from_raw's per-channel program on a halo-extended row shard
    (ca_removal.py:48-132 semantics; maps windowed to absolute rows)."""
    r, g1, b, g2 = bayer_to_rgbg(bayer_ext)
    g_res = resample_g_to_full_resolution(g1, g2)
    hb = g_res.shape[-2]

    def correct_channel(half_plane, model, bound, resample, plane_idx, gain):
        bb = (-bound, bound)
        g_at = remap_bounded(
            g_res, *_window_maps(model, "inv", hb, b0, full_shape), bb, bb
        )
        chan_res = resample(half_plane * gain, g_at)
        chan_at_g = remap_bounded(
            chan_res, *_window_maps(model, "fwd", hb, b0, full_shape), bb, bb
        )
        return bayer_to_rgbg(chan_at_g)[plane_idx] / gain

    if model_r is not None and bound_r is not None:
        r = correct_channel(r, model_r, bound_r, resample_r, 0, wb[0])
    if model_b is not None and bound_b is not None:
        b = correct_channel(b, model_b, bound_b, resample_b, 2, wb[2])
    return rgbg_to_bayer(r, g1, b, g2)


def _warp_window(
    img_ext: Array,
    warp_ops,
    scale: float,
    full_shape: Tuple[int, int],
    b0,
) -> Array:
    """apply_opcode_3_warp on a halo-extended row shard: windowed tables in
    full-frame geometry, re-based into the block, shard-local bounded remaps
    with the GLOBAL static bounds (chan_distortion_corr.py:86-98 semantics)."""
    from ..warp.rectilinear import compute_remapping_table_window

    full_h, full_w = full_shape
    hb = img_ext.shape[0]
    for coefficients, center, (dyb, dxb), kind in warp_ops:
        maps = {}
        for co in dict.fromkeys(tuple(float(v) for v in c) for c in coefficients):
            mx, my = compute_remapping_table_window(
                co, full_w, full_h, center, scale, b0, hb
            )
            mx = jnp.clip(mx, 0, full_w - 1)
            my = jnp.clip(jnp.clip(my, 0, full_h - 1) - b0, 0, hb - 1)
            maps[co] = (mx, my)
        planes = []
        for idx in range(img_ext.shape[-1]):
            co = tuple(float(v) for v in coefficients[idx])
            mx, my = maps[co]
            planes.append(
                remap_bounded(img_ext[:, :, idx], mx, my, dyb, dxb, kind=kind)
            )
        img_ext = jnp.stack(planes, axis=-1)
    return img_ext


# ---------------------------------------------------------------------------
# the sharded single-frame pipeline
# ---------------------------------------------------------------------------

def develop_frame_spatial(
    frame: RawFrame,
    mesh,
    cfg: PipelineConfig = PipelineConfig(),
    ca_model_r=None,
    ca_model_b=None,
    warp_block: Optional[bytes] = None,
    warp_scale: float = 1.0,
    warp_interpolation: str = "lanczos4",
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
    halo: Optional[int] = None,
) -> Array:
    """Full config-5 semantics for ONE frame, rows sharded over 'spatial'.

    corrections -> CA removal -> develop -> rectilinear warp, each stage
    running shard-locally on a halo-extended row block; one halo exchange up
    front covers every stage (the halo is the sum of stage reaches —
    ``required_spatial_halo``). Returns (H, W, 3) sRGB whose interior rows
    match the monolithic ``develop_pipeline`` + ``apply_opcode_3_warp``
    composition.
    """
    if cfg.fuse_hdr:
        raise ValueError("fuse_hdr needs a burst; see develop_hdr_sharded")
    if frame.bayer.ndim != 2:
        raise ValueError("develop_frame_spatial shards ONE frame's rows; "
                         "use develop_pipeline_sharded for bursts")

    n_sp = mesh.shape[SPATIAL_AXIS]
    full_h, full_w = frame.bayer.shape
    if full_h % (2 * n_sp) != 0:
        raise ValueError(
            f"height {full_h} must split into CFA-aligned blocks over {n_sp}"
        )
    rows_local = full_h // n_sp

    bound_r = _ca_bound(ca_model_r, full_h, full_w) if ca_model_r is not None else None
    bound_b = _ca_bound(ca_model_b, full_h, full_w) if ca_model_b is not None else None
    if ca_model_r is not None and bound_r is None:
        raise ValueError("red CA model has no static displacement bound; "
                         "spatial sharding unavailable for it")
    if ca_model_b is not None and bound_b is None:
        raise ValueError("blue CA model has no static displacement bound; "
                         "spatial sharding unavailable for it")

    warp_ops = (
        _warp_setup(warp_block, full_h, full_w, warp_scale, warp_interpolation)
        if warp_block is not None
        else []
    )

    if halo is None:
        halo = required_spatial_halo(
            cfg, (bound_r, bound_b), warp_ops, warp_interpolation
        )
    assert halo % 2 == 0, "halo must keep CFA phase"
    use_gather = halo >= rows_local  # tiny blocks: assemble from a full gather

    cal_leaves = tuple(f.bayer if f is not None else None for f in (flat, dark))
    core_rows = (halo, halo + rows_local)

    def extend(block: Array) -> Array:
        """Halo-extended block: ppermute neighbors (or gather when the halo
        spans blocks), CFA-reflection at the global edges."""
        idx = lax.axis_index(SPATIAL_AXIS)
        if use_gather:
            full = lax.all_gather(block, SPATIAL_AXIS, axis=0, tiled=True)
            padded = jnp.concatenate(
                [
                    _cfa_reflect_rows(full, halo, top=True),
                    full,
                    _cfa_reflect_rows(full, halo, top=False),
                ],
                axis=0,
            )
            return lax.dynamic_slice_in_dim(
                padded, idx * rows_local, rows_local + 2 * halo, axis=0
            )
        send_up = [(i, i - 1) for i in range(1, n_sp)]
        send_down = [(i, i + 1) for i in range(n_sp - 1)]
        from_below = lax.ppermute(block[:halo], SPATIAL_AXIS, send_up)
        from_above = lax.ppermute(block[-halo:], SPATIAL_AXIS, send_down)
        top_pad = jnp.where(
            idx == 0, _cfa_reflect_rows(block, halo, top=True), from_above
        )
        bottom_pad = jnp.where(
            idx == n_sp - 1,
            _cfa_reflect_rows(block, halo, top=False),
            from_below,
        )
        return jnp.concatenate([top_pad, block, bottom_pad], axis=0)

    def block_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat,
                 flat_bayer, dark_bayer):
        idx = lax.axis_index(SPATIAL_AXIS)
        b0 = idx * rows_local - halo  # absolute row of the block's first row

        ext = extend(bayer)
        frame_ext = RawFrame(
            bayer=ext, cam_mat=cam_mat, cam_white=cam_white,
            wb_neutral=wb_neutral, ev=ev, lim_sat=lim_sat,
            is_hdr=frame.is_hdr, source_pattern=frame.source_pattern,
        )

        if cfg.enables_per_frame_corrections:
            flat_f = (
                RawFrame.synthetic(extend(flat_bayer))
                if flat_bayer is not None
                else None
            )
            dark_f = (
                RawFrame.synthetic(extend(dark_bayer))
                if dark_bayer is not None
                else None
            )
            frame_ext = _correct_one(
                frame_ext, cfg, flat_f, dark_f, None,
                axis_name=SPATIAL_AXIS, core_rows=core_rows,
            )

        if bound_r is not None or bound_b is not None:
            corrected = _remove_ca_window(
                frame_ext.bayer, ca_model_r, ca_model_b,
                frame_ext.wb_reciprocal(), (full_h, full_w), b0,
                bound_r, bound_b,
            )
            frame_ext = frame_ext.replace(bayer=corrected)

        img = develop.__wrapped__(frame_ext, cfg.develop)

        if warp_ops:
            img = _warp_window(img, warp_ops, warp_scale, (full_h, full_w), b0)
        return img[halo:-halo]

    rep = P()
    cal_specs = tuple(
        P(SPATIAL_AXIS, None) if leaf is not None else rep for leaf in cal_leaves
    )
    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P(SPATIAL_AXIS, None), rep, rep, rep, rep, rep, *cal_specs),
        out_specs=P(SPATIAL_AXIS, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(
        frame.bayer, frame.cam_mat, frame.cam_white, frame.wb_neutral,
        frame.ev, frame.lim_sat, *cal_leaves,
    )


def develop_pipeline_spatial(
    frames: RawFrame,
    mesh,
    cfg: PipelineConfig = PipelineConfig(),
    ca_model_r=None,
    ca_model_b=None,
    warp_block: Optional[bytes] = None,
    warp_scale: float = 1.0,
    warp_interpolation: str = "lanczos4",
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
    halo: Optional[int] = None,
) -> Array:
    """Config-5 semantics on a ('batch', 'spatial') mesh: the burst's frame
    axis is data-parallel over 'batch' AND every frame's rows are sharded over
    'spatial' — the develop_frame_spatial block program run per local frame,
    with the burst-consensus hot-pixel psum riding 'batch' exactly as in
    develop_pipeline_sharded. Returns (N, H, W, 3).
    """
    if cfg.fuse_hdr:
        raise ValueError("fuse_hdr reduces across the frame axis; use "
                         "develop_hdr_sharded for the config-4 shape")
    if frames.bayer.ndim != 3:
        raise ValueError("develop_pipeline_spatial takes a batched RawFrame")
    from .mesh import BATCH_AXIS

    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, full_h, full_w = frames.bayer.shape
    if n % n_b != 0:
        raise ValueError(f"burst size {n} must divide the batch axis {n_b}")
    if full_h % (2 * n_sp) != 0:
        raise ValueError(
            f"height {full_h} must split into CFA-aligned blocks over {n_sp}"
        )
    rows_local = full_h // n_sp

    bound_r = _ca_bound(ca_model_r, full_h, full_w) if ca_model_r is not None else None
    bound_b = _ca_bound(ca_model_b, full_h, full_w) if ca_model_b is not None else None
    if (ca_model_r is not None and bound_r is None) or (
        ca_model_b is not None and bound_b is None
    ):
        raise ValueError("CA model has no static displacement bound; "
                         "spatial sharding unavailable for it")
    warp_ops = (
        _warp_setup(warp_block, full_h, full_w, warp_scale, warp_interpolation)
        if warp_block is not None
        else []
    )
    if halo is None:
        halo = required_spatial_halo(
            cfg, (bound_r, bound_b), warp_ops, warp_interpolation
        )
    assert halo % 2 == 0
    use_gather = halo >= rows_local
    core_rows = (halo, halo + rows_local)
    cal_leaves = tuple(f.bayer if f is not None else None for f in (flat, dark))

    def extend(blocks: Array) -> Array:
        """(n_local, rows_local, W) -> (n_local, rows_local + 2*halo, W):
        one ppermute/gather per leaf covers every local frame."""
        idx = lax.axis_index(SPATIAL_AXIS)
        if use_gather:
            full = lax.all_gather(blocks, SPATIAL_AXIS, axis=1, tiled=True)
            padded = jnp.concatenate(
                [
                    jax.vmap(lambda f: _cfa_reflect_rows(f, halo, top=True))(full),
                    full,
                    jax.vmap(lambda f: _cfa_reflect_rows(f, halo, top=False))(full),
                ],
                axis=1,
            )
            return lax.dynamic_slice_in_dim(
                padded, idx * rows_local, rows_local + 2 * halo, axis=1
            )
        send_up = [(i, i - 1) for i in range(1, n_sp)]
        send_down = [(i, i + 1) for i in range(n_sp - 1)]
        from_below = lax.ppermute(blocks[:, :halo], SPATIAL_AXIS, send_up)
        from_above = lax.ppermute(blocks[:, -halo:], SPATIAL_AXIS, send_down)

        def pad_one(block, below, above):
            top = jnp.where(
                idx == 0, _cfa_reflect_rows(block, halo, top=True), above
            )
            bottom = jnp.where(
                idx == n_sp - 1,
                _cfa_reflect_rows(block, halo, top=False),
                below,
            )
            return jnp.concatenate([top, block, bottom], axis=0)

        return jax.vmap(pad_one)(blocks, from_below, from_above)

    def block_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat,
                 flat_bayer, dark_bayer):
        idx = lax.axis_index(SPATIAL_AXIS)
        b0 = idx * rows_local - halo

        ext = extend(bayer)  # (n_local, rows_local + 2*halo, W)
        flat_ext = extend(flat_bayer[None])[0] if flat_bayer is not None else None
        dark_ext = extend(dark_bayer[None])[0] if dark_bayer is not None else None

        def rebuild(b, cm, cw, wn, e, ls):
            return RawFrame(
                bayer=b, cam_mat=cm, cam_white=cw, wb_neutral=wn, ev=e,
                lim_sat=ls, is_hdr=frames.is_hdr,
                source_pattern=frames.source_pattern,
            )

        # burst-consensus masks: per-frame detection with frame-global stats
        # (quantile psummed over 'spatial'), counts psummed over 'batch'
        shared_masks = None
        if cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None:
            from ..correct.bad_pixels import find_erroneous_pixels_median

            def detect(args):
                f = rebuild(*args)
                return find_erroneous_pixels_median(
                    f, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile,
                    axis_name=SPATIAL_AXIS, core_rows=core_rows,
                )

            per_frame = lax.map(
                detect, (ext, cam_mat, cam_white, wb_neutral, ev, lim_sat)
            )
            total = lax.psum(
                jnp.sum(per_frame.astype(jnp.int32), axis=0), BATCH_AXIS
            )
            shared_masks = total >= jnp.ceil(n * cfg.hot_pixel_shared_ratio)

        def one(args):
            f = rebuild(*args)
            if cfg.enables_per_frame_corrections or shared_masks is not None:
                flat_f = (
                    RawFrame.synthetic(flat_ext) if flat_ext is not None else None
                )
                dark_f = (
                    RawFrame.synthetic(dark_ext) if dark_ext is not None else None
                )
                f = _correct_one(
                    f, cfg, flat_f, dark_f, shared_masks,
                    axis_name=SPATIAL_AXIS, core_rows=core_rows,
                )
            if bound_r is not None or bound_b is not None:
                f = f.replace(
                    bayer=_remove_ca_window(
                        f.bayer, ca_model_r, ca_model_b, f.wb_reciprocal(),
                        (full_h, full_w), b0, bound_r, bound_b,
                    )
                )
            img = develop.__wrapped__(f, cfg.develop)
            if warp_ops:
                img = _warp_window(
                    img, warp_ops, warp_scale, (full_h, full_w), b0
                )
            return img[halo:-halo]

        return lax.map(one, (ext, cam_mat, cam_white, wb_neutral, ev, lim_sat))

    bspec = (P(BATCH_AXIS, SPATIAL_AXIS, None),) + (P(BATCH_AXIS),) * 5
    cal_specs = tuple(
        P(SPATIAL_AXIS, None) if leaf is not None else P() for leaf in cal_leaves
    )
    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(*bspec, *cal_specs),
        out_specs=P(BATCH_AXIS, SPATIAL_AXIS, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(
        frames.bayer, frames.cam_mat, frames.cam_white, frames.wb_neutral,
        frames.ev, frames.lim_sat, *cal_leaves,
    )


__all__ = [
    "develop_frame_spatial",
    "develop_pipeline_spatial",
    "required_spatial_halo",
]
