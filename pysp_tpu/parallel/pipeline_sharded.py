"""The FULL pipeline under the device mesh (VERDICT r3 item 4).

Round 3 sharded only the bare develop; config-5-shaped work (corrections + CA +
demosaic + DNG warp) and config-4 (HDR fuse) had no multi-chip path. Two
production layouts, matching how the work actually decomposes:

- ``develop_pipeline_sharded`` — the config-5 shape (bursts of frames, each
  frame small): frames are data-parallel over the mesh's 'batch' axis and each
  device runs the whole per-frame program (corrections -> CA removal -> develop
  -> rectilinear warp) locally under ``lax.map``. The CA/warp coordinate maps
  are full-frame constructs (host-computed zone bounds, absolute-radius
  polynomials), so the frame interior is never split — the batch axis is the
  natural (and scored: 16 x 1.5 MP) parallel axis for this shape. The one
  cross-device interaction, burst-consensus hot-pixel masks, becomes a
  ``lax.psum`` of the per-frame mask counts over 'batch'
  (find_shared_pixels semantics, SURVEY.md §2.5).
- ``develop_hdr_sharded`` — the config-4 shape (a bracket of LARGE frames
  fusing to ONE output): per-frame weighted sums reduce over 'batch' via
  ``lax.psum`` (the HDR fuse IS a collective), the fused frame lands replicated
  on every device, and the single develop that follows is row-sharded over
  'spatial' — slicing halos from the replicated fused frame, so the develop
  stage moves no data between devices.

Round 5 closed the last surveyed edge: CA removal and the DNG warp row-shard
too. A ('batch', 'spatial') mesh routes ``develop_pipeline_sharded`` through
``spatial_pipeline.develop_pipeline_spatial`` (frames data-parallel AND rows
halo-sharded, windowed absolute-geometry maps), and a single large frame uses
``spatial_pipeline.develop_frame_spatial`` — SURVEY §2.10 item 63 complete.

Parity on the virtual 8-device mesh is gated by tests/test_parallel.py; the
driver's ``dryrun_multichip`` runs the config-5 sharded step on every entry.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core.frame import RawFrame
from ..pipeline.develop import DevelopConfig, develop
from ..pipeline.pipeline import PipelineConfig, _correct_one
from .mesh import BATCH_AXIS, SPATIAL_AXIS
from .spatial import _cfa_reflect_rows

Array = jnp.ndarray

_FRAME_LEAVES = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _leaves(frames: RawFrame):
    return tuple(getattr(frames, name) for name in _FRAME_LEAVES)


def _rebuild(template: RawFrame, leaves) -> RawFrame:
    return RawFrame(
        **dict(zip(_FRAME_LEAVES, leaves)),
        is_hdr=template.is_hdr,
        source_pattern=template.source_pattern,
    )


def develop_pipeline_sharded(
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
) -> Array:
    """Config-5 semantics batch-sharded: corrections + CA + develop + warp.

    ``frames`` is a batched RawFrame (leading axis N on every leaf); N must
    divide by the mesh's batch size. ``flat``/``dark`` are single calibration
    frames, replicated to every device. Returns (N, H, W, 3) sRGB.
    """
    if cfg.fuse_hdr:
        raise ValueError(
            "fuse_hdr reduces across the sharded frame axis; use "
            "develop_hdr_sharded for the config-4 shape"
        )
    if SPATIAL_AXIS in mesh.shape and mesh.shape[SPATIAL_AXIS] > 1:
        # ('batch', 'spatial') mesh: every frame's rows are ALSO sharded —
        # CA + develop + warp run on halo-extended row blocks with windowed
        # absolute-geometry maps (round 5, SURVEY item 63 closed)
        from .spatial_pipeline import develop_pipeline_spatial

        return develop_pipeline_spatial(
            frames, mesh, cfg,
            ca_model_r=ca_model_r, ca_model_b=ca_model_b,
            warp_block=warp_block, warp_scale=warp_scale,
            warp_interpolation=warp_interpolation, flat=flat, dark=dark,
        )
    n_b = mesh.shape[BATCH_AXIS]
    n = frames.bayer.shape[0]
    assert n % n_b == 0, f"burst size {n} must divide the batch axis {n_b}"

    from ..correct.ca.removal import remove_ca_from_raw
    from ..warp.opcodes import apply_opcode_3_warp

    cal_leaves = tuple(
        f.bayer if f is not None else None for f in (flat, dark)
    )

    def local_fn(leaves, flat_bayer, dark_bayer):
        flat_f = (
            RawFrame.synthetic(flat_bayer) if flat_bayer is not None else None
        )
        dark_f = (
            RawFrame.synthetic(dark_bayer) if dark_bayer is not None else None
        )

        shared_masks = None
        if cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None:
            from ..correct.bad_pixels import find_erroneous_pixels_median

            template = _rebuild(frames, leaves)
            per_frame = lax.map(
                lambda f: find_erroneous_pixels_median(
                    f, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile
                ),
                template,
            )
            local_counts = jnp.sum(per_frame.astype(jnp.int32), axis=0)
            # consensus across the WHOLE burst: the one cross-device reduction
            total = lax.psum(local_counts, BATCH_AXIS)
            need = jnp.ceil(n * cfg.hot_pixel_shared_ratio)
            shared_masks = total >= need

        def correct(frame_leaves):
            f = _rebuild(frames, frame_leaves)
            return _leaves(_correct_one(f, cfg, flat_f, dark_f, shared_masks))

        if cfg.enables_per_frame_corrections or shared_masks is not None:
            leaves = lax.map(correct, leaves)

        # burst CA on the local shard: maps computed once, remaps batched
        # across the shard's frames (remove_ca_from_raw's batched path)
        local = _rebuild(frames, leaves)
        local = remove_ca_from_raw(local, ca_model_r, ca_model_b)

        def one(frame_leaves):
            f = _rebuild(frames, frame_leaves)
            img = develop.__wrapped__(f, cfg.develop)
            if warp_block is not None:
                img = apply_opcode_3_warp(
                    img, warp_block, warp_scale,
                    interpolation=warp_interpolation,
                )
            return img

        return lax.map(one, _leaves(local))

    bspec = (P(BATCH_AXIS, None, None),) + (P(BATCH_AXIS),) * 5
    cal_specs = tuple(
        P(None, None) if leaf is not None else P() for leaf in cal_leaves
    )
    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(bspec, *cal_specs),
        out_specs=P(BATCH_AXIS, None, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(_leaves(frames), *cal_leaves)


def develop_hdr_sharded(
    frames: RawFrame,
    mesh,
    cfg: PipelineConfig,
    halo: int = 16,
    flat: Optional[RawFrame] = None,
    dark: Optional[RawFrame] = None,
) -> Array:
    """Config-4 under the mesh: per-frame corrections (batch-local) -> HDR fuse
    as a 'batch' psum -> ONE develop row-sharded over 'spatial'.

    Fuse semantics follow fuse_exposures_to_raw (correct/hdr.py) with the frame
    reduction replaced by local sums + ``lax.psum``; the target EV and the
    brightest-frame pick come from an all-gather of the (tiny) EV vector so
    every device agrees on the global argmax. The fused frame is replicated, so
    the spatial develop slices its halo rows locally — no ppermute.

    Returns (H, W, 3) sRGB.
    """
    assert cfg.fuse_hdr, "develop_hdr_sharded is the fuse_hdr path"
    assert halo % 2 == 0
    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, h, w = frames.bayer.shape
    assert n % n_b == 0, f"bracket size {n} must divide the batch axis {n_b}"
    assert h % (2 * n_sp) == 0, "rows must split CFA-aligned over 'spatial'"
    n_local = n // n_b
    rows_local = h // n_sp

    cal_leaves = tuple(
        f.bayer if f is not None else None for f in (flat, dark)
    )

    def local_fn(leaves, flat_bayer, dark_bayer):
        flat_f = (
            RawFrame.synthetic(flat_bayer) if flat_bayer is not None else None
        )
        dark_f = (
            RawFrame.synthetic(dark_bayer) if dark_bayer is not None else None
        )

        shared_masks = None
        if cfg.repair_hot_pixels and cfg.hot_pixel_shared_ratio is not None:
            # burst-consensus masks reduce across the sharded frame axis —
            # same psum as develop_pipeline_sharded (develop_pipeline parity)
            from ..correct.bad_pixels import find_erroneous_pixels_median

            template = _rebuild(frames, leaves)
            per_frame = lax.map(
                lambda f: find_erroneous_pixels_median(
                    f, cfg.hot_pixel_multiplier, cfg.hot_pixel_quantile
                ),
                template,
            )
            total = lax.psum(
                jnp.sum(per_frame.astype(jnp.int32), axis=0), BATCH_AXIS
            )
            shared_masks = total >= jnp.ceil(n * cfg.hot_pixel_shared_ratio)

        def correct(frame_leaves):
            f = _rebuild(frames, frame_leaves)
            f = _correct_one(f, cfg, flat_f, dark_f, shared_masks)
            return _leaves(f)

        if cfg.enables_per_frame_corrections:
            leaves = lax.map(correct, leaves)
        local = _rebuild(frames, leaves)

        # ---- HDR fuse as a collective (fuse_exposures_to_raw semantics) ----
        evs_all = lax.all_gather(local.ev, BATCH_AXIS).reshape(n)  # tiny
        target = (
            jnp.mean(evs_all)
            if cfg.hdr_target_ev is None
            else jnp.asarray(cfg.hdr_target_ev, jnp.float32)
        )
        offsets_all = 2.0 ** (evs_all - target)
        idx_max = jnp.argmax(offsets_all)
        b_idx = lax.axis_index(BATCH_AXIS)

        local_off = 2.0 ** (local.ev - target)  # (n_local,)

        # WB noise bias from the burst's FIRST frame (global index 0)
        wb_neutral0 = lax.all_gather(local.wb_neutral, BATCH_AXIS).reshape(
            n, 3
        )[0]
        wb = 1.0 / wb_neutral0
        wpat = jnp.stack(
            [jnp.stack([wb[0], wb[1]]), jnp.stack([wb[1], wb[2]])]
        )  # (2, 2) RGGB
        bias22 = 1.6 ** (
            -0.1 * jnp.abs(local_off[:, None, None] * wpat[None])
        )  # (n_local, 2, 2)
        row_odd = (jnp.arange(h, dtype=jnp.int32) & 1)[:, None] == 1
        col_odd = (jnp.arange(w, dtype=jnp.int32) & 1)[None, :] == 1
        sel = lambda a, b_: jnp.where(col_odd, b_, a)  # noqa: E731
        bias = jnp.where(
            row_odd,
            sel(bias22[:, 1:2, 0:1], bias22[:, 1:2, 1:2]),
            sel(bias22[:, 0:1, 0:1], bias22[:, 0:1, 1:2]),
        )
        weights = (0.5 - jnp.abs(local.bayer - 0.5)) * bias
        gidx = b_idx * n_local + jnp.arange(n_local)  # global frame indices
        sel_pix = jnp.where(
            (gidx == idx_max)[:, None, None], local.bayer, 0.0
        )

        sums = (
            jnp.sum(weights, axis=0),
            jnp.sum(local.bayer * weights * local_off[:, None, None], axis=0),
            jnp.sum(sel_pix, axis=0),
            jnp.sum((weights > 0).astype(jnp.int32), axis=0),
        )
        sum_weight, sum_pixel, max_pix, _counts = lax.psum(sums, BATCH_AXIS)
        max_exposure = max_pix * jnp.max(offsets_all)
        fused = jnp.where(sum_weight == 0, max_exposure, sum_pixel / sum_weight)

        # ---- spatial develop of the replicated fused frame (no ppermute) ----
        top = _cfa_reflect_rows(fused, halo, top=True)
        bottom = _cfa_reflect_rows(fused, halo, top=False)
        padded_all = jnp.concatenate([top, fused, bottom], axis=0)
        sp_idx = lax.axis_index(SPATIAL_AXIS)
        block = lax.dynamic_slice_in_dim(
            padded_all, sp_idx * rows_local, rows_local + 2 * halo, axis=0
        )

        # color metadata from the burst's GLOBAL first frame (device-invariant
        # along 'batch', matching fuse_exposures_to_raw's "first frame" policy)
        first = lambda leaf: lax.all_gather(leaf, BATCH_AXIS).reshape(  # noqa: E731
            (n,) + leaf.shape[1:]
        )[0]
        hdr_frame = RawFrame(
            bayer=block.astype(jnp.float32),
            cam_mat=first(local.cam_mat),
            cam_white=first(local.cam_white),
            wb_neutral=wb_neutral0,
            ev=target,
            lim_sat=jnp.max(offsets_all),
            is_hdr=True,
            source_pattern=frames.source_pattern,
        )
        out = develop.__wrapped__(hdr_frame, cfg.develop)
        return out[halo:-halo]

    bspec = (P(BATCH_AXIS, None, None),) + (P(BATCH_AXIS),) * 5
    cal_specs = tuple(
        P(None, None) if leaf is not None else P() for leaf in cal_leaves
    )
    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(bspec, *cal_specs),
        out_specs=P(SPATIAL_AXIS, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(_leaves(frames), *cal_leaves)
