"""Sharded develops: spatial row-sharding with halo exchange + batch data-parallel.

The CP/sequence-parallel analog for images (SURVEY.md §2.10 / §5 long-context row):
a single large sensor's rows are sharded across the mesh's 'spatial' axis; each device
exchanges a CFA-aligned halo with its neighbors (``lax.ppermute``), develops
its padded block locally (the stencil pipeline never reaches past the halo), and crops.

Halo semantics:
- halo must be even (CFA phase) and >= the develop pipeline's total stencil reach
  (~10 sensor px for AHD with 1 postprocess stage; default 16).
- interior block boundaries are exact vs the monolithic develop;
- at the global top/bottom edge, missing neighbors are emulated with CFA-preserving
  quad reflection (pad row -k = row (k-1)^1), which equals symmetric plane padding —
  output differs from the monolithic develop only within the stencil reach of the
  global edge (different per-op border modes), which the parity test bounds.

Batch parallelism (``develop_burst_sharded``) shards the leading frame axis over
'batch' and vmaps locally — per-frame color matrices ride along as sharded leaves.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.frame import RawFrame
from ..pipeline.develop import DevelopConfig, develop
from .mesh import BATCH_AXIS, SPATIAL_AXIS

Array = jnp.ndarray


def _cfa_reflect_rows(block: Array, halo: int, top: bool) -> Array:
    """CFA-preserving reflection pad rows: pad row -k = row ((k-1) ^ 1)."""
    ks = jnp.arange(1, halo + 1)
    idx = (ks - 1) ^ 1
    if top:
        # rows above the block, ordered top-to-bottom: k = halo .. 1
        return block[idx[::-1], :]
    h = block.shape[0]
    return block[h - 1 - idx, :]


def develop_spatial(
    frame: RawFrame,
    cfg: DevelopConfig,
    mesh: Mesh,
    halo: int = 16,
) -> Array:
    """Develop one frame with its rows sharded over the mesh's spatial axis.

    Halos are exchanged BEFORE the local develop, so the develop itself is
    purely device-local (no collective crosses it). Parity is gated by
    test_parallel.py on the virtual mesh and by ``chip_smoke.py --multi`` on
    four GPUs.
    """
    assert halo % 2 == 0, "halo must keep CFA phase"
    dev_fn = develop.__wrapped__
    n_sp = mesh.shape[SPATIAL_AXIS]
    h = frame.bayer.shape[0]
    assert h % (2 * n_sp) == 0, f"height {h} must split into CFA-aligned blocks"

    def block_fn(bayer_block, cam_mat, cam_white, wb_neutral, ev, lim_sat):
        idx = lax.axis_index(SPATIAL_AXIS)

        # Neighbor halos. ppermute leaves non-receivers zero-filled;
        # global edges fall back to CFA-preserving reflection.
        send_up = [(i, i - 1) for i in range(1, n_sp)]
        send_down = [(i, i + 1) for i in range(n_sp - 1)]

        from_below = lax.ppermute(bayer_block[:halo], SPATIAL_AXIS, send_up)
        from_above = lax.ppermute(bayer_block[-halo:], SPATIAL_AXIS, send_down)

        top_pad = jnp.where(
            idx == 0, _cfa_reflect_rows(bayer_block, halo, top=True), from_above
        )
        bottom_pad = jnp.where(
            idx == n_sp - 1,
            _cfa_reflect_rows(bayer_block, halo, top=False),
            from_below,
        )

        padded = jnp.concatenate([top_pad, bayer_block, bottom_pad], axis=0)

        padded_frame = RawFrame(
            bayer=padded,
            cam_mat=cam_mat,
            cam_white=cam_white,
            wb_neutral=wb_neutral,
            ev=ev,
            lim_sat=lim_sat,
            is_hdr=frame.is_hdr,
            source_pattern=frame.source_pattern,
        )
        out = dev_fn(padded_frame, cfg)
        return out[halo:-halo]

    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P(SPATIAL_AXIS, None), P(), P(), P(), P(), P()),
        out_specs=P(SPATIAL_AXIS, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    fn = jax.jit(sharded)
    return fn(
        frame.bayer,
        frame.cam_mat,
        frame.cam_white,
        frame.wb_neutral,
        frame.ev,
        frame.lim_sat,
    )


def develop_burst_sharded(
    frames: RawFrame,
    cfg: DevelopConfig,
    mesh: Mesh,
) -> Array:
    """Develop a batched RawFrame with the frame axis sharded over 'batch'."""
    n_b = mesh.shape[BATCH_AXIS]
    assert frames.bayer.shape[0] % n_b == 0

    def local_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat):
        def one(args):
            b, cm, cw, wn, e, ls = args
            f = RawFrame(
                bayer=b, cam_mat=cm, cam_white=cw, wb_neutral=wn, ev=e,
                lim_sat=ls, is_hdr=frames.is_hdr,
                source_pattern=frames.source_pattern,
            )
            return develop.__wrapped__(f, cfg)

        # lax.map, not vmap: one frame saturates a chip; vmapped stencils are slower
        return jax.lax.map(
            one, (bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat)
        )

    spec = P(BATCH_AXIS)
    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS, None, None), spec, spec, spec, spec, spec),
        out_specs=P(BATCH_AXIS, None, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(
        frames.bayer,
        frames.cam_mat,
        frames.cam_white,
        frames.wb_neutral,
        frames.ev,
        frames.lim_sat,
    )


def develop_burst_spatial(
    frames: RawFrame,
    cfg: DevelopConfig,
    mesh: Mesh,
    halo: int = 16,
) -> Array:
    """Fully sharded burst develop: frame axis over 'batch' AND rows over 'spatial'.

    This is the production layout for large bursts of large sensors: data parallelism
    over frames, spatial row-sharding with halo exchange within each frame.
    """
    assert halo % 2 == 0
    dev_fn = develop.__wrapped__
    n_b = mesh.shape[BATCH_AXIS]
    n_sp = mesh.shape[SPATIAL_AXIS]
    n, h = frames.bayer.shape[0], frames.bayer.shape[1]
    assert n % n_b == 0 and h % (2 * n_sp) == 0

    def block_fn(bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat):
        # bayer: (N/n_b, H/n_sp, W) — exchange halos along the spatial axis, then
        # vmap the padded develop over the local batch.
        idx = lax.axis_index(SPATIAL_AXIS)
        send_up = [(i, i - 1) for i in range(1, n_sp)]
        send_down = [(i, i + 1) for i in range(n_sp - 1)]

        from_below = lax.ppermute(bayer[:, :halo], SPATIAL_AXIS, send_up)
        from_above = lax.ppermute(bayer[:, -halo:], SPATIAL_AXIS, send_down)

        def pad_one(block, below, above):
            top_pad = jnp.where(
                idx == 0, _cfa_reflect_rows(block, halo, top=True), above
            )
            bottom_pad = jnp.where(
                idx == n_sp - 1, _cfa_reflect_rows(block, halo, top=False), below
            )
            return jnp.concatenate([top_pad, block, bottom_pad], axis=0)

        padded = jax.vmap(pad_one)(bayer, from_below, from_above)

        def one(args):
            b, cm, cw, wn, e, ls = args
            f = RawFrame(
                bayer=b, cam_mat=cm, cam_white=cw, wb_neutral=wn, ev=e,
                lim_sat=ls, is_hdr=frames.is_hdr,
                source_pattern=frames.source_pattern,
            )
            return dev_fn(f, cfg)[halo:-halo]

        return jax.lax.map(
            one, (padded, cam_mat, cam_white, wb_neutral, ev, lim_sat)
        )

    bspec = P(BATCH_AXIS)
    sharded = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS, SPATIAL_AXIS, None), bspec, bspec, bspec, bspec, bspec),
        out_specs=P(BATCH_AXIS, SPATIAL_AXIS, None, None),
        check_vma=False,  # loop carries mix replicated and per-shard values
    )
    return jax.jit(sharded)(
        frames.bayer,
        frames.cam_mat,
        frames.cam_white,
        frames.wb_neutral,
        frames.ev,
        frames.lim_sat,
    )
