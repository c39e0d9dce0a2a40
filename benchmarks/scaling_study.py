"""Multi-chip scaling study on a virtual device mesh.

It needs no accelerator: it checks what a virtual CPU mesh can show honestly
(``chip_smoke.py --multi`` runs the sharded paths on four real GPUs):

1. **Numerics at every mesh size**: the spatially-sharded Best develop must
   reproduce the monolithic develop on interior rows for spatial = 2/4/8 and
   mixed batch x spatial meshes (virtual CPU devices execute the REAL
   shard_map program, collectives included).
2. **Overhead accounting**: the model that predicts multi-chip efficiency is
   analytic — per-shard halo recompute (2*halo / (H/n_sp) of each shard's
   rows) and ppermute traffic (2 * halo * W * 4 bytes per shard pair per
   step) — both printed per mesh size for the 24 MP flagship shape.
   Halo recompute is the only redundant compute; halos move by ppermute.

Run (the virtual mesh MUST be configured before jax imports):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=. python benchmarks/scaling_study.py

Wall-clock per-step times on the shared-core virtual mesh are reported but
are NOT speedup evidence — 8 virtual devices share this box's one core; the
numbers only show the sharded program's overhead staying bounded.
"""
from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _scene_mosaic(h, w, seed=0):
    """Structured RGGB mosaic (gradients + edges + light noise — the tests'
    make_scene recipe). Uniform random content is deliberately NOT used: on
    tie-dense noise the AHD H/V decision flips between different-shape
    compilations of the same program (the documented cross-compilation
    homogeneity caveat), which measures float association, not sharding."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 0.3 + 0.4 * np.sin(xx / 9) * np.cos(yy / 13) + 0.2 * (xx > w / 2)
    g = 0.4 + 0.3 * np.cos(xx / 7) + 0.15 * (yy > h / 3)
    b = 0.5 - 0.3 * np.sin(yy / 11) + 0.1 * ((xx + yy) % 17 > 8)
    rgb = np.clip(np.dstack([r, g, b]) + rng.normal(0, 0.01, (h, w, 3)), 0.02, 0.98)
    bayer = np.zeros((h, w), np.float32)
    bayer[0::2, 0::2] = rgb[0::2, 0::2, 0]
    bayer[0::2, 1::2] = rgb[0::2, 1::2, 1]
    bayer[1::2, 0::2] = rgb[1::2, 0::2, 1]
    bayer[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return bayer


def main(h=512, w=768, halo=16):
    from pysp_tpu import DevelopConfig, QualityDemosaic, RawFrame
    from pysp_tpu.parallel.mesh import make_mesh
    from pysp_tpu.parallel.spatial import develop_burst_spatial, develop_spatial
    from pysp_tpu.pipeline.develop import develop, develop_burst

    assert len(jax.devices()) >= 8, "needs the 8-device virtual mesh"
    frame = RawFrame.synthetic(
        _scene_mosaic(h, w),
        cam_mat=np.array(
            [[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32
        ),
        wb_neutral=np.array([0.45, 1.0, 0.62], np.float32),
    )
    cfg = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)

    want = np.asarray(develop(frame, cfg))

    print(f"[scaling] spatial sharding of one {h}x{w} frame (halo {halo}):")
    for n_sp in (1, 2, 4, 8):
        mesh = make_mesh((1, n_sp), devices=jax.devices()[:n_sp])
        fn = lambda f: develop_spatial(f, cfg, mesh, halo=halo)  # noqa: E731
        out = np.asarray(fn(frame))
        err = float(np.abs(out[halo:-halo] - want[halo:-halo]).max())
        t0 = time.perf_counter()
        for _ in range(3):
            fn(frame).block_until_ready()
        dt = (time.perf_counter() - t0) / 3
        shard_rows = h // n_sp
        redun = 2 * halo / (shard_rows + 2 * halo)
        comm_mb_24mp = 2 * halo * 6000 * 4 / 1e6
        print(
            f"[scaling]   spatial={n_sp}: interior maxerr {err:.2e} "
            f"(gate 2e-5), {dt*1e3:6.1f} ms/step shared-core; "
            f"analytic @24MP: halo recompute {100*2*halo/(4000/n_sp+2*halo):.1f}% "
            f"of shard rows, ppermute {comm_mb_24mp:.1f} MB/shard-pair/step"
        )
        assert err <= 2e-5, err

    print("[scaling] batch x spatial burst develop (4 frames):")
    frames = jax.tree_util.tree_map(
        lambda *xs: jax.numpy.stack(xs),
        *[RawFrame.synthetic(_scene_mosaic(h, w, seed=i)) for i in range(4)],
    )
    want_b = np.asarray(develop_burst(frames, cfg))
    for shape in ((2, 2), (4, 2), (2, 4)):
        n = shape[0] * shape[1]
        mesh = make_mesh(shape, devices=jax.devices()[:n])
        out = np.asarray(develop_burst_spatial(frames, cfg, mesh, halo=halo))
        d = np.abs(out[:, halo:-halo] - want_b[:, halo:-halo])
        # Best's AHD H/V decision can flip at exact ties between
        # different-shape compilations (documented caveat), so the burst
        # gate is statistical: tiny flip fraction + high PSNR, not maxerr
        flip_frac = float((d > 2e-5).mean())
        psnr = 10 * np.log10(1.0 / max(float((d**2).mean()), 1e-12))
        print(
            f"[scaling]   mesh {shape}: interior maxerr {d.max():.2e}, "
            f"flip fraction {flip_frac:.2e}, PSNR {psnr:.1f} dB"
        )
        assert flip_frac < 1e-3 and psnr > 50, (flip_frac, psnr)

    print("[scaling] config-5 pipeline (CA + Best + warp) batch-sharded (8 frames):")
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel
    from pysp_tpu.correct.ca.removal import remove_ca_from_raw
    from pysp_tpu.parallel.pipeline_sharded import develop_pipeline_sharded
    from pysp_tpu.pipeline.pipeline import PipelineConfig
    from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

    ph, pw = 256, 384  # config-5-shaped: many small frames
    pframes = jax.tree_util.tree_map(
        lambda *xs: jax.numpy.stack(xs),
        *[RawFrame.synthetic(_scene_mosaic(ph, pw, seed=10 + i)) for i in range(8)],
    )
    model = Poly3CorrectionModel(0.01)
    block = encode_warp_rectilinear(
        [(1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)] * 3, (0.5, 0.5)
    )
    pcfg = PipelineConfig(develop=cfg)
    one = jax.tree_util.tree_map(lambda leaf: leaf[0], pframes)
    ref0 = np.asarray(
        apply_opcode_3_warp(
            develop(remove_ca_from_raw(one, model, model), cfg),
            block,
            interpolation="bilinear",
        )
    )
    for n_b in (2, 4, 8):
        mesh = make_mesh((n_b, 1), devices=jax.devices()[:n_b])
        t0 = time.perf_counter()
        out = develop_pipeline_sharded(
            pframes, mesh, pcfg, ca_model_r=model, ca_model_b=model,
            warp_block=block, warp_interpolation="bilinear",
        )
        out.block_until_ready()
        dt = time.perf_counter() - t0
        d = np.abs(np.asarray(out[0]) - ref0)
        flip_frac = float((d > 3e-5).mean())
        psnr = 10 * np.log10(1.0 / max(float((d**2).mean()), 1e-12))
        print(
            f"[scaling]   batch={n_b}: frame-0 maxerr {d.max():.2e}, "
            f"flip fraction {flip_frac:.2e}, PSNR {psnr:.1f} dB, "
            f"{dt*1e3:6.0f} ms first-step shared-core"
        )
        assert flip_frac < 1e-3 and psnr > 50, (flip_frac, psnr)

    print(
        "[scaling] spatial config-5: ONE frame's rows over the mesh "
        "(CA + Best + warp all row-sharded; round 5):"
    )
    from pysp_tpu.parallel.spatial_pipeline import (
        _ca_setup,
        develop_frame_spatial,
        required_spatial_halo,
    )

    sframe = RawFrame.synthetic(_scene_mosaic(h, w, seed=30))
    ref_s = np.asarray(
        apply_opcode_3_warp(
            develop(remove_ca_from_raw(sframe, model, model), cfg),
            block,
            interpolation="bilinear",
        )
    )
    s_halo = required_spatial_halo(
        pcfg, (_ca_setup(model, h, w),) * 2, [], "bilinear"
    )
    edge = 2 * halo
    for n_sp in (2, 4, 8):
        mesh = make_mesh((1, n_sp), devices=jax.devices()[:n_sp])
        t0 = time.perf_counter()
        out = develop_frame_spatial(
            sframe, mesh, pcfg, ca_model_r=model, ca_model_b=model,
            warp_block=block, warp_interpolation="bilinear",
        )
        out.block_until_ready()
        dt = time.perf_counter() - t0
        d = np.abs(np.asarray(out)[edge:-edge] - ref_s[edge:-edge])
        flip_frac = float((d > 3e-5).mean())
        psnr = 10 * np.log10(1.0 / max(float((d**2).mean()), 1e-12))
        shard_rows = h // n_sp
        print(
            f"[scaling]   spatial={n_sp}: interior maxerr {d.max():.2e}, "
            f"flip fraction {flip_frac:.2e}, PSNR {psnr:.1f} dB, "
            f"{dt*1e3:6.0f} ms first-step shared-core; analytic @100MP "
            f"(9216 rows): halo {s_halo} rows = "
            f"{100 * 2 * s_halo / (9216 / n_sp + 2 * s_halo):.1f}% recompute"
        )
        assert flip_frac < 1e-3 and psnr > 50, (flip_frac, psnr)

    print("[scaling] OK: numerics hold at every mesh size")


if __name__ == "__main__":
    sys.exit(main())
