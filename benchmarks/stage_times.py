"""Device time of the develop stages that have no hand-written kernel, at real sizes.

Each stage is one jitted program, warmed up, then timed by the host clock
around ``block_until_ready`` (median of ``--reps``). The stages:

- ``best_develop``: Best (AHD) develop of one 24 MP frame;
- ``heal_sparse`` / ``heal_dense``: the config-3 hot-pixel fill alone on a
  24 MP frame, with a mask the sparse path takes and one over its site bound;
- ``rl20_plane`` / ``rl20_rgb`` / ``rl20_yuv``: Richardson-Lucy at 20
  iterations on a 24 MP plane, an RGB image, and the CLI's YUV form;
- ``ca_burst`` / ``warp_burst``: the config-5 CA removal and lanczos4 DNG
  warp alone on 16 x 1000x1504.

Prints one JSON line per stage, after the device and its power limit.

    python -m benchmarks.stage_times
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _time(fn, args, reps: int) -> dict:
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "first_call_s": round(first, 3),
        "ms_median": round(times[len(times) // 2] * 1e3, 3),
        "ms_min": round(times[0] * 1e3, 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--size", type=int, nargs=2, default=(4000, 6000), metavar=("H", "W"),
                    help="frame size (>= 1128 x 1760 for the burst crops)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from pysp_tpu import DevelopConfig, QualityDemosaic, RawFrame
    from pysp_tpu.correct.bad_pixels import repair_bad_pixels
    from pysp_tpu.correct.ca.models import Poly3CorrectionModel
    from pysp_tpu.correct.ca.removal import remove_ca_from_raw
    from pysp_tpu.filters.sharpen import (
        gaussian_rt_deconvolution,
        gaussian_rt_deconvolution_yuv,
    )
    from pysp_tpu.pipeline.develop import develop
    from pysp_tpu.utils.runtime import device_summary, enable_compile_cache, nvidia_smi_line
    from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

    enable_compile_cache()
    print(json.dumps({"device": device_summary(), "nvidia_smi": nvidia_smi_line()}), flush=True)

    def emit(name, fn, *a):
        print(json.dumps({"stage": name, **_time(fn, a, args.reps)}), flush=True)

    rng = np.random.default_rng(0)
    h, w = args.size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scene = np.clip(0.4 + 0.3 * np.sin(xx / 97.0) * np.cos(yy / 131.0)
                    + 0.05 * rng.random((h, w), np.float32), 0, 1)
    frame = jax.device_put(RawFrame.synthetic(scene))

    best = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)
    emit("best_develop", lambda f: develop(f, best), frame)

    heal = jax.jit(lambda f, m: repair_bad_pixels(f, m).bayer)
    for name, n_sites in (("heal_sparse", 2000), ("heal_dense", 40000)):
        masks = np.zeros((4, h // 2, w // 2), bool)
        flat = rng.choice(masks.size, n_sites, replace=False)
        masks.reshape(-1)[flat] = True
        emit(name, heal, frame, jnp.asarray(masks))

    rl = jax.jit(lambda x: gaussian_rt_deconvolution(x, 1.0, 20))
    rl_yuv = jax.jit(lambda x: gaussian_rt_deconvolution_yuv(x, 1.0, 20))
    rgb = jnp.asarray(np.stack([scene, scene[::-1], scene[:, ::-1]], axis=-1))
    emit("rl20_plane", rl, jnp.asarray(scene))
    emit("rl20_rgb", rl, rgb)
    emit("rl20_yuv", rl_yuv, rgb)

    n, bh, bw = 16, 1000, 1504
    burst = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[RawFrame.synthetic(scene[8 * i:8 * i + bh, 16 * i:16 * i + bw]) for i in range(n)],
    )
    ca = Poly3CorrectionModel(0.01)
    emit("ca_burst", jax.jit(lambda fs: remove_ca_from_raw(fs, ca, ca).bayer), burst)
    block = encode_warp_rectilinear(
        [(1.005, -0.01, 0.002, 0.0, 0.0003, -0.0002)] * 3, (0.5, 0.5)
    )
    imgs = jnp.asarray(np.stack([np.stack([b, b, b], -1) for b in np.asarray(burst.bayer)]))
    emit("warp_burst",
         jax.jit(lambda xs: jax.lax.map(lambda x: apply_opcode_3_warp(x, block), xs)),
         imgs)


if __name__ == "__main__":
    main()
