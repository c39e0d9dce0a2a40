"""GPU smoke test: the develop path once through its user entry points,
checked against the same programs on the CPU.

    python chip_smoke.py           # one GPU (what a plain run needs)
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

One process, phases in order; each prints its result on its own line and any
failure exits non-zero:

1. device: the default JAX device must be a GPU (no CPU fallback); prints its
   kind, the device count and nvidia-smi's name and power limit.
2. main path at 24 MP (4000x6000): builds native/libdng_fast.so, writes an
   LJ92 DNG of a structured scene (gradients, edges, mild noise), then load_raw -> develop (Best, Fast,
   Draft); develop_pipeline config 3 (flat + heal + Best) and config 4
   (5-frame HDR fuse -> Best); config 5 (16x1000x1504 burst: CA + Best +
   lanczos4 DNG warp); develop_stream over 3 files to PNG; the CLI. For each
   program: compile seconds, steady-state ms and the memory analysis.
3. reference: each program again on this process's CPU device with the same
   inputs; PSNR (8-bit) of GPU against CPU, gated per program (GATES_DB).

``--multi`` runs only the sharded programs on four GPUs, each against its
monolithic composition on one of those GPUs, with the interior-row tolerances
of ``__graft_entry__.dryrun_multichip``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The phase functions take the devices and sizes as arguments, so the tests run
them on the CPU at tiny sizes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

import jax
import jax.numpy as jnp

from pysp_tpu import DevelopConfig, PipelineConfig, QualityDemosaic, RawFrame
from pysp_tpu.correct.ca.models import Poly3CorrectionModel
from pysp_tpu.correct.ca.removal import remove_ca_from_raw
from pysp_tpu.demosaic.ahd import ahd_direction_pick
from pysp_tpu.io.image_out import to_uint8
from pysp_tpu.pipeline.develop import develop
from pysp_tpu.pipeline.pipeline import develop_pipeline
from pysp_tpu.utils.runtime import device_summary, enable_compile_cache, nvidia_smi_line
from pysp_tpu.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear

ROOT = os.path.dirname(os.path.abspath(__file__))

# PSNR floors (dB, 8-bit) of GPU against CPU, with their reasons.
GATES_DB = {
    # the repo's accelerator-vs-CPU bar: same arithmetic, different compilers
    # (association order, FMA contraction, transcendental implementations)
    "plain": 50.0,
    # AHD's H/V pick compares two homogeneity counts; an exact tie on a
    # synthetic quantized scene falls either way between two compilations and
    # flips whole pixels (DIVERGENCES.md "Cross-compilation homogeneity counts")
    "ahd": 43.0,
}
GATE_OF = {
    "draft": "plain", "fast": "plain", "config4": "plain",
    "best": "ahd", "config3": "ahd", "config5": "ahd", "stream": "ahd", "cli": "ahd",
}

BEST = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)
CA_K1 = 0.01
WARP_COEFFS = (1.005, -0.01, 0.002, 0.0, 0.0003, -0.0002)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def require_gpu(device) -> dict:
    """Refuse anything but a GPU; return the device summary."""
    if device.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: the default JAX device is {device.platform!r}, not a GPU"
        )
    summary = device_summary()
    say(f"device {json.dumps(summary)}")
    say(f"nvidia-smi: {nvidia_smi_line()}")
    return summary


def build_native() -> None:
    """Build the host decode/encode library from the committed sources."""
    from pysp_tpu.io import native

    res = subprocess.run(
        ["make", "-C", os.path.join(ROOT, "native")],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{res.stdout}\n{res.stderr}")
    if not (native.available() and native.has_png()):
        raise RuntimeError("native/libdng_fast.so built but does not load")
    say("native library built and loaded")


def scene_u16(h: int, w: int, seed: int = 2) -> np.ndarray:
    """bench.py's gradients and edges with mild noise on a 12-bit sensor range.

    The noise is uniform over 36 DN (std ~10 DN, a mid-ISO sensor's). bench.py's
    eight times stronger noise makes AHD's two directions near-equal almost
    everywhere, so a GPU-vs-CPU comparison on it measures tie flips, not
    arithmetic (PERF.md, Findings)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    scene = (
        0.25
        + 0.3 * np.sin(xx / 97.0) * np.cos(yy / 131.0)
        + 0.2 * ((xx // 256 + yy // 256) % 2)
        + 0.01 * rng.random((h, w))
    )
    return np.clip(scene * 3600 + 260, 0, 4095).astype(np.uint16)


def psnr8(a, b) -> float:
    mse = np.mean((to_uint8(a).astype(np.float64) - to_uint8(b).astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def _memory(compiled) -> dict:
    mem = compiled.memory_analysis()
    if mem is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(mem, k)) for k in keys if hasattr(mem, k)}


def measure(name: str, jfn, args: tuple, device, static=None, reps: int = 5) -> np.ndarray:
    """Compile the jitted ``jfn`` for ``device`` (``static``: its static
    keyword arguments), run it once, then time ``reps`` more runs."""
    args = jax.device_put(args, device)
    static = static or {}
    t0 = time.perf_counter()
    compiled = jfn.lower(*args, **static).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(*args)
    out.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        compiled(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    times.sort()
    out = np.asarray(out)
    if not np.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    say(f"{name} " + json.dumps({
        "shape": list(out.shape),
        "compile_s": round(compile_s, 3),
        "steady_ms_median": round(times[len(times) // 2] * 1e3, 3),
        "steady_ms_min": round(times[0] * 1e3, 3),
        "memory": _memory(compiled),
    }))
    return out


def reference(jfn, args: tuple, ref_device, static=None) -> np.ndarray:
    """The same jitted function on the reference device."""
    return np.asarray(jfn(*jax.device_put(args, ref_device), **(static or {})))


def check(name: str, got: np.ndarray, want: np.ndarray, failures: list) -> float:
    """PSNR of ``got`` against the reference, gated; a miss is added to
    ``failures`` so every program still reports before the run fails."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs reference {want.shape}")
    gate = GATES_DB[GATE_OF[name]]
    p = psnr8(got, want)
    say(f"{name} psnr_vs_cpu {p:.2f} dB (gate >= {gate} dB, {GATE_OF[name]})")
    if not p >= gate:
        failures.append(f"{name}: PSNR {p:.2f} dB below {gate} dB")
    return p


def pick_report(got: np.ndarray, want: np.ndarray, picks) -> None:
    """How much of a Best difference the H/V pick flips explain: the share of
    picks that differ, and the PSNR away from them (7x7 around each flip is
    the reach of the interpolation and the 5x5 chroma median)."""
    flip = picks[0] != picks[1]
    near = flip.copy()
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            near |= np.roll(flip, (dy, dx), axis=(0, 1))
    say("best " + json.dumps({
        "hv_pick_differs_share": float(flip.mean()),
        "psnr_away_from_flips_db": round(psnr8(got[~near], want[~near]), 2),
        "share_near_flips": round(float(near.mean()), 5),
    }))


def same_program(name: str, got: np.ndarray, want: np.ndarray) -> None:
    """Check an entry point's output against ``develop`` on the same device and
    file: the same program, so identical up to 8-bit quantization."""
    identical = np.array_equal(to_uint8(got), to_uint8(want))
    p = psnr8(got, want)
    say(f"{name} vs develop on the same device: identical_8bit {identical}, psnr {p:.2f} dB")
    if not p >= GATES_DB["plain"]:
        raise AssertionError(f"{name}: {p:.2f} dB from develop on the same device")


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG whose rows all use filter 0 (both writers here)."""
    data = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    if ihdr[8] != 8 or ihdr[9] != 2:
        raise ValueError("read_png reads 8-bit RGB only")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("read_png reads filter-0 rows only")
    return rows[:, 1:].reshape(h, w, 3)


def _burst_frames(base: RawFrame, n: int, bh: int, bw: int) -> RawFrame:
    """``n`` crops of ``base`` (one camera's burst), stacked on a leading axis."""
    h, w = base.bayer.shape
    frames = []
    for i in range(n):
        y = (2 * i * (h - bh) // max(2 * n - 2, 1)) & ~1
        x = (2 * i * (w - bw) // max(2 * n - 2, 1)) & ~1
        frames.append(base.replace(bayer=base.bayer[y:y + bh, x:x + bw],
                                   ev=base.ev + 0.1 * i))
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)


def main_path(device, ref_device, h: int = 4000, w: int = 6000,
              burst=(16, 1000, 1504), hdr_n: int = 5, stream_n: int = 3,
              reps: int = 5) -> dict:
    """Phases 2 and 3: every program on ``device``, checked on ``ref_device``.

    develop_stream and the CLI run on the process's default device, which
    ``device`` is expected to be. Returns ({program: PSNR vs reference},
    [gate failures])."""
    from pysp_tpu import cli
    from pysp_tpu.io.image_out import save_image
    from pysp_tpu.io.raw_loader import load_raw
    from pysp_tpu.io.tiff import write_synthetic_dng
    from pysp_tpu.pipeline.stream import develop_stream

    psnrs, failures = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        paths = []
        for i in range(stream_n):
            u16 = scene_u16(h, w, seed=2 + i)
            paths.append(os.path.join(tmp, f"shot{i}.dng"))
            with open(paths[-1], "wb") as f:
                f.write(write_synthetic_dng(u16, compression=7))
        frame = load_raw(paths[0])
        say(f"host: wrote {stream_n} LJ92 DNGs of {h}x{w} and decoded one in "
            f"{time.perf_counter() - t0:.2f} s")

        # --- develop, three tiers ------------------------------------------
        outs = {}
        for name, quality in (("best", QualityDemosaic.Best),
                              ("fast", QualityDemosaic.Fast),
                              ("draft", QualityDemosaic.Draft)):
            static = {"cfg": DevelopConfig(quality=quality, postprocess_stages=1)}
            outs[name] = measure(name, develop, (frame,), device, static, reps)
            want = reference(develop, (frame,), ref_device, static)
            psnrs[name] = check(name, outs[name], want, failures)
            if name == "best":
                best_ref = want
                picks = [np.asarray(jax.jit(ahd_direction_pick)(jax.device_put(frame, d)))
                         for d in (device, ref_device)]
                pick_report(outs[name], want, picks)

        # --- config 3: flat + heal + Best --------------------------------
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        r2 = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
        flat = RawFrame.synthetic(1.0 - 0.25 * r2 / 2.0)
        hot = np.array(frame.bayer)  # hot photosites for the heal to find
        rng = np.random.default_rng(5)
        n_hot = 64 + h * w // 20000
        hot[rng.integers(0, h, n_hot), rng.integers(0, w, n_hot)] = 1.0
        frame3 = frame.replace(bayer=jnp.asarray(hot))
        cfg3 = PipelineConfig(develop=BEST, flat_field=True, repair_hot_pixels=True)
        fn3 = jax.jit(lambda f, fl: develop_pipeline(f, cfg3, flat=fl))
        out3 = measure("config3", fn3, (frame3, flat), device, reps=reps)
        psnrs["config3"] = check(
            "config3", out3, reference(fn3, (frame3, flat), ref_device), failures)

        # --- config 4: HDR bracket fuse -> Best ---------------------------
        bracket = [frame.replace(bayer=jnp.clip(frame.bayer * 2.0 ** (i - hdr_n // 2), 0, 1),
                                 ev=frame.ev - (i - hdr_n // 2))
                   for i in range(hdr_n)]
        hdr = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *bracket)
        cfg4 = PipelineConfig(develop=BEST, fuse_hdr=True)
        out4 = measure("config4", develop_pipeline, (hdr,), device, {"cfg": cfg4}, reps)
        psnrs["config4"] = check(
            "config4", out4, reference(develop_pipeline, (hdr,), ref_device, {"cfg": cfg4}),
            failures)

        # --- config 5: burst CA + Best + lanczos4 DNG warp ----------------
        n, bh, bw = burst
        frames5 = _burst_frames(frame, n, bh, bw)
        ca = Poly3CorrectionModel(CA_K1)
        block = encode_warp_rectilinear([WARP_COEFFS] * 3, (0.5, 0.5))

        @jax.jit
        def fn5(fs):
            fs = remove_ca_from_raw(fs, ca, ca)
            return jax.lax.map(
                lambda f: apply_opcode_3_warp(develop(f, BEST), block), fs
            )

        out5 = measure("config5", fn5, (frames5,), device, reps=reps)
        psnrs["config5"] = check(
            "config5", out5, reference(fn5, (frames5,), ref_device), failures)

        # --- develop_stream: decode || develop || PNG ---------------------
        t0 = time.perf_counter()
        streamed = []
        for i, (src, img) in enumerate(develop_stream(paths, BEST)):
            save_image(os.path.join(tmp, f"stream{i}.png"), img)
            streamed.append((src, img))
        dt = time.perf_counter() - t0
        if [s for s, _ in streamed] != paths:
            raise AssertionError("develop_stream lost or reordered files")
        same_program("stream", streamed[0][1], outs["best"])
        say("stream " + json.dumps({"files": stream_n, "wall_s": round(dt, 3),
                                    "s_per_file": round(dt / stream_n, 3)}))
        psnrs["stream"] = check("stream", streamed[0][1], best_ref, failures)

        # --- the CLI, in this process ------------------------------------
        png = os.path.join(tmp, "cli.png")
        t0 = time.perf_counter()
        rc = cli.main(["develop", paths[0], "-o", png])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        got = read_png(png)
        same_program("cli", got.astype(np.float32) / 255.0, outs["best"])
        say("cli " + json.dumps({"wall_s": round(dt, 3), "png_bytes": os.path.getsize(png)}))
        psnrs["cli"] = check("cli", got.astype(np.float32) / 255.0, best_ref, failures)

    stats = device.memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        say(f"device peak_bytes_in_use {stats['peak_bytes_in_use']}")
    return psnrs, failures


def multi_path(devices, h: int = 4000, w: int = 6000,
               burst=(16, 1000, 1504), big=(8736, 11648), hdr_n: int = 5) -> None:
    """The sharded programs over four devices, each against its monolithic
    composition on ``devices[0]`` (interior rows, dry-run tolerances)."""
    from __graft_entry__ import _make_frames
    from pysp_tpu.parallel.mesh import make_mesh
    from pysp_tpu.parallel.pipeline_sharded import (
        develop_hdr_sharded,
        develop_pipeline_sharded,
    )
    from pysp_tpu.parallel.spatial import develop_burst_spatial
    from pysp_tpu.parallel.spatial_pipeline import develop_frame_spatial
    from pysp_tpu.pipeline.develop import develop_burst

    if len(devices) < 4:
        raise SystemExit(f"--multi needs 4 devices, found {len(devices)}")
    one = devices[0]
    fast = PipelineConfig(develop=DevelopConfig(quality=QualityDemosaic.Fast))
    block = encode_warp_rectilinear(
        [(1.004, -0.008, 0.0015, 0.0, 0.0002, -0.0001)] * 3, (0.5, 0.5)
    )

    def report(name, got, want, tol, edge=0):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
        sl = (slice(None),) * (got.ndim - 3) + (slice(edge, got.shape[-3] - edge),)
        err = float(np.abs(got[sl] - want[sl]).max())
        say(f"{name} max_abs_interior {err:.3e} (tol {tol:g}, edge rows {edge})")
        if not err <= tol:
            raise AssertionError(f"{name}: {err:.3e} > {tol:g}")

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        return out, time.perf_counter() - t0

    # burst of 24 MP frames: 'batch' x 'spatial' = (2, 2), Best
    frames = _make_frames(4, h, w)
    out, dt = timed(lambda: develop_burst_spatial(frames, BEST, make_mesh((2, 2), devices[:4]), halo=16))
    say(f"burst_spatial (2,2) 4x{h}x{w} Best first call {dt:.2f} s")
    want = develop_burst(jax.device_put(frames, one), BEST)
    report("burst_spatial", out, want, 2e-5, edge=16)

    # config-5 burst batch-sharded: (4, 1), CA + Fast + bilinear warp
    n, bh, bw = burst
    frames = _make_frames(n, bh, bw)
    model = Poly3CorrectionModel(0.008)
    out, dt = timed(lambda: develop_pipeline_sharded(
        frames, make_mesh((4, 1), devices[:4]), fast, ca_model_r=model,
        ca_model_b=model, warp_block=block, warp_interpolation="bilinear"))
    say(f"pipeline_sharded (4,1) {n}x{bh}x{bw} first call {dt:.2f} s")

    def mono5(fs):
        fs = remove_ca_from_raw(fs, model, model)
        return jax.lax.map(lambda f: apply_opcode_3_warp(
            develop(f, fast.develop), block, interpolation="bilinear"), fs)

    report("pipeline_sharded", out, jax.jit(mono5)(jax.device_put(frames, one)), 3e-5)

    # config-4 bracket: psum fuse over 'batch', develop over 'spatial' (1, 4)
    frames = _make_frames(hdr_n, h, w)
    cfg4 = PipelineConfig(develop=fast.develop, fuse_hdr=True)
    out, dt = timed(lambda: develop_hdr_sharded(frames, make_mesh((1, 4), devices[:4]), cfg4, halo=16))
    say(f"hdr_sharded (1,4) {hdr_n}x{h}x{w} first call {dt:.2f} s")
    report("hdr_sharded", out, develop_pipeline(jax.device_put(frames, one), cfg4), 3e-5, edge=16)

    # one medium-format frame, rows over (1, 4): CA + Fast + bilinear warp.
    # Displacements grow with the frame, and the select-chain remaps with
    # them: a milder lens keeps the 102 MP spans near config 5's (~10 px).
    bh, bw = big
    frame = _make_frames(1, bh, bw)
    model = Poly3CorrectionModel(0.002)
    block = encode_warp_rectilinear(
        [(1.001, -0.002, 0.0004, 0.0, 0.00005, -0.00005)] * 3, (0.5, 0.5)
    )
    out, dt = timed(lambda: develop_frame_spatial(
        frame, make_mesh((1, 4), devices[:4]), fast, ca_model_r=model,
        ca_model_b=model, warp_block=block, warp_interpolation="bilinear"))
    say(f"frame_spatial (1,4) {bh}x{bw} first call {dt:.2f} s")
    ref = jax.jit(lambda f: apply_opcode_3_warp(
        develop(remove_ca_from_raw(f, model, model), fast.develop), block,
        interpolation="bilinear"))(jax.device_put(frame, one))
    report("frame_spatial", out, ref, 3e-5, edge=32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    summary = require_gpu(jax.devices()[0])
    say(f"compile cache: {enable_compile_cache()}")
    if args.multi:
        multi_path(jax.devices())
    else:
        build_native()
        psnrs, failures = main_path(jax.devices()[0], jax.devices("cpu")[0])
        say("psnr_vs_cpu " + json.dumps({k: round(v, 2) for k, v in psnrs.items()}))
        if failures:
            raise AssertionError("gates missed: " + "; ".join(failures))
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
