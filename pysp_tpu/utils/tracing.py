"""Observability: profiler traces, named stages, per-develop statistics.

The reference has no tracing/metrics at all (SURVEY.md §5: one stray debug print).
Here every develop can emit structured per-stage statistics computed inside the same
XLA program (no extra passes), and ``trace`` wraps jax.profiler for device timelines.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import jax.numpy as jnp

Array = jnp.ndarray


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


stage = jax.named_scope  # alias: `with stage("ahd/green_interp"): ...`


def bayer_stats(bayer: Array, lim_sat: Array) -> Dict[str, Array]:
    """Sensor-domain statistics (computed in-graph; all scalars)."""
    return {
        "mean": jnp.mean(bayer),
        "clip_high_frac": jnp.mean((bayer >= lim_sat).astype(jnp.float32)),
        "clip_low_frac": jnp.mean((bayer <= 0.0).astype(jnp.float32)),
        "p99": jnp.quantile(bayer.reshape(-1), 0.99),
    }


def rgb_stats(rgb: Array) -> Dict[str, Array]:
    """Output-domain statistics per channel."""
    flat = rgb.reshape(-1, rgb.shape[-1])
    return {
        "mean_rgb": jnp.mean(flat, axis=0),
        "std_rgb": jnp.std(flat, axis=0),
        "sat_frac": jnp.mean((flat >= 1.0).astype(jnp.float32)),
        "neg_frac": jnp.mean((flat <= 0.0).astype(jnp.float32)),
    }


class StageTimer:
    """Host-side wall-clock per stage for multi-dispatch pipelines (fit loops etc.).

    Device-side develop stages fuse into one program — use ``trace`` for those; this
    times host-orchestrated phases (CA fitting, IO, WB solve).
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v*1e3:.1f} ms" for k, v in sorted(self.times.items())]
        lines.append(f"total: {total*1e3:.1f} ms")
        return "\n".join(lines)
