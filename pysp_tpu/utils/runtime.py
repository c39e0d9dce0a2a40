"""Process set-up shared by every entry point: compile cache and device report.

``enable_compile_cache`` is the one place the persistent XLA compilation cache
is configured (the CLI, ``bench.py``, ``chip_smoke.py`` and
``benchmarks/cache.py`` call it). The cache directory is part of the cache's
key, so it is fixed: ``$JAX_COMPILATION_CACHE_DIR`` when the environment sets
it (JAX reads that variable itself, so no directory is set in code), else
``<checkout>/.jax_cache``.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir


def device_summary() -> dict:
    """The default device as JAX reports it, plus the device count."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def nvidia_smi_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of each card, or None without one."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    return "; ".join(ln.strip() for ln in res.stdout.splitlines() if ln.strip())
