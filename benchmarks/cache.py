"""Persistent XLA compilation cache for benchmark scripts (delegates to
``pysp_tpu.utils.runtime.enable_compile_cache``)."""
from __future__ import annotations


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns the cache dir."""
    from pysp_tpu.utils.runtime import enable_compile_cache as enable

    return enable()
