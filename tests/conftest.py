"""Test harness config: CPU with 8 virtual devices.

Tests run on the CPU backend (fast, deterministic); multi-device sharding tests
use the 8 virtual devices. ``JAX_PLATFORMS`` is honoured when set, so on the GPU
machine ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` runs the
``gpu``-marked tests against the card (the ``gpu_device`` fixture skips them
wherever no CUDA device exists). The platform is also pinned through jax.config,
before any backend initializes, in case jax was imported earlier.
"""
import os
import tempfile

import pytest

# isolate the persistent matrix-harvest cache (io/matrix_cache.py): tests load
# hundreds of synthetic dual-illuminant DNGs, and the auto-harvest side effect
# must never touch the user's real ~/.cache registry
os.environ["PYSP_TPU_MATRIX_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="pysp_matcache_"), "harvested_matrices.json"
)

os.environ["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a CUDA device (run with JAX_PLATFORMS=cuda,cpu on the GPU machine)")
    return gpus[0]


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {jax.device_count()}"


def pytest_configure(config):
    """Build the native decode lib so the LJ92 tests run instead of skipping."""
    import pathlib
    import shutil
    import subprocess

    native = pathlib.Path(__file__).resolve().parent.parent / "native"
    so = native / "libdng_fast.so"
    src = native / "dng_fast.cc"
    if shutil.which("g++") and src.exists() and (
        not so.exists() or so.stat().st_mtime < src.stat().st_mtime
    ):
        subprocess.run(["make", "-C", str(native)], check=False, timeout=300)
