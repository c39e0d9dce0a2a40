"""Process set-up: compile cache, device report, optional dependencies, and
the multi-device dry run's refusal to stand in a CPU mesh for an accelerator."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from pysp_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, JAX_PLATFORMS="cpu")
    full_env.pop("JAX_COMPILATION_CACHE_DIR", None)
    full_env.update(env)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=full_env, cwd=REPO, timeout=300,
    )


_CACHE_PROBE = (
    "import json, jax\n"
    "from pysp_tpu.utils.runtime import enable_compile_cache\n"
    "before = jax.config.jax_compilation_cache_dir\n"
    "got = enable_compile_cache()\n"
    "print(json.dumps([before, got, jax.config.jax_compilation_cache_dir]))\n"
)


@pytest.mark.parametrize("env_dir", [None, "/nonexistent/cache-from-env"])
def test_compile_cache_dir(env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code (JAX
    reads the variable itself); unset, the cache is <checkout>/.jax_cache."""
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    r = _run(_CACHE_PROBE, **env)
    assert r.returncode == 0, r.stderr[-2000:]
    before, got, after = json.loads(r.stdout.strip().splitlines()[-1])
    if env_dir is None:
        assert got == after == os.path.join(REPO, ".jax_cache")
    else:
        assert got == env_dir
        assert after == before == env_dir


def test_device_summary_and_nvidia_smi(monkeypatch):
    summary = runtime.device_summary()
    assert summary == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
    monkeypatch.setenv("PATH", "/nonexistent")
    assert runtime.nvidia_smi_line() is None


_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('flax', 'PIL', 'rawpy'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_import_and_png_without_flax_or_pil(tmp_path):
    """The package imports and writes PNG (native and zlib writers) and TIFF
    with neither flax nor Pillow; .jpg names Pillow in a clear error."""
    code = _BLOCK + (
        "import numpy as np, pysp_tpu\n"
        "from pysp_tpu.io.image_out import save_image, save_png16\n"
        f"d = {str(tmp_path)!r}\n"
        "img = np.linspace(0, 1, 5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3)\n"
        "save_image(d + '/a.png', img)\n"
        "save_image(d + '/b.png', img, fast_png=False)\n"
        "save_png16(d + '/c.png', img)\n"
        "save_image(d + '/d.tif', img)\n"
        "try:\n"
        "    save_image(d + '/e.jpg', img)\n"
        "except RuntimeError as e:\n"
        "    assert 'Pillow' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('jpg without Pillow did not raise')\n"
        "assert not {'flax', 'PIL'} & set(sys.modules)\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]
    for name in ("a.png", "b.png", "c.png", "d.tif"):
        assert (tmp_path / name).stat().st_size > 0


def test_dng_develop_imports_no_optional_package(tmp_path):
    """load_raw -> develop on a DNG never imports rawpy, PIL or flax."""
    from pysp_tpu.io.tiff import write_synthetic_dng

    rng = np.random.default_rng(0)
    dng = tmp_path / "shot.dng"
    dng.write_bytes(write_synthetic_dng(rng.integers(300, 3900, (32, 48)).astype(np.uint16)))
    code = _BLOCK + (
        "import numpy as np\n"
        "from pysp_tpu import load_raw, develop\n"
        f"out = np.asarray(develop(load_raw({str(dng)!r})))\n"
        "assert out.shape == (32, 48, 3) and np.isfinite(out).all()\n"
        "assert not {'flax', 'PIL', 'rawpy'} & set(sys.modules)\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_dryrun_multichip_refuses_cpu_mesh_on_accelerator(monkeypatch):
    """On a GPU backend with too few devices the dry run raises instead of
    quietly running on a virtual CPU mesh."""
    import __graft_entry__ as g

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(g, "_dryrun_in_subprocess", lambda n: pytest.fail("fell back"))
    with pytest.raises(RuntimeError, match="needs 64 gpu devices"):
        g.dryrun_multichip(64)
