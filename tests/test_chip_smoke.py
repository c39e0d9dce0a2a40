"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal of anything
but a GPU, and (``gpu`` marker) the main path against the card."""
import json

import jax
import numpy as np
import pytest

import chip_smoke as cs

TINY = dict(h=64, w=96, burst=(2, 32, 48), hdr_n=3, stream_n=2, reps=1)


def test_refuses_a_cpu_device():
    with pytest.raises(SystemExit, match="not a GPU"):
        cs.require_gpu(jax.devices("cpu")[0])


def test_main_refuses_without_gpu(capsys):
    """Run as a script on a CPU backend it exits non-zero and prints no result."""
    with pytest.raises(SystemExit):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_main_path_tiny_on_cpu(capsys):
    cs.build_native()
    cpu = jax.devices("cpu")[0]
    psnrs, failures = cs.main_path(cpu, cpu, **TINY)
    assert set(psnrs) == set(cs.GATE_OF) and not failures
    # device and reference are the same here: every program matches exactly
    assert all(p == float("inf") for p in psnrs.values()), psnrs
    out = capsys.readouterr().out
    for name in ("best", "fast", "draft", "config3", "config4", "config5"):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"[smoke] {name} {{"))
        rec = json.loads(line.split(" ", 2)[2])
        assert rec["compile_s"] >= 0 and rec["steady_ms_median"] > 0
        assert rec["memory"]["output_size_in_bytes"] > 0


def test_multi_path_on_four_virtual_devices():
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 host devices (tests/conftest.py sets 8)")
    cs.multi_path(devices[:4], h=64, w=96, burst=(4, 32, 48), big=(128, 96), hdr_n=4)


def test_check_enforces_the_gates():
    a = np.full((4, 4, 3), 0.5, np.float32)
    failures = []
    assert cs.check("fast", a, a, failures) == float("inf") and not failures
    b = a.copy()
    b[0, 0] = 0.0  # one pixel 128 levels off: 10*log10(255^2 / (3*128^2/48)) ~ 18 dB
    assert cs.check("fast", b, a, failures) < 20
    assert len(failures) == 1 and "below 50.0 dB" in failures[0]
    with pytest.raises(AssertionError, match="shape"):
        cs.check("best", a, a[:2], failures)


@pytest.mark.parametrize("fast_png", [True, False])
def test_read_png_reads_both_writers(tmp_path, fast_png):
    from pysp_tpu.io.image_out import save_image, to_uint8

    cs.build_native()
    img = np.random.default_rng(1).random((9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_image(path, img, fast_png=fast_png)
    np.testing.assert_array_equal(cs.read_png(path), to_uint8(img))


def test_burst_crops_stay_cfa_aligned():
    from pysp_tpu import RawFrame

    base = RawFrame.synthetic(np.arange(40 * 60, dtype=np.float32).reshape(40, 60))
    burst = cs._burst_frames(base, 4, 16, 24)
    assert burst.bayer.shape == (4, 16, 24) and burst.ev.shape == (4,)
    b = np.asarray(base.bayer)
    for i in range(4):
        y, x = divmod(int(np.asarray(burst.bayer[i, 0, 0])), 60)
        assert y % 2 == 0 and x % 2 == 0
        np.testing.assert_array_equal(np.asarray(burst.bayer[i]), b[y:y + 16, x:x + 24])


@pytest.mark.gpu
def test_main_path_on_gpu(gpu_device):
    """The one-card smoke at a small size, on the card against the CPU."""
    cs.build_native()
    psnrs, failures = cs.main_path(gpu_device, jax.devices("cpu")[0],
                                   h=512, w=768, burst=(4, 256, 384), hdr_n=3,
                                   stream_n=2, reps=2)
    assert set(psnrs) == set(cs.GATE_OF) and not failures, failures
