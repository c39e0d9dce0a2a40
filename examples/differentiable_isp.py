"""Differentiable ISP: optimize capture parameters by gradient THROUGH develop.

The entire develop pipeline (demosaic -> WB -> color matrix -> gamma) is a pure
jittable function of the RawFrame pytree, so ``jax.grad`` flows from a loss on
the OUTPUT image back to exposure gain and the white-balance neutral. The
NumPy/cv2 reference (in-place mutation, opaque cv2 calls) structurally cannot
do this; here it is ~30 lines.

Demo: a scene rendered under a known neutral is handed to the ISP with a wrong
neutral and wrong exposure; Adam descent on a gray-world + mean-exposure loss
on the developed sRGB recovers both. The same pattern extends to denoise
strengths, tone parameters, or any other pipeline knob.

Run (CPU or GPU): python -m examples.differentiable_isp
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pysp_tpu.const import QualityDemosaic
from pysp_tpu.core.frame import RawFrame
from pysp_tpu.pipeline.develop import DevelopConfig, develop

# Fast tier: every tier is plain jax.numpy/lax, differentiable end to end.
CFG = DevelopConfig(quality=QualityDemosaic.Fast)


def make_scene(h: int = 256, w: int = 320, seed: int = 0):
    """A mosaic of a smooth gray-world scene under a non-neutral illuminant."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16, w // 16, 3), np.float32)
    rgb = np.asarray(
        jax.image.resize(jnp.asarray(coarse), (h, w, 3), method="cubic")
    )
    rgb = np.clip(0.15 + 0.6 * rgb, 0.0, 1.0)
    neutral_true = np.array([0.55, 1.0, 0.7], np.float32)  # camera WB gains^-1
    bayer = np.empty((h, w), np.float32)
    bayer[0::2, 0::2] = rgb[0::2, 0::2, 0] * neutral_true[0]
    bayer[0::2, 1::2] = rgb[0::2, 1::2, 1]
    bayer[1::2, 0::2] = rgb[1::2, 0::2, 1]
    bayer[1::2, 1::2] = rgb[1::2, 1::2, 2] * neutral_true[2]
    # under-expose by 1.5 stops so the gain parameter has work to do
    return bayer * (2.0 ** -1.5), neutral_true


def develop_with_params(params, frame: RawFrame):
    """The differentiable surface: gain + neutral -> developed sRGB."""
    gain = jnp.exp(params["log_gain"])
    neutral = jnp.concatenate([params["neutral_rb"][:1],
                               jnp.ones((1,), jnp.float32),
                               params["neutral_rb"][1:]])
    f = frame.replace(bayer=frame.bayer * gain, wb_neutral=neutral)
    return develop(f, CFG)


def loss_fn(params, frame: RawFrame):
    out = develop_with_params(params, frame)
    sl = out[8:-8, 8:-8]
    means = jnp.mean(sl, axis=(0, 1))  # per-channel sRGB means
    gray_world = jnp.sum((means - jnp.mean(means)) ** 2)
    exposure = (jnp.mean(means) - 0.5) ** 2
    return gray_world + exposure


def fit(frame: RawFrame, steps: int = 120, learning_rate: float = 5e-2):
    import optax

    params = {
        "log_gain": jnp.zeros(()),
        "neutral_rb": jnp.array([1.0, 1.0], jnp.float32),  # start: no WB
    }
    opt = optax.adam(learning_rate)
    state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    for i in range(steps):
        loss, g = grad_fn(params, frame)
        updates, state = opt.update(g, state)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return params, float(loss)


def main() -> None:
    bayer, neutral_true = make_scene()
    frame = RawFrame.synthetic(bayer, wb_neutral=np.ones(3, np.float32))
    p0 = {"log_gain": jnp.zeros(()), "neutral_rb": jnp.array([1.0, 1.0])}
    l0 = float(loss_fn(p0, frame))
    params, loss = fit(frame)
    nr, nb = (float(v) for v in params["neutral_rb"])
    print(f"loss {l0:.5f} -> {loss:.6f}")
    print(f"recovered neutral R={nr:.3f} B={nb:.3f} "
          f"(scene {neutral_true[0]:.3f}/{neutral_true[2]:.3f}), "
          f"gain {float(jnp.exp(params['log_gain'])):.2f}x "
          f"(under-exposed 2.83x)")


if __name__ == "__main__":
    main()
