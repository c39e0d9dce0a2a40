"""Gradient-based CA model fitting/refinement (JAX-native additive capability).

No reference equivalent: the reference fits radial models by tile template
matching only (/root/reference/corr_ca/ca_removal.py:15-46,
solver/tiled_template_matcher.py:4-99). Here the *entire correction operator*
— Newton model inversion + bilinear remap — is differentiable almost
everywhere, so model coefficients can be fitted (or template-match fits
refined) by gradient descent on a direct channel-alignment loss. This is a
capability the NumPy/cv2 reference structurally cannot have, and it needs no
detectable ROI features: every gradient pixel contributes signal.

Scope: all three radial models — Poly3 (``Rd = k1·Ru³ + (1−k1)·Ru``), Poly5
(``Rd = Ru + h1·Ru³ + h2·Ru⁵``) and PTLens (``Rd = a·Ru⁴ + b·Ru³ + c·Ru² +
(1−a−b−c)·Ru``) — via one generic traced-coefficient Newton inversion. The
loss aligns a ``moving`` channel against a ``reference`` channel on an
interior window (borders are excluded: clipped samples there are
non-differentiable plateaus). All ops are jittable; the fit runs equally on
CPU or GPU. Use ``refine_ca_models_gradient`` to polish a template-match fit
of any model kind in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.resample import remap_bilinear
from .models import (
    NewtonRaphsonModel,
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
    radius_field,
)

Array = jnp.ndarray


# kind -> (n_params, Rd(Ru, theta), dRd/dRu(Ru, theta), theta -> model,
#          model -> theta). The polynomials mirror models.py's host classes
# exactly (poly3.py:7-46, poly5.py:4-79, ptlens.py:17-92) with the
# coefficients as a traced vector.
def _poly3_fd(u, t):
    return t[0] * u * u * u + (1.0 - t[0]) * u


def _poly3_fdp(u, t):
    return 3.0 * t[0] * u * u + (1.0 - t[0])


def _poly5_fd(u, t):
    r2 = u * u
    return u * (1.0 + r2 * (t[0] + r2 * t[1]))


def _poly5_fdp(u, t):
    r2 = u * u
    return 1.0 + r2 * (3.0 * t[0] + 5.0 * t[1] * r2)


def _ptlens_fd(u, t):
    d = 1.0 - t[0] - t[1] - t[2]
    return u * (d + u * (t[2] + u * (t[1] + u * t[0])))


def _ptlens_fdp(u, t):
    d = 1.0 - t[0] - t[1] - t[2]
    return d + u * (2.0 * t[2] + u * (3.0 * t[1] + u * 4.0 * t[0]))


def _make_poly3(theta: np.ndarray) -> Poly3CorrectionModel:
    m = Poly3CorrectionModel()
    # direct assignment: the constructor clamps initial_k1 to [0, 1] but fitted
    # coefficients may legitimately be negative (pincushion CA)
    m._k1 = float(theta[0])
    return m


_KINDS: Dict[str, Tuple[int, Callable, Callable, Callable]] = {
    "poly3": (1, _poly3_fd, _poly3_fdp, _make_poly3),
    "poly5": (2, _poly5_fd, _poly5_fdp,
              lambda t: Poly5CorrectionModel(float(t[0]), float(t[1]))),
    "ptlens": (3, _ptlens_fd, _ptlens_fdp,
               lambda t: PtLensCorrectionModel(*(float(v) for v in t))),
}


def _kind_of_model(model: NewtonRaphsonModel) -> str:
    if isinstance(model, Poly3CorrectionModel):
        return "poly3"
    if isinstance(model, Poly5CorrectionModel):
        return "poly5"
    if isinstance(model, PtLensCorrectionModel):
        return "ptlens"
    raise TypeError(f"No gradient-fit kind for {type(model).__name__}")


def _undistort_radii(r: Array, theta: Array, kind: str, iterations: int = 8) -> Array:
    """Newton-invert a radial model's map for (possibly traced) coefficients.

    Same iteration as models.NewtonRaphsonModel.estimate_undistorted
    (zeros start, fixed trip count) so a gradient fit converges to the same
    operator the host-fitted model applies."""
    _, fd, fdp, _ = _KINDS[kind]
    theta = jnp.asarray(theta, jnp.float32)

    def body(_, und):
        return und - (fd(und, theta) - r) / fdp(und, theta)

    return jax.lax.fori_loop(0, iterations, body, jnp.zeros_like(r))


def radial_correct_channel(channel: Array, theta: Array, kind: str) -> Array:
    """Apply a radial *correction* (inverse warp) with traced coefficients.

    out(p) = channel(U_theta(p)) where U_theta is the Newton-inverted radial
    map — matches what remove_ca_from_raw's G→channel-grid warp does for a
    host-fitted model, but stays differentiable w.r.t. ``theta``."""
    h, w = channel.shape[-2], channel.shape[-1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    r = radius_field((h, w))
    scale = _undistort_radii(r, theta, kind) / r
    ys = (jnp.arange(h, dtype=jnp.float32) - cy)[:, None]
    xs = (jnp.arange(w, dtype=jnp.float32) - cx)[None, :]
    map_y = jnp.clip(ys * scale + cy, 0, h - 1)
    map_x = jnp.clip(xs * scale + cx, 0, w - 1)
    return remap_bilinear(channel, map_x, map_y)


def poly3_correct_channel(channel: Array, k1: Array) -> Array:
    """Poly3 special case of :func:`radial_correct_channel` (kept API)."""
    return radial_correct_channel(channel, jnp.reshape(k1, (1,)), "poly3")


def radial_alignment_loss(
    theta: Array, moving: Array, reference: Array, kind: str, margin: int = 8
) -> Array:
    """Interior MSE between the theta-corrected ``moving`` and ``reference``."""
    corrected = radial_correct_channel(moving, theta, kind)
    sl = (slice(margin, -margin), slice(margin, -margin))
    d = corrected[sl] - reference[sl]
    return jnp.mean(d * d)


def poly3_alignment_loss(
    k1: Array, moving: Array, reference: Array, margin: int = 8
) -> Array:
    """Poly3 special case of :func:`radial_alignment_loss` (kept API)."""
    return radial_alignment_loss(
        jnp.reshape(k1, (1,)), moving, reference, "poly3", margin
    )


def fit_radial_gradient(
    moving: Array,
    reference: Array,
    kind: str = "poly3",
    theta_init=None,
    steps: int = 80,
    learning_rate: float = 2e-3,
    margin: int = 8,
) -> Tuple[np.ndarray, float]:
    """Fit a radial model's coefficients aligning ``moving`` onto ``reference``.

    Adam descent on the interior alignment MSE; returns ``(theta, final_loss)``.
    The loop is a single jitted lax.scan — one compile, one dispatch. Typical
    use: R (or B) plane vs the G plane of a CFA-split raw, from scratch or
    seeded with a template-match fit's ``model.get_coefficients()``."""
    import optax

    n, _, _, _ = _KINDS[kind]
    if theta_init is None:
        theta_init = np.zeros((n,), np.float32)
    theta0 = jnp.asarray(theta_init, jnp.float32).reshape(n)

    opt = optax.adam(learning_rate)
    grad_fn = jax.value_and_grad(radial_alignment_loss)
    moving = jnp.asarray(moving, jnp.float32)
    reference = jnp.asarray(reference, jnp.float32)

    @jax.jit
    def run(t0):
        state0 = opt.init(t0)

        def step(carry, _):
            t, state = carry
            loss, g = grad_fn(t, moving, reference, kind, margin)
            updates, state = opt.update(g, state)
            return (t + updates, state), loss

        (t, _), losses = jax.lax.scan(step, (t0, state0), None, length=steps)
        return t, losses[-1]

    theta, loss = run(theta0)
    return np.asarray(theta, np.float64), float(loss)


def fit_poly3_gradient(
    moving: Array,
    reference: Array,
    k1_init: float = 0.0,
    steps: int = 80,
    learning_rate: float = 2e-3,
    margin: int = 8,
) -> Tuple[float, float]:
    """Poly3 special case of :func:`fit_radial_gradient` (kept API).

    Returns ``(k1, final_loss)``."""
    theta, loss = fit_radial_gradient(
        moving, reference, "poly3", np.array([k1_init], np.float32),
        steps=steps, learning_rate=learning_rate, margin=margin,
    )
    return float(theta[0]), loss


def fit_ca_models_gradient(
    frame,
    k1_init_r: float = 0.0,
    k1_init_b: float = 0.0,
    steps: int = 80,
    learning_rate: float = 2e-3,
    kind: str = "poly3",
) -> Tuple[NewtonRaphsonModel, NewtonRaphsonModel]:
    """Gradient-fit R→G and B→G radial models straight from a RawFrame.

    Drop-in alternative to compute_ca_lens_models_for_raw: aligns the R and B
    CFA planes against the mean of the two G planes (quarter-res plane space —
    the same grid relationship the template-match solver measures). Returns
    models compatible with remove_ca_from_raw. ``kind`` selects poly3 (the
    default: single coefficient, the best-behaved landscape), poly5 or ptlens;
    the k1 seeds apply to the first coefficient."""
    from ...core.bayer import bayer_to_rgbg

    n, _, _, make = _KINDS[kind]
    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    models = []
    for plane, k0 in ((r0, k1_init_r), (b0, k1_init_b)):
        t0 = np.zeros((n,), np.float32)
        t0[0] = k0
        theta, _ = fit_radial_gradient(
            plane, g, kind, t0, steps=steps, learning_rate=learning_rate
        )
        models.append(make(theta))
    return models[0], models[1]


def refine_ca_models_gradient(
    frame,
    model_r: NewtonRaphsonModel,
    model_b: NewtonRaphsonModel,
    steps: int = 40,
    learning_rate: float = 5e-4,
) -> Tuple[NewtonRaphsonModel, NewtonRaphsonModel]:
    """Polish template-match fits by gradient descent, preserving model kinds.

    Seeds each channel's fit with the host-fitted coefficients (any of the
    three model classes) and runs a short low-rate descent on the direct
    alignment loss — the template matcher quantizes radial shifts at its
    bisection resolution; this removes that quantization. Returns NEW models
    of the same classes (inputs untouched)."""
    from ...core.bayer import bayer_to_rgbg

    r0, g1, b0, g2 = bayer_to_rgbg(frame.bayer)
    g = 0.5 * (g1 + g2)
    out = []
    for plane, model in ((r0, model_r), (b0, model_b)):
        kind = _kind_of_model(model)
        _, _, _, make = _KINDS[kind]
        theta, _ = fit_radial_gradient(
            plane, g, kind, np.asarray(model.get_coefficients(), np.float32),
            steps=steps, learning_rate=learning_rate,
        )
        out.append(make(theta))
    return out[0], out[1]
