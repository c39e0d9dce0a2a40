"""AHD homogeneity map — the reference's hottest kernel, as a vectorized stencil.

Reference behavior: /root/reference/debayer/ahd_homogeneity_cython.pyx (OpenMP prange
over rows, per-pixel 3x3 window count). Here the same math is 9 shifted compares that
XLA fuses into one elementwise pass.

Semantics preserved exactly, including the kernel's one-sided luminance test
(``L_window - L_ref <= eps`` — not abs; .pyx:54-58).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.stencil import pad_reflect

Array = jnp.ndarray


def homogeneity_map_channels(
    lum: Array, a: Array, b: Array, is_vertical: bool, domain_k: int = 3
) -> Array:
    """Channelwise homogeneity count (keeps the LAB planes un-stacked, as 2D
    planes from the demosaic through the count)."""
    assert domain_k % 2 == 1
    k_pad = domain_k // 2

    lum_p = pad_reflect(lum, k_pad)
    a_p = pad_reflect(a, k_pad)
    b_p = pad_reflect(b, k_pad)

    h, w = lum.shape[-2], lum.shape[-1]

    def window(arr_p: Array, dy: int, dx: int) -> Array:
        return arr_p[..., k_pad + dy : k_pad + dy + h, k_pad + dx : k_pad + dx + w]

    # Adaptive bounds from the two directional neighbors (.pyx:41-51)
    if is_vertical:
        n1 = (window(lum_p, -1, 0), window(a_p, -1, 0), window(b_p, -1, 0))
        n2 = (window(lum_p, 1, 0), window(a_p, 1, 0), window(b_p, 1, 0))
    else:
        n1 = (window(lum_p, 0, -1), window(a_p, 0, -1), window(b_p, 0, -1))
        n2 = (window(lum_p, 0, 1), window(a_p, 0, 1), window(b_p, 0, 1))

    eps_l = jnp.maximum(jnp.abs(lum - n1[0]), jnp.abs(lum - n2[0]))
    eps_c2 = jnp.maximum(
        (a - n1[1]) ** 2 + (b - n1[2]) ** 2,
        (a - n2[1]) ** 2 + (b - n2[2]) ** 2,
    )

    # Three window terms are identically true and skip their checks: the center
    # (deltas are 0 <= eps) and the two directional neighbors that DEFINE eps
    # (n1 - lum <= |lum - n1| <= eps_l holds exactly in f32 — a-b is the exact
    # negation of b-a — and the chroma squares are the eps terms themselves).
    # Bit-identical to checking all 9, one third fewer compares.
    free = {(0, 0), (-1, 0), (1, 0)} if is_vertical else {(0, 0), (0, -1), (0, 1)}
    count = jnp.full_like(lum, 3.0)
    for dy in range(-k_pad, k_pad + 1):
        for dx in range(-k_pad, k_pad + 1):
            if (dy, dx) in free:
                continue
            wl = window(lum_p, dy, dx)
            wa = window(a_p, dy, dx)
            wb = window(b_p, dy, dx)
            # one-sided luminance test, two-sided chroma test (.pyx:54-58)
            ok = ((wl - lum) <= eps_l) & (((wa - a) ** 2 + (wb - b) ** 2) <= eps_c2)
            count = count + ok.astype(jnp.float32)

    return count

