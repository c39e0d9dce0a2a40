"""Dispatch-amortized device timing.

``timed_loop`` wraps a function in lax.fori_loop with a data dependence between
iterations, dispatches it once for 1 and once for n+1 iterations, and divides the
difference by n: per-dispatch overhead and the host round trip cancel out.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def timed_loop(fn: Callable, *args, iters: int = 8, warmup: bool = True):
    """Per-iteration seconds for ``fn(*args)``, amortized inside one dispatch.

    ``fn`` must return an array (any shape); iterations are chained through a scalar
    accumulator + an input perturbation so XLA cannot collapse the loop.
    """

    def run(n, *xs):
        def body(i, acc):
            eps = (acc * 0.0 + i.astype(jnp.float32)) * 1e-20
            out = fn(*jax.tree_util.tree_map(lambda v: v + eps, xs))
            return acc + jnp.sum(out).astype(jnp.float32) * 1e-20

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    jitted = jax.jit(run, static_argnums=0)

    if warmup:
        # warm BOTH trip counts — each static n is a separate executable
        float(jitted(1, *args))
        float(jitted(iters + 1, *args))

    # one-iteration dispatch to estimate fixed overhead
    t0 = time.time()
    float(jitted(1, *args))
    t_one = time.time() - t0

    t0 = time.time()
    float(jitted(iters + 1, *args))
    t_many = time.time() - t0

    return max((t_many - t_one) / iters, 1e-9)
