"""RawFrame / DevelopedImage as plain frozen dataclasses registered as pytrees.

Device state (pixels, matrices, scalars) are leaves; the behavioural switches
(HDR flag, source pattern, WB state) are static meta fields, so jit specialises
on them and they never become tracers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysp_tpu.const import BayerPattern
from pysp_tpu.core.frame import DevelopedImage, RawFrame


def _frame(h=8, w=12, **kw):
    return RawFrame.synthetic(np.arange(h * w, dtype=np.float32).reshape(h, w) / (h * w), **kw)


def test_replace_returns_new_frozen_frame():
    f = _frame()
    g = f.replace(bayer=f.bayer * 2, is_hdr=True)
    assert g is not f and g.is_hdr and not f.is_hdr
    np.testing.assert_allclose(np.asarray(g.bayer), 2 * np.asarray(f.bayer))
    assert g.cam_mat is f.cam_mat
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.is_hdr = True


def test_flatten_keeps_static_fields_out_of_the_leaves():
    f = _frame(is_hdr=True, source_pattern=BayerPattern.Bggr)
    leaves, treedef = jax.tree_util.tree_flatten(f)
    assert len(leaves) == 6  # bayer, cam_mat, cam_white, wb_neutral, ev, lim_sat
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.is_hdr and back.source_pattern == BayerPattern.Bggr
    img = DevelopedImage(
        image=jnp.zeros((2, 2, 3)), wb_coeff=jnp.ones(3), cam_mat=jnp.eye(3),
        cam_white=jnp.ones(3), ev=jnp.zeros(()), wb_applied=False,
    )
    img_leaves, img_def = jax.tree_util.tree_flatten(img)
    assert len(img_leaves) == 5
    assert jax.tree_util.tree_unflatten(img_def, img_leaves).wb_applied is False


def test_static_fields_are_part_of_the_jit_cache_key():
    traces = []

    @jax.jit
    def fn(frame):
        traces.append(frame.is_hdr)
        # a static field is a Python value inside the trace, never a tracer
        return frame.bayer * (2.0 if frame.is_hdr else 1.0)

    f = _frame()
    a = fn(f)
    fn(f.replace(bayer=f.bayer + 1))  # same static fields: cached
    b = fn(f.replace(is_hdr=True))    # new static value: retraced
    assert traces == [False, True]
    np.testing.assert_allclose(np.asarray(b), 2 * np.asarray(a))


def test_vmap_over_a_stacked_burst():
    frames = [_frame(ev=10.0 + i) for i in range(3)]
    burst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
    assert burst.bayer.shape == (3, 8, 12) and burst.ev.shape == (3,)
    out = jax.vmap(lambda f: f.bayer.sum() + f.ev)(burst)
    want = [float(np.asarray(f.bayer).sum() + 10.0 + i) for i, f in enumerate(frames)]
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-6)
