"""Polyphase plane split/assembly: exact round trip with the mosaic."""
import numpy as np
import jax.numpy as jnp
import pytest

from pysp_tpu.ops.polyphase import bayer_to_quad, quad_to_bayer


@pytest.mark.parametrize("shape", [(16, 20), (30, 42), (8, 8)])
def test_quad_roundtrip(shape):
    x = jnp.asarray(np.random.default_rng(0).random(shape, np.float32).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(quad_to_bayer(bayer_to_quad(x))), np.asarray(x))
