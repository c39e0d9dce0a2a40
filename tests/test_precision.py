"""Every matrix product on the device runs at full f32 precision.

A float32 dot at default precision may run in TF32 on a GPU (about three
decimal digits), so each device-side ``dot_general`` in the develop programs
pins ``Precision.HIGHEST``. Walks the jaxpr, sub-jaxprs included.
"""
import jax
import numpy as np
import pytest
from jax import lax
from jax.extend import core

from pysp_tpu import DevelopConfig, QualityDemosaic, RawFrame, develop
from pysp_tpu.pipeline.pipeline import PipelineConfig, develop_pipeline


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(sub, core.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, core.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    return RawFrame.synthetic(
        rng.random((32, 48), np.float32),
        cam_mat=np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32),
        wb_neutral=np.array([0.45, 1.0, 0.62], np.float32),
    )


PROGRAMS = {
    "draft": lambda f: develop(f, DevelopConfig(quality=QualityDemosaic.Draft)),
    "fast": lambda f: develop(f, DevelopConfig(quality=QualityDemosaic.Fast)),
    "best": lambda f: develop(f, DevelopConfig(quality=QualityDemosaic.Best)),
    "config3_heal": lambda f: develop_pipeline(f, PipelineConfig(repair_hot_pixels=True)),
    "config4_hdr": lambda f: develop_pipeline(
        jax.tree_util.tree_map(lambda x: x[None].repeat(3, 0), f),
        PipelineConfig(fuse_hdr=True),
    ),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_device_dots_are_highest_precision(program):
    precisions = _dot_precisions(jax.make_jaxpr(PROGRAMS[program])(_frame()).jaxpr, [])
    assert precisions, "expected the colour-matrix products in the program"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
