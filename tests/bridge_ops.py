"""Ops and inputs the bridge tests share, importing neither jax nor the JAX
package (the card tests run where neither is installed)."""

import numpy as np
import sympy as sp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.ops.common import storage_shape

__all__ = ["mixed_op", "case"]


def mixed_op():
    """Two output fields, index dims (AoS), a constant field and a staged
    (transposed-forward) backward with a materialised Jacobian."""
    v = Field("v", 2, index_shape=(2,))
    w = Field("w", 2, index_shape=(2,))
    k, c, z = Field("k", 2), Field("c", 2), Field("z", 2)
    return AutoDiffOp([
        Assignment(w.center(0), k[1, 0] * sp.exp(v[1, 0](0)) * c[0, 0]
                   - v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) * v[-1, 0](1) + k[0, 1]),
        Assignment(z.center, k[0, 0] * v[0, 0](1) - c[-1, 0] * k[0, -1]),
    ], op_name="mixed_bridge", constant_fields=[c],
        diff_mode="transposed-forward")


def case(op, seed=0, spatial=(24, 20)):
    """Seeded inputs and output cotangents in each field's storage shape."""
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal(storage_shape(f, spatial))
           for f in op.forward_input_fields]
    cots = [rng.standard_normal(storage_shape(f, spatial))
            for f in op.forward_output_fields]
    return ins, cots
