"""2D/3D heat equation and Laplacian models: copies of
``pystencils_autodiff_tpu/models/heat.py`` returning the port's
``AutoDiffOp`` (the JAX package's ``models`` package imports jax)."""

from __future__ import annotations

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["laplacian_op", "heat_step_op", "laplacian3d_op",
           "heat_step3d_op"]


@memoize_model
def laplacian_op(dtype="float32") -> AutoDiffOp:
    """y = ∇²x (5-point, unit grid spacing)."""
    x = Field("x", 2, dtype=dtype)
    y = Field("y", 2, dtype=dtype)
    return AutoDiffOp(
        [Assignment(y.center,
                    x[1, 0] + x[-1, 0] + x[0, 1] + x[0, -1] - 4 * x[0, 0])],
        op_name="laplacian2d")


@memoize_model
def heat_step_op(dt: float = 0.1, kappa_field: bool = False,
                 dtype="float32") -> AutoDiffOp:
    """u' = u + dt·κ·∇²u — explicit Euler step; κ a field if requested."""
    u = Field("u", 2, dtype=dtype)
    out = Field("u_next", 2, dtype=dtype)
    lap = u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]
    if kappa_field:
        k = Field("kappa", 2, dtype=dtype)
        rhs = u[0, 0] + dt * k[0, 0] * lap
    else:
        rhs = u[0, 0] + dt * lap
    return AutoDiffOp([Assignment(out.center, rhs)], op_name="heat_step2d")


@memoize_model
def laplacian3d_op(dtype="float32") -> AutoDiffOp:
    """y = ∇²x (7-point, unit grid spacing)."""
    x = Field("x", 3, dtype=dtype)
    y = Field("y", 3, dtype=dtype)
    lap = sum(x.neighbor(d, 1) + x.neighbor(d, -1) for d in range(3)) \
        - 6 * x.center
    return AutoDiffOp([Assignment(y.center, lap)], op_name="laplacian3d")


@memoize_model
def heat_step3d_op(dt: float = 0.1, dtype="float32") -> AutoDiffOp:
    """u' = u + dt·∇²u (3D explicit Euler, 7-point)."""
    u = Field("u", 3, dtype=dtype)
    out = Field("u_next", 3, dtype=dtype)
    lap = sum(u.neighbor(d, 1) + u.neighbor(d, -1) for d in range(3)) \
        - 6 * u.center
    return AutoDiffOp([Assignment(out.center, u.center + dt * lap)],
                      op_name="heat_step3d")
