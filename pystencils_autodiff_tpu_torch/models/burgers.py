"""2D viscous Burgers system — a coupled nonlinear multi-output model: a
copy of ``pystencils_autodiff_tpu/models/burgers.py`` returning the port's
``AutoDiffOp``.

    u_t + u u_x + v u_y = ν ∇²u
    v_t + u v_x + v v_y = ν ∇²v

Explicit Euler with central differences: two outputs, every term nonlinear
in two fields — exercises coupled-system adjoints (each adjoint reads both
primal fields and both output cotangents).
"""

from __future__ import annotations

import sympy as sp

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["burgers2d_op"]


@memoize_model
def burgers2d_op(nu: float = 0.05, dt: float = 0.05, dx: float = 1.0,
                 dtype="float64") -> AutoDiffOp:
    """One explicit step of 2D viscous Burgers for the velocity ``(u, v)``:
    central advection and a 5-point viscous term, ``nu`` the viscosity."""
    u = Field("u", 2, dtype=dtype)
    v = Field("v", 2, dtype=dtype)
    un = Field("u_next", 2, dtype=dtype)
    vn = Field("v_next", 2, dtype=dtype)
    h = sp.Rational(1, 2) / dx

    def ddx(f):
        return (f[1, 0] - f[-1, 0]) * h

    def ddy(f):
        return (f[0, 1] - f[0, -1]) * h

    def lap(f):
        return (f[1, 0] + f[-1, 0] + f[0, 1] + f[0, -1] - 4 * f[0, 0]) / dx ** 2

    adv_u = u[0, 0] * ddx(u) + v[0, 0] * ddy(u)
    adv_v = u[0, 0] * ddx(v) + v[0, 0] * ddy(v)
    return AutoDiffOp([
        Assignment(un.center, u[0, 0] + dt * (nu * lap(u) - adv_u)),
        Assignment(vn.center, v[0, 0] + dt * (nu * lap(v) - adv_v)),
    ], op_name="burgers2d")
