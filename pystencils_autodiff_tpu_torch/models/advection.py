"""Advection schemes, upwind and WENO5: a copy of
``pystencils_autodiff_tpu/models/advection.py`` returning the port's
``AutoDiffOp``.

Conservative advection  u_t + a u_x = 0  (a > 0) along the last spatial
axis:

* ``upwind1_op``  — first-order upwind, 2-point.
* ``weno5_op``    — fifth-order WENO-JS reconstruction of the left-biased
  flux; offsets span [-3, +2] (ghost width 3), and the adjoint saves the
  primal field because the nonlinear weights depend on it.
* ``weno5_rk3_stages`` — SSP-RK3 over WENO5 as a stage list for
  ``ops.fused_stage_chain``.
"""

from __future__ import annotations

import sympy as sp

from ..assignment import Assignment, AssignmentCollection
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["upwind1_op", "weno5_op", "weno5_rk3_stages"]


@memoize_model
def upwind1_op(a: float = 1.0, dt: float = 0.4, dx: float = 1.0,
               dtype="float64") -> AutoDiffOp:
    u = Field("u", 1, dtype=dtype)
    out = Field("u_next", 1, dtype=dtype)
    cfl = a * dt / dx
    return AutoDiffOp(
        [Assignment(out.center, u[0] - cfl * (u[0] - u[-1]))],
        op_name="upwind1")


def _axis_access(u: Field, ndim: int):
    """Accessor ``at(off)`` reading ``u`` offset along the LAST spatial axis
    (zero offsets elsewhere) — lets the 1D scheme run in any rank."""
    if ndim == 1:
        return lambda off: u[off]
    return lambda off: u[(0,) * (ndim - 1) + (off,)]


def _weno5_flux_at(at, shift: int):
    """WENO-JS reconstruction of u at the i+1/2 interface (left-biased,
    a>0), all accesses shifted by ``shift``; ``at(off)`` yields the field
    access."""
    eps = sp.Float(1e-6)
    m3, m2, m1, p0, p1 = (at(shift - 3 + k) for k in range(5))
    # candidate stencils (interface values)
    q0 = sp.Rational(1, 3) * m3 - sp.Rational(7, 6) * m2 + sp.Rational(11, 6) * m1
    q1 = -sp.Rational(1, 6) * m2 + sp.Rational(5, 6) * m1 + sp.Rational(1, 3) * p0
    q2 = sp.Rational(1, 3) * m1 + sp.Rational(5, 6) * p0 - sp.Rational(1, 6) * p1
    # smoothness indicators
    b0 = (sp.Rational(13, 12) * (m3 - 2 * m2 + m1) ** 2
          + sp.Rational(1, 4) * (m3 - 4 * m2 + 3 * m1) ** 2)
    b1 = (sp.Rational(13, 12) * (m2 - 2 * m1 + p0) ** 2
          + sp.Rational(1, 4) * (m2 - p0) ** 2)
    b2 = (sp.Rational(13, 12) * (m1 - 2 * p0 + p1) ** 2
          + sp.Rational(1, 4) * (3 * m1 - 4 * p0 + p1) ** 2)
    a0 = sp.Rational(1, 10) / (eps + b0) ** 2
    a1 = sp.Rational(6, 10) / (eps + b1) ** 2
    a2 = sp.Rational(3, 10) / (eps + b2) ** 2
    s = a0 + a1 + a2
    return (a0 * q0 + a1 * q1 + a2 * q2) / s


def _weno5_euler_rhs(u: Field, cfl, ndim: int):
    """One forward-Euler WENO5 step's rhs: u − cfl (F_{i+1/2} − F_{i−1/2})
    along the last spatial axis."""
    at = _axis_access(u, ndim)
    f_plus = _weno5_flux_at(at, 1)    # interface i+1/2 uses u[i-2..i+2]
    f_minus = _weno5_flux_at(at, 0)   # interface i-1/2 uses u[i-3..i+1]
    return at(0) - cfl * (f_plus - f_minus)


@memoize_model
def weno5_op(a: float = 1.0, dt: float = 0.4, dx: float = 1.0,
             dtype="float64", ndim: int = 1) -> AutoDiffOp:
    """u' = u − (a·dt/dx)(F_{i+1/2} − F_{i−1/2}), F by WENO5-JS, advecting
    along the last spatial axis of an ``ndim``-D domain."""
    u = Field("u", ndim, dtype=dtype)
    out = Field("u_next", ndim, dtype=dtype)
    cfl = a * dt / dx
    rhs = _weno5_euler_rhs(u, cfl, ndim)
    return AutoDiffOp(AssignmentCollection.normalize(
        [Assignment(out.center, rhs)]).new_with_cse(),
        op_name="weno5")


@memoize_model
def _weno5_rk3_ops(a, dt, dx, dtype, ndim):
    cfl = a * dt / dx
    u = Field("u", ndim, dtype=dtype)
    u1 = Field("u_s1", ndim, dtype=dtype)
    u2 = Field("u_s2", ndim, dtype=dtype)
    u1n = Field("u_s1_next", ndim, dtype=dtype)
    u2n = Field("u_s2_next", ndim, dtype=dtype)
    un = Field("u_next", ndim, dtype=dtype)
    atu = _axis_access(u, ndim)

    def stage_op(name, out_f, rhs):
        return AutoDiffOp(AssignmentCollection.normalize(
            [Assignment(out_f.center, rhs)]).new_with_cse(), op_name=name)

    return (stage_op("weno5_rk3_s1", u1n, _weno5_euler_rhs(u, cfl, ndim)),
            stage_op("weno5_rk3_s2", u2n,
                     sp.Rational(3, 4) * atu(0)
                     + sp.Rational(1, 4) * _weno5_euler_rhs(u1, cfl, ndim)),
            stage_op("weno5_rk3_s3", un,
                     sp.Rational(1, 3) * atu(0)
                     + sp.Rational(2, 3) * _weno5_euler_rhs(u2, cfl, ndim)))


def weno5_rk3_stages(a: float = 1.0, dt: float = 0.4, dx: float = 1.0,
                     dtype="float64", ndim: int = 1):
    """SSP-RK3 (Shu–Osher) WENO5 step as a three-stage op sequence for
    ``ops.fused_stage_chain``:

        u_s1 = E(u)                       (E = forward-Euler WENO5 step)
        u_s2 = 3/4 u + 1/4 E(u_s1)
        u    = 1/3 u + 2/3 E(u_s2)

    Returns ``(stages, state_names)``: the ``[(op, carry_map), ...]`` list,
    and the state, which holds ``u`` plus zero-initialised ``u_s1``/``u_s2``
    (overwritten within each cycle before any read)."""
    s1, s2, s3 = _weno5_rk3_ops(a, dt, dx, dtype, ndim)
    stages = [
        (s1, {"u_s1": "u_s1_next"}),
        (s2, {"u_s2": "u_s2_next"}),
        (s3, {"u": "u_next"}),
    ]
    return stages, ["u", "u_s1", "u_s2"]
