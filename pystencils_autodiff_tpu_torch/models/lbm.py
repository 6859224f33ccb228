"""Lattice-Boltzmann (BGK) model family: a copy of
``pystencils_autodiff_tpu/models/lbm.py`` returning the port's
``AutoDiffOp``, with ``macroscopic`` on torch tensors.

Pull-scheme step:  f_i'(x) = f̂_i + ω (f_i^eq(ρ, u) − f̂_i),
                   f̂_i(x) = f_i(x − c_i)                (streaming reads)
                   ρ = Σ_i f̂_i,  ρ u = Σ_i c_i f̂_i
                   f_i^eq = w_i ρ (1 + 3 c_i·u + 9/2 (c_i·u)² − 3/2 u²)

The adjoint is derived symbolically, including the nonlinear equilibrium
terms and the 1/ρ divisions (the saved-primal machinery handles them).
"""

from __future__ import annotations

import sympy as sp

from ..assignment import Assignment, AssignmentCollection
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["D2Q9_VELOCITIES", "D2Q9_WEIGHTS", "d2q9_bgk_op", "macroscopic",
           "D3Q19_VELOCITIES", "D3Q19_WEIGHTS", "d3q19_bgk_op", "bgk_op"]

D2Q9_VELOCITIES = [
    (0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (-1, -1), (1, -1), (-1, 1),
]
_w0, _ws, _wd = sp.Rational(4, 9), sp.Rational(1, 9), sp.Rational(1, 36)
D2Q9_WEIGHTS = [_w0, _ws, _ws, _ws, _ws, _wd, _wd, _wd, _wd]

# D3Q19: rest + 6 face neighbours + 12 edge neighbours
D3Q19_VELOCITIES = (
    [(0, 0, 0)]
    + [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    + [(1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
       (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
       (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1)]
)
D3Q19_WEIGHTS = ([sp.Rational(1, 3)] + [sp.Rational(1, 18)] * 6
                 + [sp.Rational(1, 36)] * 12)


def bgk_op(velocities, weights, omega: float = 1.7, dtype="float64",
           layout: str = "aos", op_name: str = "bgk") -> AutoDiffOp:
    """Fused stream+collide BGK step for an arbitrary velocity set:
    ``f_out = op(f)``.

    ``f`` is a d-dimensional field with index_shape (Q,), d inferred from
    the velocity tuples.  Ghost layers are (1,1) per dim (the streaming
    pull); apply bounce-back fills between steps (``boundary.py``, or the
    chains' ``boundary=``).  ``layout="soa"`` stores the distribution
    component-major — tensors are ``(Q, *spatial)``."""
    return _bgk(tuple(tuple(int(c) for c in v) for v in velocities),
                tuple(sp.nsimplify(w) for w in weights), float(omega),
                str(dtype), layout, op_name)


@memoize_model
def _bgk(velocities, weights, omega, dtype, layout, op_name) -> AutoDiffOp:
    nd = len(velocities[0])
    q = len(velocities)
    f = Field("f", nd, index_shape=(q,), dtype=dtype, layout=layout)
    f_out = Field("f_out", nd, index_shape=(q,), dtype=dtype, layout=layout)

    # streaming reads: component i pulled from x - c_i
    f_in = [f[tuple(-c for c in ci)](i) for i, ci in enumerate(velocities)]

    rho = sp.Symbol("rho")
    u = [sp.Symbol(f"u{d}") for d in range(nd)]
    subexprs = [Assignment(rho, sum(f_in, sp.Integer(0)))]
    for d in range(nd):
        subexprs.append(Assignment(
            u[d], sum((ci[d] * fi for ci, fi in zip(velocities, f_in)),
                      sp.Integer(0)) / rho))
    u2 = sum(ud * ud for ud in u)
    mains = []
    for i, (ci, w, fi) in enumerate(zip(velocities, weights, f_in)):
        cu = sum(c * ud for c, ud in zip(ci, u))
        feq = w * rho * (1 + 3 * cu + sp.Rational(9, 2) * cu ** 2
                         - sp.Rational(3, 2) * u2)
        mains.append(Assignment(f_out.center(i), fi + omega * (feq - fi)))

    return AutoDiffOp(AssignmentCollection(mains, subexprs), op_name=op_name)


def d2q9_bgk_op(omega: float = 1.7, dtype="float64",
                compressible: bool = True, layout: str = "aos") -> AutoDiffOp:
    """D2Q9 fused stream+collide BGK step (see :func:`bgk_op`)."""
    return bgk_op(D2Q9_VELOCITIES, D2Q9_WEIGHTS, omega=omega, dtype=dtype,
                  layout=layout, op_name="d2q9_bgk")


def d3q19_bgk_op(omega: float = 1.7, dtype="float64",
                 layout: str = "aos") -> AutoDiffOp:
    """D3Q19 fused stream+collide BGK step (19-component distribution on a
    3D grid)."""
    return bgk_op(D3Q19_VELOCITIES, D3Q19_WEIGHTS, omega=omega, dtype=dtype,
                  layout=layout, op_name="d3q19_bgk")


def macroscopic(f, layout: str = "aos", velocities=None):
    """Density and velocity fields from a distribution tensor — spatial
    shape + (Q,) for the default AoS layout, (Q,) + spatial for
    ``layout="soa"``.  Returns ``(rho, u_0, ..., u_{d-1})``; the velocity
    set defaults to D2Q9."""
    if velocities is None:
        velocities = D2Q9_VELOCITIES
    nd = len(velocities[0])
    axis = 0 if layout == "soa" else -1

    def comp(i):
        return f[i] if layout == "soa" else f[..., i]

    rho = f.sum(dim=axis)
    us = [sum(c[d] * comp(i) for i, c in enumerate(velocities) if c[d])
          / rho for d in range(nd)]
    return (rho, *us)
