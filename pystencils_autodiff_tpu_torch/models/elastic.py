"""Anisotropic 27-point stencil and staggered-grid elastic updates (BASELINE
config #4): copies of ``pystencils_autodiff_tpu/models/elastic.py``
returning the port's ``AutoDiffOp``.

* ``anisotropic27_op`` — ∇·(A ∇u) for a constant SPD tensor A discretised
  with the full 27-point neighbourhood (cross-derivative corner terms).
* velocity–stress elastic updates on a Virieux staggered grid: velocities
  live on faces (origin ±½), stresses at centres/edges.  Staggering is a
  per-field *origin*, accesses stay integer, so forward/backward
  differences appear as [0]/[−1] or [+1]/[0] pairs depending on which way
  the half-cell shift points.
"""

from __future__ import annotations

import numpy as np
import sympy as sp

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["anisotropic27_op", "elastic_velocity_op", "elastic_stress_op",
           "elastic_stages", "ELASTIC_FIELDS"]

ELASTIC_FIELDS = ("vx", "vy", "sxx", "syy", "sxy")


def anisotropic27_op(A=None, dtype="float32") -> AutoDiffOp:
    """y = ∇·(A∇u), 27-point: axis terms from diag(A), corner terms from
    the off-diagonal mixed derivatives (standard centred discretisation).
    The default tensor's op is built once."""
    if A is None:
        return _anisotropic27_default(dtype)
    return _anisotropic27(np.asarray(A, dtype=np.float64), dtype)


@memoize_model
def _anisotropic27_default(dtype):
    return _anisotropic27(np.array([[1.0, 0.2, 0.1], [0.2, 0.8, 0.15],
                                    [0.1, 0.15, 1.2]]), dtype)


def _anisotropic27(A, dtype) -> AutoDiffOp:
    if not np.allclose(A, A.T):
        raise ValueError("anisotropy tensor must be symmetric")
    u = Field("u", 3, dtype=dtype)
    y = Field("y", 3, dtype=dtype)

    expr = 0
    # diagonal: A_dd * d²u/dx_d²
    for d in range(3):
        expr += A[d, d] * (u.neighbor(d, 1) + u.neighbor(d, -1) - 2 * u.center)
    # off-diagonal: 2*A_de * d²u/dx_d dx_e via corner four-point formula
    for d in range(3):
        for e in range(d + 1, 3):
            def corner(sd, se):
                offs = [0, 0, 0]
                offs[d], offs[e] = sd, se
                return u[tuple(offs)]
            expr += 2 * A[d, e] * sp.Rational(1, 4) * (
                corner(1, 1) - corner(1, -1) - corner(-1, 1) + corner(-1, -1))
    return AutoDiffOp([Assignment(y.center, expr)], op_name="aniso27")


@memoize_model
def elastic_velocity_op(dt: float = 0.001, dx: float = 1.0, rho: float = 1.0,
                        dtype="float32") -> AutoDiffOp:
    """Staggered 2D P-SV velocity update:

        vx(i+½,j) += dt/ρ [ (sxx(i+1,j) − sxx(i,j))/dx + (sxy(i+½,j+½) − sxy(i+½,j−½))/dx ]
        vy(i,j+½) += dt/ρ [ (sxy(i+½,j+½) − sxy(i−½,j+½))/dx + (syy(i,j+1) − syy(i,j))/dx ]

    In integer-offset form (origins carry the half shifts): the sxx
    difference at vx is [+1]−[0]; the sxy difference at vx is [0]−[0,−1].
    """
    vx = Field("vx", 2, dtype=dtype, origin=(0.5, 0.0))
    vy = Field("vy", 2, dtype=dtype, origin=(0.0, 0.5))
    sxx = Field("sxx", 2, dtype=dtype)
    syy = Field("syy", 2, dtype=dtype)
    sxy = Field("sxy", 2, dtype=dtype, origin=(0.5, 0.5))
    vx_n = Field("vx_next", 2, dtype=dtype, origin=(0.5, 0.0))
    vy_n = Field("vy_next", 2, dtype=dtype, origin=(0.0, 0.5))

    a = dt / (rho * dx)
    asm = [
        Assignment(vx_n.center,
                   vx[0, 0] + a * ((sxx[1, 0] - sxx[0, 0])
                                   + (sxy[0, 0] - sxy[0, -1]))),
        Assignment(vy_n.center,
                   vy[0, 0] + a * ((sxy[0, 0] - sxy[-1, 0])
                                   + (syy[0, 1] - syy[0, 0]))),
    ]
    return AutoDiffOp(asm, op_name="elastic_vel")


@memoize_model
def elastic_stress_op(dt: float = 0.001, dx: float = 1.0,
                      lam: float = 2.0, mu: float = 1.0,
                      dtype="float32") -> AutoDiffOp:
    """Staggered 2D P-SV stress update (constant Lamé parameters):

        sxx += dt[(λ+2μ) ∂x vx + λ ∂y vy]      (at centres: vx diff [0]−[−1])
        syy += dt[λ ∂x vx + (λ+2μ) ∂y vy]
        sxy += dt·μ (∂y vx + ∂x vy)             (at edges: forward diffs)
    """
    vx = Field("vx", 2, dtype=dtype, origin=(0.5, 0.0))
    vy = Field("vy", 2, dtype=dtype, origin=(0.0, 0.5))
    sxx = Field("sxx", 2, dtype=dtype)
    syy = Field("syy", 2, dtype=dtype)
    sxy = Field("sxy", 2, dtype=dtype, origin=(0.5, 0.5))
    sxx_n = Field("sxx_next", 2, dtype=dtype)
    syy_n = Field("syy_next", 2, dtype=dtype)
    sxy_n = Field("sxy_next", 2, dtype=dtype, origin=(0.5, 0.5))

    a = dt / dx
    dvx_dx = vx[0, 0] - vx[-1, 0]
    dvy_dy = vy[0, 0] - vy[0, -1]
    dvx_dy = vx[0, 1] - vx[0, 0]
    dvy_dx = vy[1, 0] - vy[0, 0]
    asm = [
        Assignment(sxx_n.center, sxx[0, 0] + a * ((lam + 2 * mu) * dvx_dx + lam * dvy_dy)),
        Assignment(syy_n.center, syy[0, 0] + a * (lam * dvx_dx + (lam + 2 * mu) * dvy_dy)),
        Assignment(sxy_n.center, sxy[0, 0] + a * mu * (dvx_dy + dvy_dx)),
    ]
    return AutoDiffOp(asm, op_name="elastic_stress")


def elastic_stages(dt: float = 0.01, dtype="float32"):
    """The P-SV cycle as a stage list for ``ops.fused_stage_chain``: the
    velocity sweep, then the stress sweep."""
    return [
        (elastic_velocity_op(dt=dt, dtype=dtype),
         {"vx": "vx_next", "vy": "vy_next"}),
        (elastic_stress_op(dt=dt, dtype=dtype),
         {"sxx": "sxx_next", "syy": "syy_next", "sxy": "sxy_next"}),
    ]
