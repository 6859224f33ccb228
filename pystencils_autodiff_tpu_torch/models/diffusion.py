"""3D variable-coefficient diffusion: a copy of
``pystencils_autodiff_tpu/models/diffusion.py::diffusion3d_op`` returning
the port's ``AutoDiffOp``.

Flux-form 7-point stencil with face-averaged spatially varying κ:
    u' = u + dt · Σ_d [ κ_{d+½} (u_{+d} − u) − κ_{d−½} (u − u_{−d}) ]
with κ_{d±½} = ½(κ_0 + κ_{±d}).
"""

from __future__ import annotations

import sympy as sp

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["diffusion3d_op", "sharded_diffusion3d"]


@memoize_model
def diffusion3d_op(dt: float = 0.05, dtype="float32",
                   diff_mode="transposed",
                   grad_kappa: bool = True) -> AutoDiffOp:
    """``grad_kappa=False`` declares κ a ``constant_field`` (linear in u)."""
    u = Field("u", 3, dtype=dtype)
    k = Field("kappa", 3, dtype=dtype)
    out = Field("u_next", 3, dtype=dtype)

    half = sp.Rational(1, 2)
    flux = 0
    for d in range(3):
        up = u.neighbor(d, +1)
        dn = u.neighbor(d, -1)
        kp = half * (k.center + k.neighbor(d, +1))
        km = half * (k.center + k.neighbor(d, -1))
        flux += kp * (up - u.center) - km * (u.center - dn)
    return AutoDiffOp([Assignment(out.center, u.center + dt * flux)],
                      op_name="diffusion3d"
                      + ("" if grad_kappa else "_kfrozen"),
                      diff_mode=diff_mode,
                      **({} if grad_kappa else {"constant_fields": [k]}))


def sharded_diffusion3d(mesh, dim_axes=None, dt: float = 0.05,
                        dtype="float32", **kwargs):
    """Config #5: the 3D diffusion op decomposed over a device mesh
    (``parallel.ShardedStencil``); ``dim_axes`` defaults to spatial dim d
    on the mesh's d-th axis.  ``kwargs`` go to ``ShardedStencil``."""
    from ..parallel import ShardedStencil

    if dim_axes is None:
        dim_axes = {d: ax for d, ax in enumerate(mesh.axis_names)}
    op = diffusion3d_op(dt=dt, dtype=dtype)
    return ShardedStencil(op, mesh, dim_axes, **kwargs)
