"""Ops with wide sums (8 or more addends), jax-free, shared by the
``accumulate="dd"`` tests on the CPU (``test_torch_dd.py``, against the JAX
package) and on the card (``test_torch_dd_card.py``, against the plain
version)."""

import sympy as sp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

__all__ = ["nine_point_op", "W9"]

# the isotropic 9-point Laplacian: corners 1/6, edges 2/3, centre -10/3
W9 = {(dy, dx): (sp.Rational(-10, 3) if dy == dx == 0
                 else sp.Rational(1, 6) if dy and dx else sp.Rational(2, 3))
      for dy in (-1, 0, 1) for dx in (-1, 0, 1)}


def nine_point_op(diff_mode: str = "transposed") -> AutoDiffOp:
    """out = Σ w·u (the 9-point Laplacian, rational weights) + a product
    of three reads + a square root: a wide sum whose addends are
    constant·read, a product chain and a non-arithmetic leaf; its
    backward's gradient of u is a wide sum too.  ``diff_mode=
    "transposed-forward"`` gives the staged (TF_MAD) backward."""
    u, k, out = fields("u, kappa, out", 2)
    expr = (sum(w * u[o] for o, w in W9.items())
            + sp.Rational(1, 10) * k[0, 0] * u[0, 0] * u[1, 0]
            + sp.sqrt(k[0, 1] ** 2 + 1))
    return AutoDiffOp([Assignment(out.center, expr)],
                      op_name=f"nine_point_{diff_mode.replace('-', '_')}",
                      diff_mode=diff_mode)
