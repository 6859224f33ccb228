"""Stencil ops of any rank, jax-free, shared by the rank tests on the CPU
(``test_torch_ranks.py``, against the JAX package) and on the card
(``test_torch_ranks_card.py``, against the plain version)."""

from pystencils_autodiff_tpu_torch import (Assignment, AutoDiffOp, Field,
                                           fields)

__all__ = ["OPS", "kheat_op", "skew_op", "index_op"]


def _unit(nd, d, s):
    return tuple(s if e == d else 0 for e in range(nd))


def kheat_op(nd):
    """κ-heat: u + 0.1·κ·Σ_d (u[+e_d] + u[-e_d] - 2u)."""
    u, k, out = fields("u, kappa, out", nd)
    lap = sum(u[_unit(nd, d, 1)] + u[_unit(nd, d, -1)] - 2 * u.center
              for d in range(nd))
    return AutoDiffOp([Assignment(out.center, u.center
                                  + 0.1 * k.center * lap)],
                      op_name=f"kheat{nd}d")


def skew_op(nd):
    """Nonlinear, a reach of 2 below in dim 0 and offsets in every dim."""
    u, k, out = fields("u, kappa, out", nd)
    far = tuple([-2] + [1] * (nd - 1))
    near = tuple([1] + [-1] * (nd - 1))
    return AutoDiffOp([Assignment(out.center, u[far] * u[near]
                                  + k[_unit(nd, nd - 1, 1)] ** 2 * u.center)],
                      op_name=f"skew{nd}d")


def index_op(nd):
    """Index-dim fields, AoS and SoA, reading across the leading and the
    contiguous dim."""
    v = Field("v", nd, index_shape=(2,))
    w = Field("w", nd, index_shape=(2,), layout="soa")
    o = Field("o", nd, index_shape=(2,))
    return AutoDiffOp([
        Assignment(o.center(0), v[_unit(nd, 0, 1)](1)
                   * w[_unit(nd, nd - 1, -1)](0)),
        Assignment(o.center(1), v.center(0) - w[_unit(nd, 0, -1)](1)),
    ], op_name=f"index{nd}d")


OPS = {"kheat": kheat_op, "skew": skew_op, "index": index_op}
