"""Phase-field model family, Allen–Cahn and Cahn–Hilliard: a copy of
``pystencils_autodiff_tpu/models/phasefield.py`` returning the port's
``AutoDiffOp``, with ``ginzburg_landau_energy`` on torch tensors.

* **Allen–Cahn** (non-conserved order parameter, gradient flow of the
  Ginzburg–Landau energy E = ∫ κ/2 |∇φ|² + W f(φ)):
      φ' = φ − dt·M·(W f'(φ) − κ ∇²φ),  f(φ) = (φ²−1)²/4, f'(φ) = φ³−φ
* **Cahn–Hilliard** (conserved order parameter, H⁻¹ gradient flow):
      μ  = W f'(φ) − κ ∇²φ              (chemical potential sweep)
      φ' = φ + dt·M·∇²μ                 (conservative update sweep)
  Two sweeps per step: ``cahn_hilliard_stages`` for
  ``ops.fused_stage_chain``.
"""

from __future__ import annotations

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model

__all__ = ["allen_cahn_op", "cahn_hilliard_stages", "chemical_potential_op",
           "ch_update_op", "ginzburg_landau_energy"]


def _lap(f):
    return f[1, 0] + f[-1, 0] + f[0, 1] + f[0, -1] - 4 * f[0, 0]


@memoize_model
def allen_cahn_op(dt: float = 0.05, mobility: float = 1.0,
                  kappa: float = 1.0, well: float = 1.0,
                  dtype="float64") -> AutoDiffOp:
    """One explicit Allen–Cahn step ``phi_next = op(phi)`` (unit spacing)."""
    phi = Field("phi", 2, dtype=dtype)
    out = Field("phi_next", 2, dtype=dtype)
    p = phi[0, 0]
    mu = well * (p ** 3 - p) - kappa * _lap(phi)
    return AutoDiffOp([Assignment(out.center, p - dt * mobility * mu)],
                      op_name="allen_cahn")


@memoize_model
def chemical_potential_op(kappa: float = 1.0, well: float = 1.0,
                          dtype="float64") -> AutoDiffOp:
    """Cahn–Hilliard sweep 1: ``mu = W f'(phi) − κ ∇²phi``."""
    phi = Field("phi", 2, dtype=dtype)
    mu = Field("mu", 2, dtype=dtype)
    p = phi[0, 0]
    return AutoDiffOp(
        [Assignment(mu.center, well * (p ** 3 - p) - kappa * _lap(phi))],
        op_name="ch_mu")


@memoize_model
def ch_update_op(dt: float = 0.01, mobility: float = 1.0,
                 dtype="float64") -> AutoDiffOp:
    """Cahn–Hilliard sweep 2: ``phi_next = phi + dt·M·∇²mu``."""
    phi = Field("phi", 2, dtype=dtype)
    mu = Field("mu", 2, dtype=dtype)
    out = Field("phi_next", 2, dtype=dtype)
    return AutoDiffOp(
        [Assignment(out.center, phi[0, 0] + dt * mobility * _lap(mu))],
        op_name="ch_update")


def cahn_hilliard_stages(dt: float = 0.01, mobility: float = 1.0,
                         kappa: float = 1.0, well: float = 1.0,
                         dtype="float64"):
    """The two Cahn–Hilliard sweeps as a stage list for
    ``ops.fused_stage_chain``: state fields ``phi`` and ``mu``, one
    chemical-potential sweep feeding one conservative update per cycle."""
    return [
        (chemical_potential_op(kappa=kappa, well=well, dtype=dtype),
         {"mu": "mu"}),
        (ch_update_op(dt=dt, mobility=mobility, dtype=dtype),
         {"phi": "phi_next"}),
    ]


def ginzburg_landau_energy(phi, kappa: float = 1.0, well: float = 1.0):
    """Discrete E[φ] = Σ κ/2 |∇φ|² + W (φ²−1)²/4 (periodic differences) —
    the Lyapunov functional Allen–Cahn descends."""
    import torch

    gx = torch.roll(phi, -1, 0) - phi
    gy = torch.roll(phi, -1, 1) - phi
    grad2 = gx ** 2 + gy ** 2
    bulk = well * (phi ** 2 - 1) ** 2 / 4
    return torch.sum(kappa / 2 * grad2 + bulk)
