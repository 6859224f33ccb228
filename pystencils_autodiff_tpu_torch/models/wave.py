"""2D acoustic wave equation and the FWI gradient (BASELINE config #3): the
port of ``pystencils_autodiff_tpu/models/wave.py``.

Leapfrog discretisation of  u_tt = c² ∇²u :

    u_next = 2·u_curr − u_prev + (dt·c)² ∇²u_curr

``c`` (the velocity model) is a ``time_constant_field``: its gradient
accumulates over all time steps.  ``fwi_gradient`` computes
∂‖seismogram − observed‖²/∂c either through the checkpointed time loop of
single steps (``timeloop.run_timeloop``) or, with ``fused_k``, through the
fused k-step chain kernels in both directions (``ops.fused_time_chain``
with ``fused_bwd=True``, whose backward is ``ops.fused_chain_vjp``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from ..assignment import Assignment
from ..autodiff import AutoDiffOp
from ..field import Field
from ._memo import memoize_model
from ..timeloop import make_time_stepper, run_timeloop

__all__ = ["wave_step_op", "wave_simulate", "fwi_gradient", "WAVE_CARRY"]

WAVE_CARRY = {"u_curr": "u_next", "u_prev": "u_curr"}


@memoize_model
def wave_step_op(dt: float = 0.001, dx: float = 1.0,
                 dtype="float32", grad_c: bool = True) -> AutoDiffOp:
    """``grad_c=False`` declares the velocity model a ``constant_field``
    (no ∂/∂c derived): the op is then linear in state, so periodic fused
    value+gradient chains take the twin-chain path
    (``ops.adjoint_chain.transposed_linear_op``).  FWI gradients (∂/∂c)
    need the default ``grad_c=True`` (the two-phase chain kernel)."""
    u = Field("u_curr", 2, dtype=dtype)
    up = Field("u_prev", 2, dtype=dtype)
    c = Field("c", 2, dtype=dtype)
    out = Field("u_next", 2, dtype=dtype)
    lap = (u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]) / (dx * dx)
    rhs = 2 * u[0, 0] - up[0, 0] + (dt * c[0, 0]) ** 2 * lap
    fields_kw = ({"time_constant_fields": [c]} if grad_c
                 else {"constant_fields": [c]})
    return AutoDiffOp([Assignment(out.center, rhs)], op_name="wave_step2d"
                      + ("" if grad_c else "_cfrozen"), **fields_kw)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=16)
def _fwi_chain(dt: float, dx: float, dtype: str, fused_k: int,
               receiver_row: int, periodic: bool):
    """The fused chain of ``fwi_gradient``, built once per configuration:
    building it (programs, hoisting, the backward program, the CUDA
    sources' hashes) costs milliseconds of host time per call."""
    from ..ops.time_chain import fused_time_chain

    return fused_time_chain(wave_step_op(dt=dt, dx=dx, dtype=dtype), fused_k,
                            WAVE_CARRY, periodic=periodic, fused_bwd=True,
                            probes=[("u_curr", receiver_row)])


def wave_simulate(c: torch.Tensor, u0: torch.Tensor, n_steps: int,
                  dt: float = 0.001, dx: float = 1.0,
                  checkpoint: str = "sqrt",
                  record: Optional[Callable[[Dict], torch.Tensor]] = None,
                  fused_k: Optional[int] = None, periodic: bool = False):
    """Run the leapfrog loop from rest (u_prev = u_curr = u0).

    ``fused_k``: advance k steps per fused chain kernel
    (``ops.fused_time_chain``); only without per-step recording, and
    ``n_steps`` must be a multiple of k."""
    op = wave_step_op(dt=dt, dx=dx, dtype=_dtype_name(c))
    state = {"u_curr": u0, "u_prev": u0, "c": c}
    if fused_k:
        if record is not None:
            raise ValueError("fused_k does not support per-step recording")
        if n_steps % fused_k:
            raise ValueError("n_steps must be a multiple of fused_k")
        from ..ops.time_chain import fused_time_chain

        chain = fused_time_chain(op, fused_k, WAVE_CARRY, periodic=periodic)
        return run_timeloop(chain, state, n_steps // fused_k,
                            checkpoint=checkpoint)
    step = make_time_stepper(op, WAVE_CARRY, periodic=periodic)
    return run_timeloop(step, state, n_steps, checkpoint=checkpoint,
                        record=record)


def fwi_gradient(c: torch.Tensor, u0: torch.Tensor, observed: torch.Tensor,
                 receiver_row: int, n_steps: int, dt: float = 0.001,
                 dx: float = 1.0, checkpoint: str = "sqrt",
                 fused_k: Optional[int] = None, periodic: bool = False):
    """``(value, gradient)`` of the FWI misfit
    ``0.5·Σ(seismogram − observed)²`` w.r.t. the velocity model ``c``.

    ``observed``: (n_steps, width) reference seismogram at ``receiver_row``.

    ``fused_k``: both directions through the fused k-step chain kernels —
    the receiver row is recorded inside the forward chain after every stage
    (probe outputs) and the seismogram residual is injected per stage
    inside the two-phase adjoint kernel, so the whole gradient is
    temporally blocked.  It equals the sequential checkpointed gradient.
    """
    c_ = c.detach().requires_grad_()
    if fused_k:
        if n_steps % fused_k:
            raise ValueError("n_steps must be a multiple of fused_k")
        chain = _fwi_chain(dt, dx, _dtype_name(c), fused_k, receiver_row,
                           periodic)

        def misfit(cc):
            state = {"u_curr": u0, "u_prev": u0, "c": cc}
            chunks = []
            for _ in range(n_steps // fused_k):
                state, (probe,) = chain(state)
                chunks.append(probe)
            seis = torch.cat(chunks)
            return 0.5 * torch.sum((seis - observed) ** 2)
    else:
        def record(state):
            return state["u_curr"][receiver_row, :]

        def misfit(cc):
            _, seis = wave_simulate(cc, u0, n_steps, dt=dt, dx=dx,
                                    checkpoint=checkpoint, record=record,
                                    periodic=periodic)
            return 0.5 * torch.sum((seis - observed) ** 2)

    with torch.enable_grad():
        value = misfit(c_)
        (grad,) = torch.autograd.grad(value, c_)
    return value.detach(), grad
