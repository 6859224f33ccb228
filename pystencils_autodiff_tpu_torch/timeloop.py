"""Time stepping with checkpointed adjoints: the port of
``pystencils_autodiff_tpu/timeloop.py``.

* ``make_time_stepper`` turns an ``AutoDiffOp`` into a state→state step
  function (carry rebinding, optional boundary handling) over the op's
  ``torch_function`` — the CUDA kernel for CUDA tensors, the plain version
  for CPU tensors;
* ``run_timeloop`` runs it in a Python loop (JAX: ``lax.scan``) with
  selectable adjoint checkpointing (JAX: ``jax.checkpoint``; here
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``):

  - ``"none"``   — autograd keeps every step's saved tensors (O(n) memory),
  - ``"step"``   — each step is checkpointed (recomputed in the backward),
  - ``"sqrt"``   — chunks of ``isqrt(n)`` steps are checkpointed, the
    remainder runs plain: O(√n) stored carries, one extra forward pass.

Gradients of time-constant fields (e.g. the wave-speed model in FWI)
accumulate over the steps because every step reads the same tensor:
autograd sums its cotangents.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .boundary import BoundaryHandling

__all__ = ["make_time_stepper", "run_timeloop", "Timeloop"]

State = Dict[str, torch.Tensor]


def check_carry_map(op, carry_map: Dict[str, str]) -> None:
    """Each carry target is an op input; each source an output or input."""
    in_names = [f.name for f in op.forward_input_fields]
    out_names = [f.name for f in op.forward_output_fields]
    for dst, src in carry_map.items():
        if dst not in in_names:
            raise ValueError(f"carry target {dst!r} is not an input ({in_names})")
        if src not in out_names and src not in in_names:
            raise ValueError(f"carry source {src!r} is neither output "
                             f"({out_names}) nor input ({in_names})")


def make_time_stepper(op, carry_map: Dict[str, str],
                      boundary: Optional[BoundaryHandling] = None,
                      periodic: bool = False) -> Callable[[State], State]:
    """Build ``step(state) -> state`` from an AutoDiffOp.

    ``carry_map`` gives each forward *input* field its next-step source:
    an op *output* name or another input name (for shifts like
    u_prev ← u_curr).  Unmapped inputs carry through unchanged (constants).

    Example (leapfrog wave)::

        step = make_time_stepper(op, {"u_curr": "u_next", "u_prev": "u_curr"})
    """
    f = op.torch_function(periodic=periodic)
    in_names = [fl.name for fl in op.forward_input_fields]
    out_names = [fl.name for fl in op.forward_output_fields]
    check_carry_map(op, carry_map)

    def step(state: State) -> State:
        if boundary is not None:
            state = {**state, **boundary({n: state[n] for n in in_names
                                          if n in boundary.specs})}
        outs = f(**{n: state[n] for n in in_names})
        if not isinstance(outs, tuple):
            outs = (outs,)
        env = {**state, **dict(zip(out_names, outs))}
        new_state = dict(state)
        for dst in in_names:
            new_state[dst] = env[carry_map.get(dst, dst)]
        return new_state

    step.input_names = in_names
    step.output_names = out_names
    return step


def _loop(step, state: State, n: int, record=None):
    """``n`` steps; returns (final, stacked records or None)."""
    recs = []
    for _ in range(n):
        state = step(state)
        if record is not None:
            recs.append(record(state))
    return state, (torch.stack(recs) if record is not None and recs else None)


def run_timeloop(step: Callable[[State], State], state: State, n_steps: int,
                 checkpoint: str = "none",
                 record: Optional[Callable[[State], torch.Tensor]] = None):
    """Advance ``state`` by ``n_steps`` applications of ``step``.

    ``record(state)`` (optional) is stacked per step and returned as the
    second element — e.g. seismogram extraction at receiver locations.
    The JAX version's ``unroll`` (an XLA while-loop carry-copy knob on the
    TPU) has no counterpart: a Python loop carries no copies.
    """
    if checkpoint not in ("none", "step", "sqrt"):
        raise ValueError("checkpoint must be 'none', 'step' or 'sqrt'")

    if checkpoint == "none":
        final, recs = _loop(step, state, n_steps, record)
    elif checkpoint == "step":
        def ck_step(st):
            return _checkpoint(step, st, use_reentrant=False)
        final, recs = _loop(ck_step, state, n_steps, record)
    else:
        # sqrt: checkpointed chunks of isqrt(n) steps, then the remainder
        chunk = max(1, int(math.isqrt(n_steps)))
        n_chunks, rem = divmod(n_steps, chunk)
        final, parts = state, []
        for _ in range(n_chunks):
            final, r = _checkpoint(_loop, step, final, chunk, record,
                                   use_reentrant=False)
            parts.append(r)
        if rem:
            final, r = _loop(step, final, rem, record)
            parts.append(r)
        recs = torch.cat(parts) if record is not None and parts else None
    return (final, recs) if record is not None else final


class Timeloop:
    """Convenience bundle: stepper + BCs + checkpointing policy;
    ``loop(state, n)`` runs ``n`` steps and is differentiable."""

    def __init__(self, op, carry_map: Dict[str, str],
                 boundary: Optional[BoundaryHandling] = None,
                 checkpoint: str = "none", periodic: bool = False):
        self.step = make_time_stepper(op, carry_map, boundary=boundary,
                                      periodic=periodic)
        self.checkpoint = checkpoint

    def __call__(self, state: State, n_steps: int,
                 record: Optional[Callable[[State], torch.Tensor]] = None):
        return run_timeloop(self.step, state, n_steps,
                            checkpoint=self.checkpoint, record=record)
