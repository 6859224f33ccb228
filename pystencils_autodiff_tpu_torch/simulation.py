"""Whole-simulation assembly: sweeps + boundary conditions + time loop: the
port of ``pystencils_autodiff_tpu/simulation.py``.

The functional rebuild of the reference's experimental app-assembly layer
(``graph_datahandling.py`` + ``simulation.py`` → generated waLBerla C++
apps, SURVEY.md §2.1 #13–#15): a ``Simulation`` records an ordered list of
*sweeps* (stencil ops with carry rebinding) and per-field boundary
conditions, then runs them as one differentiable time-stepping function
(``timeloop.run_timeloop``; each sweep through ``op.torch_function``: the
CUDA kernel for CUDA tensors, the plain version for CPU tensors).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .autodiff import AutoDiffOp
from .boundary import BoundaryHandling
from .datahandling import DataHandling
from .timeloop import run_timeloop

__all__ = ["Simulation", "fuse_carry_chain"]

State = Dict[str, torch.Tensor]


class _Sweep:
    def __init__(self, op: AutoDiffOp, carry_map: Dict[str, str], fn):
        self.op = op
        self.carry_map = carry_map
        self.fn = fn


def fuse_carry_chain(sweeps: Sequence[Tuple[AutoDiffOp, Dict[str, str]]],
                     op_name: str = "fused_step") -> AutoDiffOp:
    """Symbolically fuse a sweep chain ``[(op, carry_map), ...]`` into one
    fresh ``AutoDiffOp`` named ``op_name``; its ``_fused_carry`` maps each
    updated state name to the fused op's output holding its next value.

    Later sweeps' reads of state names that earlier sweeps update are
    rewired to the earlier sweep's *output* field and inlined
    (``compose.py``), so the whole multi-sweep step becomes a single kernel
    — one pass over device memory instead of one per sweep, wider halo
    instead (symbolic temporal blocking).

    Only supports chains where each state name is updated by at most one
    sweep and carry sources are op outputs."""
    from .assignment import Assignment, AssignmentCollection
    from .compose import compose_ops, renamed
    from .field import Field

    if not sweeps:
        raise ValueError("no sweeps added")
    fused, carry0 = sweeps[0]
    # running map: state name -> output field (of the fused op) holding its
    # next value
    updated: Dict[str, Field] = {}
    out_fields = {f.name: f for f in fused.forward_output_fields}
    for dst, src in carry0.items():
        if src in out_fields:
            updated[dst] = out_fields[src]
    for nxt, carry in sweeps[1:]:
        # rewire nxt's reads of updated state names to the fused op's
        # output fields so compose_ops inlines them
        sub = {}
        for a in nxt.forward_assignments.all_assignments:
            for acc in a.rhs.atoms(Field.Access):
                tgt = updated.get(acc.field.name)
                if tgt is not None:
                    sub[acc] = Field.Access(tgt, acc.offsets, acc.index)
        if sub:
            coll = nxt.forward_assignments
            nxt = AutoDiffOp(
                AssignmentCollection(
                    [Assignment(a.lhs, a.rhs.xreplace(sub), a.is_accumulation)
                     for a in coll.main_assignments],
                    [Assignment(a.lhs, a.rhs.xreplace(sub))
                     for a in coll.subexpressions]),
                op_name=nxt.op_name + "_rw",
                constant_fields=nxt.constant_fields,
                time_constant_fields=nxt.time_constant_fields,
                diff_mode=nxt.diff_mode)
        # keep_intermediate: earlier sweeps' outputs stay op outputs — the
        # time-loop carry needs them as next-step state
        fused = compose_ops(fused, nxt, keep_intermediate=True)
        out_fields = {f.name: f for f in fused.forward_output_fields}
        for dst, src in carry.items():
            if src in out_fields:
                updated[dst] = out_fields[src]
    if len(sweeps) == 1:
        fused = renamed(fused, op_name)  # never rename the caller's op
    else:
        fused.op_name = op_name
    fused._fused_carry = {dst: f.name for dst, f in updated.items()}
    return fused


class Simulation:
    """Composable multi-sweep simulation.

    Example (elastic velocity–stress leapfrog)::

        sim = Simulation(dh)
        sim.add_boundary_conditions({"vx": "neumann", "vy": "neumann"})
        sim.add_sweep(vel_op,    {"vx": "vx_next", "vy": "vy_next"})
        sim.add_sweep(stress_op, {"sxx": "sxx_next", "syy": "syy_next",
                                  "sxy": "sxy_next"})
        state = sim.run(dh.state(), n_steps=100, checkpoint="sqrt")

    Every sweep runs ``op.torch_function(periodic=periodic)``; the
    tensors' device decides between kernel and plain version.  With a
    mesh (``mesh=``/``dim_axes=``, or the datahandling's) every sweep runs
    as a ``parallel.ShardedStencil`` (halo exchange each step) and the
    boundary conditions on the gathered fields.
    """

    def __init__(self, datahandling: Optional[DataHandling] = None,
                 mesh=None, dim_axes: Optional[Dict[int, str]] = None,
                 periodic: bool = False):
        self.mesh = (mesh if mesh is not None
                     else getattr(datahandling, "mesh", None))
        self.dim_axes = dict(dim_axes if dim_axes is not None
                             else getattr(datahandling, "dim_axes", {}) or {})
        self.dh = datahandling
        self.periodic = periodic
        self.sweeps: List[_Sweep] = []
        self.boundaries: List[BoundaryHandling] = []

    # -- assembly ------------------------------------------------------------

    def add_sweep(self, op: AutoDiffOp, carry_map: Dict[str, str]) -> "Simulation":
        """Append a stencil sweep; ``carry_map`` rebinds op outputs (or other
        inputs) to the state names they update (SURVEY.md §2.1 #14 timeloop
        recording, functional form)."""
        if self.mesh is not None and self.dim_axes:
            from .parallel import ShardedStencil

            fn = ShardedStencil(op, self.mesh, self.dim_axes,
                                periodic=self.periodic)
        else:
            fn = op.torch_function(periodic=self.periodic)
        self.sweeps.append(_Sweep(op, dict(carry_map), fn))
        return self

    def add_boundary_conditions(self, specs: Dict[str, object],
                                ghost=None) -> "Simulation":
        if ghost is None:
            if self.dh is not None:
                ghost = self.dh.ghost
            elif self.sweeps:
                from .ops import forward_program
                ghost = forward_program(self.sweeps[-1].op).ghost
            else:
                raise ValueError("give `ghost` (or add sweeps / datahandling first)")
        self.boundaries.append(BoundaryHandling(ghost, specs))
        return self

    # -- fusion --------------------------------------------------------------

    def fused_op(self, op_name: str = "fused_step") -> AutoDiffOp:
        """The sweep chain fused into one fresh op (``fuse_carry_chain``).
        Boundary conditions are not fused; apply them around the fused
        op."""
        return fuse_carry_chain([(sw.op, sw.carry_map) for sw in self.sweeps],
                                op_name)

    # -- the step ------------------------------------------------------------

    def step_fn(self) -> Callable[[State], State]:
        if not self.sweeps:
            raise ValueError("no sweeps added")
        sweeps = list(self.sweeps)
        boundaries = list(self.boundaries)

        from .parallel.mesh import on_global

        def step(state: State) -> State:
            for bh in boundaries:
                state = {**state, **{n: on_global(partial(bh.apply, n),
                                                  state[n])
                                     for n in bh.specs if n in state}}
            for sw in sweeps:
                in_names = [f.name for f in sw.op.forward_input_fields]
                out_names = [f.name for f in sw.op.forward_output_fields]
                outs = sw.fn(**{n: state[n] for n in in_names})
                if not isinstance(outs, tuple):
                    outs = (outs,)
                env = {**state, **dict(zip(out_names, outs))}
                state = dict(state)
                for dst, src in sw.carry_map.items():
                    state[dst] = env[src]
            return state

        return step

    def run(self, state: State, n_steps: int, checkpoint: str = "none",
            record: Optional[Callable[[State], torch.Tensor]] = None):
        """Advance the state; differentiable w.r.t. any state entry.  The
        datahandling (if any) takes the final state."""
        result = run_timeloop(self.step_fn(), state, n_steps,
                              checkpoint=checkpoint, record=record)
        if self.dh is not None:
            self.dh.update(result[0] if record else result)
        return result
