"""The local-VJP form of a chain's reverse stage.

The gather form (``backward_program``, what the JAX package derives)
computes the cotangent of a state plane at cell y directly: it evaluates
at y the Jacobian of every neighbour's forward step again, so for the
D3Q19 BGK step the backward body is 1,687 steps (7,043 operations a cell)
against the forward's 23 (469).  The local form splits one reverse stage
into two parts:

* **L** — at every write cell x of the forward, the local VJP
  ``w_a(x) = Σ_o ∂out_o(x)/∂a · ĉ_o(x)`` for each read access
  ``a = plane_m(x + o_a)`` of the forward, where ``ĉ_o`` is the cotangent
  of output o (the sum of the cotangents of the state planes it is carried
  into).  It is derived here by reverse accumulation through the forward's
  own subexpressions, then ``sympy.cse`` (not by differentiating the
  inlined outputs): 123 steps and 472 operations for D3Q19.
* **G** — the gather ``cot(y, m) = Σ_{a reads m} w_a(y − o_a)`` (plus the
  cotangents carried through unchanged, and the probe cotangents), which
  reaches as far as the forward does.

Reads of planes that get no gradient (fields the op declares constant) get
no w slot.  The split is exact: it sums the same products in another
order.  ``local_vjp`` builds the L program as a ``StencilProgram`` whose
inputs are the state fields (read at the forward's offsets) and one
adjoint field per forward output (read at the centre), and whose outputs
are one scalar field per w slot (its input slots: the state planes in the
plan's order, then the output planes in the plan's order), so the plain
lowering (``torch_ref``)
and the CUDA printer take it as they take any program.  The plain version
of the whole form is ``ops.adjoint_chain.plain_chain_vjp(ap, form=
"local")``; the z-streaming kernel runs it as ``form="local"``
(``ops.plane_adjoint``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import sympy as sp

from ..adjoint_field import AdjointField
from ..assignment import Assignment, AssignmentCollection
from ..field import Field
from .common import StencilProgram, make_program

__all__ = ["LocalVJP", "local_vjp", "stage_local_vjp", "local_vjp_of",
           "program_cost"]


@dataclass
class LocalVJP:
    """The L program and the G table of one chain's reverse stage."""

    program: StencilProgram
    # per w slot: (state plane index, read offsets)
    slots: List[Tuple[int, Tuple[int, ...]]]
    # per state plane m: the (w slot, offsets) pairs its cotangent gathers
    gather: List[List[Tuple[int, Tuple[int, ...]]]]


def program_cost(steps) -> Tuple[int, int]:
    """(steps, arithmetic operations) of one evaluation of ``steps``."""
    return len(steps), sum(int(sp.count_ops(s.rhs)) for s in steps)


def _accumulate(fwd_steps, seeds):
    """Reverse accumulation through ``fwd_steps``: the adjoint of every
    subexpression (its own step) and of every field read (returned),
    seeded with ``seeds[main target]``."""
    bar: Dict[object, sp.Expr] = {}
    bar_steps = []
    for step in reversed(fwd_steps):
        if step.is_main:
            seed = seeds.get(step.target)
        else:
            if step.target not in bar:
                continue
            seed = sp.Symbol(f"bar_{step.target.name}")
            bar_steps.append(Assignment(seed, bar.pop(step.target)))
        if seed is None:
            continue
        for at in step.atoms:
            d = sp.diff(step.rhs, at)
            if d != 0:
                bar[at] = bar.get(at, sp.Integer(0)) + d * seed
    return bar, bar_steps


def local_vjp(ap) -> LocalVJP:
    """The local-VJP form of ``ap`` (an ``ops.adjoint_chain.AdjointPlan``):
    its forward program differentiated at the write cell."""
    plan = ap.fwd
    return local_vjp_of(plan.program, plan.plane_keys, plan.out_planes,
                        lambda m: ap.grad_slot[m] >= 0,
                        f"{plan.op.op_name}_local_vjp")


def stage_local_vjp(plan, ev, has_grad) -> LocalVJP:
    """The local-VJP form of one stage of an ``ops.stage_chain.StagePlan``:
    the program of stage event ``ev`` differentiated at its write cell.
    Its slots number the program's input planes (``ev.in_planes`` maps
    them to state planes); ``has_grad(n)``: whether state plane n gets a
    gradient (planes that get none get no w slot)."""
    from ..codegen.cuda_printer import input_planes, output_planes

    prog = plan.progs[ev.stage]
    keys = [(f.name, idx) for f, idx in input_planes(prog)]
    return local_vjp_of(prog, keys, output_planes(prog),
                        lambda m: has_grad(ev.in_planes[m]),
                        f"{prog.name}_stage{ev.stage}_local_vjp")


def local_vjp_of(prog, keys, out_planes, has_grad, name) -> LocalVJP:
    """The L program and G table of ``prog``: ``keys`` names its input
    planes (the slots), ``out_planes`` its output planes (``(field,
    index)``), ``has_grad(m)`` whether input slot m gets a w slot."""
    nd = prog.ndim
    adj = {f.name: AdjointField(f) for f in prog.output_fields}
    centre = (0,) * nd
    seeds = {}
    for f, idx in out_planes:
        seeds[Field.Access(f, centre, idx)] = Field.Access(adj[f.name],
                                                           centre, idx)
    bar, bar_steps = _accumulate(prog.steps, seeds)
    reads = sorted((at for at in bar if isinstance(at, Field.Access)),
                   key=lambda a: (keys.index((a.field.name,
                                              tuple(a.index))),
                                  tuple(a.offsets)))
    slots, mains, w_fields = [], [], []
    for a in reads:
        m = keys.index((a.field.name, tuple(a.index)))
        if not has_grad(m):
            continue  # a plane with no gradient (a declared constant)
        w = Field(f"w{len(slots)}", nd, dtype=a.field.dtype)
        w_fields.append(w)
        slots.append((m, tuple(int(o) for o in a.offsets)))
        mains.append(Assignment(w.center, bar[a]))
    subs = [Assignment(s.target, s.rhs) for s in prog.steps
            if not s.is_main] + bar_steps
    coll = AssignmentCollection(mains, subs).new_with_cse(
        symbol_prefix="lv", preserve_subexpressions=True)
    inputs = list(prog.input_fields) + [adj[f.name]
                                        for f in prog.output_fields]
    local = make_program(coll, inputs, w_fields, name=name)
    gather: List[List[Tuple[int, Tuple[int, ...]]]] = [[] for _ in keys]
    for a, (m, offs) in enumerate(slots):
        gather[m].append((a, offs))
    return LocalVJP(program=local, slots=slots, gather=gather)
