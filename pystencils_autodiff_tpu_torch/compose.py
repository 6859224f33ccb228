"""Symbolic operator composition (stencil fusion): a copy of
``pystencils_autodiff_tpu/compose.py`` over the port's symbolic layer.

``compose_ops(op1, op2)`` inlines op1's output fields into op2's reads —
shifted appropriately — producing a single fused ``AutoDiffOp``.  One fused
kernel makes one pass over device memory where sequential sweeps make two,
and the fused adjoint comes for free from ``create_backward_assignments``
on the composed collection.

Mathematically: if op2 reads ``w[o]`` and op1 defines ``w[0] ← rhs``, the
fusion substitutes ``shift(rhs, o)`` for ``w[o]``.  Ghost layers compose
(the fused stencil's reach is the Minkowski sum of the two stencils'
reaches), so a fused kernel trades halo width for memory passes — the
symbolic form of temporal blocking.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import sympy as sp

from .assignment import Assignment, AssignmentCollection
from .autodiff import AutoDiffOp, shift_expr
from .field import Field

__all__ = ["compose_ops", "fuse_sweeps"]


def renamed(op: AutoDiffOp, op_name: str) -> AutoDiffOp:
    """A fresh op equal to ``op`` under another name.  Renaming ``op``
    itself would rename it for every caller: model constructors are
    memoized, so their ops are shared."""
    new = AutoDiffOp(op.forward_assignments, op_name=op_name,
                     constant_fields=op.constant_fields,
                     time_constant_fields=op.time_constant_fields,
                     diff_mode=op.diff_mode,
                     diff_fields_prefix=op.diff_fields_prefix,
                     do_common_subexpression_elimination=op.do_cse)
    new._backward = op._backward  # the same derivation, if already made
    return new


def compose_ops(op1: AutoDiffOp, op2: AutoDiffOp,
                op_name: Optional[str] = None,
                keep_intermediate: bool = False,
                do_common_subexpression_elimination: bool = True) -> AutoDiffOp:
    """Fuse two stencil ops: op2 ∘ op1 (op1 runs "first").

    op2's reads of op1's output fields are replaced by op1's (shifted)
    right-hand sides.  ``keep_intermediate=True`` also emits op1's outputs
    from the fused op (costs extra writes; default drops them).

    Constant/time-constant field sets are unioned.
    """
    rhs1: Dict[Field, sp.Expr] = {}
    for a in op1.forward_assignments.inlined_main_assignments():
        if a.lhs.index:
            raise NotImplementedError(
                "composition over index-component outputs not yet supported")
        rhs1[a.lhs.field] = a.rhs

    fused_main = []
    for a in op2.forward_assignments.inlined_main_assignments():
        # op1's right-hand sides read only op1's inputs, so one pass of
        # substitution removes every op1-output access
        mapping = {acc: shift_expr(rhs1[acc.field], acc.offsets)
                   for acc in a.rhs.atoms(Field.Access) if acc.field in rhs1}
        fused_main.append(Assignment(a.lhs, a.rhs.xreplace(mapping)))

    if keep_intermediate:
        fused_main = [Assignment(f.center, r) for f, r in rhs1.items()] + fused_main

    return AutoDiffOp(
        AssignmentCollection(fused_main),
        op_name=op_name or f"{op1.op_name}_then_{op2.op_name}",
        constant_fields=list({*op1.constant_fields, *op2.constant_fields}),
        time_constant_fields=list({*op1.time_constant_fields,
                                   *op2.time_constant_fields}),
        diff_mode=op1.diff_mode,
        do_common_subexpression_elimination=do_common_subexpression_elimination,
    )


def fuse_sweeps(ops: Sequence[AutoDiffOp], op_name: Optional[str] = None,
                **kwargs) -> AutoDiffOp:
    """Left-fold composition of a sweep sequence into one op."""
    if not ops:
        raise ValueError("no ops to fuse")
    if len(ops) == 1:
        return renamed(ops[0], op_name) if op_name else ops[0]
    fused = ops[0]
    for nxt in ops[1:]:
        fused = compose_ops(fused, nxt, **kwargs)
    if op_name:
        fused.op_name = op_name
    return fused
