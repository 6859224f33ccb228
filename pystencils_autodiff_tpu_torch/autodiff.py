"""Reverse-mode adjoint derivation for stencil assignment collections, and
``AutoDiffOp`` for PyTorch.

The symbolic half of ``pystencils_autodiff_tpu/autodiff.py``, copied over
the port's own ``field``/``assignment``/``adjoint_field`` modules (the port
imports nothing of the JAX package): ``create_backward_assignments``
symbolically transposes a (possibly nonlinear, variable-coefficient)
stencil operator, and ``AutoDiffOp`` bundles the forward and backward
assignment collections with the field classification.  Its one lowering
entry point is ``torch_function``.

The key correctness invariant (SURVEY.md §5.2): transposition turns the
backward *scatter* into a *gather* — every adjoint output cell is written by
exactly one assignment, so the backward kernels are embarrassingly parallel
and need no atomics.

Mathematical statement.  For forward assignments ``w_a[0] := rhs_a`` with
read accesses ``f[o]``, the adjoint of input field ``f`` at the cell centre
is the gather

    f̂[0] = Σ_a Σ_o  shift(∂rhs_a/∂f[o], −o) · ŵ_a[−o]

where ``shift(e, s)`` translates every field access in ``e`` by ``s``
(reference ``_autodiff.py`` ≈L150, SURVEY.md §3.1).  Nonlinear and
variable-coefficient terms are handled because ∂rhs/∂f[o] may itself contain
field accesses, which are shifted along.

Diff modes (parity with the reference's ``DiffModes``):

* ``transposed`` — shift each Jacobian entry by ``−o`` and multiply by the
  shifted adjoint access, all fused into ONE gather assignment per adjoint
  output (operator-transposition order).
* ``transposed-forward`` (``TF_MAD``) — differentiate first, then evaluate
  the transposed operator as a forward stencil (reference ``_autodiff.py``
  ≈L220, SURVEY.md §3.1): every variable-coefficient Jacobian entry
  ``∂rhs_a/∂f[o]`` is MATERIALISED as a Jacobian field assignment evaluated
  at center-relative positions in the forward frame (stage A), and the
  gather stage reads those fields at ``−o`` like a constant-coefficient
  forward stencil (stage B) — a ``StagedAssignmentCollection`` lowered as
  two passes.  Constant Jacobian entries stay inline, so purely
  constant-coefficient stencils collapse to a single stage.

The two constructions are *structurally different programs* (different
kernels, different intermediate storage) computing the same mathematical
adjoint; the upstream equivalence tests ("both modes produce equivalent
backward operators", SURVEY.md §4 test_tfmad) are therefore real acceptance
tests in ``tests/test_tfmad.py``.
"""

from __future__ import annotations

import collections
from enum import Enum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import sympy as sp

from .adjoint_field import DEFAULT_DIFF_PREFIX, AdjointField
from .assignment import (Assignment, AssignmentCollection, AssignmentsLike,
                         StagedAssignmentCollection)
from .field import Field

__all__ = [
    "DiffModes",
    "create_backward_assignments",
    "create_tangent_assignments",
    "tangent_op",
    "get_jacobian_of_assignments",
    "AutoDiffOp",
    "AutoDiffKernelPair",
]

class DiffModes(str, Enum):
    """How the backward assignments are constructed (reference ≈L20)."""

    TRANSPOSED = "transposed"
    TF_MAD = "transposed-forward"

    @staticmethod
    def coerce(mode) -> "DiffModes":
        if isinstance(mode, DiffModes):
            return mode
        return DiffModes(str(mode))


def shift_expr(expr: sp.Expr, shift: Tuple[int, ...]) -> sp.Expr:
    """Translate every field access in ``expr`` by ``shift``."""
    if all(s == 0 for s in shift):
        return expr
    mapping = {a: a.shifted(shift) for a in expr.atoms(Field.Access)}
    return expr.xreplace(mapping)


def _neg(offsets: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(-o for o in offsets)


def _coerce_fields(fields: Iterable) -> List[Field]:
    out = []
    for f in fields or ():
        if isinstance(f, Field.Access):
            f = f.field
        if not isinstance(f, Field):
            raise TypeError(f"expected Field, got {type(f)}")
        out.append(f)
    return out


def create_backward_assignments(
    forward_assignments: AssignmentsLike,
    diff_fields_prefix: str = DEFAULT_DIFF_PREFIX,
    time_constant_fields: Sequence[Field] = (),
    constant_fields: Sequence[Field] = (),
    diff_mode: "DiffModes | str" = DiffModes.TRANSPOSED,
    do_common_subexpression_elimination: bool = True,
) -> AssignmentCollection:
    """Derive the adjoint (backward) assignments of a forward stencil.

    Parameters mirror the reference's ``create_backward_assignments``
    (``_autodiff.py`` ≈L40, SURVEY.md §3.1):

    * ``constant_fields`` — fields to *not* differentiate (no adjoint).
    * ``time_constant_fields`` — fields constant across a time loop whose
      adjoint assignments accumulate (``+=``) instead of overwrite, so the
      gradient sums over time steps.
    * ``diff_mode`` — ``'transposed'`` or ``'transposed-forward'``; see
      module docstring.
    """
    mode = DiffModes.coerce(diff_mode)
    coll = AssignmentCollection.normalize(forward_assignments)
    main = coll.main_assignments
    if not main:
        raise ValueError("no field assignments to differentiate")

    # Chain rule through the subexpression DAG instead of differentiating
    # fully-inlined expressions: for wide ops (D3Q19: 19 outputs x 19 reads
    # through rho/u subexpressions) sp.diff over the inlined trees is
    # O(outputs x reads x tree size) — tens of seconds — while the partials
    # of the *uninlined* assignments are all small.  ``sub_total[s][acc]``
    # is the total derivative ds/d(acc), expressed over subexpression
    # symbols; Jacobian entries stay symbol-bearing all the way into the
    # backward collection (TRANSPOSED mode), whose subexpressions are the
    # forward ones plus *shifted copies* (one tiny definition per
    # (subexpression, used shift) pair) — the whole pipeline (derive, CSE,
    # lambdify, in-kernel evaluation) then works on compact DAGs.
    inline_map: Dict[sp.Symbol, sp.Expr] = {}
    for sub in coll.subexpressions:
        inline_map[sub.lhs] = sub.rhs.xreplace(inline_map)
    sub_def_map: Dict[sp.Symbol, sp.Expr] = {s.lhs: s.rhs
                                             for s in coll.subexpressions}
    sub_total: Dict[sp.Symbol, Dict[Field.Access, sp.Expr]] = {}
    for sub in coll.subexpressions:
        deps = [s for s in sub_total if sub.rhs.has(s)]
        entry: Dict[Field.Access, sp.Expr] = {
            acc: sp.diff(sub.rhs, acc)
            for acc in sub.rhs.atoms(Field.Access)}
        for s in deps:
            partial = sp.diff(sub.rhs, s)
            for acc, d in sub_total[s].items():
                entry[acc] = entry.get(acc, sp.Integer(0)) + partial * d
        sub_total[sub.lhs] = entry

    def total_reads(rhs: sp.Expr) -> List[Field.Access]:
        accs = set(rhs.atoms(Field.Access))
        for s in sub_total:
            if rhs.has(s):
                accs.update(sub_total[s])
        return sorted(accs, key=sp.default_sort_key)

    def total_diff(rhs: sp.Expr, acc: Field.Access) -> sp.Expr:
        """d(rhs)/d(acc) through the subexpression chain — compact,
        symbol-bearing (NOT inlined)."""
        d = sp.diff(rhs, acc)
        for s in sub_total:
            if rhs.has(s) and acc in sub_total[s]:
                d = d + sp.diff(rhs, s) * sub_total[s][acc]
        return d

    # Shifted-subexpression machinery: shifting an expression that
    # references subexpression symbols replaces each symbol by a shifted
    # twin whose definition is the shifted (still uninlined) forward
    # definition — one xreplace of a SMALL expression per (sub, shift).
    shifted_syms: Dict[Tuple[sp.Symbol, Tuple[int, ...]], sp.Symbol] = {}
    shifted_defs: List[Assignment] = []

    def _shift_sym(s: sp.Symbol, shift: Tuple[int, ...]) -> sp.Symbol:
        key = (s, shift)
        if key in shifted_syms:
            return shifted_syms[key]
        tag = "_".join(f"m{-o}" if o < 0 else str(o) for o in shift)
        ns = sp.Symbol(f"{s.name}__s{tag}")
        shifted_syms[key] = ns
        # nested dependencies append their definitions first (topo order)
        shifted_defs.append(Assignment(ns, _shift_with_subs(sub_def_map[s],
                                                            shift)))
        return ns

    def _shift_with_subs(expr: sp.Expr, shift: Tuple[int, ...]) -> sp.Expr:
        if all(x == 0 for x in shift):
            return expr
        mapping: Dict[object, object] = {a: a.shifted(shift)
                                         for a in expr.atoms(Field.Access)}
        mapping.update({s: _shift_sym(s, shift)
                        for s in sub_def_map if expr.has(s)})
        return expr.xreplace(mapping)

    constant = set(_coerce_fields(constant_fields))
    time_constant = set(_coerce_fields(time_constant_fields))
    written_fields = {a.lhs.field for a in main}

    # Adjoint fields for outputs (read by bwd) and inputs (written by bwd).
    adjoint: Dict[Field, AdjointField] = {}

    def adj(field: Field) -> AdjointField:
        if field not in adjoint:
            adjoint[field] = AdjointField(field, diff_fields_prefix)
        return adjoint[field]

    # Group contribution terms per adjoint unknown (field, index component).
    contributions: "collections.OrderedDict[Tuple[Field, Tuple[int, ...]], List[sp.Expr]]" = (
        collections.OrderedDict()
    )
    # TF_MAD: materialised Jacobian-field assignments (stage A).
    jac_stage: List[Assignment] = []
    jac_fields: Dict[str, Field] = {}

    def _off_tag(offsets: Tuple[int, ...], index: Tuple[int, ...]) -> str:
        parts = [f"m{-o}" if o < 0 else str(o) for o in offsets]
        parts += [f"i{i}" for i in index]
        return "_".join(parts)

    for fwd in main:
        w_acc = fwd.lhs  # centre access of the written field
        read_accesses = total_reads(fwd.rhs)
        for ra in read_accesses:
            if ra.field in constant:
                continue
            if ra.field in written_fields and ra.field != w_acc.field:
                # Chained outputs (one assignment reading another's output
                # field) would need assignment-level reverse propagation;
                # the reference's model is: outputs are written once, inputs
                # are distinct.  Fail here at derivation time instead of
                # deep inside lowering with a confusing error about the
                # adjoint field.  Inline the producer to differentiate
                # chains.
                raise NotImplementedError(
                    f"assignment writing {w_acc.field.name!r} reads "
                    f"{ra} — an output of another assignment in this "
                    f"collection. Chained-output reads are not supported "
                    f"by the adjoint derivation; inline the producing "
                    f"assignment first.")
            jac = total_diff(fwd.rhs, ra)
            if jac == 0:
                continue
            inv = _neg(ra.offsets)
            w_adj = Field.Access(adj(w_acc.field), inv, w_acc.index)
            is_variable = bool(jac.atoms(Field.Access)) or any(
                jac.has(s) for s in sub_def_map)
            if mode is DiffModes.TRANSPOSED or not is_variable:
                # shift Jacobian entry into the adjoint (gather) frame, then
                # multiply by the transposed adjoint read.  Constant entries
                # shift to themselves, so TF_MAD uses this path for them too.
                term = _shift_with_subs(jac, inv) * w_adj
            else:
                # TF_MAD: materialise the variable-coefficient Jacobian
                # entry as a field evaluated at center-relative positions in
                # the FORWARD frame (stage A); the gather reads it at −o
                # like a constant-coefficient forward stencil (stage B).
                # Stage-A assignments are inlined (access-only) — the staged
                # collection carries no symbol environment across stages.
                jname = (f"jac_{w_acc.field.name}"
                         f"{'_' + _off_tag((), w_acc.index) if w_acc.index else ''}"
                         f"_{ra.field.name}_{_off_tag(ra.offsets, ra.index)}")
                if jname not in jac_fields:
                    J = Field(jname, ra.field.spatial_dimensions,
                              dtype=ra.field.dtype)
                    jac_fields[jname] = J
                    jac_stage.append(Assignment(J.center,
                                                jac.xreplace(inline_map)))
                term = Field.Access(jac_fields[jname], inv, ()) * w_adj
            key = (ra.field, ra.index)
            contributions.setdefault(key, []).append(term)

    backward = []
    for (field, index), terms in contributions.items():
        lhs = Field.Access(adj(field), (0,) * field.spatial_dimensions, index)
        rhs = sp.Add(*terms)
        backward.append(Assignment(lhs, rhs,
                                   is_accumulation=field in time_constant))

    # Subexpressions of the backward collection: the forward definitions
    # that are still referenced (transitively) plus the shifted twins, in
    # dependency order (originals never reference shifted symbols).
    needed: set = set()
    stack = [s for a in backward for s in sub_def_map if a.rhs.has(s)]
    stack += [s for a in shifted_defs for s in sub_def_map if a.rhs.has(s)]
    while stack:
        s = stack.pop()
        if s in needed:
            continue
        needed.add(s)
        stack.extend(t for t in sub_def_map if sub_def_map[s].has(t))
    bwd_subs = ([s for s in coll.subexpressions if s.lhs in needed]
                + shifted_defs)

    if jac_stage:
        result = StagedAssignmentCollection(
            [AssignmentCollection(jac_stage),
             AssignmentCollection(backward, bwd_subs)])
    else:
        result = AssignmentCollection(backward, bwd_subs)
    if do_common_subexpression_elimination:
        result = result.new_with_cse(preserve_subexpressions=True)
    return result


def create_tangent_assignments(
    forward_assignments: AssignmentsLike,
    tangent_fields: Dict[Field, Field],
    output_fields: Dict[Field, Field],
) -> AssignmentCollection:
    """The tangent-linear program of a forward stencil: ``T(x, ẋ) = J(x)·ẋ``.

    For each main assignment ``w := rhs`` the tangent ``ẇ := Σ_acc
    ∂rhs/∂acc · ẋ[acc]`` over the accesses ``acc`` of the fields in
    ``tangent_fields`` (each mapped to its tangent field, read at the same
    offset and index), through the subexpression chain: every
    subexpression ``s`` that depends on a tangent field gains a twin
    ``s__dot`` (its own tangent, built the same way), so the program stays
    as compact as the forward.  ``output_fields`` maps each written field
    to its tangent output; a main assignment whose tangent is 0 is left
    out.  The result is an ordinary stencil collection: the forward's
    subexpressions, their tangents, one main assignment per nonzero
    tangent output."""
    coll = AssignmentCollection.normalize(forward_assignments)
    if any(a.is_accumulation for a in coll.main_assignments):
        raise NotImplementedError(
            "the tangent-linear program of an accumulating forward "
            "assignment (+=) is not derived")
    dots: Dict[sp.Symbol, sp.Symbol] = {}

    def tangent(expr: sp.Expr) -> sp.Expr:
        terms = []
        for acc in sorted(expr.atoms(Field.Access), key=sp.default_sort_key):
            if acc.field in tangent_fields:
                d = sp.diff(expr, acc)
                if d != 0:
                    terms.append(d * Field.Access(tangent_fields[acc.field],
                                                  acc.offsets, acc.index))
        for sym, dot in dots.items():
            if expr.has(sym):
                d = sp.diff(expr, sym)
                if d != 0:
                    terms.append(d * dot)
        return sp.Add(*terms)

    subs: List[Assignment] = []
    for sub in coll.subexpressions:
        subs.append(sub)
        t = tangent(sub.rhs)
        if t != 0:
            dots[sub.lhs] = sp.Symbol(f"{sub.lhs.name}__dot")
            subs.append(Assignment(dots[sub.lhs], t))
    main = []
    for a in coll.main_assignments:
        t = tangent(a.rhs)
        if t != 0:
            main.append(Assignment(
                Field.Access(output_fields[a.lhs.field], a.lhs.offsets,
                             a.lhs.index), t))
    return AssignmentCollection(main, subs)


def tangent_op(forward_assignments: AssignmentsLike, wrt: Sequence[str],
               wanted: Sequence[str], op_name: str = "tangent",
               diff_fields_prefix: str = DEFAULT_DIFF_PREFIX,
               do_common_subexpression_elimination: bool = True):
    """``(op, names)``: the tangent-linear program of a forward stencil
    along the fields named in ``wrt`` (``create_tangent_assignments``) as
    an ``AutoDiffOp`` whose adjoints are those of the fields named in
    ``wanted`` (every other field is a constant field; None: every field
    it reads, tangent fields included), or ``(None, names)`` where every
    tangent output is 0.  ``names`` maps each primal input in ``wrt`` and
    each forward output to its tangent field's name (``tlm_<name>``, more
    underscores where that name is taken).  Its backward is ``∇ₓ⟨T(x, ẋ), g⟩``: the
    second-order half of differentiating the stencil's VJP."""
    coll = AssignmentCollection.normalize(forward_assignments)
    written = list(coll.fields_written)
    read = [f for f in coll.fields_read if f not in set(written)]
    taken = {f.name for f in read + written}
    prefix = "tlm_"
    while any(prefix + f.name in taken for f in read + written):
        prefix += "_"

    def twin(f: Field) -> Field:
        t = Field(prefix + f.name, f.spatial_dimensions,
                  index_shape=f.index_shape, dtype=f.dtype, layout=f.layout,
                  origin=f.origin, field_type=f.field_type)
        t.index_major = getattr(f, "index_major", False)
        return t

    tan = {f: twin(f) for f in read if f.name in set(wrt)}
    outs = {f: twin(f) for f in written}
    names = {f.name: t.name for f, t in list(tan.items()) + list(outs.items())}
    tcoll = create_tangent_assignments(coll, tan, outs)
    if not tcoll.main_assignments:
        return None, names
    op = AutoDiffOp(
        tcoll, op_name=op_name,
        constant_fields=[] if wanted is None else [
            f for f in tcoll.fields_read if f.name not in set(wanted)],
        diff_fields_prefix=diff_fields_prefix,
        do_common_subexpression_elimination=(
            do_common_subexpression_elimination))
    return op, names


def get_jacobian_of_assignments(assignments: AssignmentsLike,
                                diff_variables: Sequence[sp.Symbol]) -> sp.Matrix:
    """sympy Matrix Jacobian of all RHSs w.r.t. ``diff_variables``
    (reference ``_autodiff.py`` ≈L530)."""
    coll = AssignmentCollection.normalize(assignments)
    rhs = sp.Matrix([a.rhs for a in coll.inlined_main_assignments()])
    return rhs.jacobian(sp.Matrix(list(diff_variables)))


def _layout_transpose_axes(f, to_storage: bool):
    """Transpose axes mapping a field's runtime array between its storage
    spatial order (``f.layout``, outer→inner loop order) and logical order,
    accounting for index-dim placement.  None when already row-major."""
    import numpy as np

    sd = f.spatial_dimensions
    perm = f.layout
    if perm == tuple(range(sd)):
        return None
    sp = perm if to_storage else tuple(int(i) for i in np.argsort(perm))
    ni = f.index_dimensions
    if getattr(f, "index_major", False):
        return tuple(range(ni)) + tuple(ni + i for i in sp)
    return tuple(sp) + tuple(sd + i for i in range(ni))


def _wrap_layout_permutations(op, fn):
    """Honour non-row-major spatial layouts at the ``torch_function``
    boundary: permute inputs storage→logical, outputs logical→storage.  The
    permutes sit outside the autograd op, so autograd permutes the
    gradients back into each input's storage layout."""
    in_fields = list(op.forward_input_fields)
    out_fields = list(op.forward_output_fields)
    by_name = {f.name: f for f in in_fields}

    def permute(f, t, to_storage):
        axes = _layout_transpose_axes(f, to_storage=to_storage)
        return t if axes is None else t.permute(axes)

    def wrapped(*tensors, **kw_tensors):
        if kw_tensors:
            conv = {n: (permute(by_name[n], t, False) if n in by_name else t)
                    for n, t in kw_tensors.items()}
            res = fn(*tensors, **conv)
        else:
            if len(tensors) != len(in_fields):
                return fn(*tensors)  # let fn raise its arity error
            res = fn(*(permute(f, t, False)
                       for f, t in zip(in_fields, tensors)))
        if isinstance(res, tuple):
            return tuple(permute(f, r, True) for f, r in zip(out_fields, res))
        return permute(out_fields[0], res, True)

    for attr in ("input_names", "output_names", "op", "forward_program",
                 "backward_program"):
        setattr(wrapped, attr, getattr(fn, attr))
    wrapped.__name__ = fn.__name__
    return wrapped


class AutoDiffOp:
    """Forward stencil + symbolically derived adjoint, run by PyTorch.

    The analog of the reference's ``AutoDiffOp`` (``_autodiff.py`` ≈L100,
    SURVEY.md §3.2/§3.3): ``torch_function`` lowers the pair to the CUDA
    kernels (CUDA tensors) or the plain PyTorch version (CPU tensors) behind
    a ``torch.autograd.Function``.
    """

    def __init__(
        self,
        forward_assignments: AssignmentsLike,
        op_name: str = "autodiff_op",
        constant_fields: Sequence[Field] = (),
        time_constant_fields: Sequence[Field] = (),
        diff_mode: "DiffModes | str" = DiffModes.TRANSPOSED,
        diff_fields_prefix: str = DEFAULT_DIFF_PREFIX,
        do_common_subexpression_elimination: bool = True,
    ):
        self.forward_assignments = AssignmentCollection.normalize(forward_assignments)
        self.op_name = op_name
        self.constant_fields = _coerce_fields(constant_fields)
        self.time_constant_fields = _coerce_fields(time_constant_fields)
        self.diff_mode = DiffModes.coerce(diff_mode)
        self.diff_fields_prefix = diff_fields_prefix
        self.do_cse = do_common_subexpression_elimination
        self._backward: Optional[AssignmentCollection] = None

    # -- symbolic ------------------------------------------------------------

    @property
    def backward_assignments(self) -> AssignmentCollection:
        if self._backward is None:
            self._backward = create_backward_assignments(
                self.forward_assignments,
                diff_fields_prefix=self.diff_fields_prefix,
                time_constant_fields=self.time_constant_fields,
                constant_fields=self.constant_fields,
                diff_mode=self.diff_mode,
                do_common_subexpression_elimination=self.do_cse,
            )
        return self._backward

    def jacobian(self) -> sp.Matrix:
        """The symbolic Jacobian of the forward assignments with respect to
        every access of a non-constant field."""
        accesses = self.forward_assignments.accesses()
        diff_vars = [a for a in accesses if a.field not in set(self.constant_fields)]
        return get_jacobian_of_assignments(self.forward_assignments, diff_vars)

    # -- field classification (reference ≈L110, SURVEY.md §3.2) --------------

    @property
    def forward_output_fields(self) -> List[Field]:
        return self.forward_assignments.fields_written

    @property
    def forward_input_fields(self) -> List[Field]:
        written = set(self.forward_output_fields)
        return [f for f in self.forward_assignments.fields_read if f not in written]

    @property
    def forward_fields(self) -> List[Field]:
        return self.forward_input_fields + self.forward_output_fields

    @property
    def diff_fields(self) -> List[Field]:
        """Non-constant forward input fields: those that get adjoints."""
        constant = set(self.constant_fields)
        return [f for f in self.forward_input_fields if f not in constant]

    @property
    def backward_output_fields(self) -> List[Field]:
        """Adjoints of the (non-constant) forward inputs."""
        return self.backward_assignments.fields_written

    @property
    def backward_input_fields(self) -> List[Field]:
        """Adjoints of forward outputs, plus any primal fields the backward
        RHS still reads (nonlinear / variable-coefficient terms)."""
        written = set(self.backward_output_fields)
        return [f for f in self.backward_assignments.fields_read if f not in written]

    @property
    def saved_fields(self) -> List[Field]:
        """Primal forward fields re-read by the backward pass — the residuals
        the autograd op's forward must save."""
        fwd = set(self.forward_fields)
        return [f for f in self.backward_input_fields
                if not isinstance(f, AdjointField) and f in fwd]

    # -- lowering entry point --------------------------------------------------

    def torch_function(self, periodic: bool = False, strategy=None,
                       tile_rows=None, config=None, **kwargs):
        """The flagship API: ``f(*tensors)`` or ``f(**{field: tensor})``
        over the ``psat::stencil`` custom op, whose backward runs the
        symbolically derived adjoint.  The op runs on its inputs' device:
        the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
        tensors.  ``periodic=True`` wraps the domain.

        ``strategy`` and ``tile_rows`` are the JAX package's
        (``jax_function(lowering="pallas", strategy=..., tile_rows=...)``):
        ``"tiled"`` runs the forward and the full-domain backward (every
        stage of a staged one) through the slab kernel
        (``csrc/row_tiled.cuh``, the port of ``_run_row_tiled``), with
        ``tile_rows`` rows of dim 0 a tile; it raises ValueError on
        index-dim fields or fewer than 2 spatial dims.  With
        ``periodic=True`` it runs the window kernel's periodic mode: the
        JAX package drops to its roll path there, so no tiled kernel runs
        on either side.  Any other strategy runs the window kernel.

        ``config`` (a ``utils.LoweringConfig``) bundles the knobs, as
        ``jax_function(config=...)`` takes it: its ``kwargs()`` first,
        explicit keyword arguments over them.  ``dtype`` (a
        ``torch.dtype`` or its name) casts the inputs before the op, so
        forward and backward compute in it.  ``accumulate="dd"`` compiles
        the forward and backward programs with extended-precision wide
        sums (8 or more addends, rounded once): float32 and bfloat16 fields
        keep their storage and each such sum runs in float64 registers,
        float64 fields sum in double-word pairs — on the card through the
        window kernel (or the slab kernel, ``strategy="tiled"``), on the
        CPU through the plain version; ``"pairwise"`` (the default) sums
        as a balanced tree in the working type; any other name raises
        ValueError."""
        from .ops import build_autograd_function

        kw = dict(strategy=strategy, tile_rows=tile_rows)
        if config is not None:
            kw.update(config.kwargs())
            kw.update({n: v for n, v in (("strategy", strategy),
                                         ("tile_rows", tile_rows))
                       if v is not None})
        kw.update(kwargs)
        unknown = set(kw) - {"strategy", "tile_rows", "dtype", "accumulate"}
        if unknown:
            raise TypeError(f"torch_function: unknown option(s) "
                            f"{sorted(unknown)}")
        dtype = kw.pop("dtype", None)
        if isinstance(dtype, str):
            import torch
            dtype = getattr(torch, dtype)
        fn = build_autograd_function(self, periodic=periodic, dtype=dtype,
                                     **kw)
        if all(f.layout == tuple(range(f.spatial_dimensions))
               for f in self.forward_input_fields + self.forward_output_fields):
            return fn
        return _wrap_layout_permutations(self, fn)

    # -- framework bridges (reference signature parity, SURVEY.md §3.3) ------

    def create_pytorch_op(self, backend: str = "torch", **kwargs):
        """The reference's torch entry point: ``backend="torch"`` is
        ``torch_function(**kwargs)``; ``"torch_native"`` the generated C
        kernels registered as PyTorch operators for CPU tensors and the
        window kernel for CUDA tensors (``backends/_torch.py``;
        ``extension=False`` asks for the ctypes route, ``dtype`` casts)."""
        from .backends._torch import create_autograd_function
        if backend == "torch_native":
            kwargs.setdefault("native", True)
        elif backend != "torch":
            raise ValueError(f"unknown torch backend {backend!r}")
        return create_autograd_function(self, **kwargs)

    def create_tensorflow_op(self, backend: str = "tensorflow", **kwargs):
        """A TensorFlow function of the op: ``backend="tensorflow"`` runs
        ``torch_function`` through ``tf.py_function`` (tensors cross by
        DLPack), ``"tensorflow_native"`` a compiled ``REGISTER_OP``
        library of the generated C kernels."""
        if backend == "tensorflow_native":
            from .backends._tensorflow_native import create_tensorflow_op
            return create_tensorflow_op(self, **kwargs)
        if backend != "tensorflow":
            raise ValueError(f"unknown tensorflow backend {backend!r}")
        from .backends._tensorflow import tensorflow_function
        return tensorflow_function(self, **kwargs)

    def create_native_op(self, **kwargs):
        """The generated C kernel pair on numpy arrays
        (``backends/_c_native.NativeFunctionPair``; ``dtype``)."""
        from .backends._c_native import create_native_function_pair
        return create_native_function_pair(self, **kwargs)

    def kernel_pair(self, **kwargs) -> "AutoDiffKernelPair":
        """The op's compiled forward and backward kernels as an
        ``AutoDiffKernelPair`` (the reference's ``AutoDiffAstPair``)."""
        return AutoDiffKernelPair(self, **kwargs)

    # -- compiled-kernel accessors (the reference's forward_kernel_cpu/gpu
    #    properties, ``_autodiff.py`` ≈L250) -----------------------------

    @property
    def forward_kernel_gpu(self):
        """``f({field: tensor}) -> {output: tensor}``: the forward program
        in interior mode (``AutoDiffKernelPair.forward_kernel_gpu``)."""
        return AutoDiffKernelPair(self).forward_kernel_gpu

    @property
    def backward_kernel_gpu(self):
        """The full-domain backward (``AutoDiffKernelPair``)."""
        return AutoDiffKernelPair(self).backward_kernel_gpu

    @property
    def forward_kernel_cpu(self):
        """The forward program's generated C kernel (interior mode, float64)
        on numpy arrays: ``kernel({field: array}) -> {output: array}``."""
        from .backends._c_native import NativeKernel
        from .ops import forward_program
        return NativeKernel(forward_program(self), full_domain=False)

    @property
    def backward_kernel_cpu(self):
        """The single-pass backward program's C kernel (full domain,
        float64; the caller masks the cotangents to the forward interior)."""
        from .backends._c_native import NativeKernel
        from .ops import backward_program
        return NativeKernel(backward_program(self), full_domain=True)

    def __repr__(self):
        return (f"AutoDiffOp({self.op_name!r}, in={[f.name for f in self.forward_input_fields]}, "
                f"out={[f.name for f in self.forward_output_fields]}, mode={self.diff_mode.value})")


class AutoDiffKernelPair:
    """Bundled forward and backward kernels (reference ``AutoDiffAstPair``,
    ``_autodiff.py`` ≈L460): ``forward(**tensors)`` (and ``__call__``) runs
    the forward program in interior mode, ``backward(**tensors)`` the exact
    VJP over the full domain — every backward program in order where the
    backward is staged (TF_MAD), as ``ops/vjp.py`` runs it.  Both go
    through ``ops.make_stencil``: the window kernel for CUDA tensors, the
    plain version for CPU tensors.  ``kwargs`` (``periodic``, ``strategy``,
    ``tile_rows``) go to both.

    ``forward_kernel_gpu`` / ``backward_kernel_gpu`` are the two functions
    on dicts, ``f({field name: tensor}) -> {output name: tensor}``."""

    def __init__(self, op: AutoDiffOp, **kwargs):
        from .ops import backward_programs, forward_program, make_stencil
        from .ops.vjp import make_staged_fn

        self.op = op
        self.forward_kernel_gpu = make_stencil(forward_program(op), **kwargs)
        progs = backward_programs(op)
        self.backward_kernel_gpu = (
            make_stencil(progs[0], full_domain=True, **kwargs)
            if len(progs) == 1 else make_staged_fn(progs, make_stencil, {},
                                                   **kwargs))

    def forward(self, **tensors):
        """The forward outputs (one tensor, or a tuple in output order) from
        the inputs by keyword: the interior-mode forward kernel."""
        outs = self.forward_kernel_gpu(tensors)
        vals = tuple(outs[f.name] for f in self.op.forward_output_fields)
        return vals[0] if len(vals) == 1 else vals

    def backward(self, **tensors):
        """The gradients of the forward inputs (one tensor, or a tuple) from
        the backward program's inputs by keyword (the outputs' adjoints
        ``diff<name>`` and the primals it reads): the full-domain kernel."""
        outs = self.backward_kernel_gpu(tensors)
        vals = tuple(outs[f.name] for f in self.op.backward_output_fields)
        return vals[0] if len(vals) == 1 else vals

    def __call__(self, **tensors):
        return self.forward(**tensors)
