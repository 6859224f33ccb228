"""Assignments and assignment collections over symbolic field accesses: a
copy of ``pystencils_autodiff_tpu/assignment.py`` over the port's own
``Field``.

Minimal re-implementation of the pystencils ``Assignment`` /
``AssignmentCollection`` substrate the reference builds on (SURVEY.md §1 L1),
plus the access-analysis helpers the adjoint pass needs:

* write accesses must be at the cell centre (stencils write centre, read
  neighbourhoods — asserted exactly as the reference does,
  ``_autodiff.py`` ≈L40, SURVEY.md §3.1),
* read-access collection per field,
* ghost-layer (halo) inference from maximum absolute offsets,
* sympy CSE over a set of right-hand sides.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import sympy as sp

from .field import Field

__all__ = [
    "Assignment",
    "AssignmentCollection",
    "StagedAssignmentCollection",
    "accesses_in",
    "fields_read",
    "fields_written",
    "ghost_layers_of",
]


class Assignment:
    """``lhs ← rhs`` where lhs is a centre ``Field.Access`` (a main assignment)
    or a plain ``sympy.Symbol`` (a subexpression).

    ``is_accumulation`` marks ``lhs += rhs`` semantics; the adjoint pass emits
    accumulation assignments for ``time_constant_fields`` (reference
    ``_autodiff.py`` ≈L45, SURVEY.md §5.4).
    """

    def __init__(self, lhs, rhs, is_accumulation: bool = False):
        rhs = sp.sympify(rhs)
        if isinstance(lhs, Field.Access):
            pass
        elif isinstance(lhs, Field):
            lhs = lhs.center
        elif not isinstance(lhs, sp.Symbol):
            raise TypeError(f"lhs must be a Field.Access or Symbol, got {type(lhs)}")
        self.lhs = lhs
        self.rhs = rhs
        self.is_accumulation = bool(is_accumulation)

    @property
    def is_field_assignment(self) -> bool:
        return isinstance(self.lhs, Field.Access)

    def subs(self, mapping) -> "Assignment":
        new_lhs = self.lhs.subs(mapping) if not isinstance(self.lhs, Field.Access) else self.lhs
        return Assignment(new_lhs, self.rhs.subs(mapping), self.is_accumulation)

    def __iter__(self):  # tuple-like unpacking: lhs, rhs = asm
        yield self.lhs
        yield self.rhs

    def __eq__(self, other):
        return (isinstance(other, Assignment) and self.lhs == other.lhs
                and self.rhs == other.rhs
                and self.is_accumulation == other.is_accumulation)

    def __hash__(self):
        return hash((self.lhs, self.rhs, self.is_accumulation))

    def __repr__(self):
        op = "+=" if self.is_accumulation else "←"
        return f"{self.lhs} {op} {self.rhs}"

    def _repr_latex_(self):
        op = r"\mathrel{+}=" if self.is_accumulation else r"\leftarrow"
        return f"${sp.latex(self.lhs)} {op} {sp.latex(self.rhs)}$"


AssignmentsLike = Union["AssignmentCollection", Sequence[Assignment], Assignment]


def _topo_sort_subs(subs: List["Assignment"]) -> List["Assignment"]:
    """Order subexpression assignments so every symbol's definition precedes
    its uses (Kahn over the def→use graph; input order breaks ties)."""
    defined = {a.lhs: a for a in subs}
    deps = {a.lhs: {s for s in a.rhs.free_symbols if s in defined}
            for a in subs}
    out, placed = [], set()
    pending = list(subs)
    while pending:
        progressed = False
        rest = []
        for a in pending:
            if deps[a.lhs] <= placed:
                out.append(a)
                placed.add(a.lhs)
                progressed = True
            else:
                rest.append(a)
        if not progressed:
            raise ValueError(
                f"cyclic subexpression dependencies among "
                f"{[a.lhs for a in rest]}")
        pending = rest
    return out


class AssignmentCollection:
    """Ordered subexpressions + main (field) assignments.

    Mirrors pystencils ``AssignmentCollection`` far enough for the adjoint
    pass and the lowerings: topologically ordered subexpressions feeding main
    assignments that each write one centre access.
    """

    def __init__(self, main_assignments: Sequence[Assignment],
                 subexpressions: Sequence[Assignment] = ()):
        self.main_assignments: List[Assignment] = list(main_assignments)
        self.subexpressions: List[Assignment] = list(subexpressions)
        for a in self.main_assignments:
            if not a.is_field_assignment:
                raise ValueError(f"main assignment lhs must be a field access: {a}")
            if not a.lhs.is_center:
                # Stencils write the centre; reads may have offsets.  Same
                # invariant the reference asserts (SURVEY.md §3.1).
                raise ValueError(f"main assignments must write the cell centre: {a}")
        for s in self.subexpressions:
            if s.is_field_assignment:
                raise ValueError(f"subexpression lhs must be a plain symbol: {s}")

    # -- normalisation -------------------------------------------------------

    @staticmethod
    def normalize(assignments: AssignmentsLike) -> "AssignmentCollection":
        if isinstance(assignments, AssignmentCollection):
            return assignments
        if isinstance(assignments, Assignment):
            assignments = [assignments]
        main, subs = [], []
        for a in assignments:
            if not isinstance(a, Assignment):
                lhs, rhs = a  # allow (lhs, rhs) tuples
                a = Assignment(lhs, rhs)
            (main if a.is_field_assignment else subs).append(a)
        return AssignmentCollection(main, subs)

    # -- views ---------------------------------------------------------------

    @property
    def all_assignments(self) -> List[Assignment]:
        return self.subexpressions + self.main_assignments

    def inlined_main_assignments(self) -> List[Assignment]:
        """Main assignments with all subexpressions substituted in, in order.

        The adjoint derivation differentiates fully-inlined right-hand sides
        so the chain rule through subexpressions is handled by sympy itself.
        """
        substitutions: Dict[sp.Symbol, sp.Expr] = {}
        for sub in self.subexpressions:
            substitutions[sub.lhs] = sub.rhs.xreplace(substitutions)
        return [Assignment(a.lhs, a.rhs.xreplace(substitutions), a.is_accumulation)
                for a in self.main_assignments]

    # -- field analysis ------------------------------------------------------

    @property
    def bound_symbols(self):
        return {s.lhs for s in self.subexpressions}

    @property
    def free_symbols(self):
        free = set()
        for a in self.all_assignments:
            free |= a.rhs.free_symbols
        return free - self.bound_symbols - set(self.accesses())

    def accesses(self) -> List[Field.Access]:
        """All read accesses in RHS order of appearance (deduplicated)."""
        seen, out = set(), []
        for a in self.all_assignments:
            for acc in sorted(a.rhs.atoms(Field.Access), key=sp.default_sort_key):
                if acc not in seen:
                    seen.add(acc)
                    out.append(acc)
        return out

    @property
    def fields_written(self) -> List[Field]:
        seen, out = set(), []
        for a in self.main_assignments:
            f = a.lhs.field
            if f not in seen:
                seen.add(f)
                out.append(f)
        return out

    @property
    def fields_read(self) -> List[Field]:
        seen, out = set(), []
        for acc in self.accesses():
            if acc.field not in seen:
                seen.add(acc.field)
                out.append(acc.field)
        return out

    @property
    def free_fields(self) -> List[Field]:
        written = set(self.fields_written)
        return [f for f in self.fields_read if f not in written]

    def read_offsets(self, field: Field) -> List[Tuple[int, ...]]:
        """Distinct spatial offsets with which ``field`` is read."""
        offs, out = set(), []
        for acc in self.accesses():
            if acc.field == field and acc.offsets not in offs:
                offs.add(acc.offsets)
                out.append(acc.offsets)
        return out

    def ghost_layers(self) -> Tuple[Tuple[int, int], ...]:
        """Required halo per spatial dim as (lo, hi) pairs: the write domain
        must shrink by this so every read stays in bounds (reference:
        pystencils ``create_kernel(ghost_layers=...)``, SURVEY.md §3.2/§3.5)."""
        return ghost_layers_of(self.accesses())

    # -- transforms ----------------------------------------------------------

    def new_with_cse(self, symbol_prefix: str = "xi",
                     preserve_subexpressions: bool = False
                     ) -> "AssignmentCollection":
        """Common-subexpression-eliminated copy (sympy.cse over all RHSs).

        Mirrors ``do_common_subexpression_elimination=True`` in the reference's
        ``create_backward_assignments`` (SURVEY.md §2.1 #2).

        ``preserve_subexpressions=True`` runs CSE over the existing DAG
        (subexpression definitions + main RHSs) *without* inlining first —
        for wide collections (D3Q19 adjoints) the inlined trees are huge
        and ``sp.cse`` over them dominates derivation time.  The combined
        subexpression list is re-ordered topologically (new CSE symbols may
        capture pieces referencing existing symbols and vice versa).
        """
        if preserve_subexpressions and self.subexpressions:
            exprs = [a.rhs for a in self.all_assignments]
            replacements, reduced = sp.cse(
                exprs, symbols=sp.numbered_symbols(symbol_prefix))
            n_sub = len(self.subexpressions)
            subs = ([Assignment(sym, e) for sym, e in replacements]
                    + [Assignment(a.lhs, e) for a, e
                       in zip(self.subexpressions, reduced[:n_sub])])
            main = [Assignment(a.lhs, e, a.is_accumulation)
                    for a, e in zip(self.main_assignments, reduced[n_sub:])]
            return AssignmentCollection(main, _topo_sort_subs(subs))
        inlined = self.inlined_main_assignments()
        replacements, reduced = sp.cse(
            [a.rhs for a in inlined], symbols=sp.numbered_symbols(symbol_prefix))
        subs = [Assignment(sym, expr) for sym, expr in replacements]
        main = [Assignment(a.lhs, new_rhs, a.is_accumulation)
                for a, new_rhs in zip(inlined, reduced)]
        return AssignmentCollection(main, subs)

    def __len__(self):
        return len(self.main_assignments)

    def __iter__(self):
        return iter(self.all_assignments)

    def __repr__(self):
        lines = [f"  {a}" for a in self.subexpressions]
        lines += [f"  {a}" for a in self.main_assignments]
        return "AssignmentCollection(\n" + "\n".join(lines) + "\n)"


class StagedAssignmentCollection(AssignmentCollection):
    """A sequence of assignment collections executed as successive passes:
    each stage may read fields written by earlier stages (materialised
    intermediates, e.g. the TF_MAD mode's Jacobian fields — SURVEY.md §3.1
    ``_autodiff.py`` ≈L220).

    The base-class view (main_assignments/subexpressions/fields_written)
    is the FINAL stage — the externally visible outputs — while
    ``fields_read`` spans all stages minus the intermediates, so
    ``AutoDiffOp``'s field classification sees exactly the external
    signature.  Lowerings run the stages in order (ops.make_staged_fn);
    single-pass consumers (fused chains, generated-C backends) reject
    staged collections with a clear error.
    """

    def __init__(self, stages: Sequence[AssignmentCollection]):
        self.stages = [AssignmentCollection.normalize(s) for s in stages]
        if not self.stages:
            raise ValueError("need at least one stage")
        final = self.stages[-1]
        super().__init__(final.main_assignments, final.subexpressions)

    @property
    def intermediate_fields(self) -> List[Field]:
        seen, out = set(), []
        for st in self.stages[:-1]:
            for f in st.fields_written:
                if f not in seen:
                    seen.add(f)
                    out.append(f)
        return out

    @property
    def fields_read(self) -> List[Field]:
        inter = set(self.intermediate_fields)
        seen, out = set(), []
        for st in self.stages:
            for f in st.fields_read:
                if f not in inter and f not in seen:
                    seen.add(f)
                    out.append(f)
        return out

    def new_with_cse(self, symbol_prefix: str = "xi",
                     preserve_subexpressions: bool = False
                     ) -> "StagedAssignmentCollection":
        return StagedAssignmentCollection(
            [st.new_with_cse(f"{symbol_prefix}s{i}_")
             for i, st in enumerate(self.stages)])

    def __repr__(self):
        parts = [f"-- stage {i} --\n{st!r}"
                 for i, st in enumerate(self.stages)]
        return "StagedAssignmentCollection(\n" + "\n".join(parts) + "\n)"


def accesses_in(expr: sp.Expr) -> List[Field.Access]:
    return sorted(expr.atoms(Field.Access), key=sp.default_sort_key)


def fields_read(assignments: AssignmentsLike) -> List[Field]:
    return AssignmentCollection.normalize(assignments).fields_read


def fields_written(assignments: AssignmentsLike) -> List[Field]:
    return AssignmentCollection.normalize(assignments).fields_written


def ghost_layers_of(accesses: Iterable[Field.Access],
                    ndim: Optional[int] = None) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) halo width per spatial dimension covering all ``accesses``."""
    accesses = list(accesses)
    if not accesses:
        if ndim is None:
            raise ValueError("no accesses and no ndim given")
        return tuple((0, 0) for _ in range(ndim))
    if ndim is None:
        ndim = max(len(a.offsets) for a in accesses)
    lo = [0] * ndim
    hi = [0] * ndim
    for a in accesses:
        for d, o in enumerate(a.offsets):
            lo[d] = max(lo[d], -o if o < 0 else 0)
            hi[d] = max(hi[d], o if o > 0 else 0)
    return tuple(zip(lo, hi))
