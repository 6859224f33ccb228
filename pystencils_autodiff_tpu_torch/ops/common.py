"""Stencil-program representation shared by the port's lowerings.

The framework-neutral half of ``pystencils_autodiff_tpu/ops/common.py``,
carried over so the port never imports jax: a ``StencilProgram`` is the
compiled-once form of an ``AssignmentCollection`` — ordered evaluation steps
(subexpressions then main assignments), the access atoms each step reads,
ghost-layer geometry and the field signature.  The plain PyTorch lowering
(``torch_ref.py``), the CUDA printer (``codegen/cuda_printer.py``) and the
CUDA kernel wrapper (``cuda_kernel.py``) all lower from this one structure.

Domain semantics
----------------
``interior`` mode: all arrays share a spatial shape ``S``; the kernel writes
cells ``lo_d <= i_d < S_d - hi_d`` and zeros on the ghost frame.

``full`` mode (the exact VJP, ops/vjp.py): every cell of ``S`` is written;
reads outside the domain are zero for adjoint fields and edge-clamped for
primal fields, so gradients land in the primal ghost cells.

``periodic`` mode: every read wraps around, every cell is written.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional, Sequence, Tuple

import sympy as sp

from ..adjoint_field import AdjointField
from ..assignment import AssignmentCollection, StagedAssignmentCollection
from ..field import Field

__all__ = ["Step", "StencilProgram", "make_program", "forward_program",
           "backward_program", "backward_programs", "is_staged_backward",
           "is_adjoint", "storage_spatial", "storage_shape", "spatial_index",
           "plane_view", "assemble_planes", "field_components",
           "check_ported", "check_accumulate", "dd_plan", "is_dd_step",
           "derived"]


# ---------------------------------------------------------------------------
# Storage-layout helpers: lowerings work on per-component *planes* in
# logical spatial order; these map between a field's storage layout (AoS
# trailing index dims — the default — or SoA leading index dims,
# ``Field(layout='soa')``) and that canonical form.
# ---------------------------------------------------------------------------

def _index_major(f: Field) -> bool:
    return bool(getattr(f, "index_major", False))


def field_components(f: Field):
    """All index-component tuples of a field ([()] for scalars)."""
    import itertools
    if f.index_shape:
        return [tuple(c) for c in
                itertools.product(*(range(s) for s in f.index_shape))]
    return [()]


def storage_spatial(f: Field, arr) -> Tuple[int, ...]:
    """Spatial shape of a storage-layout array."""
    ni = len(f.index_shape)
    if not ni:
        return tuple(arr.shape[: f.spatial_dimensions])
    return tuple(arr.shape[ni:]) if _index_major(f) else tuple(arr.shape[:-ni])


def storage_shape(f: Field, spatial) -> Tuple[int, ...]:
    """Full storage array shape for the given spatial shape."""
    spatial = tuple(spatial)
    if _index_major(f):
        return f.index_shape + spatial
    return spatial + f.index_shape


def spatial_index(f: Field, sl: Tuple) -> Tuple:
    """Embed a tuple of spatial slices/indices into a full storage index."""
    if _index_major(f):
        return (slice(None),) * len(f.index_shape) + tuple(sl)
    return tuple(sl) + (Ellipsis,)


def plane_view(f: Field, arr, idx: Tuple[int, ...]):
    """Component plane (spatial shape) of a storage-layout array."""
    if not idx:
        return arr
    return arr[idx] if _index_major(f) else arr[(Ellipsis,) + idx]


def assemble_planes(f: Field, planes, spatial):
    """Stack canonical component planes back into storage layout."""
    import torch
    spatial = tuple(spatial)
    if not f.index_shape:
        return planes[0].reshape(spatial)
    if _index_major(f):
        return torch.stack(planes, 0).reshape(f.index_shape + spatial)
    return torch.stack(planes, -1).reshape(spatial + f.index_shape)


@dataclass
class Step:
    """One evaluation step: ``target ← fn(*atom_values)``."""

    target: object  # Field.Access (main) or sp.Symbol (subexpression)
    atoms: List[object]  # Field.Access and bound sp.Symbols read by rhs
    fn: Callable  # compiled elementwise function of the atoms
    rhs: sp.Expr
    is_accumulation: bool = False

    @property
    def is_main(self) -> bool:
        return isinstance(self.target, Field.Access)


@dataclass
class StencilProgram:
    collection: AssignmentCollection
    input_fields: List[Field]
    output_fields: List[Field]
    steps: List[Step]
    ghost: Tuple[Tuple[int, int], ...]  # (lo, hi) per spatial dim
    ndim: int
    accum_fields: List[Field] = dc_field(default_factory=list)
    name: str = "stencil"
    accumulate: str = "pairwise"  # wide-sum mode the steps were compiled with

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self.input_fields]

    @property
    def output_names(self) -> List[str]:
        return [f.name for f in self.output_fields]

    def interior_slices(self, shift: Tuple[int, ...] = ()) -> Tuple[slice, ...]:
        """Spatial slices selecting the interior, optionally shifted (for a
        read access with offsets ``shift``): ``lo+o : S-hi+o`` per dim."""
        if not shift:
            shift = (0,) * self.ndim
        out = []
        for (lo, hi), o in zip(self.ghost, shift):
            stop = -(hi - o) if hi - o > 0 else None
            out.append(slice(lo + o, stop))
        return tuple(out)

    def interior_shape(self, spatial_shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape the program writes: ``spatial_shape`` less the ghost
        frame on each side."""
        return tuple(s - lo - hi for s, (lo, hi) in zip(spatial_shape, self.ghost))


_PAIRWISE_ADD_MIN_TERMS = 8


class _NonArithmetic(Exception):
    pass


def pairwise_sum(parts: list, add: Callable):
    """``parts`` summed as a balanced pairwise tree with ``add``: O(log n)
    accumulation error instead of the left fold's O(n).  Neighbours pair
    up level by level, an odd last part joining the next level: the order
    every lowering (plain, CUDA, C) sums a wide sum in."""
    while len(parts) > 1:
        nxt = [add(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _tree_sum(terms: List[str]) -> str:
    """``pairwise_sum`` over emitted term sources."""
    return pairwise_sum(terms, lambda a, b: f"({a}+{b})")


def _emit_grouped_add(e: sp.Add, names: dict, emit=None) -> Optional[str]:
    """Coefficient-grouped emission of a wide linear combination:
    ``c·a + c·b − c·d → c·((a+b) − d)`` for every set of ≥2 addends
    sharing a numeric |coefficient| (symmetric stencil weights).  Done at
    string emission because sympy re-distributes ``Number*Add`` on
    construction.  ``emit`` prints the leaves (default: Python source).
    Returns ``None`` when no group has ≥2 members."""
    emit = emit or _emit_py
    groups: dict = {}
    order: List = []
    for t in e.args:
        c, rest = t.as_coeff_Mul()
        key = abs(c)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((c, rest, t))
    if all(len(v) < 2 for v in groups.values()):
        return None
    parts: List[str] = []
    for key in order:
        items = groups[key]
        if len(items) == 1:
            parts.append(emit(items[0][2], names))
            continue
        pos = [emit(rest, names) for c, rest, _ in items if c > 0]
        neg = [emit(rest, names) for c, rest, _ in items if c < 0]
        if pos and neg:
            inner = f"({_tree_sum(pos)}-{_tree_sum(neg)})"
        elif pos:
            inner = _tree_sum(pos)
        else:
            inner = f"(-{_tree_sum(neg)})"
        if key == 1:
            parts.append(inner)
        else:
            parts.append(f"({emit(key, names)}*{inner})")
    return _tree_sum(parts)


def _emit_py(e: sp.Expr, names: dict, as_kernel: bool = False) -> str:
    """Python source for a pure-arithmetic expression (operators only).

    Raises ``_NonArithmetic`` on anything needing a function namespace
    (sin, Piecewise, non-integer powers, ...) — the caller falls back to
    ``sp.lambdify``, whose fixed per-call overhead would otherwise dominate
    program builds for wide ops.  ``as_kernel`` (``accumulate="dd"``
    programs, whose kernels are held to their plain versions bit for
    bit): integer powers multiplied out and square roots (``x**(1/2)``,
    ``x**(-1/2)`` as ``1/sqrt(x)``) printed as the CUDA printer prints
    them (``_sqrt``: ``torch.sqrt``), so each operation rounds where the
    kernel's does."""
    key = names.get(e)
    if key is not None:
        return key
    if e.is_Integer:
        return repr(int(e))
    if e.is_Rational:
        return f"({int(e.p)}/{int(e.q)})"
    if e.is_Float:
        return repr(float(e))

    def emit(x, nm=names):
        return _emit_py(x, nm, as_kernel)

    if isinstance(e, sp.Add):
        if len(e.args) >= 4:
            grouped = _emit_grouped_add(e, names, emit=emit)
            if grouped is not None:
                return grouped
        terms = [emit(a) for a in e.args]
        if len(terms) >= _PAIRWISE_ADD_MIN_TERMS:
            return _tree_sum(terms)
        return "(" + "+".join(terms) + ")"
    if isinstance(e, sp.Mul):
        return "(" + "*".join(emit(a) for a in e.args) + ")"
    if isinstance(e, sp.Pow):
        if e.exp.is_Integer and not as_kernel:
            return f"({emit(e.base)}**{int(e.exp)})"
        if e.exp.is_Integer:
            n, base = int(e.exp), emit(e.base)
            prod = "*".join([f"({base})"] * abs(n)) or "1"
            return f"({prod})" if n >= 0 else f"(1/({prod}))"
        if as_kernel and abs(e.exp) == sp.Rational(1, 2):
            root = f"_sqrt({emit(e.base)})"
            return root if e.exp > 0 else f"(1/{root})"
        raise _NonArithmetic(e)
    raise _NonArithmetic(e)


def dd_plan(rhs: sp.Expr):
    """The evaluation tree of a wide sum in ``accumulate="dd"`` mode, as
    the JAX package's ``_compile_dd_add`` builds it: ``("const", c)`` for a
    number (c a float), ``("add", [...])`` for a sum of any width (its
    addends in SymPy's order, summed as a balanced pairwise tree),
    ``("mul", [...])`` for a product (a left fold; an integer power 2 … 4
    is its base repeated) and ``("leaf", e)`` for anything else — an
    access, a subexpression symbol or a non-arithmetic term (``sqrt``,
    ``exp``, …), evaluated in the working type as in pairwise mode and
    rounded to it there."""
    if rhs.is_Number:
        return ("const", float(rhs))
    if isinstance(rhs, sp.Add):
        return ("add", [dd_plan(t) for t in rhs.args])
    if isinstance(rhs, sp.Mul):
        return ("mul", [dd_plan(f) for f in rhs.args])
    if (isinstance(rhs, sp.Pow) and rhs.exp.is_Integer
            and 1 < int(rhs.exp) <= 4):
        return ("mul", [dd_plan(rhs.base)] * int(rhs.exp))
    return ("leaf", rhs)


def is_dd_step(rhs: sp.Expr, accumulate: str) -> bool:
    """Whether a step's right-hand side is a wide sum that ``accumulate``
    mode ``"dd"`` evaluates in extended precision (8 or more addends at
    its top level; every other step is evaluated as in pairwise mode)."""
    return (accumulate == "dd" and isinstance(rhs, sp.Add)
            and len(rhs.args) >= _PAIRWISE_ADD_MIN_TERMS)


def _compile_dd_add(rhs: sp.Add, atoms: List[object]) -> Callable:
    """A wide sum with extended-precision accumulation, the counterpart of
    the JAX package's ``_compile_dd_add`` (``ops/common.py`` there) on
    torch tensors, over the tree of ``dd_plan``.

    * Working type float32, bfloat16 or float16: the whole tree in
      float64 — leaves cast up, constants as float64, products and the
      pairwise sums in float64 —, rounded once to the working type.  The
      JAX package carries double-word float32 pairs instead (about 48
      bits); float64 carries 53, so the two agree wherever the correctly
      rounded result is not within 2^-48 of a rounding boundary.
    * Working type float64: double-word float64 pairs (``utils/dd.py``),
      as the JAX package evaluates them.

    A leaf is evaluated in the working type first and rounded to it, as
    the JAX package rounds its non-arithmetic leaves."""
    import torch

    from ..utils.dd import _round_barrier, dd_add_dd, dd_mul, dd_to

    plan = dd_plan(rhs)

    def compile_leaves(node):
        kind, item = node
        if kind == "leaf":
            return ("leaf", _compile_rhs(item, atoms, "dd"))
        if kind in ("add", "mul"):
            return (kind, [compile_leaves(n) for n in item])
        return node

    plan = compile_leaves(plan)

    def fn(*vals):
        ts = [v for v in vals if isinstance(v, torch.Tensor)]
        dtype = ts[0].dtype if ts else torch.get_default_dtype()
        for t in ts[1:]:
            dtype = torch.promote_types(dtype, t.dtype)
        device = ts[0].device if ts else None
        pairs = dtype == torch.float64

        def leaf(f):
            v = f(*vals)
            if not isinstance(v, torch.Tensor) or v.dtype != dtype:
                v = torch.as_tensor(v, dtype=dtype, device=device)
            return v

        def ev(node):
            kind, item = node
            if kind == "const":
                return (item, 0.0) if pairs else item
            if kind == "leaf":
                # pinned: a rounded leaf feeding a TwoSum must stay rounded
                return ((_round_barrier(leaf(item)), 0.0) if pairs
                        else leaf(item).to(torch.float64))
            if kind == "mul":
                v = ev(item[0])
                for sub in item[1:]:
                    v = dd_mul(v, ev(sub)) if pairs else v * ev(sub)
                return v
            return pairwise_sum([ev(sub) for sub in item],
                                dd_add_dd if pairs else operator.add)

        res = ev(plan)
        if pairs:
            res = dd_to(res)
        return torch.as_tensor(res, dtype=torch.float64,
                               device=device).to(dtype)

    return fn


def _compile_rhs(rhs: sp.Expr, atoms: List[object],
                 accumulate: str = "pairwise") -> Callable:
    """Compile ``rhs`` into an elementwise function of ``atoms``.

    In ``accumulate="dd"`` mode a wide sum (``is_dd_step``) accumulates in
    extended precision (``_compile_dd_add``).  Otherwise pure arithmetic
    goes straight to Python source (wide sums as balanced pairwise trees);
    anything else through ``sp.lambdify`` over identifier-safe dummies
    with the torch namespace."""
    if is_dd_step(rhs, accumulate):
        return _compile_dd_add(rhs, atoms)
    try:
        import torch

        names = {a: f"a{i}" for i, a in enumerate(atoms)}
        src = _emit_py(rhs, names, as_kernel=accumulate == "dd")
        args = ", ".join(names.values())
        return eval(compile(f"lambda {args}: {src}", "<stencil-rhs>", "eval"),
                    {"__builtins__": {}, "_sqrt": torch.sqrt})
    except _NonArithmetic:
        pass

    dummies = [sp.Dummy(f"a{i}") for i in range(len(atoms))]
    expr = rhs.xreplace(dict(zip(atoms, dummies)))
    if not dummies:
        return sp.lambdify((), expr, modules="torch")
    if isinstance(expr, sp.Add) and len(expr.args) >= _PAIRWISE_ADD_MIN_TERMS:
        term_fns = [sp.lambdify(dummies, t, modules="torch")
                    for t in expr.args]

        def fn(*vals):
            return pairwise_sum([t(*vals) for t in term_fns], operator.add)

        return fn
    return sp.lambdify(dummies, expr, modules="torch")


def derived(op, key, build):
    """``build()``, memoised on ``op`` under ``key``: what a builder derives
    from an op (a transposed cotangent op, a twin's pieces) is derived
    once."""
    memo = op.__dict__.setdefault("_derived", {})
    if key not in memo:
        memo[key] = build()
    return memo[key]


ACCUMULATE = ("pairwise", "dd")


def check_accumulate(accumulate) -> str:
    """The wide-sum mode ``accumulate`` names (None: ``"pairwise"``);
    raises ValueError on any other name.  The JAX package treats every
    value but ``"dd"`` as pairwise; the port names the two modes and
    refuses a misspelt one."""
    if accumulate is None:
        return "pairwise"
    if accumulate not in ACCUMULATE:
        raise ValueError(f"accumulate={accumulate!r}; one of {ACCUMULATE}")
    return accumulate


def check_ported(program) -> None:
    """Raise on a program a fused chain does not take: one compiled with
    extended-precision sums (``accumulate="dd"``).  That is a mode of the
    single step (the window and slab kernels and their plain version); the
    JAX package's fused chains never build a dd program either."""
    if getattr(program, "accumulate", "pairwise") == "dd":
        raise ValueError(
            f"{program.name}: accumulate='dd' is a single-step mode; the "
            f"fused chains take pairwise programs")


def make_program(
    collection: AssignmentCollection,
    input_fields: Sequence[Field],
    output_fields: Sequence[Field],
    name: str = "stencil",
    accumulate: str = "pairwise",
) -> StencilProgram:
    """Compile an assignment collection into an ordered step program;
    ``accumulate="dd"`` compiles its wide sums with extended-precision
    accumulation (``_compile_dd_add``)."""
    accumulate = check_accumulate(accumulate)
    input_fields = list(input_fields)
    output_fields = list(output_fields)
    ndim = output_fields[0].spatial_dimensions if output_fields else (
        input_fields[0].spatial_dimensions)
    ghost = collection.ghost_layers()
    if len(ghost) < ndim:
        ghost = ghost + tuple((0, 0) for _ in range(ndim - len(ghost)))

    bound = set()
    steps: List[Step] = []
    for a in collection.all_assignments:
        accesses = sorted(a.rhs.atoms(Field.Access), key=sp.default_sort_key)
        symbols = sorted((s for s in a.rhs.free_symbols
                          if not isinstance(s, Field.Access) and s in bound),
                         key=sp.default_sort_key)
        free = {s for s in a.rhs.free_symbols
                if not isinstance(s, Field.Access) and s not in bound}
        if free:
            raise ValueError(
                f"free symbols {free} in {a}; bind them as fields or subexpressions")
        atoms = list(accesses) + list(symbols)
        steps.append(Step(target=a.lhs, atoms=atoms,
                          fn=_compile_rhs(a.rhs, atoms, accumulate),
                          rhs=a.rhs,
                          is_accumulation=a.is_accumulation))
        if not a.is_field_assignment:
            bound.add(a.lhs)

    accum = []
    for a in collection.main_assignments:
        if a.is_accumulation and a.lhs.field not in accum:
            accum.append(a.lhs.field)

    declared = {f.name for f in input_fields}
    for s in steps:
        for at in s.atoms:
            if isinstance(at, Field.Access) and at.field.name not in declared:
                raise ValueError(
                    f"{name}: access {at} reads undeclared field {at.field.name!r}; "
                    f"inputs are {sorted(declared)}")

    return StencilProgram(
        collection=collection,
        input_fields=input_fields,
        output_fields=output_fields,
        steps=steps,
        ghost=ghost,
        ndim=ndim,
        accum_fields=accum,
        name=name,
        accumulate=accumulate,
    )


def forward_program(op, accumulate: str = "pairwise") -> StencilProgram:
    """Program for an ``AutoDiffOp``'s forward collection."""
    return make_program(
        op.forward_assignments,
        input_fields=op.forward_input_fields,
        output_fields=op.forward_output_fields,
        name=f"{op.op_name}_fwd",
        accumulate=accumulate,
    )


def is_staged_backward(op) -> bool:
    """True when the op's backward collection is multi-pass (TF_MAD with
    materialised Jacobian fields)."""
    return isinstance(op.backward_assignments, StagedAssignmentCollection)


def backward_programs(op, accumulate: str = "pairwise"
                      ) -> List[StencilProgram]:
    """Per-stage programs of a (possibly staged) backward collection, in
    execution order.  Single-pass collections yield one program."""
    coll = op.backward_assignments
    if not isinstance(coll, StagedAssignmentCollection):
        return [backward_program(op, accumulate)]
    progs = []
    for i, stage in enumerate(coll.stages[:-1]):
        progs.append(make_program(
            stage,
            input_fields=stage.fields_read,
            output_fields=stage.fields_written,
            name=f"{op.op_name}_bwd_stage{i}",
            accumulate=accumulate,
        ))
    final = coll.stages[-1]
    inputs = list(op.backward_input_fields) + list(coll.intermediate_fields)
    accum_prev = [f for f in final.fields_written
                  if any(a.is_accumulation and a.lhs.field == f
                         for a in final.main_assignments)]
    progs.append(make_program(
        final,
        input_fields=inputs + [f for f in accum_prev if f not in inputs],
        output_fields=op.backward_output_fields,
        name=f"{op.op_name}_bwd_gather",
        accumulate=accumulate,
    ))
    return progs


def backward_program(op, accumulate: str = "pairwise") -> StencilProgram:
    """Program for an ``AutoDiffOp``'s single-pass backward collection.

    Inputs: adjoints of forward outputs + the saved primal fields; for
    accumulation (``time_constant_fields``) adjoint outputs the previous
    adjoint array is an additional input."""
    coll = op.backward_assignments
    if isinstance(coll, StagedAssignmentCollection):
        raise NotImplementedError(
            f"{op.op_name}: the backward collection is multi-pass (TF_MAD "
            f"materialised-Jacobian mode); use backward_programs")
    inputs = list(op.backward_input_fields)
    accum_prev = [f for f in coll.fields_written
                  if any(a.is_accumulation and a.lhs.field == f
                         for a in coll.main_assignments)]
    return make_program(
        coll,
        input_fields=inputs + [f for f in accum_prev if f not in inputs],
        output_fields=op.backward_output_fields,
        name=f"{op.op_name}_bwd",
        accumulate=accumulate,
    )


def is_adjoint(f: Field) -> bool:
    """Whether ``f`` is an ``AdjointField`` (an adjoint input or output)."""
    return isinstance(f, AdjointField)
