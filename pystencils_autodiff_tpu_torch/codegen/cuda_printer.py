"""CUDA source for one ``StencilProgram``: the per-stencil part of the kernel.

The hand-written kernel template (``csrc/stencil_step.cuh``) owns indexing,
halos, masks and the three domain modes; this printer emits only what
differs per stencil, the way the Pallas kernels trace their arithmetic from
the program steps:

* one ``const T`` local per distinct field access, printed as a read whose
  meaning depends on the mode — ``c.rp`` (primal: edge-clamped in full mode,
  wrapped in periodic mode) or ``c.ra`` (adjoint: zero outside the domain
  and outside the forward interior, wrapped in periodic mode);
* one ``const T`` local per CSE subexpression step;
* one ``v[k] = ...`` per main step (``k`` = output plane) and the
  accumulation epilogue ``v[k] += prev``.

Arithmetic mirrors ``ops.common._emit_py`` (same grouping and pairwise
trees as the plain version); constants are cast to ``T``, integer powers
are multiplied out, square roots print their argument the same way, other
functions go through SymPy's C printer.  A
single-step program compiled with ``accumulate="dd"`` prints its wide sums
through ``_emit_dd`` (``csrc/dd.cuh``): the tree of
``ops.common.dd_plan`` in float64 registers (float and bfloat16 kernels)
or double-word pairs (double kernels), rounded once to ``T``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import sympy as sp
from sympy.printing.c import C99CodePrinter

from ..field import Field
from .nvcc import FLAGS_MARK
from ..ops.common import (_PAIRWISE_ADD_MIN_TERMS, StencilProgram,
                          _emit_grouped_add, _tree_sum, dd_plan,
                          field_components, is_adjoint, is_dd_step,
                          pairwise_sum)

__all__ = ["STORAGE", "generate_cuda_source", "kernel_nd", "lift",
           "generate_chain_source",
           "generate_adjoint_source", "generate_plane_source",
           "generate_twin_source", "generate_warp_chain_source",
           "generate_stage_source", "generate_stage_adjoint_source",
           "generate_stage_march_source", "input_planes", "output_planes"]

MAX_NDIM = 3  # reads print at least three offsets; unused ones are 0


def kernel_nd(program: StencilProgram) -> int:
    """Spatial dims of the single-step kernel for ``program``: a 1D program
    runs as a 2D one with a leading extent of 1 (its dim the contiguous
    column axis); every other rank as itself."""
    return max(2, program.ndim)


def lift(program: StencilProgram, values, fill=0) -> list:
    """Per-dim ``values`` of ``program`` in the kernel's dims
    (``kernel_nd``): ``fill`` for the leading dim a 1D program gains."""
    return [fill] * (kernel_nd(program) - program.ndim) + list(values)


def input_planes(program: StencilProgram) -> List[Tuple[Field, tuple]]:
    """Kernel input slots: one per (input field, index component)."""
    return [(f, idx) for f in program.input_fields
            for idx in field_components(f)]


def output_planes(program: StencilProgram) -> List[Tuple[Field, tuple]]:
    """Kernel output slots: one per (output field, index component)."""
    return [(f, idx) for f in program.output_fields
            for idx in field_components(f)]


def _const(e) -> str:
    if e.is_Integer:
        return f"T({int(e)})"
    if e.is_Rational:
        return f"T({int(e.p)}.0/{int(e.q)}.0)"
    return f"T({float(e)!r})"


def _int_pow(base: str, n: int) -> str:
    if n == 0:
        return "T(1)"
    prod = "*".join([f"({base})"] * abs(n))
    return f"({prod})" if n > 0 else f"(T(1)/({prod}))"


class _CudaExprPrinter(C99CodePrinter):
    """SymPy's C printer with program-local names and ``T``-typed constants,
    for what the arithmetic emitter does not cover (functions, Piecewise,
    non-integer powers)."""

    def __init__(self, names: Dict[object, str]):
        super().__init__()
        self.names = names

    def _print_Symbol(self, expr):
        name = self.names.get(expr)
        if name is None:
            raise ValueError(f"unbound symbol {expr} in stencil expression")
        return name

    def _print_Integer(self, expr):
        return _const(expr)

    _print_Rational = _print_Integer
    _print_Float = _print_Integer

    def _print_Pow(self, expr):
        base = self._print(expr.base)
        if expr.exp.is_Integer:
            return _int_pow(base, int(expr.exp))
        if expr.exp == sp.Rational(1, 2):
            return f"sqrt({base})"
        if expr.exp == sp.Rational(-1, 2):
            return f"(T(1)/sqrt({base}))"
        return f"pow({base}, {self._print(expr.exp)})"


def _emit_cuda(e: sp.Expr, names: Dict[object, str]) -> str:
    key = names.get(e)
    if key is not None:
        return key
    if e.is_Number and e.is_real:
        return _const(e)
    if isinstance(e, sp.Add):
        if len(e.args) >= 4:
            grouped = _emit_grouped_add(e, names, emit=_emit_cuda)
            if grouped is not None:
                return grouped
        terms = [_emit_cuda(a, names) for a in e.args]
        if len(terms) >= _PAIRWISE_ADD_MIN_TERMS:
            return _tree_sum(terms)
        return "(" + "+".join(terms) + ")"
    if isinstance(e, sp.Mul):
        return "(" + "*".join(_emit_cuda(a, names) for a in e.args) + ")"
    if isinstance(e, sp.Pow) and e.exp.is_Integer:
        return _int_pow(_emit_cuda(e.base, names), int(e.exp))
    if isinstance(e, sp.Pow) and abs(e.exp) == sp.Rational(1, 2):
        root = f"sqrt({_emit_cuda(e.base, names)})"
        return root if e.exp > 0 else f"(T(1)/{root})"
    return _CudaExprPrinter(names).doprint(e)


def _emit_dd(e: sp.Expr, names: Dict[object, str]) -> str:
    """A wide sum in ``accumulate="dd"`` mode: ``ops.common.dd_plan``'s
    tree over ``csrc/dd.cuh``'s accumulator (``psat::ddv<T>`` a leaf
    printed as in pairwise mode, ``psat::ddk<T>`` a constant as its
    float64 value, ``psat::ddmul`` a left fold, ``psat::ddadd`` the
    balanced pairwise tree), rounded once to ``T`` — the order in which
    the plain version (``ops.common._compile_dd_add``) evaluates it."""
    def emit(node):
        kind, item = node
        if kind == "const":
            return f"psat::ddk<T>({item!r})"
        if kind == "leaf":
            return f"psat::ddv<T>({_emit_cuda(item, names)})"
        parts = [emit(n) for n in item]
        if kind == "mul":
            return functools.reduce(
                lambda a, b: f"psat::ddmul({a}, {b})", parts)
        return pairwise_sum(parts, lambda a, b: f"psat::ddadd({a}, {b})")

    return f"psat::ddto<T>({emit(dd_plan(e))})"


def _read(acc, slot: int, lead: int = 0) -> str:
    """A read of ``acc`` through the reader ``c``: its offsets after
    ``lead`` zero offsets (the leading dims a lifted program gains), and
    zeros up to ``MAX_NDIM``."""
    offs = [0] * lead + list(acc.offsets)
    offs += [0] * (MAX_NDIM - len(offs))
    kind = "ra" if is_adjoint(acc.field) else "rp"
    return f"c.{kind}({slot}, {', '.join(str(o) for o in offs)})"


def _emit_steps(steps, in_slot, out_slot, hoisted=(), lead: int = 0,
                accumulate: str = "pairwise") -> List[str]:
    """Body lines of ``steps`` over a reader ``c``: one ``const T`` local
    per distinct field access (``c.rp``/``c.ra`` of its input slot) and per
    hoisted symbol read (``c.rh(j)``, j = position in ``hoisted``), one per
    subexpression, and ``v[k] = ...`` for each step ``out_slot(step)`` maps
    to output ``k`` (main steps always; subexpressions when the body is the
    hoisting pass); ``lead``: zero offsets before each read's own (a
    lifted program, ``kernel_nd``); ``accumulate="dd"``: wide sums through
    ``_emit_dd``."""
    hoisted = {sym: j for j, sym in enumerate(hoisted)}
    names: Dict[object, str] = {}
    reads: List[str] = []
    lines: List[str] = []
    for step in steps:
        for at in step.atoms:
            if at in names:
                continue
            if isinstance(at, Field.Access):
                if at.field.index_dimensions and not at.index:
                    raise ValueError(
                        f"access {at} to index field must select components")
                names[at] = f"r{len(reads)}"
                slot = in_slot[(at.field.name, at.index)]
                reads.append(f"const T {names[at]} = "
                             f"{_read(at, slot, lead)};")
            elif at in hoisted:
                names[at] = f"r{len(reads)}"
                reads.append(f"const T {names[at]} = c.rh({hoisted[at]});")
        rhs = (_emit_dd(step.rhs, names)
               if is_dd_step(step.rhs, accumulate)
               else _emit_cuda(step.rhs, names))
        k = out_slot(step)
        if step.is_main:
            lines.append(f"v[{k}] = {rhs};")
        else:
            names[step.target] = f"s{len(names)}"
            lines.append(f"const T {names[step.target]} = {rhs};")
            if k is not None:
                lines.append(f"v[{k}] = {names[step.target]};")
    return reads + lines


def _body_struct(name: str, program: StencilProgram, steps=None,
                 hoisted=(), qual: str = "__device__ __forceinline__",
                 lead: int = 0, accumulate: str = "pairwise") -> List[str]:
    """``struct <name>`` whose ``run(c, inside, v)`` evaluates one program
    at one cell through the reader ``c``: ``steps`` (default: the
    program's) inside, then the accumulation epilogue ``v[k] += prev``.
    The same body serves the single-step kernel (global-memory reader,
    ``stencil_step.cuh``) and the chain kernels (shared-memory tile
    readers, ``time_chain.cuh``/``adjoint_chain.cuh``) and, with ``qual``
    ``"inline"``, the generated C kernels (``codegen/c_printer.py``);
    ``lead`` zero offsets go before each read's own (the single step of
    a 1D program, which runs as 2D: ``kernel_nd``); ``accumulate``: the
    wide-sum mode of the body (``"dd"`` only for the single step, whose
    source includes ``csrc/dd.cuh``; the C printer's bodies are pairwise
    whatever the program's mode, as the JAX package's C printer has no
    such mode)."""
    ins, outs = input_planes(program), output_planes(program)
    in_slot = {(f.name, idx): k for k, (f, idx) in enumerate(ins)}
    out_slot = {(f.name, idx): k for k, (f, idx) in enumerate(outs)}
    if not ins:
        raise NotImplementedError(f"{program.name}: program reads no field")
    body = _emit_steps(
        program.steps if steps is None else steps, in_slot,
        lambda s: (out_slot[(s.target.field.name, tuple(s.target.index))]
                   if s.is_main else None), hoisted, lead, accumulate)
    epilogue: List[str] = []
    for f in program.accum_fields:
        if f.name not in program.input_names:
            continue
        for idx in field_components(f):
            prev = Field.Access(f, (0,) * program.ndim, idx)
            epilogue.append(f"v[{out_slot[(f.name, idx)]}] += "
                            f"{_read(prev, in_slot[(f.name, idx)], lead)};")
    ind = " " * 8
    return [
        f"struct {name} {{",
        "    template <typename T, typename C>",
        f"    {qual} static void run(const C& c, bool inside, T* v) {{",
        "        if (inside) {",
        *(ind + "    " + s for s in body),
        "        }",
        *(ind + s for s in epilogue),
        "    }",
        "};",
    ]


# dtype name -> (storage type, compute type, dtype code of the launchers)
STORAGE = {"float32": ("float", "float", 0), "float64": ("double", "double", 1),
           "bfloat16": ("__nv_bfloat16", "float", 2)}
MODES = {"interior": 0, "full": 1, "periodic": 2}
FORMS = ("window", "direct", "strided", "slab")


def access_reach(program: StencilProgram) -> Tuple[List[int], List[int]]:
    """Per-dim (lo, hi) reach of the program's field reads (the
    accumulation epilogue reads the centre)."""
    nd = program.ndim
    lo, hi = [0] * nd, [0] * nd
    for s in program.steps:
        for a in s.atoms:
            if isinstance(a, Field.Access):
                for d, o in enumerate(a.offsets):
                    lo[d] = max(lo[d], -int(o))
                    hi[d] = max(hi[d], int(o))
    return lo, hi


def _middle_rows(lo, hi):
    """The window's middle dims (1 … nd − 2, the kernel's dims) as one
    flattened axis of window rows, the last middle dim fastest: (per dim
    the flattened index's multiplier, per dim its extent lo + hi + 1,
    the number of rows).  2D: no middle dim, one row."""
    nd = len(lo)
    mul, wid, rows = [0] * nd, [1] * nd, 1
    for d in range(nd - 2, 0, -1):
        mul[d], wid[d] = rows, lo[d] + hi[d] + 1
        rows *= wid[d]
    return mul, wid, rows


def window_warps_x(program: StencilProgram) -> int:
    """The warps of a window block along the contiguous dim: all four for
    a 1D program (its leading dim has one row), else one (2D: the four
    warps stack along dim 0; 3D and up: along dim nd − 2)."""
    return 4 if program.ndim == 1 else 1


def window_entries(program: StencilProgram, tile):
    """The window entries the body reads for a thread's R × V cells
    (``csrc/stencil_step.cuh::stencil_window``): ``(rows, halo)`` — the
    (plane, window row, window y) rows whose centre V columns some read
    uses, and the (plane, row, y, column) entries outside the centre —,
    each in window coordinates (offsets shifted by the reach ``lo``), in
    the kernel's dims (``kernel_nd``); y flattens the middle dims
    (``_middle_rows``; 2D: 0, 3D: the offset in y)."""
    r, v = tile
    nd = kernel_nd(program)
    lo, hi = (lift(program, x) for x in access_reach(program))
    mul, _, _ = _middle_rows(lo, hi)
    slot = {(f.name, idx): k for k, (f, idx) in enumerate(
        input_planes(program))}
    reads = set()
    for s in program.steps:
        for a in s.atoms:
            if isinstance(a, Field.Access):
                reads.add((slot[(a.field.name, tuple(a.index))],
                           tuple(lift(program, map(int, a.offsets)))))
    for f in program.accum_fields:
        if f.name in program.input_names:
            for idx in field_components(f):
                reads.add((slot[(f.name, idx)], (0,) * nd))
    lx = lo[nd - 1]
    rows, halo = set(), set()
    for k, o in reads:
        y = sum((o[d] + lo[d]) * mul[d] for d in range(1, nd - 1))
        for j in range(r):
            for c in range(v):
                x = c + o[-1] + lx
                if lx <= x < lx + v:
                    rows.add((k, j + o[0] + lo[0], y))
                else:
                    halo.add((k, j + o[0] + lo[0], y, x))
    return sorted(rows), sorted(halo)


def _window_struct(program: StencilProgram, tile) -> List[str]:
    """``struct PsatWin``: the window design's R × V cells a thread, the
    reads' reach in the kernel's dims (``kernel_nd``), the middle dims'
    flattened window rows (``WY``; ``ylo/ymul/ywid(d)``: the reach below,
    multiplier and extent of middle dim d), the warps along the
    contiguous dim (``XW``), the adjoint planes (``adj(k)``: input plane
    k) and the window entries the body reads (``window_entries``:
    ``NROW`` centre rows, ``row_k/r/y(i)``; ``NHALO`` halo entries,
    ``halo_k/r/y/x(i)``), so the fills load nothing else."""
    r, v = tile
    nd = kernel_nd(program)
    lo, hi = (lift(program, x) for x in access_reach(program))
    mul, wid, wy = _middle_rows(lo, hi)
    adj = [is_adjoint(f) for f, _ in input_planes(program)]
    rows, halo = window_entries(program, tile)
    return ["struct PsatWin {",
            f"    static constexpr int R = {int(r)}, V = {int(v)}, "
            f"WY = {wy}, XW = {window_warps_x(program)};",
            f"    static constexpr int lo[{nd}] = "
            f"{{{', '.join(map(str, lo))}}};",
            f"    static constexpr int hi[{nd}] = "
            f"{{{', '.join(map(str, hi))}}};",
            f"    static constexpr int NROW = {len(rows)}, "
            f"NHALO = {len(halo)};",
            _table("ylo", lo, "d"), _table("ymul", mul, "d"),
            _table("ywid", wid, "d"),
            _table("adj", [int(a) for a in adj], "k"),
            *(_table(f"row_{c}", [e[i] for e in rows] or [0])
              for i, c in enumerate("kry")),
            *(_table(f"halo_{c}", [e[i] for e in halo] or [0])
              for i, c in enumerate("kryx")),
            "};"]


def _variant_defines(dtype: str) -> List[str]:
    if dtype not in STORAGE:
        raise ValueError(f"unknown float type {dtype!r}; one of "
                         f"{sorted(STORAGE)}")
    s, t, code = STORAGE[dtype]
    return [f"#define PSAT_S {s}", f"#define PSAT_T {t}",
            f"#define PSAT_DTYPE {code}"]


def generate_cuda_source(program: StencilProgram, dtype: str = "float32",
                         mode: str = "interior", form: str = "window",
                         tile=(1, 1)) -> str:
    """A translation unit for one variant of the single step: the template
    header, the per-program body ``PsatBody::run`` and the launcher stub,
    instantiated once, for ``dtype`` ("float32", "float64" or "bfloat16"),
    ``mode`` ("interior", "full", "periodic") and ``form``: the window
    design of ``stencil_step.cuh`` ("window", ``tile`` = (R, V) cells a
    thread), the per-cell design there ("direct", or "strided" where an
    extent is above the 65535 blocks a grid dimension holds) or the slab
    kernel ``row_tiled.cuh`` ("slab": scalar fields, interior or full
    mode, 2 or 3 spatial dims).  The window and per-cell designs take any
    rank: a 1D program runs as a 2D one with a leading extent of 1
    (``kernel_nd``), ranks above 3 with every dim its own (the window's
    middle dims flattened into its y axis, the per-cell grid's leading
    dims merged into grid.z and taken apart again by div/mod), so each
    mask, clamp and wrap stays per dim.  Compile with ``-I`` on the
    package's ``csrc/``.  A program compiled with ``accumulate="dd"``
    gets the dd body (``_emit_dd``) in every variant, and asks nvcc not to
    contract a mul and an add into an fma anywhere in it (the leaves too):
    each operation then rounds where the plain version's does."""
    if mode not in MODES or form not in FORMS:
        raise ValueError(f"unknown variant: mode {mode!r}, form {form!r}")
    slab = form == "slab"
    if slab and program.ndim not in (2, 3):
        raise NotImplementedError(
            f"{program.name}: the slab kernel takes 2 or 3 spatial dims, "
            f"got {program.ndim}")
    if slab and mode == "periodic":
        raise ValueError(f"{program.name}: the slab kernel has no periodic "
                         f"mode")
    ins = input_planes(program)
    if slab:
        if any(f.index_dimensions for f, _ in ins):
            raise ValueError(f"{program.name}: the slab kernel takes "
                             f"scalar fields only")
        adj = sum(1 << k for k, (f, _) in enumerate(ins) if is_adjoint(f))
        form_lines = [f"#define PSAT_ADJ {adj}u"]
    elif form == "window":
        form_lines = ["#define PSAT_WINDOW 1",
                      *_window_struct(program, tile)]
    else:
        form_lines = ["#define PSAT_WINDOW 0",
                      f"#define PSAT_STRIDED {int(form == 'strided')}"]
    kernel = "row_tiled" if slab else "stencil_step"
    acc = program.accumulate
    return "\n".join([
        f"// generated from stencil program {program.name!r}: {dtype}, "
        f"{mode}, {form}" + (f" {tuple(tile)}" if form == "window" else "")
        + (", accumulate='dd'" if acc == "dd" else ""),
        f'#include "{kernel}.cuh"',
        *([f"{FLAGS_MARK} --fmad=false", '#include "dd.cuh"']
          if acc == "dd" else []),
        f"#define PSAT_ND {kernel_nd(program)}",
        f"#define PSAT_NIN {len(ins)}",
        f"#define PSAT_NOUT {len(output_planes(program))}",
        *_variant_defines(dtype),
        f"#define PSAT_MODE {MODES[mode]}",
        *form_lines,
        *_body_struct("PsatBody", program,
                      lead=kernel_nd(program) - program.ndim,
                      accumulate=acc),
        f'#include "{kernel}.cu"',
        "",
    ])


def _chain_parts(plan) -> List[str]:
    """The forward half of a chain translation unit: sizes, the hoisting
    pass ``PsatHoist`` (the chain-invariant steps, evaluated once per tile
    into shared-memory planes) and the per-stage forward body ``PsatFwd``
    (the remaining steps, reading hoisted values through ``c.rh``)."""
    prog = plan.program
    in_slot = {(f.name, idx): k for k, (f, idx) in enumerate(plan.planes)}
    hoisted = [s.target for s in plan.hoist_steps]
    hoist = _emit_steps(plan.hoist_steps, in_slot,
                        lambda s: hoisted.index(s.target))
    ind = " " * 8
    return [
        f"#define PSAT_ND {prog.ndim}",
        f"#define PSAT_NS {len(plan.planes)}",
        f"#define PSAT_NOUT {len(plan.out_planes)}",
        f"#define PSAT_NH {len(hoisted)}",
        "struct PsatHoist {",
        "    template <typename T, typename C>",
        "    __device__ __forceinline__ static void run(const C& c, T* v) {",
        *(ind + s for s in hoist),
        "    }",
        "};",
        *_body_struct("PsatFwd", prog, plan.cycle_steps, hoisted),
    ]


def _chain_variant(dtype: str, periodic: bool) -> List[str]:
    """The one (float type, boundary mode) a chain library instantiates."""
    return [*_variant_defines(dtype), f"#define PSAT_PERIODIC {int(periodic)}"]


def generate_chain_source(plan, dtype: str = "float32") -> str:
    """Translation unit of the forward chain kernel for one
    ``ops.time_chain.ChainPlan`` and float type ``dtype``."""
    return "\n".join([
        f"// generated: fused time chain of {plan.program.name!r}, {dtype}",
        '#include "time_chain.cuh"',
        *_chain_parts(plan),
        *_chain_variant(dtype, plan.periodic),
        '#include "time_chain.cu"',
        "",
    ])


def generate_warp_chain_source(plan, dtype: str = "float32",
                               tab=None) -> str:
    """Translation unit of the warp-march chain kernel
    (``csrc/warp_chain.cuh``) for one 2D ``ops.time_chain.ChainPlan`` and
    float type: the forward and hoisting bodies and ``struct PsatWarp``,
    the march's tables (``ops.warp_chain.warp_tables``) as constants."""
    from ..ops.warp_chain import lane_widths, warp_tables

    tab = tab or warp_tables(plan)
    k, ns = plan.k, len(plan.planes)
    vmax = max(lane_widths(8 if dtype == "float64" else 4))
    return "\n".join([
        f"// generated: warp-march chain of {plan.program.name!r}, k={k}, "
        f"{dtype}",
        '#include "warp_chain.cuh"',
        *_chain_parts(plan),
        "struct PsatWarp {",
        f"    static constexpr int K = {k}, NX = {tab.nx}, P = {tab.p}, "
        f"LH = {tab.lh}, LEAD = {tab.lead}, NP = {len(tab.probes)};",
        _table("lag", tab.lag, "s"),
        _table("smap", [x for row in tab.smap for x in row], "i"),
        _table("ostr", [x for row in tab.ostr for x in row], "i"),
        _table("hstr", tab.hstr),
        _table("probe", tab.probes, "q"),
        _table("load", [int(b) for b in tab.load], "n"),
        _table("store", [int(b) for b in tab.store], "n"),
        "};",
        *_chain_variant(dtype, plan.periodic),
        f"#define PSAT_VMAX {vmax}",
        '#include "warp_chain.cu"',
        "",
    ])


def _table(name: str, values: List[int], arg: str = "j") -> str:
    """A constexpr lookup ``name(arg)`` over ``values`` (-1 past the end),
    folded at compile time for the literal slots the bodies use."""
    expr = "-1"
    for i in range(len(values) - 1, -1, -1):
        expr = f"({arg} == {i} ? {values[i]} : {expr})"
    return (f"    __host__ __device__ static constexpr int {name}(int {arg}) "
            f"{{ return {expr}; }}")


def generate_adjoint_source(ap, dtype: str = "float32") -> str:
    """Translation unit of the two-phase adjoint kernel for one
    ``ops.adjoint_chain.AdjointPlan`` and float type ``dtype``: the chain
    parts, the backward body ``PsatBwd`` and ``PsatBwdMeta``, the wiring
    of the backward program's slots onto the state planes."""
    return "\n".join([
        f"// generated: two-phase adjoint chain of {ap.fwd.program.name!r}, "
        f"{dtype}",
        '#include "adjoint_chain.cuh"',
        *_chain_parts(ap.fwd),
        *_bwd_parts(ap),
        *_chain_variant(dtype, ap.fwd.periodic),
        '#include "adjoint_chain.cu"',
        "",
    ])


def _flat_lists(lists) -> Tuple[int, List[int]]:
    """(width, row-major table) of lists padded with -1 to one width."""
    width = max([1] + [len(v) for v in lists])
    return width, [v[q] if q < len(v) else -1 for v in lists
                   for q in range(width)]


def _bwd_parts(ap) -> List[str]:
    """The backward body ``PsatBwd`` and ``PsatBwdMeta``, the wiring of the
    backward program's slots onto the state planes: ``adj(j, q)`` and
    ``pass(m, q)`` are lists per slot (-1 past their end)."""
    maxpass, passes = _flat_lists(ap.pass_to)
    maxadj, adjs = _flat_lists(ap.adj)
    return [
        f"#define PSAT_NIN_B {len(input_planes(ap.bwd))}",
        f"#define PSAT_NOUT_B {max(1, len(output_planes(ap.bwd)))}",
        f"#define PSAT_MAXPASS {maxpass}",
        *_body_struct("PsatBwd", ap.bwd),
        "struct PsatBwdMeta {",
        f"    static constexpr int kMaxAdj = {maxadj};",
        "    // backward input slot -> state plane it reads as a primal",
        _table("prim", ap.prim),
        "    // (backward input slot, q) -> q-th state plane whose cotangent",
        "    // it reads (summed: the carriers of its output)",
        _table("adj_flat", adjs, "i"),
        "    __host__ __device__ static constexpr int adj(int j, int q) "
        "{ return adj_flat(j * kMaxAdj + q); }",
        "    // state plane -> backward output slot holding its gradient",
        _table("grad", ap.grad_slot, "m"),
        "    // (state plane, q) -> q-th plane whose cotangent passes to it",
        _table("pass_flat", passes, "i"),
        "    __host__ __device__ static constexpr int pass(int m, int q) "
        "{ return pass_flat(m * PSAT_MAXPASS + q); }",
        "};",
    ]


def _gather_struct(lv, n_planes: int) -> List[str]:
    """``struct PsatGather``: ``run(c, v)`` sums, for each state plane m,
    its w planes at minus their read offsets (``c.w_at(a, o0, o1, o2)``);
    a plane no read of which has a slot gets 0."""
    lines = []
    for m in range(n_planes):
        terms = [f"c.w_at({a}, "
                 + ", ".join(str(-o) for o in
                             list(offs) + [0] * (MAX_NDIM - len(offs)))
                 + ")" for a, offs in lv.gather[m]]
        lines.append(f"v[{m}] = {_tree_sum(terms) if terms else 'T(0)'};")
    return ["struct PsatGather {",
            "    template <typename T, typename C>",
            "    __device__ __forceinline__ static void run(const C& c, T* v) {",
            *("        " + ln for ln in lines),
            "    }",
            "};"]


def _local_parts(ap) -> List[str]:
    """The local form's L body ``PsatLocal`` (``ops.local_vjp``), the G
    body ``PsatGather`` and ``PsatLocalMeta``: the carriers of each forward
    output plane (``car(j, q)``) and the cotangents passed through
    unchanged to each state plane (``pass(m, q)``)."""
    from ..ops.local_vjp import local_vjp

    lv = local_vjp(ap)
    plan = ap.fwd
    keys = plan.plane_keys
    cars = [[keys.index((n, idx)) for n in ap.feeds_output.get(f.name, [])]
            for f, idx in plan.out_planes]
    maxcar, car_flat = _flat_lists(cars)
    maxpass, pass_flat = _flat_lists(ap.pass_to)
    return [
        f"#define PSAT_NW {max(1, len(lv.slots))}",
        *_body_struct("PsatLocal", lv.program),
        *_gather_struct(lv, len(keys)),
        "struct PsatLocalMeta {",
        f"    static constexpr int kMaxCar = {maxcar};",
        f"    static constexpr int kMaxPass = {maxpass};",
        f"    static constexpr bool kHasPass = "
        f"{str(any(ap.pass_to)).lower()};",
        "    // (forward output plane, q) -> q-th state plane it is carried into",
        _table("car_flat", car_flat, "i"),
        "    __host__ __device__ static constexpr int car(int j, int q) "
        "{ return car_flat(j * kMaxCar + q); }",
        "    // (state plane, q) -> q-th plane whose cotangent passes to it",
        _table("pass_flat", pass_flat, "i"),
        "    __host__ __device__ static constexpr int pass(int m, int q) "
        "{ return pass_flat(m * kMaxPass + q); }",
        "};",
    ]


PLANE_FORMS = {"forward": 0, "gather": 1, "local": 2}


def generate_plane_source(plan, mode: str, dtype: str,
                          form: str = "gather") -> str:
    """Translation unit of the z-streaming chain kernel
    (``csrc/plane_adjoint.cuh``) for one ``mode``: ``"two_phase"`` (``plan``
    an ``ops.adjoint_chain.AdjointPlan``) in ``form`` "gather" (the
    backward body ``PsatBwd``) or "local" (the local-VJP body and the
    gather, ``ops.local_vjp``), or ``"forward"`` (``plan`` an
    ``ops.time_chain.ChainPlan``; ``form`` ignored), specialised to
    ``dtype`` ("float32", "float64" or "bfloat16") and the plan's boundary
    mode.  ``PsatPlaneMeta`` maps each
    state plane to its slot in the rings (``dyn``, -1: chain-invariant,
    read from its input) and names where a stage takes it from: forward
    output ``src_out`` or state plane ``src_in`` (carried unchanged)."""
    two_phase = mode == "two_phase"
    if mode not in ("two_phase", "forward"):
        raise ValueError(f"unknown streaming mode {mode!r}")
    if two_phase and form not in ("gather", "local"):
        raise ValueError(f"unknown two-phase form {form!r}")
    form = form if two_phase else "forward"
    fwd = plan.fwd if two_phase else plan
    dyn, n_dyn = [], 0
    for f, _ in fwd.planes:
        dyn.append(-1 if f.name in fwd.invariant else n_dyn)
        n_dyn += f.name not in fwd.invariant
    srcs = [fwd.src_of(n) for n in range(len(fwd.planes))]
    shard = []
    if fwd.shard is not None:
        from ..ops.flatten import shard_wraps

        shard = ["#define PSAT_SHARD 1"] + [
            f"#define PSAT_WRAP{d} {int(w)}" for d, w in
            enumerate(shard_wraps(fwd.periodic, 3, fwd.shard))]
    return "\n".join([
        f"// generated: z-streaming {mode} chain of {fwd.program.name!r}, "
        f"{form} form, {dtype}, "
        f"{'periodic' if fwd.periodic else 'bounded'}"
        f"{', shard mode' if fwd.shard is not None else ''}",
        *shard,
        '#include "plane_adjoint.cuh"',
        *_chain_parts(fwd),
        *(_bwd_parts(plan) if form == "gather" else []),
        *(_local_parts(plan) if form == "local" else []),
        "struct PsatPlaneMeta {",
        f"    static constexpr int kNDyn = {n_dyn};",
        f"    static constexpr bool kProbes = {str(bool(fwd.probes)).lower()};",
        "    // state plane -> its slot in the state rings (-1: invariant)",
        _table("dyn", dyn, "n"),
        "    // state plane -> forward output it is carried from, or -1",
        _table("src_out", [i if kind == "out" else -1 for kind, i in srcs],
               "n"),
        "    // state plane -> state plane it is carried from unchanged, or -1",
        _table("src_in", [i if kind == "in" else -1 for kind, i in srcs],
               "n"),
        "};",
        *_variant_defines(dtype),
        f"#define PSAT_PERIODIC {int(fwd.periodic)}",
        f"#define PSAT_TWO_PHASE {int(two_phase)}",
        f"#define PSAT_FORM {PLANE_FORMS[form]}",
        '#include "plane_adjoint.cu"',
        "",
    ])


def _slots_struct(name: str, slots) -> List[str]:
    """``struct <name>``: per body input slot, the state plane it reads
    (``src``), or the cotangent plane (``cot``) and whether through the
    masked view (``mask``) — ``ops.twin_adjoint.TwinPlan``'s tables."""
    src, cot, mask = slots
    return [f"struct {name} {{", _table("src", src), _table("cot", cot),
            _table("mask", mask), "};"]


def generate_twin_source(tp, dtype: str = "float32") -> str:
    """Translation unit of the twin-with-accumulation kernel for one
    ``ops.twin_adjoint.TwinPlan`` and float type ``dtype``: the chain
    parts, the cotangent body
    ``PsatCot`` (the transposed op's forward program), the grad body
    ``PsatGrad`` (the coefficient-gradient program; empty for the bounded
    twin of a pure-linear op) and their slot tables."""
    if tp.grad_prog is not None:
        grad = _body_struct("PsatGrad", tp.grad_prog)
    else:
        grad = ["struct PsatGrad {",
                "    template <typename T, typename C>",
                "    __device__ __forceinline__ static void run(const C&, "
                "bool, T*) {}",
                "};"]
    return "\n".join([
        f"// generated: twin-with-accumulation chain of "
        f"{tp.fwd.program.name!r}",
        '#include "twin_accum.cuh"',
        *_chain_parts(tp.fwd),
        f"#define PSAT_NC {len(tp.cot_keys)}",
        f"#define PSAT_NG {len(tp.coeff_keys)}",
        *_body_struct("PsatCot", tp.cot_prog),
        *_slots_struct("PsatCotSlots", tp.cot_slots),
        *grad,
        *_slots_struct("PsatGradSlots", tp.grad_slots),
        *_chain_variant(dtype, tp.fwd.periodic),
        '#include "twin_accum.cu"',
        "",
    ])


def _dtable(name: str, values: List[float], arg: str = "j") -> str:
    """``_table`` for double constants (BC values, lattice weights)."""
    expr = "0.0"
    for i in range(len(values) - 1, -1, -1):
        expr = f"({arg} == {i} ? {float(values[i])!r} : {expr})"
    return (f"    __host__ __device__ static constexpr double {name}(int {arg}) "
            f"{{ return {expr}; }}")


def _zyx3(values, nd: int, fill: int = 0) -> List[int]:
    return [fill] * (3 - nd) + [int(v) for v in values]


_BC_TEMPLATES = {"dirichlet": "Dirichlet", "neumann": "Neumann",
                 "masked_dirichlet": "MaskedDirichlet", "sponge": "Sponge",
                 "bounce_back": "BounceBack"}


def _bc_event(i: int, ev, plan, ap=None) -> List[str]:
    """``PsatBcDesc<i>`` (the event's constants as constexpr tables, every
    per-dim table in (z, y, x) order) and ``PsatEv<i>``, the chain_bc.cuh
    template of its kind over it."""
    bc, nd = ev.bc, plan.nd
    ghost = plan.progs[ev.stage].ghost
    tgt = plan.planes_of(bc.field)
    key = plan.plane_keys

    def plane(name):
        return key.index((name, ())) if isinstance(name, str) else -1

    def cslot(n):
        return ap.cslot[n] if (ap is not None and n >= 0) else -1

    dims = bc.dims if bc.dims is not None else range(nd)
    on = _zyx3([int(d in dims) for d in range(nd)], nd)
    vel = [_zyx3(v, nd) for v in (bc.velocities or ())]
    coef = [6.0 * w * bc.rho_wall for w in (bc.weights or [0.0] * len(vel))]
    uw = list(bc.u_wall) if bc.u_wall is not None else [0.0] * nd
    uwp = _zyx3([plane(u) for u in uw], nd, -1)
    uwv = [0.0] * (3 - nd) + [0.0 if isinstance(u, str) else float(u)
                              for u in uw]
    value = bc.value if not isinstance(bc.value, str) else 0.0
    vplane = plane(bc.value) if isinstance(bc.value, str) else -1
    return [
        f"struct PsatBcDesc{i} {{",
        f"    static constexpr int kNComp = {len(tgt)};",
        _table("target", tgt),
        _table("tcs", [cslot(n) for n in tgt]),
        _table("on", on, "d"),
        _table("glo", _zyx3([lo for lo, _ in ghost], nd), "d"),
        _table("ghi", _zyx3([hi for _, hi in ghost], nd), "d"),
        f"    __host__ __device__ static constexpr double value() "
        f"{{ return {float(value)!r}; }}",
        f"    __host__ __device__ static constexpr int vplane() "
        f"{{ return {vplane}; }}",
        f"    __host__ __device__ static constexpr int vcs() "
        f"{{ return {cslot(vplane)}; }}",
        f"    __host__ __device__ static constexpr int mask() "
        f"{{ return {plane(bc.mask) if bc.mask else -1}; }}",
        _table("opp", list(bc.opposite or [])),
        _table("cz", [v[0] for v in vel]),
        _table("cy", [v[1] for v in vel]),
        _table("cx", [v[2] for v in vel]),
        _dtable("coef", coef),
        f"    __host__ __device__ static constexpr bool has_uw() "
        f"{{ return {str(bc.u_wall is not None).lower()}; }}",
        _table("uwp", uwp, "d"),
        _dtable("uwv", uwv, "d"),
        _table("uwcs", [cslot(n) for n in uwp], "d"),
        "};",
        f"struct PsatEv{i} : psat_bc::{_BC_TEMPLATES[bc.kind]}"
        f"<PsatBcDesc{i}> {{",
        "    static constexpr bool kIsBc = true;",
        f"    static constexpr int kNOut = {len(tgt)};",
        "};",
    ]


def _stage_event(i: int, ev, plan, ap=None) -> List[str]:
    """``PsatFwd<i>`` (the stage's forward body), ``PsatEv<i>`` with its
    input-slot → state-plane table and interior window, and for the
    adjoint ``PsatBwd<i>`` (the backward body) with its slot tables."""
    nd = plan.nd
    prog = plan.progs[ev.stage]
    lines = _body_struct(f"PsatFwd{i}", prog)
    bwd_lines, meta = [], []
    if ap is not None:
        bprog = ap.bwd[ev.stage]
        t = ap.tables[i]
        maxpass, flat = _flat_lists(t["pass"])
        maxadj, adjs = _flat_lists(t["adj"])
        blo, bhi = ap.reach[i]
        bwd_lines = _body_struct(f"PsatBwd{i}", bprog)
        meta = [
            f"    using Bwd = PsatBwd{i};",
            f"    static constexpr int kNOutB = "
            f"{max(1, len(output_planes(bprog)))};",
            f"    static constexpr int kMaxPass = {maxpass};",
            "    // backward input slot -> state plane read as a primal",
            _table("prim", t["prim"]),
            f"    static constexpr int kMaxAdj = {maxadj};",
            "    // (backward input slot, q) -> q-th cotangent slot it reads",
            "    // (summed: the carriers of its output)",
            _table("adj_flat", adjs, "i"),
            "    __host__ __device__ static constexpr int adj(int j, int q) "
            "{ return adj_flat(j * kMaxAdj + q); }",
            "    // cotangent slot -> backward output slot of its gradient",
            _table("grad", t["grad"], "m"),
            "    // (cotangent slot, q) -> q-th slot passing to it",
            _table("pass_flat", flat, "i"),
            "    __host__ __device__ static constexpr int pass(int m, int q) "
            "{ return pass_flat(m * kMaxPass + q); }",
            _table("blo", _zyx3(blo, nd), "d"),
            _table("bhi", _zyx3(bhi, nd), "d"),
        ]
    return lines + bwd_lines + [
        f"struct PsatEv{i} : PsatFwd{i} {{",
        "    static constexpr bool kIsBc = false;",
        f"    static constexpr int kNOut = {ev.nout};",
        _table("in", ev.in_planes),
        _table("glo", _zyx3([lo for lo, _ in prog.ghost], nd), "d"),
        _table("ghi", _zyx3([hi for _, hi in prog.ghost], nd), "d"),
        *meta,
        "};",
    ]


def _stage_parts(plan, ap=None) -> List[str]:
    """Sizes, one ``PsatEv<i>`` per event of a cycle and the visitor
    ``PsatEvents::visit(kind, v)`` that calls ``v(PsatEv<kind>{})``."""
    lines = [
        f"#define PSAT_ND {plan.nd}",
        f"#define PSAT_NS {len(plan.planes)}",
        f"#define PSAT_NE {plan.k * len(plan.cycle)}",
        f"#define PSAT_MAXOUT {max(ev.nout for ev in plan.cycle)}",
    ]
    for i, ev in enumerate(plan.cycle):
        lines += (_bc_event(i, ev, plan, ap) if ev.kind == "bc"
                  else _stage_event(i, ev, plan, ap))
    cases = " ".join(f"case {i}: v(PsatEv{i}{{}}); break;"
                     for i in range(len(plan.cycle)))
    return lines + [
        "struct PsatEvents {",
        "    template <typename V>",
        "    __device__ __forceinline__ static void visit(int kind, "
        "const V& v) {",
        f"        switch (kind) {{ {cases} default: break; }}",
        "    }",
        "};",
    ]


def generate_stage_source(plan, dtype: str = "float32") -> str:
    """Translation unit of kernel 12 (the forward stage chain) for one
    ``ops.stage_chain.StagePlan`` (its k and boundary mode) and float type
    ``dtype``."""
    return "\n".join([
        f"// generated: fused stage chain {plan.name!r}, k={plan.k}, {dtype}",
        '#include "stage_chain.cuh"',
        *_stage_parts(plan),
        *_chain_variant(dtype, plan.periodic),
        '#include "stage_chain.cu"',
        "",
    ])


def generate_stage_adjoint_source(ap, dtype: str = "float32") -> str:
    """Translation unit of kernel 13 (the fused value+gradient stage
    chain) for one ``ops.stage_adjoint.AdjointStagePlan`` and float type
    ``dtype``."""
    return "\n".join([
        f"// generated: fused stage chain adjoint {ap.fwd.name!r}, "
        f"k={ap.fwd.k}, {dtype}",
        '#include "stage_adjoint.cuh"',
        *_stage_parts(ap.fwd, ap),
        f"#define PSAT_NC {len(ap.cot_planes)}",
        *_chain_variant(dtype, ap.fwd.periodic),
        '#include "stage_adjoint.cu"',
        "",
    ])


def _march_stage_event(i: int, ev, mp) -> List[str]:
    """``PsatEv<i>`` of a stage for the march (``csrc/stage_march.cuh``):
    its forward body, its interior window in march coordinates and, in
    two-phase mode, its reverse form's bodies and tables: the backward
    program (gather form) or the local-VJP body ``PsatLoc<i>`` with the
    gather ``PsatGth<i>`` over the cotangent slots (local form)."""
    from ..ops.stage_march import _m3

    plan, ap = mp.plan, mp.ap
    nd = plan.nd
    prog = plan.progs[ev.stage]
    form = mp.forms[ev.stage] if ap is not None else None
    lines = _body_struct(f"PsatFwd{i}", prog)
    meta = [f"    static constexpr bool kHasBwd = "
            f"{str(form == 'gather').lower()};",
            f"    static constexpr bool kHasLoc = "
            f"{str(form == 'local').lower()};"]
    if ap is not None:
        t = ap.tables[i]
        maxpass, flat = _flat_lists(t["pass"])
        meta += [
            f"    static constexpr int kMaxPass = {maxpass};",
            "    // (cotangent slot, q) -> q-th slot passing to it",
            _table("pass_flat", flat, "i"),
            "    __host__ __device__ static constexpr int pass(int m, int q) "
            "{ return pass_flat(m * kMaxPass + q); }",
        ]
    if form == "gather":
        bprog = ap.bwd[ev.stage]
        maxadj, adjs = _flat_lists(t["adj"])
        blo, bhi = ap.reach[i]
        lines += _body_struct(f"PsatBwd{i}", bprog)
        meta += [
            f"    using Bwd = PsatBwd{i};",
            f"    static constexpr int kNOutB = "
            f"{max(1, len(output_planes(bprog)))};",
            "    // backward input slot -> state plane read as a primal",
            _table("prim", t["prim"]),
            f"    static constexpr int kMaxAdj = {maxadj};",
            _table("adj_flat", adjs, "i"),
            "    __host__ __device__ static constexpr int adj(int j, int q) "
            "{ return adj_flat(j * kMaxAdj + q); }",
            "    // cotangent slot -> backward output slot of its gradient",
            _table("grad", t["grad"], "m"),
            _table("blo", _m3(blo, nd), "d"),
            _table("bhi", _m3(bhi, nd), "d"),
        ]
    elif form == "local":
        lv = mp.local[ev.stage]
        nc = len(ap.cot_planes)
        cars = [[ap.cslot[n] for n, s in enumerate(ev.src)
                 if s == ("out", o) and ap.cslot[n] >= 0]
                for o in range(ev.nout)]
        maxcar, car_flat = _flat_lists(cars)
        gl = []
        for m in range(nc):
            terms = [f"c.w_at({a}, "
                     + ", ".join(str(-o) for o in
                                 list(offs) + [0] * (MAX_NDIM - len(offs)))
                     + ")" for a, (ms, offs) in enumerate(lv.slots)
                     if ap.cslot[ev.in_planes[ms]] == m]
            gl.append(f"v[{m}] = {_tree_sum(terms) if terms else 'T(0)'};")
        lines += _body_struct(f"PsatLoc{i}", lv.program) + [
            f"struct PsatGth{i} {{",
            "    template <typename T, typename C>",
            "    __device__ __forceinline__ static void run(const C& c, T* v) {",
            *("        " + ln for ln in gl),
            "    }",
            "};"]
        meta += [
            f"    using Loc = PsatLoc{i};",
            f"    using Gth = PsatGth{i};",
            f"    static constexpr int kNW = {max(1, len(lv.slots))};",
            f"    static constexpr int kMaxCar = {maxcar};",
            "    // (forward output plane, q) -> q-th cotangent slot of a",
            "    // state plane it is carried into",
            _table("car_flat", car_flat, "i"),
            "    __host__ __device__ static constexpr int car(int o, int q) "
            "{ return car_flat(o * kMaxCar + q); }",
        ]
    return lines + [
        f"struct PsatEv{i} : PsatFwd{i} {{",
        "    static constexpr bool kIsBc = false;",
        f"    static constexpr int kNOut = {ev.nout};",
        f"    static constexpr int kNIn = {len(input_planes(prog))};",
        _table("in", ev.in_planes),
        _table("mlo", _m3([lo for lo, _ in prog.ghost], nd), "d"),
        _table("mhi", _m3([hi for _, hi in prog.ghost], nd), "d"),
        *meta,
        "};",
    ]


def _march_part(x: int, part, mp, lay) -> List[str]:
    """``PsatPart<x>``: part x of the march with its tables as constexpr
    functions (``csrc/stage_march.cuh``)."""
    from ..ops.stage_march import FOLDLIKE, S, SC

    ns = len(mp.plan.planes)
    nc = len(mp.ap.cot_planes) if mp.ap is not None else 0
    src = part.src or [None] * ns
    csrc = part.csrc or [None] * nc
    nfold = sum(1 for q in mp.parts if q.kind in FOLDLIKE and q.host == x)
    lo, hi = lay["ext"][x]
    ev = part.ev if part.kind not in (S, SC) else 0
    return [
        "template <>",
        f"struct PsatPart<{x}> {{",
        f"    using Ev = PsatEv{ev};",
        f"    static constexpr int kKind = {part.kind};",
        f"    static constexpr int kRing = {part.ring};",
        "    // output j -> its plane in the ring",
        _table("op", part.out_planes(), "j"),
        f"    static constexpr int kNOut = {part.nout};",
        f"    static constexpr int kWRing = {part.wring};",
        f"    static constexpr int kNFold = {nfold};",
        "    // a barrier follows the part; the stage whose probe cotangents",
        "    // join what it writes (-1: none)",
        f"    static constexpr bool kSync = {str(part.sync).lower()};",
        f"    static constexpr int kProbeStage = {part.probe_stage};",
        "    using Probes = PsatProbes;",
        _table("elo", list(lo), "d"),
        _table("ehi", list(hi), "d"),
        "    // state plane -> ring and plane holding it before the event",
        _table("sr", [v[0] if v else -1 for v in src], "n"),
        _table("sp", [v[1] if v else -1 for v in src], "n"),
        "    // cotangent slot -> ring and plane holding it after the event",
        _table("cr", [v[0] if v else -1 for v in csrc], "m"),
        _table("cp", [v[1] if v else -1 for v in csrc], "m"),
        "    // output j -> the cotangent slot it is",
        _table("wr", list(part.writes or []), "j"),
        "};",
    ]


def _march_shard_defines(plan) -> List[str]:
    """The march's shard mode (``plan.shard``, an ``ops.flatten.ShardSpec``)
    and the march dims (2D: dim 0 and x; 3D: z, y, x) a periodic chain
    wraps in it: every dim the shard keeps whole.  Empty for an unsharded
    plan (the header's defaults)."""
    if plan.shard is None:
        return []
    from ..ops.flatten import shard_wraps

    w = shard_wraps(plan.periodic, plan.nd, plan.shard)
    w3 = (w[0], plan.periodic, w[1]) if plan.nd == 2 else w
    return ["#define PSAT_SHARD 1"] + [
        f"#define PSAT_WRAP{d} {int(x)}" for d, x in enumerate(w3)]


def generate_stage_march_source(mg, dtype: str = "float32") -> str:
    """Translation unit of the march kernel (``csrc/stage_march.cuh``) for
    one ``ops.stage_march.MarchGeometry``: kernel 12 (forward mode, no
    ``ap``) or kernel 13 (two-phase mode, each stage's reverse in its
    form), specialised to ``dtype``, the plan's boundary mode and the
    march's threads a block (``PSAT_THREADS``: 256, 512 or 1024).  The
    parts, their tables and extents, the rings' planes and lateral
    origins and the march's geometry — chunk, tile, lags, ring offsets,
    depths and widths — are constants here, so that every read's ring
    address folds; the launcher checks them against the ``geo`` block of
    ``stage_march_geometry``, which also carries the shape, the segments
    and the probe rows."""
    from ..ops.stage_march import FOLD, IN_COT, IN_STATE, march_layout

    mp, threads = mg.program, mg.threads
    plan, ap = mp.plan, mp.ap
    lay = march_layout(mp)
    in_folds = [x for x, p in enumerate(mp.parts)
                if p.kind == FOLD and p.host < 0]
    ext_a = lay["ring_ext"][IN_STATE]
    ext_b = lay["ring_ext"][IN_COT] if ap is not None else ([0] * 3,
                                                            [0] * 3)
    stored = [int(n in mp.dyn) for n in range(len(plan.planes))]
    lines = [
        f"// generated: stage chain march {plan.name!r}, k={plan.k}, "
        f"{'two-phase ' + '/'.join(mp.forms) if ap is not None else 'forward'}"
        f", {dtype}{', shard mode' if plan.shard is not None else ''}",
        *_march_shard_defines(plan),
        '#include "stage_march.cuh"',
        f"#define PSAT_ND {plan.nd}",
        f"#define PSAT_NS {len(plan.planes)}",
        f"#define PSAT_NCOT {len(ap.cot_planes) if ap is not None else 0}",
        f"#define PSAT_NC {max(1, len(ap.cot_planes)) if ap is not None else 1}",
        f"#define PSAT_NP {len(mp.parts)}",
        f"#define PSAT_NR {len(mp.ring_planes)}",
        f"#define PSAT_TWO_PHASE {int(ap is not None)}",
        f"#define PSAT_A_LO0 {ext_a[0][0]}",
        f"#define PSAT_A_HI0 {ext_a[1][0]}",
        f"#define PSAT_B_LO0 {ext_b[0][0]}",
        f"#define PSAT_B_HI0 {ext_b[1][0]}",
        f"#define PSAT_IN_FOLD0 {in_folds[0] if in_folds else 0}",
        f"#define PSAT_N_IN_FOLD {len(in_folds)}",
        f"#define PSAT_THREADS {int(threads)}",
        f"#define PSAT_MIN_BLOCKS {mg.blocks_per_sm}",
        "// probe q: the cotangent slot its row joins (two-phase mode) or",
        "// the state plane it records (forward mode); rows: in geo",
        "struct PsatProbes {",
        f"    static constexpr int kN = {len(plan.probes)};",
        f"    static constexpr int kLast = {plan.k - 1};",
        _table("slot", list(mp.probe_slots), "q"),
        _table("plane", [n for n, _ in plan.probes], "q"),
        "};",
    ]
    for i, ev in enumerate(plan.cycle):
        lines += (_bc_event(i, ev, plan, ap) if ev.kind == "bc"
                  else _march_stage_event(i, ev, mp))
    lines += [
        "struct PsatRings {",
        f"    static constexpr int kNDyn = {len(mp.dyn)};",
        f"    static constexpr int kNInv = {len(mp.inv)};",
        "    // ring -> planes, lateral origin (y, x)",
        _table("planes", list(mp.ring_planes), "r"),
        _table("lo1", [a for a, _ in lay["ring_lo"]], "r"),
        _table("lo2", [b for _, b in lay["ring_lo"]], "r"),
        "    // input rings: their planes -> state planes",
        _table("dyn", list(mp.dyn), "q"),
        _table("inv", list(mp.inv), "q"),
        "    // state plane -> whether state_k holds it (not invariant)",
        _table("stored", stored, "n"),
        "    // the march's geometry: chunk, tile, per ring its offset,",
        "    // depth, extents and writer lag, per part its lag",
        f"    static constexpr int kChunk = {mg.chunk};",
        f"    static constexpr int kT0 = {mg.tile[0]};",
        f"    static constexpr int kT1 = {mg.tile[1]};",
        _table("off", [r[0] for r in mg.rings], "r"),
        _table("depth", [r[1] for r in mg.rings], "r"),
        _table("ry", [r[2] for r in mg.rings], "r"),
        _table("rx", [r[3] for r in mg.rings], "r"),
        _table("rlag", [r[4] for r in mg.rings], "r"),
        _table("plag", list(mg.lags), "x"),
        "};",
    ]
    for x, part in enumerate(mp.parts):
        lines += _march_part(x, part, mp, lay)
    return "\n".join(lines + [
        *_chain_variant(dtype, plan.periodic),
        '#include "stage_march.cu"',
        "",
    ])
