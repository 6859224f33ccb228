"""C source for one ``StencilProgram``: the generated CPU kernels.

The port of ``pystencils_autodiff_tpu/codegen/c_printer.py``: a program is
printed as one translation unit holding an OpenMP loop nest over the
domain, compiled with g++ by ``codegen/jit.py`` and called through ctypes
(``backends/_c_native.py``) or from the framework extensions
(``backends/astnodes.py``).  The arithmetic is the CUDA printer's
(``cuda_printer._body_struct``: one ``const T`` local per distinct read and
per subexpression, the plain version's grouping and pairwise trees), so the
C kernels, the CUDA kernels and the plain version sum in one order; only
the reader differs.  Build without ``-ffast-math``, which would reorder
the sums.

Two domain modes, as ``ops/common.py``'s:

* ``interior``: the outputs are zeroed by ``memset``, then ``lo ≤ i < S−hi``
  is written;
* ``full``: every cell is written; reads outside the domain are zero for
  adjoint fields and edge-clamped for primal fields (the exact VJP; the
  caller masks the cotangents to the forward interior first).

Indexing is AoS only (trailing index dims); a ``layout="soa"`` field
raises.  A non-row-major spatial layout (``layout="f"``) is indexed in
logical order, as the JAX package's C kernels index it: the caller passes
arrays in logical order.

The kernel's C signature is the JAX package's: every input pointer, then
every output pointer, then ``const long long* shape``.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..ops.common import StencilProgram
from .cuda_printer import _body_struct, input_planes, output_planes

__all__ = ["generate_c_source", "kernel_symbol_name", "c_preamble", "CTYPE"]

CTYPE = {np.dtype("float64"): "double", np.dtype("float32"): "float"}

_PREAMBLE = """\
#ifndef PSAT_C_PREAMBLE
#define PSAT_C_PREAMBLE
#include <string.h>
#include <cmath>
namespace psat_c {
// the input planes of a kernel: base pointer (array + index component)
// and components a cell, and the domain's extents
template <typename T, int NIN>
struct Table {
    const T* base[NIN];
    long long stride[NIN];
    long long s[3];
};
// reads of one cell (i0, i1, i2): rp a primal read, ra an adjoint read;
// FULL: primal reads edge-clamped, adjoint reads zero outside the domain
template <typename T, int NIN, int ND, bool FULL>
struct Reader {
    const Table<T, NIN>* t;
    long long i0, i1, i2;
    static inline long long clamp(long long x, long long n) {
        return x < 0 ? 0 : (x >= n ? n - 1 : x);
    }
    inline long long at(int k, long long j0, long long j1,
                        long long j2) const {
        long long lin = j0;
        if (ND > 1) lin = lin * t->s[1] + j1;
        if (ND > 2) lin = lin * t->s[2] + j2;
        return lin * t->stride[k];
    }
    inline T rp(int k, int o0, int o1, int o2) const {
        long long j0 = i0 + o0, j1 = i1 + o1, j2 = i2 + o2;
        if (FULL) {
            j0 = clamp(j0, t->s[0]);
            if (ND > 1) j1 = clamp(j1, t->s[1]);
            if (ND > 2) j2 = clamp(j2, t->s[2]);
        }
        return t->base[k][at(k, j0, j1, j2)];
    }
    inline T ra(int k, int o0, int o1, int o2) const {
        long long j0 = i0 + o0, j1 = i1 + o1, j2 = i2 + o2;
        if (FULL && (j0 < 0 || j0 >= t->s[0]
                     || (ND > 1 && (j1 < 0 || j1 >= t->s[1]))
                     || (ND > 2 && (j2 < 0 || j2 >= t->s[2]))))
            return T(0);
        return t->base[k][at(k, j0, j1, j2)];
    }
};
}  // namespace psat_c
#endif
"""


def c_preamble() -> str:
    """The includes and the reader every generated kernel uses (guarded:
    a translation unit may hold several kernels)."""
    return _PREAMBLE


def kernel_symbol_name(program: StencilProgram, full_domain: bool) -> str:
    return re.sub(r"\W", "_", f"{program.name}_"
                  f"{'full' if full_domain else 'interior'}")


def _check_layouts(program: StencilProgram) -> None:
    for f in list(program.input_fields) + list(program.output_fields):
        if getattr(f, "index_major", False):
            # the loop nest linearises index dims TRAILING (AoS); an
            # index-major ('soa') array would be silently mis-indexed
            raise NotImplementedError(
                f"native C backends index AoS (trailing index dims) only; "
                f"field {f.name!r} uses layout='soa'. Rebuild the op with "
                f"the default layout for the C/torch/TF-native paths.")


def generate_c_source(program: StencilProgram, full_domain: bool,
                      dtype=np.float64, openmp: bool = True,
                      preamble: bool = True, extern_c: bool = False) -> str:
    """A self-contained C++ translation unit for the program: the reader
    (``preamble=False`` leaves it out, for a unit that printed it
    before), the program's body and ``void <kernel_symbol_name>(inputs...,
    outputs..., const long long* shape)`` (with C linkage where
    ``extern_c``: the ctypes route)."""
    _check_layouts(program)
    nd = program.ndim
    if nd not in (1, 2, 3):
        raise NotImplementedError(f"{program.name}: the C kernels take 1 to "
                                  f"3 spatial dims, got {nd}")
    ctype = CTYPE[np.dtype(dtype)]
    name = kernel_symbol_name(program, full_domain)
    ins, outs = input_planes(program), output_planes(program)
    in_names = program.input_names
    # an accumulation that adds to a given previous array: the interior
    # mode then also writes the ghost frame (the previous value), as the
    # plain version does
    accum_in = any(f.name in in_names for f in program.accum_fields)
    loop_all = full_domain or accum_in

    args = [f"const {ctype}* __restrict__ {f.name}"
            for f in program.input_fields]
    args += [f"{ctype}* __restrict__ {f.name}_out"
             for f in program.output_fields]
    args.append("const long long* shape")

    def comps(f) -> int:
        return int(np.prod(f.index_shape)) if f.index_shape else 1

    def flat(f, idx) -> int:
        k = 0
        for i, n in zip(idx, f.index_shape):
            k = k * n + i
        return k

    lines: List[str] = [_PREAMBLE] if preamble else []
    lines.append(f"namespace psat_body_{name} {{")
    lines.append("using namespace std;")
    lines += _body_struct("PsatBody", program, qual="inline")
    lines.append("}")
    lines.append("")
    link = 'extern "C" ' if extern_c else ""
    lines.append(f"{link}void {name}({', '.join(args)})")
    lines.append("{")
    for d in range(nd):
        lines.append(f"    const long long s{d} = shape[{d}];")
    total = " * ".join(f"s{d}" for d in range(nd))
    lines.append(f"    psat_c::Table<{ctype}, {len(ins)}> tab;")
    for k, (f, idx) in enumerate(ins):
        lines.append(f"    tab.base[{k}] = {f.name} + {flat(f, idx)}; "
                     f"tab.stride[{k}] = {comps(f)};")
    for d in range(3):
        lines.append(f"    tab.s[{d}] = {f's{d}' if d < nd else 1};")
    if not full_domain:
        for f in program.output_fields:
            mult = f" * {comps(f)}" if comps(f) != 1 else ""
            lines.append(f"    memset({f.name}_out, 0, "
                         f"(size_t)({total}{mult}) * sizeof({ctype}));")
    bounds, inside = [], []
    for d in range(nd):
        lo, hi = program.ghost[d]
        top = f"s{d} - {hi}" if hi else f"s{d}"
        if loop_all:
            bounds.append(("0", f"s{d}"))
            if not full_domain:
                inside.append(f"i{d} >= {lo} && i{d} < {top}")
        else:
            bounds.append((str(lo), top))
    ind = "    "
    if openmp and nd >= 2:
        lines.append(f"    #pragma omp parallel for collapse({min(nd, 2)}) "
                     f"schedule(static)")
    for d in range(nd):
        lo, hi = bounds[d]
        lines.append(f"{ind * (d + 1)}for (long long i{d} = {lo}; i{d} < "
                     f"{hi}; ++i{d}) {{")
    body = ind * (nd + 1)
    idx3 = ", ".join(f"i{d}" if d < nd else "0" for d in range(3))
    mode = "true" if full_domain else "false"
    lines.append(f"{body}const psat_c::Reader<{ctype}, {len(ins)}, {nd}, "
                 f"{mode}> c{{&tab, {idx3}}};")
    lines.append(f"{body}{ctype} v[{len(outs)}] = {{}};")
    cond = " && ".join(inside) if inside else "true"
    lines.append(f"{body}psat_body_{name}::PsatBody::run(c, {cond}, v);")
    lin = "i0"
    for d in range(1, nd):
        lin = f"({lin}) * s{d} + i{d}"
    for k, (f, idx) in enumerate(outs):
        off = f"({lin}) * {comps(f)} + {flat(f, idx)}" if comps(f) != 1 \
            else lin
        lines.append(f"{body}{f.name}_out[{off}] = v[{k}];")
    for d in reversed(range(nd)):
        lines.append(f"{ind * (d + 1)}}}")
    lines.append("}")
    lines.append("")
    return "\n".join(lines)
