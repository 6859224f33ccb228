"""CUDA lowering: a stencil program → the hand-written single-step kernel.

``make_cuda_stencil`` is the port of
``pystencils_autodiff_tpu/ops/pallas_kernel.py::make_pallas_stencil`` and
its kernel, ``csrc/stencil_step.cuh``, replaces the four single-step Pallas
kernels there:

* ``_run_whole_array`` (every field one VMEM block, small arrays),
* ``_run_blocked`` (row blocks + halo strips: forward interior-write,
  full-domain exact VJP with fused cotangent mask, 2D periodic),
* ``_run_plane_single`` (3D forward in dim-0 plane tiles, periodic in 3D),
* ``_run_plane_full`` (3D full-domain exact VJP with fused mask).

Their *semantics* are carried over; their tiling (flattened rows, halo
strips, roll+iota shifts, VMEM budgets) is not.

Bound: the least traffic is each operand read once and each output written
once, and the arithmetic is a few flops per access, so the roofline is
memory bandwidth.  Design (the window form): a thread computes R
cells along the outermost dim by V along the contiguous one from a window
of registers that it loads once per plane (``window_tile`` is the
reckoning of R and V); a block's tile is interior (no clamp, no mask, one
base pointer a row, 16-byte loads where the plane allows) or edge (clamped,
masked or wrapped coordinates), the same answer for the whole block; a
1D grid of one block a tile walks them grid-stride.  The per-cell design —
one thread a cell, every read computing its int64 offset and, in FULL
mode, clamping and masking — is kept behind ``form="cell"`` for the
in-turns comparison.  ``strategy="tiled"`` runs the slab form instead
(``csrc/row_tiled.cuh``, the port of ``_run_row_tiled``): shared-memory
slabs that apply the clamp and the mask once, at load.

The wrapper checks device, dtype (float32, float64 or bfloat16 — stored
as bf16, computed in float; anything else raises) and every input's
storage shape (rank, index dims, the shared spatial shape); any strides
are read in place.  It allocates outputs with ``torch.empty``, launches on
the current stream, and raises if the launch is refused.  ``LAUNCHES``
counts launches; ``LAUNCH_CALLS`` splits them by the call that made them:
(program name, full_domain, periodic, spatial shape, bytes per element,
route, form: "window" for the window kernel, "cell" for the per-cell
kernel, "slab" for the slab kernel).  The route is the window's cells a
thread ("r2v4": R = 2, V = 4), the per-cell kernel's grid form ("direct"
or "strided") or the slab kernel's copy width ("w16", "w8", "w4", or
"elem" per element: ``row_tiled.slab_route``, from the tensors' pointers
and strides), with ``_dd`` at its end for a program compiled with
``accumulate="dd"``.
"""

from __future__ import annotations

import ctypes
import math
import re
from collections import Counter
from typing import Dict, List

import torch

from ..codegen.cuda_printer import (generate_cuda_source, input_planes,
                                    kernel_nd, lift, output_planes,
                                    window_warps_x)
from ..utils.config import log_lowering_decision
from .launch import Ptrs, empty, exporting, real, run
from .common import (StencilProgram, field_components, is_adjoint,
                     storage_shape, storage_spatial)

__all__ = ["make_cuda_stencil", "on_device", "reset_launch_counts",
           "LAUNCHES", "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()

_MODES = {"interior": 0, "full": 1, "periodic": 2}
# dtype codes of every launcher (codegen/cuda_printer.py::STORAGE): bf16 is
# stored as bf16 and computed (and tiled in shared memory) in float
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.bfloat16: "bfloat16"}
GRID_CAP = 65535  # blocks a grid's y or z dimension holds
# the extent of every dim at which a shape-polymorphic export picks its
# window tile: a shape that fills the card, as served shapes do
FILL_EXTENT = 8192


def tile_itemsize(t: torch.Tensor) -> int:
    """Bytes of one element of ``t``'s compute type, the type the kernels
    keep in shared memory: bf16 storage is tiled in float."""
    return 8 if t.dtype == torch.float64 else 4


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES`` and clear ``LAUNCH_CALLS``, this module's launch
    counters."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def _spatial_axes(f):
    """(spatial axes, index axes) of a field's storage-layout tensor."""
    sd, ni = f.spatial_dimensions, f.index_dimensions
    if getattr(f, "index_major", False):
        return list(range(ni, ni + sd)), list(range(ni))
    return list(range(sd)), list(range(sd, sd + ni))


def _check_inputs(program: StencilProgram, inputs: Dict[str, torch.Tensor]):
    f0 = program.input_fields[0]
    a0 = inputs[f0.name]
    if not isinstance(a0, torch.Tensor) or a0.device.type != "cuda":
        raise ValueError(f"{program.name}: the CUDA lowering takes CUDA "
                         f"tensors; got {getattr(a0, 'device', type(a0))}")
    if a0.dtype not in _DTYPES:
        raise NotImplementedError(
            f"{program.name}: the CUDA stencil kernel takes float32, "
            f"float64 or bfloat16 tensors, got {a0.dtype}")
    spatial = storage_spatial(f0, a0)
    for f in program.input_fields:
        if f.name not in inputs:
            raise KeyError(f"{program.name}: missing input {f.name!r}")
        t = inputs[f.name]
        if t.device != a0.device or t.dtype != a0.dtype:
            raise ValueError(
                f"{program.name}: input {f.name!r} is {t.dtype} on "
                f"{t.device}; expected {a0.dtype} on {a0.device}")
        if tuple(t.shape) != storage_shape(f, spatial):
            raise ValueError(
                f"{program.name}: input {f.name!r} has shape "
                f"{tuple(t.shape)}, expected {storage_shape(f, spatial)}")
    return a0, spatial


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its kernel for tensor ``t`` (a CUDA tensor)
    or its plain version (a CPU tensor)."""
    return t.device.type == "cuda"


def on_device(kernel, plain, first_name: str):
    """``fn(inputs, *rest)`` running ``kernel`` when the input named
    ``first_name`` lies on a CUDA device and ``plain`` when it lies on the
    CPU; nothing is moved between devices."""
    def fn(inputs, *rest):
        run = kernel if on_card(inputs[first_name]) else plain
        return run(inputs, *rest)
    return fn


def _device_stream(t: torch.Tensor):
    """(device index, current stream handle) for a launch on ``t``'s card."""
    device = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return device, torch.cuda.current_stream(t.device).cuda_stream


def _plane_args(planes, tensors, nd, zyx=False):
    """Pointers (each plane's tensor and its component's offset) and
    spatial strides of each (field, component) plane, in kernel slot
    order: ``nd`` strides a plane (stride 0 for the leading dims a lifted
    program gains, ``kernel_nd``); ``zyx``: three strides a plane, (z, y,
    x), z = 0 for a 2D domain."""
    ptrs, strides = Ptrs(), []
    for f, idx in planes:
        t = tensors[f.name]
        sp_axes, idx_axes = _spatial_axes(f)
        ptrs.append((t, sum(int(i) * t.stride(a)
                            for i, a in zip(idx, idx_axes))))
        strides.extend([0] * ((3 if zyx else nd) - len(sp_axes))
                       + [t.stride(a) for a in sp_axes])
    return ptrs, strides


STRATEGIES = (None, "blocked", "whole", "plane", "plane_full", "tiled")
STEP_FORMS = (None, "cell")
# the window kernel: a body of more operations a cell than this takes one
# cell a thread (its code is instantiated R·V times); otherwise R × V
# cells, the most whose live window registers (the entries its reads use,
# 32-bit registers) and outputs stay within WINDOW_REGS
WINDOW_HEAVY_OPS = 128
WINDOW_REGS = 96
WINDOW_ROWS = (4, 2, 1)
# the most cells along the contiguous dim a thread takes, by spatial dims:
# in 2D two columns (8-byte float32 loads) came within 1–10 % of the best
# tile at every float32 shape of the in-turns comparison, four lost up to
# 18 % where a row is no whole number of 16-byte vectors; and at most
# this many bytes of them: in 2D float64 one column a lane (4 × 1) beat
# two (4 × 2) by 7–8 % on the forward and tied on the backward (PERF.md
# §6)
WINDOW_LANES = {2: 2, 3: 4}
WINDOW_LANE_BYTES = {2: 8, 3: 16}


def window_extent(tile, nd: int, xw: int = 1) -> List[int]:
    """A block's tile of the window kernel (cells per dim, outermost
    first, in the kernel's ``nd`` dims) for (R, V) cells a thread: 2D
    (4/xw)·R × 32·xw·V (``xw`` warps along the columns: 4 for a 1D
    program, ``window_warps_x``), 3D R × 4 × 32V, above R × 1 … × 4 ×
    32V (``WinShape::tile`` in csrc/stencil_step.cuh)."""
    r, v = tile
    if nd == 2:
        return [4 // xw * r, 32 * xw * v]
    return [r] + [1] * (nd - 3) + [4, 32 * v]


def window_geometry(program: StencilProgram, spatial, mode: str, tile,
                    alo, ahi, wlo, whi) -> List[int]:
    """The window kernel's tile reckoning, the int64 block its launcher
    reads after the domain's: tiles per dim, then per dim the origins
    [smin, smax] of the *interior* tiles — those whose reads all lie in
    the array (where adjoint planes are read, in the adjoint window
    [alo, ahi) — it lies inside the array) and, in interior mode, whose
    cells all lie in the write window [wlo, whi).  A tile is interior iff
    its origin lies in [smin, smax] in every dim: the same answer for
    every thread of its block.  Every per-dim argument is in the
    kernel's dims (``kernel_nd``: a 1D program's leading extent of 1
    first)."""
    from ..codegen.cuda_printer import access_reach

    lo, hi = (lift(program, x) for x in access_reach(program))
    ext = window_extent(tile, kernel_nd(program), window_warps_x(program))
    adj = any(is_adjoint(f) for f, _ in input_planes(program))
    nt, smin, smax = [], [], []
    for d, (n, t) in enumerate(zip(spatial, ext)):
        a, b = 0, n
        if mode != "periodic" and adj:
            a, b = torch.sym_max(alo[d], 0), torch.sym_min(ahi[d], n)
        s0, s1 = a + lo[d], torch.sym_min(b - hi[d], n) - t
        if mode == "interior":
            s0, s1 = (torch.sym_max(s0, wlo[d]),
                      torch.sym_min(s1, whi[d] - t))
        nt.append(-(-n // t))
        smin.append(s0)
        smax.append(s1)
    return nt + smin + smax


def interior_tiles(geo, tile, nd: int, xw: int = 1) -> int:
    """How many tiles of a ``window_geometry`` block are interior (``nd``
    the kernel's dims, ``xw`` its warps along the columns)."""
    nt, smin, smax = geo[:nd], geo[nd:2 * nd], geo[2 * nd:]
    ext = window_extent(tile, nd, xw)
    return math.prod(sum(1 for i in range(nt[d])
                         if smin[d] <= i * ext[d] <= smax[d])
                     for d in range(nd))


def window_tile(program: StencilProgram, spatial, itemsize: int):
    """The window kernel's (R, V) for ``program`` at ``spatial`` with
    ``itemsize``-byte storage: of V cells along the contiguous dim (at
    most ``WINDOW_LANE_BYTES`` of storage and ``WINDOW_LANES``, and no
    more than a warp's share of the extent) by R along the outermost dim
    (``WINDOW_ROWS``), the most cells whose live window entries
    (``window_entries``) and outputs fit ``WINDOW_REGS`` 32-bit
    registers, ties to the squarer tile, then the larger R; a body of
    more than ``WINDOW_HEAVY_OPS`` operations a cell takes (1, 1), and so
    does a grid of fewer such tiles than the card has SMs: there a
    thread's chain of loads is the time, and 1 × 1 ran as fast as the per-cell
    kernel on the card alone, R × V up to 1.5× slower (64², 16²).  The
    rule is the in-turns comparison's (``chip_smoke.py --window-ab``,
    PERF.md §6).  A 1D program takes R = 1 (its leading extent is 1) and
    the 2D lanes; ranks above 3 the 3D lanes."""
    import sympy as sp

    from ..codegen.cuda_printer import window_entries

    if sum(int(sp.count_ops(s.rhs)) for s in program.steps) \
            > WINDOW_HEAVY_OPS:
        return (1, 1)
    words = 2 if itemsize == 8 else 1
    nout = sum(len(field_components(f)) for f in program.output_fields)
    nd, xw = kernel_nd(program), window_warps_x(program)
    lanes = min(nd, 3)
    vmax = min(WINDOW_LANES[lanes], WINDOW_LANE_BYTES[lanes] // itemsize)
    while vmax > 1 and 32 * xw * vmax > spatial[-1]:
        vmax //= 2
    def key(r, v):  # more cells, then the squarer tile, then more rows
        return (r * v, -abs(r.bit_length() - v.bit_length()), r)

    best = (1, 1)
    for v in (1, 2, 4):
        for r in WINDOW_ROWS:
            if v > vmax or (r > 1 and program.ndim == 1):
                continue
            rows, halo = window_entries(program, (r, v))
            live = len(rows) * v + len(halo) + nout * r * v
            if live * words <= WINDOW_REGS and key(r, v) > key(*best):
                best = (r, v)
    from .row_tiled import NUM_SMS

    ext = window_extent(best, nd, xw)
    if math.prod(-(-n // t) for n, t in zip(lift(program, spatial, 1),
                                            ext)) < NUM_SMS:
        return (1, 1)
    return best


def check_strategy(program: StencilProgram, strategy, periodic: bool) -> bool:
    """Whether ``strategy`` runs the slab kernel (``"tiled"``, not
    periodic); raises ValueError on an unknown strategy and, as the JAX
    package's tiled path does, on ``"tiled"`` with index-dim fields or
    fewer than 2 spatial dims."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{STRATEGIES}")
    if strategy != "tiled":
        return False
    has_index = any(f.index_shape for f in program.input_fields
                    + program.output_fields)
    if program.ndim < 2 or has_index:
        raise ValueError(
            f"{program.name}: the tiled path needs >= 2 spatial dims and "
            f"scalar (no index-dim) fields; got {program.ndim} dims, index "
            f"fields={has_index}")
    return not periodic


def make_cuda_stencil(program: StencilProgram, full_domain: bool = False,
                      periodic: bool = False, adjoint_mask_ghost=None,
                      strategy=None, tile_rows=None, form=None, window=None):
    """Build ``fn(inputs: dict[str, Tensor]) -> dict[str, Tensor]`` running
    the CUDA stencil kernel; same semantics as ``make_torch_stencil``.

    ``strategy="tiled"`` (the JAX package's name for ``_run_row_tiled``)
    runs the slab kernel ``csrc/row_tiled.cuh`` with ``tile_rows`` rows of
    dim 0 a tile (default: ``row_tiled.slab_tile``'s pick); with
    ``periodic=True`` it runs the window kernel's periodic mode (the JAX
    package drops to its roll path there: no tiled kernel runs on either
    side).  Every other strategy (None, "blocked", "whole", "plane",
    "plane_full") runs the window kernel of ``csrc/stencil_step.cuh``,
    which replaces those four Pallas kernels, at ``window_tile``'s R × V
    for the shape (``window`` = (R, V) forces one: the in-turns
    comparison of the tiles); ``form="cell"`` runs the per-cell kernel
    instead (the in-turns comparison of the designs).  Each (float type,
    mode, form, R × V) is its own library, built at its first use; each
    (shape, element size) reckons its tile and geometry block once.

    Ranks: every rank runs the window kernel (or the per-cell one) — a 1D
    program as a 2D one with a leading extent of 1 (``kernel_nd``),
    every dim its own above 3; ``strategy="tiled"`` above 3 dims runs the
    window kernel too (the slab kernel tiles 2 or 3 dims; the JAX
    package's tiled path takes any rank from 2, and both compute the same
    function).

    A program compiled with ``accumulate="dd"`` runs the same kernels with
    its wide sums accumulated in extended precision in the emitted body
    (``codegen/cuda_printer.py::_emit_dd``: float64 registers for float32
    and bfloat16 fields, double-word pairs for float64 ones), in every
    mode and rank; its libraries are their own (``_dd`` in their names).
    With ``strategy="tiled"`` it takes the slab kernel only where the JAX
    package's auto-select runs dd programs through its blocked kernel
    (``pallas_kernel.py``: 2 or more dims, and no full-domain primal-only
    program of 3 or more) and raises ValueError elsewhere."""
    dd = program.accumulate == "dd"
    slab = check_strategy(program, strategy, periodic) and program.ndim <= 3
    if slab and dd and full_domain and program.ndim >= 3 and not any(
            is_adjoint(f) for f in program.input_fields):
        raise ValueError(
            f"{program.name}: a full-domain program without adjoint inputs "
            f"in {program.ndim} dims takes no blocked dd kernel in the JAX "
            f"package; strategy='tiled' with accumulate='dd' refuses it")
    if strategy == "tiled" and not slab and not periodic:
        log_lowering_decision(program.name, route="window",
                              reason=f"the slab kernel tiles 2 or 3 dims, "
                                     f"not {program.ndim}")
    if form not in STEP_FORMS:
        raise ValueError(f"unknown form {form!r}; one of {STEP_FORMS}")
    mode = ("periodic" if periodic else "full" if full_domain
            else "interior")
    ins, outs = input_planes(program), output_planes(program)
    nd = kernel_nd(program)
    reach = [max([lo, hi]) for lo, hi in program.ghost]
    if slab:
        from .row_tiled import slab_halo
        halo = slab_halo(program)
    libs = {}
    shapes = {}
    slabs = {}

    def launcher(dtype: str, form: str, tile=(1, 1)):
        key = (dtype, form, tile)
        if key not in libs:
            from ..codegen.nvcc import compile_and_load

            src = generate_cuda_source(program, dtype, mode, form, tile)
            tag = f"_r{tile[0]}v{tile[1]}" if form == "window" else ""
            tag += "_dd" if dd else ""
            libs[key] = compile_and_load(src, re.sub(
                r"\W", "_", f"{program.name}_{mode}_{form}{tag}_{dtype}"))
        return libs[key]

    def fn(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        global LAUNCHES
        a0, spatial = _check_inputs(program, inputs)
        if periodic and any(n < r for n, r in zip(spatial, reach)):
            raise ValueError(f"{program.name}: periodic extents {spatial} "
                             f"must cover the stencil reach {reach}")
        outputs = {f.name: empty(storage_shape(f, spatial), a0.dtype,
                                 a0.device)
                   for f in program.output_fields}
        if any(n == 0 for n in spatial):
            return real(outputs)
        dtype = DTYPE_NAMES[a0.dtype]
        if adjoint_mask_ghost is not None and not periodic:
            alo = [lo for lo, _ in adjoint_mask_ghost]
            ahi = [n - hi for n, (_, hi) in zip(spatial, adjoint_mask_ghost)]
        else:
            alo, ahi = [0] * program.ndim, list(spatial)
        wlo = [lo for lo, _ in program.ghost]
        whi = [n - hi for n, (_, hi) in zip(spatial, program.ghost)]
        # in the kernel's dims: a 1D program's leading extent of 1 first
        kspatial = lift(program, spatial, 1)
        alo, ahi = lift(program, alo), lift(program, ahi, 1)
        wlo, whi = lift(program, wlo), lift(program, whi, 1)
        symbolic = not all(isinstance(n, int) for n in spatial)
        align = ()
        if slab:
            from .row_tiled import slab_args, slab_route, slab_tile
            kind = "slab"
            traced = exporting()
            width = slab_route([inputs[f.name] for f, _ in ins],
                               a0.element_size(), pointers=not traced)
            if traced and width:
                align = ((None, None, width),)
            route = f"w{width}" if width else "elem"
            key = (tuple(spatial), a0.element_size(), width)
            if key not in slabs:
                slabs[key] = slab_tile(halo, len(ins), a0.element_size(),
                                       spatial, tile_rows, width)
                log_lowering_decision(program.name, route="slab_tile",
                                      mode=mode, spatial=tuple(spatial),
                                      itemsize=key[1], width=route,
                                      tile=slabs[key].tile)
            st = slabs[key]
            lib = launcher(dtype, kind)
            in_ptrs, in_st = _plane_args(ins, inputs, nd, zyx=True)
            out_ptrs, out_st = _plane_args(outs, outputs, nd, zyx=True)
            geo, slab_geo = slab_args(st, spatial, wlo, whi, alo, ahi)
            args = [in_ptrs, in_st, out_ptrs, out_st, geo, slab_geo]
            scalars = [_DTYPES[a0.dtype], _MODES[mode], width]
        else:
            key = (tuple(spatial), a0.element_size())
            if symbolic or key not in shapes:
                geo = kspatial + wlo + whi + alo + ahi
                if form == "cell":
                    # grid.y: dim -2; grid.z: the leading dims, merged
                    lead = [kspatial[-2], math.prod(kspatial[:-2])]
                    tile = None
                    route = ("strided" if any(n > GRID_CAP for n in lead)
                             else "direct")
                else:
                    # a symbolic shape takes the tile of shapes that fill
                    # the card (the geometry is the runtime shape's)
                    tile = tuple(window) if window else window_tile(
                        program, [FILL_EXTENT] * len(spatial) if symbolic
                        else spatial, a0.element_size())
                    route = f"r{tile[0]}v{tile[1]}"
                    geo += window_geometry(program, kspatial, mode, tile,
                                           alo, ahi, wlo, whi)
                if symbolic:  # traced: the geometry is the graph's
                    shape = (tile, route, geo)
                else:
                    shape = shapes[key] = (tile, route, (
                        ctypes.c_int64 * len(geo))(*geo))
                    log_lowering_decision(program.name, route="window_tile",
                                          mode=mode, spatial=tuple(spatial),
                                          itemsize=key[1], tile=route)
            else:
                shape = shapes[key]
            tile, route, geo = shape
            if form == "cell":
                kind = "cell"
                lib = launcher(dtype, route)
            else:
                kind = "window"
                lib = launcher(dtype, kind, tile)
            in_ptrs, in_st = _plane_args(ins, inputs, nd)
            out_ptrs, out_st = _plane_args(outs, outputs, nd)
            args = [in_ptrs, in_st, out_ptrs, out_st, geo]
            scalars = [_DTYPES[a0.dtype], _MODES[mode]]
        route += "_dd" if dd else ""
        if run(lib, scalars, args, a0,
               f"{program.name}: stencil launch ({mode}, {kind}, {route})",
               align):
            LAUNCHES += 1
            LAUNCH_CALLS[(program.name, full_domain, periodic,
                          tuple(spatial), a0.element_size(), route,
                          kind)] += 1
        return real(outputs)

    fn.form = "slab" if slab else form or "window"
    fn.program = program
    fn.__name__ = f"cuda_{program.name}"
    return fn
