"""Plain PyTorch lowering: shifted-slice evaluation of a stencil program.

The port of ``pystencils_autodiff_tpu/ops/jnp_ref.py`` and the plain version
of the CUDA kernel in ``cuda_kernel.py``: the CPU path runs it, the tests
hold it against the JAX package, and ``chip_smoke.py`` compares the kernel
with it on the card.  Everything here is tensor slicing and arithmetic on
the inputs' own device; ``torch.autograd`` can differentiate through it,
which makes it the gradcheck oracle for the op.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..field import Field
from .common import (StencilProgram, assemble_planes, check_ported,
                     field_components, is_adjoint, plane_view, spatial_index,
                     storage_spatial)

__all__ = ["make_torch_stencil", "evaluate_program", "make_shard_stencil",
           "PLAIN_CALLS"]

# evaluations of a program by the plain version (bounded, periodic or a
# shard's), counted where they run: a check that a path stayed on the
# kernels reads it before and after
PLAIN_CALLS = 0


def _count():
    global PLAIN_CALLS
    PLAIN_CALLS += 1


def _spatial_shape(program: StencilProgram, inputs: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    for f in program.input_fields:
        return storage_spatial(f, inputs[f.name])
    raise ValueError("program has no inputs")


def _read_plane(arr, acc):
    if acc.index:
        return plane_view(acc.field, arr, tuple(acc.index))
    if acc.field.index_dimensions:
        raise ValueError(f"access {acc} to index field must select components")
    return arr


def _as_plane(res, shape, dtype, device) -> torch.Tensor:
    if not isinstance(res, torch.Tensor) or res.dtype != dtype:
        res = torch.as_tensor(res, dtype=dtype, device=device)
    return torch.broadcast_to(res, shape)


def step_schedule(steps):
    """The steps in an order that keeps few subexpression planes alive, and
    for each position the subexpressions read there for the last time.

    Each main step is preceded by the subexpressions it needs that are not
    computed yet (depth first), so a value lives from just before its first
    use to its last; an evaluator drops it after its last use.  The order
    changes no value (every step is elementwise).  For the D3Q19 BGK
    backward program (1687 steps) this keeps at most 86 planes alive, in
    the derivation's order 1239 — 83 GB at 256³ float32."""
    by_target = {s.target: s for s in steps if not s.is_main}
    order, seen = [], set()

    def visit(step):
        for at in step.atoms:
            if at in by_target and at not in seen:
                seen.add(at)
                visit(by_target[at])
        order.append(step)

    for step in steps:
        if step.is_main:
            visit(step)
    last = {}
    for i, step in enumerate(order):
        for at in step.atoms:
            if at in by_target:
                last[at] = i
    drop = [[] for _ in order]
    for at, i in last.items():
        drop[i].append(at)
    return order, drop


def evaluate_program(
    program: StencilProgram,
    arrays: Dict[str, torch.Tensor],
    interior_shape: Tuple[int, ...],
    dtype,
    slices=None,
) -> Dict[str, Dict[tuple, torch.Tensor]]:
    """Run the step list on interior-shaped views; returns per-component
    interior planes keyed by output field name then index tuple.
    ``slices(offsets)``: the spatial slices a read at ``offsets`` takes
    (default ``program.interior_slices``)."""
    _count()
    slices = slices or program.interior_slices
    device = next(iter(arrays.values())).device
    env: Dict[object, torch.Tensor] = {}
    out_vals: Dict[str, Dict[tuple, torch.Tensor]] = {
        f.name: {} for f in program.output_fields}
    order, drop = step_schedule(program.steps)
    for step, dead in zip(order, drop):
        vals = []
        for at in step.atoms:
            if isinstance(at, Field.Access):
                sl = slices(at.offsets)
                vals.append(_read_plane(arrays[at.field.name], at)[sl])
            else:
                vals.append(env[at])
        res = _as_plane(step.fn(*vals), interior_shape, dtype, device)
        if step.is_main:
            out_vals[step.target.field.name][tuple(step.target.index)] = res
        else:
            env[step.target] = res
        for at in dead:
            del env[at]
    return out_vals


def _spatial_axis(f: Field, d: int) -> int:
    return f.index_dimensions + d if getattr(f, "index_major", False) else d


def _pad_input(f: Field, arr: torch.Tensor, ghost) -> torch.Tensor:
    """Pad spatial dims by the ghost widths.  Adjoint fields pad with zeros
    (no contributions from outside the domain); primal fields replicate the
    edge so e.g. divisions by a coefficient stay finite (the padded values
    are always multiplied by a zero adjoint)."""
    zero = is_adjoint(f)
    for d, (lo, hi) in enumerate(ghost):
        if not (lo or hi):
            continue
        ax = _spatial_axis(f, d)
        n = arr.shape[ax]
        if zero:
            shape = list(arr.shape)
            shape[ax] = n + lo + hi
            padded = arr.new_zeros(shape)
            padded.narrow(ax, lo, n).copy_(arr)
            arr = padded
        else:
            idx = torch.arange(-lo, n + hi, device=arr.device).clamp_(0, n - 1)
            arr = arr.index_select(ax, idx)
    return arr


def _mask_adjoint_inputs(program, inputs, ghost_spec):
    """Zero adjoint-field inputs outside the given (forward) interior (the
    exact-VJP cotangent mask)."""
    out = dict(inputs)
    for f in program.input_fields:
        if is_adjoint(f):
            arr = inputs[f.name]
            spatial = storage_spatial(f, arr)
            sl = spatial_index(f, tuple(slice(lo, s - hi) for s, (lo, hi)
                                        in zip(spatial, ghost_spec)))
            masked = torch.zeros_like(arr)
            masked[sl] = arr[sl]
            out[f.name] = masked
    return out


def _evaluate_periodic(program: StencilProgram, inputs, dtype):
    """Full-domain evaluation with wrap-around reads: every access is a
    circular roll, every cell is written.  The adjoint of a circulant
    stencil is the transposed circulant, so the backward collection through
    this same path is the exact periodic VJP with no masking at all."""
    _count()
    env: Dict[object, torch.Tensor] = {}
    shape = _spatial_shape(program, inputs)
    nd = program.ndim
    device = inputs[program.input_fields[0].name].device
    out_vals: Dict[str, Dict] = {f.name: {} for f in program.output_fields}

    def read(acc):
        arr = _read_plane(inputs[acc.field.name], acc)
        shifts = tuple(-o for o in acc.offsets)
        if any(shifts):
            arr = torch.roll(arr, shifts, dims=tuple(range(nd)))
        return arr

    order, drop = step_schedule(program.steps)
    for step, dead in zip(order, drop):
        vals = [read(at) if isinstance(at, Field.Access) else env[at]
                for at in step.atoms]
        res = _as_plane(step.fn(*vals), shape, dtype, device)
        if step.is_main:
            out_vals[step.target.field.name][step.target.index] = res
        else:
            env[step.target] = res
        for at in dead:
            del env[at]

    outputs: Dict[str, torch.Tensor] = {}
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    for f in program.output_fields:
        comps = out_vals[f.name]
        val = assemble_planes(f, [comps.get(idx, zeros)
                                  for idx in field_components(f)], shape)
        if f in program.accum_fields and f.name in inputs:
            val = val + inputs[f.name]
        outputs[f.name] = val.contiguous()
    return outputs


def make_torch_stencil(program: StencilProgram, full_domain: bool = False,
                       periodic: bool = False, adjoint_mask_ghost=None):
    """Build ``fn(inputs: dict[str, Tensor]) -> dict[str, Tensor]``.

    ``full_domain=False``: outputs are zero on the ghost frame, the interior
    holds the stencil result; accumulation outputs add into the provided
    previous array.

    ``full_domain=True``: exact-VJP semantics — inputs are ghost-padded and
    the result covers the entire domain.

    ``adjoint_mask_ghost``: zero adjoint inputs outside this (forward)
    interior before evaluating — the exact-VJP cotangent mask.

    ``periodic=True``: every cell written, reads wrap; no ghost frame and no
    masking (the other flags are ignored).

    A program compiled with ``accumulate="dd"`` evaluates its wide sums in
    extended precision (its steps' functions, ``ops/common.py::
    _compile_dd_add``): every mode takes it.
    """

    def fn(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out_dtype = inputs[program.input_fields[0].name].dtype
        if periodic:
            return _evaluate_periodic(program, inputs, out_dtype)
        if adjoint_mask_ghost is not None:
            inputs = _mask_adjoint_inputs(program, inputs, adjoint_mask_ghost)
        spatial = _spatial_shape(program, inputs)
        if full_domain:
            arrays = {f.name: _pad_input(f, inputs[f.name], program.ghost)
                      for f in program.input_fields}
            interior = spatial
        else:
            arrays = {f.name: inputs[f.name] for f in program.input_fields}
            interior = program.interior_shape(spatial)
        vals = evaluate_program(program, arrays, interior, out_dtype)

        device = inputs[program.input_fields[0].name].device
        outputs: Dict[str, torch.Tensor] = {}
        zeros_int = torch.zeros(interior, dtype=out_dtype, device=device)
        for f in program.output_fields:
            comps = vals[f.name]
            prev = inputs.get(f.name) if f in program.accum_fields else None
            if full_domain:
                val = assemble_planes(
                    f, [comps.get(idx, zeros_int)
                        for idx in field_components(f)], interior)
            else:
                sl = program.interior_slices()
                planes = []
                for idx in field_components(f):
                    plane = torch.zeros(spatial, dtype=out_dtype, device=device)
                    plane[sl] = comps.get(idx, zeros_int)
                    planes.append(plane)
                val = assemble_planes(f, planes, spatial)
            outputs[f.name] = (val.contiguous() if prev is None
                               else prev + val)
        return outputs

    fn.program = program
    fn.__name__ = f"torch_{program.name}"
    return fn


def _pad_shard(f: Field, arr: torch.Tensor, ghost, wraps) -> torch.Tensor:
    """Pad spatial dims by the ghost widths: wrapped where ``wraps[d]``,
    else the edge value repeated (a shard block's outer margin, whose
    cells never reach an owned cell of the chain)."""
    for d, (lo, hi) in enumerate(ghost):
        if not (lo or hi):
            continue
        ax = _spatial_axis(f, d)
        n = arr.shape[ax]
        idx = torch.arange(-lo, n + hi, device=arr.device)
        idx = idx.remainder(n) if wraps[d] else idx.clamp(0, n - 1)
        arr = arr.index_select(ax, idx)
    return arr


def make_shard_stencil(program: StencilProgram, periodic: bool, shard):
    """``fn(inputs, bases) -> outputs``: one step of ``program`` on a
    halo-extended block of a sharded domain (``ops.flatten.ShardSpec``),
    the plain version of the fused chains' shard modes.  Reads wrap in the
    dims a periodic domain keeps whole and repeat the block's edge
    elsewhere; a bounded step writes the cells whose global coordinate
    (block coordinate + ``bases``) lies in the program's interior window of
    the global domain and 0 elsewhere (the global ghost frame), a periodic
    one every cell.  Only the written cells are evaluated, so no value
    outside the window enters an expression (or its gradient)."""
    from .flatten import check_bases, global_window, shard_wraps

    check_ported(program)
    if program.accum_fields:
        raise NotImplementedError(f"{program.name}: accumulation outputs "
                                  f"in a sharded chain")
    nd = program.ndim
    ghost = program.ghost
    wraps = shard_wraps(periodic, nd, shard)

    def fn(inputs: Dict[str, torch.Tensor], bases) -> Dict[str, torch.Tensor]:
        b = check_bases(shard, bases, nd)
        f0 = program.input_fields[0]
        a0 = inputs[f0.name]
        dtype, device = a0.dtype, a0.device
        spatial = storage_spatial(f0, a0)
        win = global_window(ghost, spatial, shard, b, periodic)
        shape = tuple(stop - start for start, stop in win)
        arrays = {f.name: _pad_shard(f, inputs[f.name], ghost, wraps)
                  for f in program.input_fields}

        def slices(offs):
            offs = offs or (0,) * nd
            return tuple(slice(start + lo + o, start + lo + o + n)
                         for (start, _), (lo, _), o, n
                         in zip(win, ghost, offs, shape))

        vals = (evaluate_program(program, arrays, shape, dtype, slices)
                if all(shape) else {f.name: {} for f in
                                    program.output_fields})
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        box = tuple(slice(start, stop) for start, stop in win)
        outputs: Dict[str, torch.Tensor] = {}
        for f in program.output_fields:
            planes = []
            for idx in field_components(f):
                plane = torch.zeros(spatial, dtype=dtype, device=device)
                plane[box] = vals[f.name].get(idx, zeros)
                planes.append(plane)
            outputs[f.name] = assemble_planes(f, planes, spatial).contiguous()
        return outputs

    fn.program = program
    return fn
