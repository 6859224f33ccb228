"""``torch.autograd.Function`` assembly: the port of
``pystencils_autodiff_tpu/ops/vjp.py`` (``jax.custom_vjp`` there).

``build_autograd_function(op)`` returns ``f(*tensors) -> outputs`` (ordered
by ``op.forward_input_fields`` / ``op.forward_output_fields``) whose
backward runs the *symbolically derived* backward program instead of
PyTorch's own autodiff.

Boundary exactness: the forward writes only the ghost-shrunk interior, so
its exact VJP (a) masks incoming cotangents to that interior and
(b) evaluates the backward gather over the *full* domain with zero-extended
adjoint reads and edge-clamped primal reads, so gradients land in the
primal ghost cells the forward's reads touched.  The lowering's
``full_domain=True`` mode with ``adjoint_mask_ghost`` does both (fused into
the CUDA kernel); periodic ops need no masks at all.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.function import once_differentiable

from ..adjoint_field import AdjointField
from .common import (backward_programs, forward_program, is_staged_backward,
                     storage_shape, storage_spatial)

__all__ = ["build_autograd_function", "make_staged_fn"]


def make_staged_fn(progs, lower, final_kwargs, **kwargs):
    """Chain lowered per-stage functions: each stage's outputs join the
    environment the next stage reads (multi-pass backward programs, e.g.
    TF_MAD's materialised Jacobian stage).  All stages run full-domain;
    only the final (gather) stage applies the exact-VJP cotangent mask."""
    fns = [lower(p, full_domain=True, **kwargs) for p in progs[:-1]]
    fns.append(lower(progs[-1], full_domain=True, **final_kwargs, **kwargs))

    def fn(inputs):
        env = dict(inputs)
        out = env
        for f in fns:
            out = f(env)
            env.update(out)
        return out

    return fn


def build_autograd_function(op, periodic: bool = False, strategy=None,
                            tile_rows=None):
    """The op as a ``torch.autograd.Function``: forward program in interior
    mode, backward program(s) in full mode with the fused cotangent mask —
    or both periodic.  Each program runs on its inputs' device
    (``make_stencil``); ``strategy``/``tile_rows`` go to the forward and
    every backward stage alike, as the JAX package's ``build_custom_vjp``
    passes them."""
    from functools import partial

    from . import make_stencil as _make_stencil

    make_stencil = partial(_make_stencil, strategy=strategy,
                           tile_rows=tile_rows)
    fwd_prog = forward_program(op)
    bwd_progs = backward_programs(op)
    bwd_prog = bwd_progs[-1]
    staged = is_staged_backward(op)
    if periodic:
        # every cell is written, so the VJP needs no masking anywhere: the
        # adjoint of a circulant stencil is the transposed circulant
        fwd_fn = make_stencil(fwd_prog, periodic=True)
        if staged:
            bwd_fn = make_staged_fn(bwd_progs, make_stencil, {}, periodic=True)
        else:
            bwd_fn = make_stencil(bwd_prog, full_domain=True, periodic=True)
    else:
        fwd_fn = make_stencil(fwd_prog)
        mask = {"adjoint_mask_ghost": fwd_prog.ghost}
        if staged:
            bwd_fn = make_staged_fn(bwd_progs, make_stencil, mask)
        else:
            bwd_fn = make_stencil(bwd_prog, full_domain=True, **mask)
    bwd_input_fields = bwd_prog.input_fields
    if staged:
        inter = set(op.backward_assignments.intermediate_fields)
        seen, bwd_input_fields = set(), []
        for p in bwd_progs:
            for f in p.input_fields:
                if f not in inter and f not in seen:
                    seen.add(f)
                    bwd_input_fields.append(f)

    in_names = [f.name for f in op.forward_input_fields]
    out_names = [f.name for f in op.forward_output_fields]
    saved_names = [f.name for f in op.saved_fields]
    grad_names = [f.corresponding_forward_field.name
                  for f in op.backward_output_fields]

    class StencilFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *tensors):
            inputs = dict(zip(in_names, tensors))
            outputs = fwd_fn(inputs)
            ctx.save_for_backward(*(inputs[n] for n in saved_names))
            ctx.spatial = storage_spatial(op.forward_input_fields[0],
                                          tensors[0])
            return tuple(outputs[n] for n in out_names)

        @staticmethod
        @once_differentiable
        def backward(ctx, *cotangents):
            saved = dict(zip(saved_names, ctx.saved_tensors))
            cots = dict(zip(out_names, cotangents))
            spatial = ctx.spatial
            ref = cotangents[0]
            bwd_inputs: Dict[str, torch.Tensor] = {}
            for f in bwd_input_fields:
                if isinstance(f, AdjointField):
                    primal_name = f.corresponding_forward_field.name
                    if primal_name in cots:
                        # masked to the forward interior by the lowering
                        bwd_inputs[f.name] = cots[primal_name]
                    else:
                        # previous-adjoint input of an accumulation
                        # (time_constant_fields) output: within one step
                        # the accumulator starts at zero — autograd sums
                        # the steps of a loop
                        primal = f.corresponding_forward_field
                        bwd_inputs[f.name] = ref.new_zeros(
                            storage_shape(primal, spatial))
                else:
                    bwd_inputs[f.name] = saved[f.name]
            grads = bwd_fn(bwd_inputs)
            by_primal = dict(zip(grad_names, (grads[f.name] for f in
                                              op.backward_output_fields)))
            return tuple(
                by_primal[f.name] if f.name in by_primal
                # constant field: zero cotangent
                else ref.new_zeros(storage_shape(f, spatial))
                for f in op.forward_input_fields)

    def user_fn(*tensors, **kw_tensors):
        if kw_tensors:
            if tensors:
                raise TypeError("pass fields either positionally or by name, not both")
            unknown = set(kw_tensors) - set(in_names)
            if unknown:
                raise TypeError(f"unknown field(s) {sorted(unknown)}; inputs are {in_names}")
            missing = set(in_names) - set(kw_tensors)
            if missing:
                raise TypeError(f"missing field(s) {sorted(missing)}; inputs are {in_names}")
            tensors = tuple(kw_tensors[n] for n in in_names)
        if len(tensors) != len(in_names):
            raise TypeError(f"expected {len(in_names)} inputs {in_names}, got {len(tensors)}")
        spatial_shapes = {}
        for f, t in zip(op.forward_input_fields, tensors):
            sd, ni = f.spatial_dimensions, f.index_dimensions
            if t.dim() != sd + ni:
                raise ValueError(
                    f"field {f.name!r}: expected rank {sd + ni} ({sd} spatial "
                    f"+ {ni} index dims), got tensor of rank {t.dim()}")
            index_major = getattr(f, "index_major", False)
            got_idx = tuple(t.shape[:ni]) if index_major else tuple(t.shape[sd:])
            if f.index_shape and got_idx != f.index_shape:
                where = "leading" if index_major else "trailing"
                raise ValueError(
                    f"field {f.name!r}: {where} index dims {got_idx} != "
                    f"declared index_shape {f.index_shape}")
            spatial_shapes[f.name] = storage_spatial(f, t)
        if len(set(spatial_shapes.values())) > 1:
            raise ValueError(
                f"all fields must share one spatial shape; got {spatial_shapes}")
        result = StencilFunction.apply(*tensors)
        return result[0] if len(result) == 1 else result

    user_fn.input_names = in_names
    user_fn.output_names = out_names
    user_fn.op = op
    user_fn.forward_program = fwd_prog
    user_fn.backward_program = bwd_prog
    user_fn.__name__ = op.op_name
    return user_fn
