"""The op's single step with its derived VJP, as a custom op: the port of
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

The launches are the ``psat::stencil`` / ``psat::stencil_bwd`` custom ops
(``ops/custom_ops.py``); ``StencilEntry`` is their registry entry: the
forward and backward programs with the op's field lists, lowered at the
first call — the CUDA kernel for CUDA tensors, the plain version for CPU
tensors, as PyTorch's dispatcher picks.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import torch

from ..adjoint_field import AdjointField
from . import custom_ops
from .common import (backward_programs, forward_program, is_staged_backward,
                     storage_shape, storage_spatial)

__all__ = ["build_autograd_function", "make_staged_fn", "StencilEntry"]


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


class StencilEntry:
    """The op's single step as a registry entry (``ops/custom_ops.py``):
    the forward program in interior mode and the backward program(s) in
    full mode with the fused cotangent mask — or both periodic —, with the
    op's field lists.  Pickles as that recipe (no op inside); lowers it at
    the first call: ``make_cuda_stencil`` (``strategy``/``tile_rows`` go
    to the forward and every backward stage alike, as the JAX package's
    ``build_custom_vjp`` passes them) for CUDA tensors,
    ``make_torch_stencil`` for CPU tensors."""

    kind = "stencil"

    def __init__(self, op, periodic: bool = False, strategy=None,
                 tile_rows=None):
        from .cuda_kernel import check_strategy

        fwd_prog = forward_program(op)
        bwd_progs = backward_programs(op)
        for p in [fwd_prog] + bwd_progs:
            check_strategy(p, strategy, periodic)
        bwd_input_fields = bwd_progs[-1].input_fields
        if is_staged_backward(op):
            inter = set(op.backward_assignments.intermediate_fields)
            seen, bwd_input_fields = set(), []
            for p in bwd_progs:
                for f in p.input_fields:
                    if f not in inter and f not in seen:
                        seen.add(f)
                        bwd_input_fields.append(f)
        self.name = op.op_name
        self.recipe = dict(
            fwd=fwd_prog, bwd=bwd_progs, periodic=periodic,
            strategy=strategy, tile_rows=tile_rows,
            inputs=list(op.forward_input_fields),
            outputs=list(op.forward_output_fields),
            saved=[f.name for f in op.saved_fields],
            grads=list(op.backward_output_fields),
            bwd_inputs=list(bwd_input_fields))
        self._init()

    def _init(self):
        r = self.recipe
        self.in_names = [f.name for f in r["inputs"]]
        self.out_names = [f.name for f in r["outputs"]]
        self.saved_idx = [self.in_names.index(n) for n in r["saved"]]
        self._lowered = {}

    def __getstate__(self):
        return {"name": self.name, "key": self.key, "recipe": self.recipe}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init()

    def lowered(self, card: bool):
        """(forward, backward) functions on dicts: the kernel's or the
        plain version's."""
        if card not in self._lowered:
            from . import make_cuda_stencil, make_torch_stencil

            r = self.recipe
            make = (partial(make_cuda_stencil, strategy=r["strategy"],
                            tile_rows=r["tile_rows"]) if card
                    else make_torch_stencil)
            fwd_prog, bwd_progs = r["fwd"], r["bwd"]
            staged = len(bwd_progs) > 1
            if r["periodic"]:
                # every cell is written, so the VJP needs no masking
                # anywhere: the adjoint of a circulant stencil is the
                # transposed circulant
                fwd = make(fwd_prog, periodic=True)
                bwd = (make_staged_fn(bwd_progs, make, {}, periodic=True)
                       if staged else make(bwd_progs[0], full_domain=True,
                                           periodic=True))
            else:
                fwd = make(fwd_prog)
                mask = {"adjoint_mask_ghost": fwd_prog.ghost}
                bwd = (make_staged_fn(bwd_progs, make, mask) if staged
                       else make(bwd_progs[0], full_domain=True, **mask))
            self._lowered[card] = (fwd, bwd)
        return self._lowered[card]

    def forward(self, card, extra, tensors):
        outputs = self.lowered(card)[0](dict(zip(self.in_names, tensors)))
        outs = [outputs[n] for n in self.out_names]
        # the kernel allocates every output; a plain version may pass an
        # input through
        return outs if card else custom_ops.fresh(outs, tensors)

    def fake_forward(self, extra, tensors):
        spatial = storage_spatial(self.recipe["inputs"][0], tensors[0])
        return [tensors[0].new_empty(storage_shape(f, spatial))
                for f in self.recipe["outputs"]]

    def to_save(self, tensors):
        return [tensors[i] for i in self.saved_idx]

    def backward(self, card, extra, saved, cotangents):
        """The gradients of every forward input (zeros for a constant
        field) from the saved primals and the outputs' cotangents."""
        r = self.recipe
        saved = dict(zip(r["saved"], saved))
        cots = dict(zip(self.out_names, cotangents))
        ref = cotangents[0]
        spatial = storage_spatial(r["outputs"][0], ref)
        bwd_inputs: Dict[str, torch.Tensor] = {}
        for f in r["bwd_inputs"]:
            if isinstance(f, AdjointField):
                primal_name = f.corresponding_forward_field.name
                if primal_name in cots:
                    # masked to the forward interior by the lowering
                    bwd_inputs[f.name] = cots[primal_name]
                else:
                    # previous-adjoint input of an accumulation
                    # (time_constant_fields) output: within one step the
                    # accumulator starts at zero — autograd sums the
                    # steps of a loop
                    primal = f.corresponding_forward_field
                    bwd_inputs[f.name] = ref.new_zeros(
                        storage_shape(primal, spatial))
            else:
                bwd_inputs[f.name] = saved[f.name]
        grads = self.lowered(card)[1](bwd_inputs)
        by_primal = {f.corresponding_forward_field.name: grads[f.name]
                     for f in r["grads"]}
        return custom_ops.fresh([
            by_primal[f.name] if f.name in by_primal
            # constant field: zero cotangent
            else ref.new_zeros(storage_shape(f, spatial))
            for f in r["inputs"]], list(saved.values()) + list(cotangents))

    def fake_backward(self, extra, saved, cotangents):
        ref = cotangents[0]
        spatial = storage_spatial(self.recipe["outputs"][0], ref)
        return [ref.new_empty(storage_shape(f, spatial))
                for f in self.recipe["inputs"]]

    def grads(self, saved, cotangents, needs, extra):
        if not any(needs):
            return [None] * len(needs)
        g = custom_ops.stencil_bwd(self.key, saved, cotangents)
        return [x if need else None for x, need in zip(g, needs)]


def build_autograd_function(op, periodic: bool = False, strategy=None,
                            tile_rows=None, dtype=None):
    """The op as ``f(*tensors)`` / ``f(**{field: tensor})`` over the
    ``psat::stencil`` custom op (a ``StencilEntry``): forward program in
    interior mode, backward program(s) in full mode with the fused
    cotangent mask — or both periodic.  The dispatcher runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors;
    ``strategy``/``tile_rows`` go to the forward and every backward stage
    alike.  ``dtype`` (a ``torch.dtype``) casts the inputs to it first,
    so forward and backward compute in it."""
    ent = StencilEntry(op, periodic=periodic, strategy=strategy,
                       tile_rows=tile_rows)
    custom_ops.register(ent)
    in_names, out_names = ent.in_names, ent.out_names

    # the fields' layouts as plain values, read once (the symbolic
    # layer's properties recompute them; torch.compile traces this)
    specs = [(f.name, f.spatial_dimensions, f.index_dimensions,
              bool(getattr(f, "index_major", False)), tuple(f.index_shape))
             for f in op.forward_input_fields]

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
        shapes = tuple(t.shape for t in tensors)
        try:
            seen = shapes in checked
        except TypeError:  # symbolic extents (torch.export's Dims)
            seen = False
        if not seen:
            check(tensors)
            try:
                checked.add(shapes)
            except TypeError:
                pass
        if dtype is not None:
            tensors = tuple(t.to(dtype) for t in tensors)
        result = custom_ops.apply(ent, None, *tensors)
        return result[0] if len(result) == 1 else result

    def check(tensors):
        """Raise unless the tensors' ranks, index dims and spatial shapes
        fit the op's fields (once per tuple of shapes)."""
        spatial_shapes = {}
        for (name, sd, ni, index_major, index_shape), t in zip(specs,
                                                               tensors):
            if t.dim() != sd + ni:
                raise ValueError(
                    f"field {name!r}: expected rank {sd + ni} ({sd} spatial "
                    f"+ {ni} index dims), got tensor of rank {t.dim()}")
            got_idx = tuple(t.shape[:ni]) if index_major else tuple(t.shape[sd:])
            if index_shape and got_idx != index_shape:
                where = "leading" if index_major else "trailing"
                raise ValueError(
                    f"field {name!r}: {where} index dims {got_idx} != "
                    f"declared index_shape {index_shape}")
            spatial_shapes[name] = (tuple(t.shape[ni:]) if index_major
                                    else tuple(t.shape[:sd]))
        # pairwise, not through a set: symbolic extents (torch.export's
        # Dims) do not hash
        first = next(iter(spatial_shapes.values()))
        if any(s != first for s in spatial_shapes.values()):
            raise ValueError(
                f"all fields must share one spatial shape; got {spatial_shapes}")

    checked: set = set()

    user_fn.input_names = in_names
    user_fn.output_names = out_names
    user_fn.op = op
    user_fn.forward_program = ent.recipe["fwd"]
    user_fn.backward_program = ent.recipe["bwd"][-1]
    user_fn.entry = ent
    user_fn.__name__ = op.op_name
    return user_fn
