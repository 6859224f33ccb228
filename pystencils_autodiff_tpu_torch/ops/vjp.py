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

Second order.  With ``y = f(x)`` (interior mode: ``M·F(x)``, M the
forward interior) and the backward ``B(x, g) = J(x)ᵀ·M·g``, every
derivative of B is a stencil program of its own, derived from the
tangent-linear program ``T(x, ẋ) = M·J(x)·ẋ`` (``autodiff.tangent_op``;
``StencilEntry.tangent`` builds its entry once per (tangent fields,
wanted adjoints) and caches it):

* reverse over reverse, w the cotangent of B's output:
  ``∂/∂g ⟨B, w⟩ = T(x, w)`` (T's forward) and ``∂/∂x ⟨B, w⟩ =
  ∇ₓ⟨T(x, w), g⟩`` (T's backward, with respect to x only, g masked to
  the forward interior as ever);
* forward mode: ``ḟ = T(x, ẋ)`` and ``Ḃ = B(x, ġ) + ∇⟨T(x, ẋ), g⟩``.

Each is a launch of the same kernels, through the same custom ops, so a
third order follows by the same rules on T's entry.
"""

from __future__ import annotations

import dataclasses
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
    op's field lists (no op inside); lowers it at the first call: ``make_cuda_stencil`` (``strategy``/``tile_rows`` go
    to the forward and every backward stage alike, as the JAX package's
    ``build_custom_vjp`` passes them) for CUDA tensors,
    ``make_torch_stencil`` for CPU tensors.  ``accumulate`` is the
    programs' wide-sum mode (``"dd"``: extended-precision sums, compiled
    into every program of the entry, its tangent and full entries too);
    a dd entry's name ends in ``_dd``, so its registry key, its libraries
    and its exported launches never meet a pairwise entry's."""

    kind = "stencil"

    def __init__(self, op, periodic: bool = False, strategy=None,
                 tile_rows=None, ghost=None, accumulate: str = "pairwise"):
        from .common import check_accumulate
        from .cuda_kernel import check_strategy

        accumulate = check_accumulate(accumulate)
        fwd_prog = forward_program(op, accumulate)
        if ghost is not None:
            # a tangent program writes the interior of the op it derives
            # from, whatever its own reads reach
            fwd_prog = dataclasses.replace(
                fwd_prog, ghost=tuple(tuple(g) for g in ghost))
        # no backward where no input gets an adjoint (a tangent program
        # whose adjoints are all zero): the gradients are zeros, no launch
        bwd_progs = backward_programs(op, accumulate) \
            if op.backward_output_fields else []
        for p in [fwd_prog] + bwd_progs:
            check_strategy(p, strategy, periodic)
        bwd_input_fields = bwd_progs[-1].input_fields if bwd_progs else []
        if is_staged_backward(op):
            inter = set(op.backward_assignments.intermediate_fields)
            seen, bwd_input_fields = set(), []
            for p in bwd_progs:
                for f in p.input_fields:
                    if f not in inter and f not in seen:
                        seen.add(f)
                        bwd_input_fields.append(f)
        self.op_name = op.op_name
        self.name = op.op_name + ("_dd" if accumulate == "dd" else "")
        self.recipe = dict(
            fwd=fwd_prog, bwd=bwd_progs, periodic=periodic,
            strategy=strategy, tile_rows=tile_rows, accumulate=accumulate,
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
        self.diff_names = [f.corresponding_forward_field.name
                           for f in r["grads"]]
        self._lowered = {}
        self._tangents = {}
        self._full = None

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
            if not bwd_progs:
                self._lowered[card] = (make(fwd_prog,
                                            periodic=r["periodic"]), None)
            elif r["periodic"]:
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
            if bwd_progs:
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
        if not r["bwd"]:
            return [ref.new_zeros(storage_shape(f, spatial))
                    for f in r["inputs"]]
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
        g = custom_ops.through(custom_ops.stencil_bwd, self, saved,
                                   cotangents)
        return [x if need else None for x, need in zip(g, needs)]

    # -- second order -------------------------------------------------------

    def grads_graph(self, saved, cotangents, needs, extra, link=None):
        """``grads`` recorded for a further differentiation (grad mode on
        in the backward: ``create_graph=True``, or a ``torch.func``
        transform): the backward op through ``custom_ops.bwd_apply``,
        whose own rules are ``second_vjp`` and ``backward_jvp``."""
        if not any(needs):
            return [None] * len(needs)
        g = custom_ops.bwd_apply(self, saved, cotangents, link)
        return [x if need else None for x, need in zip(g, needs)]

    def constant_requires_grad(self, tensors) -> bool:
        """Whether an input of a constant field requires grad."""
        return any(t.requires_grad for n, t in zip(self.in_names, tensors)
                   if n not in self.diff_names)

    def constant_grads(self, inputs, cotangents, needs, grads,
                       differentiable):
        """``grads`` with the constant fields' entries (where needed) the
        forward's VJP in them: the full backward (``AutoDiffOp`` of the
        same forward with no constant field, built once) on every input
        and ``cotangents``.  A second-order pass asks for it: the first
        gradient depends on a constant field through the primal output
        too, which the JAX package's jnp HVP differentiates."""
        consts = [i for i, (n, need) in enumerate(zip(self.in_names, needs))
                  if need and n not in self.diff_names]
        if not consts:
            return grads
        if self._full is None:
            from ..autodiff import AutoDiffOp

            r = self.recipe
            self._full = StencilEntry(
                AutoDiffOp(r["fwd"].collection,
                           op_name=f"{self.op_name}_full"),
                periodic=r["periodic"], strategy=r["strategy"],
                tile_rows=r["tile_rows"], ghost=r["fwd"].ghost,
                accumulate=r["accumulate"])
            custom_ops.register(self._full)
        full = self._full
        saved = full.to_save(list(inputs))
        g = (custom_ops.bwd_apply(full, saved, cotangents) if differentiable
             else custom_ops.through(custom_ops.stencil_bwd, full, saved,
                                     list(cotangents)))
        return [g[i] if i in consts else x for i, x in enumerate(grads)]

    def tangent(self, wrt, wanted):
        """``(entry, names)``: the tangent-linear program of the forward
        along the inputs named in ``wrt``, with the adjoints of the
        inputs named in ``wanted`` as its backward (None: of every field
        it reads, so that whatever is differentiated later finds its
        adjoint; ``autodiff.tangent_op``), as a registered entry writing
        this op's interior — or ``(None, names)`` where the tangent is 0.
        ``names``: primal input or output name → its tangent field's.
        Built once per (wrt, wanted) and kept here."""
        key = (tuple(wrt), None if wanted is None else tuple(wanted))
        if key not in self._tangents:
            from ..autodiff import tangent_op

            r = self.recipe
            op, names = tangent_op(
                r["fwd"].collection, wrt, wanted,
                op_name=f"{self.op_name}_tlm_{'_'.join(wrt)}")
            ent = None
            if op is not None:
                ent = StencilEntry(op, periodic=r["periodic"],
                                   strategy=r["strategy"],
                                   tile_rows=r["tile_rows"],
                                   ghost=r["fwd"].ghost,
                                   accumulate=r["accumulate"])
                custom_ops.register(ent)
            self._tangents[key] = (ent, names)
        return self._tangents[key]

    def _tangent_args(self, ent, names, which, env, tangents):
        """The tensors of ``ent``'s field list ``which`` (its inputs or its
        saved fields): tangent fields from ``tangents``, primal fields
        from ``env`` (both keyed by primal name)."""
        of = {t: p for p, t in names.items()}
        out = []
        for n in which:
            if n in of and of[n] in tangents:
                out.append(tangents[of[n]])
            elif n in env:
                out.append(env[n])
            else:
                raise RuntimeError(
                    f"{self.name}: the tangent program reads {n!r}, which "
                    f"this differentiation does not hold")
        return out

    def tangent_outputs(self, env, tangents, ref, fwd_call):
        """``M·J(x)·ẋ`` per forward output (zeros where it is 0): the
        tangent program's forward on the primal tensors ``env`` and the
        tangents ``tangents`` (by primal name)."""
        wrt = [n for n in self.in_names if n in tangents]
        ent, names = self.tangent(wrt, None)
        spatial = storage_spatial(self.recipe["inputs"][0], ref)
        zeros = [ref.new_zeros(storage_shape(f, spatial))
                 for f in self.recipe["outputs"]]
        if ent is None:
            return zeros
        got = dict(zip(ent.out_names, fwd_call(
            ent, self._tangent_args(ent, names, ent.in_names, env,
                                    tangents))))
        return [got.get(names[n], z) for n, z in zip(self.out_names, zeros)]

    def tangent_vjp(self, env, tangents, cotangents, wanted, ref, bwd_call):
        """``∇⟨T(x, ẋ), g⟩`` for the primal inputs named in ``wanted``
        (a dict name → gradient; zeros where it is 0): the tangent
        program's backward, ``g`` the forward outputs' ``cotangents``."""
        wrt = [n for n in self.in_names if n in tangents]
        ent, names = self.tangent(wrt, wanted)
        spatial = storage_spatial(self.recipe["inputs"][0], ref)
        fields = {f.name: f for f in self.recipe["inputs"]}
        out = {n: ref.new_zeros(storage_shape(fields[n], spatial))
               for n in wanted}
        if ent is None or not ent.recipe["bwd"]:
            return out
        cots = dict(zip(self.out_names, cotangents))
        of = {t: p for p, t in names.items()}
        g = bwd_call(ent, self._tangent_args(ent, names, ent.recipe["saved"],
                                             env, tangents),
                     [cots[of[n]] for n in ent.out_names])
        for n, x in zip(ent.in_names, g):
            if n in out:
                out[n] = x
        return out

    def second_vjp(self, saved, cotangents, w, needs_saved, needs_cots,
                   fwd_call, bwd_call):
        """Reverse over reverse: the backward's inputs' gradients (saved
        primals, then cotangents; None where not needed) for ``w``, the
        cotangents of its outputs (one per forward input; None where
        unused): ``∇ₓ⟨T(x, w), g⟩`` and ``T(x, w)``."""
        saved_names = self.recipe["saved"]
        env = dict(zip(saved_names, saved))
        tangents = {n: x for n, x in zip(self.in_names, w)
                    if x is not None and n in self.diff_names}
        ref = cotangents[0]
        g_cots = [None] * len(cotangents)
        g_saved = [None] * len(saved)
        if any(needs_cots):
            outs = self.tangent_outputs(env, tangents, ref, fwd_call)
            g_cots = [x if need else None
                      for x, need in zip(outs, needs_cots)]
        wanted = [n for n, need in zip(saved_names, needs_saved) if need]
        if wanted:
            got = self.tangent_vjp(env, tangents, cotangents, wanted, ref,
                                   bwd_call) if tangents else {}
            g_saved = [got.get(n, torch.zeros_like(x)) if need else None
                       for n, x, need in zip(saved_names, saved,
                                             needs_saved)]
        return g_saved, g_cots

    def backward_jvp(self, saved, cotangents, saved_dot, cot_dot, fwd_call,
                     bwd_call):
        """Forward mode through the backward: ``B(x, ġ) + ∇⟨T(x, ẋ), g⟩``
        per forward input (``saved_dot``/``cot_dot``: the tangents of the
        saved primals and of the cotangents, None where there is none)."""
        ref = cotangents[0]
        if any(t is not None for t in cot_dot):
            out = list(bwd_call(self, list(saved), [
                t if t is not None else torch.zeros_like(g)
                for t, g in zip(cot_dot, cotangents)]))
        else:
            spatial = storage_spatial(self.recipe["inputs"][0], ref)
            out = [ref.new_zeros(storage_shape(f, spatial))
                   for f in self.recipe["inputs"]]
        tangents = {n: t for n, t in zip(self.recipe["saved"], saved_dot)
                    if t is not None}
        if tangents and self.diff_names:
            got = self.tangent_vjp(dict(zip(self.recipe["saved"], saved)),
                                   tangents, cotangents, self.diff_names,
                                   ref, bwd_call)
            out = [x + got[n] if n in got else x
                   for n, x in zip(self.in_names, out)]
        return out

    def forward_jvp(self, tensors, tangents, fwd_call):
        """Forward mode: ``T(x, ẋ)`` per forward output."""
        tans = {n: t for n, t in zip(self.in_names, tangents)
                if t is not None}
        return self.tangent_outputs(dict(zip(self.in_names, tensors)), tans,
                                    tensors[0], fwd_call)


def build_autograd_function(op, periodic: bool = False, strategy=None,
                            tile_rows=None, dtype=None,
                            accumulate: str = "pairwise"):
    """The op as ``f(*tensors)`` / ``f(**{field: tensor})`` over the
    ``psat::stencil`` custom op (a ``StencilEntry``): forward program in
    interior mode, backward program(s) in full mode with the fused
    cotangent mask — or both periodic.  The dispatcher runs the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors;
    ``strategy``/``tile_rows`` go to the forward and every backward stage
    alike.  ``dtype`` (a ``torch.dtype``) casts the inputs to it first,
    so forward and backward compute in it; ``accumulate`` is the
    programs' wide-sum mode (``StencilEntry``)."""
    ent = StencilEntry(op, periodic=periodic, strategy=strategy,
                       tile_rows=tile_rows, accumulate=accumulate)
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
