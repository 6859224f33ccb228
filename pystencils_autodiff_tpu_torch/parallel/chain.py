"""Comm-avoiding sharded fused chains: temporal blocking × domain
decomposition in one step — the port of
``pystencils_autodiff_tpu/parallel/chain.py``.

``ShardedStencil`` (sharding.py) exchanges halos every time step: k steps
cost 2k transports per sharded dim.  ``ShardedChain`` exchanges ONE
``k·reach``-deep halo per fused k-cycle call (2 transports per sharded dim,
independent of k), then runs the fused chain kernel on every shard's
halo-extended block in its shard mode (``ops.flatten.ShardSpec``: masks
test *global* coordinates from the shard's base offsets, so an interior
shard's halo is live data for the early steps), and slices the block back.
The result equals the single-device fused chain, and sequential stepping.

Routes, as in the JAX package:

* 2D, and 3D chains of several stages or with in-chain BCs: the stage
  chain (kernel 12, ``ops.stage_chain``) forward and kernel 13
  (``ops.stage_adjoint``) for ``fused_bwd=True``, both the dim-0 march's
  shard mode on the card;
* 3D single-op chains without BCs (``_plane_ok``): the 3D forward chain
  (``ops.time_chain``: the march's or the z-streaming kernel's forward
  mode) and the fused adjoint (row 9s), in shard mode: the dim-0 march's
  two-phase mode over the chain as a one-stage cycle where a march fits
  the block and wins by ``time_chain.two_phase_design``'s reckoning
  (κ-diffusion), else the z-streaming two-phase kernel
  (``ops.plane_adjoint``: D3Q19 in f64), as the JAX package sends the
  same chains to its plane kernel;
* the trivial mesh (every sharded axis of size 1): the unsharded kernels on
  the whole block — no exchange, no global masks.

Gradients: the chain is the ``psat::sharded_chain`` custom op over the
shards' blocks (``ShardedChainEntry``; its backward the
``psat::sharded_chain_bwd`` op), which ``torch.export`` records, so a run
compiled with ``mesh=`` exports; eager calls take the same code through
an autograd Function.  The default backward recomputes the cycles with
sequential ``ShardedStencil`` sweeps and pulls back through them;
``fused_bwd=True`` runs ONE ``k·(reach_f+reach_b+bc)``-deep exchange and
the fused adjoint kernel per shard, autograd supplying the transposed
exchange; a LINEAR single-op periodic chain pulls back through the
transposed op's own ``ShardedChain`` on the cotangents (the twin).  On CPU tensors every
kernel is its plain version's shard mode.

One process drives every shard (as JAX's single-controller ``shard_map``
does); several shards may share one card.  The shards of a call run one
after the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..ops import custom_ops
from ..ops.chain_bc import (apply_bc_sequential, bc_dim_reach,
                            normalize_chain_bcs)
from ..ops.common import backward_program, storage_spatial
from ..ops.flatten import ShardSpec
from ..ops.stage_chain import _cycle_initial_reads, _validate_stages
from .halo import exchange_dim, halo_transpose
from .mesh import ShardedArray, gather_blocks, split_blocks
from .sharding import (ShardedStencil, as_blocks, field_spec, pad_edge,
                       sharded_global_spatial, sharded_stepper, spatial_lead)

__all__ = ["ShardedChain"]

def _as_stages(op_or_stages, carry_map):
    """Normalise a single op + time-stepper carry map to stage form: an
    unmapped input whose name collides with an op output takes the output,
    as the time stepper does."""
    if carry_map is None:
        return [(op, dict(carry)) for op, carry in op_or_stages]
    op = op_or_stages
    in_names = [f.name for f in op.forward_input_fields]
    out_names = {f.name for f in op.forward_output_fields}
    carry = {}
    for n in in_names:
        src = carry_map.get(n, n)
        if n in carry_map or src in out_names:
            carry[n] = src
    return [(op, carry)]


class ShardedChainEntry:
    """A ``ShardedChain`` as the registry entry of the
    ``psat::sharded_chain`` op: ``forward(true_global, blocks)`` and
    ``backward(true_global, needs, blocks, cotangents)`` over the flat
    list of every field's shard blocks (a field's cotangents zero where
    ``needs`` asks none of it)."""

    kind = "sharded_chain"

    def __init__(self, chain):
        self.chain = chain
        self.name = f"sharded_{chain.progs[0].name}"

    def forward(self, true_global, blocks):
        c = self.chain
        return c._flatten(c._fused(c._unflatten(blocks), true_global))

    def backward(self, true_global, needs, blocks, cots):
        c = self.chain
        by = c._unflatten(list(needs))
        needed = {n for n, v in by.items() if any(v)}
        grads = c._pull(c._unflatten(blocks), c._unflatten(cots),
                        true_global, needed)
        return [g for n in c.input_names
                for g in (grads[n] if n in needed
                          else [torch.zeros_like(b) for b in
                                c._unflatten(blocks)[n]])]


class _ChainFunction(torch.autograd.Function):
    """The chain over the flat list of every field's shard blocks: the
    eager path of the ``psat::sharded_chain`` op."""

    @staticmethod
    def forward(ctx, ent, true_global, *flat):
        chain = ent.chain
        out = chain._unflatten(ent.forward(true_global, flat))
        ctx.entry, ctx.true_global = ent, true_global
        ctx.save_for_backward(*flat)
        # a chain-invariant field that needs no gradient stays so through
        # chained calls (the next call's adjoint then makes none for it)
        needs = chain._unflatten(ctx.needs_input_grad[2:])
        frozen = [b for n in chain.invariant if not any(needs[n])
                  for b in out[n]]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(chain._flatten(out))

    @staticmethod
    def backward(ctx, *cots):
        chain = ctx.entry.chain
        saved = ctx.saved_tensors
        cots = [c if c is not None else torch.zeros_like(s)
                for c, s in zip(cots, saved)]
        needs = chain._unflatten(ctx.needs_input_grad[2:])
        needed = {n for n, v in needs.items() if any(v)}
        grads = chain._pull(chain._unflatten(saved), chain._unflatten(cots),
                            ctx.true_global, needed)
        s = chain.mesh.size
        flat = [g for n in chain.input_names
                for g in (grads[n] if n in needed else [None] * s)]
        # a second differentiation raises (the fused kernels have none)
        flat = custom_ops.once_only(flat, list(saved) + cots,
                                    custom_ops.twice_error(
                                        "sharded chain", ctx.entry.name))
        return (None, None) + tuple(flat)


class ShardedChain:
    """k fused cycles of a stage sequence per ONE deep halo exchange.

    Parameters
    ----------
    op_or_stages : an ``AutoDiffOp`` (with ``carry_map=``, time-chain
        style) or a ``[(op, carry_map), ...]`` stage list (stage-chain
        style, see ``ops.fused_stage_chain``).
    k : fused cycle count per call.
    mesh : the device mesh (``parallel.make_mesh``).
    dim_axes : spatial dim → mesh axis name.  Leading dims only — the last
        spatial dim (the kernels' x) stays whole.
    carry_map : required iff ``op_or_stages`` is a single op.
    periodic : global periodic wrap (transported by the exchange across
        shard boundaries; every leading dim the stencil reaches into must
        then be in ``dim_axes`` — a size-1 mesh axis is fine).
    dtype : a ``torch.dtype`` the state is cast to before the chain.
    intermediates, boundary : as ``ops.fused_stage_chain``.
    fused_bwd : the fused comm-avoiding backward (see the module doc).

    ``__call__(state)`` takes a dict of global tensors or ``ShardedArray``s
    and returns the kind it was given.
    """

    def __init__(self, op_or_stages, k: int, mesh, dim_axes: Dict[int, str],
                 carry_map: Optional[Dict[str, str]] = None,
                 periodic: bool = False, dtype=None,
                 intermediates: Sequence[str] = (), boundary=None,
                 fused_bwd: bool = False):
        stages = _as_stages(op_or_stages, carry_map)
        if not stages:
            raise ValueError("no stages")
        self._entry = None
        self.stages = stages
        self.k = int(k)
        self.mesh = mesh
        self.dim_axes = dict(dim_axes)
        self.periodic = periodic
        self._dtype = dtype
        self._boundary = boundary
        self._intermediates = tuple(intermediates)

        progs, carries, state_fields, state_names = _validate_stages(stages)
        self.bcs, extra_fields = normalize_chain_bcs(
            boundary, state_fields,
            {n: f.index_shape for n, f in state_fields.items()},
            progs[0].ndim, len(stages),
            next(iter(state_fields.values())).dtype)
        self._extra_fields = extra_fields
        if extra_fields:
            state_fields = {**state_fields, **extra_fields}
            state_names = list(state_names) + list(extra_fields)
        if self.bcs and periodic:
            frame_kinds = [bc.kind for bl in self.bcs.values() for bc in bl
                           if bc.kind in ("dirichlet", "neumann")]
            if frame_kinds:
                raise ValueError(f"frame BCs {frame_kinds} are meaningless "
                                 f"on a periodic domain")
        for f in state_fields.values():
            if f.layout != tuple(range(f.spatial_dimensions)):
                raise ValueError(f"ShardedChain needs row-major spatial "
                                 f"layouts; {f.name!r} has {f.layout}")
        self.progs, self.carries = progs, carries
        self.state_fields, self.input_names = state_fields, list(state_names)
        # never rewritten by a carry, a stage output or a BC
        written = {bc.field for bl in self.bcs.values() for bc in bl}
        for p, c in zip(progs, carries):
            written |= set(c) | {n for n in state_names
                                 if n in p.output_names}
        self.invariant = [n for n in state_names if n not in written]
        self.initial_read_fields = _cycle_initial_reads(progs, carries)
        bad = [n for n in intermediates if n in self.initial_read_fields]
        if bad:
            raise ValueError(f"stage cycle is misordered: intermediate "
                             f"field(s) {bad} are read before written")
        self.ndim = nd = progs[0].ndim

        # per-dim reach of one full cycle: the stages' ghosts plus the
        # fused BCs' read reaches
        cyc = [(0, 0)] * nd
        for j, p in enumerate(progs):
            cyc = [(lo + plo, hi + phi)
                   for (lo, hi), (plo, phi) in zip(cyc, p.ghost)]
            for bc in self.bcs.get(j, ()):
                cyc = [(lo + blo, hi + bhi) for (lo, hi), (blo, bhi)
                       in zip(cyc, bc_dim_reach(bc, p.ghost, nd))]
        self.cycle_ghost = cyc
        # deep halo: k cycles' reach per sharded dim
        self.halo = {d: (self.k * cyc[d][0], self.k * cyc[d][1])
                     for d in self.dim_axes}

        self._fused_bwd = bool(fused_bwd)
        # the linear twin (ops/adjoint_chain.py semantics): the k-step VJP
        # of a LINEAR single-op periodic chain is (Aᵀ)ᵏ, the transposed
        # op's own comm-avoiding sharded chain on the cotangents
        self._twin = None
        if (self._fused_bwd and len(stages) == 1 and not self.bcs
                and periodic):
            from ..ops.adjoint_chain import transposed_linear_op

            twin = transposed_linear_op(stages[0][0], stages[0][1])
            if twin is not None:
                cot_op, cot_carry, name_of, coeff_reads = twin
                self._twin_info = (name_of, coeff_reads)
                self._twin = ShardedChain(
                    cot_op, k, mesh, dim_axes, carry_map=cot_carry,
                    periodic=True, dtype=dtype)
        if self._fused_bwd:
            # the adjoint chain needs the forward recompute's margin PLUS
            # the backward spread; BC transposes take their mirrored reach
            cyc_b = [(0, 0)] * nd
            for op, _ in self.stages:
                bp = backward_program(op)
                cyc_b = [(lo + plo, hi + phi)
                         for (lo, hi), (plo, phi) in zip(cyc_b, bp.ghost)]
            bcr = [(0, 0)] * nd
            for j, p in enumerate(progs):
                for bc in self.bcs.get(j, ()):
                    bcr = [(lo + blo, hi + bhi) for (lo, hi), (blo, bhi)
                           in zip(bcr, bc_dim_reach(bc, p.ghost, nd))]
            self._halo_bwd = {
                d: (self.k * (cyc[d][0] + cyc_b[d][0] + bcr[d][1]),
                    self.k * (cyc[d][1] + cyc_b[d][1] + bcr[d][0]))
                for d in self.dim_axes}

        for d, ax in self.dim_axes.items():
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
            if not (0 <= d < nd):
                raise ValueError(f"dim {d} out of range for {nd}D op")
            if d == nd - 1:
                raise ValueError(
                    "ShardedChain shards leading dims only; the last "
                    "spatial dim is the lane dim (the kernels' x) — keep it "
                    "whole")
        if periodic:
            unreachable = [d for d in range(nd - 1)
                           if d not in self.dim_axes and cyc[d] != (0, 0)]
            if unreachable:
                raise ValueError(
                    f"periodic ShardedChain needs every leading dim the "
                    f"stencil reaches into in dim_axes (missing {unreachable}"
                    f"); map it to a size-1 mesh axis if it should not be "
                    f"decomposed")

        # the 3D single-op route (JAX: plane chains): the 3D forward chain
        # and the z-streaming adjoint, where the op's carry has no
        # collision the time-chain and stage semantics would read apart
        self._plane_ok = False
        if nd == 3 and len(stages) == 1 and not self.bcs \
                and not self._extra_fields:
            op0, carry0 = stages[0]
            outs0 = {f.name for f in op0.forward_output_fields}
            self._plane_ok = all(
                n in carry0 or n not in outs0
                for n in (f.name for f in op0.forward_input_fields))

        # trivial mesh: every sharded axis of size 1 decomposes nothing —
        # the unsharded kernels on the whole block (the exchange would be
        # the identity)
        self._trivial = all(self.mesh.shape[ax] == 1
                            for ax in self.dim_axes.values())
        self._kernels: Dict[tuple, object] = {}
        self._seq_steps: Dict[tuple, List[object]] = {}

    # -- public API ----------------------------------------------------------

    def partition_spec(self, field) -> tuple:
        return field_spec(field, self.dim_axes, self.ndim)

    def input_shardings(self):
        return {n: self.partition_spec(f)
                for n, f in self.state_fields.items()}

    def __call__(self, state: Dict[str, object]) -> Dict[str, object]:
        names = self.input_names
        state = {n: state[n] for n in names}
        if self._dtype is not None:
            state = {n: (ShardedArray([b.to(self._dtype) for b in v.blocks],
                                      v.mesh, v.spec)
                         if isinstance(v, ShardedArray)
                         else v.to(self._dtype))
                     for n, v in state.items()}
        f0 = self.state_fields[names[0]]
        first = state[names[0]]
        true_global = sharded_global_spatial(f0, first)
        pads = {}
        for d, ax in self.dim_axes.items():
            rem = true_global[d] % self.mesh.shape[ax]
            if rem:
                pads[d] = self.mesh.shape[ax] - rem
        if pads and self.periodic:
            raise ValueError(
                f"periodic sharded dims must divide the mesh evenly "
                f"(global {true_global}, mesh {dict(self.mesh.shape)}): "
                f"pad-and-mask would break the wrap seam")
        sharded_in = isinstance(first, ShardedArray)
        if sharded_in:
            if pads:
                raise ValueError(f"a ShardedArray of global extents "
                                 f"{true_global} does not divide the mesh "
                                 f"{dict(self.mesh.shape)}")
            # a global tensor beside sharded ones (a BC parameter plane) is
            # split like them
            blocks = {n: as_blocks(v, self.mesh, self._spec(n))
                      for n, v in state.items()}
        else:
            device = first.device
            if pads:
                # pad to divisibility; pads are edge copies (finite under
                # nonlinear stages), masked as global ghost by the
                # TRUE-extent tests inside the kernels, sliced off below
                state = {n: pad_edge(v, {self._lead(n) + d: p
                                         for d, p in pads.items()})
                         for n, v in state.items()}
            blocks = {n: split_blocks(v, self.mesh, self._spec(n))
                      for n, v in state.items()}
        if self._entry is None:
            self._entry = ShardedChainEntry(self)
            custom_ops.register(self._entry)
        flat = self._flatten(blocks)
        if custom_ops.traced():
            out = custom_ops.sharded_chain(self._entry.key,
                                           list(true_global), flat)
            # as the eager Function marks them: an invariant field that
            # needs no gradient stays so through chained calls
            needs = self._unflatten([t.requires_grad for t in flat])
            out = self._unflatten(out)
            out = {n: ([b.detach() for b in v]
                       if n in self.invariant and not any(needs[n]) else v)
                   for n, v in out.items()}
        else:
            out = self._unflatten(_ChainFunction.apply(
                self._entry, true_global, *flat))
        if sharded_in:
            return {n: ShardedArray(out[n], self.mesh, self._spec(n))
                    for n in names}
        res = {}
        for n in names:
            g = gather_blocks(out[n], self.mesh, self._spec(n), device)
            for d in pads:
                g = g.narrow(self._lead(n) + d, 0, true_global[d])
            res[n] = g
        return res

    # -- plumbing ------------------------------------------------------------

    def _spec(self, n):
        return self.partition_spec(self.state_fields[n])

    def _lead(self, n) -> int:
        return spatial_lead(self.state_fields[n])

    def _flatten(self, blocks) -> List[torch.Tensor]:
        return [b for n in self.input_names for b in blocks[n]]

    def _unflatten(self, flat) -> Dict[str, List[torch.Tensor]]:
        s = self.mesh.size
        return {n: list(flat[i * s:(i + 1) * s])
                for i, n in enumerate(self.input_names)}

    def _local_spatial(self, blocks):
        n0 = self.input_names[0]
        return tuple(storage_spatial(self.state_fields[n0], blocks[n0][0]))

    def _extend(self, blocks, n, halo) -> ShardedArray:
        """Field ``n``'s blocks halo-extended by ``halo`` in ascending dim
        order (later dims carry the earlier dims' halos: corner halos)."""
        e = ShardedArray(blocks, self.mesh, self._spec(n))
        for d in sorted(halo):
            lo, hi = halo[d]
            if lo or hi:
                e = exchange_dim(e, self._lead(n) + d, self.dim_axes[d], lo,
                                 hi, self.periodic)
        return e

    def _bases(self, i, local_spatial, halo) -> List[int]:
        c = self.mesh.coords(i)
        return [c[self.dim_axes[d]] * local_spatial[d] - halo[d][0]
                if d in self.dim_axes else 0 for d in range(self.ndim)]

    def _check_halo(self, halo, local_spatial, what):
        for d, (lo, hi) in halo.items():
            n_shards = self.mesh.shape[self.dim_axes[d]]
            if max(lo, hi) > local_spatial[d]:
                raise ValueError(
                    f"{what} {max(lo, hi)} along dim {d} exceeds the local "
                    f"shard extent {local_spatial[d]} ({n_shards} shards): "
                    f"reduce k or the mesh axis size")

    def _cast(self, tree):
        if self._dtype is None:
            return tree
        return {n: [b.to(self._dtype) for b in v] for n, v in tree.items()}

    # -- kernels -------------------------------------------------------------

    def _shard_spec(self, true_global):
        return ShardSpec(global_spatial=tuple(true_global),
                         sharded_dims=tuple(sorted(self.dim_axes)))

    def _chain_plan(self, shard):
        from ..ops.time_chain import chain_plan

        op0, carry0 = self.stages[0]
        return chain_plan(op0, self.k, carry0, self.periodic, shard=shard)

    def _forward_kernel(self, true_global):
        """``fn(state, bases) -> state`` of one block: the fused chain in
        shard mode (``true_global`` None: the unsharded chain, the trivial
        mesh's)."""
        key = ("fwd", true_global)
        if key not in self._kernels:
            shard = (self._shard_spec(true_global)
                     if true_global is not None else None)
            if self._plane_ok:
                from ..ops.time_chain import chain_runner

                run = chain_runner(self._chain_plan(shard))
                fn = ((lambda st, bases: run(st)[0]) if shard is None else
                      (lambda st, bases: run(st, bases)[0]))
            else:
                from ..ops.stage_chain import StagePlan, stage_runner

                run = stage_runner(StagePlan(
                    self.stages, self.k, self.periodic, self._boundary,
                    self._intermediates, shard=shard))
                fn = ((lambda st, bases: run(st)) if shard is None else run)
            self._kernels[key] = fn
        return self._kernels[key]

    def _vjp_kernel(self, true_global, wanted):
        """``g(state, cots, bases) -> (state_k, cot_0)`` of one block: the
        fused adjoint in shard mode (None: unsharded); ``wanted``: the
        chain-invariant fields whose cotangent is asked for (the stage
        route computes no other)."""
        key = ("vjp", true_global, wanted)
        if key not in self._kernels:
            shard = (self._shard_spec(true_global)
                     if true_global is not None else None)
            if self._plane_ok:
                g = self._plane_vjp(shard, wanted)
            else:
                from ..ops.stage_adjoint import fused_stage_chain_vjp

                vjp = fused_stage_chain_vjp(
                    self.stages, self.k, periodic=self.periodic,
                    boundary=self._boundary, shard=shard, wanted=wanted)

                def g(state, cots, bases, _s=shard is not None):
                    return vjp(state, cots, bases) if _s else vjp(state, cots)
            self._kernels[key] = g
        return self._kernels[key]

    def _plane_vjp(self, shard, wanted):
        """The 3D single-op route's fused adjoint (rows 9 and 9s): on the
        card the design ``time_chain.two_phase_design`` picks per (block
        shape, itemsize) before any launch — the dim-0 march's two-phase
        mode (its launches count on ``ops.stage_adjoint``, design
        "march-shard") or the z-streaming kernel's, in shard mode; the
        trivial mesh's unsharded block the z-streaming kernel; on CPU
        tensors the plain version (its shard mode)."""
        from ..ops import plane_adjoint as pa
        from ..ops import stage_adjoint as sa
        from ..ops.adjoint_chain import (AdjointPlan, make_chain_march_kernel,
                                         plain_chain_vjp)
        from ..ops.cuda_kernel import on_card, tile_itemsize
        from ..ops.time_chain import two_phase_design
        from ..utils.config import log_lowering_decision

        ap = AdjointPlan(self._chain_plan(shard))
        plain = plain_chain_vjp(ap)
        first = self.input_names[0]
        if shard is None:
            stream = pa.make_plane_adjoint_kernel(ap)

            def g(state, cots, bases):
                run = stream if on_card(state[first]) else plain
                return run(state, cots)
            return g
        kernels = {"march": make_chain_march_kernel(ap.fwd, sa, wanted),
                   "stream": pa.make_plane_adjoint_kernel(ap)}
        designs: Dict[tuple, str] = {}

        def g(state, cots, bases):
            if not on_card(state[first]):
                return plain(state, cots, (), bases)
            a0 = state[first]
            spatial = tuple(storage_spatial(self.state_fields[first], a0))
            key = (spatial, tile_itemsize(a0))
            if key not in designs:
                d = two_phase_design(ap, *key, wanted)
                log_lowering_decision(ap.fwd.program.name,
                                      route="sharded_two_phase", design=d,
                                      spatial=spatial, itemsize=key[1])
                # neither fits: the streaming kernel raises its ValueError
                designs[key] = d or "stream"
            return kernels[designs[key]](state, cots, (), bases)

        g.designs = designs
        return g

    # -- fused forward -------------------------------------------------------

    def _fused(self, local, true_global):
        names = self.input_names
        if self._trivial:
            run = self._forward_kernel(None)
            outs = [run({n: local[n][i] for n in names}, None)
                    for i in range(self.mesh.size)]
            return {n: [o[n] for o in outs] for n in names}
        local_spatial = self._local_spatial(local)
        self._check_halo(self.halo, local_spatial, "chain halo")
        ext = {n: self._extend(local[n], n, self.halo) for n in names}
        run = self._forward_kernel(true_global)
        out = {n: [] for n in names}
        for i in range(self.mesh.size):
            o = run({n: ext[n].blocks[i] for n in names},
                    self._bases(i, local_spatial, self.halo))
            for n in names:
                out[n].append(self._crop(o[n], n, self.halo, local_spatial))
        return out

    def _crop(self, t, n, halo, local_spatial):
        for d, (lo, _) in halo.items():
            t = t.narrow(self._lead(n) + d, lo, local_spatial[d])
        return t

    # -- backward ------------------------------------------------------------

    def _pull(self, saved, cot, true_global, needed=None):
        """The cotangents of the blocks; ``needed``: the fields whose
        gradient is asked for (default: all)."""
        names = self.input_names
        wanted = frozenset(needed if needed is not None else names)
        if self._twin is not None:
            name_of, coeff_reads = self._twin_info
            ct = {name_of[m]: cot[m] for m in name_of}
            # coefficient arrays ride the cotangent chain unchanged
            for cn in coeff_reads:
                ct[cn] = saved[cn]
            ct = self._twin._fused(self._cast(ct), true_global)
            # declared-constant coefficients keep the identity pass-through
            # of their cotangent (the forward returns them unchanged)
            return {m: (ct[name_of[m]] if m in name_of else cot[m])
                    for m in names}
        saved, cot = self._cast(saved), self._cast(cot)
        if self._fused_bwd:
            if self._trivial:
                g = self._vjp_kernel(None, wanted)
                res = [g({n: saved[n][i] for n in names},
                         {n: cot[n][i] for n in names}, None)[1]
                       for i in range(self.mesh.size)]
                return {n: [r.get(n, cot[n][i]) for i, r in enumerate(res)]
                        for n in names}
            return self._local_pull(saved, cot, true_global, wanted)
        return self._sequential_pull(saved, cot, true_global)

    def _local_pull(self, saved, cot, true_global, wanted):
        """ONE deep halo exchange (k·(reach_f+reach_b+bc) a side), the fused
        adjoint kernel on every extended block for a cotangent on its owned
        cells (0 on its halo), then the transposed exchange
        (``halo.halo_transpose``, in reverse dim order) routing the halo
        cotangents back to the shards they came from."""
        import torch.nn.functional as F

        names = self.input_names
        halo = self._halo_bwd
        local_spatial = self._local_spatial(saved)
        self._check_halo(halo, local_spatial, "fused-backward halo")
        ext = {n: self._extend(saved[n], n, halo) for n in names}
        g = self._vjp_kernel(true_global, wanted)
        # the fields whose cotangent is asked for; an invariant field's
        # only where wanted (the adjoint kernels make no other)
        outs = [n for n in names if n in wanted]
        cot0 = {n: [] for n in outs}
        for i in range(self.mesh.size):
            st = {n: ext[n].blocks[i] for n in names}
            ce = {}
            for n in names:
                # 0 on the halo: F.pad takes (lo, hi) pairs, last dim first
                pad = []
                for ax in range(cot[n][i].dim() - 1, -1, -1):
                    d = ax - self._lead(n)
                    pad += list(halo.get(d, (0, 0))) if d >= 0 else [0, 0]
                ce[n] = F.pad(cot[n][i], pad)
            _, c0 = g(st, ce, self._bases(i, local_spatial, halo))
            for n in outs:
                cot0[n].append(c0[n] if n in c0 else torch.zeros_like(st[n]))
        for n in outs:
            for d in sorted(halo, reverse=True):
                lo, hi = halo[d]
                if lo or hi:
                    cot0[n] = halo_transpose(cot0[n], self.mesh,
                                             self._lead(n) + d,
                                             self.dim_axes[d], lo, hi,
                                             self.periodic)
        return cot0

    def _sequential_pull(self, saved, cot, true_global):
        """The default backward: the k cycles recomputed with sequential
        ``ShardedStencil`` sweeps (and the sequential BCs) on the gathered
        state, pulled back by autograd."""
        names = self.input_names
        dev = saved[names[0]][0].device
        glob = {n: gather_blocks(saved[n], self.mesh, self._spec(n), dev)
                for n in names}
        gcot = {n: gather_blocks(cot[n], self.mesh, self._spec(n), dev)
                for n in names}
        with torch.enable_grad():
            ins = {n: v.detach().requires_grad_() for n, v in glob.items()}
            out = self._sequential(ins, true_global)
            used = [n for n in names if out[n].requires_grad]
            grads = torch.autograd.grad([out[n] for n in used],
                                        [ins[n] for n in names],
                                        [gcot[n] for n in used],
                                        allow_unused=True)
        return {n: split_blocks(gr if gr is not None
                                else torch.zeros_like(glob[n]),
                                self.mesh, self._spec(n))
                for n, gr in zip(names, grads)}

    def _sequential(self, state, true_global):
        if true_global not in self._seq_steps:
            self._seq_steps[true_global] = [
                sharded_stepper(op, carry, ShardedStencil(
                    op, self.mesh, self.dim_axes, periodic=self.periodic,
                    mask_global_spatial=true_global))
                for op, carry in self.stages]
        for _ in range(self.k):
            for j, step in enumerate(self._seq_steps[true_global]):
                for bc in self.bcs.get(j, ()):
                    state = apply_bc_sequential(state, bc,
                                                self.progs[j].ghost,
                                                self.periodic,
                                                fields=self.state_fields)
                state = step(state)
        return {n: state[n] for n in self.input_names}
