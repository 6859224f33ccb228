"""Fused adjoint of heterogeneous stage chains: the value AND gradient of
k cycles of a multi-op sequence in one kernel — the port of
``pystencils_autodiff_tpu/ops/stage_adjoint.py``.

``fused_stage_chain_vjp(stages, k, ...)`` returns
``g(state, cot_state) -> (state_k, cot_0)``.  On CUDA tensors it runs
kernel 13, the counterpart of the Pallas kernel ``fused_stage_chain_vjp``,
as the two-phase mode of the dim-0 march of ``ops.stage_march``
(``csrc/stage_march.cuh``; the box-tile design of ``csrc/stage_adjoint.cuh``
stays behind ``make_stage_adjoint_kernel(ap, "box")``): phase 1
recomputes every event of the k cycles (BC events and stages, the same
device code as kernel 12), keeping per stage only the primal planes its
backward program reads; phase 2 walks the events back, threading
cotangents through each stage's reverse step (its symbolically derived
backward program, or its local-VJP form) and the stage-carry transpose

    ĉ_state[m] = Σ_{n carried from output o} (∂F_o/∂m)ᵀ·ĉ'[n]
               + Σ_{n whose carry source is state field m} ĉ'[n]

(unmapped state passes through, and so does its cotangent), and through
the in-kernel transposes of the BC events: dirichlet zeroes the
cotangent on its frame; neumann sums the frame cotangents into the
interior cell they copy; masked_dirichlet zeroes it under the mask and
sends it to a field-valued Dirichlet value; sponge multiplies by the
damping (and, for a damping field, accumulates pre-sponge state ×
cotangent into its gradient); bounce_back transposes the population
swap, edge-clamped pulls included, and accumulates the wall-velocity term
into each wall-velocity field's gradient.

Where no march of the k-deep kernel fits the shared memory with the
picker's owned-share floor, ``g`` runs the segmented form (the JAX
package's ``seg_compose``): kernel 12 at depth kk writes the k/kk − 1
checkpoints, then the kk-deep kernel 13 runs per segment in reverse.
The choice is made from the march reckoning when a shape is first seen
(``g.segments``), never on a failure: a build or launch error raises.

``wanted``: the chain-invariant fields (BC parameters, coefficients) whose
gradient is asked for — the others get no cotangent planes, and a sponge
whose damping gradient is not wanted saves no pre-sponge planes.  Every
other state field always gets its cotangent.  On CPU tensors ``g`` runs
the plain version (``plain_stage_chain_vjp``: autograd through
``plain_stage_chain``).  ``LAUNCHES`` / ``LAUNCH_CALLS`` count kernel 13.
"""

from __future__ import annotations

from collections import Counter
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..adjoint_field import AdjointField
from ..codegen.cuda_printer import input_planes, output_planes
from .common import (backward_program, check_ported, field_components,
                     storage_shape, storage_spatial)
from .cuda_kernel import _DTYPES, tile_itemsize
from .launch import empty, real, run
from . import stage_chain as _sc
from .stage_chain import (StagePlan, check_stage_state, plain_stage_chain,
                          sequential_stage_chain,
                          stage_geometry, stage_runner)
from .stage_march import march_fits
from .time_chain import ADJ_BLOCK_ROWS, _load_library, access_reach, plane_args3
from ..utils.config import log_lowering_decision

__all__ = ["fused_stage_chain_vjp", "validate_bc_invariance",
           "plain_stage_chain_vjp", "make_stage_adjoint_kernel",
           "AdjointStagePlan", "reset_launch_counts", "LAUNCHES",
           "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()
# owned tile widths tried beside time_chain.TILE_COLS in 2D: a BGK cavity
# holds 41 planes at depth 1 (21 pool buffers, 2 × 10 cotangent slots),
# whose f64 tiles fit only 16 columns wide
ADJ_NARROW_COLS = (16,)


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def validate_bc_invariance(bcs, carries) -> None:
    """Build-time checks for BCs entering the fused backward: phase 2
    reads BC parameter planes from the ORIGINAL input block
    (chain-invariance) — a carry-written mask/value/u_wall field would
    make every cycle's transpose use the cycle-0 plane, and a
    masked_dirichlet value aliasing its target is ambiguous."""
    bad = [bc.kind for bl in bcs.values() for bc in bl
           if bc.kind not in ("dirichlet", "neumann",
                              "masked_dirichlet", "bounce_back", "sponge")]
    if bad:
        raise ValueError(
            f"fused_stage_chain_vjp: BC kinds {bad} have no fused "
            f"transpose yet — use fused_bwd=False (sequential "
            f"recompute backward)")
    carried = {dst for c in carries for dst in c}
    for bl in bcs.values():
        for bc in bl:
            params = [bc.mask] + list(bc.u_wall or ()) + [bc.value]
            refs = [p for p in params if isinstance(p, str)]
            if bc.value == bc.field:
                raise ValueError(
                    f"fused backward: {bc.kind} value/profile field "
                    f"aliases its target {bc.field!r} — unsupported")
            hot = sorted(set(refs) & carried)
            if hot:
                raise ValueError(
                    f"fused backward: BC parameter field(s) {hot} are "
                    f"carry targets (not chain-invariant) — use "
                    f"fused_bwd=False")


class AdjointStagePlan:
    """Kernel 13's wiring on top of a ``StagePlan``: the cotangent planes
    (every plane but those of invariant fields whose gradient is not
    wanted), per stage the backward program and its slot tables, per event
    the planes kept from phase 1 and the reverse reach."""

    def __init__(self, plan: StagePlan, wanted=None):
        self.fwd = plan
        inv = plan.invariant
        self.wanted = set(inv if wanted is None else wanted) & inv
        keys = plan.plane_keys
        self.cot_planes = [n for n, (name, _) in enumerate(keys)
                           if name not in inv or name in self.wanted]
        self.cslot = [-1] * len(keys)
        for cs, n in enumerate(self.cot_planes):
            self.cslot[n] = cs
        self.cot_names = [nm for nm in plan.state_names
                          if nm not in inv or nm in self.wanted]
        self.bwd = [backward_program(op) for op, _ in plan.stages]
        for b in self.bwd:
            check_ported(b)
        self.tables = []  # per cycle event: stage tables or BC slots
        self.keeps, self.reach = [], []
        for ev in plan.cycle:
            if ev.kind == "stage":
                t, keep = self._stage_tables(ev)
                self.tables.append(t)
                self.keeps.append(keep)
                self.reach.append(access_reach(self.bwd[ev.stage].steps,
                                               plan.nd))
            else:
                bc = ev.bc
                keep = []
                if (bc.kind == "sponge" and isinstance(bc.value, str)
                        and bc.value in self.wanted):
                    keep = plan.planes_of(bc.field)
                self.tables.append(None)
                self.keeps.append(keep)
                lo, hi = ev.reach
                self.reach.append((list(hi), list(lo)))  # mirrored

    def _stage_tables(self, ev):
        plan = self.fwd
        keys = plan.plane_keys
        op = plan.stages[ev.stage][0]
        bwd = self.bwd[ev.stage]
        prog = plan.progs[ev.stage]
        outs = [(f.name, idx) for f in prog.output_fields
                for idx in field_components(f)]
        prim, adj, keep = [], [], set()
        for f, idx in input_planes(bwd):
            if isinstance(f, AdjointField):
                primal = f.corresponding_forward_field.name
                carriers = ([n for n, s in enumerate(ev.src)
                             if s == ("out", outs.index((primal, idx)))]
                            if (primal, idx) in outs else [])
                # an output carried into several state fields reads the
                # sum of their cotangents
                adj.append([self.cslot[n] for n in carriers])
                prim.append(-1)
            else:
                if (f.name, idx) not in keys:
                    raise NotImplementedError(
                        f"{op.op_name}: the backward program reads "
                        f"{f.name!r}, which is not a state field")
                n = keys.index((f.name, idx))
                prim.append(n)
                adj.append([])
                keep.add(n)
        grad_of = {f.name: f.corresponding_forward_field.name
                   for f in op.backward_output_fields}
        grad = [-1] * len(self.cot_planes)
        for slot, (f, idx) in enumerate(output_planes(bwd)):
            n = keys.index((grad_of[f.name], idx))
            if self.cslot[n] >= 0:
                grad[self.cslot[n]] = slot
        passes = [[self.cslot[n] for n, s in enumerate(ev.src)
                   if s == ("in", m) and self.cslot[n] >= 0]
                  for m in self.cot_planes]
        return ({"prim": prim, "adj": adj, "grad": grad, "pass": passes},
                sorted(keep))

    def events_keeps(self):
        return self.keeps * self.fwd.k

    def events_reach(self):
        return self.reach * self.fwd.k


def adjoint_geometry(ap: AdjointStagePlan, spatial, itemsize: int):
    """Geometry of kernel 13: the halo holds the forward and reverse reach
    of every event; 2 cotangent sets follow the pool; 32-row blocks, one
    tile per SM; 2D tiles may also be ``ADJ_NARROW_COLS`` wide.  Raises ``ValueError`` when no tile fits."""
    return stage_geometry(ap.fwd, spatial, itemsize,
                          second_reach=ap.events_reach(),
                          keeps=ap.events_keeps(),
                          extra_planes=2 * len(ap.cot_planes),
                          blocks_per_sm=1, block_rows=ADJ_BLOCK_ROWS,
                          cols=ADJ_NARROW_COLS)


# ---------------------------------------------------------------------------
# Plain version.

def plain_stage_chain_vjp(ap: AdjointStagePlan, form: str = "gather"):
    """``fn(state, cots, bases=None) -> (state_k, cot_0)``: autograd
    through ``plain_stage_chain`` (the plain single steps and the
    sequential BCs) — the plain version of kernel 13.  ``cot_0`` holds the
    cotangent fields of ``ap`` (``ap.cot_names``).  ``form="local"``
    walks the events back explicitly, each stage in the local-VJP form
    (``plain_local_vjp``).  A sharded plan (``ap.fwd.shard``) takes the
    block's ``bases`` and differentiates the plain shard mode, whatever
    the form (the exact VJP both forms compute)."""
    if ap.fwd.probes:
        raise NotImplementedError(
            f"{ap.fwd.name}: the plain stage versions take no probe rows "
            f"(ops.adjoint_chain.plain_chain_vjp does)")
    if form not in ("gather", "local"):
        raise ValueError(f"unknown form {form!r}; 'gather' or 'local'")
    if form == "local" and ap.fwd.shard is None:
        return plain_local_vjp(ap)
    plan = ap.fwd
    fwd = plain_stage_chain(plan)

    def fn(state, cots, bases=None):
        with torch.enable_grad():
            # a mask (bool, int) is no cotangent field: it stays as given
            ins = {n: (state[n].detach().requires_grad_()
                       if state[n].is_floating_point() else state[n])
                   for n in plan.state_names}
            out = fwd(ins, bases)
            names = [n for n in plan.state_names if n in cots]
            grads = torch.autograd.grad(
                [out[n] for n in names], [ins[n] for n in ap.cot_names],
                [cots[n] for n in names], allow_unused=True)
        new = {n: t.detach() for n, t in out.items()}
        return new, {n: (g if g is not None else torch.zeros_like(state[n]))
                     for n, g in zip(ap.cot_names, grads)}

    return fn


def _shifted(w, offs, periodic):
    """``out(y) = w(y − o)``, wrapped (periodic) or 0-filled (bounded)."""
    if periodic:
        return torch.roll(w, tuple(offs), tuple(range(w.dim())))
    out = torch.zeros_like(w)
    dst = tuple(slice(max(o, 0), n + min(o, 0)) for o, n in zip(offs,
                                                                w.shape))
    src = tuple(slice(max(-o, 0), n - max(o, 0)) for o, n in zip(offs,
                                                                 w.shape))
    out[dst] = w[src]
    return out


def plain_local_vjp(ap: AdjointStagePlan):
    """The plain version of kernel 13 in the local-VJP form: the forward
    events keeping each state, then the events walked back — a BC event
    by autograd through its sequential form, a stage as L (its local VJP,
    ``ops.local_vjp.stage_local_vjp``, at every write cell: the program
    evaluated over the whole domain with its cotangent inputs masked to
    the stage's interior window, or periodic) and G (each cotangent plane
    gathered from the w planes moved by their read offsets, plus the
    cotangents carried through unchanged)."""
    from .chain_bc import apply_bc_sequential
    from .common import assemble_planes, plane_view
    from .local_vjp import stage_local_vjp
    from .torch_ref import make_torch_stencil

    plan = ap.fwd
    names = plan.state_names
    keys = plan.plane_keys
    events = plan.events()
    steps = [make_torch_stencil(p, periodic=plan.periodic)
             for p in plan.progs]
    lvs, lsteps = {}, {}
    for ev in plan.cycle:
        if ev.kind == "stage" and ev.stage not in lvs:
            lv = stage_local_vjp(plan, ev, lambda n: ap.cslot[n] >= 0)
            lvs[ev.stage] = lv
            lsteps[ev.stage] = make_torch_stencil(
                lv.program, full_domain=True, periodic=plan.periodic,
                adjoint_mask_ghost=plan.progs[ev.stage].ghost)

    def fn(state, cots):
        f0 = plan.state_fields[names[0]]
        spatial = storage_spatial(f0, state[names[0]])

        def fields_of(cot, nm):
            """Field ``nm``'s cotangent from the planes by cot slot (0 for
            a plane with no slot)."""
            f = plan.state_fields[nm]
            cs = [ap.cslot[keys.index((nm, idx))]
                  for idx in field_components(f)]
            return assemble_planes(f, [cot[c] if c >= 0 else zero
                                       for c in cs], spatial)
        st = {n: state[n] for n in names}
        states = []
        for ev in events:
            states.append(st)
            j = ev.stage
            if ev.kind == "bc":
                st = apply_bc_sequential(st, ev.bc, plan.progs[j].ghost,
                                         plan.periodic,
                                         fields=plan.state_fields)
            else:
                prog = plan.progs[j]
                outs = steps[j]({n: st[n] for n in prog.input_names})
                env = {**st, **outs}
                st = {**st, **{d: env[s_] for d, s_ in
                               plan.carries[j].items()}}
        zero = torch.zeros(spatial, dtype=state[names[0]].dtype,
                           device=state[names[0]].device)
        def slots(fields):
            """Cotangent planes by cot slot (0 where a field is None)."""
            return [plane_view(f, fields[f.name], idx)
                    if fields[f.name] is not None else zero
                    for f, idx in (plan.planes[n] for n in ap.cot_planes)]

        cot = slots(cots)
        for e in range(len(events) - 1, -1, -1):
            ev, before = events[e], states[e]
            if ev.kind == "bc":
                with torch.enable_grad():
                    ins = {n: t.detach().requires_grad_()
                           for n, t in before.items()}
                    out = apply_bc_sequential(ins, ev.bc,
                                              plan.progs[ev.stage].ghost,
                                              plan.periodic,
                                              fields=plan.state_fields)
                    grads = torch.autograd.grad(
                        [out[nm] for nm in names],
                        [ins[nm] for nm in names],
                        [fields_of(cot, nm) for nm in names],
                        allow_unused=True)
                cot = slots(dict(zip(names, grads)))
                continue
            prog = plan.progs[ev.stage]
            lv = lvs[ev.stage]
            ins = {f.name: before[f.name] for f in prog.input_fields}
            outs = [(f, idx) for f in prog.output_fields
                    for idx in field_components(f)]
            for f in prog.output_fields:
                adj = next(a for a in lv.program.input_fields
                           if getattr(a, "corresponding_forward_field",
                                      None) is not None
                           and a.corresponding_forward_field.name == f.name)
                planes = []
                for idx in field_components(f):
                    o = outs.index((f, idx))
                    car = [ap.cslot[n] for n, s_ in enumerate(ev.src)
                           if s_ == ("out", o) and ap.cslot[n] >= 0]
                    acc = zero
                    for m in car:
                        acc = acc + cot[m]
                    planes.append(acc)
                ins[adj.name] = assemble_planes(adj, planes, spatial)
            w = lsteps[ev.stage](ins)
            new = []
            for m, n in enumerate(ap.cot_planes):
                acc = zero
                for a, (ms, offs) in enumerate(lv.slots):
                    if ev.in_planes[ms] == n:
                        acc = acc + _shifted(w[f"w{a}"], offs, plan.periodic)
                for q in ap.tables[e % len(plan.cycle)]["pass"][m]:
                    acc = acc + cot[q]
                new.append(acc)
            cot = new
        return ({n: t.detach() for n, t in st.items()},
                {nm: fields_of(cot, nm).contiguous() for nm in ap.cot_names})

    return fn


# ---------------------------------------------------------------------------
# The CUDA kernel.

def check_cots(ap: AdjointStagePlan, cots, a0, spatial) -> None:
    """Kernel 13's cotangent checks: one per cotangent field, in its
    storage shape, on the state's device and in its type."""
    plan = ap.fwd
    for n in ap.cot_names:
        t = cots[n]
        want = storage_shape(plan.state_fields[n], spatial)
        if (t.device != a0.device or t.dtype != a0.dtype
                or tuple(t.shape) != want):
            raise ValueError(
                f"{plan.name}: cotangent {n!r} must be {want} {a0.dtype} "
                f"on {a0.device}; got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def make_stage_adjoint_kernel(ap: AdjointStagePlan, design: str = "march",
                              form=None):
    """``fn(state, cots) -> (state_k, cot_0)`` through kernel 13; same
    semantics as ``plain_stage_chain_vjp``.  Chain-invariant state fields
    come back as the tensors given.  ``design``: "march" (the dim-0 march,
    ``ops.stage_march``, each stage's reverse in ``form`` or the form the
    reckoning picks; ``ValueError`` at a shape no march fits) or "box" (the
    box tile of PR 4, kept for the in-turns comparison of the two
    designs)."""
    from .stage_march import make_march_kernel

    if design == "march":
        return make_march_kernel(ap.fwd, ap, form)
    if design == "box":
        return make_box_adjoint_kernel(ap)
    raise ValueError(f"unknown design {design!r}; 'march' or 'box'")


def make_box_adjoint_kernel(ap: AdjointStagePlan):
    """``fn(state, cots) -> (state_k, cot_0)`` through kernel 13 in the
    box-tile design of PR 4 (``csrc/stage_adjoint.cuh``)."""
    from ..codegen.cuda_printer import generate_stage_adjoint_source

    plan = ap.fwd
    lib_state: dict = {}
    name = f"{plan.name}_stage_adjoint_k{plan.k}"
    nd = plan.nd
    cot_planes = [plan.planes[n] for n in ap.cot_planes]

    def fn(state, cots):
        global LAUNCHES
        a0, spatial = check_stage_state(plan, state)
        check_cots(ap, cots, a0, spatial)
        new_state = {n: (state[n] if n in plan.invariant else
                         empty(storage_shape(plan.state_fields[n], spatial),
                               a0.dtype, a0.device))
                     for n in plan.state_names}
        cot0 = {n: empty(storage_shape(plan.state_fields[n], spatial),
                         a0.dtype, a0.device)
                for n in ap.cot_names}
        if any(n == 0 for n in spatial):
            return real(new_state), real(cot0)
        geo, _ = adjoint_geometry(ap, spatial, tile_itemsize(a0))
        lib = _load_library(lib_state,
                            partial(generate_stage_adjoint_source, ap),
                            name, a0.dtype)
        stored = {n: t for n, t in new_state.items()
                  if n not in plan.invariant}
        args = [*plane_args3(plan.planes, state, nd),
                *plane_args3(plan.planes, stored, nd),
                *plane_args3(cot_planes, cots, nd),
                *plane_args3(cot_planes, cot0, nd), geo]
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)], args, a0,
               f"{name}: stage adjoint launch"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.name, plan.k, plan.periodic, spatial,
                          a0.element_size())] += 1
        return real(new_state), real(cot0)

    fn.plan = ap
    return fn


# ---------------------------------------------------------------------------
# The user-facing function.

def fused_stage_chain_vjp(stages: Sequence[Tuple[object, Dict[str, str]]],
                          k: int, periodic: bool = False, boundary=None,
                          wanted=None, segments: Optional[int] = None,
                          shard=None, form=None):
    """Build ``g(state, cot_state) -> (state_k, cot_0)`` for k cycles of the
    stage sequence with the in-chain BCs of ``boundary`` (see the module
    doc).  ``segments`` forces the number of segments (a divisor of k); by
    default it is 1 where a k-deep march fits, else the fewest that fit
    (CUDA tensors; CPU tensors run the plain version, segmented only when
    forced).  ``g.segments`` is the count chosen at the last new shape;
    ``g.segments_for(spatial, itemsize)`` gives the count the reckoning
    picks for a shape: the fewest segments whose depth a march holds
    (``stage_march.march_fits``), raising where none fits even at depth
    1; ``g.route_for`` gives None there, and on the card ``g`` then runs
    the ladder's last rung, the sequential-recompute backward (autograd
    through ``sequential_stage_chain``, the ``fused_bwd=False`` path), as
    the JAX package does (``ops/stage_chain.py:773–792``).  ``form`` (as
    ``stage_march.stage_march_geometry`` takes it) forces the march's
    reverse forms; on the CPU ``form="local"`` runs the plain local
    form.

    ``shard`` (an ``ops.flatten.ShardSpec``, ``parallel.ShardedChain``'s
    fused backward): the state is one halo-extended block and ``g`` is
    called as ``g(state, cots, bases)``.  As in the JAX package's sharded
    adjoint, it is one k-deep kernel 13 in shard mode — no segments and no
    sequential rung; a march that does not fit the block raises — or, on
    CPU tensors, its plain version."""
    plan = StagePlan(stages, k, periodic, boundary, shard=shard)
    if shard is not None and segments not in (None, 1):
        raise ValueError("a sharded fused adjoint runs as one k-deep "
                         "kernel: segments must be 1")
    validate_bc_invariance(plan.bcs, plan.carries)
    if segments is not None and (segments < 1 or k % segments):
        raise ValueError(f"segments={segments} must divide k={k}")
    parts: Dict[int, tuple] = {}

    def at_depth(kk, f=form):
        """(forward runner, forward plain, adjoint plan, kernel 13, plain
        vjp) of the kk-deep chain, kernel 13 in form ``f``; the runner
        takes the forward ladder (``stage_chain.stage_runner``) to write
        the checkpoints."""
        if (kk, f) not in parts:
            p = plan if kk == k else StagePlan(stages, kk, periodic, boundary,
                                               shard=shard)
            ap = AdjointStagePlan(p, wanted)
            parts[kk, f] = (stage_runner(p), plain_stage_chain(p),
                            ap, make_stage_adjoint_kernel(ap, form=f),
                            plain_stage_chain_vjp(
                                ap, "local" if f == "local" else "gather"))
        return parts[kk, f]

    chosen: Dict[tuple, Optional[int]] = {}
    forms: Dict[tuple, Optional[str]] = {}

    def fits(m, spatial, itemsize, f=form):
        """Whether a march of the (k/m)-deep adjoint fits the shape."""
        ap = at_depth(k // m, f)[2]
        return march_fits(ap.fwd, spatial, itemsize, ap, f)

    def route(spatial, itemsize, f=form):
        """The fewest segments whose depth a march holds, or None where
        none fits even at depth 1 (the sequential-recompute rung)."""
        key = (spatial, itemsize, f)
        if key not in chosen:
            chosen[key] = next((cand for cand in range(1, k + 1)
                                if k % cand == 0
                                and fits(cand, spatial, itemsize, f)), None)
            log_lowering_decision(plan.name, route="route_for", k=k,
                                  spatial=spatial, itemsize=itemsize, form=f,
                                  segments=chosen[key])
        g.segments = chosen[key]
        return chosen[key]

    def form_for(state):
        """``form``, or where it is None the measured-best form an
        autotune sweep recorded for the state's device, shape and type
        (``utils.autotune.tuned_tile``), else None (the reckoning's)."""
        if form is not None:
            return form
        t0 = state[plan.state_names[0]]
        key = (tuple(t0.shape), t0.dtype, t0.device)
        if key not in forms:
            from ..utils.autotune import stage_sig_of, tuned_tile

            f0 = plan.state_fields[plan.state_names[0]]
            forms[key] = tuned_tile(
                "stages", "grad", stage_sig_of(stages, plan.bcs),
                storage_spatial(f0, t0), t0.dtype, periodic, k,
                device=t0.device)
        return forms[key]

    def sequential(state):
        """Whether ``g`` takes the ladder's last rung for ``state``."""
        if (shard is not None or segments is not None
                or not _sc.on_card(state[plan.state_names[0]])):
            return False
        a0, spatial = check_stage_state(plan, state)
        return route(spatial, tile_itemsize(a0), form_for(state)) is None

    def choose(spatial, itemsize):
        m = route(spatial, itemsize)
        if m is None:
            raise ValueError(
                f"{plan.name}: no march of the fused adjoint fits even "
                f"at depth 1 for {spatial} ({itemsize}-byte elements)")
        return m

    def g(state, cot_state, bases=None):
        on_card = _sc.on_card(state[plan.state_names[0]])
        f = form_for(state)
        if shard is not None:
            _, _, ap, kern_b, plain_b = at_depth(k, f)
            g.segments = 1
            cots = {n: cot_state[n] for n in ap.cot_names}
            if on_card:
                return kern_b(state, cots, bases=bases)
            return plain_b(state, cots, bases)
        if segments is not None:
            m = g.segments = segments
        elif on_card:
            a0, spatial = check_stage_state(plan, state)
            m = route(spatial, tile_itemsize(a0), f)
            if m is None:
                return recompute(state, cot_state)
        else:
            m = g.segments = 1
        kern_f, plain_f, ap, kern_b, plain_b = at_depth(k // m, f)
        fwd, bwd = (kern_f, kern_b) if on_card else (plain_f, plain_b)
        cps = [{n: state[n] for n in plan.state_names}]
        for _ in range(m - 1):
            cps.append(fwd(cps[-1]))
        ct = {n: cot_state[n] for n in ap.cot_names}
        new_state = None
        for j in range(m - 1, -1, -1):
            st_j, ct = bwd(cps[j], ct)
            if new_state is None:
                new_state = st_j
        return new_state, ct

    def recompute(state, cot_state):
        """The ladder's last rung: k cycles recomputed through the ops'
        own single steps (``sequential_stage_chain``) and pulled back by
        autograd — the ``fused_bwd=False`` backward."""
        names = plan.state_names
        cot_names = at_depth(k)[2].cot_names
        with torch.enable_grad():
            ins = {n: state[n].detach().requires_grad_() for n in names}
            out = seq_chain(ins)
            outs = [n for n in cot_names if out[n].requires_grad]
            grads = torch.autograd.grad([out[n] for n in outs],
                                        [ins[n] for n in cot_names],
                                        [cot_state[n] for n in outs],
                                        allow_unused=True)
        return ({n: out[n].detach() for n in names},
                {n: (gr if gr is not None else torch.zeros_like(state[n]))
                 for n, gr in zip(cot_names, grads)})

    seq_chain = sequential_stage_chain(plan)
    g.sequential = sequential
    g.segments = segments
    g.segments_for = choose
    g.route_for = route
    g.input_names = list(plan.state_names)
    g.k = k
    g.plan = plan
    g.at_depth = at_depth
    return g
