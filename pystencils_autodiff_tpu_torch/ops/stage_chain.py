"""Heterogeneous fused chains: k cycles of a *sequence of different ops*
(RK stages, a staggered velocity/stress pair, a BGK step behind its
bounce-back walls) in one kernel — the port of
``pystencils_autodiff_tpu/ops/stage_chain.py``.

``fused_stage_chain(stages, k, ...)`` advances a state dict k cycles per
call.  A cycle runs, for each stage j in order, the BC events of
``boundary`` that precede stage j (``ops/chain_bc.py``), then stage j's
op and its carry map.  On CUDA tensors the cycle runs through the
hand-written kernel 12, the counterpart of the Pallas kernel
``_make_stage_chain_kernel``: the dim-0 march of ``ops.stage_march``
(``csrc/stage_march.cuh``; the box-tile design of ``csrc/stage_chain.cuh``
stays behind ``make_stage_kernel(plan, "box")``); on CPU tensors through the
plain version ``plain_stage_chain`` (k cycles of the plain single steps of
``ops.torch_ref`` and the sequential BCs of ``boundary.py``).  Both have
the semantics of sequential stepping with ``stage_stepper``: each stage is
one interior-mode (or periodic) step, zero on its own ghost frame, then
its carry map; unmapped state entries pass through.

The state is the union of the stages' input fields (first-seen order)
plus the BC parameter fields (masks, wall velocities, damping profiles),
which are chain-invariant: the kernel does not write them and the chain
returns them as given.  Periodic domains are 2D only, as in the JAX
package; a 3D periodic chain raises.

Gradients: the chain is the ``psat::stage_chain`` custom op
(``StageEntry``, ``ops/custom_ops.py``).  With
``fused_bwd=True`` its backward is the fused value+gradient kernel
(``ops.stage_adjoint.fused_stage_chain_vjp``); otherwise the k cycles are
recomputed with ``stage_stepper`` (the op's own single-step function) and
the sequential BCs, and autograd pulls back through them.

``LAUNCHES`` counts kernel launches and ``LAUNCH_CALLS`` splits them by
(stage programs, k, periodic, spatial shape, itemsize).
"""

from __future__ import annotations

from collections import Counter
from functools import partial
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..field import Field
from .chain_bc import (POINTWISE_KINDS, ChainBC, apply_bc_sequential,
                       apply_bc_shard, bc_dim_reach, normalize_chain_bcs)
from .common import (StencilProgram, check_ported, field_components,
                     forward_program, storage_shape, storage_spatial)
from . import custom_ops
from .cuda_kernel import _DTYPES, on_card, tile_itemsize
from .launch import empty, real, run
from .time_chain import (ADJ_BLOCK_ROWS, FWD_BLOCK_ROWS, FWD_BLOCKS_PER_SM,
                         _load_library, _zyx, access_reach, pick_tile,
                         plane_args3)
from .torch_ref import make_shard_stencil, make_torch_stencil
from ..utils.config import log_lowering_decision

__all__ = ["fused_stage_chain", "stage_stepper", "plain_stage_chain",
           "make_stage_kernel", "StagePlan", "reset_launch_counts",
           "LAUNCHES", "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def stage_stepper(op, carry_map: Dict[str, str], periodic: bool = False):
    """``step(state) -> state`` for ONE stage of a heterogeneous sequence,
    through the op's own single-step function (``op.torch_function``).

    Unlike ``timeloop.make_time_stepper`` the carry may target any *chain*
    state field, not just this op's inputs (RK intermediates are written by
    one stage and read by the next); unmapped state entries pass through."""
    f = op.torch_function(periodic=periodic)
    in_names = [fl.name for fl in op.forward_input_fields]
    out_names = [fl.name for fl in op.forward_output_fields]
    for dst, src in carry_map.items():
        if src not in out_names and src not in in_names:
            raise ValueError(f"carry source {src!r} is neither output "
                             f"({out_names}) nor input ({in_names})")

    def step(state):
        outs = f(**{n: state[n] for n in in_names})
        if not isinstance(outs, tuple):
            outs = (outs,)
        env = {**state, **dict(zip(out_names, outs))}
        new_state = dict(state)
        for dst, src in carry_map.items():
            new_state[dst] = env[src]
        return new_state

    step.input_names = in_names
    step.output_names = out_names
    return step


def _validate_stages(stages) -> Tuple[List[StencilProgram],
                                      List[Dict[str, str]],
                                      Dict[str, Field], List[str]]:
    """Compile stage programs, check carry maps, resolve the state signature
    (union of all stage inputs, first-seen order)."""
    progs, carries = [], []
    state_fields: Dict[str, Field] = {}
    order: List[str] = []
    for op, carry in stages:
        prog = forward_program(op)
        progs.append(prog)
        carries.append(dict(carry))
        for f in prog.input_fields:
            if f.name not in state_fields:
                state_fields[f.name] = f
                order.append(f.name)
            elif state_fields[f.name].index_shape != f.index_shape:
                raise ValueError(
                    f"field {f.name!r} has inconsistent index_shape across "
                    f"stages: {state_fields[f.name].index_shape} vs "
                    f"{f.index_shape}")
    for prog, carry in zip(progs, carries):
        out_names = set(prog.output_names)
        for dst, src in carry.items():
            if dst not in state_fields:
                raise ValueError(
                    f"stage {prog.name}: carry target {dst!r} is not a state "
                    f"field ({sorted(state_fields)})")
            if src not in out_names and src not in state_fields:
                raise ValueError(
                    f"stage {prog.name}: carry source {src!r} is neither a "
                    f"stage output ({sorted(out_names)}) nor a state field")
            src_f = (next(f for f in prog.output_fields if f.name == src)
                     if src in out_names else state_fields[src])
            if src_f.index_shape != state_fields[dst].index_shape:
                raise ValueError(
                    f"stage {prog.name}: carry {dst!r} <- {src!r} mismatches "
                    f"index_shape")
    return progs, carries, state_fields, order


def _cycle_initial_reads(progs: Sequence[StencilProgram],
                         carries: Sequence[Dict[str, str]]) -> List[str]:
    """State fields some stage reads before any carry writes them in cycle
    order — i.e. the fields whose *initial* content is semantically live.
    Everything else is a pure cycle intermediate (zeros are provably fine)."""
    written = set()
    live: List[str] = []
    for prog, carry in zip(progs, carries):
        for f in prog.input_fields:
            if f.name not in written and f.name not in live:
                live.append(f.name)
        written.update(carry.keys())
    return live


# ---------------------------------------------------------------------------
# The plan: state planes, the event sequence of one cycle, reaches.

@dataclass
class Event:
    """One step of a cycle: a BC event before stage ``stage``, or the stage
    itself.  ``src[n]``: where state plane n comes from after the event,
    ('out', o) or ('in', m); ``reach``: per-dim (lo, hi) read reach."""

    kind: str  # "stage" or "bc"
    stage: int
    bc: Optional[ChainBC]
    nout: int
    src: List[Tuple[str, int]]
    reach: Tuple[List[int], List[int]]
    in_planes: List[int]  # stage: the program's input slots → state planes


class StagePlan:
    """What kernel 12, kernel 13 and their plain versions share: the stage
    programs and carries, the state (stage inputs + BC parameter fields) as
    planes, the BC events and the event sequence of one cycle."""

    def __init__(self, stages, k: int, periodic: bool = False,
                 boundary=None, intermediates: Sequence[str] = (),
                 wrap3d: bool = False, shard=None):
        self.stages = [(op, dict(carry)) for op, carry in stages]
        if not self.stages:
            raise ValueError("no stages")
        if k < 1:
            raise ValueError(f"chain depth k={k} must be at least 1")
        progs, carries, fields, names = _validate_stages(self.stages)
        for p in progs:
            check_ported(p)
        nd = progs[0].ndim
        if any(p.ndim != nd for p in progs):
            raise ValueError("all stages must share the spatial rank")
        # a one-stage cycle without BC events (a chain of one op, as
        # ops.stage_march.chain_march_plans builds it) wraps in 3D too
        if periodic and nd != 2 and shard is None and not (
                wrap3d and len(progs) == 1 and not boundary):
            raise ValueError("periodic fused chains support 2D domains only "
                             "(periodic wrap is 2D-only)")
        for p in progs:
            if p.accum_fields:
                raise NotImplementedError(
                    f"{p.name}: accumulation (+=) outputs in a chained "
                    f"forward program are not supported")
        bcs, extra = normalize_chain_bcs(
            boundary, fields, {n: f.index_shape for n, f in fields.items()},
            nd, len(self.stages), next(iter(fields.values())).dtype)
        if periodic:
            frame = [bc.kind for bl in bcs.values() for bc in bl
                     if bc.kind in ("dirichlet", "neumann")]
            if frame:
                raise ValueError(f"frame BCs {frame} are meaningless on a "
                                 f"periodic domain")
        fields = {**fields, **extra}
        names = list(names) + list(extra)
        for f in fields.values():
            if f.layout != tuple(range(f.spatial_dimensions)):
                raise ValueError(f"fused_stage_chain needs row-major spatial "
                                 f"layouts; {f.name!r} has {f.layout}")
        self.initial_reads = _cycle_initial_reads(progs, carries)
        unknown = [n for n in intermediates if n not in fields]
        if unknown:
            raise ValueError(f"intermediates {unknown} are not state fields "
                             f"({sorted(fields)})")
        misordered = [n for n in intermediates if n in self.initial_reads]
        if misordered:
            raise ValueError(
                f"stage cycle is misordered: intermediate field(s) "
                f"{misordered} are read by a stage before any carry writes "
                f"them — their initial state content would silently enter "
                f"the result. Reorder the stages or fix the carry maps.")
        self.progs, self.carries = progs, carries
        self.boundary, self.intermediates = boundary, tuple(intermediates)
        self.state_fields, self.state_names = fields, names
        self.bcs, self.extra_fields = bcs, extra
        self.k, self.periodic, self.nd = k, periodic, nd
        self.planes = [(fields[n], idx) for n in names
                       for idx in field_components(fields[n])]
        self.plane_keys = [(f.name, idx) for f, idx in self.planes]
        self.name = "+".join(p.name for p in progs)
        written = {bc.field for bl in bcs.values() for bc in bl}
        for p, c in zip(progs, carries):
            written |= set(c)
            written |= {n for n in names if n in p.output_names}
        # never rewritten by a carry or a BC: the kernels read these planes
        # from their first buffer and never store them
        self.invariant = {n for n in names if n not in written}
        self.cycle = self._cycle_events()
        # (state plane, row) probe rows whose per-cycle cotangents the
        # march's two-phase mode injects (chain_march_plans sets them; the
        # plain stage versions take none)
        self.probes: List[Tuple[int, int]] = []
        # one block of a sharded domain (ops.flatten.ShardSpec): the
        # kernels' shard mode
        self.shard = shard
        check_shard(self, shard)

    def planes_of(self, name: str) -> List[int]:
        return [i for i, (n, _) in enumerate(self.plane_keys) if n == name]

    def _cycle_events(self) -> List[Event]:
        keys, nd = self.plane_keys, self.nd
        events = []
        for j, (prog, carry) in enumerate(zip(self.progs, self.carries)):
            for bc in self.bcs.get(j, ()):
                tgt = self.planes_of(bc.field)
                src = [("out", tgt.index(n)) if n in tgt else ("in", n)
                       for n in range(len(keys))]
                lo_hi = bc_dim_reach(bc, prog.ghost, nd)
                events.append(Event("bc", j, bc, len(tgt), src,
                                    ([lo for lo, _ in lo_hi],
                                     [hi for _, hi in lo_hi]), []))
            outs = [(f.name, idx) for f in prog.output_fields
                    for idx in field_components(f)]
            src = []
            for name, idx in keys:
                s = carry.get(name)
                if s is not None and (s, idx) in outs:
                    src.append(("out", outs.index((s, idx))))
                else:
                    src.append(("in", keys.index((s or name, idx))))
            ins = [keys.index((f.name, idx)) for f in prog.input_fields
                   for idx in field_components(f)]
            events.append(Event("stage", j, None, len(outs), src,
                                access_reach(prog.steps, nd), ins))
        return events

    def events(self) -> List[Event]:
        return self.cycle * self.k


def event_schedule(plan: StagePlan, keeps=None):
    """Shared-memory buffer of every state plane before and after every
    event of the k cycles (the pool of ``ops.time_chain.carry_schedule``,
    generalised to events with their own output counts).

    An event writes its outputs into free buffers, and its carry only
    renames buffers; a pointwise BC event (dirichlet, masked_dirichlet,
    sponge) writes in place when its target's buffer holds no other plane
    and is not kept.  ``keeps[e]``: state planes whose buffer before event
    e stays live to the end (the primals the adjoint's reverse sweep
    reads).  Returns ``(sbuf, obuf, npool)``: ``sbuf[e][n]`` for e = 0..E,
    ``obuf[e][o]`` for e < E."""
    events = plan.events()
    ns = len(plan.planes)
    sb = list(range(ns))
    sbuf, obuf, npool, pinned = [sb], [], ns, set()
    for e, ev in enumerate(events):
        pinned |= {sb[n] for n in (keeps[e] if keeps else ())}
        live = set(sb) | pinned
        free = [b for b in range(npool) if b not in live]
        inplace = (ev.kind == "bc" and ev.bc.kind in POINTWISE_KINDS)
        tgt = [n for n, (kind, _) in enumerate(ev.src) if kind == "out"]
        outs = []
        for o in range(ev.nout):
            b = sb[tgt[o]] if inplace else None
            if b is not None and b not in pinned and sb.count(b) == 1:
                outs.append(b)
            elif free:
                outs.append(free.pop(0))
            else:
                outs.append(npool)
                npool += 1
        obuf.append(outs)
        sb = [outs[i] if kind == "out" else sb[i] for kind, i in ev.src]
        sbuf.append(sb)
    return sbuf, obuf, npool


def stage_geometry(plan: StagePlan, spatial, itemsize: int, *,
                   second_reach=None, keeps=None, extra_planes: int = 0,
                   blocks_per_sm: int = 1, block_rows: int = ADJ_BLOCK_ROWS,
                   cols: Sequence[int] = ()):
    """Tile, schedule and the int64 geometry block the stage kernels read
    (layout in csrc/stage_chain.cuh::parse_stage_geo).

    The halo is the sum over the k cycles' events of their forward reach,
    plus ``second_reach`` (per event, the reverse sweep's) for the
    adjoint; ``extra_planes`` (the adjoint's cotangent sets) follow the
    pool in shared memory; ``cols``: more owned widths for ``pick_tile``.  Returns ``(geo, (tile, extended, smem))``."""
    nd = plan.nd
    events = plan.events()
    second = second_reach or [([0] * nd, [0] * nd)] * len(events)
    halo = [(sum(ev.reach[0][d] + b[0][d] for ev, b in zip(events, second)),
             sum(ev.reach[1][d] + b[1][d] for ev, b in zip(events, second)))
            for d in range(nd)]
    sbuf, obuf, npool = event_schedule(plan, keeps)
    n_planes = npool + extra_planes
    tile, ext, smem = pick_tile(halo, n_planes, itemsize, spatial,
                                blocks_per_sm, cols=cols)
    # compute regions, local to the extended tile: forward event e writes
    # the region left after its reach; reverse event e writes what is left
    # of the reverse region after it, shrunk by its reverse reach
    lo, hi = [0] * nd, [0] * nd
    fwd = []
    for ev in events:
        lo = [a + b for a, b in zip(lo, ev.reach[0])]
        hi = [a + b for a, b in zip(hi, ev.reach[1])]
        fwd.append((list(lo), [x - h for x, h in zip(ext, hi)]))
    rev = [None] * len(events)
    for e in range(len(events) - 1, -1, -1):
        lo = [a + b for a, b in zip(lo, second[e][0])]
        hi = [a + b for a, b in zip(hi, second[e][1])]
        rev[e] = (list(lo), [x - h for x, h in zip(ext, hi)])
    ncycle = len(plan.cycle)
    maxout = max(ev.nout for ev in plan.cycle)
    geo = (_zyx(spatial, nd, 1) + _zyx(tile, nd, 1) + _zyx(ext, nd, 1)
           + _zyx([lo_ for lo_, _ in halo], nd, 0)
           + [len(events), npool, n_planes, block_rows])
    for e in range(len(events)):
        geo.append(e % ncycle)
        for region in (fwd[e], rev[e]):
            geo += _zyx(region[0], nd, 0) + _zyx(region[1], nd, 1)
    geo += [b for row in sbuf for b in row]
    geo += [b for row in obuf for b in row + [-1] * (maxout - len(row))]
    return geo, (tile, ext, smem)


def check_stage_state(plan: StagePlan, state):
    """The kernels' input checks: every state field present, on one CUDA
    device, float32/float64/bfloat16, in its storage shape over one
    spatial shape."""
    f0 = plan.state_fields[plan.state_names[0]]
    a0 = state[f0.name]
    if not isinstance(a0, torch.Tensor) or a0.device.type != "cuda":
        raise ValueError(f"{plan.name}: the stage kernels take CUDA tensors; "
                         f"got {getattr(a0, 'device', type(a0))}")
    if a0.dtype not in _DTYPES:
        raise NotImplementedError(
            f"{plan.name}: the stage kernels take float32, float64 or "
            f"bfloat16 tensors, got {a0.dtype}")
    spatial = storage_spatial(f0, a0)
    for n in plan.state_names:
        if n not in state:
            raise KeyError(f"{plan.name}: missing state field {n!r}")
        t = state[n]
        if t.device != a0.device or t.dtype != a0.dtype:
            raise ValueError(f"{plan.name}: state {n!r} is {t.dtype} on "
                             f"{t.device}; expected {a0.dtype} on "
                             f"{a0.device}")
        want = storage_shape(plan.state_fields[n], spatial)
        if tuple(t.shape) != want:
            raise ValueError(f"{plan.name}: state {n!r} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    return a0, tuple(spatial)


def check_shard(plan: StagePlan, shard) -> None:
    """A shard mode's build-time checks, as the JAX package's sharded stage
    kernels make them: a ``ShardSpec`` of the plan's rank whose sharded
    dims are leading dims, no probe rows, and on a periodic domain every
    leading dim a stage or BC reaches into sharded (its wrap arrives by the
    exchange; the shard mode reads a sharded dim bounded-style)."""
    if shard is None:
        return
    nd = plan.nd
    if len(shard.global_spatial) != nd:
        raise ValueError(f"{plan.name}: ShardSpec.global_spatial "
                         f"{shard.global_spatial} is not {nd}-D")
    if any(not 0 <= d < nd - 1 for d in shard.sharded_dims):
        raise ValueError(f"{plan.name}: sharded dims {shard.sharded_dims} "
                         f"must be leading dims; the last spatial dim stays "
                         f"whole")
    if plan.probes:
        raise NotImplementedError(f"{plan.name}: sharded chains take no "
                                  f"probe rows (the JAX package's "
                                  f"ShardedChain takes none)")
    if plan.periodic:
        reached = {d for ev in plan.cycle for d in range(nd - 1)
                   if ev.reach[0][d] or ev.reach[1][d]}
        missing = sorted(reached - set(shard.sharded_dims))
        if missing:
            raise ValueError(
                f"{plan.name}: leading dims {missing} are reached by the "
                f"stencil but not in shard.sharded_dims — their wrap data "
                f"never arrives by the halo exchange (map them to a size-1 "
                f"mesh axis if they should not be decomposed)")


# ---------------------------------------------------------------------------
# Plain version.

def plain_stage_chain(plan: StagePlan, k: Optional[int] = None):
    """``fn(state, bases=None) -> state``: k cycles (default ``plan.k``) of
    the sequential BCs (``chain_bc.apply_bc_sequential``) and the plain
    single steps (``ops.torch_ref``, interior or periodic) with each
    stage's carry map — the plain version of kernel 12.  A sharded plan
    (``plan.shard``, an ``ops.flatten.ShardSpec``): the state is one
    halo-extended block of a sharded domain and ``bases`` its base
    offsets; each step and BC then tests global coordinates
    (``torch_ref.make_shard_stencil``, ``chain_bc.apply_bc_shard``) — the
    plain version of kernel 12's shard mode."""
    k = plan.k if k is None else k
    shard = plan.shard
    if shard is None:
        steps = [make_torch_stencil(p, periodic=plan.periodic)
                 for p in plan.progs]
    else:
        steps = [make_shard_stencil(p, plan.periodic, shard)
                 for p in plan.progs]

    def fn(state: Dict[str, torch.Tensor], bases=None):
        st = {n: state[n] for n in plan.state_names}
        extra = () if shard is None else (bases,)
        for _ in range(k):
            for j, (prog, carry) in enumerate(zip(plan.progs, plan.carries)):
                for bc in plan.bcs.get(j, ()):
                    st = apply_bc_shard(st, bc, prog.ghost, plan.periodic,
                                        plan.state_fields, shard, bases)
                outs = steps[j]({n: st[n] for n in prog.input_names}, *extra)
                env = {**st, **outs}
                st = {**st, **{dst: env[src] for dst, src in carry.items()}}
        return {n: st[n] for n in plan.state_names}

    return fn


def sequential_stage_chain(plan: StagePlan):
    """``fn(state) -> state``: k cycles through ``stage_stepper`` (the ops'
    own single-step functions) and the sequential BCs — the recompute of
    the ``fused_bwd=False`` backward."""
    steps = [stage_stepper(op, carry, periodic=plan.periodic)
             for op, carry in plan.stages]

    def fn(state):
        st = {n: state[n] for n in plan.state_names}
        for _ in range(plan.k):
            for j, step in enumerate(steps):
                for bc in plan.bcs.get(j, ()):
                    st = apply_bc_sequential(st, bc, plan.progs[j].ghost,
                                             plan.periodic,
                                             fields=plan.state_fields)
                st = step(st)
        return {n: st[n] for n in plan.state_names}

    return fn


# ---------------------------------------------------------------------------
# The CUDA kernel.

def make_stage_kernel(plan: StagePlan, design: str = "march"):
    """``fn(state) -> state`` through kernel 12; same semantics as
    ``plain_stage_chain``.  Chain-invariant state fields (BC parameters,
    coefficients) come back as the tensors given.  ``design``: "march"
    (the dim-0 march, ``ops.stage_march``; ``ValueError`` at a shape no
    march fits) or "box" (the box tile of PR 4, ``make_box_stage_kernel``,
    kept for the in-turns comparison of the two designs)."""
    from .stage_march import make_march_kernel

    if design == "march":
        return make_march_kernel(plan)
    if design == "box":
        return make_box_stage_kernel(plan)
    raise ValueError(f"unknown design {design!r}; 'march' or 'box'")


def make_box_stage_kernel(plan: StagePlan):
    """``fn(state) -> state`` through kernel 12 in the box-tile design of
    PR 4 (``csrc/stage_chain.cuh``)."""
    from ..codegen.cuda_printer import generate_stage_source

    lib_state: dict = {}
    name = f"{plan.name}_stage_chain_k{plan.k}"
    nd = plan.nd
    planes = plan.planes

    def fn(st: Dict[str, torch.Tensor]):
        global LAUNCHES
        a0, spatial = check_stage_state(plan, st)
        outputs = {n: (st[n] if n in plan.invariant else
                       empty(storage_shape(plan.state_fields[n], spatial),
                             a0.dtype, a0.device))
                   for n in plan.state_names}
        if any(n == 0 for n in spatial):
            return real(outputs)
        geo, _ = stage_geometry(plan, spatial, tile_itemsize(a0),
                                blocks_per_sm=FWD_BLOCKS_PER_SM[nd],
                                block_rows=FWD_BLOCK_ROWS[nd])
        lib = _load_library(lib_state, partial(generate_stage_source, plan),
                            name, a0.dtype)
        stored = {n: t for n, t in outputs.items() if n not in plan.invariant}
        in_ptrs, in_st = plane_args3(planes, st, nd)
        out_ptrs, out_st = plane_args3(planes, stored, nd)
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)],
               [in_ptrs, in_st, out_ptrs, out_st, geo], a0,
               f"{name}: stage chain launch"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.name, plan.k, plan.periodic, spatial,
                          a0.element_size())] += 1
        return real(outputs)

    fn.plan = plan
    return fn


def stage_plan_at_depth(plan: StagePlan, depth: int) -> StagePlan:
    """``plan``'s chain, ``depth`` cycles deep."""
    if depth == plan.k:
        return plan
    return StagePlan(plan.stages, depth, plan.periodic, plan.boundary,
                     plan.intermediates, shard=plan.shard)


def stage_route(plan: StagePlan, spatial, itemsize: int):
    """The rung of the depth ladder kernel 12 runs at a shape: the deepest
    divisor kk of k at which a march of the kk-deep chain fits
    (``stage_march.march_fits``: ``stage_march_geometry`` stays the
    reckoning) — k/kk launches —, or None where none fits even at depth 1:
    then the chain runs k cycles of single steps
    (``sequential_stage_chain``).  The JAX package's TPU dispatch runs the
    same ladder (``ops/stage_chain.py:658–667``), found there by
    compiling; here it is decided before any launch.  The march is 2D and
    3D: a 1D or a >3D chain runs its single steps (the window kernel takes
    every rank)."""
    from .stage_march import march_fits

    if plan.nd not in (2, 3):
        return None
    for kk in [d for d in range(plan.k, 0, -1) if plan.k % d == 0]:
        if march_fits(stage_plan_at_depth(plan, kk), spatial, itemsize):
            return kk
    return None


def stage_runner(plan: StagePlan):
    """The chain on its inputs' device: for CUDA tensors the rung of
    ``stage_route`` (k/kk launches of kernel 12, or k cycles of single
    steps; ``fn.depth`` is kk, None for single steps), for CPU tensors the
    plain version.  A sharded plan runs ``fn(state, bases)``: kernel 12's
    shard mode at depth k, or its plain version."""
    kernels = {}
    plain = plain_stage_chain(plan)
    first = plan.state_names[0]
    routes: dict = {}

    def kernel(kk):
        if kk not in kernels:
            kernels[kk] = (sequential_stage_chain(plan) if kk is None else
                           make_stage_kernel(stage_plan_at_depth(plan, kk)))
        return kernels[kk]

    def card(state, bases=None):
        if plan.shard is not None:
            # a shard's k-deep kernel, as the JAX package's ShardedChain
            # builds it: no shallower rung (the single steps have no
            # global masks); a march that does not fit raises
            return kernel(plan.k)(state, bases=bases)
        a0, spatial = check_stage_state(plan, state)
        key = (spatial, tile_itemsize(a0))
        if key not in routes:
            routes[key] = stage_route(plan, *key)
            log_lowering_decision(plan.name, route="stage_route", k=plan.k,
                                  spatial=spatial, itemsize=key[1],
                                  depth=routes[key])
        kk = fn.depth = routes[key]
        run = kernel(kk)
        if kk is None or kk == plan.k:
            return run(state)
        st = state
        for _ in range(plan.k // kk):
            st = {**st, **run(st)}
        return {n: st[n] for n in plan.state_names}

    def fn(state, bases=None):
        if not on_card(state[first]):
            return plain(state, bases)
        return card(state, bases)

    fn.card = card  # the kernels' path alone (CUDA tensors)
    fn.plan = plan
    fn.kernel = kernel
    fn.depth = plan.k
    return fn


# ---------------------------------------------------------------------------
# The user-facing chain.

class StageEntry:
    """The stage chain as a registry entry (``ops/custom_ops.py``,
    ``psat::stage_chain`` / ``psat::stage_chain_bwd``): the plan (its ops'
    derived backwards included), ``fused_bwd`` and kernel 13's ``form``.
    The forward op returns the state fields the kernel writes; the
    chain-invariant fields (BC parameters, coefficients) are no outputs —
    the wrapper passes the tensors given through, so an invariant that
    needs no gradient stays so across chained calls, and its cotangent
    reaches it directly (the backward sees zeros in its place).  The CUDA
    kernel is ``stage_runner``'s kernel path (kernel 12, or single-step
    cycles on the ladder's last rung); the CPU kernel the runner (the plain
    version on CPU tensors).  The backward op is kernel 13
    (``fused_stage_chain_vjp``, one per set of wanted invariant
    gradients); the sequential-recompute backward (``fused_bwd=False``, and
    the ladder's last rung where no march fits) differentiates the ops'
    own single steps with autograd, outside any op."""

    kind = "stage_chain"

    def __init__(self, plan: StagePlan, fused_bwd: bool, form=None):
        self.name = plan.name
        self.recipe = dict(plan=plan, fused_bwd=fused_bwd, form=form)
        self._init()

    def _init(self):
        plan = self.recipe["plan"]
        self.names = plan.state_names
        self.stored = [n for n in self.names if n not in plan.invariant]
        self.runner = stage_runner(plan)
        self.vjps: dict = {}
        self.seq = None
        if self.recipe["fused_bwd"]:
            from .stage_adjoint import validate_bc_invariance

            validate_bc_invariance(plan.bcs, plan.carries)

    def vjp(self, wanted):
        """Kernel 13's ``g`` for the wanted invariant gradients."""
        key = frozenset(wanted)
        if key not in self.vjps:
            from .stage_adjoint import fused_stage_chain_vjp

            plan = self.recipe["plan"]
            self.vjps[key] = fused_stage_chain_vjp(
                plan.stages, plan.k, periodic=plan.periodic,
                boundary=plan.boundary, wanted=key, shard=plan.shard,
                form=self.recipe["form"])
        return self.vjps[key]

    def cot_names(self, wanted):
        inv = self.recipe["plan"].invariant
        return [n for n in self.names if n not in inv or n in wanted]

    def forward(self, card, bases, tensors):
        run = self.runner.card if card else self.runner
        new = run(dict(zip(self.names, tensors)), bases)
        return custom_ops.fresh([new[n] for n in self.stored], tensors)

    def fake_forward(self, bases, tensors):
        st = dict(zip(self.names, tensors))
        return [torch.empty_like(st[n]) for n in self.stored]

    def to_save(self, tensors):
        return list(tensors)

    def backward(self, card, extra, state, cotangents):
        bases, mask = extra
        wanted = {n for n, w in zip(self.names, mask) if w}
        st = dict(zip(self.names, state))
        cots = dict(zip(self.cot_names(wanted), cotangents))
        g = self.vjp(wanted)
        # the plain version is autograd through the plain forward
        cot0 = (g(st, cots, bases) if card else
                custom_ops.with_autograd(g, st, cots, bases))[1]
        return custom_ops.fresh([cot0[n] for n in self.cot_names(wanted)],
                                state + cotangents)

    def fake_backward(self, extra, state, cotangents):
        return [torch.empty_like(c) for c in cotangents]

    def sequential(self, saved, cots):
        """The k cycles recomputed through ``stage_stepper`` (the ops' own
        single steps) and the sequential BCs, pulled back by autograd."""
        # a mask (bool, int) is no cotangent field: it stays as given
        names = [n for n in self.names if saved[n].is_floating_point()]
        if self.seq is None:  # built once: each build registers its ops
            self.seq = sequential_stage_chain(self.recipe["plan"])
        with torch.enable_grad():
            ins = {n: saved[n].detach().requires_grad_() for n in names}
            out = self.seq({**saved, **ins})
            grads = torch.autograd.grad([out[n] for n in names],
                                        [ins[n] for n in names],
                                        [cots[n] for n in names],
                                        allow_unused=True)
        return {n: (g if g is not None else torch.zeros_like(saved[n]))
                for n, g in zip(names, grads)}

    def grads(self, saved, cotangents, needs, bases):
        if not any(needs):
            return [None] * len(needs)
        plan = self.recipe["plan"]
        st = dict(zip(self.names, saved))

        def cot(n):  # an invariant's cotangent reaches it directly
            return (cotangents[self.stored.index(n)] if n in self.stored
                    else torch.zeros_like(st[n]))

        wanted = {n for n, need in zip(self.names, needs)
                  if need and n in plan.invariant}
        # kernel 13 is 2D and 3D: other ranks recompute through single steps
        if self.recipe["fused_bwd"] and plan.nd in (2, 3) \
                and not self.vjp(wanted).sequential(st):
            names = self.cot_names(wanted)
            cot0 = dict(zip(names, custom_ops.through(
                custom_ops.stage_chain_bwd, self, bases,
                [n in wanted for n in self.names], saved,
                [cot(n) for n in names])))
        else:
            cot0 = self.sequential(st, {n: cot(n) for n in self.names
                                        if st[n].is_floating_point()})
        return [cot0.get(n) if need else None
                for n, need in zip(self.names, needs)]


def fused_stage_chain(stages: Sequence[Tuple[object, Dict[str, str]]],
                      k: int = 1, periodic: bool = False,
                      intermediates: Sequence[str] = (),
                      fused_bwd: bool = False, boundary=None, shard=None,
                      dtype=None, form=None):
    """``chain(state: dict) -> state`` advancing ``k`` full cycles of the
    stage sequence in ONE kernel (see the module doc), over the
    ``psat::stage_chain`` custom op (``StageEntry``).  ``dtype`` (a
    ``torch.dtype``; the JAX package's ``dtype=``) casts the state to it
    before the chain, so forward and backward run in it and the state
    comes back in it — ``torch.bfloat16`` stores bf16 and computes in
    float on the card.

    ``stages``: sequence of ``(op, carry_map)``; each carry map sends
    state-field names to that stage's output (or another state field).
    Fields a later stage introduces (e.g. RK intermediates) must be in the
    initial state (zeros are fine).

    ``intermediates``: state fields the caller asserts are pure cycle
    intermediates; if a stage reads one before a carry writes it, the
    cycle is misordered and a ``ValueError`` is raised at build time.  The
    fields whose initial value is live are ``chain.initial_read_fields``.

    ``boundary``: ``{stage_idx: {field: spec}}`` or ``{field: spec}`` (stage
    0), specs as ``boundary.BoundaryHandling`` takes them with array-valued
    parameters given as state-field NAMES (``ops/chain_bc.py``).

    ``fused_bwd=True``: the backward is kernel 13, one fused value+gradient
    kernel per call (or per segment, ``ops.stage_adjoint``); every BC kind
    has its transpose in that kernel.  ``form`` (with ``fused_bwd``) forces
    kernel 13's reverse form, as ``fused_stage_chain_vjp`` takes it; None
    lets it take a measured-best form (``utils.autotune``) or its
    reckoning's.

    ``shard`` (an ``ops.flatten.ShardSpec``, as ``parallel.ShardedChain``
    uses it): the state is one halo-extended block of a sharded domain and
    the chain is called as ``chain(state, bases)``, ``bases`` the block's
    base offsets per spatial dim; kernels 12 and 13 run their shard mode
    at depth k (one library serves every shard: bases and global extents
    are arguments of the launch).  The sequential-recompute backward has
    no global masks, so a sharded chain takes ``fused_bwd=True``."""
    plan = StagePlan(stages, k, periodic, boundary, intermediates,
                     shard=shard)
    if shard is not None and not fused_bwd:
        raise ValueError("a sharded fused_stage_chain differentiates through "
                         "kernel 13's shard mode: pass fused_bwd=True "
                         "(parallel.ShardedChain recomputes through "
                         "ShardedStencil sweeps instead)")
    if form is not None and not fused_bwd:
        raise ValueError("form= picks kernel 13's reverse form: pass "
                         "fused_bwd=True")
    ent = StageEntry(plan, fused_bwd, form)
    custom_ops.register(ent)
    names, stored = plan.state_names, ent.stored

    def chain(state: Dict[str, torch.Tensor], bases=None):
        tensors = [state[n] if dtype is None else state[n].to(dtype)
                   for n in names]
        res = custom_ops.apply(
            ent, None if bases is None else [int(b) for b in bases],
            *tensors)
        # chain-invariant fields come back as the tensors given
        out = dict(zip(names, tensors))
        out.update(zip(stored, res))
        return out

    chain.input_names = list(names)
    chain.initial_read_fields = plan.initial_reads
    chain.k = k
    chain.n_stages = len(plan.stages)
    chain.plan = plan
    chain.entry = ent
    return chain
