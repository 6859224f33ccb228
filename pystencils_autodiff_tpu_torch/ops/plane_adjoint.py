"""The z-streaming chain kernel: 3D chains whose state a box tile cannot
hold, forward and fused value+gradient — the port of
``pystencils_autodiff_tpu/ops/plane_adjoint.py::make_plane_chain_vjp_fn``.

The TPU kernel tiles dim 0 and keeps whole (n1, n2) planes of every stage
in VMEM.  On the H100 a block has 227 KB of shared memory, and a box tile
(``csrc/time_chain.cuh``) wraps its halo around six faces: for the D3Q19
BGK step (19 planes, forward reach 1, backward reach 2) no box owns
anything at k = 2.  So here a block owns a (y, x) column tile and marches
through dim 0 (``csrc/plane_adjoint.cuh``); the inputs are read from device
memory as the march reaches them, and only the intermediate states and
cotangents live in shared memory, as rings of planes.  Two modes:

* ``"two_phase"`` (``make_plane_adjoint_kernel``): ``fn(state, cots) ->
  (state_k, cot_0)`` of k steps, the semantics of
  ``ops.adjoint_chain.plain_chain_vjp`` (its plain version), bounded or
  periodic in all three dims.  ``fused_chain_vjp`` takes it (route
  ``"plane_two_phase"``, the JAX package's name) for every 3D op the twin
  decompositions reject: the nonlinear ones.  It runs in one of two forms
  (``FORMS``): "gather", the backward program at every cell of each
  reverse stage, or "local", each reverse stage as the local VJP at every
  forward write cell and the gather of its w planes (``ops.local_vjp``).
* ``"forward"`` (``make_plane_chain_kernel``): ``fn(state) -> (state_k,
  probe_list)`` of k steps, the semantics of
  ``ops.time_chain.plain_time_chain``; ``fused_time_chain`` takes it for a
  3D chain where no box tile owns ``MIN_OWNED_SHARE`` of its extended
  tile.

Probes (bounded mode): the forward mode records each probe line (the line
``divmod(row, n1)`` along the last dim) after every stage into a ``(k,
n2)`` record, from the block that owns it; the two-phase mode adds the
probe cotangents into that field's cotangent on that line.  Every mode
takes float32, float64 or bf16 storage (computed in float).

``stream_geometry`` reckons the stages' lags and extents, the rings'
depths, the form, the lateral tile and the dim-0 segments from the
reaches, as ``time_chain.pick_tile`` does for boxes; the choice of kernel
and form comes from that reckoning before any launch (``form=`` forces a
form).  ``LAUNCHES`` counts launches of both modes; ``LAUNCH_CALLS``
splits them by (op name, k, periodic, shape, itemsize, mode, form — None
in forward mode; the mode ends in "_shard" in shard mode).
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..adjoint_field import AdjointField
from ..field import Field
from ..utils.config import log_lowering_decision
from .common import storage_shape
from .cuda_kernel import _DTYPES, _check_inputs, tile_itemsize
from .launch import Ptrs, empty, real, run
from .time_chain import (MIN_OWNED_SHARE, SMEM_BUDGET, ChainPlan,
                         _load_library, check_state, plane_args3,
                         probe_index)

__all__ = ["stream_geometry", "StreamGeometry", "make_plane_adjoint_kernel",
           "make_plane_chain_kernel", "reset_launch_counts", "LAUNCHES",
           "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()

MAX_K = 8  # kMaxK in csrc/plane_adjoint.cuh
THREADS = 256  # kThreads: the cells of a stage's region are dealt out
NUM_SMS = 132  # H100 SXM
# the two-phase forms (csrc/plane_adjoint.cuh): the backward program at
# every cell ("gather"), or the local VJP at every forward write cell and
# the gather of its w planes ("local", ops/local_vjp.py)
FORMS = ("gather", "local")
# stage kinds of the march (csrc/plane_adjoint.cuh::StageKind); LG is an
# L stage that gathers its cotangent input in place (G fused into it)
F, R, L, G, LG = 0, 1, 2, 3, 4
# lateral tile candidates (y, x) and a forced dim-0 segment count (None:
# from the reckoning); tests patch them to get ragged multi-tile grids
TILE_Y = tuple(range(1, 33))
TILE_X = tuple(range(1, 65))
STREAM_SEGMENTS: Optional[int] = None


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES`` and clear ``LAUNCH_CALLS``, this module's launch
    counters."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


@dataclass
class StreamGeometry:
    """The march: its stages (kind, s, lag and per-dim (lo, hi) extents
    around the owned tile); the rings' depths and offsets; the form, the
    lateral tile, the dim-0 segments and the int64 block the launcher
    reads (``geo``, layout in csrc/plane_adjoint.cuh::parse_geo)."""

    form: Optional[str]  # None in forward mode
    tile: Tuple[int, int]
    nseg: int
    zlen: int
    smem: int  # bytes
    owned_share: float  # owned tile / the widest stage region
    work: float  # weighted steps per owned cell (the picker's measure)
    stages: List[Tuple[int, int]]  # (kind, s)
    lags: List[int]
    extents: List[Tuple[List[int], List[int]]]
    state_depth: List[int]  # ring of state s (index s; 0 unused)
    cot_depth: List[int]
    w_depth: List[int]
    geo: List[int]


@dataclass
class _March:
    """The tile-independent part of the reckoning of one form."""

    stages: List[Tuple[int, int]]
    lags: List[int]
    extents: List[Tuple[List[int], List[int]]]
    weights: List[int]  # steps of each stage's program
    state_depth: List[int]
    cot_depth: List[int]
    w_depth: List[int]
    # per s: the stage whose region ring state s, cot_s and w_s cover
    ring_stage: List[Tuple[int, int, int]]
    planes: Tuple[int, int, int]  # planes of a state, cot and w ring slot


def _widen(ext, lo, hi):
    return ([e + r for e, r in zip(ext[0], lo)],
            [e + r for e, r in zip(ext[1], hi)])


def _cover(*exts):
    return ([max(e[0][d] for e in exts) for d in range(3)],
            [max(e[1][d] for e in exts) for d in range(3)])


def _march(plan: ChainPlan, ap=None, form: Optional[str] = None) -> _March:
    """Stages, lags, extents, ring depths and weights of one form
    (independent of the tile).  Stage X works on plane t − lag[X] at march
    step t, over the owned tile widened by extents[X]; each stage lags its
    writers by their reach above it, so every plane it reads is computed
    earlier in the march (or earlier in the same step: stages run in list
    order); a ring is as deep as its readers' reach below plus their lag
    behind its writer, and covers its writer's region.

    Forward F_1..F_k: F_k covers the owned tile, F_s what F_{s+1} reads
    (its region plus the forward reach) and what the reverse stage s reads
    of state s.  Gather form, R_{k-1}..R_0: R_s covers the owned tile plus
    s backward reaches (what R_0 reads through R_{s-1}); F_s, where the
    backward program reads saved primals, R_s's region plus the backward
    reach.  Local form, L_{k-1}, G_{k-1}, ..., L_0, G_0: G_0 covers the
    owned tile, L_s what G_s gathers (its region plus the forward reach,
    mirrored), G_s (s > 0) what L_{s-1} reads (and G_{s-1}, where a
    cotangent passes through unchanged); F_s L_s's region plus the forward
    reach.  Where no cotangent passes through unchanged, G_s (s > 0) is
    fused into L_{s-1}, which then gathers its cotangent input from w_s at
    the cell (stage LG_{s-1}): the march is L_{k-1}, LG_{k-2}, ..., LG_0,
    G_0 and cot_1..cot_{k-1} need no ring."""
    k = plan.k
    lf, hf = plan.reach
    zero = ([0] * 3, [0] * 3)
    nf = len(plan.cycle_steps) + len(plan.hoist_steps)
    ns = len(plan.planes)
    n_dyn = sum(f.name not in plan.invariant for f, _ in plan.planes)
    rev: Dict[Tuple[int, int], Tuple[list, list]] = {}
    rev_w: Dict[Tuple[int, int], int] = {}
    # reverse stage s reads state s: (its region, the stage, reach below)
    reads_state = {}
    order = []
    if form == "gather":
        lb, hb = ap.reach
        for s in range(k):
            rev[(R, s)] = ([s * lb[d] for d in range(3)],
                           [s * hb[d] for d in range(3)])
            rev_w[(R, s)] = len(ap.bwd.steps)
            if ap.saved_planes:
                reads_state[s] = (_widen(rev[(R, s)], lb, hb), (R, s), lb[0])
        order = [(R, s) for s in range(k - 1, -1, -1)]
    elif form == "local":
        from .local_vjp import local_vjp

        lv = local_vjp(ap)
        n_w = len(lv.slots)
        passes = any(ap.pass_to)
        dyn_reads = any(isinstance(at, Field.Access)
                        and at.field.name not in plan.invariant
                        and not isinstance(at.field, AdjointField)
                        for st in lv.program.steps for at in st.atoms)
        # where no cotangent passes through unchanged, cot_s (s > 0) is read
        # by L_{s-1} alone, at the cell: G_s is fused into it (LG_{s-1})
        # and cot_s needs no ring
        fuse = not passes
        lk = {s: (LG if fuse and s < k - 1 else L) for s in range(k)}
        gather = {0: zero}
        for s in range(k):
            if s >= 1:
                gather[s] = _cover(rev[(lk[s - 1], s - 1)], *(
                    [gather[s - 1]] if passes else []))
            rev[(lk[s], s)] = _widen(gather[s], hf, lf)
            rev_w[(lk[s], s)] = len(lv.program.steps) + (
                n_w if lk[s] == LG else 0)
            if not fuse or s == 0:
                rev[(G, s)] = gather[s]
                rev_w[(G, s)] = n_w
            if dyn_reads:
                reads_state[s] = (_widen(rev[(lk[s], s)], lf, hf),
                                  (lk[s], s), lf[0])
        order = [x for s in range(k - 1, -1, -1)
                 for x in ((lk[s], s), (G, s)) if x in rev]
    ef = {k: zero}
    for s in range(k - 1, 0, -1):
        covers = [_widen(ef[s + 1], lf, hf)]
        if s in reads_state:
            covers.append(reads_state[s][0])
        ef[s] = _cover(*covers)
    stages = [(F, s) for s in range(1, k + 1)] + order
    lag = {(F, 1): 0}
    for s in range(2, k + 1):
        lag[(F, s)] = lag[(F, s - 1)] + hf[0]
    extents = {(F, s): ef[s] for s in range(1, k + 1)}
    extents.update(rev)
    hb0 = ap.reach[1][0] if form == "gather" else 0
    for kind, s in order:
        if kind == R:
            lg = lag[(R, s + 1)] + hb0 if s + 1 < k else 0
            if s in reads_state and s >= 1:
                lg = max(lg, lag[(F, s)] + hb0)
        elif kind in (L, LG):
            # L_s reads cot_{s+1} at the cell; LG_s gathers it from w_{s+1}
            # up to lf below the cell, so it lags L_{s+1} by lf
            lg = (0 if s + 1 == k else lag[(G, s + 1)] if kind == L
                  else lag[(lk[s + 1], s + 1)] + lf[0])
            if s in reads_state and s >= 1:
                lg = max(lg, lag[(F, s)] + hf[0])
        else:  # G_s gathers w_s up to lf below the cell: L_s lags by it
            lg = lag[(lk[s], s)] + lf[0]
        lag[(kind, s)] = lg
    state_depth, cot_depth, w_depth = [0] * k, [0] * k, [0] * k
    for s in range(1, k):
        readers = [((F, s + 1), lf[0])]
        if s in reads_state:
            readers.append(reads_state[s][1:])
        state_depth[s] = max(lag[x] + low for x, low in readers) \
            - lag[(F, s)] + 1
    if form == "gather":
        lb = ap.reach[0]
        for s in range(1, k):
            cot_depth[s] = lag[(R, s - 1)] - lag[(R, s)] + lb[0] + 1
        writer = {s: (R, s) for s in range(k)}
    elif form == "local":
        for s in range(k):
            reader = (G, s) if (G, s) in rev else (lk[s - 1], s - 1)
            w_depth[s] = lag[reader] - lag[(lk[s], s)] + hf[0] + 1
        for s in range(1, k):
            if fuse:
                continue
            readers = [(L, s - 1)] + ([(G, s - 1)] if passes else [])
            cot_depth[s] = max(lag[x] for x in readers) - lag[(G, s)] + 1
        writer = {s: (G, s) if (G, s) in rev else (lk[s], s)
                  for s in range(k)}
    index = {x: i for i, x in enumerate(stages)}
    ring_stage = [(index[(F, s)] if s >= 1 else 0,
                   index[writer[s]] if form else 0,
                   index[(lk[s], s)] if form == "local" else 0)
                  for s in range(k)]
    weights = [nf if kind == F else rev_w[(kind, s)] for kind, s in stages]
    return _March(stages=stages, lags=[lag[x] for x in stages],
                  extents=[extents[x] for x in stages], weights=weights,
                  state_depth=state_depth, cot_depth=cot_depth,
                  w_depth=w_depth, ring_stage=ring_stage,
                  planes=(n_dyn, ns, n_w if form == "local" else 0))


def _region(tile, ext) -> int:
    lo, hi = ext
    return (tile[0] + lo[1] + hi[1]) * (tile[1] + lo[2] + hi[2])


def _ring_elems(mr: _March, tile) -> List[Tuple[int, int, int]]:
    """Elements of ring state s, cot_s and w_s, per s."""
    out = []
    for s, (sx, cx, wx) in enumerate(mr.ring_stage):
        n_dyn, ns, n_w = mr.planes
        out.append((mr.state_depth[s] * n_dyn * _region(tile, mr.extents[sx])
                    if s >= 1 else 0,
                    mr.cot_depth[s] * ns * _region(tile, mr.extents[cx])
                    if s >= 1 else 0,
                    mr.w_depth[s] * n_w * _region(tile, mr.extents[wx])))
    return out


def stream_geometry(plan: ChainPlan, spatial: Sequence[int], itemsize: int,
                    ap=None, form: Optional[str] = None
                    ) -> Optional[StreamGeometry]:
    """The streaming kernel's geometry for ``plan`` (two-phase with the
    ``AdjointPlan`` ``ap``, forward without), or None where no lateral
    tile's rings fit the shared memory a block may use while owning
    ``MIN_OWNED_SHARE`` of its widest stage region.

    Two-phase, the form is ``form`` or, where None, the one the picker
    takes: form and tile minimise the work per owned cell — every stage's
    region, rounded up to whole passes of the block's threads, weighted by
    its program's steps (D3Q19: forward 23, gather-form backward 1,687,
    local VJP 123, gather 19 terms); ties go to less shared memory, then
    to wider rows.  Where the lateral tiles alone give fewer than two
    blocks per SM, dim 0 is cut into segments no shorter than the march's
    own dim-0 halo.

    Reckoning, D3Q19 BGK k=2 float32, forward reach 1 and backward 2 in
    every dim.  Gather form: F_1 covers the tile + 4 a side (what R_1
    reads), R_1 the tile + 2; the state_1 ring is 5 planes × 19 components
    over F_1's region and the cot_1 ring 5 × 19 over R_1's; a 9×14 tile
    (231 KB, 0.34 owned).  Local form: L_1 covers the tile + 2, G_1 and
    L_0 + 1, F_1 + 3; rings state_1 and w_1, w_0 of 3 × 19 planes, cot_1 of
    1 × 19; the picker takes it, at 12×12 (188 KB, 0.44 owned).  The
    forward mode holds 3 planes of 19 over the tile + 2 a side: 27×33
    (0.88 owned) in float32."""
    if plan.program.ndim != 3:
        raise ValueError("the streaming chain kernel takes 3D domains")
    if form is not None and form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    if not 1 <= plan.k <= MAX_K:
        return None
    forms = [None] if ap is None else ([form] if form else list(FORMS))
    n0, n1, n2 = (int(n) for n in spatial)
    best = None
    for fm in forms:
        mr = _march(plan, ap, fm)
        for ty in TILE_Y:
            if ty > max(1, n1) and ty != TILE_Y[0]:
                continue
            for tx in TILE_X:
                if tx > max(1, n2) and tx != TILE_X[0]:
                    continue
                tile = (ty, tx)
                regions = [_region(tile, e) for e in mr.extents]
                smem = sum(map(sum, _ring_elems(mr, tile))) * itemsize
                share = ty * tx / max(regions)
                if smem > SMEM_BUDGET or share < MIN_OWNED_SHARE:
                    continue
                work = sum(math.ceil(r / THREADS) * THREADS * w
                           for r, w in zip(regions, mr.weights)) / (ty * tx)
                key = (work, smem, -tx)
                if best is None or key < best[0]:
                    best = (key, fm, mr, tile, smem, share)
    if best is None:
        return None
    (work, _, _), fm, mr, tile, smem, share = best
    k = plan.k
    nt = (math.ceil(n1 / tile[0]), math.ceil(n2 / tile[1]))
    tlo = min(lag - e[0][0] for lag, e in zip(mr.lags, mr.extents))
    thi = max(lag + e[1][0] for lag, e in zip(mr.lags, mr.extents))
    if STREAM_SEGMENTS is not None:
        nseg = STREAM_SEGMENTS
    else:
        want = math.ceil(2 * NUM_SMS / (nt[0] * nt[1]))
        nseg = max(1, min(want, n0 // max(1, thi - tlo)))
    nseg = max(1, min(nseg, n0))
    zlen = math.ceil(n0 / nseg)
    nseg = math.ceil(n0 / zlen)
    ghost = plan.program.ghost
    lb, hb = ap.reach if fm == "gather" else ([0] * 3, [0] * 3)
    geo = ([n0, n1, n2, k, len(mr.stages), tile[0], tile[1], nt[0], nt[1],
            nseg, zlen] + [lo for lo, _ in ghost]
           + [n - hi for n, (_, hi) in zip(spatial, ghost)]
           + list(lb) + list(hb) + [tlo, thi, smem // itemsize])
    for (kind, s), lag, (lo, hi) in zip(mr.stages, mr.lags, mr.extents):
        geo += [kind, s, lag] + list(lo) + list(hi)
    off = 0
    for s, (elems, (sx, cx, wx)) in enumerate(zip(_ring_elems(mr, tile),
                                                  mr.ring_stage)):
        offs = []
        for e in elems:
            offs.append(off)
            off += e
        geo += [offs[0], mr.state_depth[s], sx, offs[1], mr.cot_depth[s], cx,
                offs[2], mr.w_depth[s], wx]
    probes = []
    for pname, prow in plan.probes:
        probes += [plan.plane_keys.index((pname, ()))] + list(
            probe_index(prow, spatial))
    geo += [len(plan.probes)] + probes
    return StreamGeometry(form=fm, tile=tile, nseg=nseg, zlen=zlen,
                          smem=smem, owned_share=share, work=work,
                          stages=mr.stages, lags=mr.lags,
                          extents=mr.extents, state_depth=mr.state_depth,
                          cot_depth=mr.cot_depth, w_depth=mr.w_depth,
                          geo=geo)


def _launcher(plan: ChainPlan, ap, mode: str, form: Optional[str] = None):
    """``launch(a0, spatial, ptr_sets) -> None`` for one mode (two-phase:
    in ``form``, or where None the picker's form for each shape): the
    geometry reckoned once per (shape, itemsize), before the launch; the
    library of each (form, float type) built at its first use."""
    from ..codegen.cuda_printer import generate_plane_source

    libs: Dict[tuple, dict] = {}
    geos: Dict[tuple, StreamGeometry] = {}
    name = (f"{plan.program.name}_plane_{mode}_"
            f"{'periodic' if plan.periodic else 'bounded'}"
            f"{'_shard' if plan.shard is not None else ''}")

    reaches = [plan.reach] + ([ap.reach] if ap is not None else [])
    reach = [max(r[side][d] for r in reaches for side in (0, 1))
             for d in range(3)]

    def launch(a0, spatial, ptr_sets, probes=(), bases=None):
        global LAUNCHES
        key = (spatial, tile_itemsize(a0))
        if plan.periodic and any(n < r for n, r in zip(spatial, reach)):
            # the kernel wraps a read with one add or subtract
            raise ValueError(f"{plan.op.op_name}: periodic extents "
                             f"{spatial} must cover the stencil reach "
                             f"{reach}")
        if key not in geos:
            sg = stream_geometry(plan, spatial, tile_itemsize(a0), ap, form)
            if sg is None:
                raise ValueError(
                    f"{plan.op.op_name}: no streaming tile fits "
                    f"{SMEM_BUDGET} bytes of shared memory at k={plan.k} "
                    f"({tile_itemsize(a0)}-byte elements, shape {spatial}"
                    f"{f', {form} form' if form else ''}); use a smaller k")
            geos[key] = sg
            log_lowering_decision(plan.program.name, route="stream",
                                  spatial=spatial, itemsize=key[1],
                                  form=sg.form, segments=sg.nseg)
        sg = geos[key]
        dtype = str(a0.dtype).replace("torch.", "")
        tag = f"_{sg.form}" if sg.form else ""
        lib = _load_library(
            libs.setdefault((a0.dtype, sg.form), {}),
            lambda: generate_plane_source(ap if ap is not None else plan,
                                          mode, dtype, sg.form or "gather"),
            f"{name}{tag}_{dtype}")
        probe_ptrs = Ptrs((t, 0) for t in probes)
        fwd_mode = mode == "forward"
        args = [a for pair in ptr_sets for a in pair] + [
            probe_ptrs if fwd_mode else None,
            None if fwd_mode else probe_ptrs,
            shard_geo(plan, sg.geo, spatial, bases)]
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)], args, a0,
               f"{name}: streaming launch ({sg.form or mode})"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic, spatial,
                          a0.element_size(),
                          mode if plan.shard is None else f"{mode}_shard",
                          sg.form)] += 1
        launch.form = sg.form

    launch.form = form
    return launch


WINDOW_AT = 11  # geo[WINDOW_AT:WINDOW_AT + 6]: wlo[3], whi[3]


def shard_geo(plan: ChainPlan, geo, spatial, bases) -> List[int]:
    """``geo`` for one launch: a sharded plan's forward interior window
    and global domain in the block's coordinates (the global ones less the
    block's base offsets; ``csrc/plane_adjoint.cuh``), so one library
    serves every shard.  Unchanged for an unsharded plan."""
    if plan.shard is None:
        return list(geo)
    from .flatten import check_bases

    b = check_bases(plan.shard, bases, 3)
    g = plan.shard.global_spatial
    ghost = plan.program.ghost
    geo = list(geo)
    geo[WINDOW_AT:WINDOW_AT + 6] = (
        [lo - b[d] for d, (lo, _) in enumerate(ghost)]
        + [g[d] - hi - b[d] for d, (_, hi) in enumerate(ghost)])
    return geo + [-x for x in b] + [g[d] - b[d] for d in range(3)]


def _outputs(plan: ChainPlan, state, a0, spatial):
    """state_k tensors (chain-invariant planes: the tensors given) and the
    ones the kernel writes."""
    new = {f.name: (state[f.name] if f.name in plan.invariant else
                    empty(storage_shape(f, spatial), a0.dtype, a0.device))
           for f in plan.program.input_fields}
    return new, {n: t for n, t in new.items() if n not in plan.invariant}


def make_plane_adjoint_kernel(ap, form: Optional[str] = None):
    """``fn(state, cots) -> (state_k, cot_0)`` through the streaming kernel
    in two-phase mode, in ``form`` ("gather" or "local"; None: the
    picker's, per shape); same semantics as
    ``ops.adjoint_chain.plain_chain_vjp``, probe cotangents included.
    ``fn.form`` is the form of the last launch.  A sharded plan
    (``ap.fwd.shard``) runs the shard mode: ``fn(..., bases=)``."""
    from .adjoint_chain import check_probe_cots

    if form is not None and form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    plan = ap.fwd
    launch = _launcher(plan, ap, "two_phase", form)

    def fn(state, cots, probe_cots=(), bases=None):
        a0, spatial = check_state(plan, state)
        _check_inputs(plan.program, cots)
        pcs = check_probe_cots(plan, probe_cots, a0, spatial)
        new_state, stored = _outputs(plan, state, a0, spatial)
        cot0 = {f.name: empty(storage_shape(f, spatial), a0.dtype,
                              a0.device)
                for f in plan.program.input_fields}
        if any(n == 0 for n in spatial):
            return real(new_state), real(cot0)
        launch(a0, spatial, [plane_args3(plan.planes, t, 3)
                             for t in (state, stored, cots, cot0)], pcs,
               bases)
        fn.form = launch.form
        return real(new_state), real(cot0)

    fn.plan = ap
    fn.form = form
    return fn


def make_plane_chain_kernel(plan: ChainPlan):
    """``fn(state) -> (state_k, probe_list)`` through the streaming kernel
    in forward mode; same semantics as
    ``ops.time_chain.plain_time_chain`` (``fn(state, bases)`` in a sharded
    plan's shard mode)."""
    launch = _launcher(plan, None, "forward")
    if any(p in plan.invariant for p, _ in plan.probes):
        raise NotImplementedError(
            f"{plan.op.op_name}: the streaming kernel records probes of "
            f"carried state fields only")

    def fn(state, bases=None):
        a0, spatial = check_state(plan, state)
        new_state, stored = _outputs(plan, state, a0, spatial)
        probes = [empty((plan.k, spatial[-1]), a0.dtype, a0.device)
                  for _ in plan.probes]
        if any(n == 0 for n in spatial):
            return real(new_state), real(probes)
        no_cots = plane_args3(plan.planes, {}, 3)
        launch(a0, spatial, [plane_args3(plan.planes, state, 3),
                             plane_args3(plan.planes, stored, 3),
                             no_cots, no_cots], probes, bases)
        return real(new_state), real(probes)

    fn.plan = plan
    return fn
