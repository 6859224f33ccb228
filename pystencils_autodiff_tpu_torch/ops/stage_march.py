"""The dim-0 march of the stage kernels: kernel 12 (forward mode) and
kernel 13 (two-phase mode) as one march of stage events on a Hopper GPU
(``csrc/stage_march.cuh``); over a time chain seen as a one-stage cycle
repeated k times (``chain_stage_plan``, ``chain_march_plans``; 3D
periodic chains wrap every dim) its forward mode also runs row 7, the 3D
forward chain, with probe records, and its two-phase mode rows 8, 10 and
11, the 2D two-phase, the 2D periodic and the 3D twin-accum
value+gradient, with probe cotangents joining the reverse parts.

The TPU kernels hold whole rows in VMEM and tile dim 0.  The box design of
PR 4 (``csrc/stage_chain.cuh``, ``csrc/stage_adjoint.cuh``) wraps the halo
of every event round a box tile and keeps every plane over it: kernel 13
then owned 0.13–0.14 of its tile on the cavity and the elastic pair.  Here
a block owns a lateral tile (2D: a strip of columns; 3D: a (y, x) tile)
and a segment of dim 0, and MARCHES through it a chunk of rows (planes) a
step; only rings of rows live in shared memory, so the halo is paid in
the lateral dims alone.

The march is a list of **parts** (``MarchProgram``), run in order at every
march step:

* forward: ``F`` (a stage) and ``B`` (a BC event that reads neighbours:
  bounce-back, Neumann), each writing its outputs into a ring of its own;
  ``S`` stores state_k for the owned cells in the last one's pass;
* reverse (two-phase mode), the events walked back: ``R`` (the gather
  form: the stage's backward program) or ``L`` then ``G`` (the local-VJP
  form, ``ops.local_vjp.stage_local_vjp``: the local VJP at the write cell
  into w rows, then the gather of the w slots), and ``BR`` (a BC's
  transpose), each writing the cotangent slots it changes; ``SC`` stores
  cot_0 in the last one's pass;
* probe records (forward mode, a time chain's one-stage cycle): ``P``
  stores the probe rows (2D) or lines (3D) of state s + 1 into record s
  of their ``(k, n_last)`` outputs, at the owned cells of the stage
  part's pass;
* folds: a pointwise BC event (dirichlet, masked_dirichlet, sponge) runs
  at the cell in the epilogue of the forward part before it (``FOLD``:
  in place where the target's plane is in that part's ring and holds no
  other state plane, else into an extra plane of it; the first cycle's
  lead BCs fold into the input load), and its transpose in the epilogue
  of the reverse part before it in reverse order (``RFOLD``): no ring,
  pass or barrier of their own.  The products are the same in the same
  order.

Every part reads the planes it needs through tables (``src``: where each
state plane lives before the event; ``csrc``: where each cotangent slot
lives after it) that name a ring and a plane; unchanged planes are never
copied (the carry maps and pass-through cotangents only rename).  The
inputs (state_0, the chain-invariant planes, cot_k) come through input
rings the kernel fills with ``cp.async`` one step ahead.

``stage_march_geometry`` reckons the lags (part X works on rows
``t·C − lag[X]`` at march step t, so every row it reads is computed
earlier), the per-dim extents of every ring (what its readers read), the
ring depths (the readers' dim-0 reach plus their lag behind the writer
plus a chunk), the chunk height C, the strip width, the threads of a
block and the blocks resident on an SM, the dim-0 segments (by rounds of
the card's resident slots) and, per stage, the reverse form, from the
weighted work per owned cell.  A library is one march: the geometry is
constants of its source, so every ring address folds.  A barrier follows
a part only where a later part of the step reads what the pass wrote.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from ..adjoint_field import AdjointField
from ..field import Field
from .chain_bc import POINTWISE_KINDS
from .time_chain import MAX_PROBES, SMEM_BUDGET

__all__ = ["MarchProgram", "MarchGeometry", "Part", "march_program",
           "stage_march_geometry", "march_fits", "chain_march_plans",
           "chain_stage_plan",
           "FORMS", "PART_NAMES"]

# a march's first build's block size (PSAT_THREADS; GAIN lists the others
# the reckoning weighs where the registers allow)
THREADS = 256
NUM_SMS = 132  # H100 SXM
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
# input rings: their lateral origin and width are whole vectors of 4
# elements (16-byte copies of f32, two of f64)
VEC = 4
FORMS = ("gather", "local")
# part kinds (csrc/stage_march.cuh::PartKind)
F, B, R, L, G, BR, S, SC, FOLD, RFOLD, P = range(11)
PART_NAMES = ("F", "B", "R", "L", "G", "BR", "S", "SC", "FOLD", "RFOLD",
              "P")
IN_STATE, IN_INV, IN_COT = 0, 1, 2
# parts that run at their host's cells in its pass (the stores: at the
# owned ones)
FOLDLIKE = (FOLD, RFOLD, S, SC, P)
# parts that read the owned cells only (the stores)
STORES = (S, SC, P)
WIDE_AT = 10  # geo[WIDE_AT]: 16-byte input copies (set per call)
# candidates: 2D chunk heights and owned strip widths, 3D (y, x) tiles;
# tests patch them (and MARCH_SEGMENTS, a forced dim-0 segment count)
CHUNKS_2D = (1, 2, 3, 4, 6, 8)
CHUNKS_3D = (1, 2)
STRIP_COLS = tuple(range(16, 1025, 8))
TILES_3D = tuple((ty, tx) for ty in (2, 4, 8, 12, 16, 24, 32)
                 for tx in (8, 16, 24, 32, 48, 64))
MARCH_SEGMENTS: Optional[int] = None
# what a part costs each march step beyond its cells' bodies (its barrier,
# setup and slowest warp), in program steps of a 256-thread block; with
# GAIN, fitted to the chunk, block-size and residency sweeps on the H100
# (PERF.md)
STEP_OVERHEAD = 48
MIN_MARCH_SHARE = 0.1
# (threads a block, blocks resident on an SM) -> the time a thread-step
# costs against one 256-thread block an SM: more warps hide more of the
# shared-memory latencies and of one block's barriers behind the others'
# work.  Blocks resident on an SM share its shared memory; a choice is
# weighed only where the built kernel's registers allow it.
SMEM_PER_SM = 233472
GAIN = {(256, 1): 1.0, (256, 2): 0.8, (512, 1): 0.9, (256, 3): 0.68,
        (256, 4): 0.6, (512, 2): 0.72, (1024, 1): 0.81}
# the blocks of a launch do not end together: the last round's stragglers
# cost about half a block's time, so more, shorter segments pay (fitted
# to the segment sweeps of `chip_smoke.py --march-ab`, PERF.md)
ROUND_TAIL = 0.5


def _m3(offs, nd: int) -> Tuple[int, int, int]:
    """Program-dim offsets in march coordinates (d0 the march dim; 2D: the
    lateral dim is the last, the middle one is 1 wide)."""
    o = [int(v) for v in offs]
    return (o[0], 0, o[1]) if nd == 2 else (o[0], o[1], o[2])


def _reach3(lo, hi, nd):
    return list(_m3(lo, nd)), list(_m3(hi, nd))


def _cover(a, b):
    if a is None or b is None:
        return b if a is None else a
    return ([max(x, y) for x, y in zip(a[0], b[0])],
            [max(x, y) for x, y in zip(a[1], b[1])])


def _widen(ext, lo, hi):
    return ([e + r for e, r in zip(ext[0], lo)],
            [e + r for e, r in zip(ext[1], hi)])


ZERO = ([0, 0, 0], [0, 0, 0])


@dataclass
class Part:
    """One part of the march (see the module doc)."""

    kind: int
    ev: int = -1   # cycle event index: the emitted type
    ring: int = -1  # output ring
    nout: int = 0
    src: Optional[list] = None   # state plane -> (ring, plane)
    csrc: Optional[list] = None  # cot slot -> (ring, plane)
    writes: Optional[list] = None  # output j -> cot slot (reverse parts)
    wring: int = -1  # G: the ring of its L part's w planes
    host: int = -1   # folds: the part whose cells they run at (-1: input)
    reads: Dict[int, tuple] = field(default_factory=dict)  # ring -> reach
    weight: int = 0
    outp: Optional[list] = None  # folds: the ring plane of each output
    # reverse parts: the stage whose probe cotangents join what they write
    # (the cotangent of state s + 1), or -1; P: the record it stores
    probe_stage: int = -1
    sync: bool = False  # a barrier follows the part (march_program)

    def out_planes(self) -> List[int]:
        """The ring planes the part writes: ``outp`` for a fold, else its
        ``nout`` planes in order."""
        return (list(self.outp) if self.outp is not None
                else list(range(self.nout)))

    def read(self, ring: int, lo, hi) -> None:
        """Widen the part's read of ``ring`` to cover ``lo``..``hi`` cells a
        dim."""
        self.reads[ring] = _cover(self.reads.get(ring),
                                  (list(lo), list(hi)))


@dataclass
class MarchProgram:
    """The shape-independent half of the march: parts, rings (planes and
    writer), the per-stage forms and local VJPs."""

    plan: object
    ap: object
    forms: Tuple[str, ...]  # per stage of the cycle (two-phase mode)
    parts: List[Part]
    ring_planes: List[int]
    dyn: List[int]  # state planes of ring IN_STATE (the non-invariant ones)
    inv: List[int]  # state planes of ring IN_INV (the invariant ones)
    local: Dict[int, object]  # stage -> LocalVJP (local form)
    probe_slots: List[int] = field(default_factory=list)  # per probe


@dataclass
class MarchGeometry:
    """A march for one shape: the program, its lags and extents, ring
    depths and offsets, the chunk, the lateral tile, the segments, the
    work reckoning and the int64 block the launcher reads (``geo``, layout
    in csrc/stage_march.cuh::parse_march_geo)."""

    program: MarchProgram
    forms: Tuple[str, ...]
    chunk: int
    tile: Tuple[int, int]  # lateral (y, x); 2D: (1, strip width)
    nseg: int
    zlen: int
    smem: int
    owned_share: float
    work: float  # weighted steps per owned cell (the picker's measure)
    lags: List[int]
    extents: List[tuple]  # per part (lo[3], hi[3]) around the owned tile
    ring_depth: List[int]
    ring_ext: List[tuple]
    cot_lag: int
    geo: List[int]
    blocks_per_sm: int = 1  # blocks resident on an SM, as reckoned
    threads: int = 256  # a block's (the library's PSAT_THREADS)
    rounds: int = 1  # of blocks over the card's resident slots
    # per ring (offset, depth, ry, rx, writer lag): with the chunk, tile and
    # lags, constants of the generated source (one library per march)
    rings: List[tuple] = field(default_factory=list)


# ---------------------------------------------------------------------------
# The part program.

def _bc_planes(plan, bc) -> List[int]:
    """State planes a BC event reads: its targets and parameter planes."""
    names = [bc.field] + [p for p in ([bc.mask, bc.value]
                                      + list(bc.u_wall or ()))
                          if isinstance(p, str)]
    return [n for nm in names for n in plan.planes_of(nm)]


def _bc_rev_planes(plan, bc, ap) -> List[int]:
    """State planes a BC's transpose reads (chain_bc.cuh ``bwd``): the mask
    (masked_dirichlet, bounce_back), the damping (sponge) and, for a
    damping field that gets a gradient, the targets before the sponge."""
    names = []
    if bc.kind in ("masked_dirichlet", "bounce_back"):
        names.append(bc.mask)
    if bc.kind == "sponge" and isinstance(bc.value, str):
        names.append(bc.value)
        if any(ap.cslot[n] >= 0 for n in plan.planes_of(bc.value)):
            names.append(bc.field)
    return [n for nm in names for n in plan.planes_of(nm)]


def _bc_touched(ap, plan, bc) -> List[int]:
    """Cotangent slots a BC's transpose changes: its targets', a value
    (or damping) field's and the wall velocities' where they have one."""
    slots = [ap.cslot[n] for n in plan.planes_of(bc.field)]
    params = ([bc.value] if isinstance(bc.value, str) else []) + [
        u for u in (bc.u_wall or ()) if isinstance(u, str)]
    for nm in params:
        for n in plan.planes_of(nm):
            if ap.cslot[n] >= 0 and ap.cslot[n] not in slots:
                slots.append(ap.cslot[n])
    return [s for s in slots if s >= 0]


def _plane_reach(steps, nd, slot_plane, pick=None):
    """Per state plane the (lo, hi) march-coordinate reach of the accesses
    of ``steps``; ``slot_plane(field, idx)`` maps an access to its state
    plane (None: not a state plane read), ``pick`` filters fields."""
    out: Dict[int, tuple] = {}
    for s in steps:
        for a in s.atoms:
            if not isinstance(a, Field.Access):
                continue
            if pick is not None and not pick(a.field):
                continue
            n = slot_plane(a.field, tuple(a.index))
            if n is None:
                continue
            o = _m3(a.offsets, nd)
            r = ([max(0, -v) for v in o], [max(0, v) for v in o])
            out[n] = _cover(out.get(n), r)
    return out


def march_program(plan, ap=None, forms=None) -> MarchProgram:
    """The parts of the march of ``plan`` (forward mode) or, with the
    ``AdjointStagePlan`` ``ap``, of its value and gradient, the reverse of
    stage j in ``forms[j]``."""
    from ..codegen.cuda_printer import input_planes
    from .local_vjp import stage_local_vjp

    nd = plan.nd
    events = plan.events()
    ncyc = len(plan.cycle)
    keys = plan.plane_keys
    dyn = [n for n, (nm, _) in enumerate(keys) if nm not in plan.invariant]
    inv = [n for n, (nm, _) in enumerate(keys) if nm in plan.invariant]
    nstage = len(plan.progs)
    forms = tuple(forms) if forms is not None else ("gather",) * nstage
    if plan.probes and (ncyc != 1 or (ap is not None and nd != 2)):
        raise NotImplementedError(
            f"{plan.name}: probe rows join the march of a one-stage chain "
            f"only (its two-phase mode: in 2D)")
    if ap is None and any(keys[n][0] in plan.invariant
                          for n, _ in plan.probes):
        raise NotImplementedError(
            f"{plan.name}: the march records probes of carried state "
            f"fields only")
    probe_slots = [ap.cslot[n] for n, _ in plan.probes] if ap else []
    ring_planes = [len(dyn), len(inv)] + (
        [len(ap.cot_planes)] if ap is not None else [])
    smap = [None] * len(keys)
    for i, n in enumerate(dyn):
        smap[n] = (IN_STATE, i)
    for i, n in enumerate(inv):
        smap[n] = (IN_INV, i)
    parts: List[Part] = []
    before = []
    host = -1

    def new_ring(planes):
        ring_planes.append(planes)
        return len(ring_planes) - 1

    for e, ev in enumerate(events):
        i = e % ncyc
        before.append(list(smap))
        if ev.kind == "bc" and ev.bc.kind in POINTWISE_KINDS:
            r = parts[host].ring if host >= 0 else IN_STATE
            # in place where the target's plane is in this ring and holds
            # no other state plane, and no transpose reads it before the
            # BC (a sponge whose damping gets a gradient)
            keep = ap is not None and any(
                n in _bc_rev_planes(plan, ev.bc, ap)
                for n in plan.planes_of(ev.bc.field))
            outp = []
            for n in plan.planes_of(ev.bc.field):
                if (not keep and smap[n][0] == r
                        and smap.count(smap[n]) == 1):
                    outp.append(smap[n][1])
                else:
                    outp.append(ring_planes[r])
                    ring_planes[r] += 1
            p = Part(FOLD, i, ring=r, nout=ev.nout, src=list(smap),
                     host=host, weight=ev.nout, outp=outp)
            if host >= 0:
                for n in _bc_planes(plan, ev.bc):
                    p.read(smap[n][0], [0] * 3, [0] * 3)
            for j, n in enumerate(plan.planes_of(ev.bc.field)):
                smap[n] = (r, outp[j])
            parts.append(p)
            continue
        r = new_ring(ev.nout)
        if ev.kind == "stage":
            prog = plan.progs[ev.stage]
            slot = {(f.name, idx): ev.in_planes[j] for j, (f, idx)
                    in enumerate(input_planes(prog))}
            p = Part(F, i, ring=r, nout=ev.nout, src=list(smap),
                     weight=len(prog.steps))
            for n, rch in _plane_reach(
                    prog.steps, nd, lambda f, idx: slot.get((f.name, idx))
                    ).items():
                p.read(smap[n][0], *rch)
            old = list(smap)
            for n, (kind, o) in enumerate(ev.src):
                smap[n] = (r, o) if kind == "out" else old[o]
        else:
            lo, hi = _reach3(*ev.reach, nd)
            p = Part(B, i, ring=r, nout=ev.nout, src=list(smap),
                     weight=4 * ev.nout)
            for n in _bc_planes(plan, ev.bc):
                p.read(smap[n][0], lo, hi)
            for j, n in enumerate(plan.planes_of(ev.bc.field)):
                smap[n] = (r, j)
        parts.append(p)
        host = len(parts) - 1
        if ap is None and plan.probes:
            # record e: the probe rows of state e + 1, in this pass
            rec = Part(P, i, src=list(smap), host=host, probe_stage=e,
                       weight=len(plan.probes))
            for n, _ in plan.probes:
                rec.read(smap[n][0], [0] * 3, [0] * 3)
            parts.append(rec)
    # state_k: stored from the owned cells in the last forward part's pass
    store = Part(S, src=list(smap), weight=len(dyn), host=host)
    for n in dyn:
        store.read(smap[n][0], [0] * 3, [0] * 3)
    parts.append(store)
    local = {}
    if ap is not None:
        nc = len(ap.cot_planes)
        cmap = [(IN_COT, m) for m in range(nc)]
        rhost = None
        for e in range(len(events) - 1, -1, -1):
            ev = events[e]
            i = e % ncyc
            src = before[e]
            if ev.kind == "bc":
                touched = _bc_touched(ap, plan, ev.bc)
                lo, hi = _reach3(*ev.reach, nd)
                both = [max(a, b) for a, b in zip(lo, hi)]
                fold = ev.bc.kind in POINTWISE_KINDS
                if fold:
                    if rhost is None:
                        raise NotImplementedError(
                            f"{plan.name}: a chain that ends with a "
                            f"pointwise BC event has no reverse part to "
                            f"fold its transpose into")
                    r = parts[rhost].ring
                    outp = []
                    for m in touched:  # in place where it may be
                        if cmap[m][0] == r and cmap.count(cmap[m]) == 1:
                            outp.append(cmap[m][1])
                        else:
                            outp.append(ring_planes[r])
                            ring_planes[r] += 1
                    p = Part(RFOLD, i, ring=r, nout=len(touched),
                             src=src, csrc=list(cmap), writes=touched,
                             host=rhost, weight=2 * len(touched), outp=outp)
                else:
                    r = new_ring(len(touched))
                    p = Part(BR, i, ring=r, nout=len(touched), src=src,
                             csrc=list(cmap), writes=touched,
                             weight=12 * len(touched))
                for m in touched:
                    p.read(cmap[m][0], both, both)
                for n in _bc_rev_planes(plan, ev.bc, ap):
                    p.read(src[n][0], both, both)
                for j, m in enumerate(touched):
                    cmap[m] = (r, p.out_planes()[j])
                parts.append(p)
                if not fold:
                    rhost = len(parts) - 1
                continue
            t = ap.tables[i]
            form = forms[ev.stage]
            prog = plan.progs[ev.stage]
            slot = {(f.name, idx): ev.in_planes[j] for j, (f, idx)
                    in enumerate(input_planes(prog))}
            # the probe cotangents of stage e − 1 join the cotangent of
            # state e, which this part writes
            probed = probe_slots if e >= 1 else []
            writes = [m for m in range(nc)
                      if t["grad"][m] >= 0 or t["pass"][m] != [m]
                      or m in probed]
            if form == "gather":
                bwd = ap.bwd[ev.stage]
                r = new_ring(len(writes))
                p = Part(R, i, ring=r, nout=len(writes), src=src,
                         csrc=list(cmap), writes=writes,
                         weight=len(bwd.steps))
                blo, bhi = _reach3(*ap.reach[i], nd)
                for n in [n for n in t["prim"] if n >= 0]:
                    p.read(src[n][0], blo, bhi)
                for slots in t["adj"]:
                    for m in slots:
                        p.read(cmap[m][0], blo, bhi)
                for m in writes:
                    for q in t["pass"][m]:
                        p.read(cmap[q][0], [0] * 3, [0] * 3)
                for j, m in enumerate(writes):
                    cmap[m] = (r, j)
                if probed:
                    p.probe_stage = e - 1
                parts.append(p)
            else:
                lv = local.get(ev.stage)
                if lv is None:
                    lv = local[ev.stage] = stage_local_vjp(
                        plan, ev, lambda n: ap.cslot[n] >= 0)
                nw = len(lv.slots)
                rl = new_ring(nw)
                pl = Part(L, i, ring=rl, nout=nw, src=src,
                          csrc=list(cmap), weight=len(lv.program.steps))
                nin = len(input_planes(prog))
                for n, rch in _plane_reach(
                        lv.program.steps, nd,
                        lambda f, idx: slot.get((f.name, idx)),
                        pick=lambda f: not isinstance(f, AdjointField)
                        ).items():
                    pl.read(src[n][0], *rch)
                for n, s in enumerate(ev.src):
                    if s[0] == "out" and ap.cslot[n] >= 0:
                        pl.read(cmap[ap.cslot[n]][0], [0] * 3, [0] * 3)
                assert nin <= len(input_planes(lv.program))
                parts.append(pl)
                rg = new_ring(len(writes))
                pg = Part(G, i, ring=rg, nout=len(writes), src=src,
                          csrc=list(cmap), writes=writes, wring=rl,
                          weight=nw + len(writes))
                for a, (_, offs) in enumerate(lv.slots):
                    o = _m3(offs, nd)
                    # G reads w_a at minus its read offset
                    pg.read(rl, [max(0, v) for v in o],
                            [max(0, -v) for v in o])
                for m in writes:
                    for q in t["pass"][m]:
                        pg.read(cmap[q][0], [0] * 3, [0] * 3)
                for j, m in enumerate(writes):
                    cmap[m] = (rg, j)
                if probed:
                    pg.probe_stage = e - 1
                parts.append(pg)
            rhost = len(parts) - 1
        sc = Part(SC, csrc=list(cmap), weight=nc, host=rhost)
        for m in range(nc):
            sc.read(cmap[m][0], [0] * 3, [0] * 3)
        parts.append(sc)
    _place_barriers(parts)
    return MarchProgram(plan=plan, ap=ap, forms=forms, parts=parts,
                        ring_planes=ring_planes,
                        dyn=dyn, inv=inv, local=local,
                        probe_slots=probe_slots)


def _place_barriers(parts: List[Part]) -> None:
    """A barrier after a part only where a later part of the step reads a
    ring written since the last barrier (every cell of a pass is another
    thread's): parts that read none of it share the pass.  The step's own
    closing barrier follows the last part."""
    live = [x for x, p in enumerate(parts) if p.kind not in FOLDLIKE]
    dirty: set = set()
    for a, x in enumerate(live):
        reads = set(parts[x].reads)
        for q in parts:
            if q.kind in FOLDLIKE and q.host == x:
                reads |= set(q.reads)
        if a and reads & dirty:
            parts[live[a - 1]].sync = True
            dirty = set()
        dirty.add(parts[x].ring)


# ---------------------------------------------------------------------------
# Lags, extents, depths.

def _lags_and_extents(mp: MarchProgram):
    """Per part its lag and (dim-0 and lateral) extents around the owned
    tile, per ring its writer's lag and its extents, and the lag of the
    cot_k input ring.  A part lags each part whose ring it reads by that
    read's reach above the row (a barrier follows every part)."""
    parts = mp.parts
    nring = len(mp.ring_planes)
    two_phase = mp.ap is not None
    folds = {x: [] for x in range(-1, len(parts))}
    for x, p in enumerate(parts):
        if p.kind in FOLDLIKE:
            folds[p.host].append(x)
    ring_lag = [0] * nring
    lag = [0] * len(parts)
    for x, p in enumerate(parts):
        if p.kind in FOLDLIKE:
            lag[x] = lag[p.host] if p.host >= 0 else 0
            continue
        lg = 0
        for fx in [x] + folds[x]:
            for r, (lo, hi) in parts[fx].reads.items():
                if two_phase and r == IN_COT:
                    continue
                lg = max(lg, ring_lag[r] + hi[0])
        lag[x] = lg
        if p.ring >= 0:
            ring_lag[p.ring] = lg
    cot_lag = 0
    if two_phase:
        cands = [lag[x] - lo_hi[1][0] for x, p in enumerate(parts)
                 for r, lo_hi in p.reads.items() if r == IN_COT]
        cot_lag = min(cands) if cands else 0
        ring_lag[IN_COT] = cot_lag
    ring_ext: List[Optional[tuple]] = [None] * nring
    ext: List[Optional[tuple]] = [None] * len(parts)
    for x in range(len(parts) - 1, -1, -1):
        p = parts[x]
        if p.kind in FOLDLIKE:
            continue
        ex = ZERO if ring_ext[p.ring] is None else ring_ext[p.ring]
        ext[x] = ex
        for fx in [x] + folds[x]:
            ext[fx] = ex
            # a store reads the owned cells only
            at = ZERO if parts[fx].kind in STORES else ex
            for r, (lo, hi) in parts[fx].reads.items():
                ring_ext[r] = _cover(ring_ext[r], _widen(at, lo, hi))
    # the input folds run at the cells of the state and invariant input
    # rings, which share their extents
    both = _cover(_cover(ring_ext[IN_STATE], ring_ext[IN_INV]), ZERO)
    ring_ext[IN_STATE] = ring_ext[IN_INV] = both
    for fx in folds[-1]:
        ext[fx] = both
    for r in range(nring):
        if ring_ext[r] is None:
            ring_ext[r] = ZERO
    return lag, ext, ring_lag, ring_ext, cot_lag


def _depths(mp: MarchProgram, lag, ring_lag, chunk: int) -> List[int]:
    """Rows each ring holds: its readers' lag behind the writer plus their
    dim-0 reach below plus a chunk (the input rings one more chunk: the
    copies of the next step are in flight while this step reads), rounded
    up to a power of two."""
    nring = len(mp.ring_planes)
    need = [0] * nring
    for x, p in enumerate(mp.parts):
        if p.kind == FOLD and p.host < 0:
            continue
        for r, (lo, _) in p.reads.items():
            need[r] = max(need[r], lag[x] - ring_lag[r] + lo[0])
    n_in = 3 if mp.ap is not None else 2
    # whole powers of two: a read's slot is then a mask, not a wrap (the
    # A/B in PERF.md: faster on every main shape but the cavity's adjoint)
    return [1 << (need[r] + chunk + (chunk if r < n_in else 0) - 1
                  ).bit_length() for r in range(nring)]


def march_layout(mp: MarchProgram):
    """The half of the reckoning that the generated source holds as
    constants (it depends on neither the shape nor the chunk): per part
    its extents, per ring its extents and lateral origin (``lo1``,
    ``lo2``)."""
    _, ext, _, ring_ext, _ = _lags_and_extents(mp)
    n_in = 3 if mp.ap is not None else 2
    lo = [_ring_region((1, 1), ring_ext[r], r, n_in)[:2]
          for r in range(len(mp.ring_planes))]
    return dict(ext=ext, ring_ext=ring_ext, ring_lo=lo)


def _step_range(mp, lag, ext, ring_ext, cot_lag):
    """(tlo, thi): the march steps of a segment [za, zb) are t·C in
    [za + tlo, zb + thi): every part's rows, and the input groups'."""
    n_in = 3 if mp.ap is not None else 2
    live = [x for x, p in enumerate(mp.parts) if p.kind not in FOLDLIKE]
    tlo = min([lag[x] - ext[x][0][0] for x in live]
              + [-ring_ext[IN_STATE][0][0]]
              + ([cot_lag - ring_ext[IN_COT][0][0]] if n_in == 3 else []))
    thi = max([lag[x] + ext[x][1][0] for x in live]
              + [ring_ext[IN_STATE][1][0]]
              + ([cot_lag + ring_ext[IN_COT][1][0]] if n_in == 3 else []))
    return tlo, thi


def _ring_region(tile, ext, r: int, n_in: int):
    """(lo1, lo2, ry, rx): a ring's lateral origin (cells left of and above
    the owned tile) and extents; the input rings' x origin and width are
    whole vectors."""
    (_, lo1, lo2), (_, hi1, hi2) = ext
    if r < n_in:
        lo2 = -(-lo2 // VEC) * VEC
        rx = -(-(tile[1] + lo2 + hi2) // VEC) * VEC
    else:
        rx = tile[1] + lo2 + hi2
    return lo1, lo2, tile[0] + lo1 + hi1, rx


# ---------------------------------------------------------------------------
# The reckoning.

def _evaluate(mp, layout, itemsize, chunk, tile, config=(256, 1)):
    """(smem bytes, work per owned cell, owned share, depths) of one
    (chunk, tile, (threads a block, blocks per SM)) choice."""
    smem, share, depth, regions, loads = _regions(mp, layout, itemsize,
                                                  chunk, tile)
    return (smem, _work(regions, loads, chunk, tile, config), share, depth)


def _regions(mp, layout, itemsize, chunk, tile):
    """(smem bytes, owned share, depths, per live part (cells of its
    region a row, weight), input cells loaded a step) of one (chunk,
    tile) choice."""
    lag, ext, ring_lag, ring_ext, _ = layout
    n_in = 3 if mp.ap is not None else 2
    depth = _depths(mp, lag, ring_lag, chunk)
    elems = 0
    for r, planes in enumerate(mp.ring_planes):
        _, _, ry, rx = _ring_region(tile, ring_ext[r], r, n_in)
        elems += -(-depth[r] * planes * ry * rx // VEC) * VEC
    # and a margin of 8 bytes a ring
    smem = elems * itemsize + 8 * len(mp.ring_planes)
    owned = tile[0] * tile[1]
    widest = owned
    regions = []
    for x, p in enumerate(mp.parts):
        if p.kind in FOLDLIKE:
            continue
        (_, a1, a2), (_, b1, b2) = ext[x]
        reg = (tile[0] + a1 + b1) * (tile[1] + a2 + b2)
        widest = max(widest, reg)
        regions.append((reg, p.weight + sum(
            q.weight for q in mp.parts if q.kind in FOLDLIKE and q.host == x)))
    loads = 0
    for r in range(n_in):
        _, _, ry, rx = _ring_region(tile, ring_ext[r], r, n_in)
        loads += chunk * ry * rx * mp.ring_planes[r]
    return smem, owned / widest, depth, regions, loads


def _work(regions, loads, chunk, tile, config):
    """Weighted thread-steps per owned cell (see stage_march_geometry)."""
    threads = config[0]
    work = loads + sum(math.ceil(chunk * reg / threads) * threads * w
                       + STEP_OVERHEAD * THREADS for reg, w in regions)
    return work / (chunk * tile[0] * tile[1]) * GAIN.get(config, 1.0)


def _halo0(mp, layout) -> int:
    """Rows a dim-0 segment marches beyond its own: the parts' dim-0 reach
    and lags."""
    lag, ext = layout[0], layout[1]
    live = [x for x, p in enumerate(mp.parts) if p.kind not in FOLDLIKE]
    return (max(lag[x] + ext[x][1][0] for x in live)
            - min(lag[x] - ext[x][0][0] for x in live) + 1)


def _segments(ntiles: int, n0: int, halo0: int, slots: int):
    """(dim-0 segments, rounds, rows a slot marches): the segment count
    whose blocks fill the card's ``slots`` resident slots in the fewest
    rows — (rounds + ``ROUND_TAIL``) × (segment length + halo0); a round
    that more segments would fill is no dearer than a partial one.  A
    segment is no shorter than ``halo0`` (``MARCH_SEGMENTS`` forces a
    count)."""
    if MARCH_SEGMENTS is not None:
        cost, nseg, rounds = _segment_cost(
            ntiles, n0, halo0, slots, max(1, min(MARCH_SEGMENTS, n0)),
            ROUND_TAIL)
        return nseg, rounds, cost
    return _best_segments(ntiles, n0, halo0, slots, ROUND_TAIL)


def _segment_cost(ntiles, n0, halo0, slots, nseg, tail):
    """(rows a slot marches, segments, rounds) of ``nseg`` segments."""
    zlen = math.ceil(n0 / nseg)
    nseg = math.ceil(n0 / zlen)
    rounds = math.ceil(ntiles * nseg / slots)
    return (rounds + tail) * (zlen + halo0), nseg, rounds


@lru_cache(maxsize=None)
def _best_segments(ntiles, n0, halo0, slots, tail):
    """``_segments``' search, cached: a pure function of its arguments,
    which the reckonings weigh thousands of times over a few shapes."""
    nmax = max(1, min(n0, n0 // max(1, halo0)))
    best = None
    r = math.ceil(ntiles / slots)
    while True:
        nseg = min(nmax, max(1, r * slots // ntiles))
        cost, ns, rounds = _segment_cost(ntiles, n0, halo0, slots, nseg,
                                         tail)
        if best is None or cost < best[0]:
            best = (cost, ns, rounds)
        if nseg >= nmax or r * halo0 >= best[0]:
            break
        r += 1
    return best[1], best[2], best[0]


def _form_combos(nstage: int, ap, form) -> List[Tuple[str, ...]]:
    """The per-stage reverse forms the reckoning weighs for ``form``."""
    if ap is None:
        return [("gather",) * nstage]
    if form is None:
        return list(itertools.product(FORMS, repeat=nstage))
    if isinstance(form, str):
        if form not in FORMS:
            raise ValueError(f"unknown form {form!r}; one of {FORMS}")
        return [(form,) * nstage]
    if len(form) != nstage or any(f not in FORMS for f in form):
        raise ValueError(f"form {form!r}: one of {FORMS} per stage")
    return [tuple(form)]


def march_fits(plan, spatial: Sequence[int], itemsize: int, ap=None,
               form=None) -> bool:
    """Whether a march of ``plan`` (with ``ap``: of its value and
    gradient) fits a shape: ``stage_march_geometry`` finds one.  An
    unknown ``form`` raises."""
    _form_combos(len(plan.progs), ap, form)
    try:
        stage_march_geometry(plan, spatial, itemsize, ap, form)
    except ValueError:
        return False
    return True


def _configs(regs) -> List[Tuple[int, int]]:
    """The (threads a block, blocks per SM) choices a kernel of ``regs``
    registers a thread allows (None: not built yet, one 256-thread
    block)."""
    if regs is None:
        return [(THREADS, 1)]
    return [c for c in GAIN if c[0] * c[1] <= THREADS_PER_SM
            and regs * c[0] * c[1] <= REGS_PER_SM]


def stage_march_geometry(plan, spatial: Sequence[int], itemsize: int,
                         ap=None, form=None, regs=None) -> MarchGeometry:
    """The march of ``plan`` (forward mode) or of the value and gradient
    of its ``AdjointStagePlan`` ``ap`` for one shape: the counterpart of
    ``plane_adjoint.stream_geometry``.  ``form``: None (each stage's
    reverse form is the one the reckoning weighs lower), "gather",
    "local", or a tuple of one per stage of the cycle.

    The work per owned cell is every part's region (its chunk of rows
    over its lateral extents), rounded up to whole passes of the block's
    threads, weighted by its program's steps, plus ``STEP_OVERHEAD`` a
    part and step, and the input loads, times the ``GAIN`` of the block
    size and residency.  The picker minimises the card's time: that work
    over the cells a resident slot marches in its rounds (``_segments``:
    the dim-0 segments whose blocks fill the card's slots best), over the
    chunk heights ``CHUNKS_2D`` and strip widths ``STRIP_COLS`` (2D; 3D:
    ``CHUNKS_3D`` planes a step and the tiles ``TILES_3D``) whose rings
    fit the shared memory a
    block may use and own ``MIN_MARCH_SHARE`` of the widest region; ties
    go to less shared memory.  ``regs``: the registers a thread of the
    built kernel uses; with them, every (threads, blocks per SM) choice of
    ``GAIN`` they allow is weighed (the blocks share the SM's shared
    memory), else one 256-thread block.  Raises ``ValueError`` where
    nothing fits."""
    nd = plan.nd
    combos = _form_combos(len(plan.progs), ap, form)
    spatial = tuple(int(n) for n in spatial)
    s3 = (spatial[0], 1, spatial[1]) if nd == 2 else spatial
    best = None
    for forms in combos:
        mp = march_program(plan, ap, forms)
        if nd == 2:
            cands = [(c, (1, w)) for c in CHUNKS_2D for w in STRIP_COLS
                     if w < s3[2] + VEC or w == STRIP_COLS[0]]
        else:
            cands = [(c, t) for c in CHUNKS_3D for t in TILES_3D
                     if (t[0] < s3[1] + 2 or t[0] == TILES_3D[0][0])
                     and (t[1] < s3[2] + VEC or t[1] == TILES_3D[0][1])]
        layout = _lags_and_extents(mp)
        halo0 = _halo0(mp, layout)
        configs = _configs(regs)
        for chunk, tile in cands:
            smem, share, depth, regions, loads = _regions(
                mp, layout, itemsize, chunk, tile)
            if share < MIN_MARCH_SHARE:
                continue
            ntiles = math.ceil(s3[1] / tile[0]) * math.ceil(s3[2] / tile[1])
            for config in configs:
                resident = config[1]
                budget = min(SMEM_BUDGET, (SMEM_PER_SM - 1024 * resident)
                             // resident - 256)
                if smem > budget:
                    continue
                work = _work(regions, loads, chunk, tile, config)
                nseg, rounds, rows = _segments(ntiles, s3[0], halo0,
                                               NUM_SMS * resident)
                key = (rows * resident * tile[0] * tile[1] * work, smem)
                if best is None or key < best[0]:
                    best = (key, mp, layout, chunk, tile, smem, share,
                            depth, config, work, nseg, rounds)
    if best is None:
        raise ValueError(
            f"{plan.name}: no march of the stage chain fits {SMEM_BUDGET} "
            f"bytes of shared memory at k={plan.k} ({itemsize}-byte "
            f"elements, shape {spatial}); use a smaller k")
    (_, mp, layout, chunk, tile, smem, share, depth, config, work, nseg,
     rounds) = best
    return _finish(mp, layout, s3, chunk, tile, smem, share, work, depth,
                   config, nseg, rounds)


def _finish(mp, layout, s3, chunk, tile, smem, share, work, depth, config,
            nseg, rounds) -> MarchGeometry:
    """The picked march: its ring offsets and the int64 block the launcher
    reads."""
    lag, ext, ring_lag, ring_ext, cot_lag = layout
    n_in = 3 if mp.ap is not None else 2
    nt = (math.ceil(s3[1] / tile[0]), math.ceil(s3[2] / tile[1]))
    zlen = math.ceil(s3[0] / nseg)
    # ring offsets (elements), each a whole number of 16-byte vectors
    offs, off = [], 0
    regions = []
    for r, planes in enumerate(mp.ring_planes):
        lo1, lo2, ry, rx = _ring_region(tile, ring_ext[r], r, n_in)
        regions.append((lo1, lo2, ry, rx))
        offs.append(off)
        off += depth[r] * planes * ry * rx
        off = -(-off // VEC) * VEC
    tlo, thi = _step_range(mp, lag, ext, ring_ext, cot_lag)
    geo = (list(s3) + list(tile) + list(nt)
           + [nseg, zlen, chunk, 0, off, tlo, thi, cot_lag])
    for r in range(len(mp.ring_planes)):
        geo += [offs[r], depth[r], regions[r][2], regions[r][3],
                ring_lag[r]]
    geo += lag
    rings = [(offs[r], depth[r], regions[r][2], regions[r][3], ring_lag[r])
             for r in range(len(mp.ring_planes))]
    probes = mp.plan.probes
    geo += [len(probes)] + [row for _, row in probes]
    return MarchGeometry(program=mp, forms=mp.forms, chunk=chunk, tile=tile,
                         nseg=nseg, zlen=zlen, smem=smem, owned_share=share,
                         work=work, lags=lag, extents=ext, ring_depth=depth,
                         ring_ext=ring_ext, cot_lag=cot_lag, geo=geo,
                         blocks_per_sm=config[1], threads=config[0],
                         rounds=rounds, rings=rings)


# ---------------------------------------------------------------------------
# The kernel wrappers (kernels 12 and 13 in the march design).

def _wide(ptr_sets, storage_itemsize: int, itemsize: int,
          pointers: bool = True) -> int:
    """Whether the input copies may be 16-byte ones: storage in the
    compute type, every plane contiguous along x with rows (and planes)
    a whole number of vectors apart, and 16-byte aligned bases
    (``pointers=False`` leaves the bases out)."""
    if storage_itemsize != itemsize:
        return 0
    for ptrs, strides in ptr_sets:
        for q, (t, off) in enumerate(ptrs):
            if t is None:
                continue
            st = strides[3 * q: 3 * q + 3]
            if (st[2] != 1 or st[0] % VEC or st[1] % VEC or pointers and (
                    t.data_ptr() + off * t.element_size()) % 16):
                return 0
    return 1


def shard_tail(plan, bases) -> List[int]:
    """The geo block's shard-mode tail (``csrc/stage_march.cuh``): the
    block's base offsets and the global extents in march coordinates —
    arguments of the launch, so one library serves every shard.  Empty
    for an unsharded plan."""
    if plan.shard is None:
        return []
    from .flatten import check_bases

    b = check_bases(plan.shard, bases, plan.nd)
    g = [int(n) for n in plan.shard.global_spatial]
    if plan.nd == 2:
        return [b[0], 0, b[1], g[0], 1, g[1]]
    return list(b) + g


def make_march_kernel(plan, ap=None, form=None, counter=None,
                      count_name=None):
    """Kernel 12 (``ap`` None: ``fn(state, records=()) -> state``, the
    semantics of ``stage_chain.plain_stage_chain``; with the plan's probe
    rows, ``records`` holds one contiguous ``(k, n_last)`` output a probe,
    which the kernel fills with the probe's row or line after each stage)
    or kernel 13 (``fn(state, cots, probe_cots=()) -> (state_k, cot_0)``,
    those of ``stage_adjoint.plain_stage_chain_vjp``; with the plan's
    probe rows, one contiguous ``(k, n1)`` cotangent a probe) in the march
    design; ``form`` as
    ``stage_march_geometry`` takes it.  A sharded plan (``plan.shard``)
    runs the shard mode: ``fn(..., bases=)`` takes the block's base
    offsets.  The geometry is reckoned once per
    (shape, itemsize), before the launch: first for one 256-thread block,
    whose library (one per march and float type, built at its first use)
    reports its registers; then over the block sizes and residencies
    those allow.  Launches count on ``counter`` (a module with
    ``LAUNCHES`` and ``LAUNCH_CALLS``, keyed by ``count_name``; default
    ``stage_chain`` for kernel 12 and ``stage_adjoint`` for kernel 13, by
    the plan's name; the design "march", "march-shard" in shard mode);
    ``fn.geometry(spatial, itemsize)`` gives the march
    of a shape, ``fn.last_geometry`` and ``fn.forms`` those of the last
    launch, ``fn.regs`` the registers it was reckoned with.  A library is
    one march: its geometry (chunk, tile, ring offsets, depths, widths and
    lags) is constants of the source."""
    import ctypes

    import torch

    from ..codegen.cuda_printer import generate_stage_march_source
    from . import stage_adjoint as _sa
    from . import stage_chain as _sc
    from .common import storage_shape
    from .cuda_kernel import _DTYPES, tile_itemsize
    from .launch import Out, Ptrs, empty, exporting, real, run
    from .time_chain import _load_library, plane_args3

    libs: Dict[tuple, dict] = {}
    geos: Dict[tuple, MarchGeometry] = {}
    two_phase = ap is not None
    nd = plan.nd
    name = (f"{plan.name}_march_{'adjoint' if two_phase else 'chain'}"
            f"_k{plan.k}")
    cot_planes = ([plan.planes[n] for n in ap.cot_planes] if two_phase
                  else [])
    counter = counter or (_sa if two_phase else _sc)
    count_name = count_name or plan.name

    def geometry(spatial, itemsize, regs=None):
        """The march of a shape; with ``regs`` (the built kernel's), in the
        forms picked without them, weighing every block size and
        residency they allow."""
        key = (tuple(spatial), itemsize, regs)
        if key not in geos:
            f = form if regs is None else geometry(spatial, itemsize).forms
            geos[key] = stage_march_geometry(plan, spatial, itemsize, ap, f,
                                             regs)
        return geos[key]

    def library(mg, dtype):
        lib = _load_library(
            libs.setdefault((mg.forms, mg.threads, tuple(mg.geo)), {}),
            lambda dt: generate_stage_march_source(mg, dt),
            f"{name}{'_' + '_'.join(mg.forms) if two_phase else ''}"
            f"_t{mg.threads}", dtype)
        if not hasattr(lib, "regs"):
            lib.psat_march_regs.argtypes = [ctypes.c_int]
            lib.psat_march_regs.restype = ctypes.c_int
            lib.regs = {}
        return lib

    def regs_of(lib, device):
        if device not in lib.regs:
            r = lib.psat_march_regs(device)
            lib.regs[device] = r if r > 0 else None
        return lib.regs[device]

    def launch(a0, spatial, ptr_sets, probe_ptrs, bases):
        isz = tile_itemsize(a0)
        device = (a0.device.index if a0.device.index is not None
                  else torch.cuda.current_device())
        regs = regs_of(library(geometry(spatial, isz), a0.dtype), device)
        fn.regs = regs
        mg = fn.last_geometry = geometry(spatial, isz, regs)
        lib = library(mg, a0.dtype)
        geo = list(mg.geo) + shard_tail(plan, bases)
        # traced, the pointers' alignment is the launch's test
        traced = exporting()
        geo[WIDE_AT] = _wide(ptr_sets, a0.element_size(), isz, not traced)
        args = [a for pair in ptr_sets for a in pair] + [probe_ptrs, geo]
        align = ((len(args) - 1, WIDE_AT, 16),) if traced else ()
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)], args, a0,
               f"{name}: stage march launch", align):
            counter.LAUNCHES += 1
            counter.LAUNCH_CALLS[(count_name, plan.k, plan.periodic,
                                  spatial, a0.element_size(),
                                  "march" if plan.shard is None
                                  else "march-shard")] += 1
        fn.forms = mg.forms

    def new_state(st, a0, spatial):
        return {n: (st[n] if n in plan.invariant else
                    empty(storage_shape(plan.state_fields[n], spatial),
                          a0.dtype, a0.device))
                for n in plan.state_names}

    def fn(state, cots=None, probe_cots=(), records=(), bases=None):
        a0, spatial = _sc.check_stage_state(plan, state)
        out = new_state(state, a0, spatial)
        stored = {n: t for n, t in out.items() if n not in plan.invariant}
        cot0 = {}
        if two_phase:
            _sa.check_cots(ap, cots, a0, spatial)
            cot0 = {n: empty(storage_shape(plan.state_fields[n], spatial),
                             a0.dtype, a0.device)
                    for n in ap.cot_names}
        # the probe tensors: cotangents in (two-phase), records out
        # (forward mode)
        what = "probe cotangent" if two_phase else "probe record"
        probes = probe_cots if two_phase else records
        if len(probes) != len(plan.probes) or (probe_cots and records):
            raise ValueError(f"{plan.name}: {len(plan.probes)} {what}s "
                             f"expected, got {len(probes)}")
        for pc in probes:
            if (pc.device != a0.device or pc.dtype != a0.dtype
                    or tuple(pc.shape) != (plan.k, spatial[-1])
                    or not (isinstance(pc, Out) or pc.is_contiguous())):
                raise ValueError(
                    f"{plan.name}: a {what} must be a contiguous "
                    f"{(plan.k, spatial[-1])} {a0.dtype} tensor on "
                    f"{a0.device}")
        if all(n > 0 for n in spatial):
            ptr_sets = [plane_args3(plan.planes, state, nd),
                        plane_args3(plan.planes, stored, nd),
                        plane_args3(cot_planes, cots or {}, nd),
                        plane_args3(cot_planes, cot0, nd)]
            probe_ptrs = Ptrs([(pc, 0) for pc in probes]
                              + [(None, 0)] * (MAX_PROBES - len(probes)))
            launch(a0, spatial, ptr_sets, probe_ptrs, bases)
        out, cot0 = real(out), real(cot0)
        return (out, cot0) if two_phase else out

    fn.plan = ap if two_phase else plan
    fn.geometry = geometry
    fn.last_geometry = None
    fn.regs = None  # the 256-thread library's, as the card reported them
    fn.forms = None
    fn.design = "march"
    return fn


# ---------------------------------------------------------------------------
# A time chain of one op as a one-stage march (rows 7, 8 and 11).

def chain_stage_plan(plan):
    """The chain of ``plan`` (an ``ops.time_chain.ChainPlan``) as a
    one-stage cycle repeated k times: a ``StagePlan`` with no BC events,
    the chain's periodicity (3D periodic too: the march wraps every dim)
    and its probe rows (2D: a row of dim 0; 3D: the line of the flattened
    row, ``time_chain.probe_index``).  Its forward mode computes
    ``time_chain.plain_time_chain``'s state and probe records (row 7)."""
    from .stage_chain import StagePlan

    carry = {n: s for n, s in plan.next_src.items() if s != n}
    sp = StagePlan([(plan.op, carry)], plan.k, plan.periodic, wrap3d=True,
                   shard=plan.shard)
    sp.probes = [(sp.planes_of(name)[0], row) for name, row in plan.probes]
    return sp


def chain_march_plans(plan, wanted=None):
    """``chain_stage_plan(plan)`` and the ``AdjointStagePlan`` whose wanted
    invariant planes are those the backward program differentiates (κ,
    c) — of them, with ``wanted`` (field names), only those it names.
    The incoming cotangent of such a plane joins its accumulated gradient
    (it passes to itself); the cotangent of any other invariant field
    passes through unchanged, outside the kernel.  Their value and
    gradient is ``adjoint_chain.plain_chain_vjp``'s (a sharded plan's:
    its shard mode, ``_plain_shard_chain_vjp``)."""
    from .stage_adjoint import AdjointStagePlan

    sp = chain_stage_plan(plan)
    grads = {f.corresponding_forward_field.name
             for f in plan.op.backward_output_fields} & sp.invariant
    if wanted is not None:
        grads &= set(wanted)
    return sp, AdjointStagePlan(sp, wanted=grads)
