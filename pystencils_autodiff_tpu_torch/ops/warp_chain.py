"""The 2D forward chain as a warp-level register march (PERF.md row 6).

The Hopper design of ``pystencils_autodiff_tpu/ops/time_chain.py::
_make_chain_kernel_fn``, beside the box tiles of ``csrc/time_chain.cuh``
(its earlier design) and the dim-0 march's forward mode: a warp owns a
strip of columns and a segment of rows, keeps every stream of rows (each
loaded state plane, each hoisted plane, each stage's outputs) in a ring of
registers and marches down dim 0 with no block barrier (``csrc/
warp_chain.cuh`` says how).  This module holds its host side:

* ``warp_tables``: the march's constant tables — the streams, each stage's
  lag behind the loads, which stream a state plane is at each stage (the
  carry map as a renaming), each stream's ring depth — reckoned from the
  plan alone; the generated source holds them as constants;
* ``warp_geometry``: V (columns a lane), the lateral halo, the strips, the
  segments and their length, for a shape: from the built kernel's
  registers where given (``-Xptxas -v``, read on the card through
  ``psat_warp_regs``), else from an estimate of them (the route's
  reckoning before any build); raises ValueError where nothing fits;
* ``make_warp_chain_kernel``: the wrapper (``time_chain.make_chain_kernel(
  plan, "warp")``), which counts its launches on ``time_chain``'s
  counters under the design "warp".
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..field import Field
from .common import storage_shape
from .cuda_kernel import _DTYPES, tile_itemsize
from .launch import Ptrs, empty, real, run

__all__ = ["WarpTables", "warp_tables", "WarpGeometry", "warp_geometry",
           "make_warp_chain_kernel", "LOAD_AHEAD", "WARPS"]

LOAD_AHEAD = 2   # rows the loads run ahead of their first use (D)
WARPS = 4        # warps a block (psat_warp::kWarps)
NUM_SMS = 132    # the H100's SMs
REGS_PER_SM = 65536
MAX_WARPS_PER_SM = 64
# registers the estimate adds to the rings' (addresses, masks, temporaries)
REG_OVERHEAD = 40
MAX_REGS = 255
# the time model of warp_geometry, fitted to the in-turns comparison of
# every V on the H100 (PERF.md §6): a round of resident warps runs
# steps × (V + STEP_OVERHEAD) lane-work, at a rate that grows as
# min(warps, SAT_WARPS) ** WARP_EXPONENT
SAT_WARPS = 16
STEP_OVERHEAD = 0.5
WARP_EXPONENT = 1.5
MAX_PROBES = 4   # psat_warp::kMaxProbes


@dataclass
class WarpTables:
    """The march's constants (``struct PsatWarp``): ``nx`` streams — the
    ns loaded planes, then the hoisted planes, then each stage's outputs;
    ``lag[s]`` the rows stage s runs behind the loads (``lag[0]`` = 0);
    ``lh`` the hoisting pass's; ``smap[s][n]`` the stream state plane n is
    after stage s; ``ostr[s-1][o]`` stage s's output o; ``hstr[j]``
    hoisted plane j; ``need[x]`` the rows stream x must keep; ``p`` the
    ring period (the deepest need); ``lead`` the rows a segment starts
    above its first owned row; ``load``/``store`` the planes loaded and
    stored; ``probes`` the probes' state planes; ``reach`` the lateral
    reach a stage (``hreach`` the hoist's)."""

    nx: int
    lag: List[int]
    lh: int
    smap: List[List[int]]
    ostr: List[List[int]]
    hstr: List[int]
    need: List[int]
    p: int
    lead: int
    load: List[bool]
    store: List[bool]
    probes: List[int]
    reach: int
    hreach: int


def _reads(steps) -> List[Tuple[str, tuple, int]]:
    """(field, index, dim-0 offset) of each field read of ``steps``."""
    out = []
    for s in steps:
        for a in s.atoms:
            if isinstance(a, Field.Access):
                out.append((a.field.name, tuple(a.index), int(a.offsets[0])))
    return out


def warp_tables(plan, ahead: int = LOAD_AHEAD) -> WarpTables:
    """The march's tables for a 2D ``time_chain.ChainPlan``."""
    from .time_chain import access_reach

    if plan.program.ndim != 2:
        raise ValueError("the warp march runs 2D chains")
    k, keys = plan.k, plan.plane_keys
    ns, nout, nh = len(plan.planes), len(plan.out_planes), \
        len(plan.hoist_steps)
    (lof, hif), (hlo, hhi) = plan.reach, access_reach(plan.hoist_steps, 2)
    lh = ahead + hhi[0]
    lag = [0, max(ahead + hif[0], lh if nh else 0)]
    for _ in range(2, k + 1):
        lag.append(lag[-1] + hif[0])
    hstr = list(range(ns, ns + nh))
    ostr = [[ns + nh + s * nout + o for o in range(nout)] for s in range(k)]
    nx = ns + nh + k * nout
    prod = [0] * ns + [lh] * nh + [lag[s + 1] for s in range(k)
                                   for _ in range(nout)]
    smap = [list(range(ns))]
    for s in range(1, k + 1):
        row = []
        for n in range(ns):
            kind, i = plan.src_of(n)
            row.append(ostr[s - 1][i] if kind == "out" else smap[s - 1][i])
        smap.append(row)
    age: Dict[int, int] = {}

    def use(x, a):
        if a < 0:
            raise AssertionError(f"stream {x} read {-a} rows before it is "
                                 f"produced")
        age[x] = max(age.get(x, 0), a)

    slot = {key: n for n, key in enumerate(keys)}
    for name, idx, o in _reads(plan.hoist_steps):
        use(slot[(name, idx)], lh - o)
    cycle = _reads(plan.cycle_steps)
    for s in range(1, k + 1):
        for name, idx, o in cycle:
            x = smap[s - 1][slot[(name, idx)]]
            use(x, lag[s] - o - prod[x])
        for j in range(nh):
            use(hstr[j], lag[s] - lh)
    probes = [slot[(pname, ())] for pname, _ in plan.probes]
    for s in range(1, k + 1):
        for n in probes:
            use(smap[s][n], lag[s] - prod[smap[s][n]])
    store = [f.name not in plan.invariant for f, _ in plan.planes]
    for n in range(ns):
        if store[n]:
            use(smap[k][n], lag[k] - prod[smap[k][n]])
    need = [age.get(x, -1) + 1 for x in range(nx)]
    load = [need[n] > 0 for n in range(ns)]
    p = max(1, max(need))
    lead = k * lof[0] + (hlo[0] if nh else 0)
    reach = max(lof[1], hif[1])
    hreach = max(hlo[1], hhi[1]) if nh else 0
    return WarpTables(nx=nx, lag=lag, lh=lh, smap=smap, ostr=ostr,
                      hstr=hstr, need=need, p=p, lead=lead, load=load,
                      store=store, probes=probes, reach=reach, hreach=hreach)


@dataclass
class WarpGeometry:
    """A shape's march: ``v`` columns a lane, ``halo`` lateral columns a
    side, ``owned`` columns a strip owns (32·v − 2·halo), ``nstrip``
    strips, ``nseg`` segments of ``seg`` rows, ``steps`` march steps an
    item runs, ``items`` warps, ``regs`` a thread's registers (built, or
    estimated), ``warps_per_sm`` resident, ``owned_share`` of the cells
    an item computes that it owns."""

    v: int
    halo: int
    owned: int
    nstrip: int
    nseg: int
    seg: int
    steps: int
    items: int
    regs: int
    warps_per_sm: int
    owned_share: float
    cost: float

    def geo(self, spatial, wlo, whi, probe_rows) -> List[int]:
        """The int64 block the launcher reads (csrc/warp_chain.cu)."""
        return ([spatial[0], spatial[1], wlo[0], wlo[1], whi[0], whi[1],
                 self.seg, self.nstrip, self.items, self.owned, self.halo,
                 self.steps] + list(probe_rows))


def lane_widths(itemsize: int) -> Tuple[int, ...]:
    """The V a library instantiates: up to 16 bytes of 4- or 8-byte
    compute words (``tile_itemsize``), at most 4."""
    return (4, 2, 1) if itemsize <= 4 else (2, 1)


def estimate_regs(tab: WarpTables, v: int, itemsize: int) -> int:
    """A thread's registers at ``v`` columns a lane, estimated: every
    ring's live rows × v words, plus ``REG_OVERHEAD``."""
    words = 2 if itemsize == 8 else 1
    return sum(tab.need) * v * words + REG_OVERHEAD


def warp_geometry(plan, spatial, itemsize: int,
                  regs: Optional[Dict[int, Tuple[int, int]]] = None,
                  tab: Optional[WarpTables] = None,
                  lanes: Optional[int] = None) -> WarpGeometry:
    """The march at a shape: for each V (``lane_widths``) whose kernel
    takes at most ``MAX_REGS`` registers and spills nothing (``regs``:
    {V: (registers, local bytes)} of the built kernel; else the estimate,
    ``estimate_regs``) and whose strip owns columns (32·V > 2·halo), the
    segment count that minimises the modelled time — rounds of resident
    warps (``WARPS``-warp blocks, as many as the SMs' registers hold) ×
    the march steps of an item × (V + ``STEP_OVERHEAD``) (a step's work a
    lane) over an SM's rate, min(warps, ``SAT_WARPS``) **
    ``WARP_EXPONENT`` / warps —; the least-cost pick over V (``lanes``
    forces one).  Blocks are ``WARPS``
    warps, each warp its own item.  Raises ValueError
    where no V fits."""
    tab = tab or warp_tables(plan)
    n0, n1 = spatial
    if len(plan.probes) > MAX_PROBES:
        raise ValueError(f"at most {MAX_PROBES} probes")
    best = None
    for v in lane_widths(itemsize):
        if lanes is not None and v != lanes:
            continue
        if regs is not None:
            r, local = regs.get(v, (MAX_REGS + 1, 0))
            if local:
                continue
        else:
            r = estimate_regs(tab, v, itemsize)
        if r > MAX_REGS:
            continue
        halo = v * math.ceil((plan.k * tab.reach + tab.hreach) / v)
        owned = 32 * v - 2 * halo
        if owned < v:
            continue
        # a warp's registers are allocated 8 a thread at a time, a block's
        # warps all together
        regs_block = 32 * WARPS * 8 * math.ceil(max(r, 32) / 8)
        warps = min(MAX_WARPS_PER_SM, REGS_PER_SM // regs_block * WARPS)
        if warps < WARPS:
            continue
        nstrip = math.ceil(n1 / owned)
        slots = NUM_SMS * warps
        rate = min(warps, SAT_WARPS) ** WARP_EXPONENT / warps
        extra = tab.lead + tab.lag[-1]
        for nseg in range(1, n0 + 1):
            seg = math.ceil(n0 / nseg)
            if nseg > 1 and math.ceil(n0 / seg) != nseg:
                continue
            steps = tab.p * math.ceil((seg + extra) / tab.p)
            items = nstrip * nseg
            cost = (math.ceil(items / slots) * steps
                    * (v + STEP_OVERHEAD) / rate)
            if best is None or cost < best.cost:
                share = (n0 * n1) / (items * steps * 32 * v)
                best = WarpGeometry(v=v, halo=halo, owned=owned,
                                    nstrip=nstrip, nseg=nseg, seg=seg,
                                    steps=steps, items=items, regs=r,
                                    warps_per_sm=warps, owned_share=share,
                                    cost=cost)
            if items >= 8 * slots:
                break
    if best is None:
        raise ValueError(f"{plan.op.op_name}: no warp march fits k={plan.k} "
                         f"at {tuple(spatial)} ({itemsize}-byte elements)")
    return best


def make_warp_chain_kernel(plan, counter, lanes: Optional[int] = None):
    """``fn(state) -> (state, probe_list)`` through the warp march; same
    semantics as ``time_chain.plain_time_chain``, probe rows included.
    Chain-invariant state fields come back as the tensors given.  One
    library per float type holds the kernel at every V of
    ``lane_widths``; the wrapper reads their registers on the card at the
    first call and picks the geometry with them (``fn.geometry``;
    ``lanes`` forces V, for the in-turns comparison of the widths).
    Launches count on ``counter`` (``ops.time_chain``) keyed (op name, k,
    periodic, shape, itemsize, "warp")."""
    from ..codegen.cuda_printer import generate_warp_chain_source
    from .time_chain import _load_library, check_state, plane_args3

    tab = warp_tables(plan)
    libs: dict = {}
    regs: dict = {}
    geos: dict = {}
    name = f"{plan.program.name}_warp_chain"
    ghost = plan.program.ghost

    def library(dtype):
        lib = _load_library(
            libs, lambda dt: generate_warp_chain_source(plan, dt, tab),
            name, dtype)
        if dtype not in regs:
            lib.psat_warp_regs.argtypes = [ctypes.c_int, ctypes.c_void_p]
            lib.psat_warp_regs.restype = ctypes.c_int
            got = {}
            for v in lane_widths(8 if dtype == torch.float64 else 4):
                out = (ctypes.c_int * 2)()
                if lib.psat_warp_regs(v, out) == 0:
                    got[v] = (out[0], out[1])
            regs[dtype] = got
        return lib

    def fn(st: Dict[str, torch.Tensor]):
        a0, spatial = check_state(plan, st)
        outputs = {f.name: (st[f.name] if f.name in plan.invariant else
                            empty(storage_shape(f, spatial), a0.dtype,
                                  a0.device))
                   for f in plan.program.input_fields}
        stored = {n: t for n, t in outputs.items()
                  if n not in plan.invariant}
        probes = [empty((plan.k, spatial[-1]), a0.dtype, a0.device)
                  for _ in plan.probes]
        if any(n == 0 for n in spatial):
            return real(outputs), real(probes)
        lib = library(a0.dtype)
        key = (spatial, a0.dtype)
        if key not in geos:
            geos[key] = warp_geometry(plan, spatial, tile_itemsize(a0),
                                      regs[a0.dtype], tab, lanes)
        wg = fn.geometry = geos[key]
        wlo = [lo for lo, _ in ghost]
        whi = [n - hi for n, (_, hi) in zip(spatial, ghost)]
        geo = wg.geo(spatial, wlo, whi, [r for _, r in plan.probes])
        in_ptrs, in_st = _planes2(plan.planes, st, plane_args3)
        out_ptrs, out_st = _planes2(plan.planes, stored, plane_args3)
        probe_ptrs = Ptrs((p, 0) for p in probes)
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic), wg.v],
               [in_ptrs, in_st, out_ptrs, out_st, probe_ptrs, geo], a0,
               f"{name}: warp-march launch"):
            counter.LAUNCHES += 1
            counter.LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic,
                                  spatial, a0.element_size(), "warp")] += 1
        return real(outputs), real(probes)

    def library_regs(dtype):
        """{V: (registers, local bytes)} of the built kernel of a type."""
        library(dtype)
        return regs[dtype]

    fn.plan = plan
    fn.design = "warp"
    fn.tables = tab
    fn.regs = regs
    fn.library_regs = library_regs
    fn.geometry = None
    return fn


def _planes2(planes, tensors, plane_args3):
    """Pointers and (y, x) strides of each plane (``plane_args3`` without
    the z stride)."""
    ptrs, st3 = plane_args3(planes, tensors, 2)
    return ptrs, [st3[3 * i + d] for i in range(len(planes))
                  for d in (1, 2)] or [0, 0]
