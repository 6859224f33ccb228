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
  decompositions reject: the nonlinear ones.
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
depths, the lateral tile and the dim-0 segments from the reaches, as
``time_chain.pick_tile`` does for boxes; the choice of kernel comes from
that reckoning before any launch.  ``LAUNCHES`` counts launches of both
modes; ``LAUNCH_CALLS`` splits them by (op name, k, periodic, shape,
itemsize, mode).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .common import storage_shape
from .cuda_kernel import (_DTYPES, _check_inputs, _device_stream,
                          tile_itemsize)
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
# lateral tile candidates (y, x) and a forced dim-0 segment count (None:
# from the reckoning); tests patch them to get ragged multi-tile grids
TILE_Y = tuple(range(1, 33))
TILE_X = tuple(range(1, 65))
STREAM_SEGMENTS: Optional[int] = None


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


@dataclass
class StreamGeometry:
    """The march: stages F_1..F_k (and R_{k-1}..R_0 in two-phase mode),
    each with its lag and per-dim (lo, hi) extents around the owned tile;
    the rings' depths and offsets; the lateral tile, the dim-0 segments
    and the int64 block the launcher reads (``geo``, layout in
    csrc/plane_adjoint.cuh::parse_geo)."""

    tile: Tuple[int, int]
    nseg: int
    zlen: int
    smem: int  # bytes
    owned_share: float  # owned tile / the widest stage region
    lags: List[int]
    extents: List[Tuple[List[int], List[int]]]
    state_depth: List[int]  # ring of state s (index s; 0 unused)
    cot_depth: List[int]
    geo: List[int]


def _march(plan: ChainPlan, ap=None):
    """Lags, extents and ring depths (independent of the tile).  Stage X
    works on plane t − lag[X] at march step t, over the owned tile widened
    by extents[X]: F_k covers the owned tile; F_s what F_{s+1} reads
    (its region plus the forward reach) and, where the backward program
    reads saved primals, what R_s reads (R_s's region plus the backward
    reach); R_s covers the owned tile plus s backward reaches, what R_0
    reads through R_{s-1}.  Each stage lags its writers by their reach
    above it, so every plane it reads is computed earlier in the march (or
    earlier in the same step: stages run in list order); a ring is as deep
    as its readers' reach below plus their lag behind its writer."""
    k = plan.k
    lf, hf = plan.reach
    two = ap is not None
    lb, hb = ap.reach if two else ([0] * 3, [0] * 3)
    saved = two and bool(ap.saved_planes)
    ef = {k: ([0] * 3, [0] * 3)}
    for s in range(k - 1, 0, -1):
        lo = [ef[s + 1][0][d] + lf[d] for d in range(3)]
        hi = [ef[s + 1][1][d] + hf[d] for d in range(3)]
        if saved:
            lo = [max(lo[d], (s + 1) * lb[d]) for d in range(3)]
            hi = [max(hi[d], (s + 1) * hb[d]) for d in range(3)]
        ef[s] = (lo, hi)
    lag_f = {1: 0}
    for s in range(2, k + 1):
        lag_f[s] = lag_f[s - 1] + hf[0]
    lags = [lag_f[s] for s in range(1, k + 1)]
    extents = [ef[s] for s in range(1, k + 1)]
    state_depth, cot_depth = [0] * k, [0] * k
    for s in range(1, k):
        state_depth[s] = lag_f[s + 1] - lag_f[s] + lf[0] + 1
    if two:
        lag_r = {}
        for s in range(k - 1, -1, -1):
            lag = lag_r[s + 1] + hb[0] if s + 1 < k else 0
            if saved and s >= 1:
                lag = max(lag, lag_f[s] + hb[0])
            lag_r[s] = lag
        for s in range(k - 1, -1, -1):
            lags.append(lag_r[s])
            extents.append(([s * lb[d] for d in range(3)],
                            [s * hb[d] for d in range(3)]))
        for s in range(1, k):
            if saved:
                state_depth[s] = max(state_depth[s],
                                     lag_r[s] - lag_f[s] + lb[0] + 1)
            cot_depth[s] = lag_r[s - 1] - lag_r[s] + lb[0] + 1
    return lags, extents, state_depth, cot_depth


def _region(tile, ext) -> int:
    lo, hi = ext
    return (tile[0] + lo[1] + hi[1]) * (tile[1] + lo[2] + hi[2])


def stream_geometry(plan: ChainPlan, spatial: Sequence[int], itemsize: int,
                    ap=None) -> Optional[StreamGeometry]:
    """The streaming kernel's geometry for ``plan`` (two-phase with the
    ``AdjointPlan`` ``ap``, forward without), or None where no lateral
    tile's rings fit the shared memory a block may use while owning
    ``MIN_OWNED_SHARE`` of its widest stage region.

    The tile minimises the work per owned cell: every stage's region,
    rounded up to whole passes of the block's threads, weighted by its
    program's steps (the D3Q19 backward program has 1,687, its forward
    23); ties go to less shared memory, then to wider rows.  Where the
    lateral tiles alone give fewer than two blocks per SM, dim 0 is cut
    into segments no shorter than the march's own dim-0 halo.

    Reckoning, D3Q19 BGK k=2 float32 two-phase: forward reach 1, backward
    2 in every dim; F_1 covers the tile + 4 a side (what R_1 reads), R_1
    the tile + 2; the state_1 ring is 5 planes × 19 components over F_1's
    region and the cot_1 ring 5 × 19 over R_1's, 380·((t0+8)(t1+8) +
    (t0+4)(t1+4)) bytes; the picker takes a 9×14 tile (17×22 and 13×18
    regions, 231 KB, 0.34 owned; in float64 6×6, 0.18 owned).  The
    forward mode holds 3 planes of 19 over the tile + 2 a side: 27×33
    (0.88 owned) in float32."""
    if plan.program.ndim != 3:
        raise ValueError("the streaming chain kernel takes 3D domains")
    if not 1 <= plan.k <= MAX_K:
        return None
    lags, extents, sdep, cdep = _march(plan, ap)
    k = plan.k
    n_dyn = sum(f.name not in plan.invariant for f, _ in plan.planes)
    ns = len(plan.planes)
    w_fwd = len(plan.cycle_steps) + len(plan.hoist_steps)
    weights = [w_fwd] * k + ([len(ap.bwd.steps)] * k if ap is not None
                             else [])
    n0, n1, n2 = (int(n) for n in spatial)
    best = None
    for ty in TILE_Y:
        if ty > max(1, n1) and ty != TILE_Y[0]:
            continue
        for tx in TILE_X:
            if tx > max(1, n2) and tx != TILE_X[0]:
                continue
            tile = (ty, tx)
            regions = [_region(tile, e) for e in extents]
            elems = sum(sdep[s] * n_dyn * regions[s - 1]
                        for s in range(1, k))
            if ap is not None:
                elems += sum(cdep[s] * ns * regions[2 * k - 1 - s]
                             for s in range(1, k))
            smem = elems * itemsize
            share = ty * tx / max(regions)
            if smem > SMEM_BUDGET or share < MIN_OWNED_SHARE:
                continue
            work = sum(math.ceil(r / THREADS) * THREADS * w
                       for r, w in zip(regions, weights)) / (ty * tx)
            key = (work, smem, -tx)
            if best is None or key < best[0]:
                best = (key, tile, smem, share)
    if best is None:
        return None
    _, tile, smem, share = best
    nt = (math.ceil(n1 / tile[0]), math.ceil(n2 / tile[1]))
    tlo = min(lag - e[0][0] for lag, e in zip(lags, extents))
    thi = max(lag + e[1][0] for lag, e in zip(lags, extents))
    if STREAM_SEGMENTS is not None:
        nseg = STREAM_SEGMENTS
    else:
        want = math.ceil(2 * NUM_SMS / (nt[0] * nt[1]))
        nseg = max(1, min(want, n0 // max(1, thi - tlo)))
    nseg = max(1, min(nseg, n0))
    zlen = math.ceil(n0 / nseg)
    nseg = math.ceil(n0 / zlen)
    ghost = plan.program.ghost
    lb, hb = ap.reach if ap is not None else ([0] * 3, [0] * 3)
    geo = ([n0, n1, n2, k, len(lags), tile[0], tile[1], nt[0], nt[1], nseg,
            zlen] + [lo for lo, _ in ghost]
           + [n - hi for n, (_, hi) in zip(spatial, ghost)]
           + list(lb) + list(hb) + [tlo, thi, smem // itemsize])
    for lag, (lo, hi) in zip(lags, extents):
        geo += [lag] + list(lo) + list(hi)
    off = 0
    probes = []
    for pname, prow in plan.probes:
        probes += [plan.plane_keys.index((pname, ()))] + list(
            probe_index(prow, spatial))
    for s in range(k):
        soff = off
        if s >= 1:
            off += sdep[s] * n_dyn * _region(tile, extents[s - 1])
        coff = off
        if s >= 1 and ap is not None:
            off += cdep[s] * ns * _region(tile, extents[2 * k - 1 - s])
        geo += [soff, sdep[s], coff, cdep[s]]
    geo += [len(plan.probes)] + probes
    return StreamGeometry(tile=tile, nseg=nseg, zlen=zlen, smem=smem,
                          owned_share=share, lags=lags, extents=extents,
                          state_depth=sdep, cot_depth=cdep, geo=geo)


def _launcher(plan: ChainPlan, ap, mode: str):
    """``launch(a0, spatial, ptr_sets) -> None`` for one mode: the library
    of each float type is built at its first use, the geometry reckoned
    once per (shape, itemsize)."""
    from ..codegen.cuda_printer import generate_plane_source

    libs: Dict[torch.dtype, dict] = {}
    geos: Dict[tuple, StreamGeometry] = {}
    name = (f"{plan.program.name}_plane_{mode}_"
            f"{'periodic' if plan.periodic else 'bounded'}")

    reaches = [plan.reach] + ([ap.reach] if ap is not None else [])
    reach = [max(r[side][d] for r in reaches for side in (0, 1))
             for d in range(3)]

    def launch(a0, spatial, ptr_sets, probes=()):
        global LAUNCHES
        key = (spatial, tile_itemsize(a0))
        if plan.periodic and any(n < r for n, r in zip(spatial, reach)):
            # the kernel wraps a read with one add or subtract
            raise ValueError(f"{plan.op.op_name}: periodic extents "
                             f"{spatial} must cover the stencil reach "
                             f"{reach}")
        if key not in geos:
            sg = stream_geometry(plan, spatial, tile_itemsize(a0), ap)
            if sg is None:
                raise ValueError(
                    f"{plan.op.op_name}: no streaming tile fits "
                    f"{SMEM_BUDGET} bytes of shared memory at k={plan.k} "
                    f"({tile_itemsize(a0)}-byte elements, shape {spatial}); "
                    f"use a smaller k")
            geos[key] = sg
        dtype = str(a0.dtype).replace("torch.", "")
        lib = _load_library(
            libs.setdefault(a0.dtype, {}),
            lambda: generate_plane_source(ap if ap is not None else plan,
                                          mode, dtype),
            f"{name}_{dtype}", "psat_plane_launch", 12)
        geo = geos[key].geo
        geo_arr = (ctypes.c_int64 * len(geo))(*geo)
        device, stream = _device_stream(a0)
        args = [a for pair in ptr_sets for a in pair]
        probe_ptrs = (ctypes.c_void_p * max(1, len(probes)))(
            *[t.data_ptr() for t in probes])
        fwd_mode = mode == "forward"
        rc = lib.psat_plane_launch(_DTYPES[a0.dtype], int(plan.periodic),
                                   device, *args,
                                   probe_ptrs if fwd_mode else None,
                                   None if fwd_mode else probe_ptrs,
                                   geo_arr, stream)
        if rc != 0:
            raise RuntimeError(
                f"{name}: CUDA streaming launch failed: "
                f"{lib.psat_error_string(rc).decode()} (code {rc})")
        LAUNCHES += 1
        LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic, spatial,
                      a0.element_size(), mode)] += 1

    return launch


def _outputs(plan: ChainPlan, state, a0, spatial):
    """state_k tensors (chain-invariant planes: the tensors given) and the
    ones the kernel writes."""
    new = {f.name: (state[f.name] if f.name in plan.invariant else
                    torch.empty(storage_shape(f, spatial), dtype=a0.dtype,
                                device=a0.device))
           for f in plan.program.input_fields}
    return new, {n: t for n, t in new.items() if n not in plan.invariant}


def make_plane_adjoint_kernel(ap):
    """``fn(state, cots) -> (state_k, cot_0)`` through the streaming kernel
    in two-phase mode; same semantics as
    ``ops.adjoint_chain.plain_chain_vjp``, probe cotangents included."""
    from .adjoint_chain import check_probe_cots

    plan = ap.fwd
    launch = _launcher(plan, ap, "two_phase")

    def fn(state, cots, probe_cots=()):
        a0, spatial = check_state(plan, state)
        _check_inputs(plan.program, cots)
        pcs = check_probe_cots(plan, probe_cots, a0, spatial)
        new_state, stored = _outputs(plan, state, a0, spatial)
        cot0 = {f.name: torch.empty(storage_shape(f, spatial),
                                    dtype=a0.dtype, device=a0.device)
                for f in plan.program.input_fields}
        if any(n == 0 for n in spatial):
            return new_state, cot0
        launch(a0, spatial, [plane_args3(plan.planes, t, 3)
                             for t in (state, stored, cots, cot0)], pcs)
        return new_state, cot0

    fn.plan = ap
    return fn


def make_plane_chain_kernel(plan: ChainPlan):
    """``fn(state) -> (state_k, probe_list)`` through the streaming kernel
    in forward mode; same semantics as
    ``ops.time_chain.plain_time_chain``."""
    launch = _launcher(plan, None, "forward")
    if any(p in plan.invariant for p, _ in plan.probes):
        raise NotImplementedError(
            f"{plan.op.op_name}: the streaming kernel records probes of "
            f"carried state fields only")

    def fn(state):
        a0, spatial = check_state(plan, state)
        new_state, stored = _outputs(plan, state, a0, spatial)
        probes = [torch.empty((plan.k, spatial[-1]), dtype=a0.dtype,
                              device=a0.device) for _ in plan.probes]
        if any(n == 0 for n in spatial):
            return new_state, probes
        no_cots = plane_args3(plan.planes, {}, 3)
        launch(a0, spatial, [plane_args3(plan.planes, state, 3),
                             plane_args3(plan.planes, stored, 3),
                             no_cots, no_cots], probes)
        return new_state, probes

    fn.plan = plan
    return fn
