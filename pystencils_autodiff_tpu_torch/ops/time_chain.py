"""Temporal blocking: k time steps of a stencil op fused into one kernel.

The port of ``pystencils_autodiff_tpu/ops/time_chain.py``.
``fused_time_chain(op, k, carry_map)`` advances a state dict k steps per
call: on CUDA tensors through the hand-written chain kernel
(``csrc/time_chain.cuh``, the counterpart of the Pallas kernels
``_make_chain_kernel_fn`` in 2D and ``plane_chain.py::
make_plane_chain_kernel_fn`` in 3D), on CPU tensors through the plain
version (``plain_time_chain``: k single steps of ``ops.torch_ref``).  Both
have the sequential semantics of ``timeloop.make_time_stepper``: each stage
is one interior-mode (or periodic) step, zero on the ghost frame, followed
by the carry map.

``probes=[(field, row)]`` records that row of the (scalar) field after
every stage — per-step observables such as an FWI seismogram survive the
blocking; the chain then returns ``(state, probes)`` with one ``(k, cols)``
tensor per probe.  In 3D ``row`` is a row of the state flattened to
(n0·n1, n2), as in the JAX package: the line ``(i0, i1) = divmod(row, n1)``
along the last dim (``probe_index``).  3D periodic chains take no probes,
as in the JAX package, whose flattened-row kernel wraps 2D only.

Gradients: the chain is the ``psat::chain`` custom op (``ChainEntry``,
``ops/custom_ops.py``).  Its backward either recomputes the k steps with
the single-step op under ``torch.enable_grad`` and pulls back through
them (``fused_bwd=False``, the counterpart of the JAX ``bwd_rule``), or
runs ONE fused adjoint chain (``ops.adjoint_chain.fused_chain_vjp``,
``fused_bwd=True``, the ``psat::chain_bwd`` op).

Kernel scope: 2D and 3D domains, float32/float64/bfloat16 (bf16 stored,
computed in float), scalar and
index-component fields (as per-plane pointers and strides), bounded or
periodic in every dim.  The design comes from the host reckonings
(``forward_design``): a 2D chain (row 6) runs the first of
``DESIGNS_2D`` that fits — the warp march (``ops.warp_chain``,
``csrc/warp_chain.cuh``), the box, the dim-0 march's forward mode; a 3D
chain (row 7) the forward mode of the dim-0 march (``ops.stage_march``,
``csrc/stage_march.cuh``, over the chain as a one-stage cycle, probe
lines recorded in the march) where a march fits — for a chain no box
holds (D3Q19), only where it owns ``STREAM_SHARE[itemsize]`` of what
the z-streaming kernel owns —, else the box, else the z-streaming kernel's
forward mode (``ops.plane_adjoint``, which counts those launches);
``make_chain_kernel(plan, design=)`` forces one.  Where no design fits at
depth k, the depth ladder (``forward_route``, as the JAX package's TPU
dispatch does) runs k/kk launches of the deepest kk-deep chain that fits,
and k single steps where none does.
``LAUNCHES`` counts the launches of the box, the march and the warp
kernels and ``LAUNCH_CALLS`` splits them by (op name, k, periodic, shape,
itemsize, design).
"""

from __future__ import annotations

import itertools
import math
import re
import sys
from collections import Counter
from functools import partial
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..field import Field
from .common import (StencilProgram, check_ported, field_components,
                     forward_program, storage_shape)
from . import custom_ops
from .cuda_kernel import (_DTYPES, DTYPE_NAMES, _check_inputs,
                          _plane_args, on_device,
                          tile_itemsize)
from .hoist import invariant_fields, plan_hoisting
from .launch import Ptrs, empty, real, run
from ..utils.config import log_lowering_decision
from .torch_ref import make_shard_stencil, make_torch_stencil

__all__ = ["fused_time_chain", "plain_time_chain", "make_chain_kernel",
           "forward_design", "two_phase_design", "fitting_designs",
           "chain_plan", "reset_launch_counts", "LAUNCHES", "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()

MAX_K = 32  # kMaxK in csrc/time_chain.cuh (schedule tables)
MAX_PROBES = 4  # kMaxProbes
# shared memory a block may use on the H100, and an SM's (each resident
# block also takes 1 KB of the SM's)
SMEM_BUDGET = 232448
SM_SMEM = 233472
# a tile must own at least this share of its extended tile: below it the
# halo's redundant work passes 9× the owned work (3D boxes at k=4), and the
# picker raises so that the caller takes a smaller k
MIN_OWNED_SHARE = 0.1
TILE_ROWS = (8, 16, 24, 32, 48, 64)
TILE_COLS = (32, 64, 96, 128)
# the forward chain's block shape and tile objective (pick_tile), by
# spatial dims: 2D runs 8-row (256-thread) blocks on tiles picked for 3
# resident blocks per SM; a 3D box's halo wraps six faces, so there the
# owned share alone decides, and one large tile per SM gets 32 rows (1024
# threads).  The adjoint kernels always run 32 rows.
FWD_BLOCKS_PER_SM = {2: 3, 3: 1}
FWD_BLOCK_ROWS = {2: 8, 3: 32}
ADJ_BLOCK_ROWS = 32
# a 3D forward chain no box holds runs the march only where it owns at
# least this share of what the z-streaming kernel owns (forward_design),
# by the itemsize of the tiles: the march's time per computed cell over
# the streaming kernel's, measured on D3Q19 (H100; PERF.md §6, PR 10:
# 0.47 and 0.54 in float32, 0.73 in float64), rounded up
STREAM_SHARE = {4: 0.55, 8: 0.75}
# 3D box tiles (z, y, x); TILE_COLS_3D None: the owned widths whose
# extended width fills whole warps (32·m − halo)
TILE_DEPTH_3D = (1, 2, 4, 8, 16)
TILE_ROWS_3D = (4, 8, 16, 32)
TILE_COLS_3D = None


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def access_reach(steps, nd: int, pick=None) -> Tuple[List[int], List[int]]:
    """Per-dim (lo, hi) reach of every field access of ``steps`` (only of
    the accesses to fields ``pick(field)`` accepts, when given)."""
    lo, hi = [0] * nd, [0] * nd
    for s in steps:
        for a in s.atoms:
            if isinstance(a, Field.Access) and (pick is None
                                                or pick(a.field)):
                for d, o in enumerate(a.offsets):
                    lo[d] = max(lo[d], -int(o))
                    hi[d] = max(hi[d], int(o))
    return lo, hi


@dataclass
class ChainPlan:
    """What the chain kernels and their plain versions share: the forward
    program, the state planes, the carry, hoisting and the probes."""

    op: object
    program: StencilProgram
    k: int
    periodic: bool
    probes: List[Tuple[str, int]]
    in_names: List[str]
    planes: List[Tuple[Field, tuple]]  # state planes (kernel slots)
    out_planes: List[Tuple[Field, tuple]]
    next_src: Dict[str, str]
    invariant: set
    hoist_steps: list
    cycle_steps: list
    reach: Tuple[List[int], List[int]]
    # one block of a sharded domain (ops.flatten.ShardSpec): the 3D
    # kernels' shard mode (parallel.ShardedChain's plane route)
    shard: object = None

    @property
    def plane_keys(self):
        return [(f.name, idx) for f, idx in self.planes]

    def src_of(self, n: int):
        """Where state plane ``n`` comes from after a stage: ('out', o) or
        ('in', m)."""
        f, idx = self.planes[n]
        src = self.next_src[f.name]
        out_keys = [(g.name, i) for g, i in self.out_planes]
        if (src, idx) in out_keys:
            return "out", out_keys.index((src, idx))
        return "in", self.plane_keys.index((src, idx))


def chain_plan(op, k: int, carry_map: Dict[str, str], periodic: bool,
               probes=None, shard=None) -> ChainPlan:
    from ..timeloop import check_carry_map

    prog = forward_program(op)
    check_ported(prog)
    if shard is not None:
        if prog.ndim != 3:
            raise ValueError(f"{op.op_name}: a sharded time chain is 3D "
                             f"(2D sharded chains run the stage chain)")
        if 2 in shard.sharded_dims:
            raise ValueError("the lane dim (2) cannot be sharded")
        if probes:
            raise NotImplementedError(f"{op.op_name}: sharded chains take no "
                                      f"probes")
    if prog.ndim == 1:
        # as the JAX package: its flattened-row chain kernel finds no tile
        # for a 1D domain's one row ("no viable tile for rows=1")
        raise NotImplementedError(
            f"{op.op_name}: fused chains take 2 or more spatial dims, not "
            f"1D (the JAX package's fused_time_chain refuses 1D domains "
            f"too); run the op's own steps (timeloop.make_time_stepper)")
    if prog.ndim == 3 and probes and periodic:
        raise NotImplementedError(
            f"{op.op_name}: 3D periodic chains take no probes (the JAX "
            f"package raises there too: its flattened-row kernel wraps 2D "
            f"domains only)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"chain depth k={k} must be in [1, {MAX_K}]")
    if prog.accum_fields:
        raise NotImplementedError(
            f"{op.op_name}: accumulation (+=) outputs in a chained forward "
            f"program are not supported")
    check_carry_map(op, carry_map)
    in_names = [f.name for f in op.forward_input_fields]
    fields_by_name = {f.name: f for f in op.forward_input_fields}
    probes = [(str(n), int(r)) for n, r in (probes or ())]
    if len(probes) > MAX_PROBES:
        raise ValueError(f"at most {MAX_PROBES} probes")
    for pname, _ in probes:
        if pname not in fields_by_name:
            raise ValueError(f"probe field {pname!r} is not a state field")
        if fields_by_name[pname].index_shape:
            raise ValueError(f"probe field {pname!r} must be scalar")
    for f in op.forward_input_fields:
        if f.layout != tuple(range(f.spatial_dimensions)):
            raise ValueError(f"{op.op_name}: fused chains need row-major "
                             f"spatial layouts; {f.name!r} has {f.layout}")
    out_names = [f.name for f in prog.output_fields]
    inv = invariant_fields(in_names, out_names, carry_map)
    hoist_steps, cycle_steps = plan_hoisting(prog.steps, inv)
    planes = [(f, idx) for f in prog.input_fields
              for idx in field_components(f)]
    out_planes = [(f, idx) for f in prog.output_fields
                  for idx in field_components(f)]
    return ChainPlan(op=op, program=prog, k=k, periodic=periodic,
                     probes=probes, in_names=in_names,
                     planes=planes, out_planes=out_planes,
                     next_src={n: carry_map.get(n, n) for n in in_names},
                     invariant=inv, hoist_steps=hoist_steps,
                     cycle_steps=cycle_steps,
                     reach=access_reach(prog.steps, prog.ndim), shard=shard)


# ---------------------------------------------------------------------------
# Plain version: k single steps of the plain PyTorch lowering.

def probe_index(row: int, spatial) -> tuple:
    """The index of probe row ``row`` of a state of shape ``spatial``: the
    row itself in 2D, the line ``divmod(row, n1)`` along the last dim in 3D
    (the JAX package's flattened rows, ``ops/flatten.py::FlatGeom``)."""
    return tuple(int(i) for i in np.unravel_index(row, spatial[:-1]))


def plain_time_chain(plan: ChainPlan):
    """``fn(state, bases=None) -> (state, probe_list)``: k applications of
    the port's plain single step (interior or periodic), the carry map and
    the probe rows after every stage.  A sharded plan (``plan.shard``)
    steps one halo-extended block at base offsets ``bases`` with global
    masks (``torch_ref.make_shard_stencil``): the plain version of the 3D
    kernels' shard mode."""
    if plan.shard is None:
        step = make_torch_stencil(plan.program, periodic=plan.periodic)
    else:
        shard_step = make_shard_stencil(plan.program, plan.periodic,
                                        plan.shard)

    def fn(state: Dict[str, torch.Tensor], bases=None):
        st = {n: state[n] for n in plan.in_names}
        recs: List[list] = [[] for _ in plan.probes]
        for _ in range(plan.k):
            outs = step(st) if plan.shard is None else shard_step(st, bases)
            env = {**st, **outs}
            st = {n: env[plan.next_src[n]] for n in plan.in_names}
            for p, (pname, prow) in enumerate(plan.probes):
                recs[p].append(st[pname][probe_index(prow, st[pname].shape)])
        return st, [torch.stack(r) for r in recs]

    return fn


# ---------------------------------------------------------------------------
# The CUDA kernel.

def carry_schedule(plan: ChainPlan, keep: Sequence[int] = ()):
    """Shared-memory buffer of every state plane at every stage.

    State planes live in a pool of tile-sized buffers; a stage writes its
    outputs into free buffers, and the carry map only renames buffers
    (u_prev ← u_curr costs no copy).  ``keep``: state planes whose buffer
    at every stage stays live to the end (the primal planes the two-phase
    adjoint reads back).  Returns ``(sbuf, obuf, npool)``: ``sbuf[s][n]``
    for s = 0..k, ``obuf[s][o]`` for s = 0..k-1."""
    ns, nout = len(plan.planes), len(plan.out_planes)
    srcs = [plan.src_of(n) for n in range(ns)]
    sb = list(range(ns))
    sbuf, obuf, npool, pinned = [sb], [], ns, set()
    for _ in range(plan.k):
        pinned |= {sb[n] for n in keep}
        live = set(sb) | pinned
        free = [b for b in range(npool) if b not in live]
        outs = []
        for _o in range(nout):
            if free:
                outs.append(free.pop(0))
            else:
                outs.append(npool)
                npool += 1
        obuf.append(outs)
        sb = [outs[i] if kind == "out" else sb[i] for kind, i in srcs]
        sbuf.append(sb)
    return sbuf, obuf, npool


def pick_tile(halo: Sequence[Tuple[int, int]], n_planes: int,
              itemsize: int, spatial: Sequence[int], blocks_per_sm: int = 1,
              owned_planes: int = 0, cols: Sequence[int] = ()):
    """``best_tile``, raising where no tile fits."""
    best = best_tile(halo, n_planes, itemsize, spatial, blocks_per_sm,
                     owned_planes, cols)
    if best is None:
        raise ValueError(
            f"no chain tile fits {SMEM_BUDGET} bytes of shared memory with "
            f"{n_planes} planes and halo {tuple(halo)} ({itemsize}-byte "
            f"elements) and owns {MIN_OWNED_SHARE} of its extended tile; "
            f"use a smaller k")
    return best


def best_tile(halo: Sequence[Tuple[int, int]], n_planes: int,
              itemsize: int, spatial: Sequence[int], blocks_per_sm: int = 1,
              owned_planes: int = 0, cols: Sequence[int] = ()):
    """The owned tile (one extent per dim) whose ``n_planes`` planes over
    the extended (halo-padded) tile, plus ``owned_planes`` planes over the
    owned tile, fit the per-block shared memory and that maximises the
    owned share of its extended tile times ``min(b, blocks_per_sm) /
    blocks_per_sm``, b the blocks that fit one SM's shared memory; ties go
    to the smaller footprint.  ``halo`` = ((lo, hi) per dim).  Returns
    ``(tile, extended, smem bytes)``, or None when no tile fits and owns
    at least ``MIN_OWNED_SHARE`` of its extended tile.  2D tiles
    are ``TILE_ROWS`` × ``TILE_COLS``, 3D boxes ``TILE_DEPTH_3D`` ×
    ``TILE_ROWS_3D`` × ``TILE_COLS_3D``.

    ``blocks_per_sm``: the forward chain spends most of its time loading
    and storing planes, which overlaps only across the blocks resident on
    an SM — 3 there; the adjoint kernels are dominated by their reverse
    stages, so the owned share alone decides — 1 (tile sweeps on the H100,
    PERF.md).  ``cols``: more owned widths to try in 2D (the stage adjoint's
    wide state needs narrower tiles).

    Reckoning, wave two-phase adjoint k=4 float32: halo 4·(1+1) = 8 per
    side, a 32×32 tile extends to 48×48 (9 KB a plane) and 13 planes are
    live (6 pool buffers: u_curr at every stage, u_prev, c; 1 hoisted
    (dt·c)²; 2×3 cotangents) — 120 KB, under the 227 KB a block may use;
    the picker prefers 32×64 there (195 KB, 0.53 of the extended tile
    owned).  Diffusion3d forward chain k=2 float32: halo 2 per side, 3 pool
    buffers + 6 hoisted face factors; an 8×8×32 box extends to 12×12×36
    (187 KB, 0.40 owned)."""
    nd = len(spatial)
    if nd == 2:
        cands = (TILE_ROWS, tuple(cols) + tuple(TILE_COLS))
    else:
        # None: owned widths whose extended width fills whole warps
        hx = halo[2][0] + halo[2][1]
        cols = TILE_COLS_3D or tuple(32 * m - hx for m in (1, 2, 4)
                                     if 32 * m > hx)
        cands = (TILE_DEPTH_3D, TILE_ROWS_3D, cols)
    caps = [max(8 if d < nd - 1 else 32, 2 * n)
            for d, n in enumerate(spatial)]
    if nd == 3:
        caps[0] = max(1, 2 * spatial[0])
    best = None
    for tile in itertools.product(*cands):
        if any(t > c for t, c in zip(tile, caps)):
            continue
        ext = tuple(t + lo + hi for t, (lo, hi) in zip(tile, halo))
        owned = math.prod(tile)
        smem = (n_planes * math.prod(ext) + owned_planes * owned) * itemsize
        if smem > SMEM_BUDGET or owned < MIN_OWNED_SHARE * math.prod(ext):
            continue
        resident = min(SM_SMEM // (smem + 1024), blocks_per_sm)
        key = (owned / math.prod(ext) * resident / blocks_per_sm, -smem)
        if best is None or key > best[0]:
            best = (key, (tile, ext, smem))
    return None if best is None else best[1]


def check_state(plan: ChainPlan, state):
    """The kernels' input checks (``cuda_kernel._check_inputs``: CUDA
    tensors, float32/float64/bfloat16, one spatial shape) plus the probe
    rows."""
    a0, spatial = _check_inputs(plan.program, state)
    rows = math.prod(spatial[:-1])
    for _, prow in plan.probes:
        if not 0 <= prow < rows:
            raise ValueError(f"probe row {prow} outside [0, {rows})")
    return a0, tuple(spatial)


def _zyx(values, nd: int, fill: int) -> List[int]:
    """Per-dim values in the kernels' (z, y, x) order: a 2D domain is
    (1, n0, n1), so its leading dim gets ``fill``."""
    return [fill] * (3 - nd) + [int(v) for v in values]


def _chain_halo_planes(plan: ChainPlan, halo_reach, keep, extra_planes):
    """(halo per dim, planes over the extended tile) of a chain kernel:
    k·``halo_reach`` a side (default: the forward reach), and the pool,
    hoisted and ``extra_planes`` planes."""
    nd, k = plan.program.ndim, plan.k
    rlo, rhi = halo_reach or plan.reach
    _, _, npool = carry_schedule(plan, keep)
    return ([(k * rlo[d], k * rhi[d]) for d in range(nd)],
            npool + len(plan.hoist_steps) + extra_planes)


def chain_tile(plan: ChainPlan, spatial, itemsize: int, *, halo_reach=None,
               keep=(), extra_planes: int = 0, owned_planes: int = 0,
               blocks_per_sm: int = 3, **_):
    """``chain_geometry``'s tile reckoning alone (``best_tile``): the
    ``(tile, extended, smem)`` it would pick, or None where none fits."""
    halo, n_planes = _chain_halo_planes(plan, halo_reach, keep, extra_planes)
    return best_tile(halo, n_planes, itemsize, spatial, blocks_per_sm,
                     owned_planes)


def chain_geometry(plan: ChainPlan, spatial, itemsize: int, *,
                   halo_reach=None, second_reach=None, keep=(),
                   extra_planes: int = 0, owned_planes: int = 0,
                   blocks_per_sm: int = 3, block_rows: int = ADJ_BLOCK_ROWS):
    """Tile, schedule and the int64 geometry block the launchers read
    (layout in csrc/time_chain.cuh::parse_geo).

    The halo is k·``halo_reach`` per dim and side (default: the forward
    reach); ``second_reach`` is the backward program's reach (two-phase)
    or the cotangent op's (twin-with-accumulation); ``keep`` the state
    planes whose every stage stays live (``carry_schedule``);
    ``extra_planes`` planes over the extended tile and ``owned_planes``
    over the owned tile follow the pool and hoisted planes in shared
    memory; blocks are 32 × ``block_rows`` threads.  Returns
    ``(geo, (tile, extended, smem))``."""
    nd, k = plan.program.ndim, plan.k
    lof, hif = plan.reach
    lob, hib = second_reach or ([0] * nd, [0] * nd)
    halo, n_planes = _chain_halo_planes(plan, halo_reach, keep, extra_planes)
    sbuf, obuf, npool = carry_schedule(plan, keep)
    hlo, hhi = access_reach(plan.hoist_steps, nd)
    tile, ext, smem = pick_tile(halo, n_planes, itemsize, spatial,
                                blocks_per_sm, owned_planes)
    ghost = plan.program.ghost
    geo = (_zyx(spatial, nd, 1) + [k] + _zyx(tile, nd, 1) + _zyx(ext, nd, 1)
           + _zyx([lo for lo, _ in halo], nd, 0)
           + _zyx(lof, nd, 0) + _zyx(hif, nd, 0)
           + _zyx(lob, nd, 0) + _zyx(hib, nd, 0)
           + _zyx([lo for lo, _ in ghost], nd, 0)
           + _zyx([n - hi for n, (_, hi) in zip(spatial, ghost)], nd, 1)
           + _zyx(hlo, nd, 0) + _zyx(hhi, nd, 0)
           + [npool, n_planes, owned_planes, block_rows, len(plan.probes)])
    for pname, prow in plan.probes:
        # (state plane, z, y) of the line: z = 0 in 2D
        geo += ([plan.plane_keys.index((pname, ()))] + [0] * (3 - nd)
                + list(probe_index(prow, spatial)))
    geo += [b for row in sbuf for b in row]
    geo += [b for row in obuf for b in row]
    return geo, (tile, ext, smem)


def box_tile(plan: ChainPlan, spatial, itemsize: int):
    """The forward chain kernel's box reckoning (``chain_geometry`` as
    the box kernel calls it), or None where no box fits."""
    nd, k = plan.program.ndim, plan.k
    lof, hif = plan.reach
    _, _, npool = carry_schedule(plan)
    return best_tile([(k * lof[d], k * hif[d]) for d in range(nd)],
                     npool + len(plan.hoist_steps), itemsize, spatial,
                     FWD_BLOCKS_PER_SM[nd])


def plane_args3(planes, tensors, nd: int):
    """``cuda_kernel._plane_args`` with three (z, y, x) strides per plane,
    as the chain kernels take them (z = 0 for a 2D domain); a plane whose
    field is missing from ``tensors`` gets a null pointer."""
    ptrs, strides = Ptrs(), []
    for f, idx in planes:
        if f.name not in tensors:
            ptrs.append((None, 0))
            strides += [0, 0, 0]
            continue
        p, st = _plane_args([(f, idx)], tensors, nd)
        ptrs += p
        strides += _zyx(list(st), nd, 0)
    return ptrs, strides or [0, 0, 0]


def _load_library(state: dict, source_fn, name: str, dtype=None):
    """The library of ``source_fn()`` (built at its first use).  With
    ``dtype`` (a ``torch.dtype``) the library is one float type's:
    ``state`` keeps one per type and ``source_fn`` takes the type's
    name."""
    if dtype is not None:
        name = f"{name}_{DTYPE_NAMES[dtype]}"
        state = state.setdefault(dtype, {})
        source_fn = partial(source_fn, DTYPE_NAMES[dtype])
    if "lib" not in state:
        from ..codegen.nvcc import compile_and_load

        state["lib"] = compile_and_load(source_fn(), re.sub(r"\W", "_", name))
    return state["lib"]


def forward_design(plan: ChainPlan, spatial, itemsize: int, warp_regs=None):
    """The forward chain's design at a shape, from the host reckonings
    alone (``fitting_designs``; ``warp_regs`` as it takes it), or None
    where no design fits (the ladder of ``forward_route`` then takes a
    shallower chain).

    2D: the first of ``DESIGNS_2D`` that fits — the warp march
    (``ops.warp_chain``, ``csrc/warp_chain.cuh``), then the box, then the
    dim-0 march's forward mode: the order of the three designs' times in
    turns (PERF.md §6: the warp march 1.5–3.0× faster than the box
    and the march on every measured 2D chain).

    3D: the dim-0 march's forward mode ("march") where a march fits and
    either a box fits too (a chain of few planes: the march owns more of
    its tile than the box) or the march owns at least
    ``STREAM_SHARE[itemsize]`` of what the z-streaming kernel owns; else
    the box ("box") where one fits; else the z-streaming kernel's forward
    mode ("stream") where it fits.  The share is the march's time per
    computed cell over the streaming kernel's: the two designs break even
    where the owned shares stand in that ratio.  D3Q19 (PERF.md §6, PR
    10), owned shares march / stream: k=2 256³ f32 0.762 / 0.878 (0.87),
    the march 1.62× faster; k=4 256³ f32 0.327 / 0.49 (0.67), the march
    1.43× faster; k=2 128³ f64 0.533 / 0.83 (0.64), the streaming kernel
    1.15× faster — in f64 the march costs more per computed cell (0.73 of
    the streaming kernel's, against 0.47–0.54 in f32)."""
    fits = fitting_designs(plan, spatial, itemsize, warp_regs)
    if plan.program.ndim == 2:
        return next((d for d in DESIGNS_2D if d in fits), None)
    march, stream = fits.get("march"), fits.get("stream")
    share = STREAM_SHARE[8 if itemsize >= 8 else 4]
    if march is not None and "box" not in fits and stream is not None \
            and march < share * stream:
        march = None
    if march is not None:
        return "march"
    return next((d for d in ("box", "stream") if d in fits), None)


def two_phase_design(ap, spatial, itemsize: int, wanted=None):
    """The fused value+gradient's design of a sharded 3D single-op chain
    (row 9s: ``parallel.ShardedChain``'s fused backward on one
    halo-extended block; ``ap`` an ``adjoint_chain.AdjointPlan``) at a
    block shape, from the host reckonings alone: the two-phase mode of
    the dim-0 march ("march", ``adjoint_chain.make_chain_march_kernel``
    in shard mode) where a march of ``stage_march.chain_march_plans(
    ap.fwd, wanted)`` fits; else the z-streaming kernel's two-phase mode
    ("stream", ``plane_adjoint.make_plane_adjoint_kernel``) where it
    fits; else None.  ``wanted``: the invariant fields whose gradient is
    asked for (the march accumulates no other).  No share is weighed
    against the streaming kernel's, as ``forward_design`` weighs
    ``STREAM_SHARE``: that ratio was fitted to the forward mode, and on
    config #2's κ block, 200² × 384 f32 (k=2 on a 2×2 split of 384³),
    the march takes 0.24 of the streaming kernel's time on an H100
    (PERF.md, row 9s), though it owns 0.88 of the streaming kernel's
    share of its tile.  Path C's D3Q19 f64 block 76² × 128: no march
    fits, "stream"."""
    from .plane_adjoint import stream_geometry
    from .stage_march import chain_march_plans, stage_march_geometry

    try:
        sp, sap = chain_march_plans(ap.fwd, wanted)
        stage_march_geometry(sp, spatial, itemsize, sap)
        return "march"
    except ValueError:
        pass
    return ("stream" if stream_geometry(ap.fwd, spatial, itemsize, ap)
            is not None else None)


def fitting_designs(plan: ChainPlan, spatial, itemsize: int,
                    warp_regs=None) -> dict:
    """The forward chain's designs that fit a shape, each with the share
    of its tile it owns (None for the box, whose reckoning keeps only
    tiles above ``MIN_OWNED_SHARE``): "march" where
    ``stage_march_geometry`` of ``chain_stage_plan`` finds one and no
    probe is of an invariant field (the march records carried fields
    only), "box" where ``box_tile`` finds one; 2D: "warp" where
    ``warp_chain.warp_geometry`` finds one (from the built kernel's
    registers where ``warp_regs(plan)`` gives them, as on the card; else
    from their estimate); 3D: "stream" where
    ``plane_adjoint.stream_geometry`` does."""
    from .stage_march import chain_stage_plan, stage_march_geometry

    fits = {}
    if plan.program.ndim == 2:
        from .warp_chain import warp_geometry
        regs = warp_regs(plan) if warp_regs else None
        try:
            fits["warp"] = warp_geometry(plan, spatial, itemsize,
                                         regs).owned_share
        except ValueError:
            pass
    if not any(p in plan.invariant for p, _ in plan.probes):
        try:
            fits["march"] = stage_march_geometry(
                chain_stage_plan(plan), spatial, itemsize).owned_share
        except ValueError:
            pass
    if plan.shard is None and box_tile(plan, spatial, itemsize) is not None:
        # the box designs have no shard mode
        fits["box"] = None
    if plan.program.ndim == 3:
        from .plane_adjoint import stream_geometry
        stream = stream_geometry(plan, spatial, itemsize)
        if stream is not None:
            fits["stream"] = stream.owned_share
    return fits


def plan_at_depth(plan: ChainPlan, depth: int) -> ChainPlan:
    """``plan``'s chain, ``depth`` steps deep."""
    if depth == plan.k:
        return plan
    carry = {n: s for n, s in plan.next_src.items() if s != n}
    return chain_plan(plan.op, depth, carry, plan.periodic, plan.probes,
                      plan.shard)


def forward_route(plan: ChainPlan, spatial, itemsize: int, warp_regs=None):
    """The rung of the depth ladder a forward chain runs at a shape:
    ``(design, kk)``, k/kk launches of the kk-deep chain in ``design``
    (``forward_design`` of ``plan_at_depth(plan, kk)``), kk the deepest
    divisor of k at which a design fits; ``("steps", 1)`` — k single
    steps through the op's own step (``timeloop.make_time_stepper``) —
    where none fits even at depth 1.  The JAX package's TPU dispatch runs
    the same ladder (``ops/time_chain.py:514–523``), found there by
    compiling; here it is a host reckoning, decided before any launch.
    Periodic extents below the stencil's reach raise, as they do in the
    JAX package.  Above 3 spatial dims no fused design exists: k single
    steps (the window kernel takes every rank)."""
    reach = [max(lo, hi) for lo, hi in zip(*plan.reach)]
    if plan.periodic and any(n < r for n, r in zip(spatial, reach)):
        raise ValueError(f"{plan.op.op_name}: periodic extents "
                         f"{tuple(spatial)} must cover the stencil reach "
                         f"{reach}")
    if plan.program.ndim > 3:
        return "steps", 1
    for kk in [d for d in range(plan.k, 0, -1) if plan.k % d == 0]:
        design = forward_design(plan_at_depth(plan, kk), spatial, itemsize,
                                warp_regs)
        if design is not None:
            return design, kk
    return "steps", 1


DESIGNS = ("march", "box", "stream", "warp")
# the 2D designs, in the order forward_design prefers them
DESIGNS_2D = ("warp", "box", "march")


def make_chain_kernel(plan: ChainPlan, design=None):
    """``fn(state) -> (state, probe_list)`` through the CUDA chain kernels;
    same semantics as ``plain_time_chain``.  Chain-invariant state fields
    come back as the tensors given (the kernels do not write them).
    ``design``: None — ``forward_route``'s rung for each shape, reckoned
    once per shape before any launch: k/kk launches of the kk-deep chain
    in the design ``forward_design`` picks there (the probe records of the
    launches stacked in step order), or k single steps where no design
    fits even at depth 1 —, or one design at depth k, forced for the
    in-turns comparison of the designs: "march" (the dim-0 march,
    ``adjoint_chain.make_chain_forward_march_kernel``), "box" (the box
    tiles of ``csrc/time_chain.cuh``), "warp" (2D: the warp march,
    ``ops.warp_chain``) or "stream" (3D: the z-streaming kernel's forward
    mode, ``ops.plane_adjoint``, which counts its launches); a forced
    design that does not fit the shape raises.  ``fn.design`` and
    ``fn.depth`` are the design ("steps" for single steps) and the depth
    of the last call's launches.  A sharded plan (``plan.shard``) runs
    ``fn(state, bases)`` at depth k in the march's or the streaming
    kernel's shard mode (``forward_design``'s pick; the box raises)."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; one of {DESIGNS}")
    if plan.shard is not None and design not in (None, "march", "stream"):
        raise ValueError(f"design {design!r} has no shard mode: a sharded "
                         f"3D chain runs the dim-0 march's forward mode or "
                         f"the z-streaming kernel's")
    nd = plan.program.ndim
    if nd == 2 and design == "stream":
        raise ValueError("a 2D forward chain runs the warp march, the box "
                         "or the dim-0 march; the z-streaming kernel is 3D")
    if nd == 3 and design == "warp":
        raise ValueError("the warp march runs 2D forward chains")
    kernels: dict = {}
    picks: dict = {}

    def kernel(d, kk=None):
        kk = plan.k if kk is None else kk
        if (d, kk) not in kernels:
            # the single steps run all k steps in one call
            kernels[d, kk] = rung_kernel(
                plan if d == "steps" else plan_at_depth(plan, kk), d)
        return kernels[d, kk]

    def fn(st: Dict[str, torch.Tensor], bases=None):
        d, kk = design, plan.k
        if plan.shard is not None:
            # a shard's k-deep kernel, as the JAX package's ShardedChain
            # builds it: no shallower rung and no single steps (they have
            # no global masks)
            if d is None:
                a0, spatial = check_state(plan, st)
                key = (spatial, tile_itemsize(a0))
                if key not in picks:
                    picks[key] = forward_design(plan, *key)
                    log_lowering_decision(plan.program.name,
                                          route="forward_design", k=plan.k,
                                          spatial=spatial, itemsize=key[1],
                                          design=picks[key], shard=True)
                d = picks[key]
                if d is None:
                    raise ValueError(
                        f"{plan.op.op_name}: neither the dim-0 march nor the "
                        f"z-streaming kernel fits the shard block {spatial} "
                        f"at k={plan.k}; reduce k or the mesh axis size")
            fn.design, fn.depth = d, kk
            return kernel(d, kk)(st, bases)
        if d is None:
            a0, spatial = check_state(plan, st)
            key = (spatial, tile_itemsize(a0))
            if key not in picks:
                # the warp march's fit from its built kernel's registers
                picks[key] = forward_route(plan, *key, warp_regs=(
                    lambda p: kernel("warp", p.k).library_regs(a0.dtype))
                    if nd == 2 else None)
                log_lowering_decision(plan.program.name,
                                      route="forward_route", k=plan.k,
                                      spatial=spatial, itemsize=key[1],
                                      design=picks[key][0],
                                      depth=picks[key][1])
            d, kk = picks[key]
        fn.design, fn.depth = d, kk
        run = kernel(d, kk)
        if d == "steps" or kk == plan.k:
            return run(st)
        recs: List[list] = [[] for _ in plan.probes]
        for _ in range(plan.k // kk):
            st, part = run(st)
            for r, p in zip(recs, part):
                r.append(p)
        return st, [torch.cat(r) for r in recs]

    fn.plan = plan
    fn.design = design
    fn.depth = plan.k
    fn.kernel = kernel  # a design's kernel at a depth (built on first use)
    return fn


def rung_kernel(plan: ChainPlan, design: str):
    """``fn(state) -> (state, probe_list)``: ``plan``'s chain through one
    design, or ("steps") its k single steps."""
    if design == "march":
        from .adjoint_chain import make_chain_forward_march_kernel
        return make_chain_forward_march_kernel(plan, sys.modules[__name__])
    if design == "stream":
        from .plane_adjoint import make_plane_chain_kernel
        return make_plane_chain_kernel(plan)
    if design == "warp":
        from .warp_chain import make_warp_chain_kernel
        return make_warp_chain_kernel(plan, sys.modules[__name__])
    if design == "steps":
        return single_steps(plan)
    return _make_box_chain_kernel(plan)


def single_steps(plan: ChainPlan):
    """``fn(state) -> (state, probe_list)``: the ladder's last rung, k
    single steps through the op's own step function
    (``timeloop.make_time_stepper``: the single-step kernel on CUDA
    tensors, which counts its launches on ``ops.cuda_kernel``), the probe
    rows recorded after each."""
    from ..timeloop import make_time_stepper

    step = make_time_stepper(
        plan.op, {n: s for n, s in plan.next_src.items() if s != n},
        periodic=plan.periodic)

    def fn(state: Dict[str, torch.Tensor]):
        st = {n: state[n] for n in plan.in_names}
        recs: List[list] = [[] for _ in plan.probes]
        for _ in range(plan.k):
            st = step(st)
            for r, (pname, prow) in zip(recs, plan.probes):
                r.append(st[pname][probe_index(prow, st[pname].shape)])
        return ({n: st[n] for n in plan.in_names},
                [torch.stack(r) for r in recs])

    fn.plan = plan
    fn.design = "steps"
    return fn


def sequential_chain_vjp(plan: ChainPlan):
    """``fn(state, cot_state, probe_cots=()) -> (state_k, cot_0)``: the k
    steps recomputed through the op's own step function under
    ``torch.enable_grad`` and pulled back by autograd — the
    ``fused_bwd=False`` backward (the JAX package's ``bwd_rule``), and the
    ladder's last rung of the fused adjoints where no kernel fits even at
    depth 1 (the JAX package's ``sequential_recompute``)."""
    run = single_steps(plan)
    in_names = plan.in_names

    def fn(state, cot_state, probe_cots=()):
        with torch.enable_grad():
            ins = {n: state[n].detach().requires_grad_() for n in in_names}
            st, recs = run(ins)
            outs = [st[n] for n in in_names] + list(recs)
            cots = [cot_state[n] for n in in_names] + list(probe_cots)
            grads = torch.autograd.grad(outs, [ins[n] for n in in_names],
                                        cots, allow_unused=True)
        return ({n: st[n].detach() for n in in_names},
                {n: (g if g is not None else torch.zeros_like(state[n]))
                 for n, g in zip(in_names, grads)})

    fn.plan = plan
    return fn


def _make_box_chain_kernel(plan: ChainPlan):
    """``make_chain_kernel(plan, "box")``: the box-tile chain kernel
    (``csrc/time_chain.cuh``; 2D, and the earlier 3D design)."""
    from ..codegen.cuda_printer import generate_chain_source

    state: dict = {}
    name = f"{plan.program.name}_chain"
    nd = plan.program.ndim

    def fn(st: Dict[str, torch.Tensor]):
        global LAUNCHES
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
        geo, _ = chain_geometry(plan, spatial, tile_itemsize(a0),
                                blocks_per_sm=FWD_BLOCKS_PER_SM[nd],
                                block_rows=FWD_BLOCK_ROWS[nd])
        lib = _load_library(state, partial(generate_chain_source, plan), name,
                            a0.dtype)
        in_ptrs, in_st = plane_args3(plan.planes, st, nd)
        out_ptrs, out_st = plane_args3(plan.planes, stored, nd)
        probe_ptrs = Ptrs((p, 0) for p in probes)
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)],
               [in_ptrs, in_st, out_ptrs, out_st, probe_ptrs, geo], a0,
               f"{name}: chain launch"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic, spatial,
                          a0.element_size(), "box")] += 1
        return real(outputs), real(probes)

    fn.plan = plan
    fn.design = "box"
    return fn


def chain_runner(plan: ChainPlan):
    """The chain on its inputs' device: the kernel for CUDA tensors, the
    plain version for CPU tensors (``fn(state, bases)`` for a sharded
    plan)."""
    fn = on_device(make_chain_kernel(plan), plain_time_chain(plan),
                   plan.in_names[0])
    fn.plan = plan
    return fn


# ---------------------------------------------------------------------------
# The user-facing chain.

class ChainEntry:
    """The fused chain as a registry entry (``ops/custom_ops.py``,
    ``psat::chain`` / ``psat::chain_bwd``): the plan (its op's derived
    backward included) and ``fused_bwd``.  The forward op returns the
    state planes the kernel writes and the probe records; the
    chain-invariant fields (κ, c) are no outputs — the wrapper passes the
    tensors given through, so their cotangents reach them directly and
    the backward sees zeros in their place.  The CUDA kernel is
    ``make_chain_kernel``; the CPU kernel the device-dispatching runner
    (``chain_runner``: the plain version on CPU tensors).  The backward
    op is the fused adjoint (``adjoint_chain.fused_chain_vjp``); the
    sequential-recompute backward (``fused_bwd=False``, and the ladder's
    last rung where no adjoint kernel fits) differentiates the op's own
    single steps with autograd, outside any op."""

    kind = "chain"

    def __init__(self, plan: ChainPlan, fused_bwd: bool):
        self.name = f"{plan.program.name}_chain"
        self.recipe = dict(plan=plan, fused_bwd=fused_bwd)
        self._init()

    def _init(self):
        plan = self.recipe["plan"]
        self.in_names = plan.in_names
        self.stored = [n for n in plan.in_names if n not in plan.invariant]
        self.kernel = make_chain_kernel(plan)
        self.runner = on_device(self.kernel, plain_time_chain(plan),
                                plan.in_names[0])
        self.seq = sequential_chain_vjp(plan)
        self.adj = None
        # the fused adjoint kernels are 2D and 3D; above, the backward
        # recomputes through the single steps (the ladder's last rung)
        if self.recipe["fused_bwd"] and plan.program.ndim <= 3:
            from .adjoint_chain import fused_chain_vjp

            carry = {n: s for n, s in plan.next_src.items() if s != n}
            self.adj = fused_chain_vjp(plan.op, plan.k, carry,
                                       periodic=plan.periodic,
                                       probes=plan.probes or None)

    def forward(self, card, extra, tensors):
        new, probes = (self.kernel if card else self.runner)(
            dict(zip(self.in_names, tensors)))
        return custom_ops.fresh([new[n] for n in self.stored] + list(probes),
                                tensors)

    def fake_forward(self, extra, tensors):
        st = dict(zip(self.in_names, tensors))
        k = self.recipe["plan"].k
        return ([torch.empty_like(st[n]) for n in self.stored]
                + [tensors[0].new_empty((k, st[p].shape[-1]))
                   for p, _ in self.recipe["plan"].probes])

    def to_save(self, tensors):
        return list(tensors)

    def backward(self, card, extra, state, cotangents, probe_cotangents):
        st = dict(zip(self.in_names, state))
        ct = dict(zip(self.in_names, cotangents))
        args = ((st, ct, tuple(probe_cotangents))
                if self.recipe["plan"].probes else (st, ct))
        # the plain version is autograd through the plain forward
        _, cot0 = (self.adj(*args) if card
                   else custom_ops.with_autograd(self.adj, *args))
        return custom_ops.fresh([cot0[n] for n in self.in_names],
                                state + cotangents + probe_cotangents)

    def fake_backward(self, extra, state, cotangents, probe_cotangents):
        return [torch.empty_like(t) for t in state]

    def grads(self, saved, cotangents, needs, extra):
        if not any(needs):
            return [None] * len(needs)
        st = dict(zip(self.in_names, saved))
        ns = len(self.stored)
        cot_state = {n: (cotangents[self.stored.index(n)]
                         if n in self.stored else torch.zeros_like(st[n]))
                     for n in self.in_names}
        probe_cots = list(cotangents[ns:])
        if self.adj is not None and not self.adj.sequential(st):
            cot0 = dict(zip(self.in_names, custom_ops.through(
                custom_ops.chain_bwd, self, saved,
                [cot_state[n] for n in self.in_names], probe_cots)))
        else:
            _, cot0 = self.seq(st, cot_state, tuple(probe_cots))
        return [cot0[n] if need else None
                for n, need in zip(self.in_names, needs)]


def fused_time_chain(op, k: int, carry_map: Dict[str, str],
                     periodic: bool = False, dtype=None,
                     fused_bwd: bool = False, probes=None):
    """``chain(state: dict) -> state`` advancing ``k`` steps in ONE kernel
    (see the module doc) over the ``psat::chain`` custom op
    (``ChainEntry``).  With ``probes`` the chain returns
    ``(state, probe_tuple)``.  ``dtype`` (a ``torch.dtype``) casts the
    state before the chain, so forward and backward compute in it."""
    plan = chain_plan(op, k, carry_map, periodic, probes)
    ent = ChainEntry(plan, fused_bwd)
    custom_ops.register(ent)
    in_names, stored = plan.in_names, ent.stored
    n_probes = len(plan.probes)

    def chain(state: Dict[str, torch.Tensor]):
        tensors = [state[n] if dtype is None else state[n].to(dtype)
                   for n in in_names]
        res = custom_ops.apply(ent, None, *tensors)
        # chain-invariant fields come back as the tensors given
        out = dict(zip(in_names, tensors))
        out.update(zip(stored, res[:len(stored)]))
        if n_probes:
            return out, tuple(res[len(stored):])
        return out

    chain.input_names = in_names
    chain.k = k
    chain.plan = plan
    chain.entry = ent
    return chain
