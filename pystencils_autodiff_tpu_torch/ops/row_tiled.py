"""The slab single step (``csrc/row_tiled.cuh``): its tile reckoning and
the arguments of its launch.

The port of ``pystencils_autodiff_tpu/ops/pallas_kernel.py::_run_row_tiled``
(PERF.md row 5).  ``make_cuda_stencil(..., strategy="tiled")`` launches it;
this module holds what is particular to it: ``slab_tile`` picks the tile
(``t0`` rows of dim 0 by a lateral extent of the other dims) and the blocks
per SM from the shared-memory budget, and ``slab_args`` packs the launch's
geometry.  The plain version is the single step's (``torch_ref.py``): the
kernel computes the same function.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .time_chain import SMEM_BUDGET

__all__ = ["SlabTile", "slab_tile", "slab_halo", "slab_args",
           "LATERAL", "TILE_ROWS", "MAX_BLOCKS_PER_SM"]

THREADS = 256  # kThreads in csrc/row_tiled.cuh
# default tile: t0 rows by a lateral extent (dims 1.. of the program);
# 8 × 128 in 2D and 4 × 8 × 32 in 3D are 1024 cells, 4 per thread
TILE_ROWS = {2: 8, 3: 4}
LATERAL = {2: (128,), 3: (8, 32)}
MAX_BLOCKS_PER_SM = 2048 // THREADS


@dataclass(frozen=True)
class SlabTile:
    tile: Tuple[int, ...]    # per spatial dim
    halo: Tuple[Tuple[int, int], ...]
    slab: Tuple[int, ...]    # tile + halo, per spatial dim
    smem: int                # bytes of both slots
    blocks_per_sm: int


def slab_halo(program) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) per dim: how far the program's reads reach below and above
    the cell."""
    lo, hi = [0] * program.ndim, [0] * program.ndim
    for step in program.steps:
        for at in step.atoms:
            offs = getattr(at, "offsets", None)
            if offs is None:
                continue
            for d, o in enumerate(offs):
                lo[d], hi[d] = max(lo[d], -int(o)), max(hi[d], int(o))
    return tuple(zip(lo, hi))


def slab_tile(halo: Sequence[Tuple[int, int]], n_planes: int, itemsize: int,
              spatial: Sequence[int], tile_rows: Optional[int] = None
              ) -> SlabTile:
    """The slab kernel's tile for ``n_planes`` input planes of ``itemsize``
    bytes in shared memory (the compute type's: bf16 storage tiles in
    float) over ``spatial``: ``tile_rows`` rows of dim 0 when given, else
    ``TILE_ROWS`` halved until both slots fit ``SMEM_BUDGET``; the lateral
    extent is ``LATERAL``, cut to the domain.  Blocks per SM: as many as
    the budget holds, at most ``MAX_BLOCKS_PER_SM``.  Raises ValueError
    where no slab fits."""
    nd = len(spatial)
    if nd not in LATERAL:
        raise ValueError(f"the slab kernel takes 2 or 3 spatial dims, got "
                         f"{nd}")
    lateral = tuple(min(w, n) for w, n in zip(LATERAL[nd], spatial[1:]))
    per_row = 2 * n_planes * itemsize * math.prod(
        w + lo + hi for w, (lo, hi) in zip(lateral, halo[1:]))
    lo0, hi0 = halo[0]

    def smem(t0):
        return (t0 + lo0 + hi0) * per_row

    if tile_rows is not None:
        t0 = int(tile_rows)
        if t0 < 1:
            raise ValueError(f"tile_rows must be at least 1, got {tile_rows}")
    else:
        t0 = TILE_ROWS[nd]
        while t0 > 1 and smem(t0) > SMEM_BUDGET:
            t0 //= 2
    if smem(t0) > SMEM_BUDGET:
        raise ValueError(
            f"no slab fits {SMEM_BUDGET} bytes of shared memory: 2 slots of "
            f"{n_planes} input planes at a {(t0,) + lateral} tile with halo "
            f"{tuple(halo)} take {smem(t0)} bytes")
    tile = (t0,) + lateral
    return SlabTile(tile=tile, halo=tuple(tuple(h) for h in halo),
                    slab=tuple(t + lo + hi for t, (lo, hi) in zip(tile, halo)),
                    smem=smem(t0),
                    blocks_per_sm=max(1, min(MAX_BLOCKS_PER_SM,
                                             SMEM_BUDGET // smem(t0))))


def _zyx(values, nd, fill):
    return [fill] * (3 - nd) + [int(v) for v in values]


def slab_args(st: SlabTile, spatial, wlo, whi, alo, ahi):
    """(geo, slab) int64 arrays of ``psat_slab_launch``, (z, y, x) order."""
    nd = len(spatial)
    geo = (_zyx(spatial, nd, 1) + _zyx(wlo, nd, 0) + _zyx(whi, nd, 1)
           + _zyx(alo, nd, 0) + _zyx(ahi, nd, 1))
    slab = (_zyx([lo for lo, _ in st.halo], nd, 0)
            + _zyx([hi for _, hi in st.halo], nd, 0)
            + _zyx(st.tile, nd, 1) + [st.blocks_per_sm])
    return ((ctypes.c_int64 * len(geo))(*geo),
            (ctypes.c_int64 * len(slab))(*slab))
