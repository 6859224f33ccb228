"""The slab single step (``csrc/row_tiled.cuh``): its tile reckoning, its
copy route and the arguments of its launch.

The port of ``pystencils_autodiff_tpu/ops/pallas_kernel.py::_run_row_tiled``
(PERF.md row 5).  ``make_cuda_stencil(..., strategy="tiled")`` launches it;
this module holds what is particular to it: ``slab_tile`` picks the lateral
tile, the rows a chunk (``R``) and the ring's depth, and the blocks per SM
from the shared-memory budget; ``slab_route`` picks the copy width from
the input tensors' pointers and strides; ``slab_args`` packs the launch's
geometry, with the walk dim (dim 0 of the program) cut into segments so
that the resident blocks fill the card in one wave.  The plain version is
the single step's (``torch_ref.py``): the kernel computes the same
function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .time_chain import SM_SMEM, SMEM_BUDGET

__all__ = ["SlabTile", "slab_tile", "slab_halo", "slab_route", "slab_args",
           "LATERAL", "TILE_ROWS", "STAGES", "WIDTHS"]

# ring slots, a power of two from 4 to kMaxStages = 16: chunk c reads
# chunks c-1..c+1, so STAGES - 3 chunks are in flight beyond them
STAGES = 4
NUM_SMS = 132  # H100 SXM
# the lateral tile (dims 1.. of the program), a thread per column (at most
# kMaxThreads = 256): 2D 128 columns, 3D 8 × 32; rows a chunk by spatial
# dims (at least the walk-dim reach), halved by default until the ring
# leaves MIN_THREADS_PER_SM resident threads: the A/B of PERF.md (H100,
# PR 7) ran 2D f32 faster at 4 rows (12 blocks of 128) than at 8 (6) and
# 3D f64 at 2 (4 blocks of 256) than at 4 (2), 3D f32 at 4 than at 2
LATERAL = {2: (128,), 3: (8, 32)}
TILE_ROWS = {2: 4, 3: 4}
MIN_THREADS_PER_SM = 768
# copy widths in bytes, widest first; 0: per element
WIDTHS = (16, 8, 4)


@dataclass(frozen=True)
class SlabTile:
    tile: Tuple[int, ...]    # (R rows a chunk,) + the lateral tile
    halo: Tuple[Tuple[int, int], ...]  # x rounded out to whole copies
    slab: Tuple[int, ...]    # (D ring rows,) + the lateral slab extents
    smem: int                # bytes of the ring
    blocks_per_sm: int
    threads: int
    width: int               # copy width in bytes (0: per element)


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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pow2_at_least(v: int) -> int:
    return 1 << (v - 1).bit_length()


def slab_route(tensors, itemsize: int, pointers: bool = True) -> int:
    """The copy width (bytes) the kernel takes for ``tensors`` (the input
    planes): the widest of ``WIDTHS``, no narrower than an element, that
    divides every base address and every stride in bytes, with the last
    dim contiguous; 0 (per element) where none does.  A host reckoning
    made before the launch; ``pointers=False`` leaves the base addresses
    out (a traced launch tests them: ``launch.run``'s ``align``)."""
    for w in WIDTHS:
        if w < itemsize:
            continue
        if all(t.stride(-1) == 1 and (not pointers or t.data_ptr() % w == 0)
               and all(s * itemsize % w == 0 for s in t.stride()[:-1])
               for t in tensors):
            return w
    return 0


def slab_tile(halo: Sequence[Tuple[int, int]], n_planes: int, itemsize: int,
              spatial: Sequence[int], tile_rows: Optional[int] = None,
              width: int = 16) -> SlabTile:
    """The slab kernel's geometry for ``n_planes`` input planes of
    ``itemsize`` bytes (the storage type's: bf16 stays bf16 in the ring)
    over ``spatial`` at copy width ``width``: the lateral tile ``LATERAL``
    (x cut to the domain in whole warps, y to the domain), the x halo
    rounded out to whole copies; ``R`` rows a chunk: the power of two at
    or below ``tile_rows`` (default ``TILE_ROWS``), halved until the ring
    fits ``SMEM_BUDGET`` (by default also until the resident blocks hold
    ``MIN_THREADS_PER_SM`` threads), never below the walk-dim reach (so
    that the ring of ``STAGES · R`` rows is a power of two, indexed by a
    mask).
    Blocks per SM: as many as the SM's shared memory and threads hold.
    Raises ValueError where no ring fits."""
    nd = len(spatial)
    if nd not in LATERAL:
        raise ValueError(f"the slab kernel takes 2 or 3 spatial dims, got "
                         f"{nd}")
    lateral = list(LATERAL[nd])
    lateral[-1] = min(lateral[-1], _round_up(spatial[-1], 32))
    if nd == 3:
        lateral[0] = min(lateral[0], spatial[1])
    v = max(1, width // itemsize)
    halo = [tuple(h) for h in halo]
    halo[-1] = (_round_up(halo[-1][0], v), halo[-1][1])
    pitch = _round_up(halo[-1][0] + lateral[-1] + halo[-1][1], v)
    halo[-1] = (halo[-1][0], pitch - lateral[-1] - halo[-1][0])
    lat_slab = [t + lo + hi for t, (lo, hi) in zip(lateral, halo[1:])]
    reach = _pow2_at_least(max(1, *halo[0]))

    def ring(rows):
        return STAGES * rows

    def smem(rows):
        return n_planes * ring(rows) * math.prod(lat_slab) * itemsize

    threads = math.prod(lateral)

    def blocks(rows):
        return max(1, min(2048 // threads, SM_SMEM // (smem(rows) + 1024)))

    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be at least 1, got {tile_rows}")
    rows = (TILE_ROWS[nd] if tile_rows is None
            else 1 << (int(tile_rows).bit_length() - 1))
    rows = max(rows, reach)
    while rows // 2 >= reach and (
            smem(rows) > SMEM_BUDGET or (tile_rows is None and blocks(rows)
                                         * threads < MIN_THREADS_PER_SM)):
        rows //= 2
    if smem(rows) > SMEM_BUDGET:
        raise ValueError(
            f"no slab fits {SMEM_BUDGET} bytes of shared memory: a ring of "
            f"{ring(rows)} rows of {n_planes} input planes over a "
            f"{tuple(lat_slab)} slab takes {smem(rows)} bytes")
    return SlabTile(tile=(rows, *lateral), halo=tuple(halo),
                    slab=(ring(rows), *lat_slab), smem=smem(rows),
                    blocks_per_sm=blocks(rows), threads=threads,
                    width=width)


def _zyx(values, nd, fill):
    return [fill] * (3 - nd) + [int(v) for v in values]


def slab_segments(st: SlabTile, spatial) -> int:
    """Segments of the walk dim: as many as let the lateral tiles fill the
    resident blocks of every SM once, each at least two chunks long."""
    lat_tiles = math.prod(math.ceil(n / t)
                          for n, t in zip(spatial[1:], st.tile[1:]))
    want = max(1, st.blocks_per_sm * NUM_SMS // lat_tiles)
    return max(1, min(want, spatial[0] // (2 * st.tile[0])))


def slab_args(st: SlabTile, spatial, wlo, whi, alo, ahi):
    """(geo, slab) int64 blocks of ``psat_slab_launch``, (z, y, x) order."""
    nd = len(spatial)
    geo = (_zyx(spatial, nd, 1) + _zyx(wlo, nd, 0) + _zyx(whi, nd, 1)
           + _zyx(alo, nd, 0) + _zyx(ahi, nd, 1)
           + _zyx([0] + [lo for lo, _ in st.halo[1:]], nd, 0))
    slab = (_zyx((1,) + st.tile[1:], nd, 1) + _zyx((1,) + st.slab[1:], nd, 1)
            + [st.tile[0], st.slab[0], slab_segments(st, spatial)])
    return geo, slab
