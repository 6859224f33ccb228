"""What a fused chain kernel needs to run on one shard of a larger domain —
the port of ``ShardSpec`` in ``pystencils_autodiff_tpu/ops/flatten.py``.

The JAX module's ``FlatGeom`` (the Pallas row flattening of the leading
dims) is not ported: the port's kernels address (z, y, x) planes and keep
their own geometry (``ops.stage_march``, ``ops.plane_adjoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

__all__ = ["ShardSpec", "shard_wraps", "check_bases", "global_window"]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Tells a fused chain kernel it is running on one halo-extended shard
    of a larger global domain (``parallel.ShardedChain``): a sharded dim is
    read bounded-style (its periodic wrap, if any, arrived by the halo
    exchange), an unsharded dim of a periodic domain still wraps, and every
    interior, exact-VJP and in-domain test takes *global* coordinates: the
    block's coordinate plus the shard's base offset, given at call time,
    against ``global_spatial``."""
    global_spatial: Tuple[int, ...]
    sharded_dims: Tuple[int, ...]


def shard_wraps(periodic: bool, nd: int, shard) -> Tuple[bool, ...]:
    """Per spatial dim, whether reads wrap: a periodic domain's dims wrap,
    except those a shard decomposes."""
    sharded = set(shard.sharded_dims) if shard is not None else set()
    return tuple(periodic and d not in sharded for d in range(nd))


def check_bases(shard, bases, nd: int) -> Tuple[int, ...]:
    """The base offsets of a shard mode call as a tuple of ``nd`` ints (0
    for an unsharded dim); raises where a sharded call has none."""
    if shard is None:
        return (0,) * nd
    if bases is None:
        raise ValueError("a sharded chain kernel needs the shard's base "
                         "offsets (bases=)")
    b = tuple(int(x) for x in bases)
    if len(b) != nd:
        raise ValueError(f"bases {b} must give one offset per spatial dim "
                         f"({nd})")
    if len(shard.global_spatial) != nd:
        raise ValueError(f"ShardSpec.global_spatial "
                         f"{shard.global_spatial} is not {nd}-D")
    return b


def global_window(ghost: Sequence[Tuple[int, int]], spatial, shard,
                  bases, periodic: bool):
    """Per dim, the local [start, stop) of the cells of a block of extent
    ``spatial`` whose global coordinate lies in the interior window of a
    stage with ``ghost`` widths (every cell where ``periodic``)."""
    if periodic:
        return [(0, int(n)) for n in spatial]
    g = shard.global_spatial if shard is not None else tuple(spatial)
    out = []
    for d, (n, (lo, hi)) in enumerate(zip(spatial, ghost)):
        b = bases[d]
        start = min(max(lo - b, 0), int(n))
        stop = max(min(g[d] - hi - b, int(n)), start)
        out.append((start, stop))
    return out
