"""Halo (ghost-layer) exchange over a mesh — the port of
``pystencils_autodiff_tpu/parallel/halo.py``.

Each shard extends its block with its neighbours' edge slabs: the slab is
cut with ``narrow``, copied to the receiving shard's device with ``to``
(within the card where both shards share one) and joined with
``torch.cat``.  The
move of one direction's slabs for every shard at once is one transport,
the counterpart of one ``lax.ppermute``; ``exchange_count()`` counts them
(and their transposes under autograd), as the JAX tests count ``ppermute``
in the jaxpr.

Everything here is differentiable: an exchange's backward
(``halo_transpose``) moves the halo cotangents back along the reversed
permutation and accumulates each into the edge it came from — the
transposed exchange of a sharded stencil, as ``jax.grad`` derives it
through ``ppermute``.  An exchange is the ``psat::halo`` custom op
(``HaloEntry``, ``ops/custom_ops.py``) where ``torch.compile`` traces it;
eager calls, and ``torch.export``, take the same code through an autograd
Function, so an exported sharded run holds each exchange as its
``narrow``, its slab copies (``to(..., copy=True)``) and its ``cat``.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import custom_ops
from .mesh import ShardedArray

__all__ = ["exchange_dim", "extend_with_halo", "mask_global_ghost",
           "halo_transpose", "exchange_count", "reset_exchange_count",
           "HaloEntry", "halo_entry"]

_EXCHANGES = 0


def exchange_count() -> int:
    """Transports since the last reset: one per direction of an exchange
    along an axis of size > 1 (the JAX package's ``ppermute``s), and one
    per direction of each transposed exchange."""
    return _EXCHANGES


def reset_exchange_count() -> None:
    global _EXCHANGES
    _EXCHANGES = 0


def _transport(pairs, slabs) -> List[torch.Tensor]:
    """Move slab ``src`` to shard ``dst`` for each (src, dst) pair, every
    shard at once (one transport); a shard no pair reaches receives
    zeros."""
    global _EXCHANGES
    _EXCHANGES += 1
    recv = [None] * len(slabs)
    for src, dst in pairs:
        recv[dst] = slabs[src].to(slabs[dst].device, copy=True)
    return [r if r is not None else torch.zeros_like(slabs[i])
            for i, r in enumerate(recv)]


def _shift_pairs(mesh, axis_name: str, direction: int,
                 periodic: bool) -> Tuple[Tuple[int, int], ...]:
    """(src, dst) shard pairs sending one step along ``axis_name``
    (``direction`` +1: to the higher index)."""
    n = mesh.shape[axis_name]
    pairs = []
    for i in range(mesh.size):
        c = mesh.coords(i)
        j = c[axis_name] + direction
        if 0 <= j < n or periodic:
            pairs.append((i, mesh.flat({**c, axis_name: j % n})))
    return tuple(pairs)


def _route(slabs: Sequence[torch.Tensor], mesh, axis_name: str,
           direction: int, periodic: bool) -> List[torch.Tensor]:
    """Transport edge slabs one mesh step; on a size-1 axis the transport
    is elided (periodic wrap = the shard's own opposite edge, bounded =
    zeros), as the JAX package elides the ``ppermute``."""
    if mesh.shape[axis_name] == 1:
        return list(slabs) if periodic else [torch.zeros_like(s)
                                             for s in slabs]
    return _transport(_shift_pairs(mesh, axis_name, direction, periodic),
                      slabs)


def _extend(blocks, mesh, dim, axis_name, lo, hi, periodic):
    """Every block extended along ``dim`` by its neighbours' halos."""
    left = right = None
    if lo:
        # my left halo = my left neighbour's last `lo` rows
        left = _route([b.narrow(dim, b.shape[dim] - lo, lo) for b in blocks],
                      mesh, axis_name, +1, periodic)
    if hi:
        right = _route([b.narrow(dim, 0, hi) for b in blocks], mesh,
                       axis_name, -1, periodic)
    return [torch.cat(([left[i]] if left else []) + [b]
                      + ([right[i]] if right else []), dim)
            for i, b in enumerate(blocks)]


def halo_transpose(gexts, mesh, dim: int, axis_name: str, lo: int, hi: int,
                   periodic: bool = False) -> List[torch.Tensor]:
    """The transpose of ``exchange_dim`` on the extended blocks' cotangents:
    each block's own rows, plus the halo cotangents its neighbours received
    from it, sent back and added into the edge rows they came from (an edge
    shard's outward halo of a bounded domain came from nowhere: dropped).
    Two transports, one each way."""
    n = [g.shape[dim] - lo - hi for g in gexts]
    out = [g.narrow(dim, lo, m).clone() for g, m in zip(gexts, n)]
    if lo:
        recv = _route([g.narrow(dim, 0, lo) for g in gexts], mesh, axis_name,
                      -1, periodic)
        for o, r, m in zip(out, recv, n):
            o.narrow(dim, m - lo, lo).add_(r)
    if hi:
        recv = _route([g.narrow(dim, lo + m, hi) for g, m in zip(gexts, n)],
                      mesh, axis_name, +1, periodic)
        for o, r in zip(out, recv):
            o.narrow(dim, 0, hi).add_(r)
    return out


class HaloEntry:
    """One exchange (mesh, tensor dim, mesh axis, halo widths, wrap) as a
    registry entry of the ``psat::halo`` op: ``forward(blocks)`` the
    extended blocks, ``backward(cotangents)`` their transpose."""

    kind = "halo"

    def __init__(self, mesh, dim: int, axis_name: str, lo: int, hi: int,
                 periodic: bool):
        self.name = f"halo_{axis_name}_{dim}"
        self.recipe = dict(mesh=mesh, dim=int(dim), axis_name=axis_name,
                           lo=int(lo), hi=int(hi), periodic=bool(periodic))

    def _meta(self):
        r = self.recipe
        return (r["mesh"], r["dim"], r["axis_name"], r["lo"], r["hi"],
                r["periodic"])

    def forward(self, blocks):
        return _extend(blocks, *self._meta())

    def backward(self, gexts):
        return halo_transpose(gexts, *self._meta())

    def _resized(self, ts, grow):
        d, w = self.recipe["dim"], self.recipe["lo"] + self.recipe["hi"]
        return [t.new_empty([n + (grow * w if a == d else 0)
                             for a, n in enumerate(t.shape)]) for t in ts]

    def fake_forward(self, blocks):
        return self._resized(blocks, 1)

    def fake_backward(self, gexts):
        return self._resized(gexts, -1)


# one entry per (mesh, dim, axis, widths, wrap), for the mesh's life
_ENTRIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def halo_entry(mesh, dim, axis_name, lo, hi, periodic) -> HaloEntry:
    per = _ENTRIES.setdefault(mesh, {})
    key = (dim, axis_name, lo, hi, periodic)
    if key not in per:
        per[key] = HaloEntry(mesh, dim, axis_name, lo, hi, periodic)
        custom_ops.register(per[key])
    return per[key]


class _HaloExchange(torch.autograd.Function):
    """``exchange_dim`` over every block at once, the eager path of the
    ``psat::halo`` op; its backward is ``halo_transpose`` (no full-size
    zero tensors per halo slab, as autograd through ``narrow`` would
    make)."""

    @staticmethod
    def forward(ctx, ent, *blocks):
        ctx.entry = ent
        return tuple(ent.forward(blocks))

    @staticmethod
    def backward(ctx, *gexts):
        if any(g is None for g in gexts):
            return (None,) * (len(gexts) + 1)
        return (None,) + tuple(ctx.entry.backward(gexts))


def exchange_dim(local: ShardedArray, dim: int, axis_name: str, lo: int,
                 hi: int, periodic: bool = False) -> ShardedArray:
    """Extend every block of ``local`` along tensor axis ``dim`` with its
    neighbours' halos of width (lo, hi) along mesh axis ``axis_name``:
    received left halo, the block, received right halo.  Edge shards of a
    bounded domain receive zeros (their global ghost cells are masked
    anyway).  Differentiable: its transpose is ``halo_transpose``."""
    blocks = local.blocks
    if lo > min(b.shape[dim] for b in blocks) or \
            hi > min(b.shape[dim] for b in blocks):
        raise ValueError(f"halo ({lo}, {hi}) along dim {dim} exceeds the "
                         f"block extent {blocks[0].shape[dim]}")
    if not (lo or hi):
        return local
    ent = halo_entry(local.mesh, dim, axis_name, lo, hi, periodic)
    out = (custom_ops.halo(ent.key, list(blocks)) if custom_ops.traced()
           else _HaloExchange.apply(ent, *blocks))
    return ShardedArray(list(out), local.mesh, local.spec)


def extend_with_halo(local: ShardedArray, dim_axes: Dict[int, str],
                     ghost: Sequence[Tuple[int, int]],
                     periodic: bool = False, lead: int = 0) -> ShardedArray:
    """Halo-extend every mesh-sharded spatial dim, in ascending dim order:
    later dims then transport the earlier dims' halo rows with them, which
    fills the corner halos of a multi-dim decomposition.  ``lead``: index
    dims before the spatial ones (an index-major field)."""
    out = local
    for d in sorted(dim_axes):
        lo, hi = ghost[d]
        if lo or hi:
            out = exchange_dim(out, lead + d, dim_axes[d], lo, hi, periodic)
    return out


def mask_global_ghost(local_out: ShardedArray, dim_axes: Dict[int, str],
                      ghost: Sequence[Tuple[int, int]],
                      global_shape: Sequence[int], index_dims: int = 0,
                      periodic: bool = False,
                      lead: int = 0) -> ShardedArray:
    """Zero the cells whose *global* coordinate — built from the shard's
    mesh index and its block extent — lies in the ghost frame of a sharded
    dim (the local op cannot see the shard's position).  ``index_dims``
    trailing (or, as ``lead``, leading) index dims are not spatial.  A
    periodic domain has no global ghost frame."""
    if periodic:
        return local_out
    mesh = local_out.mesh
    out = []
    for i, o in enumerate(local_out.blocks):
        c = mesh.coords(i)
        for d, ax in dim_axes.items():
            lo, hi = ghost[d]
            axis = lead + d
            size = o.shape[axis]
            base = c[ax] * size
            if base >= lo and base + size <= global_shape[d] - hi:
                continue  # no global ghost cell in this block
            ids = torch.arange(size, device=o.device) + base
            keep = (ids >= lo) & (ids < global_shape[d] - hi)
            keep = keep.reshape([-1 if a == axis else 1
                                 for a in range(o.dim())])
            o = torch.where(keep, o, torch.zeros((), dtype=o.dtype,
                                                 device=o.device))
        out.append(o)
    return ShardedArray(out, mesh, local_out.spec)
