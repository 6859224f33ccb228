"""Sharded stencil execution over a device mesh with halo exchange — the
port of ``pystencils_autodiff_tpu/parallel/sharding.py``.

A global array lives split over a ``Mesh`` (``shard_array``); each step the
sharded op

1. halo-extends every shard with its neighbours' edges (``halo.py``),
2. runs the op's own single-step function (``AutoDiffOp.torch_function``:
   the window kernel on CUDA tensors, the plain version on CPU tensors) on
   the extended block, in interior mode,
3. slices back to the local block and masks the global ghost cells.

The result equals the op on the gathered array, and autograd through it
runs the transposed halo exchange (reverse transport + edge accumulation),
every piece of glue being a differentiable torch op, while the op's
backward stays its own symbolic backward kernel.  One process drives every
shard, as JAX's single-controller ``shard_map`` does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..ops import forward_program
from ..ops.common import storage_spatial
from .halo import extend_with_halo, mask_global_ghost
from .mesh import Mesh, ShardedArray, gather_blocks, split_blocks

__all__ = ["ShardedStencil", "make_mesh", "shard_array", "field_spec",
           "pad_edge", "sharded_stepper"]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of the first ``prod(shape)`` devices (row-major).  With no
    ``devices``, the visible CUDA devices; a caller that wants several
    shards on one card says so (``devices=[torch.device("cuda")] * 4``).
    Raises where fewer devices are listed than the mesh needs."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def shard_array(arr: torch.Tensor, mesh: Mesh, spec) -> ShardedArray:
    """``arr`` split over ``mesh`` by ``spec`` (axis names or None per dim,
    as ``PartitionSpec``): each block on its shard's device."""
    return ShardedArray(split_blocks(arr, mesh, spec), mesh, spec)


def field_spec(f, dim_axes: Dict[int, str], ndim: int) -> tuple:
    """The spec of field ``f``'s storage: ``dim_axes`` on its spatial
    dims, None on its index dims (leading for an index-major field)."""
    spatial = tuple(dim_axes.get(d) for d in range(ndim))
    ni = f.index_dimensions
    if ni and getattr(f, "index_major", False):
        return (None,) * ni + spatial
    return spatial + (None,) * ni


def spatial_lead(f) -> int:
    """Index dims before the spatial ones in ``f``'s storage."""
    return f.index_dimensions if getattr(f, "index_major", False) else 0


def pad_edge(t: torch.Tensor, pads: Dict[int, int]) -> torch.Tensor:
    """``t`` padded at the high end of each tensor axis in ``pads`` with
    copies of its last slice (finite under any op)."""
    for axis, p in pads.items():
        n = t.shape[axis]
        idx = torch.arange(n + p, device=t.device).clamp(max=n - 1)
        t = t.index_select(axis, idx)
    return t


class ShardedStencil:
    """A domain-decomposed ``AutoDiffOp`` over a device mesh.

    Parameters
    ----------
    op: the AutoDiffOp.
    mesh: the device mesh (``make_mesh``).
    dim_axes: spatial dim → mesh axis name, e.g. ``{0: 'x', 1: 'y'}``.
    periodic: wrap halos around the domain (periodic domain).
    overlap: split each step into a bulk computation on the raw block (it
        does not depend on the exchange) and thin edge strips that do;
        values equal ``overlap=False`` exactly.
    mask_global_spatial: the extents the global-ghost masks test, where a
        caller pre-padded an uneven domain (``ShardedChain``'s sequential
        recompute).
    kwargs: forwarded to ``op.torch_function`` (``strategy``,
        ``tile_rows``).

    ``__call__`` takes the op's input fields (positionally or by name) as
    global tensors or ``ShardedArray``s and returns the kind it was given.
    """

    def __init__(self, op, mesh: Mesh, dim_axes: Dict[int, str],
                 periodic: bool = False, overlap: bool = False,
                 mask_global_spatial=None, **kwargs):
        self.op = op
        self.mesh = mesh
        self.dim_axes = dict(dim_axes)
        self.periodic = periodic
        self.overlap = overlap
        self._mask_global = (tuple(mask_global_spatial)
                             if mask_global_spatial is not None else None)
        # interior mode: the wrap of a sharded dim arrives by the exchange,
        # an unsharded periodic dim's by the local extension below
        self._local = op.torch_function(**kwargs)
        prog = forward_program(op)
        self.ghost = prog.ghost
        self.ndim = prog.ndim
        for d, ax in self.dim_axes.items():
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
            if not (0 <= d < self.ndim):
                raise ValueError(f"dim {d} out of range for {self.ndim}D op")
        # unsharded dims of a globally periodic domain wrap LOCALLY (the
        # whole dim lives on every shard); sharded dims wrap by exchange
        self._local_wrap_dims = [
            d for d in range(self.ndim)
            if periodic and d not in self.dim_axes
            and (self.ghost[d][0] or self.ghost[d][1])]
        if self._local_wrap_dims and overlap:
            raise NotImplementedError(
                "overlap mode with periodic wrap in an unsharded dim is not "
                "supported; shard that dim (a size-1 mesh axis works) or "
                "disable overlap")

    def partition_spec(self, field) -> tuple:
        return field_spec(field, self.dim_axes, self.ndim)

    def input_shardings(self):
        return {f.name: self.partition_spec(f)
                for f in self.op.forward_input_fields}

    def _pad_uneven(self, arrays, fields, global_spatial):
        """Pad global arrays so every sharded dim divides its mesh axis.
        Pads are edge copies (finite under nonlinear kernels), land in the
        last shard, are never read by true-interior cells, and are zeroed
        by the global-ghost mask testing the TRUE extents — so results and
        gradients equal the op on the gathered array."""
        pads = {}
        for d, ax in self.dim_axes.items():
            nsh = self.mesh.shape[ax]
            rem = global_spatial[d] % nsh
            if rem:
                pads[d] = nsh - rem
        if not pads:
            return arrays, None
        if self.periodic:
            raise ValueError(
                f"periodic sharded dims must divide the mesh evenly "
                f"(global {tuple(global_spatial)}, mesh "
                f"{dict(self.mesh.shape)}): pad-and-mask would break the "
                f"wrap seam — resize the domain or the mesh")
        return tuple(pad_edge(a, {spatial_lead(f) + d: p
                                  for d, p in pads.items()})
                     for a, f in zip(arrays, fields)), pads

    def _wrap_extend(self, a: ShardedArray, lead: int) -> ShardedArray:
        """Extend an unsharded dim of a periodic domain with its own
        opposite edges."""
        blocks = a.blocks
        for d in self._local_wrap_dims:
            lo, hi = self.ghost[d]
            ax = lead + d
            out = []
            for b in blocks:
                n = b.shape[ax]
                parts = ([b.narrow(ax, n - lo, lo)] if lo else []) + [b] + (
                    [b.narrow(ax, 0, hi)] if hi else [])
                out.append(torch.cat(parts, ax))
            blocks = out
        return ShardedArray(blocks, a.mesh, a.spec)

    def _slice_back(self, o: torch.Tensor, lead: int) -> torch.Tensor:
        for d in list(self.dim_axes) + self._local_wrap_dims:
            lo, hi = self.ghost[d]
            o = o.narrow(lead + d, lo, o.shape[lead + d] - lo - hi)
        return o

    def _call_local(self, blocks):
        outs = self._local(*blocks)
        return outs if isinstance(outs, tuple) else (outs,)

    def _overlap_shard(self, raw, ext, out_fields, leads_in):
        """One shard's outputs from the bulk (raw block) and the edge bands
        recomputed from thin strips of the extended block."""
        outs = list(self._call_local(raw))
        for d in self.dim_axes:
            lo, hi = self.ghost[d]
            for side, width in ((0, lo), (1, hi)):
                if not width:
                    continue
                strips = []
                for a, ld in zip(ext, leads_in):
                    e = a.shape[ld + d]
                    # the strip of ext covering the edge band and its reach
                    strips.append(a.narrow(ld + d, 0, 2 * lo + hi)
                                  if side == 0 else
                                  a.narrow(ld + d, e - (lo + 2 * hi),
                                           lo + 2 * hi))
                s_outs = self._call_local(strips)
                for k, (f, so) in enumerate(zip(out_fields, s_outs)):
                    lf = spatial_lead(f)
                    n_s = so.shape[lf + d]
                    band = (so.narrow(lf + d, lo, lo) if side == 0
                            else so.narrow(lf + d, n_s - 2 * hi, hi))
                    # the strip spans the extended extent in the other
                    # sharded dims; trim to the local extent
                    for d2 in self.dim_axes:
                        if d2 == d:
                            continue
                        lo2, hi2 = self.ghost[d2]
                        band = band.narrow(lf + d2, lo2,
                                           band.shape[lf + d2] - lo2 - hi2)
                    o = outs[k].clone()
                    n_o = o.shape[lf + d]
                    tgt = [slice(None)] * o.dim()
                    tgt[lf + d] = (slice(0, lo) if side == 0
                                   else slice(n_o - hi, n_o))
                    o[tuple(tgt)] = band
                    outs[k] = o
        return tuple(outs)

    def __call__(self, *arrays, **kw_arrays):
        in_fields = self.op.forward_input_fields
        out_fields = self.op.forward_output_fields
        names = [f.name for f in in_fields]
        if kw_arrays:
            if arrays:
                raise TypeError("pass fields either positionally or by name, "
                                "not both")
            arrays = tuple(kw_arrays[n] for n in names)
        sharded_in = isinstance(arrays[0], ShardedArray)
        leads_in = [spatial_lead(f) for f in in_fields]
        pads = None
        if sharded_in:
            locals_ = [ShardedArray(a.blocks, self.mesh,
                                    self.partition_spec(f))
                       for a, f in zip(arrays, in_fields)]
            true_spatial = sharded_global_spatial(in_fields[0], arrays[0])
        else:
            device = arrays[0].device
            true_spatial = sharded_global_spatial(in_fields[0], arrays[0])
            arrays, pads = self._pad_uneven(arrays, in_fields, true_spatial)
            locals_ = [ShardedArray(split_blocks(a, self.mesh,
                                                 self.partition_spec(f)),
                                    self.mesh, self.partition_spec(f))
                       for a, f in zip(arrays, in_fields)]
        # ghost masks test the TRUE extents (pad cells count as ghost)
        global_spatial = self._mask_global or true_spatial
        ext = [self._wrap_extend(extend_with_halo(a, self.dim_axes,
                                                  self.ghost, self.periodic,
                                                  ld), ld)
               for a, ld in zip(locals_, leads_in)]
        per_out = [[] for _ in out_fields]
        for i in range(self.mesh.size):
            if self.overlap:
                outs = self._overlap_shard([a.blocks[i] for a in locals_],
                                           [a.blocks[i] for a in ext],
                                           out_fields, leads_in)
            else:
                outs = tuple(
                    self._slice_back(o, spatial_lead(f))
                    for o, f in zip(self._call_local(
                        [a.blocks[i] for a in ext]), out_fields))
            for k, o in enumerate(outs):
                per_out[k].append(o)
        result = []
        for f, blocks in zip(out_fields, per_out):
            spec = self.partition_spec(f)
            o = mask_global_ghost(ShardedArray(blocks, self.mesh, spec),
                                  self.dim_axes, self.ghost, global_spatial,
                                  periodic=self.periodic,
                                  lead=spatial_lead(f))
            if sharded_in:
                result.append(o)
                continue
            g = gather_blocks(o.blocks, self.mesh, spec, device)
            if pads:
                for d in pads:
                    g = g.narrow(spatial_lead(f) + d, 0, true_spatial[d])
            result.append(g)
        return result[0] if len(result) == 1 else tuple(result)


def sharded_global_spatial(field, arr) -> tuple:
    """The global spatial shape of a global tensor or ``ShardedArray``."""
    if isinstance(arr, ShardedArray):
        return tuple(storage_spatial(field, torch.empty(arr.shape,
                                                        device="meta")))
    return tuple(storage_spatial(field, arr))


def as_blocks(arr, mesh: Mesh, spec) -> list:
    """The blocks of ``arr`` under ``spec``: a ``ShardedArray``'s own, or a
    global tensor's split (differentiable)."""
    if isinstance(arr, ShardedArray):
        return list(arr.blocks)
    return split_blocks(arr, mesh, spec)


def sharded_stepper(op, carry_map: Dict[str, str], stencil: ShardedStencil):
    """``step(state) -> state``: one sweep of ``op`` through a
    ``ShardedStencil``, then its carry map (``ops.stage_chain.
    stage_stepper`` semantics: unmapped state entries pass through)."""
    in_names = [f.name for f in op.forward_input_fields]
    out_names = [f.name for f in op.forward_output_fields]

    def step(state):
        outs = stencil(**{n: state[n] for n in in_names})
        if not isinstance(outs, tuple):
            outs = (outs,)
        env = {**state, **dict(zip(out_names, outs))}
        new = dict(state)
        for dst, src in carry_map.items():
            new[dst] = env[src]
        return new

    return step
