"""A mesh of devices in one process, and arrays split over it — the port's
counterpart of ``jax.sharding.Mesh`` and of a ``NamedSharding``-placed
array.

JAX's mesh is single-controller: one process holds the whole mesh and
``shard_map`` runs the local function on every shard.  So is this one: a
``Mesh`` is an array of ``torch.device``s with axis names, and a
``ShardedArray`` holds one block per mesh position, on that position's
device, in row-major mesh order.  Several positions may name the same
device (several shards on one card); an axis a spec does not name holds
copies.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "ShardedArray", "normalize_spec", "split_blocks",
           "gather_blocks", "on_global"]


class Mesh:
    """``devices``: a (nested) sequence or object array of devices of the
    mesh's shape; ``axis_names``: one name per mesh axis.  ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = [torch.device(d)
                                       for d in arr.reshape(-1)]
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{arr.ndim}-D mesh")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        """The devices in row-major mesh order (one per shard)."""
        return list(self.devices.reshape(-1))

    def coords(self, i: int) -> Dict[str, int]:
        """Axis name → index of the shard at flat position ``i``."""
        idx = np.unravel_index(i, self.devices.shape)
        return {ax: int(c) for ax, c in zip(self.axis_names, idx)}

    def flat(self, coords: Dict[str, int]) -> int:
        """The flat position of the shard at ``coords`` (missing axes: 0)."""
        return int(np.ravel_multi_index(
            tuple(coords.get(ax, 0) for ax in self.axis_names),
            self.devices.shape))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.device_list]})")



def normalize_spec(spec, ndim: int, mesh: Mesh) -> Tuple:
    """``spec`` (axis names or None, one per array dim from the first, as
    ``PartitionSpec``) padded with None to ``ndim`` entries, checked
    against the mesh."""
    spec = tuple(spec) if spec is not None else ()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the array's "
                         f"{ndim} dims")
    spec = spec + (None,) * (ndim - len(spec))
    named = [ax for ax in spec if ax is not None]
    for ax in named:
        if ax not in mesh.axis_names:
            raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
    if len(set(named)) != len(named):
        raise ValueError(f"spec {spec} names an axis twice")
    return spec


def split_blocks(t: torch.Tensor, mesh: Mesh, spec) -> List[torch.Tensor]:
    """The blocks of ``t`` for every shard of ``mesh`` under ``spec``, each
    moved to its shard's device: views of ``t`` (``torch.split``, whose
    backward is one ``cat`` of the blocks' gradients) where the shard's
    device is ``t``'s; a size-1 axis splits nothing."""
    spec = normalize_spec(spec, t.dim(), mesh)
    named = [(d, ax) for d, ax in enumerate(spec)
             if ax is not None and mesh.shape[ax] > 1]
    for d, ax in named:
        if t.shape[d] % mesh.shape[ax]:
            raise ValueError(
                f"dim {d} of extent {t.shape[d]} does not divide mesh axis "
                f"{ax!r} of size {mesh.shape[ax]}")

    def pieces(x, rest):
        """axis-index tuple (over ``rest``) → block"""
        if not rest:
            return {(): x}
        d, ax = rest[0]
        out = {}
        for i, part in enumerate(x.split(x.shape[d] // mesh.shape[ax], d)):
            for key, b in pieces(part, rest[1:]).items():
                out[(i,) + key] = b
        return out

    parts = pieces(t, named)
    blocks = []
    for i, dev in enumerate(mesh.device_list):
        c = mesh.coords(i)
        blocks.append(parts[tuple(c[ax] for _, ax in named)].to(dev))
    return blocks


def gather_blocks(blocks: Sequence[torch.Tensor], mesh: Mesh, spec,
                  device=None) -> torch.Tensor:
    """The global tensor of ``blocks`` (mesh order) under ``spec``, on
    ``device`` (default: the first block's); copies along unnamed axes are
    taken from index 0, and a size-1 axis joins nothing.  Differentiable
    (``to`` and ``cat``)."""
    spec = normalize_spec(spec, blocks[0].dim(), mesh)
    device = device if device is not None else blocks[0].device
    named = [(d, ax) for d, ax in enumerate(spec) if ax is not None]

    def build(fixed, rest):
        if not rest:
            return blocks[mesh.flat(fixed)].to(device)
        d, ax = rest[0]
        if mesh.shape[ax] == 1:
            return build({**fixed, ax: 0}, rest[1:])
        return torch.cat([build({**fixed, ax: i}, rest[1:])
                          for i in range(mesh.shape[ax])], d)

    return build({}, named)


class ShardedArray:
    """A global array split over a ``Mesh`` by ``spec``: ``blocks[i]`` is
    the block of the shard at flat mesh position ``i``, on that shard's
    device.  The counterpart of a JAX array placed with
    ``NamedSharding(mesh, PartitionSpec(*spec))``.  ``full()`` gathers it
    onto one device."""

    def __init__(self, blocks: Sequence[torch.Tensor], mesh: Mesh, spec):
        self.blocks = list(blocks)
        self.mesh = mesh
        if len(self.blocks) != mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of "
                             f"{mesh.size}")
        self.spec = normalize_spec(spec, self.blocks[0].dim(), mesh)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape."""
        s = list(self.blocks[0].shape)
        for d, ax in enumerate(self.spec):
            if ax is not None:
                s[d] *= self.mesh.shape[ax]
        return tuple(s)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def dim(self) -> int:
        """The number of dims of the global array (``torch.Tensor.dim``)."""
        return self.blocks[0].dim()

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, gathered from the blocks onto ``device``
        (default: the first block's device)."""
        return gather_blocks(self.blocks, self.mesh, self.spec, device)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh!r})")


def on_global(fn, value):
    """``fn`` applied to ``value``'s global tensor: a ``ShardedArray`` is
    gathered, and the result split back over its mesh by its spec
    (differentiable); a tensor is passed as it is."""
    if not isinstance(value, ShardedArray):
        return fn(value)
    out = fn(value.full())
    return ShardedArray(split_blocks(out, value.mesh, value.spec),
                        value.mesh, value.spec)
