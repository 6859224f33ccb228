"""Field-array management: allocation, ghost layers: the port of
``pystencils_autodiff_tpu/datahandling.py``.

Capability parity with the pystencils ``DataHandling`` the reference builds
on and records (SURVEY.md §2.1 #14): create tensors for symbolic fields,
carry ghost-layer conventions and place them on a device mesh, in the JAX
package's functional style: the state is a dict of tensors, and
``set_array`` / ``fill_interior`` *replace* a stored tensor instead of
writing into it, so a dict taken earlier by ``state()`` keeps its values
(and autograd can differentiate through the replacements).  On a mesh
every array is a ``parallel.ShardedArray``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .field import Field
from .field_tensor_conversion import numpy_dtype

__all__ = ["DataHandling"]


class DataHandling:
    """Allocate and track tensors for a set of symbolic fields.

    Parameters
    ----------
    domain_size:
        Interior spatial shape (without ghost frame).
    ghost_layers:
        (lo, hi) per dim or a single int applied symmetrically.
    default_dtype:
        ``torch.dtype`` of fields added without one.
    device:
        Where the tensors live: the card unless the caller asks for
        another device (``device="cpu"``).
    mesh / dim_axes:
        Optional device mesh (``parallel.make_mesh``) and spatial-dim →
        axis map; arrays are then split over the mesh
        (``parallel.shard_array``; a global extent, ghost frame included,
        must divide its mesh axis) and allocated on the mesh's first
        device.
    """

    def __init__(self, domain_size: Sequence[int], ghost_layers=1,
                 default_dtype=torch.float32, device="cuda",
                 mesh=None, dim_axes: Optional[Dict[int, str]] = None):
        self.mesh = mesh
        self.dim_axes = dict(dim_axes or {})
        if mesh is not None:
            device = mesh.device_list[0]
        self.domain_size = tuple(int(s) for s in domain_size)
        nd = len(self.domain_size)
        if isinstance(ghost_layers, int):
            self.ghost = tuple((ghost_layers, ghost_layers) for _ in range(nd))
        else:
            self.ghost = tuple((int(a), int(b)) for a, b in ghost_layers)
        self.default_dtype = default_dtype
        self.device = torch.device(device)
        self.fields: Dict[str, Field] = {}
        self.arrays: Dict[str, torch.Tensor] = {}

    @property
    def shape_with_ghost(self) -> Tuple[int, ...]:
        return tuple(s + lo + hi
                     for s, (lo, hi) in zip(self.domain_size, self.ghost))

    def _interior(self) -> Tuple[slice, ...]:
        return tuple(slice(lo, s - hi) for (lo, hi), s
                     in zip(self.ghost, self.shape_with_ghost))

    def add_field(self, name: str, index_shape: Tuple[int, ...] = (),
                  dtype=None, init=0.0, origin=None) -> Field:
        """Register a field and allocate its tensor (ghost frame included,
        index dims trailing); ``init`` (a number or an array) broadcasts
        over it like ``jnp.full``."""
        dtype = dtype or self.default_dtype
        f = Field(name, len(self.domain_size), index_shape=index_shape,
                  dtype=numpy_dtype(dtype), origin=origin)
        self.fields[name] = f
        shape = self.shape_with_ghost + tuple(index_shape)
        arr = torch.empty(shape, dtype=dtype, device=self.device)
        arr.copy_(torch.as_tensor(init, dtype=dtype, device=self.device))
        self.arrays[name] = self._place(arr, f)
        return f

    def _place(self, arr: torch.Tensor, f: Field):
        """``arr`` split over the mesh (a tensor as it is without one)."""
        if self.mesh is None or not self.dim_axes:
            return arr
        from .parallel.sharding import field_spec, shard_array

        for d, ax in self.dim_axes.items():
            n = self.mesh.shape[ax]
            if arr.shape[d] % n:
                lo, hi = self.ghost[d]
                raise ValueError(
                    f"dim {d}: global extent {arr.shape[d]} (interior "
                    f"{self.domain_size[d]} + ghost {lo}+{hi}) must divide the "
                    f"{n}-way mesh axis {ax!r}; choose a domain size with "
                    f"interior + ghost ≡ 0 (mod {n})")
        return shard_array(arr, self.mesh,
                           field_spec(f, self.dim_axes, len(self.domain_size)))

    def _global(self, name: str) -> torch.Tensor:
        a = self.arrays[name]
        return a if isinstance(a, torch.Tensor) else a.full()

    def add_arrays(self, spec: str, dtype=None):
        """``dh.add_arrays('u, v(2)')`` — parity with the pystencils helper."""
        from .field import fields as _fields

        fs = _fields(spec, len(self.domain_size))
        fs = fs if isinstance(fs, tuple) else (fs,)
        out = tuple(self.add_field(f.name, f.index_shape, dtype=dtype)
                    for f in fs)
        return out if len(out) > 1 else out[0]

    def set_array(self, name: str, value) -> None:
        """Replace ``name``'s tensor by ``value`` (converted to its dtype and
        device; the stored tensor is not written)."""
        old = self.arrays[name]
        arr = torch.as_tensor(value, dtype=old.dtype, device=self.device)
        if tuple(arr.shape) != tuple(old.shape):
            raise ValueError(f"{name}: expected shape {tuple(old.shape)}, "
                             f"got {tuple(arr.shape)}")
        self.arrays[name] = self._place(arr, self.fields[name])

    def fill_interior(self, name: str, value) -> None:
        """Replace ``name``'s tensor by a copy whose interior is ``value``."""
        arr = self._global(name).clone()
        arr[self._interior()] = value
        self.arrays[name] = self._place(arr, self.fields[name])

    def interior(self, name: str) -> torch.Tensor:
        """The interior of field ``name``: its tensor with the ghost frame
        cut off (a view of the global tensor)."""
        return self._global(name)[self._interior()]

    def state(self) -> Dict[str, torch.Tensor]:
        """The state dict passed into time loops."""
        return dict(self.arrays)

    def update(self, new_state: Dict[str, torch.Tensor]) -> None:
        """Replace the tensors of the fields named in ``new_state`` (a state
        dict a time loop returned); names that are not fields are ignored."""
        for k, v in new_state.items():
            if k in self.arrays:
                self.arrays[k] = v

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    def __repr__(self):
        inner = ", ".join(f"{n}{list(self.arrays[n].shape)}" for n in self.arrays)
        return (f"DataHandling(domain={self.domain_size}, ghost={self.ghost}, "
                f"device={self.device}, fields=[{inner}])")
