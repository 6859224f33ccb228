"""Symbolic field substrate of the port: a copy of
``pystencils_autodiff_tpu/field.py``, so that the port's symbolic layer is its
own and it imports nothing of the JAX package.

This is the minimal re-implementation of the stencil substrate the reference
(`theHamsta/pystencils_autodiff`) obtains from its external ``pystencils``
dependency (SURVEY.md L1): ``Field``, ``Field.Access`` (a ``sympy.Symbol``
subclass carrying integer spatial offsets and index-dimension components),
layouts, dtypes and staggered-grid origins.  The adjoint-derivation pass
(autodiff.py) and the lowerings (ops/) only ever touch this subset.

Reference parity: pystencils ``Field.create_generic`` /
``Field.create_from_numpy_array`` / ``Field.Access`` (SURVEY.md §1, L1 row).

A Field here is purely symbolic — at runtime fields bind to torch tensors.
Staggering is represented as a per-field *origin* (tuple of half-integer
shifts) rather than half-integer access offsets, so every ``Access`` keeps
integer offsets and lowers to plain shifted slices / tile loads
(SURVEY.md §7 "Hard parts" #6).
"""

from __future__ import annotations

import re
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import sympy as sp

__all__ = ["Field", "FieldType", "fields", "spatial_dims_of", "layout_string",
           "parse_layout"]


class FieldType(Enum):
    GENERIC = "generic"
    # Staggered fields live on cell faces/edges; `origin` carries the shift.
    STAGGERED = "staggered"


def _canonical_dtype(dtype) -> np.dtype:
    if dtype is None:
        return np.dtype("float64")
    return np.dtype(dtype)


def layout_string(layout: Union[str, Sequence[int]], ndim: int) -> Tuple[int, ...]:
    """Normalise a layout spec to a permutation tuple (loop order, outer→inner).

    'c'/'numpy' → row-major (0, 1, ..., ndim-1); 'f'/'fortran' → reversed.
    'soa'/'aos' fix the *index-dim* placement (structure-of-arrays stores
    component planes contiguously: index dims lead) and keep row-major
    spatial order — the index placement itself is returned separately by
    :func:`parse_layout`.
    """
    perm, _ = parse_layout(layout, ndim)
    return perm


def parse_layout(layout: Union[str, Sequence[int]], ndim: int):
    """(spatial permutation, index_major) of a layout spec.

    ``index_major=True`` ("soa") stores index dims LEADING — runtime arrays
    are ``index_shape + spatial`` so component planes are contiguous slices
    (the lowering-friendly layout for many-component fields like D2Q9);
    default AoS stores them trailing.
    """
    if isinstance(layout, str):
        low = layout.lower()
        if low in ("c", "numpy", "row", "aos"):
            return tuple(range(ndim)), False
        if low in ("f", "fortran", "col", "reverse_numpy"):
            return tuple(reversed(range(ndim))), False
        if low == "soa":
            return tuple(range(ndim)), True
        raise ValueError(f"unknown layout {layout!r}")
    perm = tuple(int(i) for i in layout)
    if sorted(perm) != list(range(ndim)):
        raise ValueError(f"layout {perm} is not a permutation of 0..{ndim-1}")
    return perm, False


_OFFSET_RE = re.compile(r"^-?\d+$")


def _fmt_offset(o: int) -> str:
    return str(int(o))


class Field:
    """A symbolic n-dimensional field with spatial and index dimensions.

    Parameters
    ----------
    name:
        Identifier; must be a valid-ish python identifier (used in symbol
        names and generated code).
    spatial_dimensions:
        Number of spatial (grid) dimensions.
    index_shape:
        Shape of trailing per-cell component dimensions, e.g. ``(3,)`` for a
        3-vector field, ``()`` for scalars.
    dtype:
        numpy dtype of the field values (symbolic only; runtime arrays may
        differ, e.g. f32 on the GPU with an f64 CPU oracle).
    layout:
        Loop/memory order of spatial dims, 'c' (default) or 'f' or a
        permutation tuple; 'soa' stores index dims LEADING (runtime arrays
        are ``index_shape + spatial`` — contiguous component planes), the
        default ('aos') trailing.
    origin:
        Per-spatial-dim offset of sample locations in cell units; (0,)*d for
        cell-centred fields, e.g. (0.5, 0) for an x-face staggered field.
    """

    def __init__(
        self,
        name: str,
        spatial_dimensions: int,
        index_shape: Tuple[int, ...] = (),
        dtype=np.float64,
        layout: Union[str, Sequence[int]] = "c",
        origin: Optional[Tuple[float, ...]] = None,
        field_type: FieldType = FieldType.GENERIC,
    ):
        if not name.isidentifier():
            raise ValueError(f"field name {name!r} must be a valid identifier")
        self.name = name
        self.spatial_dimensions = int(spatial_dimensions)
        self.index_shape = tuple(int(s) for s in index_shape)
        self.dtype = _canonical_dtype(dtype)
        self.layout, self.index_major = parse_layout(layout,
                                                     self.spatial_dimensions)
        if self.index_major and not self.index_shape:
            self.index_major = False  # 'soa' on a scalar field is a no-op
        if origin is None:
            origin = (0.0,) * self.spatial_dimensions
        if len(origin) != self.spatial_dimensions:
            raise ValueError("origin must have one entry per spatial dimension")
        self.origin = tuple(float(o) for o in origin)
        if any(o != 0.0 for o in self.origin):
            field_type = FieldType.STAGGERED
        self.field_type = field_type

    # -- basic props ---------------------------------------------------------

    @property
    def index_dimensions(self) -> int:
        return len(self.index_shape)

    @property
    def ndim(self) -> int:
        return self.spatial_dimensions + self.index_dimensions

    @property
    def is_staggered(self) -> bool:
        return self.field_type is FieldType.STAGGERED

    # -- constructors (parity with pystencils factory methods) --------------

    @staticmethod
    def create_generic(
        name: str,
        spatial_dimensions: int,
        dtype=np.float64,
        index_shape: Tuple[int, ...] = (),
        layout="c",
        origin=None,
    ) -> "Field":
        return Field(name, spatial_dimensions, index_shape=index_shape, dtype=dtype,
                     layout=layout, origin=origin)

    @staticmethod
    def create_from_numpy_array(name: str, array, index_dimensions: int = 0) -> "Field":
        """Infer spatial/index split and dtype from an array-like (reference:
        pystencils ``Field.create_from_numpy_array``; SURVEY.md §1 L1)."""
        arr = np.asarray(array) if not hasattr(array, "shape") else array
        shape = tuple(int(s) for s in arr.shape)
        sd = len(shape) - index_dimensions
        if sd <= 0:
            raise ValueError("array has fewer dims than index_dimensions")
        return Field(name, sd, index_shape=shape[sd:],
                     dtype=np.dtype(str(getattr(arr, "dtype", "float64")).replace("torch.", "")))

    # -- access creation -----------------------------------------------------

    @property
    def center(self) -> "Field.Access":
        return Field.Access(self, (0,) * self.spatial_dimensions, ())

    def __getitem__(self, offsets) -> "Field.Access":
        """Access at integer *storage* offsets — or, per dim, a fractional
        *physical* offset that resolves against this field's staggering
        origin (SURVEY.md hard-part #6): ``vx[0.5, 0]`` on a field with
        ``origin=(0.5, 0)`` is storage offset ``(0, 0)``; on a cell-centred
        field it is rejected because no sample exists there.  Integer
        components always mean storage offsets (the established staggered
        convention of the model library)."""
        if not isinstance(offsets, tuple):
            offsets = (offsets,)
        if len(offsets) != self.spatial_dimensions:
            raise ValueError(
                f"{self.name}: expected {self.spatial_dimensions} offsets, got {len(offsets)}")
        offs = []
        for d, o in enumerate(offsets):
            oi = int(o)
            if oi == o:
                offs.append(oi)
                continue
            st = float(o) - self.origin[d]
            if st != int(st):
                raise ValueError(
                    f"{self.name}[{offsets}]: physical offset {o} in dim {d} "
                    f"does not land on this field's grid (origin "
                    f"{self.origin[d]}); samples exist at origin + integers")
            offs.append(int(st))
        return Field.Access(self, tuple(offs), ())

    def __call__(self, *index) -> "Field.Access":
        """Access index components at the centre: ``v(0)`` is component 0."""
        return self.center(*index)

    def neighbor(self, dim: int, offset: int) -> "Field.Access":
        offs = [0] * self.spatial_dimensions
        offs[dim] = int(offset)
        return Field.Access(self, tuple(offs), ())

    # -- identity ------------------------------------------------------------

    def _fingerprint(self) -> tuple:
        """Everything about a field that affects lowering of its accesses.

        Used to key the Access instance cache: two same-named fields with
        different fingerprints must NOT share cached Access symbols (sympy's
        global Symbol cache is keyed by name alone, which would silently
        retarget ``.field`` on accesses inside previously built ops).
        """
        return (
            self.name,
            self.spatial_dimensions,
            self.index_shape,
            str(self.dtype),
            self.layout,
            self.index_major,
            self.origin,
        )

    def __eq__(self, other):
        return (
            isinstance(other, Field)
            and self.name == other.name
            and self.spatial_dimensions == other.spatial_dimensions
            and self.index_shape == other.index_shape
        )

    def __hash__(self):
        return hash((self.name, self.spatial_dimensions, self.index_shape))

    def __repr__(self):
        idx = f", index_shape={self.index_shape}" if self.index_shape else ""
        stag = f", origin={self.origin}" if self.is_staggered else ""
        return f"Field({self.name!r}, {self.spatial_dimensions}D{idx}{stag})"

    # -- the access symbol ---------------------------------------------------

    class Access(sp.Symbol):
        """A read/write access ``f[o0, o1, ...](i0, ...)``.

        Subclasses ``sympy.Symbol`` so accesses are first-class atoms in
        expressions: ``sp.diff(rhs, access)`` works, which is the operation
        the whole adjoint derivation is built on (reference
        ``_autodiff.py`` ≈L150, SURVEY.md §3.1).

        The symbol name encodes (field, offsets, index) so sympy's equality
        semantics do the right thing.

        Instance caching is done HERE, keyed by (name, field fingerprint),
        bypassing sympy's global Symbol cache: that cache is keyed by name
        alone, so a later Field with the same name but different
        index_shape/dtype/layout would be handed the cached instance and
        ``obj.field = field`` would silently retarget accesses inside
        already-built ops.
        """

        _instances: dict = {}

        def __new__(cls, field: "Field", offsets: Tuple[int, ...], index: Tuple[int, ...]):
            offsets = tuple(int(o) for o in offsets)
            index = tuple(int(i) for i in index)
            if len(index) > field.index_dimensions:
                raise ValueError(f"{field.name}: too many index components {index}")
            for i, s in zip(index, field.index_shape):
                if not (0 <= i < s):
                    raise IndexError(f"{field.name}: index {index} out of range {field.index_shape}")
            name = f"{field.name}[{','.join(_fmt_offset(o) for o in offsets)}]"
            if index:
                name += f"({','.join(str(i) for i in index)})"
            key = (name, field._fingerprint())
            cached = cls._instances.get(key)
            if cached is not None:
                return cached
            obj = sp.Symbol.__xnew__(cls, name)
            obj.field = field
            obj.offsets = offsets
            obj.index = index
            cls._instances[key] = obj
            return obj

        # sympy caches Symbol instances; getnewargs must rebuild identically.
        def __getnewargs_ex__(self):
            return ((self.field, self.offsets, self.index), {})

        def _hashable_content(self):
            # Distinguish same-named accesses of *different* fields in
            # sympy's eyes.  The instance cache above dedups per
            # fingerprint, but sympy's global operation cache (cacheit on
            # Add/Mul/...) compares by _hashable_content — name alone would
            # hand an expression built for an earlier same-named field
            # (e.g. layout 'c') to a later one (layout 'f'), silently
            # retargeting every atom inside it (the same hazard as in the
            # instance cache).
            return (sp.Symbol._hashable_content(self)
                    + (self.field._fingerprint(),))

        def __call__(self, *index):
            if self.index:
                raise ValueError("index components already specified")
            return Field.Access(self.field, self.offsets, tuple(int(i) for i in index))

        @property
        def is_center(self) -> bool:
            return all(o == 0 for o in self.offsets)

        @property
        def physical_position(self) -> Tuple[float, ...]:
            """Sample position in physical cell units: storage offset plus
            the field's staggering origin."""
            return tuple(o + og for o, og
                         in zip(self.offsets, self.field.origin))

        def shifted(self, shift: Sequence[int]) -> "Field.Access":
            """Return this access translated by ``shift`` (used by the adjoint
            transposition: ``shift(expr, -offset)``, SURVEY.md §3.1)."""
            if len(shift) != len(self.offsets):
                raise ValueError("shift rank mismatch")
            return Field.Access(
                self.field,
                tuple(o + int(s) for o, s in zip(self.offsets, shift)),
                self.index,
            )

        def at_index(self, *index) -> "Field.Access":
            return Field.Access(self.field, self.offsets, tuple(int(i) for i in index))

        def _latex(self, printer=None):
            sub = ",".join(str(o) for o in self.offsets)
            base = self.field.latex_name if hasattr(self.field, "latex_name") else self.field.name
            s = f"{{{base}}}_{{{sub}}}"
            if self.index:
                s += f"^{{{','.join(str(i) for i in self.index)}}}"
            return s


def fields(spec: str, spatial_dimensions: int = 2, dtype=np.float64, **kwargs):
    """Convenience constructor: ``u, v = fields('u, v', 2)``;
    ``vel = fields('vel(3)', 3)`` makes a 3-vector field.

    Parity with pystencils' ``fields()`` helper (SURVEY.md §1 L1).
    """
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(\w+)(?:\((\d+(?:\s*,\s*\d+)*)\))?$", part)
        if not m:
            raise ValueError(f"cannot parse field spec {part!r}")
        name, idx = m.group(1), m.group(2)
        index_shape = tuple(int(x) for x in idx.split(",")) if idx else ()
        out.append(Field(name, spatial_dimensions, index_shape=index_shape,
                         dtype=dtype, **kwargs))
    return out[0] if len(out) == 1 else tuple(out)


def spatial_dims_of(accesses) -> int:
    dims = {a.field.spatial_dimensions for a in accesses}
    if len(dims) != 1:
        raise ValueError(f"mixed spatial dimensionality: {dims}")
    return dims.pop()
