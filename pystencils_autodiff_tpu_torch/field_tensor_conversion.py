"""Array-like ⇄ Field coercion and moving field arrays into the port.

The reference's helpers (``ArrayWrapper``, ``is_array_like``,
``create_field_from_array_like``, ``coerce_to_field``, ``to_numpy``,
``torch_tensor_from_field``, ``tf_constant_from_field``,
``tf_variable_from_field``, ``tf_placeholder_from_field``; copies of the
JAX package's ``field_tensor_conversion.py``) build the symbolic ``Field``
matching an array — a numpy array, a torch tensor or any object with
``shape`` and ``dtype`` — and a tensor matching a field, on an explicit
device (TensorFlow's are on its default device; TensorFlow is imported
when one is called).

``from_jax_arrays`` takes the JAX side's field arrays — state and
coefficients such as κ, this library's "weights" — as numpy arrays and
returns torch tensors on the requested device, in each field's own storage
layout (AoS or SoA index dims, spatial layout), checked against the field
declarations of an op, of a stage list (``[(op, carry_map), ...]``: every
stage's fields) or of a stage chain (``ops.fused_stage_chain``, or its
``StagePlan``: the chain state, BC parameter planes — masks, wall
velocities, damping — included).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .field import Field
from .ops.common import storage_shape, storage_spatial

__all__ = [
    "ArrayWrapper",
    "is_array_like",
    "create_field_from_array_like",
    "coerce_to_field",
    "to_numpy",
    "torch_tensor_from_field",
    "tf_constant_from_field",
    "tf_variable_from_field",
    "tf_placeholder_from_field",
    "from_jax_arrays",
]


class ArrayWrapper:
    """Wrap an array with field annotations (index_dimensions, layout) that
    plain arrays cannot carry (reference ≈L120)."""

    def __init__(self, array, index_dimensions: int = 0, layout="c"):
        self.array = array
        self.index_dimensions = index_dimensions
        self.layout = layout

    def __array__(self, dtype=None):
        return np.asarray(self.array, dtype=dtype)

    @property
    def shape(self):
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype a field declares for an array's ``dtype`` (numpy,
    torch or a name); ``torch.bfloat16``, which numpy lacks, is tracked as
    float32 symbolically."""
    s = str(dtype)
    if s.startswith("torch."):
        s = s[len("torch."):]
    if s == "bfloat16":
        s = "float32"
    if s.startswith("<dtype: "):  # tf dtype repr
        s = s[len("<dtype: "):].strip("'>")
    return np.dtype(s)


def _dtype_of(array) -> np.dtype:
    dt = getattr(array, "dtype", None)
    return np.dtype("float64") if dt is None else numpy_dtype(dt)


def is_array_like(obj) -> bool:
    if isinstance(obj, ArrayWrapper):
        return True
    return (hasattr(obj, "shape") and hasattr(obj, "dtype")
            and not isinstance(obj, Field))


def create_field_from_array_like(name: str, array,
                                 index_dimensions: Optional[int] = None,
                                 layout="c") -> Field:
    """Infer a symbolic Field from any array-like (numpy / torch / ...).

    ``index_dimensions`` splits trailing dims into per-cell components
    (e.g. 1 for a vector field stored as (..., 3)).
    """
    if isinstance(array, ArrayWrapper):
        if index_dimensions is None:
            index_dimensions = array.index_dimensions
        layout = array.layout
        array = array.array
    if index_dimensions is None:
        index_dimensions = 0
    shape = tuple(int(s) for s in array.shape)
    sd = len(shape) - index_dimensions
    if sd <= 0:
        raise ValueError(f"array rank {len(shape)} too small for "
                         f"{index_dimensions} index dimensions")
    return Field(name, sd, index_shape=shape[sd:], dtype=_dtype_of(array),
                 layout=layout)


def coerce_to_field(name: str, obj) -> Field:
    if isinstance(obj, Field):
        return obj
    if is_array_like(obj):
        return create_field_from_array_like(name, obj)
    raise TypeError(f"cannot coerce {type(obj)} to Field")


def to_numpy(array) -> np.ndarray:
    """Host-side numpy copy of any supported array type (a bfloat16
    tensor comes back as float32, as its field declares it)."""
    if isinstance(array, torch.Tensor):
        t = array.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if type(array).__module__.startswith("tensorflow"):
        return array.numpy()
    return np.asarray(array)


def torch_tensor_from_field(field: Field, spatial_shape,
                            requires_grad: bool = False, device="cuda"):
    """A zero tensor for ``field`` over ``spatial_shape`` (index dims placed
    as the field stores them) on ``device`` — the card unless the caller
    asks for another device."""
    dt = getattr(torch, field.dtype.name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"field {field.name!r}: no torch dtype for "
                        f"{field.dtype}")
    t = torch.zeros(storage_shape(field, spatial_shape), dtype=dt,
                    device=device)
    return t.requires_grad_(requires_grad)


def tf_constant_from_field(field: Field, spatial_shape, init=0):
    """A TensorFlow constant for ``field`` over ``spatial_shape`` (index
    dims placed as the field stores them), filled with ``init``."""
    import tensorflow as tf

    return tf.constant(init, dtype=field.dtype.name,
                       shape=storage_shape(field, spatial_shape),
                       name=field.name)


def tf_variable_from_field(field: Field, spatial_shape, init=0):
    """A TensorFlow variable for ``field`` over ``spatial_shape``, filled
    with ``init``."""
    import tensorflow as tf

    return tf.Variable(tf.fill(storage_shape(field, spatial_shape),
                               tf.constant(init, dtype=field.dtype.name)),
                       name=field.name)


def tf_placeholder_from_field(field: Field, spatial_shape):
    """The reference's placeholder: TensorFlow 2 has none, so a
    ``tf.TensorSpec`` of the field's shape and dtype (what a
    ``tf.function``'s input signature takes)."""
    import tensorflow as tf

    return tf.TensorSpec(shape=storage_shape(field, spatial_shape),
                         dtype=field.dtype.name, name=field.name)


def _declared_fields(target):
    """``(name, {field name: Field})`` of an op, a stage list or a stage
    chain."""
    from .ops.stage_chain import StagePlan

    plan = target if isinstance(target, StagePlan) else getattr(
        target, "plan", None)
    if isinstance(plan, StagePlan):
        return plan.name, dict(plan.state_fields)
    if isinstance(target, (list, tuple)):
        fields = {}
        for op, _ in target:
            for f in op.forward_fields:
                fields.setdefault(f.name, f)
        return "+".join(op.op_name for op, _ in target), fields
    return target.op_name, {f.name: f for f in target.forward_fields}


def from_jax_arrays(op, arrays: Dict[str, np.ndarray], device,
                    dtype=None) -> Dict[str, torch.Tensor]:
    """``{field name: array}`` → ``{field name: tensor}`` on ``device``.

    ``op``: an ``AutoDiffOp``, a stage list or a stage chain (see the module
    doc); names must be among its fields.  Each array
    keeps its storage layout; its rank and index dims must match the
    field's declaration (index dims leading for ``layout='soa'``, trailing
    otherwise) and all arrays must share one spatial shape.  ``dtype``
    (a ``torch.dtype``) converts; the default keeps the array's dtype."""
    what, fields = _declared_fields(op)
    out: Dict[str, torch.Tensor] = {}
    spatial_shapes = {}
    for name, arr in arrays.items():
        if name not in fields:
            raise KeyError(f"{name!r} is not a field of {what}; "
                           f"fields are {sorted(fields)}")
        f = fields[name]
        arr = np.asarray(arr)
        sd, ni = f.spatial_dimensions, f.index_dimensions
        if arr.ndim != sd + ni:
            raise ValueError(f"field {name!r}: expected rank {sd + ni} "
                             f"({sd} spatial + {ni} index dims), got "
                             f"{arr.ndim}")
        index_major = getattr(f, "index_major", False)
        got_idx = tuple(arr.shape[:ni]) if index_major else tuple(arr.shape[sd:])
        if got_idx != f.index_shape:
            where = "leading" if index_major else "trailing"
            raise ValueError(f"field {name!r}: {where} index dims {got_idx} "
                             f"!= declared index_shape {f.index_shape}")
        spatial_shapes[name] = storage_spatial(f, arr)
        t = torch.tensor(arr, device=device)  # a copy: arr may be read-only
        out[name] = t if dtype is None else t.to(dtype)
    if len(set(spatial_shapes.values())) > 1:
        raise ValueError(
            f"all fields must share one spatial shape; got {spatial_shapes}")
    return out
