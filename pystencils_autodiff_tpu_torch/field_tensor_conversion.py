"""Moving field arrays into the port.

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

from typing import Dict

import numpy as np
import torch

from .ops.common import storage_spatial

__all__ = ["from_jax_arrays"]


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
