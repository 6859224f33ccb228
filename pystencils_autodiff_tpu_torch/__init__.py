"""pystencils_autodiff_tpu_torch — the differentiable stencil framework on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper GPUs.

The symbolic layer (fields, assignments, the adjoint derivation, operator
composition) is the port's own copy of the JAX package's (``field``,
``assignment``, ``adjoint_field``, ``autodiff``, ``compose``); the port
adds the torch lowerings (``ops``), the CUDA code generator and build route
(``codegen``, ``csrc``), ``AutoDiffOp.torch_function`` and the
app-assembly layer (``datahandling``, ``simulation``,
``graph_datahandling``).  This package imports torch, sympy and numpy —
never jax, and nothing of ``pystencils_autodiff_tpu``.

Public API surface mirrors the reference's ``__init__`` re-exports
(SURVEY.md §2.1 #1), plus ``from_jax_arrays``.
"""

from .adjoint_field import AdjointField
from .assignment import Assignment, AssignmentCollection
from .autodiff import (AutoDiffKernelPair, AutoDiffOp, DiffModes,
                       create_backward_assignments,
                       get_jacobian_of_assignments)
from .compose import compose_ops, fuse_sweeps
from .field import Field, FieldType, fields
from .field_tensor_conversion import (ArrayWrapper, coerce_to_field,
                                      create_field_from_array_like,
                                      from_jax_arrays, is_array_like)

__all__ = [
    "Field",
    "FieldType",
    "fields",
    "Assignment",
    "AssignmentCollection",
    "AdjointField",
    "DiffModes",
    "create_backward_assignments",
    "get_jacobian_of_assignments",
    "AutoDiffOp",
    "AutoDiffKernelPair",
    "compose_ops",
    "fuse_sweeps",
    "ArrayWrapper",
    "create_field_from_array_like",
    "coerce_to_field",
    "is_array_like",
    "from_jax_arrays",
]
