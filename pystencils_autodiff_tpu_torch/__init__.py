"""pystencils_autodiff_tpu_torch — the differentiable stencil framework on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper GPUs.

The symbolic layer (fields, assignments, the adjoint derivation) is the
port's own copy of the JAX package's (``field``, ``assignment``,
``adjoint_field``, ``autodiff``); the port adds the torch lowerings
(``ops``), the CUDA code generator and build route (``codegen``, ``csrc``)
and ``AutoDiffOp.torch_function``.  This package imports torch, sympy and
numpy — never jax, and nothing of ``pystencils_autodiff_tpu``.
"""

from .assignment import Assignment, AssignmentCollection
from .autodiff import AutoDiffOp, DiffModes, create_backward_assignments
from .field import Field, fields
from .field_tensor_conversion import from_jax_arrays

__all__ = [
    "Field",
    "fields",
    "Assignment",
    "AssignmentCollection",
    "DiffModes",
    "create_backward_assignments",
    "AutoDiffOp",
    "from_jax_arrays",
]
