"""Lowerings: stencil programs → functions on torch tensors.

* ``make_torch_stencil`` — the plain PyTorch version (``torch_ref.py``);
* ``make_cuda_stencil`` — the hand-written CUDA kernel (``cuda_kernel.py``);
  raises on tensors that are not on a CUDA device;
* ``make_stencil`` — what the op uses: the kernel for CUDA tensors, the
  plain version for CPU tensors, decided per call from the first input's
  device;
* ``fused_time_chain`` / ``fused_chain_vjp`` — k steps (and their
  gradient) per call through the chain kernels (``time_chain.py``,
  ``adjoint_chain.py``, ``twin_adjoint.py``, and for 3D states too wide
  for a box tile or ops the twins reject the z-streaming kernel,
  ``plane_adjoint.py``), dispatched on the device the same way;
* ``fused_stage_chain`` / ``fused_stage_chain_vjp`` — k cycles of a
  sequence of ops with in-chain boundary conditions (and their gradient)
  through the stage kernels (``stage_chain.py``, ``stage_adjoint.py``,
  ``chain_bc.py``).

The op, the fused chains and the stage chains launch through
``torch.library`` custom ops (``custom_ops.py``), whose CUDA and CPU
kernels PyTorch's dispatcher picks by device.
"""

from __future__ import annotations

from .common import (StencilProgram, backward_program, backward_programs,
                     forward_program, make_program)
from .adjoint_chain import fused_chain_vjp, transposed_linear_op
from .chain_bc import ChainBC, apply_bc_sequential, normalize_chain_bcs
from .cuda_kernel import check_strategy, make_cuda_stencil, on_device
from .plane_adjoint import (make_plane_adjoint_kernel,
                            make_plane_chain_kernel, stream_geometry)
from .stage_adjoint import fused_stage_chain_vjp, validate_bc_invariance
from .stage_chain import fused_stage_chain, stage_stepper
from .time_chain import fused_time_chain
from .torch_ref import make_torch_stencil
from .vjp import build_autograd_function

__all__ = [
    "StencilProgram",
    "make_program",
    "forward_program",
    "backward_program",
    "backward_programs",
    "make_torch_stencil",
    "make_cuda_stencil",
    "make_stencil",
    "build_autograd_function",
    "fused_time_chain",
    "fused_chain_vjp",
    "transposed_linear_op",
    "make_plane_adjoint_kernel",
    "make_plane_chain_kernel",
    "stream_geometry",
    "fused_stage_chain",
    "fused_stage_chain_vjp",
    "stage_stepper",
    "validate_bc_invariance",
    "ChainBC",
    "normalize_chain_bcs",
    "apply_bc_sequential",
]


def make_stencil(program: StencilProgram, strategy=None, tile_rows=None,
                 **kwargs):
    """Dispatch on the inputs' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; nothing is moved between devices.
    ``strategy``/``tile_rows`` choose the kernel's form
    (``make_cuda_stencil``); the plain version computes the same function
    whatever they are, and ``"tiled"`` raises where the kernel would."""
    check_strategy(program, strategy, kwargs.get("periodic", False))
    fn = on_device(make_cuda_stencil(program, strategy=strategy,
                                     tile_rows=tile_rows, **kwargs),
                   make_torch_stencil(program, **kwargs),
                   program.input_fields[0].name)
    fn.program = program
    fn.__name__ = f"stencil_{program.name}"
    return fn
