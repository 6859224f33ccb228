"""PyTorch backends: the port of
``pystencils_autodiff_tpu/backends/_torch.py``.

* ``native=False`` (``backend="torch"``): ``AutoDiffOp.torch_function``,
  the ``psat::stencil`` custom op.
* ``native=True`` (``backend="torch_native"``): on CUDA tensors the same
  ``torch_function`` (the port's window kernel, ``ops/cuda_kernel.py``,
  behind the custom op that ``torch.export`` and ``torch.compile`` see);
  on CPU tensors a ``torch.autograd.Function`` over
  ``TorchNativeFunctionPair``, the generated C kernels compiled into the
  op's ``TorchModule`` (PyTorch operators called through the C++
  dispatcher; the tensors' memory is used in place).  CUDA tensors never
  reach the C kernels, and neither device runs the plain version.  A
  failed extension build raises; ``extension=False`` asks for the ctypes
  route (``_c_native.NativeFunctionPair`` on numpy views of the tensors).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.common import backward_programs, forward_program
from ..ops.cuda_kernel import on_card
from ._c_native import NativeFunctionPair, exact_vjp, numpy_masked

__all__ = ["create_autograd_function", "TorchNativeFunctionPair",
           "torch_dtype_to_numpy", "numpy_dtype_to_torch"]


def torch_dtype_to_numpy(dtype) -> np.dtype:
    """The numpy dtype of a ``torch.dtype``."""
    return np.dtype(str(dtype).replace("torch.", ""))


def numpy_dtype_to_torch(dtype) -> torch.dtype:
    """The ``torch.dtype`` of a numpy dtype."""
    return getattr(torch, np.dtype(dtype).name)


class TorchNativeFunctionPair:
    """The op's C kernels on CPU tensors with the exact VJP's glue:
    ``forward(**tensors) -> {output: tensor}`` and ``backward(cotangents,
    saved) -> {input: gradient}`` — through the op's ``TorchModule``
    (built here; a failed build raises), or with ``extension=False``
    through ``NativeFunctionPair`` (ctypes, one per float type) on numpy
    views.  ``dtype`` (a ``torch.dtype``, a numpy dtype or its name) casts
    the inputs first; None keeps theirs."""

    def __init__(self, op, dtype=None, extension: bool = True):
        from .astnodes import TorchModule

        self.op = op
        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = numpy_dtype_to_torch(dtype)
        self.dtype = dtype
        self.fwd_prog = forward_program(op)
        self.bwd_progs = backward_programs(op)
        # prints the C kernels: a 'soa' field raises here on either route
        self.module = TorchModule(op.op_name, op)
        self.is_extension = extension
        self.loaded = self.module.compile() if extension else None
        self._ctypes: Dict[np.dtype, NativeFunctionPair] = {}
        self.in_names = self.fwd_prog.input_names
        self.out_names = self.fwd_prog.output_names

    def _cast(self, tensors: Dict[str, torch.Tensor]):
        if self.dtype is None:
            return tensors
        return {k: v.to(self.dtype) for k, v in tensors.items()}

    def _numpy_pair(self, dtype: torch.dtype) -> NativeFunctionPair:
        dt = torch_dtype_to_numpy(dtype)
        if dt not in self._ctypes:
            self._ctypes[dt] = NativeFunctionPair(self.op, dtype=dt)
        return self._ctypes[dt]

    def forward(self, **tensors) -> Dict[str, torch.Tensor]:
        """The op's outputs from its inputs by keyword (CPU tensors, cast
        to the pair's dtype): the extension's operators, or the ctypes
        route."""
        tensors = self._cast(tensors)
        if self.loaded is not None:
            return self.loaded.call_forward(**tensors)
        pair = self._numpy_pair(tensors[self.in_names[0]].dtype)
        outs = pair.forward(**_numpy(tensors))
        return {k: torch.from_numpy(v) for k, v in outs.items()}

    def __call__(self, **tensors):
        return self.forward(**tensors)

    def backward(self, cotangents: Dict[str, torch.Tensor],
                 saved: Dict[str, torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        """Gradients of the forward inputs (the non-constant ones) from the
        outputs' cotangents and the saved primals (``exact_vjp``)."""
        saved = self._cast(saved or {})
        cotangents = self._cast(cotangents)
        ref = next(iter(cotangents.values()))
        if self.loaded is None:
            grads = self._numpy_pair(ref.dtype).backward(
                _numpy(cotangents), _numpy(saved))
            return {k: torch.from_numpy(v) for k, v in grads.items()}
        spatial = tuple(ref.shape[: self.fwd_prog.ndim])
        return exact_vjp(
            self.op, self.bwd_progs,
            {k: v.contiguous() for k, v in cotangents.items()},
            {k: v.contiguous() for k, v in saved.items()},
            lambda i, ins: self.loaded.call_backward_stage(i, **ins),
            numpy_masked(self.fwd_prog, torch.zeros_like),
            lambda f: ref.new_zeros(spatial + f.index_shape))


def _numpy(tensors):
    return {k: v.detach().contiguous().numpy() for k, v in tensors.items()}


def create_autograd_function(autodiff_op, native: bool = False, dtype=None,
                             extension: bool = True, **kwargs):
    """``apply(*tensors)`` (or ``apply(**{field: tensor})``) differentiable
    by torch autograd, inputs ordered by ``autodiff_op.forward_input_fields``
    (``apply.input_names``).  ``native=False`` is ``torch_function(dtype=
    dtype, **kwargs)``; ``native=True`` runs CUDA tensors through that same
    function and CPU tensors through the ``TorchNativeFunctionPair``
    behind a ``torch.autograd.Function`` (``apply.function_class``,
    ``apply.pair``)."""
    if not native:
        return autodiff_op.torch_function(dtype=dtype, **kwargs)
    if kwargs:
        raise TypeError(f"backend='torch_native': unknown option(s) "
                        f"{sorted(kwargs)}")
    from ..autodiff import _wrap_layout_permutations

    pair = TorchNativeFunctionPair(autodiff_op, dtype=dtype,
                                   extension=extension)
    on_cuda = autodiff_op.torch_function(dtype=dtype)
    in_names, out_names = pair.in_names, pair.out_names
    # the forward inputs a backward stage reads
    saved_names = {f.name for p in pair.bwd_progs
                   for f in p.input_fields} & set(in_names)
    constant = {f.name for f in autodiff_op.constant_fields}

    class NativeOp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *tensors):
            outs = pair.forward(**dict(zip(in_names, tensors)))
            # the saved primals through save_for_backward: autograd's
            # version counters catch an in-place change before backward
            ctx.saved_input_names = [n for n in in_names if n in saved_names]
            ctx.save_for_backward(*(t for n, t in zip(in_names, tensors)
                                    if n in saved_names))
            ctx.in_dtypes = [t.dtype for t in tensors]
            res = tuple(outs[n] for n in out_names)
            return res if len(res) > 1 else res[0]

        @staticmethod
        def backward(ctx, *grad_outputs):
            cots = dict(zip(out_names, grad_outputs))
            saved = dict(zip(ctx.saved_input_names, ctx.saved_tensors))
            grads = pair.backward(cots, saved)
            return tuple(grads[n].to(dt) if n in grads and n not in constant
                         else None for n, dt in zip(in_names, ctx.in_dtypes))

    def apply(*tensors, **kw_tensors):
        if kw_tensors:
            if tensors:
                raise TypeError("pass fields either positionally or by name, "
                                "not both")
            if set(kw_tensors) != set(in_names):
                raise TypeError(f"expected fields {in_names}, got "
                                f"{sorted(kw_tensors)}")
            tensors = tuple(kw_tensors[n] for n in in_names)
        if len(tensors) != len(in_names):
            raise TypeError(f"expected {len(in_names)} inputs {in_names}, got "
                            f"{len(tensors)}")
        return NativeOp.apply(*tensors)

    apply.input_names = in_names
    apply.output_names = out_names
    apply.op = autodiff_op
    apply.forward_program = pair.fwd_prog
    apply.backward_program = pair.bwd_progs[-1]
    apply.__name__ = autodiff_op.op_name
    if all(f.layout == tuple(range(f.spatial_dimensions))
           for f in autodiff_op.forward_input_fields
           + autodiff_op.forward_output_fields):
        on_cpu = apply
    else:
        # the C kernels index in logical order, as torch_function's do
        on_cpu = _wrap_layout_permutations(autodiff_op, apply)

    positional = [f.name for f in autodiff_op.forward_input_fields]

    def fn(*tensors, **kw_tensors):
        first = tensors[0] if tensors else next(iter(kw_tensors.values()),
                                                None)
        if first is None or not on_card(first):
            return on_cpu(*tensors, **kw_tensors)
        # constant fields get no gradient (None), as on the CPU route
        tensors = tuple(t.detach() if n in constant else t
                        for n, t in zip(positional, tensors))
        kw_tensors = {n: t.detach() if n in constant else t
                      for n, t in kw_tensors.items()}
        return on_cuda(*tensors, **kw_tensors)

    for attr in ("input_names", "output_names", "op", "forward_program",
                 "backward_program", "__name__"):
        setattr(fn, attr, getattr(apply, attr))
    fn.function_class = NativeOp
    fn.pair = pair
    fn.cuda_function = on_cuda
    return fn
