"""The generated C kernels on numpy arrays: the port of
``pystencils_autodiff_tpu/backends/_c_native.py``.

A ``StencilProgram`` is printed as C (``codegen/c_printer.py``), compiled
with g++ (``codegen/jit.py``) and called through ctypes on numpy arrays:
the CPU path by name, a correctness oracle independent of the plain
PyTorch version, and the kernels of the torch and TensorFlow extensions
(``astnodes.py``).  Arrays pass as raw pointers plus a shape vector, in
logical order with trailing index dims (AoS).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from ..adjoint_field import AdjointField
from ..codegen.c_printer import generate_c_source, kernel_symbol_name
from ..codegen.jit import compile_and_load
from ..ops.common import backward_programs, forward_program, is_staged_backward

__all__ = ["make_c_stencil", "create_native_function_pair", "NativeKernel",
           "NativeFunctionPair", "external_backward_inputs", "exact_vjp",
           "numpy_masked"]

_PTR = {
    np.dtype("float64"): ctypes.POINTER(ctypes.c_double),
    np.dtype("float32"): ctypes.POINTER(ctypes.c_float),
}


def external_backward_inputs(op, progs):
    """The backward programs' inputs that come from outside (cotangents
    and saved primals), in first-read order: a staged backward's
    intermediates flow from stage to stage."""
    inter = (set(op.backward_assignments.intermediate_fields)
             if is_staged_backward(op) else set())
    seen, out = set(), []
    for p in progs:
        for f in p.input_fields:
            if f not in inter and f not in seen:
                seen.add(f)
                out.append(f)
    return out


def exact_vjp(op, progs, cotangents, saved, run_stage, masked, zeros):
    """The exact VJP of the op's interior-only forward through its compiled
    backward stages, the glue every bridge shares: each output's cotangent
    zeroed outside the forward interior (``masked(c, field)``), the
    previous adjoint of an accumulation (``time_constant_fields``) that has
    no cotangent starting at zero within a step (``zeros(field)``), the
    saved primals for the rest; then ``run_stage(i, {input: array})`` for
    each stage in order, a stage reading what the earlier ones wrote.
    Returns the gradients by forward input name (the non-constant ones)."""
    env = {}
    for f in external_backward_inputs(op, progs):
        if isinstance(f, AdjointField):
            primal = f.corresponding_forward_field
            env[f.name] = (masked(cotangents[primal.name], primal)
                           if primal.name in cotangents else zeros(primal))
        else:
            env[f.name] = saved[f.name]
    for i, prog in enumerate(progs):
        env.update(run_stage(i, {n: env[n] for n in prog.input_names}))
    return {f.corresponding_forward_field.name: env[f.name]
            for f in op.backward_output_fields}


def numpy_masked(fwd_prog, zeros_like=np.zeros_like):
    """``masked(c, field)`` for ``exact_vjp`` on arrays that slice as numpy
    does (numpy arrays, torch tensors with ``torch.zeros_like``)."""
    sl = fwd_prog.interior_slices()

    def masked(c, field):
        m = zeros_like(c)
        m[sl] = c[sl]
        return m

    return masked


class NativeKernel:
    """A compiled C kernel for one (program, domain mode, dtype):
    ``kernel({field: array}) -> {output: array}``."""

    def __init__(self, program, full_domain: bool = False, dtype=np.float64):
        self.program = program
        self.full_domain = full_domain
        self.dtype = np.dtype(dtype)
        if self.dtype not in _PTR:
            raise NotImplementedError(f"{program.name}: the C kernels take "
                                      f"float32 or float64, got {self.dtype}")
        self.source = generate_c_source(program, full_domain,
                                        dtype=self.dtype, extern_c=True)
        self.lib = compile_and_load(self.source,
                                    name_hint=f"c_{program.name}")
        self._fn = getattr(self.lib, kernel_symbol_name(program, full_domain))
        ptr = _PTR[self.dtype]
        n_in, n_out = len(program.input_fields), len(program.output_fields)
        self._fn.argtypes = [ptr] * (n_in + n_out) + [
            ctypes.POINTER(ctypes.c_longlong)]
        self._fn.restype = None

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        prog = self.program
        arrays, spatial = [], None
        for f in prog.input_fields:
            a = np.ascontiguousarray(inputs[f.name], dtype=self.dtype)
            if spatial is None:
                spatial = a.shape[: f.spatial_dimensions]
            want = tuple(spatial) + tuple(f.index_shape)
            if a.shape != want:
                raise ValueError(f"{prog.name}: input {f.name!r} has shape "
                                 f"{a.shape}, expected {want}")
            arrays.append(a)
        outs = [np.empty(tuple(spatial) + tuple(f.index_shape), self.dtype)
                for f in prog.output_fields]
        shape = (ctypes.c_longlong * len(spatial))(*spatial)
        ptr = _PTR[self.dtype]
        self._fn(*[a.ctypes.data_as(ptr) for a in arrays],
                 *[o.ctypes.data_as(ptr) for o in outs], shape)
        return dict(zip(prog.output_names, outs))


def make_c_stencil(program, full_domain: bool = False, dtype=None,
                   adjoint_mask_ghost=None):
    """``fn({field: array}) -> {output: array}`` through the C kernel (one
    per dtype, built at its first call), with the exact VJP's cotangent
    mask where ``adjoint_mask_ghost`` is given: adjoint inputs are zeroed
    outside that (forward) interior first."""
    kern = {}

    def fn(inputs):
        arrs = {k: np.asarray(v) for k, v in inputs.items()}
        if adjoint_mask_ghost is not None:
            for f in program.input_fields:
                if isinstance(f, AdjointField):
                    a = arrs[f.name]
                    sl = tuple(slice(lo, a.shape[d] - hi) for d, (lo, hi)
                               in enumerate(adjoint_mask_ghost))
                    m = np.zeros_like(a)
                    m[sl + (Ellipsis,)] = a[sl + (Ellipsis,)]
                    arrs[f.name] = m
        dt = np.dtype(dtype) if dtype else arrs[program.input_fields[0].name].dtype
        if dt not in kern:
            kern[dt] = NativeKernel(program, full_domain, dt)
        return kern[dt](arrs)

    fn.program = program
    fn.__name__ = f"c_{program.name}"
    return fn


class NativeFunctionPair:
    """The op's compiled forward (interior) and backward (full domain, every
    stage of a staged backward in order) C kernels with the exact VJP's
    glue on numpy: ``forward(**arrays)``, ``backward(cotangents, saved)``."""

    def __init__(self, op, dtype=np.float64):
        self.op = op
        self.dtype = np.dtype(dtype)
        self.fwd_prog = forward_program(op)
        self.bwd_progs = backward_programs(op)
        self.bwd_prog = self.bwd_progs[-1]
        self.forward_kernel = NativeKernel(self.fwd_prog, False, self.dtype)
        self.backward_kernels = [NativeKernel(p, True, self.dtype)
                                 for p in self.bwd_progs]
        self.backward_kernel = self.backward_kernels[-1]

    def forward(self, **inputs) -> Dict[str, np.ndarray]:
        """The op's outputs from its inputs by keyword (numpy arrays): the
        interior-mode forward kernel."""
        return self.forward_kernel(inputs)

    def __call__(self, **inputs) -> Dict[str, np.ndarray]:
        return self.forward(**inputs)

    def backward(self, cotangents: Dict[str, np.ndarray],
                 saved: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, np.ndarray]:
        """Gradients of the forward inputs (the non-constant ones) from the
        outputs' cotangents and the saved primals (``exact_vjp``)."""
        ref = np.asarray(next(iter(cotangents.values())))
        spatial = ref.shape[: self.fwd_prog.ndim]
        return exact_vjp(
            self.op, self.bwd_progs,
            {k: np.asarray(v, dtype=self.dtype)
             for k, v in cotangents.items()}, saved or {},
            lambda i, ins: self.backward_kernels[i](ins),
            numpy_masked(self.fwd_prog),
            lambda f: np.zeros(spatial + f.index_shape, self.dtype))


def create_native_function_pair(op, dtype=np.float64) -> NativeFunctionPair:
    """``NativeFunctionPair(op, dtype)``: the op's generated C kernels on
    numpy arrays of ``dtype``."""
    return NativeFunctionPair(op, dtype=dtype)
