"""The port's framework bridges on the CPU against the JAX package, in
float64 (and float32 where stated): the generated C kernels
(``codegen/c_printer.py``, ``backends/_c_native.py``), ``NativeFunctionPair``,
``create_pytorch_op(backend="torch_native")`` on CPU tensors (the C kernels
registered as PyTorch operators, ``backends/astnodes.TorchModule``), the
framework-free ``PybindModule`` and the g++ build route
(``codegen/jit.py``).  The reference is the JAX package's
``jax_function(lowering="jnp")`` and ``jax.vjp`` of the same op
(``torch_jax_twin.jax_twin``).  The TensorFlow bridges are in
``test_torch_bridges_tf.py``; ``torch_native`` on CUDA tensors in
``test_torch_bridges_card.py``."""

import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu.backends import _c_native as jnative
from pystencils_autodiff_tpu.codegen import c_printer as jprinter
from pystencils_autodiff_tpu.ops import common as jcommon
from bridge_ops import mixed_op
from test_torch_op import OPS, _case
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.backends import AVAILABLE_BACKENDS
from pystencils_autodiff_tpu_torch.backends import astnodes
from pystencils_autodiff_tpu_torch.backends._c_native import (
    NativeFunctionPair, NativeKernel, make_c_stencil)
from pystencils_autodiff_tpu_torch.codegen import jit
from pystencils_autodiff_tpu_torch.codegen.c_printer import (
    generate_c_source, kernel_symbol_name)
from pystencils_autodiff_tpu_torch.models import burgers2d_op, heat_step_op
from pystencils_autodiff_tpu_torch.ops import (backward_programs,
                                               forward_program)

RTOL = 1e-10
RTOL32 = 1e-5
C_OPS = {**OPS, "burgers2d": lambda: burgers2d_op(dtype="float64")}


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _jax_value_and_vjp(op, ins, cots):
    """The JAX package's outputs and input gradients (storage layout)."""
    f = jax_twin(op).jax_function(lowering="jnp")
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    outs = out if isinstance(out, tuple) else (out,)
    grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _logical(f, a):
    """A field's storage array in logical order (the C kernels' order)."""
    if f.layout == tuple(range(f.spatial_dimensions)):
        return a
    inv = tuple(int(i) for i in np.argsort(f.layout))
    return np.transpose(a, inv + tuple(range(f.spatial_dimensions, a.ndim)))


# ---------------------------------------------------------- generated C --

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(C_OPS))
def test_c_kernels_match_jax(name, dtype):
    """``NativeFunctionPair``'s forward (interior mode) and backward (full
    domain, cotangents masked to the forward interior; every stage of a
    staged backward) equal the JAX package's value and VJP everywhere,
    ghost cells included: rtol 1e-10 in float64; in float32 (the inputs
    rounded) rtol 1e-5, atol 1e-5 of max |ref|.  A 'soa' field raises in
    both packages' C printers."""
    op = C_OPS[name]()
    ins, cots = _case(op)
    if any(getattr(f, "index_major", False) for f in op.forward_fields):
        for printer, prog in ((generate_c_source, forward_program(op)),
                              (jprinter.generate_c_source,
                               jcommon.forward_program(jax_twin(op)))):
            with pytest.raises(NotImplementedError, match="soa"):
                printer(prog, False)
        return
    dt = np.dtype(dtype)
    ins = [a.astype(dt).astype(np.float64) for a in ins]
    cots = [c.astype(dt).astype(np.float64) for c in cots]
    ref_out, ref_grads = _jax_value_and_vjp(op, ins, cots)
    pair = NativeFunctionPair(op, dtype=dt)
    in_f, out_f = op.forward_input_fields, op.forward_output_fields
    arrays = {f.name: _logical(f, a).astype(dt) for f, a in zip(in_f, ins)}
    outs = pair.forward(**arrays)
    grads = pair.backward({f.name: _logical(f, c).astype(dt)
                           for f, c in zip(out_f, cots)}, saved=arrays)
    rtol = RTOL if dt == np.float64 else RTOL32
    for f, r in zip(out_f, ref_out):
        assert outs[f.name].dtype == dt
        _close(outs[f.name], _logical(f, r), rtol)
    diff = {f.name for f in op.diff_fields}
    assert set(grads) == diff
    for f, r in zip(in_f, ref_grads):
        if f.name in diff:
            _close(grads[f.name], _logical(f, r), rtol)


def test_c_kernels_equal_the_jax_packages_c_kernels():
    """The port's and the JAX package's compiled C kernels, float64, on the
    same arrays: equal to rounding (the ``layout='f'`` op in logical order,
    as both index it; both printers take AoS index dims)."""
    for name in ("layout_f", "heat_kappa", "tfmad", "accum"):
        op = C_OPS[name]()
        ins, cots = _case(op, seed=3)
        arrays = {f.name: _logical(f, a)
                  for f, a in zip(op.forward_input_fields, ins)}
        cot = {f.name: _logical(f, c)
               for f, c in zip(op.forward_output_fields, cots)}
        mine = NativeFunctionPair(op)
        theirs = jnative.NativeFunctionPair(jax_twin(op))
        a, b = mine.forward(**arrays), theirs.forward(**arrays)
        for n in a:
            _close(a[n], b[n])
        ga, gb = mine.backward(cot, arrays), theirs.backward(cot, arrays)
        assert set(ga) == set(gb)
        for n in ga:
            _close(ga[n], gb[n])


def test_c_source_structure():
    """Symbol names as the JAX package's, the OpenMP loop nest, ``memset``
    of the ghost frame in interior mode only, ``__restrict__`` pointers,
    the C signature (inputs, outputs, shape) and C linkage on request; the
    arithmetic printed by the CUDA printer's body struct."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    jop = jax_twin(op)
    fwd, bwd = forward_program(op), backward_programs(op)[0]
    for prog, jprog, full in ((fwd, jcommon.forward_program(jop), False),
                              (bwd, jcommon.backward_program(jop), True)):
        assert kernel_symbol_name(prog, full) == \
            jprinter.kernel_symbol_name(jprog, full)
    src = generate_c_source(fwd, False)
    assert "#pragma omp parallel for collapse(2)" in src
    assert "memset(u_next_out, 0" in src
    assert "for (long long i0 = 1; i0 < s0 - 1; ++i0)" in src
    assert ("void heat_step2d_fwd_interior(const double* __restrict__ kappa, "
            "const double* __restrict__ u, double* __restrict__ u_next_out, "
            "const long long* shape)") in src
    assert "struct PsatBody" in src and 'extern "C"' not in src
    full = generate_c_source(bwd, True, np.float32, extern_c=True)
    assert "memset" not in full and "for (long long i0 = 0; i0 < s0;" in full
    assert 'extern "C" void heat_step2d_bwd_full(const float*' in full
    assert "Reader<float, " in full and ", true> c{" in full
    assert "#pragma omp" not in generate_c_source(fwd, False, openmp=False)
    assert "#include <cmath>" not in generate_c_source(fwd, False,
                                                       preamble=False)


def test_make_c_stencil_masks_adjoints():
    """``make_c_stencil`` with ``adjoint_mask_ghost`` equals the backward
    kernel on cotangents masked by hand (the exact VJP's mask)."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    fwd, bwd = forward_program(op), backward_programs(op)[0]
    rng = np.random.default_rng(4)
    arrays = {f.name: rng.standard_normal((11, 9)) for f in bwd.input_fields}
    got = make_c_stencil(bwd, True, adjoint_mask_ghost=fwd.ghost)(arrays)
    adj = bwd.input_fields[0].name
    masked = np.zeros_like(arrays[adj])
    masked[fwd.interior_slices()] = arrays[adj][fwd.interior_slices()]
    ref = NativeKernel(bwd, True)({**arrays, adj: masked})
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n])
    with pytest.raises(ValueError, match="expected"):
        NativeKernel(fwd)({"u": arrays[adj], "kappa": arrays[adj][:, :4]})


# ---------------------------------------------------------- torch_native --

@pytest.fixture(scope="module")
def heat_native():
    """The κ-heat op and its torch_native function (one extension build)."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    return op, op.create_pytorch_op(backend="torch_native")


@pytest.fixture(scope="module")
def mixed_native():
    op = mixed_op()
    return op, op.create_pytorch_op(backend="torch_native")


def _native_value_and_grads(fn, ins, cots, dtype=torch.float64):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in ins]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c, dtype=dtype)
                                           for c in cots], allow_unused=True)
    return ([o.detach().double().numpy() for o in outs],
            [None if g is None else g.double().numpy() for g in grads])


def test_torch_native_is_the_extension(heat_native):
    """The CPU kernels are the compiled operators: ``TORCH_LIBRARY`` under
    a per-source namespace, float32 and float64 in one library, called
    through ``torch.ops``."""
    op, fn = heat_native
    pair = fn.pair
    assert pair.is_extension
    src = pair.module.extension_source
    assert f"TORCH_LIBRARY({pair.module.namespace}, m)" in src
    assert f"TORCH_LIBRARY_IMPL({pair.module.namespace}, CPU, m)" in src
    assert "f64::heat_step2d_fwd_interior(" in src
    assert "f32::heat_step2d_bwd_full(" in src
    assert "Python.h" not in src and "pybind11" not in src
    ns = getattr(torch.ops, pair.module.namespace)
    u = torch.ones(5, 6, dtype=torch.float64)
    (out,) = ns.call_forward([u, u])
    assert out.shape == (5, 6) and out[0].abs().sum() == 0
    with pytest.raises(RuntimeError, match="float32 or float64"):
        ns.call_forward([u.half(), u.half()])
    with pytest.raises(RuntimeError, match="has shape"):
        ns.call_forward([u, u[:, :3]])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_native_matches_jax(heat_native, mixed_native, dtype):
    """Value and gradients on CPU tensors equal the JAX package's: the
    κ-heat op and an op with two outputs, index dims, a constant field
    (no gradient) and a staged backward; rtol 1e-10 in float64, 1e-5 with
    atol 1e-5 of max |ref| in float32."""
    rtol = RTOL if dtype == torch.float64 else RTOL32
    for op, fn in (heat_native, mixed_native):
        ins, cots = _case(op, seed=5)
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        ins = [a.astype(np_dt).astype(np.float64) for a in ins]
        cots = [c.astype(np_dt).astype(np.float64) for c in cots]
        ref_out, ref_grads = _jax_value_and_vjp(op, ins, cots)
        outs, grads = _native_value_and_grads(fn, ins, cots, dtype)
        for o, r in zip(outs, ref_out):
            _close(o, r, rtol)
        constant = {f.name for f in op.constant_fields}
        for f, g, r in zip(op.forward_input_fields, grads, ref_grads):
            if f.name in constant:
                assert g is None
            else:
                _close(g, r, rtol)


def test_torch_native_gradcheck(heat_native, mixed_native):
    for op, fn in (heat_native, mixed_native):
        rng = np.random.default_rng(12)
        constant = {f.name for f in op.constant_fields}
        ts = tuple(torch.tensor(rng.standard_normal(
            (6, 7) + f.index_shape), requires_grad=f.name not in constant)
            for f in op.forward_input_fields)
        assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-8)


def test_torch_native_constant_field_gets_none(mixed_native):
    op, fn = mixed_native
    ins, _ = _case(op)
    ts = {f.name: torch.tensor(a, requires_grad=True)
          for f, a in zip(op.forward_input_fields, ins)}
    w, z = fn(**ts)
    (w.sum() + z.square().sum()).backward()
    assert ts["c"].grad is None
    assert ts["k"].grad is not None and ts["v"].grad is not None


def test_torch_native_detects_inplace_mutation(heat_native):
    """Saved primals go through ``save_for_backward``: autograd's version
    counters catch an in-place change before the backward."""
    _, fn = heat_native
    rng = np.random.default_rng(5)
    ts = [torch.tensor(rng.standard_normal((6, 7)), requires_grad=True)
          for _ in fn.input_names]
    out = fn(*ts)
    with torch.no_grad():
        ts[1].add_(1.0)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        out.sum().backward()


def test_torch_native_ctypes_route_and_layouts(heat_native):
    """``extension=False`` runs the C kernels through ctypes on numpy views
    of the tensors: the same bits as the extension.  A 'soa' field raises;
    a ``layout='f'`` field is permuted at the boundary as
    ``torch_function`` permutes it."""
    op, fn = heat_native
    ctypes_fn = op.create_pytorch_op(backend="torch_native", extension=False)
    assert not ctypes_fn.pair.is_extension
    ins, cots = _case(op, seed=8)
    a = _native_value_and_grads(fn, ins, cots)
    b = _native_value_and_grads(ctypes_fn, ins, cots)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(NotImplementedError, match="soa"):
        OPS["vector"]().create_pytorch_op(backend="torch_native",
                                          extension=False)
    lop = OPS["layout_f"]()
    ins, cots = _case(lop)
    ref_out, ref_grads = _jax_value_and_vjp(lop, ins, cots)
    outs, grads = _native_value_and_grads(
        lop.create_pytorch_op(backend="torch_native", extension=False),
        ins, cots)
    for x, r in zip(outs + grads, ref_out + ref_grads):
        _close(x, r)


def test_torch_native_sends_card_tensors_to_torch_function(
        heat_native, mixed_native, monkeypatch):
    """Tensors on the card go through ``torch_function`` (the window kernel
    behind the ``psat::stencil`` custom op), never through the pair's C
    kernels: with ``on_card`` true for every tensor, the pair refuses to
    run, the value and gradients equal ``torch_function``'s bit for bit,
    and a constant field still gets None."""
    from pystencils_autodiff_tpu_torch.backends import _torch as bt

    def refuse(*args, **kwargs):
        raise AssertionError("a C kernel ran")

    monkeypatch.setattr(bt, "on_card", lambda t: True)
    for op, fn in (heat_native, mixed_native):
        monkeypatch.setattr(fn.pair, "forward", refuse)
        monkeypatch.setattr(fn.pair, "backward", refuse)
        ins, cots = _case(op, seed=6)
        got = _native_value_and_grads(fn, ins, cots)
        ref = _native_value_and_grads(op.torch_function(), ins, cots)
        constant = {f.name for f in op.constant_fields}
        for x, y in zip(got[0], ref[0]):
            np.testing.assert_array_equal(x, y)
        for f, x, y in zip(op.forward_input_fields, got[1], ref[1]):
            if f.name in constant:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)


def test_torch_native_build_failure_raises(monkeypatch):
    """A failed extension build reaches the caller; nothing falls back."""
    def fail(*args, **kwargs):
        raise RuntimeError("g++ build of torch_heat_step2d failed: boom")

    monkeypatch.setattr(astnodes, "compile_shared_library", fail)
    op = heat_step_op(kappa_field=True, dtype="float64")
    with pytest.raises(RuntimeError, match="boom"):
        op.create_pytorch_op(backend="torch_native")
    with pytest.raises(RuntimeError, match="boom"):
        astnodes.TorchModule("heat", op).compile()


# ------------------------------------------------------------ PybindModule --

def test_pybind_module_matches_jax():
    """The framework-free extension (``Python.h``, the buffer protocol):
    forward and the chained, masked backward on numpy equal the JAX
    package's."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    mod = astnodes.PybindModule("plainmod", op)
    src = mod.extension_source
    assert "#include <Python.h>" in src and "PyInit_" in src
    assert "PyObject_GetBuffer" in src and "torch" not in src
    loaded = mod.compile()
    ins, cots = _case(op, seed=21)
    names = [f.name for f in op.forward_input_fields]
    ref_out, ref_grads = _jax_value_and_vjp(op, ins, cots)
    _close(loaded.call_forward(**dict(zip(names, ins)))["u_next"], ref_out[0])
    grads = loaded.call_backward({"u_next": cots[0]}, dict(zip(names, ins)))
    for n, r in zip(names, ref_grads):
        _close(grads[n], r)


def test_pybind_module_rejects_bad_buffers():
    op = heat_step_op(kappa_field=True, dtype="float64")
    loaded = astnodes.PybindModule("plainmod", op).compile()
    x = np.random.default_rng(23).standard_normal((6, 7))
    out = np.zeros_like(x)
    with pytest.raises(TypeError, match="itemsize"):
        loaded.raw.call_forward(x.astype(np.float32), x, out)
    with pytest.raises(TypeError, match="expected 2 input"):
        loaded.raw.call_forward(x, out)
    with pytest.raises(ValueError, match="spatial shape"):
        loaded.raw.call_forward(x, x[:, :3].copy(), out)
    with pytest.raises(ValueError, match="C-contiguous"):
        loaded.raw.call_forward(x, x.T, out)


# --------------------------------------------------------------- the rest --

def test_backends_api():
    """The port's backends (no JAX one) and the JAX package's errors on
    unknown backend names."""
    assert AVAILABLE_BACKENDS == ["torch", "torch_native", "tensorflow",
                                  "tensorflow_native"]
    op = heat_step_op(dtype="float64")
    with pytest.raises(ValueError, match="unknown torch backend"):
        op.create_pytorch_op(backend="jax")
    with pytest.raises(ValueError, match="unknown tensorflow backend"):
        op.create_tensorflow_op(backend="torch")
    with pytest.raises(TypeError, match="unknown option"):
        op.create_pytorch_op(backend="torch_native", periodic=True)


def test_jit_cache_and_link(tmp_path):
    """One build per source (the cache under ``build/torch_kernels/``, the
    key over the source, the flags and ``g++ --version``); ``link`` joins
    object files into a library ctypes loads."""
    src = 'extern "C" int psat_jit_probe(int x) { return 3 * x + 1; }\n'
    a = jit.compile_shared_library(src, "jit_probe")
    assert a == jit.compile_shared_library(src, "jit_probe")
    assert a.parent.name == "torch_kernels" and a.exists()
    assert jit.compile_shared_library(src, "jit_probe",
                                      extra_flags=["-O1"]) != a
    assert ctypes.CDLL(str(a)).psat_jit_probe(4) == 13
    (tmp_path / "p.cpp").write_text(src.replace("3 * x", "5 * x"))
    subprocess.run(["g++", "-fPIC", "-c", str(tmp_path / "p.cpp"), "-o",
                    str(tmp_path / "p.o")], check=True)
    lib = jit.link([tmp_path / "p.o"], "jit_probe_linked")
    assert ctypes.CDLL(str(lib)).psat_jit_probe(4) == 21
    with pytest.raises(RuntimeError, match="failed"):
        jit.compile_and_load("int broken(", "jit_broken")


def test_one_build_per_key_whatever_the_name():
    """Within a process a library is its key's: a second caller that hints
    another name gets the library already built (``nvcc.BUILDS`` records
    one build), not a second build of the same source."""
    import time

    from pystencils_autodiff_tpu_torch.codegen import nvcc

    src = (f'extern "C" long psat_key_probe(void) {{ return '
           f'{time.time_ns()}L; }}\n')
    before = len(nvcc.BUILDS)
    a = jit.compile_shared_library(src, "key_probe_a")
    b = jit.compile_shared_library(src, "key_probe_b")
    try:
        assert a == b and a.name.startswith("key_probe_a_")
        assert len(nvcc.BUILDS) == before + 1
        assert nvcc.BUILDS[-1][0] == "key_probe_a"
    finally:
        a.unlink()
