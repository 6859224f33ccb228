"""Framework binding modules: generated translation units around the C
kernels, the port of ``pystencils_autodiff_tpu/backends/astnodes.py``.

Each module bundles an op's generated kernels (``codegen/c_printer.py``)
with framework glue, and ``.compile()`` returns the loaded module:

* ``TorchModule`` registers the kernels as PyTorch operators
  (``TORCH_LIBRARY`` / ``TORCH_LIBRARY_IMPL(..., CPU, ...)``, float32 and
  float64 in one library), built with g++ against PyTorch's headers and
  loaded with ``torch.ops.load_library``: calls go through PyTorch's C++
  dispatcher, the tensors' memory is read and written in place, and no
  ``Python.h`` or pybind11 is needed.
* ``TensorflowModule`` is a TensorFlow custom-op library (``REGISTER_OP`` +
  ``OpKernel`` + shape functions), built with ``tf.sysconfig``'s flags and
  loaded with ``tf.load_op_library``.
* ``PybindModule`` is a framework-free CPython extension (``Python.h`` and
  the buffer protocol: any C-contiguous array binds without a copy).  No
  entry point of the port uses it: it is kept for parity with the JAX
  package's module of that name.

jinja2, torch's build flags and TensorFlow are imported inside the
functions that need them.
"""

from __future__ import annotations

import hashlib
import re
from typing import List

import numpy as np

from ..codegen.c_printer import (CTYPE, c_preamble, generate_c_source,
                                 kernel_symbol_name)
from ..codegen.jit import compile_shared_library
from ..ops.common import backward_programs, forward_program
from ._c_native import exact_vjp, numpy_masked

__all__ = ["TorchModule", "TensorflowModule", "PybindModule"]

_FLOATS = (np.dtype("float32"), np.dtype("float64"))


def _render(template: str, **kw) -> str:
    import jinja2

    return jinja2.Template(template, keep_trailing_newline=True).render(**kw)


def _digest(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
    return h.hexdigest()[:16]


def _kernel_specs(fwd_prog, bwd_progs, module_name: str) -> List[dict]:
    """Template data for each kernel: its call name, C symbol, input names
    and every field's index shape (the storage is AoS: spatial dims, then
    index dims)."""
    def spec(prog, full, name, doc):
        return {"name": name, "doc": doc,
                "kernel": kernel_symbol_name(prog, full),
                "inputs": [{"name": f.name, "index": list(f.index_shape)}
                           for f in prog.input_fields],
                "outputs": [{"name": f.name, "index": list(f.index_shape)}
                            for f in prog.output_fields]}

    specs = [spec(fwd_prog, False, "call_forward",
                  f"{module_name} forward stencil")]
    specs += [spec(p, True, f"call_backward_s{i}",
                   f"{module_name} adjoint stencil pass {i}")
              for i, p in enumerate(bwd_progs)]
    return specs


def _kernel_sources(fwd_prog, bwd_progs, dtype) -> str:
    """Every kernel of the op in one float type, without the preamble."""
    return "\n".join(
        [generate_c_source(fwd_prog, False, dtype, preamble=False)]
        + [generate_c_source(p, True, dtype, preamble=False)
           for p in bwd_progs])


_TORCH_TEMPLATE = '''\
// Generated PyTorch operators for {{ op_name }}: the op's C kernels in
// float32 and float64, registered with the dispatcher for CPU tensors.
{{ preamble }}
#include <torch/library.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <vector>

namespace f32 {
{{ f32_source }}
}  // namespace f32
namespace f64 {
{{ f64_source }}
}  // namespace f64

{% for spec in kernels %}
// {{ spec.doc }}
static std::vector<at::Tensor> {{ spec.name }}(const std::vector<at::Tensor>& inputs) {
  TORCH_CHECK(inputs.size() == {{ spec.inputs | length }},
              "{{ op_name }} {{ spec.name }}: expected {{ spec.inputs | length }} inputs, got ", inputs.size());
  const at::ScalarType st = inputs[0].scalar_type();
  TORCH_CHECK(st == at::kFloat || st == at::kDouble,
              "{{ op_name }} {{ spec.name }}: the C kernels take float32 or float64, got ", st);
  TORCH_CHECK(inputs[0].dim() == {{ ndim + (spec.inputs[0].index | length) }},
              "{{ op_name }} {{ spec.name }}: input '{{ spec.inputs[0].name }}' must have rank {{ ndim + (spec.inputs[0].index | length) }}");
  long long shape[{{ ndim }}];
  for (int d = 0; d < {{ ndim }}; ++d) shape[d] = inputs[0].size(d);
  std::vector<at::Tensor> t;
  t.reserve(inputs.size());
{% for i in spec.inputs %}  {
    const at::Tensor& a = inputs[{{ loop.index0 }}];
    TORCH_CHECK(a.scalar_type() == st && a.device() == inputs[0].device(),
                "{{ op_name }} {{ spec.name }}: input '{{ i.name }}' must be ", st, " on ", inputs[0].device());
    bool ok = a.dim() == {{ ndim + (i.index | length) }};
    for (int d = 0; ok && d < {{ ndim }}; ++d) ok = a.size(d) == shape[d];
{% for n in i.index %}    ok = ok && a.size({{ ndim + loop.index0 }}) == {{ n }};
{% endfor %}    TORCH_CHECK(ok, "{{ op_name }} {{ spec.name }}: input '{{ i.name }}' has shape ", a.sizes(),
                ", expected the spatial shape of '{{ spec.inputs[0].name }}'{% if i.index %} and index dims {{ i.index }}{% endif %}");
    t.push_back(a.contiguous());
  }
{% endfor %}  std::vector<at::Tensor> outs;
{% for o in spec.outputs %}  outs.push_back(at::empty({ {% for d in range(ndim) %}shape[{{ d }}], {% endfor %}{% for n in o.index %}{{ n }}, {% endfor %}}, inputs[0].options()));
{% endfor %}  if (st == at::kDouble) {
    f64::{{ spec.kernel }}({% for i in spec.inputs %}t[{{ loop.index0 }}].data_ptr<double>(), {% endfor %}{% for o in spec.outputs %}outs[{{ loop.index0 }}].data_ptr<double>(), {% endfor %}shape);
  } else {
    f32::{{ spec.kernel }}({% for i in spec.inputs %}t[{{ loop.index0 }}].data_ptr<float>(), {% endfor %}{% for o in spec.outputs %}outs[{{ loop.index0 }}].data_ptr<float>(), {% endfor %}shape);
  }
  return outs;
}
{% endfor %}
TORCH_LIBRARY({{ namespace }}, m) {
{% for spec in kernels %}  m.def("{{ spec.name }}(Tensor[] inputs) -> Tensor[]");
{% endfor %}}

TORCH_LIBRARY_IMPL({{ namespace }}, CPU, m) {
{% for spec in kernels %}  m.impl("{{ spec.name }}", &{{ spec.name }});
{% endfor %}}
'''


def torch_build_flags():
    """(include and library flags, link flags) of a source built against
    the running PyTorch's headers and libraries."""
    from pathlib import Path

    import torch

    root = Path(torch.__file__).resolve().parent
    inc = [root / "include", root / "include" / "torch" / "csrc" / "api"
           / "include"]
    lib = root / "lib"
    abi = int(getattr(torch._C, "_GLIBCXX_USE_CXX11_ABI", True))
    # the version keys the cached library to the PyTorch it was built for
    flags = [f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             f"-DPSAT_TORCH_VERSION={torch.__version__}",
             *(f"-I{p}" for p in inc), f"-L{lib}", f"-Wl,-rpath,{lib}"]
    return flags, ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]


class TorchModule:
    """The op's C kernels as PyTorch operators in one library
    (``TORCH_LIBRARY(<namespace>, m)`` with ``call_forward`` and
    ``call_backward_s<i>``, each ``(Tensor[] inputs) -> Tensor[]``, the
    float type taken from the inputs).  ``.compile()`` builds and loads it
    (a failed build raises) and returns the loaded module:
    ``call_forward(**tensors)`` and ``call_backward_stage(i, **tensors)``
    on CPU tensors, each returning ``{output: tensor}``; ``.raw`` is
    ``torch.ops.<namespace>``.  ``TorchNativeFunctionPair`` chains the
    stages (``_c_native.exact_vjp``)."""

    def __init__(self, module_name: str, autodiff_op):
        self.module_name = module_name
        self.op = autodiff_op
        self.fwd_prog = forward_program(autodiff_op)
        self.bwd_progs = backward_programs(autodiff_op)
        self.bwd_prog = self.bwd_progs[-1]
        self.sources = {
            dt.name: _kernel_sources(self.fwd_prog, self.bwd_progs, dt)
            for dt in _FLOATS}
        self.kernels = _kernel_specs(self.fwd_prog, self.bwd_progs,
                                     module_name)
        source = _render(_TORCH_TEMPLATE, op_name=module_name,
                         preamble=c_preamble(), ndim=self.fwd_prog.ndim,
                         f32_source=self.sources["float32"],
                         f64_source=self.sources["float64"],
                         kernels=self.kernels, namespace="PSAT_NAMESPACE")
        self.namespace = "psat_native_" + _digest(source)
        self.extension_source = source.replace("PSAT_NAMESPACE",
                                               self.namespace)

    def _load_extension(self):
        import torch

        flags, libs = torch_build_flags()
        so = compile_shared_library(
            self.extension_source, name_hint=f"torch_{self.module_name}",
            extra_flags=flags, post_flags=libs)
        torch.ops.load_library(str(so))
        return getattr(torch.ops, self.namespace)

    def compile(self):
        """Build and load the operators; the loaded module."""
        fwd_in = self.fwd_prog.input_names
        fwd_out = self.fwd_prog.output_names
        stages = [(p.input_names, p.output_names) for p in self.bwd_progs]
        ops = self._load_extension()
        module = self

        class Loaded:
            raw = ops
            extension_source = module.extension_source
            is_extension = True
            n_backward_stages = len(stages)

            def call_forward(self, **tensors):
                return dict(zip(fwd_out, ops.call_forward(
                    [tensors[n] for n in fwd_in])))

            def call_backward_stage(self, i, **tensors):
                fn = getattr(ops, f"call_backward_s{i}")
                return dict(zip(stages[i][1], fn(
                    [tensors[n] for n in stages[i][0]])))

        return Loaded()


_TF_TEMPLATE = '''\
// Generated TensorFlow custom ops for {{ op_name }}: REGISTER_OP and an
// OpKernel for each of the op's C kernels ({{ tf_dtype }}, CPU).
{{ preamble }}
#include "tensorflow/core/framework/op.h"
#include "tensorflow/core/framework/op_kernel.h"
#include "tensorflow/core/framework/shape_inference.h"

using namespace tensorflow;

{{ kernel_source }}

{% for spec in ops %}
REGISTER_OP("{{ spec.tf_name }}")
{% for i in spec.inputs %}    .Input("{{ i.name | lower }}: {{ tf_dtype }}")
{% endfor %}{% for o in spec.outputs %}    .Output("{{ o.name | lower }}_out: {{ tf_dtype }}")
{% endfor %}    .SetShapeFn([](shape_inference::InferenceContext* c) {
        shape_inference::ShapeHandle sp, out;
        TF_RETURN_IF_ERROR(c->Subshape(c->input(0), 0, {{ ndim }}, &sp));
{% for o in spec.outputs %}        TF_RETURN_IF_ERROR(c->Concatenate(sp, c->MakeShape({ {{ o.index | join(", ") }} }), &out));
        c->set_output({{ loop.index0 }}, out);
{% endfor %}        return absl::OkStatus();
    });

class {{ spec.tf_name }}Op : public OpKernel {
 public:
  explicit {{ spec.tf_name }}Op(OpKernelConstruction* ctx) : OpKernel(ctx) {}
  void Compute(OpKernelContext* ctx) override {
    const TensorShape& shp0 = ctx->input(0).shape();
    OP_REQUIRES(ctx, shp0.dims() >= {{ ndim }},
                errors::InvalidArgument("{{ spec.tf_name }}: input 0 has rank < {{ ndim }}"));
    long long shape[{{ ndim }}];
    TensorShape spatial;
    for (int d = 0; d < {{ ndim }}; ++d) {
      shape[d] = shp0.dim_size(d);
      spatial.AddDim(shape[d]);
    }
{% for i in spec.inputs %}    {
      TensorShape want = spatial;
{% for n in i.index %}      want.AddDim({{ n }});
{% endfor %}      OP_REQUIRES(ctx, ctx->input({{ loop.index0 }}).shape() == want,
                  errors::InvalidArgument("{{ spec.tf_name }}: input '{{ i.name }}' has shape ",
                                          ctx->input({{ loop.index0 }}).shape().DebugString(),
                                          ", expected ", want.DebugString()));
    }
{% endfor %}{% for o in spec.outputs %}    Tensor* out_{{ loop.index0 }} = nullptr;
    {
      TensorShape s = spatial;
{% for n in o.index %}      s.AddDim({{ n }});
{% endfor %}      OP_REQUIRES_OK(ctx, ctx->allocate_output({{ loop.index0 }}, s, &out_{{ loop.index0 }}));
    }
{% endfor %}    {{ spec.kernel }}(
{% for i in spec.inputs %}        ctx->input({{ loop.index0 }}).flat<{{ ctype }}>().data(),
{% endfor %}{% for o in spec.outputs %}        out_{{ loop.index0 }}->flat<{{ ctype }}>().data(),
{% endfor %}        shape);
  }
};
REGISTER_KERNEL_BUILDER(Name("{{ spec.tf_name }}").Device(DEVICE_CPU), {{ spec.tf_name }}Op);
{% endfor %}
'''


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in re.split(r"[\W_]+", name) if p)


def _snake(name: str) -> str:
    """The Python name TensorFlow gives an op named ``name``."""
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_",
                  name).lower()


class TensorflowModule:
    """The op's C kernels as one TensorFlow custom-op library in one float
    type: ``<Name>Fwd`` and ``<Name>Bwd<i>`` (every backward stage), each
    input and output a tensor.  ``.compile()`` builds it with
    ``tf.sysconfig``'s flags and returns ``tf.load_op_library``'s module;
    ``fwd_fn(lib)`` / ``bwd_fns(lib)`` its functions."""

    def __init__(self, module_name: str, autodiff_op, dtype=np.float64):
        self.module_name = module_name
        self.op = autodiff_op
        self.dtype = np.dtype(dtype)
        if self.dtype not in _FLOATS:
            raise NotImplementedError(f"{module_name}: the C kernels take "
                                      f"float32 or float64, got {self.dtype}")
        self.fwd_prog = forward_program(autodiff_op)
        self.bwd_progs = backward_programs(autodiff_op)
        self.bwd_prog = self.bwd_progs[-1]
        kernel_source = _kernel_sources(self.fwd_prog, self.bwd_progs,
                                        self.dtype)
        specs = _kernel_specs(self.fwd_prog, self.bwd_progs, module_name)
        base = _camel(module_name) + _digest(kernel_source)[:8].capitalize()
        self.fwd_tf_name = base + "Fwd"
        self.bwd_tf_names = [f"{base}Bwd{i}" for i in
                             range(len(self.bwd_progs))]
        self.bwd_tf_name = self.bwd_tf_names[-1]
        for spec, name in zip(specs, [self.fwd_tf_name] + self.bwd_tf_names):
            spec["tf_name"] = name
        self.source = _render(_TF_TEMPLATE, op_name=module_name,
                              preamble=c_preamble(), ndim=self.fwd_prog.ndim,
                              ctype=CTYPE[self.dtype],
                              tf_dtype=self.dtype.name,
                              kernel_source=kernel_source, ops=specs)

    def compile(self):
        """g++ with ``tf.sysconfig``'s flags, then ``tf.load_op_library``."""
        import tensorflow as tf

        flags = [f for f in tf.sysconfig.get_compile_flags()
                 if not f.startswith("--std")]
        so = compile_shared_library(
            self.source, name_hint=f"tfop_{self.module_name}",
            extra_flags=flags, post_flags=tf.sysconfig.get_link_flags())
        return tf.load_op_library(str(so))

    def fwd_fn(self, lib):
        """The forward op of a loaded library (``tf.load_op_library``)."""
        return getattr(lib, _snake(self.fwd_tf_name))

    def bwd_fns(self, lib):
        """The backward ops of a loaded library, one a stage."""
        return [getattr(lib, _snake(n)) for n in self.bwd_tf_names]


_PYBIND_TEMPLATE = '''\
// Generated CPython extension for {{ op_name }}: the op's C kernels
// ({{ ctype }}) on any C-contiguous buffer (the buffer protocol), no
// framework headers.
#include <Python.h>
{{ preamble }}
{{ kernel_sources }}

{% for spec in specs %}
static PyObject* py_{{ spec.name }}(PyObject* self, PyObject* args) {
  (void)self;
  const int n_in = {{ spec.inputs | length }}, n_out = {{ spec.outputs | length }};
  Py_buffer views[{{ (spec.inputs | length) + (spec.outputs | length) }}];
  int acq = 0;
  long long shape[{{ ndim }}];
  if (PyTuple_GET_SIZE(args) != n_in + n_out) {
    PyErr_SetString(PyExc_TypeError,
                    "{{ spec.name }}: expected {{ spec.inputs | length }} input + "
                    "{{ spec.outputs | length }} output buffers");
    return NULL;
  }
  for (int i = 0; i < n_in + n_out; ++i) {
    int flags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT;
    if (i >= n_in) flags |= PyBUF_WRITABLE;
    if (PyObject_GetBuffer(PyTuple_GET_ITEM(args, i), &views[i], flags) != 0)
      goto fail;
    acq = i + 1;
    if (views[i].itemsize != (Py_ssize_t)sizeof({{ ctype }})) {
      PyErr_Format(PyExc_TypeError,
                   "{{ spec.name }}: argument %d has itemsize %zd, "
                   "expected %zd ({{ ctype }})", i, views[i].itemsize,
                   (Py_ssize_t)sizeof({{ ctype }}));
      goto fail;
    }
  }
  if (views[0].ndim < {{ ndim }}) {
    PyErr_SetString(PyExc_ValueError,
                    "{{ spec.name }}: first input has rank < {{ ndim }}");
    goto fail;
  }
  for (int d = 0; d < {{ ndim }}; ++d)
    shape[d] = (long long)views[0].shape[d];
  for (int i = 1; i < n_in + n_out; ++i) {
    bool ok = views[i].ndim >= {{ ndim }};
    for (int d = 0; ok && d < {{ ndim }}; ++d)
      ok = (long long)views[i].shape[d] == shape[d];
    if (!ok) {
      PyErr_Format(PyExc_ValueError,
                   "{{ spec.name }}: argument %d does not have the spatial "
                   "shape of the first input", i);
      goto fail;
    }
  }
  Py_BEGIN_ALLOW_THREADS
  {{ spec.kernel }}(
{%- for i in spec.inputs %}(const {{ ctype }}*)views[{{ loop.index0 }}].buf, {% endfor %}
{%- for o in spec.outputs %}({{ ctype }}*)views[{{ (spec.inputs | length) + loop.index0 }}].buf, {% endfor %}shape);
  Py_END_ALLOW_THREADS
  for (int i = 0; i < acq; ++i) PyBuffer_Release(&views[i]);
  Py_RETURN_NONE;
fail:
  for (int i = 0; i < acq; ++i) PyBuffer_Release(&views[i]);
  return NULL;
}
{% endfor %}

static PyMethodDef Methods[] = {
{% for spec in specs %}  {"{{ spec.name }}", py_{{ spec.name }}, METH_VARARGS,
   "{{ spec.doc }} (positional: inputs then preallocated outputs)"},
{% endfor %}  {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
  PyModuleDef_HEAD_INIT, "{{ init_name }}",
  "Generated stencil kernels for {{ op_name }}", -1, Methods,
  NULL, NULL, NULL, NULL
};

PyMODINIT_FUNC PyInit_{{ init_name }}(void) {
  return PyModule_Create(&moduledef);
}
'''


class PybindModule:
    """The op's C kernels as a plain CPython extension module: no torch or
    TensorFlow headers, only ``Python.h`` and the buffer protocol, so any
    C-contiguous array of the module's float type binds without a copy.
    ``.compile()`` imports it and returns the loaded module:
    ``call_forward(**arrays)``, ``call_backward_stage(i, **arrays)`` and
    ``call_backward(cotangents, saved)`` (``_c_native.exact_vjp``: the
    gradients by forward input name) on numpy, outputs allocated; ``.raw``
    holds the positional kernels (inputs, then preallocated outputs)."""

    def __init__(self, module_name: str, autodiff_op, dtype=np.float64):
        self.module_name = module_name
        self.op = autodiff_op
        self.dtype = np.dtype(dtype)
        if self.dtype not in _FLOATS:
            raise NotImplementedError(f"{module_name}: the C kernels take "
                                      f"float32 or float64, got {self.dtype}")
        self.fwd_prog = forward_program(autodiff_op)
        self.bwd_progs = backward_programs(autodiff_op)
        kernel_sources = _kernel_sources(self.fwd_prog, self.bwd_progs,
                                         self.dtype)
        self._specs = _kernel_specs(self.fwd_prog, self.bwd_progs,
                                    module_name)
        self._init_name = "psext_" + _digest(module_name, kernel_sources,
                                             self.dtype.name)
        self.extension_source = _render(
            _PYBIND_TEMPLATE, op_name=module_name, ndim=self.fwd_prog.ndim,
            ctype=CTYPE[self.dtype], init_name=self._init_name,
            preamble=c_preamble(), kernel_sources=kernel_sources,
            specs=self._specs)

    def _compile_extension(self):
        import importlib.util
        import sysconfig

        # no libpython link: the symbols resolve from the running
        # interpreter when the module is imported
        so = compile_shared_library(
            self.extension_source, name_hint=self._init_name,
            extra_flags=[f"-I{sysconfig.get_paths()['include']}"])
        spec = importlib.util.spec_from_file_location(self._init_name, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def compile(self):
        """Build the extension with g++ and import it; the loaded module
        (see the class doc)."""
        ext = self._compile_extension()
        module = self
        progs = [self.fwd_prog] + list(self.bwd_progs)

        def run(i, arrays):
            """Allocate the outputs, then one positional call."""
            prog, spec = progs[i], module._specs[i]
            ins, spatial = [], None
            for f in prog.input_fields:
                a = np.ascontiguousarray(arrays[f.name], dtype=module.dtype)
                if spatial is None:
                    spatial = a.shape[: f.spatial_dimensions]
                ins.append(a)
            outs = [np.empty(tuple(spatial) + f.index_shape, module.dtype)
                    for f in prog.output_fields]
            getattr(ext, spec["name"])(*ins, *outs)
            return dict(zip(prog.output_names, outs))

        class Loaded:
            raw = ext
            extension_source = module.extension_source
            is_extension = True
            n_backward_stages = len(module.bwd_progs)

            def call_forward(self, **arrays):
                return run(0, arrays)

            def call_backward_stage(self, i, **arrays):
                return run(1 + i, arrays)

            def call_backward(self, cotangents, saved):
                ref = np.asarray(next(iter(cotangents.values())))
                spatial = ref.shape[: module.fwd_prog.ndim]
                return exact_vjp(
                    module.op, module.bwd_progs,
                    {k: np.asarray(v, module.dtype)
                     for k, v in cotangents.items()}, saved,
                    lambda i, ins: run(1 + i, ins),
                    numpy_masked(module.fwd_prog),
                    lambda f: np.zeros(spatial + f.index_shape,
                                       module.dtype))

        return Loaded()
