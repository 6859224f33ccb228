"""TensorFlow shim backend: the op as a differentiable TensorFlow function
over the port's ``torch_function`` — the port of
``pystencils_autodiff_tpu/backends/_tensorflow.py``.

``tf.custom_gradient`` pairs a ``tf.py_function`` forward with a
``tf.py_function`` backward.  Tensors cross between the frameworks by
DLPack (``tf.experimental.dlpack`` and ``torch.from_dlpack``), without a
copy; the backward is ``torch.autograd`` over the port's op, so the
cotangent mask and the ghost cells' gradients are ``torch_function``'s.
Constant fields get ``None``.  TensorFlow is imported when a function is
built.
"""

from __future__ import annotations

from ..ops.common import storage_shape, storage_spatial

__all__ = ["tensorflow_function"]


def _to_torch(t):
    import tensorflow as tf
    import torch

    return torch.from_dlpack(tf.experimental.dlpack.to_dlpack(t))


def _to_tf(t):
    import tensorflow as tf

    return tf.experimental.dlpack.from_dlpack(t.detach().contiguous()
                                              .__dlpack__())


def _output_shapes(in_field, t, out_fields):
    """The outputs' storage shapes from an input's (spatial layouts and
    index dims placed as each field stores them)."""
    stored = storage_spatial(in_field, t)
    logical = [0] * len(stored)
    for j, d in enumerate(in_field.layout):
        logical[d] = stored[j]
    return [storage_shape(f, [logical[d] for d in f.layout])
            for f in out_fields]


def tensorflow_function(autodiff_op, **kwargs):
    """``f(*tensors) -> tensor(s)`` differentiable under
    ``tf.GradientTape``, inputs ordered by ``forward_input_fields``
    (``f.input_names``); ``kwargs`` go to ``torch_function``."""
    import tensorflow as tf
    import torch

    fn = autodiff_op.torch_function(**kwargs)
    in_fields = list(autodiff_op.forward_input_fields)
    out_fields = list(autodiff_op.forward_output_fields)
    in_names = [f.name for f in in_fields]
    out_names = [f.name for f in out_fields]
    constant = {f.name for f in autodiff_op.constant_fields}
    multi = len(out_names) > 1

    @tf.custom_gradient
    def op(*tensors):
        state = {}

        def run_forward(*tf_in):
            ins = [_to_torch(t).requires_grad_(n not in constant)
                   for n, t in zip(in_names, tf_in)]
            with torch.enable_grad():
                out = fn(*ins)
            outs = out if isinstance(out, tuple) else (out,)
            state["ins"], state["outs"] = ins, outs
            return [_to_tf(o) for o in outs]

        dtype = tensors[0].dtype
        outs = tf.py_function(run_forward, list(tensors),
                              [dtype] * len(out_names))
        outs = [tf.ensure_shape(o, s) for o, s in
                zip(outs, _output_shapes(in_fields[0], tensors[0],
                                         out_fields))]

        def grad(*cotangents):
            def run_backward(*tf_cots):
                ins = state["ins"]
                wrt = [t for n, t in zip(in_names, ins) if n not in constant]
                gs = iter(torch.autograd.grad(
                    state["outs"], wrt, [_to_torch(c) for c in tf_cots]))
                return [_to_tf(next(gs)) if n not in constant
                        else tf.zeros_like(t)
                        for n, t in zip(in_names, tensors)]

            gs = tf.py_function(run_backward, list(cotangents),
                                [t.dtype for t in tensors])
            return [None if n in constant else tf.ensure_shape(g, t.shape)
                    for n, g, t in zip(in_names, gs, tensors)]

        return (outs if multi else outs[0]), grad

    op.input_names = in_names
    op.output_names = out_names
    return op
