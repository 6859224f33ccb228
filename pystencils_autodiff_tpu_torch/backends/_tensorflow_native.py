"""TensorFlow native backend: the op's C kernels as a compiled TensorFlow
custom-op library with its gradient — the port of
``pystencils_autodiff_tpu/backends/_tensorflow_native.py``.

The forward op and the backward ops (every stage of a staged backward)
come from one library (``astnodes.TensorflowModule`` → g++ →
``tf.load_op_library``); ``tf.custom_gradient`` makes the backward the
forward's gradient.  The cotangents are masked to the forward interior
(the exact VJP of interior-only writes, ``ops/vjp.py``) with TensorFlow
ops, so the path holds no ``py_function``.
"""

from __future__ import annotations

import numpy as np

from ._c_native import exact_vjp
from .astnodes import TensorflowModule

__all__ = ["create_tensorflow_op"]


def create_tensorflow_op(autodiff_op, dtype=np.float64):
    """A differentiable TensorFlow function of the op's compiled kernels in
    ``dtype`` (float32 or float64), inputs ordered by
    ``forward_input_fields`` (``f.input_names``)."""
    import tensorflow as tf

    module = TensorflowModule(autodiff_op.op_name, autodiff_op, dtype=dtype)
    lib = module.compile()
    fwd_fn, bwd_fns = module.fwd_fn(lib), module.bwd_fns(lib)
    in_names = module.fwd_prog.input_names
    out_names = module.fwd_prog.output_names
    constant = {f.name for f in autodiff_op.constant_fields}
    ghost = module.fwd_prog.ghost
    nd = module.fwd_prog.ndim
    multi = len(out_names) > 1

    def interior_mask(c, field):
        """1 on the forward interior, 0 on the ghost frame, broadcast over
        the field's index dims."""
        spatial = [int(s) for s in c.shape[:nd]]
        inner = [s - lo - hi for s, (lo, hi) in zip(spatial, ghost)]
        m = tf.pad(tf.ones(inner, c.dtype), [[lo, hi] for lo, hi in ghost])
        return tf.reshape(m, spatial + [1] * field.index_dimensions)

    @tf.custom_gradient
    def op(*tensors):
        ins = dict(zip(in_names, tensors))
        outs = fwd_fn(*tensors)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]

        def grad(*cotangents):
            def run_stage(i, env):
                res = bwd_fns[i](*[env[n] for n in
                                   module.bwd_progs[i].input_names])
                res = list(res) if isinstance(res, (list, tuple)) else [res]
                return dict(zip(module.bwd_progs[i].output_names, res))

            spatial = list(tensors[0].shape[:nd])
            grads = exact_vjp(
                autodiff_op, module.bwd_progs,
                dict(zip(out_names, cotangents)), ins, run_stage,
                lambda c, f: c * interior_mask(c, f),
                lambda f: tf.zeros(spatial + list(f.index_shape),
                                   tensors[0].dtype))
            return [grads[n] if n in grads and n not in constant else None
                    for n in in_names]

        return (outs if multi else outs[0]), grad

    op.input_names = in_names
    op.output_names = out_names
    op.module = module
    return op
