"""The port's TensorFlow bridges on the CPU against the JAX package, in
float64: the shim (``create_tensorflow_op()``: ``tf.custom_gradient`` and
``tf.py_function`` over ``torch_function``, tensors crossing by DLPack),
the compiled custom-op library (``backend="tensorflow_native"``,
``backends/astnodes.TensorflowModule``) and the ``tf_*`` field helpers.
The reference is ``jax_function(lowering="jnp")`` and ``jax.vjp``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bridge_ops import mixed_op
from test_torch_op import OPS as OP_CASES, _case
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch import AutoDiffOp, Assignment, Field
from pystencils_autodiff_tpu_torch.backends.astnodes import TensorflowModule
from pystencils_autodiff_tpu_torch.field_tensor_conversion import (
    tf_constant_from_field, tf_placeholder_from_field, tf_variable_from_field)
from pystencils_autodiff_tpu_torch.models import burgers2d_op, heat_step_op

tf = pytest.importorskip("tensorflow")

RTOL = 1e-10
OPS = {"heat_kappa": lambda: heat_step_op(kappa_field=True, dtype="float64"),
       "burgers2d": lambda: burgers2d_op(dtype="float64"),
       "mixed": mixed_op}


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _held_against_jax(op, fn):
    """``fn``'s value and gradients under ``tf.GradientTape`` (the outputs'
    cotangents given) against the JAX package's; constant fields get
    ``None``."""
    ins, cots = _case(op, seed=17)
    f = jax_twin(op).jax_function(lowering="jnp")
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    ref_outs = out if isinstance(out, tuple) else (out,)
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                    else jnp.asarray(cots[0]))
    assert fn.input_names == [g.name for g in op.forward_input_fields]
    vs = [tf.Variable(a) for a in ins]
    with tf.GradientTape() as tape:
        res = fn(*vs)
    outs = res if isinstance(res, (list, tuple)) else [res]
    grads = tape.gradient(outs, vs, output_gradients=[tf.constant(c)
                                                      for c in cots])
    for o, r in zip(outs, ref_outs):
        _close(o.numpy(), r)
    constant = {g.name for g in op.constant_fields}
    for g, r, field in zip(grads, ref_grads, op.forward_input_fields):
        if field.name in constant:
            assert g is None
        else:
            _close(g.numpy(), r)


@pytest.mark.parametrize("name", sorted(OPS) + ["layout_f"])
def test_tensorflow_shim_matches_jax(name):
    op = OPS[name]() if name in OPS else OP_CASES[name]()
    _held_against_jax(op, op.create_tensorflow_op())


@pytest.mark.parametrize("name", sorted(OPS))
def test_tensorflow_native_matches_jax(name):
    """The compiled ``REGISTER_OP`` library: forward op, one backward op a
    stage (the mixed op's backward is staged), the cotangent mask in TF
    ops."""
    op = OPS[name]()
    _held_against_jax(op, op.create_tensorflow_op(
        backend="tensorflow_native"))


def test_tensorflow_native_in_float32():
    op = OPS["heat_kappa"]()
    fn = op.create_tensorflow_op(backend="tensorflow_native",
                                 dtype=np.float32)
    ins, _ = _case(op, seed=2)
    out = fn(*(tf.constant(a.astype(np.float32)) for a in ins))
    ref = jax_twin(op).jax_function(lowering="jnp")(
        *(jnp.asarray(a.astype(np.float32).astype(np.float64)) for a in ins))
    assert out.dtype == tf.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def test_tensorflow_module_source_structure():
    op = mixed_op()
    mod = TensorflowModule("srccheck", op)
    src = mod.source
    assert src.count("REGISTER_OP(") == 1 + len(mod.bwd_tf_names) == 3
    assert "class " + mod.fwd_tf_name + "Op : public OpKernel" in src
    assert ".flat<double>().data()" in src
    assert "REGISTER_KERNEL_BUILDER(Name(\"" + mod.bwd_tf_name in src
    assert "c->Concatenate(sp, c->MakeShape({ 2 }), &out)" in src
    assert "mixed_bridge_fwd_interior(" in src
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        TensorflowModule("srccheck", op, dtype=np.float16)


def test_tf_field_helpers():
    """Shapes (index dims placed as the field stores them) and dtypes."""
    f = Field("f", 2, index_shape=(3,), dtype="float32")
    g = Field("g", 3, index_shape=(2,), layout="soa")
    c = tf_constant_from_field(f, (4, 5), init=2.5)
    assert c.shape == (4, 5, 3) and c.dtype == tf.float32
    assert float(c[1, 2, 0]) == 2.5
    v = tf_variable_from_field(g, (2, 3, 4))
    assert isinstance(v, tf.Variable) and v.shape == (2, 2, 3, 4)
    assert v.dtype == tf.float64 and float(tf.reduce_sum(v)) == 0.0
    spec = tf_placeholder_from_field(f, (4, 5))
    assert isinstance(spec, tf.TensorSpec)
    assert spec.shape == (4, 5, 3) and spec.dtype == tf.float32
    x, y = Field("x", 2), Field("y", 2)
    op = AutoDiffOp([Assignment(y.center, 2 * x[1, 0])], op_name="tf_cf")
    fn = op.create_tensorflow_op()
    out = fn(tf_constant_from_field(x, (4, 5), init=1.0))
    assert out.shape == (4, 5) and float(out[1, 2]) == 2.0
