"""The port's ``torch_tf_interop.py`` training loop through its native
operators against the same loop through the JAX package's native
PyTorch op, in float64 on the CPU."""

import numpy as np
import torch

from torch_jax_twin import jax_twin
from chip_smoke import example_module as example


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


# ---------------------------------------------------------- torch native --

def test_torch_native_training_matches_the_jax_package_op():
    """κ after 30 Adam steps through ``create_pytorch_op(backend=
    "torch_native")`` (the generated C operators on CPU tensors) against
    the same loop through the JAX package's ``create_pytorch_op(
    native=True)`` (rtol 1e-10)."""
    ex = example("torch_tf_interop")
    op = ex.make_op()
    u0, k_true = ex.inputs()
    loss, _, k_hat = ex.train_torch(op.create_pytorch_op(
        backend="torch_native"), u0, k_true, steps=30)
    jloss, _, jk_hat = ex.train_torch(jax_twin(op).create_pytorch_op(
        native=True), u0, k_true, steps=30)
    _close(k_hat, jk_hat, 1e-10, "kappa")
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
