"""``create_pytorch_op(backend="torch_native")`` on CUDA tensors:
``torch_function``, the window kernel (``ops/cuda_kernel.py``) behind the
``psat::stencil`` custom op — one forward and one backward launch per
value+gradient, no plain-version call and no C kernel (those run only for
CPU tensors; ``test_torch_bridges.py`` holds them against the
JAX package).  Every test here needs a CUDA device and skips without
one."""

import numpy as np
import pytest
import torch

from bridge_ops import case, mixed_op

from pystencils_autodiff_tpu_torch.models import heat_step_op
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import torch_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


def _no_c_kernels(fn):
    """Make the CPU route (the C kernels) raise if anything runs it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a C kernel ran")

    fn.pair.forward = fn.pair.backward = refuse


def _value_and_grads(fn, ins, cot):
    ts = [t.detach().clone().requires_grad_() for t in ins]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, ts, cot, allow_unused=True)
    return list(outs) + [g for g in grads if g is not None]


def test_torch_native_on_the_card_is_torch_function(dev):
    """The κ-heat op at 8192² f32: value and gradients bit-equal to
    ``torch_function``'s, with 1 + 1 window launches and no evaluation by
    the plain version (``torch_ref.PLAIN_CALLS``)."""
    op = heat_step_op(kappa_field=True)
    native = op.create_pytorch_op(backend="torch_native")
    _no_c_kernels(native)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 8192
    ins = [torch.randn((n, n), generator=gen, device=dev) for _ in range(2)]
    cot = (torch.randn((n, n), generator=gen, device=dev),)
    ck.reset_launch_counts()
    plain = torch_ref.PLAIN_CALLS
    got = _value_and_grads(native, ins, cot)
    torch.cuda.synchronize()
    assert torch_ref.PLAIN_CALLS == plain
    assert ck.LAUNCHES == 2
    assert {key[6] for key in ck.LAUNCH_CALLS} == {"window"}
    assert sorted(key[1] for key in ck.LAUNCH_CALLS) == [False, True]
    ref = _value_and_grads(op.torch_function(), ins, cot)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_torch_native_on_the_card_equals_its_cpu_run(dev):
    """Small float64 cases on the card against the same calls on CPU
    tensors (the C kernels): the κ-heat op and an op with two outputs,
    index dims, a constant field and a staged backward."""
    for op in (heat_step_op(kappa_field=True, dtype="float64"), mixed_op()):
        native = op.create_pytorch_op(backend="torch_native")
        ins, cots = case(op, seed=9)
        cpu = _value_and_grads(native, [torch.tensor(a) for a in ins],
                               tuple(torch.tensor(c) for c in cots))
        card = _value_and_grads(native,
                                [torch.tensor(a, device=dev) for a in ins],
                                tuple(torch.tensor(c, device=dev)
                                      for c in cots))
        assert len(card) == len(cpu)
        for g, r in zip(card, cpu):
            np.testing.assert_allclose(g.detach().cpu().numpy(),
                                       r.detach().numpy(), rtol=1e-12,
                                       atol=1e-12 * r.abs().max().item())
