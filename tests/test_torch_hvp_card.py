"""Second and third differentiation of the stencil op on the card: the
HVP by reverse over reverse and by forward over reverse on CUDA tensors,
held against the same calls on CPU tensors (the plain versions; those are
held against the JAX package in ``test_torch_hvp.py``), with the launches
each takes — every one a window kernel, no plain-version evaluation.
Every test here needs a CUDA device and skips without one."""

import numpy as np
import pytest
import sympy as sp
import torch

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields
from pystencils_autodiff_tpu_torch.models import burgers2d_op, heat_step_op
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import torch_ref

pytestmark = pytest.mark.cuda
RTOL = 1e-12
SHAPE = (40, 70)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


def _const_op():
    u, c, out = fields("u, c, out", 2)
    return AutoDiffOp([Assignment(out.center, c[0, 1] ** 2 * u[1, 0]
                                  + sp.sin(u[0, -1]) * c[0, 0])],
                      op_name="const_mixed_card", constant_fields=[c])


OPS = {"kappa_heat": lambda: heat_step_op(kappa_field=True, dtype="float64"),
       "burgers2d": lambda: burgers2d_op(),
       "const_mixed": _const_op}


def _case(op, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(SHAPE) + (1.5 if f.name == "kappa" else 0)
          for f in op.forward_input_fields]
    return xs, [rng.standard_normal(SHAPE) for _ in xs]


def _rr(op, xs, vs, device, order=2):
    f = op.torch_function()
    ts = [torch.tensor(x, device=device, requires_grad=True) for x in xs]
    vt = [torch.tensor(v, device=device) for v in vs]
    out = f(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    g = torch.autograd.grad(sum((o * o).sum() for o in outs), ts,
                            create_graph=True)
    for _ in range(order - 1):
        g = torch.autograd.grad(sum((gi * vi).sum() for gi, vi in zip(g, vt)),
                                ts, create_graph=True)
    return [h.detach().cpu() for h in g]


def _fr(op, xs, vs, device):
    f = op.torch_function()

    def loss(*a):
        out = f(*a)
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * o).sum() for o in outs)

    grad = torch.func.grad(loss, argnums=tuple(range(len(xs))))
    _, h = torch.func.jvp(
        grad, tuple(torch.tensor(x, device=device) for x in xs),
        tuple(torch.tensor(v, device=device) for v in vs))
    return [x.cpu() for x in h]


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                   atol=RTOL * max(r.abs().max().item(),
                                                   1e-300))


@pytest.mark.parametrize("name", sorted(OPS))
def test_hvp_on_the_card(dev, name):
    """Reverse over reverse and forward over reverse on CUDA tensors equal
    the CPU runs; every launch is a window kernel and the plain version
    runs nowhere.  κ-heat's HVP takes 5 launches either way: reverse over
    reverse f, B, the tangent program T, T's backward and B again (the
    loss's own curvature pulled back through f); forward over reverse f,
    T, B, B on the cotangent's tangent and T's backward."""
    op = OPS[name]()
    xs, vs = _case(op, seed=1)
    ref_rr, ref_fr = _rr(op, xs, vs, "cpu"), _fr(op, xs, vs, "cpu")
    _rr(op, xs, vs, dev)  # builds every library the counted run takes
    ck.reset_launch_counts()
    plain0 = torch_ref.PLAIN_CALLS
    rr = _rr(op, xs, vs, dev)
    n_rr = ck.LAUNCHES
    fr = _fr(op, xs, vs, dev)
    n_fr = ck.LAUNCHES - n_rr
    assert torch_ref.PLAIN_CALLS == plain0
    assert {k[-1] for k in ck.LAUNCH_CALLS} == {"window"}
    if name == "kappa_heat":
        assert (n_rr, n_fr) == (5, 5)
    _close(rr, ref_rr)
    _close(fr, ref_fr)


def test_third_order_on_the_card(dev):
    """A third reverse differentiation on the card equals the CPU run."""
    op = OPS["burgers2d"]()
    xs, vs = _case(op, seed=2)
    _close(_rr(op, xs, vs, dev, order=3), _rr(op, xs, vs, "cpu", order=3))
