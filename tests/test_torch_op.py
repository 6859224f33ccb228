"""The port's op (``AutoDiffOp.torch_function``) against the JAX package's
``jax_function(lowering="jnp")`` and ``jax.vjp`` in float64 on the CPU:
values and gradients everywhere, ghost cells included; gradcheck; the
argument checks; ``from_jax_arrays``; and the slice as a whole — the heat
inverse problem's Adam trajectory held against the JAX run."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import sympy as sp
import torch

from pystencils_autodiff_tpu_torch import (Assignment, AssignmentCollection,
                                           AutoDiffOp, Field, fields,
                                           from_jax_arrays)
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step3d_op, heat_step_op,
                                                  laplacian_op)
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from torch_jax_twin import jax_twin

RTOL = 1e-10
SHAPE2, SHAPE3 = (24, 20), (8, 10, 12)


def _tfmad_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * sp.exp(x[-1, 0]) * x[0, 0])],
                      op_name="tfmad_exp", diff_mode="transposed-forward")


def _accum_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="accum_op", time_constant_fields=[k])


def _vector_op():
    v = Field("v", 2, index_shape=(2,), layout="soa")
    w = Field("w", 2, index_shape=(2,))
    c = Field("c", 2)
    return AutoDiffOp([
        Assignment(w.center(0), v[1, 0](0) * c[0, 0] - v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) * v[-1, 0](1) + c[0, 1]),
    ], op_name="vec_mixed")


def _layout_op():
    x = Field("x", 2, layout="f")
    k, y = Field("k", 2), Field("y", 2)
    return AutoDiffOp([Assignment(y.center, x[1, 0] - x[0, 1] * k[0, 0])],
                      op_name="layout_f")


OPS = {
    "heat_kappa": lambda: heat_step_op(kappa_field=True, dtype="float64"),
    "laplacian": lambda: laplacian_op(dtype="float64"),
    "diffusion3d": lambda: diffusion3d_op(dtype="float64"),
    "diffusion3d_kfrozen": lambda: diffusion3d_op(dtype="float64",
                                                  grad_kappa=False),
    "heat3d": lambda: heat_step3d_op(dtype="float64"),
    "tfmad": _tfmad_op,
    "accum": _accum_op,
    "vector": _vector_op,
    "layout_f": _layout_op,
}


def _storage(f, spatial):
    spatial = tuple(spatial[i] for i in f.layout)
    return storage_shape(f, spatial)


def _case(op, seed=0):
    spatial = SHAPE3 if op.forward_input_fields[0].spatial_dimensions == 3 else SHAPE2
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal(_storage(f, spatial))
           for f in op.forward_input_fields]
    cots = [rng.standard_normal(_storage(f, spatial))
            for f in op.forward_output_fields]
    return ins, cots


def _jax_value_and_vjp(op, ins, cots, periodic=False):
    f = jax_twin(op).jax_function(lowering="jnp", periodic=periodic)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    outs = out if isinstance(out, tuple) else (out,)
    grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_value_and_vjp(op, ins, cots, periodic=False, device="cpu"):
    f = op.torch_function(periodic=periodic)
    ts = [torch.tensor(a, device=device, requires_grad=True) for a in ins]
    out = f(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c, device=device)
                                           for c in cots])
    return ([o.detach().cpu().numpy() for o in outs],
            [g.cpu().numpy() for g in grads])


def _assert_close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL,
                                   atol=RTOL * max(np.abs(r).max(), 1e-300))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_value_and_gradient_match_jax(name, periodic):
    op = OPS[name]()
    ins, cots = _case(op)
    j_out, j_grad = _jax_value_and_vjp(op, ins, cots, periodic)
    t_out, t_grad = _torch_value_and_vjp(op, ins, cots, periodic)
    _assert_close(t_out, j_out)
    _assert_close(t_grad, j_grad)
    # ghost cells carry gradient (the exact VJP of interior-write)
    if not periodic and name == "heat_kappa":
        iu = [f.name for f in op.forward_input_fields].index("u")
        assert np.abs(t_grad[iu][0]).max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_on_the_card_matches_jax(name, periodic):
    """The same comparison through the CUDA kernel (the op on CUDA
    tensors), float64; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is compiled with nvcc "
                    "for sm_90a and has no CPU mode)")
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    op = OPS[name]()
    ins, cots = _case(op)
    j_out, j_grad = _jax_value_and_vjp(op, ins, cots, periodic)
    before = ck.LAUNCHES
    t_out, t_grad = _torch_value_and_vjp(op, ins, cots, periodic, "cuda")
    assert ck.LAUNCHES > before
    _assert_close(t_out, j_out)
    _assert_close(t_grad, j_grad)


def test_constant_field_gets_zero_gradient():
    op = diffusion3d_op(dtype="float64", grad_kappa=False)
    ins, cots = _case(op)
    _, grads = _torch_value_and_vjp(op, ins, cots)
    names = [f.name for f in op.forward_input_fields]
    assert not np.any(grads[names.index("kappa")])


def test_gradcheck_heat_step():
    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    rng = np.random.default_rng(7)
    u = torch.tensor(rng.standard_normal((10, 12)), requires_grad=True)
    k = torch.tensor(rng.standard_normal((10, 12)), requires_grad=True)
    assert torch.autograd.gradcheck(f, (u, k), eps=1e-6, atol=1e-8)


def test_expanded_cotangent_of_sum():
    """``loss = out.sum()`` hands backward a stride-0 cotangent."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    ins, _ = _case(op, seed=4)
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    op.torch_function()(*ts).sum().backward()
    _, j_grad = _jax_value_and_vjp(op, ins, [np.ones(SHAPE2)])
    _assert_close([t.grad.numpy() for t in ts], j_grad)


def test_argument_probes():
    """The probes of examples/heat_inverse_problem.py plus the shape
    checks of the op's entry point."""
    u, out, kappa = fields("u, out, kappa", 2)
    op = AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * kappa[0, 0] * (
        u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))],
        op_name="heat_step")
    f = op.torch_function()
    u0, k0 = torch.zeros(16, 16), torch.ones(16, 16)
    with pytest.raises(TypeError, match="expected 2 inputs"):
        f(u0)
    with pytest.raises(TypeError, match="unknown field"):
        f(u=u0, kappa=k0, bogus=u0)
    with pytest.raises(TypeError, match="missing field"):
        f(u=u0)
    with pytest.raises(ValueError, match="does not land"):
        u[0.5, 0]
    with pytest.raises(ValueError, match="cell centre"):
        AssignmentCollection([Assignment(out[1, 0], u[0, 0])])
    with pytest.raises(TypeError, match="not both"):
        f(u0, kappa=k0)
    with pytest.raises(ValueError, match="rank"):
        f(u0[None], k0)
    with pytest.raises(ValueError, match="one spatial shape"):
        f(u0, torch.ones(16, 15))
    vec = _vector_op().torch_function()
    with pytest.raises(ValueError, match="index dims"):
        vec(torch.zeros(3, 8, 8), torch.zeros(8, 8))


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_from_jax_arrays_round_trip(layout):
    v = Field("v", 2, index_shape=(2,), layout=layout)
    w, c = Field("w", 2), Field("c", 2)
    op = AutoDiffOp([Assignment(w.center, v[1, 0](0) * c[0, 0] - v[0, -1](1))],
                    op_name=f"conv_{layout}")
    rng = np.random.default_rng(8)
    vshape = (2,) + SHAPE2 if layout == "soa" else SHAPE2 + (2,)
    jarrays = {"v": jnp.asarray(rng.standard_normal(vshape)),
               "c": jnp.asarray(rng.standard_normal(SHAPE2))}
    tensors = from_jax_arrays(op, {n: np.asarray(a) for n, a in jarrays.items()},
                              device="cpu")
    for n, a in jarrays.items():
        assert tensors[n].dtype == torch.float64
        np.testing.assert_array_equal(tensors[n].numpy(), np.asarray(a))
    # the moved state runs through the port and comes back as the JAX result
    got = op.torch_function()(**tensors)
    ref = jax_twin(op).jax_function()(**jarrays)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    f32 = from_jax_arrays(op, {"c": np.asarray(jarrays["c"])}, "cpu",
                          dtype=torch.float32)
    assert f32["c"].dtype == torch.float32
    with pytest.raises(KeyError, match="not a field"):
        from_jax_arrays(op, {"bogus": np.zeros(SHAPE2)}, "cpu")
    with pytest.raises(ValueError, match="rank"):
        from_jax_arrays(op, {"c": np.zeros(SHAPE2 + (1,))}, "cpu")
    with pytest.raises(ValueError, match="index dims"):
        from_jax_arrays(op, {"v": np.zeros(SHAPE2 + (3,))}, "cpu")
    with pytest.raises(ValueError, match="one spatial shape"):
        from_jax_arrays(op, {"v": np.asarray(jarrays["v"]),
                             "c": np.zeros((5, 5))}, "cpu")


def test_heat_inverse_problem_adam_trajectory_matches_jax():
    """The slice as a whole: examples/heat_inverse_problem.py for 20 Adam
    steps, the same start in both frameworks, the loss after every step
    held against the JAX run."""
    u, out, kappa = fields("u, out, kappa", 2)
    op = AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * kappa[0, 0] * (
        u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))],
        op_name="heat_step")
    steps, lr = 20, 0.05

    f = jax.jit(jax_twin(op).jax_function())
    u0 = jax.random.normal(jax.random.PRNGKey(0), (16, 16))
    k_true = 1.0 + 0.5 * jax.nn.sigmoid(
        jax.random.normal(jax.random.PRNGKey(1), (16, 16)))
    target = f(u=u0, kappa=k_true)
    opt = optax.adam(lr)
    k = jnp.ones((16, 16))
    state = opt.init(k)
    vg = jax.jit(jax.value_and_grad(
        lambda k: jnp.mean((f(u=u0, kappa=k) - target) ** 2)))
    jax_losses = []
    for _ in range(steps):
        loss, g = vg(k)
        upd, state = opt.update(g, state)
        k = optax.apply_updates(k, upd)
        jax_losses.append(float(loss))

    moved = from_jax_arrays(op, {"u": np.asarray(u0),
                                 "kappa": np.asarray(k_true)}, "cpu")
    ft = op.torch_function()
    t_target = ft(u=moved["u"], kappa=moved["kappa"])
    kt = torch.ones(16, 16, dtype=torch.float64, requires_grad=True)
    topt = torch.optim.Adam([kt], lr=lr)
    torch_losses = []
    for _ in range(steps):
        topt.zero_grad()
        loss = torch.mean((ft(u=moved["u"], kappa=kt) - t_target) ** 2)
        loss.backward()
        topt.step()
        torch_losses.append(loss.item())
    assert torch_losses[-1] < 0.1 * torch_losses[0]
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=1e-8)
