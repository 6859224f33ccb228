"""Second and third differentiation of the port's stencil op against the
JAX package's ``jax_function(lowering="jnp")`` in float64 on the CPU.

The port differentiates its backward ``B(x, g) = J(x)ᵀ·M·g`` through the
tangent-linear program ``T(x, ẋ) = M·J(x)·ẋ`` (``autodiff.tangent_op``):
reverse over reverse (``torch.autograd.grad(..., create_graph=True)``
twice) and forward over reverse (``torch.func.jvp`` of
``torch.func.grad``) must equal ``jax.grad`` of ``jax.grad`` and
``jax.jvp`` of ``jax.grad`` to rtol 1e-10, ghost cells included; so must
a third order and the mixed derivatives through a constant field.  The
fused chains are not twice differentiable in the JAX package (their
Pallas kernels have no JVP): the port raises an error naming ROADMAP
Queue 3 #17 there, never a None or a silent zero.  Inputs are made from
numpy seeds."""

import numpy as np
import pytest
import sympy as sp

import jax
import jax.numpy as jnp
import torch

from pystencils_autodiff_tpu_torch import (Assignment, AutoDiffOp, Field,
                                           fields)
from pystencils_autodiff_tpu_torch.autodiff import tangent_op
from pystencils_autodiff_tpu_torch.models import burgers2d_op, heat_step_op
from pystencils_autodiff_tpu_torch.ops import custom_ops
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from torch_jax_twin import jax_twin

RTOL = 1e-10
SHAPE = (12, 14)


def _const_op():
    """A constant field c whose mixed derivatives the JAX package keeps
    (its jnp backward reads c)."""
    u, c, out = fields("u, c, out", 2)
    return AutoDiffOp([Assignment(out.center, c[0, 1] ** 2 * u[1, 0]
                                  + sp.sin(u[0, -1]) * c[0, 0])],
                      op_name="const_mixed", constant_fields=[c])


def _tfmad_op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0] ** 2
                                  + k[-1, 0] * sp.exp(x[-1, 0]) * x[0, 0])],
                      op_name="tfmad_hvp", diff_mode="transposed-forward")


def _vector_op():
    v = Field("v", 2, index_shape=(2,), layout="soa")
    w = Field("w", 2, index_shape=(2,))
    return AutoDiffOp([
        Assignment(w.center(0), v[1, 0](0) * v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) ** 2 - v[-1, 0](1)),
    ], op_name="vec_hvp")


def _heat4d_op():
    u, k, out = fields("u, kappa, out", 4)
    unit = [tuple(1 if e == d else 0 for e in range(4)) for d in range(4)]
    lap = sum(u[e] + u[tuple(-x for x in e)] - 2 * u.center for e in unit)
    return AutoDiffOp([Assignment(out.center,
                                  u.center + 0.1 * k.center ** 2 * lap)],
                      op_name="kheat4d_hvp")


OPS = {
    "kappa_heat": lambda: heat_step_op(kappa_field=True, dtype="float64"),
    "burgers2d": lambda: burgers2d_op(),
    "const_mixed": _const_op,
    "tfmad": _tfmad_op,
    "vector": _vector_op,
    "heat4d": _heat4d_op,
}


def _inputs(op, seed):
    nd = op.forward_input_fields[0].spatial_dimensions
    spatial = SHAPE if nd == 2 else (5, 4, 6, 7)
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(storage_shape(f, spatial))
          + (1.5 if f.name == "kappa" else 0.0)
          for f in op.forward_input_fields]
    vs = [rng.standard_normal(x.shape) for x in xs]
    ws = [rng.standard_normal(storage_shape(f, spatial))
          for f in op.forward_output_fields]
    return xs, vs, ws


def _loss_torch(f, ws):
    def loss(*a):
        o = f(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum((w * x * x).sum() for w, x in zip(ws, o))
    return loss


def _loss_jax(f, ws):
    def loss(*a):
        o = f(*a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(w * x * x) for w, x in zip(ws, o))
    return loss


def _jax_hvp(op, xs, vs, ws, periodic=False, order=2):
    f = jax_twin(op).jax_function(lowering="jnp", periodic=periodic)
    arg = tuple(range(len(xs)))
    g = jax.grad(_loss_jax(f, [jnp.asarray(w) for w in ws]), argnums=arg)
    for _ in range(order - 1):
        g = jax.grad(lambda *a, g=g: sum(jnp.vdot(gi, vi) for gi, vi in
                                         zip(g(*a), vs)), argnums=arg)
    return [np.asarray(h) for h in g(*xs)]


def _port_rr(op, xs, vs, ws, periodic=False, order=2):
    loss = _loss_torch(op.torch_function(periodic=periodic),
                       [torch.tensor(w) for w in ws])
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    vt = [torch.tensor(v) for v in vs]
    g = torch.autograd.grad(loss(*ts), ts, create_graph=True)
    for _ in range(order - 1):
        g = torch.autograd.grad(sum((gi * vi).sum() for gi, vi in zip(g, vt)),
                                ts, create_graph=True)
    return [h.detach().numpy() for h in g]


def _port_fr(op, xs, vs, ws, periodic=False):
    loss = _loss_torch(op.torch_function(periodic=periodic),
                       [torch.tensor(w) for w in ws])
    grad = torch.func.grad(loss, argnums=tuple(range(len(xs))))
    _, h = torch.func.jvp(grad, tuple(torch.tensor(x) for x in xs),
                          tuple(torch.tensor(v) for v in vs))
    return [x.numpy() for x in h]


def _close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL,
                                   atol=RTOL * max(np.abs(r).max(), 1e-300))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_hvp_reverse_over_reverse(name, periodic):
    """``grad`` of ``grad`` (``create_graph=True``) equals the JAX
    package's ``jax.grad`` of ``jax.grad`` through jnp."""
    op = OPS[name]()
    xs, vs, ws = _inputs(op, seed=1)
    _close(_port_rr(op, xs, vs, ws, periodic),
           _jax_hvp(op, xs, vs, ws, periodic))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_hvp_forward_over_reverse(name, periodic):
    """``torch.func.jvp`` of ``torch.func.grad`` equals the JAX package's
    HVP, and the two port modes agree."""
    op = OPS[name]()
    xs, vs, ws = _inputs(op, seed=2)
    fr = _port_fr(op, xs, vs, ws, periodic)
    f = jax_twin(op).jax_function(lowering="jnp", periodic=periodic)
    grad = jax.grad(_loss_jax(f, [jnp.asarray(w) for w in ws]),
                    argnums=tuple(range(len(xs))))
    _, jfr = jax.jvp(grad, tuple(jnp.asarray(x) for x in xs),
                     tuple(jnp.asarray(v) for v in vs))
    _close(fr, [np.asarray(h) for h in jfr])
    if not op.constant_fields:
        # a constant field's zero first derivative makes the Jacobian of
        # the gradient unsymmetric: the two products differ there
        _close(fr, _port_rr(op, xs, vs, ws, periodic))


@pytest.mark.parametrize("name", ["burgers2d", "const_mixed"])
def test_third_order(name):
    """A third reverse differentiation, through the tangent program's own
    tangent program, equals the JAX package's."""
    op = OPS[name]()
    xs, vs, ws = _inputs(op, seed=3)
    _close(_port_rr(op, xs, vs, ws, order=3),
           _jax_hvp(op, xs, vs, ws, order=3))


def test_second_differentiation_is_never_none():
    """Every input's second derivative comes back as a tensor — with
    ``allow_unused=True`` too — and the first gradients carry a graph (no
    error node): κ's mixed derivative through u included."""
    op = OPS["kappa_heat"]()
    xs, vs, ws = _inputs(op, seed=4)
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    loss = _loss_torch(op.torch_function(), [torch.tensor(w) for w in ws])
    g = torch.autograd.grad(loss(*ts), ts, create_graph=True)
    assert all(type(x.grad_fn).__name__.startswith("StencilBwd") for x in g)
    for gi in g:
        h = torch.autograd.grad(gi.sum(), ts, allow_unused=True,
                                retain_graph=True)
        assert all(x is not None and x.abs().max() > 0 for x in h)


def test_traced_rule_matches_eager():
    """The ops' own autograd (``psat::stencil_bwd``'s ``register_autograd``,
    what ``torch.compile`` and ``torch.export`` record) gives the eager
    Functions' HVP bit for bit."""
    op = OPS["burgers2d"]()
    f = op.torch_function()
    key = f.entry.key
    xs, vs, ws = _inputs(op, seed=5)
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    wt = [torch.tensor(w) for w in ws]
    outs = custom_ops.stencil(key, ts)
    g = torch.autograd.grad(sum((w * o * o).sum() for w, o in zip(wt, outs)),
                            ts, create_graph=True)
    h = torch.autograd.grad(sum((gi * torch.tensor(v)).sum()
                                for gi, v in zip(g, vs)), ts)
    eager = _port_rr(op, xs, vs, ws)
    for a, b in zip(h, eager):
        assert np.array_equal(a.numpy(), b)


def test_tangent_program():
    """``tangent_op``: the tangent-linear program's forward is J·ẋ on the
    forward's interior (a finite difference of the forward, to first
    order), its adjoints those asked for, and an op along a field it does
    not read has no tangent program."""
    op = OPS["burgers2d"]()
    top, names = tangent_op(op.forward_assignments, ["u", "v"], None)
    assert names == {"u": "tlm_u", "v": "tlm_v", "u_next": "tlm_u_next",
                     "v_next": "tlm_v_next"}
    assert {f.name for f in top.backward_output_fields} == {
        "difftlm_u", "difftlm_v", "diffu", "diffv"}
    xs, vs, _ = _inputs(op, seed=6)
    f = op.torch_function()
    t = top.torch_function()
    x = [torch.tensor(a) for a in xs]
    v = [torch.tensor(a) for a in vs]
    eps = 1e-6
    fd = [(p - m) / (2 * eps) for p, m in zip(
        f(*[a + eps * b for a, b in zip(x, v)]),
        f(*[a - eps * b for a, b in zip(x, v)]))]
    by = dict(zip([fl.name for fl in top.forward_input_fields], range(4)))
    args = [None] * 4
    for n, a, b in zip(["u", "v"], x, v):
        args[by[n]], args[by[names[n]]] = a, b
    for got, ref in zip(t(*args), fd):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-7)
    c_op = _const_op()
    none, _ = tangent_op(c_op.forward_assignments, ["nothing"], None)
    assert none is None


def _chain_cases():
    from pystencils_autodiff_tpu.ops.stage_chain import \
        fused_stage_chain as jstage
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jtime

    from pystencils_autodiff_tpu_torch.ops import (fused_stage_chain,
                                                   fused_time_chain)

    carry = {"u": "u_next"}
    return {
        f"time_chain_fused_bwd={fb}": (
            lambda op, fb=fb: fused_time_chain(op, 2, carry, fused_bwd=fb),
            lambda op, fb=fb: jtime(op, 2, carry, fused_bwd=fb))
        for fb in (False, True)} | {
        f"stage_chain_fused_bwd={fb}": (
            lambda op, fb=fb: fused_stage_chain([(op, carry)], 2,
                                                fused_bwd=fb),
            lambda op, fb=fb: jstage([(op, carry)], k=2, fused_bwd=fb))
        for fb in (False, True)}


@pytest.mark.parametrize("name", sorted(_chain_cases()))
def test_chain_second_differentiation_raises_like_jax(name):
    """Each fused chain API: the JAX package cannot differentiate it twice
    (its Pallas chain kernels have no JVP), and the port raises an error
    naming ROADMAP Queue 3 #17 — reverse over reverse, with
    ``allow_unused=True`` too, and forward over reverse — where a
    once-differentiable backward used to return None."""
    port_chain, jax_chain = _chain_cases()[name]
    op = heat_step_op(kappa_field=True, dtype="float64")
    rng = np.random.default_rng(7)
    u0 = rng.standard_normal(SHAPE)
    k0 = 1 + 0.1 * rng.random(SHAPE)

    jch = jax_chain(jax_twin(op))
    jk = jnp.asarray(k0)

    def jloss(u):
        return jnp.sum(jch({"u": u, "kappa": jk})["u"] ** 2)

    with pytest.raises(Exception):
        jax.grad(lambda u: jnp.sum(jax.grad(jloss)(u)))(jnp.asarray(u0))

    ch = port_chain(op)
    for loss in (lambda o: (o ** 2).sum(), lambda o: o.sum()):
        u = torch.tensor(u0, requires_grad=True)
        k = torch.tensor(k0, requires_grad=True)
        g = torch.autograd.grad(loss(ch({"u": u, "kappa": k})["u"]), (u, k),
                                create_graph=True)
        with pytest.raises(RuntimeError, match="Queue 3 #17"):
            torch.autograd.grad(sum(x.sum() for x in g), (u, k),
                                allow_unused=True)
    kd = torch.tensor(k0)
    with pytest.raises(NotImplementedError, match="Queue 3 #17"):
        torch.func.jvp(torch.func.grad(
            lambda a: (ch({"u": a, "kappa": kd})["u"] ** 2).sum()),
            (torch.tensor(u0),), (torch.ones(SHAPE, dtype=torch.float64),))


def test_sharded_chain_second_differentiation_raises():
    """A ``ShardedChain`` (the fused chain on a mesh) raises the same error
    on a second differentiation; a ``ShardedStencil``, whose shards run
    the stencil op, differentiates twice and equals the unsharded HVP."""
    from pystencils_autodiff_tpu_torch.parallel import (ShardedChain,
                                                        ShardedStencil,
                                                        make_mesh)

    op = heat_step_op(kappa_field=True, dtype="float64")
    mesh = make_mesh((2,), ("x",), ["cpu"] * 2)
    rng = np.random.default_rng(8)
    u0, k0, v0 = (rng.standard_normal((16, 10)) for _ in range(3))
    k0 = 1.5 + 0.1 * k0
    ch = ShardedChain(op, 2, mesh, {0: "x"}, carry_map={"u": "u_next"},
                      fused_bwd=True)
    u = torch.tensor(u0, requires_grad=True)
    k = torch.tensor(k0, requires_grad=True)
    (g,) = torch.autograd.grad((ch({"u": u, "kappa": k})["u"] ** 2).sum(),
                               (u,), create_graph=True)
    with pytest.raises(RuntimeError, match="Queue 3 #17"):
        torch.autograd.grad(g.sum(), (u, k), allow_unused=True)

    st = ShardedStencil(op, mesh, {0: "x"})
    names = [f.name for f in op.forward_input_fields]
    v = torch.tensor(v0)

    def hvp(fn):
        ts = [torch.tensor(u0 if n == "u" else k0, requires_grad=True)
              for n in names]
        g = torch.autograd.grad((fn(*ts) ** 2).sum(), ts, create_graph=True)
        return torch.autograd.grad((g[names.index("u")] * v).sum(), ts)

    for a, b in zip(hvp(st), hvp(op.torch_function())):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * b.abs().max().item())


def test_traced_rule_with_a_constant_field_raises():
    """Through the raw op (the traced path), a second differentiation with
    a constant field that requires grad raises an error naming ROADMAP
    Queue 3 #17 instead of leaving out that field's second-order term."""
    op = OPS["const_mixed"]()
    f = op.torch_function()
    xs, _, _ = _inputs(op, seed=9)
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    (out,) = custom_ops.stencil(f.entry.key, ts)
    with pytest.raises(NotImplementedError, match="Queue 3 #17"):
        torch.autograd.grad((out * out).sum(), ts, create_graph=True)
