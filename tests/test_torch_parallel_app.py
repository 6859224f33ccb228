"""The port's app-assembly layer on a device mesh (``DataHandling``,
``Simulation`` and ``GraphDataHandling.compile`` with ``mesh=``) against
the JAX package's, in float64 on the CPU.

The port's meshes are ``["cpu"] * 8`` and its arrays ``ShardedArray``s;
the JAX side runs ``lowering="jnp"`` on one device (its own tests hold
its sharded runs equal to that).  Values to rtol 1e-12, gradients to
1e-11, as the JAX package's mesh tests.  Mirrors the mesh cases of
``tests/test_simulation.py`` and ``tests/test_graph_datahandling.py`` and
``test_graph_compile_fused_sharded_matches_replay`` of
``tests/test_sharded_chain.py``.  Inputs are made from a seed with
numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import graph_datahandling as jgraph
from pystencils_autodiff_tpu import simulation as jsim
from pystencils_autodiff_tpu.models import heat_step_op as jheat_step_op
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
from pystencils_autodiff_tpu_torch.datahandling import DataHandling
from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import elastic_stages, heat_step_op
from pystencils_autodiff_tpu_torch.parallel import (ShardedArray,
                                                    exchange_count,
                                                    make_mesh,
                                                    reset_exchange_count)
from pystencils_autodiff_tpu_torch.simulation import Simulation

RTOL, GRAD_RTOL = 1e-12, 1e-11
F64 = torch.float64
CPU8 = ["cpu"] * 8
ELASTIC = ["vx", "vy", "sxx", "syy", "sxy"]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, ref, rtol=RTOL, what=""):
    if isinstance(got, ShardedArray):
        got = got.full()
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def test_datahandling_sharded():
    """On a mesh every array is a ShardedArray split by dim_axes; set,
    fill and read back the interior through it."""
    mesh = make_mesh((4,), ("x",), CPU8)
    dh = DataHandling((30, 16), mesh=mesh, dim_axes={0: "x"},
                      default_dtype=F64)
    dh.add_field("u")
    dh.add_field("f", index_shape=(3,))
    assert isinstance(dh["u"], ShardedArray) and dh["u"].spec == ("x", None)
    assert dh["f"].shape == (32, 18, 3) and dh["f"].blocks[0].shape == (8,
                                                                       18, 3)
    a = _rand(0, (32, 18))
    dh.set_array("u", a)
    _close(dh["u"], a)
    dh.fill_interior("u", 5.0)
    assert float(dh["u"].full()[0, 0]) == a[0, 0]
    assert torch.equal(dh.interior("u"), torch.full((30, 16), 5.0, dtype=F64))


@pytest.mark.parametrize("mesh_shape,axes,dims", [
    ((4,), ("x",), {0: "x"}),
    ((2, 2), ("x", "y"), {0: "x", 1: "y"}),
])
def test_simulation_sharded(mesh_shape, axes, dims):
    """A sharded Simulation (every sweep a ShardedStencil) equals the JAX
    package's Simulation, value and the gradient of the initial field."""
    op = heat_step_op(dt=0.1, dtype="float64")
    mesh = make_mesh(mesh_shape, axes, CPU8)
    dh = DataHandling((30, 16), mesh=mesh, dim_axes=dims, default_dtype=F64)
    dh.add_field("u")
    u0 = _rand(2, (32, 18))
    dh.set_array("u", u0)
    sim = Simulation(dh)
    sim.add_sweep(op, {"u": "u_next"})
    ut = torch.tensor(u0, requires_grad=True)
    out = sim.run({"u": ut}, 3)
    js = jsim.Simulation()
    js.add_sweep(jheat_step_op(dt=0.1, dtype="float64"), {"u": "u_next"})
    jout = js.run({"u": jnp.asarray(u0)}, 3)
    _close(out["u"], jout["u"])
    (g,) = torch.autograd.grad(out["u"].square().sum(), ut)
    jg = jax.grad(lambda a: jnp.sum(js.run({"u": a}, 3)["u"] ** 2))(
        jnp.asarray(u0))
    _close(g, jg, GRAD_RTOL)
    dh.set_array("u", u0)
    sim.run(dh.state(), 3)
    assert isinstance(dh["u"], ShardedArray)
    _close(dh["u"], jout["u"])


def test_simulation_sharded_elastic_with_boundaries():
    """Two staggered sweeps with Neumann BCs (on the gathered fields) over
    a (2, 2) mesh: equal to the JAX package's unsharded Simulation."""
    mesh = make_mesh((2, 2), ("x", "y"), CPU8)
    dh = DataHandling((18, 18), mesh=mesh, dim_axes={0: "x", 1: "y"},
                      default_dtype=F64)
    js = jsim.Simulation()
    sim = Simulation(dh)
    for s in (sim, js):
        s.add_boundary_conditions({"vx": "neumann", "vy": "neumann"},
                                  ghost=((1, 1), (1, 1)))
    for op, carry in elastic_stages(dtype="float64"):
        sim.add_sweep(op, carry)
        js.add_sweep(jax_twin(op), carry)
    state = {n: _rand(10 + i, (20, 20)) for i, n in enumerate(ELASTIC)}
    for n, a in state.items():
        dh.add_field(n)
        dh.set_array(n, a)
    out = sim.run(dh.state(), 4)
    jout = js.run({n: jnp.asarray(a) for n, a in state.items()}, 4)
    for n in ELASTIC:
        assert isinstance(out[n], ShardedArray)
        _close(out[n], jout[n], RTOL, n)


def _heat_graph(n, seed, bc=None):
    dh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                           default_dtype=F64, device="cpu")
    jd = jgraph.GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                                  default_dtype=jnp.float64)
    u0 = _rand(seed, (n, n))
    for d, op in ((dh, heat_step_op(dt=0.1, dtype="float64")),
                  (jd, jheat_step_op(dt=0.1, kappa_field=False,
                                     dtype="float64"))):
        d.add_field("u", init=0.0)
        d.set_array("u", u0)
        with d.timeloop() as loop:
            if bc:
                loop.boundary({"u": bc})
            loop.sweep(op, {"u": "u_next"})
    return dh, jd, u0


def test_graph_compiles_to_sharded_execution():
    """compile(mesh=) replays every recorded sweep as a ShardedStencil:
    equal to the single-device replay and to the JAX package, gradients
    included; fuse="symbolic" with a mesh raises."""
    dh, jd, u0 = _heat_graph(32, 0)
    mesh = make_mesh((4,), ("x",), CPU8)
    run_sh = dh.compile(mesh=mesh, dim_axes={0: "x"})
    run_1d = dh.compile()
    ut = torch.tensor(u0, requires_grad=True)
    out = run_sh({"u": ut}, 5)["u"]
    _close(out, run_1d({"u": torch.tensor(u0)}, 5)["u"])
    _close(out, jd.compile()(jd.state(), 5)["u"])
    (g,) = torch.autograd.grad(out.square().sum(), ut)
    u1 = torch.tensor(u0, requires_grad=True)
    (g1,) = torch.autograd.grad(run_1d({"u": u1}, 5)["u"].square().sum(),
                                u1)
    _close(g, g1.detach(), GRAD_RTOL)
    with pytest.raises(ValueError, match="fuse='none' and fuse='stages'"):
        dh.compile(fuse="symbolic", mesh=mesh)


def test_graph_compile_fused_sharded_matches_replay():
    """compile(fuse="stages", mesh=) runs a ShardedChain: one exchange a
    call, equal to node-by-node replay and to the JAX package."""
    dh, jd, u0 = _heat_graph(32, 7)
    mesh = make_mesh((4,), ("x",), CPU8)
    run_f = dh.compile(fuse="stages", k=2, mesh=mesh, dim_axes={0: "x"})
    reset_exchange_count()
    out = run_f(dh.state(), 4)["u"]
    assert exchange_count() == 2 * 2
    _close(out, dh.compile()(dh.state(), 4)["u"])
    _close(out, jd.compile()(jd.state(), 4)["u"])


def test_graph_stages_mesh_boundary_fused_bwd_compose():
    """A recorded Neumann BC, fuse="stages" on a mesh with the fused
    backward: the BC (and its transpose) runs inside every shard's chain
    in shard mode; equal to the unfused single-device replay, gradients
    included."""
    dh, jd, u0 = _heat_graph(32, 5, bc="neumann")
    mesh = make_mesh((4,), ("x",), CPU8)
    run_f = dh.compile(fuse="stages", k=2, mesh=mesh, dim_axes={0: "x"},
                       fused_bwd=True)
    run_r = dh.compile()
    uf, ur = (torch.tensor(u0, requires_grad=True) for _ in range(2))
    of, orr = run_f({"u": uf}, 4)["u"], run_r({"u": ur}, 4)["u"]
    _close(of, orr.detach())
    _close(of, jd.compile()(jd.state(), 4)["u"])
    (gf,) = torch.autograd.grad(torch.sin(of).sum(), uf)
    (gr,) = torch.autograd.grad(torch.sin(orr).sum(), ur)
    _close(gf, gr.detach(), GRAD_RTOL)


def test_graph_sponge_stages_on_mesh():
    """The elastic pair behind a recorded Cerjan sponge (a synthetic BC
    plane, split over the mesh like the state), fused on a sharded
    datahandling with the fused backward: equal to the unsharded replay,
    gradients included."""
    n = 24
    mesh = make_mesh((2,), ("x",), CPU8)
    dh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                           default_dtype=F64, device="cpu", mesh=mesh,
                           dim_axes={0: "x"})
    state = {name: _rand(40 + i, (n, n)) * 0.1
             for i, name in enumerate(ELASTIC)}
    for name, a in state.items():
        dh.add_field(name, init=torch.tensor(a))
    damp = cerjan_damping((n, n), width=4, alpha=0.1, dtype=F64,
                          device="cpu")
    with dh.timeloop() as loop:
        loop.boundary({name: ("sponge", damp) for name in ELASTIC})
        for op, carry in elastic_stages(dtype="float64"):
            loop.sweep(op, carry)
    run_f = dh.compile(fuse="stages", k=2, fused_bwd=True)
    run_r = dh.compile(mesh=None, dim_axes={})
    out = run_f(dh.state(), 4)
    assert isinstance(out["vx"], ShardedArray)
    ins = {name: torch.tensor(a, requires_grad=True)
           for name, a in state.items()}
    ref = run_r(ins, 4)
    for name in ELASTIC:
        _close(out[name], ref[name].detach(), RTOL, name)
    ins2 = {name: torch.tensor(a, requires_grad=True)
            for name, a in state.items()}
    out2 = run_f(ins2, 4)
    g = torch.autograd.grad(sum(out2[m].square().sum() for m in ELASTIC),
                            [ins2[m] for m in ELASTIC])
    gr = torch.autograd.grad(sum(ref[m].square().sum() for m in ELASTIC),
                             [ins[m] for m in ELASTIC])
    for name, a, b in zip(ELASTIC, g, gr):
        _close(a, b, GRAD_RTOL, name)
