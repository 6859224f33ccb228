"""The port's app-assembly layer against the JAX package's, in float64 on
the CPU: ``DataHandling``, ``Simulation`` and the recorded call graph
(``GraphDataHandling.compile`` in its three fuse modes), values and
gradients, at rtol 1e-10.  The JAX side runs ``lowering="jnp"``; its
``fuse="stages"`` also as its own tests run it (the Pallas chain in
interpret mode).  Mirrors ``tests/test_graph_datahandling.py``,
``tests/test_simulation.py`` and ``tests/test_compose.py`` where they need
no mesh and no TensorFlow (``tests/test_torch_parallel_app.py`` holds the
mesh), plus the port's own rules: a mesh a run cannot take raises, the
state is never written in place, a one-sweep ``fused_op`` leaves the
model op alone, and a BC tensor recorded on several fields is one chain
input."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import datahandling as jdh_mod
from pystencils_autodiff_tpu import graph_datahandling as jgraph
from pystencils_autodiff_tpu import simulation as jsim
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
from pystencils_autodiff_tpu_torch.compose import renamed
from pystencils_autodiff_tpu_torch.datahandling import DataHandling
from pystencils_autodiff_tpu_torch.graph_datahandling import (
    AllocNode, BoundaryNode, CommNode, GraphDataHandling, SweepNode,
    TimeloopNode)
from pystencils_autodiff_tpu_torch.models import (elastic_stress_op,
                                                  elastic_velocity_op,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
from pystencils_autodiff_tpu_torch.ops import forward_program
from pystencils_autodiff_tpu_torch.simulation import Simulation
from pystencils_autodiff_tpu_torch.timeloop import run_timeloop

RTOL = 1e-10
F64 = torch.float64
VEL_CARRY = {"vx": "vx_next", "vy": "vy_next"}
STRESS_CARRY = {"sxx": "sxx_next", "syy": "syy_next", "sxy": "sxy_next"}


def fresh_twin(op):
    """A JAX op equal to ``op`` of its own: the JAX package's one-sweep
    ``fused_op`` renames the op it is given, so no twin is shared."""
    return jax_twin.__wrapped__(op)


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, ref, err_msg=""):
    got, ref = _numpy(got), _numpy(ref)
    assert got.shape == ref.shape, err_msg
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300),
                               err_msg=err_msg)


def _rand(seed, shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def heat():
    return heat_step_op(dt=0.1, dtype="float64")


def elastic_pair():
    return (elastic_velocity_op(dt=0.01, dtype="float64"),
            elastic_stress_op(dt=0.01, dtype="float64"))


# ---------------------------------------------------------- DataHandling --

def test_datahandling_basic_matches_jax():
    dh = DataHandling((16, 16), ghost_layers=1, default_dtype=F64,
                      device="cpu")
    jd = jdh_mod.DataHandling((16, 16), ghost_layers=1,
                              default_dtype=jnp.float64)
    for d in (dh, jd):
        d.add_field("u", init=2.0)
        d.fill_interior("u", 5.0)
        d.add_arrays("p, q(2)")
    assert dh["u"].shape == (18, 18) and dh["u"].device.type == "cpu"
    assert float(dh["u"][0, 0]) == 2.0 and float(dh["u"][5, 5]) == 5.0
    assert dh.interior("u").shape == (16, 16)
    assert dh["q"].shape == (18, 18, 2) and dh.fields["q"].index_shape == (2,)
    assert dh.fields["u"].dtype == np.float64
    for name in ("u", "p", "q"):
        _close(dh[name], jd[name], name)
    assert dh.shape_with_ghost == jd.shape_with_ghost
    assert "u[18, 18]" in repr(dh)


def test_datahandling_array_init_broadcasts_as_jnp_full():
    """``add_field(init=...)`` broadcasts like ``jnp.full``; ghost
    layers may differ per side."""
    ghost = ((1, 2), (0, 1))
    row = _rand(1, (15,))
    dh = DataHandling((6, 14), ghost_layers=ghost, default_dtype=F64,
                      device="cpu")
    jd = jdh_mod.DataHandling((6, 14), ghost_layers=ghost,
                              default_dtype=jnp.float64)
    dh.add_field("a", init=row)
    jd.add_field("a", init=jnp.asarray(row))
    dh.add_field("b", init=torch.tensor(row))
    assert dh["a"].shape == (9, 15)
    _close(dh["a"], jd["a"])
    _close(dh["b"], jd["a"])
    _close(dh.interior("a"), jd.interior("a"))


def test_datahandling_state_snapshot_survives_replacement():
    """``set_array`` and ``fill_interior`` replace the stored tensor: a
    state taken before keeps its values, as in the JAX package."""
    dh = DataHandling((8, 8), ghost_layers=1, default_dtype=F64, device="cpu")
    dh.add_field("u", init=1.0)
    before = dh.state()
    dh.fill_interior("u", 7.0)
    assert float(before["u"].max()) == 1.0 and float(dh["u"][4, 4]) == 7.0
    mid = dh.state()
    dh.set_array("u", np.zeros((10, 10)))
    assert float(mid["u"][4, 4]) == 7.0 and float(dh["u"].abs().max()) == 0
    with pytest.raises(ValueError, match="expected shape"):
        dh.set_array("u", np.zeros((8, 8)))
    dh.update({"u": before["u"], "not_a_field": before["u"]})
    assert dh["u"] is before["u"] and "not_a_field" not in dh.arrays


def test_datahandling_defaults_to_the_card():
    """Entry points allocate on the card unless asked: without one,
    allocating fails instead of falling back to the CPU."""
    dh = DataHandling((4, 4))
    assert dh.device.type == "cuda" and dh.default_dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            dh.add_field("u")


@pytest.mark.parametrize("where", ["DataHandling", "GraphDataHandling",
                                   "Simulation", "compile"])
def test_mesh_raises(where):
    """A mesh the arrays or the run cannot take raises ValueError, as in
    the JAX package: a global extent (ghost frame included) that does not
    divide its mesh axis, a dim mapped to an axis the mesh lacks, and
    ``fuse="symbolic"`` on a mesh."""
    from pystencils_autodiff_tpu_torch.parallel import make_mesh

    mesh = make_mesh((4,), ("x",), ["cpu"] * 4)
    with pytest.raises(ValueError):
        if where == "DataHandling":
            DataHandling((8, 8), mesh=mesh, dim_axes={0: "x"},
                         device="cpu").add_field("u")
        elif where == "GraphDataHandling":
            GraphDataHandling((8, 8), mesh=mesh, dim_axes={0: "x"},
                              device="cpu").add_field("u")
        elif where == "Simulation":
            Simulation(mesh=mesh, dim_axes={0: "y"}).add_sweep(
                heat(), {"u": "u_next"})
        else:
            _heat_graphs()[0].compile(fuse="symbolic", mesh=mesh,
                                      dim_axes={0: "x"})


# ------------------------------------------------------------ Simulation --

def _heat_dh(n=14, seed=0):
    """Port and JAX datahandlings with the same random ``u``."""
    u = _rand(seed, (n + 2, n + 2))
    dh = DataHandling((n, n), ghost_layers=1, default_dtype=F64, device="cpu")
    jd = jdh_mod.DataHandling((n, n), ghost_layers=1,
                              default_dtype=jnp.float64)
    for d, conv in ((dh, torch.tensor), (jd, jnp.asarray)):
        d.add_field("u")
        d.set_array("u", conv(u))
    return dh, jd


@pytest.mark.parametrize("periodic", [False, True])
def test_simulation_heat_matches_jax(periodic):
    dh, jd = _heat_dh()
    u0 = dh["u"]
    sim = Simulation(dh, periodic=periodic)
    sim.add_sweep(heat(), {"u": "u_next"})
    final = sim.run(dh.state(), 4)
    jsim_ = jsim.Simulation(jd, periodic=periodic)
    jsim_.add_sweep(fresh_twin(heat()), {"u": "u_next"})
    jsim_.run(jd.state(), 4)
    assert dh["u"] is final["u"]
    _close(dh["u"], jd["u"])
    f = heat().torch_function(periodic=periodic)
    u = u0
    for _ in range(4):
        u = f(u)
    _close(dh["u"], u)


def _elastic_states(n=20):
    st = {name: _rand(30 + i, (n, n), 0.1)
          for i, name in enumerate(ELASTIC_FIELDS)}
    st["sxx"][n // 2, n // 2] = 1.0
    return st


def test_simulation_multi_sweep_elastic_matches_jax():
    vop, sop = elastic_pair()
    st = _elastic_states()
    finals = []
    for S, D, conv, twin, dt in (
            (Simulation, DataHandling, torch.tensor, lambda o: o, F64),
            (jsim.Simulation, jdh_mod.DataHandling, jnp.asarray, fresh_twin,
             jnp.float64)):
        kw = {"device": "cpu"} if D is DataHandling else {}
        dh = D((18, 18), ghost_layers=1, default_dtype=dt, **kw)
        for name, a in st.items():
            dh.add_field(name)
            dh.set_array(name, conv(a))
        sim = S(dh)
        sim.add_boundary_conditions({"vx": "neumann", "vy": "neumann"})
        sim.add_sweep(twin(vop), VEL_CARRY)
        sim.add_sweep(twin(sop), STRESS_CARRY)
        finals.append(sim.run(dh.state(), 10))
    energy = sum(float((v ** 2).sum()) for v in finals[0].values())
    assert energy > 0 and np.isfinite(energy)
    for name in ELASTIC_FIELDS:
        _close(finals[0][name], finals[1][name], name)


@pytest.mark.parametrize("checkpoint", ["none", "step", "sqrt"])
def test_simulation_run_gradient_matches_jax(checkpoint):
    """∂/∂κ of a loss over the final state and the recorded per-step
    probes, through ``Simulation.run`` (checkpointed as asked)."""
    op = heat_step_op(dt=0.05, kappa_field=True, dtype="float64")
    u0, k0 = _rand(1, (12, 12)), 1.0 + 0.1 * _rand(2, (12, 12))

    def record(s):
        return s["u"][3]

    sim = Simulation()
    sim.add_sweep(op, {"u": "u_next"})
    kappa = torch.tensor(k0, requires_grad=True)
    out, recs = sim.run({"u": torch.tensor(u0), "kappa": kappa}, 5,
                        checkpoint=checkpoint, record=record)
    (g,) = torch.autograd.grad((out["u"] ** 2).sum() + recs.sum(), kappa)

    js = jsim.Simulation()
    js.add_sweep(fresh_twin(op), {"u": "u_next"})

    def jloss(k):
        o, r = js.run({"u": jnp.asarray(u0), "kappa": k}, 5,
                      checkpoint=checkpoint, record=record)
        return jnp.sum(o["u"] ** 2) + jnp.sum(r)

    assert float(g.abs().max()) > 0
    _close(g, jax.grad(jloss)(jnp.asarray(k0)))
    # the step function alone, through the time loop
    st = run_timeloop(sim.step_fn(), {"u": torch.tensor(u0),
                                      "kappa": torch.tensor(k0)}, 5)
    _close(st["u"], out["u"])


def test_simulation_fused_op_heat_chain_matches_jax():
    """``fused_op`` rewires carry chains: two heat sweeps become one op."""
    op = heat()
    op2 = renamed(op, "heat2")
    sim, js = Simulation(), jsim.Simulation()
    for s, twin in ((sim, lambda o: o), (js, fresh_twin)):
        s.add_sweep(twin(op), {"u": "u_next"})
        s.add_sweep(twin(op2), {"u": "u_next"})
    fused, j_fused = sim.fused_op(), js.fused_op()
    assert [f.name for f in fused.forward_input_fields] == ["u"]
    assert fused._fused_carry == j_fused._fused_carry == {"u": "u_next"}
    assert fused.op_name == "fused_step"
    x = _rand(6, (20, 20))
    fus = fused.torch_function()(torch.tensor(x))
    _close(fus, j_fused.jax_function(lowering="jnp")(jnp.asarray(x)))
    f1 = op.torch_function()
    seq = f1(f1(torch.tensor(x)))
    _close(fus[2:-2, 2:-2], seq[2:-2, 2:-2])


def test_simulation_fused_elastic_full_step_matches_jax():
    vop, sop = elastic_pair()
    sim, js = Simulation(), jsim.Simulation()
    for s, twin in ((sim, lambda o: o), (js, fresh_twin)):
        s.add_sweep(twin(vop), VEL_CARRY)
        s.add_sweep(twin(sop), STRESS_CARRY)
    fused, j_fused = sim.fused_op("elastic_fused"), js.fused_op(
        "elastic_fused")
    ins = [f.name for f in fused.forward_input_fields]
    assert set(ins) == set(ELASTIC_FIELDS)
    assert fused._fused_carry == j_fused._fused_carry
    state = {n: _rand(60 + i, (18, 18)) for i, n in enumerate(sorted(ins))}
    outs = fused.torch_function()(**{n: torch.tensor(state[n]) for n in ins})
    j_outs = j_fused.jax_function(lowering="jnp")(
        **{n: jnp.asarray(state[n]) for n in ins})
    for o, j in zip(outs, j_outs):
        _close(o, j)
    # the unfused step on the deep interior
    seq = sim.step_fn()({n: torch.tensor(a) for n, a in state.items()})
    by_name = dict(zip([f.name for f in fused.forward_output_fields], outs))
    for dst, src in fused._fused_carry.items():
        _close(by_name[src][2:-2, 2:-2], seq[dst][2:-2, 2:-2], dst)


def test_one_sweep_fused_op_leaves_the_model_op_alone():
    """The JAX package renames the memoised model op it fuses alone; the
    port returns a fresh op."""
    sim = Simulation()
    sim.add_sweep(heat_step_op(), {"u": "u_next"})
    fused = sim.fused_op("x")
    assert fused.op_name == "x" and fused._fused_carry == {"u": "u_next"}
    assert fused is not heat_step_op()
    assert heat_step_op().op_name == "heat_step2d"
    assert not hasattr(heat_step_op(), "_fused_carry")


def test_simulation_boundary_ghost_and_validation():
    sim = Simulation()
    with pytest.raises(ValueError, match="give `ghost`"):
        sim.add_boundary_conditions({"u": "neumann"})
    with pytest.raises(ValueError, match="no sweeps"):
        sim.step_fn()
    with pytest.raises(ValueError, match="no sweeps"):
        sim.fused_op()
    sim.add_sweep(heat(), {"u": "u_next"})
    sim.add_boundary_conditions({"u": "neumann"})
    assert sim.boundaries[0].ghost == forward_program(heat()).ghost


# ------------------------------------------------------- the call graph --

def _graphs(n, ghost, arrays, body):
    """(port, JAX) graph datahandlings recording the same program:
    ``arrays`` {name: full array}, ``body`` a list of ("boundary",
    make_specs(conv)), ("sweep", op, carry) and ("comm", names)."""
    pdh = GraphDataHandling(n, ghost_layers=ghost, default_dtype=F64,
                            device="cpu")
    jd = jgraph.GraphDataHandling(n, ghost_layers=ghost,
                                  default_dtype=jnp.float64)
    for dh, conv, twin in ((pdh, torch.tensor, lambda o: o),
                           (jd, jnp.asarray, fresh_twin)):
        for name, a in arrays.items():
            dh.add_field(name)
            dh.set_array(name, conv(a))
        with dh.timeloop() as loop:
            for kind, *rest in body:
                if kind == "boundary":
                    loop.boundary(rest[0](conv))
                elif kind == "sweep":
                    loop.sweep(twin(rest[0]), rest[1])
                else:
                    loop.communicate(*rest[0])
    return pdh, jd


def _heat_graphs(n=24, bc=None):
    return _graphs((n - 2, n - 2), 1, {"u": _rand(0, (n, n))}, [
        ("boundary", lambda conv: {"u": bc or "neumann"}),
        ("comm", ["u"]),
        ("sweep", heat(), {"u": "u_next"})])


def _elastic_graphs(n, ghost, sponge):
    arrays = {name: _rand(40 + i, (n, n), 0.1)
              for i, name in enumerate(ELASTIC_FIELDS)}
    vop, sop = elastic_pair()
    body = [("sweep", vop, VEL_CARRY), ("sweep", sop, STRESS_CARRY)]
    if sponge:
        damp = cerjan_damping((n, n), width=4, alpha=0.1, dtype=F64,
                              device="cpu").numpy()

        def specs(conv):
            d = conv(damp)  # one array, recorded on every field
            return {name: ("sponge", d) for name in ELASTIC_FIELDS}
        body.insert(0, ("boundary", specs))
    return _graphs((n - 2 * ghost,) * 2, ghost, arrays, body)


def _value_and_grad(prun, jrun, pdh, jd, n_steps):
    """Both runs' final states and the gradients of Σ sin(final) with
    respect to every initial field."""
    names = sorted(pdh.arrays)
    x = {n: t.clone().requires_grad_() for n, t in pdh.state().items()}
    out = prun(x, n_steps)
    grads = torch.autograd.grad(sum(torch.sin(out[n]).sum() for n in names),
                                [x[n] for n in names])

    def jloss(s):
        o = jrun(s, n_steps)
        return sum(jnp.sum(jnp.sin(o[n])) for n in names)

    j_out = jrun(jd.state(), n_steps)
    j_grads = jax.grad(jloss)(jd.state())
    return ({n: out[n] for n in names}, dict(zip(names, grads)),
            {n: j_out[n] for n in names}, {n: j_grads[n] for n in names})


def _assert_runs_match(prun, jrun, pdh, jd, n_steps):
    out, g, j_out, j_g = _value_and_grad(prun, jrun, pdh, jd, n_steps)
    for n in out:
        _close(out[n], j_out[n], f"value {n}")
        _close(g[n], j_g[n], f"gradient {n}")
        assert float(g[n].abs().max()) > 0
    return out, g


def test_graph_records_the_jax_artifact():
    pdh, jd = _heat_graphs()
    assert [type(n) for n in pdh.graph.nodes] == [AllocNode, TimeloopNode]
    assert [type(n) for n in pdh.graph.nodes[1].body] == [
        BoundaryNode, CommNode, SweepNode]
    assert pdh.graph.describe() == jd.graph.describe()
    assert pdh.graph.to_dict() == jd.graph.to_dict()
    spec = json.loads(pdh.graph.to_json())
    sweep = spec["nodes"][1]["body"][2]
    assert sweep["reads"] == ["u"] and sweep["carry"] == {"u": "u_next"}
    assert spec["nodes"][0]["dtype"] == "float64"


@pytest.mark.parametrize("checkpoint", ["none", "sqrt"])
def test_graph_replay_matches_jax(checkpoint):
    """fuse='none': the BC node, the comm node (nothing on one device)
    and the sweep through its single step; checkpointed as asked."""
    pdh, jd = _heat_graphs()
    run = pdh.compile(checkpoint=checkpoint)
    assert run.steps_per_call == 1 and run.chain is None
    _assert_runs_match(run, jd.compile(checkpoint=checkpoint), pdh, jd, 5)
    # == manual stepping
    step = run.step
    st = pdh.state()
    for _ in range(5):
        st = step(st)
    _close(st["u"], run(pdh.state(), 5)["u"])


def test_graph_symbolic_matches_jax():
    pdh, jd = _heat_graphs()
    out, _ = _assert_runs_match(pdh.compile(fuse="symbolic"),
                                jd.compile(fuse="symbolic"), pdh, jd, 3)
    # one sweep: the same program as the replay
    _close(out["u"], pdh.compile()(pdh.state(), 3)["u"])


def test_graph_symbolic_elastic_matches_jax():
    pdh, jd = _elastic_graphs(18, 1, sponge=False)
    _assert_runs_match(pdh.compile(fuse="symbolic"),
                       jd.compile(fuse="symbolic"), pdh, jd, 2)


STAGE_CASES = {
    # (graphs, port compile kwargs, JAX compile kwargs, steps)
    "heat-neumann-k2": (lambda: _heat_graphs(),
                        {"k": 2}, {}, 4),
    "heat-neumann-k2-fused-bwd-sqrt": (lambda: _heat_graphs(),
                                       {"k": 2, "fused_bwd": True,
                                        "checkpoint": "sqrt"}, {}, 4),
    "elastic-periodic-k2": (lambda: _elastic_graphs(32, 0, sponge=False),
                            {"k": 2, "periodic": True},
                            {"periodic": True}, 4),
    "elastic-sponge-k2-fused-bwd": (lambda: _elastic_graphs(24, 1,
                                                            sponge=True),
                                    {"k": 2, "fused_bwd": True}, {}, 4),
}


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_graph_stages_match_jax(name):
    """fuse='stages' against the JAX package's fuse='stages' (its Pallas
    chain in interpret mode) and against its jnp replay."""
    make, kw, jkw, steps = STAGE_CASES[name]
    pdh, jd = make()
    run = pdh.compile(fuse="stages", **kw)
    assert run.steps_per_call == kw["k"]
    j_fused = jd.compile(fuse="stages", k=kw["k"], interpret=True,
                         tile_rows=16, **jkw)
    j_replay = jd.compile(lowering="jnp", **jkw)
    out, g = _assert_runs_match(run, j_replay, pdh, jd, steps)
    j_out = j_fused(jd.state(), steps)
    for n in out:
        _close(out[n], j_out[n], f"against the JAX chain: {n}")


def test_graph_stages_register_a_bc_tensor_once():
    """A damping profile recorded on five fields is one synthetic chain
    input (the JAX package makes one plane per field), cast to the state's
    dtype and device once; the result equals the direct chain's."""
    pdh, _ = _elastic_graphs(24, 1, sponge=True)
    run = pdh.compile(fuse="stages", k=2)
    synthetic = [n for n in run.chain.input_names if n.startswith("_bc_arr")]
    assert synthetic == ["_bc_arr0"] and list(run.bc_planes.arrays) == synthetic
    st = pdh.state()
    out = run(st, 2)
    assert set(out) == set(st)  # the synthetic plane stays out of the state
    cast = run.bc_planes.cast(st["vx"])["_bc_arr0"]
    run(out, 2)
    assert run.bc_planes.cast(st["vx"])["_bc_arr0"] is cast
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain

    vop, sop = elastic_pair()
    chain = fused_stage_chain(
        [(vop, VEL_CARRY), (sop, STRESS_CARRY)], 2,
        boundary={0: {n: ("sponge", "damp") for n in ELASTIC_FIELDS}})
    direct = chain({**st, "damp": cast})
    for n in ELASTIC_FIELDS:
        _close(out[n], direct[n], n)


def test_graph_stage_fusion_boundary_node_rules():
    """Frame BCs on periodic domains and a trailing boundary node raise;
    a bounded recorded Neumann BC fuses (test_graph_stage_fusion_matches_
    replay's rules)."""
    pdh, _ = _heat_graphs()
    with pytest.raises(ValueError, match="meaningless on"):
        pdh.compile(fuse="stages", k=2, periodic=True)
    pdh.graph.nodes[-1].body.append(pdh.graph.nodes[-1].body[0])
    with pytest.raises(ValueError, match="after the last"):
        pdh.compile(fuse="stages", k=2)
    pdh, _ = _heat_graphs()
    with pytest.raises(ValueError, match="not divisible"):
        pdh.compile(fuse="stages", k=2)(pdh.state(), 3)


def test_graph_stage_fusion_passes_extra_fields_through():
    pdh = GraphDataHandling((32, 32), ghost_layers=0, default_dtype=F64,
                            device="cpu")
    pdh.add_field("u")
    pdh.add_field("scratch", init=3.0)
    pdh.set_array("u", _rand(0, (32, 32)))
    with pdh.timeloop() as loop:
        loop.sweep(heat(), {"u": "u_next"})
    out = pdh.compile(fuse="stages", k=2, periodic=True)(pdh.state(), 4)
    assert bool((out["scratch"] == 3.0).all())


def test_graph_symbolic_fusion_rejects_interleaved_boundary():
    vop, sop = elastic_pair()
    pdh = GraphDataHandling((16, 16), ghost_layers=1, default_dtype=F64,
                            device="cpu")
    for name in ELASTIC_FIELDS:
        pdh.add_field(name)
    with pdh.timeloop() as loop:
        loop.sweep(vop, VEL_CARRY)
        loop.boundary({"vx": "neumann"})
        loop.sweep(sop, STRESS_CARRY)
    with pytest.raises(ValueError, match="contiguous"):
        pdh.compile(fuse="symbolic")


def test_graph_symbolic_fusion_preserves_trailing_boundary_order():
    """Recorded [sweep, boundary] keeps the BC after the (fused) sweep."""
    pdh, jd = _graphs((22, 22), 1, {"u": _rand(1, (24, 24))}, [
        ("sweep", heat(), {"u": "u_next"}),
        ("boundary", lambda conv: {"u": ("dirichlet", 7.0)})])
    out_n = pdh.compile()(pdh.state(), 3)["u"]
    out_s = pdh.compile(fuse="symbolic")(pdh.state(), 3)["u"]
    _close(out_s, out_n)
    _close(out_s, jd.compile(fuse="symbolic")(jd.state(), 3)["u"])
    assert bool((out_n[0, :] == 7.0).all())


def test_graph_validation():
    dh = GraphDataHandling((8, 8), ghost_layers=1, device="cpu")
    dh.add_field("u")
    with pytest.raises(ValueError, match="exactly one recorded timeloop"):
        dh.compile()
    pdh, _ = _heat_graphs()
    with pytest.raises(ValueError, match="unknown fuse mode"):
        pdh.compile(fuse="bogus")
    with pytest.raises(TypeError, match="no keyword arguments"):
        pdh.compile(fused_bwd=True)


def test_add_field_array_init_records_placeholder():
    arr = np.arange(100, dtype=np.float64).reshape(10, 10)
    pdh = GraphDataHandling((8, 8), ghost_layers=1, default_dtype=F64,
                            device="cpu")
    jd = jgraph.GraphDataHandling((8, 8), ghost_layers=1,
                                  default_dtype=jnp.float64)
    pdh.add_field("u", init=arr)
    jd.add_field("u", init=arr)
    pdh.add_field("t", init=torch.tensor(arr))
    _close(pdh.arrays["u"], arr)
    assert pdh.graph.nodes[0].init == jd.graph.nodes[0].init == "array(10, 10)"
    assert pdh.graph.nodes[1].init == "array(10, 10)"
    assert pdh.graph.to_dict()["nodes"][0] == jd.graph.to_dict()["nodes"][0]
    pdh.graph.to_json()
