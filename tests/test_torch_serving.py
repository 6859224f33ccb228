"""The port's ahead-of-time export (``pystencils_autodiff_tpu_torch.serving``)
against the JAX package's ``lowering="jnp"`` in float64, rtol 1e-10: the
six cases of ``tests/test_serving.py`` (round trip of values and
gradients, a whole recorded program, shape-polymorphic, step-count
artifacts, the ``fuse="stages"`` step scaling, the saved step guard), a
load in a fresh process with jax, the JAX package and the port blocked
(the torch-only load; ``test_torch_serving_load.py`` holds every artifact
kind that way), and ``torch.library.opcheck`` on every custom op the port
registers."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import graph_datahandling as jgraph
from pystencils_autodiff_tpu.models.heat import heat_step_op as jheat
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields
from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  elastic_stages,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.ops import (custom_ops, fused_stage_chain,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.serving import (export_op, export_program,
                                                   load_exported,
                                                   save_exported)

RTOL = 1e-10
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _op():
    x, y, k = fields("x, y, k", 2)
    return AutoDiffOp(
        [Assignment(y.center,
                    k[0, 0] * (x[1, 0] + x[-1, 0] - 2 * x[0, 0]) + x[0, 1] ** 2)],
        op_name="srv")


def _close(got, ref, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300),
                               err_msg=err_msg)


def _args(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _jax_value_and_vjp(op, args, cot):
    f = jax_twin(op).jax_function(lowering="jnp")
    ja = [jnp.asarray(a) for a in args]
    out, pull = jax.vjp(lambda *a: f(*a), *ja)
    return out, pull(jnp.asarray(cot))


def _save_load(exp, tmp_path, name="art.pt2"):
    path = str(tmp_path / name)
    save_exported(exp, path)
    return load_exported(path)


def test_export_roundtrip_values_and_grads(tmp_path):
    op = _op()
    exp = export_op(op, (16, 16), dtype=F64, device="cpu")
    fn, vjp_fn = _save_load(exp, tmp_path)
    assert vjp_fn is not None
    names = [f.name for f in op.forward_input_fields]
    args = _args(0, (16, 16), len(names))
    cot = np.random.default_rng(1).standard_normal((16, 16))
    ref, jgrads = _jax_value_and_vjp(op, args, cot)
    targs = [torch.tensor(a) for a in args]
    _close(fn(*targs), ref)
    grads = vjp_fn(*targs, torch.tensor(cot))
    for g, r, n in zip(grads, jgrads, names):
        _close(g, r, n)


def _heat_graphs(n, steps_bc=True, fuse_seed=0, dtype=F64):
    """(port, JAX) graph datahandlings recording the Neumann (or no-BC)
    heat sweep on the same seeded u."""
    u = np.random.default_rng(fuse_seed).standard_normal((n, n))
    pdh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                            default_dtype=dtype, device="cpu")
    jd = jgraph.GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                                  default_dtype=jnp.float64)
    name = "float64" if dtype == F64 else "float32"
    for dh, conv, op in ((pdh, lambda a: torch.tensor(a, dtype=dtype),
                          heat_step_op(dt=0.1, dtype=name)),
                         (jd, jnp.asarray, jheat(dt=0.1, kappa_field=False,
                                                 dtype="float64"))):
        dh.add_field("u")
        dh.set_array("u", conv(u))
        with dh.timeloop() as loop:
            if steps_bc:
                loop.boundary({"u": "neumann"})
            loop.sweep(op, {"u": "u_next"})
    return pdh, jd


def test_export_whole_program_roundtrip(tmp_path):
    """A recorded GraphDataHandling program (Neumann heat, replay) exports
    with its gradient, reloads and reproduces the JAX package's replay and
    ``jax.grad``."""
    n, steps = 20, 4
    pdh, jd = _heat_graphs(n)
    run = pdh.compile()
    exp = export_program(run, pdh.state(), steps)
    fn, vjp_fn = _save_load(exp, tmp_path)
    u0 = pdh.state()["u"]
    (out,) = fn(u0)
    jrun = jd.compile(lowering="jnp")
    _close(out, jrun(jd.state(), steps)["u"], "value")
    (g,) = vjp_fn(u0, torch.ones_like(u0))
    jg = jax.grad(lambda a: jnp.sum(jrun({"u": a}, steps)["u"]))(
        jd.state()["u"])
    _close(g, jg, "gradient")


def test_shape_polymorphic_export(tmp_path):
    """One artifact serves several grid sizes (symbolic spatial dims)."""
    op = _op()
    exp = export_op(op, ("n", "m"), dtype=F64, device="cpu")
    fn, vjp_fn = _save_load(exp, tmp_path)
    names = [f.name for f in op.forward_input_fields]
    for seed, shape in enumerate([(16, 16), (24, 40), (7, 5)]):
        args = _args(seed, shape, len(names))
        cot = np.random.default_rng(10 + seed).standard_normal(shape)
        ref, jgrads = _jax_value_and_vjp(op, args, cot)
        targs = [torch.tensor(a) for a in args]
        _close(fn(*targs), ref, str(shape))
        for g, r in zip(vjp_fn(*targs, torch.tensor(cot)), jgrads):
            _close(g, r, str(shape))


def test_step_count_polymorphic_program_export(tmp_path):
    """n_steps=None exports one run.step; one artifact serves any step
    count and, with symbolic_spatial, any grid size."""
    pdh, jd = _heat_graphs(20, steps_bc=False)
    run = pdh.compile()
    state = pdh.state()
    exp = export_program(run, state, n_steps=None, with_gradient=False,
                         symbolic_spatial=("n", "m"))
    fn, _ = _save_load(exp, tmp_path)
    jrun = jd.compile(lowering="jnp")
    for steps in (3, 7):
        out = fn(steps, state["u"])
        _close(out[0], jrun(jd.state(), steps)["u"], f"{steps} steps")
    pdh2, jd2 = _heat_graphs(28, steps_bc=False, fuse_seed=3)
    out2 = fn(np.int64(5), pdh2.state()["u"])
    _close(out2[0], jd2.compile(lowering="jnp")(jd2.state(), 5)["u"])
    with pytest.raises(ValueError, match="forward-only"):
        export_program(run, state, n_steps=None, with_gradient=True)


def test_dynamic_export_scales_fused_chain_steps():
    """A step-count artifact of a fuse='stages' run (k physical steps a
    step() call) counts its runtime argument in physical steps."""
    n, k = 16, 2
    pdh, jd = _heat_graphs(n, steps_bc=False)
    run = pdh.compile(fuse="stages", k=k)
    state = pdh.state()
    exp = export_program(run, state, n_steps=None, with_gradient=False)
    assert exp.steps_per_call == k
    out = exp(4, state["u"])[0]
    _close(out, jd.compile(lowering="jnp")(jd.state(), 4)["u"])
    with pytest.raises(ValueError, match="multiple"):
        exp(3, state["u"])


def test_saved_dynamic_artifact_keeps_step_guard(tmp_path):
    """save/load keeps the multiple-of-chain-depth check, for Python and
    numpy integers and 0-d tensors."""
    n, k = 16, 2
    pdh, _ = _heat_graphs(n, steps_bc=False)
    run = pdh.compile(fuse="stages", k=k)
    exp = export_program(run, pdh.state(), n_steps=None,
                         with_gradient=False)
    u = torch.tensor(np.random.default_rng(1).standard_normal((n, n)))
    with pytest.raises(ValueError, match="multiple"):
        exp(torch.tensor(3), u)
    fn, _ = _save_load(exp, tmp_path, "prog.pt2")
    out = fn(torch.tensor(4), u)
    assert out[0].shape == (n, n)
    for bad in (3, np.int32(3), torch.tensor(3)):
        with pytest.raises(ValueError, match="multiple"):
            fn(bad, u)


# ---------------------------------------------------------------------------
# Beyond the JAX package's cases.

def _elastic_program(n=12, k=2):
    """Config #4's recorded graph (a Cerjan-like sponge on the five fields,
    the velocity and the stress sweep) at n² f64, fuse='stages', k, with
    kernel 13's fused backward."""
    gdh = GraphDataHandling((n - 2, n - 2), ghost_layers=1, default_dtype=F64,
                            device="cpu")
    rng = np.random.default_rng(21)
    for nm in ("vx", "vy", "sxx", "syy", "sxy"):
        gdh.add_field(nm)
        gdh.set_array(nm, torch.tensor(0.1 * rng.standard_normal((n, n))))
    damp = torch.tensor(0.9 + 0.1 * rng.random((n, n)))
    with gdh.timeloop() as loop:
        loop.boundary({nm: ("sponge", damp) for nm in gdh.fields})
        for op, carry in elastic_stages(dt=0.01, dtype="float64"):
            loop.sweep(op, carry)
    return gdh, gdh.compile(fuse="stages", k=k, fused_bwd=True)


def test_load_in_a_fresh_process_with_jax_blocked(tmp_path):
    """Artifacts saved here load in a fresh ``python3`` with jax, the JAX
    package and the port blocked and no compiler on its ``PATH``, through
    the torch-only load (``chip_smoke.torch_only_load``): the graphs hold
    the plain versions' aten ops.  The op (values and VJP), config #4's
    recorded stage-chain program with kernel 13's backward (loss
    gradients), a fused 3D chain's step and a step-count artifact equal
    the eager runs bit for bit (the same plain versions)."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    f = op.torch_function()
    rng = np.random.default_rng(5)
    u, kap = (torch.tensor(rng.standard_normal((14, 12))) for _ in range(2))
    cot = torch.tensor(rng.standard_normal((14, 12)))
    ref = {"op_out": f(u=u, kappa=kap)}
    ui, ki = u.clone().requires_grad_(), kap.clone().requires_grad_()
    ref["op_gu"], ref["op_gk"] = torch.autograd.grad(f(u=ui, kappa=ki),
                                                     [ui, ki], cot)
    save_exported(export_op(op, (14, 12), dtype=F64, device="cpu"),
                  str(tmp_path / "op.pt2"))

    gdh, run = _elastic_program()
    st = gdh.state()
    names = sorted(st)
    x = {nm: t.clone().requires_grad_() for nm, t in st.items()}
    out = run(x, 4)
    grads = torch.autograd.grad([out[nm] for nm in names],
                                [x[nm] for nm in names],
                                [torch.ones_like(out[nm]) for nm in names])
    for nm, gr in zip(names, grads):
        ref[f"el_{nm}"], ref[f"el_g{nm}"] = out[nm].detach(), gr
    save_exported(export_program(run, st, 4), str(tmp_path / "el.pt2"))
    save_exported(export_program(run, st, n_steps=None, with_gradient=False),
                  str(tmp_path / "dyn.pt2"))
    ref["dyn_vx"] = run(st, 6)["vx"]

    chain = fused_time_chain(diffusion3d_op(dt=0.05, dtype="float64"), 2,
                             {"u": "u_next"}, fused_bwd=True)
    c_st = {"u": torch.tensor(rng.standard_normal((6, 5, 8))),
            "kappa": torch.tensor(1 + 0.1 * rng.random((6, 5, 8)))}
    cx = {nm: t.clone().requires_grad_() for nm, t in c_st.items()}
    c_out = chain(cx)
    ref["ch_u"] = c_out["u"].detach()
    ref["ch_gu"], ref["ch_gk"] = torch.autograd.grad(
        c_out["u"].square().sum(), [cx["u"], cx["kappa"]])
    save_exported(export_program(lambda s, n: chain(s), c_st, 1),
                  str(tmp_path / "ch.pt2"))

    torch.save({"ref": ref, "u": u, "kap": kap, "cot": cot, "st": st,
                "c_st": c_st}, str(tmp_path / "ref.pt"))
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu",
                   "pystencils_autodiff_tpu_torch")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        from chip_smoke import torch_only_load
        def load(p):
            primal, vjp, meta = torch_only_load(p)
            return (primal.module(), vjp.module() if vjp else None, meta)
        d = {str(tmp_path)!r}
        data = torch.load(d + "/ref.pt")
        ref = data["ref"]
        got = {{}}
        fn, vjp, _ = load(d + "/op.pt2")
        got["op_out"] = fn(data["kap"], data["u"])
        got["op_gk"], got["op_gu"] = vjp(data["kap"], data["u"], data["cot"])
        fn, vjp, _ = load(d + "/el.pt2")
        st = data["st"]
        names = sorted(st)
        outs = fn(*[st[n] for n in names])
        grads = vjp(*[st[n] for n in names],
                    *[torch.ones_like(st[n]) for n in names])
        for n, o, g in zip(names, outs, grads):
            got["el_" + n], got["el_g" + n] = o, g
        dyn, _, meta = load(d + "/dyn.pt2")
        state = [st[n] for n in names]
        for _ in range(6 // meta["steps_per_call"]):
            state = list(dyn(*state))
        got["dyn_vx"] = state[names.index("vx")]
        fn, vjp, _ = load(d + "/ch.pt2")
        c = data["c_st"]
        got["ch_u"] = fn(c["kappa"], c["u"])[1]
        gk, gu = vjp(c["kappa"], c["u"], torch.zeros_like(c["kappa"]),
                     2 * got["ch_u"])
        got["ch_gk"], got["ch_gu"] = gk, gu
        for key, r in ref.items():
            assert torch.equal(got[key], r), key
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("OK", len(ref))
    """)
    empty = tmp_path / "no_compilers"
    empty.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(empty))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith(f"OK {len(ref)}")


def _opcheck_cases():
    """(op, args) samples of every registered op at small f64 shapes, and
    the wrappers that keep their registry entries alive."""
    rng = np.random.default_rng(7)

    def t(shape, grad=False):
        return torch.tensor(rng.standard_normal(shape), requires_grad=grad)

    cases = []
    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    key = f.entry.key
    cases.append((custom_ops.stencil, (key, [t((9, 8), True),
                                             t((9, 8), True)])))
    cases.append((custom_ops.stencil_bwd, (key, [t((9, 8)), t((9, 8))],
                                           [t((9, 8))])))
    chain = fused_time_chain(diffusion3d_op(dt=0.05, dtype="float64"), 2,
                             {"u": "u_next"}, fused_bwd=True)
    ck = chain.entry.key
    cases.append((custom_ops.chain, (ck, [t((6, 5, 7), True),
                                          t((6, 5, 7), True)])))
    cases.append((custom_ops.chain_bwd, (ck, [t((6, 5, 7)), t((6, 5, 7))],
                                         [t((6, 5, 7)), t((6, 5, 7))], [])))
    probed = fused_time_chain(heat_step_op(dtype="float64"), 2,
                              {"u": "u_next"}, fused_bwd=True,
                              probes=[("u", 3)])
    pk = probed.entry.key
    cases.append((custom_ops.chain, (pk, [t((10, 9), True)])))
    cases.append((custom_ops.chain_bwd, (pk, [t((10, 9))], [t((10, 9))],
                                         [t((2, 9))])))
    stages = elastic_stages(dt=0.01, dtype="float64")
    sch = fused_stage_chain(stages, 2, fused_bwd=True,
                            boundary={0: {"vx": ("sponge", "damp")}})
    sk = sch.entry.key
    names = sch.input_names
    state = [t((10, 9), True) for _ in names]
    cases.append((custom_ops.stage_chain, (sk, None, state)))
    wanted = [n == "damp" for n in names]
    cots = [t((10, 9)) for _ in names]
    cases.append((custom_ops.stage_chain_bwd,
                  (sk, None, wanted, [s.detach() for s in state], cots)))
    return cases, (f, chain, probed, sch)


@pytest.mark.parametrize("case", range(8))
def test_opcheck_every_registered_op(case):
    """``torch.library.opcheck`` (schema, autograd registration, fake
    tensors, AOT dispatch with dynamic shapes) on each of the six ops,
    the chain ops with and without probe records."""
    cases, _keep = _opcheck_cases()
    op, args = cases[case]
    torch.library.opcheck(op, args)


def _parallel_opcheck_cases():
    """(op, args) samples of the ``parallel/`` ops — one exchange, its
    transpose, a sharded fused chain and its backward — on two shards of
    the CPU, and the objects that keep their entries alive."""
    from pystencils_autodiff_tpu_torch.parallel import (ShardedChain,
                                                        make_mesh)
    from pystencils_autodiff_tpu_torch.parallel.halo import halo_entry

    rng = np.random.default_rng(8)

    def t(shape, grad=False):
        return torch.tensor(rng.standard_normal(shape), requires_grad=grad)

    mesh = make_mesh((2,), ("x",), ["cpu"] * 2)
    ent = halo_entry(mesh, 0, "x", 1, 2, False)
    chain = ShardedChain(heat_step_op(dt=0.1, dtype="float64"), 2, mesh,
                         {0: "x"}, carry_map={"u": "u_next"},
                         fused_bwd=True)
    chain({"u": t((16, 9))})
    ck = chain._entry.key
    blocks = [t((8, 9), True), t((8, 9), True)]
    return [(custom_ops.halo, (ent.key, blocks)),
            (custom_ops.halo_bwd, (ent.key, [t((11, 9), True),
                                             t((11, 9), True)])),
            (custom_ops.sharded_chain, (ck, [16, 9], blocks)),
            (custom_ops.sharded_chain_bwd,
             (ck, [16, 9], [True, True], [b.detach() for b in blocks],
              [t((8, 9)), t((8, 9))]))], (ent, chain, mesh)


@pytest.mark.parametrize("case", range(4))
def test_opcheck_parallel_ops(case):
    """``torch.library.opcheck`` on the halo exchange, its transpose and
    the sharded chain's two ops."""
    cases, _keep = _parallel_opcheck_cases()
    op, args = cases[case]
    torch.library.opcheck(op, args)


def test_func_vjp_and_compile_through_torch_function():
    """``torch.func.vjp`` and ``torch.compile(backend="eager",
    fullgraph=True)`` see through ``torch_function`` to the custom ops and
    give the eager gradients."""
    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    rng = np.random.default_rng(3)
    u, kap, cot = (torch.tensor(rng.standard_normal((12, 11)))
                   for _ in range(3))
    ui, ki = u.clone().requires_grad_(), kap.clone().requires_grad_()
    eager = torch.autograd.grad(f(u=ui, kappa=ki), [ui, ki], cot)
    out, pull = torch.func.vjp(lambda a, b: f(u=a, kappa=b), u, kap)
    for g, e in zip(pull(cot), eager):
        assert torch.equal(g, e)
    compiled = torch.compile(lambda a, b: (f(u=a, kappa=b) * cot).sum(),
                             backend="eager", fullgraph=True)
    ui, ki = u.clone().requires_grad_(), kap.clone().requires_grad_()
    for g, e in zip(torch.autograd.grad(compiled(ui, ki), [ui, ki]), eager):
        assert torch.equal(g, e)


def test_export_of_a_mesh_run_is_not_ported():
    """A run compiled with ``mesh=`` no longer raises in
    ``export_program``, as the JAX package's does not: the trace goes
    through its exchanges, whose slab copies to each shard's device
    (``to(..., copy=True)``) are in the graph, one per shard a transport
    reaches, beside the shards' plain steps and no op of the port; the
    artifact equals the eager run bit for bit (the sharded export cases
    below hold the rest)."""
    from chip_smoke import halo_copies

    from pystencils_autodiff_tpu_torch.parallel import (exchange_count,
                                                        make_mesh,
                                                        reset_exchange_count)

    pdh, _ = _heat_graphs(12)
    mesh = make_mesh((2,), ("x",), ["cpu"] * 2)
    run = pdh.compile(mesh=mesh, dim_axes={0: "x"})
    reset_exchange_count()
    ref = run(pdh.state(), 2)["u"]
    transports = exchange_count()
    exp = export_program(run, pdh.state(), 2)
    assert not any(str(n.target).startswith("psat.")
                   for n in exp.primal.graph_module.graph.nodes)
    # a transport along a 2-shard bounded axis reaches one shard
    assert halo_copies(exp.primal) == transports > 0
    assert torch.equal(exp(pdh.state()["u"])[0], ref)


@pytest.mark.parametrize("fuse", ["none", "stages"])
def test_sharded_export_loads_in_a_fresh_process(tmp_path, fuse):
    """A run compiled with ``mesh=`` (four shards of the CPU mesh the
    parallel tests build, one process; the Neumann heat sweep) exports
    as the JAX package's ``export_program`` exports its mesh runs, traced
    through its exchanges (``narrow``, a copy to each receiving shard,
    ``cat``) and the shards' steps (the replay's single steps, the fused
    run's sharded chain and its fused backward).  Loaded in a fresh
    process with the port, jax and the JAX package blocked (the
    torch-only load), the artifact equals the eager sharded run bit for
    bit, values and VJP, and its graphs copy as many halo slabs as the
    eager runs' transports move (three shards each reach on the 4-shard
    bounded axis); the eager sharded run equals the unsharded port and
    the JAX package to rounding."""
    from pystencils_autodiff_tpu_torch.parallel import (exchange_count,
                                                        make_mesh,
                                                        reset_exchange_count)

    n, steps = 32, 4
    pdh, jd = _heat_graphs(n, fuse_seed=9)
    mesh = make_mesh((4,), ("x",), ["cpu"] * 8)
    kw = {"k": 2, "fused_bwd": True} if fuse == "stages" else {}
    run = pdh.compile(fuse=fuse, mesh=mesh, dim_axes={0: "x"}, **kw)
    u = pdh.state()["u"]
    cot = torch.tensor(np.random.default_rng(4).standard_normal((n, n)))
    reset_exchange_count()
    out = run({"u": u}, steps)["u"]
    transports = exchange_count()
    ui = u.clone().requires_grad_()
    reset_exchange_count()
    (grad,) = torch.autograd.grad(run({"u": ui}, steps)["u"], ui, cot)
    vjp_transports = exchange_count()
    ref = pdh.compile()({"u": u}, steps)["u"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * ref.abs().max().item())
    jref = np.asarray(jd.compile()(jd.state(), steps)["u"])
    np.testing.assert_allclose(out.numpy(), jref, rtol=1e-12,
                               atol=1e-12 * np.abs(jref).max())

    exp = export_program(run, pdh.state(), steps)
    assert not any(str(nd.target).startswith("psat.")
                   for nd in exp.primal.graph_module.graph.nodes)
    assert torch.equal(exp(u)[0], out)
    path = str(tmp_path / "mesh.pt2")
    save_exported(exp, path)
    torch.save({"u": u, "cot": cot, "out": out, "grad": grad,
                "copies": [3 * transports, 3 * vjp_transports]},
               path + ".ref")
    script = textwrap.dedent(f"""
        import sys
        BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu",
                   "pystencils_autodiff_tpu_torch")
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        from chip_smoke import halo_copies, torch_only_load
        d = torch.load({path!r} + ".ref")
        primal, vjp, _ = torch_only_load({path!r})
        assert torch.equal(primal.module()(d["u"])[0], d["out"])
        assert torch.equal(vjp.module()(d["u"], d["cot"])[0], d["grad"])
        copies = [halo_copies(primal), halo_copies(vjp)]
        assert copies == d["copies"], (copies, d["copies"])
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print("OK")
    """)
    empty = tmp_path / "no_compilers"
    empty.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(empty))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_symbolic_constraints_set_the_dims_minimums():
    """``export_program``'s ``symbolic_constraints`` ("n >= 6") raise a
    symbolic dim's minimum over the default 4; anything else raises."""
    from pystencils_autodiff_tpu_torch.serving import _symbolic_mins

    assert _symbolic_mins(("n", "m", 3), ["n >= 6"]) == [6, 4, 0]
    for bad in (["k >= 2"], ["n <= 6"]):
        with pytest.raises(ValueError, match="constraint"):
            _symbolic_mins(("n", "m"), bad)


def test_sequential_stage_chain_backward_keeps_the_registry_bounded():
    """The sequential-recompute backward of a ``fused_bwd=False`` stage
    chain builds its single steps once: backward after backward, the
    registry of launches does not grow."""
    import gc

    chain = fused_stage_chain(elastic_stages(dt=0.01, dtype="float64"), 2)
    rng = np.random.default_rng(5)

    def grad_once():
        st = {n: torch.tensor(rng.standard_normal((10, 9)),
                              requires_grad=True)
              for n in chain.input_names}
        out = chain(st)
        sum(o.sum() for o in out.values()).backward()
        gc.collect()
        return len(custom_ops.REGISTRY)

    first = grad_once()
    assert [grad_once() for _ in range(4)] == [first] * 4


def test_registry_entries_live_with_their_callers():
    """An entry leaves the registry with the last caller: the wrapper, then
    the autograd graph of a call, which can be differentiated after the
    wrapper is gone."""
    import gc

    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    key = f.entry.key
    u, kap = (torch.tensor(a, requires_grad=True)
              for a in _args(8, (9, 8), 2))
    out = f(u=u, kappa=kap)
    del f
    gc.collect()
    assert key in custom_ops.REGISTRY
    out.sum().backward()
    assert u.grad is not None and kap.grad is not None
    del out
    gc.collect()
    assert key not in custom_ops.REGISTRY
