"""The custom ops and the exported artifacts on the card, held against the
same calls on CPU tensors (the plain versions; those are held against the
JAX package in ``test_torch_serving.py``): each op's CUDA kernel against
its CPU kernel, and a saved and loaded artifact against the eager run, at
small float64 sizes.  Every test here needs a CUDA device and skips
without one."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  elastic_stages,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import launch, torch_ref
from pystencils_autodiff_tpu_torch.ops import (custom_ops, fused_stage_chain,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.serving import (export_op, export_program,
                                                   load_exported,
                                                   save_exported)

pytestmark = pytest.mark.cuda
RTOL = 1e-12
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


def _close(got, ref):
    got, ref = got.detach().cpu().numpy(), ref.detach().cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _t(rng, shape):
    return torch.tensor(rng.standard_normal(shape))


def _cases():
    """(name, op, args on the CPU) of every op, as test_torch_serving's
    opcheck cases build them, at sizes that fill a few tiles, and the
    wrappers that keep their registry entries alive."""
    rng = np.random.default_rng(3)
    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    key = f.entry.key
    out = [("stencil", custom_ops.stencil,
            (key, [_t(rng, (70, 45)), _t(rng, (70, 45))])),
           ("stencil_bwd", custom_ops.stencil_bwd,
            (key, [_t(rng, (70, 45)), _t(rng, (70, 45))],
             [_t(rng, (70, 45))]))]
    chain = fused_time_chain(diffusion3d_op(dt=0.05, dtype="float64"), 2,
                             {"u": "u_next"}, fused_bwd=True)
    sp3 = (12, 10, 37)
    kap = torch.tensor(1 + 0.1 * rng.random(sp3))
    out += [("chain", custom_ops.chain,
             (chain.entry.key, [kap, _t(rng, sp3)])),
            ("chain_bwd", custom_ops.chain_bwd,
             (chain.entry.key, [kap, _t(rng, sp3)],
              [_t(rng, sp3), _t(rng, sp3)], []))]
    sch = fused_stage_chain(elastic_stages(dt=0.01, dtype="float64"), 2,
                            fused_bwd=True,
                            boundary={0: {"vx": ("sponge", "damp")}})
    names = sch.input_names
    state = [torch.tensor(0.9 + 0.1 * rng.random((40, 37))) if n == "damp"
             else _t(rng, (40, 37)) for n in names]
    out += [("stage_chain", custom_ops.stage_chain,
             (sch.entry.key, None, state)),
            ("stage_chain_bwd", custom_ops.stage_chain_bwd,
             (sch.entry.key, None, [n == "damp" for n in names], state,
              [_t(rng, (40, 37)) for _ in names]))]
    return out, (f, chain, sch)


def _to(args, dev):
    return tuple([a.to(dev) for a in x] if isinstance(x, list)
                 and x and isinstance(x[0], torch.Tensor)
                 else x.to(dev) if isinstance(x, torch.Tensor) else x
                 for x in args)


@pytest.mark.parametrize("case", range(6))
def test_op_cuda_kernel_matches_cpu_kernel(case, dev):
    """Each op's CUDA kernel (the hand-written kernels) against its CPU
    kernel (the plain versions) on the same inputs."""
    cases, _keep = _cases()
    name, op, args = cases[case]
    ref = op(*args)
    got = op(*_to(args, dev))
    assert len(got) == len(ref), name
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        _close(g, r)


def test_a_cuda_tensor_reaches_the_kernel(dev):
    """The op on CUDA tensors launches the window kernel once a call (its
    CUDA kernel; no plain version runs)."""
    f = heat_step_op(kappa_field=True, dtype="float64").torch_function()
    u = torch.randn((64, 48), dtype=F64, device=dev)
    ck.reset_launch_counts()
    f(u=u, kappa=u)
    assert ck.LAUNCHES == 1


def test_loaded_op_equals_eager(dev, tmp_path):
    """export_op on the card (fixed and symbolic shapes), saved and loaded:
    values and gradients equal the eager ``torch_function`` bit for bit."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    f = op.torch_function()
    for i, spatial in enumerate([(96, 80), ("n", "m")]):
        path = str(tmp_path / f"op{i}.pt2")
        save_exported(export_op(op, spatial, dtype=F64), path)
        fn, vjp = load_exported(path)
        for shape in ([(96, 80)] if i == 0 else [(96, 80), (67, 130)]):
            kap, u, cot = (torch.randn(shape, dtype=F64, device=dev)
                           for _ in range(3))
            ki, ui = kap.clone().requires_grad_(), u.clone().requires_grad_()
            eager = f(kappa=ki, u=ui)
            gk, gu = torch.autograd.grad(eager, [ki, ui], cot)
            assert torch.equal(fn(kap, u), eager.detach())
            lk, lu = vjp(kap, u, cot)
            assert torch.equal(lk, gk) and torch.equal(lu, gu)


def _elastic_run(dev, n=40):
    """The elastic pair with a sponge recorded at n² f64, fuse='stages',
    k=2 with kernel 13's backward; (run, state)."""
    gdh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                            default_dtype=F64, device=dev)
    rng = np.random.default_rng(4)
    for nm in ("vx", "vy", "sxx", "syy", "sxy"):
        gdh.add_field(nm)
        gdh.set_array(nm, torch.tensor(0.1 * rng.standard_normal((n, n)),
                                       device=dev))
    damp = torch.tensor(0.9 + 0.1 * rng.random((n, n)), device=dev)
    with gdh.timeloop() as loop:
        loop.boundary({nm: ("sponge", damp) for nm in gdh.fields})
        for op, carry in elastic_stages(dt=0.01, dtype="float64"):
            loop.sweep(op, carry)
    return gdh.compile(fuse="stages", k=2, fused_bwd=True), gdh.state()


def test_loaded_stage_program_equals_eager(dev, tmp_path):
    """The elastic pair with a sponge recorded, fuse='stages' (kernels 12
    and 13), exported on the card with its gradient and as a step-count
    artifact: the loaded programs equal the eager run."""
    run, st = _elastic_run(dev)
    names = sorted(st)
    path = str(tmp_path / "el.pt2")
    save_exported(export_program(run, st, 4), path)
    fn, vjp = load_exported(path)
    x = {nm: t.clone().requires_grad_() for nm, t in st.items()}
    out = run(x, 4)
    cots = [torch.randn_like(st[nm]) for nm in names]
    grads = torch.autograd.grad([out[nm] for nm in names],
                                [x[nm] for nm in names], cots)
    for got, ref in zip(fn(*[st[nm] for nm in names]),
                        [out[nm] for nm in names]):
        assert torch.equal(got, ref.detach())
    for got, ref in zip(vjp(*[st[nm] for nm in names], *cots), grads):
        assert torch.equal(got, ref)
    save_exported(export_program(run, st, n_steps=None, with_gradient=False),
                  str(tmp_path / "dyn.pt2"))
    dyn, _ = load_exported(str(tmp_path / "dyn.pt2"))
    ref = run(st, 6)
    for got, nm in zip(dyn(6, *[st[nm] for nm in names]), names):
        assert torch.equal(got, ref[nm])
    with pytest.raises(ValueError, match="multiple"):
        dyn(3, *[st[nm] for nm in names])


CHILD = textwrap.dedent("""
    import json, sys
    from chip_smoke import (TORCH_ONLY_BLOCKED, block_the_port,
                            kernel_launches, torch_only_load)
    block_the_port()
    import torch
    path, inputs, out = sys.argv[1:]
    data = torch.load(inputs, map_location="cuda")
    primal, vjp, meta = torch_only_load(path)
    calls = {"primal": (primal.module(), data["inputs"]),
             "vjp": (vjp.module(), data["inputs"] + data["cots"])}
    res = {}
    for label, (fn, args) in calls.items():
        torch.ops.psat_launch.reset_launch_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        res[label] = {"out": list(got) if isinstance(got, (tuple, list))
                      else [got], "launches": kernel_launches(meta)}
    torch.save(res, out)
    print(json.dumps(sorted(m for m in sys.modules
                            if m.split(".")[0] in TORCH_ONLY_BLOCKED)))
""")


def _torch_only(tmp_path, path, ins, cots):
    """The torch-only load of ``path`` in a fresh process (the port, jax
    and the JAX package blocked, no compiler on its PATH) on the card: per
    call ("primal", "vjp") the outputs and the leaf op's launches by the
    launch each library serves."""
    torch.save({"inputs": [t.cpu() for t in ins],
                "cots": [t.cpu() for t in cots]}, str(tmp_path / "in.pt"))
    empty = tmp_path / "no_compilers"
    empty.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(empty))
    env.pop("CUDA_HOME", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, path, str(tmp_path / "in.pt"),
         str(tmp_path / "out.pt")], capture_output=True, text=True, env=env,
        timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    return torch.load(str(tmp_path / "out.pt"))


def _launched(fn):
    """``fn()`` and its eager launches by description
    (``ops.launch.LAUNCHES``)."""
    launch.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(launch.LAUNCHES)


def _check_torch_only(tmp_path, exp, f, ins, cots):
    """Save ``exp``; the torch-only load's primal and VJP equal ``f``'s
    eager outputs and gradients bit for bit and make its kernel launches,
    by the launch each serves; no plain version ran here."""
    path = str(tmp_path / "art.pt2")
    save_exported(exp, path)
    xs = [t.clone().requires_grad_() for t in ins]

    def value_and_grad():
        out = f(*xs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return torch.autograd.grad(outs, xs, cots)

    plain = torch_ref.PLAIN_CALLS
    e_out, e_primal = _launched(lambda: f(*ins))
    e_out = list(e_out) if isinstance(e_out, (tuple, list)) else [e_out]
    e_grads, e_vjp = _launched(value_and_grad)
    assert torch_ref.PLAIN_CALLS == plain
    got = _torch_only(tmp_path, path, ins, cots)
    for g, e in zip(got["primal"]["out"], e_out):
        assert torch.equal(g, e)
    for g, e in zip(got["vjp"]["out"], e_grads):
        assert torch.equal(g, e)
    assert e_primal and got["primal"]["launches"] == e_primal
    assert got["vjp"]["launches"] == e_vjp


def test_torch_only_load_of_the_op_makes_the_eager_launches(dev, tmp_path):
    """The κ-heat op exported on the card: loaded with torch alone in a
    fresh process, its forward and VJP equal the eager op bit for bit and
    launch the eager call's window kernels, by name (one forward, then
    one forward and one backward); the exporting process ran no plain
    version."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    f = op.torch_function()
    names = [fl.name for fl in op.forward_input_fields]
    plain = torch_ref.PLAIN_CALLS
    exp = export_op(op, (96, 80), dtype=F64)
    assert torch_ref.PLAIN_CALLS == plain
    ins = [torch.randn((96, 80), dtype=F64, device=dev) for _ in names]
    cots = [torch.randn((96, 80), dtype=F64, device=dev)]
    _check_torch_only(tmp_path, exp,
                      lambda *a: f(**dict(zip(names, a))), ins, cots)


def test_torch_only_load_of_a_stage_program_makes_the_eager_launches(
        dev, tmp_path):
    """The elastic pair's recorded program (kernels 12 and 13) exported
    on the card and loaded with torch alone: values and gradients bit for
    bit, and the eager run's kernel launches (2 of kernel 12 in the
    primal; 2 + 2 with kernel 13 in the VJP)."""
    run, st = _elastic_run(dev)
    names = sorted(st)
    plain = torch_ref.PLAIN_CALLS
    exp = export_program(run, st, 4)
    assert torch_ref.PLAIN_CALLS == plain

    def f(*xs):
        out = run(dict(zip(names, xs)), 4)
        return tuple(out[nm] for nm in names)

    ins = [st[nm] for nm in names]
    cots = [torch.randn_like(t) for t in ins]
    _check_torch_only(tmp_path, exp, f, ins, cots)
