"""The custom ops and the exported artifacts on the card, held against the
same calls on CPU tensors (the plain versions; those are held against the
JAX package in ``test_torch_serving.py``): each op's CUDA kernel against
its CPU kernel, and a saved and loaded artifact against the eager run, at
small float64 sizes.  Every test here needs a CUDA device and skips
without one."""

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  elastic_stages,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import (custom_ops, fused_stage_chain,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.serving import (export_op, export_program,
                                                   load_exported,
                                                   save_exported)

pytestmark = pytest.mark.cuda
RTOL = 1e-12
F64 = torch.float64


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


def test_loaded_stage_program_equals_eager(dev, tmp_path):
    """The elastic pair with a sponge recorded, fuse='stages' (kernels 12
    and 13), exported on the card with its gradient and as a step-count
    artifact: the loaded programs equal the eager run."""
    n = 40
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
    run = gdh.compile(fuse="stages", k=2, fused_bwd=True)
    st = gdh.state()
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
