"""The app-assembly layer and the kernel pair on the card, held against the
same calls on CPU tensors (the plain versions; those are held against the
JAX package in ``test_torch_app.py`` and ``test_torch_api.py``).  Every
test here needs a CUDA device and skips without one."""

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch import AutoDiffOp, Assignment, fields
from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
from pystencils_autodiff_tpu_torch.graph_datahandling import \
    GraphDataHandling
from pystencils_autodiff_tpu_torch.models import (burgers2d_op,
                                                  elastic_stages,
                                                  heat_step_op,
                                                  laplacian3d_op)
from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
from pystencils_autodiff_tpu_torch.ops import backward_programs

RTOL = 1e-12


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")


def _close(got, ref):
    got, ref = got.detach().cpu().numpy(), ref.detach().cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _tfmad_op():
    x, y, k = fields("x, y, k", 2, dtype="float64")
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="tfmad", diff_mode="transposed-forward")


PAIR_OPS = {
    "heat_kappa": lambda: heat_step_op(kappa_field=True, dtype="float64"),
    "burgers2d": lambda: burgers2d_op(),
    "laplacian3d": lambda: laplacian3d_op(dtype="float64"),
    "tfmad": _tfmad_op,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAIR_OPS))
def test_kernel_pair_on_the_card(name):
    """Forward and full-domain backward through the window kernel (a
    staged backward: each stage), float64, against the CPU tensors' run."""
    _need_card()
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    op = PAIR_OPS[name]()
    shape = (24, 20) if op.forward_input_fields[0].spatial_dimensions == 2 \
        else (8, 10, 12)
    written, bwd_names = set(), []
    for p in backward_programs(op):
        bwd_names += [f.name for f in p.input_fields
                      if f.name not in written and f.name not in bwd_names]
        written |= set(p.output_names)
    gen = torch.Generator().manual_seed(3)
    fwd = {f.name: torch.randn(shape, generator=gen, dtype=torch.float64)
           for f in op.forward_input_fields}
    bwd = {n: torch.randn(shape, generator=gen, dtype=torch.float64)
           for n in bwd_names}
    pair = op.kernel_pair()
    before = ck.LAUNCHES
    for call, ins in ((pair.forward, fwd), (pair.backward, bwd)):
        got = _tuple(call(**{n: t.cuda() for n, t in ins.items()}))
        for g, r in zip(got, _tuple(call(**ins))):
            _close(g, r)
    assert ck.LAUNCHES - before == 1 + len(backward_programs(op))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bwd", [False, True])
def test_graph_stages_gradient_on_the_card(fused_bwd):
    """compile(fuse='stages') of a recorded elastic timeloop with a sponge
    on CUDA tensors (kernel 12; kernel 13 with ``fused_bwd``) against the
    same recorded graph replayed on CPU tensors, float64."""
    _need_card()
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc

    n, f64 = 24, torch.float64
    gen = torch.Generator().manual_seed(5)
    init = {nm: 0.1 * torch.randn((n, n), generator=gen, dtype=f64)
            for nm in ELASTIC_FIELDS}
    runs = {}
    for device in ("cpu", "cuda"):
        dh = GraphDataHandling((n - 2, n - 2), default_dtype=f64,
                               device=device)
        for nm, t in init.items():
            dh.add_field(nm, init=t)
        damp = cerjan_damping((n, n), width=4, alpha=0.1, dtype=f64,
                              device=device)
        with dh.timeloop() as loop:
            loop.boundary({nm: ("sponge", damp) for nm in ELASTIC_FIELDS})
            for op, carry in elastic_stages(dtype="float64"):
                loop.sweep(op, carry)
        run = (dh.compile(fuse="stages", k=2, fused_bwd=fused_bwd)
               if device == "cuda" else dh.compile())
        sc.reset_launch_counts()
        sa.reset_launch_counts()
        x = {nm: t.clone().requires_grad_() for nm, t in dh.state().items()}
        out = run(x, 4)
        loss = sum(torch.sin(out[nm]).sum() for nm in ELASTIC_FIELDS)
        grads = torch.autograd.grad(loss, [x[nm] for nm in ELASTIC_FIELDS])
        runs[device] = ([out[nm] for nm in ELASTIC_FIELDS], grads,
                        sc.LAUNCHES, sa.LAUNCHES)
    for a, b in zip(runs["cuda"][0] + list(runs["cuda"][1]),
                    runs["cpu"][0] + list(runs["cpu"][1])):
        _close(a, b)
    assert runs["cuda"][2] >= 2 and runs["cpu"][2] == 0
    assert (runs["cuda"][3] > 0) == fused_bwd
