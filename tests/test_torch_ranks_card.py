"""Ops of 1, 4 and 5 spatial dims on the card: the window kernel (a 1D
program as a 2D one with a leading extent of 1; above 3 dims every dim
its own) and the per-cell kernel against the plain version on the same
CUDA inputs, in every mode, at the picked and at forced tiles (ragged
grids, edge and interior tiles); the op's value+gradient through them
with exactly 1 + 1 launches and no plain-version evaluation.  The plain
versions are held against the JAX package in ``test_torch_ranks.py``.
Every test here needs a CUDA device and skips without one."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_cuda_source
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               forward_program,
                                               make_torch_stencil)
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import torch_ref
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from rank_ops import OPS, kheat_op

pytestmark = pytest.mark.cuda
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DTYPES = {torch.float64: "float64", torch.float32: "float32"}
SHAPES = {1: [(37,), (5000,)], 4: [(5, 6, 4, 7), (9, 6, 10, 70)],
          5: [(4, 3, 5, 3, 6), (6, 4, 3, 10, 40)]}
# a forced tile beside the picked one: 2 cells a thread along the
# contiguous dim (1D), 2 rows of dim 0 (above 3 dims)
FORCED = {1: (1, 2), 4: (2, 1), 5: (2, 1)}
# every op in float64, the κ-heat in float32 too
CASES = [(name, nd, dt) for name in sorted(OPS) for nd in (1, 4, 5)
         for dt in (torch.float64, torch.float32)
         if dt == torch.float64 or name == "kheat"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")
    _prebuild()
    return torch.device("cuda", 0)


def _variants(name, nd, dtype):
    """(program, mode kwargs, spatial, window, form) of every launch
    ``test_rank_kernels_match_plain_version`` makes for one case."""
    op = OPS[name](nd)
    for i, spatial in enumerate(SHAPES[nd]):
        for mode, prog, kw in _modes(op):
            if kw.get("periodic") and any(
                    n < max(g) for n, g in zip(spatial, prog.ghost)) \
                    or mode == "full fwd" and name != "kheat":
                continue
            # the forced tile on the larger grid, where tiles are interior
            for window in (None, FORCED[nd]) if i else (None,):
                yield prog, kw, spatial, window, None
            yield prog, kw, spatial, None, "cell"


def _prebuild():
    """Every library the tests here launch, one nvcc each, all started
    together (a library builds once per key; the wrappers then load it)."""
    from pystencils_autodiff_tpu_torch.codegen.nvcc import compile_and_load

    sources = {}
    for name, nd, dtype in CASES:
        for prog, kw, spatial, window, form in _variants(name, nd, dtype):
            mode = ("periodic" if kw.get("periodic") else "full"
                    if kw.get("full_domain") else "interior")
            dt = DTYPES[dtype]
            if form == "cell":
                lead = ck.lift(prog, spatial, 1)
                f = ("strided" if max(lead[-2], np.prod(lead[:-2]))
                     > ck.GRID_CAP else "direct")
                src = generate_cuda_source(prog, dt, mode, f)
            else:
                tile = window or ck.window_tile(prog, spatial,
                                                8 if dt == "float64" else 4)
                src = generate_cuda_source(prog, dt, mode, "window", tile)
            sources[src] = f"{prog.name}_{mode}_{dt}"
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(lambda item: compile_and_load(*item), sources.items()))


def _inputs(prog, spatial, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return {f.name: torch.tensor(rng.standard_normal(storage_shape(f, spatial)),
                                 dtype=dtype, device=dev)
            for f in prog.input_fields}


def _modes(op):
    fp, bp = forward_program(op), backward_program(op)
    return [("interior", fp, {}),
            ("full+mask", bp, {"full_domain": True,
                               "adjoint_mask_ghost": fp.ghost}),
            ("periodic fwd", fp, {"periodic": True}),
            ("periodic bwd", bp, {"full_domain": True, "periodic": True}),
            ("full fwd", fp, {"full_domain": True})]


def _check(got, ref, dtype):
    for n, r in ref.items():
        g = got[n].cpu()
        r = r.cpu()
        tol = TOL[dtype]
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=tol,
                                   atol=tol * max(r.abs().max().item(),
                                                  1e-300), err_msg=n)


@pytest.mark.parametrize("name,nd,dtype", CASES)
def test_rank_kernels_match_plain_version(dev, name, nd, dtype):
    """Window kernel (picked and forced tiles) and per-cell kernel equal
    the plain version in every mode at 1D, 4D and 5D."""
    for prog, kw, spatial, window, form in _variants(name, nd, dtype):
        x = _inputs(prog, spatial, dtype, dev)
        ref = make_torch_stencil(prog, **kw)(x)
        _check(ck.make_cuda_stencil(prog, window=window, form=form, **kw)(x),
               ref, dtype)


@pytest.mark.parametrize("nd", [1, 4, 5])
def test_rank_value_and_gradient_on_the_card(dev, nd):
    """``torch_function`` of a 1D, 4D and 5D κ-heat on CUDA tensors: 1 + 1
    window launches a value+gradient, no plain-version evaluation, equal
    to the CPU run to rounding."""
    op = kheat_op(nd)
    spatial = SHAPES[nd][1]
    rng = np.random.default_rng(nd)
    ins = [rng.standard_normal(spatial) for _ in op.forward_input_fields]
    cot = rng.standard_normal(spatial)
    f = op.torch_function()

    def run(device):
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in ins]
        out = f(*ts)
        grads = torch.autograd.grad(out, ts, torch.tensor(cot, device=device))
        return [out.detach().cpu()] + [g.cpu() for g in grads]

    ref = run("cpu")
    ck.reset_launch_counts()
    plain0 = torch_ref.PLAIN_CALLS
    got = run(dev)
    assert ck.LAUNCHES == 2
    assert {k[-1] for k in ck.LAUNCH_CALLS} == {"window"}
    assert torch_ref.PLAIN_CALLS == plain0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12 * r.abs().max().item())


def test_tiled_strategy_above_three_dims_runs_the_window_kernel(dev):
    """``strategy="tiled"`` on a 4D op: the slab kernel tiles 2 or 3 dims,
    so the window kernel serves it (launch form "window"), equal to the
    plain version."""
    op = kheat_op(4)
    prog = forward_program(op)
    x = _inputs(prog, SHAPES[4][1], torch.float64, dev, seed=3)
    ref = make_torch_stencil(prog)(x)
    ck.reset_launch_counts()
    _check(ck.make_cuda_stencil(prog, strategy="tiled")(x), ref,
           torch.float64)
    assert {k[-1] for k in ck.LAUNCH_CALLS} == {"window"}
