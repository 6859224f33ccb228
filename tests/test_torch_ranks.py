"""Ops of 1, 4 and 5 spatial dims: the port's ``torch_function`` against
the JAX package's ``jax_function(lowering="jnp")`` in float64 on the CPU,
values and gradients everywhere, ghost cells included — ghost layers of
2 in a leading dim, offsets in every dim, index-dim fields (AoS and SoA)
and periodic wrap; and the CUDA codegen of those ranks, which needs no
nvcc (the window kernel runs a 1D program as a 2D one with a leading
extent of 1, ranks above 3 with every dim its own).  The kernels
themselves run in ``test_torch_ranks_card.py``."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
    access_reach, generate_cuda_source, kernel_nd, window_entries)
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               forward_program)
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from rank_ops import OPS, kheat_op, skew_op
from torch_jax_twin import jax_twin

RTOL = 1e-10
SHAPES = {1: (23,), 4: (5, 6, 4, 7), 5: (4, 3, 5, 3, 6)}


def _case(op, seed):
    spatial = SHAPES[op.forward_input_fields[0].spatial_dimensions]
    rng = np.random.default_rng(seed)
    ins = [rng.standard_normal(storage_shape(f, spatial))
           for f in op.forward_input_fields]
    cots = [rng.standard_normal(storage_shape(f, spatial))
            for f in op.forward_output_fields]
    return ins, cots


def _jax(op, ins, cots, periodic):
    f = jax_twin(op).jax_function(lowering="jnp", periodic=periodic)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    outs = out if isinstance(out, tuple) else (out,)
    grads = vjp(tuple(jnp.asarray(c) for c in cots) if len(cots) > 1
                else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(op, ins, cots, periodic):
    f = op.torch_function(periodic=periodic)
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    out = f(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c) for c in cots])
    return ([o.detach().numpy() for o in outs], [g.numpy() for g in grads])


def _close(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=RTOL,
                                   atol=RTOL * max(np.abs(r).max(), 1e-300))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("nd", [1, 4, 5])
@pytest.mark.parametrize("name", sorted(OPS))
def test_rank_matches_jax(name, nd, periodic):
    """Forward and VJP of 1D, 4D and 5D ops equal the JAX package's, ghost
    frame included (interior mode zeros it; the exact VJP lands gradients
    in it), bounded and periodic."""
    op = OPS[name](nd)
    ins, cots = _case(op, seed=nd)
    outs, grads = _port(op, ins, cots, periodic)
    jouts, jgrads = _jax(op, ins, cots, periodic)
    _close(outs, jouts)
    _close(grads, jgrads)


@pytest.mark.parametrize("nd", [1, 4, 5])
def test_rank_ghost_frame(nd):
    """A bounded forward writes zeros on the ghost frame of every dim (2
    deep below dim 0 for the skew op) and the gradient reaches it."""
    op = skew_op(nd)
    ins, cots = _case(op, seed=11)
    outs, grads = _port(op, ins, cots, False)
    ghost = forward_program(op).ghost
    out = outs[0]
    for d, (lo, hi) in enumerate(ghost):
        assert lo or hi
        edge = np.moveaxis(out, d, 0)
        if lo:
            assert not edge[:lo].any()
        if hi:
            assert not edge[edge.shape[0] - hi:].any()
    # the primal's cells two below dim 0's interior feed the first row
    u = [f.name for f in op.forward_input_fields].index("u")
    assert np.abs(grads[u][0]).max() > 0


@pytest.mark.parametrize("nd", [1, 4, 5])
@pytest.mark.parametrize("name", sorted(OPS))
@pytest.mark.parametrize("mode", ["interior", "full", "periodic"])
def test_cuda_codegen_ranks(name, nd, mode):
    """``generate_cuda_source`` emits the window and per-cell units of 1D,
    4D and 5D programs (no nvcc needed): the kernel's dims (a 1D program
    as 2D), reads naming every kernel dim, the window's middle dims
    flattened (``WY``) and, in 1D, the block's four warps along the
    columns (``XW``); the slab kernel still refuses them."""
    op = OPS[name](nd)
    fp, bp = forward_program(op), backward_program(op)
    prog = bp if mode == "full" else fp
    knd = kernel_nd(prog)
    assert knd == max(2, nd)
    spatial = SHAPES[nd]
    tile = ck.window_tile(prog, spatial, 8)
    for form, t in (("window", tile), ("direct", (1, 1)),
                    ("strided", (1, 1))):
        src = generate_cuda_source(prog, "float64", mode, form, t)
        assert f"#define PSAT_ND {knd}" in src
        reads = re.findall(r"c\.r[pa]\((\d+(?:, -?\d+)+)\)", src)
        assert reads and all(len(r.split(",")) - 1 >= max(knd, 3)
                             for r in reads)
        if nd == 1:
            # the lifted leading dim: every read's first offset is 0
            assert all(r.split(",")[1].strip() == "0" for r in reads)
        if form == "window":
            wy = int(re.search(r"WY = (\d+)", src).group(1))
            xw = int(re.search(r"XW = (\d+)", src).group(1))
            assert xw == (4 if nd == 1 else 1)
            lo, hi = (ck.lift(prog, r) for r in access_reach(prog))
            assert wy == np.prod([lo[d] + hi[d] + 1
                                  for d in range(1, knd - 1)])
    if nd != 1 and mode != "periodic" and not any(
            f.index_shape for f in prog.input_fields):
        with pytest.raises(NotImplementedError, match="2 or 3 spatial"):
            generate_cuda_source(prog, "float64", mode, "slab")


@pytest.mark.parametrize("nd", [1, 4, 5])
def test_window_reckoning_ranks(nd):
    """The window reckoning in the kernel's dims: a 1D program takes R = 1
    and one tile row; every rank's tiles cover the grid; interior tiles
    exist where the grid is wide enough; a thread's window holds the
    stencil's reads and no other entry (κ-heat: 2·nd + 1 reads of u,
    one of κ)."""
    prog = forward_program(kheat_op(nd))
    spatial = {1: (1 << 20,), 4: (12, 10, 16, 300),
               5: (10, 6, 6, 12, 300)}[nd]
    tile = ck.window_tile(prog, spatial, 4)
    knd = kernel_nd(prog)
    xw = 4 if nd == 1 else 1
    if nd == 1:
        assert tile[0] == 1
    ext = ck.window_extent(tile, knd, xw)
    ks = ck.lift(prog, spatial, 1)
    geo = ck.window_geometry(prog, ks, "interior", tile, [0] * knd, ks,
                             ck.lift(prog, [1] * nd), ck.lift(
                                 prog, [n - 1 for n in spatial], 1))
    nt = geo[:knd]
    assert all(t * e >= n for t, e, n in zip(nt, ext, ks))
    assert ck.interior_tiles(geo, tile, knd, xw) > 0
    rows, halo = window_entries(prog, (1, 1))
    assert len(rows) + len(halo) == 2 * nd + 2


@pytest.mark.parametrize("nd", [1, 4])
def test_tiled_strategy_ranks(nd):
    """``strategy="tiled"``: 1D raises as the JAX package's tiled path
    does; 4D computes what the JAX package's tiled path computes (the
    port's slab kernel tiles 2 or 3 dims; on the card the window kernel
    serves 4D)."""
    op = kheat_op(nd)
    if nd == 1:
        with pytest.raises(ValueError, match=">= 2 spatial dims"):
            op.torch_function(strategy="tiled")
        return
    ins, cots = _case(op, seed=3)
    f = op.torch_function(strategy="tiled")
    ts = [torch.tensor(a, requires_grad=True) for a in ins]
    out = f(*ts)
    grads = torch.autograd.grad(out, ts, torch.tensor(cots[0]))
    jouts, jgrads = _jax(op, ins, cots, False)
    _close([out.detach().numpy()], jouts)
    _close([g.numpy() for g in grads], jgrads)


def _chains(api, nd, fused_bwd):
    from pystencils_autodiff_tpu.ops.stage_chain import \
        fused_stage_chain as jstage
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jtime

    from pystencils_autodiff_tpu_torch.ops import (fused_stage_chain,
                                                   fused_time_chain)

    op, carry = kheat_op(nd), {"u": "out"}
    if api == "time_chain":
        return (fused_time_chain(op, 2, carry, fused_bwd=fused_bwd),
                jtime(jax_twin(op), 2, carry, fused_bwd=fused_bwd))
    return (fused_stage_chain([(op, carry)], 2, fused_bwd=fused_bwd),
            jstage([(jax_twin(op), carry)], k=2, fused_bwd=fused_bwd))


# (api, rank, fused_bwd) where the JAX package runs the chain; the port's
# time chain of a 4D op with fused_bwd=True is held against its own
# sequential backward below (the JAX package finds no tile at this size)
CHAIN_CASES = [("stage_chain", 1, False), ("stage_chain", 1, True),
               ("stage_chain", 4, False), ("stage_chain", 4, True),
               ("time_chain", 4, False)]


@pytest.mark.parametrize("api,nd,fused_bwd", CHAIN_CASES)
def test_rank_chains_match_jax(api, nd, fused_bwd):
    """The fused chain APIs run 1D and 4D domains where the JAX package
    does — as k single steps through the window kernel on the card —
    with the JAX package's values and gradients."""
    chain, jchain = _chains(api, nd, fused_bwd)
    spatial = (40,) if nd == 1 else (6, 6, 6, 12)
    rng = np.random.default_rng(20 + nd)
    u0, k0 = rng.standard_normal(spatial), 1 + 0.1 * rng.random(spatial)
    u = torch.tensor(u0, requires_grad=True)
    out = chain({"u": u, "kappa": torch.tensor(k0)})["u"]
    (g,) = torch.autograd.grad((out ** 2).sum(), u)
    jk = jnp.asarray(k0)
    jout = jchain({"u": jnp.asarray(u0), "kappa": jk})["u"]
    jg = jax.grad(lambda a: jnp.sum(jchain({"u": a, "kappa": jk})["u"] ** 2))(
        jnp.asarray(u0))
    _close([out.detach().numpy(), g.numpy()], [np.asarray(jout),
                                               np.asarray(jg)])


def test_rank_chain_refusals_and_fused_backward():
    """A 1D fused time chain raises, as the JAX package's does (its
    flattened-row kernel finds no tile for one row); a 4D time chain's
    fused backward equals its sequential one."""
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    with pytest.raises(NotImplementedError, match="refuses 1D"):
        fused_time_chain(kheat_op(1), 2, {"u": "out"})
    rng = np.random.default_rng(30)
    spatial = (6, 5, 6, 12)
    u0, k0 = rng.standard_normal(spatial), 1 + 0.1 * rng.random(spatial)
    grads = []
    for fb in (False, True):
        chain = fused_time_chain(kheat_op(4), 2, {"u": "out"}, fused_bwd=fb)
        u = torch.tensor(u0, requires_grad=True)
        k = torch.tensor(k0, requires_grad=True)
        out = chain({"u": u, "kappa": k})["u"]
        grads.append(torch.autograd.grad((out ** 2).sum(), (u, k)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
