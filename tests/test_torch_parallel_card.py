"""The shard modes of the fused chain kernels on the card, each held
against its plain version's shard mode on the same block (those are held
against the JAX package in ``test_torch_sharded_chain.py``), and
``ShardedChain`` on a mesh of one card's shards against the same chain on
CPU tensors.

The shard modes: the dim-0 march's forward mode (kernel 12, and row 7's
3D forward chain) and its two-phase mode (kernel 13, and row 9s over a
3D chain as a one-stage cycle), the z-streaming kernel's two-phase mode
(row 9s's other design, both forms) and its forward mode.  Each runs on
an *interior* shard's extended block (bases ≠ 0, the global frame partly
inside; row 9s's march on an edge shard's too); state_k is compared on
the owned cells, cot_0 on the whole block for a cotangent on the owned
cells.  The route of row 9s (``time_chain.two_phase_design``) runs
through ``ShardedChain`` against the CPU run.  Tolerances: rtol 1e-12
in float64, 1e-5 with atol 1e-5·max|ref| in float32 (the sums run in
another order).  Every test here needs a CUDA device and skips without
one."""

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  elastic_stages,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec
from pystencils_autodiff_tpu_torch.parallel import (ShardedChain,
                                                    exchange_count,
                                                    make_mesh,
                                                    reset_exchange_count)

ELASTIC = ["vx", "vy", "sxx", "syy", "sxy"]
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")


def _close(got, ref, dtype, what=""):
    rtol, atol = TOL[dtype]
    got = got.detach().double().cpu().numpy()
    ref = ref.detach().double().cpu().numpy()
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _block(g, starts, sizes, periodic):
    """The block of ``g``'s leading dims starting at ``starts`` (global
    coordinates, below 0 or beyond the domain: wrapped, or 0 in a bounded
    domain)."""
    out = g
    for d, (s, n) in enumerate(zip(starts, sizes)):
        idx = torch.arange(s, s + n, device=g.device)
        m = g.shape[d]
        out = out.index_select(d, idx.remainder(m))
        if not periodic:
            ok = ((idx >= 0) & (idx < m)).reshape(
                [-1 if dd == d else 1 for dd in range(out.dim())])
            out = out * ok
    return out


def _owned(t, halo, sizes):
    for d, (lo, n) in enumerate(zip(halo, sizes)):
        t = t.narrow(d, lo, n)
    return t


def _rand(seed, shape, dtype, scale=1.0):
    return torch.tensor(scale * np.random.default_rng(seed).standard_normal(
        shape), dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic,dtype", [(False, torch.float64),
                                            (True, torch.float64),
                                            (False, torch.float32)])
def test_march_shard_modes_stage_chain(periodic, dtype):
    """Kernels 12 and 13 in shard mode (the elastic pair behind a sponge;
    bounded also a Dirichlet and a Neumann frame on the global edge) on
    shard 1 of 4 along dim 0, against their plain shard modes."""
    _need_card()
    stages = elastic_stages(dt=0.01, dtype="float64")
    boundary = {0: {"vx": [("sponge", "damp")]}}
    if not periodic:
        boundary[1] = {"sxx": "dirichlet", "vy": "neumann"}
    k, n0, n1, parts, i = 2, 256, 96, 4, 1
    halo = max(ShardedChain(stages, k, make_mesh((parts,), ("x",),
                                                 ["cpu"] * parts),
                            {0: "x"}, periodic=periodic, boundary=boundary,
                            fused_bwd=True)._halo_bwd[0])
    spec = ShardSpec((n0, n1), (0,))
    plan = sc.StagePlan(stages, k, periodic, boundary, shard=spec)
    L = n0 // parts
    g = {n: _rand(j, (n0, n1), dtype) for j, n in enumerate(ELASTIC)}
    g["damp"] = 0.8 + 0.2 * _rand(9, (n0, n1), dtype).abs()
    sizes = (L + 2 * halo, n1)
    starts = (i * L - halo, 0)
    blk = {n: _block(v, starts, sizes, periodic) for n, v in g.items()}
    cot = {n: torch.zeros(sizes, dtype=dtype) for n in g}
    for j, n in enumerate(ELASTIC):
        cot[n][halo:halo + L] = _rand(20 + j, (L, n1), dtype)
    dev = torch.device("cuda")
    on = {n: v.to(dev) for n, v in blk.items()}
    sc.reset_launch_counts()
    out = sc.make_stage_kernel(plan)(on, bases=starts)
    assert sc.LAUNCHES == 1
    ref = sc.plain_stage_chain(plan)(blk, starts)
    for n in ELASTIC:
        _close(_owned(out[n], (halo, 0), (L, n1)),
               _owned(ref[n], (halo, 0), (L, n1)), dtype, n)
    ap = sa.AdjointStagePlan(plan)
    for form in ("gather", "local"):
        sa.reset_launch_counts()
        _, c0 = sa.make_stage_adjoint_kernel(ap, form=form)(
            on, {n: v.to(dev) for n, v in cot.items()}, bases=starts)
        assert sa.LAUNCHES == 1
        _, r0 = sa.plain_stage_chain_vjp(ap)(blk, cot, starts)
        for n in ap.cot_names:
            _close(c0[n], r0[n], dtype, f"{form} cot {n}")


def _diffusion_block(dtype, periodic, k, halo_per_step, seed=0):
    """A 3D κ-diffusion state of (24, 20, 16) split (4, 2) over dims 0 and
    1, and shard (1, 1)'s block extended by k·halo_per_step."""
    n = (24, 20, 16)
    owned = (6, 10)
    h = k * halo_per_step
    starts = (1 * owned[0] - h, 1 * owned[1] - h)
    sizes = (owned[0] + 2 * h, owned[1] + 2 * h)
    g = {"u": _rand(seed, n, dtype),
         "kappa": 1 + 0.1 * _rand(seed + 1, n, dtype) ** 2}
    blk = {m: _block(v, starts, sizes, periodic) for m, v in g.items()}
    return n, owned, h, starts + (0,), blk


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["march", "stream"])
@pytest.mark.parametrize("periodic,dtype", [(False, torch.float64),
                                            (True, torch.float64),
                                            (False, torch.float32)])
def test_3d_forward_shard_modes(design, periodic, dtype):
    """Row 7 in shard mode: the march's forward mode and the streaming
    kernel's forward mode on an interior shard's block of a (4, 2) split,
    against the plain shard mode."""
    _need_card()
    op = diffusion3d_op(dt=0.05, dtype="float64")
    k = 2
    n, owned, h, bases, blk = _diffusion_block(dtype, periodic, k, 1)
    plan = tc.chain_plan(op, k, {"u": "u_next"}, periodic,
                         shard=ShardSpec(n, (0, 1)))
    tc.reset_launch_counts()
    pa.reset_launch_counts()
    fn = tc.make_chain_kernel(plan, design=design)
    out, _ = fn({m: v.cuda() for m, v in blk.items()}, bases)
    assert tc.LAUNCHES + pa.LAUNCHES == 1
    ref, _ = tc.plain_time_chain(plan)(blk, bases)
    _close(_owned(out["u"], (h, h), owned), _owned(ref["u"], (h, h), owned),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "local"])
@pytest.mark.parametrize("periodic,dtype", [(False, torch.float64),
                                            (True, torch.float64),
                                            (False, torch.float32)])
def test_stream_two_phase_shard_mode(form, periodic, dtype):
    """Row 9 in shard mode, both forms, on an interior shard's block with
    the fused backward's halo k·(reach_f + reach_b): cot_0 of u and κ on
    the whole block."""
    _need_card()
    op = diffusion3d_op(dt=0.05, dtype="float64")
    k = 2
    n, owned, h, bases, blk = _diffusion_block(dtype, periodic, k, 2)
    plan = tc.chain_plan(op, k, {"u": "u_next"}, periodic,
                         shard=ShardSpec(n, (0, 1)))
    ap = ac.AdjointPlan(plan)
    cot = {m: torch.zeros_like(v) for m, v in blk.items()}
    cot["u"][h:h + owned[0], h:h + owned[1]] = _rand(
        5, (owned[0], owned[1], n[2]), dtype)
    pa.reset_launch_counts()
    _, c0 = pa.make_plane_adjoint_kernel(ap, form=form)(
        {m: v.cuda() for m, v in blk.items()},
        {m: v.cuda() for m, v in cot.items()}, (), bases)
    assert pa.LAUNCHES == 1
    _, r0 = ac.plain_chain_vjp(ap)(blk, cot, (), bases)
    for m in ("u", "kappa"):
        _close(c0[m], r0[m], dtype, m)


@pytest.mark.cuda
@pytest.mark.parametrize("at", [(1, 1), (0, 1)], ids=["interior", "edge"])
@pytest.mark.parametrize("periodic,dtype", [(False, torch.float64),
                                            (True, torch.float64),
                                            (False, torch.float32),
                                            (True, torch.float32)])
def test_march_two_phase_shard_mode_3d(periodic, dtype, at):
    """Row 9s on the dim-0 march: its two-phase mode over the sharded
    κ-diffusion chain as a one-stage cycle (``make_chain_march_kernel`` of
    a sharded plan) on an interior and an edge shard's block with the
    fused backward's halo k·(reach_f + reach_b), against the plain shard
    mode: state_k on the owned cells, cot_0 of u and κ on the whole block
    for cotangents on the owned cells; one launch, counted on
    ``ops.stage_adjoint`` in shard mode."""
    _need_card()
    op = diffusion3d_op(dt=0.05, dtype="float64")
    k = 2
    n, owned, h = (24, 20, 16), (6, 10), 2 * k
    starts = tuple(a * o - h for a, o in zip(at, owned))
    sizes = tuple(o + 2 * h for o in owned)
    g = {"u": _rand(0, n, dtype),
         "kappa": 1 + 0.1 * _rand(1, n, dtype) ** 2}
    blk = {m: _block(v, starts, sizes, periodic) for m, v in g.items()}
    plan = tc.chain_plan(op, k, {"u": "u_next"}, periodic,
                         shard=ShardSpec(n, (0, 1)))
    cot = {m: torch.zeros_like(v) for m, v in blk.items()}
    for j, m in enumerate(("u", "kappa")):
        cot[m][h:h + owned[0], h:h + owned[1]] = _rand(
            5 + j, (owned[0], owned[1], n[2]), dtype)
    bases = starts + (0,)
    sa.reset_launch_counts()
    st, c0 = ac.make_chain_march_kernel(plan, sa)(
        {m: v.cuda() for m, v in blk.items()},
        {m: v.cuda() for m, v in cot.items()}, (), bases)
    assert dict(sa.LAUNCH_CALLS) == {
        (op.op_name, k, periodic, sizes + (n[2],),
         torch.tensor([], dtype=dtype).element_size(), "march-shard"): 1}
    rst, r0 = ac.plain_chain_vjp(ac.AdjointPlan(plan))(blk, cot, (), bases)
    _close(_owned(st["u"], (h, h), owned), _owned(rst["u"], (h, h), owned),
           dtype, "state_k")
    rtol, atol = TOL[dtype]
    for m in ("u", "kappa"):
        np.testing.assert_allclose(
            c0[m].double().cpu().numpy(), r0[m].double().numpy(),
            rtol=10 * rtol if dtype == torch.float32 else rtol,
            atol=(10 if dtype == torch.float32 else 1) * atol
            * r0[m].abs().max().item(), err_msg=f"cot_0 {m}")


def _card_vs_cpu(chain_of, state, cot, wrt, dtype):
    """The value and the gradients w.r.t. ``wrt`` of ``chain_of(device)``
    on the card and on CPU tensors; returns both and the card chain."""
    res, chains = [], []
    for dev in ("cuda", "cpu"):
        chain = chain_of(dev)
        ins = {n: v.to(dev).requires_grad_(n in wrt)
               for n, v in state.items()}
        out = chain(ins)
        name = next(iter(cot))
        grads = torch.autograd.grad(out[name], [ins[n] for n in wrt],
                                    cot[name].to(dev))
        res.append((out[name], grads))
        chains.append(chain)
    scale = 10.0 if dtype == torch.float32 else 1.0
    _close(res[0][0], res[1][0], dtype, "value")
    rtol, atol = TOL[dtype]
    for n, a, b in zip(wrt, res[0][1], res[1][1]):
        np.testing.assert_allclose(
            a.double().cpu().numpy(), b.double().numpy(), rtol=scale * rtol,
            atol=scale * atol * b.abs().max().item(), err_msg=f"d/d{n}")
    return chains[0]


@pytest.mark.cuda
def test_sharded_route_takes_march_for_kappa_on_the_card():
    """The route's reckoning on the card: κ-diffusion f32 (k=2, bounded) on
    a (2, 4) mesh of one card, global (8, 16, 384), whose fused-backward
    halo equals the shard extent (block 12 × 12 × 384): a march fits, so
    each shard's backward is one march launch (8, counted on
    ``ops.stage_adjoint`` in shard mode); value, d/du and d/dκ equal the
    CPU run."""
    _need_card()
    op = diffusion3d_op(dt=0.05)
    n = (8, 16, 384)
    state = {"u": _rand(21, n, torch.float32),
             "kappa": 1 + 0.1 * _rand(22, n, torch.float32) ** 2}
    sa.reset_launch_counts()

    def chain_of(dev):
        return ShardedChain(op, 2, make_mesh((2, 4), ("x", "y"),
                                             [torch.device(dev)] * 8),
                            {0: "x", 1: "y"}, carry_map={"u": "u_next"},
                            fused_bwd=True)

    chain = _card_vs_cpu(chain_of, state, {"u": _rand(23, n, torch.float32)},
                         ("u", "kappa"), torch.float32)
    assert chain._halo_bwd == {0: (4, 4), 1: (4, 4)}
    g = chain._kernels[("vjp", n, frozenset({"u", "kappa"}))]
    assert g.designs == {((12, 12, 384), 4): "march"}
    assert dict(sa.LAUNCH_CALLS) == {
        (op.op_name, 2, False, (12, 12, 384), 4, "march-shard"): 8}


@pytest.mark.cuda
def test_sharded_route_d3q19_f64_on_the_card():
    """D3Q19 f64 (k=2, periodic) on a 2×2 mesh of one card, global 16³:
    no march of its value+gradient fits the block (20 × 20 × 16), so the
    route runs the streaming kernel's shard mode, 4 launches, and the
    value and d/df equal the CPU run."""
    from pystencils_autodiff_tpu_torch.models import d3q19_bgk_op

    _need_card()
    op = d3q19_bgk_op(omega=1.7, dtype="float64", layout="soa")
    n = (16, 16, 16)
    f = (1.0 + 0.1 * _rand(31, (19,) + n, torch.float64)) / 19
    pa.reset_launch_counts()

    def chain_of(dev):
        return ShardedChain(op, 2, make_mesh((2, 2), ("x", "y"),
                                             [torch.device(dev)] * 4),
                            {0: "x", 1: "y"}, carry_map={"f": "f_out"},
                            periodic=True, fused_bwd=True)

    chain = _card_vs_cpu(chain_of, {"f": f},
                         {"f": _rand(32, (19,) + n, torch.float64)}, ("f",),
                         torch.float64)
    block = tuple(8 + sum(chain._halo_bwd[d]) for d in (0, 1)) + (16,)
    assert tc.two_phase_design(
        ac.AdjointPlan(chain._chain_plan(chain._shard_spec(n))), block,
        8) == "stream"
    g = chain._kernels[("vjp", n, frozenset({"f"}))]
    assert g.designs == {(block, 8): "stream"}
    # the backward's launches (the forward's streaming mode counts here
    # too, as "forward_shard")
    bwd = {key: v for key, v in pa.LAUNCH_CALLS.items()
           if key[5] == "two_phase_shard"}
    assert sum(bwd.values()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bwd", [False, True])
def test_deep_halo_at_shard_extent_on_the_card(fused_bwd):
    """The fused backward's halo equal to the shard extent in both sharded
    dims, on a (2, 4) mesh of one card: value and gradient equal the same
    chain on CPU tensors."""
    _need_card()
    op = diffusion3d_op(dt=0.05, dtype="float64")
    u = _rand(11, (8, 16, 8), torch.float64)
    kap = 1 + 0.1 * _rand(12, (8, 16, 8), torch.float64) ** 2
    cot = _rand(13, (8, 16, 8), torch.float64)
    res = []
    for dev in ("cuda", "cpu"):
        chain = ShardedChain(op, 2, make_mesh((2, 4), ("x", "y"),
                                              [torch.device(dev)] * 8),
                             {0: "x", 1: "y"}, carry_map={"u": "u_next"},
                             fused_bwd=fused_bwd)
        ut = u.to(dev).requires_grad_()
        out = chain({"u": ut, "kappa": kap.to(dev)})["u"]
        (g,) = torch.autograd.grad(out, ut, cot.to(dev))
        res.append((out, g))
    _close(res[0][0], res[1][0], torch.float64)
    _close(res[0][1], res[1][1], torch.float64)


@pytest.mark.cuda
def test_deep_halo_march_design_on_the_card():
    """The deep-halo chain of ``test_deep_halo_at_shard_extent_on_the_card``
    (float64, halo equal to the shard extent in both sharded dims): the
    reckoning takes the march at this small block (12 × 12 × 8), 8 march
    launches, and value and gradient equal the CPU run."""
    _need_card()
    op = diffusion3d_op(dt=0.05, dtype="float64")
    n = (8, 16, 8)
    state = {"u": _rand(11, n, torch.float64),
             "kappa": 1 + 0.1 * _rand(12, n, torch.float64) ** 2}
    sa.reset_launch_counts()

    def chain_of(dev):
        return ShardedChain(op, 2, make_mesh((2, 4), ("x", "y"),
                                             [torch.device(dev)] * 8),
                            {0: "x", 1: "y"}, carry_map={"u": "u_next"},
                            fused_bwd=True)

    chain = _card_vs_cpu(chain_of, state,
                         {"u": _rand(13, n, torch.float64)}, ("u",),
                         torch.float64)
    (g,) = [v for key, v in chain._kernels.items() if key[0] == "vjp"]
    assert g.designs == {((12, 12, 8), 8): "march"}
    assert {key[3:]: v for key, v in sa.LAUNCH_CALLS.items()} == {
        ((12, 12, 8), 8, "march-shard"): 8}


@pytest.mark.cuda
def test_sharded_elastic_chain_on_the_card():
    """The elastic pair behind a sponge, 4 shards of one card, k=2, the
    fused backward: kernels 12 and 13 in shard mode launch once per shard
    each, and the value and gradients equal the CPU run."""
    _need_card()
    stages = elastic_stages(dt=0.01, dtype="float64")
    boundary = {0: {n: [("sponge", "damp")] for n in ELASTIC}}
    state = {n: _rand(j, (128, 64), torch.float64)
             for j, n in enumerate(ELASTIC)}
    state["damp"] = 0.8 + 0.2 * _rand(9, (128, 64), torch.float64).abs()
    res = []
    for dev in ("cuda", "cpu"):
        chain = ShardedChain(stages, 2, make_mesh((4,), ("x",),
                                                  [torch.device(dev)] * 4),
                             {0: "x"}, boundary=boundary, fused_bwd=True)
        ins = {n: v.to(dev).requires_grad_() for n, v in state.items()}
        sc.reset_launch_counts()
        sa.reset_launch_counts()
        out = chain(ins)
        grads = torch.autograd.grad([out[n].square().sum()
                                     for n in ELASTIC],
                                    [ins[n] for n in state])
        if dev == "cuda":
            assert sc.LAUNCHES == 4 and sa.LAUNCHES == 4
        res.append((out, grads))
    for n in ELASTIC:
        _close(res[0][0][n], res[1][0][n], torch.float64, n)
    for a, b in zip(res[0][1], res[1][1]):
        _close(a, b, torch.float64)


@pytest.mark.cuda
def test_trivial_mesh_launches_are_the_unsharded_chains():
    """A 1-shard mesh runs the unsharded kernels: exactly the unsharded
    chain's launches (kernel 12 forward; the twin's kernel 12 backward for
    the linear periodic heat chain), no transport."""
    _need_card()
    op = heat_step_op(dt=0.1, dtype="float32")
    u = _rand(3, (512, 256), torch.float32).cuda()
    counts = []
    for mesh in (make_mesh((1,), ("x",), [torch.device("cuda")]), None):
        sc.reset_launch_counts()
        sa.reset_launch_counts()
        reset_exchange_count()
        ut = u.clone().requires_grad_()
        if mesh is None:
            from pystencils_autodiff_tpu_torch.ops import fused_stage_chain
            from pystencils_autodiff_tpu_torch.ops.adjoint_chain import \
                transposed_linear_op
            chain = fused_stage_chain([(op, {"u": "u_next"})], 4,
                                      periodic=True)
            out = chain({"u": ut})["u"]
            # the twin: the transposed op's chain on the cotangent
            cot_op, cot_carry, name_of, _ = transposed_linear_op(
                op, {"u": "u_next"})
            twin = fused_stage_chain([(cot_op, cot_carry)], 4,
                                     periodic=True)
            twin({name_of["u"]: 2 * out.detach()})
        else:
            chain = ShardedChain(op, 4, mesh, {0: "x"},
                                 carry_map={"u": "u_next"}, periodic=True,
                                 fused_bwd=True)
            out = chain({"u": ut})["u"]
            torch.autograd.grad(out.square().sum(), ut)
        torch.cuda.synchronize()
        counts.append((sc.LAUNCHES, sa.LAUNCHES, exchange_count()))
    assert counts[0] == counts[1] == (2, 0, 0)
