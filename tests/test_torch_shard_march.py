"""Row 9s on the dim-0 march: the fused value+gradient of a sharded 3D
single-op chain (``ShardedChain``'s fused backward on one halo-extended
block) through the march's two-phase mode in shard mode, on the CPU.

- the route's reckoning (``time_chain.two_phase_design``) at config #2's
  κ block, at small blocks (the march wherever it fits) and at path C's
  D3Q19 f64 block;
- the march's plain version of the sharded one-stage cycle (the stage
  plan's shard-mode plain VJP from ``stage_march.chain_march_plans``)
  against ``adjoint_chain._plain_shard_chain_vjp`` on an interior and an
  edge shard's block, κ-diffusion f64, bounded and periodic (rtol 1e-12);
- ``ShardedChain`` through the route (the card branch taken, the march
  standing in by its plain version: no card here) against the JAX
  package's ``ShardedChain`` in interpret mode, and its launches counted
  on ``ops.stage_adjoint`` in shard mode;
- the march's CUDA source for a 3D two-phase shard plan.

Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import parallel as jpar
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_stage_march_source
from pystencils_autodiff_tpu_torch.models import d3q19_bgk_op, diffusion3d_op
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_march as sm
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec
from pystencils_autodiff_tpu_torch.parallel import ShardedChain, make_mesh

RTOL, GRAD_RTOL = 1e-12, 1e-11
CARRY = {"u": "u_next"}


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _sharded_plan(n, k, periodic, op=None, dims=(0, 1)):
    op = op or diffusion3d_op(dt=0.05, dtype="float64")
    return tc.chain_plan(op, k, CARRY, periodic, shard=ShardSpec(n, dims))


# ------------------------------------------------------------ reckoning --

def test_two_phase_design_picks_march_for_config2_kappa_block():
    """Config #2's κ chain (k=2, bounded) on a 2×2 split of 384³: the
    fused backward's block is 192 + 2·4 in the sharded dims, a march of
    its value+gradient fits it (owning 0.74 of its tile), so the route
    takes the march."""
    op = diffusion3d_op(dt=0.05)
    n = (384, 384, 384)
    chain = ShardedChain(op, 2, make_mesh((2, 2), ("x", "y"), ["cpu"] * 4),
                         {0: "x", 1: "y"}, carry_map=CARRY, fused_bwd=True)
    block = tuple(192 + sum(chain._halo_bwd[d]) for d in (0, 1)) + (384,)
    assert block == (200, 200, 384)
    ap = ac.AdjointPlan(_sharded_plan(n, 2, False, op))
    assert tc.two_phase_design(ap, block, 4) == "march"
    assert tc.two_phase_design(ap, block, 4, frozenset({"kappa"})) == "march"
    sp, sap = sm.chain_march_plans(ap.fwd, frozenset({"kappa"}))
    assert sm.stage_march_geometry(sp, block, 4, sap).owned_share > 0.7


@pytest.mark.parametrize("n,block", [((16,) * 3, (16, 16, 16)),
                                     ((16, 16, 8), (16, 16, 8)),
                                     ((128,) * 3, (40, 40, 128))])
def test_two_phase_design_takes_march_wherever_it_fits(n, block):
    """The reckoning weighs no share against the streaming kernel's: at
    small blocks, where the march owns little of its tile (0.22 at 16³
    f32, against the streaming kernel's 0.60), it still takes the march,
    in both float types."""
    ap = ac.AdjointPlan(_sharded_plan(n, 2, False))
    for itemsize in (4, 8):
        sp, sap = sm.chain_march_plans(ap.fwd)
        sm.stage_march_geometry(sp, block, itemsize, sap)  # fits
        assert tc.two_phase_design(ap, block, itemsize) == "march"


def test_two_phase_design_keeps_stream_for_d3q19_f64_block():
    """Path C's D3Q19 f64 chain (k=2, periodic) on a 2×2 split of 128³:
    no march of its value+gradient fits the block (76² × 128), so the
    route keeps the streaming kernel."""
    op = d3q19_bgk_op(omega=1.7, dtype="float64", layout="soa")
    n = (128, 128, 128)
    plan = tc.chain_plan(op, 2, {"f": "f_out"}, True,
                         shard=ShardSpec(n, (0, 1)))
    ap = ac.AdjointPlan(plan)
    block = (76, 76, 128)
    assert tc.two_phase_design(ap, block, 8) == "stream"
    assert pa.stream_geometry(plan, block, 8, ap).form == "local"


# ------------------------------------------------ the march's plain version --

def _block(g, starts, sizes, periodic):
    """The block of ``g``'s leading dims from global ``starts`` (wrapped,
    or 0 beyond a bounded domain: what the exchange gives an edge shard)."""
    out = g
    for d, (s, m) in enumerate(zip(starts, sizes)):
        idx = torch.arange(s, s + m)
        n = g.shape[d]
        out = out.index_select(d, idx.remainder(n))
        if not periodic:
            ok = ((idx >= 0) & (idx < n)).reshape(
                [-1 if a == d else 1 for a in range(out.dim())])
            out = out * ok
    return out


def _kappa_block(periodic, at, n=(24, 20, 12), owned=(6, 10), k=2):
    """κ-diffusion's state and a cotangent on the owned cells of shard
    ``at`` of a (4, 2) split of dims 0 and 1, on the block extended by the
    fused backward's halo k·(reach_f + reach_b) = 2k a side."""
    h = 2 * k
    starts = tuple(a * o - h for a, o in zip(at, owned))
    sizes = tuple(o + 2 * h for o in owned)
    g = {"u": torch.tensor(_rand(0, n)),
         "kappa": torch.tensor(1 + 0.1 * _rand(1, n) ** 2)}
    blk = {m: _block(v, starts, sizes, periodic) for m, v in g.items()}
    cot = {m: torch.zeros_like(v) for m, v in blk.items()}
    cot["u"][h:h + owned[0], h:h + owned[1]] = torch.tensor(
        _rand(2, owned + (n[2],)))
    cot["kappa"][h:h + owned[0], h:h + owned[1]] = torch.tensor(
        _rand(3, owned + (n[2],)))
    return n, starts + (0,), blk, cot


@pytest.mark.parametrize("at", [(1, 1), (0, 1)], ids=["interior", "edge"])
@pytest.mark.parametrize("periodic", [False, True])
def test_march_plain_shard_cycle_matches_plain_shard_chain_vjp(periodic, at):
    """The sharded one-stage cycle's plain VJP (``plain_stage_chain_vjp``
    of ``chain_march_plans``' stage plans: the semantics the march's
    two-phase shard mode is held to on the card) equals the chain's plain
    shard VJP on an interior and an edge shard's block: state_k on every
    cell, cot_0 of u and of κ (its accumulated gradient and its incoming
    cotangent) on the whole block."""
    n, bases, blk, cot = _kappa_block(periodic, at)
    plan = _sharded_plan(n, 2, periodic)
    sp, sap = sm.chain_march_plans(plan)
    assert sorted(sap.cot_names) == ["kappa", "u"]
    st, c0 = sa.plain_stage_chain_vjp(sap)(blk, cot, bases)
    rst, r0 = ac._plain_shard_chain_vjp(ac.AdjointPlan(plan))(
        blk, cot, (), bases)
    _close(st["u"], rst["u"], RTOL, "state_k")
    for m in ("u", "kappa"):
        _close(c0[m], r0[m], RTOL, f"cot_0 {m}")
    # without κ wanted, the march accumulates no gradient of it
    _, sap_u = sm.chain_march_plans(plan, frozenset({"u"}))
    assert sap_u.cot_names == ["u"]
    _, cu = sa.plain_stage_chain_vjp(sap_u)(blk, {"u": cot["u"]}, bases)
    _close(cu["u"], r0["u"], RTOL, "cot_0 u, κ not wanted")


# --------------------------------------------------------------- the route --

@pytest.fixture
def march_on_cpu(monkeypatch):
    """``(calls, card_branch)``: ``card_branch()`` makes the backward route
    take its card branch on CPU tensors (``on_card`` true; call it after
    the forward, which then ran its plain version), with the march's
    launcher replaced by its plain version (the stage plan's shard-mode
    VJP) counting a launch as the kernel would and recording the
    cotangent fields of its plan in ``calls``, and the kernel wrappers'
    CUDA checks by their CPU counterparts."""
    calls = []

    def fake_march(plan, ap=None, form=None, counter=None, count_name=None):
        plain = sa.plain_stage_chain_vjp(ap)

        def kern(state, cots, probe_cots=(), records=(), bases=None):
            f0 = plan.state_fields[plan.state_names[0]]
            spatial = tuple(ck.storage_spatial(f0, state[f0.name]))
            counter.LAUNCHES += 1
            counter.LAUNCH_CALLS[(count_name, plan.k, plan.periodic, spatial,
                                  state[f0.name].element_size(),
                                  "march-shard")] += 1
            calls.append(sorted(ap.cot_names))
            return plain(state, cots, bases)
        kern.geometry = None
        return kern

    def cpu_state(plan, state):
        f0 = plan.program.input_fields[0]
        return state[f0.name], tuple(ck.storage_spatial(f0, state[f0.name]))

    monkeypatch.setattr(sm, "make_march_kernel", fake_march)
    monkeypatch.setattr(ac, "check_state", cpu_state)
    monkeypatch.setattr(ac, "_check_inputs", lambda program, ins: None)
    return calls, lambda: monkeypatch.setattr(ck, "on_card",
                                              lambda t: True)


def test_sharded_chain_march_route_matches_jax_interpret(march_on_cpu):
    """Config #2's κ chain on a 2×2 mesh, bounded, fused backward, through
    the route's card branch in the march design (its plain version
    standing in for the kernel): value, d/du and
    d/dκ equal the JAX package's ``ShardedChain`` (its Pallas kernels in
    interpret mode on the virtual devices), and each of the 4 shards
    launches once, counted on ``ops.stage_adjoint`` in shard mode."""
    op = diffusion3d_op(dt=0.05, dtype="float64")
    n = (16, 16, 8)
    chain = ShardedChain(op, 2, make_mesh((2, 2), ("x", "y"), ["cpu"] * 4),
                         {0: "x", 1: "y"}, carry_map=CARRY, fused_bwd=True)
    jchain = jpar.ShardedChain(jax_twin(op), 2, jpar.make_mesh(
        (2, 2), ("x", "y")), {0: "x", 1: "y"}, carry_map=CARRY,
        interpret=True, fused_bwd=True)
    u, kap, cot = (_rand(4, n), 1 + 0.1 * _rand(5, n) ** 2, _rand(6, n))
    calls, card_branch = march_on_cpu
    sa.reset_launch_counts()
    ins = {"u": torch.tensor(u, requires_grad=True),
           "kappa": torch.tensor(kap, requires_grad=True)}
    out = chain(ins)["u"]
    card_branch()
    gu, gk = torch.autograd.grad(out, [ins["u"], ins["kappa"]],
                                 torch.tensor(cot))
    jout, pull = jax.vjp(lambda a, b: jchain({"u": a, "kappa": b})["u"],
                         jnp.asarray(u), jnp.asarray(kap))
    jgu, jgk = pull(jnp.asarray(cot))
    _close(out, jout)
    _close(gu, jgu, GRAD_RTOL, "d/du")
    _close(gk, jgk, GRAD_RTOL, "d/dκ")
    block = (8 + 8, 8 + 8, 8)
    assert calls == [["kappa", "u"]] * 4
    assert sa.LAUNCHES == 4
    assert dict(sa.LAUNCH_CALLS) == {
        ("diffusion3d", 2, False, block, 8, "march-shard"): 4}
    g = chain._kernels[("vjp", n, frozenset({"u", "kappa"}))]
    assert g.designs == {(block, 8): "march"}


def test_sharded_chain_route_honours_wanted(march_on_cpu, monkeypatch):
    """A gradient w.r.t. u alone: the march accumulates no κ gradient (its
    plan's cotangents are u's), and d/du still equals the plain route's
    (CPU) result."""
    op = diffusion3d_op(dt=0.05, dtype="float64")
    n = (16, 16, 8)
    u, kap, cot = (_rand(7, n), 1 + 0.1 * _rand(8, n) ** 2, _rand(9, n))
    calls, card_branch = march_on_cpu
    res = []
    for on_card in (False, True):
        chain = ShardedChain(op, 2, make_mesh((2, 2), ("x", "y"),
                                              ["cpu"] * 4),
                             {0: "x", 1: "y"}, carry_map=CARRY,
                             fused_bwd=True)
        ut = torch.tensor(u, requires_grad=True)
        out = chain({"u": ut, "kappa": torch.tensor(kap)})["u"]
        if on_card:
            card_branch()
        (g,) = torch.autograd.grad(out, ut, torch.tensor(cot))
        res.append(g)
    assert calls == [["u"]] * 4
    _close(res[0], res[1], GRAD_RTOL)


def test_forced_stream_design_takes_the_streaming_kernel(monkeypatch):
    """Where the reckoning (``time_chain.two_phase_design``, forced here)
    picks "stream", the route runs the streaming kernel's shard mode (its
    launch is the first thing that needs the card)."""
    built = []

    def fake_stream(ap, form=None):
        def fn(state, cots, probe_cots=(), bases=None):
            built.append(bases)
            return ac._plain_shard_chain_vjp(ap)(state, cots, (), bases)
        return fn

    monkeypatch.setattr(tc, "two_phase_design", lambda *a: "stream")
    monkeypatch.setattr(pa, "make_plane_adjoint_kernel", fake_stream)
    op = diffusion3d_op(dt=0.05, dtype="float64")
    chain = ShardedChain(op, 2, make_mesh((2, 2), ("x", "y"), ["cpu"] * 4),
                         {0: "x", 1: "y"}, carry_map=CARRY, fused_bwd=True)
    ut = torch.tensor(_rand(10, (16, 16, 8)), requires_grad=True)
    out = chain({"u": ut, "kappa": torch.ones(16, 16, 8,
                                              dtype=torch.float64)})["u"]
    monkeypatch.setattr(ck, "on_card", lambda t: True)
    torch.autograd.grad(out.sum(), ut)
    assert built == [[-4, -4, 0], [-4, 4, 0], [4, -4, 0], [4, 4, 0]]


# ------------------------------------------------------------- the source --

@pytest.mark.parametrize("periodic", [False, True])
def test_march_source_of_3d_two_phase_shard_plan(periodic):
    """The march's translation unit for config #2's sharded κ cycle in
    two-phase mode generates on the CPU: shard mode on, 3D, two-phase,
    the sharded dims 0 and 1 unwrapped and (periodic) dim 2 wrapped."""
    plan = _sharded_plan((48, 40, 24), 2, periodic)
    sp, sap = sm.chain_march_plans(plan)
    mg = sm.stage_march_geometry(sp, (20, 18, 24), 8, sap)
    src = generate_stage_march_source(mg, "float64")
    lines = src.splitlines()
    for want in ("#define PSAT_SHARD 1", "#define PSAT_WRAP0 0",
                 "#define PSAT_WRAP1 0", f"#define PSAT_WRAP2 {int(periodic)}",
                 "#define PSAT_ND 3", "#define PSAT_TWO_PHASE 1",
                 "#define PSAT_NCOT 2"):
        assert want in lines, want
    assert lines.index("#define PSAT_SHARD 1") < lines.index(
        '#include "stage_march.cuh"')
