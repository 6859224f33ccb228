"""The port's comm-avoiding ``ShardedChain`` and the shard modes of its
fused chains (``ops.flatten.ShardSpec``) against the JAX package, in
float64 on the CPU.

On CPU tensors every fused chain runs its plain version's shard mode, so
these tests hold the semantics the CUDA shard modes are compared with on
the card.  The port's meshes are ``["cpu"] * 8``.  The reference is the
JAX package's jnp sequential stepping (``stage_stepper(lowering="jnp")``,
the reference its own ``tests/test_sharded_chain.py`` uses), and at one
tiny case its interpret-mode ``ShardedChain`` on the 8 virtual devices.
Tolerances are those tests': rtol 1e-12 for values, 1e-11 for gradients.
Mirrors ``tests/test_sharded_chain.py`` and the chain cases of
``tests/test_sharded_uneven.py``; the transport counts stand for their
``ppermute`` counts.  The last tests hold each plain shard mode on an
interior shard's block against the unsharded plain version on the whole
array.  Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu import parallel as jpar
from pystencils_autodiff_tpu.ops.stage_chain import stage_stepper as jstepper
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  elastic_stages,
                                                  wave_step_op)
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec
from pystencils_autodiff_tpu_torch.parallel import (ShardedChain,
                                                    ShardedStencil,
                                                    exchange_count,
                                                    make_mesh,
                                                    reset_exchange_count)

RTOL, GRAD_RTOL = 1e-12, 1e-11
CPU8 = ["cpu"] * 8
ELASTIC = ["vx", "vy", "sxx", "syy", "sxy"]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def heat_op(dt=0.1):
    u, u_next = fields("u, u_next", 2)
    return AutoDiffOp([Assignment(
        u_next[0, 0],
        u[0, 0] + dt * (u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1]
                        - 4 * u[0, 0]))], op_name="heat2d")


def diff_op_3d(dt=0.05):
    u, u_next = fields("u, u_next", 3)
    return AutoDiffOp([Assignment(
        u_next[0, 0, 0],
        u[0, 0, 0] + dt * (u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0]
                           + u[0, -1, 0] + u[0, 0, 1] + u[0, 0, -1]
                           - 6 * u[0, 0, 0]))], op_name="diff3d")


def _mesh(shape, axes):
    return make_mesh(shape, axes, CPU8)


def jax_sequential(stages, k, periodic):
    """The JAX package's jnp sequential stepping, jitted:
    ``run(state) -> state``."""
    steps = [jstepper(jax_twin(op), dict(c), lowering="jnp",
                      periodic=periodic) for op, c in stages]

    @jax.jit
    def run(state):
        st = dict(state)
        for _ in range(k):
            for step in steps:
                st = step(st)
        return {n: st[n] for n in state}

    return run


def _value_and_vjp(chain, state, cots):
    """The port chain's state and the VJP of ``cots`` w.r.t. the state."""
    ins = {n: _t(v, True) for n, v in state.items()}
    out = chain(ins)
    names = list(cots)
    grads = torch.autograd.grad([out[n] for n in names],
                                [ins[n] for n in state], [_t(cots[n])
                                                          for n in names],
                                allow_unused=True)
    return out, dict(zip(state, grads))


def _jax_value_and_vjp(stages, k, periodic, state, cots):
    run = jax_sequential(stages, k, periodic)
    js = {n: jnp.asarray(v) for n, v in state.items()}
    out, pull = jax.vjp(run, js)
    (g,) = pull({n: jnp.asarray(cots[n]) if n in cots else jnp.zeros_like(
        js[n]) for n in js})
    return out, g


def _check_chain(chain, stages, k, periodic, state, cots):
    out, grads = _value_and_vjp(chain, state, cots)
    jout, jg = _jax_value_and_vjp(stages, k, periodic, state, cots)
    for n in cots:
        _close(out[n], jout[n], RTOL, f"state {n}")
    for n in state:
        if grads[n] is not None:
            _close(grads[n], jg[n], GRAD_RTOL, f"grad {n}")


# ------------------------------------------------------ values and counts --

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_heat_chain_1d_decomposition(k, periodic):
    """A single-op chain over 8 shards of dim 0 equals the JAX package's
    sequential stepping, with ONE exchange a call: 2 transports, for any
    k."""
    op = heat_op()
    chain = ShardedChain(op, k, _mesh((8,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, periodic=periodic)
    u = _rand(0, (64, 32))
    reset_exchange_count()
    out = chain({"u": _t(u)})
    assert exchange_count() == 2
    ref = jax_sequential([(op, {"u": "u_next"})], k, periodic)(
        {"u": jnp.asarray(u)})
    _close(out["u"], ref["u"])


@pytest.mark.parametrize("periodic", [False, True])
def test_heat_chain_gradients_exact(periodic):
    """The default backward (sequential ShardedStencil recompute and the
    transposed deep exchange) is the single-device gradient."""
    op = heat_op()
    chain = ShardedChain(op, 3, _mesh((4,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, periodic=periodic)
    u = _rand(1, (64, 32))
    ut = _t(u, True)
    (g,) = torch.autograd.grad(torch.sin(chain({"u": ut})["u"]).sum(), ut)
    seq = jax_sequential([(op, {"u": "u_next"})], 3, periodic)
    jg = jax.grad(lambda a: jnp.sum(jnp.sin(seq({"u": a})["u"])))(
        jnp.asarray(u))
    _close(g, jg, GRAD_RTOL)


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_elastic_stage_chain_sharded(periodic, fused_bwd):
    """The staggered two-sweep cycle, k=2, over 4 shards (2 with the fused
    backward): state and the VJP of every field."""
    stages = elastic_stages(dt=0.01, dtype="float64")
    chain = ShardedChain(stages, 2, _mesh((2 if fused_bwd else 4,), ("x",)),
                         {0: "x"}, periodic=periodic, fused_bwd=fused_bwd)
    state = {n: _rand(i, (64, 32)) for i, n in enumerate(ELASTIC)}
    cots = {n: _rand(40 + i, (64, 32)) for i, n in enumerate(ELASTIC)}
    _check_chain(chain, stages, 2, periodic, state, cots)


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_diff3d_chain_2d_decomposition(periodic, fused_bwd):
    """A 3D chain over a (2, 2) mesh of dims 0 and 1 (the plane route:
    the 3D forward chain and the streaming adjoint in shard mode); the
    corner halos ride the second exchange."""
    op = diff_op_3d()
    chain = ShardedChain(op, 2, _mesh((2, 2), ("x", "y")), {0: "x", 1: "y"},
                         carry_map={"u": "u_next"}, periodic=periodic,
                         fused_bwd=fused_bwd)
    assert chain._plane_ok
    u = _rand(2, (16, 16, 16))
    _check_chain(chain, [(op, {"u": "u_next"})], 2, periodic, {"u": u},
                 {"u": _rand(3, (16, 16, 16))})


def test_kappa_diffusion_plane_route_fused():
    """Config #2's κ-diffusion chain on the plane route, bounded, fused
    backward: the κ gradient too (the invariant plane's accumulation)."""
    op = diffusion3d_op(dt=0.05, dtype="float64")
    chain = ShardedChain(op, 2, _mesh((2, 2), ("x", "y")), {0: "x", 1: "y"},
                         carry_map={"u": "u_next"}, fused_bwd=True)
    assert chain._plane_ok
    state = {"u": _rand(4, (12, 12, 10)),
             "kappa": 1 + 0.1 * _rand(5, (12, 12, 10)) ** 2}
    _check_chain(chain, [(op, {"u": "u_next"})], 2, False, state,
                 {"u": _rand(6, (12, 12, 10))})


def test_exchange_count_is_k_independent():
    """The fused chain exchanges 2 transports per sharded dim for any k;
    sequential ShardedStencil stepping 2 per dim and step."""
    op = heat_op()
    mesh = _mesh((4,), ("x",))
    u = _t(_rand(3, (64, 32)))
    for k in (1, 4):
        chain = ShardedChain(op, k, mesh, {0: "x"},
                             carry_map={"u": "u_next"})
        reset_exchange_count()
        chain({"u": u})
        assert exchange_count() == 2
    seq = ShardedStencil(op, mesh, {0: "x"})
    reset_exchange_count()
    a = u
    for _ in range(4):
        a = seq(a)
    assert exchange_count() == 2 * 4


def test_fused_backward_exchange_count():
    """The fused backward exchanges ONCE (a deep halo) and autograd moves
    its transpose: the value and gradient cost 6 transports along the
    sharded dim (2 forward, 2 + 2 transposed), at most the JAX package's
    8 ``ppermute``s, for any k."""
    op = heat_op()
    for k in (2, 4):
        chain = ShardedChain(op, k, _mesh((4,), ("x",)), {0: "x"},
                             carry_map={"u": "u_next"}, fused_bwd=True)
        ut = _t(_rand(9, (64, 32)), True)
        reset_exchange_count()
        torch.autograd.grad(chain({"u": ut})["u"].square().sum(), ut)
        assert exchange_count() == 6


def test_twin_backward_exchange_count():
    """The twin backward: 2 forward and 2 cotangent-chain transports,
    independent of k."""
    op = heat_op()
    chain = ShardedChain(op, 8, _mesh((4,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, periodic=True,
                         fused_bwd=True)
    assert chain._twin is not None
    ut = _t(_rand(9, (128, 32)), True)
    reset_exchange_count()
    torch.autograd.grad(chain({"u": ut})["u"].square().sum(), ut)
    assert exchange_count() == 4


# ------------------------------------------------------------ validation --

def test_sharded_chain_validation():
    op = heat_op()
    mesh = _mesh((8,), ("x",))
    with pytest.raises(ValueError, match="lane dim"):
        ShardedChain(op, 2, mesh, {1: "x"}, carry_map={"u": "u_next"})
    with pytest.raises(ValueError, match="size-1 mesh axis"):
        ShardedChain(diff_op_3d(), 2, mesh, {0: "x"},
                     carry_map={"u": "u_next"}, periodic=True)
    with pytest.raises(ValueError, match="not in mesh"):
        ShardedChain(op, 2, mesh, {0: "q"}, carry_map={"u": "u_next"})
    chain = ShardedChain(op, 16, mesh, {0: "x"}, carry_map={"u": "u_next"})
    with pytest.raises(ValueError, match="exceeds the local shard extent"):
        chain({"u": _t(_rand(4, (64, 32)))})
    with pytest.raises(ValueError, match="meaningless"):
        ShardedChain(elastic_stages(dtype="float64"), 2, mesh, {0: "x"},
                     periodic=True, boundary={"vx": "dirichlet"})


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_deep_halo_at_shard_extent(fused_bwd):
    """The fused backward's halo (k·(reach_f+reach_b) = 4) equals the shard
    extent in both sharded dims of a (2, 4) mesh: the exchanged halo spans
    the whole neighbour shard and the corner halos are at full depth."""
    op = diff_op_3d()
    chain = ShardedChain(op, 2, _mesh((2, 4), ("x", "y")), {0: "x", 1: "y"},
                         carry_map={"u": "u_next"}, fused_bwd=fused_bwd)
    _check_chain(chain, [(op, {"u": "u_next"})], 2, False,
                 {"u": _rand(11, (8, 16, 8))}, {"u": _rand(12, (8, 16, 8))})


@pytest.mark.parametrize("periodic", [False, True])
def test_fused_backward_matches_sequential(periodic):
    """fused_bwd=True (one deep exchange, the two-phase adjoint per shard)
    equals the sequential-recompute backward and the JAX package's
    gradient."""
    op = heat_op()
    mesh = _mesh((4,), ("x",))
    u, cot = _rand(7, (64, 32)), _rand(8, (64, 32))
    res = {}
    for fb in (False, True):
        chain = ShardedChain(op, 2, mesh, {0: "x"},
                             carry_map={"u": "u_next"}, periodic=periodic,
                             fused_bwd=fb)
        res[fb] = _value_and_vjp(chain, {"u": u}, {"u": cot})
    _close(res[True][0]["u"], res[False][0]["u"].detach())
    _close(res[True][1]["u"], res[False][1]["u"], GRAD_RTOL)
    _check_chain(ShardedChain(op, 2, mesh, {0: "x"},
                              carry_map={"u": "u_next"}, periodic=periodic,
                              fused_bwd=True),
                 [(op, {"u": "u_next"})], 2, periodic, {"u": u}, {"u": cot})


@pytest.mark.parametrize("carry,frozen", [({"u": "u_next"}, False),
                                          (None, True)])
def test_twin_backward(carry, frozen):
    """Linear periodic single-op chains pull back through the transposed
    op's own ShardedChain; a frozen coefficient (the wave's c) rides the
    cotangent chain and keeps its pass-through cotangent."""
    if frozen:
        op = wave_step_op(grad_c=False, dtype="float64")
        carry = {"u_curr": "u_next", "u_prev": "u_curr"}
        state = {"u_curr": _rand(50, (64, 32)), "u_prev": _rand(51, (64, 32)),
                 "c": 2.0 + 0.1 * np.abs(_rand(52, (64, 32)))}
        cots = {"u_curr": _rand(53, (64, 32)), "u_prev": _rand(54, (64, 32))}
    else:
        op = heat_op()
        state, cots = {"u": _rand(40, (64, 32))}, {"u": _rand(41, (64, 32))}
    chain = ShardedChain(op, 2, _mesh((4,), ("x",)), {0: "x"},
                         carry_map=carry, periodic=True, fused_bwd=True)
    assert chain._twin is not None
    _check_chain(chain, [(op, carry)], 2, True, state, cots)


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_trivial_mesh_fast_path(periodic, fused_bwd):
    """Every sharded axis of size 1: the unsharded chain on the whole
    block — no transport, no global masks — and exact gradients."""
    op = heat_op()
    chain = ShardedChain(op, 3, _mesh((1,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, periodic=periodic,
                         fused_bwd=fused_bwd)
    assert chain._trivial
    reset_exchange_count()
    _check_chain(chain, [(op, {"u": "u_next"})], 3, periodic,
                 {"u": _rand(21, (64, 32))}, {"u": _rand(22, (64, 32))})
    assert exchange_count() == 0


@pytest.mark.parametrize("periodic", [False, True])
def test_mixed_mesh_size1_axis(periodic):
    """A real axis beside a size-1 axis: the size-1 dim's exchange moves
    nothing (its own opposite edge, or zeros), the real one 2 transports;
    state and gradients stay exact."""
    op = diff_op_3d()
    chain = ShardedChain(op, 2, _mesh((2, 1), ("x", "y")), {0: "x", 1: "y"},
                         carry_map={"u": "u_next"}, periodic=periodic)
    assert not chain._trivial
    u = _rand(23, (16, 12, 8))
    reset_exchange_count()
    chain({"u": _t(u)})
    assert exchange_count() == 2
    _check_chain(chain, [(op, {"u": "u_next"})], 2, periodic, {"u": u},
                 {"u": _rand(24, (16, 12, 8))})


def test_matches_jax_interpret_sharded_chain():
    """One tiny case against the JAX package's own ShardedChain (its
    Pallas kernels in interpret mode on the virtual devices), fused
    backward, bounded."""
    op = heat_op()
    chain = ShardedChain(op, 2, _mesh((4,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, fused_bwd=True)
    jchain = jpar.ShardedChain(jax_twin(op), 2, jpar.make_mesh((4,), ("x",)),
                               {0: "x"}, carry_map={"u": "u_next"},
                               interpret=True, fused_bwd=True)
    u, cot = _rand(30, (32, 16)), _rand(31, (32, 16))
    out, g = _value_and_vjp(chain, {"u": u}, {"u": cot})
    jout, pull = jax.vjp(lambda a: jchain({"u": a})["u"], jnp.asarray(u))
    _close(out["u"], jout)
    _close(g["u"], pull(jnp.asarray(cot))[0], GRAD_RTOL)


# ---------------------------------------------------------------- uneven --

def _uneven_op():
    u, kap, out = fields("u, kap, out", 2)
    lap = u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]
    return AutoDiffOp([Assignment(out.center,
                                  u.center + 0.1 * kap.center ** 2 * lap)],
                      op_name="heat_vk_uneven")


@pytest.mark.parametrize("fused_bwd", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_sharded_chain_uneven(k, fused_bwd):
    """45×33 over 4 shards of dim 0: pad-and-mask, state and gradients
    (κ's too) exact."""
    op = _uneven_op()
    chain = ShardedChain(op, k, _mesh((4,), ("x",)), {0: "x"},
                         carry_map={"u": "out"}, fused_bwd=fused_bwd)
    state = {"u": _rand(0, (45, 33)),
             "kap": 1.0 + 0.1 * _rand(1, (45, 33)) ** 2}
    _check_chain(chain, [(op, {"u": "out"})], k, False, state,
                 {"u": _rand(2, (45, 33))})


def test_sharded_chain_uneven_periodic_raises():
    chain = ShardedChain(heat_op(), 2, _mesh((4,), ("x",)), {0: "x"},
                         carry_map={"u": "u_next"}, periodic=True)
    with pytest.raises(ValueError, match="divide the mesh evenly"):
        chain({"u": _t(_rand(0, (45, 32)))})


# --------------------------------------------------- plain shard modes --

def _block(g, lo_hi, base_len, idx, nshards, periodic):
    """Shard ``idx``'s block of dim 0 of ``g`` extended by ``lo_hi``
    (wrapped, or zeros beyond a bounded domain)."""
    lo, hi = lo_hi
    n = g.shape[0]
    rows = torch.arange(idx * base_len - lo, (idx + 1) * base_len + hi)
    if periodic:
        return g[rows % n]
    ok = (rows >= 0) & (rows < n)
    out = g[rows.clamp(0, n - 1)].clone()
    out[~ok] = 0
    return out


@pytest.mark.parametrize("periodic", [False, True])
def test_plain_stage_shard_mode_matches_unsharded(periodic):
    """Kernel 12's and 13's plain shard modes on an interior shard's
    extended block, with in-chain BCs (sponge; bounded also dirichlet and
    neumann), against the unsharded plain versions on the whole array:
    the owned rows of state_k, and cot_0 over the whole block for a
    cotangent on the owned rows."""
    stages = elastic_stages(dt=0.01, dtype="float64")
    boundary = {0: {"vx": [("sponge", "damp")]}}
    if not periodic:
        boundary[1] = {"sxx": "dirichlet", "vy": "neumann"}
    n0, n1, k, parts, i = 64, 24, 2, 4, 1
    plan = sc.StagePlan(stages, k, periodic, boundary)
    # the fused backward's halo, k·(reach_f + reach_b + bc) a side
    halo = max(ShardedChain(stages, k, _mesh((parts,), ("x",)), {0: "x"},
                            periodic=periodic, boundary=boundary,
                            fused_bwd=True)._halo_bwd[0])
    spec = ShardSpec((n0, n1), (0,))
    splan = sc.StagePlan(stages, k, periodic, boundary, shard=spec)
    g = {n: _t(_rand(j, (n0, n1))) for j, n in enumerate(ELASTIC)}
    g["damp"] = _t(0.8 + 0.2 * np.abs(_rand(9, (n0, n1))))
    L = n0 // parts
    blk = {n: _block(v, (halo, halo), L, i, parts, periodic)
           for n, v in g.items()}
    bases = (i * L - halo, 0)
    out = sc.plain_stage_chain(splan)(blk, bases)
    ref = sc.plain_stage_chain(plan)(g)
    for n in ELASTIC:
        _close(out[n][halo:halo + L], ref[n][i * L:(i + 1) * L], RTOL, n)
    cot = {n: torch.zeros(n0, n1, dtype=torch.float64) for n in g}
    for j, n in enumerate(ELASTIC):
        cot[n][i * L:(i + 1) * L] = _t(_rand(20 + j, (L, n1)))
    cblk = {n: _block(v, (halo, halo), L, i, parts, periodic)
            for n, v in cot.items()}
    _, c0 = sa.plain_stage_chain_vjp(sa.AdjointStagePlan(splan))(
        blk, cblk, bases)
    _, r0 = sa.plain_stage_chain_vjp(sa.AdjointStagePlan(plan))(g, cot)
    for n in list(ELASTIC) + ["damp"]:
        want = _block(r0[n], (halo, halo), L, i, parts, periodic)
        _close(c0[n], want, GRAD_RTOL, f"cot {n}")


@pytest.mark.parametrize("periodic", [False, True])
def test_plain_time_chain_shard_mode_matches_unsharded(periodic):
    """The 3D chain's plain shard mode (rows 7 and 9) on the block of
    shard (1, 0) of a (4, 2) split of dims 0 and 1, against the unsharded
    plain chain and VJP on the whole array."""
    op = diffusion3d_op(dt=0.05, dtype="float64")
    n, k = (16, 12, 6), 2
    spec = ShardSpec(n, (0, 1))
    plan = tc.chain_plan(op, k, {"u": "u_next"}, periodic)
    splan = tc.chain_plan(op, k, {"u": "u_next"}, periodic, shard=spec)
    h = 2 * k
    lo = (1 * 4 - h, 0 * 6 - h)
    g = {"u": _t(_rand(0, n)), "kappa": _t(1 + 0.1 * _rand(1, n) ** 2)}

    def block(v):
        idx = [torch.arange(lo[0], lo[0] + 4 + 2 * h),
               torch.arange(lo[1], lo[1] + 6 + 2 * h)]
        ok = [(r >= 0) & (r < m) for r, m in zip(idx, n)]
        b = v[(idx[0] % n[0])[:, None], (idx[1] % n[1])[None, :]]
        if not periodic:
            b = b * (ok[0][:, None] & ok[1][None, :])[..., None]
        return b

    bases = (lo[0], lo[1], 0)
    blk = {m: block(v) for m, v in g.items()}
    out, _ = tc.plain_time_chain(splan)(blk, bases)
    ref, _ = tc.plain_time_chain(plan)(g)
    _close(out["u"][h:h + 4, h:h + 6], ref["u"][4:8, 0:6])
    cot = {m: torch.zeros(n, dtype=torch.float64) for m in g}
    cot["u"][4:8, 0:6] = _t(_rand(2, (4, 6, 6)))
    _, c0 = ac.plain_chain_vjp(ac.AdjointPlan(splan))(
        blk, {m: block(v) for m, v in cot.items()}, (), bases)
    _, r0 = ac.plain_chain_vjp(ac.AdjointPlan(plan))(g, cot)
    for m in g:
        _close(c0[m], block(r0[m]), GRAD_RTOL, m)


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_cavity_bounce_back_sharded(layout):
    """The lid-driven cavity (D2Q9 BGK behind bounce-back walls with a
    moving lid, the walls' pulls edge-clamped at the global domain's edge)
    on 2 shards of dim 0 with the fused backward: state and the gradients
    of the populations and the lid velocity equal the unsharded stage
    chain's (held against the JAX package in test_torch_stage.py)."""
    from pystencils_autodiff_tpu_torch.models import d2q9_bgk_op
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain

    n = 24
    stages = [(d2q9_bgk_op(omega=1.6, layout=layout), {"f": "f_out"})]
    bc = {"f": ("bounce_back", "solid", ("uw0", "uw1"))}
    rng = np.random.default_rng(3)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    shape = (9, n, n) if layout == "soa" else (n, n, 9)
    f0 = (w[:, None, None] if layout == "soa" else w) * np.ones(shape)
    f0 = f0 + 0.01 * rng.standard_normal(shape)
    solid = np.zeros((n, n))
    solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = 1.0
    lid = np.zeros((n, n))
    lid[0, :] = 0.08
    state = {"f": f0, "solid": solid, "uw0": np.zeros((n, n)), "uw1": lid}
    cots = {"f": rng.standard_normal(shape)}
    res = []
    for chain in (ShardedChain(stages, 2, _mesh((2,), ("x",)), {0: "x"},
                               boundary=bc, fused_bwd=True),
                  fused_stage_chain(stages, 2, boundary=bc,
                                    fused_bwd=True)):
        res.append(_value_and_vjp(chain, state, cots))
    _close(res[0][0]["f"], res[1][0]["f"].detach())
    for name in ("f", "uw1"):
        _close(res[0][1][name], res[1][1][name], GRAD_RTOL, name)
