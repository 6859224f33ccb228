"""The fused chains of the port (``ops.time_chain``, ``ops.adjoint_chain``)
and the FWI gradient (``models.wave.fwi_gradient``) against the JAX
package, in float64 on the CPU.

The JAX side runs as its own tests run it: the Pallas chain kernels in
interpret mode with 16-row tiles, the sequential reference with
``lowering="jnp"``.  On CPU tensors the port runs the plain versions of its
chain kernels (k single steps of ``ops.torch_ref``), so these tests hold
the semantics the CUDA kernels are compared with on the card; the
``cuda``-marked tests at the end compare the kernels themselves (skipped
without a card).  Inputs are made from a seed with numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
    generate_adjoint_source, generate_chain_source)
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op, fwi_gradient,
                                                  heat_step_op, heat_step3d_op,
                                                  wave_step_op)
from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta
from pystencils_autodiff_tpu_torch.timeloop import make_time_stepper
from torch_jax_twin import jax_twin

CARRY = {"u_curr": "u_next", "u_prev": "u_curr"}
HEAT_CARRY = {"u": "u_next"}
SHAPE, ROW, K = (48, 32), 17, 4


def _wave(**kw):
    return wave_step_op(dt=0.2, dtype="float64", **kw)


def _heat():
    return heat_step_op(dt=0.1, dtype="float64")


def _jax_op(name):
    from pystencils_autodiff_tpu.models.heat import heat_step_op as jheat
    from pystencils_autodiff_tpu.models.wave import wave_step_op as jwave

    return (jwave(dt=0.2, dtype="float64") if name == "wave"
            else jheat(dt=0.1, dtype="float64"))


def _state(names, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    st = {n: 0.1 * rng.standard_normal(shape) for n in names}
    if "c" in st:
        st["c"] = 2.0 + 0.1 * rng.standard_normal(shape) ** 2
    return st


def _t(arrays, device="cpu", dtype=torch.float64):
    return {n: torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for n, a in arrays.items()}


def _close(got, ref, rtol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


# (id, op name, carry, periodic, probes)
CHAINS = [
    ("wave-bounded-probe", "wave", CARRY, False, [("u_curr", ROW)]),
    ("wave-periodic-probe", "wave", CARRY, True, [("u_curr", ROW)]),
    ("heat-periodic", "heat", HEAT_CARRY, True, []),
]


def _port_op(name):
    return _wave() if name == "wave" else _heat()


@pytest.mark.parametrize("case", CHAINS, ids=[c[0] for c in CHAINS])
def test_fused_time_chain_matches_jax_and_sequential(case):
    """The port's chain vs JAX ``fused_time_chain`` (interpret mode) and
    vs the port's own sequential stepping: states and probe rows, rtol
    1e-12."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    _, name, carry, periodic, probes = case
    op = _port_op(name)
    names = [f.name for f in op.forward_input_fields]
    arrays = _state(names)
    jc = jchain(_jax_op(name), K, carry, periodic=periodic, interpret=True,
                tile_rows=16, probes=probes or None)
    jres = jc({n: jnp.asarray(a) for n, a in arrays.items()})
    chain = fused_time_chain(op, K, carry, periodic=periodic,
                             probes=probes or None)
    res = chain(_t(arrays))
    jst, jprobes = jres if probes else (jres, ())
    st, tprobes = res if probes else (res, ())
    step = make_time_stepper(op, carry, periodic=periodic)
    seq = _t(arrays)
    rows = []
    for _ in range(K):
        seq = step(seq)
        rows += [seq[p][r] for p, r in probes]
    for n in names:
        _close(st[n], jst[n], 1e-12, f"state {n} vs JAX")
        _close(st[n], seq[n].detach(), 1e-12, f"state {n} vs sequential")
    for tp, jp in zip(tprobes, jprobes):
        _close(tp, jp, 1e-12, "probe vs JAX")
        _close(tp, torch.stack(rows).detach(), 1e-12, "probe vs sequential")


# 3D chains (BASELINE config #2's op and the 3D heat step), at the JAX
# package's own 3D test shape
SHAPE3 = (12, 10, 16)
CHAINS3D = [
    # (id, op factory, k, periodic)
    ("diffusion3d-bounded-k1", lambda: diffusion3d_op(dt=0.05,
                                                      dtype="float64"), 1,
     False),
    ("diffusion3d-bounded-k2", lambda: diffusion3d_op(dt=0.05,
                                                      dtype="float64"), 2,
     False),
    ("diffusion3d-periodic-k2", lambda: diffusion3d_op(dt=0.05,
                                                       dtype="float64"), 2,
     True),
    ("heat3d-periodic-k3", lambda: heat_step3d_op(dtype="float64"), 3, True),
]


def _state3d(op, seed, shape=SHAPE3):
    rng = np.random.default_rng(seed)
    return {f.name: (1.0 + 0.2 * rng.standard_normal(shape) ** 2
                     if f.name == "kappa" else rng.standard_normal(shape))
            for f in op.forward_input_fields}


@pytest.mark.parametrize("case", CHAINS3D, ids=[c[0] for c in CHAINS3D])
def test_fused_time_chain_3d_matches_jax(case):
    """The port's 3D chain vs JAX ``fused_time_chain`` (interpret mode: its
    plane chain kernel) and vs the port's own sequential stepping, every
    cell, rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    _, make_op, k, periodic = case
    op = make_op()
    arrays = _state3d(op, 0)
    jres = jchain(jax_twin(op), k, HEAT_CARRY, periodic=periodic,
                  interpret=True)({n: jnp.asarray(a)
                                   for n, a in arrays.items()})
    res = fused_time_chain(op, k, HEAT_CARRY, periodic=periodic)(_t(arrays))
    step = make_time_stepper(op, HEAT_CARRY, periodic=periodic)
    seq = _t(arrays)
    for _ in range(k):
        seq = step(seq)
    for n in arrays:
        _close(res[n], jres[n], 1e-10, f"state {n} vs JAX")
        _close(res[n], seq[n].detach(), 1e-12, f"state {n} vs sequential")


def test_twin_chains_3d_periodic_linear_match_jax():
    """A linear periodic 3D op takes the twin chains — two 3D forward
    chains — in both packages; value and cotangent equal, rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    op = heat_step3d_op(dtype="float64")
    arrays, cots = _state3d(op, 1), _state3d(op, 2)
    g = fused_chain_vjp(op, 2, HEAT_CARRY, periodic=True)
    assert g.route == "twin"
    st, cot0 = g(_t(arrays), _t(cots))
    jst, jcot0 = jvjp(jax_twin(op), 2, HEAT_CARRY, periodic=True,
                      interpret=True)(
        {n: jnp.asarray(a) for n, a in arrays.items()},
        {n: jnp.asarray(a) for n, a in cots.items()})
    _close(st["u"], jst["u"], 1e-10, "state")
    _close(cot0["u"], jcot0["u"], 1e-10, "cot")


# (id, op name, carry, periodic, probes, expected route)
VJPS = [
    ("wave-bounded-probe", "wave", CARRY, False, [("u_curr", ROW)],
     "two_phase"),
    ("wave-bounded", "wave", CARRY, False, [], "two_phase"),
    ("wave-periodic-probe", "wave", CARRY, True, [("u_curr", ROW)],
     "two_phase"),
    ("wave-periodic", "wave", CARRY, True, [], "twin_accum"),
    ("heat-periodic-twin", "heat", HEAT_CARRY, True, [], "twin"),
]


def _vjp_case(case, seed=1):
    _, name, carry, periodic, probes, _ = case
    op = _port_op(name)
    names = [f.name for f in op.forward_input_fields]
    arrays = _state(names, seed=seed)
    rng = np.random.default_rng(seed + 10)
    cots = {n: rng.standard_normal(SHAPE) for n in names}
    pcots = [rng.standard_normal((K, SHAPE[1])) for _ in probes]
    return op, names, arrays, cots, pcots


def _jax_vjp(case, arrays, cots, pcots):
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    _, name, carry, periodic, probes, _ = case
    g = jvjp(_jax_op(name), K, carry, periodic=periodic, interpret=True,
             tile_rows=16, probes=probes or None)
    st, cot0 = g({n: jnp.asarray(a) for n, a in arrays.items()},
                 {n: jnp.asarray(a) for n, a in cots.items()},
                 tuple(jnp.asarray(p) for p in pcots))
    return ({n: np.asarray(v) for n, v in st.items()},
            {n: np.asarray(v) for n, v in cot0.items()})


@pytest.mark.parametrize("case", VJPS, ids=[c[0] for c in VJPS])
def test_fused_chain_vjp_matches_jax(case):
    """``(state_k, cot_0)`` of the port vs JAX ``fused_chain_vjp``
    (interpret mode), every cell including the ghost frame, rtol 1e-10.
    Periodic wave without probes takes the twin-with-accumulation route
    in both packages."""
    _, name, carry, periodic, probes, route = case
    op, names, arrays, cots, pcots = _vjp_case(case)
    g = fused_chain_vjp(op, K, carry, periodic=periodic,
                        probes=probes or None)
    assert g.route == route
    st, cot0 = g(_t(arrays), _t(cots), tuple(torch.tensor(p) for p in pcots))
    jst, jcot0 = _jax_vjp(case, arrays, cots, pcots)
    for n in names:
        _close(st[n], jst[n], 1e-10, f"state {n}")
        _close(cot0[n], jcot0[n], 1e-10, f"cot {n}")
    if not periodic:  # the exact VJP puts gradient into the ghost frame
        assert np.abs(cot0["u_curr"].numpy()[0]).max() > 0


@pytest.mark.parametrize("case", VJPS[:3], ids=[c[0] for c in VJPS[:3]])
def test_segmented_two_phase_matches_jax(case):
    """The two-phase route run as 2 segments of depth 2 (each recomputes
    its forward from a checkpoint; the probe cotangents split by segment)
    equals the JAX package's k-deep ``fused_chain_vjp``, rtol 1e-10."""
    _, name, carry, periodic, probes, _ = case
    op, names, arrays, cots, pcots = _vjp_case(case, seed=4)
    g = fused_chain_vjp(op, K, carry, periodic=periodic,
                        probes=probes or None, segments=2)
    st, cot0 = g(_t(arrays), _t(cots), tuple(torch.tensor(p) for p in pcots))
    assert g.segments == 2
    jst, jcot0 = _jax_vjp(case, arrays, cots, pcots)
    for n in names:
        _close(st[n], jst[n], 1e-10, f"state {n}")
        _close(cot0[n], jcot0[n], 1e-10, f"cot {n}")
    with pytest.raises(ValueError, match="must divide"):
        fused_chain_vjp(op, K, carry, periodic=periodic,
                        probes=probes or None, segments=3)


def test_two_phase_segments_from_the_tile_reckoning():
    """The segment count is a host reckoning of the plan, the shape and the
    itemsize: the 2D wave's two-phase kernel (the dim-0 march) holds k=16
    at 8192² float32 but not k=32 (2 segments of 16), and float64 halves
    the depth again."""
    plan32 = tc.chain_plan(_wave(), 32, CARRY, False)
    assert not ac.two_phase_fits(plan32, (8192, 8192), 4)
    assert ac.two_phase_fits(ac.plan_at_depth(plan32, 16), (8192, 8192), 4)
    assert ac.two_phase_segments(plan32, (8192, 8192), 4) == 2
    assert ac.two_phase_segments(plan32, (8192, 8192), 8) == 4
    assert ac.two_phase_segments(tc.chain_plan(_wave(), K, CARRY, False),
                                 (8192, 8192), 4) == 1
    g = fused_chain_vjp(_wave(), 32, CARRY, periodic=False)
    assert g.segments_for((8192, 8192), 4) == 2


def _multi_carrier():
    """u_next = u·u[1,0] + 0.1·v, carried into both u and v: the backward
    program reads the output's cotangent as the sum of two carriers'."""
    u, v = Field("u", 2, dtype="float64"), Field("v", 2, dtype="float64")
    out = Field("u_next", 2, dtype="float64")
    return AutoDiffOp([Assignment(out.center, u[0, 0] * u[1, 0]
                                  + 0.1 * v[0, 0])], op_name="multi_carrier")


MULTI = {"u": "u_next", "v": "u_next"}


def test_multi_carrier_vjp_matches_jax():
    """An output carried into several state fields: the port's
    ``fused_chain_vjp`` (two-phase route, bounded, k=2) vs JAX
    ``fused_chain_vjp`` (interpret mode), every cell including the ghost
    frame, float64, rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    op = _multi_carrier()
    arrays = _state(["u", "v"], seed=5)
    rng = np.random.default_rng(6)
    cots = {n: rng.standard_normal(SHAPE) for n in arrays}
    g = fused_chain_vjp(op, 2, MULTI, periodic=False)
    assert g.route == "two_phase"
    assert g.plan.adj.count([0, 1]) == 1  # û_next reads ĉ_u + ĉ_v
    st, cot0 = g(_t(arrays), _t(cots))
    jst, jcot0 = jvjp(jax_twin(op), 2, MULTI, periodic=False,
                      interpret=True, tile_rows=16)(
        {n: jnp.asarray(a) for n, a in arrays.items()},
        {n: jnp.asarray(a) for n, a in cots.items()})
    for n in arrays:
        _close(st[n], jst[n], 1e-10, f"state {n}")
        _close(cot0[n], jcot0[n], 1e-10, f"cot {n}")
    assert np.abs(cot0["u"].numpy()[0]).max() > 0


def _fwi_inputs(seed=0, n_steps=8, shape=SHAPE):
    rng = np.random.default_rng(seed)
    u0 = 0.1 * rng.standard_normal(shape)
    c = 2.0 + 0.1 * rng.standard_normal(shape) ** 2
    obs = 0.01 * rng.standard_normal((n_steps, shape[1]))
    return u0, c, obs


@pytest.mark.parametrize("periodic", [False, True])
def test_fwi_gradient_fused_matches_jax(periodic):
    """Config #3: ``fwi_gradient(fused_k=4)`` (fused chain forward,
    two-phase backward) vs the JAX package's sequential
    ``fwi_gradient(lowering="jnp")`` and the port's unfused gradient: value
    and gradient, rtol 1e-10."""
    from pystencils_autodiff_tpu.models.wave import fwi_gradient as jfwi

    n_steps = 8
    u0, c, obs = _fwi_inputs(n_steps=n_steps)
    jv, jg = jfwi(jnp.asarray(c), jnp.asarray(u0), jnp.asarray(obs), ROW,
                  n_steps, dt=0.2, lowering="jnp", periodic=periodic)
    args = (torch.tensor(c), torch.tensor(u0), torch.tensor(obs), ROW,
            n_steps)
    v, g = fwi_gradient(*args, dt=0.2, fused_k=4, periodic=periodic)
    vu, gu = fwi_gradient(*args, dt=0.2, periodic=periodic)
    _close(v, jv, 1e-10, "fused value")
    _close(g, jg, 1e-10, "fused gradient")
    _close(vu, jv, 1e-10, "unfused value")
    _close(gu, jg, 1e-10, "unfused gradient")


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_chain_gradients_through_autograd(fused_bwd):
    """``torch.autograd.grad`` through two chained calls equals the
    gradient through 2k sequential single steps: the recompute backward
    (``fused_bwd=False``) and the two-phase one, with a probe."""
    op = _wave()
    names = ["u_curr", "u_prev", "c"]
    arrays = _state(names, seed=3)
    w = torch.tensor(np.random.default_rng(4).standard_normal(SHAPE))
    chain = fused_time_chain(op, K, CARRY, fused_bwd=fused_bwd,
                             probes=[("u_curr", ROW)])
    step = make_time_stepper(op, CARRY)

    def loss_chain(st):
        probes = []
        for _ in range(2):
            st, (p,) = chain(st)
            probes.append(p)
        return (st["u_curr"] * w).sum() + (torch.cat(probes) ** 2).sum()

    def loss_seq(st):
        rows = []
        for _ in range(2 * K):
            st = step(st)
            rows.append(st["u_curr"][ROW])
        return (st["u_curr"] * w).sum() + (torch.stack(rows) ** 2).sum()

    grads = []
    for loss in (loss_chain, loss_seq):
        ins = {n: t.requires_grad_() for n, t in _t(arrays).items()}
        grads.append(torch.autograd.grad(loss(ins), [ins[n] for n in names]))
    for n, a, b in zip(names, *grads):
        _close(a, b.numpy(), 1e-10, n)


PROBES3D = [("u", 3 * 10 + 4), ("u", 9 * 10 + 7)]  # lines (3, 4), (9, 7)


@pytest.mark.parametrize("fused_bwd", [False, True])
def test_3d_chain_with_probes_matches_jax(fused_bwd):
    """A bounded 3D chain with probes (a probe row names the line
    ``divmod(row, n1)`` along the last dim, as the JAX package's flattened
    rows do): states, probe lines and the gradient of a loss of both, with
    respect to u and κ, against the JAX package's ``fused_time_chain(...,
    probes=..., interpret=True)`` and ``jax.grad``, f64, rtol 1e-10.  The
    fused backward takes the z-streaming two-phase route with the probe
    cotangents injected."""
    import jax

    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    op = diffusion3d_op(dt=0.05, dtype="float64")
    shape, k = (12, 10, 16), 2
    arrays = _state3d(op, 3, shape)
    rng = np.random.default_rng(9)
    w = rng.standard_normal(shape)
    pw = [rng.standard_normal((k, shape[-1])) for _ in PROBES3D]
    jfn = jchain(jax_twin(op), k, HEAT_CARRY, probes=PROBES3D,
                 interpret=True, fused_bwd=fused_bwd)

    def jloss(st):
        out, recs = jfn(st)
        return ((out["u"] * w).sum()
                + sum((r * q).sum() for r, q in zip(recs, pw)))

    jst = {n: jnp.asarray(a) for n, a in arrays.items()}
    jout, jrecs = jfn(jst)
    jgrad = jax.grad(jloss)(jst)
    chain = fused_time_chain(op, k, HEAT_CARRY, probes=PROBES3D,
                             fused_bwd=fused_bwd)
    if fused_bwd:
        g = fused_chain_vjp(op, k, HEAT_CARRY, periodic=False,
                            probes=PROBES3D)
        assert g.route == "plane_two_phase"
    ins = {n: t.requires_grad_() for n, t in _t(arrays).items()}
    out, recs = chain(ins)
    loss = ((out["u"] * torch.tensor(w)).sum()
            + sum((r * torch.tensor(q)).sum() for r, q in zip(recs, pw)))
    grads = torch.autograd.grad(loss, [ins[n] for n in arrays])
    for n in arrays:
        _close(out[n], jout[n], 1e-10, f"state {n}")
    for r, jr in zip(recs, jrecs):
        assert tuple(r.shape) == (k, shape[-1])
        _close(r, jr, 1e-10, "probe line")
    for n, gr in zip(arrays, grads):
        _close(gr, jgrad[n], 1e-10, f"grad {n}")


def test_3d_periodic_chain_with_probes_raises_as_jax_does():
    """The JAX package refuses 3D periodic chains with probes; so does the
    port, saying so."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    op = diffusion3d_op(dt=0.05, dtype="float64")
    arrays = {n: jnp.asarray(a) for n, a in _state3d(op, 3).items()}
    with pytest.raises(ValueError, match="2D"):
        jchain(jax_twin(op), 2, HEAT_CARRY, periodic=True, probes=PROBES3D,
               interpret=True)(arrays)
    with pytest.raises(NotImplementedError, match="JAX package raises"):
        fused_time_chain(op, 2, HEAT_CARRY, periodic=True, probes=PROBES3D)
    with pytest.raises(NotImplementedError, match="JAX package raises"):
        fused_chain_vjp(op, 2, HEAT_CARRY, periodic=True, probes=PROBES3D)


def test_dtype_override_casts_the_chain():
    op = _wave()
    arrays = _state(["u_curr", "u_prev", "c"], seed=5)
    st = {n: t.float() for n, t in _t(arrays).items()}
    out = fused_time_chain(op, K, CARRY, dtype=torch.float64)(st)
    ref = fused_time_chain(op, K, CARRY)(_t(arrays))
    for n in out:
        assert out[n].dtype == torch.float64
        _close(out[n], ref[n].numpy(), 1e-6, n)


def test_routes_and_refusals():
    """Linear periodic ops without probes take the twin chains, periodic
    coefficient ops and bounded 3D linear ops the twin-with-accumulation
    kernel, the rest of 2D the two-phase kernel, a nonlinear 3D op the
    z-streaming two-phase kernel; 3D periodic probes and CPU tensors on the
    kernel wrappers raise."""
    assert fused_chain_vjp(_heat(), K, HEAT_CARRY).route == "twin"
    assert fused_chain_vjp(_heat(), K, HEAT_CARRY,
                           periodic=False).route == "two_phase"
    assert fused_chain_vjp(_wave(grad_c=False), K, CARRY).route == "twin"
    assert fused_chain_vjp(heat_step3d_op(dtype="float64"), K, HEAT_CARRY,
                           periodic=False).route == "twin_accum"
    u, out = Field("u", 3), Field("u_next", 3)
    nonlinear = AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")
    assert fused_chain_vjp(nonlinear, K, HEAT_CARRY,
                           periodic=False).route == "plane_two_phase"
    with pytest.raises(NotImplementedError, match="probes"):
        fused_time_chain(heat_step3d_op(dtype="float64"), K, HEAT_CARRY,
                         periodic=True, probes=[("u", 1)])
    plan = tc.chain_plan(_wave(), K, CARRY, False, [("u_curr", ROW)])
    cpu = _t(_state(["u_curr", "u_prev", "c"]))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tc.make_chain_kernel(plan)(cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ac.make_adjoint_kernel(ac.AdjointPlan(plan))(cpu, cpu)
    with pytest.raises(ValueError, match="carry target"):
        fused_time_chain(_wave(), K, {"nope": "u_next"})
    with pytest.raises(ValueError, match="must be scalar|not a state"):
        fused_time_chain(_wave(), K, CARRY, probes=[("u_next", 3)])


def test_carry_schedule_and_tile():
    """The pool schedule renames buffers for the carry (u_prev ← u_curr is
    free) and, for the two-phase kernel, keeps every stage's u_curr buffer
    live; the tile picker reckons the wave two-phase at k=4 in float32 and
    raises when nothing fits."""
    plan = tc.chain_plan(_wave(), K, CARRY, False)
    sbuf, obuf, npool = tc.carry_schedule(plan)
    keys = plan.plane_keys
    iu, ip = keys.index(("u_curr", ())), keys.index(("u_prev", ()))
    for s in range(K):
        assert sbuf[s + 1][ip] == sbuf[s][iu]  # the shift is a rename
        assert sbuf[s + 1][iu] == obuf[s][0]
    assert npool == 4
    ap = ac.AdjointPlan(plan)
    assert ap.saved_planes == (iu,)
    sbuf, _, npool = tc.carry_schedule(plan, ap.saved_planes)
    assert len({sbuf[s][iu] for s in range(K + 1)}) == K + 1
    assert npool == K + 2
    halo = [a + b for a, b in zip(plan.reach[0], ap.reach[0])]
    geo, ((ty, tx), _, smem) = tc.chain_geometry(
        plan, (8192, 8192), 4, halo_reach=(halo, halo),
        second_reach=ap.reach, keep=ap.saved_planes,
        extra_planes=2 * len(keys), blocks_per_sm=1)
    assert smem <= tc.SMEM_BUDGET and ty * tx >= 32 * 32
    assert (ty, tx) == (32, 64) and smem == 13 * 48 * 80 * 4
    with pytest.raises(ValueError, match="no chain tile"):
        tc.pick_tile([(64, 64)] * 2, 40, 8, (8192, 8192))


def test_generated_chain_sources():
    """The chain translation units (no nvcc here): wave's (dt·c)² is
    hoisted and read through ``c.rh``; the backward body and its wiring
    table read u_curr as a saved primal, ĉ's previous adjoint as zero."""
    plan = tc.chain_plan(_wave(), K, CARRY, False, [("u_curr", ROW)])
    src = generate_chain_source(plan)
    assert '#include "time_chain.cuh"' in src and "#define PSAT_NH 1" in src
    assert "c.rh(0)" in src and "struct PsatHoist" in src
    assert "#define PSAT_NS 3" in src and "#define PSAT_NOUT 1" in src
    ap = ac.AdjointPlan(plan)
    src = generate_adjoint_source(ap)
    assert '#include "adjoint_chain.cuh"' in src
    assert "struct PsatBwd " in src and "struct PsatBwdMeta" in src
    assert "static constexpr int prim(int j)" in src
    assert [] in ap.adj  # the accumulator-prev input reads zero
    assert ap.grad_slot.count(-1) == 0  # every state plane has a gradient


def _vector_op():
    v = Field("v", 2, index_shape=(2,), layout="soa")
    w = Field("w", 2, index_shape=(2,), layout="soa")
    c = Field("c", 2)
    return AutoDiffOp([
        Assignment(w.center(0), v[0, 0](0)
                   + 0.1 * c[0, 0] * (v[1, 0](1) - v[0, -1](0))),
        Assignment(w.center(1), v[0, 0](1)
                   - 0.1 * c[0, 1] * v[-1, 0](0) * v[0, 1](1)),
    ], op_name="vec_chain", time_constant_fields=[c])


# --------------------------------------------------------------------------
# On the card: the kernels themselves.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernels are compiled "
                    "with nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


# (id, op factory, carry, shape, probes)
KERNEL_CHAINS = [
    ("wave-odd", _wave, CARRY, (37, 45), [("u_curr", 5)]),
    ("wave-tall", _wave, CARRY, (131, 70), [("u_curr", 130)]),
    ("heat-odd", _heat, HEAT_CARRY, (45, 37), []),
    ("vector-soa", _vector_op, {"v": "w"}, (29, 40), []),
]


def _kernel_inputs(op, shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    from pystencils_autodiff_tpu_torch.ops.common import storage_shape
    out = {}
    for f in op.forward_input_fields:
        a = rng.standard_normal(storage_shape(f, shape))
        if f.name == "c":
            a = 2.0 + 0.1 * a ** 2
        out[f.name] = torch.tensor(a, dtype=dtype, device=device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CHAINS, ids=[c[0] for c in KERNEL_CHAINS])
def test_chain_kernels_match_plain_versions(case, dtype, periodic, tiles,
                                            cuda_device, monkeypatch):
    """Forward chain and two-phase kernels vs their plain versions on the
    same CUDA tensors, k = 3, ragged tiles (8×32 forced, or the picked
    tile); rtol 1e-12 in f64, 1e-5 with atol 1e-5·max|ref| in f32 (FMA
    contraction and summation order differ)."""
    if tiles == "small":
        monkeypatch.setattr(tc, "TILE_ROWS", (8,))
        monkeypatch.setattr(tc, "TILE_COLS", (32,))
    _, make_op, carry, shape, probes = case
    op = make_op()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = _kernel_inputs(op, shape, dtype, cuda_device, 1)
    cots = _kernel_inputs(op, shape, dtype, cuda_device, 2)
    pcs = tuple(torch.randn((3, shape[1]), dtype=dtype, device=cuda_device,
                            generator=torch.Generator(cuda_device)
                            .manual_seed(3)) for _ in probes)
    plan = tc.chain_plan(op, 3, carry, periodic, probes)
    ap = ac.AdjointPlan(plan)
    before = (tc.LAUNCHES, ac.LAUNCHES)
    got = tc.make_chain_kernel(plan)(st)
    got_adj = ac.make_adjoint_kernel(ap)(st, cots, pcs)
    torch.cuda.synchronize()
    assert (tc.LAUNCHES, ac.LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = tc.plain_time_chain(plan)(st)
    ref_adj = ac.plain_chain_vjp(ap)(st, cots, pcs)

    def check(a, b, scale=1.0):
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())

    for n in plan.invariant:  # returned as given, not written
        assert got[0][n] is st[n] and got_adj[0][n] is st[n]
    for n in ref[0]:
        check(got[0][n], ref[0][n])
        check(got_adj[0][n], ref_adj[0][n])
        check(got_adj[1][n], ref_adj[1][n], 10.0)  # k backward sums
    for a, b in zip(got[1], ref[1]):
        check(a, b)


KERNEL_CHAINS3D = [
    # (id, op factory, k, shape)
    ("diffusion3d-k2", lambda: diffusion3d_op(dt=0.05), 2, (11, 9, 37)),
    ("diffusion3d-k3", lambda: diffusion3d_op(dt=0.05), 3, (20, 33, 70)),
    ("heat3d-k4", heat_step3d_op, 4, (13, 17, 40)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CHAINS3D,
                         ids=[c[0] for c in KERNEL_CHAINS3D])
def test_chain_kernel_3d_matches_plain_version(case, dtype, periodic, tiles,
                                               cuda_device, monkeypatch):
    """The 3D forward chain kernel vs its plain version on the same CUDA
    tensors: the box design on ragged grids of several box tiles (2×4×32
    forced), or the march in the geometry it picks; rtol 1e-12 in f64,
    1e-5 with atol 1e-5·max|ref| in f32."""
    if tiles == "small":  # tiny boxes own little: lift the owned-share floor
        monkeypatch.setattr(tc, "TILE_DEPTH_3D", (2,))
        monkeypatch.setattr(tc, "TILE_ROWS_3D", (4,))
        monkeypatch.setattr(tc, "TILE_COLS_3D", (32,))
        monkeypatch.setattr(tc, "MIN_OWNED_SHARE", 0.0)
    _, make_op, k, shape = case
    op = make_op()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = {n: t.to(dtype) for n, t in
          _t(_state3d(op, 1, shape), cuda_device).items()}
    plan = tc.chain_plan(op, k, HEAT_CARRY, periodic)
    before = tc.LAUNCHES
    got, _ = tc.make_chain_kernel(
        plan, "box" if tiles == "small" else "march")(st)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    ref, _ = tc.plain_time_chain(plan)(st)
    for n in plan.invariant:  # κ: returned as given, not written
        assert got[n] is st[n]
    for n in ref:
        torch.testing.assert_close(got[n], ref[n], rtol=tol,
                                   atol=tol * ref[n].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", VJPS, ids=[c[0] for c in VJPS])
def test_fused_chain_vjp_kernel_matches_jax(case, cuda_device):
    """``fused_chain_vjp`` on CUDA tensors (the two-phase kernel, the twin
    forward chains or the twin-with-accumulation kernel) vs the JAX
    package's values, float64, rtol 1e-10."""
    _, name, carry, periodic, probes, _ = case
    op, names, arrays, cots, pcots = _vjp_case(case)
    before = tc.LAUNCHES + ac.LAUNCHES + ta.LAUNCHES
    g = fused_chain_vjp(op, K, carry, periodic=periodic,
                        probes=probes or None)
    st, cot0 = g(_t(arrays, cuda_device), _t(cots, cuda_device),
                 tuple(torch.tensor(p, device=cuda_device) for p in pcots))
    torch.cuda.synchronize()
    assert tc.LAUNCHES + ac.LAUNCHES + ta.LAUNCHES > before
    jst, jcot0 = _jax_vjp(case, arrays, cots, pcots)
    for n in names:
        _close(st[n], jst[n], 1e-10, f"state {n}")
        _close(cot0[n], jcot0[n], 1e-10, f"cot {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multi_carrier_kernel_matches_plain_version(dtype, periodic,
                                                    cuda_device):
    """Kernel 8 on an output carried into two state fields vs its plain
    version on the same CUDA tensors, k=2, ragged 37×45 grid; rtol 1e-12 in
    f64, 1e-5 with atol 1e-5·max|ref| in f32 (×10 on the cotangents)."""
    op = _multi_carrier()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = _kernel_inputs(op, (37, 45), dtype, cuda_device, 1)
    cots = _kernel_inputs(op, (37, 45), dtype, cuda_device, 2)
    ap = ac.AdjointPlan(tc.chain_plan(op, 2, MULTI, periodic))
    before = ac.LAUNCHES
    got = ac.make_adjoint_kernel(ap)(st, cots)
    torch.cuda.synchronize()
    assert ac.LAUNCHES == before + 1
    ref = ac.plain_chain_vjp(ap)(st, cots)
    for i, scale in ((0, 1.0), (1, 10.0)):
        for n in ref[i]:
            torch.testing.assert_close(
                got[i][n], ref[i][n], rtol=scale * tol,
                atol=scale * tol * ref[i][n].abs().max().item())


@pytest.mark.cuda
def test_fwi_gradient_on_the_card_matches_cpu(cuda_device):
    """The FWI gradient through both chain kernels equals the CPU run of
    the plain versions, float64."""
    u0, c, obs = _fwi_inputs(seed=2)
    args = [torch.tensor(a) for a in (c, u0, obs)]
    v, g = fwi_gradient(*args, ROW, 8, dt=0.2, fused_k=4)
    vc, gc = fwi_gradient(*(a.to(cuda_device) for a in args), ROW, 8,
                          dt=0.2, fused_k=4)
    _close(vc, v.numpy(), 1e-10, "value")
    _close(gc, g.numpy(), 1e-10, "gradient")


@pytest.mark.cuda
def test_unsupported_dtype_raises_on_the_card(cuda_device):
    plan = tc.chain_plan(_wave(), K, CARRY, False)
    st = _kernel_inputs(_wave(), SHAPE, torch.float16, cuda_device, 0)
    with pytest.raises(NotImplementedError,
                       match="float32, float64 or bfloat16"):
        tc.make_chain_kernel(plan)(st)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segmented_two_phase_on_the_card(dtype, cuda_device, monkeypatch):
    """Where the reckoning finds no k-deep two-phase march (one 16-column
    strip of 1 row a step, and the shared memory cut to what its 2-deep
    march needs), ``fused_chain_vjp`` runs 2 segments: 1 forward chain
    launch for the checkpoint and 2 two-phase launches, equal to the plain
    k-deep version (rtol 1e-12 in f64; 1e-5, ×10 on the cotangents, in
    f32)."""
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm

    monkeypatch.setattr(sm, "STRIP_COLS", (16,))
    monkeypatch.setattr(sm, "CHUNKS_2D", (1,))
    op, shape, probes = _wave(), (131, 70), [("u_curr", 60)]
    plan = tc.chain_plan(op, K, CARRY, False, probes)
    sp, sap = sm.chain_march_plans(ac.plan_at_depth(plan, K // 2))
    need = sm.stage_march_geometry(sp, shape, dtype.itemsize, sap).smem
    monkeypatch.setattr(sm, "SMEM_BUDGET", need)
    assert ac.two_phase_segments(plan, shape, dtype.itemsize) == 2
    st = _kernel_inputs(op, shape, dtype, cuda_device, 5)
    cots = _kernel_inputs(op, shape, dtype, cuda_device, 6)
    pcs = (torch.randn((K, shape[1]), dtype=dtype, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(7)),)
    g = fused_chain_vjp(op, K, CARRY, periodic=False, probes=probes)
    before = (tc.LAUNCHES, ac.LAUNCHES)
    got = g(st, cots, pcs)
    torch.cuda.synchronize()
    assert g.segments == 2
    assert (tc.LAUNCHES, ac.LAUNCHES) == (before[0] + 1, before[1] + 2)
    ref = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots, pcs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b, scale in [(got[0][n], ref[0][n], 1.0) for n in ref[0]] + [
            (got[1][n], ref[1][n], 10.0) for n in ref[1]]:
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())


def _bf16_cases():
    """(id, kind, runners factory, op, carry, shape, periodic, probes, k)
    of each chain kernel family; kind: "fwd" (state), "vjp" (state,
    cotangents, probe cotangents) or "twin" (state, cotangents)."""
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa

    u, out = Field("u", 3), Field("u_next", 3)
    nl3d = AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")

    def fwd(plan):
        kern = (pa.make_plane_chain_kernel(plan) if plan.op is nl3d
                else tc.make_chain_kernel(plan))
        return kern, tc.plain_time_chain(plan)

    def two_phase(plan):
        ap = ac.AdjointPlan(plan)
        kern = (pa.make_plane_adjoint_kernel(ap) if plan.program.ndim == 3
                else ac.make_adjoint_kernel(ap))
        return kern, ac.plain_chain_vjp(ap)

    def twin(plan):
        carry = {n: s for n, s in plan.next_src.items() if s != n}
        tp = ac.fused_chain_vjp(plan.op, plan.k, carry,
                                periodic=plan.periodic).plan
        return ta.make_twin_accum_kernel(tp), ta.plain_twin_accum_vjp(tp)

    wave, d3 = wave_step_op(dt=0.2), diffusion3d_op(dt=0.05)
    return [
        ("time_chain-2d", "fwd", fwd, wave, CARRY, (131, 70), False,
         [("u_curr", 60)], 3),
        ("time_chain-3d", "fwd", fwd, d3, HEAT_CARRY, (11, 9, 37), False,
         [("u", 40)], 2),
        ("adjoint_chain-2d", "vjp", two_phase, wave, CARRY, (131, 70), False,
         [("u_curr", 60)], 3),
        ("twin_accum-2d", "twin", twin, wave, CARRY, (64, 70), True, [], 2),
        ("twin_accum-3d", "twin", twin, d3, HEAT_CARRY, (11, 9, 37), False,
         [], 2),
        ("plane-forward", "fwd", fwd, nl3d, HEAT_CARRY, (11, 9, 37), False,
         [("u", 40)], 2),
        ("plane-two_phase", "vjp", two_phase, nl3d, HEAT_CARRY, (11, 9, 37),
         False, [("u", 40)], 2),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(7))
def test_chain_kernels_in_bf16(idx, cuda_device):
    """Each chain kernel family on bf16 state (stored bf16, computed and
    tiled in float) vs its plain version in f32 on the same bf16-rounded
    inputs: every output within 0.05 of max |ref|, in bf16."""
    name, kind, make, op, carry, shape, periodic, probes, k = \
        _bf16_cases()[idx]
    plan = tc.chain_plan(op, k, carry, periodic, probes)
    kern, plain = make(plan)
    bf = torch.bfloat16
    args = [_kernel_inputs(op, shape, bf, cuda_device, 11)]
    if kind != "fwd":
        args.append(_kernel_inputs(op, shape, bf, cuda_device, 12))
    if kind == "vjp":
        gen = torch.Generator(cuda_device).manual_seed(13)
        args.append(tuple(torch.randn((k, shape[-1]), device=cuda_device,
                                      generator=gen).to(bf)
                          for _ in probes))
    got = kern(*args)
    torch.cuda.synchronize()
    ref = plain(*[{n: t.float() for n, t in a.items()} if isinstance(a, dict)
                  else tuple(t.float() for t in a) for a in args])

    def flat(r):
        if isinstance(r, dict):
            return [r[n] for n in sorted(r)]
        if isinstance(r, (list, tuple)):
            return [t for q in r for t in flat(q)]
        return [r]

    for a, b in zip(flat(got), flat(ref)):
        assert a.dtype == bf, name
        assert (a.float() - b).abs().max() <= 0.05 * b.abs().max(), name
