"""The port's examples (``examples/torch_port/``) against the same flows
written here with the JAX package's API, in float64 on the CPU.

The JAX scripts of ``examples/`` run their whole flow at import, so each
flow is written out below; both sides take the same inputs, made from a
seed with numpy, at reduced step counts.  The JAX side runs its default
lowering (jnp).  ``torch.optim.Adam`` and ``optax.adam`` compute the
same update in another order: trajectories agree to round-off over the
few steps compared here.  The sharded examples are in
``test_torch_examples_sharded.py``, the native-operator training in
``test_torch_examples_native.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pystencils_autodiff_tpu import models as jmodels
from pystencils_autodiff_tpu.boundary import BoundaryHandling as JBH
from pystencils_autodiff_tpu.graph_datahandling import \
    GraphDataHandling as JGDH
from pystencils_autodiff_tpu.models.lbm import d2q9_bgk_op as jd2q9
from pystencils_autodiff_tpu.models.lbm import macroscopic as jmacroscopic
from pystencils_autodiff_tpu.models.phasefield import \
    cahn_hilliard_stages as jch_stages
from pystencils_autodiff_tpu.ops.stage_chain import \
    stage_stepper as jstage_stepper
from pystencils_autodiff_tpu.timeloop import \
    make_time_stepper as jmake_time_stepper
from torch_jax_twin import jax_twin
from chip_smoke import example_module as example

from pystencils_autodiff_tpu_torch.models import fwi_gradient

F64 = torch.float64


def _rng(seed):
    return np.random.default_rng(seed)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, ref, rtol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


# ------------------------------------------------------------------ heat --

def test_heat_inverse_problem_adam_matches_optax():
    """κ after 30 Adam steps against optax.adam through the JAX op."""
    ex = example("heat_inverse_problem")
    rng = _rng(0)
    u0 = rng.standard_normal((16, 16))
    k_true = 1.0 + 0.5 / (1 + np.exp(-rng.standard_normal((16, 16))))
    _, k = ex.run(torch.tensor(u0), torch.tensor(k_true), steps=30)

    f = jax.jit(jax_twin(ex.make_op()).jax_function())
    target = f(u=jnp.asarray(u0), kappa=jnp.asarray(k_true))

    def loss(kk):
        return jnp.mean((f(u=jnp.asarray(u0), kappa=kk) - target) ** 2)

    opt = optax.adam(ex.LR)
    kj = jnp.ones((16, 16))
    state = opt.init(kj)
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(30):
        _, g = vg(kj)
        up, state = opt.update(g, state)
        kj = optax.apply_updates(kj, up)
    _close(k, kj, 1e-9, "kappa")


def test_heat_probes_match_the_jax_package():
    """P1–P5: the same exception types and messages as the JAX op's."""
    ex = example("heat_inverse_problem")
    u0 = torch.tensor(_rng(1).standard_normal((16, 16)))
    got = ex.probes(u0, u0)
    assert got["P5 mixed args"][0] is TypeError
    assert got["P4 off-centre write"][0] is ValueError
    from pystencils_autodiff_tpu import Assignment as JA
    from pystencils_autodiff_tpu import AssignmentCollection as JAC
    from pystencils_autodiff_tpu import fields as jfields
    ju, jout, _ = jfields("u, out, kappa", 2)
    f = jax_twin(ex.make_op()).jax_function()
    a = jnp.asarray(_np(u0))
    calls = {
        "P1 wrong-arity": lambda: f(a),
        "P2 bogus kwarg": lambda: f(u=a, kappa=a, bogus=a),
        "P3 half offset": lambda: ju[0.5, 0],
        "P4 off-centre write": lambda: JAC([JA(jout[1, 0], ju[0, 0])]),
        "P5 mixed args": lambda: f(a, kappa=a),
    }
    for name, call in calls.items():
        try:
            call()
        except (TypeError, KeyError, ValueError) as e:
            assert got[name] == (type(e), str(e)), name
        else:
            raise AssertionError(f"{name}: the JAX op did not raise")


# ------------------------------------------------------------------- FWI --

def test_fwi_seismogram_and_gradient_match():
    """The observed seismogram (rtol 1e-12) and one sqrt-checkpointed
    ``fwi_gradient`` value and gradient at 24², 40 steps (rtol 1e-10), at
    a velocity model perturbed from c = 2 by a seeded field."""
    ex = example("fwi_inversion")
    steps = 40
    _, c_true, u0, observed = ex.setup(steps=steps)
    _, jobs = jmodels.wave_simulate(
        jnp.asarray(_np(c_true)), jnp.asarray(_np(u0)), steps, dt=ex.DT,
        checkpoint="none", record=lambda s: s["u_curr"][ex.ROW, :])
    _close(observed, jobs, 1e-12, "seismogram")
    c = 2.0 + 0.05 * _rng(2).standard_normal((ex.N, ex.N))
    v, g = fwi_gradient(torch.tensor(c), u0, observed, ex.ROW, steps,
                        dt=ex.DT, checkpoint="sqrt")
    jv, jg = jmodels.fwi_gradient(jnp.asarray(c), jnp.asarray(_np(u0)),
                                  jobs, ex.ROW, steps, dt=ex.DT,
                                  checkpoint="sqrt")
    _close(v, jv, 1e-10, "value")
    _close(g, jg, 1e-10, "gradient")


def test_fwi_elastic_pair_matches():
    """50 velocity/stress steps at 32² from the example's source (rtol
    1e-12)."""
    ex = example("fwi_inversion")
    state = ex.elastic()
    fv = jmodels.elastic_velocity_op(dt=0.01, dtype="float64").jax_function()
    fs = jmodels.elastic_stress_op(dt=0.01, dtype="float64").jax_function()
    js = {k: jnp.zeros(ex.ELASTIC_SHAPE) for k in ex.ELASTIC}
    js["sxx"] = js["sxx"].at[16, 16].set(1.0)
    js["syy"] = js["syy"].at[16, 16].set(1.0)
    for _ in range(ex.ELASTIC_STEPS):
        js["vx"], js["vy"] = fv(**js)
        js["sxx"], js["syy"], js["sxy"] = fs(**js)
    for k in ex.ELASTIC:
        _close(state[k], js[k], 1e-12, k)


# ---------------------------------------------------------------- cavity --

def _jax_cavity(n):
    op = jd2q9(omega=1.7)
    solid = np.zeros((n, n), bool)
    solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = True
    solid = jnp.asarray(solid)

    def run(u_lid, f0, n_steps):
        lid = jnp.zeros((n, n)).at[0, :].set(1.0) * u_lid
        bh = JBH(op, {"f": ("bounce_back", solid, (jnp.zeros((n, n)), lid))})
        step = jmake_time_stepper(op, {"f": "f_out"}, boundary=bh)
        return jax.lax.fori_loop(0, n_steps, lambda _, s: step(s),
                                 {"f": f0})["f"]

    def v1(f):
        _, _, v = jmacroscopic(f + 1e-30)
        return jnp.where(solid, 0.0, v)

    return run, v1


def test_cavity_stepper_gradient_and_fused_chain_match():
    """From a seeded perturbation of the equilibrium start: 200 stepper
    steps (rtol 1e-12), the recovery loss's u_lid gradient over 50 steps
    (rtol 1e-10), and the fused chain (2 calls, k=2, fused backward)
    against the JAX stepper (1e-12), its u_lid gradient against the JAX
    stepper's (rtol 1e-10)."""
    ex = example("lbm_cavity")
    n, m, mg = 24, 200, 50
    cav = ex.Cavity(n)
    f0 = cav.f_eq0 * (1 + 0.01 * torch.tensor(
        _rng(3).standard_normal((n, n, 9))))
    jrun, jv1 = _jax_cavity(n)
    jf0 = jnp.asarray(_np(f0))
    with torch.no_grad():
        f = cav.run(ex.U_LID_TRUE, f0, m)
    jf = jax.jit(jrun, static_argnums=2)(ex.U_LID_TRUE, jf0, m)
    _close(f, jf, 1e-12, "stepper state")

    target = cav.fluid_v1(f)
    ul = cav.lid(ex.U_START).requires_grad_()
    val = torch.sum((cav.fluid_v1(cav.run(ul, f0, mg)) - target) ** 2)
    (g,) = torch.autograd.grad(val, ul)
    jtarget = jv1(jf)
    jval, jg = jax.jit(jax.value_and_grad(
        lambda u: jnp.sum((jv1(jrun(u, jf0, mg)) - jtarget) ** 2)))(
            ex.U_START)
    _close(val, jval, 1e-10, "loss")
    _close(g, jg, 1e-10, "u_lid gradient")

    with torch.no_grad():
        f_fus = cav.run_fused(ex.U_LID_TRUE, f0, 2)
    _close(f_fus, jrun(ex.U_LID_TRUE, jf0, 2 * ex.K), 1e-12, "fused state")
    ul = cav.lid(ex.U_LID_TRUE).requires_grad_()
    (gf,) = torch.autograd.grad(torch.sin(cav.run_fused(ul, f0, 2)).sum(),
                                ul)
    jgs = jax.grad(lambda u: jnp.sum(jnp.sin(jrun(u, jf0, 2 * ex.K))))(
        ex.U_LID_TRUE)
    _close(gf, jgs, 1e-10, "fused u_lid gradient")


# ------------------------------------------------------------- spinodal --

def test_spinodal_replay_fused_and_bracket_match():
    """Replay and the fused stage chain (k=2) against the JAX replay
    (1e-12), and the three bracket misfits (rtol 1e-10), at 32², 10
    cycles."""
    ex = example("phasefield_spinodal")
    n, cycles = 32, 10
    phi0 = 0.1 * _rng(4).standard_normal((n, n))
    dh = ex.record(torch.tensor(phi0))
    run_replay, run_fused = ex.compiled(dh)
    st = dh.state()
    with torch.no_grad():
        out_r = run_replay(st, ex.K * cycles)
        out_f = run_fused(st, ex.K * cycles)

    jd = JGDH((n, n), ghost_layers=0, default_dtype=jnp.float64)
    jd.add_field("phi", init=0.0)
    jd.add_field("mu", init=0.0)
    jd.set_array("phi", jnp.asarray(phi0))
    with jd.timeloop() as loop:
        for op, carry in jch_stages(dt=ex.DT, mobility=1.0):
            loop.sweep(op, carry)
        loop.communicate("phi")
    assert dh.graph.describe() == jd.graph.describe()
    jst = jd.state()
    jout = jd.compile(periodic=True)(jst, ex.K * cycles)
    _close(out_r["phi"], jout["phi"], 1e-12, "replay")
    _close(out_f["phi"], jout["phi"], 1e-12, "fused")

    with torch.no_grad():
        vals = ex.bracket(st, out_r["phi"], ex.K * cycles)

    def jtraj(mob):
        steps = [jstage_stepper(op, carry, periodic=True)
                 for op, carry in jch_stages(dt=ex.DT * mob)]
        s = dict(jst)
        for _ in range(ex.K * cycles):
            for stp in steps:
                s = stp(s)
        return s["phi"]

    for mob in ex.MOBILITIES:
        ref = float(jnp.mean((jtraj(mob) - jout["phi"]) ** 2))
        if mob == 1.0:
            assert vals[mob] < 1e-28
        else:
            np.testing.assert_allclose(vals[mob], ref, rtol=1e-10)
