"""The port's time loop (``timeloop.py``), boundary handling
(``boundary.py``) and wave model (``models/wave.py``) against the JAX
package, in float64 on the CPU: values and gradients.  Inputs are made
from a seed with numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu import boundary as jbc
from pystencils_autodiff_tpu_torch import boundary as tbc
from pystencils_autodiff_tpu_torch.models import (heat_step_op, wave_simulate,
                                                  wave_step_op)
from pystencils_autodiff_tpu_torch.timeloop import (Timeloop,
                                                    make_time_stepper,
                                                    run_timeloop)

SHAPE, ROW, N_STEPS = (20, 16), 7, 7
RTOL = 1e-12


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _wave_inputs(seed=0):
    rng = np.random.default_rng(seed)
    u0 = 0.1 * rng.standard_normal(SHAPE)
    c = 2.0 + 0.1 * rng.standard_normal(SHAPE) ** 2
    w = rng.standard_normal(SHAPE)
    return u0, c, w


def _jax_wave(u0, c, w, checkpoint, record):
    """Final u_curr, seismogram and d(loss)/dc of the JAX wave_simulate."""
    from pystencils_autodiff_tpu.models.wave import wave_simulate as jsim

    rec = (lambda s: s["u_curr"][ROW]) if record else None

    def loss(c_):
        res = jsim(c_, jnp.asarray(u0), N_STEPS, dt=0.2,
                   checkpoint=checkpoint, record=rec, lowering="jnp")
        final, seis = res if record else (res, None)
        val = jnp.sum(final["u_curr"] * w)
        if record:
            val = val + jnp.sum(seis ** 2)
        return val, (final["u_curr"], seis)

    (_, (fin, seis)), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(c))
    return np.asarray(fin), None if seis is None else np.asarray(seis), g


def _port_wave(u0, c, w, checkpoint, record):
    c_ = torch.tensor(c, requires_grad=True)
    rec = (lambda s: s["u_curr"][ROW]) if record else None
    res = wave_simulate(c_, torch.tensor(u0), N_STEPS, dt=0.2,
                        checkpoint=checkpoint, record=rec)
    final, seis = res if record else (res, None)
    val = (final["u_curr"] * torch.tensor(w)).sum()
    if record:
        val = val + (seis ** 2).sum()
    (g,) = torch.autograd.grad(val, c_)
    return final["u_curr"].detach(), seis, g


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("checkpoint", ["none", "step", "sqrt"])
def test_run_timeloop_modes_match_each_other_and_jax(checkpoint, record):
    """``run_timeloop`` in every checkpoint mode, with and without
    ``record``, through ``wave_simulate``: final state, seismogram and the
    gradient w.r.t. c equal the port's ``"none"`` run and JAX's
    ``run_timeloop`` in the same mode (7 steps: sqrt runs 3 checkpointed
    chunks of 2 and a remainder of 1)."""
    u0, c, w = _wave_inputs()
    got = _port_wave(u0, c, w, checkpoint, record)
    base = _port_wave(u0, c, w, "none", record)
    ref = _jax_wave(u0, c, w, checkpoint, record)
    for g, b, r, what in zip(got, base, ref, ("final", "seis", "grad c")):
        if r is None:
            assert g is None
            continue
        _close(g, b.detach().numpy(), RTOL, what + " vs none")
        _close(g, r, 1e-10, what + " vs JAX")


def test_wave_simulate_fused_k_matches_unfused():
    u0, c, _ = _wave_inputs(1)
    a = wave_simulate(torch.tensor(c), torch.tensor(u0), 8, dt=0.2,
                      fused_k=4, checkpoint="none")
    b = wave_simulate(torch.tensor(c), torch.tensor(u0), 8, dt=0.2,
                      checkpoint="none")
    for n in ("u_curr", "u_prev", "c"):
        _close(a[n], b[n].numpy(), RTOL, n)
    with pytest.raises(ValueError, match="multiple of fused_k"):
        wave_simulate(torch.tensor(c), torch.tensor(u0), 6, fused_k=4)
    with pytest.raises(ValueError, match="recording"):
        wave_simulate(torch.tensor(c), torch.tensor(u0), 8, fused_k=4,
                      record=lambda s: s["u_curr"][0])


def test_stepper_with_boundary_and_timeloop_class():
    """A heat stepper with a Neumann frame fill before each step, through
    ``Timeloop`` with sqrt checkpointing: values and gradient vs the JAX
    ``Timeloop``."""
    from pystencils_autodiff_tpu.models.heat import heat_step_op as jheat
    from pystencils_autodiff_tpu.timeloop import Timeloop as JTimeloop

    rng = np.random.default_rng(2)
    u = rng.standard_normal(SHAPE)
    k = 1.0 + 0.1 * rng.standard_normal(SHAPE) ** 2
    carry = {"u": "u_next"}
    op = heat_step_op(kappa_field=True, dtype="float64")
    jop = jheat(kappa_field=True, dtype="float64")
    loop = Timeloop(op, carry, boundary=tbc.BoundaryHandling(op, {"u": "neumann"}),
                    checkpoint="sqrt")
    jloop = JTimeloop(jop, carry, boundary=jbc.BoundaryHandling(jop, {"u": "neumann"}),
                      checkpoint="sqrt")
    k_ = torch.tensor(k, requires_grad=True)
    out = loop({"u": torch.tensor(u), "kappa": k_}, 5)
    (g,) = torch.autograd.grad((out["u"] ** 2).sum(), k_)

    def jloss(kk):
        o = jloop({"u": jnp.asarray(u), "kappa": kk}, 5)
        return jnp.sum(o["u"] ** 2), o["u"]

    (_, ju), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(k))
    _close(out["u"], ju, 1e-10, "u")
    _close(g, jg, 1e-10, "grad kappa")
    with pytest.raises(ValueError, match="carry source"):
        make_time_stepper(op, {"u": "nope"})
    with pytest.raises(ValueError, match="checkpoint must be"):
        run_timeloop(loop.step, {"u": torch.tensor(u)}, 2, checkpoint="all")


_GHOST = ((1, 2), (2, 1))
_MASK = np.zeros(SHAPE, bool)
_MASK[5:9, 4:10] = True
_MASK[0, :] = True


def _d2q9_inputs(rng):
    f = rng.standard_normal(SHAPE + (9,))
    u_lid = (rng.standard_normal(SHAPE), 0.3)
    return f, u_lid


# (id, fn(module, arr, rng_arrays) -> array); the same call on both modules
BCS = [
    ("dirichlet", lambda m, a, x: m.dirichlet(a, _GHOST, 0.5)),
    ("dirichlet-dims", lambda m, a, x: m.dirichlet(a, _GHOST, dims=[1])),
    ("neumann", lambda m, a, x: m.neumann(a, _GHOST)),
    ("periodic", lambda m, a, x: m.periodic(a, _GHOST)),
    ("masked_dirichlet", lambda m, a, x: m.masked_dirichlet(a, _MASK, x[0])),
    ("masked_neumann", lambda m, a, x: m.masked_neumann(a, _MASK)),
    ("sponge", lambda m, a, x: m.sponge(a, m.cerjan_damping(
        SHAPE, 4, alpha=0.2, free=[(0, 0)], dtype=a.dtype,
        **({"device": a.device} if m is tbc else {})))),
]


def _as(mod, a):
    return torch.tensor(a) if mod is tbc else jnp.asarray(a)


@pytest.mark.parametrize("case", BCS, ids=[c[0] for c in BCS])
def test_boundary_functions_match_jax(case):
    """Each frame and masked BC: values and the VJP of ⟨w, bc(a)⟩ w.r.t. a
    (e.g. a Neumann fill accumulates ghost gradients into edge cells)."""
    _, fn = case
    rng = np.random.default_rng(3)
    a, w = rng.standard_normal(SHAPE), rng.standard_normal(SHAPE)
    extra = [rng.standard_normal(SHAPE)]
    at = torch.tensor(a, requires_grad=True)
    out = fn(tbc, at, [torch.tensor(x) for x in extra])
    (g,) = torch.autograd.grad((out * torch.tensor(w)).sum(), at)
    jout, vjp = jax.vjp(lambda aa: fn(jbc, aa, [jnp.asarray(x)
                                                for x in extra]),
                        jnp.asarray(a))
    (jg,) = vjp(jnp.asarray(w))
    _close(out, jout, RTOL, "value")
    _close(g, jg, RTOL, "vjp")
    assert not torch.equal(out.detach(), at.detach())


@pytest.mark.parametrize("wrap", [False, True])
def test_bounce_back_matches_jax(wrap):
    """D2Q9 bounce-back with a moving lid: values and the gradient w.r.t.
    the populations and the wall velocity."""
    rng = np.random.default_rng(4)
    f, (ux, uy) = _d2q9_inputs(rng)
    w = rng.standard_normal(SHAPE + (9,))
    ft = torch.tensor(f, requires_grad=True)
    uxt = torch.tensor(ux, requires_grad=True)
    out = tbc.bounce_back(ft, _MASK, u_wall=(uxt, uy), wrap=wrap)
    gf, gu = torch.autograd.grad((out * torch.tensor(w)).sum(), [ft, uxt])
    jout, vjp = jax.vjp(lambda ff, uu: jbc.bounce_back(
        ff, _MASK, u_wall=(uu, uy), wrap=wrap), jnp.asarray(f),
        jnp.asarray(ux))
    jgf, jgu = vjp(jnp.asarray(w))
    _close(out, jout, RTOL, "value")
    _close(gf, jgf, RTOL, "grad f")
    _close(gu, jgu, RTOL, "grad u_wall")


def test_boundary_handling_chains_specs():
    """A spec list (frame fill, then a masked BC) and a kwargs dict, as in
    the JAX ``BoundaryHandling``."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(SHAPE)
    specs = {"u": ["neumann", ("masked_dirichlet", _MASK, 0.25)],
             "v": ("dirichlet", 1.5)}
    got = tbc.BoundaryHandling(_GHOST, specs)(
        {"u": torch.tensor(a), "v": torch.tensor(a)})
    ref = jbc.BoundaryHandling(_GHOST, specs)(
        {"u": jnp.asarray(a), "v": jnp.asarray(a)})
    for n in ("u", "v"):
        _close(got[n], ref[n], RTOL, n)
    op = wave_step_op(dtype="float64")
    assert tbc.BoundaryHandling(op, {}).ghost == ((1, 1), (1, 1))
    with pytest.raises(ValueError, match="unknown BC"):
        tbc.BoundaryHandling(_GHOST, {"u": "reflective"})


def test_cerjan_damping_builds_on_the_card_unless_told():
    """Like every entry point of the port, the damping profile is built on
    the card unless the caller names a device; on a host without one, the
    default raises instead of handing back a CPU tensor."""
    prof = tbc.cerjan_damping((12, 10), 3, alpha=0.2, dtype=torch.float64,
                              device="cpu")
    assert prof.device.type == "cpu" and prof.dtype == torch.float64
    ref = jbc.cerjan_damping((12, 10), 3, alpha=0.2, dtype=jnp.float64)
    np.testing.assert_allclose(prof.numpy(), np.asarray(ref), rtol=1e-15)
    if torch.cuda.is_available():
        assert tbc.cerjan_damping((12, 10), 3).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tbc.cerjan_damping((12, 10), 3)
