"""The twin-with-accumulation adjoint chains of the port
(``ops.twin_adjoint``) and the 3D fused chains of BASELINE config #2
against the JAX package, in float64 on the CPU.

The JAX side runs as its own tests run it: ``fused_chain_vjp`` and
``fused_time_chain`` with ``interpret=True`` (its twin-accum and plane
kernels in interpret mode), on the op rebuilt from the JAX package's own
constructors (``torch_jax_twin.jax_twin``).  On CPU tensors the port runs
the plain versions (k plain forward steps, then k plain backward steps),
so these tests hold the semantics the CUDA kernel is compared with on the
card; the ``cuda``-marked tests compare the kernel itself (skipped without
a card).  Inputs are made from a seed with numpy; rtol 1e-10, ghost cells
included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_twin_source
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step3d_op,
                                                  heat_step_op, wave_step_op)
from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from torch_jax_twin import jax_twin

RTOL = 1e-10
WAVE = {"u_curr": "u_next", "u_prev": "u_curr"}
UC = {"u": "u_next"}
S3 = (12, 10, 16)


def _nonlinear3d():
    u, out = Field("u", 3, dtype="float64"), Field("u_next", 3,
                                                   dtype="float64")
    return AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")


def _shifted_coeff():
    """u' = u + c[1,0]·u: the κ gradient reads u one row above the
    forward stencil's reach."""
    u, c, out = Field("u", 2), Field("c", 2), Field("u_next", 2)
    return AutoDiffOp([Assignment(out.center, u[0, 0] + 0.1 * c[1, 0]
                                  * u[0, 0])], op_name="shifted_coeff",
                      time_constant_fields=[c])


OPS = {
    "wave": lambda: wave_step_op(dt=0.2, dtype="float64"),
    "kheat": lambda: heat_step_op(dt=0.1, kappa_field=True, dtype="float64"),
    "heat": lambda: heat_step_op(dt=0.1, dtype="float64"),
    "diffusion3d": lambda: diffusion3d_op(dt=0.05, dtype="float64"),
    "diffusion3d_kfrozen": lambda: diffusion3d_op(dt=0.05, dtype="float64",
                                                  grad_kappa=False),
    "heat3d": lambda: heat_step3d_op(dtype="float64"),
    "nl3d": _nonlinear3d,
}
CARRY = {"wave": WAVE}


def _state(op, shape, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f in op.forward_input_fields:
        a = 0.5 * rng.standard_normal(storage_shape(f, shape))
        if f.name in ("c", "kappa"):
            a = 1.0 + 0.2 * a ** 2
        out[f.name] = a
    return out


def _t(arrays, device="cpu"):
    return {n: torch.tensor(a, dtype=torch.float64, device=device)
            for n, a in arrays.items()}


def _close(got, ref, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


# --------------------------------------------------------------------------
# The decomposition and the routes.

@pytest.mark.parametrize("name,periodic", [
    ("wave", True), ("kheat", True), ("diffusion3d", False),
    ("diffusion3d", True), ("heat3d", False), ("diffusion3d_kfrozen", False)])
def test_state_coeff_twin_matches_jax(name, periodic):
    """The port's copy of ``state_coeff_twin`` builds the JAX package's
    pieces: the coefficient and saved fields, the cotangent op and carry,
    and the grad program's signature."""
    from pystencils_autodiff_tpu.ops.twin_adjoint import \
        state_coeff_twin as jtwin

    op = OPS[name]()
    carry = CARRY.get(name, UC)
    allow = op.forward_input_fields[0].spatial_dimensions == 3 and not periodic
    mine = ta.state_coeff_twin(op, carry, allow_no_coeff=allow)
    ref = jtwin(jax_twin(op), carry, allow_no_coeff=allow)
    for key in ("coeff_names", "saved_names", "plain_reads", "cot_carry",
                "name_of", "declared_const", "view_of", "masked_views"):
        assert mine[key] == ref[key], key
    assert ([str(a) for a in mine["cot_op"].forward_assignments]
            == [str(a) for a in ref["cot_op"].forward_assignments])
    if ref["grad_prog"] is None:
        assert mine["grad_prog"] is None
    else:
        assert mine["grad_prog"].input_names == ref["grad_prog"].input_names
        assert mine["grad_prog"].output_names == ref["grad_prog"].output_names
        assert ([str(s.rhs) for s in mine["grad_prog"].steps]
                == [str(s.rhs) for s in ref["grad_prog"].steps])


def _jax_route(op, k, carry, periodic, probes, shape, monkeypatch):
    """The kernel the JAX package's interpret path picks for this call,
    recorded by replacing its kernel builders."""
    from pystencils_autodiff_tpu.ops import adjoint_chain as jac
    from pystencils_autodiff_tpu.ops import plane_adjoint, twin_adjoint

    jop = jax_twin(op)
    if periodic and not probes and jac.transposed_linear_op(
            jop, carry) is not None:
        return "twin"
    picked = []

    def recorder(name):
        def build(*args, **kwargs):
            picked.append(name)
            return lambda s, c, p=(): (s, c)
        return build

    monkeypatch.setattr(twin_adjoint, "make_twin_accum_vjp_fn",
                        recorder("twin_accum"))
    monkeypatch.setattr(twin_adjoint, "make_plane_twin_accum_vjp_fn",
                        recorder("twin_accum"))
    monkeypatch.setattr(plane_adjoint, "make_plane_chain_vjp_fn",
                        recorder("plane_two_phase"))
    g = jac.fused_chain_vjp(jop, k, carry, periodic=periodic, interpret=True,
                            probes=probes or None)
    st = {n: jnp.asarray(a) for n, a in _state(op, shape, 0).items()}
    pcs = tuple(jnp.zeros((k, shape[-1])) for _ in probes)
    g(st, dict(st), pcs)
    return picked[0] if picked else "two_phase"


ROUTES = [
    # (op, periodic, probes, port route)
    ("wave", True, [], "twin_accum"),
    ("wave", True, [("u_curr", 3)], "two_phase"),
    ("wave", False, [], "two_phase"),
    ("kheat", True, [], "twin_accum"),
    ("kheat", False, [], "two_phase"),
    ("heat", True, [], "twin"),
    ("diffusion3d", False, [], "twin_accum"),
    ("diffusion3d", True, [], "twin_accum"),
    ("diffusion3d_kfrozen", False, [], "twin_accum"),
    ("diffusion3d_kfrozen", True, [], "twin"),
    ("heat3d", False, [], "twin_accum"),
    ("heat3d", True, [], "twin"),
    ("nl3d", False, [], "plane_two_phase"),
    ("nl3d", True, [], "plane_two_phase"),
]


@pytest.mark.parametrize("name,periodic,probes,route", ROUTES)
def test_routes_match_jax_interpret(name, periodic, probes, route,
                                    monkeypatch):
    """``g.route`` is "twin_accum" exactly where the JAX package's
    interpret path builds its twin-accum kernel, and "plane_two_phase"
    (the z-streaming kernel) where it builds its plane two-phase kernel."""
    op = OPS[name]()
    carry = CARRY.get(name, UC)
    nd = op.forward_input_fields[0].spatial_dimensions
    shape = (6, 6, 8) if nd == 3 else (16, 16)
    jroute = _jax_route(op, 2, carry, periodic, probes, shape, monkeypatch)
    assert jroute == route
    g = fused_chain_vjp(op, 2, carry, periodic=periodic,
                        probes=probes or None)
    assert g.route == route


def test_grad_reach_beyond_the_chain_is_refused():
    """A coefficient gradient that reads the state outside the forward
    reach is refused by both packages, with the same error."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    op = _shifted_coeff()
    carry = {"u": "u_next"}
    assert ta.state_coeff_twin(op, carry) is not None
    with pytest.raises(ValueError, match="reach exceeds the chain reaches"):
        fused_chain_vjp(op, 2, carry, periodic=True)
    g = jvjp(jax_twin(op), 2, carry, periodic=True, interpret=True)
    st = {n: jnp.asarray(a) for n, a in _state(op, (16, 16), 0).items()}
    with pytest.raises(ValueError, match="reach exceeds the chain reaches"):
        g(st, dict(st))


# --------------------------------------------------------------------------
# Values and gradients against the JAX package.

VJPS = [
    # (id, op, k, periodic, shape)
    ("diffusion3d-bounded-k1", "diffusion3d", 1, False, S3),
    ("diffusion3d-bounded-k2", "diffusion3d", 2, False, S3),
    ("diffusion3d-periodic-k1", "diffusion3d", 1, True, S3),
    ("diffusion3d-periodic-k2", "diffusion3d", 2, True, S3),
    ("heat3d-bounded-twin-k2", "heat3d", 2, False, S3),
    ("wave2d-periodic-k4", "wave", 4, True, (32, 32)),
    ("kheat2d-periodic-k4", "kheat", 4, True, (24, 24)),
]


@pytest.mark.parametrize("case", VJPS, ids=[c[0] for c in VJPS])
def test_twin_accum_matches_jax(case):
    """``(state_k, cot_0)`` of the port's twin-with-accumulation route vs
    JAX ``fused_chain_vjp`` (interpret mode: its twin-accum kernels),
    every cell including the ghost frame, rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    _, name, k, periodic, shape = case
    op = OPS[name]()
    carry = CARRY.get(name, UC)
    state, cots = _state(op, shape, 1), _state(op, shape, 2)
    g = fused_chain_vjp(op, k, carry, periodic=periodic)
    assert g.route == "twin_accum"
    st, cot0 = g(_t(state), _t(cots))
    jg = jvjp(jax_twin(op), k, carry, periodic=periodic, interpret=True)
    jst, jcot0 = jg({n: jnp.asarray(a) for n, a in state.items()},
                    {n: jnp.asarray(a) for n, a in cots.items()})
    for n in state:
        _close(st[n], jst[n], f"state {n}")
        _close(cot0[n], jcot0[n], f"cot {n}")
    if not periodic:  # the exact VJP puts gradient into the ghost frame
        assert np.abs(cot0["u"].numpy()[0]).max() > 0


@pytest.mark.parametrize("periodic", [False, True])
def test_fused_bwd_3d_autograd_matches_jax(periodic):
    """The slice as a whole, small: ``torch.autograd.grad`` of an MSE loss
    through ``fused_time_chain(diffusion3d, k=2, fused_bwd=True)``, two
    chain calls, with respect to κ and the initial u, vs ``jax.grad``
    through the JAX package's fused chain (interpret mode)."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    op = OPS["diffusion3d"]()
    arrays = _state(op, S3, 3)
    target = np.random.default_rng(4).standard_normal(S3)
    chain = fused_time_chain(op, 2, UC, periodic=periodic, fused_bwd=True)
    jc = jchain(jax_twin(op), 2, UC, periodic=periodic, interpret=True,
                fused_bwd=True)

    def loss_j(u, kap):
        st = {"u": u, "kappa": kap}
        for _ in range(2):
            st = jc(st)
        return jnp.mean((st["u"] - target) ** 2)

    jval, (ju, jk) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(arrays["u"]), jnp.asarray(arrays["kappa"]))
    ts = {n: t.requires_grad_() for n, t in _t(arrays).items()}
    st = dict(ts)
    for _ in range(2):
        st = chain(st)
    loss = torch.mean((st["u"] - torch.tensor(target)) ** 2)
    gu, gk = torch.autograd.grad(loss, [ts["u"], ts["kappa"]])
    _close(loss, jval, "loss")
    _close(gu, ju, "grad u")
    _close(gk, jk, "grad kappa")


def test_twin_plan_and_source():
    """The kernel's wiring for config #2's op: κ is the coefficient and an
    invariant (not written back), u the one cotangent plane and the one
    saved plane; the cotangent body reads κ and the masked cotangent of
    u; the tile at 384³ f32 and k=2 fits, at k=4 nothing fits."""
    op = OPS["diffusion3d"]()
    g = fused_chain_vjp(op, 2, UC, periodic=False)
    tp = g.plan
    keys = tp.fwd.plane_keys
    assert tp.cot_keys == [("u", ())] and tp.coeff_keys == [("kappa", ())]
    assert tp.saved_planes == (keys.index(("u", ())),)
    assert tp.cot_slots == ([keys.index(("kappa", ())), -1], [-1, 0], [0, 1])
    geo, (tile, ext, smem) = ta.twin_geometry(tp, (384,) * 3, 4)
    assert smem <= tc.SMEM_BUDGET and len(tile) == 3
    src = generate_twin_source(tp)
    assert '#include "twin_accum.cuh"' in src and "#define PSAT_ND 3" in src
    assert "#define PSAT_NC 1" in src and "#define PSAT_NG 1" in src
    assert "struct PsatGradSlots" in src and "struct PsatCot " in src
    with pytest.raises(ValueError, match="no chain tile"):
        ta.twin_geometry(fused_chain_vjp(op, 4, UC, periodic=False).plan,
                         (384,) * 3, 4)
    cpu = _t(_state(op, S3, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ta.make_twin_accum_kernel(tp)(cpu, cpu)


# --------------------------------------------------------------------------
# On the card: kernels B (2D periodic) and C (3D) against their plain
# version.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the twin-accum kernel is compiled "
                    "with nvcc for sm_90a and has no CPU mode)")
    return torch.device("cuda", 0)


KERNEL_CASES = [
    # (id, op, k, periodic, shape)
    ("wave2d-periodic", "wave", 3, True, (37, 45)),
    ("kheat2d-periodic", "kheat", 4, True, (45, 70)),
    ("diffusion3d-bounded", "diffusion3d", 2, False, (11, 9, 37)),
    ("diffusion3d-periodic", "diffusion3d", 2, True, (11, 9, 37)),
    ("diffusion3d-bounded-k1", "diffusion3d", 1, False, (20, 33, 70)),
    ("heat3d-bounded-twin", "heat3d", 3, False, (13, 17, 40)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_twin_accum_kernel_matches_plain_version(case, dtype, tiles,
                                                 cuda_device, monkeypatch):
    """The twin-accum kernel vs its plain version on the same CUDA
    tensors: the box design (kernel B in 2D, ``design="box"``) on ragged
    grids of several tiles (8×32 and 2×4×32 forced), or the march (the
    route's design) in the geometry it picks; rtol 1e-12 in f64, 1e-5 with
    atol 1e-5·max|ref| in f32 (×10 on the cotangents: k backward sums)."""
    if tiles == "small":  # tiny boxes own little: lift the owned-share floor
        monkeypatch.setattr(tc, "TILE_ROWS", (8,))
        monkeypatch.setattr(tc, "TILE_COLS", (32,))
        monkeypatch.setattr(tc, "TILE_DEPTH_3D", (2,))
        monkeypatch.setattr(tc, "TILE_ROWS_3D", (4,))
        monkeypatch.setattr(tc, "TILE_COLS_3D", (32,))
        monkeypatch.setattr(tc, "MIN_OWNED_SHARE", 0.0)
    _, name, k, periodic, shape = case
    op = OPS[name]()
    carry = CARRY.get(name, UC)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = {n: t.to(dtype) for n, t in _t(_state(op, shape, 1),
                                        cuda_device).items()}
    cots = {n: t.to(dtype) for n, t in _t(_state(op, shape, 2),
                                          cuda_device).items()}
    g = fused_chain_vjp(op, k, carry, periodic=periodic)
    assert g.route == "twin_accum"
    before = ta.LAUNCHES
    got = ta.make_twin_accum_kernel(
        g.plan, "box" if tiles == "small" else "march")(st, cots)
    torch.cuda.synchronize()
    assert ta.LAUNCHES == before + 1
    ref = ta.plain_twin_accum_vjp(g.plan)(st, cots)
    for n in ref[0]:
        torch.testing.assert_close(got[0][n], ref[0][n], rtol=tol,
                                   atol=tol * ref[0][n].abs().max().item())
        torch.testing.assert_close(
            got[1][n], ref[1][n], rtol=10 * tol,
            atol=10 * tol * ref[1][n].abs().max().item())


@pytest.mark.cuda
def test_config2_gradient_on_the_card_matches_cpu(cuda_device):
    """The κ gradient of config #2's path (diffusion3d, bounded, k=2,
    fused_bwd=True, 4 steps) on CUDA tensors equals the CPU run of the
    plain versions, float64, rtol 1e-12."""
    op = OPS["diffusion3d"]()
    arrays = _state(op, (14, 13, 35), 5)
    chain = fused_time_chain(op, 2, UC, fused_bwd=True)

    def grad(device):
        ts = _t(arrays, device)
        ts["kappa"].requires_grad_()
        st = dict(ts)
        for _ in range(2):
            st = chain(st)
        loss = (st["u"] ** 2).mean()
        return loss, torch.autograd.grad(loss, ts["kappa"])[0]

    before = (tc.LAUNCHES, ta.LAUNCHES)
    lc, gc = grad(cuda_device)
    torch.cuda.synchronize()
    assert (tc.LAUNCHES, ta.LAUNCHES) == (before[0] + 2, before[1] + 2)
    lp, gp = grad("cpu")
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-12, atol=0)
    torch.testing.assert_close(gc.cpu(), gp, rtol=1e-12,
                               atol=1e-12 * gp.abs().max().item())
