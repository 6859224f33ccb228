"""The z-streaming chain kernel of the port (``ops.plane_adjoint``: the
fused value+gradient of 3D ops the twin decompositions reject, and the
forward chain of 3D states too wide for a box tile) against the JAX
package, in float64 on the CPU.

The JAX side runs as its own tests run it: ``make_plane_chain_vjp_fn`` with
``interpret=True`` (tests/test_plane_adjoint.py), on the op rebuilt from
the JAX package's own constructors (``torch_jax_twin.jax_twin``).  For
D3Q19 that kernel takes a minute in interpret mode here, so D3Q19 is held
against the JAX package's sequential ``jax.vjp`` of its jnp stepper
instead.  On CPU tensors the port runs the kernel's plain version (k plain
forward steps, then k plain backward steps), so these tests hold the
semantics the CUDA kernel is compared with on the card; the
``cuda``-marked tests compare the kernel itself (skipped without a card).
Inputs are made from a seed with numpy; rtol 1e-10, ghost cells
included."""

from collections import Counter

import numpy as np
import pytest
import sympy as sp
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_plane_source
from pystencils_autodiff_tpu_torch.models import (D3Q19_VELOCITIES,
                                                  anisotropic27_op,
                                                  d3q19_bgk_op,
                                                  diffusion3d_op, macroscopic)
from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from torch_jax_twin import jax_twin

RTOL = 1e-10
S3 = (12, 10, 16)
UC = {"u": "u_next"}
LBM = {"f": "f_out"}


def _nl3d():
    u, out = Field("u", 3, dtype="float64"), Field("u_next", 3,
                                                   dtype="float64")
    return AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")


def _wave3d():
    """tests/test_plane_adjoint.py's two-field carry with a coefficient."""
    u, up = Field("u", 3, dtype="float64"), Field("u_prev", 3,
                                                  dtype="float64")
    c, out = Field("c", 3, dtype="float64"), Field("u_next", 3,
                                                   dtype="float64")
    lap = sum(u.neighbor(d, 1) + u.neighbor(d, -1) for d in range(3)) \
        - 6 * u.center
    return AutoDiffOp([Assignment(out.center, 2 * u.center - up.center
                                  + sp.Rational(1, 100) * c.center ** 2
                                  * lap)], op_name="wave3d")


def _d3q19(dtype="float64"):
    return d3q19_bgk_op(omega=1.7, dtype=dtype, layout="soa")


OPS = {
    "nl3d": (_nl3d, UC),
    "diffusion3d": (lambda: diffusion3d_op(dt=0.05, dtype="float64"), UC),
    "wave3d": (_wave3d, {"u_prev": "u", "u": "u_next"}),
    "d3q19": (_d3q19, LBM),
}


def _state(op, shape, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f in op.forward_input_fields:
        a = 0.5 * rng.standard_normal(storage_shape(f, shape))
        if f.name in ("c", "kappa"):
            a = 1.0 + 0.2 * a ** 2
        elif f.name == "f":  # a distribution near rest: ρ ≈ 1
            a = (1.0 + 0.1 * a) / 19
        out[f.name] = a
    return out


def _cots(op, shape, seed):
    rng = np.random.default_rng(seed)
    return {f.name: rng.standard_normal(storage_shape(f, shape))
            for f in op.forward_input_fields}


def _t(arrays, device="cpu", dtype=torch.float64):
    return {n: torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for n, a in arrays.items()}


def _close(got, ref, what, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _plain_plane(op, k, carry, periodic):
    """The streaming two-phase kernel's plain version for ``op``."""
    return ac.plain_chain_vjp(ac.AdjointPlan(tc.chain_plan(op, k, carry,
                                                           periodic)))


# --------------------------------------------------------------------------
# Values and cotangents against the JAX package.

PLANE_VJPS = [
    # (id, op, k, periodic)
    ("nl3d-bounded-k1", "nl3d", 1, False),
    ("nl3d-bounded-k2", "nl3d", 2, False),
    ("nl3d-periodic-k1", "nl3d", 1, True),
    ("nl3d-periodic-k2", "nl3d", 2, True),
    ("diffusion3d-periodic-k2", "diffusion3d", 2, True),
    ("wave3d-bounded-k2", "wave3d", 2, False),
]


@pytest.mark.parametrize("case", PLANE_VJPS, ids=[c[0] for c in PLANE_VJPS])
def test_plane_vjp_matches_jax_plane_kernel(case):
    """``(state_k, cot_0)`` of the streaming kernel's plain version vs the
    JAX package's ``make_plane_chain_vjp_fn`` (interpret mode), every cell
    including the ghost frame, rtol 1e-10.  A nonlinear op takes it through
    ``fused_chain_vjp`` (route "plane_two_phase"); config #2's diffusion
    and the wave's coefficient op take the twin-accum route there, so they
    are held through the plain version the kernel is compared with."""
    from pystencils_autodiff_tpu.ops.plane_adjoint import \
        make_plane_chain_vjp_fn

    _, name, k, periodic = case
    make, carry = OPS[name]
    op = make()
    state, cots = _state(op, S3, 1), _cots(op, S3, 2)
    if name == "nl3d":
        g = fused_chain_vjp(op, k, carry, periodic=periodic)
        assert g.route == "plane_two_phase"
    else:
        g = _plain_plane(op, k, carry, periodic)
    st, cot0 = g(_t(state), _t(cots))
    jg = make_plane_chain_vjp_fn(jax_twin(op), k, carry, S3, jnp.float64,
                                 interpret=True, periodic=periodic)
    jst, jcot0 = jg({n: jnp.asarray(a) for n, a in state.items()},
                    {n: jnp.asarray(a) for n, a in cots.items()})
    for n in state:
        _close(st[n], jst[n], f"state {n}")
        _close(cot0[n], jcot0[n], f"cot {n}")
    if not periodic:  # the exact VJP puts gradient into the ghost frame
        assert np.abs(cot0["u"].numpy()[0]).max() > 0


def test_d3q19_plane_vjp_matches_jax_sequential():
    """D3Q19 BGK, periodic, k=2 through ``fused_chain_vjp`` (route
    "plane_two_phase") vs the JAX package's ``jax.vjp`` of two steps of its
    jnp stepper, float64, rtol 1e-10 (the JAX plane kernel in interpret
    mode takes a minute on this shape's minimum, 12 planes)."""
    from pystencils_autodiff_tpu.timeloop import make_time_stepper as jstep

    op, shape = _d3q19(), (6, 4, 5)
    state, cots = _state(op, shape, 3), _cots(op, shape, 4)
    g = fused_chain_vjp(op, 2, LBM, periodic=True)
    assert g.route == "plane_two_phase"
    st, cot0 = g(_t(state), _t(cots))
    step = jstep(jax_twin(op), LBM, lowering="jnp", periodic=True)

    def run(s):
        for _ in range(2):
            s = step(s)
        return s

    ref, pull = jax.vjp(run, {"f": jnp.asarray(state["f"])})
    (rcot,) = pull({"f": jnp.asarray(cots["f"])})
    _close(st["f"], ref["f"], "state f")
    _close(cot0["f"], rcot["f"], "cot f")


@pytest.mark.parametrize("periodic", [False, True])
def test_fused_bwd_nl3d_autograd_matches_jax(periodic):
    """The slice as a whole, small: ``torch.autograd.grad`` of an MSE loss
    through ``fused_time_chain(nl3d, k=2, fused_bwd=True)``, two chain
    calls, vs ``jax.grad`` through the JAX package's fused chain
    (interpret mode: its plane kernels)."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    op = _nl3d()
    u0 = _state(op, S3, 5)["u"]
    target = np.random.default_rng(6).standard_normal(S3)
    chain = fused_time_chain(op, 2, UC, periodic=periodic, fused_bwd=True)
    jc = jchain(jax_twin(op), 2, UC, periodic=periodic, interpret=True,
                fused_bwd=True)

    def loss_j(u):
        st = {"u": u}
        for _ in range(2):
            st = jc(st)
        return jnp.mean((st["u"] - target) ** 2)

    jval, jgu = jax.value_and_grad(loss_j)(jnp.asarray(u0))
    u = torch.tensor(u0, requires_grad=True)
    st = {"u": u}
    for _ in range(2):
        st = chain(st)
    loss = torch.mean((st["u"] - torch.tensor(target)) ** 2)
    (gu,) = torch.autograd.grad(loss, u)
    _close(loss, jval, "loss")
    _close(gu, jgu, "grad u")


def test_d3q19_fused_chain_forward_matches_plain_steps():
    """Path C's chain on CPU tensors: ``fused_time_chain(D3Q19, 2,
    periodic)`` equals two steps of the op's own periodic single step."""
    from pystencils_autodiff_tpu_torch.timeloop import make_time_stepper

    op, shape = _d3q19(), (5, 6, 4)
    f = _t(_state(op, shape, 7))
    got = fused_time_chain(op, 2, LBM, periodic=True)(f)
    step = make_time_stepper(op, LBM, periodic=True)
    ref = step(step(f))
    _close(got["f"], ref["f"].detach().numpy(), "state f", 1e-12)


# --------------------------------------------------------------------------
# The reckoning: which kernel a chain takes, from shapes alone.

def test_geometry_reckoning_picks_the_kernels():
    """D3Q19 k=2 at 256³ fits no box: the forward chain takes the streaming
    kernel (f32 and f64), whose rings fit; at k=1 a box fits.  Config #2's
    diffusion and aniso27 keep their boxes at 384³ k=2.  The two-phase
    rings of D3Q19 k=2 fit in f32 and f64 in both forms; at k=1 the gather
    form keeps nothing in shared memory.  The local form's reckoning: L_1
    covers the tile + 2 a side, L_0 (with G_1 fused in: D3Q19 passes no
    cotangent through unchanged) + 1, F_1 + 3; rings of 3 planes
    (state_1, w_1, w_0) and none for cot_1."""
    for dtype, size in (("float32", 4), ("float64", 8)):
        op = _d3q19(dtype)
        plan = tc.chain_plan(op, 2, LBM, True)
        assert tc.box_tile(plan, (256,) * 3, size) is None
        fwd = pa.stream_geometry(plan, (256,) * 3, size)
        assert fwd is not None and fwd.smem <= tc.SMEM_BUDGET
        assert fwd.state_depth == [0, 3]  # the forward reach 1 + 1 + 1
        two = pa.stream_geometry(plan, (256,) * 3, size,
                                 ac.AdjointPlan(plan), form="gather")
        assert two is not None and two.smem <= tc.SMEM_BUDGET
        # F_1 covers what R_1 reads (2·2 a side); rings of 5 planes
        assert two.extents[0] == ([4, 4, 4], [4, 4, 4])
        assert two.state_depth == [0, 5] and two.cot_depth == [0, 5]
        assert two.lags == [0, 1, 2, 4]
        loc = pa.stream_geometry(plan, (256,) * 3, size,
                                 ac.AdjointPlan(plan), form="local")
        assert loc is not None and loc.smem <= tc.SMEM_BUDGET
        assert loc.stages == [(pa.F, 1), (pa.F, 2), (pa.L, 1), (pa.LG, 0),
                              (pa.G, 0)]
        assert [e[0] for e in loc.extents] == [[3] * 3, [0] * 3, [2] * 3,
                                               [1] * 3, [0] * 3]
        assert loc.state_depth == [0, 3] and loc.cot_depth == [0, 0]
        assert loc.w_depth == [3, 3] and loc.lags == [0, 1, 1, 2, 3]
        k1 = tc.chain_plan(op, 1, LBM, True)
        assert tc.box_tile(k1, (256,) * 3, size) is not None
        assert pa.stream_geometry(k1, (256,) * 3, size, ac.AdjointPlan(k1),
                                  form="gather").smem == 0
    plan32 = tc.chain_plan(_d3q19("float32"), 2, LBM, True)
    f32 = pa.stream_geometry(plan32, (256,) * 3, 4, ac.AdjointPlan(plan32),
                             form="gather")
    assert f32.tile == (9, 14) and f32.nseg == 1
    loc = pa.stream_geometry(plan32, (256,) * 3, 4, ac.AdjointPlan(plan32),
                             form="local")
    assert loc.tile == (14, 14) and loc.nseg == 1
    for op, carry in ((diffusion3d_op(dt=0.05), UC),
                      (anisotropic27_op(), {"u": "y"})):
        for periodic in (False, True):
            plan = tc.chain_plan(op, 2, carry, periodic)
            assert tc.box_tile(plan, (384,) * 3, 4) is not None


def test_wiring_and_source():
    """The streaming translation units (no nvcc here): D3Q19's 19 planes
    are all in the rings and carried from the outputs; wave3d's c is
    invariant (no ring slot) and u_prev is carried from u; the two-phase
    unit holds the backward body and its multi-carrier table; the wrappers
    refuse CPU tensors."""
    src = generate_plane_source(ac.AdjointPlan(tc.chain_plan(
        _d3q19(), 2, LBM, True)), "two_phase", "float32")
    assert '#include "plane_adjoint.cuh"' in src and "struct PsatBwd " in src
    assert "static constexpr int kNDyn = 19;" in src
    assert "#define PSAT_T float" in src and "#define PSAT_PERIODIC 1" in src
    assert "#define PSAT_TWO_PHASE 1" in src and "kMaxAdj = 1;" in src
    make, carry = OPS["wave3d"]
    plan = tc.chain_plan(make(), 2, carry, False)
    src = generate_plane_source(plan, "forward", "float64")
    keys = plan.plane_keys
    assert "#define PSAT_TWO_PHASE 0" in src and "struct PsatBwd " not in src
    assert f"static constexpr int kNDyn = {len(keys) - 1};" in src
    assert plan.src_of(keys.index(("u_prev", ()))) == (
        "in", keys.index(("u", ())))
    cpu = _t(_state(make(), S3, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.make_plane_chain_kernel(plan)(cpu)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.make_plane_adjoint_kernel(ac.AdjointPlan(plan))(cpu, cpu)


def test_d3q19_at_k4_runs_as_two_segments_of_depth_2():
    """No streaming two-phase tile of D3Q19 fits at k = 3 or 4 at 256³; the
    reckoning (a host function of the plan, shape and itemsize) runs k=4 as
    2 segments of depth 2, in float32 and float64, and k=2 whole."""
    op = _d3q19("float32")
    plan4 = tc.chain_plan(op, 4, LBM, True)
    assert pa.stream_geometry(plan4, (256,) * 3, 4,
                              ac.AdjointPlan(plan4)) is None
    for itemsize in (4, 8):
        assert ac.two_phase_segments(plan4, (256,) * 3, itemsize) == 2
        assert ac.two_phase_segments(tc.chain_plan(op, 2, LBM, True),
                                     (256,) * 3, itemsize) == 1
    g = fused_chain_vjp(op, 4, LBM, periodic=True)
    assert g.route == "plane_two_phase"
    assert g.segments_for((256,) * 3, 4) == 2


@pytest.mark.parametrize("periodic", [False, True])
def test_segmented_plane_vjp_matches_jax(periodic):
    """nl3d k=2 as 2 segments of depth 1 (forced) equals the JAX package's
    2-deep ``make_plane_chain_vjp_fn`` (interpret mode), rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.plane_adjoint import \
        make_plane_chain_vjp_fn

    op = _nl3d()
    state, cots = _state(op, S3, 5), _cots(op, S3, 6)
    g = fused_chain_vjp(op, 2, UC, periodic=periodic, segments=2)
    st, cot0 = g(_t(state), _t(cots))
    assert g.segments == 2
    jg = make_plane_chain_vjp_fn(jax_twin(op), 2, UC, S3, jnp.float64,
                                 interpret=True, periodic=periodic)
    jst, jcot0 = jg({n: jnp.asarray(a) for n, a in state.items()},
                    {n: jnp.asarray(a) for n, a in cots.items()})
    for n in state:
        _close(st[n], jst[n], f"state {n}")
        _close(cot0[n], jcot0[n], f"cot {n}")


# --------------------------------------------------------------------------
# On the card: both modes against their plain versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the streaming kernel is compiled "
                    "with nvcc for sm_90a and has no CPU mode)")
    return torch.device("cuda", 0)


KERNEL_CASES = [
    # (id, op, k, shape, periodic)
    ("nl3d-k2-bounded", "nl3d", 2, (11, 9, 37), False),
    ("nl3d-k2-periodic", "nl3d", 2, (11, 9, 37), True),
    ("nl3d-k3-bounded", "nl3d", 3, (20, 13, 30), False),
    ("nl3d-k3-periodic", "nl3d", 3, (20, 13, 30), True),
    ("wave3d-k2-bounded", "wave3d", 2, (9, 17, 21), False),
    ("wave3d-k2-periodic", "wave3d", 2, (9, 17, 21), True),
    # an index field (SoA); path C's mode (its 1,687-step backward body
    # takes minutes to build per variant)
    ("d3q19-k2-periodic", "d3q19", 2, (10, 7, 11), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[c[0] for c in KERNEL_CASES])
def test_plane_kernel_matches_plain_versions(case, dtype, tiles,
                                             cuda_device, monkeypatch):
    """Both modes of the streaming kernel vs their plain versions on the
    same CUDA tensors: ragged grids of several column tiles and dim-0
    segments (3×5 tiles and 3 segments forced), or the picked geometry;
    rtol 1e-12 in f64, 1e-5 with atol 1e-5·max|ref| in f32 (×10 on the
    cotangents: k backward sums)."""
    if tiles == "small":
        monkeypatch.setattr(pa, "TILE_Y", (3,))
        monkeypatch.setattr(pa, "TILE_X", (5,))
        monkeypatch.setattr(pa, "STREAM_SEGMENTS", 3)
        monkeypatch.setattr(pa, "MIN_OWNED_SHARE", 0.0)
    _, name, k, shape, periodic = case
    make, carry = OPS[name]
    op = make()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = _t(_state(op, shape, 1), cuda_device, dtype)
    cots = _t(_cots(op, shape, 2), cuda_device, dtype)
    plan = tc.chain_plan(op, k, carry, periodic)
    ap = ac.AdjointPlan(plan)
    before = pa.LAUNCHES
    got = pa.make_plane_chain_kernel(plan)(st)
    got_adj = pa.make_plane_adjoint_kernel(ap)(st, cots)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 2
    ref = tc.plain_time_chain(plan)(st)
    ref_adj = ac.plain_chain_vjp(ap)(st, cots)

    def check(a, b, scale=1.0):
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())

    for n in plan.invariant:  # returned as given, not written
        assert got[0][n] is st[n] and got_adj[0][n] is st[n]
    for n in ref[0]:
        check(got[0][n], ref[0][n])
        check(got_adj[0][n], ref_adj[0][n])
        check(got_adj[1][n], ref_adj[1][n], 10.0)


def _path_c(f0, target, steps, k=2):
    """Path C, small: the MSE of the final velocity of ``steps`` D3Q19 steps
    through the fused chain and its gradient with respect to f0."""
    chain = fused_time_chain(_d3q19(), k, LBM, periodic=True,
                             fused_bwd=True)
    f = f0.detach().requires_grad_()
    st = {"f": f}
    for _ in range(steps // k):
        st = chain(st)
    _, *u = macroscopic(st["f"], "soa", D3Q19_VELOCITIES)
    loss = sum(torch.mean((a - b) ** 2) for a, b in zip(u, target))
    return loss, torch.autograd.grad(loss, f)[0]


@pytest.mark.cuda
def test_path_c_gradient_on_the_card_matches_cpu(cuda_device):
    """Path C at 8×9×10, float64: the loss and gradient on CUDA tensors (4
    launches of the streaming kernel, 2 per mode) equal the CPU run of the
    plain versions, rtol 1e-12."""
    op, shape = _d3q19(), (8, 9, 10)
    f0 = _t(_state(op, shape, 8))["f"]
    rng = np.random.default_rng(9)
    target = [torch.tensor(0.01 * rng.standard_normal(shape))
              for _ in range(3)]
    before = dict(pa.LAUNCH_CALLS)
    lc, gc = _path_c(f0.to(cuda_device), [t.to(cuda_device) for t in target],
                     4)
    torch.cuda.synchronize()
    modes = Counter()
    for key, n in pa.LAUNCH_CALLS.items():
        modes[key[5]] += n - before.get(key, 0)
    assert modes == Counter({"forward": 2, "two_phase": 2})
    lp, gp = _path_c(f0, target, 4)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-12, atol=0)
    torch.testing.assert_close(gc.cpu(), gp, rtol=1e-12,
                               atol=1e-12 * gp.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segmented_plane_vjp_on_the_card(dtype, cuda_device, monkeypatch):
    """nl3d at k=4 with the lateral tiles cut to 3×5 and no owned-share
    floor: the shared memory is cut so that only depth 2 fits, and
    ``fused_chain_vjp`` runs 2 segments (1 forward chain launch for the
    checkpoint, 2 two-phase launches), equal to the plain 4-deep version."""
    monkeypatch.setattr(pa, "TILE_Y", (3,))
    monkeypatch.setattr(pa, "TILE_X", (5,))
    monkeypatch.setattr(pa, "MIN_OWNED_SHARE", 0.0)
    op, shape = _nl3d(), (20, 13, 30)
    plan = tc.chain_plan(op, 4, UC, False)
    need = {d: pa.stream_geometry(ac.plan_at_depth(plan, d), shape,
                                  dtype.itemsize,
                                  ac.AdjointPlan(ac.plan_at_depth(plan, d))
                                  ).smem for d in (2,)}
    monkeypatch.setattr(pa, "SMEM_BUDGET", need[2])
    assert ac.two_phase_segments(plan, shape, dtype.itemsize) == 2
    st = _t(_state(op, shape, 7), cuda_device, dtype)
    cots = _t(_cots(op, shape, 8), cuda_device, dtype)
    g = fused_chain_vjp(op, 4, UC, periodic=False)
    before, box_before = Counter(pa.LAUNCH_CALLS), tc.LAUNCHES
    got = g(st, cots)
    torch.cuda.synchronize()
    modes = Counter()
    for key, n in pa.LAUNCH_CALLS.items():
        modes[key[5]] += n - before.get(key, 0)
    # the checkpoint: one 2-deep forward chain, a box (it fits) or streamed
    assert g.segments == 2 and modes["two_phase"] == 2
    assert modes["forward"] + tc.LAUNCHES - box_before == 1
    ref = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b, scale in [(got[0][n], ref[0][n], 1.0) for n in ref[0]] + [
            (got[1][n], ref[1][n], 10.0) for n in ref[1]]:
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_3d_probes_on_the_card(dtype, tiles, cuda_device, monkeypatch):
    """3D probe lines on the card vs the plain versions: the forward chain
    (diffusion3d; the box design on small box tiles, or the march in the
    geometry it picks), the streaming forward mode and the streaming
    two-phase mode with probe cotangents (nl3d), k=2, ragged grids (small
    tiles and dim-0 segments forced) or the picked geometry; rtol 1e-12 in
    f64, 1e-5 in f32 (×10 on the cotangents)."""
    if tiles == "small":
        monkeypatch.setattr(pa, "TILE_Y", (3,))
        monkeypatch.setattr(pa, "TILE_X", (5,))
        monkeypatch.setattr(pa, "STREAM_SEGMENTS", 3)
        monkeypatch.setattr(pa, "MIN_OWNED_SHARE", 0.0)
        monkeypatch.setattr(tc, "TILE_DEPTH_3D", (2,))
        monkeypatch.setattr(tc, "TILE_ROWS_3D", (4,))
        monkeypatch.setattr(tc, "TILE_COLS_3D", (32,))
        monkeypatch.setattr(tc, "MIN_OWNED_SHARE", 0.0)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    shape = (11, 9, 37)
    probes = [("u", 3 * 9 + 2), ("u", 10 * 9 + 8)]

    def check(a, b, scale=1.0):
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())

    dop = diffusion3d_op(dt=0.05)
    plan = tc.chain_plan(dop, 2, UC, False, probes)
    design = "box" if tiles == "small" else "march"
    assert design in tc.fitting_designs(plan, shape, dtype.itemsize)
    st = _t(_state(dop, shape, 3), cuda_device, dtype)
    got = tc.make_chain_kernel(plan, design)(st)
    ref = tc.plain_time_chain(plan)(st)
    check(got[0]["u"], ref[0]["u"])
    for a, b in zip(got[1], ref[1]):
        check(a, b)
    op = _nl3d()
    plan = tc.chain_plan(op, 2, UC, False, probes)
    ap = ac.AdjointPlan(plan)
    st = _t(_state(op, shape, 4), cuda_device, dtype)
    cots = _t(_cots(op, shape, 5), cuda_device, dtype)
    gen = torch.Generator(cuda_device).manual_seed(6)
    pcs = tuple(torch.randn((2, shape[-1]), dtype=dtype, device=cuda_device,
                            generator=gen) for _ in probes)
    got = pa.make_plane_chain_kernel(plan)(st)
    ref = tc.plain_time_chain(plan)(st)
    check(got[0]["u"], ref[0]["u"])
    for a, b in zip(got[1], ref[1]):
        check(a, b)
    got = pa.make_plane_adjoint_kernel(ap)(st, cots, pcs)
    ref = ac.plain_chain_vjp(ap)(st, cots, pcs)
    torch.cuda.synchronize()
    check(got[0]["u"], ref[0]["u"])
    check(got[1]["u"], ref[1]["u"], 10.0)
