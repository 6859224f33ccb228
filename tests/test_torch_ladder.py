"""The depth ladder of the port's chains and the reckonings of the window
single step and the warp march (the 2D forward chain).

Where no fused design fits a shape, the JAX package's TPU dispatch runs
shallower chains and in the end single steps (forwards) or the
sequential-recompute backward; the port decides the same ladder by its
host reckonings before any launch (``time_chain.forward_route``,
``stage_chain.stage_route``, ``adjoint_chain.fused_segments``,
``fused_stage_chain_vjp(...).route_for``).  The reckonings run here at the
shapes where the port used to raise (pure host work).  The rungs run here
on the plain versions — each rung's kernels replaced by their plain
versions on CPU tensors, the routes forced — in float64 against the JAX
package's ``lowering="jnp"`` stepping and ``jax.grad``, rtol 1e-10.  The
``cuda``-marked tests at the end run the rungs, the window kernel and the
warp march on the card (skipped without one).  Inputs are made from a
seed with numpy."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu_torch.models import (d3q19_bgk_op,
                                                  diffusion3d_op,
                                                  heat_step3d_op,
                                                  heat_step_op, wave_step_op)
from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                               forward_program,
                                               fused_stage_chain,
                                               fused_time_chain,
                                               make_cuda_stencil,
                                               make_torch_stencil)
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops import warp_chain as wc
from pystencils_autodiff_tpu_torch.ops.common import (storage_shape,
                                                      storage_spatial)
from torch_jax_twin import jax_twin

LBM = {"f": "f_out"}
UC = {"u": "u_next"}
BOUNCE = {"f": ("bounce_back", "solid", ("uw0", "uw1", "uw2"))}


def _d3q19(dtype="float64"):
    return d3q19_bgk_op(omega=1.7, dtype=dtype, layout="soa")


# ---------------------------------------------------------------------------
# The route reckoning at the shapes where the port used to raise.

Q3 = [(dt, n, per) for dt in ("float32", "float64") for n in (128, 256)
      for per in (False, True)]


@pytest.mark.parametrize("dtype, n, periodic", Q3,
                         ids=[f"{d}-{n}-{'periodic' if p else 'bounded'}"
                              for d, n, p in Q3])
def test_d3q19_k8_takes_a_rung_without_raising(dtype, n, periodic):
    """D3Q19 k=8 (no design fits at depth 8): the forward runs 2 launches
    of the 4-deep chain — the march in f32, the z-streaming forward mode
    in f64 —, the fused adjoint 4 segments of depth 2; no reckoning
    raises."""
    isz = 8 if dtype == "float64" else 4
    plan = tc.chain_plan(_d3q19(dtype), 8, LBM, periodic)
    shape = (n,) * 3
    assert tc.forward_design(plan, shape, isz) is None
    design, kk = tc.forward_route(plan, shape, isz)
    assert (design, kk) == ("march" if isz == 4 else "stream", 4)
    assert plan.k // kk == 2  # launches a chain call
    assert ac.fused_segments(plan, shape, isz) == 4


@pytest.mark.parametrize("k", [1, 2])
def test_bounce_back_stage_chain_f64_64_takes_a_rung(k):
    """The D3Q19 BGK stage chain with bounce-back walls in f64 at 64³:
    kernel 12 fits at depth 1 (k launches), kernel 13 fits at no depth —
    the adjoint runs the sequential-recompute rung (``route_for`` None;
    ``segments_for``, the segment reckoning, raises)."""
    stages = [(_d3q19(), LBM)]
    plan = sc.StagePlan(stages, k, False, BOUNCE)
    assert sc.stage_route(plan, (64,) * 3, 8) == 1
    g = sa.fused_stage_chain_vjp(stages, k, boundary=BOUNCE)
    assert g.route_for((64,) * 3, 8) is None
    with pytest.raises(ValueError, match="no march"):
        g.segments_for((64,) * 3, 8)


def test_periodic_extent_below_the_reach_raises():
    """As in the JAX package, a periodic extent below the stencil's reach
    is refused before any launch."""
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field

    u, out = Field("u", 2, dtype="float64"), Field("u_next", 2,
                                                   dtype="float64")
    op = AutoDiffOp([Assignment(out.center, u[2, 0] + u[-2, 0])],
                    op_name="reach2")
    plan = tc.chain_plan(op, 2, UC, True)
    with pytest.raises(ValueError, match="must cover the stencil reach"):
        tc.forward_route(plan, (1, 40), 8)
    assert tc.forward_route(plan, (2, 40), 8)[0] in tc.DESIGNS_2D


# ---------------------------------------------------------------------------
# The rungs on the plain versions against the JAX package.

def _t(arrays, grad=False):
    return {n: torch.tensor(np.asarray(a), dtype=torch.float64,
                            requires_grad=grad) for n, a in arrays.items()}


def _cpu_check_state(plan, state):
    f0 = plan.program.input_fields[0]
    return state[f0.name], tuple(storage_spatial(f0, state[f0.name]))


def _lbm_state(shape, seed, names=("f",)):
    rng = np.random.default_rng(seed)
    w = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)
    return {"f": w.reshape((19,) + (1,) * 3)
            * (1.0 + 0.05 * rng.standard_normal((19,) + shape))}


def _kdiff_state(shape, seed):
    rng = np.random.default_rng(seed)
    return {"u": rng.standard_normal(shape),
            "kappa": 1.0 + 0.5 / (1.0 + np.exp(-rng.standard_normal(shape)))}


@pytest.fixture
def ladder_on_cpu(monkeypatch):
    """Run the card's routes on CPU tensors: the state checks accept them,
    ``on_card`` says yes, and each rung's kernels are their plain
    versions (the "steps" rung and the sequential-recompute backward run
    as they do on the card, through the ops' own single steps).  Returns
    the launch log: (design, depth) of each rung call."""
    calls = []

    def rung(plan, design):
        run = (tc.single_steps(plan) if design == "steps"
               else tc.plain_time_chain(plan))

        def fn(state):
            calls.append((design, plan.k))
            return run(state)
        return fn

    monkeypatch.setattr(tc, "rung_kernel", rung)
    monkeypatch.setattr(tc, "check_state", _cpu_check_state)
    monkeypatch.setattr(ac, "check_state", _cpu_check_state)
    monkeypatch.setattr(ac, "on_card", lambda t: True)
    # the chains' runners pick the kernel for "card" tensors
    monkeypatch.setattr(tc, "on_device",
                        lambda kernel, plain, first: kernel)
    return calls


RUNGS = [("march", 2), ("march", 1), ("steps", 1)]


@pytest.mark.parametrize("rung", RUNGS, ids=[f"{d}-{kk}" for d, kk in RUNGS])
@pytest.mark.parametrize("periodic", [False, True])
def test_forward_and_sequential_adjoint_rungs_match_jax(rung, periodic,
                                                        ladder_on_cpu,
                                                        monkeypatch):
    """κ-diffusion k=4 at 24³ f64 through ``fused_time_chain(fused_bwd=
    True)`` with the forward forced onto a rung (k/kk launches of the
    kk-deep chain, or 4 single steps) and the fused adjoint onto its last
    rung (no kernel fits at depth 1): the loss and ∂/∂(u, κ) of two chain
    calls vs the JAX package's jnp stepping and ``jax.grad``, rtol
    1e-10; the rung's launches are k/kk a call."""
    from pystencils_autodiff_tpu.timeloop import make_time_stepper as jstep

    design, kk = rung
    monkeypatch.setattr(tc, "forward_route",
                        lambda plan, *a, **kw: (design, kk))
    monkeypatch.setattr(ac, "fused_segments", lambda *a, **kw: None)
    op, k, shape = diffusion3d_op(dt=0.05, dtype="float64"), 4, (24,) * 3
    arrays = _kdiff_state(shape, 5)
    target = np.random.default_rng(6).standard_normal(shape)
    chain = fused_time_chain(op, k, UC, periodic=periodic, fused_bwd=True)
    ins = _t(arrays, grad=True)
    st = dict(ins)
    for _ in range(2):
        st = chain(st)
    loss = ((st["u"] - torch.tensor(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, [ins["u"], ins["kappa"]])
    # each chain call: k/kk launches of the kk-deep rung, or one call of
    # the k single steps (the forward and, in the backward, the recompute)
    want = [("steps", k)] if design == "steps" else [(design, kk)] * (k // kk)
    assert ladder_on_cpu[:len(want)] == want

    step = jstep(jax_twin(op), UC, lowering="jnp", periodic=periodic)

    def jloss(u, kappa):
        s = {"u": u, "kappa": kappa}
        for _ in range(2 * k):
            s = step(s)
        return jnp.mean((s["u"] - target) ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(arrays["u"]), jnp.asarray(arrays["kappa"]))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-10)
    for g, r in zip(grads, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10,
                                   atol=1e-10 * np.abs(r).max())


def test_d3q19_steps_rung_with_sequential_adjoint_matches_jax(ladder_on_cpu,
                                                             monkeypatch):
    """D3Q19 BGK periodic k=2 at 24³ f64: the forward on its last rung (2
    single steps), the adjoint on the sequential-recompute rung, vs the
    JAX package's ``jax.vjp`` of two jnp steps, rtol 1e-10."""
    from pystencils_autodiff_tpu.timeloop import make_time_stepper as jstep

    monkeypatch.setattr(tc, "forward_route",
                        lambda plan, *a, **kw: ("steps", 1))
    monkeypatch.setattr(ac, "fused_segments", lambda *a, **kw: None)
    op, shape = _d3q19(), (24,) * 3
    arrays = _lbm_state(shape, 7)
    cot = np.random.default_rng(8).standard_normal((19,) + shape)
    chain = fused_time_chain(op, 2, LBM, periodic=True, fused_bwd=True)
    ins = _t(arrays, grad=True)
    out = chain(ins)
    (grad,) = torch.autograd.grad(out["f"], [ins["f"]],
                                  [torch.tensor(cot)])
    assert ladder_on_cpu[0] == ("steps", 2)
    step = jstep(jax_twin(op), LBM, lowering="jnp", periodic=True)

    def run(s):
        for _ in range(2):
            s = step(s)
        return s

    ref, pull = jax.vjp(run, {"f": jnp.asarray(arrays["f"])})
    (rcot,) = pull({"f": jnp.asarray(cot)})
    for got, want in ((out["f"].detach(), ref["f"]), (grad, rcot["f"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("kk", [1, None])
def test_stage_chain_rungs_match_jax(kk, monkeypatch):
    """A heat stage chain with Neumann frames, k=2, 24² f64: kernel 12 on
    the rung of 2 one-deep launches (kk=1, the plain version standing in
    for the kernel) or of 2 single-step cycles (kk None), the adjoint on
    the sequential-recompute rung, vs the JAX package's sequential
    stepping and ``jax.vjp``, rtol 1e-10."""
    from test_torch_stage import jax_vjp

    calls = []

    def kernel(plan, design="march"):
        plain = sc.plain_stage_chain(plan)

        def fn(st):
            calls.append(plan.k)
            return plain(st)
        return fn

    monkeypatch.setattr(sc, "on_card", lambda t: True)
    monkeypatch.setattr(sc, "check_stage_state", lambda plan, st: (
        st[plan.state_names[0]], tuple(st[plan.state_names[0]].shape)))
    monkeypatch.setattr(sa, "check_stage_state", sc.check_stage_state)
    monkeypatch.setattr(sc, "make_stage_kernel", kernel)
    monkeypatch.setattr(sc, "stage_route", lambda plan, *a: kk)
    monkeypatch.setattr(sa, "march_fits", lambda *a, **kw: False)
    stages = [(heat_step_op(dt=0.1, dtype="float64"), UC)]
    boundary = {"u": "neumann"}
    rng = np.random.default_rng(9)
    arrays = {"u": rng.standard_normal((24, 24))}
    cots = {"u": rng.standard_normal((24, 24))}
    chain = fused_stage_chain(stages, 2, boundary=boundary, fused_bwd=True)
    ins = _t(arrays, grad=True)
    out = chain(ins)
    (grad,) = torch.autograd.grad(out["u"], [ins["u"]],
                                  [torch.tensor(cots["u"])])
    assert calls == ([1, 1] if kk == 1 else [])
    ref, rgrads = jax_vjp(stages, 2, False, boundary, arrays, cots)
    for got, want in ((out["u"].detach(), ref["u"]), (grad, rgrads["u"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The window single step's reckoning.

def _heat_progs():
    op = heat_step_op(kappa_field=True)
    return forward_program(op), backward_program(op)


@pytest.mark.parametrize("shape, itemsize, fwd, bwd", [
    ((8192, 8192), 4, (4, 2), (4, 2)), ((4096, 4096), 8, (4, 1), (2, 1)),
    ((8191, 8190), 4, (4, 2), (4, 2)), ((70000, 64), 4, (4, 2), (4, 2)),
    ((64, 64), 4, (1, 1), (1, 1)), ((40, 17), 4, (1, 1), (1, 1)),
    ((4000, 17), 4, (4, 1), (4, 1)), ((16, 16), 8, (1, 1), (1, 1)),
    ((8192, 8192), 2, (4, 2), (4, 2))])
def test_window_tile_by_shape_and_type(shape, itemsize, fwd, bwd):
    """(R, V) of the κ-heat forward and backward: V at most
    ``WINDOW_LANE_BYTES`` of storage (8 in 2D) and ``WINDOW_LANES`` (2 in
    2D), but no wider than a warp's share
    of the contiguous extent, R the most rows whose live window registers
    fit ``WINDOW_REGS``; 1 × 1 where such tiles would be fewer than the
    card's SMs (64², 40×17, 16²)."""
    f, b = _heat_progs()
    assert ck.window_tile(f, shape, itemsize) == fwd
    assert ck.window_tile(b, shape, itemsize) == bwd


def test_window_tile_of_heavy_and_3d_bodies():
    """A body above ``WINDOW_HEAVY_OPS`` operations (D3Q19) takes one cell
    a thread; the 3D diffusion backward, with y in its window, 2 × 2 (of
    the 4-cell tiles that fit, the squarest), its forward 4 × 2, the 3D
    heat step 4 × 4."""
    op = _d3q19("float32")
    for prog in (forward_program(op), backward_program(op)):
        assert ck.window_tile(prog, (256,) * 3, 4) == (1, 1)
    d3 = diffusion3d_op()
    assert ck.window_tile(backward_program(d3), (384,) * 3, 4) == (2, 2)
    assert ck.window_tile(forward_program(d3), (384,) * 3, 4) == (4, 2)
    assert ck.window_tile(forward_program(heat_step3d_op()), (384,) * 3,
                          4) == (4, 4)


@pytest.mark.parametrize("mode", ["interior", "full", "periodic"])
def test_window_block_classification(mode):
    """A tile is interior iff its reads lie in the array (in the adjoint
    window where adjoint planes are read) and, in interior mode, its cells
    in the write window — counted here against a brute-force test of
    every tile of a ragged 70×300 grid."""
    f, b = _heat_progs()
    prog = f if mode == "interior" else b
    shape, tile = (70, 300), (2, 4)
    n = shape
    ghost = prog.ghost
    alo, ahi = ([1, 1], [69, 299]) if mode == "full" else ([0, 0], list(n))
    wlo = [lo for lo, _ in ghost]
    whi = [m - hi for m, (_, hi) in zip(n, ghost)]
    geo = ck.window_geometry(prog, n, mode, tile, alo, ahi, wlo, whi)
    ext = ck.window_extent(tile, 2)
    assert geo[:2] == [math.ceil(a / t) for a, t in zip(n, ext)]
    brute = 0
    for i in range(geo[0]):
        for j in range(geo[1]):
            o = (i * ext[0], j * ext[1])
            ok = all(o[d] + ext[d] <= n[d] for d in range(2))
            ok = ok and all(o[d] - 1 >= (alo[d] if mode == "full" else 0)
                            and o[d] + ext[d] + 1 <= (ahi[d] if mode == "full"
                                                      else n[d])
                            for d in range(2))
            if mode == "interior":
                ok = ok and all(o[d] >= wlo[d] and o[d] + ext[d] <= whi[d]
                                for d in range(2))
            brute += ok
    assert ck.interior_tiles(geo, tile, 2) == brute
    assert 0 < brute < geo[0] * geo[1]


def test_cell_form_stays_reachable_by_name():
    """The per-cell kernel is asked for by ``form="cell"`` only; an
    unknown form raises; CPU tensors run the plain version."""
    f, _ = _heat_progs()
    with pytest.raises(ValueError, match="unknown form"):
        make_cuda_stencil(f, form="slab")
    assert make_cuda_stencil(f).form == "window"
    assert make_cuda_stencil(f, form="cell").form == "cell"
    assert make_cuda_stencil(f, strategy="tiled").form == "slab"


# ---------------------------------------------------------------------------
# The warp march's reckoning and 2D routes.

def _wave_plan(k=4, periodic=False, probes=(("u_curr", 64),)):
    return tc.chain_plan(wave_step_op(dt=0.2), k, WAVE_CARRY, periodic,
                         list(probes))


def test_warp_tables_of_the_fwi_wave_chain():
    """The wave chain k=4 with a probe: planes (c, u_curr, u_prev);
    u_prev ← u_curr and u_curr ← u_next are renamings of streams (SMAP),
    the hoisted (dt·c)² one stream read by every stage; stage s runs
    2 + s rows behind the loads (2 rows of load-ahead, one row of reach a
    stage), the ring period is 5 rows."""
    tab = wc.warp_tables(_wave_plan())
    assert tab.lag == [0, 3, 4, 5, 6] and tab.lh == 2 and tab.p == 5
    assert tab.smap == [[0, 1, 2], [0, 4, 1], [0, 5, 4], [0, 6, 5],
                        [0, 7, 6]]
    assert tab.need == [3, 5, 4, 5, 3, 3, 3, 1]
    assert tab.store == [False, True, True] and tab.probes == [1]
    assert tab.lead == 4 and tab.reach == 1 and tab.hreach == 0


@pytest.mark.parametrize("shape", [(8192, 8192), (8191, 8190), (70, 300),
                                   (4096, 100), (33, 61)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_warp_geometry_covers_the_domain(shape, itemsize):
    """The strips cover the columns (each owns 32V − 2·halo, halo ≥ k ×
    the lateral reach, a whole number of V), the segments the rows, and
    an item runs at least its rows plus the lead-in and the last stage's
    lag, in whole ring periods; the V from the built kernel's registers
    where given (a spilling V is skipped)."""
    plan = _wave_plan()
    tab = wc.warp_tables(plan)
    g = wc.warp_geometry(plan, shape, itemsize)
    assert g.v in wc.lane_widths(itemsize)
    assert g.halo % g.v == 0 and g.halo >= plan.k * tab.reach
    assert g.owned == 32 * g.v - 2 * g.halo > 0
    assert g.nstrip * g.owned >= shape[1] > (g.nstrip - 1) * g.owned
    assert g.nseg * g.seg >= shape[0] > (g.nseg - 1) * g.seg
    assert g.items == g.nstrip * g.nseg
    assert g.steps % tab.p == 0 and g.steps >= g.seg + tab.lead + tab.lag[-1]
    assert 0 < g.owned_share <= 1
    built = {v: (64, 0) for v in wc.lane_widths(itemsize)}
    built[max(built)] = (200, 96)  # spills
    g2 = wc.warp_geometry(plan, shape, itemsize, built)
    assert g2.v != max(built)


def test_forward_design_in_2d():
    """A 2D chain takes the first of ``DESIGNS_2D`` that fits: the warp
    march at the FWI shape; with no warp march fitting (registers), the
    next; where none fits, None, and the route takes a shallower
    chain."""
    plan = _wave_plan()
    fits = tc.fitting_designs(plan, (8192, 8192), 4)
    assert set(fits) == {"warp", "box", "march"}
    assert tc.forward_design(plan, (8192, 8192), 4) == tc.DESIGNS_2D[0]
    assert tc.forward_route(plan, (8192, 8192), 4) == (tc.DESIGNS_2D[0], 4)
    with pytest.raises(ValueError, match="the warp march runs 2D"):
        tc.make_chain_kernel(tc.chain_plan(diffusion3d_op(), 2, UC, False),
                             "warp")
    with pytest.raises(ValueError, match="z-streaming kernel is 3D"):
        tc.make_chain_kernel(plan, "stream")


def test_2d_route_falls_back_when_nothing_fits(monkeypatch):
    """With no 2D design fitting at depth 4 but the warp march at depth 2,
    the route is 2 launches of the 2-deep warp march; with nothing fitting
    at any depth, 4 single steps."""
    plan = _wave_plan()
    real = tc.fitting_designs
    monkeypatch.setattr(tc, "fitting_designs", lambda p, *a: (
        {} if p.k > 2 else {"warp": 0.5}))
    assert tc.forward_route(plan, (8192, 8192), 4) == ("warp", 2)
    monkeypatch.setattr(tc, "fitting_designs", lambda p, *a: {})
    assert tc.forward_route(plan, (8192, 8192), 4) == ("steps", 1)
    monkeypatch.setattr(tc, "fitting_designs", real)


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with "
                    "nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


def _close_t(got, ref, dtype):
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    if dtype == torch.bfloat16:
        got, tol = got.float(), 0.05
    torch.testing.assert_close(got, ref.to(got.dtype), rtol=tol,
                               atol=tol * ref.abs().max().item())


WARP_CASES = [
    ("wave-probe", lambda dt: wave_step_op(dt=0.2, dtype=dt), WAVE_CARRY, 4,
     False, [("u_curr", 17)], (70, 300)),
    ("wave-periodic", lambda dt: wave_step_op(dt=0.2, dtype=dt), WAVE_CARRY,
     3, True, [("u_curr", 5)], (41, 150)),
    ("heat-k8-periodic", lambda dt: heat_step_op(dt=0.1, dtype=dt), UC, 8,
     True, [], (64, 200)),
    ("kheat-invariant-probe",
     lambda dt: heat_step_op(dt=0.1, kappa_field=True, dtype=dt), UC, 2,
     False, [("u", 3), ("kappa", 30)], (33, 261)),
]


# (dtype, V): float64 lanes hold at most 2 columns (16 bytes)
WARP_LANES = [(torch.float64, 1), (torch.float64, 2)] + [
    (dt, v) for dt in (torch.float32, torch.bfloat16) for v in (1, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, lanes", WARP_LANES,
                         ids=[f"{str(d)[6:]}-V{v}" for d, v in WARP_LANES])
@pytest.mark.parametrize("case", WARP_CASES, ids=[c[0] for c in WARP_CASES])
def test_warp_march_matches_plain_version(case, dtype, lanes, cuda_device):
    """The warp march at each V against ``plain_time_chain`` (bf16 against
    the float32 plain version on the same inputs, to 0.05), probes,
    invariant planes returned as given; one launch counted.  A V whose
    built kernel spills is refused by the reckoning (ValueError)."""
    _, make, carry, k, periodic, probes, shape = case
    plan = tc.chain_plan(make("float32"), k, carry, periodic, probes)
    rng = np.random.default_rng(3)
    st = {f.name: torch.tensor(0.1 * rng.standard_normal(
        storage_shape(f, shape)), dtype=dtype, device=cuda_device)
        for f in plan.program.input_fields}
    for n in ("c", "kappa"):
        if n in st:
            st[n] = 1.0 + st[n].abs()
    kern = wc.make_warp_chain_kernel(plan, tc, lanes=lanes)
    before = tc.LAUNCHES
    regs, spill = kern.library_regs(dtype)[lanes]
    if spill or regs > wc.MAX_REGS:
        # the reckoning refuses a V whose kernel spills
        with pytest.raises(ValueError, match="no warp march fits"):
            kern(st)
        return
    got, recs = kern(st)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    ref_st = {n: t.float() if dtype == torch.bfloat16 else t
              for n, t in st.items()}
    ref, rrecs = tc.plain_time_chain(plan)(ref_st)
    for n in plan.in_names:
        if n in plan.invariant:
            assert got[n] is st[n]
        _close_t(got[n], ref[n], dtype)
    for a, b in zip(recs, rrecs):
        _close_t(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_rungs_on_the_card(dtype, cuda_device, monkeypatch):
    """Each rung of the forward ladder on the card — 2 launches of the
    2-deep warp march, 4 single steps — against ``plain_time_chain``,
    launches counted exactly."""
    plan = _wave_plan(probes=(("u_curr", 9),))
    rng = np.random.default_rng(4)
    st = {n: torch.tensor(0.1 * rng.standard_normal((40, 130)), dtype=dtype,
                          device=cuda_device) for n in plan.in_names}
    st["c"] = 1.0 + st["c"].abs()
    ref, rrecs = tc.plain_time_chain(plan)(st)
    for route, counter, launches in ((("warp", 2), tc, 2),
                                     (("steps", 1), ck, 4)):
        monkeypatch.setattr(tc, "forward_route",
                            lambda *a, r=route, **kw: r)
        fn = tc.make_chain_kernel(plan)
        before = counter.LAUNCHES
        got, recs = fn(st)
        torch.cuda.synchronize()
        assert counter.LAUNCHES == before + launches
        assert (fn.design, fn.depth) == route
        for n in plan.in_names:
            _close_t(got[n], ref[n], dtype)
        _close_t(recs[0], rrecs[0], dtype)


WINDOW_CASES = [
    # (id, program kind, kw, shape)
    ("fwd-interior", "fwd", {}, (70, 300)),
    ("bwd-full-mask", "bwd", "mask", (70, 300)),
    ("fwd-periodic", "fwd", {"periodic": True}, (41, 130)),
    ("bwd-periodic", "bwd", {"full_domain": True, "periodic": True},
     (41, 130)),
    ("fwd-tall", "fwd", {}, (70000, 64)),
    ("bwd-tall", "bwd", "mask", (66000, 70)),
    ("fwd-3d", "fwd3", {}, (9, 14, 300)),
    ("bwd-3d", "bwd3", "mask", (9, 14, 300)),
    ("bwd-3d-periodic", "bwd3", {"full_domain": True, "periodic": True},
     (6, 9, 70)),
    # periodic extents below a tile's span: a tile's cells past the edge
    # read more than one extent past it
    ("fwd-periodic-small", "fwd", {"periodic": True}, (8, 64)),
    ("bwd-periodic-small", "bwd", {"full_domain": True, "periodic": True},
     (5, 40)),
    ("bwd-3d-periodic-small", "bwd3", {"full_domain": True,
                                       "periodic": True}, (16, 2, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=[c[0] for c in WINDOW_CASES])
def test_window_kernel_matches_plain_version(case, dtype, cuda_device):
    """The window single step against its plain version in every mode,
    interior and edge tiles (interior tiles exist at the larger shapes;
    the small periodic ones are smaller than a tile), 2D and 3D, a
    leading extent above 65535, with an expanded (stride-0)
    cotangent in the backward cases; at the picked tile (1 × 1 where the
    grid is too small to fill the card) and at 4 × 2 cells a thread; PR
    1's per-cell kernel on the same inputs too."""
    _, kind, kw, shape = case
    d3 = diffusion3d_op()
    prog = {"fwd": _heat_progs()[0], "bwd": _heat_progs()[1],
            "fwd3": forward_program(d3), "bwd3": backward_program(d3)}[kind]
    if kw == "mask":
        kw = {"full_domain": True, "adjoint_mask_ghost": prog.ghost}
    rng = np.random.default_rng(5)
    ins = {}
    for f in prog.input_fields:
        a = rng.standard_normal(storage_shape(f, shape))
        if f.name == "kappa":
            a = 1.0 + np.abs(a)
        t = torch.tensor(a, dtype=dtype, device=cuda_device)
        if f.name.startswith("diff"):  # an expanded cotangent
            t = t[..., :1].expand(t.shape)
        ins[f.name] = t
    ref_in = {n: t.float() if dtype == torch.bfloat16 else t
              for n, t in ins.items()}
    ref = make_torch_stencil(prog, **kw)(ref_in)
    for form, window in ((None, None), (None, (4, 2)), ("cell", None)):
        got = make_cuda_stencil(prog, form=form, window=window, **kw)(ins)
        torch.cuda.synchronize()
        for n, r in ref.items():
            _close_t(got[n], r, dtype)


def _vector_op(layout):
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field

    v = Field("v", 2, index_shape=(2,), layout=layout)
    w = Field("w", 2, index_shape=(2,), layout=layout)
    c = Field("c", 2)
    return AutoDiffOp([
        Assignment(w.center(0), v[1, 0](0) * c[0, 0] - v[0, -1](1)),
        Assignment(w.center(1), v[0, 1](0) * v[-1, 0](1) + c[0, 1]),
    ], op_name=f"vec_{layout}")


def _accum_op(mode=None):
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

    x, y, k = fields("x, y, k", 2)
    kw = ({"diff_mode": "transposed-forward"} if mode
          else {"time_constant_fields": [k]})
    return AutoDiffOp([Assignment(y.center, k[1, 0] * x[1, 0]
                                  + k[-1, 0] * x[-1, 0] * x[0, 0])],
                      op_name="tfmad" if mode else "accum", **kw)


OP_CASES = [
    ("vec-aos", lambda: _vector_op("aos")),
    ("vec-soa", lambda: _vector_op("soa")),
    ("accumulation", _accum_op),
    ("staged-tfmad", lambda: _accum_op("tfmad")),
    ("constant-field", lambda: wave_step_op(dt=0.2, grad_c=False)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_window_kernel_index_accumulation_staged_constant(case, dtype,
                                                          cuda_device):
    """The window kernel on AoS and SoA index fields, an accumulation
    (+=) output, the staged TF_MAD backward (every program of the
    collection) and a declared-constant field, forward interior and
    backward full+mask, at a shape with interior tiles, at the picked
    tile and at 2 × 2 cells a thread, against the plain versions."""
    from pystencils_autodiff_tpu_torch.ops.common import backward_programs

    op = case[1]()
    shape = (70, 300)
    progs = [(forward_program(op), {})] + [
        (p, {"full_domain": True, "adjoint_mask_ghost": p.ghost})
        for p in backward_programs(op)]
    rng = np.random.default_rng(11)
    for prog, kw in progs:
        ins = {f.name: torch.tensor(rng.standard_normal(storage_shape(
            f, shape)), dtype=dtype, device=cuda_device)
            for f in prog.input_fields}
        ref = make_torch_stencil(prog, **kw)(ins)
        for window in (None, (2, 2)):
            got = make_cuda_stencil(prog, window=window, **kw)(ins)
            torch.cuda.synchronize()
            for n, r in ref.items():
                _close_t(got[n], r, dtype)
