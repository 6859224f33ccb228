"""Rows 8 and 11 on the dim-0 march: the 2D two-phase route and the 3D
twin-accum route of ``fused_chain_vjp`` run the two-phase mode of the
march (``ops/stage_march.py``, ``csrc/stage_march.cuh``) over the chain
seen as a one-stage cycle repeated k times (``chain_march_plans``), with
probe rows injected in the march and 3D periodic chains wrapped.

On the CPU these tests hold the one-stage plan's plain version against the
chain's (f64, 1e-12) and, through ``fused_chain_vjp``, against the JAX
package; the reckoning at the main paths' full shapes (one time segment,
an owned share at least the box's, blocks that fill whole rounds of the
card's resident slots); and the march itself, emulated over rings of rows
with its probes and its 3D wrap, against ``plain_chain_vjp``.  The
``cuda``-marked tests at the end hold the kernels against their plain
versions on the card (skipped without one).  Inputs are made from a seed
with numpy."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                  heat_step3d_op,
                                                  wave_step_op)
from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
from pystencils_autodiff_tpu_torch.ops import fused_chain_vjp
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_march as sm
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta
from test_torch_stage_march import emulate_march
from torch_jax_twin import jax_twin

UC = {"u": "u_next"}
MULTI_CARRY = {"u": "u_next", "v": "u_next"}
S2, S3 = (24, 40), (12, 10, 14)


def _multi_carrier(dtype="float64"):
    """u_next = u·u[1,0] + 0.1·v, carried into both u and v."""
    u, v = Field("u", 2, dtype=dtype), Field("v", 2, dtype=dtype)
    out = Field("u_next", 2, dtype=dtype)
    return AutoDiffOp([Assignment(out.center, u[0, 0] * u[1, 0]
                                  + 0.1 * v[0, 0])], op_name="multi_carrier")


OPS = {
    "wave": lambda dt="float64": wave_step_op(dt=0.2, dtype=dt),
    "kdiff": lambda dt="float64": diffusion3d_op(dt=0.05, dtype=dt),
    "heat3d": lambda dt="float64": heat_step3d_op(dtype=dt),
    "multi": _multi_carrier,
}
CARRIES = {"wave": WAVE_CARRY, "kdiff": UC, "heat3d": UC,
           "multi": MULTI_CARRY}


def _arrays(names, shape, seed):
    rng = np.random.default_rng(seed)
    st = {n: 0.3 * rng.standard_normal(shape) for n in names}
    if "c" in st:
        st["c"] = 2.0 + 0.1 * rng.standard_normal(shape) ** 2
    if "kappa" in st:
        st["kappa"] = 1.0 + 0.5 / (1.0 + np.exp(-rng.standard_normal(shape)))
    return st


def _t(arrays, device="cpu", dtype=torch.float64):
    return {n: torch.tensor(np.asarray(a), dtype=dtype, device=device)
            for n, a in arrays.items()}


def _close(got, ref, rtol, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref.detach().cpu() if isinstance(ref, torch.Tensor)
                     else ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _case(name, k, periodic, shape, probes=(), seed=1):
    """(plan, state, cots, probe cots) in f64 on the CPU."""
    op = OPS[name]()
    plan = tc.chain_plan(op, k, CARRIES[name], periodic, list(probes))
    st = _t(_arrays(plan.in_names, shape, seed))
    cots = _t(_arrays(plan.in_names, shape, seed + 10))
    rng = np.random.default_rng(seed + 20)
    pcs = tuple(torch.tensor(rng.standard_normal((k, shape[-1])))
                for _ in probes)
    return plan, st, cots, pcs


# ---------------------------------------------------------------------------
# The one-stage plan computes the chain's function.

ONE_STAGE = [
    # (id, op, k, periodic, shape, route)
    ("wave-k4-bounded", "wave", 4, False, S2, "two_phase"),
    ("wave-k4-periodic", "wave", 4, True, S2, "twin_accum"),
    ("kdiff-k2-bounded", "kdiff", 2, False, S3, "twin_accum"),
    ("kdiff-k2-periodic", "kdiff", 2, True, S3, "twin_accum"),
    ("heat3d-bounded-twin-k2", "heat3d", 2, False, S3, "twin_accum"),
    ("multi-carrier-k2", "multi", 2, False, (20, 16), "two_phase"),
]


@pytest.mark.parametrize("case", ONE_STAGE, ids=[c[0] for c in ONE_STAGE])
def test_one_stage_plan_computes_the_chain(case):
    """``plain_stage_chain_vjp`` of ``chain_march_plans(plan)`` — one stage,
    no BC events, the chain's periodicity (3D periodic wrapped) — equals
    ``plain_chain_vjp`` and, on the twin-accum route,
    ``plain_twin_accum_vjp``: state and every cotangent, f64 to 1e-12.
    The wanted planes are the differentiated invariant ones (κ, c); the
    cotangent of any other field the march does not carry passes through."""
    _, name, k, periodic, shape, route = case
    plan, st, cots, _ = _case(name, k, periodic, shape)
    sp, sap = sm.chain_march_plans(plan)
    assert len(sp.cycle) == 1 and sp.cycle[0].kind == "stage"
    assert sp.invariant == plan.invariant and sp.periodic == periodic
    grads = {f.corresponding_forward_field.name
             for f in plan.op.backward_output_fields}
    assert sap.wanted == grads & plan.invariant
    ref_s, ref_c = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots)
    got_s, got_c = sa.plain_stage_chain_vjp(sap)(
        st, {n: cots[n] for n in sap.cot_names})
    refs = [(ref_s, ref_c)]
    g = fused_chain_vjp(plan.op, k, CARRIES[name], periodic=periodic)
    assert g.route == route
    if route == "twin_accum":
        refs.append(ta.plain_twin_accum_vjp(g.plan)(st, cots))
    for rs, rc in refs:
        for n in plan.in_names:
            _close(got_s[n], rs[n], 1e-12, f"state {n}")
            _close(got_c.get(n, cots[n]), rc[n], 1e-12, f"cot {n}")


def test_3d_periodic_stage_chains_stay_refused():
    """The public stage chains keep refusing 3D periodic, as the JAX
    package's do; only the one-stage cycle of a chain wraps in 3D."""
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain

    with pytest.raises(ValueError, match="2D domains only"):
        fused_stage_chain([(heat_step3d_op(), UC)], 2, periodic=True)
    plan = tc.chain_plan(heat_step3d_op(), 2, UC, True)
    assert sm.chain_march_plans(plan)[0].periodic


@pytest.mark.parametrize("route", ["two_phase", "twin_accum"])
def test_each_route_matches_jax(route):
    """One case of each route through ``fused_chain_vjp`` on CPU tensors
    (the plain version the march is held against on the card) vs the JAX
    package's ``fused_chain_vjp`` in interpret mode, rtol 1e-10: the
    bounded wave with a probe row (two-phase) and the periodic κ-diffusion
    (the 3D twin-accum route)."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    if route == "two_phase":
        name, k, periodic, shape, probes = "wave", 4, False, (48, 32), \
            [("u_curr", 17)]
    else:
        name, k, periodic, shape, probes = "kdiff", 2, True, S3, []
    plan, st, cots, pcs = _case(name, k, periodic, shape, probes, seed=3)
    g = fused_chain_vjp(plan.op, k, CARRIES[name], periodic=periodic,
                        probes=probes or None)
    assert g.route == route
    got_s, got_c = g(st, cots, pcs)
    kw = {"tile_rows": 16} if name == "wave" else {}
    jg = jvjp(jax_twin(plan.op), k, CARRIES[name], periodic=periodic,
              interpret=True, probes=probes or None, **kw)
    jst, jcot = jg({n: jnp.asarray(t.numpy()) for n, t in st.items()},
                   {n: jnp.asarray(t.numpy()) for n, t in cots.items()},
                   *([tuple(jnp.asarray(p.numpy()) for p in pcs)]
                     if pcs else []))
    for n in plan.in_names:
        _close(got_s[n], np.asarray(jst[n]), 1e-10, f"state {n}")
        _close(got_c[n], np.asarray(jcot[n]), 1e-10, f"cot {n}")


# ---------------------------------------------------------------------------
# The reckoning at the main paths' shapes.

MAIN = [
    # (id, op, k, periodic, shape, probes, the box's owned share)
    ("fwi-wave-k4-8192-probe", "wave", 4, False, (8192, 8192),
     [("u_curr", 64)], 0.533),
    ("config2-kdiff-k2-384-bounded", "kdiff", 2, False, (384,) * 3, [],
     0.389),
    ("config2-kdiff-k2-384-periodic", "kdiff", 2, True, (384,) * 3, [],
     0.389),
]


@pytest.mark.parametrize("case", MAIN, ids=[c[0] for c in MAIN])
def test_main_paths_fit_one_segment_and_own_more_than_the_box(case):
    """At the main paths' full shapes in f32 the march of the k-deep chain
    fits (one time segment, on the route the interpret path picks), owns
    at least what the box design owned (0.533 for the wave's two-phase
    tile, 0.389 for the twin-accum tile), and so it does at every
    register count the reckoning may be given."""
    _, name, k, periodic, shape, probes, box = case
    op = OPS[name]("float32")
    plan = tc.chain_plan(op, k, CARRIES[name], periodic, probes)
    sp, sap = sm.chain_march_plans(plan)
    g = fused_chain_vjp(op, k, CARRIES[name], periodic=periodic,
                        probes=probes or None)
    assert g.route == ("two_phase" if len(shape) == 2 else "twin_accum")
    assert g.segments_for(shape, 4) == 1
    for regs in (None, 64, 128, 255):
        mg = sm.stage_march_geometry(sp, shape, 4, sap, regs=regs)
        assert mg.owned_share >= box, (regs, mg.owned_share)
        assert mg.smem <= tc.SMEM_BUDGET
        assert regs is not None or (mg.threads, mg.blocks_per_sm) == (256, 1)
    # the box design's owned share at the same shape, as its picker reckons
    if len(shape) == 2:
        _, (tile, ext, _) = tc.chain_geometry(
            plan, shape, 4, **ac.two_phase_kw(ac.AdjointPlan(plan)))
    else:
        _, (tile, ext, _) = ta.twin_geometry(g.plan, shape, 4)
    assert abs(math.prod(tile) / math.prod(ext) - box) < 1e-3


@pytest.mark.parametrize("regs", [None, 48, 96, 200])
@pytest.mark.parametrize("case", MAIN, ids=[c[0] for c in MAIN])
def test_blocks_fill_whole_rounds_of_resident_slots(case, regs):
    """The dim-0 segments are picked by rounds: the blocks (tiles ×
    segments) fill ``rounds`` rounds of the card's resident slots (132 SMs
    × blocks per SM) so that one more segment would need another round,
    or no segment may be shorter; the block size and residency are ones
    the registers allow (at most 65,536 a SM, 2,048 threads); the full
    shapes take several rounds (a launch's stragglers cost a part of a
    block, not of a launch)."""
    _, name, k, periodic, shape, probes, _ = case
    plan = tc.chain_plan(OPS[name]("float32"), k, CARRIES[name], periodic,
                         probes)
    sp, sap = sm.chain_march_plans(plan)
    mg = sm.stage_march_geometry(sp, shape, 4, sap, regs=regs)
    s3 = (shape[0], 1, shape[1]) if len(shape) == 2 else shape
    ntiles = math.ceil(s3[1] / mg.tile[0]) * math.ceil(s3[2] / mg.tile[1])
    slots = sm.NUM_SMS * mg.blocks_per_sm
    blocks = ntiles * mg.nseg
    assert mg.rounds == math.ceil(blocks / slots)
    halo0 = sm._halo0(mg.program, sm._lags_and_extents(mg.program))
    longest = s3[0] // max(1, halo0)
    assert blocks + ntiles > mg.rounds * slots or mg.nseg >= longest
    assert mg.zlen * mg.nseg >= s3[0] > mg.zlen * (mg.nseg - 1)
    assert mg.rounds >= 2
    if regs is not None:
        assert (mg.threads * mg.blocks_per_sm <= sm.THREADS_PER_SM
                and regs * mg.threads * mg.blocks_per_sm <= sm.REGS_PER_SM)


def test_rounds_reckoning_by_hand():
    """``_segments`` on a hand-worked case: 144 tiles over 132 slots and
    384 rows with a dim-0 halo of 8, each launch paying half a block more
    (``ROUND_TAIL``): one segment takes 2 rounds of 392 rows, (2 + 0.5) ×
    392 = 980; 2 segments 3.5 × 200 = 700; 3, 4, 5, 6, 7 segments 612,
    572, 552.5, 540, 535.5; 8 segments fill 9 rounds (1,152 of 1,188
    slots) of 48 + 8 rows, 9.5 × 56 = 532, the least; 9 segments 535.5; a
    forced count is taken as given."""
    assert sm.ROUND_TAIL == 0.5
    assert sm._segments(144, 384, 8, 132) == (8, 9, 532.0)
    sm_forced = sm.MARCH_SEGMENTS
    try:
        sm.MARCH_SEGMENTS = 2
        assert sm._segments(144, 384, 8, 132) == (2, 3, 700.0)
    finally:
        sm.MARCH_SEGMENTS = sm_forced


def test_barriers_only_where_a_later_part_reads_the_pass():
    """The wave's k=4 march: every forward part reads the one before it
    and every reverse part the reverse part after it in time, so each
    takes a barrier — but the first reverse part reads state 3 and cot_4,
    not state 4: it shares the last forward part's pass (one barrier less
    a step); the probe rows join the cotangents of states 1–3 in the
    reverse parts of events 1–3 and cot_4 at the load.  The forward mode
    of the same plan records the probe row after each stage instead (a P
    part hosted by each F part)."""
    plan = tc.chain_plan(OPS["wave"](), 4, WAVE_CARRY, False,
                         [("u_curr", 5)])
    sp, sap = sm.chain_march_plans(plan)
    mp = sm.march_program(sp, sap)
    kinds = [sm.PART_NAMES[p.kind] for p in mp.parts]
    assert kinds == ["F", "F", "F", "F", "S", "R", "R", "R", "R", "SC"]
    assert [p.sync for p in mp.parts] == [True, True, True, False, False,
                                          True, True, True, False, False]
    assert [p.probe_stage for p in mp.parts if p.kind == sm.R] == [2, 1, 0,
                                                                    -1]
    assert mp.probe_slots == [sap.cslot[sp.planes_of("u_curr")[0]]]
    fwd = sm.march_program(sp)
    assert [sm.PART_NAMES[p.kind] for p in fwd.parts] == ["F", "P"] * 4 + [
        "S"]


# ---------------------------------------------------------------------------
# The march emulated over rings of rows, with probes and the 3D wrap.

EMU = [
    # (id, op, k, periodic, shape, probes, forced dim-0 segments, rows or
    #  planes a step)
    ("wave-k4-probe-1seg", "wave", 4, False, S2, [("u_curr", 9)], 1, 3),
    ("wave-k4-probe-3seg", "wave", 4, False, S2, [("u_curr", 9)], 3, 3),
    ("wave-k4-probe-edge-rows-3seg", "wave", 4, False, S2,
     [("u_curr", 0), ("u_prev", 23)], 3, 3),
    ("wave-k4-periodic-probe-3seg", "wave", 4, True, S2, [("u_curr", 1)],
     3, 3),
    ("kdiff-k2-bounded-3seg", "kdiff", 2, False, S3, [], 3, 2),
    ("kdiff-k2-bounded-1plane-3seg", "kdiff", 2, False, S3, [], 3, 1),
    ("kdiff-k2-periodic-3seg", "kdiff", 2, True, S3, [], 3, 2),
    ("heat3d-twin-k2-periodic-1seg", "heat3d", 2, True, S3, [], 1, 2),
]


@pytest.mark.parametrize("form", ["gather", "local"])
@pytest.mark.parametrize("case", EMU, ids=[c[0] for c in EMU])
def test_march_emulator_with_probes_and_3d_wrap(case, form, monkeypatch):
    """The two-phase march of the one-stage chain, emulated over rings of
    rows (``emulate_march``: lags, ring depths, dim-0 extents, the probe
    rows at the cot_k load and in the reverse parts' epilogues, wrapped
    rows in periodic mode), equals ``plain_chain_vjp`` with the probe
    cotangents, f64 to 1e-12, in either reverse form, whole or as 3 dim-0
    segments (a probe row then also lies in the halo of the segment below
    or above it), 3 rows (2D) or 1 or 2 planes (3D) a step."""
    _, name, k, periodic, shape, probes, nseg, chunk = case
    monkeypatch.setattr(sm, "CHUNKS_2D", (chunk,))
    monkeypatch.setattr(sm, "CHUNKS_3D", (chunk,))
    monkeypatch.setattr(sm, "MARCH_SEGMENTS", nseg)
    plan, st, cots, pcs = _case(name, k, periodic, shape, probes, seed=5)
    sp, sap = sm.chain_march_plans(plan)
    mg = sm.stage_march_geometry(sp, shape, 8, sap, form)
    assert (mg.nseg, mg.chunk) == (nseg, chunk)
    got_s, got_c = emulate_march(mg, st, {n: cots[n] for n in sap.cot_names},
                                 pcs)
    ref_s, ref_c = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots, pcs)
    for n in set(plan.in_names) - plan.invariant:
        _close(got_s[n], ref_s[n], 1e-12, f"state {n}")
    for n in sap.cot_names:
        _close(got_c[n], ref_c[n], 1e-12, f"cot {n}")


# ---------------------------------------------------------------------------
# On the card: the march kernels of both routes against their plain
# versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the march kernels are compiled "
                    "with nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


CARD = [
    # (id, op, k, periodic, shape, probes)
    ("wave-k3-bounded-probe", "wave", 3, False, (131, 70), [("u_curr", 60)]),
    ("wave-k3-periodic-probes", "wave", 3, True, (131, 70),
     [("u_curr", 0), ("u_prev", 130)]),
    ("multi-carrier-k2", "multi", 2, False, (67, 45), []),
    ("kdiff-k2-bounded", "kdiff", 2, False, (11, 9, 37), []),
    ("kdiff-k2-periodic", "kdiff", 2, True, (11, 9, 37), []),
    ("heat3d-twin-k2", "heat3d", 2, False, (11, 9, 37), []),
]


def _card_case(case, dtype, device, seed=1):
    _, name, k, periodic, shape, probes = case
    op = OPS[name]()
    plan = tc.chain_plan(op, k, CARRIES[name], periodic, probes)
    st = _t(_arrays(plan.in_names, shape, seed), device, dtype)
    cots = _t(_arrays(plan.in_names, shape, seed + 10), device, dtype)
    rng = np.random.default_rng(seed + 20)
    pcs = tuple(torch.tensor(rng.standard_normal((k, shape[-1])),
                             dtype=dtype, device=device) for _ in probes)
    return plan, st, cots, pcs


def _route_kernel(plan):
    if plan.program.ndim == 2:
        return ac.make_adjoint_kernel(ac.AdjointPlan(plan)), ac
    carry = {n: s for n, s in plan.next_src.items() if s != n}
    tp = fused_chain_vjp(plan.op, plan.k, carry, periodic=plan.periodic).plan
    return ta.make_twin_accum_kernel(tp), ta


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CARD, ids=[c[0] for c in CARD])
def test_chain_march_kernels_match_plain_versions(case, dtype, tiles,
                                                  cuda_device, monkeypatch):
    """Each route's march kernel vs ``plain_chain_vjp`` on the same CUDA
    tensors, with probes (small strips or tiles, 2 rows or planes a step
    and 3 dim-0 segments forced, or the picked march); one launch counted
    on the route's module; rtol 1e-12 in f64, 1e-5 with atol 1e-5·max|ref|
    in f32."""
    if tiles == "small":
        monkeypatch.setattr(sm, "STRIP_COLS", (16,))
        monkeypatch.setattr(sm, "TILES_3D", ((4, 8),))
        monkeypatch.setattr(sm, "CHUNKS_2D", (2,))
        monkeypatch.setattr(sm, "CHUNKS_3D", (2,))
        monkeypatch.setattr(sm, "MARCH_SEGMENTS", 3)
    plan, st, cots, pcs = _card_case(case, dtype, cuda_device)
    kern, mod = _route_kernel(plan)
    before = mod.LAUNCHES
    got_s, got_c = (kern(st, cots, pcs) if plan.program.ndim == 2
                    else kern(st, cots))
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1 and kern.design == "march"
    ref_s, ref_c = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots, pcs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n in plan.invariant:
        assert got_s[n] is st[n]
    for a, b in [(got_s[n], ref_s[n]) for n in ref_s] + [
            (got_c[n], ref_c[n]) for n in ref_c]:
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD, ids=[c[0] for c in CARD])
def test_chain_march_kernels_in_bf16(case, cuda_device):
    """The march kernels on bf16 state (stored bf16, computed in float) vs
    the plain version in f32 on the same bf16-rounded inputs: within 0.05
    of max |ref|."""
    plan, st, cots, pcs = _card_case(case, torch.bfloat16, cuda_device)
    kern, _ = _route_kernel(plan)
    got_s, got_c = (kern(st, cots, pcs) if plan.program.ndim == 2
                    else kern(st, cots))
    torch.cuda.synchronize()
    f32 = lambda d: {n: t.float() for n, t in d.items()}  # noqa: E731
    ref_s, ref_c = ac.plain_chain_vjp(ac.AdjointPlan(plan))(
        f32(st), f32(cots), tuple(p.float() for p in pcs))
    for a, b in [(got_s[n], ref_s[n]) for n in ref_s] + [
            (got_c[n], ref_c[n]) for n in ref_c]:
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 0.05 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["wave", "kdiff"])
def test_time_segments_on_the_card(name, dtype, cuda_device, monkeypatch):
    """Where the reckoning finds no k-deep march (one candidate geometry,
    the shared memory cut to what the half-depth march needs),
    ``fused_chain_vjp`` runs 2 time segments on either route: one forward
    chain launch for the checkpoint and 2 march launches, equal to the
    plain k-deep version (rtol 1e-12 in f64, 1e-5 in f32); the route names
    are the interpret path's."""
    monkeypatch.setattr(sm, "STRIP_COLS", (16,))
    monkeypatch.setattr(sm, "TILES_3D", ((4, 8),))
    monkeypatch.setattr(sm, "CHUNKS_2D", (1,))
    if name == "wave":
        case = ("w", "wave", 4, False, (131, 70), [("u_curr", 60)])
    else:
        case = ("k", "kdiff", 4, False, (11, 9, 37), [])
    plan, st, cots, pcs = _card_case(case, dtype, cuda_device, seed=7)
    half = ac.plan_at_depth(plan, 2)
    sp, sap = sm.chain_march_plans(half)
    monkeypatch.setattr(sm, "SMEM_BUDGET", sm.stage_march_geometry(
        sp, st[plan.in_names[0]].shape, dtype.itemsize, sap).smem)
    g = fused_chain_vjp(plan.op, 4, CARRIES[name], periodic=False,
                        probes=case[5] or None)
    assert g.route == ("two_phase" if name == "wave" else "twin_accum")
    mod = ac if name == "wave" else ta
    before = (tc.LAUNCHES, mod.LAUNCHES)
    got_s, got_c = g(st, cots, pcs)
    torch.cuda.synchronize()
    assert g.segments == 2
    assert (tc.LAUNCHES, mod.LAUNCHES) == (before[0] + 1, before[1] + 2)
    ref_s, ref_c = ac.plain_chain_vjp(ac.AdjointPlan(plan))(st, cots, pcs)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b in [(got_s[n], ref_s[n]) for n in ref_s] + [
            (got_c[n], ref_c[n]) for n in ref_c]:
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * b.abs().max().item())
