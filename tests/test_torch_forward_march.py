"""Row 7 and row 10 on the dim-0 march: the 3D forward chain runs the
march's forward mode over the chain seen as a one-stage cycle repeated k
times (``stage_march.chain_stage_plan``), with its probe lines recorded in
the march (``P`` parts), and the 2D periodic twin-accum route of
``fused_chain_vjp`` runs the march's two-phase mode.

On the CPU these tests hold the forward march, emulated over rings of
rows (``emulate_march``), against ``plain_time_chain`` — state and probe
records, 2D and 3D, bounded and periodic, probe rows and lines on edge
rows and in a segment's halo, 1 and 3 dim-0 segments, f64 to 1e-12 —; the
plain versions the kernels are held against on the card against the JAX
package in f64 (rtol 1e-10); the design each shape takes (a host
reckoning at the main paths' full shapes); and the part program.  The
``cuda``-marked tests at the end hold every design of the forward chain
and the 2D periodic twin march against their plain versions on the card
(skipped without one).  Inputs are made from a seed with numpy."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                  d3q19_bgk_op,
                                                  diffusion3d_op,
                                                  heat_step3d_op,
                                                  wave_step_op)
from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
from pystencils_autodiff_tpu_torch.ops import (fused_chain_vjp,
                                               fused_time_chain)
from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
from pystencils_autodiff_tpu_torch.ops import stage_march as sm
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from test_torch_stage_march import emulate_march
from torch_jax_twin import jax_twin

UC = {"u": "u_next"}
LBM = {"f": "f_out"}
S2, S3 = (24, 40), (12, 10, 14)


def _nl3d(dtype="float64"):
    u, out = Field("u", 3, dtype=dtype), Field("u_next", 3, dtype=dtype)
    return AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")


OPS = {
    "wave": lambda dt="float64": wave_step_op(dt=0.2, dtype=dt),
    "kdiff": lambda dt="float64": diffusion3d_op(dt=0.05, dtype=dt),
    "heat3d": lambda dt="float64": heat_step3d_op(dtype=dt),
    "nl3d": _nl3d,
    "d3q19": lambda dt="float64": d3q19_bgk_op(omega=1.7, dtype=dt,
                                               layout="soa"),
    "aniso": lambda dt="float32": anisotropic27_op(),
}
CARRIES = {"wave": WAVE_CARRY, "kdiff": UC, "heat3d": UC, "nl3d": UC,
           "d3q19": LBM, "aniso": {"u": "y"}}


def _arrays(op, shape, seed):
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


def _line(shape, z, y):
    """The flattened probe row of the line (z, y) along x."""
    return z * shape[1] + y


# ---------------------------------------------------------------------------
# The forward march emulated over rings of rows, with probe records.

EMU = [
    # (id, op, k, periodic, shape, probes, forced dim-0 segments, rows or
    #  planes a step)
    ("wave-k4-edge-rows-1seg", "wave", 4, False, S2,
     [("u_curr", 0), ("u_prev", 23)], 1, 3),
    # 3 segments of 8 rows: row 8 starts the second and lies in the halo
    # of the first
    ("wave-k4-halo-row-3seg", "wave", 4, False, S2,
     [("u_curr", 0), ("u_curr", 8), ("u_prev", 23)], 3, 3),
    ("wave-k4-periodic-3seg", "wave", 4, True, S2,
     [("u_curr", 0), ("u_prev", 16), ("u_curr", 23)], 3, 2),
    ("kdiff-k2-edge-lines-1seg", "kdiff", 2, False, S3,
     [("u", _line(S3, 0, 0)), ("u", _line(S3, 11, 9))], 1, 2),
    # 3 segments of 4 planes: plane 4 starts the second
    ("kdiff-k2-halo-lines-3seg", "kdiff", 2, False, S3,
     [("u", _line(S3, 0, 9)), ("u", _line(S3, 4, 3)),
      ("u", _line(S3, 7, 0)), ("u", _line(S3, 11, 5))], 3, 1),
    ("kdiff-k2-periodic-3seg", "kdiff", 2, True, S3, [], 3, 2),
    ("nl3d-k3-lines-3seg", "nl3d", 3, False, S3,
     [("u", _line(S3, 8, 2)), ("u", _line(S3, 3, 9))], 3, 2),
    ("heat3d-k2-periodic-1seg", "heat3d", 2, True, S3, [], 1, 1),
    ("d3q19-k2-periodic-3seg", "d3q19", 2, True, (9, 6, 8), [], 3, 1),
]


@pytest.mark.parametrize("case", EMU, ids=[c[0] for c in EMU])
def test_forward_march_emulator_with_probe_records(case, monkeypatch):
    """The forward march of the one-stage chain, emulated over rings of
    rows (``emulate_march``: lags, ring depths, dim-0 extents, the P parts
    storing record s from the owned rows of their segment, wrapped rows in
    periodic mode), equals ``plain_time_chain``: state and every probe
    record, f64 to 1e-12, whole or as 3 dim-0 segments (a probe row then
    also lies in the halo of the segment below or above it: stored once,
    by its owner), 1–3 rows (2D) or 1 or 2 planes (3D) a step."""
    _, name, k, periodic, shape, probes, nseg, chunk = case
    monkeypatch.setattr(sm, "CHUNKS_2D", (chunk,))
    monkeypatch.setattr(sm, "CHUNKS_3D", (chunk,))
    monkeypatch.setattr(sm, "MARCH_SEGMENTS", nseg)
    op = OPS[name]()
    plan = tc.chain_plan(op, k, CARRIES[name], periodic, probes)
    st = _t(_arrays(op, shape, 5))
    sp = sm.chain_stage_plan(plan)
    mg = sm.stage_march_geometry(sp, shape, 8)
    assert (mg.nseg, mg.chunk) == (nseg, chunk)
    recs = []
    got, _ = emulate_march(mg, st, records=recs)
    ref, ref_recs = tc.plain_time_chain(plan)(st)
    for n in set(plan.in_names) - plan.invariant:
        _close(got[n], ref[n], 1e-12, f"state {n}")
    assert len(recs) == len(ref_recs) == len(probes)
    for q, (a, b) in enumerate(zip(recs, ref_recs)):
        _close(a, b, 1e-12, f"probe {q}")


def test_forward_part_program_records_after_each_stage():
    """The forward march of a probed chain: after each stage's F part a P
    part (a fold of that F part: no pass or barrier of its own) stores
    record s from the plane the probe's field is in after stage s — the
    F part's ring, or for a field carried from an input (u_prev ← u_curr)
    the ring that holds it; its reads are owned cells only; the geometry
    block carries the flattened probe rows.  A probe of a chain-invariant
    field raises, as the streaming kernel does (the route keeps the box
    for such a chain); a two-phase march takes probes in 2D only."""
    plan = tc.chain_plan(OPS["wave"](), 3, WAVE_CARRY, False,
                         [("u_prev", 5), ("u_curr", 7)])
    sp = sm.chain_stage_plan(plan)
    mp = sm.march_program(sp)
    kinds = [sm.PART_NAMES[p.kind] for p in mp.parts]
    assert kinds == ["F", "P", "F", "P", "F", "P", "S"]
    recs = [p for p in mp.parts if p.kind == sm.P]
    assert [p.probe_stage for p in recs] == [0, 1, 2]
    assert [p.host for p in recs] == [0, 2, 4]
    prev, curr = (sp.planes_of("u_prev")[0], sp.planes_of("u_curr")[0])
    # after stage 0, u_prev is the input u_curr and u_curr F_0's output
    assert recs[0].src[prev][0] == sm.IN_STATE
    assert recs[0].src[curr][0] == mp.parts[0].ring
    assert recs[1].src[prev][0] == mp.parts[0].ring
    assert all(rch == ([0] * 3, [0] * 3) for p in recs
               for rch in p.reads.values())
    assert not any(p.sync for p in recs)
    mg = sm.stage_march_geometry(sp, S2, 8)
    assert mg.geo[-3:] == [2, 5, 7]
    plan3 = tc.chain_plan(OPS["kdiff"](), 2, UC, False,
                          [("u", _line(S3, 4, 3))])
    mg3 = sm.stage_march_geometry(sm.chain_stage_plan(plan3), S3, 8)
    assert mg3.geo[-2:] == [1, 4 * S3[1] + 3]
    inv = tc.chain_plan(OPS["kdiff"](), 2, UC, False, [("kappa", 3)])
    with pytest.raises(NotImplementedError, match="carried state"):
        sm.march_program(sm.chain_stage_plan(inv))
    # such a chain keeps the box, as before the march
    assert tc.forward_design(inv, S3, 8) == "box"
    sp3, sap3 = sm.chain_march_plans(plan3)
    with pytest.raises(NotImplementedError, match="in 2D"):
        sm.march_program(sp3, sap3)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package.

JAX_FWD = [
    # (id, op, k, periodic, shape, probes)
    ("kdiff-k2-bounded", "kdiff", 2, False, S3, []),
    ("kdiff-k2-periodic", "kdiff", 2, True, S3, []),
    ("nl3d-k2-two-lines", "nl3d", 2, False, S3,
     [("u", _line(S3, 2, 7)), ("u", _line(S3, 9, 0))]),
    ("d3q19-k2-periodic", "d3q19", 2, True, (6, 5, 8), []),
]


@pytest.mark.parametrize("case", JAX_FWD, ids=[c[0] for c in JAX_FWD])
def test_fused_time_chain_3d_matches_jax_jnp(case):
    """``fused_time_chain`` of a 3D op on CPU tensors (the plain version
    every design is held against on the card) vs k steps of the JAX
    package's ``make_time_stepper(lowering="jnp")``, the probe lines
    ``divmod(row, n1)`` read after each step: state and records, f64,
    rtol 1e-10."""
    from pystencils_autodiff_tpu.timeloop import make_time_stepper as jstep

    _, name, k, periodic, shape, probes = case
    op = OPS[name]()
    arrays = _arrays(op, shape, 11)
    chain = fused_time_chain(op, k, CARRIES[name], periodic=periodic,
                             probes=probes or None)
    res = chain(_t(arrays))
    out, recs = res if probes else (res, ())
    step = jstep(jax_twin(op), CARRIES[name], lowering="jnp",
                 periodic=periodic)
    jst = {n: jnp.asarray(a) for n, a in arrays.items()}
    jrecs = [[] for _ in probes]
    for _ in range(k):
        jst = step(jst)
        for q, (pname, row) in enumerate(probes):
            jrecs[q].append(np.asarray(jst[pname])[divmod(row, shape[1])])
    for n in arrays:
        _close(out[n], np.asarray(jst[n]), 1e-10, f"state {n}")
    for q, r in enumerate(recs):
        assert tuple(r.shape) == (k, shape[-1])
        _close(r, np.stack(jrecs[q]), 1e-10, f"probe {q}")


def test_periodic_wave_twin_accum_route_matches_jax():
    """Row 10's route — the periodic wave k=4 through ``fused_chain_vjp``
    (``"twin_accum"``: the march on the card, kernel B only behind
    ``design="box"``) — on CPU tensors vs the JAX package's
    ``fused_chain_vjp`` in interpret mode: state and every cotangent (the
    gradient of c includes its incoming cotangent), f64, rtol 1e-10."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp

    op, shape, k = OPS["wave"](), (32, 24), 4
    g = fused_chain_vjp(op, k, WAVE_CARRY, periodic=True)
    assert g.route == "twin_accum"
    assert ta.make_twin_accum_kernel(g.plan).design == "march"
    assert ta.make_twin_accum_kernel(g.plan, "box").design == "box"
    st, cots = _t(_arrays(op, shape, 3)), _t(_arrays(op, shape, 4))
    got_s, got_c = g(st, cots)
    jg = jvjp(jax_twin(op), k, WAVE_CARRY, periodic=True, interpret=True,
              tile_rows=16)
    jst, jcot = jg({n: jnp.asarray(t.numpy()) for n, t in st.items()},
                   {n: jnp.asarray(t.numpy()) for n, t in cots.items()})
    for n in st:
        _close(got_s[n], np.asarray(jst[n]), 1e-10, f"state {n}")
        _close(got_c[n], np.asarray(jcot[n]), 1e-10, f"cot {n}")


# ---------------------------------------------------------------------------
# The design each shape takes: host reckoning at the full shapes.

FULL = [
    # (id, op, float type, k, periodic, shape, itemsize, probes)
    ("config2-kdiff-384-bounded-f32", "kdiff", "float32", 2, False,
     (384,) * 3, 4, []),
    ("config2-kdiff-384-periodic-f32", "kdiff", "float32", 2, True,
     (384,) * 3, 4, []),
    ("kdiff-192-bounded-f64", "kdiff", "float64", 2, False, (192,) * 3, 8,
     []),
    ("heat3d-384-bounded-f32", "heat3d", "float32", 2, False, (384,) * 3,
     4, []),
    ("nl3d-384-two-lines-f32", "nl3d", "float32", 2, False, (384,) * 3, 4,
     [("u", 96 * 384 + 128), ("u", 288 * 384 + 256)]),
    ("aniso27-384-periodic-f32", "aniso", "float32", 2, True, (384,) * 3,
     4, []),
]


@pytest.mark.parametrize("case", FULL, ids=[c[0] for c in FULL])
def test_3d_forward_chains_pick_the_march(case):
    """At the main paths' full shapes a 3D forward chain takes the march
    (``forward_design``), whose reckoning fits the shared memory a block
    may use; a 2D chain takes the first 2D design (``DESIGNS_2D``: the
    warp march)."""
    _, name, dt, k, periodic, shape, isz, probes = case
    plan = tc.chain_plan(OPS[name](dt), k, CARRIES[name], periodic, probes)
    assert tc.forward_design(plan, shape, isz) == "march"
    mg = sm.stage_march_geometry(sm.chain_stage_plan(plan), shape, isz)
    assert mg.smem <= tc.SMEM_BUDGET and mg.program.ap is None
    wave = tc.chain_plan(OPS["wave"]("float32"), 4, WAVE_CARRY, False,
                         [("u_curr", 64)])
    assert tc.forward_design(wave, (8192, 8192), 4) == tc.DESIGNS_2D[0]


@pytest.mark.parametrize("periodic", [False, True])
def test_march_owns_more_than_the_box_at_config2(periodic):
    """Config #2's forward chain (κ-diffusion k=2, 384³ f32): the march
    owns at least 0.9 of its widest region at every register count the
    reckoning may be given, the box design 0.389 (its own reckoning)."""
    plan = tc.chain_plan(OPS["kdiff"]("float32"), 2, UC, periodic)
    tile, ext, _ = tc.box_tile(plan, (384,) * 3, 4)
    box = math.prod(tile) / math.prod(ext)
    assert abs(box - 0.389) < 1e-3
    sp = sm.chain_stage_plan(plan)
    for regs in (None, 48, 96, 160):
        mg = sm.stage_march_geometry(sp, (384,) * 3, 4, regs=regs)
        assert mg.owned_share >= 0.9 > box, (regs, mg.owned_share)


@pytest.mark.parametrize("dtype, n, k, design", [
    ("float32", 256, 2, "march"), ("float32", 256, 4, "march"),
    ("float64", 128, 2, "stream"), ("float64", 32, 2, "stream")])
def test_d3q19_forward_design_follows_the_share_rule(dtype, n, k, design):
    """D3Q19 (19 planes; no box holds it): the march takes its forward
    chain only where it owns at least ``STREAM_SHARE[itemsize]`` (0.55 in
    f32, 0.75 in f64: the march's time per computed cell over the
    streaming kernel's, measured on the H100) of what the z-streaming
    kernel owns — k=2 256³ f32: a 12×16 tile owning 0.762 against the
    streaming 27×33 tile's 0.878 (ratio 0.87: the march); k=4 256³ f32
    (path C's k=4 forward): 8×8 owning 0.327 against 14×14's 0.49 (0.67:
    the march); k=2 128³ f64: 4×8 owning 0.533 against 20×21's 0.83
    (0.64: the streaming kernel); path C's 32³ f64 check takes the
    streaming kernel too."""
    isz = 8 if dtype == "float64" else 4
    plan = tc.chain_plan(OPS["d3q19"](dtype), k, LBM, True)
    shape = (n,) * 3
    assert tc.box_tile(plan, shape, isz) is None
    march = sm.stage_march_geometry(sm.chain_stage_plan(plan), shape, isz)
    stream = pa.stream_geometry(plan, shape, isz)
    ratio = march.owned_share / stream.owned_share
    assert (ratio >= tc.STREAM_SHARE[isz]) == (design == "march")
    assert tc.forward_design(plan, shape, isz) == design
    assert tc.fitting_designs(plan, shape, isz) == {
        "march": march.owned_share, "stream": stream.owned_share}
    if n >= 128:
        assert march.tile == {(4, 2): (12, 16), (4, 4): (8, 8),
                              (8, 2): (4, 8)}[isz, k]
        assert stream.tile == {(4, 2): (27, 33), (4, 4): (14, 14),
                               (8, 2): (20, 21)}[isz, k]


def test_designs_are_checked():
    """``make_chain_kernel``'s ``design``: an unknown one raises, a 2D chain
    takes no streaming kernel (a 3D design) and a 3D chain no warp march
    (a 2D one), and every design's wrapper refuses CPU tensors."""
    plan2 = tc.chain_plan(OPS["wave"](), 2, WAVE_CARRY, False)
    with pytest.raises(ValueError, match="unknown design"):
        tc.make_chain_kernel(plan2, "slab")
    with pytest.raises(ValueError, match="2D forward chain"):
        tc.make_chain_kernel(plan2, "stream")
    plan3 = tc.chain_plan(OPS["kdiff"](), 2, UC, False)
    with pytest.raises(ValueError, match="2D forward chains"):
        tc.make_chain_kernel(plan3, "warp")
    cpu = _t(_arrays(plan3.op, S3, 1))
    for design in (None,) + tuple(d for d in tc.DESIGNS if d != "warp"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tc.make_chain_kernel(plan3, design)(cpu)
    cpu2 = _t(_arrays(plan2.op, (12, 40), 1))
    for design in (None,) + tc.DESIGNS_2D:
        with pytest.raises(ValueError, match="CUDA tensors"):
            tc.make_chain_kernel(plan2, design)(cpu2)


# ---------------------------------------------------------------------------
# On the card: every design of the 3D forward chain and the 2D periodic
# twin march against their plain versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the march kernels are compiled "
                    "with nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


CARD = [
    # (id, op, k, periodic, shape, probes, designs)
    ("kdiff-k2-bounded-lines", "kdiff", 2, False, (11, 9, 37),
     [("u", 3 * 9 + 2), ("u", 10 * 9 + 8)], ("march", "box", "stream")),
    ("kdiff-k2-periodic", "kdiff", 2, True, (11, 9, 37), [],
     ("march", "box", "stream")),
    ("nl3d-k3-bounded-lines", "nl3d", 3, False, (13, 17, 40),
     [("u", 0), ("u", 12 * 17 + 16)], ("march", "box", "stream")),
    ("d3q19-k2-periodic", "d3q19", 2, True, (10, 9, 20), [],
     ("march", "stream")),
]
CARD_RUNS = [(c, d) for c in CARD for d in c[6]]


def _card(case, dtype, device, seed=1):
    _, name, k, periodic, shape, probes, _ = case
    plan = tc.chain_plan(OPS[name](), k, CARRIES[name], periodic, probes)
    return plan, _t(_arrays(plan.op, shape, seed), device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("run", CARD_RUNS,
                         ids=[f"{c[0]}-{d}" for c, d in CARD_RUNS])
def test_forward_designs_match_plain_versions(run, dtype, tiles, cuda_device,
                                              monkeypatch):
    """Each design of the 3D forward chain vs ``plain_time_chain`` on the
    same CUDA tensors, probe lines included (the march: small tiles, 1
    plane a step and 3 dim-0 segments forced, or its pick); one launch
    counted on ``time_chain`` (the streaming kernel: on
    ``plane_adjoint``); invariant fields come back as given; rtol 1e-12 in
    f64, 1e-5 with atol 1e-5·max|ref| in f32."""
    case, design = run
    if tiles == "small":
        monkeypatch.setattr(sm, "TILES_3D", ((4, 8),))
        monkeypatch.setattr(sm, "CHUNKS_3D", (1,))
        monkeypatch.setattr(sm, "MARCH_SEGMENTS", 3)
    plan, st = _card(case, dtype, cuda_device)
    kern = tc.make_chain_kernel(plan, design)
    mod = pa if design == "stream" else tc
    before = mod.LAUNCHES
    got, recs = kern(st)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1 and kern.design == design
    ref, ref_recs = tc.plain_time_chain(plan)(st)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n in plan.invariant:
        assert got[n] is st[n]
    for a, b in [(got[n], ref[n]) for n in ref] + list(zip(recs, ref_recs)):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD[:3], ids=[c[0] for c in CARD[:3]])
def test_forward_march_in_bf16(case, cuda_device):
    """The forward march on bf16 state (stored bf16, computed in float) vs
    the plain version in f32 on the same bf16-rounded inputs: state and
    records within 0.05 of max |ref|, in bf16."""
    plan, st = _card(case, torch.bfloat16, cuda_device)
    got, recs = tc.make_chain_kernel(plan, "march")(st)
    torch.cuda.synchronize()
    ref, ref_recs = tc.plain_time_chain(plan)(
        {n: t.float() for n, t in st.items()})
    for a, b in [(got[n], ref[n]) for n in ref] + list(zip(recs, ref_recs)):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 0.05 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_time_chain_3d_runs_the_march(dtype, cuda_device):
    """``fused_time_chain`` of config #2's op (bounded, k=2, 2 calls) and
    the κ gradient through it on CUDA tensors: 2 forward launches counted
    on ``time_chain`` as march launches, 2 twin-accum march launches, and
    the CPU run's values (rtol 1e-12 in f64, 1e-5 in f32)."""
    op = OPS["kdiff"]()
    arrays = _arrays(op, (14, 13, 35), 5)
    chain = fused_time_chain(op, 2, UC, fused_bwd=True)

    def grad(device):
        ts = _t(arrays, device, dtype)
        ts["kappa"].requires_grad_()
        st = dict(ts)
        for _ in range(2):
            st = chain(st)
        loss = (st["u"] ** 2).mean()
        return loss, torch.autograd.grad(loss, ts["kappa"])[0]

    tc.reset_launch_counts()
    before = ta.LAUNCHES
    lc, gc = grad(cuda_device)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == 2 and ta.LAUNCHES == before + 2
    assert all(key[-1] == "march" for key in tc.LAUNCH_CALLS)
    lp, gp = grad("cpu")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(lc.cpu(), lp.to(dtype), rtol=tol, atol=0)
    torch.testing.assert_close(gc.cpu(), gp.to(dtype), rtol=tol,
                               atol=tol * gp.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("design", ["march", "box"])
def test_periodic_wave_twin_march_matches_plain_version(design, dtype,
                                                        cuda_device):
    """Row 10 on the card: the 2D periodic twin-accum kernel in the march
    (the route's) and kernel B (``design="box"``) vs
    ``plain_twin_accum_vjp`` on the same CUDA tensors, the periodic wave
    k=4 on a ragged 131×70 grid: invariant planes come back as given, one
    launch counted on ``twin_adjoint``; rtol 1e-12 in f64, 1e-5 with atol
    1e-5·max|ref| in f32 (×10 on the cotangents: k backward sums)."""
    op = OPS["wave"]()
    g = fused_chain_vjp(op, 4, WAVE_CARRY, periodic=True)
    assert g.route == "twin_accum"
    kern = ta.make_twin_accum_kernel(g.plan, design)
    st = _t(_arrays(op, (131, 70), 1), cuda_device, dtype)
    cots = _t(_arrays(op, (131, 70), 2), cuda_device, dtype)
    before = ta.LAUNCHES
    got_s, got_c = kern(st, cots)
    torch.cuda.synchronize()
    assert ta.LAUNCHES == before + 1 and kern.design == design
    ref_s, ref_c = ta.plain_twin_accum_vjp(g.plan)(st, cots)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert got_s["c"] is st["c"]
    for n in ref_s:
        torch.testing.assert_close(got_s[n], ref_s[n], rtol=tol,
                                   atol=tol * ref_s[n].abs().max().item())
        torch.testing.assert_close(got_c[n], ref_c[n], rtol=10 * tol,
                                   atol=10 * tol * ref_c[n].abs().max()
                                   .item())
