"""The march design of the stage kernels (``ops/stage_march.py``,
``csrc/stage_march.cuh``): kernel 12 and kernel 13 as one dim-0 march of
stage events, the local-VJP form of a stage and the pointwise BC events
folded into their neighbours.

On the CPU these tests hold the march's reckoning at the main paths' full
shapes, its part program (the folded schedule, evaluated over whole
planes, bit-equal to the sequential chain in f64), an emulator of the
march itself (the lagged parts over rings of rows, in torch) and the
plain local form against the JAX package's sequential steps under
``jax.vjp`` in f64.  The ``cuda``-marked tests at the end hold each march
kernel against its plain version on the card (skipped without one).
Inputs are made from a seed with numpy."""

import math

import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
from pystencils_autodiff_tpu_torch.models import (d2q9_bgk_op,
                                                  elastic_stages,
                                                  heat_step3d_op)
from pystencils_autodiff_tpu_torch.ops import fused_stage_chain_vjp
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import stage_march as sm
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.chain_bc import apply_bc_sequential
from pystencils_autodiff_tpu_torch.ops.common import (assemble_planes,
                                                      field_components,
                                                      plane_view,
                                                      storage_spatial)
from pystencils_autodiff_tpu_torch.ops.torch_ref import make_torch_stencil
from test_torch_stage import (CASES, CAVITY_BC, ELASTIC, MULTI_CARRY, _close,
                              _rand_state, _t, cavity_state, heat_op,
                              jax_vjp, multi_carrier_op)

SPONGE = {0: {n: ("sponge", "damp") for n in ELASTIC}}
CASE = {c[0]: c for c in CASES}


def _cavity(dtype="float32"):
    return [(d2q9_bgk_op(omega=1.7, layout="soa", dtype=dtype),
             {"f": "f_out"})]


def _share(tile, ext):
    return math.prod(tile) / math.prod(ext)


# (id, stages, k, boundary, spatial, itemsize, wanted)
MAIN = [
    ("cavity-f32", _cavity(), 2, CAVITY_BC, (4096, 4096), 4, {"uw1"}),
    ("cavity-f64", _cavity("float64"), 2, CAVITY_BC, (4096, 4096), 8,
     {"uw1"}),
    ("elastic-sponge-f32", elastic_stages(dt=0.01), 4, SPONGE,
     (8192, 8192), 4, ()),
    ("heat3d-neumann-f32", [(heat_step3d_op(), {"u": "u_next"})], 2,
     {"u": "neumann"}, (384, 384, 384), 4, None),
]


@pytest.mark.parametrize("case", MAIN, ids=[c[0] for c in MAIN])
def test_march_fits_the_main_paths_and_owns_more_than_the_box(case):
    """At the main paths' full shapes both modes of the march fit the
    232,448 bytes a block may use and own at least what the box tile of
    PR 4 owns at the depth it ran; the full-k adjoint fits (one segment);
    the BGK stage's reverse takes the local form."""
    name, stages, k, boundary, spatial, isz, wanted = case
    plan = sc.StagePlan(stages, k, False, boundary)
    ap = sa.AdjointStagePlan(plan, wanted)
    nd = plan.nd
    fwd = sm.stage_march_geometry(plan, spatial, isz)
    adj = sm.stage_march_geometry(plan, spatial, isz, ap)
    assert fwd.smem <= tc.SMEM_BUDGET and adj.smem <= tc.SMEM_BUDGET
    _, (tile, ext, _) = sc.stage_geometry(
        plan, spatial, isz, blocks_per_sm=tc.FWD_BLOCKS_PER_SM[nd],
        block_rows=tc.FWD_BLOCK_ROWS[nd])
    assert fwd.owned_share >= _share(tile, ext)
    box = None
    for kk in [d for d in range(k, 0, -1) if k % d == 0]:
        try:
            p = plan if kk == k else sc.StagePlan(stages, kk, False,
                                                  boundary)
            _, (tile, ext, _) = sa.adjoint_geometry(
                sa.AdjointStagePlan(p, wanted), spatial, isz)
            box = _share(tile, ext)
            break
        except ValueError:
            continue
    assert box is not None and adj.owned_share >= box
    g = fused_stage_chain_vjp(stages, k, boundary=boundary, wanted=wanted)
    assert g.segments_for(spatial, isz) == 1
    if name.startswith("cavity"):
        assert adj.forms == ("local",)
        kinds = [sm.PART_NAMES[p.kind] for p in adj.program.parts]
        assert kinds == ["B", "F", "B", "F", "S", "L", "G", "BR", "L", "G",
                         "BR", "SC"]
        # a barrier after every part: each lags its writers by their reach
        lag, _, _, _, cot_lag = sm._lags_and_extents(adj.program)
        assert lag == [1, 2, 3, 4, 4, 4, 5, 6, 6, 7, 8, 8] and cot_lag == 4
    if name.startswith("elastic"):
        # the 20 sponge events of a call fold into the stress stages (and
        # the first cycle's into the input load): no part of their own
        kinds = [p.kind for p in fwd.program.parts]
        assert kinds.count(sm.FOLD) == 20 and kinds.count(sm.F) == 8
        assert sum(p.host < 0 for p in fwd.program.parts
                   if p.kind == sm.FOLD) == 5


def test_lags_and_rings_of_a_hand_worked_march(monkeypatch):
    """Two heat steps (reach 1 a side), 2 rows a step, f64: F_1 reads the
    input ring at reach 1 (lag 1), F_2 F_1's ring (lag 2), S F_2's at the
    cell (F_2's lag).  Depths, each rounded up to a power of two (a read's
    slot is a mask): the input ring 1 + 1 below + 2 + 2 in flight = 6 ->
    8; F_1's (2 − 1 + 1) + 2 = 4; F_2's 0 + 2 = 2; the empty invariant
    ring 2 + 2.  Extents: F_2 the owned tile, F_1 one cell a
    side, the input ring two (its x origin and width rounded up to whole
    vectors of 4: 4 + 16 + 2 -> 24)."""
    monkeypatch.setattr(sm, "CHUNKS_2D", (2,))
    monkeypatch.setattr(sm, "STRIP_COLS", (16,))
    plan = sc.StagePlan([(heat_op(), {"u": "u_next"})], 2, False, None)
    g = sm.stage_march_geometry(plan, (24, 40), 8)
    assert [sm.PART_NAMES[p.kind] for p in g.program.parts] == ["F", "F",
                                                                 "S"]
    assert g.chunk == 2 and g.tile == (1, 16)
    assert g.lags == [1, 2, 2] and g.ring_depth == [8, 4, 4, 2]
    assert g.ring_ext[2] == ([1, 0, 1], [1, 0, 1])
    assert g.ring_ext[3] == ([0, 0, 0], [0, 0, 0])
    assert g.ring_ext[0] == ([2, 0, 2], [2, 0, 2])
    lo1, lo2, ry, rx = sm._ring_region(g.tile, g.ring_ext[0], 0, 2)
    assert (lo1, lo2, ry, rx) == (0, 4, 1, 24)
    with pytest.raises(ValueError, match="no march"):
        monkeypatch.setattr(tc, "SMEM_BUDGET", 64)
        monkeypatch.setattr(sm, "SMEM_BUDGET", 64)
        sm.stage_march_geometry(plan, (24, 40), 8)


def test_segments_follow_the_march_and_the_box_is_asked_for(monkeypatch):
    """The adjoint's segment count is the fewest whose depth a march fits:
    with one candidate march and the budget at the 1-deep march's bytes,
    two heat steps run as 2 segments; a byte less and nothing fits.  The
    kernel factories build the march unless the box design is asked for
    by name, and an unknown design raises."""
    monkeypatch.setattr(sm, "CHUNKS_2D", (1,))
    monkeypatch.setattr(sm, "STRIP_COLS", (16,))
    stages = [(heat_op(), {"u": "u_next"})]
    plan = sc.StagePlan(stages, 2, False, None)
    one = sc.StagePlan(stages, 1, False, None)
    smem = [sm.stage_march_geometry(p, (24, 40), 8,
                                    sa.AdjointStagePlan(p)).smem
            for p in (one, plan)]
    assert smem[0] < smem[1]
    for budget, want in ((smem[1], 1), (smem[0], 2), (smem[0] - 1, None)):
        monkeypatch.setattr(sm, "SMEM_BUDGET", budget)
        g = fused_stage_chain_vjp(stages, 2)
        assert sm.march_fits(one, (24, 40), 8, sa.AdjointStagePlan(one)) \
            == (want is not None)
        if want is None:
            with pytest.raises(ValueError, match="no march"):
                g.segments_for((24, 40), 8)
        else:
            assert g.segments_for((24, 40), 8) == want
    ap = sa.AdjointStagePlan(plan)
    assert sc.make_stage_kernel(plan).design == "march"
    assert sa.make_stage_adjoint_kernel(ap).design == "march"
    assert sc.make_stage_kernel(plan, "box").plan is plan
    assert sa.make_stage_adjoint_kernel(ap, "box").plan is ap
    for bad in (None, "tile"):
        with pytest.raises(ValueError, match="unknown design"):
            sc.make_stage_kernel(plan, bad)
        with pytest.raises(ValueError, match="unknown design"):
            sa.make_stage_adjoint_kernel(ap, bad)
    with pytest.raises(ValueError, match="unknown form"):
        sm.march_fits(plan, (24, 40), 8, ap, "scatter")


# ---------------------------------------------------------------------------
# The local form against the JAX package.

LOCAL_CASES = [
    ("cavity-aos", [(d2q9_bgk_op(omega=1.6), {"f": "f_out"})], 2, False,
     CAVITY_BC, cavity_state(16, "aos")),
    ("cavity-soa-moving-lid", [(d2q9_bgk_op(omega=1.6, layout="soa"),
                                {"f": "f_out"})], 2, False, CAVITY_BC,
     cavity_state(16, "soa")),
    CASE["elastic-sponge-k2"][:6],
    ("multi-carrier", [(multi_carrier_op(), MULTI_CARRY)], 2, False, None,
     _rand_state(["u", "v"], (20, 16), 61, 0.5)),
    CASE["elastic-periodic-k3"][:6],
    CASE["neumann-3d"][:6],
]


@pytest.mark.parametrize("case", LOCAL_CASES, ids=[c[0] for c in LOCAL_CASES])
def test_local_form_matches_jax(case):
    """``plain_stage_chain_vjp(ap, form="local")`` — each stage's reverse
    as its local VJP at the write cell and the gather of the w planes —
    and ``fused_stage_chain_vjp(form="local")`` on CPU tensors equal the
    JAX package's sequential steps under ``jax.vjp``, state and every
    cotangent, f64 to 1e-12."""
    _, stages, k, periodic, boundary, arrays = case
    rng = np.random.default_rng(5)
    cots = {n: rng.standard_normal(np.shape(a)) for n, a in arrays.items()}
    jout, jgrads = jax_vjp(stages, k, periodic, boundary, arrays, cots)
    ap = sa.AdjointStagePlan(sc.StagePlan(stages, k, periodic, boundary))
    out, cot0 = sa.plain_stage_chain_vjp(ap, form="local")(_t(arrays),
                                                          _t(cots))
    g = fused_stage_chain_vjp(stages, k, periodic=periodic,
                              boundary=boundary, form="local")
    out2, cot2 = g(_t(arrays), _t(cots))
    for n in out:
        _close(out[n], jout[n], 1e-12, f"state {n}")
        _close(out2[n], jout[n], 1e-12, f"state {n}")
    for n in cot0:
        _close(cot0[n], jgrads[n], 1e-12, f"cot {n}")
        _close(cot2[n], jgrads[n], 1e-12, f"cot {n}")


# ---------------------------------------------------------------------------
# The folded schedule over whole planes.

def _plane_state(plan, planes, src, spatial):
    keys = plan.plane_keys
    return {nm: assemble_planes(f, [planes[src[keys.index((nm, idx))]]
                                    for idx in field_components(f)],
                                spatial)
            for nm, f in plan.state_fields.items()}


def run_forward_parts(mp, state):
    """The forward parts of a march program over whole planes, in order,
    each reading the planes its ``src`` table names and writing its outputs
    (a fold's into its host's ring) — no lags, no rings of rows."""
    plan = mp.plan
    f0 = plan.state_fields[plan.state_names[0]]
    spatial = storage_spatial(f0, state[f0.name])
    steps = [make_torch_stencil(p, periodic=plan.periodic)
             for p in plan.progs]
    planes = {}
    for ring, ns in ((sm.IN_STATE, mp.dyn), (sm.IN_INV, mp.inv)):
        for i, n in enumerate(ns):
            f, idx = plan.planes[n]
            planes[(ring, i)] = plane_view(f, state[f.name], idx)
    for p in mp.parts:
        if p.kind == sm.S:
            return _plane_state(plan, planes, p.src, spatial)
        ev = plan.cycle[p.ev]
        st = _plane_state(plan, planes, p.src, spatial)
        if ev.kind == "stage":
            prog = plan.progs[ev.stage]
            outs = steps[ev.stage]({n: st[n] for n in prog.input_names})
            vals = [plane_view(f, outs[f.name], idx)
                    for f in prog.output_fields
                    for idx in field_components(f)]
        else:
            new = apply_bc_sequential(st, ev.bc, plan.progs[ev.stage].ghost,
                                      plan.periodic, fields=plan.state_fields)
            vals = [plane_view(plan.planes[n][0], new[ev.bc.field],
                               plan.planes[n][1])
                    for n in plan.planes_of(ev.bc.field)]
        for j, v in enumerate(vals):
            planes[(p.ring, p.out_planes()[j])] = v
    raise AssertionError("no store part")


FOLD_CASES = ["elastic-sponge-k2", "sponge-field-dirichlet",
              "masked-dirichlet-field", "dirichlet-frame", "dirichlet-rows",
              "sponge-wave"]


@pytest.mark.parametrize("name", FOLD_CASES)
def test_folded_schedule_is_bit_equal_to_the_sequential_chain(name):
    """Pointwise BC events folded into the part before them (the lead ones
    of the first cycle into the input load), evaluated over whole planes
    through the march's tables, give the sequential chain bit for bit
    (f64): the same products in the same order."""
    _, stages, k, periodic, boundary, arrays, inter = CASE[name]
    plan = sc.StagePlan(stages, k, periodic, boundary, inter)
    mp = sm.march_program(plan)
    assert any(p.kind == sm.FOLD for p in mp.parts)
    assert not any(p.kind == sm.B and plan.cycle[p.ev].bc.kind in
                   ("dirichlet", "masked_dirichlet", "sponge")
                   for p in mp.parts)
    got = run_forward_parts(mp, _t(arrays))
    ref = sc.plain_stage_chain(plan)(_t(arrays))
    for n in ref:
        assert torch.equal(got[n], ref[n]), n


# ---------------------------------------------------------------------------
# The march emulated over rings of rows.

class _Ring:
    """Rows of one ring, each slot tagged with the row it holds: a read of
    a slot that holds another row (overwritten, or never written) fails."""

    def __init__(self, depth, planes, lat, dtype):
        self.depth = depth
        self.buf = torch.full((depth, max(planes, 1)) + lat, float("nan"),
                              dtype=dtype)
        self.tag = [None] * depth

    def put(self, row, plane, value):
        s = row % self.depth
        if self.tag[s] != row:
            self.buf[s] = float("nan")
            self.tag[s] = row
        self.buf[s, plane] = value

    def get(self, row, plane):
        s = row % self.depth
        assert self.tag[s] == row, (f"ring slot {s} holds row {self.tag[s]}"
                                    f", read as row {row}")
        return self.buf[s, plane]


def emulate_march(mg, state, cots=None, probe_cots=(), records=None):
    """The march of ``mg`` (2D or 3D: rows are rows, or planes, of dim 0;
    the lateral dims whole) in torch: every segment's steps, every part on
    its lagged rows, reading and writing rings of ``ring_depth`` rows, the
    inputs loaded one step ahead, the lead folds at the load, the probe
    cotangents of the last stage added to cot_k as it loads and those of
    stage s to what the reverse part that writes the cotangent of state
    s + 1 writes (2D, on the probe row).  In forward mode with probes,
    ``records`` (a list) receives one ``(k, n_last)`` tensor a probe: the
    P parts store the probe's row (2D) or line (3D, ``divmod(row, n1)``)
    of state s + 1 into record s from the owned rows of their segment.  A
    part's rows are computed by its plain event over the whole domain from
    the window of rows it reads (other rows 0) — so a lag, depth, dim-0
    extent, table or probe fault shows as a failed read or a wrong
    value."""
    mp = mg.program
    plan, ap = mp.plan, mp.ap
    keys = plan.plane_keys
    f0 = plan.state_fields[plan.state_names[0]]
    spatial = storage_spatial(f0, state[f0.name])
    n0, lat = spatial[0], tuple(spatial[1:])
    dt = state[f0.name].dtype
    C = mg.chunk
    steps = [make_torch_stencil(p, periodic=plan.periodic)
             for p in plan.progs]
    lsteps = {j: make_torch_stencil(lv.program, full_domain=True,
                                    periodic=plan.periodic,
                                    adjoint_mask_ghost=plan.progs[j].ghost)
              for j, lv in mp.local.items()}
    nc = len(ap.cot_planes) if ap is not None else 0
    zero = torch.zeros(spatial, dtype=dt)

    def pl(fields, n):
        f, idx = plan.planes[n]
        return plane_view(f, fields[f.name], idx)

    final = {n: torch.full(spatial, float("nan"), dtype=dt)
             for n in range(len(keys))}
    final_cot = {m: torch.full(spatial, float("nan"), dtype=dt)
                 for m in range(nc)}
    recs = [torch.full((plan.k, lat[-1]), float("nan"), dtype=dt)
            for _ in plan.probes]
    a_lo, a_hi = mg.ring_ext[0][0][0], mg.ring_ext[0][1][0]
    b_lo, b_hi = ((mg.ring_ext[2][0][0], mg.ring_ext[2][1][0]) if nc
                  else (0, 0))
    parts = mp.parts
    folds = {x: [f for f, q in enumerate(parts)
                 if q.kind in sm.FOLDLIKE and q.host == x]
             for x in range(-1, len(parts))}
    for seg in range(mg.nseg):
        za = seg * mg.zlen
        zb = min(za + mg.zlen, n0)
        rings = [_Ring(d, p, lat, dt) for d, p in zip(mg.ring_depth,
                                                      mp.ring_planes)]

        def real(v):
            if plan.periodic:
                return v % n0
            return v if 0 <= v < n0 else None

        def window(planes_src, x, reach_of, rows):
            """Whole-domain planes holding the rows each plane's reader
            reach needs, read from the rings."""
            out = {}
            for key, (ring, plane) in planes_src.items():
                if ring not in reach_of:
                    out[key] = zero
                    continue
                lo, hi = reach_of[ring]
                full = torch.zeros(spatial, dtype=dt)
                for v in range(rows[0] - lo[0], rows[1] + hi[0]):
                    rv = real(v)
                    if rv is not None:
                        full[rv] = rings[ring].get(v, plane)
                out[key] = full
            return out

        def load(tt, group):
            if group == "A":
                lg, first, last = 0, za - a_lo, zb + a_hi
            else:
                lg, first, last = mg.cot_lag, za - b_lo, zb + b_hi
            r0 = tt * C - lg
            for v in range(max(r0, first), min(r0 + C, last)):
                rv = v % n0 if plan.periodic else min(max(v, 0), n0 - 1)
                if group == "A":
                    for i, n in enumerate(mp.dyn):
                        rings[0].put(v, i, pl(state, n)[rv])
                    for i, n in enumerate(mp.inv):
                        rings[1].put(v, i, pl(state, n)[rv])
                else:
                    for m, n in enumerate(ap.cot_planes):
                        row = pl(cots, n)[rv]
                        for q, (_, prow) in enumerate(plan.probes):
                            if mp.probe_slots[q] == m and real(v) == prow:
                                row = row + probe_cots[q][plan.k - 1]
                        rings[2].put(v, m, row)

        def input_folds(tt):
            r0 = tt * C
            rows = (max(r0, za - a_lo), min(r0 + C, zb + a_hi))
            if rows[1] > rows[0]:
                for f in folds[-1]:
                    run(f, rows, {0: ([0] * 3, [0] * 3),
                                  1: ([0] * 3, [0] * 3)})

        def run(x, rows, reach=None):
            p = parts[x]
            reach = p.reads if reach is None else reach
            if p.kind in sm.STORES:  # the owned rows only
                rows = (max(rows[0], za), min(rows[1], zb))
            if p.kind == sm.SC:
                cw = window({m: s for m, s in enumerate(p.csrc)}, x, reach,
                            rows)
                for v in range(*rows):
                    for m in range(nc):
                        final_cot[m][v] = cw[m][v]
                return
            sw = window({n: s for n, s in enumerate(p.src)}, x, reach, rows)
            st = {nm: assemble_planes(f, [sw[keys.index((nm, idx))]
                                          for idx in field_components(f)],
                                      spatial)
                  for nm, f in plan.state_fields.items()}
            if p.kind == sm.S:
                for v in range(*rows):
                    for n in range(len(keys)):
                        final[n][v] = sw[n][v]
                return
            if p.kind == sm.P:
                for q, (n, prow) in enumerate(plan.probes):
                    at = divmod(prow, lat[0]) if len(lat) == 2 else (prow,)
                    if rows[0] <= at[0] < rows[1]:
                        recs[q][p.probe_stage] = sw[n][at]
                return
            ev = plan.cycle[p.ev]
            cw = (window({m: s for m, s in enumerate(p.csrc)}, x, reach,
                         rows) if p.csrc is not None else {})
            if p.kind in (sm.F, sm.B, sm.FOLD):
                if ev.kind == "stage":
                    prog = plan.progs[ev.stage]
                    o = steps[ev.stage]({n: st[n] for n in
                                         prog.input_names})
                    vals = [plane_view(f, o[f.name], idx)
                            for f in prog.output_fields
                            for idx in field_components(f)]
                else:
                    new = apply_bc_sequential(st, ev.bc,
                                              plan.progs[ev.stage].ghost,
                                              plan.periodic,
                                              fields=plan.state_fields)
                    vals = [pl(new, n) for n in plan.planes_of(ev.bc.field)]
            elif p.kind == sm.L:
                lv = mp.local[ev.stage]
                prog = plan.progs[ev.stage]
                ins = {f.name: st[f.name] for f in prog.input_fields}
                outs = [(f, idx) for f in prog.output_fields
                        for idx in field_components(f)]
                for a in lv.program.input_fields[len(prog.input_fields):]:
                    fwd_f = a.corresponding_forward_field
                    ps = []
                    for idx in field_components(fwd_f):
                        o = outs.index((fwd_f, idx))
                        acc = zero
                        for n, s in enumerate(ev.src):
                            if s == ("out", o) and ap.cslot[n] >= 0:
                                acc = acc + cw[ap.cslot[n]]
                        ps.append(acc)
                    ins[a.name] = assemble_planes(a, ps, spatial)
                w = lsteps[ev.stage](ins)
                vals = [w[f"w{a}"] for a in range(len(lv.slots))]
            elif p.kind == sm.G:
                lv = mp.local[ev.stage]
                ww = window({a: (p.wring, a) for a in range(len(lv.slots))},
                            x, reach, rows)
                t = ap.tables[p.ev]
                vals = []
                for m in p.writes:
                    acc = zero
                    for a, (ms, offs) in enumerate(lv.slots):
                        if ap.cslot[ev.in_planes[ms]] == m:
                            acc = acc + sa._shifted(ww[a], offs,
                                                    plan.periodic)
                    for q in t["pass"][m]:
                        acc = acc + cw[q]
                    vals.append(acc)
            else:  # R, BR, RFOLD: autograd through the event
                with torch.enable_grad():
                    ins = {n: v.detach().requires_grad_()
                           for n, v in st.items()}
                    if ev.kind == "stage":
                        prog = plan.progs[ev.stage]
                        o = steps[ev.stage]({n: ins[n] for n in
                                             prog.input_names})
                        env = {**ins, **o}
                        out = {**ins, **{d: env[s_] for d, s_ in
                                         plan.carries[ev.stage].items()}}
                    else:
                        out = apply_bc_sequential(
                            ins, ev.bc, plan.progs[ev.stage].ghost,
                            plan.periodic, fields=plan.state_fields)
                    names = plan.state_names
                    cf = {nm: assemble_planes(
                        f, [cw[ap.cslot[keys.index((nm, idx))]]
                            if ap.cslot[keys.index((nm, idx))] >= 0
                            else zero for idx in field_components(f)],
                        spatial) for nm, f in plan.state_fields.items()}
                    gr = torch.autograd.grad([out[nm] for nm in names],
                                             [ins[nm] for nm in names],
                                             [cf[nm] for nm in names],
                                             allow_unused=True)
                gd = {nm: (g if g is not None else
                           torch.zeros_like(st[nm]))
                      for nm, g in zip(names, gr)}
                vals = [pl(gd, ap.cot_planes[m]) for m in p.writes]
            if p.probe_stage >= 0:
                for j, m in enumerate(p.writes):
                    for q, (_, prow) in enumerate(plan.probes):
                        if mp.probe_slots[q] == m:
                            vals[j] = vals[j].clone()
                            vals[j][prow] += probe_cots[q][p.probe_stage]
            for j, v in enumerate(vals):
                for r in range(*rows):
                    rv = real(r)
                    rings[p.ring].put(r, p.out_planes()[j],
                                      v[rv] if rv is not None else
                                      torch.full(lat, float("nan"),
                                                 dtype=dt))

        live = [x for x, q in enumerate(parts) if q.kind not in sm.FOLDLIKE]
        t0 = min([(za - a_lo) // C] + [(za - mg.extents[x][0][0]
                                        + mg.lags[x]) // C for x in live]
                 + ([(za - b_lo + mg.cot_lag) // C] if nc else []))
        t1 = max([(zb + a_hi - 1) // C + 1]
                 + [(zb + mg.extents[x][1][0] - 1 + mg.lags[x]) // C + 1
                    for x in live]
                 + ([(zb + b_hi - 1 + mg.cot_lag) // C + 1] if nc else []))
        load(t0, "A")
        if nc:
            load(t0, "B")
        input_folds(t0)
        for t in range(t0, t1):
            if t + 1 < t1:
                load(t + 1, "A")
                if nc:
                    load(t + 1, "B")
            for x in live:
                r0 = t * C - mg.lags[x]
                rows = (max(r0, za - mg.extents[x][0][0]),
                        min(r0 + C, zb + mg.extents[x][1][0]))
                if rows[1] <= rows[0]:
                    continue
                for f in [x] + folds[x]:
                    run(f, rows)
            if t + 1 < t1:
                input_folds(t + 1)
    out = {nm: assemble_planes(f, [final[keys.index((nm, idx))]
                                   for idx in field_components(f)], spatial)
           for nm, f in plan.state_fields.items()}
    cot0 = {nm: assemble_planes(f, [final_cot[ap.cslot[keys.index(
        (nm, idx))]] for idx in field_components(f)], spatial)
            for nm, f in plan.state_fields.items()
            if ap is not None and nm in ap.cot_names}
    if records is not None:
        records.extend(recs)
    return out, cot0


def _emu_cases():
    el = CASE["elastic-sponge-k2"]
    damp = np.asarray(cerjan_damping((24, 40), width=5, alpha=0.08,
                                     dtype=torch.float64, device="cpu"))
    wave = CASE["sponge-wave"]
    rng = np.random.default_rng(7)
    return [
        ("cavity-soa", _cavity("float64"), 2, False, CAVITY_BC,
         cavity_state(24, "soa"), ()),
        ("elastic-sponge", el[1], 2, False, el[4],
         {**_rand_state(ELASTIC, (24, 40), 1), "damp": damp}, ()),
        ("sponge-wave-periodic-free", wave[1], 2, True, None,
         {n: rng.standard_normal((24, 40)) for n in ("u_curr", "u_prev")}
         | {"c": 2.0 + 0.1 * np.abs(rng.standard_normal((24, 40)))}, ()),
        ("neumann-masked", [(heat_op(), {"u": "u_next"})], 2, False,
         {"u": ["neumann", ("masked_dirichlet", "obst", "uval")]},
         {**_rand_state(["u", "uval"], (24, 40), 6),
          "obst": (rng.random((24, 40)) < 0.1).astype(float)}, ()),
    ]


EMU = _emu_cases()


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("form", [None, "gather", "local"])
@pytest.mark.parametrize("case", EMU, ids=[c[0] for c in EMU])
def test_march_emulator_matches_plain(case, form, chunk, monkeypatch):
    """The march at 24×40, k=2, 1 or 3 rows a step, 3 segments, emulated
    over rings of rows (``emulate_march``): kernel 12's and kernel 13's
    parts (each reverse form) equal the plain versions, f64 to 1e-12."""
    monkeypatch.setattr(sm, "CHUNKS_2D", (chunk,))
    monkeypatch.setattr(sm, "MARCH_SEGMENTS", 3)
    _, stages, k, periodic, boundary, arrays, inter = case
    plan = sc.StagePlan(stages, k, periodic, boundary, inter)
    st = _t(arrays)
    if form is None:
        mg = sm.stage_march_geometry(plan, (24, 40), 8)
        assert mg.nseg == 3
        got, _ = emulate_march(mg, st)
        ref = sc.plain_stage_chain(plan)(st)
        for n in set(ref) - plan.invariant:
            _close(got[n], ref[n].numpy(), 1e-12, n)
        return
    ap = sa.AdjointStagePlan(plan)
    rng = np.random.default_rng(8)
    cots = _t({n: rng.standard_normal(np.shape(arrays[n]))
               for n in ap.cot_names})
    mg = sm.stage_march_geometry(plan, (24, 40), 8, ap, form)
    got, cot0 = emulate_march(mg, st, cots)
    ref, rcot = sa.plain_stage_chain_vjp(ap)(st, cots)
    for n in set(ref) - plan.invariant:
        _close(got[n], ref[n].numpy(), 1e-12, n)
    for n in rcot:
        _close(cot0[n], rcot[n].numpy(), 1e-12, f"cot {n}")


# ---------------------------------------------------------------------------
# On the card: the march kernels against their plain versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the march kernels are compiled "
                    "with nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


CARD_CASES = [CASE[n] for n in (
    "elastic-bounded-k3", "elastic-periodic-k3", "elastic-sponge-k2",
    "weno5-rk3-periodic", "cahn-hilliard-k2", "neumann-2d", "neumann-3d",
    "masked-dirichlet-field", "sponge-field-dirichlet", "sponge-wave",
    "cavity-aos", "cavity-soa", "stream9-periodic-bounce")]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "local"])
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_march_kernels_match_plain_versions(case, dtype, tiles, form,
                                            cuda_device, monkeypatch):
    """Kernel 12 and kernel 13 in the march design vs their plain versions
    on the same CUDA tensors (small strips, 3 segments and 2 rows a step,
    or the picked march); rtol 1e-12 in f64, 1e-5 with atol 1e-5·max|ref|
    in f32 (×10 on the cotangents: FMA contraction and summation order)."""
    if tiles == "small":
        monkeypatch.setattr(sm, "STRIP_COLS", (16,))
        monkeypatch.setattr(sm, "TILES_3D", ((4, 8),))
        monkeypatch.setattr(sm, "CHUNKS_2D", (2,))
        monkeypatch.setattr(sm, "MARCH_SEGMENTS", 3)
    _, stages, k, periodic, boundary, arrays, inter = case
    plan = sc.StagePlan(stages, k, periodic, boundary, inter)
    ap = sa.AdjointStagePlan(plan)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = _t(arrays, cuda_device, dtype)
    rng = np.random.default_rng(40)
    cots = _t({n: rng.standard_normal(np.shape(arrays[n]))
               for n in ap.cot_names}, cuda_device, dtype)
    before = (sc.LAUNCHES, sa.LAUNCHES)
    got = sc.make_stage_kernel(plan, "march")(st)
    kern = sa.make_stage_adjoint_kernel(ap, "march", form)
    got_s, got_c = kern(st, cots)
    torch.cuda.synchronize()
    assert (sc.LAUNCHES, sa.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert kern.design == "march" and set(kern.forms) == {form}
    ref = sc.plain_stage_chain(plan)(st)
    ref_s, ref_c = sa.plain_stage_chain_vjp(ap)(st, cots)

    def check(a, b, scale=1.0):
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())

    for n in plan.invariant:
        assert got[n] is st[n] and got_s[n] is st[n]
    for n in ref:
        check(got[n], ref[n])
        check(got_s[n], ref_s[n])
    for n in ref_c:
        check(got_c[n], ref_c[n], 10.0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "local"])
def test_bf16_march_kernels_on_the_card(form, cuda_device):
    """The march kernels on bf16 state (stored bf16, computed in float) vs
    their plain versions in f32 on the same bf16-rounded inputs: within
    0.05 of max |ref|."""
    _, stages, k, periodic, boundary, arrays, _ = CASE["elastic-sponge-k2"]
    plan = sc.StagePlan(stages, k, periodic, boundary)
    ap = sa.AdjointStagePlan(plan)
    rng = np.random.default_rng(71)
    cots = {n: rng.standard_normal(np.shape(arrays[n])) for n in ap.cot_names}
    st = _t(arrays, cuda_device, torch.bfloat16)
    ct = _t(cots, cuda_device, torch.bfloat16)
    got = sc.make_stage_kernel(plan, "march")(st)
    got_s, got_c = sa.make_stage_adjoint_kernel(ap, "march", form)(st, ct)
    torch.cuda.synchronize()
    f32 = {n: t.float() for n, t in st.items()}
    ref = sc.plain_stage_chain(plan)(f32)
    ref_s, ref_c = sa.plain_stage_chain_vjp(ap)(
        f32, {n: t.float() for n, t in ct.items()})
    for a, b in [(got[n], ref[n]) for n in ref] + [
            (got_s[n], ref_s[n]) for n in ref_s] + [
            (got_c[n], ref_c[n]) for n in ref_c]:
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 0.05 * b.abs().max()


@pytest.mark.cuda
def test_march_gradients_on_the_card_match_cpu(cuda_device):
    """The cavity's u_lid gradient through the fused chain, which takes the
    march on the card (one launch of each kernel per call), equals the
    CPU run of the plain versions, float64 to 1e-12."""
    n, k = 48, 2
    stages = _cavity("float64")
    arrays = cavity_state(n, "soa")
    lid = torch.tensor((arrays["uw1"] != 0).astype(float))
    res = {}
    for dev in ("cpu", cuda_device):
        chain = sc.fused_stage_chain(stages, k, fused_bwd=True,
                                     boundary=CAVITY_BC)
        stt = _t({k_: v for k_, v in arrays.items() if k_ != "uw1"}, dev)
        u = torch.tensor(0.05, dtype=torch.float64, device=dev,
                         requires_grad=True)
        before = (sc.LAUNCHES, sa.LAUNCHES)
        f = chain(chain({**stt, "uw1": lid.to(dev) * u}))["f"]
        loss = (f ** 2).mean()
        (g,) = torch.autograd.grad(loss, u)
        if dev != "cpu":
            assert (sc.LAUNCHES - before[0], sa.LAUNCHES - before[1]) == (2, 2)
        res[str(dev)] = (loss.item(), g.item())
    (lc, gc), (lg, gg) = res["cpu"], res[str(cuda_device)]
    assert abs(lg - lc) <= 1e-12 * abs(lc) and abs(gg - gc) <= 1e-12 * abs(gc)
