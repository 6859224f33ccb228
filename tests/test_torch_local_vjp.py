"""The local-VJP form of the z-streaming kernel's reverse stages
(``ops.local_vjp``, ``fused_chain_vjp(form="local")``) on the CPU against
the JAX package in float64, its derivation's size, the form picker, and on
a card both forms of the kernel against their plain versions.

On CPU tensors ``fused_chain_vjp(..., form="local")`` runs the plain
version of the local form (``plain_chain_vjp(ap, form="local")``: the L
program at every cell, then the gather of its w planes).  The JAX side
runs as its own tests run it: ``make_plane_chain_vjp_fn`` in interpret
mode, or ``jax.vjp`` of its fused chain with probes.  D3Q19 is held
against the port's gather form, which ``test_torch_plane.py`` holds
against the JAX package, so the slow JAX oracle is not run again.  Inputs
are made from a seed with numpy; rtol 1e-10, ghost cells included."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
    generate_plane_source
from pystencils_autodiff_tpu_torch.models import heat_step_op
from pystencils_autodiff_tpu_torch.ops import fused_chain_vjp
from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from pystencils_autodiff_tpu_torch.ops.local_vjp import (local_vjp,
                                                         program_cost)
from test_torch_plane import LBM, OPS, S3, UC, _close, _cots, _d3q19, \
    _nl3d, _state, _t
from torch_jax_twin import jax_twin

PROBES = [("u", 3 * 10 + 4), ("u", 9 * 10 + 7)]  # lines (3, 4), (9, 7)


def _jax_plane(op, k, carry, periodic, state, cots):
    from pystencils_autodiff_tpu.ops.plane_adjoint import \
        make_plane_chain_vjp_fn

    jg = make_plane_chain_vjp_fn(jax_twin(op), k, carry, S3, jnp.float64,
                                 interpret=True, periodic=periodic)
    return jg({n: jnp.asarray(a) for n, a in state.items()},
              {n: jnp.asarray(a) for n, a in cots.items()})


# (id, k, periodic, segments)
LOCAL_VS_JAX = [
    ("bounded-k1", 1, False, None),
    ("bounded-k2", 2, False, None),
    ("periodic-k1", 1, True, None),
    ("periodic-k2", 2, True, None),
    ("bounded-k2-2-segments", 2, False, 2),
    ("periodic-k2-2-segments", 2, True, 2),
]


@pytest.mark.parametrize("case", LOCAL_VS_JAX,
                         ids=[c[0] for c in LOCAL_VS_JAX])
def test_local_form_matches_jax_plane_kernel(case):
    """nl3d through ``fused_chain_vjp(form="local")`` (k = 1 and 2, bounded
    and periodic, whole or as 2 segments of depth 1) equals the JAX
    package's ``make_plane_chain_vjp_fn`` (interpret mode), state_k and
    cot_0, rtol 1e-10."""
    _, k, periodic, segments = case
    op = _nl3d()
    state, cots = _state(op, S3, 11), _cots(op, S3, 12)
    g = fused_chain_vjp(op, k, UC, periodic=periodic, segments=segments,
                        form="local")
    assert g.route == "plane_two_phase"
    st, cot0 = g(_t(state), _t(cots))
    assert g.form == "local" and g.segments == (segments or 1)
    jst, jcot0 = _jax_plane(op, k, UC, periodic, state, cots)
    for n in state:
        _close(st[n], jst[n], f"state {n}")
        _close(cot0[n], jcot0[n], f"cot {n}")
    if not periodic:  # the exact VJP puts gradient into the ghost frame
        assert np.abs(cot0["u"].numpy()[0]).max() > 0


@pytest.mark.parametrize("segments", [None, 2])
def test_local_form_with_probes_matches_jax(segments):
    """nl3d bounded, k=2, with two probe lines: the local form's (state_k,
    cot_0) with probe cotangents equals ``jax.vjp`` of the JAX package's
    fused chain with probes (interpret mode), rtol 1e-10; whole and as 2
    segments (each segment takes its rows of the probe cotangents)."""
    from pystencils_autodiff_tpu.ops.time_chain import \
        fused_time_chain as jchain

    op, k = _nl3d(), 2
    state, cots = _state(op, S3, 13), _cots(op, S3, 14)
    pcs = [np.random.default_rng(15 + i).standard_normal((k, S3[-1]))
           for i in range(len(PROBES))]
    g = fused_chain_vjp(op, k, UC, periodic=False, probes=PROBES,
                        segments=segments, form="local")
    st, cot0 = g(_t(state), _t(cots), tuple(torch.tensor(p) for p in pcs))
    jfn = jchain(jax_twin(op), k, UC, probes=PROBES, interpret=True)
    jst, pull = jax.vjp(jfn, {n: jnp.asarray(a) for n, a in state.items()})
    (jcot0,) = pull(({n: jnp.asarray(a) for n, a in cots.items()},
                     tuple(jnp.asarray(p) for p in pcs)))
    for n in state:
        _close(st[n], jst[0][n], f"state {n}")
        _close(cot0[n], jcot0[n], f"cot {n}")


@pytest.mark.parametrize("name,periodic", [("d3q19", True),
                                           ("wave3d", False),
                                           ("wave3d", True),
                                           ("diffusion3d", False)])
def test_local_form_equals_gather_form(name, periodic):
    """The two plain forms agree, k=2, rtol 1e-10: D3Q19 periodic (whose
    gather form is held against the JAX package in test_torch_plane.py),
    the wave's cotangents carried through unchanged (u_prev ← u) with an
    invariant coefficient that gets a gradient (c), and the variable-κ
    diffusion (κ invariant, ∂/∂κ)."""
    make, carry = OPS[name]
    op = make()
    shape = (6, 4, 5) if name == "d3q19" else (9, 8, 10)
    state, cots = _t(_state(op, shape, 16)), _t(_cots(op, shape, 17))
    ap = ac.AdjointPlan(tc.chain_plan(op, 2, carry, periodic))
    st_g, cot_g = ac.plain_chain_vjp(ap)(state, cots)
    st_l, cot_l = ac.plain_chain_vjp(ap, form="local")(state, cots)
    for n in state:
        _close(st_l[n], st_g[n].numpy(), f"state {n}")
        _close(cot_l[n], cot_g[n].numpy(), f"cot {n}")


def test_d3q19_local_form_through_fused_chain_vjp():
    """D3Q19 periodic k=2 through ``fused_chain_vjp(form="local")`` on CPU
    tensors equals the same call in the gather form, rtol 1e-10."""
    op, shape = _d3q19(), (6, 4, 5)
    state, cots = _t(_state(op, shape, 18)), _t(_cots(op, shape, 19))
    got = fused_chain_vjp(op, 2, LBM, periodic=True, form="local")
    ref = fused_chain_vjp(op, 2, LBM, periodic=True, form="gather")
    (st_l, cot_l), (st_g, cot_g) = got(state, cots), ref(state, cots)
    assert got.form == "local" and ref.form == "gather"
    _close(st_l["f"], st_g["f"].numpy(), "state f")
    _close(cot_l["f"], cot_g["f"].numpy(), "cot f")


def test_d3q19_derivation_size():
    """The D3Q19 local VJP derived by reverse accumulation through the
    forward's 4 subexpressions (ρ, u0, u1, u2) and ``sympy.cse``: 123 steps
    and 472 operations a cell (the gather form's backward program: 1,687
    and 7,043; the forward: 23 and 469); one w slot per read, 19, each
    gathered by the plane it reads at minus its offset."""
    ap = ac.AdjointPlan(tc.chain_plan(_d3q19("float32"), 2, LBM, True))
    lv = local_vjp(ap)
    assert program_cost(lv.program.steps) == (123, 472)
    assert program_cost(ap.bwd.steps) == (1687, 7043)
    assert program_cost(ap.fwd.program.steps) == (23, 469)
    assert len(lv.slots) == 19
    assert all(len(g) == 1 for g in lv.gather)
    assert lv.slots[1] == (1, (-1, 0, 0))  # f_1 is read at x − (1, 0, 0)
    assert lv.gather[1] == [(1, (-1, 0, 0))]


def test_picker_takes_the_form_with_less_work():
    """``stream_geometry`` picks form and tile by the work per owned cell,
    from the reckoning alone: D3Q19 k=2 at 256³ takes the local form (f32:
    14×14, 622 weighted steps an owned cell against the gather form's
    6,995), nl3d (a one-step forward, an 8-operation backward) keeps the
    gather form at 384³, bounded and periodic."""
    plan = tc.chain_plan(_d3q19("float32"), 2, LBM, True)
    ap = ac.AdjointPlan(plan)
    picked = pa.stream_geometry(plan, (256,) * 3, 4, ap)
    gather = pa.stream_geometry(plan, (256,) * 3, 4, ap, form="gather")
    assert picked.form == "local" and picked.tile == (14, 14)
    assert round(picked.work) == 622 and round(gather.work) == 6995
    assert pa.stream_geometry(plan, (128,) * 3, 8, ap).form == "local"
    for periodic in (False, True):
        plan = tc.chain_plan(_nl3d(), 2, UC, periodic)
        ap = ac.AdjointPlan(plan)
        g = pa.stream_geometry(plan, (384,) * 3, 4, ap)
        loc = pa.stream_geometry(plan, (384,) * 3, 4, ap, form="local")
        assert g.form == "gather" and loc.work > g.work


def test_local_source_and_form_checks():
    """The local form's translation unit holds the L body, the gather and
    the carrier table and no backward body; a form is refused where it
    does not apply (2D chains, unknown names)."""
    ap = ac.AdjointPlan(tc.chain_plan(_d3q19(), 2, LBM, True))
    src = generate_plane_source(ap, "two_phase", "float32", "local")
    assert "struct PsatLocal " in src and "struct PsatGather " in src
    assert "struct PsatBwd " not in src and "#define PSAT_FORM 2" in src
    assert "#define PSAT_NW 19" in src and "kMaxCar = 1;" in src
    assert "v[1] = c.w_at(1, 1, 0, 0);" in src
    gsrc = generate_plane_source(ap, "two_phase", "float32")
    assert "#define PSAT_FORM 1" in gsrc and "struct PsatLocal " not in gsrc
    with pytest.raises(ValueError, match="3D two-phase"):
        fused_chain_vjp(heat_step_op(kappa_field=True), 2, UC,
                        periodic=False, form="local")
    with pytest.raises(ValueError, match="unknown form"):
        ac.plain_chain_vjp(ap, form="scatter")
    with pytest.raises(ValueError, match="3D two-phase"):
        fused_chain_vjp(_nl3d(), 2, UC, form="scatter")


# --------------------------------------------------------------------------
# On the card: both forms of the kernel against their plain versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the streaming kernel is compiled "
                    "with nvcc for sm_90a and has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "local"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("name", ["nl3d", "wave3d", "d3q19"])
def test_both_forms_on_the_card(name, dtype, periodic, form, cuda_device,
                                monkeypatch):
    """Each form of the streaming kernel forced, vs the plain version of
    the same form on the same CUDA tensors, on a ragged grid (3×5 lateral
    tiles, 3 dim-0 segments): rtol 1e-12 in f64, 1e-5 with atol
    1e-5·max|ref| in f32 (×10 on the cotangents: k backward sums); bf16
    storage against the f32 plain version on the same bf16-rounded
    inputs, 0.05 of max |ref|.  Every launch is counted under its form."""
    if name == "d3q19" and not periodic:
        pytest.skip("path C's D3Q19 is periodic")
    monkeypatch.setattr(pa, "TILE_Y", (3,))
    monkeypatch.setattr(pa, "TILE_X", (5,))
    monkeypatch.setattr(pa, "STREAM_SEGMENTS", 3)
    monkeypatch.setattr(pa, "MIN_OWNED_SHARE", 0.0)
    make, carry = OPS[name]
    op = make()
    shape = (10, 7, 11) if name == "d3q19" else (11, 9, 37)
    store = dtype if dtype != torch.bfloat16 else torch.float32
    st = {n: t.to(dtype) for n, t in
          _t(_state(op, shape, 21), cuda_device, store).items()}
    cots = {n: t.to(dtype) for n, t in
            _t(_cots(op, shape, 22), cuda_device, store).items()}
    ap = ac.AdjointPlan(tc.chain_plan(op, 2, carry, periodic))
    before = Counter(pa.LAUNCH_CALLS)
    got = pa.make_plane_adjoint_kernel(ap, form)(st, cots)
    torch.cuda.synchronize()
    new = Counter({key: n - before.get(key, 0)
                   for key, n in pa.LAUNCH_CALLS.items()})
    assert +new == Counter({(op.op_name, 2, periodic, shape,
                             dtype.itemsize, "two_phase", form): 1})
    if dtype == torch.bfloat16:
        ref = ac.plain_chain_vjp(ap, form)(
            {n: t.float() for n, t in st.items()},
            {n: t.float() for n, t in cots.items()})
        for i in (0, 1):
            for n, r in ref[i].items():
                err = (got[i][n].float() - r).abs().max().item()
                assert err <= 0.05 * r.abs().max().item(), (i, n, err)
        return
    ref = ac.plain_chain_vjp(ap, form)(st, cots)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i, scale in ((0, 1.0), (1, 10.0)):
        for n, r in ref[i].items():
            torch.testing.assert_close(got[i][n], r, rtol=scale * tol,
                                       atol=scale * tol * r.abs().max()
                                       .item())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "local"])
def test_forced_forms_through_fused_chain_vjp_on_the_card(form,
                                                          cuda_device):
    """``fused_chain_vjp(form=...)`` on CUDA tensors runs the kernel in the
    forced form (nl3d bounded with two probe lines, k=2, f64, the picked
    tile) and equals the same call on CPU tensors (the plain version of
    that form), rtol 1e-12; without ``form`` the picker's form runs (nl3d:
    gather)."""
    op, shape = _nl3d(), (11, 10, 37)
    state, cots = _state(op, shape, 23), _cots(op, shape, 24)
    pcs = [np.random.default_rng(25 + i).standard_normal((2, shape[-1]))
           for i in range(len(PROBES))]
    g = fused_chain_vjp(op, 2, UC, periodic=False, probes=PROBES, form=form)
    card = g(_t(state, cuda_device), _t(cots, cuda_device),
             tuple(torch.tensor(p, device=cuda_device) for p in pcs))
    assert g.form == form
    cpu = g(_t(state), _t(cots), tuple(torch.tensor(p) for p in pcs))
    for a, b in zip(card, cpu):
        for n in b:
            torch.testing.assert_close(a[n].cpu(), b[n], rtol=1e-12,
                                       atol=1e-12 * b[n].abs().max().item())
    picked = fused_chain_vjp(op, 2, UC, periodic=False, probes=PROBES)
    picked(_t(state, cuda_device), _t(cots, cuda_device),
           tuple(torch.tensor(p, device=cuda_device) for p in pcs))
    assert picked.form == "gather"
