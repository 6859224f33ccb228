"""The stage chains of the port (``ops.stage_chain``, ``ops.stage_adjoint``,
``ops.chain_bc``) and the models they carry (elastic, lattice Boltzmann,
advection, phase field) against the JAX package, in float64 on the CPU.

On CPU tensors the port runs the plain versions of its two stage kernels
(k cycles of the plain single steps and the sequential BCs; autograd
through them), so these tests hold the semantics the CUDA kernels are
compared with on the card.  The JAX side is its sequential reference —
``stage_stepper(lowering="jnp")`` with ``apply_bc_sequential`` under
``jax.vjp`` — and, at a few tiny shapes, its fused Pallas chains in
interpret mode.  Every state and BC-parameter plane is compared, ghost
cells included, to rtol 1e-10.  Inputs are made from a seed with numpy.
The ``cuda``-marked tests at the end compare the kernels themselves with
their plain versions (skipped without a card)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pystencils_autodiff_tpu.ops.chain_bc import \
    apply_bc_sequential as japply_bc
from pystencils_autodiff_tpu.ops.chain_bc import \
    normalize_chain_bcs as jnormalize
from pystencils_autodiff_tpu.ops.stage_chain import \
    _validate_stages as jvalidate
from pystencils_autodiff_tpu.ops.stage_chain import \
    fused_stage_chain as jfused_stage_chain
from pystencils_autodiff_tpu.ops.stage_chain import stage_stepper as jstepper

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field, fields
from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
from pystencils_autodiff_tpu_torch.field_tensor_conversion import \
    from_jax_arrays
from pystencils_autodiff_tpu_torch.models import (cahn_hilliard_stages,
                                                  d2q9_bgk_op,
                                                  elastic_stages,
                                                  ginzburg_landau_energy,
                                                  heat_step3d_op,
                                                  macroscopic, wave_step_op,
                                                  weno5_rk3_stages)
from pystencils_autodiff_tpu_torch.ops import (fused_stage_chain,
                                               fused_stage_chain_vjp,
                                               normalize_chain_bcs)
from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec
from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
from pystencils_autodiff_tpu_torch.ops import time_chain as tc
from torch_jax_twin import jax_twin

RTOL = 1e-10
ELASTIC = ["vx", "vy", "sxx", "syy", "sxy"]
WAVE_CARRY = {"u_curr": "u_next", "u_prev": "u_curr"}
CAVITY_BC = {"f": ("bounce_back", "solid", ("uw0", "uw1"))}


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _t(arrays, device="cpu", dtype=torch.float64, grad=False):
    return {n: torch.tensor(np.asarray(a), dtype=dtype, device=device,
                            requires_grad=grad) for n, a in arrays.items()}


def heat_op(dt=0.1):
    u, u_next = fields("u, u_next", 2)
    return AutoDiffOp([Assignment(
        u_next[0, 0],
        u[0, 0] + dt * (u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1]
                        - 4 * u[0, 0]))], op_name="heat2d")


def stream9_op(layout):
    """Pure D2Q9 streaming: keeps the program tiny so the bounce-back
    transpose dominates."""
    from pystencils_autodiff_tpu_torch.models import D2Q9_VELOCITIES

    f = Field("f", 2, index_shape=(9,), dtype="float64", layout=layout)
    fo = Field("f_out", 2, index_shape=(9,), dtype="float64", layout=layout)
    return AutoDiffOp([Assignment(fo(j), f[tuple(-c for c in cj)](j))
                       for j, cj in enumerate(D2Q9_VELOCITIES)],
                      op_name=f"stream9_{layout}")


def _solid(n):
    s = np.zeros((n, n))
    s[0, :] = s[-1, :] = s[:, 0] = s[:, -1] = 1.0
    return s


def cavity_state(n, layout, seed=3):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
    f0 = (w[:, None, None] if layout == "soa" else w) * np.ones(
        (9, n, n) if layout == "soa" else (n, n, 9))
    f0 = f0 + 0.01 * rng.standard_normal(f0.shape)
    lid = np.zeros((n, n))
    lid[0, :] = 1.0
    return {"f": f0, "solid": _solid(n), "uw0": np.zeros((n, n)),
            "uw1": 0.08 * lid}


def _rand_state(names, shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: scale * rng.standard_normal(shape) for n in names}


# ---------------------------------------------------------------------------
# The JAX package's sequential reference.

def _jax_stages(stages):
    return [(jax_twin(op), dict(c)) for op, c in stages]


def jax_sequential(stages, k, periodic, boundary):
    """``run(state) -> state``: k cycles of the JAX package's
    ``apply_bc_sequential`` and ``stage_stepper(lowering="jnp")`` — for an
    'soa' target the BC runs on its AoS view, as the JAX package's own
    tests do."""
    js = _jax_stages(stages)
    progs, _, flds, names = jvalidate(js)
    bcs, extra = jnormalize(boundary, flds,
                            {n: f.index_shape for n, f in flds.items()},
                            progs[0].ndim, len(js),
                            next(iter(flds.values())).dtype)
    flds = {**flds, **extra}
    names = list(names) + list(extra)
    steps = [jstepper(op, c, lowering="jnp", periodic=periodic)
             for op, c in js]

    def bc_step(st, bc, ghost):
        f = flds[bc.field]
        if getattr(f, "index_major", False):
            moved = {**st, bc.field: jnp.moveaxis(st[bc.field], 0, -1)}
            out = japply_bc(moved, bc, ghost, periodic)
            return {**st, bc.field: jnp.moveaxis(out[bc.field], -1, 0)}
        return japply_bc(st, bc, ghost, periodic, fields=flds)

    def run(state):
        st = dict(state)
        for _ in range(k):
            for j, step in enumerate(steps):
                for bc in bcs.get(j, ()):
                    st = bc_step(st, bc, progs[j].ghost)
                st = step(st)
        return {n: st[n] for n in names}

    return run, names


def jax_vjp(stages, k, periodic, boundary, arrays, cots):
    run, names = jax_sequential(stages, k, periodic, boundary)
    out, pull = jax.vjp(run, {n: jnp.asarray(arrays[n]) for n in names})
    (grads,) = pull({n: jnp.asarray(cots[n]) for n in names})
    return out, grads


def port_vjp(stages, k, periodic, boundary, arrays, cots, intermediates=()):
    """Forward state and the cotangents of every state plane through
    ``fused_stage_chain(fused_bwd=True)`` under autograd."""
    chain = fused_stage_chain(stages, k, periodic=periodic, fused_bwd=True,
                              boundary=boundary, intermediates=intermediates)
    names = chain.input_names
    ins = _t({n: arrays[n] for n in names}, grad=True)
    out = chain(ins)
    grads = torch.autograd.grad([out[n] for n in names],
                                [ins[n] for n in names],
                                [torch.tensor(cots[n]) for n in names],
                                allow_unused=True)
    return out, dict(zip(names, grads)), names


# (id, stages, k, periodic, boundary, state, intermediates)
def _cases():
    el = elastic_stages(dtype="float64")
    weno, _ = weno5_rk3_stages(a=1.0, dt=0.3, dx=1.0, ndim=2)
    ch = cahn_hilliard_stages(dt=0.01)
    heat = [(heat_op(), {"u": "u_next"})]
    sh = (40, 32)
    mask = np.zeros(sh)
    mask[10:14, 8:12] = 1.0
    damp = np.asarray(cerjan_damping(sh, width=5, alpha=0.08,
                                     dtype=torch.float64, device="cpu"))
    el_state = _rand_state(ELASTIC, (48, 32), 0)
    rng = np.random.default_rng(7)
    u0 = (np.sin(2 * np.pi * np.arange(32) / 32)[None, :] * np.ones((16, 1))
          + 0.1 * rng.standard_normal((16, 32)))
    wave_state = {**_rand_state(["u_curr", "u_prev"], (36, 32), 20, 0.1),
                  "c": 2.0 + 0.1 * np.abs(rng.standard_normal((36, 32))),
                  "damp": np.asarray(cerjan_damping(
                      (36, 32), width=4, alpha=0.1, free=[(0, 0)],
                      dtype=torch.float64, device="cpu"))}
    return [
        ("elastic-bounded-k1", el, 1, False, None, el_state, ()),
        ("elastic-bounded-k3", el, 3, False, None, el_state, ()),
        ("elastic-periodic-k1", el, 1, True, None, el_state, ()),
        ("elastic-periodic-k3", el, 3, True, None, el_state, ()),
        ("elastic-sponge-k2", el, 2, False,
         {0: {n: ("sponge", "damp") for n in ELASTIC}},
         {**_rand_state(ELASTIC, sh, 1), "damp": damp}, ()),
        ("weno5-rk3-periodic", weno, 1, True, None,
         {"u": u0, "u_s1": np.zeros_like(u0), "u_s2": np.zeros_like(u0)},
         ("u_s1", "u_s2")),
        ("cahn-hilliard-k2", ch, 2, False, None,
         {"phi": 0.3 * np.random.default_rng(2).standard_normal((40, 32)),
          "mu": np.zeros((40, 32))}, ("mu",)),
        ("dirichlet-frame", heat, 2, False, {"u": ("dirichlet", 1.5)},
         _rand_state(["u"], sh, 3), ()),
        ("dirichlet-rows", heat, 2, False, {"u": ("dirichlet", 0.5, (0,))},
         _rand_state(["u"], sh, 3), ()),
        ("neumann-2d", heat, 2, False, {"u": "neumann"},
         _rand_state(["u"], sh, 4), ()),
        ("neumann-3d", [(heat_step3d_op(dtype="float64"), {"u": "u_next"})],
         2, False, {"u": "neumann"}, _rand_state(["u"], (10, 9, 12), 5), ()),
        ("masked-dirichlet-field", heat, 2, False,
         {"u": ["neumann", ("masked_dirichlet", "obst", "uval")]},
         {**_rand_state(["u", "uval"], sh, 6), "obst": mask}, ()),
        ("sponge-field-dirichlet", heat, 3, False,
         {"u": [("sponge", "damp"), ("dirichlet", 0.0)]},
         {**_rand_state(["u"], sh, 8), "damp": damp}, ()),
        ("sponge-wave", [(wave_step_op(dt=0.2, dtype="float64"), WAVE_CARRY)],
         2, False, {"u_curr": ("sponge", "damp"),
                    "u_prev": ("sponge", "damp")}, wave_state, ()),
        ("cavity-aos", [(d2q9_bgk_op(omega=1.6), {"f": "f_out"})], 2, False,
         CAVITY_BC, cavity_state(16, "aos"), ()),
        ("cavity-soa", [(d2q9_bgk_op(omega=1.6, layout="soa"),
                         {"f": "f_out"})], 1, False, CAVITY_BC,
         cavity_state(16, "soa"), ()),
        ("stream9-periodic-bounce", [(stream9_op("aos"), {"f": "f_out"})], 2,
         True, {"f": ("bounce_back", "solid", ("uw0", 0.02))},
         {k: v for k, v in cavity_state(16, "aos").items() if k != "uw1"},
         ()),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stage_chain_matches_jax_sequential(case):
    """Forward state and fused-backward cotangents of every state and
    BC-parameter plane (ghost cells included) against the JAX package's
    sequential steps under ``jax.vjp``, rtol 1e-10."""
    _, stages, k, periodic, boundary, arrays, inter = case
    rng = np.random.default_rng(99)
    cots = {n: rng.standard_normal(np.shape(a)) for n, a in arrays.items()}
    out, grads, names = port_vjp(stages, k, periodic, boundary, arrays,
                                 cots, inter)
    jout, jgrads = jax_vjp(stages, k, periodic, boundary, arrays, cots)
    assert sorted(names) == sorted(jout)
    for n in names:
        _close(out[n], jout[n], what=f"state {n}")
        g = grads[n] if grads[n] is not None else torch.zeros(())
        _close(g.expand(np.shape(jgrads[n])), jgrads[n], what=f"cot {n}")


def test_direct_vjp_matches_autograd_and_keeps_invariant_planes():
    """``fused_stage_chain_vjp`` called directly: its cotangents equal the
    autograd route's; without ``wanted`` every invariant field (a BC
    parameter) gets its cotangent, with ``wanted=()`` none does."""
    _, stages, k, periodic, boundary, arrays, _ = next(
        c for c in CASES if c[0] == "sponge-field-dirichlet")
    rng = np.random.default_rng(4)
    cots = {n: rng.standard_normal(np.shape(a)) for n, a in arrays.items()}
    _, grads, _ = port_vjp(stages, k, periodic, boundary, arrays, cots)
    g = fused_stage_chain_vjp(stages, k, periodic=periodic,
                              boundary=boundary)
    st, cot0 = g(_t(arrays), _t(cots))
    assert g.segments == 1 and sorted(cot0) == ["damp", "u"]
    for n in cot0:
        _close(cot0[n], grads[n].numpy(), 1e-12, n)
    g0 = fused_stage_chain_vjp(stages, k, periodic=periodic,
                               boundary=boundary, wanted=())
    _, cot_u = g0(_t(arrays), _t(cots))
    assert sorted(cot_u) == ["u"]
    _close(cot_u["u"], grads["u"].numpy(), 1e-12, "u")


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_cavity_lid_velocity_gradient_matches_jax(layout):
    """The lid-driven cavity: value and d/d u_lid of a loss on the final
    populations, u_lid a scalar entering as ``uw1 = lid_mask · u_lid``,
    against ``jax.grad`` of the JAX package's sequential steps."""
    n, k = 16, 2
    stages = [(d2q9_bgk_op(omega=1.6, layout=layout), {"f": "f_out"})]
    arrays = cavity_state(n, layout)
    lid = (arrays["uw1"] != 0).astype(float)
    chain = fused_stage_chain(stages, k, fused_bwd=True, boundary=CAVITY_BC)
    u = torch.tensor(0.08, dtype=torch.float64, requires_grad=True)
    st = _t({k_: v for k_, v in arrays.items() if k_ != "uw1"})
    loss = torch.sin(chain({**st, "uw1": torch.tensor(lid) * u})["f"]).sum()
    (g,) = torch.autograd.grad(loss, u)
    run, _ = jax_sequential(stages, k, False, CAVITY_BC)

    def jloss(uv):
        state = {k_: jnp.asarray(v) for k_, v in arrays.items()}
        state["uw1"] = jnp.asarray(lid) * uv
        return jnp.sum(jnp.sin(run(state)["f"]))

    jv, jg = jax.value_and_grad(jloss)(0.08)
    _close(loss.detach().numpy(), np.asarray(jv), what="loss")
    _close(g.numpy(), np.asarray(jg), what="u_lid gradient")
    assert abs(float(g)) > 0


@pytest.mark.parametrize("which", ["elastic", "cavity-soa"])
def test_matches_jax_fused_chains_in_interpret_mode(which):
    """Against the JAX package's own fused stage chain and fused adjoint
    (Pallas kernels in interpret mode): state and cotangents."""
    from pystencils_autodiff_tpu.ops.stage_adjoint import \
        fused_stage_chain_vjp as jvjp

    if which == "elastic":
        stages, k, boundary = elastic_stages(dtype="float64"), 2, None
        arrays = _rand_state(ELASTIC, (32, 32), 11)
    else:
        stages = [(d2q9_bgk_op(omega=1.6, layout="soa"), {"f": "f_out"})]
        k, boundary, arrays = 1, CAVITY_BC, cavity_state(12, "soa")
    rng = np.random.default_rng(12)
    cots = {n: rng.standard_normal(np.shape(a)) for n, a in arrays.items()}
    js = _jax_stages(stages)
    jst = {n: jnp.asarray(a) for n, a in arrays.items()}
    jout = jfused_stage_chain(js, k, interpret=True, tile_rows=16,
                              boundary=boundary)(jst)
    out = fused_stage_chain(stages, k, boundary=boundary)(_t(arrays))
    for n in out:
        _close(out[n], jout[n], what=f"state {n}")
    progs, carries, flds, _ = jvalidate(js)
    bcs, extra = jnormalize(boundary, flds,
                            {n: f.index_shape for n, f in flds.items()},
                            progs[0].ndim, len(js),
                            next(iter(flds.values())).dtype)
    _, jcot = jvjp(js, k, interpret=True, tile_rows=16, bcs=bcs,
                   extra_state=extra)(jst, {n: jnp.asarray(c)
                                            for n, c in cots.items()})
    _, cot0 = fused_stage_chain_vjp(stages, k, boundary=boundary)(
        _t(arrays), _t(cots))
    for n in cot0:
        _close(cot0[n], jcot[n], what=f"cot {n}")


@pytest.mark.parametrize("which", ["elastic-sponge", "cavity"])
def test_segmented_adjoint_equals_monolithic(which):
    """The segmented form (the forward chain writes checkpoints, the
    shallower adjoint runs per segment in reverse) equals the monolithic
    adjoint, state and cotangents."""
    if which == "cavity":
        stages = [(d2q9_bgk_op(omega=1.6, layout="soa"), {"f": "f_out"})]
        k, boundary, arrays = 4, CAVITY_BC, cavity_state(14, "soa")
    else:
        stages, k = elastic_stages(dtype="float64"), 2
        boundary = {0: {n: ("sponge", "damp") for n in ELASTIC}}
        arrays = {**_rand_state(ELASTIC, (24, 20), 13),
                  "damp": np.asarray(cerjan_damping(
                      (24, 20), width=4, alpha=0.1, dtype=torch.float64,
                      device="cpu"))}
    rng = np.random.default_rng(14)
    cots = {n: rng.standard_normal(np.shape(a)) for n, a in arrays.items()}
    mono = fused_stage_chain_vjp(stages, k, boundary=boundary)
    seg = fused_stage_chain_vjp(stages, k, boundary=boundary, segments=k)
    s1, c1 = mono(_t(arrays), _t(cots))
    s2, c2 = seg(_t(arrays), _t(cots))
    assert (mono.segments, seg.segments) == (1, k)
    for n in s1:
        _close(s2[n], s1[n].numpy(), 1e-12, f"state {n}")
    for n in c1:
        _close(c2[n], c1[n].numpy(), 1e-12, f"cot {n}")
    with pytest.raises(ValueError, match="must divide"):
        fused_stage_chain_vjp(stages, k, boundary=boundary, segments=3)


def test_plans_and_schedules():
    """Per-dim, per-side reach from each stage's accesses; chain-invariant
    BC parameter planes; pointwise BCs write in place; the cavity's
    adjoint at 4096² f32 fits a 2-deep tile (16 columns wide) but no
    4-deep one."""
    el = sc.StagePlan(elastic_stages(), 4, False,
                      {0: {n: ("sponge", "damp") for n in ELASTIC}})
    stage_reach = [ev.reach for ev in el.cycle if ev.kind == "stage"]
    assert stage_reach == [([1, 1], [1, 1]), ([1, 1], [1, 1])]
    assert el.invariant == {"damp"}
    sbuf, obuf, npool = sc.event_schedule(el)
    assert npool == len(el.planes) + 3  # sponges in place, stress: 3 outs
    ap = sa.AdjointStagePlan(el, wanted=())
    _, (tile, ext, _) = sa.adjoint_geometry(ap, (8192, 8192), 4)
    assert ext == (tile[0] + 32, tile[1] + 32)
    cav = [(d2q9_bgk_op(omega=1.7, dtype="float32", layout="soa"),
            {"f": "f_out"})]
    g = fused_stage_chain_vjp(cav, 4, boundary=CAVITY_BC, wanted={"uw1"})
    geo_ok = []
    for kk in (4, 2, 1):
        try:
            sa.adjoint_geometry(g.at_depth(kk)[2], (4096, 4096), 4)
            geo_ok.append(kk)
        except ValueError:
            pass
    assert geo_ok == [2, 1]


def test_validation_errors_raise_as_in_jax():
    el = elastic_stages(dtype="float64")
    heat = [(heat_op(), {"u": "u_next"})]
    with pytest.raises(ValueError, match="carry source"):
        fused_stage_chain([(el[0][0], {"vx": "nope"})], 1)
    with pytest.raises(ValueError, match="carry target"):
        fused_stage_chain([(el[0][0], {"zz": "vx_next"})], 1)
    with pytest.raises(ValueError, match="no stages"):
        fused_stage_chain([], 1)
    with pytest.raises(ValueError, match="meaningless on"):
        fused_stage_chain(heat, 1, periodic=True, boundary={"u": "neumann"})
    with pytest.raises(TypeError, match="state-field NAME"):
        fused_stage_chain(heat, 1, boundary={"u": ("masked_dirichlet",
                                                   np.zeros((4, 4)), 0.0)})
    with pytest.raises(ValueError, match="not a chain state field"):
        fused_stage_chain(heat, 1, boundary={"zz": "neumann"})
    with pytest.raises(ValueError, match="out of range"):
        fused_stage_chain(heat, 1, boundary={3: {"u": "neumann"}})
    with pytest.raises(ValueError, match="cannot fuse"):
        normalize_chain_bcs({"u": "periodic"}, {"u": Field("u", 2)},
                            {"u": ()}, 2, 1, "float64")
    with pytest.raises(ValueError, match="1-index-dim population"):
        fused_stage_chain(heat, 1, boundary={"u": ("bounce_back", "s")})
    u, m, u_next = fields("u, m, u_next", 2)
    op2 = AutoDiffOp([Assignment(
        u_next[0, 0], u[0, 0] + 0.1 * m[0, 0]
        + 0.1 * (u[1, 0] + u[-1, 0] - 2 * u[0, 0]))], op_name="heat_m")
    with pytest.raises(ValueError, match="carry targets"):
        fused_stage_chain([(op2, {"u": "u_next", "m": "u_next"})], 2,
                          boundary={"u": ("masked_dirichlet", "m", 0.5)},
                          fused_bwd=True)
    with pytest.raises(ValueError, match="aliases"):
        fused_stage_chain(heat, 2, fused_bwd=True,
                          boundary={"u": ("masked_dirichlet", "obst", "u")})
    # the intermediates check, with the collision stages of the JAX tests
    c, mu, c_next = fields("c, mu, c_next", 2)
    op_mu = AutoDiffOp([Assignment(
        mu[0, 0], c[1, 0] + c[-1, 0] + c[0, 1] + c[0, -1] - 4 * c[0, 0])],
        op_name="mu_sweep")
    op_c = AutoDiffOp([Assignment(
        c_next[0, 0], c[0, 0] + 0.1 * mu[0, 0])], op_name="c_sweep")
    good = [(op_mu, {"mu": "mu"}), (op_c, {"c": "c_next"})]
    chain = fused_stage_chain(good, 1, intermediates=("mu",))
    assert chain.initial_read_fields == ["c"]
    with pytest.raises(ValueError, match="misordered"):
        fused_stage_chain(good[::-1], 1, intermediates=("mu",))
    with pytest.raises(ValueError, match="not state fields"):
        fused_stage_chain(good, 1, intermediates=("zz",))
    with pytest.raises(ValueError, match="2D-only"):
        fused_stage_chain([(heat_step3d_op(dtype="float64"),
                            {"u": "u_next"})], 1, periodic=True)
    with pytest.raises(ValueError, match="2D-only"):
        fused_stage_chain_vjp([(heat_step3d_op(dtype="float64"),
                                {"u": "u_next"})], 1, periodic=True)
    with pytest.raises(ValueError, match="fused_bwd=True"):
        fused_stage_chain(heat, 1, shard=ShardSpec((8, 8), (0,)))


def test_unmapped_output_name_collision_passes_through():
    """A state field named like a stage output, not in the carry map,
    passes through unchanged (stage_stepper semantics), forward and
    backward."""
    c, mu, c_next = fields("c, mu, c_next", 2)
    op1 = AutoDiffOp([Assignment(
        mu[0, 0], c[1, 0] + c[-1, 0] + c[0, 1] + c[0, -1] - 4 * c[0, 0])],
        op_name="mu_sweep")
    op2 = AutoDiffOp([Assignment(
        c_next[0, 0],
        c[0, 0] + 0.1 * mu[0, 0] + 0.01 * (mu[1, 0] + mu[-1, 0]))],
        op_name="c_sweep")
    stages = [(op1, {}), (op2, {"c": "c_next"})]
    arrays = _rand_state(["c", "mu"], (32, 32), 21)
    cots = _rand_state(["c", "mu"], (32, 32), 22)
    out, grads, names = port_vjp(stages, 2, False, None, arrays, cots)
    jout, jgrads = jax_vjp(stages, 2, False, None, arrays, cots)
    _close(out["mu"], arrays["mu"], 0.0, "mu passes through")
    for n in names:
        _close(out[n], jout[n], what=n)
        _close(grads[n], jgrads[n], what=f"cot {n}")


def test_models_match_jax():
    """The copied models build the same programs; ``macroscopic`` and
    ``ginzburg_landau_energy`` on tensors equal the JAX package's."""
    from pystencils_autodiff_tpu.models import elastic as jel
    from pystencils_autodiff_tpu.models import lbm as jlbm
    from pystencils_autodiff_tpu.models import phasefield as jpf
    from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                      d3q19_bgk_op)
    from pystencils_autodiff_tpu_torch.ops import forward_program

    for port, ref in ((anisotropic27_op(dtype="float64"),
                       jel.anisotropic27_op(dtype="float64")),
                      (d3q19_bgk_op(), jlbm.d3q19_bgk_op())):
        a = forward_program(port).steps
        b = [str(s.rhs) for s in
             __import__("pystencils_autodiff_tpu.ops.common",
                        fromlist=["forward_program"]).forward_program(
                 ref).steps]
        assert [str(s.rhs) for s in a] == b
    rng = np.random.default_rng(30)
    f = 0.1 + rng.random((9, 12, 10))
    for layout, arr in (("soa", f), ("aos", np.moveaxis(f, 0, -1))):
        port = macroscopic(torch.tensor(arr), layout=layout)
        ref = jlbm.macroscopic(jnp.asarray(arr), layout=layout)
        for p, r in zip(port, ref):
            _close(p, r, 1e-14, f"macroscopic {layout}")
    phi = rng.standard_normal((12, 10))
    _close(ginzburg_landau_energy(torch.tensor(phi), kappa=0.7),
           jpf.ginzburg_landau_energy(jnp.asarray(phi), kappa=0.7), 1e-13)


def test_from_jax_arrays_takes_a_chain_state():
    """``from_jax_arrays`` checks a chain's state, BC planes included, and a
    stage list's fields."""
    stages = [(d2q9_bgk_op(omega=1.6, layout="soa"), {"f": "f_out"})]
    chain = fused_stage_chain(stages, 1, boundary=CAVITY_BC)
    arrays = cavity_state(10, "soa")
    moved = from_jax_arrays(chain, arrays, "cpu")
    assert moved["f"].shape == (9, 10, 10) and moved["uw1"].shape == (10, 10)
    with pytest.raises(ValueError, match="index dims"):
        from_jax_arrays(chain, {"f": np.zeros((10, 10, 9))}, "cpu")
    with pytest.raises(KeyError, match="not a field"):
        from_jax_arrays(stages, {"solid": arrays["solid"]}, "cpu")
    el = from_jax_arrays(elastic_stages(), _rand_state(ELASTIC, (6, 5), 0),
                         "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in el.values())


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage kernels are compiled "
                    "with nvcc for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


# the kernels' cases, one cycle deep where no deeper f64 tile fits (the
# wrappers segment those; here each kernel runs whole)
_ONE_DEEP = ("neumann-3d", "cavity-aos", "stream9-periodic-bounce")
KERNEL_CASES = [(c[0], c[1], 1 if c[0] in _ONE_DEEP else c[2], *c[3:])
                for c in CASES if c[0] in (
    "elastic-bounded-k3", "elastic-periodic-k3", "elastic-sponge-k2",
    "weno5-rk3-periodic", "cahn-hilliard-k2", "neumann-2d", "neumann-3d",
    "masked-dirichlet-field", "sponge-field-dirichlet", "sponge-wave",
    "cavity-aos", "cavity-soa", "stream9-periodic-bounce")]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", ["small", "picked"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_stage_kernels_match_plain_versions(case, dtype, tiles, cuda_device,
                                            monkeypatch):
    """Kernel 12 and kernel 13 vs their plain versions on the same CUDA
    tensors (the box design on ragged grids of forced small tiles, or the
    design and tile the reckoning picks); rtol 1e-12 in f64, 1e-5 with
    atol 1e-5·max|ref| in f32 (×10 on the cotangents: FMA contraction and
    summation order differ)."""
    if tiles == "small":
        monkeypatch.setattr(tc, "TILE_ROWS", (8,))
        monkeypatch.setattr(tc, "TILE_COLS", (32,))
        monkeypatch.setattr(tc, "TILE_DEPTH_3D", (2,))
        monkeypatch.setattr(tc, "TILE_ROWS_3D", (4,))
        monkeypatch.setattr(tc, "MIN_OWNED_SHARE", 0.0)
    _, stages, k, periodic, boundary, arrays, inter = case
    plan = sc.StagePlan(stages, k, periodic, boundary, inter)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    st = _t(arrays, cuda_device, dtype)
    rng = np.random.default_rng(40)
    ap = sa.AdjointStagePlan(plan)
    cots = _t({n: rng.standard_normal(np.shape(arrays[n]))
               for n in ap.cot_names}, cuda_device, dtype)
    before = (sc.LAUNCHES, sa.LAUNCHES)
    design = "box" if tiles == "small" else "march"
    got = sc.make_stage_kernel(plan, design)(st)
    got_s, got_c = sa.make_stage_adjoint_kernel(ap, design)(st, cots)
    torch.cuda.synchronize()
    assert (sc.LAUNCHES, sa.LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = sc.plain_stage_chain(plan)(st)
    ref_s, ref_c = sa.plain_stage_chain_vjp(ap)(st, cots)

    def check(a, b, scale=1.0):
        torch.testing.assert_close(a, b, rtol=scale * tol,
                                   atol=scale * tol * b.abs().max().item())

    for n in plan.invariant:  # returned as given, not written
        assert got[n] is st[n] and got_s[n] is st[n]
    for n in ref:
        check(got[n], ref[n])
        check(got_s[n], ref_s[n])
    for n in ref_c:
        check(got_c[n], ref_c[n], 10.0)


@pytest.mark.cuda
def test_cavity_gradient_on_the_card_matches_cpu(cuda_device):
    """The cavity's loss and u_lid gradient through the fused chain (kernel
    12 forward, kernel 13 backward, segmented where the tile reckoning asks
    for it) equal the CPU run of the plain versions, float64."""
    n, k = 48, 4
    stages = [(d2q9_bgk_op(omega=1.7, layout="soa"), {"f": "f_out"})]
    arrays = cavity_state(n, "soa")
    lid = torch.tensor((arrays["uw1"] != 0).astype(float))
    res = {}
    for dev in ("cpu", cuda_device):
        chain = fused_stage_chain(stages, k, fused_bwd=True,
                                  boundary=CAVITY_BC)
        st = _t({k_: v for k_, v in arrays.items() if k_ != "uw1"}, dev)
        u = torch.tensor(0.05, dtype=torch.float64, device=dev,
                         requires_grad=True)
        f = chain({**st, "uw1": lid.to(dev) * u})["f"]
        loss = (f ** 2).mean()
        (g,) = torch.autograd.grad(loss, u)
        res[str(dev)] = (loss.item(), g.item())
    (lc, gc), (lg, gg) = res["cpu"], res[str(cuda_device)]
    assert abs(lg - lc) <= 1e-12 * abs(lc) and abs(gg - gc) <= 1e-12 * abs(gc)


@pytest.mark.cuda
def test_segmented_adjoint_on_the_card(cuda_device):
    """Forced segments on the card equal the monolithic kernel 13."""
    stages, k = elastic_stages(dtype="float64"), 4
    arrays = _rand_state(ELASTIC, (70, 45), 50)
    cots = _rand_state(ELASTIC, (70, 45), 51)
    mono = fused_stage_chain_vjp(stages, k)
    seg = fused_stage_chain_vjp(stages, k, segments=2)
    s1, c1 = mono(_t(arrays, cuda_device), _t(cots, cuda_device))
    s2, c2 = seg(_t(arrays, cuda_device), _t(cots, cuda_device))
    for n in ELASTIC:
        torch.testing.assert_close(s2[n], s1[n], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(c2[n], c1[n], rtol=1e-12, atol=1e-12)


def multi_carrier_op():
    """``u_next = u·u[1,0] + 0.1·v``: with carry {"u": "u_next", "v":
    "u_next"} its output is carried into two state fields."""
    u, v, un = fields("u, v, u_next", 2)
    return AutoDiffOp([Assignment(un.center, u[0, 0] * u[1, 0] + 0.1 * v[0, 0])],
                      op_name="multi_carrier_stage")


MULTI_CARRY = {"u": "u_next", "v": "u_next"}


@pytest.mark.parametrize("segments", [None, 2])
def test_output_carried_into_several_fields_matches_jax(segments):
    """Kernel 13's plan takes an output carried into two state fields (the
    slot reads the sum of both cotangents); its value and cotangents match
    the JAX package's fused_stage_chain_vjp in interpret mode, f64, whole
    and in 2 segments."""
    from pystencils_autodiff_tpu.ops.stage_adjoint import \
        fused_stage_chain_vjp as jvjp

    stages, k = [(multi_carrier_op(), MULTI_CARRY)], 2
    arrays = _rand_state(["u", "v"], (20, 16), 61, 0.5)
    cots = _rand_state(["u", "v"], (20, 16), 62)
    ap = sa.AdjointStagePlan(sc.StagePlan(stages, k, False, None, ()))
    (t,) = [t for t in ap.tables if t is not None]
    assert [len(a) for a in t["adj"] if a] == [2]
    jst = {n: jnp.asarray(a) for n, a in arrays.items()}
    jout, jcot = jvjp(_jax_stages(stages), k, interpret=True, tile_rows=16)(
        jst, {n: jnp.asarray(c) for n, c in cots.items()})
    out, cot0 = fused_stage_chain_vjp(stages, k, segments=segments)(
        _t(arrays), _t(cots))
    for n in ("u", "v"):
        _close(out[n], jout[n], what=f"state {n}")
        _close(cot0[n], jcot[n], what=f"cot {n}")
    # and through the chain under autograd, against the sequential steps
    ref_out, ref_g = jax_vjp(stages, k, False, None, arrays, cots)
    got_out, got_g, names = port_vjp(stages, k, False, None, arrays, cots)
    for n in names:
        _close(got_out[n], ref_out[n], what=n)
        _close(got_g[n], ref_g[n], what=f"grad {n}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multi_carrier_stage_adjoint_on_the_card(dtype, cuda_device):
    """Kernel 13 on the multi-carrier op vs its plain version (rtol 1e-12
    in f64, 1e-4 with atol 1e-4·max|ref| on the f32 cotangents)."""
    stages, k = [(multi_carrier_op(), MULTI_CARRY)], 2
    arrays = _rand_state(["u", "v"], (70, 45), 63, 0.5)
    cots = _rand_state(["u", "v"], (70, 45), 64)
    ap = sa.AdjointStagePlan(sc.StagePlan(stages, k, False, None, ()))
    st, ct = _t(arrays, cuda_device, dtype), _t(cots, cuda_device, dtype)
    before = sa.LAUNCHES
    got_s, got_c = sa.make_stage_adjoint_kernel(ap)(st, ct)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == before + 1
    ref_s, ref_c = sa.plain_stage_chain_vjp(ap)(st, ct)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for n in ("u", "v"):
        torch.testing.assert_close(got_s[n], ref_s[n], rtol=tol,
                                   atol=tol * ref_s[n].abs().max().item())
        torch.testing.assert_close(got_c[n], ref_c[n], rtol=10 * tol,
                                   atol=10 * tol * ref_c[n].abs().max().item())


# ---------------------------------------------------------------------------
# bfloat16 state (tests/test_bf16.py's cases): the port's bf16 calls against
# the JAX package's bf16 calls and against float32, to 0.05 (bf16 keeps ~8
# mantissa bits; 2 smoothing steps keep values O(1)).

def _bf16_heat():
    return heat_op()


def _bf16_u0(n=32):
    return np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)


def _bf16_close(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(jnp.asarray(got).astype(jnp.float32))
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else \
        np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("periodic", [True, False])
def test_bf16_stage_chain_tracks_jax_and_f32(periodic):
    """``fused_stage_chain(..., dtype=torch.bfloat16)`` casts the state and
    returns it in bf16; it tracks the JAX package's bf16 chain and the f32
    chain to 0.05."""
    stages, k, u0 = [(_bf16_heat(), {"u": "u_next"})], 2, _bf16_u0()
    jout = jfused_stage_chain(_jax_stages(stages), k, periodic=periodic,
                              interpret=True, dtype=jnp.bfloat16)(
        {"u": jnp.asarray(u0).astype(jnp.bfloat16)})["u"]
    out = fused_stage_chain(stages, k, periodic=periodic,
                            dtype=torch.bfloat16)({"u": torch.tensor(u0)})["u"]
    ref = fused_stage_chain(stages, k, periodic=periodic)(
        {"u": torch.tensor(u0)})["u"]
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    _bf16_close(out, jout)
    _bf16_close(out, ref)


def test_bf16_fused_chain_vjp_tracks_jax_and_f32():
    """``fused_chain_vjp`` on bf16 state returns bf16 state and finite
    cotangents that track the JAX package's bf16 call and float32 (0.05)."""
    from pystencils_autodiff_tpu.ops.adjoint_chain import \
        fused_chain_vjp as jvjp
    from pystencils_autodiff_tpu_torch.ops import fused_chain_vjp

    op, u0 = _bf16_heat(), _bf16_u0()
    jst, jcot = jvjp(jax_twin(op), 2, {"u": "u_next"}, periodic=True,
                     interpret=True)(
        {"u": jnp.asarray(u0).astype(jnp.bfloat16)},
        {"u": jnp.ones((32, 32), jnp.bfloat16)})
    g = fused_chain_vjp(op, 2, {"u": "u_next"}, periodic=True)
    ub = torch.tensor(u0).to(torch.bfloat16)
    st, cot0 = g({"u": ub}, {"u": torch.ones_like(ub)})
    _, ref = g({"u": torch.tensor(u0)}, {"u": torch.ones(32, 32)})
    assert st["u"].dtype == torch.bfloat16 and cot0["u"].dtype == torch.bfloat16
    assert torch.isfinite(cot0["u"].float()).all()
    assert cot0["u"].float().abs().max() > 0
    _bf16_close(st["u"], jst["u"])
    _bf16_close(cot0["u"], jcot["u"])
    _bf16_close(cot0["u"], ref["u"])


@pytest.mark.parametrize("strategy", [None, "tiled"])
def test_bf16_single_step_tracks_jax_and_f32(strategy):
    """The op's single step and its gradient on bf16 tensors (both forms
    of the kernel's plain version) against the JAX package's jnp lowering
    on bf16 arrays and against float32, to 0.05."""
    op, u0 = _bf16_heat(), _bf16_u0()
    cot = np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32)
    f = op.torch_function(strategy=strategy)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        u = torch.tensor(u0).to(dt).requires_grad_()
        out = f(u)
        (gu,) = torch.autograd.grad(out, [u], [torch.tensor(cot).to(dt)])
        assert out.dtype == dt and gu.dtype == dt
        res[dt] = (out.detach(), gu)
    jf = jax_twin(op).jax_function(lowering="jnp")
    jout, pull = jax.vjp(jf, jnp.asarray(u0).astype(jnp.bfloat16))
    (jg,) = pull(jnp.asarray(cot).astype(jnp.bfloat16))
    for got, want, ref in zip(res[torch.bfloat16], (jout, jg),
                              res[torch.float32]):
        _bf16_close(got, want)
        _bf16_close(got, ref)


@pytest.mark.cuda
def test_bf16_stage_kernels_on_the_card(cuda_device):
    """Kernels 12 and 13 on bf16 state (stored bf16, computed in float) vs
    their plain versions in f32 on the same bf16-rounded inputs: within
    0.05 of max |ref|."""
    stages, k = elastic_stages(), 2
    plan = sc.StagePlan(stages, k, False, None, ())
    ap = sa.AdjointStagePlan(plan)
    arrays = _rand_state(ELASTIC, (70, 45), 70)
    cots = _rand_state(ap.cot_names, (70, 45), 71)
    st = _t(arrays, cuda_device, torch.bfloat16)
    ct = _t(cots, cuda_device, torch.bfloat16)
    got = sc.make_stage_kernel(plan)(st)
    got_s, got_c = sa.make_stage_adjoint_kernel(ap)(st, ct)
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
