"""The port's autotune sweep (``pystencils_autodiff_tpu_torch.utils.autotune``):
candidate selection, persistence, failure routing and the measured-best
default form — the 18 cases of ``tests/test_autotune.py``.  The
measurement is injected (deterministic fake timers) so these run on the
CPU; the default timers run at small sizes here and, in the ``cuda``
case, on the card.  The sweep axes are the chain depth k and the fused
adjoint's form (the JAX API's tile axis)."""

import json
import logging

import pytest
import torch

from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field
from pystencils_autodiff_tpu_torch.models import heat_step_op
from pystencils_autodiff_tpu_torch.utils import (autotune_chain,
                                                 autotune_stage_chain)
from pystencils_autodiff_tpu_torch.utils import autotune as at


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("PYSTENCILS_ADTPU_TUNE_CACHE", str(path))
    return path


def _state(n=32):
    gen = torch.Generator().manual_seed(0)
    return {"u": torch.randn((n, n), generator=gen, dtype=torch.float32)}


def _nl3d():
    """A nonlinear 3D op: its fused adjoint takes the z-streaming route,
    the one with forms."""
    u, o = Field("u", 3, dtype="float64"), Field("u_next", 3,
                                                 dtype="float64")
    return AutoDiffOp([Assignment(o.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")


def _state3(n=8):
    gen = torch.Generator().manual_seed(1)
    return {"u": torch.randn((n, n, n), generator=gen, dtype=torch.float64)}


def fake_timer_table(times):
    def timer(chain_fn, state, k, calls, repeats, vjp):
        return times[k]
    return timer


def test_picks_fastest_candidate(tune_cache):
    op = heat_step_op(dt=0.1)
    state = _state()
    res = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4, 8),
                         periodic=True,
                         timer=fake_timer_table({2: 3e-3, 4: 1e-3, 8: 2e-3}))
    assert res.best == {"k": 4, "form": None}
    assert res.per_step_s == 1e-3
    assert not res.cached
    assert set(res.table) == {(2, None), (4, None), (8, None)}
    # the returned fn is the built chain at the winning config
    out = res.fn({"u": state["u"]})
    assert out["u"].shape == state["u"].shape


def test_cache_hit_skips_measurement(tune_cache):
    op = heat_step_op(dt=0.1)
    state = _state()
    autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                   periodic=True, timer=fake_timer_table({2: 2e-3, 4: 1e-3}))
    assert tune_cache.exists()
    entry = next(iter(json.loads(tune_cache.read_text()).values()))
    assert entry["k"] == 4

    calls = []

    def counting_timer(chain_fn, state, k, c, r, vjp):
        calls.append(k)
        return 1.0

    res = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                         periodic=True, timer=counting_timer)
    assert res.cached and res.best["k"] == 4 and not calls
    # force=True re-measures
    res2 = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                          periodic=True, timer=counting_timer, force=True)
    assert not res2.cached and calls == [2, 4]


def test_failed_candidates_are_skipped(tune_cache):
    op = heat_step_op(dt=0.1)

    def flaky_timer(chain_fn, st, k, calls, repeats, vjp):
        if k == 2:
            raise RuntimeError("synthetic launch failure")
        return float(k)

    res = autotune_chain(op, {"u": "u_next"}, _state(),
                         k_candidates=(2, 4, 8), periodic=True,
                         timer=flaky_timer)
    assert res.best["k"] == 4
    assert (2, None) not in res.table


def test_all_failed_raises(tune_cache):
    op = heat_step_op(dt=0.1)

    def bad_timer(*a):
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError):
        autotune_chain(op, {"u": "u_next"}, _state(), k_candidates=(2,),
                       periodic=True, timer=bad_timer)


def test_vjp_direction_tunes_fused_chain_vjp(tune_cache):
    op = heat_step_op(dt=0.1)
    state = _state()
    res = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                         vjp=True, periodic=True,
                         timer=fake_timer_table({2: 1e-3, 4: 2e-3}))
    assert res.best["k"] == 2
    st2, cot0 = res.fn({"u": state["u"]}, {"u": torch.ones_like(state["u"])})
    assert st2["u"].shape == state["u"].shape
    assert cot0["u"].shape == state["u"].shape


def test_default_timer_runs_both_directions(tune_cache):
    """The real measurement path on the CPU's plain versions — guards the
    timers' plumbing (the forward carry is the state dict itself, the
    value+gradient carries its cotangents)."""
    op = heat_step_op(dt=0.1)
    state = _state(16)
    res_f = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2,),
                           periodic=True, calls=2, repeats=1)
    assert res_f.per_step_s > 0
    res_b = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2,),
                           vjp=True, periodic=True, calls=2, repeats=1)
    assert res_b.per_step_s > 0


@pytest.mark.cuda
def test_default_timer_on_hardware(tune_cache):
    """The real measurement path: sweep two depths on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernels are compiled "
                    "with nvcc for sm_90a)")
    op = heat_step_op(dt=0.1)
    n = 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"u": torch.randn((n, n), generator=gen, device="cuda")}
    res = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                         periodic=True, calls=2, repeats=2)
    assert res.best["k"] in (2, 4)
    assert res.per_step_s > 0
    out = res.fn({"u": state["u"]})
    assert bool(torch.isfinite(out["u"]).all())


def test_cache_key_scopes_candidates_and_kwargs(tune_cache):
    """A winner tuned under one configuration is not served for another:
    candidate sets and builder kwargs are part of the key."""
    op = heat_step_op(dt=0.1)
    state = _state()
    autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                   periodic=True, timer=fake_timer_table({2: 2e-3, 4: 1e-3}))

    seen = []

    def spy_timer(chain_fn, st, k, c, r, vjp):
        seen.append(k)
        return {2: 2e-3, 4: 1e-3, 8: 5e-4}[k]

    # wider candidate set -> cache miss, re-measures, finds better k
    res = autotune_chain(op, {"u": "u_next"}, state,
                         k_candidates=(2, 4, 8), periodic=True,
                         timer=spy_timer)
    assert not res.cached and res.best["k"] == 8 and seen == [2, 4, 8]
    # different builder kwargs -> separate entry
    seen.clear()
    res2 = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4),
                          periodic=True, fused_bwd=True, timer=spy_timer)
    assert not res2.cached and seen == [2, 4]


# ---- stage-chain autotuning ------------------------------------------------

def test_stage_chain_picks_fastest_and_caches(tune_cache):
    """autotune_stage_chain sweeps fused_stage_chain configurations (a
    BC'd chain with kernel 13's fused backward) and persists the winner
    keyed by stages + boundary + direction."""
    op = heat_step_op(dt=0.1)
    state = _state()

    def timer(chain_fn, st, k, calls, repeats, grad):
        assert grad is True
        return {1: 2e-3, 2: 1e-3}[k]

    res = autotune_stage_chain(
        [(op, {"u": "u_next"})], state, k_candidates=(1, 2),
        fused_bwd=True, boundary={"u": "neumann"}, timer=timer)
    assert res.best == {"k": 2, "form": None} and not res.cached

    # the returned fn is the BC'd fused-bwd chain: differentiable
    u = state["u"].clone().requires_grad_()
    (g,) = torch.autograd.grad((res.fn({"u": u})["u"] ** 2).sum(), u)
    assert bool(torch.isfinite(g).all())

    def never(*a):
        raise AssertionError("re-measured")

    # cache hit: no re-measurement
    res2 = autotune_stage_chain(
        [(op, {"u": "u_next"})], state, k_candidates=(1, 2),
        fused_bwd=True, boundary={"u": "neumann"}, timer=never)
    assert res2.cached and res2.best["k"] == 2

    # a different boundary spec is a different key -> re-measures
    res3 = autotune_stage_chain(
        [(op, {"u": "u_next"})], state, k_candidates=(1, 2),
        fused_bwd=True, boundary={"u": ("dirichlet", 0.0)}, timer=timer)
    assert not res3.cached


def test_stage_chain_default_timer_runs_on_cpu(tune_cache):
    """The real _stage_timer path runs on the plain versions."""
    op = heat_step_op(dt=0.1)
    res = autotune_stage_chain(
        [(op, {"u": "u_next"})], _state(16), k_candidates=(1,),
        fused_bwd=False, periodic=True, calls=1, repeats=1)
    assert res.per_step_s > 0


def test_stage_chain_real_timer_with_bool_mask_and_dtype(tune_cache):
    """The real _stage_timer handles state entries the chain does not
    round-trip in dtype — a bool obstacle mask with masked_dirichlet, and
    a dtype= override."""
    op = heat_step_op(dt=0.1, dtype="float64")
    n = 16
    mask = torch.zeros((n, n), dtype=torch.bool)
    mask[5:8, 5:8] = True
    state = {"u": _state(n)["u"].to(torch.float64), "m": mask,
             "val": torch.ones((n, n), dtype=torch.float64)}
    res = autotune_stage_chain(
        [(op, {"u": "u_next"})], state, k_candidates=(1,),
        fused_bwd=True, boundary={"u": ("masked_dirichlet", "m", "val")},
        calls=1, repeats=1)
    assert res.per_step_s > 0

    # dtype override over f32 state (forward timer path)
    res2 = autotune_stage_chain(
        [(heat_step_op(dt=0.1), {"u": "u_next"})], _state(n),
        k_candidates=(1,), periodic=True, dtype=torch.bfloat16, calls=1,
        repeats=1)
    assert res2.per_step_s > 0


# ---- measured-best default dispatch -----------------------------------------

def seq_timer(times):
    """Deterministic timer yielding ``times`` in sweep order (k-major,
    form-minor) — lets a test make a specific (k, form) win."""
    it = iter(times)
    return lambda *a: next(it)


def test_sweep_records_canonical_best(tune_cache):
    """A sweep persists a candidate-set-independent record (overall winner
    + best form per depth) that ``best_config``/``tuned_tile`` serve,
    partitioned by device."""
    op = _nl3d()
    state = _state3()
    autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2,),
                   form_candidates=("gather", "local"), vjp=True,
                   timer=seq_timer([2e-3, 1e-3]))
    sp, f64 = (8, 8, 8), torch.float64
    rec = at.best_config("chain", "vjp", op.op_name, sp, f64, False,
                         device="cpu")
    assert rec and rec["k"] == 2 and rec["form"] == "local"
    assert at.tuned_tile("chain", "vjp", op.op_name, sp, f64, False, 2,
                         device="cpu") == "local"
    # un-swept depth -> no form; a card's record stays separate
    assert at.tuned_tile("chain", "vjp", op.op_name, sp, f64, False, 4,
                         device="cpu") is None
    assert at.best_config("chain", "vjp", op.op_name, sp, f64, False,
                          device="NVIDIA H100 80GB HBM3") is None


def test_chain_builds_consult_tuned_tile(tune_cache, caplog):
    """End-to-end measured-best dispatch: after a sweep, a plain
    ``fused_chain_vjp`` build (``form=None``) takes the recorded form —
    store and consult keys agree — and equals the build that forces it;
    the forward chain, which takes no form, stays as it was."""
    from pystencils_autodiff_tpu_torch.ops.adjoint_chain import \
        fused_chain_vjp
    from pystencils_autodiff_tpu_torch.ops.time_chain import \
        fused_time_chain

    op = _nl3d()
    state = _state3()
    cots = {"u": torch.ones_like(state["u"])}
    ref_f = fused_time_chain(op, 2, {"u": "u_next"})(dict(state))
    ref_b = fused_chain_vjp(op, 2, {"u": "u_next"}, periodic=False,
                            form="local")(dict(state), dict(cots))

    autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2,),
                   form_candidates=("local",), vjp=True,
                   timer=seq_timer([1e-3]))
    with caplog.at_level(logging.INFO,
                         logger="pystencils_autodiff_tpu_torch.autotune"):
        out_f = fused_time_chain(op, 2, {"u": "u_next"})(dict(state))
        g = fused_chain_vjp(op, 2, {"u": "u_next"}, periodic=False)
        out_b = g(dict(state), dict(cots))
    hits = [r.getMessage() for r in caplog.records
            if "measured-best form" in r.getMessage()]
    assert len(hits) == 1 and g.form == "local", hits
    assert torch.equal(out_f["u"], ref_f["u"])
    assert torch.equal(out_b[0]["u"], ref_b[0]["u"])
    assert torch.equal(out_b[1]["u"], ref_b[1]["u"])


def test_stage_chain_builds_consult_tuned_tile(tune_cache, caplog):
    """The same for stage chains: after a fused-backward sweep, a plain
    ``fused_stage_chain(fused_bwd=True)`` build runs kernel 13's recorded
    form (here its plain version's)."""
    from pystencils_autodiff_tpu_torch.ops.stage_chain import \
        fused_stage_chain

    op = heat_step_op(dt=0.1, dtype="float64")
    state = {"u": _state(32)["u"].to(torch.float64)}
    stages = [(op, {"u": "u_next"})]

    def run(chain):
        u = state["u"].clone().requires_grad_()
        val = chain({"u": u})["u"]
        (g,) = torch.autograd.grad(val, u, torch.ones_like(val))
        return val.detach(), g

    ref_v, ref_g = run(fused_stage_chain(stages, 2, periodic=True,
                                         fused_bwd=True, form="local"))
    autotune_stage_chain(stages, state, k_candidates=(2,),
                         form_candidates=("local",), fused_bwd=True,
                         periodic=True, timer=seq_timer([1e-3]))
    with caplog.at_level(logging.INFO,
                         logger="pystencils_autodiff_tpu_torch.autotune"):
        out_v, out_g = run(fused_stage_chain(stages, 2, periodic=True,
                                             fused_bwd=True))
    hits = [r.getMessage() for r in caplog.records
            if "measured-best form" in r.getMessage()]
    assert hits, "the stage-chain build did not consult the tune cache"
    assert torch.equal(out_v, ref_v)
    assert torch.equal(out_g, ref_g)


def test_stage_chain_boundary_key_is_canonical(tune_cache):
    """Spec spellings that normalize identically share one cache entry."""
    op = heat_step_op(dt=0.1)
    state = _state()

    def timer(chain_fn, st, k, calls, repeats, grad):
        return 1e-3

    def never(*a):
        raise AssertionError("re-measured despite canonical key")

    autotune_stage_chain([(op, {"u": "u_next"})], state, k_candidates=(1,),
                         boundary={"u": "neumann"}, timer=timer)
    res = autotune_stage_chain([(op, {"u": "u_next"})], state,
                               k_candidates=(1,),
                               boundary={"u": [("neumann",)]}, timer=never)
    assert res.cached


# ---- budgeted sweeps ---------------------------------------------------------

def test_early_stop_skips_deeper_candidates(tune_cache, monkeypatch):
    """With the default timer and sweep='fast', candidates are ranked by
    the cheap timer; a depth >10% slower than the running best stops the
    sweep, and the winner alone is re-timed with the slope timer."""
    seen, finalized = [], []

    def fake_cheap(chain_fn, state, k, calls, repeats, vjp):
        seen.append(k)
        return {2: 1e-3, 4: 2e-3, 6: 5e-4, 8: 4e-4}[k]

    def fake_default(chain_fn, state, k, calls, repeats, vjp):
        finalized.append(k)
        return {2: 3e-3, 4: 2e-3, 6: 1.5e-3, 8: 5e-4}[k]

    monkeypatch.setattr(at, "_cheap_timer", fake_cheap)
    monkeypatch.setattr(at, "_default_timer", fake_default)
    op = heat_step_op(dt=0.1)
    res = autotune_chain(op, {"u": "u_next"}, _state(),
                         k_candidates=(2, 4, 6, 8), periodic=True)
    # k=4 is >10% over k=2 -> stop; 6 and 8 never built/measured
    assert seen == [2, 4]
    assert res.best["k"] == 2
    # winner re-timed; the cached per_step_s is the slope timer's value
    assert finalized == [2]
    assert res.per_step_s == 3e-3

    # sweep='full' measures everything with the slope timer directly
    seen.clear()
    finalized.clear()
    res2 = autotune_chain(op, {"u": "u_next"}, _state(),
                          k_candidates=(2, 4, 6, 8), periodic=True,
                          sweep="full", force=True)
    assert seen == [] and finalized == [2, 4, 6, 8]
    assert res2.best["k"] == 8


def test_injected_timer_always_sweeps_fully(tune_cache):
    """Deterministic injected timers (tests) are exempt from early stop."""
    op = heat_step_op(dt=0.1)
    res = autotune_chain(op, {"u": "u_next"}, _state(),
                         k_candidates=(2, 4, 8), periodic=True,
                         timer=fake_timer_table({2: 1e-3, 4: 9e-3,
                                                 8: 5e-4}))
    assert set(res.table) == {(2, None), (4, None), (8, None)}
    assert res.best["k"] == 8


def test_interrupted_sweep_resumes_from_partial(tune_cache):
    """Measured candidates are persisted at once: an interrupted sweep
    resumes instead of measuring everything again."""
    op = heat_step_op(dt=0.1)
    state = _state()

    def dies_at_8(chain_fn, st, k, calls, repeats, vjp):
        if k == 8:
            raise KeyboardInterrupt  # simulate the session dying
        return {2: 2e-3, 4: 1e-3}[k]

    with pytest.raises(KeyboardInterrupt):
        autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4, 8),
                       periodic=True, timer=dies_at_8)
    # partial record holds the two measured candidates
    partials = [v for kk, v in json.loads(tune_cache.read_text()).items()
                if kk.endswith("|partial")]
    assert partials and set(partials[0]) == {"2,None", "4,None"}

    seen = []

    def resume_timer(chain_fn, st, k, calls, repeats, vjp):
        seen.append(k)
        return 5e-4

    res = autotune_chain(op, {"u": "u_next"}, state, k_candidates=(2, 4, 8),
                         periodic=True, timer=resume_timer)
    assert seen == [8]  # only the unmeasured candidate re-ran
    assert res.best["k"] == 8
    # partial cleaned up, final record written
    reg = json.loads(tune_cache.read_text())
    assert not any(kk.endswith("|partial") for kk in reg)


def test_forward_builders_take_no_form(tune_cache):
    """The form axis applies to the fused adjoints only: a forward sweep
    with any other candidate than None raises before measuring."""
    with pytest.raises(ValueError, match="take no form"):
        autotune_chain(heat_step_op(dt=0.1), {"u": "u_next"}, _state(),
                       k_candidates=(2,), form_candidates=(None, "local"),
                       timer=fake_timer_table({2: 1e-3}))
    with pytest.raises(ValueError, match="take no form"):
        autotune_stage_chain([(heat_step_op(dt=0.1), {"u": "u_next"})],
                             _state(), k_candidates=(1,),
                             form_candidates=("gather",),
                             timer=fake_timer_table({1: 1e-3}))
