"""The port's ``utils`` (``pystencils_autodiff_tpu_torch.utils``): the
``LoweringConfig`` in ``torch_function`` against the JAX package's
``jax_function(lowering="jnp")`` in float64 (rtol 1e-10), the decision log,
``timed_region``, ``KernelStats``' bytes against the bytes ``chip_smoke.py``
counts for row 2, ``trace`` and the timers on the CPU."""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystencils_autodiff_tpu.utils as jutils
from torch_jax_twin import jax_twin

import pystencils_autodiff_tpu_torch.utils as utils
from pystencils_autodiff_tpu_torch.models import heat_step_op
from pystencils_autodiff_tpu_torch.ops import forward_program
from pystencils_autodiff_tpu_torch.ops.common import storage_shape
from pystencils_autodiff_tpu_torch.utils import (KernelStats, LoweringConfig,
                                                 ab_timed, fetch_timed,
                                                 roofline_gbps, slope_timed,
                                                 timed_region, trace)

RTOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_utils_names_are_the_jax_packages_but_the_relay_baseline():
    assert set(utils.__all__) == set(jutils.__all__) - {"rtt_baseline"}
    assert not hasattr(utils, "rtt_baseline")


def _kheat():
    return heat_step_op(dt=0.1, kappa_field=True, dtype="float64")


def _value_and_grads(f, arrays, cot, dtype=torch.float64):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    out = f(*ts)
    return out, torch.autograd.grad(out, ts, torch.tensor(cot, dtype=dtype))


@pytest.mark.parametrize("config", [
    LoweringConfig(),
    LoweringConfig(strategy="tiled", tile_rows=4),
    LoweringConfig(strategy="blocked", accumulate="pairwise"),
], ids=["default", "tiled", "blocked"])
def test_lowering_config_in_torch_function_matches_jax(config):
    """``torch_function(config=...)`` runs as the same keywords do, and its
    values and gradients equal the JAX package's jnp lowering."""
    op = _kheat()
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((20, 17)) for _ in op.forward_input_fields]
    cot = rng.standard_normal((20, 17))
    out, grads = _value_and_grads(op.torch_function(config=config), arrays,
                                  cot)
    kw_out, kw_grads = _value_and_grads(op.torch_function(**config.kwargs()),
                                        arrays, cot)
    assert torch.equal(out, kw_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, kw_grads))
    jf = jax_twin(op).jax_function(
        config=jutils.LoweringConfig(lowering="jnp"))
    jout, pull = jax.vjp(lambda *a: jf(*a), *[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=RTOL)
    for g, r in zip(grads, pull(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=RTOL * float(np.abs(r).max()))


def test_lowering_config_options():
    """Keywords override the config; ``dtype`` casts the inputs;
    ``accumulate`` is carried into the recipe (``"dd"`` from the config and
    as a keyword; a misspelt mode raises); ``kwargs()`` leaves
    ``full_domain`` out, as the JAX package's does; an unknown option
    raises."""
    op = _kheat()
    f = op.torch_function(config=LoweringConfig(strategy="tiled",
                                                tile_rows=4), tile_rows=8)
    assert f.entry.recipe["tile_rows"] == 8
    assert f.entry.recipe["strategy"] == "tiled"
    u = torch.randn((12, 11), dtype=torch.float32)
    out = op.torch_function(config=LoweringConfig(dtype="float64"))(u, u)
    ref = op.torch_function()(u.double(), u.double())
    assert out.dtype == torch.float64 and torch.equal(out, ref)
    assert LoweringConfig(accumulate="dd").kwargs() == {"accumulate": "dd"}
    for f in (op.torch_function(config=LoweringConfig(accumulate="dd")),
              op.torch_function(accumulate="dd")):
        assert f.entry.recipe["accumulate"] == "dd"
        assert f.forward_program.accumulate == "dd"
        assert all(p.accumulate == "dd" for p in f.entry.recipe["bwd"])
    assert op.torch_function().entry.recipe["accumulate"] == "pairwise"
    with pytest.raises(ValueError, match="accumulate"):
        LoweringConfig(accumulate="double")
    assert "full_domain" not in LoweringConfig(full_domain=True).kwargs()
    with pytest.raises(TypeError, match="unknown option"):
        op.torch_function(interpret=True)


def test_decision_log_once_per_shape(caplog):
    """A route decision is logged where it is reckoned, once per shape:
    kernel 13's segments (``route_for``) at two shapes, each asked twice."""
    from pystencils_autodiff_tpu_torch.ops.stage_adjoint import \
        fused_stage_chain_vjp

    g = fused_stage_chain_vjp([(heat_step_op(dt=0.1), {"u": "u_next"})], 2,
                              boundary={"u": "neumann"})
    with caplog.at_level(logging.INFO,
                         logger="pystencils_autodiff_tpu_torch.lowering"):
        for spatial in ((64, 48), (64, 48), (96, 80), (96, 80)):
            g.route_for(spatial, 4)
    recs = [r.getMessage() for r in caplog.records
            if r.name == "pystencils_autodiff_tpu_torch.lowering"]
    assert len(recs) == 2 and all("route=route_for" in m for m in recs)
    assert "(64, 48)" in recs[0] and "(96, 80)" in recs[1]


def test_decision_log_enabled_by_the_environment():
    script = ("import logging; from pystencils_autodiff_tpu_torch.utils "
              "import config; print(config.logger.isEnabledFor(logging.INFO))")
    env = dict(os.environ, PYSTENCILS_ADTPU_LOG="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "True", proc.stderr


def test_timed_region_reports_through_its_sink():
    lines = []
    with timed_region("step", sink=lines.append):
        torch.ones(8).sum()
    assert len(lines) == 1 and lines[0].startswith("[step] ")
    assert float(lines[0].split()[1].rstrip("s")) >= 0


def test_kernel_stats_bytes_match_chip_smokes_row_2():
    """The κ-heat forward at 8192² f32 (PERF.md row 2): KernelStats' least
    bytes equal the bytes ``chip_smoke.check_and_time`` counts (each input
    read once, each output written once)."""
    import chip_smoke

    prog = forward_program(heat_step_op(kappa_field=True))
    spatial = (8192, 8192)
    tensors = [torch.empty(storage_shape(f, spatial), dtype=torch.float32,
                           device="meta")
               for f in prog.input_fields + prog.output_fields]
    stats = KernelStats(prog, spatial, dtype_bytes=4)
    assert stats.min_bytes == chip_smoke._nbytes(tensors) == 3 * 4 * 8192 ** 2
    assert stats.flops_per_cell > 0
    rep = stats.report(1e-3, peak_gbps=1000.0)
    assert rep["gbps_effective"] == pytest.approx(3 * 4 * 8192 ** 2 / 1e-3
                                                  / 1e9)
    assert rep["fraction_of_peak"] == pytest.approx(rep["gbps_effective"]
                                                    / 1000.0)
    # without a peak: the measured copy rate of the device asked for
    assert stats.report(1e-3, device="cpu")["fraction_of_peak"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_timers_on_the_cpu(caplog):
    x = torch.ones(256, 256)

    def make(n):
        def f(a):
            for _ in range(n):
                a = a * 1.0001
            return a
        return f

    assert fetch_timed(make(4), x, repeats=2) > 0
    assert slope_timed(make, x, 2, 4, repeats=2) > 0
    with pytest.raises(RuntimeError, match="noise"):
        slope_timed(make, x, 1, 2, repeats=1, min_delta_s=10.0, max_calls=4,
                    on_noise="raise")
    with caplog.at_level(logging.WARNING):
        assert slope_timed(make, x, 1, 2, repeats=1, min_delta_s=10.0,
                           max_calls=4) > 0
    assert any("noise-limited" in r.getMessage() for r in caplog.records)
    res = ab_timed(make(1), make(8), x, repeats=5)
    assert res.t_a > 0 and res.t_b > 0 and res.spread >= 0
    assert res.delta == pytest.approx(res[2])
    rate = roofline_gbps("cpu")
    assert rate > 0 and roofline_gbps("cpu") == rate


@pytest.mark.parametrize("call", [
    lambda dev: utils.roofline_gbps(*dev),
    lambda dev: KernelStats(forward_program(heat_step_op(kappa_field=True)),
                            (64, 64)).report(1e-3, device=(dev or [None])[0]),
    lambda dev: utils.autotune._device_name(*dev),
], ids=["roofline_gbps", "KernelStats.report", "autotune._device_name"])
def test_no_quiet_cpu_fallback(call):
    """With no device named, the three utilities take the current card and
    raise where there is none; ``"cpu"`` asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is that card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(())
    assert call(("cpu",))
