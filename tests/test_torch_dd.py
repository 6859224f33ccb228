"""``accumulate="dd"`` in the port against the JAX package on the CPU.

* ``utils/dd.py`` against the JAX package's ``utils/dd.py`` in float32 and
  float64: the error-free transforms bit for bit, the composite functions
  within 2 ulp of the working type in hi + lo (bit for bit here: eager
  PyTorch and XLA on the CPU round the same operations).
* The op's dd value and gradient through ``torch_function(accumulate=
  "dd")`` (the plain version on CPU tensors) against ``jax_function(config=
  LoweringConfig(lowering="jnp", accumulate="dd"))``: aniso27 at 20³ in
  float32 held to ``tests/test_dd.py``'s bounds for the JAX package's
  (gradient within 2e-8 of max |g64| of the correctly rounded float64
  oracle and below pairwise; values within 1.3e-7·max |y64|) and to the
  JAX package's dd result within 2e-8·max |ref| elementwise; a 2D 9-point
  op bounded and periodic, its staged (TF_MAD) backward, and float64 (the
  JAX package's own pairs: within 1 ulp of max |ref|).  Pairwise ops come
  out as before.
* The modes around it: the chains refuse a dd program, the C printer
  ignores the mode, ``strategy="tiled"`` takes it where the JAX package's
  blocked route runs dd, ``export_op`` exports a dd op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd_ops import nine_point_op
from pystencils_autodiff_tpu.utils import LoweringConfig as JConfig
from pystencils_autodiff_tpu.utils import dd as jdd
from torch_jax_twin import jax_twin

from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                  heat_step_op)
from pystencils_autodiff_tpu_torch.ops import (backward_programs,
                                               forward_program,
                                               make_cuda_stencil)
from pystencils_autodiff_tpu_torch.ops.common import check_ported
from pystencils_autodiff_tpu_torch.utils import LoweringConfig
from pystencils_autodiff_tpu_torch.utils import dd as pdd

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _pair(rng, n, dt, scale):
    return ((rng.standard_normal(n) * scale).astype(dt),
            (rng.standard_normal(n) * scale * 1e-9).astype(dt))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_error_free_transforms_bit_equal(dtype):
    """two_sum and two_prod have one exact answer: the port's equals the
    JAX package's bit for bit, and hi + lo is the exact sum / product."""
    dt = DTYPES[dtype][0]
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(2000) * 1e4).astype(dt)
    b = (rng.standard_normal(2000) * 1e-3).astype(dt)
    for name in ("two_sum", "two_prod"):
        got = getattr(pdd, name)(torch.tensor(a), torch.tensor(b))
        ref = getattr(jdd, name)(jnp.asarray(a), jnp.asarray(b))
        for g, r in zip(got, ref):
            assert g.dtype == DTYPES[dtype][1]
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if dt is np.float32:
        s, e = pdd.two_sum(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(
            s.double().numpy() + e.double().numpy(),
            a.astype(np.float64) + b.astype(np.float64))
        p, e = pdd.two_prod(torch.tensor(a), torch.tensor(b))
        np.testing.assert_array_equal(
            p.double().numpy() + e.double().numpy(),
            a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_composites_match_jax_package(dtype):
    """dd, dd_add, dd_add_dd, dd_mul, dd_to, dd_sum and dd_dot within 2
    ulp of the working type in hi + lo of the JAX package's."""
    dt = DTYPES[dtype][0]
    rng = np.random.default_rng(1)
    p, q = _pair(rng, 500, dt, 10.0), _pair(rng, 500, dt, 0.1)
    x = (rng.standard_normal(500) * 3).astype(dt)
    tp = tuple(torch.tensor(v) for v in p)
    tq = tuple(torch.tensor(v) for v in q)
    jp = tuple(jnp.asarray(v) for v in p)
    jq = tuple(jnp.asarray(v) for v in q)
    cases = {
        "dd": (pdd.dd(torch.tensor(x)), jdd.dd(jnp.asarray(x))),
        "dd_add": (pdd.dd_add(tp, torch.tensor(x)),
                   jdd.dd_add(jp, jnp.asarray(x))),
        "dd_add_dd": (pdd.dd_add_dd(tp, tq), jdd.dd_add_dd(jp, jq)),
        "dd_mul": (pdd.dd_mul(tp, tq), jdd.dd_mul(jp, jq)),
        "dd_sum": (pdd.dd_sum(torch.tensor(x.reshape(20, 25)), axis=0),
                   jdd.dd_sum(jnp.asarray(x.reshape(20, 25)), axis=0)),
        "dd_sum_all": (pdd.dd_sum(torch.tensor(x)), jdd.dd_sum(
            jnp.asarray(x))),
        "dd_dot": (pdd.dd_dot(torch.tensor(x), torch.tensor(p[0])),
                   jdd.dd_dot(jnp.asarray(x), jnp.asarray(p[0]))),
    }
    for name, (got, ref) in cases.items():
        g = got[0].double().numpy() + got[1].double().numpy()
        r = np.asarray(ref[0], np.float64) + np.asarray(ref[1], np.float64)
        ulp = np.spacing(np.abs(np.asarray(ref[0]))).astype(np.float64)
        assert np.all(np.abs(g - r) <= 2 * ulp), name
    assert float(pdd.dd_to(pdd.dd_mul(pdd.dd(torch.tensor(1.0 / 3.0)),
                                      pdd.dd(torch.tensor(3.0))))) == 1.0


def test_dd_sum_beats_float32_by_orders():
    """The JAX package's ``test_dd_sum_beats_f32_by_orders`` on the port's
    module: float64-grade sums in float32 pairs."""
    rng = np.random.default_rng(2)
    vals = (rng.standard_normal(10_000)
            * np.logspace(0, 4, 10_000)).astype(np.float32)
    truth = vals.astype(np.float64).sum()
    naive = float(torch.tensor(vals).sum())
    hi, lo = pdd.dd_sum(torch.tensor(vals))
    comp = float(hi.double() + lo.double())
    assert abs(comp - truth) < 1e-3 * max(abs(naive - truth), 1e-30)
    assert abs(comp - truth) / abs(truth) < 1e-12


def _value_and_grad_port(f, u, w):
    t = torch.tensor(u, requires_grad=True)
    y = f(t)
    (g,) = torch.autograd.grad((y * torch.tensor(w)).sum(), t)
    return y.detach().numpy().astype(np.float64), g.numpy().astype(
        np.float64)


def _value_and_grad_jax(f, u, w):
    y = f(u=jnp.asarray(u))
    g = jax.grad(lambda a: jnp.sum(f(u=a) * jnp.asarray(w)))(jnp.asarray(u))
    return np.asarray(y, np.float64), np.asarray(g, np.float64)


def _near_tie(rhs, u, cell, rel=2.0 ** -45) -> bool:
    """Whether the exact value of ``rhs`` (a sum of constant·read, the
    constants' float64 values) at ``cell`` of ``u`` lies within ``rel``
    (relative) of a midpoint between two float32 numbers."""
    from fractions import Fraction

    exact = Fraction(0)
    for term in rhs.args:
        c, acc = term.as_coeff_Mul()
        at = tuple(i + int(o) for i, o in zip(cell, acc.offsets))
        exact += Fraction(float(c)) * Fraction(float(u[at]))
    f = np.float32(float(exact))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    mids = [(Fraction(float(a)) + Fraction(float(b))) / 2
            for a, b in zip(near, near[1:])]
    return min(abs(exact - m) for m in mids) <= rel * abs(exact)


def test_aniso27_float32_meets_the_jax_bounds():
    """``tests/test_dd.py::test_dd_accumulate_in_kernels`` on the port: the
    float32 dd gradient within 2e-8 of max |g64| of the correctly rounded
    float64 oracle and below pairwise, the values within 1.3e-7·max |y64|
    (and below pairwise); both within 2e-8·max |ref| of the JAX package's
    dd result elementwise, but for values at a near tie (``_near_tie``),
    where they are one ulp apart; ``accumulate=`` and ``config=`` give the
    same; pairwise comes out as before."""
    op32, op64 = (anisotropic27_op(dtype="float32"),
                  anisotropic27_op(dtype="float64"))
    n = 20
    rng = np.random.default_rng(7)
    u = rng.standard_normal((n, n, n)).astype(np.float32)
    w = rng.standard_normal((n, n, n)).astype(np.float32)
    y64, g64 = _value_and_grad_port(op64.torch_function(),
                                    u.astype(np.float64),
                                    w.astype(np.float64))
    y32, g32 = _value_and_grad_port(op32.torch_function(), u, w)
    ydd, gdd = _value_and_grad_port(op32.torch_function(accumulate="dd"),
                                    u, w)
    ycf, gcf = _value_and_grad_port(op32.torch_function(
        config=LoweringConfig(accumulate="dd")), u, w)
    np.testing.assert_array_equal(ydd, ycf)
    np.testing.assert_array_equal(gdd, gcf)
    ypw, gpw = _value_and_grad_port(
        op32.torch_function(accumulate="pairwise"), u, w)
    np.testing.assert_array_equal(ypw, y32)
    np.testing.assert_array_equal(gpw, g32)

    gq = g64.astype(np.float32).astype(np.float64)
    scale = np.abs(g64).max()
    err32 = np.abs(g32 - gq).max() / scale
    errdd = np.abs(gdd - gq).max() / scale
    assert errdd < 2e-8, errdd
    assert errdd < err32, (errdd, err32)
    yq = y64.astype(np.float32).astype(np.float64)
    vdd = np.abs(ydd - yq).max()
    assert vdd < np.abs(y64).max() * 1.3e-7
    assert np.abs(y32 - yq).max() > vdd

    jf = jax_twin(op32).jax_function(config=JConfig(lowering="jnp",
                                                    accumulate="dd"))
    jy, jg = _value_and_grad_jax(jf, u, w)
    assert np.abs(gdd - jg).max() <= 2e-8 * np.abs(jg).max()
    # values: every cell within 2e-8·max |ref| of the JAX package's but
    # those whose exact sum lies within 2^-45 of a float32 rounding
    # midpoint, which the port's float64 sum (53 bits) and the JAX
    # package's float32 pairs (about 48) may round either way: there the
    # two differ by one ulp
    far = np.abs(ydd - jy) > 2e-8 * np.abs(jy).max()
    rhs = forward_program(op32, "dd").steps[0].rhs
    for cell in np.argwhere(far):
        assert _near_tie(rhs, u, tuple(cell)), tuple(cell)
        assert abs(ydd[tuple(cell)] - jy[tuple(cell)]) <= np.spacing(
            np.float32(abs(jy[tuple(cell)])))
    assert far.sum() <= 2
    jp = jax_twin(op32).jax_function(lowering="jnp")
    jy32, jg32 = _value_and_grad_jax(jp, u, w)
    np.testing.assert_allclose(y32, jy32, rtol=0, atol=1e-6 * np.abs(
        jy32).max())
    np.testing.assert_allclose(g32, jg32, rtol=0, atol=1e-6 * np.abs(
        jg32).max())


def _nine_point_case(op, dtype, periodic, seed=3):
    dt = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    shape = (18, 23)
    xs = {f.name: (rng.standard_normal(shape) + (1.5 if f.name == "kappa"
                                                 else 0)).astype(dt)
          for f in op.forward_input_fields}
    cot = rng.standard_normal(shape).astype(dt)
    f = op.torch_function(periodic=periodic, accumulate="dd")
    ts = {n: torch.tensor(v, requires_grad=True) for n, v in xs.items()}
    y = f(**ts)
    grads = torch.autograd.grad((y * torch.tensor(cot)).sum(),
                                list(ts.values()))
    jf = jax_twin(op).jax_function(
        periodic=periodic, config=JConfig(lowering="jnp", accumulate="dd"))
    jy, pull = jax.vjp(lambda *a: jf(**dict(zip(xs, a))),
                       *[jnp.asarray(v) for v in xs.values()])
    jgs = pull(jnp.asarray(cot))
    pairs = [(y.detach().numpy(), np.asarray(jy))]
    pairs += [(g.numpy(), np.asarray(r)) for g, r in zip(grads, jgs)]
    return pairs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("diff_mode", ["transposed", "transposed-forward"])
def test_nine_point_matches_jax_package(diff_mode, periodic, dtype):
    """A 2D 9-point op with rational weights, a product chain and a square
    root, bounded and periodic, its backward single-pass and staged
    (TF_MAD): float64 within 1 ulp of max |ref| of the JAX package's dd
    result (both evaluate double-word pairs there); float32 within
    1e-7·max |ref|: the leaves (the square root, the backward's narrow
    steps) are evaluated in float32 as in pairwise mode, where XLA may
    contract ``k·k + 1`` into an fma and eager PyTorch does not, and a
    leaf one rounding apart moves the rounded sum by one ulp at most."""
    op = nine_point_op(diff_mode)
    if diff_mode == "transposed-forward":
        assert len(backward_programs(op, "dd")) == 2
    for got, ref in _nine_point_case(op, dtype, periodic):
        assert got.dtype == ref.dtype == DTYPES[dtype][0]
        scale = np.abs(ref).max()
        bound = (1e-7 * scale if dtype == "float32"
                 else np.spacing(scale))
        assert np.abs(got.astype(np.float64)
                      - ref.astype(np.float64)).max() <= bound


def test_aniso27_float64_matches_jax_pairs():
    """Float64 dd: double-word float64 pairs on both sides, within 1 ulp
    of max |ref| (bit for bit here)."""
    op = anisotropic27_op(dtype="float64")
    rng = np.random.default_rng(11)
    u = rng.standard_normal((12, 14, 16))
    w = rng.standard_normal((12, 14, 16))
    y, g = _value_and_grad_port(op.torch_function(accumulate="dd"), u, w)
    jf = jax_twin(op).jax_function(config=JConfig(lowering="jnp",
                                                  accumulate="dd"))
    jy, jg = _value_and_grad_jax(jf, u, w)
    for got, ref in ((y, jy), (g, jg)):
        assert np.abs(got - ref).max() <= np.spacing(np.abs(ref).max())


def test_programs_carry_the_mode():
    """The programs carry the mode; only wide sums change; a narrow op's
    dd program evaluates as its pairwise one; an unknown mode raises."""
    op = heat_step_op(kappa_field=True, dtype="float64")
    rng = np.random.default_rng(5)
    u, k = (torch.tensor(rng.standard_normal((9, 11))) for _ in range(2))
    assert torch.equal(op.torch_function(accumulate="dd")(u, k),
                       op.torch_function()(u, k))
    prog = forward_program(anisotropic27_op(), "dd")
    assert prog.accumulate == "dd"
    assert forward_program(anisotropic27_op()).accumulate == "pairwise"
    with pytest.raises(ValueError, match="accumulate"):
        forward_program(op, "kahan")
    with pytest.raises(ValueError, match="accumulate"):
        op.torch_function(accumulate="kahan")


@pytest.mark.parametrize("form", ["window", "slab"])
def test_dd_sources_build_without_contraction(form):
    """A dd program's CUDA source asks nvcc for ``--fmad=false`` (its
    leaves then round where the plain version's do); a pairwise one asks
    for no flag."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.codegen.nvcc import source_flags

    for acc, want in (("dd", ["--fmad=false"]), ("pairwise", [])):
        prog = forward_program(anisotropic27_op(), acc)
        src = generate_cuda_source(prog, "float32", "interior", form, (2, 2))
        assert source_flags(src) == want


def test_chains_refuse_and_the_c_printer_ignores_dd():
    """A fused chain takes pairwise programs only, as the JAX package's do
    (ValueError naming dd a single-step mode); the C printer prints a dd
    program as its pairwise one (the JAX package's has no such mode)."""
    from pystencils_autodiff_tpu_torch.codegen.c_printer import \
        generate_c_source

    op = anisotropic27_op(dtype="float64")
    dd, pw = forward_program(op, "dd"), forward_program(op)
    with pytest.raises(ValueError, match="single-step mode"):
        check_ported(dd)
    check_ported(pw)
    assert (generate_c_source(dd, full_domain=False)
            == generate_c_source(pw, full_domain=False))


def test_tiled_takes_dd_where_the_blocked_route_does():
    """``strategy="tiled"`` with a dd program builds the slab wrapper in 2D
    and 3D, forward and backward, and refuses the one case the JAX
    package's blocked route does not take: a full-domain primal-only
    program in 3 dims."""
    op3, op2 = anisotropic27_op(), nine_point_op()
    for prog, kw in ((forward_program(op3, "dd"), {}),
                     (backward_programs(op3, "dd")[0],
                      {"full_domain": True}),
                     (forward_program(op2, "dd"), {}),
                     (forward_program(op2, "dd"), {"full_domain": True})):
        assert make_cuda_stencil(prog, strategy="tiled", **kw).form == "slab"
    with pytest.raises(ValueError, match="blocked dd kernel"):
        make_cuda_stencil(forward_program(op3, "dd"), strategy="tiled",
                          full_domain=True)
    # the same program through the window kernel
    assert make_cuda_stencil(forward_program(op3, "dd"),
                             full_domain=True).form == "window"


def test_export_op_of_a_dd_op():
    """``export_op`` of a dd op (CPU tensors: the plain version traced)
    gives the eager dd op's value and gradient."""
    from pystencils_autodiff_tpu_torch.serving import export_op

    op = nine_point_op()
    rng = np.random.default_rng(9)
    u = torch.tensor(rng.standard_normal((10, 12)).astype(np.float32))
    k = torch.tensor(1.5 + rng.standard_normal((10, 12)).astype(np.float32))
    cot = torch.tensor(rng.standard_normal((10, 12)).astype(np.float32))
    ex = export_op(op, (10, 12), device="cpu", accumulate="dd")
    f = op.torch_function(accumulate="dd")
    assert torch.equal(ex(u, k), f(u, k))
    tu, tk = u.clone().requires_grad_(), k.clone().requires_grad_()
    want = torch.autograd.grad((f(tu, tk) * cot).sum(), (tu, tk))
    got = ex.vjp.module()(u, k, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
