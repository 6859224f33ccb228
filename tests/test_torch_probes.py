"""The probes' plain versions (``utils/probes.py``) on the CPU: the FMA chain
and the slice rungs against jnp transcriptions of the Pallas bodies they
replace (``benchmarks/round3_tpu.py:58-63``, ``round4_tpu.py:58-63`` and
``:93-127``) in float32, rtol 1e-6 (unfused mul + add on both sides); the
shuffle rungs against their own definitions; the two rungs of
``accumulate="dd"`` against float64 arithmetic and the JAX package's
``utils/dd.py``.  The kernels are held against these on the card
(``test_torch_probes_card.py``)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pystencils_autodiff_tpu.utils import dd as jdd

from pystencils_autodiff_tpu_torch.utils import probes

A = 1.0000001
ROWS, COLS, REPS = 64, 96, 32


def _jnp_ladder(per_rep, x, rows):
    """``_ladder_kernel``'s body (round4_tpu.py:58-63) on the CPU."""
    acc = x[:rows]
    for i in range(REPS):
        acc = per_rep(acc, x, i)
    return np.asarray(acc)


def _input():
    return probes.ladder_input(ROWS, COLS, torch.float32, "cpu", seed=4)


def test_fma_chain_matches_the_pallas_body():
    """``sec_vpu``'s kernel (round3_tpu.py:58-63): 256 chained x·a + b in
    float32 on ones of (2048, 512), and on random values."""
    got = probes.fma_rate(torch.float32, device="cpu")
    assert got.shape == (2048, 512) and got.dtype == torch.float32

    def body(x):
        a, b = jnp.float32(1.0000001), jnp.float32(1e-7)
        for _ in range(256):
            x = x * a + b
        return np.asarray(x)

    np.testing.assert_allclose(got.numpy(), body(jnp.ones((2048, 512),
                                                          jnp.float32)),
                               rtol=1e-6)
    x = _input()[:ROWS]
    np.testing.assert_allclose(probes.fma_rate(x=x, reps=256).numpy(),
                               body(jnp.asarray(x.numpy())), rtol=1e-6)
    x64 = probes.fma_rate(torch.float64, rows=8, cols=32, reps=5,
                          device="cpu")
    assert x64.dtype == torch.float64
    want = 1.0
    for _ in range(5):
        want = want * A + 1e-7
    assert torch.equal(x64, torch.full((8, 32), want, dtype=torch.float64))
    assert probes.LAUNCHES == 0


def _round32(q):
    """The float32 nearest the rational ``q``, ties to even."""
    c = np.float32(float(q))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - q),
                                    int(np.array(v).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """``fma32`` (the fused plain versions' float32 fma) is x·a + b
    rounded once, against exact rationals: random operands over a wide
    range of exponents, and products that are float32 midpoints
    (24929 · 673·2^-28 = 2^-4 + 2^-28) with an addend far below the
    float64 product's last bit, where rounding the float64 sum to float32
    would round twice and land on the even side."""
    rng = np.random.default_rng(11)
    n = 400
    x, a, b = (rng.standard_normal(n) * 2.0 ** rng.integers(lo, 20, n)
               for lo in (-20, -20, -60))
    x, a, b = x.astype(np.float32), a.astype(np.float32), b.astype(np.float32)
    x[:4], a[:4] = 24929, np.float32(673 * 2.0 ** -28)
    b[:4] = [2.0 ** -80, -2.0 ** -80, 0.0, 2.0 ** -60]
    got = probes.fma32(torch.from_numpy(x), torch.from_numpy(a),
                       torch.from_numpy(b)).numpy()
    want = [_round32(Fraction(float(p)) * Fraction(float(q))
                     + Fraction(float(r))) for p, q, r in zip(x, a, b)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert got[0] > got[1] == got[2] == np.float32(2.0 ** -4)
    twice = (x.astype(np.float64) * a + b.astype(np.float64)).astype(
        np.float32)
    assert twice[0] != want[0]
    with pytest.raises(ValueError, match="float32"):
        probes.fma32(torch.ones(2, dtype=torch.float64), A, 1e-7)
    # the fused plain versions chain it
    xt = _input()
    want = xt[:ROWS]
    for _ in range(5):
        want = probes.fma32(want, A, 1e-7)
    assert torch.equal(probes.plain_fma_rate(xt[:ROWS], 5, fused=True), want)
    assert torch.equal(probes.plain_ladder("fma", xt, 5, fused=True), want)


SLICE_BODIES = {
    "fma": lambda acc, x, i: acc * A + 1e-7,
    "smem_odd": lambda acc, x, i: acc * A + x[1 + i % 7:1 + i % 7 + ROWS],
    "smem_row": lambda acc, x, i: acc * A + x[8 * (i % 2):8 * (i % 2)
                                              + ROWS],
}


@pytest.mark.parametrize("rung", sorted(SLICE_BODIES))
def test_slice_rungs_match_the_pallas_bodies(rung):
    """The baseline, the misaligned and the aligned slice of ``sec_prims``
    (round4_tpu.py:93-114)."""
    x = _input()
    got = probes.op_ladder([rung], reps=REPS, x=x)[rung]
    ref = _jnp_ladder(SLICE_BODIES[rung], jnp.asarray(x.numpy()), ROWS)
    assert got.shape == (ROWS, COLS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


def _roll32(a, s):
    """Each row's columns rolled by ``s`` inside each group of 32."""
    out = np.empty_like(a)
    for g in range(a.shape[1] // 32):
        blk = a[:, 32 * g:32 * g + 32]
        out[:, 32 * g:32 * g + 32] = blk[:, (np.arange(32) - s) % 32]
    return out


@pytest.mark.parametrize("rung", ["lane_shuffle", "masked_shuffle"])
def test_shuffle_rungs_match_their_definitions(rung):
    """out[c] = acc[c − s] inside each group of 32 columns (s = 1 + i%2),
    times a; the masked rung zeroes the last column first."""
    x = _input()
    got = probes.op_ladder([rung], reps=REPS, x=x)[rung]
    acc = x[:ROWS].numpy()
    for i in range(REPS):
        r = _roll32(acc, 1 + i % 2)
        if rung == "masked_shuffle":
            r[:, -1] = 0
        acc = r * np.float32(A)
    np.testing.assert_array_equal(got.numpy(), acc)


def test_dd_rungs():
    """``convert``: x → float64, ·a + b, → float32 each rep; ``fma_f64``:
    the baseline in float64; ``dd_addend``: acc·a + b on double-word
    float64 pairs, as the JAX package's ``dd_mul`` and ``dd_add_dd``
    compute it (bit for bit)."""
    x = _input()
    out = probes.op_ladder(["convert", "fma_f64", "dd_addend"], reps=REPS,
                           x=x)
    acc = x[:ROWS].numpy()
    for _ in range(REPS):
        acc = (acc.astype(np.float64) * A + 1e-7).astype(np.float32)
    np.testing.assert_array_equal(out["convert"].numpy(), acc)
    acc = x[:ROWS].double().numpy()
    for _ in range(REPS):
        acc = acc * A + 1e-7
    np.testing.assert_array_equal(out["fma_f64"].numpy(), acc)
    hi = jnp.asarray(x[:ROWS].double().numpy())
    pair = (hi, jnp.zeros_like(hi))
    for _ in range(REPS):
        pair = jdd.dd_add_dd(jdd.dd_mul((jnp.float64(A), jnp.float64(0.0)),
                                        pair),
                             (jnp.float64(1e-7), jnp.float64(0.0)))
    np.testing.assert_array_equal(out["dd_addend"].numpy(),
                                  np.asarray(pair[0] + pair[1]))
    assert out["dd_addend"].dtype == torch.float64


def test_ladder_types_and_timers_on_the_cpu():
    """Each rung's float type; an unknown rung raises; the timers run on
    CPU tensors (``slope_timed`` there: no noise floor)."""
    out = probes.op_ladder(reps=3, x=_input(), dtype=torch.float64)
    want = {r: (t or torch.float64) for r, (_, t) in probes.RUNGS.items()}
    assert {r: o.dtype for r, o in out.items()} == want
    with pytest.raises(ValueError, match="unknown rung"):
        probes.op_ladder(["sublane_rotate"], x=_input())
    assert probes.fma_flops(rows=64, cols=32, reps=4, device="cpu",
                            calls=1) > 0
    ps = probes.ladder_ps(["smem_odd"], rows=ROWS, cols=COLS, reps=2,
                          device="cpu", calls=1)
    assert set(ps) == {"smem_odd"} and ps["smem_odd"]["ps"] > 0
    assert ps["smem_odd"]["dtype"] == "float32"
