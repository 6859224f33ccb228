"""The probes' kernels on the card (``csrc/probes.cu``), each held against
its plain version (``utils/probes.py``; those are held against the Pallas
bodies in ``test_torch_probes.py``), on random values, with their launch
counts.  Every test here needs a CUDA device and skips without one.

Tolerances: in float32 every kernel is held bit for bit, against the plain
version that rounds each x·a + b once as the kernel's fma does
(``fused=True``); the shuffle, convert and double-word rungs round where
the unfused plain version does.  In float64 the fma chain and the slice
rungs, fused on the card and unfused in the plain version, agree to a
rounding a rep (reps·eps relative), far below what one rep changes: the
chain moves a value by about 1e-7 of itself a rep, a slice rung by the
slice's value."""

import pytest
import torch

from pystencils_autodiff_tpu_torch.utils import probes

pytestmark = pytest.mark.cuda
EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_rate_matches_plain(dev, dtype):
    """The TPU's shape, and a ragged element count (a thread's last
    elements past the end); ones, as the TPU ran it, and random values."""
    fused = dtype == torch.float32
    for rows, cols, reps in ((2048, 512, 256), (7, 33, 50)):
        before = probes.LAUNCHES
        got = probes.fma_rate(dtype, rows, cols, reps, device=dev)
        torch.cuda.synchronize()
        assert probes.LAUNCHES == before + 1
        x = torch.ones((rows, cols), dtype=dtype, device=dev)
        ref = probes.plain_fma_rate(x, reps, fused=fused)
        x = probes.ladder_input(rows, cols, dtype, dev, seed=5)[:rows]
        pairs = [(got, ref), (probes.fma_rate(x=x, reps=reps),
                              probes.plain_fma_rate(x, reps, fused=fused))]
        for g, r in pairs:
            if fused:
                assert torch.equal(g, r)
            else:
                err = (g - r).abs().max().item()
                assert err <= reps * EPS[dtype] * r.abs().max().item(), err
    assert probes.fma_flops(dtype, device=dev) > 0


EXACT = ("lane_shuffle", "masked_shuffle", "convert", "dd_addend")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rung", sorted(probes.RUNGS))
def test_ladder_rung_matches_plain(dev, rung, dtype):
    """40 reps (two unrolled blocks of 14 and a tail of 12) on a 256 × 128
    tile grid: each rung one launch, held against its plain version."""
    reps = 40
    x = probes.ladder_input(256, 128, torch.float64, dev, seed=2)
    before = probes.LAUNCHES
    got = probes.op_ladder([rung], reps=reps, dtype=dtype, x=x)[rung]
    torch.cuda.synchronize()
    assert probes.LAUNCHES == before + 1
    xt = x.to(got.dtype)
    fused = got.dtype == torch.float32
    ref = probes.plain_ladder(rung, xt, reps, fused=fused)
    assert got.shape == (256, 128) and got.dtype == ref.dtype
    if rung in EXACT or fused:
        assert torch.equal(got, ref)
    else:
        err = (got - ref).abs().max().item()
        assert err <= 2 * reps * EPS[got.dtype] * ref.abs().max().item(), err


def test_slice_rungs_read_shared_memory_every_rep(dev):
    """The slice rungs' SASS loads from shared memory inside the rep loop
    (at least 14 reps × 8 rows in the unrolled block), no other rung
    loads from it at all."""
    loads = probes.ladder_loads()
    assert set(loads) == {r for r, (_, t) in probes.RUNGS.items()
                          if t in (None, torch.float32)}
    for rung, n in loads.items():
        if rung in ("smem_row", "smem_odd"):
            assert n >= 14 * 8, (rung, n)
        else:
            assert n == 0, (rung, n)


def test_ladder_shapes_and_timing(dev):
    """Rows not a multiple of 64 or columns not of 32 raise; the timer
    gives every asked rung a positive time less the baseline's."""
    with pytest.raises(ValueError, match="multiple"):
        probes.op_ladder(["fma"], x=probes.ladder_input(100, 64, device=dev))
    ps = probes.ladder_ps(["lane_shuffle", "convert"], reps=256, device=dev)
    assert set(ps) == {"lane_shuffle", "convert"}
    assert all(r["ps"] > 0 for r in ps.values())
