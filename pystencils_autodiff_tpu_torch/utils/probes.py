"""The card's probes: the FMA rate and the op ladder, the port of the JAX
package's two TPU probe kernels.

* ``fma_rate`` replaces ``benchmarks/round3_tpu.py::sec_vpu``'s
  ``pallas_call``: 256 chained ``x·a + b`` per element (a = 1.0000001,
  b = 1e-7) of a (2048, 512) array held on chip; ``fma_flops`` times it
  and reports FLOP/s as 2·reps·rows·cols/t.
* ``op_ladder`` replaces ``benchmarks/round4_tpu.py::_ladder_kernel``: one
  kernel per rung, each running ``acc = rung(acc, x, i)`` ``reps`` times on
  a tile held on chip; ``ladder_ps`` reports picoseconds per element per
  rep, raw and less the float32 FMA baseline, as ``sec_prims`` did.

Both kernels live in ``csrc/probes.cu`` (its note gives each rung's
instructions and what bounds it), built by ``codegen/nvcc.py`` into the
build directory at first use.  On a CUDA tensor a probe launches its kernel
or raises; on a CPU tensor it runs its plain version, which repeats the
arithmetic with PyTorch operators — unfused (``x*a + b``, where the kernel
fuses an fma), so the two agree to a rounding a rep; with ``fused=True``
the float32 versions round each ``x·a + b`` once, as the card's fma does
(``fma32``), and agree with the kernels bit for bit.  ``LAUNCHES`` counts
kernel launches.  A probe measures: nothing in the port reads its numbers
to pick a route, and the bounds a run states stay the card's published
peaks.

The rungs (``RUNGS``; each with the float type it runs in, ``dtype`` for
the first five):

=================  ==========================================================
``fma``            acc = fma(acc, a, b): the baseline
``lane_shuffle``   a warp shuffle by 1 + i%2 lanes, then ·a: the TPU's lane
                   rotate (``pltpu.roll`` on axis 1), here a roll inside
                   each group of 32 columns; the warp march's lateral read
``smem_row``       acc·a + x[r + 8(i%2)] from shared memory: the aligned
                   slice and the ×8 sublane rotate
``smem_odd``       acc·a + x[r + 1 + i%7] from shared memory, an element
                   offset of 1 … 7: the misaligned slice
``masked_shuffle`` the shuffle, 0 in the last column, then ·a: the masked
                   lane rotate (every window kernel's edge)
``fma_f64``        the fma rung in float64
``convert``        float32 → float64, ·a + b in float64, rounded back: one
                   addend of an ``accumulate="dd"`` float32 body
``dd_addend``      acc = acc·a + b on double-word float64 pairs (TwoProd and
                   TwoSums, ``utils/dd.py``; ``csrc/dd.cuh`` on the card):
                   one addend of an ``accumulate="dd"`` float64 body
=================  ==========================================================

The TPU's single-sublane rotate has no rung: on the card moving a value to
another row that a thread holds is a rename of registers and costs no
instruction.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from ..ops.launch import Ptrs, run

__all__ = ["RUNGS", "LAUNCHES", "reset_launch_counts", "fma_rate",
           "fma_flops", "op_ladder", "ladder_ps", "plain_fma_rate",
           "plain_ladder", "ladder_input", "ladder_loads", "fma32",
           "REPLACES"]

LAUNCHES = 0
REPLACES = {"fma_rate": "benchmarks/round3_tpu.py:52",
            "op_ladder": "benchmarks/round4_tpu.py:53"}
A, B = 1.0000001, 1e-7  # round3_tpu.py:58-63, round4_tpu.py:87-91
PAD = 8  # rows below the tile the slice rungs read (round4_tpu.py:108-114)
LANES = 32  # the shuffle rungs roll inside groups of this many columns
LADDER_ROWS = 64  # a ladder block's rows (csrc/probes.cu: kRows)
# rung -> (kernel rung code, float type; None: the caller's dtype)
RUNGS = {"fma": (0, None), "lane_shuffle": (1, None), "smem_row": (2, None),
         "smem_odd": (3, None), "masked_shuffle": (4, None),
         "fma_f64": (0, torch.float64), "convert": (5, torch.float32),
         "dd_addend": (6, torch.float64)}
_CODES = {torch.float32: 0, torch.float64: 1}
_LIB = []


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES``, the probe kernels' launch counter."""
    global LAUNCHES
    LAUNCHES = 0


def _library():
    if not _LIB:
        from ..codegen.nvcc import compile_and_load

        _LIB.append(compile_and_load('#include "probes.cu"\n',
                                     "probe_kernels"))
    return _LIB[0]


def _launch(probe: int, rung: int, x: torch.Tensor, out: torch.Tensor,
            rows: int, cols: int, reps: int, what: str) -> None:
    global LAUNCHES
    if x.dtype not in _CODES or not x.is_contiguous():
        raise ValueError(f"{what}: takes a contiguous float32 or float64 "
                         f"tensor, got {x.dtype}")
    if run(_library(), [probe, _CODES[x.dtype], rung, rows, cols, reps],
           [Ptrs([(x, 0)]), Ptrs([(out, 0)])], x, what):
        LAUNCHES += 1


def _device(device, x):
    if x is not None:
        return x.device
    if device is None:
        from .benchmark import current_card

        return current_card()
    return torch.device(device)


def fma32(x: torch.Tensor, a, b) -> torch.Tensor:
    """fma(x, a, b) for float32 ``x`` and float32 ``a``, ``b`` (floats are
    rounded to float32, tensors cast), rounded once as the card's fma
    rounds it, for finite values: the float64 product of two float32
    values is exact; its sum with ``b`` is rounded to odd (where TwoSum's
    error is not 0 and the sum's last bit is even, the sum steps one
    float64 ulp towards the exact value), and a round-to-odd float64
    rounded to float32 is the correctly rounded result (53 ≥ 24 + 2 bits;
    Boldo and Melquiond 2008)."""
    from .dd import two_sum

    def wide(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).double()
        return torch.tensor(v, dtype=torch.float32).item()

    if x.dtype != torch.float32:
        raise ValueError(f"fma32 takes float32, got {x.dtype}")
    s, e = two_sum(x.double() * wide(a), wide(b))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.nextafter(s, torch.full_like(s, float("inf")).copysign(e))
    return torch.where((e != 0) & even, toward, s).float()


# -- the FMA rate ------------------------------------------------------------

def plain_fma_rate(x: torch.Tensor, reps: int,
                   fused: bool = False) -> torch.Tensor:
    """``reps`` chained ``x·a + b`` in ``x``'s type: unfused, or, with
    ``fused`` (float32 only), each rounded once (``fma32``)."""
    for _ in range(reps):
        x = fma32(x, A, B) if fused else x * A + B
    return x


def fma_rate(dtype=torch.float32, rows: int = 2048, cols: int = 512,
             reps: int = 256, x: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
    """``reps`` chained fma(x, a, b) per element of ``x`` (default: ones
    of ``(rows, cols)`` and ``dtype`` on ``device``, the current card
    where None), in float32 or float64: the output.  On the card each
    thread chains its elements in registers and writes once
    (``csrc/probes.cu::fma_chain``); on the CPU the plain version."""
    dev = _device(device, x)
    if x is None:
        x = torch.ones((rows, cols), dtype=dtype, device=dev)
    if x.device.type != "cuda":
        return plain_fma_rate(x, reps)
    out = torch.empty_like(x)
    _launch(0, 0, x, out, 1, x.numel(), reps, f"fma_rate({x.dtype}, {reps})")
    return out


def fma_flops(dtype=torch.float32, rows: int = 2048, cols: int = 512,
              reps: int = 256, device=None, calls: int = 8,
              x: Optional[torch.Tensor] = None) -> float:
    """FLOP/s of ``fma_rate`` (2·reps·rows·cols a call) on ``x`` (default:
    ones of ``(rows, cols)`` and ``dtype``) by the two-point slope of
    ``utils/benchmark.slope_timed`` over ``calls`` and 2·``calls``
    chained calls (each call's output the next one's input), as the JAX
    package timed its kernel (``round3_tpu.py:38-49``)."""
    from .benchmark import slope_timed

    if x is None:
        x = torch.ones((rows, cols), dtype=dtype,
                       device=_device(device, None))
    rows, cols = x.shape

    def chained(n):
        def f(y):
            for _ in range(n):
                y = fma_rate(x=y, reps=reps)
            return y
        return f

    t = slope_timed(chained, x, calls, 2 * calls)
    return 2.0 * reps * rows * cols / t


# -- the op ladder -------------------------------------------------------------

def ladder_input(rows: int = 2048, cols: int = 512, dtype=torch.float32,
                 device=None, seed: int = 0) -> torch.Tensor:
    """A ``(rows + 8, cols)`` input of the ladder: values in [0.25, 0.75)
    from ``seed`` (the TPU filled it with 0.5; distinct values let a test
    see every read's offset)."""
    g = torch.Generator().manual_seed(seed)
    x = 0.25 + 0.5 * torch.rand((rows + PAD, cols), generator=g,
                                dtype=torch.float64)
    return x.to(dtype=dtype, device=_device(device, None))


def _roll_lanes(acc: torch.Tensor, s: int) -> torch.Tensor:
    rows, cols = acc.shape
    return torch.roll(acc.reshape(rows, cols // LANES, LANES), s,
                      -1).reshape(rows, cols)


def _plain_rep(rung: str, acc, x, i: int, rows: int, fused: bool):
    def fma(b):
        return fma32(acc, A, b) if fused else acc * A + b

    if rung in ("fma", "fma_f64"):
        return fma(B)
    if rung in ("lane_shuffle", "masked_shuffle"):
        r = _roll_lanes(acc, 1 + i % 2)
        if rung == "masked_shuffle":
            col = torch.arange(acc.shape[1], device=acc.device)
            r = torch.where(col < acc.shape[1] - 1, r, torch.zeros_like(r))
        return r * A
    if rung == "smem_row":
        o = 8 * (i % 2)
        return fma(x[o:o + rows])
    if rung == "smem_odd":
        o = 1 + i % 7
        return fma(x[o:o + rows])
    if rung == "convert":
        return (acc.double() * A + B).float()
    from .dd import dd_add_dd, dd_mul

    return dd_add_dd(dd_mul((A, 0.0), acc), (B, 0.0))


def plain_ladder(rung: str, x: torch.Tensor, reps: int,
                 fused: bool = False) -> torch.Tensor:
    """The rung's plain version on ``x`` (``(rows + 8, cols)``, in the
    rung's float type): ``acc = x[:rows]``, then ``reps`` reps; with
    ``fused`` (float32 only) the fma and slice rungs round each
    ``acc·a + b`` once (``fma32``), as the kernel does."""
    rows = x.shape[0] - PAD
    acc = x[:rows]
    if rung == "dd_addend":
        acc = (acc, torch.zeros_like(acc))
    for i in range(reps):
        acc = _plain_rep(rung, acc, x, i, rows, fused)
    if rung == "dd_addend":
        acc = acc[0] + acc[1]
    return acc


def _rung_dtype(rung: str, dtype):
    if rung not in RUNGS:
        raise ValueError(f"unknown rung {rung!r}; one of {list(RUNGS)}")
    return RUNGS[rung][1] or dtype


def op_ladder(rungs: Iterable[str] = tuple(RUNGS), rows: int = 2048,
              cols: int = 512, reps: int = 32, dtype=torch.float32,
              device=None, x: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """Each rung's output (``rows × cols``): the rung run ``reps`` times
    on a tile of ``x`` (``ladder_input(rows, cols)`` where None; each rung
    takes it in its own float type).  On the card one launch a rung
    (``csrc/probes.cu::ladder``: rows a multiple of 64, cols of 32); on
    the CPU the plain versions."""
    dev = _device(device, x)
    if x is None:
        x = ladder_input(rows, cols, torch.float64, dev)
    rows, cols = x.shape[0] - PAD, x.shape[1]
    out = {}
    for rung in rungs:
        xt = x.to(_rung_dtype(rung, dtype)).contiguous()
        if dev.type != "cuda":
            out[rung] = plain_ladder(rung, xt, reps)
            continue
        if rows % LADDER_ROWS or cols % LANES:
            raise ValueError(f"op_ladder: rows ({rows}) must be a multiple "
                             f"of {LADDER_ROWS} and cols ({cols}) of "
                             f"{LANES}")
        o = torch.empty((rows, cols), dtype=xt.dtype, device=dev)
        _launch(1, RUNGS[rung][0], xt, o, rows, cols, reps,
                f"op_ladder({rung}, {xt.dtype}, {reps})")
        out[rung] = o
    return out


def ladder_ps(rungs: Iterable[str] = tuple(RUNGS), rows: int = 2048,
              cols: int = 512, reps: int = 32, dtype=torch.float32,
              device=None, calls: int = 8) -> Dict[str, dict]:
    """Per rung, picoseconds per element per rep (``"ps"``) and that less
    the FMA baseline's (``"ps_less_fma"``, as ``sec_prims`` reports them;
    the baseline is the ``"fma"`` rung in ``dtype``, timed whether asked
    for or not), each by the two-point slope of ``slope_timed`` over
    ``calls`` and 2·``calls`` chained calls: each call's output, with the
    input's last 8 rows below it, is the next call's input
    (``round4_tpu.py:74-78``)."""
    from .benchmark import slope_timed

    dev = _device(device, None)
    x64 = ladder_input(rows, cols, torch.float64, dev)
    rungs = list(rungs)
    order = ["fma"] + [r for r in rungs if r != "fma"]
    res = {}
    for rung in order:
        x = x64.to(_rung_dtype(rung, dtype))

        def chained(n, rung=rung):
            def f(y):
                for _ in range(n):
                    y = torch.cat([op_ladder([rung], reps=reps, dtype=y.dtype,
                                             x=y)[rung], y[-PAD:]])
                return y
            return f

        t = slope_timed(chained, x, calls, 2 * calls)
        res[rung] = {"ps": t / (rows * cols * reps) * 1e12,
                     "dtype": str(x.dtype).replace("torch.", "")}
    base = res["fma"]["ps"]
    for rung, r in res.items():
        r["ps_less_fma"] = r["ps"] - base
    return {r: res[r] for r in rungs}


def ladder_loads() -> Dict[str, int]:
    """Per rung of the float32 ladder, the shared-memory loads (``LDS``)
    in its kernel's SASS (``cuobjdump -sass`` of the probes' library, from
    the toolkit beside nvcc; builds the library where it is not built):
    the slice rungs load every rep — at least 14 reps × 8 rows in the
    unrolled block —, the other rungs never."""
    import re
    import subprocess
    from pathlib import Path

    from ..codegen.nvcc import find_nvcc

    tool = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", _library()._name],
                          capture_output=True, text=True, check=True).stdout
    names = {code: r for r, (code, t) in RUNGS.items()
             if t in (None, torch.float32)}
    out, rung = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"ladderILi(\d+)EfE", line)
            rung = names.get(int(m.group(1))) if m else None
            if rung:
                out[rung] = 0
        elif rung and re.search(r"\bLDS(\.\S+)?\s", line):
            out[rung] += 1
    return out
