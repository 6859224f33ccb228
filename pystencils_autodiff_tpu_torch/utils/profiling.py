"""Profiling helpers: the port of ``pystencils_autodiff_tpu/utils/profiling.py``
— ``torch.profiler`` traces, synchronised timed regions and roofline
accounting of a stencil program."""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
from typing import Optional

import torch

__all__ = ["trace", "timed_region", "KernelStats"]


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is there) and write its Chrome trace to
    ``<logdir>/trace.json`` (view with Perfetto or ``chrome://tracing``).
    ``logdir`` defaults to ``PYSTENCILS_ADTPU_TRACE_DIR``, else
    ``pystencils_adtpu_trace`` in the temporary directory.  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` sums the time by
    kernel)."""
    logdir = logdir or os.environ.get(
        "PYSTENCILS_ADTPU_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "pystencils_adtpu_trace"))
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed_region(name: str, sink=print):
    """Host clock around the block, printed through ``sink`` as
    ``[name] seconds``.  Where the process uses a card, the card is
    synchronised at both ends, so the time covers the device work the
    block enqueued (the JAX package's ``timed_region`` timed the dispatch
    only)."""
    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if card:
        torch.cuda.synchronize()
    sink(f"[{name}] {time.perf_counter() - t0:.4f}s")


class KernelStats:
    """Roofline accounting for a stencil program on given shapes: the least
    bytes (each input and output field read or written once, as the JAX
    package counts them) and the Add/Mul operations of its steps a cell."""

    def __init__(self, program, spatial_shape, dtype_bytes: int = 4):
        import sympy as sp

        self.program = program
        cells = math.prod(int(n) for n in spatial_shape)
        n_in = len(program.input_fields)
        n_out = len(program.output_fields)
        self.min_bytes = cells * dtype_bytes * (n_in + n_out)
        self.cells = cells
        # flops: count Add/Mul atoms in the step RHSs (rough)
        flops = 0
        for step in program.steps:
            flops += sum(1 for _ in sp.preorder_traversal(step.rhs)
                         if isinstance(_, (sp.Add, sp.Mul)))
        self.flops_per_cell = flops

    def report(self, seconds: float, peak_gbps: Optional[float] = None,
               device=None) -> dict:
        """Rates of a run that took ``seconds``; ``peak_gbps`` defaults to
        the measured copy rate of ``device`` (``benchmark.roofline_gbps``:
        default the current card, raising where there is none; ``"cpu"``
        for the CPU)."""
        if peak_gbps is None:
            from .benchmark import roofline_gbps
            peak_gbps = roofline_gbps(device)
        gbps = self.min_bytes / seconds / 1e9
        return {
            "seconds": seconds,
            "gcells_per_s": self.cells / seconds / 1e9,
            "gbps_effective": gbps,
            "fraction_of_peak": gbps / peak_gbps,
            "arithmetic_intensity": self.flops_per_cell
            * self.cells / max(self.min_bytes, 1),
        }
