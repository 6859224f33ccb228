"""Lowering configuration and structured decision logging: the port of
``pystencils_autodiff_tpu/utils/config.py``.

A frozen ``LoweringConfig`` bundles the knobs ``AutoDiffOp.torch_function``
takes (``torch_function(config=...)``, as ``jax_function(config=...)``),
and ``log_lowering_decision`` records the port's route decisions — the
window tile (``cuda_kernel.window_tile``), the slab tile
(``row_tiled.slab_tile``), the forward chain's rung and design
(``time_chain.forward_route`` / ``forward_design``), kernel 12's rung
(``stage_chain.stage_route``), the fused adjoints' segments and form
(``adjoint_chain.fused_segments``, ``fused_stage_chain_vjp(...).route_for``)
and autotune cache hits — once per (program, shape), where each is
reckoned, not per call.  Enable it with ``PYSTENCILS_ADTPU_LOG=1`` or the
standard logging configuration (logger ``pystencils_autodiff_tpu_torch.
lowering``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

logger = logging.getLogger("pystencils_autodiff_tpu_torch.lowering")
if os.environ.get("PYSTENCILS_ADTPU_LOG"):
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)

__all__ = ["LoweringConfig", "log_lowering_decision"]


@dataclasses.dataclass(frozen=True)
class LoweringConfig:
    """Per-lowering knobs the port honours; ``None`` means auto-derive.

    - ``strategy``: the JAX package's names; ``"tiled"`` runs the slab
      kernel, any other the window kernel (``ops.make_cuda_stencil``);
    - ``tile_rows``: the slab kernel's rows of dim 0 a tile;
    - ``dtype``: a ``torch.dtype`` or its name; ``torch_function`` (and the
      chains' ``dtype=``) cast the inputs to it, so forward and backward
      compute in it;
    - ``full_domain``: the lowering's exact-VJP mode, for
      ``ops.make_stencil(program, full_domain=...)``; as in the JAX
      package, ``kwargs()`` leaves it out (the op picks each program's
      mode itself);
    - ``accumulate``: the wide-sum mode of the single step, ``"pairwise"``
      (the default) or ``"dd"``: every sum of 8 or more addends
      accumulates in extended precision and is rounded once — float32
      and bfloat16 programs sum in float64 on the card (the fields keep
      their storage), float64 programs in double-word pairs
      (``ops/common.py::_compile_dd_add``); the fused chains take
      pairwise programs only, as the JAX package's do.  Any other name
      raises ValueError (``ops/common.py::check_accumulate``; the JAX
      package treats every value but ``"dd"`` as pairwise).

    The JAX fields with no counterpart on the card are left out:
    ``lowering`` (the port has one lowering, the hand-written kernel on
    CUDA tensors and its plain version on CPU tensors, picked by the
    inputs' device), ``interpret`` (Pallas' interpret mode: the CPU
    tensors' plain version takes its place) and ``vmem_limit_bytes`` (a
    TPU scoped-VMEM budget: each kernel's host reckoning sizes its shared
    memory against the card's 227 KB a block)."""

    strategy: Optional[str] = None
    tile_rows: Optional[int] = None
    dtype: Optional[object] = None
    full_domain: bool = False
    accumulate: Optional[str] = None

    def __post_init__(self):
        from ..ops.common import check_accumulate

        check_accumulate(self.accumulate)

    def kwargs(self) -> dict:
        out = {}
        if self.strategy is not None:
            out["strategy"] = self.strategy
        if self.tile_rows is not None:
            out["tile_rows"] = self.tile_rows
        if self.dtype is not None:
            out["dtype"] = self.dtype
        if self.accumulate is not None:
            out["accumulate"] = self.accumulate
        return out


def log_lowering_decision(program_name: str, **facts) -> None:
    """Structured one-line record of a lowering decision."""
    if logger.isEnabledFor(logging.INFO):
        kv = " ".join(f"{k}={v}" for k, v in facts.items())
        logger.info("lowering %s: %s", program_name, kv)
