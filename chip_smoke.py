#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pystencils_autodiff_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: card name and power limit, torch and CUDA versions.
2. Build every kernel library below with nvcc, all started together (one
   nvcc process per source), timed; each single step is one library per
   (program, float type, mode, form).
3. Kernel vs plain PyTorch version on the card, same inputs from a seeded
   ``torch.Generator``, each pair timed with CUDA events (4 runs back to
   back over the count, median of 3 such batches, after warm-up) beside a
   device copy of the bytes the kernel moves:
   - the single-step kernel (the window design, ``stencil_window``) in
     every mode (interior, full-domain exact VJP, periodic) at the main
     path's shapes, at 70000×64 (a leading extent above the 65535 a
     grid's y dimension holds) and on a ragged 8191×8190 grid, each timed
     in turns with the per-cell kernel (``form="cell"``, held against
     the plain version too) and, where one exists, the convolution;
   - row 6, the 2D forward chain, in the design its reckoning picks (the
     warp march, ``csrc/warp_chain.cuh``; its V, segments and the
     registers of every V printed) and every other 2D design that fits
     (the box of ``time_chain.cuh``, the dim-0 march's forward mode), held
     too and timed in turns: wave bounded k=4 with a probe row at 8192²
     f32 and 4096² f64, heat periodic k=8 at 8192² f32 and k=2 in bf16;
     the two-phase adjoint chain kernel (wave bounded k=4 with a probe at
     8192² f32 and 4096² f64);
   - row 7, the 3D forward chain, in the design its reckoning picks
     (``time_chain.forward_design``: the dim-0 march's forward mode, or
     for D3Q19 in f64 the z-streaming kernel's), held against its plain
     version beside its single steps, then every other design that fits
     (the march, the box of ``time_chain.cuh``, the streaming forward
     mode) held too and timed in turns with it: the variable-κ diffusion
     k=2 bounded and periodic at 384³ f32, bounded at 192³ f64 and in
     bf16 at 384³, the 3D heat step k=2 at 384³ f32, D3Q19 periodic k=2
     at 256³ f32 and 128³ f64 and k=4 at 256³ f32 (path C's k=4 forward),
     aniso27 k=2 periodic at 384³ f32 (config #4's), and nl3d with two
     probe lines at 384³ f32 (in the repairs);
   - the twin-with-accumulation kernel: 2D, the periodic wave k=4 without
     probes at 8192² f32; 3D, the variable-κ diffusion k=2 bounded and
     periodic and the bounded twin of the 3D heat step at 384³ f32;
   - rows 8, 10 and 11 (the 2D two-phase kernel, also on the multi-carrier
     op at k=2, the 2D periodic and the 3D twin-accum kernel) run the
     dim-0 march's two-phase mode: each is held against its plain
     version, beside its single steps, and the box design it replaced
     (``adjoint_chain.cuh``, ``twin_accum.cuh``: kernel B in 2D) is held
     too and timed in turns with it (march, box, box, march);
   - the stage chains, kernels 12 and 13 (see 4.);
   - the slab single step (``csrc/row_tiled.cuh``, ``strategy="tiled"``,
     the port of ``_run_row_tiled``) beside the per-cell kernel and, where
     one exists, conv2d on the same inputs, timed in turns (slab, cell,
     conv2d, slab, cell, conv2d): the κ-heat forward and backward at 8192²
     f32 (default chunk and ``tile_rows=16``) and 4096² f64, the
     constant-coefficient heat forward, a ragged 8191×8190 grid (8-byte
     copies), the variable-κ diffusion forward and backward at 384³ f32
     and 192³ f64, and bf16 storage (both kernels).
   Each case also times the same computation through single-step kernels
   and, where one PyTorch call computes the same function (a convolution
   for the constant-coefficient heat steps), that call; the least time the
   card could take (bytes at its memory rate or operations at its peak,
   whichever is larger) is computed from the case's shapes.
4. The main paths end to end, each with the launch counts reset just
   before it and read just after:
   - through ``AutoDiffOp.torch_function(strategy="tiled")``: the heat
     inverse problem at 8192² float32 (3 Adam steps; the loss must fall
     and every single-step launch is a slab launch, 8 an Adam step), one
     value+gradient of the 3D variable-κ diffusion at 384³, and the 16²
     float64 inverse problem against the CPU run (rtol 1e-12);
   - through ``AutoDiffOp.torch_function()``: the heat inverse problem at
     8192² float32 (4 unrolled steps, MSE against a target made with the
     true κ, 3 Adam steps on κ), one value+gradient of the 3D variable-κ
     diffusion at 384³, one periodic value+gradient of the 3D heat step at
     384³, and the 16² inverse problem (20 Adam steps, float64) against
     the same run of the plain version on the CPU;
   - through the fused chains: the FWI gradient (BASELINE config #3,
     ``fwi_gradient(fused_k=4)``) at 8192² float32, 32 steps, receiver row
     64, 3 gradient-descent steps on c (the misfit must fall); the twin-
     chain value+gradient of the periodic heat step, k=8, at 8192² float32
     (the JAX package's ``bench.py`` headline function); the gradient of
     a final-wavefield misfit with respect to c through the periodic wave
     chain (8192² float32, 16 steps, k=4: the 2D twin-with-accumulation
     kernel); and the 64² float64 FWI gradient against the same call on
     CPU tensors;
   - BASELINE config #2: 3D variable-κ diffusion with ∂/∂κ through
     ``fused_time_chain(diffusion3d_op(dt=0.05), 2, {"u": "u_next"},
     fused_bwd=True)`` at 384³ float32, 16 steps, an MSE loss of the final
     u against an observation made with the true κ, ``torch.autograd.grad``
     with respect to κ and 3 gradient-descent steps on κ (the loss must
     fall; each gradient launches the 3D forward chain — the march — and
     the 3D twin-accum kernel 16/2 times each, nothing else); and the same
     path at 24³ float64 against the CPU run of the plain versions.
   - BASELINE config #4: the elastic P-SV velocity/stress pair with a
     Cerjan sponge (width 40) on all five fields through
     ``fused_stage_chain(..., k=4, fused_bwd=True)`` at 8192² float32, 16
     cycles, the MSE of the final vx against an observation, its gradient
     with respect to the five initial fields and 2 line-searched descent
     steps (the loss must fall; each gradient launches kernel 12 and
     kernel 13 4 times each, nothing else: one launch of each a chain
     call, the march holding the full k=4); the same gradient at 96²
     float64 against the CPU run (rtol 1e-12); and ``anisotropic27_op()``
     value+gradient at 384³ float32 through the periodic twin chains, k=2,
     16 steps (24 launches of the 3D forward chain, the march);
   - the app-assembly layer (``app_phase``): config #4 recorded with
     ``GraphDataHandling((8190, 8190), ghost_layers=1)`` (a Cerjan sponge
     on the five fields from one profile, then the velocity and the stress
     sweep) and run through ``compile(fuse="stages", k=4,
     fused_bwd=True)``, 16 cycles from ``elastic_setup``'s start to its
     MSE loss (exactly 4 + 4 launches of kernels 12 and 13, loss and
     gradients equal to the direct chain's, the two timed in turns with
     the host clock); the same graph through ``compile()`` (replay: 64
     window-kernel launches a gradient, reckoned from the ops' backward
     programs) held against it; ``Simulation.fused_op()`` of the pair
     (one launch a cycle) against ``step_fn`` on ``[2:-2, 2:-2]``; and
     burgers2d at 8192² and laplacian3d at 384³ through
     ``AutoDiffKernelPair`` (forward and full-domain backward, each held
     against its plain version beside its copy and bound).
   - the lid-driven cavity: D2Q9 BGK (ω = 1.7, SoA) at 4096² float32 with
     bounce-back walls and a moving lid inside the stage chains (k=2), 16
     steps per loss, the MSE of the fluid velocity against the one at
     u_lid = 0.1, 3 descent steps on u_lid from 0.05 (the loss must fall;
     exact launch counts from the tile reckoning's segment count); and the
     48² float64 loss and u_lid gradient against the CPU run.
   - path C: the D3Q19 BGK Taylor–Green vortex (ω = 1.7, SoA, periodic)
     at 256³ float32 from feq(ρ=1, u(U0)), 16 steps through
     ``fused_time_chain(..., k=2, periodic=True, fused_bwd=True)``, the MSE
     of the final velocity against the one at U0 = 0.05, 3 descent steps
     on U0 from 0.03 (the loss must fall; each gradient launches the
     forward chain — the march at 256³ f32 — 8 times and the z-streaming
     kernel's two-phase mode 8 times, nothing else); one value+gradient
     of the same path in float64 at 128³ (the JAX package's size, where
     ``forward_design`` picks the z-streaming forward mode: 8 launches of
     each mode, nothing else); and the 32³ float64 loss and d/dU0 against
     the CPU run (the streaming forward mode there too, not the march).
   - ``parallel/`` (``parallel_phase``), on four shards of the one card (a
     mesh naming it four times), each end-to-end case against the
     unsharded port and timed against it in turns (host clock), with its
     transports and launches a shard: config #5 (``sharded_diffusion3d``,
     384³ f32, 2×2 mesh, MSE value+gradient w.r.t. u and κ); the JAX
     package's config #5 row (the periodic heat ``ShardedChain`` k=8 with
     ``fused_bwd`` at 8192² f32 on 1 shard — exactly the unsharded stage
     chain's launches — and on 4×1); config #4's elastic gradient on 4×1
     (kernels 12 and 13 in shard mode); config #2's κ gradient (rows 7 and
     9 in shard mode) and path C in f64 at 128³ (the streaming forward
     mode) on 2×2; then each shard mode alone against its plain version
     on an interior shard's extended block, and a fused-backward halo
     equal to the shard extent, card against CPU.
   - ``serving.py`` (``serving_phase``): the κ-heat op at 8192² f32
     exported with its gradient (``export_op``) and config #4's recorded
     graph (``fuse="stages"``, k=4) through ``export_program`` with its
     gradient, saved with the kernels' libraries and the leaf launch
     op's, and loaded in a fresh ``python3`` through the torch-only load
     (``serving_child``: the port, jax and the JAX package blocked, no
     nvcc or g++ on its PATH; ``torch_only_load``): the κ-heat forward
     and VJP bit-equal to the eager op with exactly 1 + 1 window
     launches, config #4's loss and five gradients against the direct
     chain with exactly 4 + 4 launches of kernels 12 and 13 (counted by
     the leaf op); the child's wall, CUDA set-up and load times beside
     the launch op's build; the κ-heat op exported with symbolic extents,
     loaded here, at 8192² and 8191×8190; a step-count artifact, loaded
     here (n=8: 4 chain calls, n=3 raises); the custom-op layer's host µs a call at 64² against
     the launcher alone, one Adam step of the 16² f64 inverse problem,
     and the 8192² heat inverse step re-read.
   - ``utils/autotune.py`` (``autotune_phase``): nl3d's bounded
     value+gradient at 384³ f32 swept over k ∈ {2, 4} × form ∈ {gather,
     local}, the table, the winner and its re-timed slope, then the
     default build's form by launch count.
   - the framework bridges (``bridge_phase``; the torch extension and the
     C kernels build with g++ beside the nvcc builds, ``bridge_build``):
     ``create_pytorch_op(backend="torch_native")`` on the κ-heat op at
     8192² f32, value and gradient bit-equal to ``torch_function``'s
     with exactly 1 + 1 window launches and no plain-version or C-kernel
     call; its host µs a call at 64² f32 in turns with
     ``torch_function``; ``forward_kernel_cpu``, ``backward_kernel_cpu``
     and ``torch_native`` on CPU tensors at 1024² f64 against the plain
     version on the host CPU (rtol 1e-12), ms a call, beside the OpenMP
     thread count and the CPU model; TensorFlow only where installed.
   - path C's gradient at k=4 (no 4-deep streaming two-phase tile fits: 2
     segments of depth 2, exactly 8 + 8 launches — the 4-deep forward
     chains and the 2-deep checkpoints in the march —, equal to the k=2
     path's loss and d/dU0), in the repairs phase;
   - the repairs: kernel 13 on an output carried into two state fields
     (8192² f32, k=2); bf16 state through kernel
     12 and the periodic heat ``fused_chain_vjp`` at 8192² (to 0.05 of the
     float32 plain versions); 3D probe lines (nl3d, 384³ f32, bounded)
     through the forward chain (the march, the box and the streaming
     forward mode in turns) and both streaming modes.
   - ranks (``ranks_phase``): the 1D κ-heat at 2²⁶ f32 (a (1, n) launch
     of the window kernel, row 1) and the 4D Laplacian (9 points) at 96⁴
     f32 and 24⁴ f64 (every dim its own, row 2), forward and backward
     against the plain version beside the copy, the bound and the
     per-cell kernel, then each op's value+gradient through
     ``torch_function``: exactly 1 + 1 window launches, no plain-version
     call.
   - second order (``hvp_phase``): the κ-heat HVP at 8192² f32 w.r.t.
     (κ, u) by reverse over reverse and by forward over reverse through
     the tangent-linear program: 5 window launches each, no plain-version
     call, both equal to the plain version twice differentiated by torch
     autograd on the card (a reference only) and to each other; the ms
     of an HVP against a value+gradient.
   - serving parity (``sharded_export_phase``): config #5's κ-diffusion
     sweep at 384³ f32 recorded in a ``GraphDataHandling`` and compiled
     with ``mesh=`` (2×2 of the card), exported with its gradient and
     loaded in a fresh ``python3`` through the torch-only load
     (``sharded_child``): forward and VJP bit-equal to the eager sharded
     run, the loaded graphs' halo copies those of the eager transports,
     the window launches the eager run's; the eager run against the
     unsharded replay.
   - the depth ladder at Queue 3 #1's shapes, where no fused design fits
     the chain's depth: D3Q19 periodic k=8 at 128³ f32 and f64, forward
     (2 launches of the 4-deep chain) and value+gradient (4 segments),
     and the D3Q19 stage chain with bounce-back walls at 64³ f64, k=2,
     value+gradient (kernel 12 at depth 1; the adjoint's
     sequential-recompute rung through the single-step kernel), each with
     its exact launch counts, held against its plain version.
   - the examples (``examples_phase``): each script of
     ``examples/torch_port/`` through its ``main`` on the card at its
     published size in float64 with its own asserts (the heat inverse
     problem, FWI and the elastic pair, the lid-driven cavity with its
     fused chain, the Cahn–Hilliard spinodal, sharded diffusion, the
     sharded elastic simulation, torch/TF interop — TensorFlow only where
     installed), its wall seconds and launches by row (a row it should
     reach at zero fails, as does a call of a plain version); then the
     spinodal at 8192² float32, 40 cycles: the recorded program's fused
     stage chain (k=2: 20 launches of kernel 12 in its periodic mode)
     against its replay (80 window launches) to the float32 contract,
     timed in turns with CUDA events, and one chain call held against its
     plain version beside its bound and its single steps.
   - ``accumulate="dd"`` (``dd_phase``): aniso27's value+gradient at 384³
     float32 through ``torch_function(accumulate="dd")`` (exactly 1 + 1
     window launches of the dd libraries, no plain-version call), against
     the port's double-word float64 run rounded to float32: every cell
     within one ulp, under 5e-3 of them off, fewer and no further off
     than the pairwise run, each off cell a near-tie (within 2^-10 ulp of
     a midpoint), the values within 1.3e-7·max |y|; timed in turns with
     the pairwise float32 and float64 runs; then each dd kernel (forward,
     full-domain masked backward and periodic forward at 384³ f32;
     forward and backward at 192³ f64, the double-word pairs) against its
     plain version bit for bit, the pairwise kernel of the same mode
     failing that check as its control, beside the copy and the bound
     (its float64 operations against the float64 peak) and in turns with
     that pairwise kernel.  The
     serving phase exports the dd op at 128³ and loads it in its fresh
     process: bit-equal to eager, 1 + 1 launches of the dd libraries.
   - the probes (``probes_phase``, rows 14 and 15): the LDS of the slice
     rungs counted in the SASS, ``fma_rate`` (also at 8192² × 1024) and
     every rung of ``op_ladder`` against their plain versions on random
     values (float32 bit for bit against the fused plain version), then
     the FMA
     rate in f32 and f64 at the TPU's (2048, 512) × 256 (slope over
     chained calls, and in a CUDA graph) and at 8192² × 1024, each as a
     share of the published peak, and the ladder's ps per element per rep
     at (2048, 512) × 4096 reps, raw and less the f32 FMA baseline.
   The z-streaming kernel (``plane_adjoint.cuh``) is held against its
   plain versions in both modes: two-phase for D3Q19 at 256³ f32 and 128³
   f64 (periodic, k=2) and for a nonlinear 3D op at 384³ f32 (bounded and
   periodic), each in both forms (the gather form and the local-VJP form,
   the one the reckoning picks first, timed with the operation count of
   the form that runs and the gather form's count beside it, then the two
   in turns); forward (row 7's cases) for D3Q19 at k=4 256³ f32 and at
   k=2 128³ f64, where the reckoning picks it; kernel 8 on an output carried into two state fields at 8192² f32.
   Kernel 12 and kernel 13 (the dim-0 march, ``stage_march.cuh``; the
   box-tile design of PR 4, ``stage_chain.cuh`` and
   ``stage_adjoint.cuh``, beside it) are held against their plain
   versions beside the cycles through single steps: the elastic pair
   bounded with its sponge (8192² f32, and 2048² f64) and periodic, the
   cavity at 4096², a 3D bounded case (the 3D heat step with Neumann
   frames, 384³), and the segmented adjoint; where the box design fits
   too it is held against the plain version as well and the two designs
   are timed in turns (march, box, box, march), and kernel 13 in its
   other reverse form (gather or local) in turns with the picked one.
   The build runs in two rounds: every library, then the march libraries
   the first round's registers (read from the card) pick (block size,
   residency, chunk, tile: each march library is one march).  After the
   build, the ``-Xptxas -v`` lines (registers, stack, spills) of every
   march and stage library are printed (kernels 7, 8, 10, 11, 12, 13).
5. Prints the card's name and power limit, a JSON line of the phases'
   numbers (serving, autotune, bridges, ranks, second order, sharded
   export, the examples, dd, the probes, the library counts after the
   build section and at the end),
   a JSON line of the kernels, and as the last line the device line
   ``{"ok": true, "device": {...}}``.  The libraries built after the
   build section are listed by name at the end: each is missing from the
   prebuild list.
   Each single-step launch is attributed to the Pallas kernel the JAX
   package's auto-select runs for the same call on the TPU
   (``pallas_counterpart``).

Fails (non-zero exit, no result line) without a CUDA device, outside a
checkout of the repository, or when any check fails.

    python3 chip_smoke.py --profile

instead profiles the main paths' steps (``--slab-ab`` times A/B
variants of the slab kernel beside the per-cell kernel, ``slab_ab``;
``--march-ab`` row 9s's two designs in turns on config #2's sharded κ
chain, ``shard_ab`` (``--march-ab 9s``: that alone), then the march's
block size, residency, chunk, tile and segment choices on the FWI wave,
config #2 (twin and forward), path C's forward, the elastic and the
cavity cases, ``march_ab``; ``--window-ab``
every R × V of the window single step at rows 1–4's shapes beside the
per-cell kernel, ``window_ab``; ``--host-ab TREE`` the 64² host cost and
the 16² f64 Adam step of the port in another checkout TREE — e.g. the
parent commit from ``git archive``, unpacked under ``build/`` — against
this one, in turns, each turn a fresh process, ``host_ab``):
``torch.profiler`` over 5 Adam
steps of the 8192² float32 heat inverse problem (per-cell, then through
the slab kernel), over 5 FWI gradients
(8192² float32, 32 steps, fused_k=4), over 5 κ gradients of config #2
(384³ float32, 16 steps, k=2), over 5 periodic-wave gradients (8192²
float32, 16 steps, k=4), over 5 elastic gradients of config #4
(8192² float32, 16 cycles, k=4) and over 5 cavity u_lid gradients (4096²
float32, 16 steps, k=2) and over 5 path-C gradients (256³ float32, 16
steps, k=2; the streaming two-phase calls in the form the reckoning
picks, labelled by form), printing for each the host-clock
time per step, the device's idle share of the window and each kernel's
share of device time (the traces are kept under ``build/profile/``).
"""

from __future__ import annotations

import argparse
import atexit
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = "pystencils_autodiff_tpu_torch/csrc/stencil_step.cuh"
SLAB_SOURCE = "pystencils_autodiff_tpu_torch/csrc/row_tiled.cuh"
SLAB_REPLACES = "pystencils_autodiff_tpu/ops/pallas_kernel.py:560"
PROBES_SOURCE = "pystencils_autodiff_tpu_torch/csrc/probes.cu"
REPLACES = {
    "_run_whole_array": "pystencils_autodiff_tpu/ops/pallas_kernel.py:164",
    "_run_blocked": "pystencils_autodiff_tpu/ops/pallas_kernel.py:268",
    "_run_plane_single": "pystencils_autodiff_tpu/ops/pallas_kernel.py:753",
    "_run_plane_full": "pystencils_autodiff_tpu/ops/pallas_kernel.py:797",
}
# the chain kernels: key (kernel, spatial dims) -> (JSON name, source, the
# Pallas function it replaces)
CHAIN_KERNELS = {
    # row 6 runs the warp march (the box, time_chain.cuh, and
    # the dim-0 march's forward mode in turns beside it)
    ("time_chain", 2): ("time_chain[_make_chain_kernel_fn]",
                        "pystencils_autodiff_tpu_torch/csrc/warp_chain.cuh",
                        "pystencils_autodiff_tpu/ops/time_chain.py:39"),
    # row 7 runs the forward mode of the dim-0 march (its box design,
    # time_chain.cuh, and the z-streaming forward mode in turns beside it;
    # the streaming kernel keeps the chains the march owns too little of,
    # counted as "plane_forward": path C in float64 at 128³)
    ("time_chain", 3): ("time_chain[make_plane_chain_kernel_fn]",
                        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
                        "pystencils_autodiff_tpu/ops/plane_chain.py:88"),
    # rows 8, 10 and 11 run the two-phase mode of the dim-0 march (their
    # box designs, adjoint_chain.cuh and twin_accum.cuh, in turns beside
    # it)
    ("adjoint_chain", 2): (
        "adjoint_chain[fused_chain_vjp.build]",
        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
        "pystencils_autodiff_tpu/ops/adjoint_chain.py:406"),
    ("twin_accum", 2): ("twin_accum[make_twin_accum_vjp_fn]",
                        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
                        "pystencils_autodiff_tpu/ops/twin_adjoint.py:271"),
    ("twin_accum", 3): ("twin_accum[make_plane_twin_accum_vjp_fn]",
                        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
                        "pystencils_autodiff_tpu/ops/twin_adjoint.py:605"),
    ("stage_chain", 2): ("stage_chain[_make_stage_chain_kernel]",
                         "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
                         "pystencils_autodiff_tpu/ops/stage_chain.py:138"),
    ("stage_adjoint", 2): (
        "stage_adjoint[fused_stage_chain_vjp]",
        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
        "pystencils_autodiff_tpu/ops/stage_adjoint.py:82"),
    ("plane_two_phase", 3): (
        "plane_adjoint[make_plane_chain_vjp_fn]",
        "pystencils_autodiff_tpu_torch/csrc/plane_adjoint.cuh",
        "pystencils_autodiff_tpu/ops/plane_adjoint.py:85"),
    ("plane_forward", 3): (
        "plane_adjoint[make_plane_chain_kernel_fn, z-streaming]",
        "pystencils_autodiff_tpu_torch/csrc/plane_adjoint.cuh",
        "pystencils_autodiff_tpu/ops/plane_chain.py:88"),
}
# published peaks of one H100 SXM (NVIDIA's data sheet; dense, outside the
# tensor cores), at its 700 W power limit: the least time a kernel could
# take is the larger of bytes / memory rate and operations / peak.  The
# probes (probes_phase) measure the FMA rate; the bounds stay on these
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12,
                  "bfloat16": 67e12}  # bf16 storage computes in float32
# make_pallas_stencil's whole-array limit (pallas_kernel.py:964)
PALLAS_WHOLE_ARRAY_LIMIT_BYTES = 2 * 1024 * 1024
FULL = {"heat2d": 8192, "heat2d_f64": 4096, "cube": 384, "small": 64,
        "tall": (70000, 64), "inverse_small": 16, "adam_steps": 3,
        "adam_steps_small": 20, "wave": 8192, "wave_f64": 4096,
        "chain_k": 4, "heat_k": 8, "fwi_steps": 32, "fwi_row": 64,
        "fwi_descent": 3, "fwi_small": 64, "fwi_small_row": 17,
        "twin_calls": 2, "cube_f64": 192, "cfg2_k": 2, "cfg2_steps": 16,
        "cfg2_descent": 3, "cfg2_small": 24, "wave_twin_steps": 16,
        "elastic": 8192, "elastic_f64": 2048, "elastic_k": 4,
        "elastic_cycles": 16, "elastic_descent": 2, "sponge_width": 40,
        "elastic_small": 96,
        "cavity": 4096, "cavity_k": 2, "cavity_steps": 16,
        "cavity_descent": 3, "cavity_small": 48, "stage3d": 384,
        "aniso": 384, "aniso_k": 2, "aniso_steps": 16, "nl3d": 384,
        "lbm": 256, "lbm_f64": 128, "lbm_k": 2, "lbm_steps": 16,
        "lbm_descent": 3, "lbm_small": 32, "multi": 8192,
        "ragged": (8191, 8190), "tile_rows": 16, "lbm_k_deep": 4,
        "bf16": 8192, "probe3d": 384, "ladder": 128, "ladder_k": 8,
        "ladder_stage": 64, "ladder_stage_k": 2, "par_heat": 8192,
        "par_deep": (8, 16, 384), "bridge_c": 1024, "rank1d": 1 << 26,
        "rank4d": 96, "rank4d_f64": 24, "hvp": 8192, "sharded_steps": 2,
        "spinodal": 8192, "spinodal_k": 2, "spinodal_cycles": 40,
        "dd_f64": 192, "dd_export": 128, "ladder_reps": 4096}
ELASTIC_DT = 0.01  # the step of BASELINE config #4's elastic pair here
LBM_OMEGA = 1.7
CAVITY_BC = {"f": ("bounce_back", "solid", ("uw0", "uw1"))}
DIFF_DT = 0.05  # config #2's step (tests/test_chain3d.py)
LBM_CARRY = {"f": "f_out"}
MULTI_CARRY = {"u": "u_next", "v": "u_next"}
TG_U0, TG_TARGET = 0.03, 0.05  # path C: the start and the observed U0
WAVE_DT = 0.2  # CFL: dt·max(c)/dx ≈ 0.45 < 1/√2 for c ≈ 2
HEAT_CARRY = {"u": "u_next"}
# f64 kernels agree with their plain versions to rounding; f32 ones to FMA
# contraction and summation order (nvcc contracts mul+add, torch does not)
TOL = {"float32": 1e-5, "float64": 1e-12}


_T0 = time.perf_counter()
# the build section's wall seconds (run)
BUILD_SECTION_S = [None]


# the libraries built by the end of the build section (then by the last
# section line), once the build section is over
_LATE = [None]
# seconds of the leaf launch op's g++ build (the build section's)
LAUNCH_OP_BUILD_S = [0.0]


def log(*args):
    """Print and flush; a section line ("== ...") carries the seconds
    since the script started and the libraries built so far (those built
    after the build section were missing from its list and built at their
    first use, one by one)."""
    late = []
    if args and str(args[0]).startswith("=="):
        nv = sys.modules.get("pystencils_autodiff_tpu_torch.codegen.nvcc")
        built = nv.BUILDS if nv else []
        args = (f"{args[0]} [+{time.perf_counter() - _T0:.0f} s; "
                f"{len(built)} libraries built, "
                f"{sum(sec for _, sec in built):.0f} s]",) + args[1:]
        if _LATE[0] is not None:
            late, _LATE[0] = built[_LATE[0]:], len(built)
    print(*args, flush=True)
    if late:
        print(f"  built since the last section, missing from the prebuild "
              f"list: {[name for name, _ in late]}", flush=True)


def pallas_counterpart(program, full_domain, periodic, spatial, itemsize):
    """The Pallas kernel that ``make_pallas_stencil``'s auto-select
    (``strategy=None``, pallas_kernel.py:1002-1116) runs for the same call
    on the TPU, or ``"jnp"`` where it runs no kernel.  As in the op, an
    ``adjoint_mask_ghost`` comes only with ``full_domain``.  Where Pallas
    tries a plane tile and falls back if none fits, a viable tile is
    assumed (true at this script's shapes)."""
    from pystencils_autodiff_tpu_torch.ops.common import is_adjoint

    nd, ins = program.ndim, program.input_fields
    has_index = any(f.index_shape for f in ins + program.output_fields)
    one = math.prod(spatial) * itemsize
    total = one * (len(ins) + len(program.output_fields))
    big = one > PALLAS_WHOLE_ARRAY_LIMIT_BYTES
    # accumulate="dd" programs skip the plane kernels and take the
    # blocked one wherever it runs (pallas_kernel.py:1007, :1034, :1098)
    dd = getattr(program, "accumulate", "pairwise") == "dd"
    plane_ok = (nd == 3 and not full_domain and not has_index
                and len(ins) == 1 and not any(is_adjoint(f) for f in ins)
                and not program.accum_fields and not dd)
    blocked_ok = nd >= 2 and not (full_domain and nd >= 3 and not any(
        is_adjoint(f) for f in ins))
    if periodic:
        if nd == 3 and full_domain and not has_index and big and not dd:
            return "_run_plane_full"
        if plane_ok and big:
            return "_run_plane_single"
        rows = spatial[0]
        if nd == 2 and any(rows % t == 0 for t in range(8, rows + 1, 8)):
            return "_run_blocked"
        return "jnp"
    if plane_ok and total > PALLAS_WHOLE_ARRAY_LIMIT_BYTES:
        return "_run_plane_single"
    if dd and blocked_ok:
        return "_run_blocked"
    if total <= PALLAS_WHOLE_ARRAY_LIMIT_BYTES:
        return "_run_whole_array"
    if nd == 3 and full_domain and not has_index:
        return "_run_plane_full"
    if blocked_ok:
        return "_run_blocked"
    rest = spatial[1:]
    aligned = (not rest or rest[-1] % 128 == 0) and all(
        s % 8 == 0 for s in rest[:-1])
    return "_run_row_tiled" if nd >= 2 and not has_index and aligned else "jnp"


def launches_by_counterpart(calls, programs):
    """Sum ``cuda_kernel.LAUNCH_CALLS`` by Pallas counterpart: a slab
    launch (``strategy="tiled"``) is ``_run_row_tiled``'s."""
    out = {}
    for (name, full, per, spatial, itemsize, _, form), n in calls.items():
        cp = ("_run_row_tiled" if form == "slab" else
              pallas_counterpart(programs[name], full, per, spatial,
                                 itemsize))
        out[cp] = out.get(cp, 0) + n
    return out


def step_sources(programs, dtypes=("float32", "float64"), periodic=True,
                 forms=("window",), spatial=None):
    """(name, source) of single-step variants, one library each, named as
    ``make_cuda_stencil`` names them: a forward program in interior mode, a
    backward program (one with adjoint inputs) in full mode, each also
    periodic where ``periodic`` (the slab form has no periodic mode).
    The window form at ``window_tile``'s R × V for ``spatial`` (default
    8192² in 2D, 384³ in 3D), the per-cell form ("direct", "strided")
    for the in-turns comparison."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops.common import is_adjoint

    out = []
    for p in programs:
        bwd = any(is_adjoint(f) for f in p.input_fields)
        modes = ["full" if bwd else "interior"] + (["periodic"] if periodic
                                                   else [])
        shape = spatial or ((8192, 8192) if p.ndim == 2 else (384,) * 3)
        for dt in dtypes:
            tile = ck.window_tile(p, shape, 2 if dt == "bfloat16"
                                  else 8 if dt == "float64" else 4)
            for mode in modes:
                for form in forms:
                    if form == "slab" and mode == "periodic":
                        continue
                    tag = (f"_r{tile[0]}v{tile[1]}" if form == "window"
                           else "")
                    out.append((f"{p.name}_{mode}_{form}{tag}_{dt}",
                                generate_cuda_source(p, dt, mode, form,
                                                     tile)))
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, batches=3, reps=4, warmup=3) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` runs back
    to back (so the host's launch work overlaps the device's), over the
    count; the median of ``batches`` such batches.  A function whose first
    run takes more than 50 ms is timed over one batch of 2 runs after that
    one warm-up run (the plain versions: their times are a reference, and
    the run's 1200 s hold every phase)."""
    import torch

    first = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - first > 0.05:
        batches, reps, warmup = 1, 2, 0
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, calls=50, replays=5) -> float:
    """Device time of one ``fn()`` with no host work in it: ``calls`` runs
    captured in one CUDA graph, CUDA events around ``replays`` replays,
    over the count — for shapes small enough that ``cuda_ms`` reads the
    host's time per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def build_all(sources):
    """Compile ``[(name, source)]`` with one nvcc process each, all started
    together; returns the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from pystencils_autodiff_tpu_torch.codegen.nvcc import compile_and_load

    def one(item):
        t = time.perf_counter()
        compile_and_load(item[1], item[0])
        return item[0], time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for name, sec in pool.map(one, sources):
            log(f"  built {name}: {sec:.1f} s")
    return time.perf_counter() - t0


def random_inputs(program, spatial, dtype, gen, device):
    import torch

    from pystencils_autodiff_tpu_torch.ops.common import storage_shape

    out = {}
    for f in program.input_fields:
        t = torch.randn(storage_shape(f, spatial), generator=gen,
                        dtype=dtype, device=device)
        if f.name == "kappa":  # a diffusion coefficient: positive
            t = 1.0 + 0.5 * torch.sigmoid(t)
        elif f.name == "c":  # a wave speed: ≈ 2
            t = 2.0 + 0.1 * t ** 2
        elif f.name in ("u_curr", "u_prev"):
            t = 0.1 * t
        elif f.name == "f":  # a lattice-Boltzmann distribution: ρ ≈ 1
            t = (1.0 + 0.1 * t) / t.shape[0]
        out[f.name] = t
    return out


def _flat(res):
    """The tensors of a kernel's result (dicts by key, lists in order)."""
    if isinstance(res, dict):
        return [res[k] for k in sorted(res)]
    if isinstance(res, (list, tuple)):
        return [t for r in res for t in _flat(r)]
    return [res]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def program_ops(steps) -> int:
    """Arithmetic operations of one evaluation of ``steps`` at one cell."""
    import sympy as sp

    return sum(int(sp.count_ops(s.rhs)) for s in steps)


def check_and_time(name, kernel, plain, rtol, inputs, counter, dev,
                   unfused=None, ops=0, library=None, launches=1,
                   out_scale=None, plain_ms=None, compare=None, peak=None,
                   control=None, **extra):
    """Kernel vs plain on the same tensors (``kernel()``/``plain()`` run
    them on ``inputs``), then both timed beside a device copy of the bytes
    the kernel moves: each input read once, each output it writes written
    once (an output that is one of the inputs, returned as it came, is not
    written).  ``unfused``: the same computation through single-step
    kernels, timed too; ``library``: one PyTorch call computing the same
    function, timed too.  ``ops``: the arithmetic operations the function
    needs; with the bytes it gives the least time the card could take
    (``bound_ms``).  ``launches``: the launches of ``counter``'s kernel one
    ``kernel()`` makes; ``out_scale(i)``: a factor on the tolerance of
    output i (the adjoints' cotangents, sums of k backward steps);
    ``plain_ms``: the plain version's time where it was taken already;
    ``compare(i, t)``: the part of output i that is held (a shard block's
    owned cells; the bytes count the whole output); ``peak``: the float
    type whose peak rate the operations are counted against (default:
    the outputs'; ``"float64"`` for an ``accumulate="dd"`` body's float64
    sums); ``control()``: another kernel on the same inputs that must fail
    the same comparison in some output (the pairwise body beside a dd
    body held bit for bit: the check can see the difference)."""
    import torch

    before = counter.LAUNCHES
    got = _flat(kernel())
    torch.cuda.synchronize()
    if counter.LAUNCHES != before + launches:
        raise AssertionError(f"{name}: {counter.LAUNCHES - before} kernel "
                             f"launches counted, expected {launches}")
    ref = _flat(plain())

    def bad_cells(i, g, r):
        if compare is not None:
            g, r = compare(i, g), compare(i, r)
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: output {i} shape {tuple(g.shape)} "
                                 f"vs {tuple(r.shape)} or not finite")
        diff = (g - r).abs()
        tol = rtol * (out_scale(i) if out_scale else 1.0)
        bad = diff > tol * r.abs().max().item() + tol * r.abs()
        return bad, diff.max().item(), r.abs().max().item(), tol

    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        bad, e, scale, tol = bad_cells(i, g, r)
        err = max(err, e)
        if bad.any():
            raise AssertionError(
                f"{name}: output {i} differs from the plain version: max "
                f"|diff| {e:.3e}, max |ref| {scale:.3e}, rtol {tol:g}")
    if control is not None:
        seen = [int(bad_cells(i, c, r)[0].sum())
                for i, (c, r) in enumerate(zip(_flat(control()), ref))]
        if not any(seen):
            raise AssertionError(f"{name}: the control passes the check "
                                 f"too (rtol {rtol:g})")
        extra["control_cells_off"] = seen
    given = {t.data_ptr() for t in inputs}
    nbytes = _nbytes(inputs) + _nbytes([t for t in got
                                        if t.data_ptr() not in given])
    dtype = str(got[0].dtype).replace("torch.", "")
    del got, ref
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain) if plain_ms is None else plain_ms
    half = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(half)
    copy_ms = cuda_ms(lambda: dst.copy_(half))
    del half, dst
    if unfused is not None:
        extra["unfused_ms"] = cuda_ms(unfused)
    library_ms = cuda_ms(library) if library is not None else None
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[peak or dtype] * 1e3
    rec = {"case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "copy_ms": copy_ms, "bytes": nbytes, "ops": ops,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms,
           "kernel_GBps": nbytes / ms / 1e6,
           "plain_GBps": nbytes / plain_ms / 1e6,
           "copy_GBps": nbytes / copy_ms / 1e6, **extra}
    log(f"  {name:38s} {extra.get('counterpart', ''):18s} err {err:.2e}  "
        f"kernel {ms:8.3f} ms ({rec['kernel_GBps']:7.1f} GB/s)  plain "
        f"{plain_ms:8.3f} ms ({rec['plain_GBps']:7.1f} GB/s)  copy "
        f"{copy_ms:7.3f} ms ({rec['copy_GBps']:7.1f} GB/s)  bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})"
        + (f"  single steps {extra['unfused_ms']:8.3f} ms"
           if unfused is not None else "")
        + (f"  library {library_ms:8.3f} ms" if library is not None else ""))
    torch.cuda.empty_cache()
    return rec


def stencil_weights(prog, k=1):
    """A one-field, constant-coefficient linear program as the weights of a
    convolution ({offset: coefficient}, k steps composed), else None."""
    import sympy as sp

    from pystencils_autodiff_tpu_torch.field import Field

    if (len(prog.input_fields) != 1 or len(prog.output_fields) != 1
            or prog.input_fields[0].index_shape):
        return None
    env, rhs = {}, None
    for st in prog.steps:
        e = st.rhs.xreplace(env)
        if st.is_main:
            rhs = e
        else:
            env[st.target] = e
    accs = list(rhs.atoms(Field.Access))
    w = {}
    for a in accs:
        c = sp.diff(rhs, a)
        if not c.is_Number:
            return None
        w[a.offsets] = w.get(a.offsets, 0.0) + float(c)
    if rhs.xreplace({a: 0 for a in accs}) != 0:
        return None
    out = {(0,) * prog.ndim: 1.0}
    for _ in range(k):
        nxt = {}
        for o1, c1 in out.items():
            for o2, c2 in w.items():
                o = tuple(a + b for a, b in zip(o1, o2))
                nxt[o] = nxt.get(o, 0.0) + c1 * c2
        out = nxt
    return out


def conv_library(prog, x, k=1, periodic=False):
    """One PyTorch call computing k interior (or periodic) steps of a
    constant-coefficient linear program on ``x``: a convolution (valid, or
    a Conv module with circular padding); None for any other program."""
    import torch

    w = stencil_weights(prog, k)
    nd = prog.ndim
    if w is None or nd > 3 or (periodic and nd == 1):
        return None
    r = max(abs(o) for off in w for o in off)
    weight = torch.zeros((1, 1) + (2 * r + 1,) * nd, dtype=x.dtype,
                         device=x.device)
    for off, c in w.items():
        weight[(0, 0) + tuple(r + o for o in off)] = c
    xb = x[None, None]
    if periodic:
        conv = (torch.nn.Conv2d if nd == 2 else torch.nn.Conv3d)(
            1, 1, 2 * r + 1, padding=r, padding_mode="circular", bias=False)
        conv = conv.to(device=x.device, dtype=x.dtype).requires_grad_(False)
        conv.weight.copy_(weight)
        return lambda: conv(xb)
    fn = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
          3: torch.nn.functional.conv3d}[nd]
    return lambda: fn(xb, weight)


def check_library(name, library, ref, periodic, ghost, rtol):
    """The library call computes the plain version's interior (or every
    cell, periodic) to the case's tolerance."""
    got = library()[0, 0]
    want = ref if periodic else ref[tuple(slice(lo, n - hi) for n, (lo, hi)
                                          in zip(ref.shape, ghost))]
    diff = (got - want).abs().max().item()
    if not diff <= rtol * 10 * want.abs().max().item():
        raise AssertionError(f"{name}: the library call differs from the "
                             f"plain version by {diff:.3e}")


def compare_case(case, dev, gen, counterpart=None):
    """Single-step kernel (the window design) vs plain on the same
    tensors, then timed in turns with the per-cell kernel
    (``form="cell"``, held against the plain version too) and, where one
    PyTorch call computes the same function, that call: window, cell,
    library, library, cell, window.  ``counterpart``: the kernels line's
    row, where the Pallas auto-select's pick is not it (a 1D grid above
    the whole-array limit runs jnp there)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import (make_cuda_stencil,
                                                   make_torch_stencil)

    name, prog, spatial, dtype, kw, rtol = case
    inputs = random_inputs(prog, spatial, dtype, gen, dev)
    kernel = make_cuda_stencil(prog, **kw)
    cell = make_cuda_stencil(prog, form="cell", **kw)
    plain = make_torch_stencil(prog, **kw)
    itemsize = inputs[prog.input_fields[0].name].element_size()
    counterpart = counterpart or pallas_counterpart(
        prog, kw.get("full_domain", False), kw.get("periodic", False),
        spatial, itemsize)
    library = None
    if not kw.get("full_domain"):
        library = conv_library(prog, inputs[prog.input_fields[0].name],
                               periodic=kw.get("periodic", False))
    if library is not None:
        check_library(name, library, plain(inputs)[prog.output_names[0]],
                      kw.get("periodic", False), prog.ghost, rtol)
    tile = ck.window_tile(prog, spatial, itemsize)
    rec = check_and_time(name, lambda: kernel(inputs), lambda: plain(inputs),
                         rtol, list(inputs.values()), ck, dev,
                         ops=math.prod(spatial) * program_ops(prog.steps),
                         library=library, counterpart=counterpart,
                         window=list(tile))
    ref, got = plain(inputs), cell(inputs)
    for n, r in ref.items():
        diff = (got[n] - r).abs().max().item()
        if not diff <= rtol * 2 * r.abs().max().item():
            raise AssertionError(f"{name}: the per-cell kernel differs "
                                 f"from the plain version by {diff:.3e}")
    del ref, got
    runs = [("window", lambda: kernel(inputs)), ("cell", lambda: cell(inputs))]
    if library is not None:
        runs.append(("library", library))
    turns = {label: [] for label, _ in runs}
    for i in list(range(len(runs))) + list(range(len(runs)))[::-1]:
        turns[runs[i][0]].append(cuda_ms(runs[i][1]))
    for label, ts in turns.items():
        rec[f"{label}_ms_turns"] = ts
    log(f"    window {tile}: in turns "
        + ", ".join(f"{label} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                    for label, ts in turns.items())
        + f"; window/cell {statistics.mean(turns['window']) / statistics.mean(turns['cell']):.2f}")
    torch.cuda.empty_cache()
    return rec


def step_cases(sizes, progs, hcf):
    """The single step's kernel-vs-plain cases (``compare_case``): (name,
    program, spatial, dtype, step kwargs, rtol)."""
    import torch

    f32, f64 = torch.float32, torch.float64
    hf, hb = progs["heat_step2d"]
    df, db = progs["diffusion3d"]
    tf_ = progs["heat_step3d"][0]
    n2, n2d, n3, ns = (sizes["heat2d"], sizes["heat2d_f64"], sizes["cube"],
                       sizes["small"])
    mask = {"full_domain": True, "adjoint_mask_ghost": hf.ghost}
    rag = sizes["ragged"]
    return [
        ("heat2d fwd interior f32", hf, (n2, n2), f32, {}, 1e-5),
        ("heat2d bwd full+mask f32", hb, (n2, n2), f32, mask, 1e-5),
        ("heat2d fwd periodic f32", hf, (n2, n2), f32, {"periodic": True}, 1e-5),
        ("heat2d bwd periodic f32", hb, (n2, n2), f32,
         {"full_domain": True, "periodic": True}, 1e-5),
        ("heat2d fwd interior f64", hf, (n2d, n2d), f64, {}, 1e-12),
        ("heat2d bwd full+mask f64", hb, (n2d, n2d), f64, mask, 1e-12),
        ("heat2d fwd periodic f64", hf, (n2d, n2d), f64, {"periodic": True}, 1e-12),
        ("heat2d bwd periodic f64", hb, (n2d, n2d), f64,
         {"full_domain": True, "periodic": True}, 1e-12),
        ("diffusion3d fwd interior f32", df, (n3,) * 3, f32, {}, 1e-5),
        ("diffusion3d bwd full+mask f32", db, (n3,) * 3, f32,
         {"full_domain": True, "adjoint_mask_ghost": df.ghost}, 1e-5),
        ("heat3d fwd interior f32", tf_, (n3,) * 3, f32, {}, 1e-5),
        ("heat2d const-coefficient fwd interior f32", hcf, (n2, n2), f32, {},
         1e-5),
        ("heat3d fwd periodic f32", tf_, (n3,) * 3, f32, {"periodic": True}, 1e-5),
        ("heat2d fwd interior f32 small", hf, (ns, ns), f32, {}, 1e-5),
        ("heat2d bwd full+mask f32 small", hb, (ns, ns), f32, mask, 1e-5),
        ("heat2d fwd interior f32 70000x64", hf, sizes["tall"], f32, {}, 1e-5),
        ("heat2d bwd full+mask f32 70000x64", hb, sizes["tall"], f32, mask,
         1e-5),
        (f"heat2d fwd interior f32 ragged {rag[0]}x{rag[1]}", hf, rag, f32,
         {}, 1e-5),
        (f"heat2d bwd full+mask f32 ragged {rag[0]}x{rag[1]}", hb, rag, f32,
         mask, 1e-5),
    ]


def slab_cases(sizes, progs, hcf):
    """The slab kernel's cases: the κ-heat forward and backward at 8192²
    f32 (default tile and ``tile_rows`` given) and 4096² f64, the
    constant-coefficient heat forward (beside conv2d), a ragged 8191×8190
    grid, the variable-κ diffusion forward and backward at 384³ f32 and
    192³ f64, and bf16 storage."""
    import torch

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    hf, hb = progs["heat_step2d"]
    df, db = progs["diffusion3d"]
    n2, n2d, n3, n3d = (sizes["heat2d"], sizes["heat2d_f64"], sizes["cube"],
                        sizes["cube_f64"])
    m2 = {"full_domain": True, "adjoint_mask_ghost": hf.ghost}
    m3 = {"full_domain": True, "adjoint_mask_ghost": df.ghost}
    rows, rag, nb = sizes["tile_rows"], sizes["ragged"], sizes["bf16"]
    # (name, program, spatial, dtype, step kwargs, tile_rows)
    return [
        ("heat2d fwd interior f32 slab", hf, (n2, n2), f32, {}, None),
        ("heat2d bwd full+mask f32 slab", hb, (n2, n2), f32, m2, None),
        (f"heat2d fwd interior f32 slab tile_rows={rows}", hf, (n2, n2), f32,
         {}, rows),
        (f"heat2d bwd full+mask f32 slab tile_rows={rows}", hb, (n2, n2),
         f32, m2, rows),
        ("heat2d fwd interior f64 slab", hf, (n2d, n2d), f64, {}, None),
        ("heat2d bwd full+mask f64 slab", hb, (n2d, n2d), f64, m2, None),
        ("heat2d const-coefficient fwd interior f32 slab", hcf, (n2, n2),
         f32, {}, None),
        (f"heat2d fwd interior f32 slab ragged {rag[0]}x{rag[1]}", hf, rag,
         f32, {}, None),
        (f"heat2d bwd full+mask f32 slab ragged {rag[0]}x{rag[1]}", hb, rag,
         f32, m2, None),
        ("diffusion3d fwd interior f32 slab", df, (n3,) * 3, f32, {}, None),
        ("diffusion3d bwd full+mask f32 slab", db, (n3,) * 3, f32, m3, None),
        ("diffusion3d fwd interior f64 slab", df, (n3d,) * 3, f64, {}, None),
        ("diffusion3d bwd full+mask f64 slab", db, (n3d,) * 3, f64, m3,
         None),
        ("heat2d fwd interior bf16 slab", hf, (nb, nb), bf16, {}, None),
    ]


def slab_case(case, dev, gen):
    """The slab kernel vs its plain version on the same tensors (bf16:
    against the plain version in float32 on the same bf16 inputs, to
    0.05), then timed as ``check_and_time`` does and beside the per-cell
    kernel and, where one PyTorch call computes the same function, that
    call (conv2d) on the same inputs, in turns: slab, cell, library, slab,
    cell, library.  The per-cell kernel is held against the plain version
    too."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import (make_cuda_stencil,
                                                   make_torch_stencil)
    from pystencils_autodiff_tpu_torch.ops import row_tiled as rt

    name, prog, spatial, dtype, kw, rows = case
    inputs = {n: t.to(dtype) for n, t in random_inputs(
        prog, spatial, torch.float32 if dtype == torch.bfloat16 else dtype,
        gen, dev).items()}
    bf16 = dtype == torch.bfloat16
    ref_in = {n: t.float() for n, t in inputs.items()} if bf16 else inputs
    rtol = 0.05 if bf16 else TOL[str(dtype).replace("torch.", "")]
    slab = make_cuda_stencil(prog, strategy="tiled", tile_rows=rows, **kw)
    cell = make_cuda_stencil(prog, **kw)
    plain = make_torch_stencil(prog, **kw)
    ref = plain(ref_in)
    got = cell(inputs)
    for n, r in ref.items():
        diff = (got[n].to(r.dtype) - r).abs().max().item()
        if not diff <= rtol * 2 * r.abs().max().item():
            raise AssertionError(f"{name}: the per-cell kernel differs from "
                                 f"the plain version by {diff:.3e}")
    del got, ref
    library = None
    if not kw.get("full_domain") and not bf16:
        library = conv_library(prog, inputs[prog.input_fields[0].name])
    if library is not None:
        check_library(name, library, plain(inputs)[prog.output_names[0]],
                      False, prog.ghost, rtol)
    itemsize = inputs[prog.input_fields[0].name].element_size()
    width = rt.slab_route(list(inputs.values()), itemsize)
    st = rt.slab_tile(rt.slab_halo(prog), len(prog.input_fields), itemsize,
                      spatial, rows, width)
    rec = check_and_time(name, lambda: slab(inputs), lambda: plain(ref_in),
                         rtol, list(inputs.values()), ck, dev,
                         ops=math.prod(spatial) * program_ops(prog.steps),
                         library=library, counterpart="_run_row_tiled",
                         tile=list(st.tile), ring=list(st.slab),
                         blocks_per_sm=st.blocks_per_sm, copy_width=width,
                         bf16=bf16)
    runs = [lambda: slab(inputs), lambda: cell(inputs)] + (
        [library] if library is not None else [])
    turns = [[cuda_ms(f) for f in runs] for _ in range(2)]
    rec["slab_ms_turns"] = [t[0] for t in turns]
    rec["cell_ms_turns"] = [t[1] for t in turns]
    rec["cell_ms"] = statistics.mean(rec["cell_ms_turns"])
    rec["slab_over_cell"] = statistics.mean(rec["slab_ms_turns"]) / rec[
        "cell_ms"]
    if library is not None:
        rec["library_ms_turns"] = [t[2] for t in turns]
    log(f"    tile {st.tile} ring {st.slab} ({st.blocks_per_sm} blocks/SM, "
        f"{st.smem} B, copies of {width or 'one element'}"
        f"{' B' if width else ''}): slab "
        f"{' / '.join(f'{t[0]:.3f}' for t in turns)} ms, per-cell "
        f"{' / '.join(f'{t[1]:.3f}' for t in turns)} ms"
        + (f", library {' / '.join(f'{t[2]:.3f}' for t in turns)} ms"
           if library is not None else "")
        + f"; slab/cell {rec['slab_over_cell']:.2f}")
    torch.cuda.empty_cache()
    return rec


def repair_sources(sizes):
    """(name, source) of the libraries of the repairs' phases: kernel 13 on
    the multi-carrier op, kernel 12 and the heat twin chains in bf16."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_chain_source, generate_stage_adjoint_source,
        generate_stage_source)
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops import transposed_linear_op

    mc = sc.StagePlan([(multi_carrier_op(), MULTI_CARRY)], 2, False, None)
    hs = sc.StagePlan(heat_stages(), 2, False, None)
    heat_c = heat_stages()[0][0]
    cot_op, cot_carry, _, _ = transposed_linear_op(heat_c, HEAT_CARRY)
    return [(f"{mc.name}_stage_adjoint_k2",
             generate_stage_adjoint_source(sa.AdjointStagePlan(mc))),
            (f"{hs.name}_stage_chain_k2_bfloat16",
             generate_stage_source(hs, "bfloat16"))] + [
        (f"{p.program.name}_chain_bfloat16",
         generate_chain_source(p, "bfloat16"))
        for p in (tc.chain_plan(heat_c, 2, HEAT_CARRY, True),
                  tc.chain_plan(cot_op, 2, cot_carry, True))]


def heat_stages():
    """The constant-coefficient heat step as a one-stage chain (the JAX
    package's tests/test_bf16.py op)."""
    from pystencils_autodiff_tpu_torch.models import heat_step_op

    return [(heat_step_op(dt=0.1), HEAT_CARRY)]


def chain_case(case, dev, gen):
    """Chain kernel (forward, or two-phase with ``adjoint``) vs its plain
    version on the same tensors; a 3D forward chain in the design its
    reckoning picks (``time_chain.forward_design``), then every other
    design that fits the shape, held too and timed in turns with it."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta
    from pystencils_autodiff_tpu_torch.ops.cuda_kernel import tile_itemsize
    from pystencils_autodiff_tpu_torch.ops.local_vjp import local_vjp
    from pystencils_autodiff_tpu_torch.timeloop import make_time_stepper

    name, op, carry, spatial, dtype, k, periodic, probes, kind = case[:9]
    single_steps = case[9] if len(case) > 9 else True
    both_forms = case[10] if len(case) > 10 else False
    plan = tc.chain_plan(op, k, carry, periodic, probes)
    prog = plan.program
    bf16 = dtype == torch.bfloat16
    # bf16: stored bf16, computed in float; held against the plain version
    # in float32 on the same inputs, to 0.05
    state = {n: t.to(dtype) for n, t in random_inputs(
        prog, spatial, torch.float32 if bf16 else dtype, gen, dev).items()}
    ref_state = {n: t.float() for n, t in state.items()} if bf16 else state
    rtol = 0.05 if bf16 else TOL[str(dtype).replace("torch.", "")]
    step = make_time_stepper(op, carry, periodic=periodic)
    cells = math.prod(spatial)
    fwd_ops = cells * (k * program_ops(plan.cycle_steps)
                       + program_ops(plan.hoist_steps))
    tag = {"chain": kind, "nd": len(spatial)}

    def steps(st):
        for _ in range(k):
            st = step(st)
        return st

    if kind == "plane_forward":
        kernel, plain = (pa.make_plane_chain_kernel(plan),
                         tc.plain_time_chain(plan))
        return check_and_time(name, lambda: kernel(state),
                              lambda: plain(state), rtol,
                              list(state.values()), pa, dev,
                              unfused=lambda: steps(state), ops=fwd_ops,
                              **tag)
    if kind == "time_chain":
        kernel, plain = tc.make_chain_kernel(plan), tc.plain_time_chain(plan)
        library = None
        if not probes and periodic and not bf16:
            library = conv_library(prog, state[prog.input_names[0]], k, True)
        if library is not None:
            check_library(name, library, plain(state)[0][prog.input_names[0]],
                          True, prog.ghost, rtol)
        isz = tile_itemsize(state[plan.in_names[0]])
        picked = tc.forward_design(plan, spatial, isz)
        if picked == "stream":  # the streaming kernel's forward mode
            tag["chain"] = "plane_forward"
        rec = check_and_time(name, lambda: kernel(state),
                             lambda: plain(ref_state), rtol,
                             list(state.values()),
                             pa if picked == "stream" else tc, dev,
                             unfused=None if bf16 else lambda: steps(state),
                             ops=fwd_ops, library=library, bf16=bf16,
                             design=picked, **tag)
        if kernel.design != picked:
            raise AssertionError(f"{name}: ran the {kernel.design} design, "
                                 f"the reckoning picked {picked}")
        # rows 6 and 7: every design that fits the shape, in turns with
        # the picked one (warp, box, march, march, box, warp in 2D; march,
        # box, stream, stream, box, march in 3D)
        if picked == "march":
            rec["march"] = march_summary(
                kernel.kernel("march").kernel.last_geometry)
        if picked == "warp":
            wg = kernel.kernel("warp").geometry
            rec["warp"] = {key: getattr(wg, key) for key in (
                "v", "halo", "owned", "nstrip", "nseg", "seg", "steps",
                "regs", "warps_per_sm", "owned_share")}
            rec["warp_regs"] = {str(v): list(r) for v, r in
                                kernel.kernel("warp").regs[dtype].items()}
            log(f"    warp march: {rec['warp']}; registers (V: regs, "
                f"local bytes) {rec['warp_regs']}")
        fits = tc.fitting_designs(plan, spatial, isz)
        order = tc.DESIGNS_2D if len(spatial) == 2 else tc.DESIGNS
        designs = {d: tc.make_chain_kernel(plan, d) for d in order
                   if d in fits and d != picked}
        if picked == "warp":  # the other V too: what the V model fits
            from pystencils_autodiff_tpu_torch.ops import warp_chain as wc
            designs = {**{f"warp V={v}": wc.make_warp_chain_kernel(
                plan, tc, lanes=v) for v in wc.lane_widths(isz)
                if v != rec["warp"]["v"]}, **designs}
        design_turns(rec, name, [(picked, lambda: kernel(state),
                                  pa if picked == "stream" else tc)] + [
            (d, lambda fn=fn: fn(state), pa if d == "stream" else tc)
            for d, fn in designs.items()], lambda: plain(ref_state), rtol,
            list(state.values()), dev, fwd_ops)
        return rec
    cots = {n: torch.randn(t.shape, generator=gen, dtype=dtype, device=dev)
            for n, t in state.items()}

    def unfused():  # k single forward steps, then autograd's k backward
        ins = {n: t.detach().requires_grad_() for n, t in state.items()}
        out = steps(ins)
        return torch.autograd.grad([out[n] for n in plan.in_names],
                                   [ins[n] for n in plan.in_names],
                                   [cots[n] for n in plan.in_names])

    if kind == "twin_accum":
        g = ac.fused_chain_vjp(op, k, carry, periodic=periodic)
        if g.route != "twin_accum":
            raise AssertionError(f"{name}: took the {g.route} route")
        tp = g.plan
        kernel = ta.make_twin_accum_kernel(tp)
        plain = ta.plain_twin_accum_vjp(tp)
        ops = fwd_ops + k * cells * (
            program_ops(tp.cot_prog.steps)
            + (program_ops(tp.grad_prog.steps) if tp.grad_prog else 0))
        ins = list(state.values()) + list(cots.values())
        rec = check_and_time(
            name, lambda: kernel(state, cots), lambda: plain(state, cots),
            rtol, ins, ta, dev, unfused=unfused, ops=ops, **tag)
        # rows 10 (2D: kernel B in turns) and 11: the march, the box in
        # turns
        rec["march"] = march_summary(kernel.kernel.last_geometry)
        box = ta.make_twin_accum_kernel(tp, "box")
        design_turns(rec, name, [("march", lambda: kernel(state, cots), ta),
                                 ("box", lambda: box(state, cots), ta)],
                     lambda: plain(state, cots), rtol, ins, dev, ops)
        return rec
    ap = ac.AdjointPlan(plan)
    pcs = tuple(torch.randn((k, spatial[-1]), generator=gen, dtype=dtype,
                            device=dev) for _ in probes)
    plain = ac.plain_chain_vjp(ap)
    n_state = len(state)
    gather_ops = fwd_ops + k * cells * program_ops(ap.bwd.steps)
    ins = list(state.values()) + list(cots.values()) + list(pcs)
    if kind != "plane_two_phase":
        # row 8: the march, the box in turns
        kernel, box = ac.make_adjoint_kernel(ap), ac.make_adjoint_kernel(
            ap, "box")
        rec = check_and_time(
            name, lambda: kernel(state, cots, pcs),
            lambda: plain(state, cots, pcs), rtol, ins, ac, dev,
            unfused=unfused if single_steps else None, ops=gather_ops, **tag)
        rec["march"] = march_summary(kernel.kernel.last_geometry)
        design_turns(rec, name,
                     [("march", lambda: kernel(state, cots, pcs), ac),
                      ("box", lambda: box(state, cots, pcs), ac)],
                     lambda: plain(state, cots, pcs), rtol, ins, dev,
                     gather_ops)
        return rec
    # the z-streaming kernel in the form its reckoning picks, held against
    # the plain version with the operations of that form; with
    # ``both_forms`` the other form too, and the two timed in turns
    local_ops = fwd_ops + k * cells * (program_ops(local_vjp(ap).program.steps)
                                       + len(local_vjp(ap).slots))
    ops = {"gather": gather_ops, "local": local_ops}
    picked = pa.stream_geometry(plan, spatial, tile_itemsize(state[
        plan.in_names[0]]), ap).form
    kernels = {picked: pa.make_plane_adjoint_kernel(ap)}
    scale = (lambda i: 10.0 if i >= n_state else 1.0)
    rec = check_and_time(
        f"{name} ({picked} form)", lambda: kernels[picked](state, cots, pcs),
        lambda: plain(state, cots, pcs), rtol, ins, pa, dev,
        unfused=unfused if single_steps else None, ops=ops[picked],
        out_scale=scale, form=picked, ops_gather=gather_ops, **tag)
    # the bound with the gather form's operations: the same bytes
    rec["bound_ms_gather"] = max(
        rec["bytes"] / HBM_BYTES_PER_S * 1e3,
        gather_ops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3)
    if kernels[picked].form != picked:
        raise AssertionError(f"{name}: the kernel ran the "
                             f"{kernels[picked].form} form, the reckoning "
                             f"picked {picked}")
    log(f"    {picked} form: {ops[picked]:.4g} operations (bound "
        f"{rec['bound_ms']:.3f} ms); the gather form's count "
        f"{gather_ops:.4g} (bound {rec['bound_ms_gather']:.3f} ms)")
    if both_forms:
        other = "gather" if picked == "local" else "local"
        kernels[other] = pa.make_plane_adjoint_kernel(ap, other)
        alt = check_and_time(
            f"{name} ({other} form)", lambda: kernels[other](state, cots, pcs),
            lambda: plain(state, cots, pcs), rtol, ins, pa, dev,
            ops=ops[other], out_scale=scale, plain_ms=rec["plain_ms"],
            form=other, **tag)
        turns = [[cuda_ms(lambda: kernels[f](state, cots, pcs))
                  for f in (picked, other)] for _ in range(2)]
        rec["form_turns"] = {picked: [t[0] for t in turns],
                             other: [t[1] for t in turns]}
        rec["other_form"] = {key: alt[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "ops")}
        log(f"    in turns: {picked} {' / '.join(f'{t[0]:.3f}' for t in turns)}"
            f" ms, {other} {' / '.join(f'{t[1]:.3f}' for t in turns)} ms")
    return rec


def tiled_path(example, diff3d, sizes, dev):
    """The slab kernel's main path through ``torch_function(strategy=
    "tiled")``: the heat inverse problem at 8192² f32 (4 unrolled steps,
    ``adam_steps`` Adam steps; the loss must fall and every single-step
    launch must be a slab launch: 4 forward + 4 backward a step, 4 for the
    target and 4 for the final loss), one value+gradient of the 3D
    variable-κ diffusion at 384³ f32 (1 + 1), and the 16² f64 inverse
    problem (20 Adam steps, tile_rows=4: 4 tiles of 4 rows) against the
    same run of the plain version on the CPU (rtol 1e-12).  Returns the
    slab launches of the 8192² run."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    f32, f64 = torch.float32, torch.float64
    n2, n3, steps = sizes["heat2d"], sizes["cube"], sizes["adam_steps"]

    def forms():
        out = {"slab": 0, "cell": 0}
        for key, n in ck.LAUNCH_CALLS.items():
            out[key[-1]] += n
        return out

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    losses, grad = heat_inverse_problem(example, n2, steps, dev, f32,
                                        strategy="tiled")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    heat_n = forms()
    want = {"slab": 4 + 8 * steps + 4, "cell": 0}
    log(f"  heat inverse problem {n2}² f32, tiled: losses {losses} "
        f"({sec:.2f} s host clock incl. sync); launches {heat_n}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"tiled heat inverse problem: loss did not "
                             f"fall: {losses}")
    if heat_n != want or not torch.isfinite(grad).all():
        raise AssertionError(f"tiled heat inverse problem: launches "
                             f"{heat_n}, expected {want}, or a non-finite "
                             f"gradient")
    ck.reset_launch_counts()
    d_loss = value_and_grad(diff3d, (n3,) * 3, dev, strategy="tiled")
    torch.cuda.synchronize()
    d_n = forms()
    log(f"  diffusion3d {n3}³ f32 value+grad, tiled: loss {d_loss:.6e}; "
        f"launches {d_n}")
    if d_n != {"slab": 2, "cell": 0} or not math.isfinite(d_loss):
        raise AssertionError(f"tiled diffusion3d: launches {d_n}")
    ns, ss = sizes["inverse_small"], sizes["adam_steps_small"]
    card, _ = heat_inverse_problem(example, ns, ss, dev, f64,
                                   strategy="tiled", tile_rows=4)
    cpu, _ = heat_inverse_problem(example, ns, ss, torch.device("cpu"), f64,
                                  strategy="tiled", tile_rows=4)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"  {ns}² f64 inverse problem, tiled, card vs CPU plain: "
        f"{card[-1]:.6e} vs {cpu[-1]:.6e} (max rel {rel:.2e})")
    if not rel <= 1e-12:
        raise AssertionError(f"tiled small inverse problem: card {card} vs "
                             f"CPU plain {cpu}")
    return heat_n["slab"]


def repairs(sizes, dev, gen, counted, p_losses, p_us):
    """The phases of the repairs: kernel 13 on an output carried into two
    state fields (8192² f32, k=2); path C's gradient at k=4 (256³ f32: no
    4-deep streaming two-phase tile fits, so each call runs 2 segments of
    depth 2 — exactly 8 forward-chain launches a gradient, the 4-deep
    chains and the 2-deep checkpoints in the design ``forward_design``
    picks for each (the march), and 8 two-phase launches; its
    loss and d/dU0 equal to path C's at k=2); bf16 state through kernel
    12 (the heat stage chain, k=2, 8192²) and the periodic heat
    ``fused_chain_vjp`` (its twin chains); 3D probe lines at 384³ f32
    through the forward chain (the march; the box and the streaming
    forward mode in turns), the streaming forward mode and the streaming
    two-phase mode.  Returns the kernel-vs-plain records."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    f32, bf16 = torch.float32, torch.bfloat16
    log("== repairs: kernel 13 on an output carried into two state fields")
    n = sizes["multi"]
    plan = sc.StagePlan([(multi_carrier_op(), MULTI_CARRY)], 2, False, None)
    ap = sa.AdjointStagePlan(plan)
    st = {nm: 0.5 * torch.randn((n, n), generator=gen, device=dev)
          for nm in plan.state_names}
    cots = {nm: torch.randn((n, n), generator=gen, device=dev)
            for nm in ap.cot_names}
    kernel, plain = sa.make_stage_adjoint_kernel(ap), \
        sa.plain_stage_chain_vjp(ap)
    recs = [check_and_time(
        "multi-carrier stage adjoint k2 bounded f32",
        lambda: kernel(st, cots), lambda: plain(st, cots), TOL["float32"],
        list(st.values()) + list(cots.values()), sa, dev,
        ops=stage_ops(plan, n * n, ap),
        out_scale=lambda i: 10.0 if i >= len(st) else 1.0,
        chain="stage_adjoint", nd=2, k=2)]
    del st, cots

    log("== repairs: path C's gradient at k=4 as segments")
    nb, lst, kd = sizes["lbm"], sizes["lbm_steps"], sizes["lbm_k_deep"]
    segs = ac.two_phase_segments(
        tc.chain_plan(lbm3d_op(f32), kd, LBM_CARRY, True), (nb,) * 3, 4)
    calls = lst // kd
    # each call's forward chain (k=4 deep) and the backward's segs − 1
    # checkpoints (depth k/segs), each in the design its reckoning picks
    want = {("plane_two_phase", 3): calls * segs}
    for depth, n in ((kd, calls), (kd // segs, calls * (segs - 1))):
        key = forward_key(tc.chain_plan(lbm3d_op(f32), depth, LBM_CARRY,
                                        True), (nb,) * 3, 4)
        want[key] = want.get(key, 0) + n
    vg = path_c_setup(nb, lst, kd, dev, f32)
    ((loss4, g4), n4, s4) = counted(lambda: vg(TG_U0))
    g2 = p_losses[0] / (p_us[0] - p_us[1])  # path C's d/dU0 at k=2
    rel_l = abs(loss4.item() - p_losses[0]) / p_losses[0]
    rel_g = abs(g4.item() - g2) / abs(g2)
    log(f"  D3Q19 {nb}³ f32, {lst} steps, k={kd}: {segs} segments of depth "
        f"{kd // segs}; loss {loss4.item():.6e} (k=2: {p_losses[0]:.6e}, rel "
        f"{rel_l:.2e}), d/dU0 {g4.item():.6e} (k=2: {g2:.6e}, rel "
        f"{rel_g:.2e}); {s4 * 1e3:.3f} ms host clock; launches "
        f"{ {f'{a}/{b}D': v for (a, b), v in n4.items() if v} }")
    if segs != 2 or {key: v for key, v in n4.items() if v} != want:
        raise AssertionError(f"path C k={kd}: {segs} segments, launches "
                             f"{n4}, expected {want}")
    if not (rel_l <= 1e-4 and rel_g <= 1e-3):
        raise AssertionError(f"path C k={kd}: loss or gradient differs from "
                             f"k=2 ({rel_l:.2e}, {rel_g:.2e})")
    del vg

    log("== repairs: bf16 state (stored bf16, computed in float) vs the "
        "plain versions in float32 on the same inputs, to 0.05")
    n = sizes["bf16"]
    u = torch.randn((n, n), generator=gen, device=dev).to(bf16)
    plan = sc.StagePlan(heat_stages(), 2, False, None)
    kernel, plain = sc.make_stage_kernel(plan), sc.plain_stage_chain(plan)
    bf_recs = [check_and_time(
        "heat stage chain k2 bounded bf16", lambda: kernel({"u": u}),
        lambda: plain({"u": u.float()}), 0.05, [u], sc, dev,
        ops=stage_ops(plan, n * n), chain="stage_chain", nd=2)]
    heat_c = heat_stages()[0][0]
    g = ac.fused_chain_vjp(heat_c, 2, HEAT_CARRY, periodic=True)
    vjp = ac.plain_chain_vjp(ac.AdjointPlan(
        tc.chain_plan(heat_c, 2, HEAT_CARRY, True)))
    c = torch.randn((n, n), generator=gen, device=dev).to(bf16)
    bf_recs.append(check_and_time(
        f"heat fused_chain_vjp k2 periodic bf16 ({g.route})",
        lambda: g({"u": u}, {"u": c}),
        lambda: vjp({"u": u.float()}, {"u": c.float()}), 0.05, [u, c], tc,
        dev, launches=2, chain="time_chain", nd=2))
    del u, c

    log("== repairs: 3D probe lines, bounded")
    np3 = sizes["probe3d"]
    probes = probe3d_lines(np3)
    uc = {"u": "u_next"}
    k = sizes["lbm_k"]
    for c_ in [("nl3d chain k2 bounded probes f32", nl3d_op(), uc,
                (np3,) * 3, f32, k, False, probes, "time_chain"),
               ("nl3d streaming forward k2 bounded probes f32", nl3d_op(),
                uc, (np3,) * 3, f32, k, False, probes, "plane_forward"),
               ("nl3d two-phase k2 bounded probes f32", nl3d_op(), uc,
                (np3,) * 3, f32, k, False, probes, "plane_two_phase")]:
        recs.append(chain_case(c_, dev, gen))
    for r in bf_recs:
        r["bf16"] = True
    return recs + bf_recs


def example_op():
    """The op of the README and examples/heat_inverse_problem.py."""
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

    u, out, kappa = fields("u, out, kappa", 2)
    step = Assignment(out.center, u[0, 0] + 0.1 * kappa[0, 0] * (
        u[1, 0] + u[-1, 0] + u[0, 1] + u[0, -1] - 4 * u[0, 0]))
    return AutoDiffOp([step], op_name="heat_step")


def heat_inverse_setup(op, n, dev, dtype, seed=0, unroll=4, lr=0.05, **kw):
    """The examples/heat_inverse_problem.py flow on torch tensors: returns
    ``step()`` (one Adam step on κ, returns the loss), ``final_loss()`` and
    κ; ``kw`` goes to ``torch_function`` (``strategy``, ``tile_rows``)."""
    import torch

    f = op.torch_function(**kw)
    # made on the CPU so every device starts from the same numbers
    gen = torch.Generator().manual_seed(seed)
    u0 = torch.randn((n, n), generator=gen, dtype=dtype).to(dev)
    k_true = 1.0 + 0.5 * torch.sigmoid(
        torch.randn((n, n), generator=gen, dtype=dtype).to(dev))

    def rollout(k):
        x = u0
        for _ in range(unroll):
            x = f(u=x, kappa=k)
        return x

    with torch.no_grad():
        target = rollout(k_true)
    k = torch.ones((n, n), dtype=dtype, device=dev, requires_grad=True)
    opt = torch.optim.Adam([k], lr=lr)

    def step():
        opt.zero_grad()
        loss = torch.mean((rollout(k) - target) ** 2)
        loss.backward()
        opt.step()
        return loss.item()

    def final_loss():
        with torch.no_grad():
            return torch.mean((rollout(k) - target) ** 2).item()

    return step, final_loss, k


def heat_inverse_problem(op, n, steps, dev, dtype, **kw):
    """The loss after each Adam step and one final evaluation, and the last
    gradient."""
    step, final_loss, k = heat_inverse_setup(op, n, dev, dtype, **kw)
    losses = [step() for _ in range(steps)]
    losses.append(final_loss())
    return losses, k.grad


def value_and_grad(op, spatial, dev, periodic=False, seed=7, **kw):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    f = op.torch_function(periodic=periodic, **kw)
    ins = []
    for fld in op.forward_input_fields:
        t = torch.randn(spatial, generator=gen, dtype=torch.float32,
                        device=dev)
        if fld.name == "kappa":
            t = 1.0 + 0.5 * torch.sigmoid(t)
        ins.append(t.requires_grad_())
    out = f(*ins)
    loss = (out ** 2).mean()
    loss.backward()
    for t in [out] + [t.grad for t in ins]:
        if tuple(t.shape) != tuple(spatial) or not torch.isfinite(t).all():
            raise AssertionError(f"{op.op_name}: bad output/gradient "
                                 f"{tuple(t.shape)}")
    return loss.item()


def fwi_setup(n, n_steps, k, row, dev, dtype, seed=0):
    """The FWI problem of config #3 at n²: a seeded wavefield u0 and true
    velocity model, ``observed`` made by the forward chain from the true
    model, and the starting model c_true + 0.05.  Inputs are made on the
    CPU so every device starts from the same numbers."""
    import torch

    from pystencils_autodiff_tpu_torch.models import wave_step_op
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    gen = torch.Generator().manual_seed(seed)
    u0 = (0.1 * torch.randn((n, n), generator=gen, dtype=dtype)).to(dev)
    c_true = (2.0 + 0.1 * torch.randn((n, n), generator=gen,
                                      dtype=dtype) ** 2).to(dev)
    chain = fused_time_chain(
        wave_step_op(dt=WAVE_DT, dtype=str(dtype).replace("torch.", "")), k,
        WAVE_CARRY, probes=[("u_curr", row)])

    def seismogram(c):
        with torch.no_grad():
            state, chunks = {"u_curr": u0, "u_prev": u0, "c": c}, []
            for _ in range(n_steps // k):
                state, (p,) = chain(state)
                chunks.append(p)
            return torch.cat(chunks)

    return u0, c_true + 0.05, seismogram(c_true), seismogram


def fwi_descent(n, n_steps, k, row, iters, dev, dtype, step=0.01):
    """``iters`` gradient-descent steps on c with ``fwi_gradient(fused_k=k)``
    (the move of the largest cell is ``step``); returns the misfit before
    each step and after the last, the last gradient and each gradient's
    host-clock ms (it ends in a read of the misfit, which waits for the
    device)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import fwi_gradient

    u0, c, observed, seismogram = fwi_setup(n, n_steps, k, row, dev, dtype)
    misfits, g, ms = [], None, []
    for _ in range(iters):
        t = time.perf_counter()
        v, g = fwi_gradient(c, u0, observed, row, n_steps, dt=WAVE_DT,
                            fused_k=k)
        misfits.append(v.item())  # waits for the device
        ms.append((time.perf_counter() - t) * 1e3)
        c = c - step * g / g.abs().max()
    misfits.append(0.5 * ((seismogram(c) - observed) ** 2).sum().item())
    return misfits, g, ms


def twin_heat(n, k, calls, dev, seed=3):
    """The JAX package's bench.py headline function on the port: value and
    gradient of the periodic heat step (dt = 0.1), k steps per call through
    ``fused_chain_vjp``'s twin chains, ``calls`` calls chained."""
    import torch

    from pystencils_autodiff_tpu_torch.models import heat_step_op
    from pystencils_autodiff_tpu_torch.ops import fused_chain_vjp

    g = fused_chain_vjp(heat_step_op(dt=0.1), k, HEAT_CARRY, periodic=True)
    if g.route != "twin":
        raise AssertionError(f"heat chain took the {g.route} route")
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((n, n), generator=gen, device=dev)
    cu = torch.randn((n, n), generator=gen, device=dev)
    for _ in range(calls):
        st, cot = g({"u": u}, {"u": cu})
        u, cu = st["u"], cot["u"]
    for t in (u, cu):
        if tuple(t.shape) != (n, n) or not torch.isfinite(t).all():
            raise AssertionError("twin heat chain: bad state or cotangent")
    return u.abs().max().item(), cu.abs().max().item()


def wave_final_setup(n, n_steps, k, dev, dtype, seed=5):
    """``gradient()``: the gradient with respect to the velocity model c of
    a misfit of the final wavefield (periodic domain, no receivers),
    through ``fused_time_chain(fused_bwd=True)``, whose backward is the 2D
    twin-with-accumulation kernel; returns the misfit and the gradient.
    The observation (the final field with the true c) is made here."""
    import torch

    from pystencils_autodiff_tpu_torch.models import wave_step_op
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    gen = torch.Generator().manual_seed(seed)
    u0 = (0.1 * torch.randn((n, n), generator=gen, dtype=dtype)).to(dev)
    c_true = (2.0 + 0.1 * torch.randn((n, n), generator=gen,
                                      dtype=dtype) ** 2).to(dev)
    chain = fused_time_chain(
        wave_step_op(dt=WAVE_DT, dtype=str(dtype).replace("torch.", "")), k,
        WAVE_CARRY, periodic=True, fused_bwd=True)

    def final(c):
        st = {"u_curr": u0, "u_prev": u0, "c": c}
        for _ in range(n_steps // k):
            st = chain(st)
        return st["u_curr"]

    with torch.no_grad():
        observed = final(c_true)
    c = (c_true + 0.05).requires_grad_()

    def gradient():
        misfit = 0.5 * ((final(c) - observed) ** 2).sum()
        (g,) = torch.autograd.grad(misfit, c)
        return misfit.item(), g

    return gradient


def config2_setup(n, n_steps, k, dev, dtype, seed=11):
    """BASELINE config #2 at n³: a seeded initial field u0 and true κ (made
    on the CPU, so every device starts from the same numbers), the
    observation — the final u after ``n_steps`` steps with the true κ —
    and ``value_and_grad(κ)``: the MSE of the final u against the
    observation and its gradient with respect to κ, through
    ``fused_time_chain(diffusion3d_op(dt=0.05), k, fused_bwd=True)``.
    The starting model is a constant κ."""
    import torch

    from pystencils_autodiff_tpu_torch.models import diffusion3d_op
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    gen = torch.Generator().manual_seed(seed)
    u0 = torch.randn((n,) * 3, generator=gen, dtype=dtype).to(dev)
    k_true = (1.0 + 0.5 * torch.sigmoid(torch.randn(
        (n,) * 3, generator=gen, dtype=dtype))).to(dev)
    chain = fused_time_chain(
        diffusion3d_op(dt=DIFF_DT, dtype=str(dtype).replace("torch.", "")),
        k, HEAT_CARRY, periodic=False, fused_bwd=True)

    def final(kappa):
        st = {"u": u0, "kappa": kappa}
        for _ in range(n_steps // k):
            st = chain(st)
        return st["u"]

    with torch.no_grad():
        observed = final(k_true)

    def value_and_grad(kappa):
        kap = kappa.detach().requires_grad_()
        loss = torch.mean((final(kap) - observed) ** 2)
        (g,) = torch.autograd.grad(loss, kap)
        return loss, g

    return torch.full_like(k_true, 1.25), value_and_grad


def config2_descent(n, n_steps, k, iters, dev, dtype, counted, step=0.02):
    """``iters`` gradient-descent steps on κ (the largest cell moves
    ``step``); each gradient is run through ``counted`` and must launch
    the 3D forward chain and the 3D twin-accum kernel n_steps/k times
    each and no other kernel of the port.  Returns the loss before each
    step and after the last, each gradient's host-clock ms and the
    summed launch counts."""
    kappa, value_and_grad = config2_setup(n, n_steps, k, dev, dtype)
    losses, ms, total = [], [], {}
    want = {("time_chain", 3): n_steps // k, ("twin_accum", 3): n_steps // k}
    for _ in range(iters):
        (loss, g), got, sec = counted(lambda: value_and_grad(kappa))
        losses.append(loss.item())
        ms.append(sec * 1e3)
        if {key: n for key, n in got.items() if n} != want:
            raise AssertionError(f"config #2: one gradient launched {got}, "
                                 f"expected exactly {want}")
        for key, n in got.items():
            total[key] = total.get(key, 0) + n
        kappa = kappa - step * g / g.abs().max()
    losses.append(value_and_grad(kappa)[0].item())
    return losses, ms, total


# ---------------------------------------------------------------------------
# The stage chains (kernels 12 and 13) and their main paths.

def elastic_chain_stages(dtype):
    from pystencils_autodiff_tpu_torch.models import elastic_stages

    return elastic_stages(dt=ELASTIC_DT, dtype=str(dtype).replace("torch.",
                                                                  ""))


def elastic_boundary():
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS

    return {0: {n: ("sponge", "damp") for n in ELASTIC_FIELDS}}


def cavity_stages(dtype):
    from pystencils_autodiff_tpu_torch.models import d2q9_bgk_op

    return [(d2q9_bgk_op(omega=LBM_OMEGA, layout="soa",
                         dtype=str(dtype).replace("torch.", "")),
             {"f": "f_out"})]


def heat3d_neumann_stages():
    from pystencils_autodiff_tpu_torch.models import heat_step3d_op

    return [(heat_step3d_op(), HEAT_CARRY)], {"u": "neumann"}


def stage_state(kind, spatial, dtype, dev, gen, width=40):
    """Seeded inputs of a stage case: the five elastic fields and a Cerjan
    damping plane, a perturbed D2Q9 rest state in a walled box with a
    moving lid (SoA), or a 3D field."""
    import torch

    from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=dtype,
                                   device=dev)

    if kind == "elastic":
        st = {n: rnd(spatial) for n in ELASTIC_FIELDS}
        st["damp"] = cerjan_damping(spatial, width=width, dtype=dtype,
                                    device=dev)
        return st
    if kind == "elastic-free":
        return {n: rnd(spatial) for n in ELASTIC_FIELDS}
    if kind == "cavity":
        n = spatial[0]
        w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=dtype,
                         device=dev)
        solid = torch.zeros(spatial, dtype=dtype, device=dev)
        solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = 1.0
        lid = torch.zeros(spatial, dtype=dtype, device=dev)
        lid[0, :] = 0.05
        return {"f": w[:, None, None] * (1.0 + rnd((9, n, n), 0.01)),
                "solid": solid, "uw0": torch.zeros_like(lid), "uw1": lid}
    return {"u": rnd(spatial)}


def stage_ops(plan, cells, adjoint=None):
    """Arithmetic operations of the k cycles: each stage's program (and
    backward program) per cell, one operation per target component and
    cell for each BC event."""
    per = 0
    for ev in plan.cycle:
        if ev.kind == "stage":
            per += program_ops(plan.progs[ev.stage].steps)
            if adjoint is not None:
                per += program_ops(adjoint.bwd[ev.stage].steps)
        else:
            per += ev.nout * (2 if adjoint is not None else 1)
    return plan.k * cells * per


def stage_case(case, dev, gen):
    """Kernel 12 or 13 (or the segmented adjoint) in the march design vs
    its plain version on the same tensors, beside the same cycles through
    single steps; where the box design of PR 4 fits too, it is held
    against the plain version as well and the two designs are timed in
    turns (march, box, box, march), and kernel 13's other reverse form is
    held and timed in turns with the picked one."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc

    name, stages, k, periodic, boundary, state_kind, spatial, dtype, kind, \
        wanted, segments = case
    plan = sc.StagePlan(stages, k, periodic, boundary)
    state = stage_state(state_kind, spatial, dtype, dev, gen,
                        FULL["sponge_width"])
    rtol = TOL[str(dtype).replace("torch.", "")]
    cells = math.prod(spatial)
    seq = sc.sequential_stage_chain(plan)
    tag = {"chain": "stage_chain" if kind == "fwd" else "stage_adjoint",
           "nd": len(spatial), "k": k}
    isz = 8 if dtype == torch.float64 else 4
    if kind == "fwd":
        kernel = sc.make_stage_kernel(plan, "march")
        plain = sc.plain_stage_chain(plan)
        rec = check_and_time(name, lambda: kernel(state),
                             lambda: plain(state), rtol,
                             list(state.values()), sc, dev,
                             unfused=lambda: seq(state),
                             ops=stage_ops(plan, cells), **tag)
        rec["march"] = march_summary(kernel.last_geometry)
        box = sc.make_stage_kernel(plan, "box")
        if box_fits(plan, spatial, isz):
            design_turns(rec, name, [("march", lambda: kernel(state), sc),
                                     ("box", lambda: box(state), sc)],
                         lambda: plain(state), rtol, list(state.values()),
                         dev, stage_ops(plan, cells))
        return rec
    ap = sa.AdjointStagePlan(plan, wanted)
    cots = {n: torch.randn(state[n].shape, generator=gen, dtype=dtype,
                           device=dev) for n in ap.cot_names}
    plain = sa.plain_stage_chain_vjp(ap)
    if kind == "segmented":
        g = sa.fused_stage_chain_vjp(stages, k, periodic=periodic,
                                     boundary=boundary, wanted=wanted,
                                     segments=segments)
        kernel, launches = g, segments
    else:
        kernel, launches = sa.make_stage_adjoint_kernel(ap, "march"), 1

    def unfused():  # k single-step cycles, then autograd's backward
        ins = {n: t.detach().requires_grad_(n in ap.cot_names)
               for n, t in state.items()}
        out = seq(ins)
        names = [n for n in plan.state_names if n in ap.cot_names]
        return torch.autograd.grad([out[n] for n in names],
                                   [ins[n] for n in names],
                                   [cots[n] for n in names])

    inputs = list(state.values()) + list(cots.values())
    rec = check_and_time(
        name, lambda: kernel(state, cots), lambda: plain(state, cots), rtol,
        inputs, sa, dev, unfused=unfused, ops=stage_ops(plan, cells, ap),
        launches=launches, **tag)
    if kind == "segmented":
        return rec
    mg = kernel.last_geometry
    rec["march"] = march_summary(mg)
    picked = mg.forms[0] if len(set(mg.forms)) == 1 else None
    if picked is not None:
        other = "gather" if picked == "local" else "local"
        alt = sa.make_stage_adjoint_kernel(ap, "march", other)
        form_rec = check_and_time(
            f"{name} [{other} form]", lambda: alt(state, cots),
            lambda: plain(state, cots), rtol, inputs, sa, dev,
            ops=stage_ops(plan, cells, ap), plain_ms=rec["plain_ms"],
            **tag)
        turns = [cuda_ms(f) for f in (lambda: kernel(state, cots),
                                      lambda: alt(state, cots),
                                      lambda: alt(state, cots),
                                      lambda: kernel(state, cots))]
        rec["form_turns"] = {picked: [turns[0], turns[3]],
                             other: [turns[1], turns[2]]}
        rec["other_form_err"] = form_rec["max_abs_err"]
        log(f"  {name:38s} in turns: {picked} form (picked) "
            f"{turns[0]:.3f} / {turns[3]:.3f} ms, {other} form "
            f"{turns[1]:.3f} / {turns[2]:.3f} ms")
    if box_fits(plan, spatial, isz, ap):
        box = sa.make_stage_adjoint_kernel(ap, "box")
        design_turns(rec, name, [("march", lambda: kernel(state, cots), sa),
                                 ("box", lambda: box(state, cots), sa)],
                     lambda: plain(state, cots), rtol, inputs, dev,
                     stage_ops(plan, cells, ap))
    return rec


def march_summary(mg):
    """What the march reckoning picked for a case."""
    out = {"forms": list(mg.forms), "chunk": mg.chunk,
           "tile": list(mg.tile), "segments": mg.nseg, "smem": mg.smem,
           "threads": mg.threads, "blocks_per_sm": mg.blocks_per_sm,
           "rounds": mg.rounds, "owned_share": mg.owned_share,
           "work": mg.work}
    log(f"    march: {out}")
    return out


def box_fits(plan, spatial, itemsize, ap=None):
    """Whether the box design of PR 4 has a tile for this case."""
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    try:
        if ap is None:
            sc.stage_geometry(plan, spatial, itemsize,
                              blocks_per_sm=tc.FWD_BLOCKS_PER_SM[plan.nd],
                              block_rows=tc.FWD_BLOCK_ROWS[plan.nd])
        else:
            sa.adjoint_geometry(ap, spatial, itemsize)
        return True
    except ValueError:
        return False


def design_turns(rec, name, runs, plain, rtol, inputs, dev, ops):
    """``runs`` = [(design, fn, launch counter)], the first the design the
    case picked (held against the plain version already): every other
    design held against the plain version too, then all timed in turns
    (first to last, then back: march, box, box, march) into ``rec``."""
    errs = {}
    for label, fn, counter in runs[1:]:
        other = check_and_time(f"{name} [{label} design]", fn, plain, rtol,
                               inputs, counter, dev, ops=ops,
                               plain_ms=rec["plain_ms"], chain=rec["chain"],
                               nd=rec["nd"], bf16=rec.get("bf16", False))
        errs[label] = other["max_abs_err"]
    times = {label: [] for label, _, _ in runs}
    for i in list(range(len(runs))) + list(range(len(runs)))[::-1]:
        times[runs[i][0]].append(cuda_ms(runs[i][1]))
    rec["design_turns"] = times
    rec["design_errs"] = errs
    first = runs[0][0]
    mean = {label: statistics.mean(v) for label, v in times.items()}
    log(f"  {name:38s} in turns: "
        + ", ".join(f"{label} {' / '.join(f'{t:.3f}' for t in v)} ms"
                    for label, v in times.items())
        + "".join(f" ({label} / {first} {mean[label] / mean[first]:.2f})"
                  for label in times if label != first))


def chain_cases(sizes):
    """The chain kernels' kernel-vs-plain cases (``chain_case``): (name,
    op, carry, spatial, dtype, k, periodic, probes, kernel)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                      diffusion3d_op,
                                                      heat_step3d_op,
                                                      heat_step_op,
                                                      wave_step_op)
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY

    f32, f64 = torch.float32, torch.float64
    wave32, wave64 = wave_step_op(dt=WAVE_DT), wave_step_op(
        dt=WAVE_DT, dtype="float64")
    heat_c, diff3d, heat3d = (heat_step_op(dt=0.1), diffusion3d_op(),
                              heat_step3d_op())
    k, hk, ck3 = sizes["chain_k"], sizes["heat_k"], sizes["cfg2_k"]
    probe = [("u_curr", sizes["fwi_row"])]
    nw, nwd = sizes["wave"], sizes["wave_f64"]
    cube3, cube64 = (sizes["cube"],) * 3, (sizes["cube_f64"],) * 3
    return [
        # (name, op, carry, spatial, dtype, k, periodic, probes, kernel)
        ("wave chain k4 bounded probe f32", wave32, WAVE_CARRY, (nw, nw), f32,
         k, False, probe, "time_chain"),
        ("wave chain k4 bounded probe f64", wave64, WAVE_CARRY, (nwd, nwd),
         f64, k, False, probe, "time_chain"),
        ("heat chain k8 periodic f32", heat_c, HEAT_CARRY, (nw, nw), f32, hk,
         True, [], "time_chain"),
        # the periodic heat twin chain's forward in bf16 (row 6's bf16)
        ("heat chain k2 periodic bf16", heat_c, HEAT_CARRY, (nw, nw),
         torch.bfloat16, 2, True, [], "time_chain"),
        ("diffusion3d chain k2 bounded f32", diff3d, HEAT_CARRY, cube3, f32,
         ck3, False, [], "time_chain"),
        ("diffusion3d chain k2 periodic f32", diff3d, HEAT_CARRY, cube3, f32,
         ck3, True, [], "time_chain"),
        ("diffusion3d chain k2 bounded f64", diff3d, HEAT_CARRY, cube64, f64,
         ck3, False, [], "time_chain"),
        ("diffusion3d chain k2 bounded bf16", diff3d, HEAT_CARRY, cube3,
         torch.bfloat16, ck3, False, [], "time_chain"),
        ("heat3d chain k2 bounded f32", heat3d, HEAT_CARRY, cube3, f32, ck3,
         False, [], "time_chain"),
        ("d3q19 chain k2 periodic f32", lbm3d_op(f32), LBM_CARRY,
         (sizes["lbm"],) * 3, f32, sizes["lbm_k"], True, [], "time_chain"),
        # path C's k=4 forward chain and, where the streaming forward mode
        # is picked, path C in f64 (the first of that mode's records: the
        # kernels line's); config #4's aniso27
        ("d3q19 chain k4 periodic f32", lbm3d_op(f32), LBM_CARRY,
         (sizes["lbm"],) * 3, f32, sizes["lbm_k_deep"], True, [],
         "time_chain"),
        ("d3q19 chain k2 periodic f64", lbm3d_op(f64), LBM_CARRY,
         (sizes["lbm_f64"],) * 3, f64, sizes["lbm_k"], True, [],
         "time_chain"),
        ("aniso27 chain k2 periodic f32", anisotropic27_op(), {"u": "y"},
         (sizes["aniso"],) * 3, f32, sizes["aniso_k"], True, [],
         "time_chain"),
        ("wave two-phase k4 bounded probe f32", wave32, WAVE_CARRY, (nw, nw),
         f32, k, False, probe, "adjoint_chain"),
        ("wave two-phase k4 bounded probe f64", wave64, WAVE_CARRY,
         (nwd, nwd), f64, k, False, probe, "adjoint_chain"),
        ("wave two-phase k4 periodic f32", wave32, WAVE_CARRY, (nw, nw), f32,
         k, True, [], "adjoint_chain"),
        ("wave twin-accum k4 periodic f32", wave32, WAVE_CARRY, (nw, nw), f32,
         k, True, [], "twin_accum"),
        ("diffusion3d twin-accum k2 bounded f32", diff3d, HEAT_CARRY, cube3,
         f32, ck3, False, [], "twin_accum"),
        ("diffusion3d twin-accum k2 periodic f32", diff3d, HEAT_CARRY, cube3,
         f32, ck3, True, [], "twin_accum"),
        ("heat3d bounded twin k2 f32", heat3d, HEAT_CARRY, cube3, f32, ck3,
         False, [], "twin_accum"),
        ("multi-carrier two-phase k2 bounded f32", multi_carrier_op(),
         MULTI_CARRY, (nw, nw), f32, 2, False, [], "adjoint_chain"),
    ]


def stage_cases(sizes):
    """The kernel-vs-plain cases of kernels 12 and 13: the elastic pair
    with its sponge (path A's shape and depth, and f64), without it
    (bounded and periodic: what the 20 sponge events of a call cost), the
    cavity (path B's), a 3D bounded case, and the segmented adjoint."""
    import torch

    f32, f64 = torch.float32, torch.float64
    ne, nf, nc, n3 = (sizes["elastic"], sizes["elastic_f64"],
                      sizes["cavity"], sizes["stage3d"])
    ek, ck = sizes["elastic_k"], sizes["cavity_k"]
    el32, el64 = elastic_chain_stages(f32), elastic_chain_stages(f64)
    bnd = elastic_boundary()
    cav = cavity_stages(f32)
    h3, h3b = heat3d_neumann_stages()
    # (name, stages, k, periodic, boundary, state, spatial, dtype, kind,
    #  wanted, segments)
    return [
        ("elastic sponge k4 bounded f32", el32, ek, False, bnd, "elastic",
         (ne, ne), f32, "fwd", None, None),
        ("elastic k4 periodic f32", el32, ek, True, None, "elastic-free",
         (ne, ne), f32, "fwd", None, None),
        ("elastic k4 bounded, no sponge f32", el32, ek, False, None,
         "elastic-free", (ne, ne), f32, "fwd", None, None),
        ("cavity k2 bounce-back f32", cav, ck, False, CAVITY_BC, "cavity",
         (nc, nc), f32, "fwd", None, None),
        ("heat3d neumann k2 bounded f32", h3, 2, False, h3b, "u",
         (n3,) * 3, f32, "fwd", None, None),
        ("elastic sponge k4 bounded f64", el64, ek, False, bnd, "elastic",
         (nf, nf), f64, "fwd", None, None),
        ("elastic sponge adjoint k4 f32", el32, ek, False, bnd, "elastic",
         (ne, ne), f32, "adj", (), None),
        ("elastic adjoint k4 periodic f32", el32, ek, True, None,
         "elastic-free", (ne, ne), f32, "adj", None, None),
        ("elastic adjoint k4 bounded, no sponge f32", el32, ek, False, None,
         "elastic-free", (ne, ne), f32, "adj", None, None),
        ("cavity adjoint k2 f32", cav, ck, False, CAVITY_BC, "cavity",
         (nc, nc), f32, "adj", {"uw1"}, None),
        ("heat3d neumann adjoint k1 f32", h3, 1, False, h3b, "u",
         (n3,) * 3, f32, "adj", None, None),
        ("elastic sponge adjoint k2 f64", el64, ek // 2, False, bnd,
         "elastic", (nf, nf), f64, "adj", (), None),
        ("elastic sponge adjoint k4 segmented 2x2 f32", el32, ek, False,
         bnd, "elastic", (ne, ne), f32, "segmented", (), 2),
    ]


def stage_sources(sizes):
    """(name, source) of every stage-chain library the run uses, named as
    the wrappers name them."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_stage_adjoint_source, generate_stage_source)
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc

    ek, ck = sizes["elastic_k"], sizes["cavity_k"]
    el, cav = elastic_chain_stages(torch.float32), cavity_stages(torch.float32)
    el64 = elastic_chain_stages(torch.float64)
    h3, h3b = heat3d_neumann_stages()
    f32, f64 = "float32", "float64"
    plans = [  # (stages, k, periodic, boundary, float type, kernels:
        #  "fwd" kernel 12, "adj" kernel 13 with its wanted fields)
        (el, ek, False, elastic_boundary(), f32, "fwd", None),
        (el, ek, False, elastic_boundary(), f32, "adj", ()),
        (el, ek // 2, False, elastic_boundary(), f32, "fwd", None),
        (el, ek // 2, False, elastic_boundary(), f32, "adj", ()),
        (el, ek, True, None, f32, "fwd", None),
        (el, ek, True, None, f32, "adj", None),
        (el, ek, False, None, f32, "fwd", None),
        (el, ek, False, None, f32, "adj", None),
        (cav, ck, False, CAVITY_BC, f32, "fwd", None),
        (cav, ck, False, CAVITY_BC, f32, "adj", {"uw1"}),
        (cav, 1, False, CAVITY_BC, f32, "fwd", None),
        (cav, 1, False, CAVITY_BC, f32, "adj", {"uw1"}),
        (h3, 2, False, h3b, f32, "fwd", None),
        (h3, 1, False, h3b, f32, "fwd", None),
        (h3, 1, False, h3b, f32, "adj", None),
        (el64, ek, False, elastic_boundary(), f64, "fwd", None),
        (el64, ek // 2, False, elastic_boundary(), f64, "adj", ()),
    ]
    out = []
    for stages, k, periodic, bnd, dt, kind, wanted in plans:
        plan = sc.StagePlan(stages, k, periodic, bnd)
        if kind == "fwd":
            out.append((f"{plan.name}_stage_chain_k{k}_{dt}",
                        generate_stage_source(plan, dt)))
        else:
            out.append((f"{plan.name}_stage_adjoint_k{k}_{dt}",
                        generate_stage_adjoint_source(
                            sa.AdjointStagePlan(plan, wanted), dt)))
    # the march design: every case's kernel (kernel 13 in both forms), the
    # main paths' and the repairs' shapes
    ne, ek, nc, ck = (sizes["elastic"], sizes["elastic_k"], sizes["cavity"],
                      sizes["cavity_k"])
    items = []
    for (_, stages, k, periodic, bnd, _, spatial, dtype, kind, wanted,
         segs) in stage_cases(sizes):
        dt = str(dtype).replace("torch.", "")
        if kind == "segmented":
            items += [(stages, k // segs, periodic, bnd, dt, "fwd", spatial,
                       None),
                      (stages, k // segs, periodic, bnd, dt, wanted, spatial,
                       None)]
        elif kind == "fwd":
            items.append((stages, k, periodic, bnd, dt, "fwd", spatial, None))
        else:
            items += [(stages, k, periodic, bnd, dt, wanted, spatial, f)
                      for f in (None, "gather", "local")]
    ncs = sizes["cavity_small"]
    cav64 = cavity_stages(torch.float64)
    items += [(el, ek, False, elastic_boundary(), "float32", w, (ne, ne),
               None) for w in ("fwd", ())]
    items += [(cav, ck, False, CAVITY_BC, "float32", w, (nc, nc), None)
              for w in ("fwd", {"uw1"})]
    items += [(cav64, ck, False, CAVITY_BC, "float64", w, (ncs, ncs), None)
              for w in ("fwd", {"uw1"})]
    n = sizes["multi"]
    items += [([(multi_carrier_op(), MULTI_CARRY)], 2, False, None, "float32",
               None, (n, n), None),
              (heat_stages(), 2, False, None, "bfloat16", "fwd", (n, n),
               None)]
    seen = set()
    for item in items:
        lib = march_library(*item)
        if lib[1] not in seen:
            seen.add(lib[1])
            out.append(lib)
    return out


# the march libraries of the first build round: (plan, ap, spatial,
# itemsize, forms, float type, source) of each 256-thread library, whose
# registers pick the block size of the second round (march_variants)
MARCH_FIRST = []


def march_library(stages, k, periodic, boundary, dt, wanted, spatial, form):
    """(name, source) of the march library a wrapper builds first for one
    case (256 threads a block): kernel 12 (``wanted`` "fwd") or kernel 13
    with its ``wanted`` fields, in ``form`` or the forms the reckoning
    picks at ``spatial``."""
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc

    plan = sc.StagePlan(stages, k, periodic, boundary)
    ap = None if wanted == "fwd" else sa.AdjointStagePlan(plan, wanted)
    return _march_first(plan, ap, spatial, dt, form)


def chain_march_library(op, carry, spatial, dt, k, periodic, probes=()):
    """(name, source) of the first march library of a chain's two-phase
    route (rows 8 and 11: the chain as a one-stage cycle)."""
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    plan, ap = sm.chain_march_plans(tc.chain_plan(op, k, carry, periodic,
                                                  list(probes)))
    return _march_first(plan, ap, spatial, dt, None)


def _march_first(plan, ap, spatial, dt, form):
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_stage_march_source
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm

    isz = 8 if dt == "float64" else 4
    mg = sm.stage_march_geometry(plan, spatial, isz, ap, form)
    src = generate_stage_march_source(mg, dt)
    MARCH_FIRST.append((plan, ap, tuple(spatial), isz, mg.forms, dt, src))
    tag = f"adjoint_k{plan.k}_{'_'.join(mg.forms)}" if ap else \
        f"chain_k{plan.k}"
    return f"{plan.name}_march_{tag}_t{mg.threads}_{dt}", src


def march_variants():
    """The second build round: each first-round march library's registers
    (read from the card) and the march its reckoning then picks (block
    size, residency, chunk, tile); (name, source) of each not built yet."""
    import ctypes

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_stage_march_source
    from pystencils_autodiff_tpu_torch.codegen.nvcc import compile_and_load
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm

    out, seen = [], set()
    for plan, ap, spatial, isz, forms, dt, src in MARCH_FIRST:
        lib = compile_and_load(src, "march_first")
        lib.psat_march_regs.argtypes = [ctypes.c_int]
        lib.psat_march_regs.restype = ctypes.c_int
        regs = lib.psat_march_regs(0)
        mg = sm.stage_march_geometry(plan, spatial, isz, ap, forms,
                                     regs if regs > 0 else None)
        src2 = generate_stage_march_source(mg, dt)
        if src2 == src:
            continue
        if src2 not in seen:
            seen.add(src2)
            out.append((f"{plan.name}_march_t{mg.threads}_{dt}", src2))
    return out


def ptxas_report(words=("stage", "march")):
    """Registers, stack and spills of each kernel of the built libraries
    whose names hold one of ``words``, from their ``-Xptxas=-v`` logs."""
    from pystencils_autodiff_tpu_torch.codegen.nvcc import build_dir

    out = {}
    for log_path in sorted(build_dir().glob("*.log")):
        if not any(w in log_path.name for w in words):
            continue
        lines = log_path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" not in line:
                continue
            stack = next((x.strip() for x in lines[i + 1:i + 5]
                          if "stack frame" in x), "")
            used = next((x.split(":", 1)[1].strip() for x in lines[i + 1:i + 5]
                         if "Used" in x), "")
            # a march library is one march: several share a name, the
            # hash of the source tells them apart
            name, key = log_path.stem.rsplit("_", 1)
            out[name if name not in out else f"{name} ({key})"] = \
                f"{used}; {stack}"
    return out


def elastic_setup(n, cycles, k, dev, dtype, seed=21):
    """BASELINE config #4's elastic P-SV pair at n²: 16 cycles of
    ``fused_stage_chain(elastic pair, k, fused_bwd=True)`` with a Cerjan
    sponge on all five fields.  The observation is the final vx from a
    seeded initial state (an explosive source in the stresses and a
    random velocity field, made on the CPU); the inversion starts from the
    zero state.  Returns the start, ``value_and_grad(x)`` (the MSE of the
    final vx and its gradient with respect to the five initial fields)
    and ``final(x)``."""
    import torch

    from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain

    chain = fused_stage_chain(elastic_chain_stages(dtype), k, fused_bwd=True,
                              boundary=elastic_boundary())
    damp = cerjan_damping((n, n), width=FULL["sponge_width"], dtype=dtype,
                          device=dev)
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=dtype),
                            torch.arange(n, dtype=dtype), indexing="ij")
    src = torch.exp(-((yy - n / 3) ** 2 + (xx - n / 2) ** 2) / 50.0)
    true = {nm: 0.1 * torch.randn((n, n), generator=gen, dtype=dtype)
            for nm in ELASTIC_FIELDS}
    true["sxx"] = true["sxx"] + src
    true["syy"] = true["syy"] + src
    true = {nm: t.to(dev) for nm, t in true.items()}

    def final(x):
        st = {**x, "damp": damp}
        for _ in range(cycles // k):
            st = chain(st)
        return st["vx"]

    with torch.no_grad():
        observed = final(true)

    def value_and_grad(x):
        ins = {nm: t.detach().requires_grad_() for nm, t in x.items()}
        loss = torch.mean((final(ins) - observed) ** 2)
        grads = torch.autograd.grad(loss, [ins[nm] for nm in ELASTIC_FIELDS])
        return loss, dict(zip(ELASTIC_FIELDS, grads))

    start = {nm: torch.zeros((n, n), dtype=dtype, device=dev)
             for nm in ELASTIC_FIELDS}
    return start, value_and_grad, final, observed


def elastic_descent(n, cycles, k, iters, dev, dtype, counted):
    """``iters`` steepest-descent steps on the five initial fields with an
    exact line search (the map is linear: one extra forward run of the
    gradient); each gradient is run through ``counted`` and must launch
    kernel 12 and kernel 13 cycles/k times each and nothing else.
    Returns the loss before each step and after the last, the gradients'
    host-clock ms and the launches."""
    import torch

    x, value_and_grad, final, observed = elastic_setup(n, cycles, k, dev,
                                                      dtype)
    want = {("stage_chain", 2): cycles // k, ("stage_adjoint", 2): cycles // k}
    losses, ms, total = [], [], {}
    for _ in range(iters):
        (loss, g), got, sec = counted(lambda: value_and_grad(x))
        losses.append(loss.item())
        ms.append(sec * 1e3)
        if {key: v for key, v in got.items() if v} != want:
            raise AssertionError(f"elastic: one gradient launched {got}, "
                                 f"expected exactly {want}")
        for key, v in got.items():
            total[key] = total.get(key, 0) + v
        with torch.no_grad():
            r = final(x) - observed
            fg = final(g)  # the linear map applied to the gradient
            a = (r * fg).sum() / (fg * fg).sum()
            x = {nm: x[nm] - a * g[nm] for nm in x}
    losses.append(value_and_grad(x)[0].item())
    return losses, ms, total


def cavity_setup(n, steps, k, dev, dtype, seed=31):
    """The lid-driven cavity inverse problem at n², D2Q9 BGK (ω = 1.7,
    SoA): ``fused_stage_chain`` with bounce-back walls (the frame) and a
    moving lid (``uw1 = lid_mask · u_lid``), ``steps`` steps per loss; the
    loss is the MSE of the fluid velocity against the one observed at
    u_lid = 0.1.  Returns ``value_and_grad(u_lid) -> (loss, d/d u_lid)``
    and the chain."""
    import torch

    from pystencils_autodiff_tpu_torch.models import macroscopic
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain

    chain = fused_stage_chain(cavity_stages(dtype), k, fused_bwd=True,
                              boundary=CAVITY_BC)
    gen = torch.Generator().manual_seed(seed)
    w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=dtype)
    f0 = (w[:, None, None] * (1.0 + 1e-3 * torch.randn(
        (9, n, n), generator=gen, dtype=dtype))).to(dev)
    solid = torch.zeros((n, n), dtype=dtype, device=dev)
    solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = 1.0
    lid = torch.zeros((n, n), dtype=dtype, device=dev)
    lid[0, :] = 1.0
    fluid = 1.0 - solid
    zeros = torch.zeros_like(lid)
    w_dev = w.to(dev)

    def velocity(u_lid):
        st = {"f": f0, "solid": solid, "uw0": zeros, "uw1": lid * u_lid}
        for _ in range(steps // k):
            st = chain(st)
        # the stage leaves the wall cells at 0: give them the rest state
        # there, so that ρ stays 1 and the division finite in both passes
        _, ux, uy = macroscopic(st["f"] + solid * w_dev[:, None, None],
                                layout="soa")
        return ux * fluid, uy * fluid

    with torch.no_grad():
        ox, oy = velocity(torch.tensor(0.1, dtype=dtype, device=dev))

    def value_and_grad(u_lid):
        u = torch.as_tensor(u_lid, dtype=dtype, device=dev).detach()
        u.requires_grad_()
        ux, uy = velocity(u)
        loss = torch.mean((ux - ox) ** 2 + (uy - oy) ** 2)
        (g,) = torch.autograd.grad(loss, u)
        return loss, g

    return value_and_grad, chain


def cavity_descent(n, steps, k, iters, dev, dtype, counted, want):
    """``iters`` descent steps on u_lid from 0.05 (u ← u − L/L′: half-way to
    the minimum of a quadratic loss); each gradient through ``counted``
    must make exactly the launches ``want``.  Returns the losses, u_lid,
    the gradients' host-clock ms and the launches."""
    value_and_grad, _ = cavity_setup(n, steps, k, dev, dtype)
    u, losses, us, ms, total = 0.05, [], [0.05], [], {}
    for _ in range(iters):
        (loss, g), got, sec = counted(lambda: value_and_grad(u))
        losses.append(loss.item())
        ms.append(sec * 1e3)
        if {key: v for key, v in got.items() if v} != want:
            raise AssertionError(f"cavity: one gradient launched {got}, "
                                 f"expected exactly {want}")
        for key, v in got.items():
            total[key] = total.get(key, 0) + v
        u = u - loss.item() / g.item()
        us.append(u)
    losses.append(value_and_grad(u)[0].item())
    return losses, us, ms, total


def aniso_value_and_grad(n, steps, k, dev, seed=41):
    """Config #4's other half: ``anisotropic27_op()`` (u ← ∇·(A∇u), 27
    points) through ``fused_time_chain(..., periodic=True, fused_bwd=True)``
    at n³ f32, ``steps`` steps, the gradient of the final field's mean
    square with respect to the initial field (the twin route: two 3D
    forward chains per call in the backward)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import anisotropic27_op
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    chain = fused_time_chain(anisotropic27_op(), k, {"u": "y"},
                             periodic=True, fused_bwd=True)
    gen = torch.Generator().manual_seed(seed)
    u0 = (1e-3 * torch.randn((n,) * 3, generator=gen)).to(dev)

    def run():
        u = u0.detach().requires_grad_()
        st = {"u": u}
        for _ in range(steps // k):
            st = chain(st)
        loss = torch.mean(st["u"] ** 2)
        (g,) = torch.autograd.grad(loss, u)
        return loss, g

    return run


def aniso_design_turns(n, steps, k, dev, loss, grad):
    """aniso27's value+gradient (``aniso_value_and_grad``) with its 3D
    forward chains in the design ``forward_design`` picks (the march) and
    in the box (PR 9's design, forced through ``time_chain.
    forward_design`` while the run picks its designs), each held against
    ``loss`` and ``grad`` (rtol 1e-5), then timed on the host clock in
    turns (march, box, box, march).  Returns {design: [ms, ms]}."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    runs, picked = {}, tc.forward_design
    for d in ("march", "box"):
        run = aniso_value_and_grad(n, steps, k, dev)
        tc.forward_design = lambda *a, d=d: d
        try:
            got_l, got_g = run()  # picks (and caches) the design
        finally:
            tc.forward_design = picked
        err_l = abs(got_l.item() - loss.item()) / abs(loss.item())
        err_g = ((got_g - grad).abs().max() / grad.abs().max()).item()
        if not (err_l <= 1e-5 and err_g <= 1e-5):
            raise AssertionError(f"aniso27 with the {d} design: loss rel "
                                 f"{err_l:.2e}, gradient rel {err_g:.2e}")
        runs[d] = run
    times = {d: [] for d in runs}
    for d in ("march", "box", "box", "march"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runs[d]()
        torch.cuda.synchronize()
        times[d].append((time.perf_counter() - t) * 1e3)
    return times


# ---------------------------------------------------------------------------
# The z-streaming kernel (two-phase and forward modes) and path C.

def nl3d_op(dtype="float32"):
    """A 3D op nonlinear in its state, u' = u + 0.1·(u[1,0,0]·u − u[0,0,-1]):
    the twin decompositions reject it, so its fused value+gradient is the
    streaming two-phase kernel."""
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field

    u, out = Field("u", 3, dtype=dtype), Field("u_next", 3, dtype=dtype)
    return AutoDiffOp([Assignment(out.center, u.center + 0.1 * (
        u.neighbor(0, 1) * u.center - u.neighbor(2, -1)))], op_name="nl3d")


def multi_carrier_op(dtype="float32"):
    """u_next = u·u[1,0] + 0.1·v carried into both u and v: kernel 8 reads
    the output's cotangent as the sum of two carriers'."""
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, Field

    u, v = Field("u", 2, dtype=dtype), Field("v", 2, dtype=dtype)
    out = Field("u_next", 2, dtype=dtype)
    return AutoDiffOp([Assignment(out.center, u[0, 0] * u[1, 0]
                                  + 0.1 * v[0, 0])], op_name="multi_carrier")


def lbm3d_op(dtype):
    from pystencils_autodiff_tpu_torch.models import d3q19_bgk_op

    return d3q19_bgk_op(omega=LBM_OMEGA, dtype=str(dtype).replace(
        "torch.", ""), layout="soa")


def forward_sources(sizes):
    """(name, source) of the 3D forward chains' libraries (row 7): the
    first march library of every case and main-path shape (the second
    round follows from its registers, ``march_variants``), and the box and
    streaming libraries the cases time in turns with it."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_chain_source, generate_plane_source)
    from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                      diffusion3d_op,
                                                      heat_step3d_op)
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops import transposed_linear_op

    f32, f64, bf16 = "float32", "float64", "bfloat16"
    n3, n64, k = (sizes["cube"],) * 3, (sizes["cube_f64"],) * 3, \
        sizes["cfg2_k"]
    diff3d, heat3d = diffusion3d_op(dt=DIFF_DT), heat_step3d_op()
    np3 = sizes["probe3d"]
    aniso = anisotropic27_op()
    a_cot, a_carry, _, _ = transposed_linear_op(aniso, {"u": "y"})
    lk, kd = sizes["lbm_k"], sizes["lbm_k_deep"]
    lbm32, lbm64 = lbm3d_op(torch.float32), lbm3d_op(torch.float64)
    na = (sizes["aniso"],) * 3
    # (op, carry, k, periodic, probes, spatial, float type, every design: a
    # case timed in turns, or the picked one: a main path's shape)
    cases = [(diff3d, HEAT_CARRY, k, False, [], n3, f32, True),
             (diff3d, HEAT_CARRY, k, True, [], n3, f32, True),
             (diff3d, HEAT_CARRY, k, False, [], n64, f64, True),
             (diff3d, HEAT_CARRY, k, False, [], n3, bf16, True),
             (heat3d, HEAT_CARRY, k, False, [], n3, f32, True),
             (nl3d_op(), {"u": "u_next"}, k, False, probe3d_lines(np3),
              (np3,) * 3, f32, True),
             (lbm32, LBM_CARRY, lk, True, [], (sizes["lbm"],) * 3, f32,
              True),
             (lbm32, LBM_CARRY, kd, True, [], (sizes["lbm"],) * 3, f32,
              True),
             (lbm64, LBM_CARRY, lk, True, [], (sizes["lbm_f64"],) * 3, f64,
              True),
             (aniso, {"u": "y"}, k, True, [], na, f32, True),
             (diff3d, HEAT_CARRY, k, False, [], (sizes["cfg2_small"],) * 3,
              f64, False),
             (lbm64, LBM_CARRY, lk, True, [], (sizes["lbm_small"],) * 3, f64,
              False),
             (a_cot, a_carry, k, True, [], na, f32, True)]
    out, seen = [], set()
    for op, carry, depth, periodic, probes, spatial, dt, every in cases:
        plan = tc.chain_plan(op, depth, carry, periodic, probes)
        isz = 8 if dt == f64 else 4
        picked = tc.forward_design(plan, spatial, isz)
        fits = tc.fitting_designs(plan, spatial, isz)
        items = []
        if (every or picked == "march") and "march" in fits:
            items.append(_march_first(sm.chain_stage_plan(plan), None,
                                      spatial, dt, None))
        if (every or picked == "box") and "box" in fits:
            items.append((f"{plan.program.name}_chain_{dt}",
                          generate_chain_source(plan, dt)))
        if (every or picked == "stream") and "stream" in fits:
            items.append((f"{plan.program.name}_plane_forward_{dt}",
                          generate_plane_source(plan, "forward", dt)))
        for name, src in items:
            if src not in seen:
                seen.add(src)
                out.append((name, src))
    return out


def probe3d_lines(n):
    """The two probe lines of the nl3d case at n³: (n/4, n/3) and (3n/4,
    2n/3), as flattened rows."""
    return [("u", (n // 4) * n + n // 3), ("u", (3 * n // 4) * n
                                           + 2 * n // 3)]


def plane_sources(sizes):
    """(name, source) of the streaming libraries, the multi-carrier kernel 8
    and the single steps the cases' k-step references launch."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_adjoint_source, generate_plane_source)
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    out = []
    k = sizes["lbm_k"]
    lbm = lbm3d_op(torch.float32)
    for op, carry, periodic, dtypes, modes in (
            (lbm, LBM_CARRY, True, ("float32", "float64"),
             ("two_phase", "forward")),
            (nl3d_op(), {"u": "u_next"}, False, ("float32",), ("two_phase",)),
            (nl3d_op(), {"u": "u_next"}, True, ("float32",), ("two_phase",))):
        plan = tc.chain_plan(op, k, carry, periodic)
        for dt in dtypes:
            for mode in modes:
                src = (ac.AdjointPlan(plan) if mode == "two_phase" else plan)
                for form in (("gather", "local") if mode == "two_phase"
                             else ("gather",)):
                    out.append((f"{plan.program.name}_plane_{mode}_"
                                f"{'periodic' if periodic else 'bounded'}_"
                                f"{form}_{dt}",
                                generate_plane_source(src, mode, dt, form)))
    # the single steps of the k-step references, in the modes and float
    # types they run; D3Q19's backward (1,687 steps) in its one periodic
    # float32 variant, whose build time PERF.md records
    lbm, nl = lbm3d_op(torch.float32), nl3d_op()
    out += [s for s in step_sources([forward_program(lbm)])
            if "_periodic_" in s[0]]
    out += [s for s in step_sources([backward_program(lbm)],
                                    dtypes=("float32",))
            if "_periodic_" in s[0]]
    out += step_sources([forward_program(nl), backward_program(nl)],
                        dtypes=("float32",))
    multi = multi_carrier_op()
    mplan = tc.chain_plan(multi, k, MULTI_CARRY, False)
    out.append((f"{mplan.program.name}_adjoint_chain",
                generate_adjoint_source(ac.AdjointPlan(mplan))))
    out += step_sources([forward_program(multi), backward_program(multi)],
                        dtypes=("float32",), periodic=False)
    # the streaming forward mode of nl3d (3D probe lines)
    out.append(("nl3d_plane_forward_bounded_float32",
                generate_plane_source(tc.chain_plan(nl, k, {"u": "u_next"},
                                                    False),
                                      "forward", "float32")))
    return out


def plane_cases(sizes):
    """The kernel-vs-plain cases of the streaming kernel and of kernel 8 on
    a multi-carrier op; the first case of each mode is path C's call.  The
    float32 D3Q19 two-phase case is timed beside its k single steps (one
    library, periodic float32, of the 1,687-step backward body); the
    float64 one without them."""
    import torch

    f32, f64 = torch.float32, torch.float64
    nl, nb, nbd, k = (sizes["nl3d"], sizes["lbm"], sizes["lbm_f64"],
                      sizes["lbm_k"])
    uc = {"u": "u_next"}
    # (name, op, carry, spatial, dtype, k, periodic, probes, kernel[,
    #  time the k single steps[, both two-phase forms in turns]])
    return [
        ("d3q19 two-phase k2 periodic f32", lbm3d_op(f32), LBM_CARRY,
         (nb,) * 3, f32, k, True, [], "plane_two_phase", True, True),
        ("d3q19 two-phase k2 periodic f64", lbm3d_op(f64), LBM_CARRY,
         (nbd,) * 3, f64, k, True, [], "plane_two_phase", False, True),
        ("nl3d two-phase k2 bounded f32", nl3d_op(), uc, (nl,) * 3, f32, k,
         False, [], "plane_two_phase", True, True),
        ("nl3d two-phase k2 periodic f32", nl3d_op(), uc, (nl,) * 3, f32, k,
         True, [], "plane_two_phase", True, True),
        ("multi-carrier two-phase k2 bounded f32", multi_carrier_op(),
         MULTI_CARRY, (sizes["multi"],) * 2, f32, k, False, [],
         "adjoint_chain"),
    ]


def taylor_green(n, u0, dtype, dev):
    """The D3Q19 equilibrium f = feq(ρ=1, u) of the Taylor–Green vortex on
    a periodic n³ box, SoA (19, n, n, n): u = U0·(sin x cos y cos z,
    −cos x sin y cos z, 0), x = 2π·i/n along dim 0 (y, z along dims 1,
    2), feq_i = w_i ρ (1 + 3 c_i·u + 4.5 (c_i·u)² − 1.5 u²).  ``u0`` may be
    a tensor that requires a gradient."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (D3Q19_VELOCITIES,
                                                      D3Q19_WEIGHTS)

    x = 2 * math.pi * torch.arange(n, dtype=dtype, device=dev) / n
    sx, cx = torch.sin(x), torch.cos(x)
    ux = u0 * sx[:, None, None] * cx[None, :, None] * cx[None, None, :]
    uy = -u0 * cx[:, None, None] * sx[None, :, None] * cx[None, None, :]
    usq = ux * ux + uy * uy
    planes = []
    for (c0, c1, _), w in zip(D3Q19_VELOCITIES, D3Q19_WEIGHTS):
        cu = c0 * ux + c1 * uy
        planes.append(float(w) * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * usq))
    return torch.stack(planes)


def path_c_setup(n, steps, k, dev, dtype, chain=None):
    """Path C, the differentiable D3Q19 BGK Taylor–Green vortex at n³
    (ω = 1.7, SoA, periodic): ``steps`` steps through
    ``fused_time_chain(d3q19_bgk_op(...), k, {"f": "f_out"},
    periodic=True, fused_bwd=True)`` (or ``chain``, the same chain
    sharded) from feq(ρ=1, u(U0)); the loss is the MSE of the final
    velocity (``macroscopic``) against the one observed at U0 = 0.05.
    Returns ``value_and_grad(U0) -> (loss, d/dU0)``."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (D3Q19_VELOCITIES,
                                                      macroscopic)
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain

    chain = chain or fused_time_chain(lbm3d_op(dtype), k, LBM_CARRY,
                                      periodic=True, fused_bwd=True)

    def velocity(u0):
        st = {"f": taylor_green(n, u0, dtype, dev)}
        for _ in range(steps // k):
            st = chain(st)
        _, *u = macroscopic(st["f"], "soa", D3Q19_VELOCITIES)
        return u

    with torch.no_grad():
        observed = velocity(torch.tensor(TG_TARGET, dtype=dtype, device=dev))

    def value_and_grad(u0):
        u = torch.as_tensor(u0, dtype=dtype, device=dev).detach()
        u.requires_grad_()
        loss = sum(torch.mean((a - b) ** 2)
                   for a, b in zip(velocity(u), observed)) / 3
        (g,) = torch.autograd.grad(loss, u)
        return loss, g

    return value_and_grad


def forward_key(plan, spatial, itemsize):
    """The launch-count key of a 3D forward chain at a shape: the march and
    the box count as ("time_chain", 3), the streaming kernel as
    ("plane_forward", 3) (``time_chain.forward_design``)."""
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    return (("plane_forward", 3)
            if tc.forward_design(plan, spatial, itemsize) == "stream"
            else ("time_chain", 3))


BOUNCE_3D = {"f": ("bounce_back", "solid", ("uw0", "uw1", "uw2"))}


def ladder_key(design, nd=3):
    """The launch-count key of a forward chain rung's design."""
    return ("plane_forward", nd) if design == "stream" else ("time_chain", nd)


def ladder_sources(sizes):
    """(name, source) of the libraries of the ladder phase (Queue 3 #1's
    shapes): each rung's forward chain (the first-round march library,
    or the streaming forward mode) at the depth ``forward_route`` picks,
    the checkpoints' chain at the segments' depth, the streaming two-phase
    mode at that depth, kernel 12 of the bounce-back stage chain at its
    rung and the D3Q19 single steps in float64 (the sequential rungs)."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_plane_source
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    out = []
    shape, k = (sizes["ladder"],) * 3, sizes["ladder_k"]
    for dtype in (torch.float32, torch.float64):
        dt, isz = str(dtype)[6:], dtype.itemsize
        plan = tc.chain_plan(lbm3d_op(dtype), k, LBM_CARRY, True)
        m = ac.fused_segments(plan, shape, isz)
        depths = {tc.forward_route(plan, shape, isz)} | {
            tc.forward_route(tc.plan_at_depth(plan, k // m), shape, isz)}
        for design, kk in depths:
            p = tc.plan_at_depth(plan, kk)
            if design == "march":
                out.append(_march_first(sm.chain_stage_plan(p), None, shape,
                                        dt, None))
            elif design == "stream":
                out.append((f"{p.program.name}_plane_forward_k{kk}_{dt}",
                            generate_plane_source(p, "forward", dt)))
        ap = ac.AdjointPlan(tc.plan_at_depth(plan, k // m))
        for form in ("gather", "local"):
            out.append((f"{plan.program.name}_plane_two_phase_k{k // m}_"
                        f"{form}_{dt}",
                        generate_plane_source(ap, "two_phase", dt, form)))
    op64 = lbm3d_op(torch.float64)
    stages, sn = [(op64, LBM_CARRY)], (sizes["ladder_stage"],) * 3
    splan = sc.StagePlan(stages, sizes["ladder_stage_k"], False, BOUNCE_3D)
    kk = sc.stage_route(splan, sn, 8)
    if kk is not None:
        out.append(_march_first(sc.stage_plan_at_depth(splan, kk), None, sn,
                                "float64", None))
    out += step_sources([forward_program(op64), backward_program(op64)],
                        dtypes=("float64",), periodic=False,
                        forms=("window",), spatial=sn)
    return out


def _held(name, got, ref, rtol, scale=1.0):
    """``got`` against ``ref`` (lists of tensors): finite, within rtol·scale
    of max |ref| plus rtol·scale of |ref|; the largest error."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not bool(g.isfinite().all()):
            raise AssertionError(f"{name}: output {i} has shape "
                                 f"{tuple(g.shape)} vs {tuple(r.shape)} or "
                                 f"is not finite")
        tol = rtol * scale
        diff = (g - r).abs()
        e = diff.max().item()
        err = max(err, e)
        if (diff > tol * r.abs().max().item() + tol * r.abs()).any():
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version by {e:.3e} (max |ref| "
                                 f"{r.abs().max().item():.3e}, rtol {tol:g})")
    return err


def ladder_phase(sizes, dev, gen, counted):
    """Queue 3 #1's shapes, where no fused design fits at the chain's
    depth: D3Q19 BGK periodic k=8 at 128³ in float32 and float64, forward
    (k/kk launches of the deepest chain that fits, ``forward_route``) and
    value+gradient (``fused_chain_vjp``: m segments, each segment's
    checkpoint through the forward rung at depth k/m, m launches of the
    streaming two-phase mode), and the D3Q19 stage chain with bounce-back
    walls in float64 at 64³, k=2, value+gradient through
    ``fused_stage_chain(fused_bwd=True)`` (kernel 12 on its rung; kernel
    13 fits at no depth, so the backward is the sequential-recompute rung:
    k recomputed single steps and k backward single steps).  Each asserts
    its exact launch counts (from the reckonings) and holds against its
    plain version on the card (the cotangents to 10× the tolerance, sums
    of k backward steps)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import fused_stage_chain
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    out = []
    shape, k = (sizes["ladder"],) * 3, sizes["ladder_k"]
    for dtype in (torch.float32, torch.float64):
        dt, isz = str(dtype)[6:], dtype.itemsize
        rtol = TOL[dt]
        op = lbm3d_op(dtype)
        plan = tc.chain_plan(op, k, LBM_CARRY, True)
        state = random_inputs(plan.program, shape, dtype, gen, dev)
        design, kk = tc.forward_route(plan, shape, isz)
        fwd = tc.make_chain_kernel(plan)
        (res, got_n, sec) = counted(lambda: fwd(state), tally=False)
        want = {ladder_key(design): k // kk}
        if {key: n for key, n in got_n.items() if n} != want:
            raise AssertionError(f"ladder D3Q19 k={k} {dt}: forward launches "
                                 f"{got_n}, expected {want}")
        err = _held(f"ladder D3Q19 k={k} {dt} forward", _flat(res),
                    _flat(tc.plain_time_chain(plan)(state)), rtol)
        fms = cuda_ms(lambda: fwd(state))
        log(f"  D3Q19 k={k} {shape[0]}³ {dt} forward: rung ({design}, "
            f"kk={kk}), {k // kk} launches {want}; max |err| {err:.2e}; "
            f"{fms:.3f} ms")
        out.append({"case": f"ladder d3q19 k{k} {dt} forward", "rung":
                    [design, kk], "launches": k // kk, "ms": fms,
                    "max_abs_err": err})
        del res
        g = ac.fused_chain_vjp(op, k, LBM_CARRY, periodic=True)
        cots = {"f": torch.randn(state["f"].shape, generator=gen,
                                 dtype=dtype, device=dev)}
        (res, got_n, sec) = counted(lambda: g(state, cots), tally=False)
        m = g.segments
        cdesign, ckk = tc.forward_route(tc.plan_at_depth(plan, k // m),
                                        shape, isz)
        want = {("plane_two_phase", 3): m}
        if m > 1:
            ck_key = ladder_key(cdesign)
            want[ck_key] = want.get(ck_key, 0) + (m - 1) * (k // m // ckk)
        if {key: n for key, n in got_n.items() if n} != want:
            raise AssertionError(f"ladder D3Q19 k={k} {dt}: value+gradient "
                                 f"launches {got_n}, expected {want}")
        ref = ac.plain_chain_vjp(ac.AdjointPlan(plan))(state, cots)
        err = max(_held(f"ladder D3Q19 k={k} {dt} state", [res[0]["f"]],
                        [ref[0]["f"]], rtol),
                  _held(f"ladder D3Q19 k={k} {dt} cotangent", [res[1]["f"]],
                        [ref[1]["f"]], rtol, 10.0))
        del res, ref
        gms = cuda_ms(lambda: g(state, cots))
        log(f"  D3Q19 k={k} {shape[0]}³ {dt} value+gradient: {m} segments "
            f"of depth {k // m} (checkpoints: ({cdesign}, kk={ckk})), "
            f"launches {want}; max |err| {err:.2e}; {gms:.3f} ms")
        out.append({"case": f"ladder d3q19 k{k} {dt} value+gradient",
                    "segments": m, "launches": want and {
                        f"{a}/{b}D": n for (a, b), n in want.items()},
                    "ms": gms, "max_abs_err": err})
        del state, cots, g, fwd
        torch.cuda.empty_cache()
    f64 = torch.float64
    sn, sk = (sizes["ladder_stage"],) * 3, sizes["ladder_stage_k"]
    stages = [(lbm3d_op(f64), LBM_CARRY)]
    splan = sc.StagePlan(stages, sk, False, BOUNCE_3D)
    n = sn[0]
    w = torch.tensor([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, dtype=f64,
                     device=dev)
    f0 = w[:, None, None, None] * (1 + 0.01 * torch.randn(
        (19,) + sn, generator=gen, dtype=f64, device=dev))
    solid = torch.zeros(sn, dtype=f64, device=dev)
    for d in range(3):
        solid.select(d, 0).fill_(1.0)
        solid.select(d, n - 1).fill_(1.0)
    lid = torch.zeros(sn, dtype=f64, device=dev)
    lid[0] = 0.05
    fixed = {"solid": solid, "uw0": torch.zeros_like(lid), "uw1": lid,
             "uw2": torch.zeros_like(lid)}
    cot = torch.randn(f0.shape, generator=gen, dtype=f64, device=dev)

    def value_and_grad(chain):
        f = f0.clone().requires_grad_()
        st = chain({"f": f, **fixed})
        loss = (st["f"] * cot).sum()
        return loss.detach(), torch.autograd.grad(loss, [f])[0]

    chain = fused_stage_chain(stages, sk, boundary=BOUNCE_3D, fused_bwd=True)
    ((val, grad), got_n, sec) = counted(lambda: value_and_grad(chain),
                                        tally=False)
    kk = sc.stage_route(splan, sn, 8)
    want = {("stage_chain", 3): sk // kk, ("stencil_step", 3): 2 * sk}
    if {key: v for key, v in got_n.items() if v} != want:
        raise AssertionError(f"ladder stage chain: launches {got_n}, "
                             f"expected {want}")

    def plain_vg():
        f = f0.clone().requires_grad_()
        st = sc.plain_stage_chain(splan)({"f": f, **fixed})
        loss = (st["f"] * cot).sum()
        return loss.detach(), torch.autograd.grad(loss, [f])[0]

    rval, rgrad = plain_vg()
    err = _held("ladder stage chain", [val.reshape(1), grad],
                [rval.reshape(1), rgrad], TOL["float64"])
    log(f"  D3Q19 bounce-back stage chain {n}³ f64 k={sk} value+gradient: "
        f"kernel 12 at depth {kk} ({sk // kk} launches), the adjoint on the "
        f"sequential-recompute rung ({2 * sk} single steps); launches "
        f"{want}; max |err| {err:.2e} ({sec * 1e3:.1f} ms host clock, the "
        f"first call)")
    out.append({"case": f"ladder d3q19 bounce-back stage k{sk} f64 "
                        f"value+gradient", "launches": {
                            f"{a}/{b}D": v for (a, b), v in want.items()},
                "max_abs_err": err})
    return out


def path_c_descent(n, steps, k, iters, dev, dtype, counted):
    """``iters`` descent steps on U0 from 0.03 (U0 ← U0 − L/L′: half-way to
    the minimum of a quadratic loss); each gradient through ``counted``
    must launch the forward chain (in the design its reckoning picks: the
    march at 256³ f32) and the streaming two-phase mode steps/k times each
    and no other chain kernel.  Returns the losses, the U0s, the
    gradients' host-clock ms and the launches."""
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    value_and_grad = path_c_setup(n, steps, k, dev, dtype)
    fwd = forward_key(tc.chain_plan(lbm3d_op(dtype), k, LBM_CARRY, True),
                      (n,) * 3, dtype.itemsize)
    want = {fwd: steps // k, ("plane_two_phase", 3): steps // k}
    u, losses, us, ms, total = TG_U0, [], [TG_U0], [], {}
    for _ in range(iters):
        (loss, g), got, sec = counted(lambda: value_and_grad(u))
        losses.append(loss.item())
        ms.append(sec * 1e3)
        if {key: v for key, v in got.items() if v} != want:
            raise AssertionError(f"path C: one gradient launched {got}, "
                                 f"expected exactly {want}")
        for key, v in got.items():
            total[key] = total.get(key, 0) + v
        u = u - loss.item() / g.item()
        us.append(u)
    losses.append(value_and_grad(u)[0].item())
    return losses, us, ms, total


# ---------------------------------------------------------------------------
# The app-assembly layer: config #4 through the recorded call graph.

def app_ops():
    """The ops the app phase runs: the elastic pair (f32) and a
    ``Simulation`` of it (its ``fused_op`` is one op a cycle), burgers2d
    and laplacian3d (f32)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (burgers2d_op,
                                                      laplacian3d_op)
    from pystencils_autodiff_tpu_torch.simulation import Simulation

    pair = elastic_chain_stages(torch.float32)
    sim = Simulation()
    for op, carry in pair:
        sim.add_sweep(op, carry)
    return pair, sim, burgers2d_op(dtype="float32"), laplacian3d_op()


def app_sources(sizes):
    """(name, source) of the single-step libraries the app phase adds: the
    elastic pair's forward and backward programs (the replay), the fused
    step's forward, burgers2d's and laplacian3d's forward and full-domain
    backward (the kernel pairs).  The recorded graph's stage chain is
    config #4's own: its march libraries are ``stage_sources``'."""
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)

    pair, sim, burgers, lap3d = app_ops()
    progs = [p for op, _ in pair
             for p in (forward_program(op), backward_program(op))]
    progs += [forward_program(sim.fused_op("elastic_fused"))]
    progs += [p for op in (burgers, lap3d)
              for p in (forward_program(op), backward_program(op))]
    return step_sources(progs, dtypes=("float32",), periodic=False)


def record_config4(ne, pair, dev):
    """BASELINE config #4 recorded with ``GraphDataHandling((ne - 2, ne -
    2), ghost_layers=1)`` (ne² f32 tensors, the elastic pair's ghost 1):
    the timeloop ``boundary(sponge on the five fields, elastic_setup's one
    Cerjan profile)``, the velocity sweep, the stress sweep."""
    import torch

    from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
    from pystencils_autodiff_tpu_torch.graph_datahandling import \
        GraphDataHandling
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.ops import forward_program

    f32 = torch.float32
    ghosts = {op.op_name: forward_program(op).ghost for op, _ in pair}
    if any(g != ((1, 1), (1, 1)) for g in ghosts.values()):
        raise AssertionError(f"elastic pair's ghost is not 1: {ghosts}")
    dh = GraphDataHandling((ne - 2, ne - 2), ghost_layers=1,
                           default_dtype=f32, device=dev)
    for nm in ELASTIC_FIELDS:
        dh.add_field(nm)
    if dh.shape_with_ghost != (ne, ne):
        raise AssertionError(f"graph tensors {dh.shape_with_ghost}, "
                             f"expected {(ne, ne)}")
    damp = cerjan_damping((ne, ne), width=FULL["sponge_width"], dtype=f32,
                          device=dev)
    with dh.timeloop() as loop:
        loop.boundary({nm: ("sponge", damp) for nm in ELASTIC_FIELDS})
        for op, carry in pair:
            loop.sweep(op, carry)
    return dh


def app_phase(sizes, dev, counted):
    """BASELINE config #4's elastic gradient through the app-assembly
    layer, at 8192² float32:

    - ``GraphDataHandling((8190, 8190), ghost_layers=1)`` (8192² tensors,
      the elastic pair's ghost 1) records the timeloop ``boundary(sponge
      on the five fields, one Cerjan profile)``, the velocity sweep, the
      stress sweep; ``compile(fuse="stages", k=4, fused_bwd=True)`` runs
      16 cycles from ``elastic_setup``'s start to its MSE loss: exactly 4
      launches of kernel 12 and 4 of kernel 13 a gradient, loss and
      gradients equal to ``elastic_setup``'s direct chain (the same
      emitted bodies), both timed in turns with the host clock (graph,
      direct, direct, graph; 3 gradients a turn);
    - the same graph through ``compile()`` (replay: the sponge out of
      place, each sweep the window single step) from a seeded state: its
      launches reckoned from the programs (2 forward a cycle, each op's
      backward programs) and its value and gradients held against
      ``fuse="stages"``'s;
    - ``Simulation.fused_op()`` of the pair (``compose_ops``): one
      single-step launch a cycle, held against the unfused ``step_fn`` on
      the cells ``[2:-2, 2:-2]``, both timed;
    - burgers2d at 8192² and laplacian3d at 384³ through
      ``AutoDiffKernelPair``: forward and full-domain backward once
      (counted), then each kernel held against its plain version
      (``check_and_time``).

    Returns (kernel-vs-plain records, single-step launches by Pallas
    counterpart)."""
    import torch

    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import (backward_programs,
                                                   forward_program,
                                                   make_torch_stencil)

    t_phase = time.perf_counter()
    f32 = torch.float32
    ne, ec, ek = sizes["elastic"], sizes["elastic_cycles"], sizes["elastic_k"]
    pair, sim, burgers, lap3d = app_ops()
    fused = sim.fused_op("elastic_fused")
    programs = {p.name: p for op in [o for o, _ in pair] + [fused, burgers,
                                                             lap3d]
                for p in [forward_program(op)] + backward_programs(op)}
    cp_launches: dict = {}

    def tally_counterparts():
        for cp, n in launches_by_counterpart(ck.LAUNCH_CALLS,
                                             programs).items():
            cp_launches[cp] = cp_launches.get(cp, 0) + n

    def only(got):
        return {key: v for key, v in got.items() if v}

    # -- the recorded graph ---------------------------------------------
    dh = record_config4(ne, pair, dev)
    log("  recorded program:\n    "
        + dh.graph.describe().replace("\n", "\n    "))
    run_s = dh.compile(fuse="stages", k=ek, fused_bwd=True)
    synthetic = [n for n in run_s.chain.input_names
                 if n not in ELASTIC_FIELDS]
    if synthetic != ["_bc_arr0"]:
        raise AssertionError(f"graph chain inputs {run_s.chain.input_names}: "
                             f"the damping profile is not one plane")
    x, direct_vg, _, observed = elastic_setup(ne, ec, ek, dev, f32)

    def graph_vg(xx):
        ins = {nm: t.detach().requires_grad_() for nm, t in xx.items()}
        loss = torch.mean((run_s(ins, ec)["vx"] - observed) ** 2)
        grads = torch.autograd.grad(loss, [ins[nm] for nm in ELASTIC_FIELDS])
        return loss, dict(zip(ELASTIC_FIELDS, grads))

    want = {("stage_chain", 2): ec // ek, ("stage_adjoint", 2): ec // ek}
    (g_loss, g_grads), g_n, _ = counted(lambda: graph_vg(x))
    if only(g_n) != want:
        raise AssertionError(f"graph gradient launched {g_n}, expected "
                             f"exactly {want}")
    (d_loss, d_grads), _, _ = counted(lambda: direct_vg(x), tally=False)
    err = max([abs(g_loss.item() - d_loss.item())]
              + [(g_grads[nm] - d_grads[nm]).abs().max().item()
                 for nm in ELASTIC_FIELDS])
    tol = TOL["float32"]
    for nm in ELASTIC_FIELDS:
        scale = d_grads[nm].abs().max().item()
        if (g_grads[nm] - d_grads[nm]).abs().max().item() > tol * scale:
            raise AssertionError(f"graph gradient {nm} differs from the "
                                 f"direct chain's")
    if abs(g_loss.item() - d_loss.item()) > tol * abs(d_loss.item()):
        raise AssertionError(f"graph loss {g_loss.item()} vs direct "
                             f"{d_loss.item()}")
    log(f"  config #4 through GraphDataHandling.compile(fuse='stages', "
        f"k={ek}, fused_bwd=True), {ne}² f32, {ec} cycles: loss "
        f"{g_loss.item():.6e}, max |graph - direct| over loss and "
        f"gradients {err:.3e}; launches {only(g_n)}")
    del g_grads, d_grads
    turns = {"graph": [], "direct": []}
    for label in ("graph", "direct", "direct", "graph"):
        vg = graph_vg if label == "graph" else direct_vg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            vg(x)[0].item()
        torch.cuda.synchronize()
        turns[label].append((time.perf_counter() - t0) / 3 * 1e3)
    graph_ms, direct_ms = (statistics.mean(turns[k]) for k in
                           ("graph", "direct"))
    log(f"  value+gradient host clock, in turns (graph, direct, direct, "
        f"graph; 3 gradients a turn): graph "
        f"{' / '.join(f'{t:.3f}' for t in turns['graph'])} ms, direct "
        f"{' / '.join(f'{t:.3f}' for t in turns['direct'])} ms; graph / "
        f"direct {graph_ms / direct_ms:.4f}")

    # -- replay and the fused step, from a seeded state ------------------
    gen = torch.Generator(device=dev).manual_seed(51)
    xs = {nm: 0.1 * torch.randn((ne, ne), generator=gen, dtype=f32,
                                device=dev) for nm in ELASTIC_FIELDS}
    run_r = dh.compile()

    def value_and_grads(run):
        ins = {nm: t.detach().requires_grad_() for nm, t in xs.items()}
        out = run(ins, ec)
        loss = sum(torch.mean(out[nm] ** 2) for nm in ELASTIC_FIELDS)
        grads = torch.autograd.grad(loss, [ins[nm] for nm in ELASTIC_FIELDS])
        return ({nm: out[nm].detach() for nm in ELASTIC_FIELDS},
                dict(zip(ELASTIC_FIELDS, grads)))

    (r_out, r_grads), r_n, r_s = counted(lambda: value_and_grads(run_r))
    tally_counterparts()
    bwd = sum(len(backward_programs(op)) for op, _ in pair)
    want_r = {("stencil_step", 2): ec * (len(pair) + bwd)}
    log(f"  replay (compile()), {ec} cycles: {len(pair)} forward "
        f"single steps a cycle + {bwd} backward (the ops' backward "
        f"programs: {[len(backward_programs(op)) for op, _ in pair]}) = "
        f"{want_r[('stencil_step', 2)]} window-kernel launches; counted "
        f"{only(r_n)} ({r_s * 1e3:.3f} ms host clock)")
    if only(r_n) != want_r:
        raise AssertionError(f"replay launched {r_n}, expected {want_r}")
    (s_out, s_grads), _, _ = counted(lambda: value_and_grads(run_s),
                                     tally=False)
    rel = {}
    for what, got, ref, t in (("value", r_out, s_out, tol),
                              ("gradient", r_grads, s_grads, 10 * tol)):
        rel[what] = max((got[nm] - ref[nm]).abs().max().item()
                        / ref[nm].abs().max().item() for nm in ELASTIC_FIELDS)
        if not rel[what] <= t:
            raise AssertionError(f"replay {what}s differ from fuse='stages' "
                                 f"by {rel[what]:.3e} (relative to max)")
    log(f"  replay vs fuse='stages': values rel {rel['value']:.3e}, "
        f"gradients rel {rel['gradient']:.3e}")
    del r_out, r_grads, s_out, s_grads

    step = sim.step_fn()
    f_fused = fused.torch_function()
    ins = [f.name for f in fused.forward_input_fields]
    with torch.no_grad():
        outs, f_n, _ = counted(lambda: f_fused(**{n: xs[n] for n in ins}))
        tally_counterparts()
        if only(f_n) != {("stencil_step", 2): 1}:
            raise AssertionError(f"fused step launched {f_n}, expected one "
                                 f"single step")
        seq = step(xs)
        by_name = dict(zip([f.name for f in fused.forward_output_fields],
                           outs))
        f_err = max((by_name[src][2:-2, 2:-2] - seq[dst][2:-2, 2:-2]).abs()
                    .max().item() / seq[dst].abs().max().item()
                    for dst, src in fused._fused_carry.items())
        if not f_err <= tol:
            raise AssertionError(f"fused step differs from step_fn by "
                                 f"{f_err:.3e} on [2:-2, 2:-2]")
        fused_ms = cuda_ms(lambda: f_fused(**{n: xs[n] for n in ins}))
        step_ms = cuda_ms(lambda: step(xs))
    log(f"  Simulation.fused_op() of the pair ({fused.op_name}, ghost "
        f"{forward_program(fused).ghost}): 1 launch a cycle; vs step_fn on "
        f"[2:-2, 2:-2] rel {f_err:.3e}; forward {fused_ms:.3f} ms, unfused "
        f"step {step_ms:.3f} ms (CUDA events)")
    del outs, seq, by_name

    # -- the kernel pairs ------------------------------------------------
    records = []
    for op, spatial in ((burgers, (ne, ne)), (lap3d, (sizes["cube"],) * 3)):
        kp = op.kernel_pair()
        fp, bp = forward_program(op), backward_programs(op)[-1]
        fwd = random_inputs(fp, spatial, f32, gen, dev)
        bwd = random_inputs(bp, spatial, f32, gen, dev)
        _, p_n, _ = counted(lambda: (kp.forward(**fwd), kp.backward(**bwd)))
        tally_counterparts()
        if only(p_n) != {("stencil_step", len(spatial)): 2}:
            raise AssertionError(f"{op.op_name} kernel pair launched {p_n}")
        for prog, ins_, kern, full in ((fp, fwd, kp.forward_kernel_gpu,
                                        False),
                                       (bp, bwd, kp.backward_kernel_gpu,
                                        True)):
            plain = make_torch_stencil(prog, full_domain=full)
            library = None if full else conv_library(
                prog, ins_[prog.input_fields[0].name])
            if library is not None:
                check_library(prog.name, library,
                              plain(ins_)[prog.output_names[0]], False,
                              prog.ghost, tol)
            records.append(check_and_time(
                f"{op.op_name} {'bwd full' if full else 'fwd interior'} "
                f"(kernel pair) f32", lambda: kern(ins_),
                lambda: plain(ins_), tol, list(ins_.values()), ck, dev,
                ops=math.prod(spatial) * program_ops(prog.steps),
                library=library,
                counterpart=pallas_counterpart(prog, full, False, spatial,
                                               4)))
        del fwd, bwd
    sec = time.perf_counter() - t_phase
    log(f"  app phase: {sec:.1f} s (its libraries built with the rest); "
        f"single-step launches by Pallas counterpart {cp_launches}")
    return records, cp_launches


# ---------------------------------------------------------------------------
# serving.py and utils/autotune.py: exported artifacts loaded in a fresh
# process, and the measured-best form.

SERVING_SEED = 141
SERVING_CARRY = {"u": "u_next"}


def serving_heat_graph(n, dev):
    """A Neumann heat sweep (const coefficient, f32) recorded at n² and
    compiled with ``fuse="stages"``, k=2 (kernel 12): the step-count
    artifact's program, and its start u."""
    import torch

    from pystencils_autodiff_tpu_torch.graph_datahandling import \
        GraphDataHandling
    from pystencils_autodiff_tpu_torch.models import heat_step_op

    dh = GraphDataHandling((n - 2, n - 2), ghost_layers=1,
                           default_dtype=torch.float32, device=dev)
    dh.add_field("u")
    dh.set_array("u", serving_inputs((n, n), dev, 1)[0])
    with dh.timeloop() as loop:
        loop.boundary({"u": "neumann"})
        loop.sweep(heat_step_op(dt=0.1), SERVING_CARRY)
    return dh, dh.compile(fuse="stages", k=2)


def serving_sources(sizes):
    """(name, source) of the serving phase's library the other phases do
    not build: kernel 12 of the Neumann heat stage chain at 8192² f32."""
    from pystencils_autodiff_tpu_torch.models import heat_step_op

    n = sizes["heat2d"]
    return [march_library([(heat_step_op(dt=0.1), SERVING_CARRY)], 2, False,
                          {"u": "neumann"}, "float32", "fwd", (n, n), None)]


def autotune_sources(sizes):
    """(name, source) of the autotune phase's libraries the other phases do
    not build: nl3d's bounded two-phase streaming kernel at k=4, 384³ f32,
    in both forms (k=2's are ``plane_sources``')."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_plane_source
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    ap = ac.AdjointPlan(tc.chain_plan(nl3d_op(), 4, SERVING_CARRY, False))
    return [(f"nl3d_plane_two_phase_k4_bounded_{form}_float32",
             generate_plane_source(ap, "two_phase", "float32", form))
            for form in ("gather", "local")]


def serving_inputs(shape, dev, count):
    """``count`` seeded normal tensors of ``shape`` on ``dev``, from one
    CUDA generator: the same numbers in every process on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SERVING_SEED)
    return [torch.randn(shape, generator=gen, device=dev)
            for _ in range(count)]


def torch_only_load(path):
    """The torch-only load of an exported artifact, step by step as
    ``serving.py``'s doc sets it out, with PyTorch, ``json`` and the
    standard library alone (none of the port): read the sidecar (format
    2), check every library's place and sha256, load the leaf op's
    library, bind each kernel library, ``torch.export.load`` the programs.
    Returns ``(primal, vjp or None, sidecar)``, the ``ExportedProgram``s
    and the sidecar with each library's ``path``; raises ValueError where a
    check fails, before anything is loaded."""
    import hashlib

    import torch

    with open(path + ".meta") as fh:
        meta = json.load(fh)
    if meta.get("format") != 2:
        raise ValueError(f"sidecar format {meta.get('format')!r}, not 2")
    here = os.path.realpath(os.path.dirname(os.path.abspath(path)))
    for lib in meta["libraries"]:
        full = os.path.realpath(os.path.join(here, lib["file"]))
        if os.path.dirname(full) != here:
            raise ValueError(f"library {lib['file']!r} lies outside "
                             f"{here}")
        with open(full, "rb") as fh:
            if hashlib.sha256(fh.read()).hexdigest() != lib["sha256"]:
                raise ValueError(f"library {lib['file']!r} does not match "
                                 f"its sha256")
        lib["path"] = full
    for lib in meta["libraries"]:
        if lib["role"] == "launch_op":
            torch.ops.load_library(lib["path"])
    for lib in meta["libraries"]:
        if lib["role"] == "kernel":
            torch.ops.psat_launch.bind(lib["sha256"], lib["path"])
    programs = []
    for p in (path, path + ".vjp"):
        if os.path.exists(p):
            with open(p, "rb") as fh:
                programs.append(torch.export.load(fh))
        else:
            programs.append(None)
    return programs[0], programs[1], meta


def halo_copies(ep) -> int:
    """The halo slab copies a loaded program makes: its graph's copies to a
    shard's device (``parallel/halo.py``: ``to(..., copy=True)``), one per
    shard a transport reaches; the graph is straight-line, so each runs
    once a call."""
    return sum(1 for gm in ep.graph_module.modules()
               if hasattr(gm, "graph") for nd in gm.graph.nodes
               if nd.op == "call_function" and "aten.to." in str(nd.target)
               and nd.kwargs.get("copy") is True)


def kernel_launches(meta) -> dict:
    """Launches of each kernel library of a loaded artifact since the last
    ``torch.ops.psat_launch.reset_launch_counts()``, by the launch the
    sidecar says it serves (the port's wrapper's description, the key of
    ``ops.launch.LAUNCHES`` for eager launches); none left out."""
    import torch

    out = {}
    for lib in meta["libraries"]:
        if lib["role"] == "kernel":
            n = torch.ops.psat_launch.launch_count(lib["sha256"])
            if n:
                out[lib["launch"]] = out.get(lib["launch"], 0) + n
    return out


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def _by_mode(calls):
    """Single-step launches by mode: "fwd" (interior or periodic) and
    "bwd" (the full-domain backward)."""
    out = {}
    for key, n in calls.items():
        mode = "bwd" if key[1] else "fwd"
        out[mode] = out.get(mode, 0) + n
    return out


def serving_phase(sizes, dev):
    """``serving.py`` at full width, each artifact saved under
    ``build/serving/``:

    - the heat inverse problem's κ-heat op at 8192² f32,
      ``export_op(with_gradient=True)``, loaded in a fresh ``python3`` on
      the card through the torch-only load (``serving_child``: the port,
      jax and the JAX package blocked, no compiler on its PATH): the
      loaded forward and VJP equal the eager ``torch_function``'s bit
      for bit; the loaded forward makes 1 window launch (forward), the
      loaded VJP 1 forward and 1 backward, as the leaf op counts them;
    - config #4's recorded graph (``record_config4``, ``fuse="stages"``,
      k=4, kernel 13's backward) through ``export_program(16 cycles,
      with_gradient=True)``, loaded in the same fresh process: from
      ``elastic_setup``'s start the loaded program's MSE loss and the
      loaded VJP's five gradients (the loss's cotangent by autograd)
      against the direct chain's — 0 difference expected, else within
      1e-6 of each gradient's max (f32) —, with exactly 4 launches of
      kernel 12 and 4 of kernel 13 in the VJP;
    - aniso27 at 128³ f32 exported with ``accumulate="dd"``, loaded in the
      same fresh process: forward and VJP bit-equal to the eager dd op,
      1 + 1 window launches, each of a dd library (its launch named
      ``..._dd``);
    - the κ-heat op exported shape-polymorphically (``("n", "m")``),
      saved and loaded here, run at 8192² and 8191×8190: bit-equal to the
      eager op at each shape;
    - a step-count artifact of a Neumann heat ``fuse="stages"`` run (k=2,
      8192²), saved and loaded here: n=8 makes 4 chain calls and equals
      ``run(state, 8)``; n=3 raises.

    Then the custom-op layer's host cost (``host_cost``), one Adam step
    of the 16² f64 inverse problem (``small_step_ms``) and the 8192²
    heat inverse step re-read.  Returns the phase's numbers."""
    import os
    import shutil

    import torch

    from pystencils_autodiff_tpu_torch.models import anisotropic27_op
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.serving import (export_op,
                                                       export_program,
                                                       load_exported,
                                                       read_sidecar,
                                                       save_exported)

    t_phase = time.perf_counter()
    f32 = torch.float32
    work = REPO / "build" / "serving"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n, rag = sizes["heat2d"], tuple(sizes["ragged"])
    op = example_op()
    f = op.torch_function()
    names = [fl.name for fl in op.forward_input_fields]
    expect, numbers = {}, {}

    def eager(shape):
        ins = serving_inputs(shape, dev, len(names) + 1)
        xs = [t.clone().requires_grad_() for t in ins[:-1]]
        out = f(*xs)
        grads = torch.autograd.grad(out, xs, ins[-1])
        return [_sha(t) for t in [out, *grads]]

    t0 = time.perf_counter()
    exp = export_op(op, (n, n), dtype=f32, device=dev)
    numbers["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_exported(exp, str(work / "heat.pt2"))
    numbers["save_s"] = time.perf_counter() - t0
    save_exported(export_op(op, ("n", "m"), dtype=f32, device=dev),
                  str(work / "heat_poly.pt2"))
    expect["heat"] = eager((n, n))
    poly_expect = {f"{a}x{b}": (expect["heat"] if (a, b) == (n, n)
                                else eager((a, b)))
                   for a, b in ((n, n), rag)}

    ne, ec, ek = sizes["elastic"], sizes["elastic_cycles"], sizes["elastic_k"]
    pair = elastic_chain_stages(f32)
    run4 = record_config4(ne, pair, dev).compile(fuse="stages", k=ek,
                                                 fused_bwd=True)
    x, direct_vg, _, observed = elastic_setup(ne, ec, ek, dev, f32)
    t0 = time.perf_counter()
    save_exported(export_program(run4, x, ec), str(work / "config4.pt2"))
    numbers["config4_export_save_s"] = time.perf_counter() - t0
    torch.save(observed, str(work / "observed.pt"))
    d_loss, d_grads = direct_vg(x)
    expect["config4"] = {"loss": d_loss.item(),
                         "grads": {nm: _sha(d_grads[nm])
                                   for nm in ELASTIC_FIELDS}}
    nd = sizes["dd_export"]
    dd_op = anisotropic27_op()
    fdd = dd_op.torch_function(accumulate="dd")

    def eager_dd():
        ins = serving_inputs((nd,) * 3, dev, 2)
        x = ins[0].clone().requires_grad_()
        out = fdd(x)
        (grad,) = torch.autograd.grad(out, x, ins[1])
        return [_sha(out), _sha(grad)]

    save_exported(export_op(dd_op, (nd,) * 3, dtype=f32, device=dev,
                            accumulate="dd"), str(work / "aniso_dd.pt2"))
    expect["aniso_dd"] = eager_dd()
    hdh, hrun = serving_heat_graph(n, dev)
    save_exported(export_program(hrun, hdh.state(), n_steps=None,
                                 with_gradient=False),
                  str(work / "dyn.pt2"))
    dyn_expect = _sha(hrun(hdh.state(), 8)["u"])
    del hdh, hrun, exp
    (work / "manifest.json").write_text(json.dumps({
        "names": names, "n": n, "expect": expect, "device": str(dev),
        "fields": list(ELASTIC_FIELDS), "n_dd": nd}))

    t0 = time.perf_counter()
    out = torch_only_child("serving_child", work, 900)()
    numbers["child_s"] = time.perf_counter() - t0
    got = json.loads(out.strip().splitlines()[-1])
    numbers.update({k: got[k] for k in ("cuda_init_s", "load_s", "load4_s",
                                        "load_dd_s", "child_wall_s")})
    card = card_line()
    log(f"  fresh process, torch-only load (the port, jax and the JAX "
        f"package blocked, no nvcc or g++ on its PATH; sympy imported by "
        f"torch.export.load: {got['sympy']}): {numbers['child_s']:.1f} s "
        f"from the parent ({got['child_wall_s']:.1f} s inside), CUDA set-up "
        f"{got['cuda_init_s']:.3f} s, torch.export.load and binds "
        f"{got['load_s']:.3f} s (κ-heat), {got['load4_s']:.3f} s (config "
        f"#4); the leaf launch op's g++ build at save time "
        f"{LAUNCH_OP_BUILD_S[0]:.1f} s; {card}")

    if got["heat"]["sha"] != expect["heat"]:
        raise AssertionError("loaded κ-heat artifact differs from eager")
    if got["heat"]["fwd"] != {"fwd": 1} or got["heat"]["vjp"] != {
            "fwd": 1, "bwd": 1}:
        raise AssertionError(f"loaded κ-heat launches {got['heat']}")
    dd = got["aniso_dd"]
    if dd["sha"] != expect["aniso_dd"] or dd["fwd"] != {"fwd": 1} \
            or dd["vjp"] != {"fwd": 1, "bwd": 1} \
            or not all(w.endswith("_dd)") for w in dd["whats"]):
        raise AssertionError(f"loaded aniso27 dd artifact: {dd}, expected "
                             f"{expect['aniso_dd']}")
    log(f"  aniso27 {nd}³ f32 export_op(accumulate='dd'), loaded in the "
        f"same fresh process ({got['load_dd_s']:.3f} s): forward and VJP "
        f"bit-equal to eager; launches {dd['fwd']} (forward), {dd['vjp']} "
        f"(VJP), every one of a dd library: {sorted(set(dd['whats']))}")
    log(f"  κ-heat {n}² f32 export_op(with_gradient=True): export "
        f"{numbers['export_s']:.2f} s, save {numbers['save_s']:.2f} s; "
        f"loaded forward and VJP bit-equal to eager; window launches "
        f"{got['heat']['fwd']} (forward), {got['heat']['vjp']} (VJP)")

    c4 = got["config4"]
    errs = {}
    for nm in ELASTIC_FIELDS:
        if c4["grads"][nm] == expect["config4"]["grads"][nm]:
            errs[nm] = 0.0
            continue
        g = torch.load(str(work / f"grad_{nm}.pt"), map_location=dev)
        errs[nm] = ((g - d_grads[nm]).abs().max()
                    / d_grads[nm].abs().max()).item()
    loss_rel = abs(c4["loss"] - expect["config4"]["loss"]) / abs(
        expect["config4"]["loss"])
    want4 = {"stage_chain": ec // ek, "stage_adjoint": ec // ek}
    log(f"  config #4 recorded graph, fuse='stages' k={ek}, {ne}² f32, {ec} "
        f"cycles, export_program(with_gradient=True): loss "
        f"{c4['loss']:.9e} (direct {expect['config4']['loss']:.9e}, rel "
        f"{loss_rel:.3e}); gradients against the direct chain, max |diff| / "
        f"max|g| {errs}; launches in the loaded VJP {c4['vjp']}, in the "
        f"loaded primal {c4['primal']}")
    if loss_rel > 1e-6 or max(errs.values()) > 1e-6:
        raise AssertionError(f"loaded config #4 differs: loss rel "
                             f"{loss_rel:.3e}, gradients {errs}")
    if c4["vjp"] != want4 or c4["primal"] != {"stage_chain": ec // ek}:
        raise AssertionError(f"loaded config #4 launches {c4}, expected "
                             f"{want4} in the VJP")
    numbers.update(config4_loss_rel=loss_rel,
                   config4_grad_rel_max=max(errs.values()),
                   config4_launches=c4["vjp"])
    del x, d_grads, observed

    t0 = time.perf_counter()
    fn, vjp = load_exported(str(work / "heat_poly.pt2"))
    numbers["load_poly_s"] = time.perf_counter() - t0
    meta = read_sidecar(str(work / "heat_poly.pt2"))
    for (a, b) in ((n, n), rag):
        shape = f"{a}x{b}"
        res = _run_loaded_op(fn, vjp, (a, b), dev, len(names), meta)
        if res["sha"] != poly_expect[shape] or res["fwd"] != {"fwd": 1} \
                or res["vjp"] != {"fwd": 1, "bwd": 1}:
            raise AssertionError(f"shape-polymorphic artifact at {shape} "
                                 f"differs from eager: {res}")
    log(f"  the same op exported with symbolic (n, m), loaded here "
        f"({numbers['load_poly_s']:.3f} s): bit-equal to eager at "
        f"{', '.join(poly_expect)}")
    t0 = time.perf_counter()
    dyn, _ = load_exported(str(work / "dyn.pt2"))
    numbers["load_dyn_s"] = time.perf_counter() - t0
    u = serving_inputs((n, n), dev, 1)[0]
    torch.ops.psat_launch.reset_launch_counts()
    final = dyn(8, u)
    torch.cuda.synchronize()
    calls = sum(kernel_launches(read_sidecar(str(work / "dyn.pt2"))
                                ).values())
    try:
        dyn(3, u)
        raised = None
    except ValueError as e:
        raised = str(e)[:80]
    if _sha(final[0]) != dyn_expect or calls != 4 or raised is None:
        raise AssertionError(f"step-count artifact: {calls} chain calls, "
                             f"n=3 raised {raised!r}")
    log(f"  step-count artifact (Neumann heat, fuse='stages' k=2, {n}²), "
        f"loaded here ({numbers['load_dyn_s']:.3f} s): n=8 -> {calls} "
        f"chain calls, equal to run(state, 8); n=3 raised ValueError "
        f"({raised})")
    del fn, vjp, dyn, final, u
    numbers.update(host_cost(sizes, dev))
    numbers["small_step_ms"] = small_step_ms(dev)
    log(f"  16² f64 inverse problem through torch_function: "
        f"{' / '.join(f'{t:.4f}' for t in numbers['small_step_ms'])} ms an "
        f"Adam step (host clock, turns of 200 steps after 20)")
    numbers["heat_step_ms"] = heat_step_ms(sizes, dev)
    log(f"  heat inverse problem {n}² f32 through torch_function: "
        f"{numbers['heat_step_ms']} ms an Adam step (host clock, 5 steps "
        f"after 2, in turns of one)")
    shutil.rmtree(work, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"  serving phase: {numbers['phase_s']:.1f} s")
    return numbers


def _run_loaded_op(fn, vjp, shape, dev, n_inputs, meta):
    """A loaded κ-heat artifact's forward and VJP on ``serving_inputs``:
    sha256 of each result and the window launches by mode, "fwd"
    (interior) and "bwd" (the full-domain backward), from the leaf launch
    op's counts (``meta``: the artifact's sidecar)."""
    import torch

    def counted(call):
        torch.ops.psat_launch.reset_launch_counts()
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        by_mode = {}
        for what, k in kernel_launches(meta).items():
            mode = "bwd" if "(full," in what else "fwd"
            by_mode[mode] = by_mode.get(mode, 0) + k
        return out, by_mode

    ins = serving_inputs(shape, dev, n_inputs + 1)
    out, fwd = counted(lambda: fn(*ins[:-1]))
    grads, bwd = counted(lambda: vjp(*ins))
    return {"sha": [_sha(t) for t in [out, *grads]], "fwd": fwd, "vjp": bwd}


TORCH_ONLY_BLOCKED = ("jax", "jaxlib", "pystencils_autodiff_tpu",
                      "pystencils_autodiff_tpu_torch")


def block_the_port():
    """Refuse every import of the port, jax and the JAX package in this
    process (the children of the serving phases)."""
    import importlib.abc

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in TORCH_ONLY_BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())


_CHILDREN: list = []


def _stop_children():
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(_stop_children)


def torch_only_child(fn_name: str, work, timeout: int):
    """Start ``chip_smoke.<fn_name>(work)`` in a fresh ``python3`` whose
    PATH holds no compiler (an empty directory); returns a function that
    waits for it (at most ``timeout`` s, raising on failure) and returns
    its standard output.  A child still running when this process exits
    is killed."""
    import os

    empty = Path(work) / "no_compilers"
    empty.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=str(empty))
    env.pop("CUDA_HOME", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import sys, chip_smoke; "
         f"sys.exit(chip_smoke.{fn_name}(sys.argv[1]))", str(work)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(proc)

    def wait() -> str:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"{fn_name} did not end in {timeout} s")
        if proc.returncode != 0:
            raise AssertionError(f"{fn_name} failed:\n{err[-6000:]}")
        return out

    return wait


def serving_child(workdir: str) -> int:
    """The fresh process of ``serving_phase``: loads the κ-heat, the
    aniso27 dd and the config #4 artifacts under ``workdir`` through the
    torch-only load
    (``torch_only_load``; the port, jax and the JAX package blocked, no
    compiler on the PATH), runs them on the card with the launches
    counted by the leaf op, and prints one JSON line (sha256 of each
    result, launches, wall, CUDA set-up and load times, whether sympy was
    imported — by ``torch.export.load``)."""
    t_child = time.perf_counter()
    block_the_port()
    import torch

    work = Path(workdir)
    m = json.loads((work / "manifest.json").read_text())
    dev = torch.device(m["device"])
    n, names, res = m["n"], m["names"], {}
    # the card's context first, so the load times are the loads'
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["cuda_init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    primal, vjp, meta = torch_only_load(str(work / "heat.pt2"))
    res["load_s"] = time.perf_counter() - t0
    res["heat"] = _run_loaded_op(primal.module(), vjp.module(), (n, n), dev,
                                 len(names), meta)

    t0 = time.perf_counter()
    primal, vjp, meta = torch_only_load(str(work / "aniso_dd.pt2"))
    res["load_dd_s"] = time.perf_counter() - t0
    nd = m["n_dd"]
    res["aniso_dd"] = _run_loaded_op(primal.module(), vjp.module(),
                                     (nd,) * 3, dev, 1, meta)
    res["aniso_dd"]["whats"] = [lib["launch"] for lib in meta["libraries"]
                                if lib["role"] == "kernel"]

    t0 = time.perf_counter()
    primal, vjp, meta = torch_only_load(str(work / "config4.pt2"))
    res["load4_s"] = time.perf_counter() - t0
    fn, vjp = primal.module(), vjp.module()

    def counted(call):
        torch.ops.psat_launch.reset_launch_counts()
        out = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = {"stage_chain": 0, "stage_adjoint": 0}
        for what, k in kernel_launches(meta).items():
            launches["stage_adjoint" if "_march_adjoint_" in what
                     else "stage_chain"] += k
        return out, launches

    observed = torch.load(str(work / "observed.pt"), map_location=dev)
    state_names = sorted(m["fields"])
    x = [torch.zeros_like(observed) for _ in state_names]
    out, launched = counted(lambda: fn(*x))
    primal_launches = {"stage_chain": launched["stage_chain"]}
    # the loss's cotangent as the direct chain's autograd computes it
    vx = out[state_names.index("vx")].detach().requires_grad_()
    loss = torch.mean((vx - observed) ** 2)
    (cot,) = torch.autograd.grad(loss, vx)
    cots = [cot if nm == "vx" else torch.zeros_like(cot)
            for nm in state_names]
    grads, vjp_launches = counted(lambda: vjp(*x, *cots))
    by_name = dict(zip(state_names, grads))
    expect = m["expect"]["config4"]["grads"]
    shas = {}
    for nm in m["fields"]:
        shas[nm] = _sha(by_name[nm])
        if shas[nm] != expect[nm]:  # the parent measures the difference
            torch.save(by_name[nm], str(work / f"grad_{nm}.pt"))
    res["config4"] = {"loss": loss.item(), "grads": shas,
                      "primal": primal_launches, "vjp": vjp_launches}
    blocked = sorted(mod for mod in sys.modules
                     if mod.split(".")[0] in TORCH_ONLY_BLOCKED)
    if blocked:
        raise AssertionError(f"blocked modules loaded: {blocked}")
    res["sympy"] = "sympy" in sys.modules
    res["child_wall_s"] = time.perf_counter() - t_child
    print(json.dumps(res))
    return 0


def host_cost(sizes, dev, calls=2000):
    """The custom-op layer's host cost at 64² f32: µs per call of the
    κ-heat op's forward through ``torch_function`` (the ``psat::stencil``
    op through ``OpFunction``) and through the launcher alone
    (``make_cuda_stencil``'s wrapper), ``calls`` calls a turn ending in a
    synchronise, in turns (op, launcher, launcher, op) — with no gradient
    recorded, then through ``torch_function`` with κ requiring one (the
    main paths' case: the autograd node is made)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import (forward_program,
                                                   make_cuda_stencil)

    op = example_op()
    f = op.torch_function()
    launch = make_cuda_stencil(forward_program(op))
    ns = sizes["small"]
    u, kap = serving_inputs((ns, ns), dev, 2)
    kap_g = kap.clone().requires_grad_()
    runs = {"torch_function": lambda: f(u=u, kappa=kap),
            "launcher": lambda: launch({"u": u, "kappa": kap}),
            "torch_function_grad": lambda: f(u=u, kappa=kap_g)}
    us = {name: [] for name in runs}

    def turn(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            runs[name]()
        torch.cuda.synchronize()
        us[name].append((time.perf_counter() - t0) / calls * 1e6)

    for fn in runs.values():
        for _ in range(100):
            fn()
    with torch.no_grad():
        for name in ("torch_function", "launcher", "launcher",
                     "torch_function"):
            turn(name)
    for _ in range(2):
        turn("torch_function_grad")
    op_us, ln_us, gr_us = (statistics.mean(us[k]) for k in runs)
    log(f"  host cost at {ns}² f32, forward, µs a call ({calls} calls a "
        f"turn, in turns): torch_function "
        f"{' / '.join(f'{t:.2f}' for t in us['torch_function'])}, launcher "
        f"alone {' / '.join(f'{t:.2f}' for t in us['launcher'])}; the "
        f"custom-op layer adds {op_us - ln_us:.2f} µs; with κ requiring a "
        f"gradient {' / '.join(f'{t:.2f}' for t in us['torch_function_grad'])}")
    return {"host_us_torch_function": us["torch_function"],
            "host_us_launcher": us["launcher"],
            "host_us_added": op_us - ln_us,
            "host_us_torch_function_grad": us["torch_function_grad"],
            "host_us_added_grad": gr_us - ln_us}


def small_step_ms(dev, n=16, steps=200, warmup=20, turns=2):
    """ms of one Adam step of the 16² f64 heat inverse problem (the
    host-bound main path: 4 forward and 4 backward window launches a
    step) through ``torch_function``, host clock ending in a synchronise:
    the mean of ``steps`` steps after ``warmup``, in ``turns`` turns."""
    import torch

    step, _, _ = heat_inverse_setup(example_op(), n, dev, torch.float64)
    for _ in range(warmup):
        step()
    out = []
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    return out


def heat_step_ms(sizes, dev, steps=5, warmup=2):
    """ms of one Adam step of the heat inverse problem at 8192² f32
    through ``torch_function`` (host clock ending in a synchronise), the
    mean of ``steps`` after ``warmup``."""
    import torch

    step, _, _ = heat_inverse_setup(example_op(), sizes["heat2d"], dev,
                                    torch.float32)
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) / steps * 1e3, 3)


def host_child(tree: str) -> int:
    """One turn of ``--host-ab``: the host cost and the 16² f64 Adam step of
    the package in ``tree`` (this file's timers, that tree's port), one
    JSON line."""
    import torch

    sys.path.insert(0, tree)
    import pystencils_autodiff_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != Path(tree).resolve():
        raise RuntimeError(f"imported {port.__file__}, not {tree}'s port")
    dev = torch.device("cuda", 0)
    res = host_cost(FULL, dev)
    res["small_step_ms"] = small_step_ms(dev)
    print(json.dumps(res))
    return 0


def host_ab(tree: str):
    """The port in ``tree`` (another checkout, e.g. the parent commit
    unpacked under ``build/``) against this one on the same card, in
    turns (tree, this, this, tree), each turn a fresh ``python3``
    (``host_child``): the 64² host cost and the 16² f64 Adam step.  The
    two checkouts share one kernel cache (their CUDA sources are
    compared: a library is reused only under the same source hash)."""
    import os

    here, tree = str(REPO), str(Path(tree).resolve())
    cache = REPO / "build" / "torch_kernels"
    cache.mkdir(parents=True, exist_ok=True)
    other = Path(tree, "build", "torch_kernels")
    if not other.exists():
        other.parent.mkdir(parents=True, exist_ok=True)
        other.symlink_to(cache, target_is_directory=True)
    out = {"tree": [], "this": []}
    for name, path in (("tree", tree), ("this", here), ("this", here),
                       ("tree", tree)):
        proc = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "--host-child",
             path], cwd=path, env=dict(os.environ, PYTHONPATH=""),
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"host child ({path}) failed:\n"
                                 f"{proc.stderr[-6000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"  {name} ({path}): host µs torch_function "
            f"{res['host_us_torch_function']}, launcher "
            f"{res['host_us_launcher']}, with a gradient "
            f"{res['host_us_torch_function_grad']}; 16² f64 Adam step ms "
            f"{res['small_step_ms']}")
        out[name].append(res)
    return out


def autotune_phase(sizes, dev):
    """``utils/autotune.py`` on the card: nl3d's bounded value+gradient
    chain at 384³ f32 (``nl3d_op``, PERF.md row 9's case) swept over k ∈
    {2, 4} × form ∈ {gather, local} (``autotune_chain(vjp=True)``: the
    cheap timer ranks, the slope timer re-times the winner), the cache at
    a temporary path set for this phase only; then a
    ``fused_chain_vjp(nl3d, 2, ...)`` built with ``form=None`` must take
    the recorded k=2 form — the streaming kernel's launches counted by
    form.  Returns the table, the winner and the launches."""
    import os
    import shutil
    import tempfile

    import torch

    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops.adjoint_chain import \
        fused_chain_vjp
    from pystencils_autodiff_tpu_torch.utils import autotune_chain
    from pystencils_autodiff_tpu_torch.utils.autotune import tuned_tile

    t_phase = time.perf_counter()
    n, op = sizes["nl3d"], nl3d_op()
    gen = torch.Generator(device=dev).manual_seed(61)
    state = {"u": torch.randn((n,) * 3, generator=gen, device=dev)}
    tmp = tempfile.mkdtemp(dir=str(REPO / "build"))
    old = os.environ.get("PYSTENCILS_ADTPU_TUNE_CACHE")
    os.environ["PYSTENCILS_ADTPU_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
    try:
        res = autotune_chain(op, SERVING_CARRY, state, k_candidates=(2, 4),
                             form_candidates=("gather", "local"), vjp=True)
        form = tuned_tile("chain", "vjp", op.op_name, (n,) * 3,
                          torch.float32, False, 2, device=dev)
        g = fused_chain_vjp(op, 2, SERVING_CARRY, periodic=False)
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        g(state, {"u": torch.ones_like(state["u"])})
        torch.cuda.synchronize()
        by_form = {}
        for key, c in pa.LAUNCH_CALLS.items():
            by_form[key[6]] = by_form.get(key[6], 0) + c
    finally:
        if old is None:
            os.environ.pop("PYSTENCILS_ADTPU_TUNE_CACHE", None)
        else:
            os.environ["PYSTENCILS_ADTPU_TUNE_CACHE"] = old
        shutil.rmtree(tmp, ignore_errors=True)
    table = {f"k{k} {fm}": round(t * 1e3, 4) for (k, fm), t in
             sorted(res.table.items())}
    log(f"  autotune nl3d bounded value+gradient {n}³ f32, ms a step "
        f"(winner re-timed by the slope): {table}; winner {res.best}, "
        f"{res.per_step_s * 1e3:.4f} ms a step")
    log(f"  fused_chain_vjp(nl3d, 2, form=None) after the sweep: recorded "
        f"k=2 form {form!r}, ran {g.form!r}, streaming launches by form "
        f"{by_form}")
    if form is None or g.form != form or by_form != {form: 1}:
        raise AssertionError(f"the default build did not take the recorded "
                             f"form {form!r}: ran {g.form!r}, {by_form}")
    sec = time.perf_counter() - t_phase
    log(f"  autotune phase: {sec:.1f} s")
    return {"table": table, "best": res.best,
            "per_step_ms": res.per_step_s * 1e3, "form": form,
            "launches": by_form, "phase_s": sec}


# ---------------------------------------------------------------------------
# The framework bridges: torch_native on the card, the generated C kernels on
# the host's CPU.

def bridge_op():
    """The κ-heat op of PERF.md row 2 (``heat_step_op(kappa_field=True)``)."""
    from pystencils_autodiff_tpu_torch.models import heat_step_op

    return heat_step_op(kappa_field=True)


def bridge_build():
    """Build what ``bridge_phase`` runs from the checkout's sources: the
    κ-heat op's torch extension (g++ against PyTorch's headers, the C
    kernels registered as PyTorch operators) and its float64 C kernels for
    the ctypes route.  ``run`` calls this after the nvcc builds; returns
    the objects built and the seconds each build took."""
    t0 = time.perf_counter()
    op = bridge_op()
    native = op.create_pytorch_op(backend="torch_native")
    t1 = time.perf_counter()
    fwd_c, bwd_c = op.forward_kernel_cpu, op.backward_kernel_cpu
    t2 = time.perf_counter()
    return {"op": op, "native": native, "fwd_c": fwd_c, "bwd_c": bwd_c,
            "extension_s": t1 - t0, "c_kernels_s": t2 - t1}


def _cpu_line() -> str:
    """The host CPU's model and the CPUs this process may use: the model
    name of ``/proc/cpuinfo``, else ``lscpu``'s, else the vendor, family
    and model numbers of ``/proc/cpuinfo``, else ``platform``'s answer."""
    import os
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    known = lambda v: v if v and v.lower() != "unknown" else ""  # noqa: E731
    model = known(info.get("model name")) or known(info.get("cpu model"))
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        model = known(next((line.split(":", 1)[1].strip()
                            for line in out.splitlines()
                            if line.lower().startswith("model name")), ""))
    if not model and info.get("vendor_id"):
        model = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                 f"model {info.get('model', '?')}")
    model = model or platform.processor() or platform.machine() or "unknown"
    return (f"{model}, {os.cpu_count()} CPUs, "
            f"{len(os.sched_getaffinity(0))} usable")


def _cpu_times():
    """The host's CPU times from ``/proc/stat`` (user, nice, system, idle,
    iowait, irq, softirq, steal), or None where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            vals = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    return vals if len(vals) == 8 else None


def host_load(since=None) -> str:
    """The host's load average and, from ``since`` (``_cpu_times()``) on,
    its CPUs' busy and steal shares: how far other work on the host held
    this run back."""
    import os

    la = os.getloadavg()
    out = f"load average {la[0]:.2f} {la[1]:.2f} {la[2]:.2f}"
    now = _cpu_times()
    if since and now:
        d = [x - y for x, y in zip(now, since)]
        total = sum(d) or 1
        out += (f"; since the start: CPUs busy {(total - d[3] - d[4]) / total:.1%}"
                f", steal {d[7] / total:.1%}")
    return out


def _host_ms(fn, calls=3, turns=5):
    """Host-clock ms of one ``fn()`` on CPU tensors: the median of
    ``turns`` turns of ``calls`` calls, after one warm-up call."""
    fn()
    out = []
    for _ in range(turns):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e3)
    return statistics.median(out)


def bridge_phase(sizes, dev, built, calls=2000):
    """``create_pytorch_op(backend="torch_native")`` on the card and the
    generated C kernels on the host:

    - the κ-heat op at 8192² f32 on CUDA tensors: value and gradient
      bit-equal to ``torch_function``'s, exactly 1 + 1 window launches, no
      call of the plain version and none of the C kernels;
    - the host µs a call at 64² f32 through ``torch_native`` and
      ``torch_function`` in turns (native, torch_function, torch_function,
      native; ``calls`` calls a turn ending in a synchronise), forward
      with no gradient recorded and with κ requiring one;
    - ``forward_kernel_cpu``, ``backward_kernel_cpu`` (cotangent masked)
      and ``torch_native`` on CPU tensors (value+gradient) at 1024² f64
      against the plain version (rtol 1e-12), ms a call, beside the
      OpenMP thread count and the CPU model;
    - TensorFlow: run only where it is installed.

    Returns the phase's numbers."""
    import importlib.util

    import numpy as np
    import torch

    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program,
                                                   make_torch_stencil)
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import torch_ref

    t_phase = time.perf_counter()
    op, native = built["op"], built["native"]
    log(f"  builds (g++, after nvcc): the torch extension "
        f"{built['extension_s']:.1f} s, the float64 C kernels "
        f"{built['c_kernels_s']:.1f} s; extension {native.pair.is_extension}"
        f", namespace {native.pair.module.namespace}")
    if not native.pair.is_extension:
        raise AssertionError("torch_native did not load its extension")
    n = sizes["heat2d"]
    gen = torch.Generator(device=dev).manual_seed(SERVING_SEED)
    u, kap, cot = (torch.randn((n, n), generator=gen, device=dev)
                   for _ in range(3))

    def value_and_grad(fn):
        k = kap.clone().requires_grad_()
        uu = u.clone().requires_grad_()
        out = fn(u=uu, kappa=k)
        gu, gk = torch.autograd.grad(out, [uu, k], cot)
        return [out.detach(), gu, gk]

    ref = value_and_grad(op.torch_function())
    torch.cuda.synchronize()
    c_calls = []

    def refuse(*args, **kwargs):
        c_calls.append(1)
        raise AssertionError("torch_native ran its C kernels on the card")

    native.pair.forward = native.pair.backward = refuse
    try:
        ck.reset_launch_counts()
        plain0 = torch_ref.PLAIN_CALLS
        got = value_and_grad(native)
        torch.cuda.synchronize()
        plain_calls = torch_ref.PLAIN_CALLS - plain0
        launches = dict(ck.LAUNCH_CALLS)
    finally:
        del native.pair.forward, native.pair.backward
    same = [torch.equal(g, r) for g, r in zip(got, ref)]
    kinds = sorted((key[1], key[6], c) for key, c in launches.items())
    log(f"  torch_native on CUDA tensors, κ-heat {n}² f32 value+gradient: "
        f"bit-equal to torch_function {same}; launches {kinds} "
        f"(full_domain, form, count); plain-version evaluations "
        f"{plain_calls}, C-kernel calls {len(c_calls)}")
    if not all(same) or kinds != [(False, "window", 1), (True, "window", 1)] \
            or plain_calls or c_calls:
        raise AssertionError(f"torch_native on the card: equal {same}, "
                             f"launches {launches}, plain {plain_calls}, "
                             f"C {len(c_calls)}")

    ns = sizes["small"]
    us_, ks_ = serving_inputs((ns, ns), dev, 2)
    kg_ = ks_.clone().requires_grad_()
    tf_fn = op.torch_function()
    runs = {"torch_native": lambda k: native(u=us_, kappa=k),
            "torch_function": lambda k: tf_fn(u=us_, kappa=k)}
    us = {(name, grad): [] for name in runs for grad in (False, True)}

    def turn(name, grad):
        k = kg_ if grad else ks_
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            runs[name](k)
        torch.cuda.synchronize()
        us[(name, grad)].append((time.perf_counter() - t0) / calls * 1e6)

    for fn in runs.values():
        for _ in range(100):
            fn(ks_)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            for name in ("torch_native", "torch_function", "torch_function",
                         "torch_native"):
                turn(name, grad)
    fmt = " / ".join
    for grad in (False, True):
        what = "κ requiring a gradient" if grad else "no gradient"
        log(f"  host cost at {ns}² f32, forward, {what}, µs a call ({calls} "
            f"calls a turn, in turns): torch_native "
            f"{fmt(f'{t:.2f}' for t in us[('torch_native', grad)])}, "
            f"torch_function "
            f"{fmt(f'{t:.2f}' for t in us[('torch_function', grad)])}")

    nc = sizes["bridge_c"]
    rng = np.random.default_rng(SERVING_SEED)
    a = {name: rng.standard_normal((nc, nc)) for name in ("u", "kappa")}
    c_cot = rng.standard_normal((nc, nc))
    fwd, bwd = forward_program(op), backward_program(op)
    t = {name: torch.from_numpy(v) for name, v in a.items()}
    plain_f = make_torch_stencil(fwd)
    plain_b = make_torch_stencil(bwd, full_domain=True,
                                 adjoint_mask_ghost=fwd.ghost)
    cot_name = bwd.input_fields[0].name
    masked = np.zeros_like(c_cot)
    masked[fwd.interior_slices()] = c_cot[fwd.interior_slices()]
    b_in = {**a, cot_name: masked}
    b_in_t = {**t, cot_name: torch.from_numpy(c_cot)}
    def value_and_grad_cpu(fn):
        k = t["kappa"].clone().requires_grad_()
        uu = t["u"].clone().requires_grad_()
        out = fn(u=uu, kappa=k)
        return {"out": out.detach(), **dict(zip(
            ("gu", "gk"), torch.autograd.grad(out, [uu, k],
                                              torch.from_numpy(c_cot))))}

    cases = {
        "forward_kernel_cpu": (lambda: built["fwd_c"](a),
                               lambda: plain_f(t)),
        "backward_kernel_cpu": (lambda: built["bwd_c"](b_in),
                                lambda: plain_b(b_in_t)),
        "torch_native_value_grad": (
            lambda: value_and_grad_cpu(native),
            lambda: value_and_grad_cpu(op.torch_function()))}
    host = {}
    for name, (kern, plain) in cases.items():
        got_c, ref_c = kern(), plain()
        err = 0.0
        for key in ref_c:
            g, r = np.asarray(got_c[key]), np.asarray(ref_c[key])
            err = max(err, float(np.abs(g - r).max()
                                 / max(np.abs(r).max(), 1e-300)))
        host[name] = {"ms": _host_ms(kern), "plain_ms": _host_ms(plain),
                      "max_rel_err": err}
        log(f"  {name} {nc}² f64 on the host CPU: {host[name]['ms']:.3f} ms "
            f"a call, the plain version {host[name]['plain_ms']:.3f} ms; "
            f"max |diff| / max |ref| {err:.2e}")
        if err > TOL["float64"]:
            raise AssertionError(f"{name}: the C kernels differ from the "
                                 f"plain version ({err:.2e})")
    omp = built["fwd_c"].lib.omp_get_max_threads()
    cpu = _cpu_line()
    log(f"  host CPU: {cpu}, OpenMP threads {omp}, torch threads "
        f"{torch.get_num_threads()}; beside {card_line()}")
    if importlib.util.find_spec("tensorflow") is None:
        log("  TensorFlow is not installed here: the TensorFlow bridges are "
            "held on the CPU only (tests/test_torch_bridges_tf.py)")
    else:
        tff = op.create_tensorflow_op()
        import tensorflow as tf

        out = tff(*(tf.constant(a[name]) for name in tff.input_names))
        ref_tf = op.torch_function()(**t)
        err = float(np.abs(out.numpy() - ref_tf.numpy()).max())
        log(f"  TensorFlow {tf.__version__}: the shim at {nc}² f64 against "
            f"torch_function, max |diff| {err:.2e}")
        if err > TOL["float64"] * float(ref_tf.abs().max()):
            raise AssertionError(f"the TensorFlow shim differs ({err:.2e})")
    sec = time.perf_counter() - t_phase
    log(f"  bridge phase: {sec:.1f} s and its builds "
        f"{built['extension_s'] + built['c_kernels_s']:.1f} s")
    return {"extension_s": built["extension_s"],
            "c_kernels_s": built["c_kernels_s"],
            "host_us": {f"{name}{'_grad' if grad else ''}": v
                        for (name, grad), v in us.items()},
            "host_cpu": host, "omp_threads": omp, "cpu": cpu,
            "phase_s": sec}


# ---------------------------------------------------------------------------
# parallel/: the sharded stencil (config #5) and the sharded fused chains.

# the shard modes of the fused chain kernels (ops/flatten.py::ShardSpec):
# key -> (JSON name, source, the JAX kernel's shard= line)
SHARD_KERNELS = {
    "march_forward": (
        "stage_march[shard mode, forward: _make_stage_chain_kernel(shard=),"
        " make_plane_chain_kernel_fn(shard=)]",
        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
        "pystencils_autodiff_tpu/ops/stage_chain.py:146"),
    "march_two_phase": (
        "stage_march[shard mode, two-phase: fused_stage_chain_vjp(shard=)]",
        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
        "pystencils_autodiff_tpu/ops/stage_adjoint.py:87"),
    "march_chain_two_phase": (
        "stage_march[shard mode, two-phase over a 3D chain as a one-stage "
        "cycle: make_plane_chain_vjp_fn(shard=), row 9s's march design]",
        "pystencils_autodiff_tpu_torch/csrc/stage_march.cuh",
        "pystencils_autodiff_tpu/ops/plane_adjoint.py:90"),
    "plane_two_phase": (
        "plane_adjoint[shard mode, two-phase: make_plane_chain_vjp_fn("
        "shard=), row 9s's streaming design]",
        "pystencils_autodiff_tpu_torch/csrc/plane_adjoint.cuh",
        "pystencils_autodiff_tpu/ops/plane_adjoint.py:90"),
    "plane_forward": (
        "plane_adjoint[shard mode, forward: make_plane_chain_kernel_fn("
        "shard=), z-streaming]",
        "pystencils_autodiff_tpu_torch/csrc/plane_adjoint.cuh",
        "pystencils_autodiff_tpu/ops/plane_chain.py:94"),
}


def shard_launches():
    """Launches of each shard mode since the counters' last reset (their
    keys' design "march-shard", the streaming modes' "*_shard"; kernel
    13's 3D launches in shard mode are row 9s's march design)."""
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    n = dict.fromkeys(SHARD_KERNELS, 0)
    for mod, key in ((sc, "march_forward"), (tc, "march_forward"),
                     (sa, "march_two_phase")):
        for k, v in mod.LAUNCH_CALLS.items():
            if k[5] == "march-shard":
                n["march_chain_two_phase" if mod is sa and len(k[3]) == 3
                  else key] += v
    for k, v in pa.LAUNCH_CALLS.items():
        if k[5] in ("two_phase_shard", "forward_shard"):
            n["plane_" + k[5][:-len("_shard")]] += v
    return n


def shard_block(g, starts, sizes, periodic, lead=0):
    """The block of ``g``'s spatial dims (after ``lead`` index dims) that
    starts at global ``starts`` and spans ``sizes``: a shard's extended
    block, wrapped beyond a periodic domain, 0 beyond a bounded one (what
    the exchange gives an edge shard)."""
    import torch

    out = g
    for d, (s, n) in enumerate(zip(starts, sizes)):
        ax = lead + d
        idx = torch.arange(s, s + n, device=g.device)
        m = g.shape[ax]
        out = out.index_select(ax, idx.remainder(m))
        if not periodic:
            ok = ((idx >= 0) & (idx < m)).reshape(
                [-1 if a == ax else 1 for a in range(out.dim())])
            out = out * ok
    return out


def par_chains(sizes, device):
    """The phase's sharded chains, every shard on ``device`` (their
    kernels are built at first use): name -> (chain, global spatial,
    dtype).  Their halos give the shard blocks' shapes
    (``parallel_sources``)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                      heat_step_op)
    from pystencils_autodiff_tpu_torch.parallel import ShardedChain, make_mesh

    f32, f64 = torch.float32, torch.float64
    dev = torch.device(device)
    m4 = make_mesh((4,), ("x",), [dev] * 4)
    m22 = make_mesh((2, 2), ("x", "y"), [dev] * 4)
    nh, hk = sizes["par_heat"], sizes["heat_k"]
    heat = heat_step_op(dt=0.1)
    out = {
        "heat4": (ShardedChain(heat, hk, m4, {0: "x"}, carry_map=HEAT_CARRY,
                               periodic=True, fused_bwd=True), (nh, nh), f32),
        "heat1": (ShardedChain(heat, hk, make_mesh((1,), ("x",), [dev]),
                               {0: "x"}, carry_map=HEAT_CARRY, periodic=True,
                               fused_bwd=True), (nh, nh), f32),
        "elastic4": (ShardedChain(elastic_chain_stages(f32),
                                  sizes["elastic_k"], m4, {0: "x"},
                                  boundary=elastic_boundary(),
                                  fused_bwd=True),
                     (sizes["elastic"],) * 2, f32),
        "kappa22": (ShardedChain(diffusion3d_op(dt=DIFF_DT), sizes["cfg2_k"],
                                 m22, {0: "x", 1: "y"},
                                 carry_map=HEAT_CARRY, fused_bwd=True),
                    (sizes["cube"],) * 3, f32),
        "pathc22": (ShardedChain(lbm3d_op(f64), sizes["lbm_k"], m22,
                                 {0: "x", 1: "y"}, carry_map=LBM_CARRY,
                                 periodic=True, fused_bwd=True),
                    (sizes["lbm_f64"],) * 3, f64),
        # the fused backward's halo equal to the shard extent (the JAX
        # test_deep_halo_at_shard_extent), float64
        "deep": (ShardedChain(diffusion3d_op(dt=DIFF_DT, dtype="float64"), 2,
                              make_mesh((2, 4), ("x", "y"), [dev] * 8),
                              {0: "x", 1: "y"}, carry_map=HEAT_CARRY,
                              fused_bwd=True), sizes["par_deep"], f64),
    }
    return out


def par_blocks(chain, spatial):
    """(ShardSpec, local extents, forward block, fused-backward block) of a
    sharded chain at a global shape."""
    from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec

    local = [n // chain.mesh.shape[chain.dim_axes[d]]
             if d in chain.dim_axes else n for d, n in enumerate(spatial)]
    ext = [n + sum(chain.halo.get(d, (0, 0))) for d, n in enumerate(local)]
    bwd = getattr(chain, "_halo_bwd", {})
    extb = [n + sum(bwd.get(d, (0, 0))) for d, n in enumerate(local)]
    spec = ShardSpec(tuple(spatial), tuple(sorted(chain.dim_axes)))
    return spec, tuple(local), tuple(ext), tuple(extb)


def chain_libraries(chain, spatial, dtype, wanted):
    """(name, source) of the shard-mode libraries ``chain`` builds first at
    a global shape: the forward kernel and (fused backward) the adjoint,
    in the design and form their reckonings pick; a twin's forward
    kernel.  ``wanted``: the invariant fields whose gradient is asked."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_plane_source
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    dt = str(dtype).replace("torch.", "")
    isz = torch.tensor([], dtype=dtype).element_size()
    spec, _, ext, extb = par_blocks(chain, spatial)
    if chain._trivial:
        spec, ext, extb = None, tuple(spatial), tuple(spatial)
    out = []
    if chain._plane_ok:
        plan = chain._chain_plan(spec)
        if tc.forward_design(plan, ext, isz) == "stream":
            out.append((f"{plan.program.name}_plane_forward_shard_{dt}",
                        generate_plane_source(plan, "forward", dt)))
        else:
            out.append(_march_first(sm.chain_stage_plan(plan), None, ext, dt,
                                    None))
        if chain._fused_bwd:
            # row 9s in the design the route's reckoning picks (the
            # trivial mesh: the streaming kernel)
            ap = ac.AdjointPlan(plan)
            if (spec is not None
                    and tc.two_phase_design(ap, extb, isz, wanted) == "march"):
                out.append(_march_first(*sm.chain_march_plans(plan, wanted),
                                        extb, dt, None))
                return out
            form = pa.stream_geometry(plan, extb, isz, ap).form
            out.append((f"{plan.program.name}_plane_two_phase_shard_{form}_"
                        f"{dt}", generate_plane_source(ap, "two_phase", dt,
                                                       form)))
        return out
    plan = sc.StagePlan(chain.stages, chain.k, chain.periodic,
                        chain._boundary, chain._intermediates, shard=spec)
    out.append(_march_first(plan, None, ext, dt, None))
    if chain._twin is not None:
        out += chain_libraries(chain._twin, spatial, dtype, wanted)
    elif chain._fused_bwd:
        out.append(_march_first(plan, sa.AdjointStagePlan(plan, wanted), extb,
                                dt, None))
    return out


def parallel_sources(sizes):
    """(name, source) of the libraries the parallel phase adds: config #5's
    window single steps on the 2×2 mesh's extended blocks, and every
    sharded chain's shard-mode kernels (first-round march libraries, whose
    second round ``march_variants`` adds, and the streaming kernel's)."""
    from pystencils_autodiff_tpu_torch.models import diffusion3d_op
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)

    diff = diffusion3d_op(dt=DIFF_DT)
    n3 = sizes["cube"]
    out = step_sources([forward_program(diff), backward_program(diff)],
                       dtypes=("float32",), periodic=False,
                       spatial=(n3 // 2 + 2, n3 // 2 + 2, n3))
    # the fields each case differentiates (the deep-halo case: u alone,
    # so its march accumulates no κ gradient)
    grads = {"elastic4": ELASTIC_FIELDS, "deep": ("u",)}
    for name, (chain, spatial, dtype) in par_chains(sizes, "cpu").items():
        wanted = frozenset(grads.get(name, chain.input_names))
        out += chain_libraries(chain, spatial, dtype, wanted)
    return out


def in_turns(fns, order, reps=1):
    """Host-clock ms of each ``fns[label]()`` (ending in a synchronise),
    taken in the given order of labels after one warm-up run each,
    ``reps`` runs a turn: label -> list of ms per run, one per turn."""
    import torch

    out = {label: [] for label in fns}
    for fn in fns.values():
        fn()
    for label in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[label]()
        torch.cuda.synchronize()
        out[label].append((time.perf_counter() - t0) / reps * 1e3)
    return out


def _turns_text(t):
    return ", ".join(f"{label} {' / '.join(f'{x:.3f}' for x in v)} ms"
                     for label, v in t.items())


def _ratio(t, a, b):
    return statistics.mean(t[a]) / statistics.mean(t[b])


def abba(labels, n=5):
    """An order of turns taking each label ``n`` times: the labels, then
    them reversed, over again (A B B A A B ...)."""
    cycle = list(labels) + list(labels)[::-1]
    return tuple((cycle * n)[:n * len(labels)])


def _ratio_text(t, a, b):
    """``_ratio(t, a, b)`` and its spread: each of ``a``'s turns over the
    mean of ``b``'s, the least and the most."""
    mb = statistics.mean(t[b])
    return (f"{_ratio(t, a, b):.4f} (turns {min(t[a]) / mb:.4f}–"
            f"{max(t[a]) / mb:.4f})")


def _rel(a, b):
    """max |a − b| / max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def parallel_phase(sizes, dev, counted):
    """The port's ``parallel/`` on four shards of the one card (a mesh
    naming the card four times, as the JAX package's suite runs an 8-way
    mesh on one host), each end-to-end case held against the unsharded
    port on the same card and timed against it in turns (host clock):

    - config #5: ``sharded_diffusion3d`` (κ-diffusion, 384³ f32) on a 2×2
      mesh of dims (0, 1), an MSE value and gradient w.r.t. u and κ
      against ``diffusion3d_op`` unsharded (values bit-equal: one emitted
      body; gradients to f32 rounding); 2 transports per array and
      sharded dim in the forward, as many transposed in the backward;
    - the JAX package's config #5 row (``benchmarks/run_all.py``): the
      periodic heat ``ShardedChain`` k=8 with ``fused_bwd=True`` at 8192²
      f32, 2 chained value+VJP calls, on a 1-shard mesh (the trivial path:
      exactly the unsharded stage chain's and its twin's launches) and on
      a 4×1 mesh (the twin: kernel 12's shard mode on the cotangents);
    - rows 12 and 13 in shard mode: config #4's elastic gradient (Cerjan
      sponge, 8192² f32, 16 cycles, k=4, fused backward) on a 4×1 mesh,
      loss and the five gradients against the direct
      ``fused_stage_chain``;
    - rows 7 and 9 in shard mode (the plane route; 7s and 9s):
      config #2's κ-gradient (384³ f32, 16 steps, k=2, bounded, fused
      backward) on a 2×2 mesh against ``fused_time_chain`` (row 9s in the
      march design: ``time_chain.two_phase_design``); and path C's d/dU0
      in float64 at 128³ on a 2×2 mesh (D3Q19 periodic: the streaming
      forward mode, as unsharded at that shape, and row 9s in the
      streaming design) against the unsharded path;
    - each shard mode alone on an interior shard's extended block against
      its plain version with the same ``ShardSpec`` (``check_and_time``:
      state on the owned cells, cot_0 on the whole block for a cotangent
      on the owned cells): kernel 12 (elastic, 8192²), row 7 in the march
      (κ-diffusion, 384³), kernel 13 (elastic), row 9s (κ-diffusion in the
      march, D3Q19 f64 in the streaming kernel), the
      streaming forward mode (D3Q19 f64, 128³); and a ShardedChain whose
      fused-backward halo equals the shard extent (κ-diffusion f64 on a
      2×4 mesh) against the same chain on CPU tensors.

    Returns (kernel-vs-plain records by shard mode, launches of each shard
    mode in the end-to-end cases)."""
    import torch

    from pystencils_autodiff_tpu_torch.boundary import cerjan_damping
    from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                      heat_step_op,
                                                      sharded_diffusion3d)
    from pystencils_autodiff_tpu_torch.models.elastic import ELASTIC_FIELDS
    from pystencils_autodiff_tpu_torch.ops import (fused_stage_chain,
                                                   transposed_linear_op)
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.parallel import (exchange_count,
                                                        make_mesh,
                                                        reset_exchange_count,
                                                        shard_array)

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    card = card_line()
    tol = TOL["float32"]
    chains = par_chains(sizes, dev)
    totals = dict.fromkeys(SHARD_KERNELS, 0)
    records = {key: [] for key in SHARD_KERNELS}

    def run(fn):
        """``counted`` with the transports: (result, launches by family,
        shard-mode launches, transports, seconds)."""
        reset_exchange_count()
        res, got, sec = counted(fn, tally=False)
        sh = shard_launches()
        for key, n in sh.items():
            totals[key] += n
        return res, got, sh, exchange_count(), sec

    def only(d):
        return {key: v for key, v in d.items() if v}

    def per_shard(got, shards):
        return {f"{fam}/{nd}D": f"{n} ({n / shards:g} a shard)"
                for (fam, nd), n in sorted(got.items()) if n}

    # -- config #5 ---------------------------------------------------------
    n3 = sizes["cube"]
    mesh22 = make_mesh((2, 2), ("x", "y"), [dev] * 4)
    sd = sharded_diffusion3d(mesh22, dt=DIFF_DT)
    single = diffusion3d_op(dt=DIFF_DT).torch_function()
    gen = torch.Generator(device=dev).manual_seed(61)
    u5 = torch.randn((n3,) * 3, generator=gen, device=dev)
    k5 = 1.0 + 0.5 * torch.sigmoid(torch.randn((n3,) * 3, generator=gen,
                                               device=dev))
    tgt5 = torch.randn((n3,) * 3, generator=gen, device=dev)

    def vg5(f):
        u, k = u5.detach().requires_grad_(), k5.detach().requires_grad_()
        out = f(u=u, kappa=k)
        loss = torch.mean((out - tgt5) ** 2)
        return (out.detach(), loss) + torch.autograd.grad(loss, (u, k))

    (s_out, s_loss, s_gu, s_gk), s_n, _, s_x, _ = run(lambda: vg5(sd))
    (u_out, u_loss, u_gu, u_gk), u_n, _, _, _ = run(lambda: vg5(single))
    same = torch.equal(s_out, u_out)
    rels = {"loss": abs(s_loss.item() - u_loss.item()) / abs(u_loss.item()),
            "d/du": _rel(s_gu, u_gu), "d/dκ": _rel(s_gk, u_gk)}
    t5 = in_turns({"sharded": lambda: vg5(sd), "unsharded":
                   lambda: vg5(single)},
                  ("sharded", "unsharded", "unsharded", "sharded"), reps=2)
    log(f"  config #5, sharded_diffusion3d {n3}³ f32 on a 2×2 mesh of "
        f"{torch.cuda.get_device_name(0)} ({card}), MSE value+gradient "
        f"w.r.t. u and κ: forward bit-equal to the unsharded op: {same}; "
        f"rel diff {', '.join(f'{k} {v:.2e}' for k, v in rels.items())}; "
        f"launches sharded {per_shard(s_n, 4)}, unsharded {only(u_n)}; "
        f"transports a value+gradient {s_x} (forward {2 * 2 * 2}); host "
        f"clock in turns: {_turns_text(t5)}; sharded / unsharded "
        f"{_ratio(t5, 'sharded', 'unsharded'):.4f}")
    want5 = 2 * 2 * 2 * 2  # 2 arrays × 2 dims × 2 ways, and transposed
    if not same and _rel(s_out, u_out) > tol:
        raise AssertionError(f"config #5: sharded forward differs "
                             f"{_rel(s_out, u_out):.3e}")
    if max(rels.values()) > 10 * tol or s_x != want5:
        raise AssertionError(f"config #5: {rels}, transports {s_x} "
                             f"(expected {want5})")
    del s_out, u_out, s_gu, s_gk, u_gu, u_gk, u5, k5, tgt5

    # -- the JAX package's config #5 row: periodic heat, k=8 --------------
    nh, hk, calls = sizes["par_heat"], sizes["heat_k"], sizes["twin_calls"]
    heat = heat_step_op(dt=0.1)
    gen = torch.Generator(device=dev).manual_seed(62)
    uh = torch.randn((nh, nh), generator=gen, device=dev)
    ones = torch.ones_like(uh)
    cot_op, cot_carry, name_of, _ = transposed_linear_op(heat, HEAT_CARRY)
    fwd_u = fused_stage_chain([(heat, HEAT_CARRY)], hk, periodic=True)
    twin_u = fused_stage_chain([(cot_op, cot_carry)], hk, periodic=True)

    def row_sharded(chain):
        def f():
            st, ct = uh, ones
            for _ in range(calls):
                x = st.detach().requires_grad_()
                out = chain({"u": x})["u"]
                (g,) = torch.autograd.grad(out, x, ct)
                st, ct = out.detach(), g
            return st, ct
        return f

    def row_unsharded():
        st, ct = uh, ones
        for _ in range(calls):
            st, ct = (fwd_u({"u": st})["u"],
                      twin_u({name_of["u"]: ct})[name_of["u"]])
        return st, ct

    (h1, h1_n, _, h1_x, _) = run(row_sharded(chains["heat1"][0]))
    (hu, hu_n, _, _, _) = run(row_unsharded)
    (h4, h4_n, h4_sh, h4_x, _) = run(row_sharded(chains["heat4"][0]))
    th = in_turns({"4 shards": row_sharded(chains["heat4"][0]),
                   "1 shard": row_sharded(chains["heat1"][0]),
                   "unsharded": row_unsharded},
                  ("4 shards", "1 shard", "unsharded", "unsharded",
                   "1 shard", "4 shards"), reps=3)
    rel_h = max(_rel(a, b) for a, b in zip(h4, hu))
    rel_1 = max(_rel(a, b) for a, b in zip(h1, hu))
    log(f"  the JAX package's config #5 row: periodic heat ShardedChain "
        f"k={hk}, fused_bwd, {nh}² f32, {calls} chained value+VJP calls "
        f"({card}): 1 shard (trivial) launches {only(h1_n)}, transports "
        f"{h1_x}; the unsharded stage chain and its twin {only(hu_n)}; 4 "
        f"shards launches {per_shard(h4_n, 4)}, shard modes {only(h4_sh)}, "
        f"transports {h4_x} ({h4_x / calls:g} a call); vs unsharded rel "
        f"{rel_h:.2e} (1 shard {rel_1:.2e}); host clock in turns: "
        f"{_turns_text(th)}; 4 shards / unsharded "
        f"{_ratio(th, '4 shards', 'unsharded'):.4f}, 1 shard / unsharded "
        f"{_ratio(th, '1 shard', 'unsharded'):.4f}")
    if only(h1_n) != only(hu_n) or h1_x:
        raise AssertionError(f"trivial mesh launched {h1_n} with {h1_x} "
                             f"transports; the unsharded chain {hu_n}")
    if h4_x != 4 * calls or max(rel_h, rel_1) > 10 * tol:
        raise AssertionError(f"sharded heat row: transports {h4_x}, rel "
                             f"{rel_h:.2e} / {rel_1:.2e}")
    del h1, hu, h4, uh, ones

    # -- rows 12 and 13: config #4's elastic gradient on 4 shards ---------
    ne, ec, ek = sizes["elastic"], sizes["elastic_cycles"], sizes["elastic_k"]
    x0, direct_vg, _, observed = elastic_setup(ne, ec, ek, dev, f32)
    damp = cerjan_damping((ne, ne), width=FULL["sponge_width"], dtype=f32,
                          device=dev)
    echain = chains["elastic4"][0]

    # the state stays split over the mesh between calls (ShardedArrays),
    # as a sharded array stays sharded between the JAX package's calls
    damp_s = shard_array(damp, echain.mesh, ("x", None))

    def sharded_vg(x):
        ins = {nm: t.detach().requires_grad_() for nm, t in x.items()}
        st = {nm: shard_array(t, echain.mesh, ("x", None))
              for nm, t in ins.items()}
        st["damp"] = damp_s
        for _ in range(ec // ek):
            st = echain(st)
        loss = torch.mean((st["vx"].full() - observed) ** 2)
        grads = torch.autograd.grad(loss, [ins[nm] for nm in ELASTIC_FIELDS])
        return loss, dict(zip(ELASTIC_FIELDS, grads))

    ((e_loss, e_grads), e_n, e_sh, e_x, _) = run(lambda: sharded_vg(x0))
    ((d_loss, d_grads), d_n, _, _, _) = run(lambda: direct_vg(x0))
    rel_e = max([abs(e_loss.item() - d_loss.item()) / abs(d_loss.item())]
                + [_rel(e_grads[nm], d_grads[nm]) for nm in ELASTIC_FIELDS])
    te = in_turns({"sharded": lambda: sharded_vg(x0)[0].item(),
                   "direct": lambda: direct_vg(x0)[0].item()},
                  ("sharded", "direct", "direct", "sharded"), reps=3)
    log(f"  config #4's elastic gradient, {ne}² f32, {ec} cycles, k={ek}, "
        f"fused backward, on a 4×1 mesh ({card}): loss "
        f"{e_loss.item():.6e} vs direct {d_loss.item():.6e}, max rel "
        f"(loss, five gradients) {rel_e:.2e}; launches {per_shard(e_n, 4)}"
        f", direct {only(d_n)}; transports a gradient {e_x} "
        f"({e_x / (ec // ek):g} a call); host clock a gradient in turns: "
        f"{_turns_text(te)}; sharded / direct "
        f"{_ratio(te, 'sharded', 'direct'):.4f}")
    want_e = {"march_forward": 4 * ec // ek, "march_two_phase": 4 * ec // ek}
    if only(e_sh) != want_e or rel_e > 10 * tol:
        raise AssertionError(f"sharded elastic: shard launches {e_sh} "
                             f"(expected {want_e}), rel {rel_e:.2e}")
    del e_grads, d_grads, x0, observed, damp

    # -- rows 7 and 9s: config #2's κ-gradient on a 2×2 mesh --------------
    c2k, c2n = sizes["cfg2_k"], sizes["cfg2_steps"]
    kchain = chains["kappa22"][0]
    vg2, uchain = config2_sharded(sizes, dev, kchain)
    ((k_loss, k_g), k_n, k_sh, k_x, _) = run(lambda: vg2(kchain))
    ((ku_loss, ku_g), ku_n, _, _, _) = run(lambda: vg2(uchain))
    rel_k = max(abs(k_loss.item() - ku_loss.item()) / abs(ku_loss.item()),
                _rel(k_g, ku_g))
    tk = in_turns({"sharded": lambda: vg2(kchain)[0].item(),
                   "unsharded": lambda: vg2(uchain)[0].item()},
                  abba(("sharded", "unsharded")))
    calls2 = c2n // c2k
    log(f"  config #2's κ-gradient on a 2×2 mesh (the plane route), {n3}³ "
        f"f32, {c2n} steps, k={c2k} ({card}): loss {k_loss.item():.6e} vs "
        f"unsharded {ku_loss.item():.6e}, max rel (loss, d/dκ) "
        f"{rel_k:.2e}; launches {per_shard(k_n, 4)}, shard modes "
        f"{only(k_sh)}, unsharded {only(ku_n)}; transports a gradient {k_x}"
        f" ({k_x / calls2:g} a call); host clock a gradient in turns: "
        f"{_turns_text(tk)}; sharded / unsharded "
        f"{_ratio_text(tk, 'sharded', 'unsharded')}")
    # row 9s in the march design: one two-phase launch a shard and call
    if (only(k_sh) != {"march_forward": 4 * calls2,
                       "march_chain_two_phase": 4 * calls2}
            or rel_k > 10 * tol):
        raise AssertionError(f"sharded config #2: shard launches {k_sh}, "
                             f"rel {rel_k:.2e}")
    del k_g, ku_g, vg2

    # -- path C in float64 on a 2×2 mesh: the streaming shard modes -------
    nbd, lst, lk = sizes["lbm_f64"], sizes["lbm_steps"], sizes["lbm_k"]
    pchain = chains["pathc22"][0]
    vg_u = path_c_setup(nbd, lst, lk, dev, f64)
    vg_s = path_c_setup(nbd, lst, lk, dev, f64, chain=pchain)
    ((p_loss, p_g), p_n, p_sh, p_x, _) = run(lambda: vg_s(TG_U0))
    ((pu_loss, pu_g), pu_n, _, _, _) = run(lambda: vg_u(TG_U0))
    rel_p = max(abs(p_loss.item() - pu_loss.item()) / abs(pu_loss.item()),
                abs(p_g.item() - pu_g.item()) / abs(pu_g.item()))
    tp = in_turns({"sharded": lambda: vg_s(TG_U0)[0].item(),
                   "unsharded": lambda: vg_u(TG_U0)[0].item()},
                  ("sharded", "unsharded", "unsharded", "sharded"))
    callsp = lst // lk
    log(f"  path C, D3Q19 {nbd}³ f64 periodic on a 2×2 mesh, {lst} steps, "
        f"k={lk} ({card}): loss {p_loss.item():.6e} vs unsharded "
        f"{pu_loss.item():.6e}, d/dU0 {p_g.item():.6e} vs "
        f"{pu_g.item():.6e}, max rel {rel_p:.2e}; launches "
        f"{per_shard(p_n, 4)}, shard modes {only(p_sh)}, unsharded "
        f"{only(pu_n)}; transports a gradient {p_x} ({p_x / callsp:g} a "
        f"call); host clock a gradient in turns: {_turns_text(tp)}; "
        f"sharded / unsharded {_ratio(tp, 'sharded', 'unsharded'):.4f}")
    if (only(p_sh) != {"plane_forward": 4 * callsp,
                       "plane_two_phase": 4 * callsp}
            or rel_p > 1e-10):
        raise AssertionError(f"sharded path C: shard launches {p_sh}, rel "
                             f"{rel_p:.2e}")
    del vg_u, vg_s

    # -- each shard mode alone, against its plain version -----------------
    records["march_forward"].append(_shard_case_stage(
        "elastic sponge k4 shard 1/4 f32", chains["elastic4"], None, dev,
        sc))
    records["march_forward"].append(_shard_case_chain(
        "diffusion3d k2 shard (1,1)/2x2 f32, march", chains["kappa22"],
        "march", dev, tc))
    records["march_two_phase"].append(_shard_case_stage(
        "elastic sponge adjoint k4 shard 1/4 f32", chains["elastic4"],
        frozenset(ELASTIC_FIELDS), dev, sa))
    records["march_chain_two_phase"].append(_shard_case_chain(
        "diffusion3d adjoint k2 shard (1,1)/2x2 f32, march",
        chains["kappa22"], "two_phase", dev))
    records["plane_forward"].append(_shard_case_chain(
        "d3q19 k2 periodic shard (1,1)/2x2 f64, stream", chains["pathc22"],
        "stream", dev, pa))
    # row 9s on path C's f64 shard too (its design and form the
    # reckonings': the streaming kernel)
    records["plane_two_phase"].append(_shard_case_chain(
        "d3q19 adjoint k2 periodic shard (1,1)/2x2 f64", chains["pathc22"],
        "two_phase", dev))
    deep, dspatial, _ = chains["deep"]
    res = []
    gen_d = torch.Generator().manual_seed(63)
    ud = torch.randn(dspatial, generator=gen_d, dtype=f64)
    kd = 1 + 0.1 * torch.randn(dspatial, generator=gen_d, dtype=f64) ** 2
    cd = torch.randn(dspatial, generator=gen_d, dtype=f64)
    for device in (dev, torch.device("cpu")):
        ch = deep if device == dev else par_chains(sizes, "cpu")["deep"][0]
        x = ud.to(device).requires_grad_()
        out = ch({"u": x, "kappa": kd.to(device)})["u"]
        (g,) = torch.autograd.grad(out, x, cd.to(device))
        res.append((out.cpu(), g.cpu()))
    rel_d = max(_rel(res[0][0], res[1][0]), _rel(res[0][1], res[1][1]))
    log(f"  deep halo: κ-diffusion f64 {dspatial} on a 2×4 mesh, fused "
        f"backward halo {deep._halo_bwd} = the shard extent: card vs CPU "
        f"rel {rel_d:.2e}")
    if rel_d > 1e-12:
        raise AssertionError(f"deep halo: card vs CPU {rel_d:.2e}")
    log(f"  parallel phase: {time.perf_counter() - t_phase:.1f} s; shard-"
        f"mode launches in the end-to-end cases {totals}")
    for key, n in totals.items():
        if n == 0:
            raise AssertionError(f"no end-to-end case launched the shard "
                                 f"mode {key}")
    return records, totals


def config2_sharded(sizes, dev, kchain):
    """Config #2's κ-gradient (``sizes["cfg2_steps"]`` steps of κ-diffusion
    at ``sizes["cube"]``³ f32, k = ``sizes["cfg2_k"]``, bounded; the MSE of
    the final u against an observation the unsharded chain makes from a
    seeded κ_true, at κ = 1.25) through a sharded chain like ``kchain``
    (its state split once and kept split between calls) and unsharded:
    ``(vg(chain) -> (loss, dL/dκ), the unsharded fused_time_chain)``."""
    import torch

    from pystencils_autodiff_tpu_torch.models import diffusion3d_op
    from pystencils_autodiff_tpu_torch.ops import fused_time_chain
    from pystencils_autodiff_tpu_torch.parallel import shard_array

    n3, c2k, c2n = sizes["cube"], sizes["cfg2_k"], sizes["cfg2_steps"]
    gen_c = torch.Generator().manual_seed(11)  # config2_setup's
    u0 = torch.randn((n3,) * 3, generator=gen_c).to(dev)
    k_true = (1.0 + 0.5 * torch.sigmoid(torch.randn(
        (n3,) * 3, generator=gen_c))).to(dev)
    uchain = fused_time_chain(diffusion3d_op(dt=DIFF_DT), c2k, HEAT_CARRY,
                              fused_bwd=True)

    def final(chain, kappa):
        st = {"u": u0, "kappa": kappa}
        sharded = chain is not uchain
        if sharded:
            st = {n: shard_array(t, chain.mesh, ("x", "y"))
                  for n, t in st.items()}
        for _ in range(c2n // c2k):
            st = chain(st)
        return st["u"].full() if sharded else st["u"]

    with torch.no_grad():
        obs2 = final(uchain, k_true)
    kap0 = torch.full_like(k_true, 1.25)
    del k_true

    def vg2(chain):
        kap = kap0.detach().requires_grad_()
        loss = torch.mean((final(chain, kap) - obs2) ** 2)
        return (loss,) + torch.autograd.grad(loss, kap)

    return vg2, uchain


def _interior_block(chain, spatial, dtype, dev, halo, seed, fields,
                    periodic, owned_at=1):
    """An interior shard's block (mesh coordinate ``owned_at`` along every
    sharded axis) extended by ``halo`` per dim, from a seeded global
    state; returns (block by field, bases, owned slices)."""
    import torch

    from pystencils_autodiff_tpu_torch.parallel.sharding import spatial_lead

    nd = len(spatial)
    local = [n // chain.mesh.shape[chain.dim_axes[d]]
             if d in chain.dim_axes else n for d, n in enumerate(spatial)]
    starts = [owned_at * local[d] - halo[d][0] if d in chain.dim_axes else 0
              for d in range(nd)]
    sizes = [local[d] + sum(halo[d]) if d in chain.dim_axes else spatial[d]
             for d in range(nd)]
    gen = torch.Generator().manual_seed(seed)
    blk = {}
    for name, kind in fields.items():
        f = chain.state_fields[name]
        shape = tuple(f.index_shape if spatial_lead(f) else ()) + tuple(
            spatial) + tuple(() if spatial_lead(f) else f.index_shape)
        g = torch.randn(shape, generator=gen, dtype=dtype)
        if kind == "positive":
            g = 1.0 + 0.5 * torch.sigmoid(g)
        elif kind == "damp":
            g = 0.8 + 0.2 * torch.sigmoid(g)
        elif kind == "lbm":
            g = (1.0 + 0.1 * g) / g.shape[0]
        blk[name] = shard_block(g, starts, sizes, periodic,
                                spatial_lead(f)).to(dev).contiguous()
    owned = [slice(halo[d][0], halo[d][0] + local[d])
             if d in chain.dim_axes else slice(None) for d in range(nd)]
    return blk, starts, owned


def _owned_view(chain, name, t, owned):
    from pystencils_autodiff_tpu_torch.parallel.sharding import spatial_lead

    lead = spatial_lead(chain.state_fields[name])
    return t[(slice(None),) * lead + tuple(owned)]


def _shard_case_stage(name, entry, wanted, dev, counter):
    """Kernel 12 (``wanted`` None) or kernel 13 in shard mode on shard 1's
    block (the forward's or the fused backward's halo) against the plain
    shard mode (``check_and_time``: state on the owned cells, cot_0 on the
    whole block for a cotangent on the owned cells)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops.common import storage_spatial

    chain, spatial, dtype = entry
    spec = par_blocks(chain, spatial)[0]
    plan = sc.StagePlan(chain.stages, chain.k, chain.periodic,
                        chain._boundary, shard=spec)
    halo = chain.halo if wanted is None else chain._halo_bwd
    halo = [halo.get(d, (0, 0)) for d in range(plan.nd)]
    kinds = {n: "damp" if n == "damp" else "plain" for n in plan.state_names}
    blk, bases, owned = _interior_block(chain, spatial, dtype, dev, halo, 64,
                                        kinds, chain.periodic)
    n0 = plan.state_names[0]
    cells = math.prod(storage_spatial(chain.state_fields[n0], blk[n0]))
    names = sorted(plan.state_names)
    if wanted is None:
        kern, plain = sc.make_stage_kernel(plan), sc.plain_stage_chain(plan)
        return check_and_time(
            name, lambda: kern(blk, bases=bases), lambda: plain(blk, bases),
            TOL["float32"], list(blk.values()), counter, dev,
            ops=stage_ops(plan, cells),
            compare=lambda i, t: _owned_view(chain, names[i], t, owned))
    ap = sa.AdjointStagePlan(plan, wanted)
    gen = torch.Generator(device=dev).manual_seed(65)
    cots = {}
    for n in ap.cot_names:
        c = torch.zeros_like(blk[n])
        view = _owned_view(chain, n, c, owned)
        view.copy_(torch.randn(view.shape, generator=gen, device=dev,
                               dtype=dtype))
        cots[n] = c
    kern = sa.make_stage_adjoint_kernel(ap)
    plain = sa.plain_stage_chain_vjp(ap)
    return check_and_time(
        name, lambda: kern(blk, cots, bases=bases),
        lambda: plain(blk, cots, bases), TOL["float32"],
        list(blk.values()) + list(cots.values()), counter, dev,
        ops=stage_ops(plan, cells, ap), out_scale=lambda i: 10.0,
        compare=lambda i, t: (_owned_view(chain, names[i], t, owned)
                              if i < len(names) else t))


def _shard_case_chain(name, entry, mode, dev, counter=None, design=None):
    """Row 7 in shard mode (``mode`` "march" or "stream": the forward
    chain in that design, its launches on ``counter``) or row 9s
    (``mode`` "two_phase": ``design``, or where None the design
    ``time_chain.two_phase_design`` picks for the block, as the route runs
    it — the march's two-phase mode, counted on ``ops.stage_adjoint``, or
    the streaming kernel in the form its reckoning picks, on
    ``ops.plane_adjoint``) on the block of shard (1, 1) against the plain
    shard mode (``check_and_time``)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops.common import storage_spatial

    chain, spatial, dtype = entry
    plan = chain._chain_plan(par_blocks(chain, spatial)[0])
    fwd = mode != "two_phase"
    halo = chain.halo if fwd else chain._halo_bwd
    halo = [halo.get(d, (0, 0)) for d in range(3)]
    kinds = {n: ("lbm" if n == "f" else "positive" if n == "kappa"
                 else "plain") for n in plan.in_names}
    blk, bases, owned = _interior_block(chain, spatial, dtype, dev, halo, 66,
                                        kinds, plan.periodic)
    n0 = plan.in_names[0]
    cells = math.prod(storage_spatial(chain.state_fields[n0], blk[n0]))
    names = sorted(plan.in_names)
    ops = plan.k * cells * program_ops(plan.program.steps)
    if fwd:
        kern = tc.make_chain_kernel(plan, design=mode)
        plain = tc.plain_time_chain(plan)
        return check_and_time(
            name, lambda: kern(blk, bases)[0], lambda: plain(blk, bases)[0],
            TOL[str(dtype).replace("torch.", "")], list(blk.values()),
            counter, dev, ops=ops,
            compare=lambda i, t: _owned_view(chain, names[i], t, owned))
    ap = ac.AdjointPlan(plan)
    gen = torch.Generator(device=dev).manual_seed(67)
    cots = {n: torch.zeros_like(t) for n, t in blk.items()}
    for n in plan.in_names:
        if n not in plan.invariant:
            view = _owned_view(chain, n, cots[n], owned)
            view.copy_(torch.randn(view.shape, generator=gen, device=dev,
                                   dtype=dtype))
    wanted = frozenset(plan.in_names)
    design = design or tc.two_phase_design(
        ap, tuple(storage_spatial(chain.state_fields[n0], blk[n0])),
        blk[n0].element_size(), wanted)
    if design == "march":
        kern, counter = ac.make_chain_march_kernel(plan, sa, wanted), sa
    else:
        kern, counter = pa.make_plane_adjoint_kernel(ap), pa
    plain = ac.plain_chain_vjp(ap)
    return check_and_time(
        name, lambda: kern(blk, cots, (), bases),
        lambda: plain(blk, cots, (), bases),
        TOL[str(dtype).replace("torch.", "")],
        list(blk.values()) + list(cots.values()), counter, dev,
        ops=ops + plan.k * cells * program_ops(ap.bwd.steps),
        out_scale=lambda i: 10.0,
        compare=lambda i, t: (_owned_view(chain, names[i], t, owned)
                              if i < len(names) else t))


# ---------------------------------------------------------------------------
# Ranks and second order: 1D and 4D ops through the window kernel, the
# κ-heat HVP through the tangent-linear program, and config #5's sharded
# run exported.

@functools.lru_cache(maxsize=None)
def rank_ops():
    """(the 1D κ-heat, the 4D Laplacian — the 3-point second difference in
    each of the 4 dims, 9 points), f32, built once."""
    from pystencils_autodiff_tpu_torch import Assignment, AutoDiffOp, fields

    u, k, out = fields("u, kappa, u_next", 1, dtype="float32")
    heat1 = AutoDiffOp([Assignment(out.center, u[(0,)] + 0.1 * k[(0,)]
                                   * (u[(1,)] + u[(-1,)] - 2 * u[(0,)]))],
                       op_name="kappa_heat1d")
    x, y = fields("x, y", 4, dtype="float32")
    unit = [tuple(int(e == d) for e in range(4)) for d in range(4)]
    lap = sum(x[e] + x[tuple(-o for o in e)] - 2 * x.center for e in unit)
    return heat1, AutoDiffOp([Assignment(y.center, lap)],
                             op_name="laplacian4d")


def hvp_entry():
    """The κ-heat op's ``torch_function`` (f32) and its tangent-linear
    entry along (κ, u) with the adjoints of both: the programs an HVP
    launches beside f and B (``vjp.StencilEntry.tangent``)."""
    from pystencils_autodiff_tpu_torch.models import heat_step_op

    f = heat_step_op(kappa_field=True).torch_function()
    names = f.entry.in_names
    tent, _ = f.entry.tangent(names, names)
    return f, tent


def rank_sources(sizes):
    """(name, source) of the ranks and second-order phases' libraries: the
    rank cases' window and per-cell forms (``rank_cases``), and the κ-heat
    tangent program's forward and backward at the HVP's 8192² f32."""
    out = case_sources(rank_cases(sizes))
    _, tent = hvp_entry()
    n = sizes["hvp"]
    out += step_sources([tent.recipe["fwd"]] + tent.recipe["bwd"],
                        dtypes=("float32",), periodic=False, spatial=(n, n))
    return out


def rank_cases(sizes):
    """The ranks phase's kernel-vs-plain cases: (name, program, spatial,
    dtype, step kwargs, rtol, the kernels line's row)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)

    f32, f64 = torch.float32, torch.float64
    heat1, lap4 = rank_ops()
    h1f, h1b = forward_program(heat1), backward_program(heat1)
    l4f, l4b = forward_program(lap4), backward_program(lap4)
    n1, n4, n4d = sizes["rank1d"], sizes["rank4d"], sizes["rank4d_f64"]

    def mask(fp):
        return {"full_domain": True, "adjoint_mask_ghost": fp.ghost}

    row1, row2 = "_run_whole_array", "_run_blocked"
    return [
        ("kappa-heat 1D fwd interior f32", h1f, (n1,), f32, {}, 1e-5, row1),
        ("kappa-heat 1D bwd full+mask f32", h1b, (n1,), f32, mask(h1f), 1e-5,
         row1),
        ("laplacian 4D fwd interior f32", l4f, (n4,) * 4, f32, {}, 1e-5,
         row2),
        ("laplacian 4D bwd full+mask f32", l4b, (n4,) * 4, f32, mask(l4f),
         1e-5, row2),
        ("laplacian 4D fwd interior f64", l4f, (n4d,) * 4, f64, {}, 1e-12,
         row2),
        ("laplacian 4D bwd full+mask f64", l4b, (n4d,) * 4, f64, mask(l4f),
         1e-12, row2),
        ("laplacian 4D fwd periodic f64", l4f, (n4d,) * 4, f64,
         {"periodic": True}, 1e-12, row2),
        ("laplacian 4D bwd periodic f64", l4b, (n4d,) * 4, f64,
         {"full_domain": True, "periodic": True}, 1e-12, row2),
    ]


def ranks_phase(sizes, dev, gen):
    """Fault #18's repair on the card: the 1D κ-heat at 2²⁶ f32 (row 1:
    ``_run_whole_array`` is the JAX package's only Pallas kernel of rank
    1) and the 4D Laplacian at 96⁴ f32 and 24⁴ f64 (row 2:
    ``_run_blocked`` merges the leading dims into rows), forward and
    backward against the plain version (``compare_case``: beside the copy
    of the bytes, the bound and the per-cell kernel, in turns), then each
    op's value+gradient through ``torch_function`` at full size: exactly
    1 + 1 window launches and no plain-version evaluation.  Returns
    (records, window launches of the value+gradient runs by row,
    numbers)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import torch_ref

    heat1, lap4 = rank_ops()
    n1, n4 = sizes["rank1d"], sizes["rank4d"]
    row1, row2 = "_run_whole_array", "_run_blocked"
    records = [compare_case(c[:6], dev, gen, counterpart=c[6])
               for c in rank_cases(sizes)]
    numbers = {r["case"]: {"ms": r["ms"], "copy_ms": r["copy_ms"],
                           "bound_ms": r["bound_ms"],
                           "kernel_over_copy": r["ms"] / r["copy_ms"]}
               for r in records}
    launches = {row1: 0, row2: 0}
    for op, spatial, row in ((heat1, (n1,), row1), (lap4, (n4,) * 4, row2)):
        f = op.torch_function()
        ins = [torch.randn(spatial, generator=gen, device=dev)
               for _ in op.forward_input_fields]
        ins = [1.0 + 0.5 * torch.sigmoid(t) if fl.name == "kappa" else t
               for t, fl in zip(ins, op.forward_input_fields)]

        def value_and_grad():
            xs = [t.detach().requires_grad_() for t in ins]
            out = f(*xs)
            return (out,) + torch.autograd.grad((out * out).sum(), xs)

        value_and_grad()  # every library in place
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        plain0 = torch_ref.PLAIN_CALLS
        res = value_and_grad()
        torch.cuda.synchronize()
        got, forms = ck.LAUNCHES, {k[-1] for k in ck.LAUNCH_CALLS}
        launches[row] += got
        if (got, forms) != (2, {"window"}) \
                or torch_ref.PLAIN_CALLS != plain0 \
                or not all(torch.isfinite(t).all() for t in res):
            raise AssertionError(
                f"{op.op_name}: value+gradient took {got} launches of "
                f"{forms} (expected 1 + 1 window launches), plain-version "
                f"calls {torch_ref.PLAIN_CALLS - plain0}, or non-finite "
                f"values")
        ms = cuda_ms(value_and_grad)
        numbers[f"{op.op_name} value+gradient"] = {"ms": ms, "launches": got}
        log(f"  {op.op_name} {'x'.join(map(str, spatial))} f32 value+"
            f"gradient through torch_function: {got} window launches (1 + "
            f"1), no plain-version call, {ms:.3f} ms")
        del res, ins
        torch.cuda.empty_cache()
    return records, launches, numbers


def hvp_phase(sizes, dev, gen):
    """Fault #17's repair on the card: the HVP of the κ-heat loss Σ f(u, κ)²
    at 8192² f32 with respect to (κ, u) along a seeded direction, by
    reverse over reverse (``create_graph=True``) and by forward over
    reverse (``torch.func.jvp`` of ``torch.func.grad``): every launch a
    window kernel — 5 each way (f, B, the tangent program T, T's backward
    and B again; forward over reverse f, T, B, B on the cotangent's
    tangent, T's backward) — and no plain-version evaluation; the two
    equal each other and the plain version differentiated twice by torch
    autograd on the card (the reference), to rtol 1e-5 with atol 1e-5 of
    max |ref|; the ms of an HVP against a value+gradient (CUDA events).
    Returns (window launches of the two HVPs by row, numbers)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import (forward_program,
                                                   make_torch_stencil)
    from pystencils_autodiff_tpu_torch.ops import torch_ref

    n = sizes["hvp"]
    f, tent = hvp_entry()
    op = f.op
    names = [fl.name for fl in op.forward_input_fields]
    xs = [torch.randn((n, n), generator=gen, device=dev) for _ in names]
    xs = [1.0 + 0.5 * torch.sigmoid(t) if nm == "kappa" else t
          for t, nm in zip(xs, names)]
    vs = [torch.randn((n, n), generator=gen, device=dev) for _ in names]
    plain_f = make_torch_stencil(forward_program(op))

    def loss(*a):
        out = f(*a)
        return (out * out).sum()

    def loss_plain(*a):
        out = plain_f(dict(zip(names, a)))["u_next"]
        return (out * out).sum()

    def rr(fn=loss):
        ts = [x.detach().requires_grad_() for x in xs]
        g = torch.autograd.grad(fn(*ts), ts, create_graph=True)
        return torch.autograd.grad(sum((gi * vi).sum()
                                       for gi, vi in zip(g, vs)), ts)

    def fr():
        grad = torch.func.grad(loss, argnums=tuple(range(len(xs))))
        return torch.func.jvp(grad, tuple(xs), tuple(vs))[1]

    def value_and_grad():
        ts = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(loss(*ts), ts)

    rr(), fr()  # every library in place
    counts, launches = {}, 0
    plain0 = torch_ref.PLAIN_CALLS
    for label, fn in (("reverse over reverse", rr),
                      ("forward over reverse", fr)):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[label] = (ck.LAUNCHES, {k[-1] for k in ck.LAUNCH_CALLS}, res)
        launches += ck.LAUNCHES
    if torch_ref.PLAIN_CALLS != plain0:
        raise AssertionError(f"HVP: the plain version ran "
                             f"{torch_ref.PLAIN_CALLS - plain0} times")
    ref = rr(loss_plain)
    errs = {}
    for label, (got, forms, res) in counts.items():
        if (got, forms) != (5, {"window"}):
            raise AssertionError(f"HVP {label}: {got} launches of {forms} "
                                 f"(expected 5 window launches)")
        for nm, h, r in zip(names, res, ref):
            scale = r.abs().max().item()
            e = (h - r).abs().max().item()
            errs[f"{label} d/d{nm}"] = e / scale
            if not e <= TOL["float32"] * scale \
                    or not torch.isfinite(h).all():
                raise AssertionError(f"HVP {label} d/d{nm}: max |diff| "
                                     f"{e:.3e} against the plain version "
                                     f"(max |ref| {scale:.3e})")
    agree = max(((a - b).abs().max() / b.abs().max()).item() for a, b in
                zip(counts["reverse over reverse"][2],
                    counts["forward over reverse"][2]))
    if agree > TOL["float32"]:
        raise AssertionError(f"HVP: the two modes differ by {agree:.3e}")
    del ref, counts
    torch.cuda.empty_cache()
    ms = {"hvp_rr_ms": cuda_ms(rr), "hvp_fr_ms": cuda_ms(fr),
          "value_and_grad_ms": cuda_ms(value_and_grad)}
    log(f"  κ-heat {n}² f32 HVP w.r.t. (κ, u): 5 window launches by "
        f"reverse over reverse and 5 by forward over reverse, no plain-"
        f"version call; max |diff| / max |ref| against the plain version "
        f"twice differentiated by autograd: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; the two modes {agree:.2e}; {ms['hvp_rr_ms']:.3f} ms (RR), "
        f"{ms['hvp_fr_ms']:.3f} ms (FR) against {ms['value_and_grad_ms']:.3f}"
        f" ms a value+gradient ({ms['hvp_rr_ms'] / ms['value_and_grad_ms']:.2f}"
        f"x)")
    return {"_run_blocked": launches}, {**ms, "launches_rr": 5,
                                        "launches_fr": 5, "rel_err": errs,
                                        "modes_rel": agree}


def sharded_export_phase(sizes, dev, work):
    """Config #5's run exported: the κ-diffusion sweep at 384³ f32 recorded
    in a ``GraphDataHandling`` and compiled with ``mesh=`` (a 2×2 mesh of
    the card, ``fuse="none"``: every sweep a ``ShardedStencil``, its
    exchanges ``psat::halo`` ops), ``sharded_steps`` steps, exported with
    its gradient, saved and loaded in a fresh ``python3``
    (``sharded_child``: jax and the JAX package blocked): the forward and
    the VJP bit-equal to the eager sharded run, with the eager run's
    transports and window launches; the eager run equal to the unsharded
    replay to f32 rounding.  Returns a function that awaits the fresh
    process (it runs beside the caller's next phase) and checks it."""
    import torch

    from pystencils_autodiff_tpu_torch.graph_datahandling import \
        GraphDataHandling
    from pystencils_autodiff_tpu_torch.models import diffusion3d_op
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.parallel import (exchange_count,
                                                        make_mesh,
                                                        reset_exchange_count)
    from pystencils_autodiff_tpu_torch.serving import (export_program,
                                                       save_exported)

    n3, steps = sizes["cube"], sizes["sharded_steps"]
    dh = GraphDataHandling((n3 - 2,) * 3, ghost_layers=1,
                           default_dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(63)
    dh.add_field("u")
    dh.add_field("kappa")
    dh.set_array("u", torch.randn((n3,) * 3, generator=gen, device=dev))
    dh.set_array("kappa", 1.0 + 0.5 * torch.sigmoid(torch.randn(
        (n3,) * 3, generator=gen, device=dev)))
    with dh.timeloop() as loop:
        loop.sweep(diffusion3d_op(dt=DIFF_DT), {"u": "u_next"})
    mesh = make_mesh((2, 2), ("x", "y"), [dev] * 4)
    run = dh.compile(mesh=mesh, dim_axes={0: "x", 1: "y"})
    state = dh.state()
    names = sorted(state)
    cots = [torch.randn((n3,) * 3, generator=gen, device=dev) for _ in names]

    def eager():
        xs = {nm: state[nm].detach().requires_grad_() for nm in names}
        out = run(xs, steps)
        grads = torch.autograd.grad([out[nm] for nm in names],
                                    [xs[nm] for nm in names], cots)
        return [out[nm].detach() for nm in names] + list(grads)

    def counts(fn):
        """(result, transports, window launches) of ``fn()``."""
        torch.cuda.synchronize()
        reset_exchange_count()
        ck.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, exchange_count(), ck.LAUNCHES

    eager()
    _, fwd_x, fwd_n = counts(lambda: run(dict(state), steps))
    ref, vg_x, vg_n = counts(eager)
    # the VJP artifact traces the forward and the backward together
    want = {"forward": [fwd_x, fwd_n], "vjp": [vg_x, vg_n]}
    flat = run(dict(state), steps)
    unsharded = dh.compile(mesh=None, dim_axes={})(dict(state), steps)
    rel = max(((flat[nm] - unsharded[nm]).abs().max()
               / unsharded[nm].abs().max()).item() for nm in names)
    if rel > TOL["float32"]:
        raise AssertionError(f"config #5 sharded run differs from the "
                             f"unsharded replay by {rel:.3e}")
    t0 = time.perf_counter()
    exp = export_program(run, state, steps)
    ops = sorted({str(nd.target) for nd in exp.primal.graph_module.graph.nodes
                  if str(nd.target).startswith("psat.")})
    save_exported(exp, str(work / "sharded.pt2"))
    export_s = time.perf_counter() - t0
    torch.save({"state": [state[nm] for nm in names], "cots": cots},
               str(work / "sharded_in.pt"))
    # the loaded graphs copy a halo slab to each shard a transport reaches
    # (two on each axis of the 2×2 bounded mesh)
    from pystencils_autodiff_tpu_torch.parallel.halo import _shift_pairs

    reach = {len(_shift_pairs(mesh, ax, d, False)) for ax in ("x", "y")
             for d in (1, -1)}
    if len(reach) != 1:
        raise AssertionError(f"transports reach {reach} shards")
    per = reach.pop()
    want = {k: [x * per, launches] for k, (x, launches) in want.items()}
    (work / "sharded.json").write_text(json.dumps({
        "device": str(dev), "sha": [_sha(t) for t in ref], **want}))
    del exp, flat, unsharded
    t0 = time.perf_counter()
    wait = torch_only_child("sharded_child", work, 600)
    return lambda: sharded_export_check(wait, t0, want, ops, per, rel,
                                        export_s, n3, steps)


def sharded_export_check(wait, t0, want, ops, per, rel, export_s, n3,
                         steps):
    """``sharded_export_phase``'s fresh process awaited (``wait``, started
    at ``t0``) and its result held against the eager run's."""
    out = wait()
    child_s = time.perf_counter() - t0
    got = json.loads(out.strip().splitlines()[-1])
    log(f"  config #5 (κ-diffusion {n3}³ f32, {steps} steps, 2×2 mesh of "
        f"the card, fuse=\"none\") exported with its gradient ({export_s:.1f}"
        f" s; the graph's ops of the port {ops}), loaded in a fresh process "
        f"through the torch-only load ({child_s:.1f} s from the parent, "
        f"{got['child_wall_s']:.1f} s inside; CUDA set-up "
        f"{got['cuda_init_s']:.3f} s, torch.export.load and binds "
        f"{got['load_s']:.2f} s; {card_line()}): forward and VJP bit-equal "
        f"to eager {got['equal']}; (halo copies, window launches) of the "
        f"loaded forward {got['forward']} and VJP {got['vjp']} (eager: "
        f"transports × {per} shards reached, launches: forward "
        f"{want['forward']}, value+gradient {want['vjp']}); eager sharded "
        f"vs unsharded rel {rel:.2e}")
    if ops:
        raise AssertionError(f"the exported graph holds the port's ops {ops}")
    if not got["equal"] or got["forward"] != want["forward"] \
            or got["vjp"] != want["vjp"]:
        raise AssertionError(f"config #5 artifact: {got}, expected {want}")
    return {"export_s": export_s, "child_s": child_s,
            "load_s": got["load_s"], "forward": got["forward"],
            "vjp": got["vjp"], "rel_unsharded": rel}


def sharded_child(workdir: str) -> int:
    """The fresh process of ``sharded_export_phase``: loads config #5's
    artifact through the torch-only load (the port, jax and the JAX
    package blocked, no compiler on the PATH), runs its forward and VJP on
    the card with the leaf op's launches and the graphs' halo copies
    counted, and prints one JSON line (whether every result's sha256
    equals eager's, the counts, the wall, CUDA set-up and load times)."""
    t_child = time.perf_counter()
    block_the_port()
    import torch

    work = Path(workdir)
    m = json.loads((work / "sharded.json").read_text())
    dev = torch.device(m["device"])
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    out = {"cuda_init_s": time.perf_counter() - t0}
    data = torch.load(str(work / "sharded_in.pt"), map_location=dev)
    t0 = time.perf_counter()
    primal, vjp, meta = torch_only_load(str(work / "sharded.pt2"))
    out["load_s"] = time.perf_counter() - t0
    fn, vfn = primal.module(), vjp.module()
    fn(*data["state"]), vfn(*data["state"], *data["cots"])  # warm
    res = []
    for label, ep, call in (
            ("forward", primal, lambda: fn(*data["state"])),
            ("vjp", vjp, lambda: vfn(*data["state"], *data["cots"]))):
        torch.cuda.synchronize()
        torch.ops.psat_launch.reset_launch_counts()
        res += list(call())
        torch.cuda.synchronize()
        out[label] = [halo_copies(ep), sum(kernel_launches(meta).values())]
    out["equal"] = [_sha(t) for t in res] == m["sha"]
    blocked = sorted(mod for mod in sys.modules
                     if mod.split(".")[0] in TORCH_ONLY_BLOCKED)
    if blocked:
        raise AssertionError(f"blocked modules loaded: {blocked}")
    out["child_wall_s"] = time.perf_counter() - t_child
    print(json.dumps(out))
    return 0


def case_sources(cases, beside="cell"):
    """(name, source) of every single-step library the cases launch, named
    as ``make_cuda_stencil`` names them: the window form at
    ``window_tile``'s R × V for each case's shape and storage size, and
    the per-cell form ("direct" or "strided", ``compare_case``) or the
    slab form (``slab_case``) beside it."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    out = []
    for _, prog, spatial, dtype, kw, *_ in cases:
        dt = str(dtype).replace("torch.", "")
        mode = ("periodic" if kw.get("periodic") else "full"
                if kw.get("full_domain") else "interior")
        tile = ck.window_tile(prog, spatial,
                              torch.empty((), dtype=dtype).element_size())
        forms = [("window", tile)]
        if beside == "slab":
            forms.append(("slab", (1, 1)))
        else:
            lead = ck.lift(prog, spatial, 1)
            forms.append(("strided" if max(lead[-2], math.prod(lead[:-2]))
                          > ck.GRID_CAP else "direct", (1, 1)))
        for form, t in forms:
            tag = f"_r{t[0]}v{t[1]}" if form == "window" else ""
            out.append((f"{prog.name}_{mode}_{form}{tag}_{dt}",
                        generate_cuda_source(prog, dt, mode, form, t)))
    return out


def op_step_sources(op, spatial, dtype, periodic, backward=True):
    """(name, source) of an op's single steps at one shape and float type,
    named as ``make_cuda_stencil`` names them: the forward program in
    interior (or periodic) mode and (``backward``) every backward stage in
    full (or periodic) mode, in the window form at ``window_tile``'s
    R × V."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.ops import (backward_programs,
                                                   forward_program)
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    dt = str(dtype).replace("torch.", "")
    isz = torch.empty((), dtype=dtype).element_size()
    out = []
    for prog, mode in ([(forward_program(op), "interior")]
                       + [(p, "full") for p in
                          (backward_programs(op) if backward else [])]):
        mode = "periodic" if periodic else mode
        tile = ck.window_tile(prog, spatial, isz)
        out.append((f"{prog.name}_{mode}_window_r{tile[0]}v{tile[1]}_{dt}",
                    generate_cuda_source(prog, dt, mode, "window", tile)))
    return out


EXAMPLES_DIR = REPO / "examples" / "torch_port"
EXAMPLE_NAMES = ("heat_inverse_problem", "fwi_inversion", "lbm_cavity",
                 "phasefield_spinodal", "sharded_diffusion",
                 "elastic_simulation", "torch_tf_interop")
# the rows each example reaches on the card (a zero count fails): the
# window kernel (rows 1–4, by the Pallas kernel the JAX package would run
# for the call), kernels 12 and 13, a shard mode of the march
EXAMPLE_ROWS = {name: ("window",) for name in EXAMPLE_NAMES}
EXAMPLE_ROWS["lbm_cavity"] = ("window", "12", "13")
EXAMPLE_ROWS["phasefield_spinodal"] = ("window", "12")
EXAMPLE_ROWS["sharded_diffusion"] = ("window", "shard")
ROW_OF = {"_run_whole_array": "1", "_run_blocked": "2",
          "_run_plane_single": "3", "_run_plane_full": "4",
          "_run_row_tiled": "5", "jnp": "window (jnp in the JAX package)"}


def example_module(name):
    """An example script of ``examples/torch_port/`` as a module (its
    folder on ``sys.path`` for the scripts' shared ``port_cli``)."""
    import importlib.util

    if str(EXAMPLES_DIR) not in sys.path:
        sys.path.insert(0, str(EXAMPLES_DIR))
    mod = sys.modules.get(f"torch_port_{name}")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"torch_port_{name}", EXAMPLES_DIR / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[spec.name] = mod
    return mod


def example_ops():
    """(op, spatial, float type, periodic, backward too) of every
    single-step launch the examples make on the card, as each script
    lists them (its ``single_steps``)."""
    return [step for name in EXAMPLE_NAMES
            for step in example_module(name).single_steps()]


def example_sources(sizes):
    """(name, source) of every library the examples phase builds: the
    examples' single steps (forward, and the backward stages where they
    differentiate), the cavity's D2Q9 chain with bounce-back in kernels 12
    and 13 (float64), the spinodal's periodic kernel 12 (float64 at the
    example's size, float32 at the full size) and its float32 single
    steps there, and the sharded chain's shard-mode kernels (float64)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import d2q9_bgk_op
    from pystencils_autodiff_tpu_torch.parallel import ShardedChain

    spin = example_module("phasefield_spinodal")
    n, k = sizes["spinodal"], sizes["spinodal_k"]
    ch32 = spin.stages(torch.float32)
    out = []
    for op, spatial, dtype, periodic, bwd in example_ops() + [
            (op, (n, n), torch.float32, True, False) for op, _ in ch32]:
        out += op_step_sources(op, spatial, dtype, periodic, bwd)
    cav = example_module("lbm_cavity")
    lbm = [(d2q9_bgk_op(omega=cav.OMEGA), {"f": "f_out"})]
    # the first call's gradient wants the lid alone, the second's the
    # state too
    for wanted in ("fwd", {"uw1"}, {"f", "uw1"}):
        out.append(march_library(lbm, cav.K, False, cav.BOUNDARY, "float64",
                                 wanted, (cav.N,) * 2, None))
    out.append(march_library(spin.stages(), spin.K, True, None, "float64",
                             "fwd", (spin.N,) * 2, None))
    out.append(march_library(ch32, k, True, None, "float32", "fwd", (n, n),
                             None))
    shd = example_module("sharded_diffusion")
    _, hop = shd.heat_ops()
    chain = ShardedChain(hop, k=shd.CHAIN_K, mesh=shd.mesh_of("cpu"),
                         dim_axes={0: "x"}, carry_map={"u": "out"},
                         fused_bwd=True)
    out += chain_libraries(chain, shd.SHAPE, torch.float64, frozenset({"u"}))
    return out


def example_native_build():
    """Build the torch extension of ``torch_tf_interop.py``'s op (g++, the
    generated C kernels registered as PyTorch operators): its
    ``create_pytorch_op(backend="torch_native")`` builds it even where
    every tensor is on the card; returns the seconds."""
    t = time.perf_counter()
    example_module("torch_tf_interop").make_op().create_pytorch_op(
        backend="torch_native")
    return time.perf_counter() - t


def example_launches():
    """The examples' launches since the counters' last reset, by row: the
    window kernel's by the Pallas kernel the JAX package would run for
    the same call (``pallas_counterpart``), kernels 12 and 13, and the
    march's and the streaming kernel's shard modes (12s, 13s, 7s, 9s)."""
    from pystencils_autodiff_tpu_torch.ops import backward_programs
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import forward_program
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    programs = {}
    for op, *_ in example_ops():
        for p in [forward_program(op)] + list(backward_programs(op)):
            programs[p.name] = p
    out = {}
    for key, n in ck.LAUNCH_CALLS.items():
        name, full, per, spatial, itemsize, _, form = key
        row = (ROW_OF[pallas_counterpart(programs[name], full, per, spatial,
                                         itemsize)]
               if name in programs and form != "slab" else
               f"window ({name}, not in example_ops)")
        out[row] = out.get(row, 0) + n
    rows = {(sc, "march-shard"): "12s", (sa, "march-shard"): "13s",
            (tc, "march-shard"): "7s", (pa, "forward_shard"): "7s",
            (pa, "two_phase_shard"): "9s"}
    for mod, row in ((sc, "12"), (sa, "13"), (tc, "6/7"), (pa, "7/9")):
        for key, n in mod.LAUNCH_CALLS.items():
            r = rows.get((mod, key[5]), row)
            if r == "13s" and len(key[3]) == 3:
                r = "9s"  # row 9s's march design
            out[r] = out.get(r, 0) + n
    return out


def _reaches(got, row):
    if row == "window":
        return any(r in ("1", "2", "3", "4") or r.startswith("window")
                   for r in got)
    if row == "shard":
        return any(r.endswith("s") for r in got)
    return got.get(row, 0) > 0


def examples_phase(sizes, dev, counted):
    """Each script of ``examples/torch_port/`` through its ``main`` on the
    card at its published size (float64) with its own asserts, its wall
    seconds and launches by row; then the Cahn–Hilliard spinodal at
    ``sizes["spinodal"]``² float32, the fused stage chain (kernel 12,
    periodic, k cycles a launch) against node replay (two window launches
    a cycle) to the f32 contract, timed in turns with CUDA events, and
    one chain call held against its plain version beside its bound.
    Returns (kernel-vs-plain records, window launches by Pallas
    counterpart, shard-mode launches, the phase's numbers)."""
    import torch

    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import torch_ref

    numbers, window, shards = {}, {}, dict.fromkeys(SHARD_KERNELS, 0)
    row_cp = {r: cp for cp, r in ROW_OF.items()}
    for name in EXAMPLE_NAMES:
        ex = example_module(name)
        plain = torch_ref.PLAIN_CALLS
        _, _, sec = counted(lambda: ex.main(["--device", str(dev)]))
        got = example_launches()
        for key, n in shard_launches().items():
            shards[key] += n
        for row, n in got.items():
            if row in row_cp:
                window[row_cp[row]] = window.get(row_cp[row], 0) + n
        log(f"  {name}: {sec:.2f} s wall; launches by row {got}")
        missing = [r for r in EXAMPLE_ROWS[name] if not _reaches(got, r)]
        if missing or torch_ref.PLAIN_CALLS != plain:
            raise AssertionError(
                f"{name}: no launch of row(s) {missing}, or "
                f"{torch_ref.PLAIN_CALLS - plain} plain-version calls")
        numbers[name] = {"s": sec, "launches": got}
    spin = example_module("phasefield_spinodal")
    n, k, cycles = (sizes["spinodal"], sizes["spinodal_k"],
                    sizes["spinodal_cycles"])
    f32 = torch.float32
    dh = spin.record(spin.initial_phi(n, f32, dev))
    run_replay, run_fused = spin.compiled(dh, k)
    st = dh.state()
    with torch.no_grad():
        out_f, n_f, s_f = counted(lambda: run_fused(st, cycles))
        out_r, n_r, s_r = counted(lambda: run_replay(st, cycles))
    ref, got = out_r["phi"], out_f["phi"]
    scale = ref.abs().max().item()
    diff = (got - ref).abs()
    max_diff = diff.max().item()
    if not (torch.isfinite(got).all()
            and (diff <= 1e-5 * scale + 1e-5 * ref.abs()).all()):
        raise AssertionError(f"spinodal {n}² f32: fused vs replay max "
                             f"|diff| {max_diff:.3e}, max |ref| {scale:.3e}")
    want_f = {("stage_chain", 2): cycles // k}
    want_r = {("stencil_step", 2): 2 * cycles}
    if ({key: v for key, v in n_f.items() if v} != want_f
            or {key: v for key, v in n_r.items() if v} != want_r):
        raise AssertionError(f"spinodal {n}² f32: launches fused {n_f} "
                             f"(expected {want_f}), replay {n_r} "
                             f"(expected {want_r})")
    e0 = spin.ginzburg_landau_energy(st["phi"]).item()
    e1 = spin.ginzburg_landau_energy(ref).item()
    del out_f, out_r, ref, got, diff
    with torch.no_grad():
        turns = [cuda_ms(f) for f in (lambda: run_fused(st, cycles),
                                      lambda: run_replay(st, cycles),
                                      lambda: run_replay(st, cycles),
                                      lambda: run_fused(st, cycles))]
    log(f"  spinodal {n}² f32, {cycles} cycles, k={k}: {cycles // k} "
        f"launches of kernel 12 against {2 * cycles} window launches, "
        f"fused vs replay max |diff| {max_diff:.3e} (max |ref| "
        f"{scale:.3e}); free energy {e0:.1f} -> {e1:.1f}; ms a run in "
        f"turns (CUDA events): fused {turns[0]:.3f} / {turns[3]:.3f}, "
        f"replay {turns[1]:.3f} / {turns[2]:.3f} (host clock of the counted "
        f"runs: fused {s_f * 1e3:.1f}, replay {s_r * 1e3:.1f} ms)")
    plan = sc.StagePlan(spin.stages(f32), k, True, None)
    kernel, plain = run_fused.chain, sc.plain_stage_chain(plan)
    seq = sc.sequential_stage_chain(plan)
    state = {"phi": st["phi"], "mu": st["mu"]}
    with torch.no_grad():
        # the first sweep makes μ from φ alone: the chain reads φ only
        rec = check_and_time(
            f"spinodal CH k={k} periodic {n}² f32", lambda: kernel(state),
            lambda: plain(state), TOL["float32"], [state["phi"]], sc,
            dev, unfused=lambda: seq(state),
            ops=stage_ops(plan, n * n), chain="stage_chain", nd=2, k=k)
    numbers["spinodal_f32"] = {
        "n": n, "cycles": cycles, "k": k, "fused_ms": [turns[0], turns[3]],
        "replay_ms": [turns[1], turns[2]], "fused_vs_replay": max_diff,
        "max_abs_ref": scale, **{key: rec[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "copy_ms",
            "unfused_ms", "max_abs_err")}}
    return [rec], window, shards, numbers


# the accumulate="dd" mode and the probes (rows 14 and 15): a float32 or
# float64 dd kernel rounds every operation where its plain version does
# (the wide sums through round-to-nearest intrinsics, the leaves built
# with --fmad=false), so the two are held bit for bit
DD_TOL = {"float32": 0.0, "float64": 0.0}


def dd_programs(dtype):
    """aniso27's forward and backward programs in ``accumulate="dd"``
    mode (config #4's operator)."""
    from pystencils_autodiff_tpu_torch.models import anisotropic27_op
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)

    op = anisotropic27_op(dtype=dtype)
    return forward_program(op, "dd"), backward_program(op, "dd")


def dd_sources(sizes):
    """(name, source) of the libraries ``dd_phase`` and the serving
    phase's dd artifact run: aniso27's dd forward (interior and periodic)
    and backward (full) at 384³ f32, at 192³ and 384³ f64 (the kernel
    cases, the oracle's double-word run) and the dd artifact's 128³ f32,
    the pairwise f32 and f64 ones at 384³ (the turns), and the probes'
    library."""
    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.models import anisotropic27_op
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program)
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    out = []
    n, n64, ne = sizes["aniso"], sizes["dd_f64"], sizes["dd_export"]
    for dt, acc, shape, periodic in (
            ("float32", "dd", n, True), ("float64", "dd", n64, False),
            ("float64", "dd", n, False),
            ("float32", "dd", ne, False), ("float32", "pairwise", n, False),
            ("float64", "pairwise", n, False)):
        op = anisotropic27_op(dtype=dt)
        fwd, bwd = forward_program(op, acc), backward_program(op, acc)
        isz = 8 if dt == "float64" else 4
        for prog, mode in [(fwd, "interior"), (bwd, "full")] + (
                [(fwd, "periodic")] if periodic else []):
            tile = ck.window_tile(prog, (shape,) * 3, isz)
            tag = "_dd" if acc == "dd" else ""
            out.append((f"{prog.name}_{mode}_window_r{tile[0]}v{tile[1]}"
                        f"{tag}_{dt}", generate_cuda_source(
                            prog, dt, mode, "window", tile)))
    out.append(("probe_kernels", '#include "probes.cu"\n'))
    return list(dict(out).items())


def dd_ops_per_cell(program, pairs: bool):
    """Operations of one evaluation of ``program`` at one cell, as float64
    operations for the card's float64 peak: a dd step's tree
    (``ops.common.dd_plan``) in float64 — a product of m factors m − 1
    multiplies, a sum of m addends m − 1 adds; in double-word pairs
    (float64 programs) ``ddmul`` 13 and ``ddadd`` 14 flops
    (``csrc/dd.cuh``) —, every other step's operations scaled by the
    float64 peak over its own type's.  ``pairs``: the program runs in
    float64 (double-word pairs)."""
    import sympy as sp

    from pystencils_autodiff_tpu_torch.ops.common import dd_plan, is_dd_step

    def count(node):
        kind, item = node
        if kind not in ("add", "mul"):
            return 0
        per = (13 if kind == "mul" else 14) if pairs else 1
        return per * (len(item) - 1) + sum(count(n) for n in item)

    ops = 0.0
    for s in program.steps:
        if is_dd_step(s.rhs, program.accumulate):
            ops += count(dd_plan(s.rhs))
        else:
            ops += int(sp.count_ops(s.rhs)) * (
                PEAK_OPS_PER_S["float64"] / PEAK_OPS_PER_S["float32"])
    return ops


def dd_errors(what, dd, pairwise, oracle, other):
    """``dd`` and ``pairwise`` (float32) against ``oracle`` (the
    double-word float64 run) rounded to float32: the largest difference
    over max |oracle|, the cells that differ, whether every cell of dd is
    within one float32 ulp; and at the cells where dd differs: the largest
    distance of ``oracle`` from the float32 midpoint between dd and the
    rounded oracle, in float32 ulps there (a cell whose exact value lies
    that close to a midpoint is decided by the accumulation's last bits;
    ``oracle``'s own rounding is 2^-29 ulp), the largest such cell over
    max |oracle|, and how many of them ``other`` (the pairwise float64
    run) rounds to float32 as dd does (and whether it does at the cell of
    the largest difference)."""
    import torch

    rounded = oracle.float()
    ulp = (torch.nextafter(rounded.abs(), torch.tensor(
        float("inf"), device=rounded.device)) - rounded.abs()).double()
    scale = oracle.abs().max().item()
    out = {}
    for name, x in (("dd", dd), ("pairwise", pairwise)):
        d = (x.double() - rounded.double()).abs()
        out[f"{what}_{name}"] = d.max().item() / scale
        out[f"{what}_{name}_cells"] = int((d > 0).sum())
        if name == "dd":
            out[f"{what}_dd_within_ulp"] = bool((d <= ulp).all())
            off = d > 0
    if off.any():
        a, b = dd.double()[off], rounded.double()[off]
        out[f"{what}_dd_tie_distance_ulp"] = (
            (oracle[off] - (a + b) / 2).abs() / (a - b).abs()).max().item()
        out[f"{what}_dd_largest_off_cell"] = b.abs().max().item() / scale
        same = other.float()[off] == dd[off]
        out[f"{what}_dd_off_as_f64_pairwise"] = int(same.sum())
        out[f"{what}_dd_worst_as_f64_pairwise"] = bool(
            same[(a - b).abs().argmax()])
    return out


def dd_phase(sizes, dev, gen):
    """``accumulate="dd"`` on the card (the window kernel's dd body).

    The main path: aniso27's value and gradient (⟨y, w⟩, w random) at
    384³ float32 through ``torch_function(accumulate="dd")``, with the
    launch counts set to 0 just before and read just after: exactly one
    forward and one backward window launch of the dd libraries, no
    plain-version call.  Held against the port's double-word float64 run
    (``accumulate="dd"`` on float64 copies of the same inputs) rounded to
    float32: every cell of the gradient and the values within one ulp,
    fewer than 5e-3 of the cells off, fewer cells off than the pairwise
    float32 run and no larger an error (the JAX package's bounds on its dd
    kernel on the TPU, ``tests/test_dd.py::test_dd_accumulate_kernel_on_
    tpu``), the values within 1.3e-7·max |y|, and every cell off a
    near-tie: its exact value within 2^-10 ulp of a float32 midpoint.
    The largest difference over max |g| is printed, not bounded by 2e-8
    (``tests/test_dd.py``'s bound at 20³): at 384³ one-ulp flips at such
    near-ties reach cells of half the largest magnitude.  The three runs
    (dd, pairwise float32, pairwise float64) timed in turns (dd,
    pairwise, f64, f64, pairwise, dd; CUDA events).  Then each dd kernel
    against its plain version on the same tensors, bit for bit, with the
    pairwise kernel of the same mode as the control that must fail that
    check, beside the copy and the bound (its float64 operations counted
    against the float64 peak): forward, backward (full, masked) and
    periodic forward at 384³ f32, forward and backward at 192³ f64 (the
    double-word pairs), each beside the pairwise kernel of the same mode
    in turns.  Returns (records, window launches of the main path by
    Pallas counterpart, numbers)."""
    import torch

    from pystencils_autodiff_tpu_torch.models import anisotropic27_op
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program,
                                                   make_cuda_stencil,
                                                   make_torch_stencil,
                                                   torch_ref)
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck

    t_phase = time.perf_counter()
    n = sizes["aniso"]
    op32, op64 = anisotropic27_op(), anisotropic27_op(dtype="float64")
    fdd = op32.torch_function(accumulate="dd")
    fpw, f64f = op32.torch_function(), op64.torch_function()
    u = torch.randn((n,) * 3, generator=gen, device=dev)
    w = torch.randn((n,) * 3, generator=gen, device=dev)
    u64, w64 = u.double(), w.double()

    def vg(f, x, cot):
        t = x.detach().requires_grad_()
        y = f(t)
        (g,) = torch.autograd.grad(y, t, cot)
        return y.detach(), g

    vg(fdd, u, w)  # every library in place
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    plain0 = torch_ref.PLAIN_CALLS
    y, g = vg(fdd, u, w)
    torch.cuda.synchronize()
    calls = dict(ck.LAUNCH_CALLS)
    if (ck.LAUNCHES != 2 or torch_ref.PLAIN_CALLS != plain0
            or not all(k[5].endswith("_dd") and k[6] == "window"
                       for k in calls)):
        raise AssertionError(f"aniso27 dd value+gradient: launches {calls} "
                             f"(expected 1 + 1 dd window launches), "
                             f"plain-version calls "
                             f"{torch_ref.PLAIN_CALLS - plain0}")
    fwd, bwd = dd_programs("float32")
    launches = launches_by_counterpart(calls, {fwd.name: fwd,
                                               bwd.name: bwd})
    y32, g32 = vg(fpw, u, w)
    y64, g64 = vg(f64f, u64, w64)
    ydd64, gdd64 = vg(op64.torch_function(accumulate="dd"), u64, w64)
    err = {**dd_errors("grad", g, g32, gdd64, g64),
           **dd_errors("value", y, y32, ydd64, y64)}
    del y, g, y64, g64, y32, g32, ydd64, gdd64
    torch.cuda.empty_cache()
    tie = max(err.get(f"{k}_dd_tie_distance_ulp", 0.0)
              for k in ("grad", "value"))
    log(f"  aniso27 {n}³ f32 value+gradient, accumulate='dd': launches "
        f"{launches} (1 + 1 window, dd libraries, no plain-version call); "
        f"against the port's double-word f64 run rounded to f32: gradient "
        f"{err['grad_dd']:.3e} of max |g| (pairwise "
        f"{err['grad_pairwise']:.3e}), values {err['value_dd']:.3e} of "
        f"max |y| (pairwise {err['value_pairwise']:.3e}); cells one ulp "
        f"off: gradient dd {err['grad_dd_cells']} (pairwise "
        f"{err['grad_pairwise_cells']}), values dd {err['value_dd_cells']} "
        f"(pairwise {err['value_pairwise_cells']}) of {n ** 3}, none "
        f"further; every off cell's exact value within {tie:.1e} ulp of "
        f"a float32 midpoint; {err}")
    # the JAX package's bounds on its dd kernel on the TPU
    # (tests/test_dd.py::test_dd_accumulate_kernel_on_tpu) and on its dd
    # values (test_dd_accumulate_in_kernels), and the cells off the
    # rounded oracle all near-ties: its exact value within 2^-10 ulp of a
    # float32 midpoint, where the float64 sum's last bits decide
    if not (err["grad_dd_within_ulp"] and err["value_dd_within_ulp"]
            and err["grad_dd_cells"] < 5e-3 * n ** 3
            and err["grad_dd"] <= err["grad_pairwise"]
            and err["grad_dd_cells"] < err["grad_pairwise_cells"]
            and err["value_dd"] < 1.3e-7
            and tie <= 2.0 ** -10):
        raise AssertionError(f"aniso27 dd at {n}³: {err}")
    runs = {"dd": lambda: vg(fdd, u, w), "pairwise": lambda: vg(fpw, u, w),
            "f64": lambda: vg(f64f, u64, w64)}
    turns = {k: [] for k in runs}
    for k in ["dd", "pairwise", "f64", "f64", "pairwise", "dd"]:
        turns[k].append(cuda_ms(runs[k]))
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    log(f"  in turns (ms a value+gradient, CUDA events): "
        + ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                    for k, v in turns.items())
        + f"; dd/pairwise {mean['dd'] / mean['pairwise']:.3f}, "
          f"f64/pairwise {mean['f64'] / mean['pairwise']:.3f}; "
          f"{card_line()}")
    del u, w, u64, w64, runs
    torch.cuda.empty_cache()

    records, pairs = [], {}
    cases = [("float32", n, "fwd", {}), ("float32", n, "bwd", None),
             ("float32", n, "fwd", {"periodic": True}),
             ("float64", sizes["dd_f64"], "fwd", {}),
             ("float64", sizes["dd_f64"], "bwd", None)]
    for dt, m, which, kw in cases:
        fwd, bwd = dd_programs(dt)
        prog = fwd if which == "fwd" else bwd
        if kw is None:
            kw = {"full_domain": True, "adjoint_mask_ghost": fwd.ghost}
        dtype = getattr(torch, dt)
        spatial = (m,) * 3
        inputs = random_inputs(prog, spatial, dtype, gen, dev)
        kernel = make_cuda_stencil(prog, **kw)
        plain = make_torch_stencil(prog, **kw)
        mode = ("periodic" if kw.get("periodic") else "full"
                if kw.get("full_domain") else "interior")
        name = f"aniso27 dd {which} {mode} {m}³ {dt}"
        cp = pallas_counterpart(prog, kw.get("full_domain", False),
                                kw.get("periodic", False), spatial,
                                dtype.itemsize)
        # the pairwise program of the same mode on the same tensors: the
        # control of the bit-for-bit check, then timed in turns
        pop = anisotropic27_op(dtype=dt)
        pprog = (forward_program(pop) if which == "fwd"
                 else backward_program(pop))
        pk = make_cuda_stencil(pprog, **kw)
        rec = check_and_time(
            name, lambda: kernel(inputs), lambda: plain(inputs),
            DD_TOL[dt], list(inputs.values()), ck, dev,
            ops=math.prod(spatial) * dd_ops_per_cell(prog, dt == "float64"),
            peak="float64", control=lambda: pk(inputs),
            counterpart=cp, accumulate="dd",
            window=list(ck.window_tile(prog, spatial, dtype.itemsize)))
        ts = {"dd": [], "pairwise": []}
        for label in ("dd", "pairwise", "pairwise", "dd"):
            ts[label].append(cuda_ms(lambda: (kernel if label == "dd"
                                              else pk)(inputs)))
        rec["pairwise_ms_turns"], rec["dd_ms_turns"] = (ts["pairwise"],
                                                        ts["dd"])
        rec["dd_over_pairwise"] = (statistics.mean(ts["dd"])
                                   / statistics.mean(ts["pairwise"]))
        log(f"    bit-equal to the plain version; the pairwise kernel is "
            f"not (cells off by output: {rec['control_cells_off']})")
        log(f"    in turns with the pairwise kernel: dd "
            f"{' / '.join(f'{t:.3f}' for t in ts['dd'])} ms, pairwise "
            f"{' / '.join(f'{t:.3f}' for t in ts['pairwise'])} ms; dd/"
            f"pairwise {rec['dd_over_pairwise']:.3f}; Pallas counterpart "
            f"{cp} (the JAX package's dd route; jnp: no kernel there)")
        if cp != "jnp":
            records.append(rec)
        pairs[name] = {k: rec[k] for k in (
            "ms", "plain_ms", "copy_ms", "bound_ms", "bound_by",
            "max_abs_err", "dd_over_pairwise", "pairwise_ms_turns",
            "dd_ms_turns", "control_cells_off")}
        del inputs
        torch.cuda.empty_cache()
    numbers = {"errors": err, "turns_ms": turns,
               "dd_over_pairwise": mean["dd"] / mean["pairwise"],
               "f64_over_pairwise": mean["f64"] / mean["pairwise"],
               "kernels": pairs, "phase_s": time.perf_counter() - t_phase}
    log(f"  dd phase: {numbers['phase_s']:.1f} s")
    return records, launches, numbers


def probes_phase(sizes, dev):
    """Rows 14 and 15, the probes of ``utils/probes.py``
    (``csrc/probes.cu``).  First the slice rungs' shared-memory loads
    counted in the library's SASS (``probes.ladder_loads``: every rep
    loads, no other rung does); then each kernel held against its plain
    version on random values (the FMA chain in f32 and f64 at the TPU's
    (2048, 512) × 256 and at the kernels line's 8192² × 1024; every ladder
    rung at (2048, 512), 40 reps: two unrolled blocks of 14 and a tail,
    and the fma rung at the line's 4096 reps): float32 bit for bit
    against the plain version that rounds each x·a + b once as the fma
    does, float64 to reps·eps of the unfused one, far below one rep's
    change; then, with the launch counts set to 0 just before and
    read just after, the measurements: ``fma_flops`` at the TPU's shape
    (its slope over chained calls, and one call in a CUDA graph, where no
    host work is timed) and at (8192, 8192) × 1024 (a call of at least a
    millisecond), each as a share of the published peak; ``ladder_ps``
    of every rung at (2048, 512) × 4096 reps (at the TPU's 32 reps a call
    moves 8 MB to run 1M × 32 operations: the bytes, not the rung, would
    be timed).  Each row's kernel and plain times, bound and launches for
    the kernels line.  Returns (rows, numbers)."""
    import torch

    from pystencils_autodiff_tpu_torch.utils import probes

    t_phase = time.perf_counter()
    card = card_line()
    rows, cols, reps = 2048, 512, 256
    big = (8192, 8192, 1024)
    lreps = sizes["ladder_reps"]
    f32, f64 = torch.float32, torch.float64
    eps = {f32: 2.0 ** -23, f64: 2.0 ** -52}
    lds = probes.ladder_loads()
    log(f"  LDS in each ladder rung's SASS (cuobjdump): {lds}")
    if not (all(lds[r] >= 14 * 8 for r in ("smem_row", "smem_odd"))
            and not any(v for r, v in lds.items()
                        if r not in ("smem_row", "smem_odd"))):
        raise AssertionError(f"the slice rungs do not read shared memory "
                             f"every rep: LDS {lds}")
    # the FMA chain on random values: float32 against the plain version
    # rounded as the fma rounds (bit for bit), float64 against the unfused
    # one (one rep moves a value by ~1e-7 of itself, the fusing ~2^-53)
    err_fma = {}
    for (r, c, k), dtype in itertools.product(((rows, cols, reps), big),
                                              (f32, f64)):
        x = probes.ladder_input(r - 8, c, dtype, dev, seed=3)
        got = probes.fma_rate(x=x, reps=k)
        ref = probes.plain_fma_rate(x, k, fused=dtype == f32)
        e = (got - ref).abs().max().item()
        tol = 0.0 if dtype == f32 else k * eps[dtype] * ref.abs().max().item()
        if not e <= tol:
            raise AssertionError(f"fma_rate {dtype} {r}x{c} × {k}: {e:.3e} "
                                 f"from plain (tolerance {tol:.1e})")
        err_fma[(r, c, k, dtype)] = e
        del x, got, ref
    xl = probes.ladder_input(rows, cols, f64, dev)
    err_ladder = {}
    for rung, k in [(r, 40) for r in probes.RUNGS] + [("fma", lreps)]:
        got = probes.op_ladder([rung], reps=k, x=xl)[rung]
        ref = probes.plain_ladder(rung, xl.to(got.dtype), k,
                                  fused=got.dtype == f32)
        e = (got - ref).abs().max().item()
        tol = (0.0 if got.dtype == f32 or rung == "dd_addend"
               else 2 * k * eps[got.dtype] * ref.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"op_ladder {rung} × {k}: {e:.3e} from "
                                 f"plain (tolerance {tol:.1e})")
        err_ladder[(rung, k)] = e
    log(f"  every probe kernel held against its plain version on random "
        f"values: float32 bit-equal (fma_rate at {rows}x{cols} × {reps} "
        f"and {big[0]}x{big[1]} × {big[2]}, every ladder rung × 40, the "
        f"fma rung × {lreps}), float64 fma_rate within "
        f"{max(v for k, v in err_fma.items() if k[3] == f64):.2e}, "
        f"fma_f64 and the f64 rungs "
        f"{max(err_ladder.values()):.2e} (dd_addend bit-equal)")

    numbers = {"card": card, "lds": lds}
    probes.reset_launch_counts()
    fma = {}
    for dtype in (f32, f64):
        dt = str(dtype).replace("torch.", "")
        peak = PEAK_OPS_PER_S[dt]
        small = probes.fma_flops(dtype, rows, cols, reps, device=dev)
        xg = torch.ones((rows, cols), dtype=dtype, device=dev)
        g_ms = graph_ms(lambda: probes.fma_rate(x=xg, reps=reps))
        xb = probes.ladder_input(big[0] - 8, big[1], dtype, dev, seed=3)
        large = probes.fma_flops(x=xb, reps=big[2], calls=4)
        fma[dt] = {"tpu_shape_flops": small,
                   "tpu_shape_graph_flops": 2 * reps * rows * cols
                   / (g_ms * 1e-3),
                   "large_flops": large, "large_ms": 2 * big[2] * big[0]
                   * big[1] / large * 1e3, "peak": peak}
        log(f"  fma_rate {dt}: ({rows}, {cols}) × {reps}: "
            f"{small / 1e12:.2f} TFLOP/s by slope "
            f"({small / peak:.1%} of the published {peak / 1e12:.0f}), "
            f"{fma[dt]['tpu_shape_graph_flops'] / 1e12:.2f} in a CUDA "
            f"graph ({g_ms * 1e3:.1f} µs a call); {big[0]}×{big[1]} × "
            f"{big[2]}: {large / 1e12:.2f} TFLOP/s ({large / peak:.1%}; "
            f"{fma[dt]['large_ms']:.3f} ms a call); {card}")
    fma_launches = probes.LAUNCHES
    probes.reset_launch_counts()
    ladder = probes.ladder_ps(rows=rows, cols=cols, reps=lreps, device=dev)
    ladder_launches = probes.LAUNCHES
    log(f"  op ladder, ({rows}, {cols}) × {lreps} reps, ps per element per "
        f"rep (raw; less the f32 fma baseline) — {card}:")
    for rung, r in ladder.items():
        log(f"    {rung:15s} {r['dtype']:8s} {r['ps']:8.4f}  "
            f"{r['ps_less_fma']:+8.4f}")
    if not fma_launches or not ladder_launches:
        raise AssertionError(f"probe launches {fma_launches}, "
                             f"{ladder_launches}")
    # the kernels line's rows: the large FMA case and the ladder's fma
    # rung, each beside its plain version (unfused) and bound
    xb = probes.ladder_input(big[0] - 8, big[1], f32, dev, seed=3)
    fma_ms = fma["float32"]["large_ms"]
    fma_plain = cuda_ms(lambda: probes.plain_fma_rate(xb, big[2]),
                        batches=1, reps=1, warmup=1)
    nb = big[0] * big[1]
    fma_bound = max(2 * big[2] * nb / PEAK_OPS_PER_S["float32"],
                    2 * nb * 4 / HBM_BYTES_PER_S) * 1e3
    del xb
    xl = xl.float()
    lad_ms = ladder["fma"]["ps"] * rows * cols * lreps * 1e-9
    lad_plain = cuda_ms(lambda: probes.plain_ladder("fma", xl, lreps),
                        batches=1, reps=1, warmup=1)
    lad_bound = max(2 * lreps * rows * cols / PEAK_OPS_PER_S["float32"],
                    (2 * rows + 8) * cols * 4 / HBM_BYTES_PER_S) * 1e3
    numbers.update(fma=fma, ladder=ladder, ladder_reps=lreps,
                   fma_launches=fma_launches,
                   ladder_launches=ladder_launches)
    rows_out = [
        {"name": "probes[fma_chain]", "replaces": probes.REPLACES[
            "fma_rate"], "launches": fma_launches,
         "max_abs_err": err_fma[(*big, f32)],
         "ms": fma_ms, "plain_ms": fma_plain, "bound_ms": fma_bound,
         "bound_by": "operations", "library_ms": None,
         "case": f"fma_rate float32 {big[0]}x{big[1]} x {big[2]}"},
        {"name": "probes[ladder]", "replaces": probes.REPLACES["op_ladder"],
         "launches": ladder_launches,
         "max_abs_err": err_ladder[("fma", lreps)],
         "ms": lad_ms, "plain_ms": lad_plain, "bound_ms": lad_bound,
         "bound_by": "operations", "library_ms": None,
         "case": f"op_ladder fma rung float32 {rows}x{cols} x {lreps}"}]
    log(f"  rows 14-15: fma_chain {fma_ms:.3f} ms (plain {fma_plain:.1f}, "
        f"bound {fma_bound:.3f}), ladder fma rung {lad_ms:.3f} ms (plain "
        f"{lad_plain:.1f}, bound {lad_bound:.3f}); launches "
        f"{fma_launches}, {ladder_launches}")
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"  probes phase: {numbers['phase_s']:.1f} s")
    return rows_out, numbers


def late_sources(sizes):
    """(name, source) of the libraries the phases build at their first
    use that no other list names, so that every library builds in the
    parallel rounds: the single steps the chain and stage cases time
    beside their kernels, the 2D forward march of the chain cases (timed
    in turns), the periodic wave's warp march (its final-field gradient),
    the elastic pair's marches at the small float64 check, nl3d's
    two-phase streaming kernel with probe lines (the repairs), the
    example op's 64² step (the host cost) and the libraries of the
    examples phase (``example_sources``)."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_plane_source, generate_warp_chain_source)
    from pystencils_autodiff_tpu_torch.models import wave_step_op
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc

    out = []
    for _, op, carry, spatial, dtype, k, periodic, probes, _ in \
            chain_cases(sizes):
        if dtype != torch.bfloat16:
            out += op_step_sources(op, spatial, dtype, periodic)
        plan = tc.chain_plan(op, k, carry, periodic, probes)
        isz = 8 if dtype == torch.float64 else 4
        dt = str(dtype).replace("torch.", "")
        if len(spatial) == 2 and "march" in tc.fitting_designs(
                plan, spatial, isz):
            out.append(_march_first(sm.chain_stage_plan(plan), None,
                                    spatial, dt, None))
    for case in stage_cases(sizes):
        _, stages, _, periodic, _, _, spatial, dtype = case[:8]
        for op, _ in stages:
            out += op_step_sources(op, spatial, dtype, periodic)
    wave = tc.chain_plan(wave_step_op(dt=WAVE_DT), sizes["chain_k"],
                         WAVE_CARRY, True)
    out.append((f"{wave.program.name}_warp_chain_float32",
                generate_warp_chain_source(wave, "float32")))
    ne, ek = sizes["elastic_small"], sizes["elastic_k"]
    el64 = elastic_chain_stages(torch.float64)
    # the five fields' gradients; the sponge plane is wanted by none
    for wanted in ("fwd", ()):
        out.append(march_library(el64, ek, False, elastic_boundary(),
                                 "float64", wanted, (ne, ne), None))
    np3 = sizes["probe3d"]
    nl = tc.chain_plan(nl3d_op(), sizes["cfg2_k"], {"u": "u_next"}, False,
                       probe3d_lines(np3))
    for form in ("gather", "local"):
        out.append((f"{nl.program.name}_plane_two_phase_bounded_{form}_"
                    f"float32", generate_plane_source(
                        ac.AdjointPlan(nl), "two_phase", "float32", form)))
    out += op_step_sources(example_op(), (sizes["small"],) * 2,
                           torch.float32, False)
    out += example_sources(sizes)
    return out


def run(dev, sizes=FULL):
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import (
        generate_adjoint_source, generate_chain_source, generate_twin_source,
        generate_warp_chain_source)
    from pystencils_autodiff_tpu_torch.models import (anisotropic27_op,
                                                      diffusion3d_op,
                                                      heat_step3d_op,
                                                      heat_step_op,
                                                      wave_step_op)
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program,
                                                   transposed_linear_op)
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta

    # f32 convolutions (the library yardstick) in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    heat, diff3d, heat3d = heat_step_op(kappa_field=True), diffusion3d_op(), \
        heat_step3d_op()
    example = example_op()
    progs = {}
    for op in (heat, diff3d, heat3d, example):
        progs[op.op_name] = (forward_program(op), backward_program(op))
    k, hk = sizes["chain_k"], sizes["heat_k"]
    wave32, wave64 = wave_step_op(dt=WAVE_DT), wave_step_op(
        dt=WAVE_DT, dtype="float64")
    heat_c = heat_step_op(dt=0.1)
    probe = [("u_curr", sizes["fwi_row"])]
    wave_fwd = tc.chain_plan(wave32, k, WAVE_CARRY, False, probe)
    cot_op, cot_carry, _, _ = transposed_linear_op(heat_c, HEAT_CARRY)
    hcf = forward_program(heat_c)
    # one library per single-step variant: the modes and float types the
    # run takes (the per-cell form beside the window form where the
    # cases time the two in turns), the strided form for the 70000-row
    # grid, the slab form for the tiled path and its cases, bf16 for the
    # bf16 cases
    both = ("window", "direct")
    sources = step_sources(progs["heat_step2d"], forms=both)
    sources += step_sources(list(progs["heat_step3d"]) + [hcf],
                            dtypes=("float32",), forms=both)
    sources += step_sources(progs["diffusion3d"], dtypes=("float32",),
                            periodic=False, forms=both)
    sources += step_sources(progs["heat_step"], periodic=False)
    # grids too small to fill the card take 1 × 1 windows (window_tile)
    sources += step_sources(progs["heat_step"], dtypes=("float64",),
                            periodic=False,
                            spatial=(sizes["inverse_small"],) * 2)
    sources += step_sources(progs["heat_step2d"], dtypes=("float32",),
                            periodic=False, spatial=(sizes["small"],) * 2)
    sources += step_sources(progs["heat_step2d"], dtypes=("float32",),
                            periodic=False, forms=("window", "strided"),
                            spatial=sizes["tall"])
    sources += step_sources(list(progs["heat_step2d"])
                            + list(progs["diffusion3d"])
                            + list(progs["heat_step"]) + [hcf],
                            periodic=False, forms=("slab",))
    sources += step_sources(progs["heat_step2d"][:1], dtypes=("bfloat16",),
                            periodic=False, forms=("window", "direct",
                                                   "slab"))
    # named as the chain wrappers name them
    heat_plans = [tc.chain_plan(heat_c, hk, HEAT_CARRY, True),
                  tc.chain_plan(cot_op, hk, cot_carry, True)]
    sources += [(f"{p.program.name}_chain", generate_chain_source(p))
                for p in [wave_fwd] + heat_plans]
    # row 6's warp march (the 2D forward chains' pick) in every float type
    # the run takes, the box libraries beside it (the turns)
    bf16_heat = [tc.chain_plan(heat_c, 2, HEAT_CARRY, True),
                 tc.chain_plan(cot_op, 2, cot_carry, True)]
    sources += [(f"{p.program.name}_warp_chain_{dt}",
                 generate_warp_chain_source(p, dt))
                for p, dt in [(wave_fwd, "float32"), (heat_plans[0], "float32"),
                              (heat_plans[1], "float32"),
                              (tc.chain_plan(wave64, k, WAVE_CARRY, False,
                                             probe), "float64")]
                + [(p, "bfloat16") for p in bf16_heat]]
    sources.append((f"{wave_fwd.program.name}_adjoint_chain",
                    generate_adjoint_source(ac.AdjointPlan(wave_fwd))))
    ck3 = sizes["cfg2_k"]
    # the float64 cases' chain libraries (the 3D ones: forward_sources)
    wave64_fwd = tc.chain_plan(wave64, k, WAVE_CARRY, False, probe)
    sources += [
        (f"{wave64_fwd.program.name}_chain_float64",
         generate_chain_source(wave64_fwd, "float64")),
        (f"{wave64_fwd.program.name}_adjoint_chain_float64",
         generate_adjoint_source(ac.AdjointPlan(wave64_fwd), "float64"))]
    twins = [ac.fused_chain_vjp(wave32, k, WAVE_CARRY, periodic=True).plan,
             ac.fused_chain_vjp(diff3d, ck3, HEAT_CARRY, periodic=False).plan,
             ac.fused_chain_vjp(heat3d, ck3, HEAT_CARRY,
                                periodic=False).plan,
             ac.fused_chain_vjp(diff3d, ck3, HEAT_CARRY, periodic=True).plan]
    sources += [(f"{tp.fwd.program.name}_twin_accum", generate_twin_source(tp))
                for tp in twins]
    nw, nwd, multi = sizes["wave"], sizes["wave_f64"], multi_carrier_op()
    sources.append((f"{multi.op_name}_adjoint_chain", generate_adjoint_source(
        ac.AdjointPlan(tc.chain_plan(multi, 2, MULTI_CARRY, False)))))
    sources += [(f"{wave32.op_name}_adjoint_chain_periodic",
                 generate_adjoint_source(ac.AdjointPlan(
                     tc.chain_plan(wave32, k, WAVE_CARRY, True))))]
    # the march libraries of rows 8 and 11 (the chain cases and the main
    # paths' shapes)
    sources += [chain_march_library(*c) for c in (
        (wave32, WAVE_CARRY, (nw, nw), "float32", k, False, probe),
        (wave64, WAVE_CARRY, (nwd, nwd), "float64", k, False, probe),
        (wave32, WAVE_CARRY, (nw, nw), "float32", k, True),
        (multi, MULTI_CARRY, (nw, nw), "float32", 2, False),
        (diff3d, HEAT_CARRY, (sizes["cube"],) * 3, "float32", ck3, False),
        (diff3d, HEAT_CARRY, (sizes["cube"],) * 3, "float32", ck3, True),
        (heat3d, HEAT_CARRY, (sizes["cube"],) * 3, "float32", ck3, False),
        (diff3d, HEAT_CARRY, (sizes["cfg2_small"],) * 3, "float64", ck3,
         False),
        (wave_step_op(dt=WAVE_DT, dtype="float64"), WAVE_CARRY,
         (sizes["fwi_small"],) * 2, "float64", k, False,
         [("u_curr", sizes["fwi_small_row"])]))]
    sources += stage_sources(sizes)
    sources += repair_sources(sizes)
    ak = sizes["aniso_k"]
    sources += forward_sources(sizes)
    sources += plane_sources(sizes)
    sources += ladder_sources(sizes)
    sources += app_sources(sizes)
    sources += parallel_sources(sizes)
    sources += serving_sources(sizes)
    sources += autotune_sources(sizes)
    sources += rank_sources(sizes)
    # every single-step case's library at its own shape and float type
    sources += case_sources(step_cases(sizes, progs, hcf))
    sources += case_sources(slab_cases(sizes, progs, hcf), beside="slab")
    sources += late_sources(sizes)
    sources += dd_sources(sizes)

    t_build = time.perf_counter()
    log(f"== build ({len(sources)} libraries, one nvcc each, and the leaf "
        f"launch op's g++ build, in parallel; then the bridges' g++ builds)")
    from concurrent.futures import ThreadPoolExecutor

    from pystencils_autodiff_tpu_torch.ops.launch import launch_op_library

    def launch_op_build():
        t = time.perf_counter()
        launch_op_library()
        return time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=2) as pool:
        op_build = pool.submit(launch_op_build)
        ex_build = pool.submit(example_native_build)
        build_s = build_all(sources)
        LAUNCH_OP_BUILD_S[0] = op_build.result()
        ex_native_s = ex_build.result()
    log(f"  the leaf launch op (csrc/launch_op.cpp, g++ with its CUDA "
        f"kernel): {LAUNCH_OP_BUILD_S[0]:.1f} s, and the torch extension "
        f"of examples/torch_port/torch_tf_interop.py's op (g++): "
        f"{ex_native_s:.1f} s, beside the nvcc builds")
    t_var = time.perf_counter()
    second = march_variants()
    log(f"  build total: {build_s:.1f} s; the march libraries' block sizes "
        f"from their registers ({time.perf_counter() - t_var:.1f} s): "
        f"{len(second)} more libraries")
    build_s += build_all(second) if second else 0.0
    from pystencils_autodiff_tpu_torch.codegen import nvcc
    log(f"  build total: {build_s:.1f} s")
    bridges = bridge_build()
    # every library, the bridges' g++ ones included, is built by now
    n_built = _LATE[0] = len(nvcc.BUILDS)
    BUILD_SECTION_S[0] = time.perf_counter() - t_build
    log(f"  the bridges' g++ builds: the torch extension "
        f"{bridges['extension_s']:.1f} s, the float64 C kernels "
        f"{bridges['c_kernels_s']:.1f} s; nvcc.BUILDS {n_built} after the "
        f"build section; the build section {BUILD_SECTION_S[0]:.1f} s")
    log("== -Xptxas -v of the march and stage libraries (kernels 7, 8, 10, "
        "11, 12 and 13; the stage kernels' box design; kernel 13 in both "
        "forms)")
    for lib, info in ptxas_report().items():
        log(f"  {lib}: {info}")

    log("== kernel vs plain (same inputs; ms per run: CUDA events over 4 "
        "runs back to back, median of 3 batches)")
    f32, f64 = torch.float32, torch.float64
    hf, hb = progs["heat_step2d"]
    df, db = progs["diffusion3d"]
    n2, n3 = sizes["heat2d"], sizes["cube"]
    cases = step_cases(sizes, progs, hcf)
    gen = torch.Generator(device=dev).manual_seed(1234)
    records = [compare_case(c, dev, gen) for c in cases]
    log("== the slab kernel (row_tiled.cuh, strategy=\"tiled\") vs plain, "
        "timed beside the per-cell kernel on the same inputs (slab, cell, "
        "slab, cell)")
    slab_records = [slab_case(c, dev, gen)
                    for c in slab_cases(sizes, progs, hcf)]
    nw, nwd = sizes["wave"], sizes["wave_f64"]
    chain_records = [chain_case(c, dev, gen) for c in chain_cases(sizes)]
    chain_records += [stage_case(c, dev, gen) for c in stage_cases(sizes)]
    chain_records += [chain_case(c, dev, gen) for c in plane_cases(sizes)]

    log("== main path through AutoDiffOp.torch_function()")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    losses, grad = heat_inverse_problem(example, sizes["heat2d"],
                                        sizes["adam_steps"], dev, f32)
    torch.cuda.synchronize()
    heat_s = time.perf_counter() - t0
    d_loss = value_and_grad(diff3d, (n3,) * 3, dev)
    p_loss = value_and_grad(heat3d, (n3,) * 3, dev, periodic=True)
    small_gpu, _ = heat_inverse_problem(example, sizes["inverse_small"],
                                        sizes["adam_steps_small"], dev, f64)
    torch.cuda.synchronize()
    launches = launches_by_counterpart(
        ck.LAUNCH_CALLS, {p.name: p for pair in progs.values() for p in pair})
    total = ck.LAUNCHES
    small_cpu, _ = heat_inverse_problem(example, sizes["inverse_small"],
                                        sizes["adam_steps_small"],
                                        torch.device("cpu"), f64)
    log(f"  heat inverse problem {sizes['heat2d']}² f32: losses {losses} "
        f"({heat_s:.2f} s host clock incl. sync)")
    log(f"  diffusion3d {n3}³ value+grad: loss {d_loss:.6e}; periodic heat3d "
        f"{n3}³ value+grad: loss {p_loss:.6e}")
    log(f"  {sizes['inverse_small']}² f64 inverse problem, card vs CPU plain: "
        f"{small_gpu[-1]:.6e} vs {small_cpu[-1]:.6e}")
    log(f"  launches in the main path: {total} {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"heat inverse problem: loss did not fall: {losses}")
    if not torch.isfinite(grad).all():
        raise AssertionError("heat inverse problem: non-finite gradient")
    for a, b in zip(small_gpu, small_cpu):
        if not math.isclose(a, b, rel_tol=1e-8):
            raise AssertionError(f"small inverse problem: card {small_gpu} "
                                 f"vs CPU plain {small_cpu}")
    for cp in REPLACES:
        if launches.get(cp, 0) == 0:
            raise AssertionError(f"main path never launched the kernel for {cp}")

    log("== the slab path: AutoDiffOp.torch_function(strategy=\"tiled\")")
    steps = sizes["adam_steps"]
    slab_launches = tiled_path(example, diff3d, sizes, dev)
    log(f"  launches of the slab kernel in the tiled heat inverse problem: "
        f"{slab_launches}")

    log("== ranks: the 1D κ-heat and the 4D Laplacian through the window "
        "kernel (Queue 3 #18), kernel vs plain and their value+gradient")
    rank_records, rank_launches, rank_numbers = ranks_phase(sizes, dev, gen)
    records += rank_records
    log("== second order: the κ-heat HVP through the tangent-linear "
        "program (Queue 3 #17), reverse over reverse and forward over "
        "reverse")
    hvp_launches, hvp_numbers = hvp_phase(sizes, dev, gen)
    log("== accumulate='dd': aniso27's value+gradient at "
        f"{sizes['aniso']}³ f32 through the window kernel's dd body, "
        "against the port's double-word f64 run, in turns with pairwise "
        "and f64; each dd kernel against its plain version, bit for bit")
    dd_records, dd_launches, dd_numbers = dd_phase(sizes, dev, gen)
    records += dd_records
    for cp, n in (list(rank_launches.items()) + list(hvp_launches.items())
                  + list(dd_launches.items())):
        launches[cp] = launches.get(cp, 0) + n
    log("== the probes (rows 14 and 15): the FMA rate and the op ladder, "
        "each kernel against its plain version, then measured")
    probe_rows, probe_numbers = probes_phase(sizes, dev)

    log("== main paths through the fused chains")
    chain_launches = {key: 0 for key in CHAIN_KERNELS}
    families = {"stencil_step": ck, "time_chain": tc, "adjoint_chain": ac,
                "twin_accum": ta, "stage_chain": sc, "stage_adjoint": sa,
                "plane": pa}

    def counted(fn, tally=True):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after: launches by (kernel, spatial dims); the streaming
        kernel's by its mode ("plane_forward", "plane_two_phase").  With
        ``tally`` they join the kernels line's launch counts; the small
        card-vs-CPU checks and the repairs' other phases check their own
        counts and leave the line's as the main paths at full size set
        them."""
        torch.cuda.synchronize()
        for mod in families.values():
            mod.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        got = {}
        for fam, mod in families.items():
            for key, n in mod.LAUNCH_CALLS.items():
                name = f"plane_{key[5]}" if fam == "plane" else fam
                nd = len(key[3])
                got[(name, nd)] = got.get((name, nd), 0) + n
        for key, n in got.items():
            if tally and key in chain_launches:
                chain_launches[key] += n
        return res, got, sec

    def show(got):
        return {f"{fam}/{nd}D": n for (fam, nd), n in sorted(got.items())}

    (misfits, fwi_grad, grad_ms), fwi_n, fwi_s = counted(lambda: fwi_descent(
        nw, sizes["fwi_steps"], k, sizes["fwi_row"], sizes["fwi_descent"],
        dev, f32))
    log(f"  FWI {nw}² f32, {sizes['fwi_steps']} steps, fused_k={k}: misfit "
        f"{misfits} over {sizes['fwi_descent']} descent steps "
        f"({fwi_s:.2f} s host clock incl. set-up and sync; per gradient "
        f"{[round(x, 3) for x in grad_ms]} ms); launches {show(fwi_n)}")
    (twin_max, twin_n, twin_s) = counted(lambda: twin_heat(
        nw, hk, sizes["twin_calls"], dev))
    log(f"  twin heat {nw}² f32 k={hk}, {sizes['twin_calls']} calls: max "
        f"|u| {twin_max[0]:.4e}, max |cot| {twin_max[1]:.4e} "
        f"({twin_s:.2f} s); launches {show(twin_n)}")
    ws = sizes["wave_twin_steps"]
    wave_gradient = wave_final_setup(nw, ws, k, dev, f32)
    ((wave_misfit, wave_grad), wave_n, wave_s) = counted(wave_gradient)
    log(f"  periodic wave final-field gradient {nw}² f32, {ws} steps, k={k}:"
        f" misfit {wave_misfit:.6e}, max |grad| "
        f"{wave_grad.abs().max().item():.4e} ({wave_s:.2f} s); launches "
        f"{show(wave_n)}")
    nf, rowf = sizes["fwi_small"], sizes["fwi_small_row"]

    def small_fwi(device):
        from pystencils_autodiff_tpu_torch.models import fwi_gradient

        u0, c0, obs, _ = fwi_setup(nf, 8, k, rowf, device, f64)
        return fwi_gradient(c0, u0, obs, rowf, 8, dt=WAVE_DT, fused_k=k)

    (small_card, small_n, _) = counted(lambda: small_fwi(dev))
    small_cpu_fwi = small_fwi(torch.device("cpu"))
    rel_v = abs(small_card[0].item() - small_cpu_fwi[0].item()) / abs(
        small_cpu_fwi[0].item())
    rel_g = ((small_card[1].cpu() - small_cpu_fwi[1]).abs().max()
             / small_cpu_fwi[1].abs().max()).item()
    log(f"  FWI {nf}² f64 card vs CPU: value rel {rel_v:.2e}, gradient rel "
        f"{rel_g:.2e}; launches {show(small_n)}")
    if not all(math.isfinite(x) for x in misfits) or not all(
            b < a for a, b in zip(misfits, misfits[1:])):
        raise AssertionError(f"FWI: the misfit did not fall: {misfits}")
    if not torch.isfinite(fwi_grad).all():
        raise AssertionError("FWI: non-finite gradient")
    if rel_v > 1e-8 or rel_g > 1e-8:
        raise AssertionError(f"FWI {nf}² f64: card vs CPU differ "
                             f"({rel_v:.2e}, {rel_g:.2e})")
    if (fwi_n.get(("time_chain", 2), 0) == 0
            or fwi_n.get(("adjoint_chain", 2), 0) == 0
            or twin_n.get(("time_chain", 2), 0) == 0):
        raise AssertionError(f"a chain main path launched no chain kernel: "
                             f"FWI {fwi_n}, twin {twin_n}")
    want = {("time_chain", 2): ws // k, ("twin_accum", 2): ws // k}
    del wave_gradient
    if ({key: n for key, n in wave_n.items() if n} != want
            or not math.isfinite(wave_misfit)
            or not torch.isfinite(wave_grad).all()):
        raise AssertionError(f"periodic wave gradient: launches {wave_n} "
                             f"(expected {want}) or non-finite values")

    log("== BASELINE config #2: 3D variable-κ diffusion, ∂/∂κ through the "
        "fused chains")
    c2k, c2n = sizes["cfg2_k"], sizes["cfg2_steps"]
    cfg2_losses, cfg2_ms, cfg2_n = config2_descent(
        n3, c2n, c2k, sizes["cfg2_descent"], dev, f32, counted)
    log(f"  {n3}³ f32, {c2n} steps, k={c2k}: loss {cfg2_losses} over "
        f"{sizes['cfg2_descent']} descent steps; per gradient "
        f"{[round(x, 3) for x in cfg2_ms]} ms host clock; launches "
        f"{show(cfg2_n)}")
    if not all(math.isfinite(x) for x in cfg2_losses) or not all(
            b < a for a, b in zip(cfg2_losses, cfg2_losses[1:])):
        raise AssertionError(f"config #2: the loss did not fall: "
                             f"{cfg2_losses}")
    n24 = sizes["cfg2_small"]

    kappa24, vg24 = config2_setup(n24, c2n, c2k, dev, f64)
    (small2, small2_n, _) = counted(lambda: vg24(kappa24))
    kappa24, vg24 = config2_setup(n24, c2n, c2k, torch.device("cpu"), f64)
    small2_cpu = vg24(kappa24)
    rel2_v = abs(small2[0].item() - small2_cpu[0].item()) / abs(
        small2_cpu[0].item())
    rel2_g = ((small2[1].cpu() - small2_cpu[1]).abs().max()
              / small2_cpu[1].abs().max()).item()
    log(f"  {n24}³ f64 card vs CPU: value rel {rel2_v:.2e}, κ-gradient rel "
        f"{rel2_g:.2e}; launches {show(small2_n)}")
    if rel2_v > 1e-12 or rel2_g > 1e-12:
        raise AssertionError(f"config #2 {n24}³ f64: card vs CPU differ "
                             f"({rel2_v:.2e}, {rel2_g:.2e})")
    log("== BASELINE config #4: the elastic P-SV pair with a Cerjan sponge "
        "through the stage chains, and aniso27")
    ne, ec, ek = sizes["elastic"], sizes["elastic_cycles"], sizes["elastic_k"]
    el_losses, el_ms, el_n = elastic_descent(
        ne, ec, ek, sizes["elastic_descent"], dev, f32, counted)
    log(f"  elastic {ne}² f32, {ec} cycles, k={ek}, sponge width "
        f"{sizes['sponge_width']}: loss {el_losses} over "
        f"{sizes['elastic_descent']} line-searched descent steps on the "
        f"initial fields; per gradient {[round(x, 3) for x in el_ms]} ms "
        f"host clock; launches {show(el_n)}")
    if not all(math.isfinite(x) for x in el_losses) or not all(
            b < a for a, b in zip(el_losses, el_losses[1:])):
        raise AssertionError(f"elastic: the loss did not fall: {el_losses}")
    nes = sizes["elastic_small"]

    def small_elastic(device, count=False):
        """(loss, gradients) at a perturbed start; on the card, launches
        counted for the value and gradient alone (the set-up's forward
        run makes the observation)."""
        x, vg, _, _ = elastic_setup(nes, ec, ek, device, f64)
        x = {nm: t + 0.01 for nm, t in x.items()}
        return counted(lambda: vg(x), tally=False) if count else vg(x)

    (small_e, small_e_n, _) = small_elastic(dev, count=True)
    small_e_cpu = small_elastic(torch.device("cpu"))
    rele_v = abs(small_e[0].item() - small_e_cpu[0].item()) / abs(
        small_e_cpu[0].item())
    rele_g = max(((small_e[1][nm].cpu() - g).abs().max()
                  / g.abs().max()).item()
                 for nm, g in small_e_cpu[1].items())
    want_e = {("stage_chain", 2): ec // ek, ("stage_adjoint", 2): ec // ek}
    log(f"  elastic {nes}² f64 card vs CPU: loss rel {rele_v:.2e}, gradient "
        f"rel {rele_g:.2e}; launches {show(small_e_n)}")
    if rele_v > 1e-12 or rele_g > 1e-12:
        raise AssertionError(f"elastic {nes}² f64: card vs CPU differ "
                             f"({rele_v:.2e}, {rele_g:.2e})")
    if {key: v for key, v in small_e_n.items() if v} != want_e:
        raise AssertionError(f"elastic {nes}² f64: launches {small_e_n}, "
                             f"expected {want_e}")
    na, ast_ = sizes["aniso"], sizes["aniso_steps"]
    aniso_run = aniso_value_and_grad(na, ast_, ak, dev)
    ((a_loss, a_grad), a_n, a_s) = counted(aniso_run)
    del aniso_run
    log(f"  aniso27 {na}³ f32 periodic, {ast_} steps, k={ak} (twin route): "
        f"loss {a_loss.item():.6e}, max |grad| "
        f"{a_grad.abs().max().item():.4e} ({a_s * 1e3:.3f} ms host clock); "
        f"launches {show(a_n)}")
    want_a = {("time_chain", 3): 3 * (ast_ // ak)}
    if ({key: v for key, v in a_n.items() if v} != want_a
            or not math.isfinite(a_loss.item())
            or not torch.isfinite(a_grad).all()):
        raise AssertionError(f"aniso27: launches {a_n} (expected {want_a}) "
                             f"or non-finite values")
    a_turns = aniso_design_turns(na, ast_, ak, dev, a_loss, a_grad)
    log(f"  aniso27 value+gradient, forward chains in the march (picked) "
        f"and the box (PR 9's design) in turns, host clock: "
        + ", ".join(f"{d} {' / '.join(f'{t:.3f}' for t in v)} ms"
                    for d, v in a_turns.items()))
    del a_grad

    log("== the app-assembly layer: config #4 through the recorded call "
        "graph (GraphDataHandling), its replay, Simulation.fused_op and "
        "the kernel pairs")
    app_records, app_launches = app_phase(sizes, dev, counted)
    records += app_records

    log("== parallel/: config #5 and the sharded fused chains on four shards "
        "of the card, against the unsharded port; each shard mode against "
        "its plain version")
    par_records, par_launches = parallel_phase(sizes, dev, counted)
    log("== the lid-driven cavity inverse problem: D2Q9 BGK with bounce-back "
        "walls and a moving lid, d/d u_lid through the stage chains")
    nc, cs_, ckk = sizes["cavity"], sizes["cavity_steps"], sizes["cavity_k"]
    segs = sa.fused_stage_chain_vjp(cavity_stages(f32), ckk,
                                    boundary=CAVITY_BC, wanted={"uw1"}
                                    ).segments_for((nc, nc), 4)
    calls = cs_ // ckk
    want_c = {("stage_chain", 2): calls * segs,
              ("stage_adjoint", 2): calls * segs}
    c_losses, c_us, c_ms, c_n = cavity_descent(
        nc, cs_, ckk, sizes["cavity_descent"], dev, f32, counted, want_c)
    log(f"  cavity {nc}² f32, {cs_} steps, k={ckk} ({segs} segment(s) in "
        f"the backward): loss {c_losses} at u_lid {c_us}; per gradient "
        f"{[round(x, 3) for x in c_ms]} ms host clock; launches "
        f"{show(c_n)}")
    if not all(math.isfinite(x) for x in c_losses) or not all(
            b < a for a, b in zip(c_losses, c_losses[1:])):
        raise AssertionError(f"cavity: the loss did not fall: {c_losses}")
    ncs = sizes["cavity_small"]
    vg_card, _ = cavity_setup(ncs, cs_, ckk, dev, f64)
    (small_c, small_c_n, _) = counted(lambda: vg_card(0.05), tally=False)
    vg_cpu, _ = cavity_setup(ncs, cs_, ckk, torch.device("cpu"), f64)
    small_c_cpu = vg_cpu(0.05)
    relc_v = abs(small_c[0].item() - small_c_cpu[0].item()) / abs(
        small_c_cpu[0].item())
    relc_g = abs(small_c[1].item() - small_c_cpu[1].item()) / abs(
        small_c_cpu[1].item())
    log(f"  cavity {ncs}² f64 card vs CPU: loss rel {relc_v:.2e}, u_lid "
        f"gradient rel {relc_g:.2e}; launches {show(small_c_n)}")
    if relc_v > 1e-12 or relc_g > 1e-12:
        raise AssertionError(f"cavity {ncs}² f64: card vs CPU differ "
                             f"({relc_v:.2e}, {relc_g:.2e})")
    log("== path C: the D3Q19 BGK Taylor–Green vortex, d/dU0 through the "
        "forward chain (the march at 256³ f32) and the z-streaming "
        "two-phase mode")
    nb, lst, lk = sizes["lbm"], sizes["lbm_steps"], sizes["lbm_k"]
    p_losses, p_us, p_ms, p_n = path_c_descent(
        nb, lst, lk, sizes["lbm_descent"], dev, f32, counted)
    log(f"  D3Q19 {nb}³ f32 periodic, {lst} steps, k={lk}: loss {p_losses} "
        f"at U0 {p_us}; per gradient {[round(x, 3) for x in p_ms]} ms host "
        f"clock; launches {show(p_n)}")
    if not all(math.isfinite(x) for x in p_losses) or not all(
            b < a for a, b in zip(p_losses, p_losses[1:])):
        raise AssertionError(f"path C: the loss did not fall: {p_losses}")
    nbd = sizes["lbm_f64"]
    vg64 = path_c_setup(nbd, lst, lk, dev, f64)
    ((l64, g64), n64, s64) = counted(lambda: vg64(TG_U0))
    want64 = {forward_key(tc.chain_plan(lbm3d_op(f64), lk, LBM_CARRY, True),
                          (nbd,) * 3, 8): lst // lk,
              ("plane_two_phase", 3): lst // lk}
    log(f"  D3Q19 {nbd}³ f64 periodic, {lst} steps, k={lk}: loss "
        f"{l64.item():.6e}, d/dU0 {g64.item():.6e} at U0 {TG_U0} "
        f"({s64 * 1e3:.3f} ms host clock, the first call); launches "
        f"{show(n64)}")
    if {key: v for key, v in n64.items() if v} != want64:
        raise AssertionError(f"path C {nbd}³ f64: launches {n64}, expected "
                             f"{want64}")
    # below the target U0 the loss falls as U0 grows
    if not (math.isfinite(l64.item()) and l64.item() > 0
            and g64.item() < 0):
        raise AssertionError(f"path C {nbd}³ f64: loss {l64.item()}, "
                             f"d/dU0 {g64.item()}")
    del vg64
    nls = sizes["lbm_small"]
    (small_p, small_p_n, _) = counted(
        lambda: path_c_setup(nls, lst, lk, dev, f64)(TG_U0), tally=False)
    small_p_cpu = path_c_setup(nls, lst, lk, torch.device("cpu"),
                               f64)(TG_U0)
    relp_v = abs(small_p[0].item() - small_p_cpu[0].item()) / abs(
        small_p_cpu[0].item())
    relp_g = abs(small_p[1].item() - small_p_cpu[1].item()) / abs(
        small_p_cpu[1].item())
    log(f"  D3Q19 {nls}³ f64 card vs CPU: loss rel {relp_v:.2e}, d/dU0 rel "
        f"{relp_g:.2e}; launches {show(small_p_n)}")
    if relp_v > 1e-12 or relp_g > 1e-12:
        raise AssertionError(f"path C {nls}³ f64: card vs CPU differ "
                             f"({relp_v:.2e}, {relp_g:.2e})")
    chain_records += repairs(sizes, dev, gen, counted, p_losses, p_us)
    log("== the depth ladder (Queue 3 #1's shapes, where no fused design "
        "fits at the chain's depth)")
    ladder_phase(sizes, dev, gen, counted)
    log("== serving parity: config #5's sharded run exported with its "
        "gradient and loaded in a fresh process (Queue 1 #16), which runs "
        "beside the next phase's exports")
    work = REPO / "build" / "sharded_export"
    work.mkdir(parents=True, exist_ok=True)
    sharded_check = sharded_export_phase(sizes, dev, work)
    log("== serving.py: exported artifacts loaded in a fresh process (the "
        "κ-heat op, config #4's recorded graph, a step-count artifact), "
        "the custom-op layer's host cost")
    serving = serving_phase(sizes, dev)
    log("== serving parity: config #5's fresh process")
    sharded = sharded_check()
    log("== utils/autotune.py: nl3d's value+gradient swept over k and form; "
        "the default build takes the recorded form")
    tune = autotune_phase(sizes, dev)
    log("== the framework bridges: create_pytorch_op(backend=\"torch_native\") "
        "on the card (the window kernel), the generated C kernels on the host")
    bridge = bridge_phase(sizes, dev, bridges)
    log("== the examples: each script of examples/torch_port/ on the card "
        "at its published size (float64), then the Cahn–Hilliard spinodal "
        f"at {sizes['spinodal']}² float32, fused stage chain (kernel 12, "
        "periodic) against replay")
    ex_records, ex_window, ex_shards, ex_numbers = examples_phase(
        sizes, dev, counted)
    chain_records += ex_records
    for cp, n in ex_window.items():
        launches[cp] = launches.get(cp, 0) + n
    for key, n in ex_shards.items():
        par_launches[key] += n
    log(f"  launches in the chain main paths: {show(chain_launches)}")
    for key, n in chain_launches.items():
        if n == 0:
            raise AssertionError(f"no main path launched {key}")
    if any(m == "jax" or m.startswith("jax.") or m == "pystencils_autodiff_tpu"
           or m.startswith("pystencils_autodiff_tpu.") for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    def entry(name, source, where, launches, recs):
        rep = recs[0]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": where, "launches": launches,
               # bf16 cases hold to 0.05 of max |ref|, not to rounding
               "max_abs_err": max(r["max_abs_err"] for r in recs
                                  if not r.get("bf16")),
               "ms": rep["ms"], "plain_ms": rep["plain_ms"],
               "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
               "library_ms": rep["library_ms"], "case": rep["case"]}
        # the z-streaming two-phase kernel: the form that ran, and its
        # bound by the gather form's operation count too
        out.update({key: rep[key] for key in ("form", "bound_ms_gather")
                    if key in rep})
        # the accumulate="dd" libraries of the window kernel, in this row
        dd = [{k: r[k] for k in ("case", "ms", "plain_ms", "copy_ms",
                                 "bound_ms", "bound_by", "max_abs_err",
                                 "dd_over_pairwise")}
              for r in recs if r.get("accumulate") == "dd"]
        if dd:
            out["dd_cases"] = dd
        return out

    kernels = []
    for cp, where in REPLACES.items():
        recs = [r for r in records if r["counterpart"] == cp]
        kernels.append(entry(f"stencil_step[{cp}]", SOURCE, where,
                             launches[cp] + app_launches.get(cp, 0), recs))
    kernels.append(entry("row_tiled[_run_row_tiled]", SLAB_SOURCE,
                         SLAB_REPLACES, slab_launches, slab_records))
    for (fam, nd), (name, source, where) in CHAIN_KERNELS.items():
        recs = [r for r in chain_records
                if r["chain"] == fam and r["nd"] == nd]
        kernels.append(entry(name, source, where,
                             chain_launches[(fam, nd)], recs))
    for key, (name, source, where) in SHARD_KERNELS.items():
        kernels.append(entry(name, source, where, par_launches[key],
                             par_records[key]))
    for row in probe_rows:
        kernels.append({"route": "cuda", "source": PROBES_SOURCE, **row})
    keep = ("host_us_torch_function", "host_us_launcher", "host_us_added",
            "host_us_torch_function_grad", "host_us_added_grad",
            "small_step_ms", "heat_step_ms", "export_s", "save_s",
            "cuda_init_s", "load_s", "load4_s", "load_dd_s", "load_poly_s",
            "load_dyn_s",
            "child_s", "config4_loss_rel", "config4_grad_rel_max",
            "config4_launches", "phase_s")
    late = nvcc.BUILDS[n_built:]
    log(f"  nvcc.BUILDS {len(nvcc.BUILDS)} at the end, {n_built} after the "
        f"build section"
        + (f"; built late, missing from the prebuild list: "
           f"{[name for name, _ in late]}" if late else ""))
    return kernels, {"serving": {k: serving[k] for k in keep},
                     "autotune": tune, "bridges": bridge,
                     "ranks": rank_numbers, "hvp": hvp_numbers,
                     "sharded_export": sharded, "examples": ex_numbers,
                     "dd": dd_numbers, "probes": probe_numbers,
                     "builds": {"after_build_section": n_built,
                                "at_end": len(nvcc.BUILDS)}}


def _kernel_label(name: str) -> str:
    """Short label of a device event: the stencil kernel by mode, any other
    kernel by its name up to the argument list."""
    if "row_tiled<" in name:
        mode = name.split("row_tiled<", 1)[1].split(",")[2].strip()
        return "row_tiled " + {"0": "interior", "1": "full+mask"}.get(mode,
                                                                      mode)
    if "plane_chain<" in name:  # the z-streaming kernel by form
        form = name.split("plane_chain<", 1)[1].split(",")[7].strip()
        return "plane_chain " + {"0": "forward", "1": "two-phase gather",
                                 "2": "two-phase local"}.get(form, form)
    if "stage_march<" in name:  # kernel 12 or 13 by its mode
        mode = name.split("stage_march<", 1)[1].split(",")[3].strip()
        return {"false>": "stage_march forward (kernels 7, 12)",
                "true>": "stage_march two-phase (kernels 8, 10, 11, 13)"}.get(
                    mode.split("(")[0], "stage_march " + mode)
    for kern in ("stencil_step", "stencil_window"):
        if kern + "<" in name:
            mode = name.split(kern + "<", 1)[1].split(",")[2].strip()
            return kern + " " + {"0": "interior", "1": "full+mask",
                                 "2": "periodic"}.get(mode, mode)
    if "warp_chain<" in name:
        return "warp_chain (row 6)"
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0][:160]


def profile_step(name, step, steps, warmup, what):
    """Host-clock time per ``step()`` and, under ``torch.profiler``, the
    device's busy time, idle share, idle gaps and each kernel's share of
    device time; returns the summary.  The trace is kept under
    ``build/profile/<name>.json``."""
    import torch
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    out_dir = REPO / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("the profiler recorded no device events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events)
    busy, end, last, gaps = 0.0, spans[0][0], spans[0][2], []
    for a, b, ev in spans:  # union of the device intervals, and its gaps
        if a > end:
            gaps.append((a - end, last, ev))
        if b > end:
            busy += b - max(a, end)
            end, last = b, ev
    window = end - spans[0][0]
    by_label = {}
    for e in events:
        lab = _kernel_label(e["name"])
        by_label[lab] = by_label.get(lab, 0.0) + float(e["dur"])
    total = sum(by_label.values())
    log(f"== profile: {what}")
    log(f"  host clock: {host_ms:.3f} ms per step (ends in a read that "
        f"waits for the device)")
    log(f"  device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window:"
        f" idle share {100 * (1 - busy / window):.2f} %")
    gaps.sort(reverse=True)
    log(f"  {len(gaps)} idle gaps; the 5 longest hold "
        f"{sum(g for g, _, _ in gaps[:5]) / 1e3:.3f} ms:")
    for us, before, after in gaps[:5]:
        log(f"    {us:9.1f} us after {_kernel_label(before)[:60]} "
            f"before {_kernel_label(after)[:60]}")
    for lab, us in sorted(by_label.items(), key=lambda kv: -kv[1]):
        log(f"  {100 * us / total:6.2f} %  {us / steps / 1e3:8.4f} ms/step  "
            f"{lab}")
    return {"profile": name, "steps": steps, "host_ms_per_step": host_ms,
            "device_busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle_share": 1 - busy / window, "idle_gaps": len(gaps),
            "longest_gaps_us": [g for g, _, _ in gaps[:5]],
            "device_ms_per_step": {k: v / steps / 1e3
                                   for k, v in by_label.items()}}


def profile(dev, sizes=FULL, steps=5, warmup=3):
    """Device-time breakdowns of the main paths' steps (see the module
    doc): one Adam step of the heat inverse problem (per-cell and tiled),
    one FWI gradient, one κ gradient of config #2, one periodic-wave
    gradient, one elastic, cavity and path-C gradient."""
    import torch

    from pystencils_autodiff_tpu_torch.models import fwi_gradient

    n = sizes["heat2d"]
    heat_step, _, _ = heat_inverse_setup(example_op(), n, dev, torch.float32)
    heat = profile_step("heat_inverse_step", heat_step, steps, warmup,
                        f"heat inverse problem {n}² float32, one Adam step "
                        f"of 4 unrolled heat steps")
    tiled_step, _, _ = heat_inverse_setup(example_op(), n, dev, torch.float32,
                                          strategy="tiled")
    tiled = profile_step("heat_inverse_step_tiled", tiled_step, steps,
                         warmup, f"heat inverse problem {n}² float32 through "
                         f"the slab kernel (strategy=\"tiled\"), one Adam "
                         f"step")
    nw, ns, k, row = (sizes["wave"], sizes["fwi_steps"], sizes["chain_k"],
                      sizes["fwi_row"])
    u0, c, observed, _ = fwi_setup(nw, ns, k, row, dev, torch.float32)

    def fwi_step():
        return fwi_gradient(c, u0, observed, row, ns, dt=WAVE_DT,
                            fused_k=k)[0].item()

    fwi = profile_step("fwi_gradient", fwi_step, steps, warmup,
                       f"FWI gradient {nw}² float32, {ns} steps, "
                       f"fused_k={k}")
    n3, c2n, c2k = sizes["cube"], sizes["cfg2_steps"], sizes["cfg2_k"]
    kappa, value_and_grad = config2_setup(n3, c2n, c2k, dev, torch.float32)

    def cfg2_step():
        return value_and_grad(kappa)[0].item()

    cfg2 = profile_step("config2_kappa_gradient", cfg2_step, steps, warmup,
                        f"config #2 κ gradient {n3}³ float32, {c2n} steps, "
                        f"k={c2k}")
    del kappa, value_and_grad
    ws = sizes["wave_twin_steps"]
    wave_gradient = wave_final_setup(nw, ws, k, dev, torch.float32)

    def wave_step():
        return wave_gradient()[0]

    wave = profile_step("periodic_wave_gradient", wave_step, steps, warmup,
                        f"periodic-wave final-field gradient {nw}² float32, "
                        f"{ws} steps, k={k}")
    del wave_gradient
    ne, ec, ek = sizes["elastic"], sizes["elastic_cycles"], sizes["elastic_k"]
    x0, el_vg, _, _ = elastic_setup(ne, ec, ek, dev, torch.float32)

    def elastic_step():
        return el_vg(x0)[0].item()

    elastic = profile_step("elastic_gradient", elastic_step, steps, warmup,
                           f"config #4 elastic gradient {ne}² float32, "
                           f"{ec} cycles, k={ek}, sponge")
    del x0, el_vg
    nc, cs_, ck_ = sizes["cavity"], sizes["cavity_steps"], sizes["cavity_k"]
    c_vg, _ = cavity_setup(nc, cs_, ck_, dev, torch.float32)

    def cavity_step():
        return c_vg(0.05)[0].item()

    cavity = profile_step("cavity_lid_gradient", cavity_step, steps, warmup,
                          f"cavity u_lid gradient {nc}² float32, {cs_} "
                          f"steps, k={ck_}")
    del c_vg
    nb, lst, lk = sizes["lbm"], sizes["lbm_steps"], sizes["lbm_k"]
    p_vg = path_c_setup(nb, lst, lk, dev, torch.float32)

    def path_c_step():
        return p_vg(TG_U0)[0].item()

    path_c = profile_step("path_c_gradient", path_c_step, steps, warmup,
                          f"path C d/dU0, D3Q19 Taylor–Green {nb}³ float32, "
                          f"{lst} steps, k={lk}")
    return {"profiles": [heat, tiled, fwi, cfg2, wave, elastic, cavity,
                         path_c]}


def slab_ab(dev, sizes=FULL):
    """A/B variants of the slab kernel (row 5) in one process, each timed
    in turns with the per-cell kernel on the same inputs: the default
    geometry; chunks of half and twice the rows; twice and four times the
    ring slots (more chunks in flight) at the same or a smaller ring; a
    lateral tile of twice and half the columns; copies forced per element (the route where no
    width fits: the cost of the copy issue and of the clamps and masks).
    The κ-heat forward and backward at 8192² f32 and the variable-κ
    diffusion forward and backward at 384³ f32.  Returns the records."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                      heat_step_op)
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program,
                                                   make_cuda_stencil)
    from pystencils_autodiff_tpu_torch.ops import row_tiled as rt

    gen = torch.Generator(device=dev).manual_seed(99)
    ops = ((heat_step_op(kappa_field=True), (sizes["heat2d"],) * 2),
           (diffusion3d_op(), (sizes["cube"],) * 3))
    build_all(step_sources([p for op, _ in ops for p in (
        forward_program(op), backward_program(op))], dtypes=("float32",),
        periodic=False, forms=("window", "direct", "slab")))
    out = []
    for op, n in ops:
        fwd, bwd = forward_program(op), backward_program(op)
        nd = len(n)
        lat = rt.LATERAL[nd]
        rows = rt.TILE_ROWS[nd]
        def rows_stages(r, st):
            return {"TILE_ROWS": {**rt.TILE_ROWS, nd: max(1, r)},
                    "STAGES": st}

        variants = [("default", {}),
            ("rows/2", rows_stages(rows // 2, rt.STAGES)),
            ("rows*2", rows_stages(rows * 2, rt.STAGES)),
            ("stages*2", rows_stages(rows, rt.STAGES * 2)),
            ("stages*2 rows/2", rows_stages(rows // 2, rt.STAGES * 2)),
            ("stages*4 rows/4", rows_stages(rows // 4, rt.STAGES * 4)),
            ("x*2", {"LATERAL": {**rt.LATERAL, nd: lat[:-1] + (
                lat[-1] * 2,)}} if math.prod(lat) * 2 <= 256 else None),
            ("x/2", {"LATERAL": {**rt.LATERAL, nd: lat[:-1] + (
                lat[-1] // 2,)}}),
            ("per-element copies", {"WIDTHS": ()})]
        for prog, kw in ((fwd, {}), (bwd, {"full_domain": True,
                                           "adjoint_mask_ghost": fwd.ghost})):
            inputs = random_inputs(prog, n, torch.float32, gen, dev)
            cell = make_cuda_stencil(prog, **kw)
            slab = make_cuda_stencil(prog, strategy="tiled", **kw)
            for label, patch in variants:
                if patch is None:
                    continue
                saved = {k: getattr(rt, k) for k in patch}
                for k, v in patch.items():
                    setattr(rt, k, v)
                try:
                    turns = [[cuda_ms(lambda: slab(inputs)),
                              cuda_ms(lambda: cell(inputs))]
                             for _ in range(2)]
                finally:
                    for k, v in saved.items():
                        setattr(rt, k, v)
                rec = {"case": f"{prog.name} {n}", "variant": label,
                       "slab_ms": [t[0] for t in turns],
                       "cell_ms": [t[1] for t in turns]}
                log(f"  {rec['case']:34s} {label:20s} slab "
                    f"{' / '.join(f'{t[0]:.3f}' for t in turns)} ms, "
                    f"per-cell {' / '.join(f'{t[1]:.3f}' for t in turns)} ms")
                out.append(rec)
            del inputs
            torch.cuda.empty_cache()
    return out


def window_ab(dev, sizes=FULL):
    """The window single step's tile (R cells along dim 0 × V along the
    contiguous dim a thread) at the shapes of PERF.md rows 1–4, every
    (R, V) of 1, 2 and 4 (V at most 16 bytes) beside the per-cell
    kernel, held against the plain version and timed in turns (each
    variant, then back; grids of at most 2²³ cells also on the card
    alone, ``graph_ms``); what ``cuda_kernel.window_tile`` is fitted
    to."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_cuda_source
    from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                      heat_step3d_op,
                                                      heat_step_op)
    from pystencils_autodiff_tpu_torch.ops import cuda_kernel as ck
    from pystencils_autodiff_tpu_torch.ops import (backward_program,
                                                   forward_program,
                                                   make_cuda_stencil,
                                                   make_torch_stencil)

    f32, f64 = torch.float32, torch.float64
    heat, d3 = heat_step_op(kappa_field=True), diffusion3d_op()
    hf, hb = forward_program(heat), backward_program(heat)
    df, db = forward_program(d3), backward_program(d3)
    tf_ = forward_program(heat_step3d_op())
    hcf = forward_program(heat_step_op(dt=0.1))
    m2 = {"full_domain": True, "adjoint_mask_ghost": hf.ghost}
    m3 = {"full_domain": True, "adjoint_mask_ghost": df.ghost}
    n2, n2d, n3 = sizes["heat2d"], sizes["heat2d_f64"], sizes["cube"]
    cases = [("heat2d fwd f32", hf, (n2, n2), f32, {}),
             ("heat2d bwd f32", hb, (n2, n2), f32, m2),
             ("heat2d const fwd f32", hcf, (n2, n2), f32, {}),
             ("heat2d fwd f64", hf, (n2d, n2d), f64, {}),
             ("heat2d bwd f64", hb, (n2d, n2d), f64, m2),
             ("heat2d fwd f32 ragged", hf, sizes["ragged"], f32, {}),
             ("heat2d bwd f32 ragged", hb, sizes["ragged"], f32, m2),
             ("heat2d fwd f32 tall", hf, sizes["tall"], f32, {}),
             ("heat2d bwd f32 tall", hb, sizes["tall"], f32, m2),
             ("heat2d fwd f32 64²", hf, (64, 64), f32, {}),
             ("heat2d bwd f32 64²", hb, (64, 64), f32, m2),
             ("heat2d fwd f64 16²", hf, (16, 16), f64, {}),
             ("heat2d bwd f64 16²", hb, (16, 16), f64, m2),
             ("diffusion3d fwd f32", df, (n3,) * 3, f32, {}),
             ("diffusion3d bwd f32", db, (n3,) * 3, f32, m3),
             ("heat3d fwd f32", tf_, (n3,) * 3, f32, {}),
             ("heat3d fwd periodic f32", tf_, (n3,) * 3, f32,
              {"periodic": True})]

    def mode(kw):
        return ("periodic" if kw.get("periodic") else "full"
                if kw.get("full_domain") else "interior")

    def tiles(dtype, spatial):
        return [(r, v) for r in (1, 2, 4) for v in (1, 2, 4)
                if v * dtype.itemsize <= 16 and 32 * v <= 2 * spatial[-1]]

    sources = []
    for _, prog, spatial, dtype, kw in cases:
        dt = str(dtype)[6:]
        sources += [(f"{prog.name}_{mode(kw)}_window_r{t[0]}v{t[1]}_{dt}",
                     generate_cuda_source(prog, dt, mode(kw), "window", t))
                    for t in tiles(dtype, spatial)]
        sources += step_sources([prog], dtypes=(dt,), periodic=False,
                                forms=("strided" if spatial[0] > 65535
                                       else "direct",))
    log(f"== window A/B: {len(sources)} libraries")
    build_all(sources)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, prog, spatial, dtype, kw in cases:
        inputs = random_inputs(prog, spatial, dtype, gen, dev)
        ref = make_torch_stencil(prog, **kw)(inputs)
        runs = [("cell", make_cuda_stencil(prog, form="cell", **kw))] + [
            (f"r{t[0]}v{t[1]}", make_cuda_stencil(prog, window=t, **kw))
            for t in tiles(dtype, spatial)]
        for label, fn in runs:
            got = fn(inputs)
            for n, r in ref.items():
                diff = (got[n] - r).abs().max().item()
                if not diff <= TOL[str(dtype)[6:]] * 2 * r.abs().max().item():
                    raise AssertionError(f"{name} {label}: differs from the "
                                         f"plain version by {diff:.3e}")
        times = {label: [] for label, _ in runs}
        for i in list(range(len(runs))) + list(range(len(runs)))[::-1]:
            label, fn = runs[i]
            times[label].append(cuda_ms(lambda: fn(inputs)))
        mean = {label: statistics.mean(t) for label, t in times.items()}
        pick = ck.window_tile(prog, spatial, dtype.itemsize)
        picked = f"r{pick[0]}v{pick[1]}"
        best = min(mean, key=mean.get)
        log(f"  {name:26s} picked {picked} {mean[picked]:.3f} ms, best "
            f"{best} {mean[best]:.3f}, cell {mean['cell']:.3f}: "
            + ", ".join(f"{label} {t:.3f}" for label, t in mean.items()))
        rec = {"case": name, "ms": mean, "picked": list(pick)}
        if math.prod(spatial) <= 1 << 23:
            # small shapes: also the device time alone, in turns
            dev_ms = {label: [] for label, _ in runs}
            for i in list(range(len(runs))) + list(range(len(runs)))[::-1]:
                label, fn = runs[i]
                dev_ms[label].append(graph_ms(lambda: fn(inputs)))
            g = {label: statistics.mean(t) for label, t in dev_ms.items()}
            gbest = min(g, key=g.get)
            log(f"  {name:26s} device alone: picked {g[picked]:.4f} ms, "
                f"best {gbest} {g[gbest]:.4f}, cell {g['cell']:.4f}: "
                + ", ".join(f"{label} {t:.4f}" for label, t in g.items()))
            rec["graph_ms"] = g
        out.append(rec)
        del inputs, ref
        torch.cuda.empty_cache()
    return out


def shard_ab(dev, sizes=FULL):
    """Row 9s's two designs in turns on config #2's κ chain (``kappa22``:
    a 2×2 mesh of the card over 384³ f32, k=2, bounded, fused backward):
    the fused adjoint of shard (1, 1)'s block (200² × 384) through the
    march's two-phase mode (the route's pick) and through the z-streaming
    kernel in the form its reckoning picks, each held against the plain
    shard mode, CUDA events in turns (5 each); the same on the smallest
    block a user would shard it to, shard (1, 1) of a 4×4 split of 128³
    (40² × 128); then config #2's sharded κ-gradient with each design
    (the streaming one by the reckoning ``time_chain.two_phase_design``
    patched to pick it while the chain builds its backward) and the
    unsharded one, host clock in turns (5 each).  Returns the records."""
    import torch

    from pystencils_autodiff_tpu_torch.codegen.cuda_printer import \
        generate_plane_source
    from pystencils_autodiff_tpu_torch.models import diffusion3d_op
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import plane_adjoint as pa
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops.flatten import ShardSpec

    f32, tol = torch.float32, TOL["float32"]
    n3, ck3 = sizes["cube"], sizes["cfg2_k"]
    diff3d = diffusion3d_op(dt=DIFF_DT)
    entry = par_chains(sizes, dev)["kappa22"]
    pa.reset_launch_counts()
    kchain, spatial, _ = entry
    spec, _, _, extb = par_blocks(kchain, spatial)
    plan = kchain._chain_plan(spec)
    ap = ac.AdjointPlan(plan)
    form = pa.stream_geometry(plan, extb, 4, ap).form
    # the small block: shard (1, 1) of a 4×4 split of 128³, halo 4 a side
    n_s, h_s = 128, 2 * ck3
    own_s = n_s // 4
    plan_s = tc.chain_plan(diff3d, ck3, HEAT_CARRY, False,
                           shard=ShardSpec((n_s,) * 3, (0, 1)))
    ap_s = ac.AdjointPlan(plan_s)
    blk_s = (own_s + 2 * h_s,) * 2 + (n_s,)
    form_s = pa.stream_geometry(plan_s, blk_s, 4, ap_s).form
    t0 = time.perf_counter()
    build_all(chain_libraries(kchain, spatial, f32, frozenset({"kappa"}))
              + [(f"{plan.program.name}_plane_two_phase_shard_{fm}_"
                  f"float32", generate_plane_source(ap, "two_phase",
                                                    "float32", fm))
                 for fm in sorted({form, form_s})]
              + [_march_first(*sm.chain_march_plans(plan_s), blk_s,
                              "float32", None),
                 chain_march_library(diff3d, HEAT_CARRY, (n3,) * 3,
                                     "float32", ck3, False),
                 _march_first(sm.chain_stage_plan(tc.chain_plan(
                     diff3d, ck3, HEAT_CARRY, False)), None, (n3,) * 3,
                     "float32", None)])
    second = march_variants()
    if second:
        build_all(second)
    log(f"  row 9s A/B libraries built in {time.perf_counter() - t0:.1f} s")
    halo = [kchain._halo_bwd.get(d, (0, 0)) for d in range(3)]
    blk, bases, owned = _interior_block(kchain, spatial, f32, dev, halo, 66,
                                        {"u": "plain", "kappa": "positive"},
                                        False)
    gen = torch.Generator(device=dev).manual_seed(67)
    cots = {"u": torch.zeros_like(blk["u"]),
            "kappa": torch.zeros_like(blk["kappa"])}
    view = _owned_view(kchain, "u", cots["u"], owned)
    view.copy_(torch.randn(view.shape, generator=gen, device=dev, dtype=f32))
    wanted = frozenset({"u", "kappa"})
    kernels = {"march": ac.make_chain_march_kernel(plan, sa, wanted),
               "stream": pa.make_plane_adjoint_kernel(ap, form)}
    # each design against the plain shard mode, beside its bound
    out = [_shard_case_chain(f"diffusion3d adjoint k2 shard (1,1)/2x2 f32, "
                             f"{d}", entry, "two_phase", dev, design=d)
           for d in kernels]
    ms = {d: [] for d in kernels}
    for d in abba(("march", "stream")):
        ms[d].append(cuda_ms(lambda: kernels[d](blk, cots, (), bases)))
    log(f"  row 9s on the κ block {tuple(extb)} f32 ({card_line()}), CUDA "
        f"events in turns: {_turns_text(ms)}; stream / march "
        f"{_ratio_text(ms, 'stream', 'march')}; bound "
        f"{out[0]['bound_ms']:.3f} ms")
    out.append({"case": "row 9s kappa block in turns", "ms": ms,
                "block": list(extb), "stream_form": form})
    del blk, cots

    # the small block, each design against the plain shard mode
    gs = torch.Generator().manual_seed(68)
    base_s = [own_s - h_s, own_s - h_s, 0]
    st_s = {"u": torch.randn(blk_s, generator=gs),
            "kappa": 1.0 + 0.5 * torch.sigmoid(torch.randn(blk_s,
                                                           generator=gs))}
    cot_s = {"u": torch.zeros(blk_s), "kappa": torch.zeros(blk_s)}
    cot_s["u"][h_s:h_s + own_s, h_s:h_s + own_s] = torch.randn(
        (own_s, own_s, n_s), generator=gs)
    st_s = {n: t.to(dev) for n, t in st_s.items()}
    cot_s = {n: t.to(dev) for n, t in cot_s.items()}
    small = {"march": ac.make_chain_march_kernel(plan_s, sa, wanted),
             "stream": pa.make_plane_adjoint_kernel(ap_s, form_s)}
    _, ref = ac.plain_chain_vjp(ap_s)(st_s, cot_s, (), base_s)
    errs = {}
    for d, kern in small.items():
        _, got = kern(st_s, cot_s, (), base_s)
        errs[d] = max(_rel(got[n], ref[n]) for n in ("u", "kappa"))
        if errs[d] > 10 * tol:
            raise AssertionError(f"row 9s small block, {d}: rel "
                                 f"{errs[d]:.2e}")
    ms_s = {d: [] for d in small}
    for d in abba(("march", "stream")):
        ms_s[d].append(cuda_ms(lambda: small[d](st_s, cot_s, (), base_s)))
    log(f"  row 9s on the small block {blk_s} f32 (shard (1,1) of a 4×4 "
        f"split of {n_s}³; {card_line()}), rel to the plain version "
        f"{errs}, CUDA events in turns: {_turns_text(ms_s)}; stream / "
        f"march {_ratio_text(ms_s, 'stream', 'march')}; stream form "
        f"{form_s}")
    out.append({"case": "row 9s small block in turns", "ms": ms_s,
                "block": list(blk_s), "stream_form": form_s, "rel": errs})
    del st_s, cot_s, ref

    vg2, uchain = config2_sharded(sizes, dev, kchain)
    schain = par_chains(sizes, dev)["kappa22"][0]
    pick = tc.two_phase_design
    tc.two_phase_design = lambda *a: "stream"
    try:
        vg2(schain)  # its route's design is kept per block shape
    finally:
        tc.two_phase_design = pick
    res = {label: vg2(ch) for label, ch in (("march", kchain),
                                            ("stream", schain),
                                            ("unsharded", uchain))}
    for label in ("march", "stream"):
        rel = max(abs(res[label][0].item() - res["unsharded"][0].item())
                  / abs(res["unsharded"][0].item()),
                  _rel(res[label][1], res["unsharded"][1]))
        if rel > 10 * tol:
            raise AssertionError(f"sharded config #2, {label}: rel "
                                 f"{rel:.2e}")
    designs = {label: sorted(set(g.designs.values()))
               for label, ch in (("march", kchain), ("stream", schain))
               for key, g in ch._kernels.items() if key[0] == "vjp"}
    t = in_turns({label: (lambda ch=ch: vg2(ch)[0].item())
                  for label, ch in (("march", kchain), ("stream", schain),
                                    ("unsharded", uchain))},
                 abba(("march", "stream", "unsharded")))
    log(f"  config #2's κ-gradient on a 2×2 mesh ({card_line()}), row 9s "
        f"designs {designs}, host clock in turns: {_turns_text(t)}; "
        f"sharded / unsharded: march {_ratio_text(t, 'march', 'unsharded')}"
        f", stream {_ratio_text(t, 'stream', 'unsharded')}")
    out.append({"case": "config #2 sharded gradient", "ms": t,
                "designs": designs})
    return out


def march_ab(dev, sizes=FULL):
    """The march's block size, residency, chunk and rounds choices on the
    main paths' march cases — kernel 8's FWI wave (k=4, 8192² f32, one
    probe), kernel 11's config #2 (k=2, 384³ f32), kernels 12 and 13 on the
    cavity and the elastic pair, row 7's forward mode on config #2's chain
    (κ-diffusion k=2 384³ f32) and path C's (D3Q19 k=2 256³ f32) — each
    timed at the reckoning's pick, at every (threads, blocks per SM)
    choice of ``stage_march.GAIN`` (those the kernel's registers do not
    allow with the registers capped), at forced chunk heights (2D) or
    tiles and planes a step (3D) and with the dim-0 segments of the
    earlier rule (two blocks a resident slot) instead of the rounds: what
    ``STEP_OVERHEAD``, ``GAIN`` and ``ROUND_TAIL`` are fitted to.  Each
    case's pick is reported against the best variant seen.  Returns the
    records."""
    import torch

    from pystencils_autodiff_tpu_torch.models import (diffusion3d_op,
                                                      wave_step_op)
    from pystencils_autodiff_tpu_torch.models.wave import WAVE_CARRY
    from pystencils_autodiff_tpu_torch.ops import adjoint_chain as ac
    from pystencils_autodiff_tpu_torch.ops import stage_adjoint as sa
    from pystencils_autodiff_tpu_torch.ops import stage_chain as sc
    from pystencils_autodiff_tpu_torch.ops import stage_march as sm
    from pystencils_autodiff_tpu_torch.ops import time_chain as tc
    from pystencils_autodiff_tpu_torch.ops import twin_adjoint as ta

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(77)
    ne, nc, nw, n3 = (sizes["elastic"], sizes["cavity"], sizes["wave"],
                      sizes["cube"])
    k, row = sizes["chain_k"], sizes["fwi_row"]
    wave, diff3d = wave_step_op(dt=WAVE_DT), diffusion3d_op(dt=DIFF_DT)
    stage = [("cavity", cavity_stages(f32), sizes["cavity_k"], CAVITY_BC,
              "cavity", (nc, nc), {"uw1"}),
             ("elastic sponge", elastic_chain_stages(f32), sizes["elastic_k"],
              elastic_boundary(), "elastic", (ne, ne), ())]
    chains = [("FWI wave two-phase", wave, WAVE_CARRY, k, (nw, nw),
               [("u_curr", row)]),
              ("config #2 twin-accum", diff3d, HEAT_CARRY, sizes["cfg2_k"],
               (n3,) * 3, [])]
    # row 7: the forward mode on config #2's chain and path C's
    forwards = [("config #2 forward", diff3d, HEAT_CARRY, sizes["cfg2_k"],
                 (n3,) * 3, False),
                ("path C forward (D3Q19)", lbm3d_op(f32), LBM_CARRY,
                 sizes["lbm_k"], (sizes["lbm"],) * 3, True)]
    fwd_plans = {name: tc.chain_plan(op, kk, carry, periodic)
                 for name, op, carry, kk, _, periodic in forwards}
    build_all([march_library(st, kk, False, b, "float32", w, sp, None)
               for _, st, kk, b, _, sp, wanted in stage
               for w in ("fwd", wanted)]
              + [chain_march_library(op, carry, sp, "float32", kk, False, pr)
                 for _, op, carry, kk, sp, pr in chains]
              + [_march_first(sm.chain_stage_plan(fwd_plans[name]), None,
                              sp, "float32", None)
                 for name, _, _, _, sp, _ in forwards])
    second = march_variants()
    if second:
        build_all(second)
    runs = []  # (case label, factory of (kernel, call), its dim count)
    for name, stages, kk, bnd, kind, spatial, wanted in stage:
        plan = sc.StagePlan(stages, kk, False, bnd)
        ap = sa.AdjointStagePlan(plan, wanted)
        state = stage_state(kind, spatial, f32, dev, gen,
                            sizes["sponge_width"])
        cots = {n: torch.randn(state[n].shape, generator=gen, dtype=f32,
                               device=dev) for n in ap.cot_names}

        def fwd(plan=plan, state=state):
            kern = sc.make_stage_kernel(plan, "march")
            return kern, lambda: kern(state)

        def adj(ap=ap, state=state, cots=cots):
            kern = sa.make_stage_adjoint_kernel(ap, "march")
            return kern, lambda: kern(state, cots)

        runs += [(f"{name} fwd k{kk} {spatial}", fwd, 2),
                 (f"{name} adj k{kk} {spatial}", adj, 2)]
    for name, op, carry, kk, spatial, probes in chains:
        plan = tc.chain_plan(op, kk, carry, False, probes)
        state = random_inputs(plan.program, spatial, f32, gen, dev)
        cots = {n: torch.randn(t.shape, generator=gen, dtype=f32, device=dev)
                for n, t in state.items()}
        pcs = tuple(torch.randn((kk, spatial[-1]), generator=gen, dtype=f32,
                                device=dev) for _ in probes)

        def chain(plan=plan, state=state, cots=cots, pcs=pcs):
            if plan.program.ndim == 3:
                tp = ac.fused_chain_vjp(plan.op, plan.k, HEAT_CARRY,
                                        periodic=False).plan
                kern = ta.make_twin_accum_kernel(tp)
                return kern.kernel, lambda: kern(state, cots)
            kern = ac.make_adjoint_kernel(ac.AdjointPlan(plan))
            return kern.kernel, lambda: kern(state, cots, pcs)

        runs.append((f"{name} k{kk} {spatial}", chain, len(spatial)))
    for name, op, carry, kk, spatial, periodic in forwards:
        plan = fwd_plans[name]
        state = random_inputs(plan.program, spatial, f32, gen, dev)

        def forward(plan=plan, state=state):
            kern = tc.make_chain_kernel(plan, "march")
            return kern.kernel("march").kernel, lambda: kern(state)

        runs.append((f"{name} k{kk} {spatial}", forward, 3))
    saved = (sm.CHUNKS_2D, sm.CHUNKS_3D, sm.TILES_3D, sm.GAIN,
             sm.MARCH_SEGMENTS, sm._configs)
    out = []
    for case, factory, nd in runs:
        kern, call = factory()
        ms = cuda_ms(call)
        picked = kern.last_geometry
        variants = [("picked", picked, ms)]
        regs = kern.regs
        # every (threads, blocks per SM) choice, those the registers do not
        # allow with the registers capped to fit (__launch_bounds__)
        allowed = sm._configs(regs)
        forced = [(f"{c[0]} threads x {c[1]}" + (
            "" if c in allowed else f" (<= {sm.REGS_PER_SM // (c[0] * c[1])}"
            f" registers)"), {"GAIN": {c: 1.0},
                              "_configs": lambda regs, c=c: [c]})
                  for c in sm.GAIN]
        cfg = (picked.threads, picked.blocks_per_sm)
        if nd == 2:
            forced += [(f"{cfg[0]} threads x {cfg[1]}, {ch} row(s)",
                        {"GAIN": {cfg: 1.0}, "CHUNKS_2D": (ch,)})
                       for ch in (1, 2, 4, 8) if ch != picked.chunk]
        else:
            forced += [(f"{cfg[0]} threads x {cfg[1]}, tile {t}",
                        {"GAIN": {cfg: 1.0}, "TILES_3D": (t,)})
                       for t in ((16, 32), (32, 32), (16, 64), (32, 64),
                                 (8, 8), (8, 16), (12, 12), (16, 16))
                       if t != tuple(picked.tile)]
            forced += [(f"{cfg[0]} threads x {cfg[1]}, {ch} plane(s) a "
                        f"step", {"GAIN": {cfg: 1.0}, "CHUNKS_3D": (ch,)})
                       for ch in (1, 2) if ch != picked.chunk]
        ntiles = math.prod(-(-a // b) for a, b in zip(
            picked.geo[1:3], picked.tile))
        halo0 = sm._halo0(picked.program, sm._lags_and_extents(
            picked.program))
        old = max(1, min(math.ceil(2 * sm.NUM_SMS * picked.blocks_per_sm
                                   / ntiles), picked.geo[0] // halo0))
        if old != picked.nseg:
            forced.append((f"two blocks a slot: {old} segments",
                           {"GAIN": {(picked.threads,
                                      picked.blocks_per_sm): 1.0},
                            "MARCH_SEGMENTS": old}))
        for label, patch in forced:
            for key, val in patch.items():
                setattr(sm, key, val)
            try:
                kern, call = factory()
                ms = cuda_ms(call)
                variants.append((label, kern.last_geometry, ms))
            except ValueError as exc:  # no march of that choice fits
                log(f"  {case} {label}: {exc}")
            finally:
                (sm.CHUNKS_2D, sm.CHUNKS_3D, sm.TILES_3D, sm.GAIN,
                 sm.MARCH_SEGMENTS, sm._configs) = saved
        for label, mg, ms in variants:
            rec = {"case": case, "variant": label, "ms": ms,
                   "regs": regs, **{key: v for key, v in {
                       "forms": list(mg.forms), "chunk": mg.chunk,
                       "tile": list(mg.tile), "segments": mg.nseg,
                       "threads": mg.threads,
                       "blocks_per_sm": mg.blocks_per_sm,
                       "rounds": mg.rounds, "owned_share": mg.owned_share,
                       "work": mg.work}.items()}}
            log(f"  {case:40s} {label:30s} {ms:8.3f} ms  tile {mg.tile}, "
                f"{mg.chunk} row(s), {mg.threads} threads x "
                f"{mg.blocks_per_sm}, {mg.nseg} segments in {mg.rounds} "
                f"rounds, owned {mg.owned_share:.3f}, regs {regs}")
            out.append(rec)
        best = min(variants, key=lambda v: v[2])
        log(f"  {case:40s} pick {variants[0][2]:.3f} ms against the best "
            f"variant seen, {best[0]}, {best[2]:.3f} ms "
            f"({variants[0][2] / best[2]:.3f})")
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the main paths' steps instead")
    ap.add_argument("--slab-ab", action="store_true",
                    help="time A/B variants of the slab kernel instead")
    ap.add_argument("--march-ab", nargs="?", const="all",
                    choices=("all", "9s"),
                    help="time the march's block size, residency, chunk "
                         "and rounds choices, and row 9s's two designs in "
                         "turns, instead (\"9s\": row 9s's designs alone)")
    ap.add_argument("--window-ab", action="store_true",
                    help="time the window single step's cells a thread "
                         "(R × V) beside the per-cell kernel instead")
    ap.add_argument("--host-ab", metavar="TREE",
                    help="time the 64² host cost and the 16² f64 Adam step "
                         "of the port in TREE (another checkout) against "
                         "this one, in turns, instead")
    ap.add_argument("--host-child", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not (REPO / "pystencils_autodiff_tpu_torch").is_dir():
        raise RuntimeError("chip_smoke.py runs from a checkout of the "
                           "repository (pystencils_autodiff_tpu_torch/ missing)")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    if args.host_child:
        return host_child(args.host_child)
    cpu0 = _cpu_times()
    log(f"host: {_cpu_line()}; {host_load()}")
    if (args.profile or args.slab_ab or args.march_ab or args.window_ab
            or args.host_ab):
        summary = (profile(dev) if args.profile
                   else {"slab_ab": slab_ab(dev)} if args.slab_ab
                   else {"window_ab": window_ab(dev)} if args.window_ab
                   else {"host_ab": host_ab(args.host_ab)} if args.host_ab
                   else {"shard_ab": shard_ab(dev)} if args.march_ab == "9s"
                   else {"shard_ab": shard_ab(dev),
                         "march_ab": march_ab(dev)})
        log(card)
        log(json.dumps(summary))
        return 0
    kernels, phases = run(dev)
    phases["seconds"] = {"build_section": BUILD_SECTION_S[0],
                         "run": time.perf_counter() - _T0}
    log(f"host: {host_load(cpu0)}")
    log(f"chip_smoke.py: {phases['seconds']['run']:.1f} s in all, the build "
        f"section {BUILD_SECTION_S[0]:.1f} s")
    log(card)
    log(json.dumps({"phases": phases}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
