// One stencil step on a Hopper GPU: the hand-written CUDA port of the four
// single-step Pallas kernels of pystencils_autodiff_tpu/ops/pallas_kernel.py
// (_run_whole_array, _run_blocked, _run_plane_single, _run_plane_full).
//
// What is per stencil (the arithmetic) is emitted from the StencilProgram by
// codegen/cuda_printer.py as `PsatBody::run`; everything else is here:
// indexing, halos, masks and the three domain modes.
//
//   INTERIOR  write lo <= i < n-hi in every dim, 0 on the ghost frame; an
//             accumulation output is prev everywhere and prev + val inside.
//   FULL      the exact VJP: every cell is written; primal reads are clamped
//             to the edge; adjoint reads are 0 outside the domain AND outside
//             the forward interior [alo, ahi), tested on the coordinates of
//             the cell that is read.
//   PERIODIC  every read wraps modulo the extent in every dim; no masks.
//
// Design: native nD indexing (2 and 3 spatial dims), one thread per output
// cell, blocks of 128 threads along the contiguous last dim, grid.y/.z over
// the leading dims (a strided variant past 65535 blocks, so any extent
// fits).  Every operand is a *plane* (one index component of one field)
// given by a base pointer and per-dim element strides, so AoS and SoA
// index dims, any spatial layout and stride-0 (expanded) cotangents are all
// just strides.  Offsets are int64.  Masks are coordinate compares, so the
// body stays branch-free apart from the interior test.
//
// Bound: the roofline is memory bandwidth — bytes per cell = each input
// plane read once + each output plane written once (neighbour reads hit
// L1/L2), a few flops per access.  Measured on the H100 (PERF.md), float32
// runs below it, held by the per-read cost (int64 index arithmetic, clamps
// and mask tests on every read); float64 comes close.  This kernel leaves
// the neighbour reuse to the caches; row_tiled.cuh is the shared-memory
// slab form (strategy="tiled"), which applies the clamp and the mask once,
// at load.  Storage type S (float, double, or bf16 computed in float T):
// loads and stores go through psat::ld/st (on_device.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

namespace psat {

enum Mode : int { INTERIOR = 0, FULL = 1, PERIODIC = 2 };

constexpr int kBlock = 128;

// S: the storage type of every plane (see ld/st in on_device.cuh)
template <typename S, int ND, int NIN, int NOUT>
struct Params {
    const S* in[NIN];
    int64_t in_st[NIN][ND];
    S* out[NOUT];
    int64_t out_st[NOUT][ND];
    int64_t n[ND];
    int64_t wlo[ND], whi[ND];  // INTERIOR write window [wlo, whi)
    int64_t alo[ND], ahi[ND];  // valid window of adjoint reads [alo, ahi)
};

template <typename T, typename S, int MODE, int ND, int NIN, int NOUT>
struct Cell {
    const Params<S, ND, NIN, NOUT>& p;
    int64_t i[ND];

    // primal read of input plane k at offset (o0, o1, o2): direct in
    // INTERIOR (the write window keeps every read in bounds), clamped to
    // the edge in FULL, wrapped in PERIODIC
    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        const int o[3] = {o0, o1, o2};
        int64_t off = 0;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            int64_t c = i[d] + o[d];
            if (MODE == FULL) {
                c = c < 0 ? 0 : (c >= p.n[d] ? p.n[d] - 1 : c);
            } else if (MODE == PERIODIC) {
                c = c < 0 ? c + p.n[d] : (c >= p.n[d] ? c - p.n[d] : c);
            }
            off += c * p.in_st[k][d];
        }
        return ld<T>(p.in[k] + off);
    }

    // adjoint read: 0 outside [alo, ahi) in INTERIOR and FULL; the load
    // itself uses clamped coordinates so it never leaves the array
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        if (MODE == PERIODIC) return rp(k, o0, o1, o2);
        const int o[3] = {o0, o1, o2};
        int64_t off = 0;
        bool ok = true;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            int64_t c = i[d] + o[d];
            ok = ok && c >= p.alo[d] && c < p.ahi[d];
            c = c < 0 ? 0 : (c >= p.n[d] ? p.n[d] - 1 : c);
            off += c * p.in_st[k][d];
        }
        const T val = ld<T>(p.in[k] + off);
        return ok ? val : T(0);
    }
};

// One output cell: index `last` of the last dim, i1 of dim -2, i2 of -3.
template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          typename Body>
__device__ __forceinline__ void cell_step(const Params<S, ND, NIN, NOUT>& p,
                                          int64_t last, int64_t i1,
                                          int64_t i2) {
    Cell<T, S, MODE, ND, NIN, NOUT> c{p, {}};
    c.i[ND - 1] = last;
    c.i[ND - 2] = i1;
    if constexpr (ND >= 3) c.i[ND - 3] = i2;

    bool inside = true;
    if (MODE == INTERIOR) {
#pragma unroll
        for (int d = 0; d < ND; ++d)
            inside = inside && c.i[d] >= p.wlo[d] && c.i[d] < p.whi[d];
    }
    T v[NOUT];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) v[k] = T(0);
    Body::template run<T>(c, inside, v);
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
        int64_t off = 0;
#pragma unroll
        for (int d = 0; d < ND; ++d) off += c.i[d] * p.out_st[k][d];
        st(p.out[k] + off, v[k]);
    }
}

// grid.x covers the last dim in blocks of kBlock cells, grid.y dim -2 and
// grid.z dim -3.  STRIDED (an extent above the 65535 blocks grid.y/.z
// hold; the launcher caps both): the block strides over the rest.
// Otherwise one cell per thread, with no loop — the loop costs the
// forward kernels up to 28 % of their speed on the H100 (PERF.md).
template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          typename Body, bool STRIDED>
__global__ void __launch_bounds__(kBlock)
stencil_step(const Params<S, ND, NIN, NOUT> p) {
    const int64_t last = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (last >= p.n[ND - 1]) return;
    if constexpr (!STRIDED) {
        cell_step<T, S, MODE, ND, NIN, NOUT, Body>(p, last, blockIdx.y,
                                                blockIdx.z);
    } else {
        const int64_t n2 = ND >= 3 ? p.n[ND >= 3 ? ND - 3 : 0] : 1;
        for (int64_t i2 = blockIdx.z; i2 < n2; i2 += gridDim.z)
            for (int64_t i1 = blockIdx.y; i1 < p.n[ND - 2]; i1 += gridDim.y)
                cell_step<T, S, MODE, ND, NIN, NOUT, Body>(p, last, i1, i2);
    }
}

}  // namespace psat
