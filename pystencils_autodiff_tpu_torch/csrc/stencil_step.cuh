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
// Every operand is a *plane* (one index component of one field) given by a
// base pointer and per-dim element strides, so AoS and SoA index dims, any
// spatial layout and stride-0 (expanded) cotangents are all just strides.
//
// Ranks: ND is the kernel's spatial dims, 2 or more.  A 1D program runs as
// ND = 2 with a leading extent of 1 (codegen/cuda_printer.py::kernel_nd);
// every other rank as itself.  Every coordinate, mask, clamp and wrap is
// per dim: above 3 dims the window design flattens its middle dims
// (1 … ND-2) into one axis of window rows (PsatWin::WY, decoded per dim
// by WinShape::yo) and the per-cell design merges the leading dims
// (0 … ND-3) into grid.z, taken apart again by div/mod (cell_step), so a
// read never lands on a neighbouring row of a merged index.
//
// Bound: the roofline is memory bandwidth — bytes per cell = each input
// plane read once + each output plane written once, a few flops per
// access.  Storage type S (float, double, or bf16 computed in float T):
// loads and stores go through psat::ld/st (on_device.cuh).
//
// Two designs, one body (`PsatBody::run` reads through an accessor `c`):
//
// * stencil_window (the route): each thread computes R cells along the
//   outermost dim (dim 0 in 2D, z in 3D) by V consecutive cells along the
//   contiguous last dim; a block of 32 × 4 threads owns one tile (2D: 4R
//   rows × 32V columns; 3D: R planes × 4 rows × 32V columns) and walks
//   the tiles grid-stride over a 1D grid of one block a tile (any extent
//   fits).  Each thread loads, per input plane, the window
//   its cells read — the R + reach rows of dim 0 (3D: × the reach of y)
//   by V + reach columns — into registers once, so a value that several
//   of its cells read costs one load; it loads the entries some read uses
//   and no other (PsatWin's tables).  A tile whose reads all lie inside the array (and, where
//   adjoint planes are read, inside the adjoint window [alo, ahi); in
//   INTERIOR mode, whose cells all lie in the write window) is *interior*,
//   the same answer for every thread of the block: it fills the window
//   (only the entries the body reads: PsatWin's tables) with no clamp and
//   no mask, from one base pointer per plane and row,
//   16 bytes a lane where the plane is contiguous and aligned
//   (host-reckoned `vec_in`), scalars where it is not.  Every other tile
//   fills the window with clamped (FULL, INTERIOR), masked (adjoint
//   planes) or wrapped (PERIODIC) coordinates.  The body then runs on the
//   window, so it is instantiated once per cell of the thread's R × V.
//   Heavy bodies (many operations a cell) take R = V = 1 (the host
//   reckoning, ops/cuda_kernel.py::window_tile).
// * stencil_step (the per-cell design, kept for the in-turns comparison:
//   form "cell"): one thread per output cell, blocks of 128 threads along
//   the last dim, grid.y/.z over the leading dims (a strided variant past
//   65535 blocks); every read computes its int64 offset and, in FULL mode,
//   clamps and tests its coordinates.  Neighbour reuse is left to L1.
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

    // primal read of input plane k at offsets (o_0, …; at least ND of
    // them, the rest 0): direct in INTERIOR (the write window keeps every
    // read in bounds), clamped to the edge in FULL, wrapped in PERIODIC
    template <typename... O>
    __device__ __forceinline__ T rp(int k, O... os) const {
        const int o[] = {int(os)...};
        static_assert(sizeof...(O) >= ND, "a read names every dim");
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
    template <typename... O>
    __device__ __forceinline__ T ra(int k, O... os) const {
        if (MODE == PERIODIC) return rp(k, os...);
        const int o[] = {int(os)...};
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

// The cells of dims 0 … ND-3 together (1 in 2D): grid.z's extent.
template <typename S, int ND, int NIN, int NOUT>
__device__ __forceinline__ int64_t lead_cells(
    const Params<S, ND, NIN, NOUT>& p) {
    int64_t n = 1;
#pragma unroll
    for (int d = 0; d < ND - 2; ++d) n *= p.n[d];
    return n;
}

// One output cell: index `last` of the last dim, i1 of dim -2, i2 of the
// leading dims 0 … ND-3 merged (row-major), taken apart by div/mod.
template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          typename Body>
__device__ __forceinline__ void cell_step(const Params<S, ND, NIN, NOUT>& p,
                                          int64_t last, int64_t i1,
                                          int64_t i2) {
    Cell<T, S, MODE, ND, NIN, NOUT> c{p, {}};
    c.i[ND - 1] = last;
    c.i[ND - 2] = i1;
    if constexpr (ND >= 3) {
#pragma unroll
        for (int d = ND - 3; d > 0; --d) {
            c.i[d] = i2 % p.n[d];
            i2 /= p.n[d];
        }
        c.i[0] = i2;
    }

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
// grid.z the leading dims 0 … ND-3, merged.  STRIDED (an extent above the 65535 blocks grid.y/.z
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
        const int64_t n2 = lead_cells(p);
        for (int64_t i2 = blockIdx.z; i2 < n2; i2 += gridDim.z)
            for (int64_t i1 = blockIdx.y; i1 < p.n[ND - 2]; i1 += gridDim.y)
                cell_step<T, S, MODE, ND, NIN, NOUT, Body>(p, last, i1, i2);
    }
}

// ---------------------------------------------------------------------------
// The window design.

// Per-dim reach of the body's reads (program order: dim 0 outermost, dim
// ND-1 contiguous), the thread's cells R × V, the middle dims' window rows
// flattened (WY; ylo/ymul/ywid(d): reach below, multiplier and extent of
// middle dim d), the warps along the contiguous dim (XW: 4 for a 1D
// program, whose leading extent is 1) and the adjoint planes (adj(k):
// input plane k is read through `ra`) — emitted by
// codegen/cuda_printer.py as `struct PsatWin`.
template <typename W, int ND>
struct WinShape {
    using Win = W;
    static constexpr int R = W::R, V = W::V;
    static constexpr int L0 = W::lo[0], H0 = W::hi[0];
    static constexpr int LX = W::lo[ND - 1], HX = W::hi[ND - 1];
    static constexpr int WR = R + L0 + H0;      // window rows of dim 0
    static constexpr int WY = W::WY;            // middle dims' rows; 2D: 1
    static constexpr int WX = V + LX + HX;      // columns
    static constexpr int TY = 4;                // warps a block
    static constexpr int XW = W::XW;            // 2D: warps along columns
    // the block's tile, program order: 2D (4/XW)·R × 32·XW·V; above,
    // R × 1 … × 4 × 32V
    __host__ __device__ static constexpr int64_t tile(int d) {
        return ND == 2 ? (d == 0 ? TY / XW * R : 32 * XW * V)
                       : (d == 0 ? R : d == ND - 1 ? 32 * V
                                     : d == ND - 2 ? TY : 1);
    }
    // the offset in middle dim d (1 <= d <= ND-2) of window row y
    __host__ __device__ static constexpr int yo(int y, int d) {
        return (y / W::ymul(d)) % W::ywid(d) - W::ylo(d);
    }
};

template <typename S, int ND, int NIN, int NOUT>
struct WinParams {
    Params<S, ND, NIN, NOUT> p;
    int nt[ND];                // tiles per dim
    int ntiles;
    int64_t smin[ND], smax[ND];  // interior tile iff smin <= origin <= smax
    bool vec_in[NIN], vec_out[NOUT];  // planes read / written 16 bytes a lane
};

// The accessor of one cell (j, v) of the thread's R × V: every read is a
// window register (j, v and the offsets are constants once unrolled).
template <typename T, typename SH, int ND, int NIN>
struct WinCell {
    const T (&w)[NIN][SH::WR][SH::WY][SH::WX];
    int j, v;
    template <typename... O>
    __device__ __forceinline__ T rp(int k, O... os) const {
        const int o[] = {int(os)...};
        static_assert(sizeof...(O) >= ND, "a read names every dim");
        int y = 0;
#pragma unroll
        for (int d = 1; d < ND - 1; ++d)
            y += (o[d] + SH::Win::ylo(d)) * SH::Win::ymul(d);
        return w[k][j + o[0] + SH::L0][y][v + o[ND - 1] + SH::LX];
    }
    template <typename... O>
    __device__ __forceinline__ T ra(int k, O... os) const {
        return rp(k, os...);
    }
};

template <typename S, int V>
struct alignas(sizeof(S) * V) VecOf {
    S v[V];
};

template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          typename Body, typename W>
__global__ void __launch_bounds__(kBlock)
stencil_window(const __grid_constant__ WinParams<S, ND, NIN, NOUT> wp) {
    using SH = WinShape<W, ND>;
    constexpr int R = SH::R, V = SH::V, WR = SH::WR, WY = SH::WY,
                  WX = SH::WX;
    const Params<S, ND, NIN, NOUT>& p = wp.p;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    // this thread's first cell in the tile (program order)
    int64_t toff[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) toff[d] = 0;
    if constexpr (ND == 2) {
        toff[0] = ty / SH::XW * R;
        toff[1] = ((ty % SH::XW) * 32 + tx) * V;
    } else {
        toff[ND - 2] = ty;
        toff[ND - 1] = tx * V;
    }
    for (int tile = blockIdx.x; tile < wp.ntiles; tile += gridDim.x) {
        int64_t t0[ND];
        {
            unsigned rest = (unsigned)tile;
#pragma unroll
            for (int d = ND - 1; d >= 0; --d) {
                const unsigned q = rest / (unsigned)wp.nt[d];
                t0[d] = (int64_t)(rest - q * (unsigned)wp.nt[d])
                        * SH::tile(d);
                rest = q;
            }
        }
        bool fast = true;
#pragma unroll
        for (int d = 0; d < ND; ++d)
            fast = fast && t0[d] >= wp.smin[d] && t0[d] <= wp.smax[d];
        int64_t c0[ND];  // the thread's first cell
#pragma unroll
        for (int d = 0; d < ND; ++d) c0[d] = t0[d] + toff[d];

        // the window: only the entries the body reads (PsatWin's tables:
        // the centre V columns of each row some read uses, and the halo
        // entries beside them)
        T w[NIN][WR][WY][WX];
        if (fast) {
            // interior tile: no clamp, no mask; one base pointer a row
#pragma unroll
            for (int i = 0; i < W::NROW; ++i) {
                const int k = W::row_k(i), r = W::row_r(i), y = W::row_y(i);
                const int64_t* st = p.in_st[k];
                const S* row = p.in[k] + (c0[0] + r - SH::L0) * st[0]
                               + c0[ND - 1] * st[ND - 1];
#pragma unroll
                for (int d = 1; d < ND - 1; ++d)
                    row += (c0[d] + SH::yo(y, d)) * st[d];
                if (V > 1 && wp.vec_in[k]) {
                    const VecOf<S, V> c =
                        *reinterpret_cast<const VecOf<S, V>*>(row);
#pragma unroll
                    for (int x = 0; x < V; ++x)
                        w[k][r][y][SH::LX + x] = ld<T>(&c.v[x]);
                } else {
#pragma unroll
                    for (int x = 0; x < V; ++x)
                        w[k][r][y][SH::LX + x] =
                            ld<T>(row + x * st[ND - 1]);
                }
            }
#pragma unroll
            for (int i = 0; i < W::NHALO; ++i) {
                const int k = W::halo_k(i), r = W::halo_r(i),
                          y = W::halo_y(i), x = W::halo_x(i);
                const int64_t* st = p.in_st[k];
                const S* row = p.in[k] + (c0[0] + r - SH::L0) * st[0]
                               + c0[ND - 1] * st[ND - 1];
#pragma unroll
                for (int d = 1; d < ND - 1; ++d)
                    row += (c0[d] + SH::yo(y, d)) * st[d];
                w[k][r][y][x] = ld<T>(row + (x - SH::LX) * st[ND - 1]);
            }
        } else {
            // edge tile: clamped (FULL, INTERIOR) or wrapped (PERIODIC)
            // coordinates; adjoint planes 0 outside [alo, ahi)
            auto edge = [&](int k, int r, int y, int x) {
                int64_t c[ND];
                c[0] = c0[0] + r - SH::L0;
#pragma unroll
                for (int d = 1; d < ND - 1; ++d) c[d] = c0[d] + SH::yo(y, d);
                c[ND - 1] = c0[ND - 1] + x - SH::LX;
                bool ok = true;
                int64_t off = 0;
#pragma unroll
                for (int d = 0; d < ND; ++d) {
                    ok = ok && c[d] >= p.alo[d] && c[d] < p.ahi[d];
                    // a periodic read wraps once (extents cover the reach),
                    // then is clamped: the cells of a tile past the
                    // array's edge, never stored, may read a row more
                    // than one extent past it
                    if (MODE == PERIODIC) {
                        c[d] = c[d] < 0 ? c[d] + p.n[d]
                               : (c[d] >= p.n[d] ? c[d] - p.n[d] : c[d]);
                        c[d] = c[d] < p.n[d] ? c[d] : p.n[d] - 1;
                    } else
                        c[d] = c[d] < 0 ? 0
                               : (c[d] >= p.n[d] ? p.n[d] - 1 : c[d]);
                    off += c[d] * p.in_st[k][d];
                }
                const T val = ld<T>(p.in[k] + off);
                w[k][r][y][x] =
                    (MODE != PERIODIC && W::adj(k) && !ok) ? T(0) : val;
            };
#pragma unroll
            for (int i = 0; i < W::NROW; ++i)
#pragma unroll
                for (int x = 0; x < V; ++x)
                    edge(W::row_k(i), W::row_r(i), W::row_y(i), SH::LX + x);
#pragma unroll
            for (int i = 0; i < W::NHALO; ++i)
                edge(W::halo_k(i), W::halo_r(i), W::halo_y(i), W::halo_x(i));
        }

        T out[R][V][NOUT];
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                bool inside = true;
                if (MODE == INTERIOR && !fast) {
#pragma unroll
                    for (int d = 0; d < ND; ++d) {
                        const int64_t cj = c0[d] + (d == 0 ? j : 0)
                                           + (d == ND - 1 ? v : 0);
                        inside = inside && cj >= p.wlo[d] && cj < p.whi[d];
                    }
                }
                WinCell<T, SH, ND, NIN> cell{w, j, v};
#pragma unroll
                for (int k = 0; k < NOUT; ++k) out[j][v][k] = T(0);
                Body::template run<T>(cell, inside, out[j][v]);
            }
        }

#pragma unroll
        for (int k = 0; k < NOUT; ++k) {
            const int64_t* ost = p.out_st[k];
            S* b = p.out[k];
#pragma unroll
            for (int d = 0; d < ND; ++d) b += c0[d] * ost[d];
            const bool vec = fast && V > 1 && wp.vec_out[k];
#pragma unroll
            for (int j = 0; j < R; ++j) {
                S* row = b + j * ost[0];
                if (vec) {
                    VecOf<S, V> c;
#pragma unroll
                    for (int v = 0; v < V; ++v) st(&c.v[v], out[j][v][k]);
                    *reinterpret_cast<VecOf<S, V>*>(row) = c;
                    continue;
                }
                bool rin = fast || c0[0] + j < p.n[0];
#pragma unroll
                for (int d = 1; d < ND - 1; ++d)
                    rin = rin && (fast || c0[d] < p.n[d]);
#pragma unroll
                for (int v = 0; v < V; ++v)
                    if (rin && (fast || c0[ND - 1] + v < p.n[ND - 1]))
                        st(row + v * ost[ND - 1], out[j][v][k]);
            }
        }
    }
}

}  // namespace psat
