// k time steps of one stencil op in one kernel on a Hopper GPU: the
// hand-written CUDA port of the Pallas kernels
// pystencils_autodiff_tpu/ops/time_chain.py::_make_chain_kernel_fn (2D) and
// pystencils_autodiff_tpu/ops/plane_chain.py::make_plane_chain_kernel_fn
// (3D).
//
// What is per stencil is emitted from the StencilProgram by
// codegen/cuda_printer.py: `PsatFwd::run` (one stage at one cell) and
// `PsatHoist::run` (the chain-invariant steps, e.g. wave's (dt·c)² or the
// variable-κ diffusion's face averages, once per tile).  Everything else is
// here.
//
// Semantics (sequential stepping, ops/time_chain.py::plain_time_chain):
// each stage evaluates the forward program at every cell, zeroes the
// global ghost frame (bounded mode; the interior window [wlo, whi) is
// tested on global coordinates) or wraps every read (periodic mode, in
// every dim), then applies the carry map.  Probe lines of a scalar state
// plane (along the last dim: row y of plane z; z = 0 in 2D) are recorded
// after every stage.
//
// Geometry.  Every domain is (z, y, x), outermost first; a 2D domain is
// (1, n0, n1), so one code path serves both (the emitted reads name their
// offsets in the program's own dims; `cell_off<ND>` maps them).
//
// Design.  A thread block owns a box tile of t0×t1×t2 cells and loads every
// state plane over the tile plus a halo of k·reach (per dim and side) into
// shared memory — clamped coordinates in bounded mode (the out-of-domain
// values only ever feed cells that are masked), wrapped ones in periodic
// mode.  The k stages then run in shared memory: stage s writes the
// extended tile shrunk by (s+1)·reach, so every read of stage s stays
// inside what stage s-1 left valid.  State planes live in a pool of
// tile-sized buffers; a stage writes its outputs into free buffers and the
// carry map only renames buffers (sbuf/obuf tables made on the host by
// ops/time_chain.py::carry_schedule), so a shift like u_prev ← u_curr
// costs nothing.  Each block writes the owned cells of every state plane
// and, for each probe whose line it owns, its columns of the (k, nx)
// record — no cross-block sum.  Ragged edges are masked; the 1D grid over
// tiles has no limit on any extent.  A whole 384² plane (590 KB in f32)
// exceeds the 227 KB of shared memory a block may use, so a 3D tile is
// bounded in all three dims rather than a stack of whole planes as on the
// TPU.
//
// Bound.  Per k steps the kernel reads each state plane once and writes
// each carried one once (a chain-invariant plane, such as κ or c, is not
// written back: the wrapper returns it as it came), so HBM traffic per
// step drops k× against k single steps.  What it
// pays instead: redundant halo compute (the owned share of the extended
// tile is 0.7–0.85 for k·reach = 4–8 on 2D tiles, and 0.2–0.45 on 3D
// tiles, whose halo wraps six faces) and shared-memory traffic (every read
// of every stage is a shared-memory load — 7 to 14 per cell and stage for
// the 3D 7-point ops; no register blocking yet), which bounds it once k
// amortises the HBM bytes.  cp.async/TMA loads and register reuse along a
// dim are later work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

namespace psat_chain {

// Blocks are kThreadsX wide (a warp along the contiguous dim) and
// blockDim.y tall: kRowsFwd for the 2D forward chain (several blocks share
// an SM), kRowsAdj for the 3D forward chain and the adjoint kernels (one
// large tile per SM; Geo::rows says which)
constexpr int kThreadsX = 32;
constexpr int kRowsFwd = 8;
constexpr int kRowsAdj = 32;
constexpr int kMaxK = 32;
constexpr int kMaxProbes = 4;

// Geometry block, filled from the int64 array the wrapper passes (layout in
// parse_geo).  Per-dim arrays are (z, y, x).  All tile coordinates are
// local to the extended tile.
struct Geo {
    int64_t n[3];              // domain
    int k;                     // chain depth
    int t[3], e[3], h[3];      // owned tile, extended tile, owned offset
    int lof[3], hif[3];        // forward reach per stage
    int lob[3], hib[3];        // second reach per stage: the backward
                               // program's (two-phase) or the cotangent
                               // op's (twin-with-accumulation)
    int64_t wlo[3], whi[3];    // forward interior window
    int hlo[3], hhi[3];        // reach of the hoisted steps
    int npool, nplanes, nowned, rows, nprobe;
    int probe_state[kMaxProbes];
    int64_t probe_z[kMaxProbes];    // the line along x: plane z (0 in 2D)
    int64_t probe_row[kMaxProbes];  // and row y
    int nt[3];                 // tiles per dim (set by parse_geo)

    __host__ __device__ int plane() const { return e[0] * e[1] * e[2]; }
    __host__ __device__ int owned_plane() const { return t[0] * t[1] * t[2]; }
};

// T: the compute type (and of the shared-memory planes); S: the storage
// type of the planes in device memory (ld/st in on_device.cuh)
template <typename T, int NS, int NOUT, typename S = T>
struct ChainParams {
    Geo g;
    const S* in[NS];
    int64_t in_st[NS][3];
    S* out[NS];
    int64_t out_st[NS][3];
    S* probe[kMaxProbes];          // (k, nx) records, contiguous
    int16_t sbuf[(kMaxK + 1) * NS];  // pool buffer of state plane n at stage s
    int16_t obuf[kMaxK * NOUT];      // pool buffer of output o at stage s
};

// geo: n[3] k t[3] e[3] h[3] lof[3] hif[3] lob[3] hib[3] wlo[3] whi[3]
//      hlo[3] hhi[3] npool nplanes nowned rows nprobe
//      (probe_state probe_z probe_row)*nprobe sbuf[(k+1)*NS] obuf[k*NOUT]
template <typename P>
inline bool parse_geo(const int64_t* geo, P& p, int ns, int nout) {
    Geo& g = p.g;
    int i = 0;
    auto take3 = [&](auto* dst) {
        for (int d = 0; d < 3; ++d) dst[d] = geo[i++];
    };
    take3(g.n);
    g.k = (int)geo[i++];
    take3(g.t); take3(g.e); take3(g.h);
    take3(g.lof); take3(g.hif); take3(g.lob); take3(g.hib);
    take3(g.wlo); take3(g.whi);
    take3(g.hlo); take3(g.hhi);
    g.npool = (int)geo[i++]; g.nplanes = (int)geo[i++];
    g.nowned = (int)geo[i++]; g.rows = (int)geo[i++];
    g.nprobe = (int)geo[i++];
    if (g.k < 1 || g.k > kMaxK || g.nprobe < 0 || g.nprobe > kMaxProbes)
        return false;
    int64_t tiles = 1;
    for (int d = 0; d < 3; ++d) {
        if (g.t[d] < 1) return false;
        const int64_t nt = (g.n[d] + g.t[d] - 1) / g.t[d];
        tiles *= nt;
        if (tiles > 0x7fffffff) return false;  // the grid is 1D, in int
        g.nt[d] = (int)nt;
    }
    for (int q = 0; q < g.nprobe; ++q) {
        g.probe_state[q] = (int)geo[i++];
        g.probe_z[q] = geo[i++];
        g.probe_row[q] = geo[i++];
    }
    for (int q = 0; q < (g.k + 1) * ns; ++q) p.sbuf[q] = (int16_t)geo[i++];
    for (int q = 0; q < g.k * nout; ++q) p.obuf[q] = (int16_t)geo[i++];
    return true;
}

__device__ __forceinline__ int64_t clamp_or_wrap(int64_t c, int64_t n,
                                                 bool periodic) {
    if (periodic) {
        // one add or subtract while the halo is shorter than the extent
        if (c < 0) c += n;
        else if (c >= n) c -= n;
        if (c < 0 || c >= n) {
            c %= n;
            if (c < 0) c += n;
        }
        return c;
    }
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

// An emitted read names its offsets in the program's dims (o0, o1, o2; o2
// unused in 2D); in the (z, y, x) tile they are (dz, dy, dx).
template <int ND>
__device__ __forceinline__ void zyx(int o0, int o1, int o2, int& dz, int& dy,
                                    int& dx) {
    if (ND == 3) { dz = o0; dy = o1; dx = o2; }
    else { dz = 0; dy = o0; dx = o1; }
}

// Is global z coordinate gz inside [lo, hi)?  Always, in 2D.
template <int ND>
__device__ __forceinline__ bool z_in(int64_t gz, int64_t lo, int64_t hi) {
    return ND == 2 || (gz >= lo && gz < hi);
}

template <int ND>
__device__ __forceinline__ int cell_off(int o0, int o1, int o2, int e1,
                                        int e2) {
    return ND == 3 ? (o0 * e1 + o1) * e2 + o2 : o0 * e2 + o1;
}

// This thread's rows (lz, ly) of the box [z0, z1) × [y0, y1): rows are
// dealt to threadIdx.y in turn, blockDim.y apart, running on into the next
// z slab (no division per row).  In 2D lz is the constant 0, so every z
// term folds away.
template <int ND, typename F>
__device__ __forceinline__ void for_rows(int z0, int z1, int y0, int y1,
                                         F f) {
    if constexpr (ND == 2) {
        for (int ly = y0 + (int)threadIdx.y; ly < y1; ly += blockDim.y)
            f(0, ly);
        return;
    }
    const int ny = y1 - y0;
    if (ny <= 0 || z1 <= z0) return;
    int lz = z0, ly = y0 + (int)threadIdx.y;
    while (ly >= y1) { ly -= ny; ++lz; }
    while (lz < z1) {
        f(lz, ly);
        ly += blockDim.y;
        while (ly >= y1) { ly -= ny; ++lz; }
    }
}

// Reader of the forward body (and the hoisting pass) at one cell: state
// plane k of the current stage at an offset, hoisted plane j at the cell.
// Every read stays inside the region the previous stage left valid.
template <typename T, int NS, int ND>
struct StageReader {
    const T* st[NS];
    const T* h;
    int e1, e2, plane;
    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        return st[k][cell_off<ND>(o0, o1, o2, e1, e2)];
    }
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        return rp(k, o0, o1, o2);
    }
    __device__ __forceinline__ T rh(int j) const { return h[j * plane]; }
};

// Load NP planes over the whole extended tile into consecutive shared-
// memory planes starting at dst.  Out-of-domain cells: wrapped (periodic),
// clamped (zero_outside false) or 0 (zero_outside true).  Each thread
// issues the loads of kLoadUnroll cells of every plane before it stores
// any, so a warp keeps NP·kLoadUnroll loads in flight: in 2D the cells
// are kLoadUnroll warp-widths along a row; in 3D, whose box rows are only
// one warp wide, kLoadUnroll block-widths of the flattened tile.
constexpr int kLoadUnroll = 4;

template <typename T, bool PERIODIC, int NP, typename S>
__device__ __forceinline__ void load_cell(const S* const* src,
                                       const int64_t (*st)[3], const Geo& g,
                                       const int64_t* g0, int lz, int ly,
                                       int lx, bool zero_outside, T* v) {
    const int64_t gz = g0[0] + lz, gy = g0[1] + ly, gx = g0[2] + lx;
    const bool in = gz >= 0 && gz < g.n[0] && gy >= 0 && gy < g.n[1]
                    && gx >= 0 && gx < g.n[2];
    const int64_t cz = clamp_or_wrap(gz, g.n[0], PERIODIC);
    const int64_t cy = clamp_or_wrap(gy, g.n[1], PERIODIC);
    const int64_t cx = clamp_or_wrap(gx, g.n[2], PERIODIC);
#pragma unroll
    for (int k = 0; k < NP; ++k) {
        v[k] = psat::ld<T>(src[k] + cz * st[k][0] + cy * st[k][1]
                           + cx * st[k][2]);
        if (!PERIODIC && zero_outside && !in) v[k] = T(0);
    }
}

template <typename T, bool PERIODIC, int NP, int ND, typename S>
__device__ __forceinline__ void load_planes(T* dst, const S* const* src,
                                            const int64_t (*st)[3],
                                            const Geo& g, const int64_t* g0,
                                            bool zero_outside) {
    const int plane = g.plane();
    if constexpr (ND == 3) {
        const int nthreads = kThreadsX * blockDim.y;
        const int tid = threadIdx.y * kThreadsX + threadIdx.x;
        for (int i0 = tid; i0 < plane; i0 += nthreads * kLoadUnroll) {
            T v[kLoadUnroll][NP];
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int i = i0 + u * nthreads;
                if (i >= plane) break;
                const int r = i / g.e[2];
                load_cell<T, PERIODIC, NP>(src, st, g, g0, r / g.e[1],
                                           r % g.e[1], i - r * g.e[2],
                                           zero_outside, v[u]);
            }
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int i = i0 + u * nthreads;
                if (i >= plane) break;
#pragma unroll
                for (int k = 0; k < NP; ++k) dst[k * plane + i] = v[u][k];
            }
        }
        return;
    }
    for_rows<ND>(0, g.e[0], 0, g.e[1], [&](int lz, int ly) {
        const int64_t gy = g0[1] + ly;
        const bool rin = gy >= 0 && gy < g.n[1];
        const int64_t cy = clamp_or_wrap(gy, g.n[1], PERIODIC);
        int64_t row[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) row[k] = cy * st[k][1];
        const int lrow = (lz * g.e[1] + ly) * g.e[2];
        for (int lx0 = threadIdx.x; lx0 < g.e[2];
             lx0 += kThreadsX * kLoadUnroll) {
            T v[kLoadUnroll][NP];
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int lx = lx0 + u * kThreadsX;
                if (lx >= g.e[2]) break;
                const int64_t gx = g0[2] + lx;
                const bool in = rin && gx >= 0 && gx < g.n[2];
                const int64_t cx = clamp_or_wrap(gx, g.n[2], PERIODIC);
#pragma unroll
                for (int k = 0; k < NP; ++k) {
                    v[u][k] = psat::ld<T>(src[k] + row[k] + cx * st[k][2]);
                    if (!PERIODIC && zero_outside && !in) v[u][k] = T(0);
                }
            }
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int lx = lx0 + u * kThreadsX;
                if (lx >= g.e[2]) break;
#pragma unroll
                for (int k = 0; k < NP; ++k)
                    dst[k * plane + lrow + lx] = v[u][k];
            }
        }
    });
}

// The chain-invariant steps, once per tile, into the hoisted planes.
template <typename T, int NS, int NH, int ND, typename Hoist, typename P>
__device__ __forceinline__ void hoist_pass(const P& p, const T* pool,
                                           T* hoist) {
    if constexpr (NH > 0) {
        const Geo& g = p.g;
        const int plane = g.plane();
        for_rows<ND>(g.hlo[0], g.e[0] - g.hhi[0], g.hlo[1],
                     g.e[1] - g.hhi[1],
                 [&](int lz, int ly) {
            for (int lx = g.hlo[2] + threadIdx.x; lx < g.e[2] - g.hhi[2];
                 lx += kThreadsX) {
                const int idx = (lz * g.e[1] + ly) * g.e[2] + lx;
                StageReader<T, NS, ND> r;
#pragma unroll
                for (int k = 0; k < NS; ++k)
                    r.st[k] = pool + p.sbuf[k] * plane + idx;
                r.h = hoist + idx;
                r.e1 = g.e[1];
                r.e2 = g.e[2];
                r.plane = plane;
                T v[NH];
                Hoist::template run<T>(r, v);
#pragma unroll
                for (int j = 0; j < NH; ++j) hoist[j * plane + idx] = v[j];
            }
        });
        __syncthreads();
    }
}

// The k forward stages in shared memory.  Stage s writes the extended tile
// shrunk by (s+1)·reach; with probes, records the owned part of each probe
// line of state s+1.
template <typename T, int NS, int NOUT, int ND, bool PERIODIC, typename Fwd,
          typename P>
__device__ __forceinline__ void forward_stages(const P& p, T* pool,
                                               const T* hoist,
                                               const int64_t* g0,
                                               bool probes) {
    const Geo& g = p.g;
    const int plane = g.plane();
    const int tid = threadIdx.y * kThreadsX + threadIdx.x;
    const int nthreads = kThreadsX * blockDim.y;
    for (int s = 0; s < g.k; ++s) {
        int lo[3], hi[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            lo[d] = (s + 1) * g.lof[d];
            hi[d] = g.e[d] - (s + 1) * g.hif[d];
        }
        const T* base[NS];
        T* obase[NOUT];
#pragma unroll
        for (int k = 0; k < NS; ++k) base[k] = pool + p.sbuf[s * NS + k] * plane;
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
            obase[o] = pool + p.obuf[s * NOUT + o] * plane;
        for_rows<ND>(lo[0], hi[0], lo[1], hi[1], [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            const bool rin = z_in<ND>(gz, g.wlo[0], g.whi[0])
                             && gy >= g.wlo[1] && gy < g.whi[1];
            const int lrow = (lz * g.e[1] + ly) * g.e[2];
            for (int lx = lo[2] + threadIdx.x; lx < hi[2]; lx += kThreadsX) {
                const int idx = lrow + lx;
                StageReader<T, NS, ND> r;
#pragma unroll
                for (int k = 0; k < NS; ++k) r.st[k] = base[k] + idx;
                r.h = hoist + idx;
                r.e1 = g.e[1];
                r.e2 = g.e[2];
                r.plane = plane;
                T v[NOUT];
#pragma unroll
                for (int o = 0; o < NOUT; ++o) v[o] = T(0);
                Fwd::template run<T>(r, true, v);
                if (!PERIODIC) {
                    const int64_t gx = g0[2] + lx;
                    if (!(rin && gx >= g.wlo[2] && gx < g.whi[2])) {
#pragma unroll
                        for (int o = 0; o < NOUT; ++o) v[o] = T(0);
                    }
                }
#pragma unroll
                for (int o = 0; o < NOUT; ++o) obase[o][idx] = v[o];
            }
        });
        __syncthreads();
        if (!probes) continue;
        for (int q = 0; q < g.nprobe; ++q) {
            const int64_t lz = g.probe_z[q] - g0[0];
            const int64_t ly = g.probe_row[q] - g0[1];
            if (lz < g.h[0] || lz >= g.h[0] + g.t[0] || ly < g.h[1]
                || ly >= g.h[1] + g.t[1])
                continue;  // not owned
            const T* src = pool + p.sbuf[(s + 1) * NS + g.probe_state[q]] * plane
                           + (lz * g.e[1] + ly) * g.e[2];
            for (int lx = g.h[2] + tid; lx < g.h[2] + g.t[2]; lx += nthreads) {
                const int64_t gx = g0[2] + lx;
                if (gx < g.n[2]) psat::st(p.probe[q] + s * g.n[2] + gx, src[lx]);
            }
        }
    }
}

// Write the owned, in-domain cells of `count` shared-memory planes (plane k
// at base[k], laid out over the extended tile) to global memory; with
// NULLABLE, a null dst[k] is not written.
template <typename T, int ND, bool NULLABLE = false, typename S = T>
__device__ __forceinline__ void store_owned(S* const* dst,
                                            const int64_t (*st)[3],
                                            const T* const* base, int count,
                                            const Geo& g, const int64_t* g0) {
    for_rows<ND>(g.h[0], g.h[0] + g.t[0], g.h[1], g.h[1] + g.t[1],
                 [&](int lz, int ly) {
        const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
        if (!z_in<ND>(gz, 0, g.n[0]) || gy >= g.n[1]) return;
        const int lrow = (lz * g.e[1] + ly) * g.e[2];
        for (int lx = g.h[2] + threadIdx.x; lx < g.h[2] + g.t[2];
             lx += kThreadsX) {
            const int64_t gx = g0[2] + lx;
            if (gx >= g.n[2]) break;
            for (int k = 0; k < count; ++k) {
                if (NULLABLE && dst[k] == nullptr) continue;
                int64_t at = gy * st[k][1] + gx * st[k][2];
                if constexpr (ND == 3) at += gz * st[k][0];
                psat::st(dst[k] + at, base[k][lrow + lx]);
            }
        }
    });
}

// Global coordinates of local (0, 0, 0) of this block's extended tile
// (z is the constant 0 in 2D).  The grid has under 2³¹ tiles
// (parse_geo), so the tile index splits in 32-bit arithmetic: one
// division per dim, no 64-bit division subroutine.
template <int ND>
__device__ __forceinline__ void tile_origin(const Geo& g, int64_t* g0) {
    const unsigned tile = blockIdx.x;
    const unsigned row = tile / (unsigned)g.nt[2];
    g0[2] = (int64_t)(tile - row * (unsigned)g.nt[2]) * g.t[2] - g.h[2];
    if constexpr (ND == 2) {
        g0[1] = (int64_t)row * g.t[1] - g.h[1];
        g0[0] = 0;
    } else {
        const unsigned z = row / (unsigned)g.nt[1];
        g0[1] = (int64_t)(row - z * (unsigned)g.nt[1]) * g.t[1] - g.h[1];
        g0[0] = (int64_t)z * g.t[0] - g.h[0];
    }
}

template <typename T, int NS, int NOUT, int NH, int ND, bool PERIODIC,
          typename Fwd, typename Hoist, int ROWS, typename S = T>
__global__ void __launch_bounds__(kThreadsX * ROWS)
time_chain(const __grid_constant__ ChainParams<T, NS, NOUT, S> p) {
    extern __shared__ unsigned char smem_raw[];
    T* pool = reinterpret_cast<T*>(smem_raw);
    const Geo& g = p.g;
    const int plane = g.plane();
    T* hoist = pool + g.npool * plane;
    int64_t g0[3];
    tile_origin<ND>(g, g0);
    // sbuf[0][n] == n: the initial state planes are pool buffers 0..NS-1
    load_planes<T, PERIODIC, NS, ND>(pool, p.in, p.in_st, g, g0, false);
    __syncthreads();
    hoist_pass<T, NS, NH, ND, Hoist>(p, pool, hoist);
    forward_stages<T, NS, NOUT, ND, PERIODIC, Fwd>(p, pool, hoist, g0,
                                                   g.nprobe > 0);
    const T* fin[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) fin[k] = pool + p.sbuf[g.k * NS + k] * plane;
    // a null out[k]: a chain-invariant plane, which the wrapper returns as
    // it came
    store_owned<T, ND, true>(p.out, p.out_st, fin, NS, g, g0);
}

// Launch `kernel` over one block per tile of kThreadsX × g.rows threads
// with the geometry's dynamic shared memory (above 48 KB only after opting
// in): nplanes planes over the extended tile and nowned over the owned
// tile.
template <typename K, typename P>
inline cudaError_t launch_tiles(K kernel, const P& p, const Geo& g,
                               size_t elem, cudaStream_t stream) {
    const size_t smem = ((size_t)g.nplanes * g.plane()
                         + (size_t)g.nowned * g.owned_plane()) * elem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned tiles = (unsigned)g.nt[0] * g.nt[1] * g.nt[2];
    kernel<<<tiles, dim3(kThreadsX, g.rows), smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace psat_chain
