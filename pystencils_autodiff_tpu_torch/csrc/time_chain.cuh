// k time steps of one stencil op in one kernel on a Hopper GPU: the
// hand-written CUDA port of the Pallas kernel
// pystencils_autodiff_tpu/ops/time_chain.py::_make_chain_kernel_fn.
//
// What is per stencil is emitted from the StencilProgram by
// codegen/cuda_printer.py: `PsatFwd::run` (one stage at one cell) and
// `PsatHoist::run` (the chain-invariant steps, e.g. wave's (dt·c)², once
// per tile).  Everything else is here.
//
// Semantics (sequential stepping, ops/time_chain.py::plain_time_chain):
// each stage evaluates the forward program at every cell, zeroes the
// global ghost frame (bounded mode; the interior window [wlo, whi) is
// tested on global coordinates) or wraps every read (periodic mode), then
// applies the carry map.  Probe rows of a scalar state plane are recorded
// after every stage.
//
// Design.  A thread block owns an output tile of ty×tx cells and loads
// every state plane over the tile plus a halo of k·reach (per dim and
// side) into shared memory — clamped coordinates in bounded mode (the
// out-of-domain values only ever feed cells that are masked), wrapped ones
// in periodic mode.  The k stages then run in shared memory: stage s
// writes the extended tile shrunk by (s+1)·reach, so every read of stage s
// stays inside what stage s-1 left valid.  State planes live in a pool of
// tile-sized buffers; a stage writes its outputs into free buffers and the
// carry map only renames buffers (sbuf/obuf tables made on the host by
// ops/time_chain.py::carry_schedule), so a shift like u_prev ← u_curr
// costs nothing.  Each block writes the owned cells of every state plane
// and, for each probe whose row it owns, its columns of the (k, n1)
// record — no cross-block sum.  Ragged edges are masked; the 1D grid over
// tiles has no limit on either extent.
//
// Bound.  Per k steps the kernel reads each state plane once and writes it
// once, so HBM traffic per step drops k× against k single steps.  What it
// pays instead: redundant halo compute (the owned share of the extended
// tile is 0.7–0.85 for k·reach = 4–8 at the tile sizes the wrapper picks)
// and shared-memory traffic (every read of every stage is a shared-memory
// load; no register blocking yet), which bounds it once k amortises the
// HBM bytes.  cp.async/TMA loads and register reuse along columns are
// later work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

namespace psat_chain {

// Blocks are kThreadsX wide (a warp along the contiguous dim) and
// blockDim.y tall: kRowsFwd for the forward chain (several blocks share an
// SM), kRowsAdj for the two-phase kernel (one block per SM)
constexpr int kThreadsX = 32;
constexpr int kRowsFwd = 8;
constexpr int kRowsAdj = 32;
constexpr int kMaxK = 32;
constexpr int kMaxProbes = 4;

// Geometry block, filled from the int64 array the wrapper passes (layout in
// parse_geo).  All tile coordinates are local to the extended tile.
struct Geo {
    int64_t n0, n1;            // domain
    int k;                     // chain depth
    int ty, tx, ey, ex;        // owned tile, extended tile
    int hy, hx;                // offset of the owned tile in the extended one
    int lof0, hif0, lof1, hif1;  // forward reach per stage
    int lob0, hib0, lob1, hib1;  // backward reach per stage (two-phase)
    int64_t wlo0, whi0, wlo1, whi1;  // forward interior window
    int hlo0, hhi0, hlo1, hhi1;      // reach of the hoisted steps
    int npool, nplanes, nprobe;
    int probe_state[kMaxProbes];
    int64_t probe_row[kMaxProbes];
};

template <typename T, int NS, int NOUT>
struct ChainParams {
    Geo g;
    const T* in[NS];
    int64_t in_st[NS][2];
    T* out[NS];
    int64_t out_st[NS][2];
    T* probe[kMaxProbes];          // (k, n1) records, contiguous
    int16_t sbuf[(kMaxK + 1) * NS];  // pool buffer of state plane n at stage s
    int16_t obuf[kMaxK * NOUT];      // pool buffer of output o at stage s
};

// geo: n0 n1 k ty tx ey ex hy hx lof0 hif0 lof1 hif1 lob0 hib0 lob1 hib1
//      wlo0 whi0 wlo1 whi1 hlo0 hhi0 hlo1 hhi1 npool nplanes nprobe
//      (probe_state probe_row)*nprobe sbuf[(k+1)*NS] obuf[k*NOUT]
template <typename P>
inline bool parse_geo(const int64_t* geo, P& p, int ns, int nout) {
    Geo& g = p.g;
    int i = 0;
    g.n0 = geo[i++]; g.n1 = geo[i++];
    g.k = (int)geo[i++];
    g.ty = (int)geo[i++]; g.tx = (int)geo[i++];
    g.ey = (int)geo[i++]; g.ex = (int)geo[i++];
    g.hy = (int)geo[i++]; g.hx = (int)geo[i++];
    g.lof0 = (int)geo[i++]; g.hif0 = (int)geo[i++];
    g.lof1 = (int)geo[i++]; g.hif1 = (int)geo[i++];
    g.lob0 = (int)geo[i++]; g.hib0 = (int)geo[i++];
    g.lob1 = (int)geo[i++]; g.hib1 = (int)geo[i++];
    g.wlo0 = geo[i++]; g.whi0 = geo[i++];
    g.wlo1 = geo[i++]; g.whi1 = geo[i++];
    g.hlo0 = (int)geo[i++]; g.hhi0 = (int)geo[i++];
    g.hlo1 = (int)geo[i++]; g.hhi1 = (int)geo[i++];
    g.npool = (int)geo[i++]; g.nplanes = (int)geo[i++];
    g.nprobe = (int)geo[i++];
    if (g.k < 1 || g.k > kMaxK || g.nprobe < 0 || g.nprobe > kMaxProbes)
        return false;
    for (int q = 0; q < g.nprobe; ++q) {
        g.probe_state[q] = (int)geo[i++];
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

// Reader of the forward body (and the hoisting pass) at one cell: state
// plane k of the current stage at offset (o0, o1), hoisted plane j at the
// cell.  Every read stays inside the region the previous stage left valid.
template <typename T, int NS>
struct StageReader {
    const T* st[NS];
    const T* h;
    int ex, plane;
    __device__ __forceinline__ T rp(int k, int o0, int o1, int) const {
        return st[k][o0 * ex + o1];
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
// any, so a warp keeps NP·kLoadUnroll loads in flight.
constexpr int kLoadUnroll = 4;

template <typename T, bool PERIODIC, int NP>
__device__ __forceinline__ void load_planes(T* dst, const T* const* src,
                                            const int64_t (*st)[2],
                                            const Geo& g, int64_t gy0,
                                            int64_t gx0, bool zero_outside) {
    const int plane = g.ey * g.ex;
    for (int ly = threadIdx.y; ly < g.ey; ly += blockDim.y) {
        const int64_t gy = gy0 + ly;
        const bool yin = gy >= 0 && gy < g.n0;
        const int64_t cy = clamp_or_wrap(gy, g.n0, PERIODIC);
        int64_t row[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) row[k] = cy * st[k][0];
        for (int lx0 = threadIdx.x; lx0 < g.ex;
             lx0 += kThreadsX * kLoadUnroll) {
            T v[kLoadUnroll][NP];
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int lx = lx0 + u * kThreadsX;
                if (lx >= g.ex) break;
                const int64_t gx = gx0 + lx;
                const bool in = yin && gx >= 0 && gx < g.n1;
                const int64_t cx = clamp_or_wrap(gx, g.n1, PERIODIC);
#pragma unroll
                for (int k = 0; k < NP; ++k) {
                    v[u][k] = src[k][row[k] + cx * st[k][1]];
                    if (!PERIODIC && zero_outside && !in) v[u][k] = T(0);
                }
            }
#pragma unroll
            for (int u = 0; u < kLoadUnroll; ++u) {
                const int lx = lx0 + u * kThreadsX;
                if (lx >= g.ex) break;
#pragma unroll
                for (int k = 0; k < NP; ++k)
                    dst[k * plane + ly * g.ex + lx] = v[u][k];
            }
        }
    }
}

// The chain-invariant steps, once per tile, into the hoisted planes.
template <typename T, int NS, int NH, typename Hoist, typename P>
__device__ __forceinline__ void hoist_pass(const P& p, const T* pool,
                                           T* hoist) {
    if constexpr (NH > 0) {
        const Geo& g = p.g;
        const int plane = g.ey * g.ex;
        for (int ly = g.hlo0 + threadIdx.y; ly < g.ey - g.hhi0;
             ly += blockDim.y)
            for (int lx = g.hlo1 + threadIdx.x; lx < g.ex - g.hhi1;
                 lx += kThreadsX) {
                const int idx = ly * g.ex + lx;
                StageReader<T, NS> r;
#pragma unroll
                for (int k = 0; k < NS; ++k)
                    r.st[k] = pool + p.sbuf[k] * plane + idx;
                r.h = hoist + idx;
                r.ex = g.ex;
                r.plane = plane;
                T v[NH];
                Hoist::template run<T>(r, v);
#pragma unroll
                for (int j = 0; j < NH; ++j) hoist[j * plane + idx] = v[j];
            }
        __syncthreads();
    }
}

// The k forward stages in shared memory.  Stage s writes the extended tile
// shrunk by (s+1)·reach; with probes, records the owned part of each probe
// row of state s+1.
template <typename T, int NS, int NOUT, bool PERIODIC, typename Fwd,
          typename P>
__device__ __forceinline__ void forward_stages(const P& p, T* pool,
                                               const T* hoist, int64_t gy0,
                                               int64_t gx0, bool probes) {
    const Geo& g = p.g;
    const int plane = g.ey * g.ex;
    const int tid = threadIdx.y * kThreadsX + threadIdx.x;
    const int nthreads = kThreadsX * blockDim.y;
    for (int s = 0; s < g.k; ++s) {
        const int y_lo = (s + 1) * g.lof0, y_hi = g.ey - (s + 1) * g.hif0;
        const int x_lo = (s + 1) * g.lof1, x_hi = g.ex - (s + 1) * g.hif1;
        const T* base[NS];
        T* obase[NOUT];
#pragma unroll
        for (int k = 0; k < NS; ++k) base[k] = pool + p.sbuf[s * NS + k] * plane;
#pragma unroll
        for (int o = 0; o < NOUT; ++o)
            obase[o] = pool + p.obuf[s * NOUT + o] * plane;
        for (int ly = y_lo + threadIdx.y; ly < y_hi; ly += blockDim.y) {
            const int64_t gy = gy0 + ly;
            const bool yin = gy >= g.wlo0 && gy < g.whi0;
            for (int lx = x_lo + threadIdx.x; lx < x_hi; lx += kThreadsX) {
                const int idx = ly * g.ex + lx;
                StageReader<T, NS> r;
#pragma unroll
                for (int k = 0; k < NS; ++k) r.st[k] = base[k] + idx;
                r.h = hoist + idx;
                r.ex = g.ex;
                r.plane = plane;
                T v[NOUT];
#pragma unroll
                for (int o = 0; o < NOUT; ++o) v[o] = T(0);
                Fwd::template run<T>(r, true, v);
                if (!PERIODIC) {
                    const int64_t gx = gx0 + lx;
                    if (!(yin && gx >= g.wlo1 && gx < g.whi1)) {
#pragma unroll
                        for (int o = 0; o < NOUT; ++o) v[o] = T(0);
                    }
                }
#pragma unroll
                for (int o = 0; o < NOUT; ++o) obase[o][idx] = v[o];
            }
        }
        __syncthreads();
        if (!probes) continue;
        for (int q = 0; q < g.nprobe; ++q) {
            const int64_t ly = g.probe_row[q] - gy0;
            if (ly < g.hy || ly >= g.hy + g.ty) continue;  // not an owned row
            const T* src = pool + p.sbuf[(s + 1) * NS + g.probe_state[q]] * plane
                           + ly * g.ex;
            for (int lx = g.hx + tid; lx < g.hx + g.tx; lx += nthreads) {
                const int64_t gx = gx0 + lx;
                if (gx < g.n1) p.probe[q][s * g.n1 + gx] = src[lx];
            }
        }
    }
}

// Write the owned, in-domain cells of `count` shared-memory planes (plane k
// at base[k]) to global memory.
template <typename T>
__device__ __forceinline__ void store_owned(T* const* dst,
                                            const int64_t (*st)[2],
                                            const T* const* base, int count,
                                            const Geo& g, int64_t gy0,
                                            int64_t gx0) {
    for (int ly = g.hy + threadIdx.y; ly < g.hy + g.ty; ly += blockDim.y) {
        const int64_t gy = gy0 + ly;
        if (gy >= g.n0) break;
        for (int lx = g.hx + threadIdx.x; lx < g.hx + g.tx; lx += kThreadsX) {
            const int64_t gx = gx0 + lx;
            if (gx >= g.n1) break;
            for (int k = 0; k < count; ++k)
                dst[k][gy * st[k][0] + gx * st[k][1]] = base[k][ly * g.ex + lx];
        }
    }
}

// Global coordinates of local (0, 0) of this block's extended tile.
__device__ __forceinline__ void tile_origin(const Geo& g, int64_t& gy0,
                                            int64_t& gx0) {
    const int64_t ntx = (g.n1 + g.tx - 1) / g.tx;
    const int64_t tile = blockIdx.x;
    gy0 = (tile / ntx) * g.ty - g.hy;
    gx0 = (tile % ntx) * g.tx - g.hx;
}

template <typename T, int NS, int NOUT, int NH, bool PERIODIC, typename Fwd,
          typename Hoist>
__global__ void __launch_bounds__(kThreadsX * kRowsFwd)
time_chain(const __grid_constant__ ChainParams<T, NS, NOUT> p) {
    extern __shared__ unsigned char smem_raw[];
    T* pool = reinterpret_cast<T*>(smem_raw);
    const Geo& g = p.g;
    const int plane = g.ey * g.ex;
    T* hoist = pool + g.npool * plane;
    int64_t gy0, gx0;
    tile_origin(g, gy0, gx0);
    // sbuf[0][n] == n: the initial state planes are pool buffers 0..NS-1
    load_planes<T, PERIODIC, NS>(pool, p.in, p.in_st, g, gy0, gx0, false);
    __syncthreads();
    hoist_pass<T, NS, NH, Hoist>(p, pool, hoist);
    forward_stages<T, NS, NOUT, PERIODIC, Fwd>(p, pool, hoist, gy0, gx0,
                                               g.nprobe > 0);
    const T* fin[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) fin[k] = pool + p.sbuf[g.k * NS + k] * plane;
    store_owned<T>(p.out, p.out_st, fin, NS, g, gy0, gx0);
}

// Launch `kernel` over one block per tile with the geometry's dynamic
// shared memory (above 48 KB only after opting in).
template <typename K, typename P>
inline cudaError_t launch_tiles(K kernel, const P& p, const Geo& g,
                               size_t elem, int rows, cudaStream_t stream) {
    const size_t smem = (size_t)g.nplanes * g.ey * g.ex * elem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int64_t tiles = ((g.n0 + g.ty - 1) / g.ty) * ((g.n1 + g.tx - 1) / g.tx);
    if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)tiles, dim3(kThreadsX, rows), smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace psat_chain
