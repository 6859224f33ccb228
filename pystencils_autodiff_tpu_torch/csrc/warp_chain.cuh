// k time steps of one 2D stencil op in one kernel on a Hopper GPU, as a
// warp-level register march: the Hopper design of the Pallas kernel
// pystencils_autodiff_tpu/ops/time_chain.py::_make_chain_kernel_fn (PERF.md
// row 6; csrc/time_chain.cuh's box tiles are its earlier design).
//
// What is per stencil is emitted from the StencilProgram by
// codegen/cuda_printer.py: `PsatFwd::run` (one stage at one cell),
// `PsatHoist::run` (the chain-invariant steps) and `struct PsatWarp`, the
// march's tables (below), all constants of the source.
//
// Semantics (ops/time_chain.py::plain_time_chain): each stage evaluates the
// forward program at every cell, zeroes the global ghost frame (bounded
// mode: the interior window [wlo, whi) tested on global coordinates) or
// wraps every read (periodic mode, both dims), then applies the carry map;
// probe rows of a scalar state plane are recorded after every stage.
//
// Design (register caching, after Falch and Elster, "Register caching for
// stencil computations on GPUs", 2017).  A warp owns a strip of columns and
// a segment of rows; its 32 lanes hold 32·V consecutive columns — the
// owned ones plus a lateral halo of `halo` (≥ k × the lateral reach, a
// whole number of V) on each side — and march down dim 0 one row a step,
// with no block barrier: a warp is a block's unit of work.  Every stream of
// rows — each state plane as loaded, each hoisted plane, each output of
// each stage — lives in a ring of P rows × V columns of registers,
// indexed by the row modulo P; the march loop is unrolled P times, so
// every ring index is a constant and a ring is registers.  Stage s runs
// lag(s) rows behind the loads (the loads run `D` rows ahead of their
// first use, so their latency overlaps the stages of earlier rows), reach
// rows behind stage s-1.  The carry map is a table of which stream a state
// plane is at each stage (smap), so u_prev ← u_curr costs nothing.  A
// read's column offset within the lane's V columns is a register; beyond
// them it is a __shfl_up/down_sync from the neighbouring lane (the lanes
// at the strip's edges read garbage there: their columns are halo, whose
// validity shrinks by the reach a stage and ends outside the owned
// columns).  Hoisted planes are computed once a cell, `LH` rows behind the
// loads.  Rows are loaded 16 bytes a lane where the plane is contiguous and
// aligned (`vec_in`, host-reckoned) and the lane's columns lie in the
// domain; else per column, clamped (bounded) or wrapped (periodic).  A warp
// stores only its owned cells of the carried planes, and records probe
// rows it owns after each stage (no cross-warp sum).  A segment starts
// `LEAD` rows (k × the reach above, plus the hoist's) above its first owned
// row; the rows above that the first steps compute are garbage and feed
// only rows outside the segment.
//
// Bound.  Per k steps each state plane is read once and each carried one
// written once, plus the halo columns (2·halo / 32V of a strip) and the
// lead-in rows of each segment (LEAD + lag(k) over the segment's rows)
// read again; the k stages' arithmetic runs on registers.  What it pays:
// the halo columns' redundant stages, a shuffle per read beyond a lane's
// columns, and registers: P·V values a ring, which bound the warps an SM
// holds (the host picks V from the built kernel's registers,
// ops/warp_chain.py::warp_geometry).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

namespace psat_warp {

constexpr int kWarps = 4;  // warps a block (each warp its own item)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxProbes = 4;

template <typename S, int NS>
struct WarpParams {
    const S* in[NS];
    int64_t in_st[NS][2];
    S* out[NS];  // null: a chain-invariant plane, not written
    int64_t out_st[NS][2];
    S* probe[kMaxProbes];  // (k, n1) records
    int64_t probe_row[kMaxProbes];
    int64_t n0, n1, wlo[2], whi[2];
    int64_t seg;        // rows a segment owns
    int nstrip, items;  // strips; items = strips × segments
    int owned, halo;    // columns a strip owns; lateral halo
    int steps;          // march steps of an item (a multiple of P)
    bool vec_in[NS], vec_out[NS];
};

template <typename S, int V>
struct alignas(sizeof(S) * V) Vec {
    S v[V];
};

__device__ __forceinline__ constexpr int slot_of(int row, int p) {
    return ((row % p) + p) % p;
}

// Column c (a constant once unrolled) of a ring row whose lane holds V
// columns: a register of this lane, or of the lane q whole lanes away.
template <typename T, int V>
__device__ __forceinline__ T lateral(const T (&row)[V], int c) {
    if (c >= 0 && c < V) return row[c];
    const int q = c >= 0 ? c / V : -((V - 1 - c) / V);
    const int cc = c - q * V;
    return q > 0 ? __shfl_down_sync(kFull, row[cc], q)
                 : __shfl_up_sync(kFull, row[cc], -q);
}

// Reader of the forward body (stage s reads the state after stage s-1)
// and of the hoisting pass (s = 1: the loaded planes) at one cell: the
// cell's row relative to the step's loaded row's period start, and its
// column v of the lane's V.
template <typename T, typename W, int V, int NS>
struct Reader {
    const T (&ring)[W::NX][W::P][V];
    int s, row, v;
    __device__ __forceinline__ T rp(int k, int o0, int o1, int) const {
        return lateral<T, V>(
            ring[W::smap((s - 1) * NS + k)][slot_of(row + o0, W::P)], v + o1);
    }
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        return rp(k, o0, o1, o2);
    }
    __device__ __forceinline__ T rh(int j) const {
        return ring[W::hstr(j)][slot_of(row, W::P)][v];
    }
};

template <typename T, typename S, int V, bool PERIODIC, typename W,
          typename Fwd, typename Hoist, int NS, int NOUT, int NH>
__global__ void __launch_bounds__(32 * kWarps)
warp_chain(const __grid_constant__ WarpParams<S, NS> p) {
    constexpr int P = W::P, NX = W::NX, K = W::K;
    const int lane = threadIdx.x & 31;
    const int item = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
    if (item >= p.items) return;  // the whole warp
    const int strip = item % p.nstrip, segi = item / p.nstrip;
    const int64_t a = (int64_t)segi * p.seg;
    const int64_t b = a + p.seg < p.n0 ? a + p.seg : p.n0;
    const int64_t r0 = a - W::LEAD;  // global row of march row 0
    const int64_t s0 = (int64_t)strip * p.owned;
    const int64_t s1 = s0 + p.owned < p.n1 ? s0 + p.owned : p.n1;
    const int64_t col0 = s0 - p.halo + (int64_t)lane * V;
    bool own[V], wcol[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int64_t c = col0 + v;
        own[v] = c >= s0 && c < s1;
        wcol[v] = c >= p.wlo[1] && c < p.whi[1];
    }
    const bool lane_in = col0 >= 0 && col0 + V <= p.n1;
    const bool lane_own = col0 >= s0 && col0 + V <= s1;
    int64_t ccol[V];  // the lane's columns, clamped or wrapped
#pragma unroll
    for (int v = 0; v < V; ++v) {
        int64_t c = col0 + v;
        if (PERIODIC) {
            c %= p.n1;
            if (c < 0) c += p.n1;
        } else {
            c = c < 0 ? 0 : (c >= p.n1 ? p.n1 - 1 : c);
        }
        ccol[v] = c;
    }

    T ring[NX][P][V];
#pragma unroll
    for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int v = 0; v < V; ++v) ring[x][i][v] = T(0);

    for (int t = 0; t < p.steps; t += P) {
#pragma unroll
        for (int ph = 0; ph < P; ++ph) {
            const int64_t g = r0 + t + ph;  // the row loaded this step
            int64_t gr = g;
            if (PERIODIC) {
                gr %= p.n0;
                if (gr < 0) gr += p.n0;
            } else {
                gr = gr < 0 ? 0 : (gr >= p.n0 ? p.n0 - 1 : gr);
            }
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                if (!W::load(n)) continue;
                const S* row = p.in[n] + gr * p.in_st[n][0];
                if (V > 1 && lane_in && p.vec_in[n]) {
                    const Vec<S, V> c =
                        *reinterpret_cast<const Vec<S, V>*>(row + col0);
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        ring[n][ph][v] = psat::ld<T>(&c.v[v]);
                } else {
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        ring[n][ph][v] =
                            psat::ld<T>(row + ccol[v] * p.in_st[n][1]);
                }
            }
            if constexpr (NH > 0) {
                const int row = ph - W::LH;
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    Reader<T, W, V, NS> rd{ring, 1, row, v};
                    T h[NH];
                    Hoist::template run<T>(rd, h);
#pragma unroll
                    for (int j = 0; j < NH; ++j)
                        ring[W::hstr(j)][slot_of(row, P)][v] = h[j];
                }
            }
#pragma unroll
            for (int s = 1; s <= K; ++s) {
                const int row = ph - W::lag(s);
                const int sl = slot_of(row, P);
                const int64_t gs = g - W::lag(s);  // its global row
                const bool rin = gs >= p.wlo[0] && gs < p.whi[0];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    Reader<T, W, V, NS> rd{ring, s, row, v};
                    T o[NOUT];
#pragma unroll
                    for (int q = 0; q < NOUT; ++q) o[q] = T(0);
                    Fwd::template run<T>(rd, true, o);
                    const bool zero = !PERIODIC && !(rin && wcol[v]);
#pragma unroll
                    for (int q = 0; q < NOUT; ++q)
                        ring[W::ostr((s - 1) * NOUT + q)][sl][v] = zero ? T(0) : o[q];
                }
                if constexpr (W::NP > 0) {
                    if (gs >= a && gs < b) {
#pragma unroll
                        for (int q = 0; q < W::NP; ++q) {
                            if (gs != p.probe_row[q]) continue;
                            S* rec = p.probe[q] + (int64_t)(s - 1) * p.n1;
#pragma unroll
                            for (int v = 0; v < V; ++v)
                                if (own[v])
                                    psat::st(rec + col0 + v,
                                             ring[W::smap(s * NS
                                                          + W::probe(q))]
                                                 [sl][v]);
                        }
                    }
                }
            }
            const int64_t gk = g - W::lag(K);
            if (gk >= a && gk < b) {
                const int sl = slot_of(ph - W::lag(K), P);
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    if (!W::store(n)) continue;
                    S* row = p.out[n] + gk * p.out_st[n][0];
                    if (V > 1 && lane_own && p.vec_out[n]) {
                        Vec<S, V> c;
#pragma unroll
                        for (int v = 0; v < V; ++v)
                            psat::st(&c.v[v], ring[W::smap(K * NS + n)][sl][v]);
                        *reinterpret_cast<Vec<S, V>*>(row + col0) = c;
                    } else {
#pragma unroll
                        for (int v = 0; v < V; ++v)
                            if (own[v])
                                psat::st(row + (col0 + v) * p.out_st[n][1],
                                         ring[W::smap(K * NS + n)][sl][v]);
                    }
                }
            }
        }
    }
}

}  // namespace psat_warp
