// The value and gradient of k time steps in one kernel on a Hopper GPU: the
// hand-written CUDA port of the Pallas two-phase kernel
// pystencils_autodiff_tpu/ops/adjoint_chain.py::fused_chain_vjp (`build`).
//
// Contract: g(state, cot_state[, probe_cots]) -> (state_k, cot_0), where
// cot_0 is the exact VJP of k sequential steps (ops/adjoint_chain.py::
// plain_chain_vjp) including the ghost cells.
//
// Phase 1 recomputes the k forward stages in shared memory exactly as the
// forward chain kernel does (time_chain.cuh), over a tile whose halo is
// k·(forward reach + backward reach).  The pool schedule keeps, for every
// stage, the buffers of the state planes the backward program reads as
// primals (wave: u_curr only); chain-invariant planes (wave's c) are read
// from their one stage-independent buffer.
//
// Phase 2 walks the stages back.  Before reverse stage s it adds the probe
// cotangent of stage s into the cotangent of state s+1 at the probe row
// (every tile row whose global row — wrapped, in periodic mode — matches,
// halo rows included).  Then, per cell of the extended tile shrunk by the
// backward reach once more, it runs the emitted backward body `PsatBwd`
// through a reader that maps each backward input slot onto the state planes
// (`PsatBwdMeta`):
//   - an adjoint read of output o's cotangent reads the cotangent of the
//     state plane o is carried into, 0 where none is; in bounded mode it is
//     0 outside the forward interior, tested at the coordinates of the cell
//     READ (the exact-VJP mask);
//   - a primal read takes the saved plane of stage s; in bounded mode an
//     out-of-domain primal read is 1 (its product with a masked cotangent
//     is 0 and stays finite);
// and forms each state plane's new cotangent: its gradient output plus the
// cotangents of the planes carried from it unchanged (the transposed carry
// map; this is also how a time-constant coefficient's gradient accumulates
// across stages).  Each block writes state_k and cot_0 for its owned cells.
//
// Bound.  Per k steps the kernel reads state and cotangents once and
// writes state_k and cot_0 once: HBM bytes per step drop k× against k
// single forward plus k single backward steps.  What it pays instead: a
// halo twice the forward chain's (more redundant compute: the owned share
// of the extended tile is 0.3–0.55 at k = 4), shared-memory traffic on
// every read, and the shared memory of k saved planes plus two cotangent
// sets, which limits the tile.  Smaller halos (the twin-with-accumulation
// kernel) and register blocking are later work.
#pragma once

#include "time_chain.cuh"

namespace psat_chain {

template <typename T, int NS, int NOUT>
struct AdjointParams {
    ChainParams<T, NS, NOUT> f;  // geometry, tables, state in / state_k out
    const T* cot[NS];
    int64_t cot_st[NS][2];
    T* out_cot[NS];
    int64_t out_cot_st[NS][2];
    const T* probe_cot[kMaxProbes];  // (k, n1), contiguous
};

// MASKED: bounded mode at a cell whose backward stencil leaves the forward
// interior; elsewhere (periodic mode, and the bulk of every tile) the reads
// need no mask.
template <typename T, int NS, typename Meta, bool MASKED>
struct BwdReader {
    const T* prim[NS];  // state planes of stage s, at the cell
    const T* cot;       // cotangent set of state s+1, at the cell
    int ex, plane;
    int64_t gy, gx;     // global coordinates of the cell
    const Geo* g;

    __device__ __forceinline__ T rp(int j, int o0, int o1, int) const {
        const int n = Meta::prim(j);
        const T v = prim[n < 0 ? 0 : n][o0 * ex + o1];
        if (!MASKED) return v;
        const int64_t y = gy + o0, x = gx + o1;
        return (y >= 0 && y < g->n0 && x >= 0 && x < g->n1) ? v : T(1);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int) const {
        const int n = Meta::adj(j);
        if (n < 0) return T(0);
        const T v = cot[n * plane + o0 * ex + o1];
        if (!MASKED) return v;
        const int64_t y = gy + o0, x = gx + o1;
        return (y >= g->wlo0 && y < g->whi0 && x >= g->wlo1 && x < g->whi1)
                   ? v : T(0);
    }
};

// One reverse stage at one cell: the backward body, then each state
// plane's new cotangent (its gradient plus the pass-through cotangents).
template <typename T, int NS, int NOUTB, int MAXPASS, bool MASKED,
          typename Bwd, typename Meta>
__device__ __forceinline__ void reverse_cell(const T* const* pbase,
                                             const T* cur, T* nxt, int idx,
                                             int plane, const Geo& g,
                                             int64_t gy, int64_t gx) {
    BwdReader<T, NS, Meta, MASKED> rd;
#pragma unroll
    for (int k = 0; k < NS; ++k) rd.prim[k] = pbase[k] + idx;
    rd.cot = cur + idx;
    rd.ex = g.ex;
    rd.plane = plane;
    rd.gy = gy;
    rd.gx = gx;
    rd.g = &g;
    T v[NOUTB];
#pragma unroll
    for (int o = 0; o < NOUTB; ++o) v[o] = T(0);
    Bwd::template run<T>(rd, true, v);
#pragma unroll
    for (int m = 0; m < NS; ++m) {
        const int gs = Meta::grad(m);
        T val = gs >= 0 ? v[gs < 0 ? 0 : gs] : T(0);
#pragma unroll
        for (int q = 0; q < MAXPASS; ++q) {
            const int n = Meta::pass(m, q);
            if (n >= 0) val += cur[n * plane + idx];
        }
        nxt[m * plane + idx] = val;
    }
}

template <typename T, int NS, int NOUT, int NH, int NOUTB, int MAXPASS,
          bool PERIODIC, typename Fwd, typename Hoist, typename Bwd,
          typename Meta>
__global__ void __launch_bounds__(kThreadsX * kRowsAdj)
adjoint_chain(const __grid_constant__ AdjointParams<T, NS, NOUT> p) {
    extern __shared__ unsigned char smem_raw[];
    const ChainParams<T, NS, NOUT>& f = p.f;
    const Geo& g = f.g;
    const int plane = g.ey * g.ex;
    T* pool = reinterpret_cast<T*>(smem_raw);
    T* hoist = pool + g.npool * plane;
    T* cur = hoist + (g.nplanes - g.npool - 2 * NS) * plane;
    T* nxt = cur + NS * plane;
    int64_t gy0, gx0;
    tile_origin(g, gy0, gx0);
    load_planes<T, PERIODIC, NS>(pool, f.in, f.in_st, g, gy0, gx0, false);
    load_planes<T, PERIODIC, NS>(cur, p.cot, p.cot_st, g, gy0, gx0, true);
    __syncthreads();

    // ---- phase 1: the k forward stages, keeping the saved planes ----
    hoist_pass<T, NS, NH, Hoist>(f, pool, hoist);
    forward_stages<T, NS, NOUT, PERIODIC, Fwd>(f, pool, hoist, gy0, gx0,
                                               false);

    // ---- phase 2: the reverse sweep ----
    for (int r = 0; r < g.k; ++r) {
        const int s = g.k - 1 - r;
        // the valid region of the cotangents of state s+1
        const int cy_lo = g.k * g.lof0 + r * g.lob0;
        const int cy_hi = g.ey - g.k * g.hif0 - r * g.hib0;
        const int cx_lo = g.k * g.lof1 + r * g.lob1;
        const int cx_hi = g.ex - g.k * g.hif1 - r * g.hib1;
        for (int q = 0; q < g.nprobe; ++q) {
            T* c = cur + g.probe_state[q] * plane;
            const T* pc = p.probe_cot[q] + (int64_t)s * g.n1;
            for (int ly = cy_lo + threadIdx.y; ly < cy_hi; ly += blockDim.y) {
                int64_t gy = gy0 + ly;
                if (PERIODIC) gy = clamp_or_wrap(gy, g.n0, true);
                if (gy != g.probe_row[q]) continue;
                for (int lx = cx_lo + threadIdx.x; lx < cx_hi; lx += kThreadsX) {
                    int64_t gx = gx0 + lx;
                    if (PERIODIC) gx = clamp_or_wrap(gx, g.n1, true);
                    else if (gx < 0 || gx >= g.n1) continue;
                    c[ly * g.ex + lx] += pc[gx];
                }
            }
        }
        if (g.nprobe > 0) __syncthreads();

        const T* pbase[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) pbase[k] = pool + f.sbuf[s * NS + k] * plane;
        for (int ly = cy_lo + g.lob0 + threadIdx.y; ly < cy_hi - g.hib0;
             ly += blockDim.y) {
            const int64_t gy = gy0 + ly;
            const bool yin = gy - g.lob0 >= g.wlo0 && gy + g.hib0 < g.whi0;
            for (int lx = cx_lo + g.lob1 + threadIdx.x; lx < cx_hi - g.hib1;
                 lx += kThreadsX) {
                const int64_t gx = gx0 + lx;
                const int idx = ly * g.ex + lx;
                if (PERIODIC || (yin && gx - g.lob1 >= g.wlo1
                                 && gx + g.hib1 < g.whi1))
                    reverse_cell<T, NS, NOUTB, MAXPASS, false, Bwd, Meta>(
                        pbase, cur, nxt, idx, plane, g, gy, gx);
                else
                    reverse_cell<T, NS, NOUTB, MAXPASS, true, Bwd, Meta>(
                        pbase, cur, nxt, idx, plane, g, gy, gx);
            }
        }
        __syncthreads();
        T* t = cur;
        cur = nxt;
        nxt = t;
    }

    const T* fin[NS];
    const T* cot0[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        fin[k] = pool + f.sbuf[g.k * NS + k] * plane;
        cot0[k] = cur + k * plane;
    }
    store_owned<T>(f.out, f.out_st, fin, NS, g, gy0, gx0);
    store_owned<T>(p.out_cot, p.out_cot_st, cot0, NS, g, gy0, gx0);
}

}  // namespace psat_chain
