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
//   - an adjoint read of output o's cotangent reads the sum of the
//     cotangents of the state planes o is carried into, 0 where none is;
//     in bounded mode it is 0 outside the forward interior, tested at the
//     coordinates of the cell READ (the exact-VJP mask);
//   - a primal read takes the saved plane of stage s; in bounded mode an
//     out-of-domain primal read is 1 (its product with a masked cotangent
//     is 0 and stays finite);
// and forms each state plane's new cotangent: its gradient output plus the
// cotangents of the planes carried from it unchanged (the transposed carry
// map; this is also how a time-constant coefficient's gradient accumulates
// across stages).  Each block writes state_k and cot_0 for its owned cells;
// a null state_k pointer (a chain-invariant plane, which the wrapper
// returns as it came) is not written.
//
// Bound.  Per k steps the kernel reads state and cotangents once and
// writes state_k (but its invariant planes) and cot_0 once: HBM bytes per
// step drop k× against k
// single forward plus k single backward steps.  What it pays instead: a
// halo twice the forward chain's (more redundant compute: the owned share
// of the extended tile is 0.3–0.55 at k = 4), shared-memory traffic on
// every read, and the shared memory of k saved planes plus two cotangent
// sets, which limits the tile.  Smaller halos (the twin-with-accumulation
// kernel) and register blocking are later work.
#pragma once

#include "time_chain.cuh"

namespace psat_chain {

template <typename T, int NS, int NOUT, typename S = T>
struct AdjointParams {
    ChainParams<T, NS, NOUT, S> f;  // geometry, tables, state in / state_k out
    const S* cot[NS];
    int64_t cot_st[NS][3];
    S* out_cot[NS];
    int64_t out_cot_st[NS][3];
    const S* probe_cot[kMaxProbes];  // (k, n1), contiguous
};

// MASKED: bounded mode at a cell whose backward stencil leaves the forward
// interior; elsewhere (periodic mode, and the bulk of every tile) the reads
// need no mask.
template <typename T, int NS, int ND, typename Meta, bool MASKED>
struct BwdReader {
    const T* prim[NS];  // state planes of stage s, at the cell
    const T* cot;       // cotangent set of state s+1, at the cell
    int e1, e2, plane;
    int64_t gz, gy, gx;  // global coordinates of the cell
    const Geo* g;

    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        const int n = Meta::prim(j);
        const T v = prim[n < 0 ? 0 : n][cell_off<ND>(o0, o1, o2, e1, e2)];
        if (!MASKED) return v;
        int dz, dy, dx;
        zyx<ND>(o0, o1, o2, dz, dy, dx);
        const int64_t z = gz + dz, y = gy + dy, x = gx + dx;
        return (z_in<ND>(z, 0, g->n[0]) && y >= 0 && y < g->n[1] && x >= 0
                && x < g->n[2]) ? v : T(1);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        if (Meta::adj(j, 0) < 0) return T(0);
        const int off = cell_off<ND>(o0, o1, o2, e1, e2);
        T v = cot[Meta::adj(j, 0) * plane + off];
#pragma unroll
        for (int q = 1; q < Meta::kMaxAdj; ++q) {
            const int n = Meta::adj(j, q);
            if (n >= 0) v += cot[n * plane + off];
        }
        if (!MASKED) return v;
        int dz, dy, dx;
        zyx<ND>(o0, o1, o2, dz, dy, dx);
        const int64_t z = gz + dz, y = gy + dy, x = gx + dx;
        return (z_in<ND>(z, g->wlo[0], g->whi[0]) && y >= g->wlo[1]
                && y < g->whi[1] && x >= g->wlo[2] && x < g->whi[2])
                   ? v : T(0);
    }
};

// One reverse stage at one cell: the backward body, then each state
// plane's new cotangent (its gradient plus the pass-through cotangents).
template <typename T, int NS, int NOUTB, int MAXPASS, int ND, bool MASKED,
          typename Bwd, typename Meta>
__device__ __forceinline__ void reverse_cell(const T* const* pbase,
                                             const T* cur, T* nxt, int idx,
                                             int plane, const Geo& g,
                                             int64_t gz, int64_t gy,
                                             int64_t gx) {
    BwdReader<T, NS, ND, Meta, MASKED> rd;
#pragma unroll
    for (int k = 0; k < NS; ++k) rd.prim[k] = pbase[k] + idx;
    rd.cot = cur + idx;
    rd.e1 = g.e[1];
    rd.e2 = g.e[2];
    rd.plane = plane;
    rd.gz = gz;
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
          int ND, bool PERIODIC, typename Fwd, typename Hoist, typename Bwd,
          typename Meta, typename S = T>
__global__ void __launch_bounds__(kThreadsX * kRowsAdj)
adjoint_chain(const __grid_constant__ AdjointParams<T, NS, NOUT, S> p) {
    extern __shared__ unsigned char smem_raw[];
    const ChainParams<T, NS, NOUT, S>& f = p.f;
    const Geo& g = f.g;
    const int plane = g.plane();
    T* pool = reinterpret_cast<T*>(smem_raw);
    T* hoist = pool + g.npool * plane;
    T* cur = hoist + (g.nplanes - g.npool - 2 * NS) * plane;
    T* nxt = cur + NS * plane;
    int64_t g0[3];
    tile_origin<ND>(g, g0);
    load_planes<T, PERIODIC, NS, ND>(pool, f.in, f.in_st, g, g0, false);
    load_planes<T, PERIODIC, NS, ND>(cur, p.cot, p.cot_st, g, g0, true);
    __syncthreads();

    // ---- phase 1: the k forward stages, keeping the saved planes ----
    hoist_pass<T, NS, NH, ND, Hoist>(f, pool, hoist);
    forward_stages<T, NS, NOUT, ND, PERIODIC, Fwd>(f, pool, hoist, g0,
                                                   false);

    // ---- phase 2: the reverse sweep ----
    for (int r = 0; r < g.k; ++r) {
        const int s = g.k - 1 - r;
        // the valid region of the cotangents of state s+1
        int clo[3], chi[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            clo[d] = g.k * g.lof[d] + r * g.lob[d];
            chi[d] = g.e[d] - g.k * g.hif[d] - r * g.hib[d];
        }
        // probes are 2D: the row is dim y
        for (int q = 0; q < g.nprobe; ++q) {
            T* c = cur + g.probe_state[q] * plane;
            const S* pc = p.probe_cot[q] + (int64_t)s * g.n[2];
            for_rows<ND>(clo[0], chi[0], clo[1], chi[1],
                         [&](int lz, int ly) {
                int64_t gy = g0[1] + ly;
                if (PERIODIC) gy = clamp_or_wrap(gy, g.n[1], true);
                if (gy != g.probe_row[q]) return;
                const int lrow = (lz * g.e[1] + ly) * g.e[2];
                for (int lx = clo[2] + threadIdx.x; lx < chi[2];
                     lx += kThreadsX) {
                    int64_t gx = g0[2] + lx;
                    if (PERIODIC) gx = clamp_or_wrap(gx, g.n[2], true);
                    else if (gx < 0 || gx >= g.n[2]) continue;
                    c[lrow + lx] += psat::ld<T>(pc + gx);
                }
            });
        }
        if (g.nprobe > 0) __syncthreads();

        const T* pbase[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) pbase[k] = pool + f.sbuf[s * NS + k] * plane;
        for_rows<ND>(clo[0] + g.lob[0], chi[0] - g.hib[0], clo[1] + g.lob[1],
                     chi[1] - g.hib[1], [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            const bool rin = z_in<ND>(gz, g.wlo[0] + g.lob[0],
                                      g.whi[0] - g.hib[0])
                             && gy - g.lob[1] >= g.wlo[1]
                             && gy + g.hib[1] < g.whi[1];
            const int lrow = (lz * g.e[1] + ly) * g.e[2];
            for (int lx = clo[2] + g.lob[2] + threadIdx.x;
                 lx < chi[2] - g.hib[2]; lx += kThreadsX) {
                const int64_t gx = g0[2] + lx;
                const int idx = lrow + lx;
                if (PERIODIC || (rin && gx - g.lob[2] >= g.wlo[2]
                                 && gx + g.hib[2] < g.whi[2]))
                    reverse_cell<T, NS, NOUTB, MAXPASS, ND, false, Bwd, Meta>(
                        pbase, cur, nxt, idx, plane, g, gz, gy, gx);
                else
                    reverse_cell<T, NS, NOUTB, MAXPASS, ND, true, Bwd, Meta>(
                        pbase, cur, nxt, idx, plane, g, gz, gy, gx);
            }
        });
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
    store_owned<T, ND, true>(f.out, f.out_st, fin, NS, g, g0);
    store_owned<T, ND>(p.out_cot, p.out_cot_st, cot0, NS, g, g0);
}

}  // namespace psat_chain
