// k cycles of a sequence of different stencil ops, with boundary-condition
// events between them, in one kernel on a Hopper GPU (kernel 12): the
// hand-written CUDA port of the Pallas kernel
// pystencils_autodiff_tpu/ops/stage_chain.py::_make_stage_chain_kernel.
//
// What is per chain is emitted by codegen/cuda_printer.py::
// generate_stage_source: one `PsatEv<i>` per event of a cycle — a stage
// (its forward body `PsatFwd<i>::run`, the state plane of each of its
// input slots, its ghost widths) or a BC event (a chain_bc.cuh template
// over its constants) — and `PsatEvents::visit(kind, v)`, which calls
// v(PsatEv<kind>{}).  Everything else is here and in time_chain.cuh,
// whose tile machinery (Geo, load_planes, store_owned, tile_origin,
// launch_tiles) this kernel shares.
//
// Semantics (sequential stepping, ops/stage_chain.py::plain_stage_chain):
// per cycle, for each stage, its BC events (chain_bc.cuh) and then the
// stage: every cell evaluates the stage's forward program, is zeroed on
// the stage's own ghost frame (bounded mode; tested on global
// coordinates) or reads wrapped (periodic mode, 2D), and the carry map
// renames the outputs into the state; unmapped state passes through.
//
// Design.  A block owns a box tile and loads every state plane over the
// tile plus a halo of the events' summed reach (per dim and side: a
// stage's own reach from its accesses, so a staggered pair's one-sided
// reads count on the side they read; a BC's from bc_dim_reach) into
// shared memory.  The k·S events then run in shared memory, event e
// writing the region its predecessors left valid shrunk by its own reach
// (host-side prefix sums, `fr`).  State planes live in a pool of tile-
// sized buffers: an event writes its outputs into free buffers (a
// pointwise BC into its target's own buffer) and the carry only renames
// buffers (`sbuf`/`obuf`, ops/stage_chain.py::event_schedule).  Each
// block writes the owned cells of every plane that is not chain-invariant
// (BC parameter planes and coefficients come back as given).
//
// Bound.  Per call the kernel reads each state plane once and writes each
// carried plane once: HBM bytes per cycle drop k× against single steps
// and separate BC passes.  What it pays instead: redundant halo compute
// (the owned share of the extended tile) and shared-memory traffic on
// every read; no hoisting of chain-invariant subexpressions yet (the
// JAX package hoists them), no register blocking, no cp.async/TMA.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_bc.cuh"
#include "time_chain.cuh"

namespace psat_stage {

using psat_chain::Geo;
using psat_chain::kThreadsX;

// T: the compute type (and of the shared-memory pool); S: the storage
// type of the planes in device memory (ld/st in on_device.cuh)
template <typename T, int NS, int NE, int MAXOUT, typename S = T>
struct StageParams {
    static constexpr int kMaxOut = MAXOUT;
    Geo g;                      // n t e h nt npool nplanes rows (k unused)
    int16_t kind[NE];           // event -> PsatEv index
    int16_t fr[NE][6];          // forward region: lo (z, y, x), hi (z, y, x)
    int16_t rr[NE][6];          // reverse region (kernel 13)
    int16_t sbuf[(NE + 1) * NS];  // buffer of state plane n before event e
    int16_t obuf[NE * MAXOUT];    // buffer of output o of event e
    const S* in[NS];
    int64_t in_st[NS][3];
    S* out[NS];
    int64_t out_st[NS][3];
};

// geo: n[3] t[3] e[3] h[3] ne npool nplanes rows
//      (kind fr[6] rr[6]) * ne  sbuf[(ne+1)*NS]  obuf[ne*MAXOUT]
template <typename P, int NS, int NE, int MAXOUT>
inline bool parse_stage_geo(const int64_t* geo, P& p) {
    Geo& g = p.g;
    int i = 0;
    auto take3 = [&](auto* dst) {
        for (int d = 0; d < 3; ++d) dst[d] = geo[i++];
    };
    take3(g.n);
    take3(g.t); take3(g.e); take3(g.h);
    const int ne = (int)geo[i++];
    g.npool = (int)geo[i++];
    g.nplanes = (int)geo[i++];
    g.rows = (int)geo[i++];
    g.k = 1;
    g.nowned = 0;
    g.nprobe = 0;
    if (ne != NE) return false;
    int64_t tiles = 1;
    for (int d = 0; d < 3; ++d) {
        if (g.t[d] < 1 || g.e[d] > 32767) return false;
        const int64_t nt = (g.n[d] + g.t[d] - 1) / g.t[d];
        tiles *= nt;
        if (tiles > 0x7fffffff) return false;  // the grid is 1D, in int
        g.nt[d] = (int)nt;
    }
    for (int e = 0; e < NE; ++e) {
        p.kind[e] = (int16_t)geo[i++];
        for (int q = 0; q < 6; ++q) p.fr[e][q] = (int16_t)geo[i++];
        for (int q = 0; q < 6; ++q) p.rr[e][q] = (int16_t)geo[i++];
    }
    for (int q = 0; q < (NE + 1) * NS; ++q) {
        p.sbuf[q] = (int16_t)geo[i++];
        if (p.sbuf[q] < 0 || p.sbuf[q] >= g.npool) return false;
    }
    for (int q = 0; q < NE * MAXOUT; ++q) p.obuf[q] = (int16_t)geo[i++];
    return g.npool <= g.nplanes;
}

// Reader of a stage's forward body at one cell: input slot j of stage Ev
// is state plane Ev::in(j), in the buffer it holds before the event.
template <typename T, typename Ev, int ND>
struct StageIn {
    const T* pool;
    const int16_t* sb;
    int plane, idx, e1, e2;
    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        return pool[sb[Ev::in(j)] * plane + idx
                    + psat_chain::cell_off<ND>(o0, o1, o2, e1, e2)];
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        return rp(j, o0, o1, o2);
    }
};

// Reader of a BC event's forward (chain_bc.cuh): state plane sp before the
// event at a (z, y, x) offset, and the cell's global coordinates.
template <typename T>
struct BcIn {
    const T* pool;
    const int16_t* sb;
    int plane, idx, e1, e2;
    int64_t gc[3];
    const int64_t* n;
    __device__ __forceinline__ T rd(int sp, int dz, int dy, int dx) const {
        return pool[sb[sp] * plane + idx + (dz * e1 + dy) * e2 + dx];
    }
    __device__ __forceinline__ bool in_domain() const {
        return gc[0] >= 0 && gc[0] < n[0] && gc[1] >= 0 && gc[1] < n[1]
               && gc[2] >= 0 && gc[2] < n[2];
    }
};

// Is global cell (gz, gy, gx) inside stage Ev's interior window?
template <typename Ev, int ND>
__device__ __forceinline__ bool stage_interior(const Geo& g, int64_t gz,
                                               int64_t gy, int64_t gx) {
    return psat_chain::z_in<ND>(gz, Ev::glo(0), g.n[0] - Ev::ghi(0))
           && gy >= Ev::glo(1) && gy < g.n[1] - Ev::ghi(1)
           && gx >= Ev::glo(2) && gx < g.n[2] - Ev::ghi(2);
}

// One forward event over its region (visited with the event's type).
template <typename T, int NS, int ND, bool PERIODIC, typename P>
struct FwdEvent {
    const P& p;
    T* pool;
    int e;
    const int64_t* g0;

    template <typename Ev>
    __device__ __forceinline__ void operator()(Ev) const {
        const Geo& g = p.g;
        const int plane = g.plane();
        const int16_t* sb = p.sbuf + e * NS;
        const int16_t* ob = p.obuf + e * P::kMaxOut;
        const int16_t* r = p.fr[e];
        psat_chain::for_rows<ND>(r[0], r[3], r[1], r[4], [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            const int lrow = (lz * g.e[1] + ly) * g.e[2];
            for (int lx = r[2] + threadIdx.x; lx < r[5]; lx += kThreadsX) {
                const int idx = lrow + lx;
                const int64_t gx = g0[2] + lx;
                T v[Ev::kNOut];
                if constexpr (Ev::kIsBc) {
                    const BcIn<T> rd{pool, sb, plane, idx, g.e[1], g.e[2],
                                     {gz, gy, gx}, g.n};
                    Ev::template fwd<T, PERIODIC>(rd, v);
                } else {
                    const StageIn<T, Ev, ND> rd{pool, sb, plane, idx, g.e[1],
                                                g.e[2]};
#pragma unroll
                    for (int o = 0; o < Ev::kNOut; ++o) v[o] = T(0);
                    Ev::template run<T>(rd, true, v);
                    if (!PERIODIC && !stage_interior<Ev, ND>(g, gz, gy, gx)) {
#pragma unroll
                        for (int o = 0; o < Ev::kNOut; ++o) v[o] = T(0);
                    }
                }
#pragma unroll
                for (int o = 0; o < Ev::kNOut; ++o)
                    pool[ob[o] * plane + idx] = v[o];
            }
        });
    }
};

// The k·S events in shared memory (kernel 12, and phase 1 of kernel 13).
template <typename T, int NS, int NE, int ND, bool PERIODIC, typename Events,
          typename P>
__device__ __forceinline__ void run_forward(const P& p, T* pool,
                                            const int64_t* g0) {
    for (int e = 0; e < NE; ++e) {
        Events::visit(p.kind[e], FwdEvent<T, NS, ND, PERIODIC, P>{p, pool, e,
                                                                  g0});
        __syncthreads();
    }
}

template <typename T, int NS, int NE, int MAXOUT, int ND, bool PERIODIC,
          typename Events, int ROWS, typename S = T>
__global__ void __launch_bounds__(kThreadsX * ROWS)
stage_chain(const __grid_constant__ StageParams<T, NS, NE, MAXOUT, S> p) {
    extern __shared__ unsigned char smem_raw[];
    T* pool = reinterpret_cast<T*>(smem_raw);
    const Geo& g = p.g;
    const int plane = g.plane();
    int64_t g0[3];
    psat_chain::tile_origin<ND>(g, g0);
    // sbuf[0][n] == n: the initial state planes are pool buffers 0..NS-1
    psat_chain::load_planes<T, PERIODIC, NS, ND>(pool, p.in, p.in_st, g, g0,
                                                 false);
    __syncthreads();
    run_forward<T, NS, NE, ND, PERIODIC, Events>(p, pool, g0);
    const T* fin[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) fin[k] = pool + p.sbuf[NE * NS + k] * plane;
    // a null out[k]: a chain-invariant plane, returned as it came
    psat_chain::store_owned<T, ND, true>(p.out, p.out_st, fin, NS, g, g0);
}

}  // namespace psat_stage
