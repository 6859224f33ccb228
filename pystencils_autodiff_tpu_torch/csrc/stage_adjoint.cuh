// The value and gradient of k cycles of a stage chain, boundary-condition
// events included, in one kernel on a Hopper GPU (kernel 13): the hand-
// written CUDA port of the Pallas kernel
// pystencils_autodiff_tpu/ops/stage_adjoint.py::fused_stage_chain_vjp.
//
// Contract: g(state, cot_state) -> (state_k, cot_0), cot_0 the exact VJP
// of k sequential cycles (ops/stage_adjoint.py::plain_stage_chain_vjp),
// ghost cells included, for every cotangent slot (each state plane but
// those of chain-invariant fields whose gradient is not asked for).
//
// Phase 1 runs the k·S events in shared memory exactly as kernel 12 does
// (stage_chain.cuh::run_forward, the same device code), over a tile whose
// halo holds every event's forward and reverse reach.  The pool schedule
// keeps, for each stage, the buffers of the state planes its backward
// program reads as primals (BGK: f; the linear elastic pair: none), and,
// for a sponge whose damping gradient is asked for, the pre-sponge target.
//
// Phase 2 walks the events back over regions shrinking by each event's
// reverse reach (`rr`), with the cotangents in two sets of shared-memory
// planes (read one, write the other).  A stage runs its emitted backward
// body through a reader that maps each backward input slot onto the saved
// primal planes or the cotangent slots (`PsatEv<i>` tables):
//   - an adjoint read of output o takes the sum of the cotangents of the
//     state planes o is carried into; in bounded mode it is 0 outside the stage's
//     forward interior, tested at the cell READ (the exact-VJP mask);
//   - a primal read takes the plane saved before the stage; in bounded
//     mode an out-of-domain primal read is 1 (BGK's 1/ρ then stays
//     finite, and its product with a masked cotangent is 0);
// and each cotangent slot becomes its gradient output plus the cotangents
// of the planes carried from it unchanged (the stage-carry transpose).
// A BC event runs its chain_bc.cuh transpose (gather form) and passes the
// other slots through.  Each block writes state_k and cot_0 for its owned
// cells; chain-invariant state planes are not written.
//
// Bound.  Per call the kernel reads state and cotangents once and writes
// state_k (but its invariant planes) and cot_0 once.  What it pays: a halo
// of both directions' reach (more redundant compute than kernel 12), the
// shared memory of the saved primals and two cotangent sets, which limits
// the tile (the wrapper runs the segmented form where no k-deep tile
// keeps the picker's owned-share floor), and shared-memory traffic on
// every read.
#pragma once

#include "stage_chain.cuh"

namespace psat_stage {

template <typename T, int NS, int NE, int MAXOUT, int NC, typename S = T>
struct StageAdjointParams {
    StageParams<T, NS, NE, MAXOUT, S> f;  // geometry, tables, state in/out
    const S* cot[NC];
    int64_t cot_st[NC][3];
    S* out_cot[NC];
    int64_t out_cot_st[NC][3];
};

// Reader of a stage's backward body at one cell.  MASKED: bounded mode at
// a cell whose backward stencil leaves the stage's interior window.
template <typename T, typename Ev, int ND, bool MASKED>
struct StageBwdIn {
    const T* pool;
    const int16_t* sb;  // buffers of the state before the stage
    const T* cur;       // cotangent slots after the stage
    int plane, idx, e1, e2;
    int64_t gz, gy, gx;
    const Geo* g;

    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        const int n = Ev::prim(j);
        const T v = pool[sb[n < 0 ? 0 : n] * plane + idx
                         + psat_chain::cell_off<ND>(o0, o1, o2, e1, e2)];
        if (!MASKED) return v;
        int dz, dy, dx;
        psat_chain::zyx<ND>(o0, o1, o2, dz, dy, dx);
        const int64_t z = gz + dz, y = gy + dy, x = gx + dx;
        return (psat_chain::z_in<ND>(z, 0, g->n[0]) && y >= 0 && y < g->n[1]
                && x >= 0 && x < g->n[2]) ? v : T(1);
    }
    // the sum of the cotangents of every state plane the output is
    // carried into
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        const int c0 = Ev::adj(j, 0);
        if (c0 < 0) return T(0);
        const int off = idx + psat_chain::cell_off<ND>(o0, o1, o2, e1, e2);
        T v = cur[c0 * plane + off];
#pragma unroll
        for (int q = 1; q < Ev::kMaxAdj; ++q) {
            const int c = Ev::adj(j, q);
            if (c >= 0) v += cur[c * plane + off];
        }
        if (!MASKED) return v;
        int dz, dy, dx;
        psat_chain::zyx<ND>(o0, o1, o2, dz, dy, dx);
        return stage_interior<Ev, ND>(*g, gz + dz, gy + dy, gx + dx) ? v
                                                                   : T(0);
    }
};

// Reader of a BC event's transpose (chain_bc.cuh): the state before the
// event, the cotangent slots after it.
template <typename T>
struct BcRevIn {
    const T* pool;
    const int16_t* sb;
    const T* cur;
    int plane, idx, e1, e2;
    int64_t gc[3];
    const int64_t* n;
    __device__ __forceinline__ T rd(int sp, int dz, int dy, int dx) const {
        return pool[sb[sp] * plane + idx + (dz * e1 + dy) * e2 + dx];
    }
    __device__ __forceinline__ T rc(int cs, int dz, int dy, int dx) const {
        return cur[cs * plane + idx + (dz * e1 + dy) * e2 + dx];
    }
    __device__ __forceinline__ bool in_domain() const {
        return gc[0] >= 0 && gc[0] < n[0] && gc[1] >= 0 && gc[1] < n[1]
               && gc[2] >= 0 && gc[2] < n[2];
    }
};

// One reverse stage at one cell: the backward body, then each cotangent
// slot's new value (its gradient plus the pass-through cotangents).
template <typename T, int NC, int ND, bool MASKED, typename Ev>
__device__ __forceinline__ void reverse_stage_cell(
        const StageBwdIn<T, Ev, ND, MASKED>& rd, const T* cur, T* nxt,
        int idx, int plane) {
    T v[Ev::kNOutB];
#pragma unroll
    for (int o = 0; o < Ev::kNOutB; ++o) v[o] = T(0);
    Ev::Bwd::template run<T>(rd, true, v);
#pragma unroll
    for (int m = 0; m < NC; ++m) {
        const int gs = Ev::grad(m);
        T val = gs >= 0 ? v[gs < 0 ? 0 : gs] : T(0);
#pragma unroll
        for (int q = 0; q < Ev::kMaxPass; ++q) {
            const int n = Ev::pass(m, q);
            if (n >= 0) val += cur[n * plane + idx];
        }
        nxt[m * plane + idx] = val;
    }
}

// One reverse event over its region (visited with the event's type).
template <typename T, int NS, int NC, int ND, bool PERIODIC, typename P>
struct RevEvent {
    const P& p;
    const T* pool;
    const T* cur;
    T* nxt;
    int e;
    const int64_t* g0;

    template <typename Ev>
    __device__ __forceinline__ void operator()(Ev) const {
        const Geo& g = p.g;
        const int plane = g.plane();
        const int16_t* sb = p.sbuf + e * NS;
        const int16_t* r = p.rr[e];
        psat_chain::for_rows<ND>(r[0], r[3], r[1], r[4], [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            const int lrow = (lz * g.e[1] + ly) * g.e[2];
            for (int lx = r[2] + threadIdx.x; lx < r[5]; lx += kThreadsX) {
                const int idx = lrow + lx;
                const int64_t gx = g0[2] + lx;
                if constexpr (Ev::kIsBc) {
                    T v[NC];
#pragma unroll
                    for (int m = 0; m < NC; ++m) v[m] = cur[m * plane + idx];
                    const BcRevIn<T> rd{pool, sb, cur, plane, idx, g.e[1],
                                        g.e[2], {gz, gy, gx}, g.n};
                    Ev::template bwd<T, PERIODIC>(rd, v);
#pragma unroll
                    for (int m = 0; m < NC; ++m) nxt[m * plane + idx] = v[m];
                } else {
                    // unmasked where every read of the backward stencil
                    // stays inside the stage's interior window
                    const bool clear =
                        PERIODIC
                        || (psat_chain::z_in<ND>(gz,
                                                 Ev::glo(0) + Ev::blo(0),
                                                 g.n[0] - Ev::ghi(0)
                                                     - Ev::bhi(0))
                            && gy - Ev::blo(1) >= Ev::glo(1)
                            && gy + Ev::bhi(1) < g.n[1] - Ev::ghi(1)
                            && gx - Ev::blo(2) >= Ev::glo(2)
                            && gx + Ev::bhi(2) < g.n[2] - Ev::ghi(2));
                    if (clear) {
                        const StageBwdIn<T, Ev, ND, false> rd{
                            pool, sb, cur, plane, idx, g.e[1], g.e[2],
                            gz, gy, gx, &g};
                        reverse_stage_cell<T, NC, ND, false, Ev>(rd, cur,
                                                                 nxt, idx,
                                                                 plane);
                    } else {
                        const StageBwdIn<T, Ev, ND, true> rd{
                            pool, sb, cur, plane, idx, g.e[1], g.e[2],
                            gz, gy, gx, &g};
                        reverse_stage_cell<T, NC, ND, true, Ev>(rd, cur, nxt,
                                                                idx, plane);
                    }
                }
            }
        });
    }
};

template <typename T, int NS, int NE, int MAXOUT, int NC, int ND,
          bool PERIODIC, typename Events, typename S = T>
__global__ void __launch_bounds__(kThreadsX * psat_chain::kRowsAdj)
stage_adjoint(const __grid_constant__
              StageAdjointParams<T, NS, NE, MAXOUT, NC, S> p) {
    extern __shared__ unsigned char smem_raw[];
    const StageParams<T, NS, NE, MAXOUT, S>& f = p.f;
    const Geo& g = f.g;
    const int plane = g.plane();
    T* pool = reinterpret_cast<T*>(smem_raw);
    T* cur = pool + g.npool * plane;
    T* nxt = cur + NC * plane;
    int64_t g0[3];
    psat_chain::tile_origin<ND>(g, g0);
    psat_chain::load_planes<T, PERIODIC, NS, ND>(pool, f.in, f.in_st, g, g0,
                                                 false);
    psat_chain::load_planes<T, PERIODIC, NC, ND>(cur, p.cot, p.cot_st, g, g0,
                                                 true);
    __syncthreads();

    // ---- phase 1: the k·S events, keeping the saved planes ----
    run_forward<T, NS, NE, ND, PERIODIC, Events>(f, pool, g0);

    // ---- phase 2: the reverse sweep ----
    for (int e = NE - 1; e >= 0; --e) {
        Events::visit(f.kind[e],
                      RevEvent<T, NS, NC, ND, PERIODIC,
                               StageParams<T, NS, NE, MAXOUT, S>>{
                          f, pool, cur, nxt, e, g0});
        __syncthreads();
        T* t = cur;
        cur = nxt;
        nxt = t;
    }

    const T* fin[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) fin[k] = pool + f.sbuf[NE * NS + k] * plane;
    const T* cot0[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) cot0[m] = cur + m * plane;
    psat_chain::store_owned<T, ND, true>(f.out, f.out_st, fin, NS, g, g0);
    psat_chain::store_owned<T, ND>(p.out_cot, p.out_cot_st, cot0, NC, g, g0);
}

}  // namespace psat_stage
