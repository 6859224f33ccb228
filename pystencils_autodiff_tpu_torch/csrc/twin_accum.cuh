// The value and gradient of k time steps of a state-linear op with
// differentiable chain-invariant coefficients, in one kernel on a Hopper
// GPU: the hand-written CUDA port of the Pallas kernels
// pystencils_autodiff_tpu/ops/twin_adjoint.py::make_twin_accum_vjp_fn (2D
// periodic) and ::make_plane_twin_accum_vjp_fn (3D, bounded or periodic,
// and the "bounded twin" of a pure-linear op without coefficients).
//
// Contract: g(state, cot_state) -> (state_k, cot_0), the exact VJP of k
// sequential steps, ghost cells included (the same contract as the
// two-phase kernel, adjoint_chain.cuh).
//
// The decomposition (ops/twin_adjoint.py::state_coeff_twin): the state
// cotangents advance through the transposed op's own chain (`PsatCot`, a
// forward stencil over the cotangent planes), and each coefficient's
// gradient accumulates once per stage (`PsatGrad`, the grad program), from
// the stage-s primal state and the stage-(s+1) cotangent.
//
// Phase 1 recomputes the k forward stages on the state block exactly as the
// forward chain kernel does (time_chain.cuh), over a halo of
// k·max(forward reach, cotangent reach) per side; the pool schedule keeps
// only the planes the grad program reads (saved_names) for every stage.
// Phase 2 advances the cotangent block k steps through PsatCot, its valid
// region shrinking by the cotangent reach per step (a halo of k·reach_c —
// half the two-phase kernel's k·(reach_f + reach_b) for these ops), and
// before each step adds the grad program's value to the coefficient
// gradient on the OWNED cells only, where every factor is in range.
// Bounded mode: each forward stage zeroes the global ghost frame, and every
// cotangent read that stands for an output's adjoint goes through the
// masked view (mask⊙cot, `mcot_*`: (mask∘A)ᵀ = Aᵀ∘mask), tested at the
// coordinates of the cell read; pass-through cotangents stay unmasked.
// Periodic mode wraps every load and masks nothing.
//
// Bound.  Per k steps the kernel reads state and cotangents once and writes
// state_k and cot_0 once (the invariant state planes are not written back:
// the wrapper returns them as they came), so HBM bytes per step drop k×
// against k single forward plus k single backward steps.  What it pays
// instead: redundant compute over the halo (on 3D box tiles the owned share
// of the extended tile is 0.2–0.4 at k = 2), and shared-memory traffic —
// every read of every stage and step is a shared-memory load (the 7-point
// 3D ops: 13 per cell in a forward stage with hoisting, 14 in a cotangent
// step, 8 for the κ gradient), which bounds it once k amortises the HBM
// bytes; and the shared memory of k saved planes plus two cotangent sets,
// which limits the tile.  Register blocking and cp.async/TMA loads are
// later work.
#pragma once

#include "time_chain.cuh"

namespace psat_chain {

// NC cotangent planes (the state planes the cotangent chain carries), NG
// coefficient-gradient planes (one per grad-program output).
template <typename T, int NS, int NOUT, int NC, int NG, typename S = T>
struct TwinParams {
    ChainParams<T, NS, NOUT, S> f;  // geometry, tables; out[n] null: not stored
    const S* cot[NC];
    int64_t cot_st[NC][3];
    S* out_cot[NC];
    int64_t out_cot_st[NC][3];
    const S* gcot[NG > 0 ? NG : 1];  // incoming cotangent of each coefficient
    int64_t gcot_st[NG > 0 ? NG : 1][3];
    S* out_gcot[NG > 0 ? NG : 1];
    int64_t out_gcot_st[NG > 0 ? NG : 1][3];
};

// Reader of the cotangent body and the grad program at one cell.  Slots
// maps a body input slot j to a state plane (Slots::src, the stage's
// buffer: a saved primal or an invariant coefficient) or to a cotangent
// plane (Slots::cot), read through the masked view when Slots::mask.
// MASKED: bounded mode at a cell whose stencil leaves the forward interior.
template <typename T, int NS, int ND, typename Slots, bool MASKED>
struct TwinReader {
    const T* prim[NS];  // state planes of the stage, at the cell
    const T* cot;       // cotangent set, at the cell
    int e1, e2, plane;
    int64_t gz, gy, gx;
    const Geo* g;

    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        const int off = cell_off<ND>(o0, o1, o2, e1, e2);
        const int c = Slots::cot(j);
        if (c < 0) {
            const int n = Slots::src(j);
            return prim[n < 0 ? 0 : n][off];
        }
        const T v = cot[c * plane + off];
        if (!MASKED || !Slots::mask(j)) return v;
        int dz, dy, dx;
        zyx<ND>(o0, o1, o2, dz, dy, dx);
        const int64_t z = gz + dz, y = gy + dy, x = gx + dx;
        return (z_in<ND>(z, g->wlo[0], g->whi[0]) && y >= g->wlo[1]
                && y < g->whi[1] && x >= g->wlo[2] && x < g->whi[2])
                   ? v : T(0);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        return rp(j, o0, o1, o2);
    }
};

template <typename T, int NS, int ND, typename Slots, bool MASKED,
          typename Body, int NV>
__device__ __forceinline__ void twin_cell(const T* const* pbase,
                                          const T* cur, int idx, int plane,
                                          const Geo& g, int64_t gz,
                                          int64_t gy, int64_t gx, T* v) {
    TwinReader<T, NS, ND, Slots, MASKED> rd;
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
#pragma unroll
    for (int o = 0; o < NV; ++o) v[o] = T(0);
    Body::template run<T>(rd, true, v);
}

// Is the box of reach (lo, hi) around global cell (gz, gy, gx) inside the
// forward interior?  Then no read of it needs the mask.
template <int ND>
__device__ __forceinline__ bool box_inside(const Geo& g, int64_t gz,
                                           int64_t gy, int64_t gx,
                                           const int* lo, const int* hi) {
    return z_in<ND>(gz, g.wlo[0] + lo[0], g.whi[0] - hi[0])
           && gy - lo[1] >= g.wlo[1] && gy + hi[1] < g.whi[1]
           && gx - lo[2] >= g.wlo[2] && gx + hi[2] < g.whi[2];
}

template <typename T, int NS, int NOUT, int NH, int NC, int NG, int ND,
          bool PERIODIC, typename Fwd, typename Hoist, typename Cot,
          typename CotSlots, typename Grad, typename GradSlots,
          typename S = T>
__global__ void __launch_bounds__(kThreadsX * kRowsAdj)
twin_accum(const __grid_constant__ TwinParams<T, NS, NOUT, NC, NG, S> p) {
    extern __shared__ unsigned char smem_raw[];
    const ChainParams<T, NS, NOUT, S>& f = p.f;
    const Geo& g = f.g;
    const int plane = g.plane();
    T* pool = reinterpret_cast<T*>(smem_raw);
    T* hoist = pool + g.npool * plane;
    T* cur = hoist + NH * plane;
    T* nxt = cur + NC * plane;
    T* acc = nxt + NC * plane;  // NG planes over the owned tile
    int64_t g0[3];
    tile_origin<ND>(g, g0);
    load_planes<T, PERIODIC, NS, ND>(pool, f.in, f.in_st, g, g0, false);
    load_planes<T, PERIODIC, NC, ND>(cur, p.cot, p.cot_st, g, g0, true);
    const int tid = threadIdx.y * kThreadsX + threadIdx.x;
    for (int i = tid; i < NG * g.owned_plane(); i += kThreadsX * blockDim.y)
        acc[i] = T(0);
    __syncthreads();

    // ---- phase 1: the k forward stages, keeping the saved planes ----
    hoist_pass<T, NS, NH, ND, Hoist>(f, pool, hoist);
    forward_stages<T, NS, NOUT, ND, PERIODIC, Fwd>(f, pool, hoist, g0,
                                                   false);

    // ---- phase 2: accumulate on owned cells, advance the cotangents ----
    for (int j = 0; j < g.k; ++j) {
        const int s = g.k - 1 - j;
        const T* pbase[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) pbase[k] = pool + f.sbuf[s * NS + k] * plane;
        if constexpr (NG > 0) {
            for_rows<ND>(g.h[0], g.h[0] + g.t[0], g.h[1], g.h[1] + g.t[1],
                         [&](int lz, int ly) {
                const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
                const int lrow = (lz * g.e[1] + ly) * g.e[2];
                const int arow = ((lz - g.h[0]) * g.t[1] + ly - g.h[1]) * g.t[2]
                                 - g.h[2];
                for (int lx = g.h[2] + threadIdx.x; lx < g.h[2] + g.t[2];
                     lx += kThreadsX) {
                    const int64_t gx = g0[2] + lx;
                    T v[NG];
                    if (PERIODIC || box_inside<ND>(g, gz, gy, gx, g.lob, g.hib))
                        twin_cell<T, NS, ND, GradSlots, false, Grad, NG>(
                            pbase, cur, lrow + lx, plane, g, gz, gy, gx, v);
                    else
                        twin_cell<T, NS, ND, GradSlots, true, Grad, NG>(
                            pbase, cur, lrow + lx, plane, g, gz, gy, gx, v);
#pragma unroll
                    for (int a = 0; a < NG; ++a)
                        acc[a * g.owned_plane() + arow + lx] += v[a];
                }
            });
        }
        int lo[3], hi[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            lo[d] = (j + 1) * g.lob[d];
            hi[d] = g.e[d] - (j + 1) * g.hib[d];
        }
        for_rows<ND>(lo[0], hi[0], lo[1], hi[1], [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            const int lrow = (lz * g.e[1] + ly) * g.e[2];
            for (int lx = lo[2] + threadIdx.x; lx < hi[2]; lx += kThreadsX) {
                const int64_t gx = g0[2] + lx;
                const int idx = lrow + lx;
                T v[NC];
                if (PERIODIC || box_inside<ND>(g, gz, gy, gx, g.lob, g.hib))
                    twin_cell<T, NS, ND, CotSlots, false, Cot, NC>(
                        pbase, cur, idx, plane, g, gz, gy, gx, v);
                else
                    twin_cell<T, NS, ND, CotSlots, true, Cot, NC>(
                        pbase, cur, idx, plane, g, gz, gy, gx, v);
#pragma unroll
                for (int c = 0; c < NC; ++c) nxt[c * plane + idx] = v[c];
            }
        });
        __syncthreads();
        T* t = cur;
        cur = nxt;
        nxt = t;
    }

    const T* fin[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) fin[k] = pool + f.sbuf[g.k * NS + k] * plane;
    store_owned<T, ND, true>(f.out, f.out_st, fin, NS, g, g0);
    const T* cot0[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) cot0[c] = cur + c * plane;
    store_owned<T, ND>(p.out_cot, p.out_cot_st, cot0, NC, g, g0);
    if constexpr (NG > 0) {
        // a coefficient's cotangent: the incoming one (the identity
        // pass-through of an invariant plane) plus its accumulated gradient
        for_rows<ND>(g.h[0], g.h[0] + g.t[0], g.h[1], g.h[1] + g.t[1],
                     [&](int lz, int ly) {
            const int64_t gz = g0[0] + lz, gy = g0[1] + ly;
            if (!z_in<ND>(gz, 0, g.n[0]) || gy >= g.n[1]) return;
            const int arow = ((lz - g.h[0]) * g.t[1] + ly - g.h[1]) * g.t[2]
                             - g.h[2];
            for (int lx = g.h[2] + threadIdx.x; lx < g.h[2] + g.t[2];
                 lx += kThreadsX) {
                const int64_t gx = g0[2] + lx;
                if (gx >= g.n[2]) break;
#pragma unroll
                for (int a = 0; a < NG; ++a) {
                    const int64_t in = gz * p.gcot_st[a][0]
                                       + gy * p.gcot_st[a][1]
                                       + gx * p.gcot_st[a][2];
                    const int64_t out = gz * p.out_gcot_st[a][0]
                                        + gy * p.out_gcot_st[a][1]
                                        + gx * p.out_gcot_st[a][2];
                    psat::st(p.out_gcot[a] + out,
                             psat::ld<T>(p.gcot[a] + in)
                                 + acc[a * g.owned_plane() + arow + lx]);
                }
            }
        });
    }
}

}  // namespace psat_chain
