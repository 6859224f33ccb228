// The march kernel of the stage chains (stage_march.cuh) and its launcher.
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_stage_march_source, which defines
// PSAT_ND (2 or 3), PSAT_NS (state planes), PSAT_NC (cotangent slots; 1 in
// forward mode), PSAT_NCOT (the real count, 0 in forward mode), PSAT_NP
// (parts), PSAT_NR (rings), PSAT_TWO_PHASE, the input groups' dim-0
// extents (PSAT_A_LO0, PSAT_A_HI0, PSAT_B_LO0, PSAT_B_HI0), the input
// folds (PSAT_IN_FOLD0, PSAT_N_IN_FOLD), the threads of a block
// (PSAT_THREADS) and the blocks an SM holds (PSAT_MIN_BLOCKS: the
// registers' bound), before the header the shard mode (PSAT_SHARD and the
// wrapped march dims PSAT_WRAP0..2), `PsatProbes`, the `PsatEv<i>` event
// structs,
// `PsatRings` and the `PsatPart<x>` specialisations.  Plain C interface,
// loaded with ctypes:
//
//   int psat_march_launch(int dtype, int periodic, int device,
//       const void* state_ptrs, const void* state_st,          // PSAT_NS
//       const void* out_state_ptrs, const void* out_state_st,  // PSAT_NS
//       const void* cot_ptrs, const void* cot_st,              // PSAT_NC
//       const void* out_cot_ptrs, const void* out_cot_st,      // PSAT_NC
//       const void* probe_ptrs,  // PsatProbes::kN (k, n_last) cotangents
//                                // (two-phase) or records (forward mode)
//       const void* geo,   // int64, see stage_march.cuh::parse_march_geo
//                          // (shard mode: base[3] gn[3] at the end)
//       void* stream)
//
// A null out_state pointer is not written.  Strides are (z, y, x) per
// plane, z = 0 for a 2D domain.  One library is one float type and
// boundary mode: PSAT_S (storage), PSAT_T (compute), PSAT_DTYPE and
// PSAT_PERIODIC; another dtype or mode is refused.  Launches on `device`
// and restores the thread's current device; returns the launch's
// cudaError_t (0 on success) and does not synchronise.

namespace psat_march {

constexpr int kThreads = PSAT_THREADS;
using GeoT = MarchGeo<PSAT_NR, PSAT_NP>;
template <typename T, typename S>
using Params = MarchParams<T, PSAT_NS, PSAT_NC, PSAT_NR, PSAT_NP, S>;
template <typename T, typename S>
using CellT = Cell<T, S, GeoT, PsatRings, PSAT_ND>;

// rows [r0 + dr0, r0 + dr1) of a chunk that starts at row r0, clipped to
// [first, last)
__device__ __forceinline__ void clip(int64_t r0, int C, int64_t first,
                                     int64_t last, int& dr0, int& dr1) {
    dr0 = (int)(first > r0 ? (first - r0 < C ? first - r0 : C) : 0);
    dr1 = (int)(last < r0 + C ? (last > r0 ? last - r0 : 0) : C);
}

// Input group A (state_0 into ring 0, the invariant planes into ring 1;
// lag 0) or B (cot_k into ring 2; lag g.cot_lag): issue the copies of
// march step `tc`'s rows; rbn: the rings' slots of row tc·C.
template <typename T, typename S, bool PERIODIC, bool GROUP_A>
__device__ __forceinline__ void load_inputs(const Params<T, S>& p, T* sm,
                                            const int* rbn, int64_t tc,
                                            int64_t ty0, int64_t tx0,
                                            int64_t za, int64_t zb) {
    const GeoT& g = p.g;
    constexpr int C = PsatRings::kChunk;
    constexpr int lead = GROUP_A ? 0 : 2;
    const int64_t r0 = tc * C - (GROUP_A ? 0 : g.cot_lag);
    int dr0, dr1;
    clip(r0, C, GROUP_A ? za - PSAT_A_LO0 : za - PSAT_B_LO0,
         GROUP_A ? zb + PSAT_A_HI0 : zb + PSAT_B_HI0, dr0, dr1);
    if (dr1 <= dr0) return;
    // rings 0 and 1 share their extents
    constexpr int nvec = PsatRings::rx(lead) / kVec;
    constexpr int per_row = PsatRings::ry(lead) * nvec;
    const int items = (dr1 - dr0) * per_row;
    for (int i = threadIdx.x; i < items; i += kThreads) {
        const int dr = dr0 + i / per_row;
        const int rem = i - (dr - dr0) * per_row;
        const int ly = rem / nvec;
        const int v = rem - ly * nvec;
        const int64_t row = r0 + dr;
        const int64_t gy = ty0 - PsatRings::lo1(lead) + ly;
        const int64_t gx0 = tx0 - PsatRings::lo2(lead) + (int64_t)v * kVec;
        const int64_t srow = gsrc_dim<PERIODIC, 0>(row, g.n[0]);
        const int64_t sy = gsrc_dim<PERIODIC, 1>(gy, g.n[1]);
        const bool whole = g.wide && gx0 >= 0 && gx0 + kVec <= g.n[2];
        int64_t sx[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
            sx[e] = gsrc_dim<PERIODIC, 2>(gx0 + e, g.n[2]);
        constexpr int nplanes =
            GROUP_A ? PsatRings::kNDyn + PsatRings::kNInv : PSAT_NCOT;
#pragma unroll
        for (int q = 0; q < nplanes; ++q) {
            const bool inv = GROUP_A && q >= PsatRings::kNDyn;
            const int ring = GROUP_A ? (inv ? 1 : 0) : 2;
            const int plane = inv ? q - PsatRings::kNDyn : q;
            const int n = GROUP_A ? (inv ? PsatRings::inv(plane)
                                         : PsatRings::dyn(plane))
                                  : q;
            int slot = rbn[ring] + dr;
            if (slot >= PsatRings::depth(ring)) slot -= PsatRings::depth(ring);
            T* dst = sm + PsatRings::off(ring)
                     + ((slot * PsatRings::planes(ring) + plane)
                            * PsatRings::ry(ring) + ly)
                           * PsatRings::rx(ring)
                     + v * kVec;
            const S* base = GROUP_A ? p.in[n] : p.cot[n];
            const int64_t* st = GROUP_A ? p.in_st[n] : p.cot_st[n];
            const S* rowp = base + (PSAT_ND == 3 ? srow * st[0] + sy * st[1]
                                                 : srow * st[1]);
            if constexpr (sizeof(T) == sizeof(S)) {
                if (whole) {
#pragma unroll
                    for (int b = 0; b < (int)(kVec * sizeof(T)) / 16; ++b)
                        cp_async<16>(reinterpret_cast<char*>(dst) + 16 * b,
                                     reinterpret_cast<const char*>(
                                         rowp + gx0) + 16 * b);
                    continue;
                }
            }
#pragma unroll
            for (int e = 0; e < kVec; ++e)
                load_elem<T, S>(dst + e, rowp + sx[e] * st[2]);
        }
    }
}

// The probe cotangents of the last stage join cot_k as it arrives: each
// thread adds them to the group-B vectors it issued (and has waited for)
// on a probe row (2D; wrapped in periodic mode), at the columns in the
// domain (wrapped).
template <typename T, typename S, bool PERIODIC>
__device__ __forceinline__ void input_probes(const Params<T, S>& p, T* sm,
                                             const int* rbn, int64_t tc,
                                             int64_t tx0, int64_t za,
                                             int64_t zb) {
    if constexpr (PSAT_TWO_PHASE && PsatProbes::kN > 0) {
        const GeoT& g = p.g;
        constexpr int C = PsatRings::kChunk;
        const int64_t r0 = tc * C - g.cot_lag;
        int dr0, dr1;
        clip(r0, C, za - PSAT_B_LO0, zb + PSAT_B_HI0, dr0, dr1);
        constexpr int nvec = PsatRings::rx(2) / kVec;  // ry == 1 in 2D
        for (int dr = dr0; dr < dr1; ++dr) {
            const int row = PERIODIC ? pmod(r0 + dr, g.n[0]) : (int)(r0 + dr);
            int slot = rbn[2] + dr;
            if (slot >= PsatRings::depth(2)) slot -= PsatRings::depth(2);
            // the items of this row, in load_inputs' order of threads
            const int base = (dr - dr0) * nvec;
            int v = ((int)threadIdx.x - base) % kThreads;
            if (v < 0) v += kThreads;
            for (; v < nvec; v += kThreads) {
#pragma unroll
                for (int q = 0; q < PsatProbes::kN; ++q) {
                    if (row != g.prow[q]) continue;
                    const int plane = PsatProbes::slot(q);
                    T* dst = sm + PsatRings::off(2)
                             + (slot * PsatRings::planes(2) + plane)
                                   * PsatRings::rx(2)
                             + v * kVec;
                    const S* pc = p.probe[q]
                                  + (int64_t)PsatProbes::kLast * g.n[2];
#pragma unroll
                    for (int e = 0; e < kVec; ++e) {
                        int64_t x = tx0 - PsatRings::lo2(2) + v * kVec + e;
                        if (PERIODIC) x = gsrc<true>(x, g.n[2]);
                        else if (x < 0 || x >= g.n[2]) continue;
                        dst[e] += psat::ld<T>(pc + x);
                    }
                }
            }
        }
    }
}

// Folds F..E-1 of a host at one cell, in order (each reads what the host
// and the folds before it wrote at this cell: this thread's own writes);
// a store part writes state_k (S), cot_0 (SC) or a probe record (P)
// where the cell is owned.
template <typename T, typename S, bool PERIODIC, int F, int E>
__device__ __forceinline__ void fold_cells(const Params<T, S>& p,
                                           const CellT<T, S>& c, bool owned) {
    if constexpr (F < E) {
        using PF = PsatPart<F>;
        if constexpr (PF::kKind == kS) {
            if (owned) {
#pragma unroll
                for (int n = 0; n < PSAT_NS; ++n) {
                    if (!PsatRings::stored(n)) continue;
                    const int64_t* st = p.out_st[n];
                    psat::st(p.out[n]
                                 + (PSAT_ND == 3
                                        ? (int64_t)c.row * st[0]
                                              + (int64_t)c.gy * st[1]
                                        : (int64_t)c.row * st[1])
                                 + (int64_t)c.gx * st[2],
                             state_at<PF>(c, n, 0, 0, 0));
                }
            }
        } else if constexpr (PF::kKind == kP) {
            // record s: the probe rows (2D) or lines (3D) of state s + 1
            if (owned) {
                const int64_t line = (int64_t)c.row * c.g.n[1] + c.gy;
#pragma unroll
                for (int q = 0; q < PsatProbes::kN; ++q) {
                    if (line != c.g.prow[q]) continue;
                    psat::st(p.rec[q] + (int64_t)PF::kProbeStage * c.g.n[2]
                                 + c.gx,
                             state_at<PF>(c, PsatProbes::plane(q), 0, 0, 0));
                }
            }
        } else if constexpr (PF::kKind == kSC) {
            if (owned) {
#pragma unroll
                for (int m = 0; m < PSAT_NCOT; ++m) {
                    const int64_t* st = p.out_cot_st[m];
                    psat::st(p.out_cot[m]
                                 + (PSAT_ND == 3
                                        ? (int64_t)c.row * st[0]
                                              + (int64_t)c.gy * st[1]
                                        : (int64_t)c.row * st[1])
                                 + (int64_t)c.gx * st[2],
                             cot_at<PF>(c, m, 0, 0, 0));
                }
            }
        } else {
            part_cell<T, PF, PSAT_ND, PSAT_NC, PERIODIC>(c);
        }
        fold_cells<T, S, PERIODIC, F + 1, E>(p, c, owned);
    }
}

// The lead pointwise BCs of the first cycle, folded into the input load:
// each thread runs them on the cells whose group-A copies it issued (and
// has waited for), in order, writing their outputs into ring 0.
template <typename T, typename S, bool PERIODIC>
__device__ __forceinline__ void input_folds(const Params<T, S>& p, T* sm,
                                            const int* rbn, int64_t tc,
                                            int64_t ty0, int64_t tx0,
                                            int64_t za, int64_t zb) {
    if constexpr (PSAT_N_IN_FOLD > 0) {
        const GeoT& g = p.g;
        constexpr int C = PsatRings::kChunk;
        const int64_t r0 = tc * C;
        int dr0, dr1;
        clip(r0, C, za - PSAT_A_LO0, zb + PSAT_A_HI0, dr0, dr1);
        if (dr1 <= dr0) return;
        constexpr int nvec = PsatRings::rx(0) / kVec;
        constexpr int per_row = PsatRings::ry(0) * nvec;
        const int items = (dr1 - dr0) * per_row;
        for (int i = threadIdx.x; i < items; i += kThreads) {
            const int dr = dr0 + i / per_row;
            const int rem = i - (dr - dr0) * per_row;
            const int ly = rem / nvec;
            const int v = rem - ly * nvec;
            const int cy = ly - PsatRings::lo1(0);
            for (int e = 0; e < kVec; ++e) {
                const int cx = v * kVec + e - PsatRings::lo2(0);
                const CellT<T, S> c{g, sm, rbn, 0, dr, cy, cx,
                                    (int)(r0 + dr), (int)(ty0 + cy),
                                    (int)(tx0 + cx), p.probe};
                fold_cells<T, S, PERIODIC, PSAT_IN_FOLD0,
                           PSAT_IN_FOLD0 + PSAT_N_IN_FOLD>(p, c, false);
            }
        }
    }
}

// Host part H, then its folds, at every cell of H's region on rows
// [dr0, dr1) of the chunk; the cells are dealt out to the threads in turn.
template <typename T, typename S, bool PERIODIC, int H>
__device__ __forceinline__ void run_cells(const Params<T, S>& p, T* sm,
                                          const int* rb, int64_t r0,
                                          int dr0, int dr1, int64_t ty0,
                                          int64_t tx0, int64_t za,
                                          int64_t zb) {
    using PH = PsatPart<H>;
    const GeoT& g = p.g;
    constexpr int ry = PsatRings::kT0 + PH::elo(1) + PH::ehi(1);
    constexpr int rx = PsatRings::kT1 + PH::elo(2) + PH::ehi(2);
    constexpr int per_row = ry * rx;
    // this step's ring slots (a copy the parts' stores to the rings cannot
    // alias)
    int rbl[PSAT_NR];
#pragma unroll
    for (int r = 0; r < PSAT_NR; ++r) rbl[r] = rb[r];
    // the thread's first cell and its stride as steps of (chunk row, y,
    // x): no division per cell
    constexpr int srem = kThreads % per_row, sly = srem / rx;
    constexpr int sdr = kThreads / per_row, slx = srem - sly * rx;
    const int rem = (int)threadIdx.x % per_row;
    int dr = dr0 + (int)threadIdx.x / per_row, ly = rem / rx;
    int lx = rem - ly * rx;
    while (dr < dr1) {
        const int cy = ly - PH::elo(1), cx = lx - PH::elo(2);
        const CellT<T, S> c{g, sm, rbl, PsatRings::plag(H), dr, cy, cx,
                            (int)(r0 + dr),
                            (int)(ty0 + cy), (int)(tx0 + cx), p.probe};
        const bool owned = c.row >= za && c.row < zb && cy >= 0
                           && cy < PsatRings::kT0 && cx >= 0
                           && cx < PsatRings::kT1
                           && c.gy < g.n[1] && c.gx < g.n[2];
        part_cell<T, PH, PSAT_ND, PSAT_NC, PERIODIC>(c);
        fold_cells<T, S, PERIODIC, H + 1, H + 1 + PH::kNFold>(p, c, owned);
        dr += sdr;
        ly += sly;
        lx += slx;
        if (lx >= rx) {
            lx -= rx;
            ++ly;
        }
        if (ly >= ry) {
            ly -= ry;
            ++dr;
        }
    }
}

// The parts from X on at march step t: each host part on its lagged rows
// (clipped to its dim-0 extents around the segment), its folds on the
// same cells, then a barrier where a later part reads what this pass
// wrote (kSync; the step's closing barrier follows the last part).
template <typename T, typename S, bool PERIODIC, int X>
__device__ __forceinline__ void run_parts(const Params<T, S>& p, T* sm,
                                          const int* rb, int64_t t,
                                          int64_t ty0, int64_t tx0,
                                          int64_t za, int64_t zb) {
    if constexpr (X < PSAT_NP) {
        using P = PsatPart<X>;
        if constexpr (P::kKind != kFold && P::kKind != kRFold
                      && P::kKind != kS && P::kKind != kSC) {
            constexpr int C = PsatRings::kChunk;
            const int64_t r0 = t * C - PsatRings::plag(X);
            int dr0, dr1;
            clip(r0, C, za - P::elo(0), zb + P::ehi(0), dr0, dr1);
            if (dr1 > dr0)
                run_cells<T, S, PERIODIC, X>(p, sm, rb, r0, dr0, dr1, ty0,
                                             tx0, za, zb);
            if constexpr (P::kSync) __syncthreads();
        }
        run_parts<T, S, PERIODIC, X + 1>(p, sm, rb, t, ty0, tx0, za, zb);
    }
}

// TWO_PHASE names kernel 13 apart from kernel 12 in device traces
template <typename T, typename S, bool PERIODIC,
          bool TWO_PHASE = PSAT_TWO_PHASE != 0>
__global__ void __launch_bounds__(kThreads, PSAT_MIN_BLOCKS)
stage_march(const __grid_constant__ Params<T, S> p) {
    extern __shared__ unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    const GeoT& g = p.g;
    unsigned b = blockIdx.x;
    const unsigned tx = b % (unsigned)g.nt[1];
    b /= (unsigned)g.nt[1];
    const unsigned ty = b % (unsigned)g.nt[0];
    const unsigned seg = b / (unsigned)g.nt[0];
    const int64_t ty0 = (int64_t)ty * PsatRings::kT0;
    const int64_t tx0 = (int64_t)tx * PsatRings::kT1;
    const int64_t za = (int64_t)seg * g.zlen;
    const int64_t zb = za + g.zlen < g.n[0] ? za + g.zlen : g.n[0];
    constexpr int C = PsatRings::kChunk;
    const int64_t t0 = floor_div(za + g.tlo, C);
    const int64_t t1 = floor_div(zb + g.thi - 1, C) + 1;
    // the rings' slots of row t·C, in every thread's registers
    int rbt[PSAT_NR];
#pragma unroll
    for (int r = 0; r < PSAT_NR; ++r) rbt[r] = pmod(t0 * C, PsatRings::depth(r));
    // prologue: the first step's inputs
    load_inputs<T, S, PERIODIC, true>(p, sm, rbt, t0, ty0, tx0, za, zb);
    if constexpr (PSAT_TWO_PHASE)
        load_inputs<T, S, PERIODIC, false>(p, sm, rbt, t0, ty0, tx0, za, zb);
    cp_commit();
    cp_wait_all();
    input_folds<T, S, PERIODIC>(p, sm, rbt, t0, ty0, tx0, za, zb);
    input_probes<T, S, PERIODIC>(p, sm, rbt, t0, tx0, za, zb);
    __syncthreads();
    for (int64_t t = t0; t < t1; ++t) {
        // the next step's slots of the input rings
        int rbn[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            if (r >= PSAT_NR) continue;
            const int d = PsatRings::depth(r);
            rbn[r] = rbt[r] + C >= d ? rbt[r] + C - d : rbt[r] + C;
        }
        if (t + 1 < t1) {
            load_inputs<T, S, PERIODIC, true>(p, sm, rbn, t + 1, ty0, tx0,
                                              za, zb);
            if constexpr (PSAT_TWO_PHASE)
                load_inputs<T, S, PERIODIC, false>(p, sm, rbn, t + 1, ty0,
                                                   tx0, za, zb);
            cp_commit();
        }
        run_parts<T, S, PERIODIC, 0>(p, sm, rbt, t, ty0, tx0, za, zb);
        cp_wait_all();
        if (t + 1 < t1) {
            input_folds<T, S, PERIODIC>(p, sm, rbn, t + 1, ty0, tx0, za, zb);
            input_probes<T, S, PERIODIC>(p, sm, rbn, t + 1, tx0, za, zb);
        }
#pragma unroll
        for (int r = 0; r < PSAT_NR; ++r) {
            rbt[r] += C;
            if (rbt[r] >= PsatRings::depth(r)) rbt[r] -= PsatRings::depth(r);
        }
        __syncthreads();
    }
}

}  // namespace psat_march

template <typename T, int N>
static void psat_march_planes(const void* ptrs, const void* st, T** dst,
                              int64_t (*dst_st)[3]) {
    const void* const* p = static_cast<const void* const*>(ptrs);
    const int64_t* s = static_cast<const int64_t*>(st);
    for (int k = 0; k < N; ++k) {
        dst[k] = static_cast<T*>(const_cast<void*>(p[k]));
        for (int d = 0; d < 3; ++d) dst_st[k][d] = s[3 * k + d];
    }
}

template <typename T, typename S, bool PERIODIC>
static cudaError_t psat_march_launch_t(const void* const* a,
                                       const int64_t* geo,
                                       cudaStream_t stream) {
    using namespace psat_march;
    Params<T, S> p;
    if (!parse_march_geo<PSAT_NR, PSAT_NP, PSAT_ND>(geo, PSAT_NR,
                                                    PsatProbes::kN, p.g))
        return cudaErrorInvalidValue;
    // the march this library was generated for
    bool same = p.g.chunk == PsatRings::kChunk && p.g.t[0] == PsatRings::kT0
                && p.g.t[1] == PsatRings::kT1;
    for (int r = 0; r < PSAT_NR; ++r) {
        const Ring& R = p.g.ring[r];
        same = same && R.off == PsatRings::off(r)
               && R.depth == PsatRings::depth(r) && R.ry == PsatRings::ry(r)
               && R.rx == PsatRings::rx(r) && R.lag == PsatRings::rlag(r);
    }
    for (int x = 0; x < PSAT_NP; ++x)
        same = same && p.g.lag[x] == PsatRings::plag(x);
    if (!same) return cudaErrorInvalidValue;
    S* tmp[PSAT_NS > PSAT_NC ? PSAT_NS : PSAT_NC];
    psat_march_planes<S, PSAT_NS>(a[0], a[1], tmp, p.in_st);
    for (int k = 0; k < PSAT_NS; ++k) p.in[k] = tmp[k];
    psat_march_planes<S, PSAT_NS>(a[2], a[3], p.out, p.out_st);
    for (int k = 0; k < PSAT_NC; ++k) {
        p.cot[k] = nullptr;
        p.out_cot[k] = nullptr;
        for (int d = 0; d < 3; ++d) p.cot_st[k][d] = p.out_cot_st[k][d] = 0;
    }
    if (PSAT_NCOT > 0) {
        psat_march_planes<S, PSAT_NCOT>(a[4], a[5], tmp, p.cot_st);
        for (int k = 0; k < PSAT_NCOT; ++k) p.cot[k] = tmp[k];
        psat_march_planes<S, PSAT_NCOT>(a[6], a[7], p.out_cot, p.out_cot_st);
    }
    // the probe tensors: cotangents (two-phase mode) or records (forward)
    const void* const* pr = static_cast<const void* const*>(a[8]);
    for (int q = 0; q < kMaxProbes; ++q) {
        S* t = q < PsatProbes::kN ? static_cast<S*>(const_cast<void*>(pr[q]))
                                  : nullptr;
        p.probe[q] = PSAT_TWO_PHASE ? t : nullptr;
        p.rec[q] = PSAT_TWO_PHASE ? nullptr : t;
    }
    const size_t bytes = (size_t)p.g.smem * sizeof(T);
    auto kernel = stage_march<T, S, PERIODIC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (int64_t)p.g.nt[0] * p.g.nt[1] * p.g.nseg;
    if (blocks < 1 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
}

extern "C" int psat_march_launch(int dtype, int periodic, int device,
                                 const void* state_ptrs, const void* state_st,
                                 const void* out_state_ptrs,
                                 const void* out_state_st,
                                 const void* cot_ptrs, const void* cot_st,
                                 const void* out_cot_ptrs,
                                 const void* out_cot_st,
                                 const void* probe_ptrs, const void* geo,
                                 void* stream) {
    const void* a[9] = {state_ptrs, state_st, out_state_ptrs, out_state_st,
                        cot_ptrs, cot_st, out_cot_ptrs, out_cot_st,
                        probe_ptrs};
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
            return cudaErrorInvalidValue;
        return psat_march_launch_t<PSAT_T, PSAT_S, PSAT_PERIODIC != 0>(
            a, g, s);
    });
}

// Registers a thread of the kernel uses (the reckoning weighs two resident
// blocks per SM where they fit), or -1.
extern "C" int psat_march_regs(int device) {
    cudaFuncAttributes attr;
    int regs = -1;
    psat::on_device(device, [&]() -> cudaError_t {
        const cudaError_t err = cudaFuncGetAttributes(
            &attr, psat_march::stage_march<PSAT_T, PSAT_S,
                                           PSAT_PERIODIC != 0>);
        if (err == cudaSuccess) regs = attr.numRegs;
        return err;
    });
    return regs;
}

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The uniform entry of the leaf launch op (csrc/launch_op.cpp, and every
// eager launch: ops/launch.py): the launcher's leading integers in `s`,
// its pointer arguments in `a`.
extern "C" int psat_call(int device, const int64_t* s, const void* const* a,
                         void* stream) {
    return psat_march_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4],
                             a[5], a[6], a[7], a[8], a[9], stream);
}
