// The stage chains as one dim-0 march on a Hopper GPU: kernel 12 (forward
// mode) and kernel 13 (two-phase mode), the hand-written CUDA ports of the
// Pallas kernels pystencils_autodiff_tpu/ops/stage_chain.py::
// _make_stage_chain_kernel and pystencils_autodiff_tpu/ops/stage_adjoint.py::
// fused_stage_chain_vjp.  Its two-phase mode, over a time chain seen as a
// one-stage cycle repeated k times (ops/stage_march.py::chain_march_plans),
// also ports pystencils_autodiff_tpu/ops/adjoint_chain.py::fused_chain_vjp
// (`build`, 2D: row 8) and pystencils_autodiff_tpu/ops/twin_adjoint.py::
// make_plane_twin_accum_vjp_fn (3D: row 11; plain version
// ops/adjoint_chain.py::plain_chain_vjp).
//
// Contract: forward mode computes state_k of k cycles of the stage
// sequence with its in-chain BC events (plain version ops/stage_chain.py::
// plain_stage_chain); two-phase mode also cot_0, the exact VJP of those
// cycles (plain version ops/stage_adjoint.py::plain_stage_chain_vjp),
// ghost cells included, with the semantics of the box design
// (stage_chain.cuh, stage_adjoint.cuh): a stage is zero outside its
// interior window (bounded mode) or wraps every read (periodic, 2D); a
// backward read of output o reads the sum of the cotangents of the planes
// o is carried into, 0 outside the stage's window tested at the cell READ
// (the exact-VJP mask), and an out-of-domain primal read is 1; every BC
// kind has its chain_bc.cuh forward and transpose.
//
// Design (host: ops/stage_march.py, which writes the tables).  The TPU
// kernels hold whole rows in VMEM and tile dim 0.  A box tile here pays
// the halo of every event in every dim and kept every plane over it (the
// PR 4 design owned 0.13 of its tile on the cavity).  So a block owns a
// lateral tile (2D: a strip of columns; 3D: a (y, x) tile) and a segment
// [za, zb) of dim 0 and MARCHES through it, C rows (planes) a step.  The
// chain is a list of parts, run in order at every march step t, part X on
// rows t·C − lag[X] + [0, C) over its lateral region (the owned tile
// widened by what the later parts read of it):
//   - F (a stage's forward body) and B (a BC event that reads neighbours),
//     then S (state_k for the owned cells); in two-phase mode the events
//     walked back: R (a stage's backward program: the gather form) or L
//     (the local VJP at every write cell into w rows) and G (the gather of
//     the w slots: the local form), BR (a BC's transpose), then SC (cot_0);
//   - P (forward mode, a time chain's one-stage cycle): record s of each
//     probe, its row (2D) or line along x (3D) of state s + 1, stored at
//     the owned cells of stage s's pass (time_chain.plain_time_chain's
//     probes; a halo row of a neighbouring segment stores nothing);
//   - FOLD / RFOLD: a pointwise BC event (dirichlet, masked_dirichlet,
//     sponge) and its transpose run at the cell in the epilogue of the part
//     before them, with no ring, pass or barrier of their own; the lead BCs
//     of the first cycle fold into the input load.
// Each part writes its outputs into a ring of rows of its own (a fold into
// its host's ring); every read goes through the part's tables, which name
// for each state plane (src) and cotangent slot (csrc) the ring and plane
// that hold it, so carries and pass-through cotangents are renames.  Lags
// make every row a part reads computed before it is read; a ring is as
// deep as its readers' dim-0 reach plus their lag behind the writer plus a
// chunk.  The inputs — state_0 with the chain-invariant planes (group A,
// lag 0) and cot_k (group B, lag cot_lag) — arrive in input rings by
// cp.async issued one step ahead (16-byte copies where the host found the
// strides aligned; bf16 storage is converted by plain loads).  A barrier
// follows a part only where a later part of the step reads a ring written
// since the last one.  Probe rows in two-phase mode (a time chain's, 2D):
// the cotangent of stage s's probe joins the cotangent of state s + 1 on
// its row — as cot_k arrives for the last stage, in the epilogue of the
// reverse part that writes it for the others.  Everything but the shape's extent, the
// segments and the probe rows is a constant of the generated source: the
// parts' tables, and the march's geometry (chunk, tile, ring offsets,
// depths — powers of two — and widths, lags), so a ring read costs its
// slot's add and mask and one shared load; each thread keeps the step's
// ring slots in registers.  256-, 512- or 1024-thread blocks (PSAT_THREADS), as many
// resident on an SM as the reckoning found their registers and rings fit.
//
// Shard mode (PSAT_SHARD, ops/flatten.py::ShardSpec; parallel/chain.py::
// ShardedChain, the port of the JAX kernels' `shard=`): the domain is one
// halo-extended block of a sharded global domain.  Every interior,
// exact-VJP and in-domain test, and every BC event's frame, takes the
// cell's global coordinate — block coordinate plus the shard's base
// offset — against the global extents, so an interior shard's exchanged
// halo stays live for the early steps and only the global ghost frame is
// masked.  A sharded dim is read bounded-style (its wrap arrived by the
// exchange); a dim a periodic domain keeps whole still wraps (PSAT_WRAPd,
// march dims).  Bases and global extents are arguments of the launch (the
// geo block's tail), never constants of the source: one library serves
// every shard of a chain.  No probe rows (the host raises).
//
// Bound.  Per call the kernel reads state_0 (and cot_k) once and writes
// state_k (and cot_0) once, every intermediate on chip: bytes bound it
// (PERF.md rows 8, 11, 12 and 13).  What it pays: the lateral halo's
// redundant work (the owned share of the widest region), a part's setup
// and barrier each step, shared-memory latency on every read, and one
// thread's 1–3 cells a part and step against light bodies (the wave's 15
// and 33 operations).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_bc.cuh"
#include "on_device.cuh"

// Part x of the march, emitted per chain by codegen/cuda_printer.py::
// generate_stage_march_source: its kind, event type, output ring and
// planes, lag and extents, and its tables (where each state plane and
// cotangent slot lives, which slots it writes) as constexpr functions, so
// that every read's ring and plane fold into the code.
template <int X>
struct PsatPart;

// The shard mode and, in it, the march dims a periodic chain wraps (the
// generated source defines them before this header; a library without
// them is unsharded and wraps every dim of a periodic chain).
#ifndef PSAT_SHARD
#define PSAT_SHARD 0
#define PSAT_WRAP0 1
#define PSAT_WRAP1 1
#define PSAT_WRAP2 1
#endif

namespace psat_march {

constexpr bool kShard = PSAT_SHARD != 0;
// (a function, not an array: device code may not read a host array)
__host__ __device__ constexpr bool wrap_dim(int d) {
    return d == 0 ? PSAT_WRAP0 != 0 : (d == 1 ? PSAT_WRAP1 != 0
                                              : PSAT_WRAP2 != 0);
}
constexpr int kVec = 4;  // input rings: whole vectors of 4 elements
constexpr int kMaxProbes = 4;

enum PartKind : int {
    kF = 0, kB = 1, kR = 2, kL = 3, kG = 4, kBR = 5, kS = 6, kSC = 7,
    kFold = 8, kRFold = 9, kP = 10
};

// What depends on the shape: a ring's offset (elements), depth (rows),
// lateral extents (ry × rx cells a row) and its writer's lag; each part's
// lag.
struct Ring {
    int off, depth, ry, rx, lag;
};

template <int NR, int NP>
struct MarchGeo {
    int64_t n[3];    // (march, y, x); 2D: (n0, 1, n1)
    int ni[3];       // the same in 32 bits: cell coordinates are ints
    int64_t nbc[3];  // the BC templates' (z, y, x) domain; 2D: (1, n0, n1)
    int t[2], nt[2];
    int nseg, zlen, chunk, wide;
    int64_t smem;  // elements
    int tlo, thi;  // a segment [za, zb) marches steps t·C in [za+tlo, zb+thi)
    int cot_lag;   // the cot_k input ring's
    Ring ring[NR];
    int lag[NP];
    int nprobe;  // probe rows: 2D, rows of dim 0; 3D, flattened (z·n1 + y)
    int64_t prow[kMaxProbes];
    // shard mode: the block's base offset and the global extents (march
    // coordinates), the BC templates' global (z, y, x) domain
    int base[3], gn[3];
    int64_t gnbc[3];
};

// geo (ops/stage_march.py::_finish): n[3] t[2] nt[2] nseg zlen chunk wide
//   smem tlo thi cot_lag (off depth ry rx lag) * nrings lag[nparts]
//   nprobe prow[nprobe]
template <int NR, int NP, int ND>
inline bool parse_march_geo(const int64_t* geo, int nrings, int nprobes,
                            MarchGeo<NR, NP>& g) {
    int i = 0;
    for (int d = 0; d < 3; ++d) g.n[d] = geo[i++];
    for (int d = 0; d < 2; ++d) g.t[d] = (int)geo[i++];
    for (int d = 0; d < 2; ++d) g.nt[d] = (int)geo[i++];
    g.nseg = (int)geo[i++];
    g.zlen = (int)geo[i++];
    g.chunk = (int)geo[i++];
    g.wide = (int)geo[i++];
    g.smem = geo[i++];
    g.tlo = (int)geo[i++];
    g.thi = (int)geo[i++];
    g.cot_lag = (int)geo[i++];
    if (nrings != NR || g.chunk < 1 || g.t[0] < 1 || g.t[1] < 1
        || g.zlen < 1)
        return false;
    for (int d = 0; d < 3; ++d) {
        // virtual coordinates reach a halo beyond the domain
        if (g.n[d] < 1 || g.n[d] > 0x3fffffff) return false;
        g.ni[d] = (int)g.n[d];
    }
    if (ND == 2) {
        g.nbc[0] = 1; g.nbc[1] = g.n[0]; g.nbc[2] = g.n[2];
    } else {
        for (int d = 0; d < 3; ++d) g.nbc[d] = g.n[d];
    }
    for (int r = 0; r < NR; ++r) {
        Ring& R = g.ring[r];
        R.off = (int)geo[i++];
        R.depth = (int)geo[i++];
        R.ry = (int)geo[i++];
        R.rx = (int)geo[i++];
        R.lag = (int)geo[i++];
        if (R.depth < g.chunk || R.ry < 1 || R.rx < 1) return false;
    }
    for (int x = 0; x < NP; ++x) g.lag[x] = (int)geo[i++];
    g.nprobe = (int)geo[i++];
    if (g.nprobe != nprobes || g.nprobe > kMaxProbes) return false;
    for (int q = 0; q < g.nprobe; ++q) {
        g.prow[q] = geo[i++];
        if (g.prow[q] < 0 || g.prow[q] >= g.n[0] * g.n[1]) return false;
    }
    for (int d = 0; d < 3; ++d) {
        g.base[d] = 0;
        g.gn[d] = g.ni[d];
        g.gnbc[d] = g.nbc[d];
    }
    if (kShard) {
        // geo tail: base[3] gn[3] (march coordinates)
        for (int d = 0; d < 3; ++d) {
            const int64_t b = geo[i++];
            if (b < -0x3fffffff || b > 0x3fffffff) return false;
            g.base[d] = (int)b;
        }
        for (int d = 0; d < 3; ++d) {
            const int64_t n = geo[i++];
            if (n < 1 || n > 0x3fffffff) return false;
            g.gn[d] = (int)n;
        }
        if (ND == 2) {
            g.gnbc[0] = 1; g.gnbc[1] = g.gn[0]; g.gnbc[2] = g.gn[2];
        } else {
            for (int d = 0; d < 3; ++d) g.gnbc[d] = g.gn[d];
        }
        if (nprobes != 0) return false;
    }
    return true;
}

template <typename T, int NS, int NC, int NR, int NP, typename S>
struct MarchParams {
    MarchGeo<NR, NP> g;
    const S* in[NS];
    int64_t in_st[NS][3];
    S* out[NS];  // null: a chain-invariant plane, not written
    int64_t out_st[NS][3];
    const S* cot[NC];
    int64_t cot_st[NC][3];
    S* out_cot[NC];
    int64_t out_cot_st[NC][3];
    // (k, n_last) each, contiguous: the probe cotangents (two-phase mode)
    // and the probe records (forward mode)
    const S* probe[kMaxProbes];
    S* rec[kMaxProbes];
};

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int pmod(int64_t a, int64_t b) {
    const int64_t r = a % b;
    return (int)(r < 0 ? r + b : r);
}

// a coordinate of device memory: wrapped (periodic) or clamped (bounded)
template <bool PERIODIC>
__device__ __forceinline__ int64_t gsrc(int64_t c, int64_t n) {
    if (PERIODIC) {
        c %= n;
        return c < 0 ? c + n : c;
    }
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

// the same along march dim D: a periodic chain wraps the dims a shard
// keeps whole (every dim, unsharded)
template <bool PERIODIC, int D>
__device__ __forceinline__ int64_t gsrc_dim(int64_t c, int64_t n) {
    return gsrc<PERIODIC && wrap_dim(D)>(c, n);
}

// An emitted read names its offsets in the program's dims; in march
// coordinates (d0 the march dim) they are (m0, m1, m2).
template <int ND>
__device__ __forceinline__ void march_off(int o0, int o1, int o2, int& m0,
                                          int& m1, int& m2) {
    if (ND == 3) { m0 = o0; m1 = o1; m2 = o2; }
    else { m0 = o0; m1 = 0; m2 = o1; }
}

// The cell a part works at: row dr of its chunk, tile-relative lateral
// coordinates and virtual global coordinates (march row, y, x).  Row r of
// a ring lives in slot (r + lag of its writer) mod depth, and rb[r] is
// (t·C) mod depth this step, so a read needs no division: the slot of the
// reader's row t·C − lag + dr + m0 is rb + (writer lag − reader lag) + dr
// + m0 masked by depth − 1 (every depth is a power of two).  The ring's
// planes, lateral origin, offset, depth, widths and writer lag and the
// reader's lag are constants of the generated source (Rings), so a read
// costs the slot's add and mask and one shared load.
template <typename T, typename S, typename GeoT, typename Rings, int ND>
struct Cell {
    const GeoT& g;
    T* sm;
    const int* rb;
    int lag;  // the reading part's
    int dr, cy, cx;
    int row, gy, gx;
    const S* const* probe;

    __device__ __forceinline__ T& at(int r, int plane, int m0, int m1,
                                     int m2) const {
        // depths are whole powers of two: the slot is a mask
        const int s = (rb[r] + (Rings::rlag(r) - lag) + dr + m0)
                      & (Rings::depth(r) - 1);
        const int row = ND == 3 ? (s * Rings::planes(r) + plane) * Rings::ry(r)
                                      + (cy + m1 + Rings::lo1(r))
                                : s * Rings::planes(r) + plane;  // ry == 1
        return sm[Rings::off(r) + row * Rings::rx(r)
                  + (cx + m2 + Rings::lo2(r))];
    }
    // the cell's coordinates and the extents the masks test: global ones
    // in shard mode (block coordinate + base), the block's otherwise
    __device__ __forceinline__ int grow() const {
        if constexpr (kShard) return row + g.base[0];
        else return row;
    }
    __device__ __forceinline__ int ggy() const {
        if constexpr (kShard) return gy + g.base[1];
        else return gy;
    }
    __device__ __forceinline__ int ggx() const {
        if constexpr (kShard) return gx + g.base[2];
        else return gx;
    }
    __device__ __forceinline__ int gext(int d) const {
        if constexpr (kShard) return g.gn[d];
        else return g.ni[d];
    }
    __device__ __forceinline__ bool in_domain(int m0, int m1, int m2) const {
        const int r = grow() + m0, y = ggy() + m1, x = ggx() + m2;
        return r >= 0 && r < gext(0) && y >= 0 && y < gext(1) && x >= 0
               && x < gext(2);
    }
};

// Is the cell at march offset (m0, m1, m2) inside stage Ev's interior
// window (march-coordinate ghost widths mlo/mhi)?
template <typename Ev, typename C>
__device__ __forceinline__ bool interior(const C& c, int m0, int m1,
                                         int m2) {
    const int r = c.grow() + m0, y = c.ggy() + m1, x = c.ggx() + m2;
    return r >= Ev::mlo(0) && r < c.gext(0) - Ev::mhi(0) && y >= Ev::mlo(1)
           && y < c.gext(1) - Ev::mhi(1) && x >= Ev::mlo(2)
           && x < c.gext(2) - Ev::mhi(2);
}

// state plane n (as part P reads it: before its event) and cotangent slot
// m (after its event) at a march offset
template <typename P, typename C>
__device__ __forceinline__ auto& state_at(const C& c, int n, int m0, int m1,
                                          int m2) {
    return c.at(P::sr(n), P::sp(n), m0, m1, m2);
}
template <typename P, typename C>
__device__ __forceinline__ auto& cot_at(const C& c, int m, int m0, int m1,
                                        int m2) {
    return c.at(P::cr(m), P::cp(m), m0, m1, m2);
}

// Reader of a stage's forward body: input slot j is state plane Ev::in(j)
template <typename T, typename C, typename P, int ND>
struct FwdRd {
    const C& c;
    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        int m0, m1, m2;
        march_off<ND>(o0, o1, o2, m0, m1, m2);
        return state_at<P>(c, P::Ev::in(j), m0, m1, m2);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        return rp(j, o0, o1, o2);
    }
};

// Reader of the chain_bc.cuh templates: r.rd (state before the event),
// r.rc (cotangent after it), in their (z, y, x) convention (2D: z = 0).
template <typename T, typename C, typename P, int ND>
struct BcRd {
    const C& c;
    int64_t gc[3];
    const int64_t* n;
    __device__ __forceinline__ void off(int dz, int dy, int dx, int& m0,
                                        int& m1, int& m2) const {
        if (ND == 3) { m0 = dz; m1 = dy; m2 = dx; }
        else { m0 = dy; m1 = 0; m2 = dx; }
    }
    __device__ __forceinline__ T rd(int sp, int dz, int dy, int dx) const {
        int m0, m1, m2;
        off(dz, dy, dx, m0, m1, m2);
        return state_at<P>(c, sp, m0, m1, m2);
    }
    __device__ __forceinline__ T rc(int cs, int dz, int dy, int dx) const {
        int m0, m1, m2;
        off(dz, dy, dx, m0, m1, m2);
        return cot_at<P>(c, cs, m0, m1, m2);
    }
    __device__ __forceinline__ bool in_domain() const {
        return gc[0] >= 0 && gc[0] < n[0] && gc[1] >= 0 && gc[1] < n[1]
               && gc[2] >= 0 && gc[2] < n[2];
    }
};

template <typename T, typename P, int ND, typename C>
__device__ __forceinline__ BcRd<T, C, P, ND> bc_reader(const C& c) {
    BcRd<T, C, P, ND> r{c, {0, 0, 0}, kShard ? c.g.gnbc : c.g.nbc};
    if (ND == 3) { r.gc[0] = c.grow(); r.gc[1] = c.ggy(); r.gc[2] = c.ggx(); }
    else { r.gc[0] = 0; r.gc[1] = c.grow(); r.gc[2] = c.ggx(); }
    return r;
}

// Reader of a stage's backward program (the gather form).  MASKED: bounded
// mode at a cell whose backward stencil leaves the stage's window.
template <typename T, typename C, typename P, int ND, bool MASKED>
struct BwdRd {
    const C& c;
    using Ev = typename P::Ev;
    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        int m0, m1, m2;
        march_off<ND>(o0, o1, o2, m0, m1, m2);
        const int n = Ev::prim(j);
        const T v = state_at<P>(c, n < 0 ? 0 : n, m0, m1, m2);
        if (!MASKED) return v;
        return c.in_domain(m0, m1, m2) ? v : T(1);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        int m0, m1, m2;
        march_off<ND>(o0, o1, o2, m0, m1, m2);
        const int c0 = Ev::adj(j, 0);
        if (c0 < 0) return T(0);
        T v = cot_at<P>(c, c0, m0, m1, m2);
#pragma unroll
        for (int q = 1; q < Ev::kMaxAdj; ++q) {
            const int m = Ev::adj(j, q);
            if (m >= 0) v += cot_at<P>(c, m, m0, m1, m2);
        }
        if (!MASKED) return v;
        return interior<Ev>(c, m0, m1, m2) ? v : T(0);
    }
};

// Reader of the local-VJP body (the L part): slot j < kNIn is state plane
// Ev::in(j) at a forward offset; slot kNIn + o the cotangent of forward
// output o at the cell, the sum of its carriers' cotangents.
template <typename T, typename C, typename P, int ND>
struct LocRd {
    const C& c;
    using Ev = typename P::Ev;
    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        int m0, m1, m2;
        march_off<ND>(o0, o1, o2, m0, m1, m2);
        return state_at<P>(c, Ev::in(j), m0, m1, m2);
    }
    __device__ __forceinline__ T ra(int j, int, int, int) const {
        const int o = j - Ev::kNIn;
        const int c0 = Ev::car(o, 0);
        if (c0 < 0) return T(0);
        T v = cot_at<P>(c, c0, 0, 0, 0);
#pragma unroll
        for (int q = 1; q < Ev::kMaxCar; ++q) {
            const int m = Ev::car(o, q);
            if (m >= 0) v += cot_at<P>(c, m, 0, 0, 0);
        }
        return v;
    }
};

// Reader of the gather body (the G part): w slot a of its L part's ring
template <typename T, typename C, typename P, int ND>
struct GthRd {
    const C& c;
    __device__ __forceinline__ T w_at(int a, int o0, int o1, int o2) const {
        int m0, m1, m2;
        march_off<ND>(o0, o1, o2, m0, m1, m2);
        return c.at(P::kWRing, a, m0, m1, m2);
    }
};

// The probe cotangents of stage s that join cotangent slot m at the cell:
// every probe of slot m whose row the cell's row is (wrapped, in periodic
// mode; 2D), at its column (wrapped, or none outside the domain).
template <typename T, typename Probes, bool PERIODIC, typename C>
__device__ __forceinline__ T probe_cot(const C& c, int m, int s) {
    T v = T(0);
#pragma unroll
    for (int q = 0; q < Probes::kN; ++q) {
        if (Probes::slot(q) != m) continue;
        int row = c.row, x = c.gx;
        if (PERIODIC) {
            row = pmod(row, c.g.ni[0]);
            x = pmod(x, c.g.ni[2]);
        } else if (x < 0 || x >= c.g.ni[2]) {
            continue;
        }
        if (row == c.g.prow[q])
            v += psat::ld<T>(c.probe[q] + (int64_t)s * c.g.n[2] + x);
    }
    return v;
}

// ---- one part at one cell, by kind ---------------------------------------

template <typename T, typename P, int ND, int NC, bool PERIODIC, typename C>
__device__ __forceinline__ void put(const C& c, int j, T v) {
    c.at(P::kRing, P::op(j), 0, 0, 0) = v;
}

// the pass-through cotangents into slot m (the stage-carry transpose)
template <typename T, typename P, typename C>
__device__ __forceinline__ T passed(const C& c, int m) {
    using Ev = typename P::Ev;
    T s = T(0);
#pragma unroll
    for (int q = 0; q < Ev::kMaxPass; ++q) {
        const int n = Ev::pass(m, q);
        if (n >= 0) s += cot_at<P>(c, n, 0, 0, 0);
    }
    return s;
}

template <typename T, typename P, int ND, int NC, bool PERIODIC, typename C>
__device__ __forceinline__ void part_cell(const C& c) {
    using Ev = typename P::Ev;
    constexpr int K = P::kKind;
    if constexpr (K == kF || K == kB || K == kFold) {
        T v[Ev::kNOut];
        if constexpr (Ev::kIsBc) {
            const auto rd = bc_reader<T, P, ND>(c);
            Ev::template fwd<T, PERIODIC>(rd, v);
        } else {
            const FwdRd<T, C, P, ND> rd{c};
#pragma unroll
            for (int o = 0; o < Ev::kNOut; ++o) v[o] = T(0);
            Ev::template run<T>(rd, true, v);
            if (!PERIODIC && !interior<Ev>(c, 0, 0, 0)) {
#pragma unroll
                for (int o = 0; o < Ev::kNOut; ++o) v[o] = T(0);
            }
        }
#pragma unroll
        for (int o = 0; o < Ev::kNOut; ++o)
            put<T, P, ND, NC, PERIODIC>(c, o, v[o]);
    } else if constexpr (K == kBR || K == kRFold) {
        // a BC's transpose at the cell: the touched slots
        T v[NC];
#pragma unroll
        for (int m = 0; m < NC; ++m) v[m] = T(0);
#pragma unroll
        for (int j = 0; j < P::kNOut; ++j)
            v[P::wr(j)] = cot_at<P>(c, P::wr(j), 0, 0, 0);
        const auto rd = bc_reader<T, P, ND>(c);
        Ev::template bwd<T, PERIODIC>(rd, v);
#pragma unroll
        for (int j = 0; j < P::kNOut; ++j)
            put<T, P, ND, NC, PERIODIC>(c, j, v[P::wr(j)]);
    } else if constexpr (K == kR) {
        // the gather form: the backward program, then each written slot's
        // gradient plus its pass-through cotangents
        T v[Ev::kNOutB];
#pragma unroll
        for (int o = 0; o < Ev::kNOutB; ++o) v[o] = T(0);
        const int r = c.grow(), y = c.ggy(), x = c.ggx();
        const bool clear =
            PERIODIC
            || (r - Ev::blo(0) >= Ev::mlo(0)
                && r + Ev::bhi(0) < c.gext(0) - Ev::mhi(0)
                && y - Ev::blo(1) >= Ev::mlo(1)
                && y + Ev::bhi(1) < c.gext(1) - Ev::mhi(1)
                && x - Ev::blo(2) >= Ev::mlo(2)
                && x + Ev::bhi(2) < c.gext(2) - Ev::mhi(2));
        if (clear) {
            const BwdRd<T, C, P, ND, false> rd{c};
            Ev::Bwd::template run<T>(rd, true, v);
        } else {
            const BwdRd<T, C, P, ND, true> rd{c};
            Ev::Bwd::template run<T>(rd, true, v);
        }
#pragma unroll
        for (int j = 0; j < P::kNOut; ++j) {
            const int m = P::wr(j);
            const int gs = Ev::grad(m);
            T val = (gs >= 0 ? v[gs < 0 ? 0 : gs] : T(0)) + passed<T, P>(c, m);
            if constexpr (P::kProbeStage >= 0)
                val += probe_cot<T, typename P::Probes, PERIODIC>(
                    c, m, P::kProbeStage);
            put<T, P, ND, NC, PERIODIC>(c, j, val);
        }
    } else if constexpr (K == kL) {
        T w[Ev::kNW];
#pragma unroll
        for (int a = 0; a < Ev::kNW; ++a) w[a] = T(0);
        // a forward write cell; outside the window the forward wrote a
        // constant 0, whose VJP is 0
        if (PERIODIC || interior<Ev>(c, 0, 0, 0)) {
            const LocRd<T, C, P, ND> rd{c};
            Ev::Loc::template run<T>(rd, true, w);
        }
#pragma unroll
        for (int a = 0; a < Ev::kNW; ++a)
            put<T, P, ND, NC, PERIODIC>(c, a, w[a]);
    } else if constexpr (K == kG) {
        T v[NC];
        const GthRd<T, C, P, ND> rd{c};
        Ev::Gth::template run<T>(rd, v);
#pragma unroll
        for (int j = 0; j < P::kNOut; ++j) {
            const int m = P::wr(j);
            T val = v[m] + passed<T, P>(c, m);
            if constexpr (P::kProbeStage >= 0)
                val += probe_cot<T, typename P::Probes, PERIODIC>(
                    c, m, P::kProbeStage);
            put<T, P, ND, NC, PERIODIC>(c, j, val);
        }
    }
}

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
#if defined(__CUDA_ARCH__)
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#else
    return 0;
#endif
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    if constexpr (W == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(dst)),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                         smem_u32(dst)),
                     "l"(src), "n"(W)
                     : "memory");
#else
    for (int i = 0; i < W; ++i)
        static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
#endif
}

__device__ __forceinline__ void cp_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_wait_all() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// One element of a plane of device memory into the ring: cp.async where
// storage and compute types agree, else a converting load.
template <typename T, typename S>
__device__ __forceinline__ void load_elem(T* dst, const S* src) {
    if constexpr (sizeof(T) == sizeof(S) && (sizeof(T) == 4 || sizeof(T) == 8))
        cp_async<sizeof(T)>(dst, src);
    else
        *dst = psat::ld<T>(src);
}

}  // namespace psat_march
