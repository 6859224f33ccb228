// k time steps of a 3D stencil op, and their value and gradient, streamed
// along dim 0 on a Hopper GPU: the hand-written CUDA port of the Pallas
// kernel pystencils_autodiff_tpu/ops/plane_adjoint.py::make_plane_chain_vjp_fn
// (two-phase mode), and the forward chain of
// pystencils_autodiff_tpu/ops/plane_chain.py::make_plane_chain_kernel_fn for
// states too wide for a box tile (forward mode).
//
// Contract (ops/plane_adjoint.py): two-phase mode computes
// g(state, cot_state) -> (state_k, cot_0) with the semantics of
// adjoint_chain.cuh (plain version ops/adjoint_chain.py::plain_chain_vjp):
// every forward stage zeroes the global ghost frame (bounded mode) or wraps
// every read in all three dims (periodic mode); a backward read of output
// o's cotangent reads the sum of the cotangents of the state planes o is
// carried into, in bounded mode 0 outside the forward interior tested at
// the cell READ (the exact-VJP mask); an out-of-domain primal read is 1;
// each state plane's new cotangent is its gradient plus the cotangents of
// the planes carried from it unchanged (the transposed carry map).
// Forward mode computes state_k only (plain version
// ops/time_chain.py::plain_time_chain), and each probe line (a line along
// x of a scalar state plane: row y of plane z) after every stage, written
// by the block that owns it into a (k, nx) record.  Two-phase mode adds
// the probe cotangent of stage s into the cotangent of state s+1 on that
// line: as it reads cot_k from device memory (s = k-1), as reverse stage
// s+1 writes cot_{s+1} into its ring (s < k-1).  Probes are bounded-mode
// only (the JAX package's 3D periodic chains take none either).  Chain-invariant planes (κ, c) are
// read from their input and never written.
//
// Design.  The TPU kernel holds whole (n1, n2) planes of every stage in
// 100 MB of VMEM; a block here has 227 KB.  A box tile wraps its halo
// around six faces, and a 19-component D3Q19 state with a backward reach of
// 2 leaves a box that owns nothing at k = 2.  So a block owns a (y, x)
// column tile and a segment [za, zb) of dim 0 and MARCHES through it plane
// by plane, as the TPU kernel tiles dim 0.  The chain is a list of stages
// in order F_1..F_k (forward stage s writes state s), then the reverse
// stages of one of two forms (host: ops/plane_adjoint.py::FORMS):
//   - gather: R_{k-1}..R_0, reverse stage s writes cot_s through the
//     backward program, which re-evaluates at each cell the Jacobian of
//     every neighbour's forward step (D3Q19: 1,687 steps, 7,043 operations);
//   - local: L_{k-1}, G_{k-1}, ..., L_0, G_0 (ops/local_vjp.py).  L_s
//     writes into ring w_s, at every forward write cell x, the local VJP
//     w_a(x) = Σ_o ∂out_o(x)/∂a · ĉ_o(x) of each read a of the forward
//     (D3Q19: 123 steps, 472 operations; it reads state s at the forward
//     reach and the cotangents of state s+1 at the cell alone); G_s
//     gathers cot_s(y, m) = Σ_{a reads m} w_a(y − o_a), plus the
//     cotangents carried through unchanged, reaching as far as the
//     forward does.  The halos grow by the forward reach per part instead
//     of the backward reach per stage.  Where no cotangent passes through
//     unchanged, G_s (s > 0) is fused into L_{s-1} (stage LG_{s-1}: it
//     gathers cot_s from w_s at the cell), so cot_s needs no ring.
// Stage X works on plane t - lag[X] at march step t, over the owned tile
// widened by its extents (elo, ehi per dim: what the later stages read of
// it).  Lags make every plane a stage reads computed before it is read;
// the reverse stages march in the same direction as the forward ones and
// lag behind them.
//   - The inputs (state_0, cot_k) and every chain-invariant plane are read
//     from device memory, through L1 and L2, when the march reaches them:
//     wrapped in periodic mode, clamped in bounded mode.
//   - Only the intermediate states 1..k-1, cotangents 1..k-1 and (local
//     form) the w planes live in shared memory, as rings of planes over
//     their writer's lateral region; a ring is as deep as its readers'
//     dim-0 reach plus their lag behind the writer (host:
//     ops/plane_adjoint.py::stream_geometry, which also picks the form and
//     the tile by the work per owned cell).  At k = 1 the gather form
//     keeps nothing in shared memory.
//   - Blocks of kThreads threads deal the cells of a stage's lateral region
//     out in turn; one __syncthreads follows each stage of a march step.
//   - Where the lateral tiles alone would put fewer blocks than SMs in
//     flight, dim 0 is cut into segments, each with its own dim-0 halo
//     (periodic wrap at a segment's ends is the same wrap as anywhere).
//
// Shard mode (PSAT_SHARD; ops/flatten.py::ShardSpec, the port of the JAX
// kernels' `shard=`): the domain is one halo-extended block of a sharded
// global domain.  The forward interior window (wlo, whi) and the global
// domain (dlo, dhi) arrive in the block's coordinates — the global ones
// less the shard's base offset, set by the wrapper at each launch — so
// every interior, exact-VJP and in-domain test is a global one and one
// library serves every shard.  A sharded dim is read bounded-style (its
// wrap arrived by the exchange); a dim a periodic domain keeps whole still
// wraps (PSAT_WRAPd).  No probes (the host raises).
//
// Bound.  Per call the kernel reads state_0 (and cot_k) once from device
// memory and writes state_k (and cot_0) once; every intermediate stays on
// chip.  In the gather form the operations bound it (D3Q19 k=2 at 256³
// f32: 3.76 ms against 1.52 ms of bytes) and the body runs at 255
// registers with spills over the tile widened by the backward reach once
// per reverse stage; the local form cuts a reverse stage's operations a
// cell from 7,043 to 491, so that the bytes bound it (PERF.md row 9).  What both still pay: the lateral halo's redundant
// work, one block per SM where the rings fill shared memory, and the
// device-memory reads' wrap/clamp arithmetic (one add or subtract per dim:
// the cell's coordinates are normalised once).  cp.async/TMA rings and
// persistent blocks are later work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

// The shard mode and, in it, the dims a periodic chain wraps (the
// generated source defines them before this header; a library without
// them is unsharded and wraps every dim of a periodic chain).
#ifndef PSAT_SHARD
#define PSAT_SHARD 0
#define PSAT_WRAP0 1
#define PSAT_WRAP1 1
#define PSAT_WRAP2 1
#endif

namespace psat_plane {

constexpr bool kShard = PSAT_SHARD != 0;
// (a function, not an array: device code may not read a host array)
__host__ __device__ constexpr bool wrap_dim(int d) {
    return d == 0 ? PSAT_WRAP0 != 0 : (d == 1 ? PSAT_WRAP1 != 0
                                              : PSAT_WRAP2 != 0);
}
constexpr int kThreads = 256;
constexpr int kMaxK = 8;                   // stream chains take k <= kMaxK
constexpr int kMaxStages = 3 * kMaxK;      // F_1..F_k, then R_s or L_s, G_s
constexpr int kMaxProbes = 4;

// The kinds of stage of the march: forward F_s (writes state s), the
// gather form's reverse R_s (writes cot_s), and the local form's L_s
// (writes w_s), G_s (writes cot_s) and LG_s (L_s with G_{s+1} fused in:
// it gathers cot_{s+1} from w_{s+1} at the cell instead of reading a ring).
enum StageKind : int { kF = 0, kR = 1, kL = 2, kG = 3, kLG = 4 };
// The kernel's form: forward only, two-phase gather form, two-phase local
// form (ops/plane_adjoint.py::FORMS).
enum Form : int { kForward = 0, kGather = 1, kLocal = 2 };

// The geometry the wrapper computes (layout in parse_geo).  Per-dim arrays
// are (z, y, x).
struct PlaneGeo {
    int64_t n[3];            // domain
    int k, nstage;           // depth; stages
    int t[2], nt[2];         // lateral tile (y, x) and tiles per dim
    int nseg, zlen;          // dim-0 segments and their length
    int64_t wlo[3], whi[3];  // forward interior window
    int lb[3], hb[3];        // backward reach (gather form)
    int tlo, thi;            // march steps t in [za + tlo, zb + thi)
    int64_t smem;            // shared-memory elements: every ring
    int kind[kMaxStages], ss[kMaxStages], lag[kMaxStages];
    int elo[kMaxStages][3], ehi[kMaxStages][3];
    // ring s of the states, the cotangents and the local form's w planes:
    // element offset, depth, and the stage whose region it covers
    int soff[kMaxK], sdep[kMaxK], sx[kMaxK];
    int coff[kMaxK], cdep[kMaxK], cx[kMaxK];
    int woff[kMaxK], wdep[kMaxK], wx[kMaxK];
    int nprobe;
    int probe_state[kMaxProbes];
    int64_t probe_z[kMaxProbes], probe_y[kMaxProbes];  // the line along x
    // the global domain in the block's coordinates (shard mode; else the
    // block)
    int64_t dlo[3], dhi[3];
};

// geo: n[3] k nstage t[2] nt[2] nseg zlen wlo[3] whi[3] lb[3] hb[3] tlo thi
//      smem (kind s lag elo[3] ehi[3]) * nstage
//      (soff sdep sx coff cdep cx woff wdep wx) * k
//      nprobe (probe_state probe_z probe_y) * nprobe
//      shard mode: dlo[3] dhi[3]
inline bool parse_geo(const int64_t* geo, PlaneGeo& g) {
    int i = 0;
    for (int d = 0; d < 3; ++d) g.n[d] = geo[i++];
    g.k = (int)geo[i++];
    g.nstage = (int)geo[i++];
    for (int d = 0; d < 2; ++d) g.t[d] = (int)geo[i++];
    for (int d = 0; d < 2; ++d) g.nt[d] = (int)geo[i++];
    g.nseg = (int)geo[i++];
    g.zlen = (int)geo[i++];
    for (int d = 0; d < 3; ++d) g.wlo[d] = geo[i++];
    for (int d = 0; d < 3; ++d) g.whi[d] = geo[i++];
    for (int d = 0; d < 3; ++d) g.lb[d] = (int)geo[i++];
    for (int d = 0; d < 3; ++d) g.hb[d] = (int)geo[i++];
    g.tlo = (int)geo[i++];
    g.thi = (int)geo[i++];
    g.smem = geo[i++];
    if (g.k < 1 || g.k > kMaxK || g.nstage < g.k || g.nstage > 3 * g.k)
        return false;
    for (int x = 0; x < g.nstage; ++x) {
        g.kind[x] = (int)geo[i++];
        g.ss[x] = (int)geo[i++];
        g.lag[x] = (int)geo[i++];
        for (int d = 0; d < 3; ++d) g.elo[x][d] = (int)geo[i++];
        for (int d = 0; d < 3; ++d) g.ehi[x][d] = (int)geo[i++];
        if (g.kind[x] < kF || g.kind[x] > kLG || g.ss[x] < 0
            || g.ss[x] > g.k)
            return false;
    }
    for (int s = 0; s < g.k; ++s) {
        int* ring[9] = {&g.soff[s], &g.sdep[s], &g.sx[s], &g.coff[s],
                        &g.cdep[s], &g.cx[s], &g.woff[s], &g.wdep[s],
                        &g.wx[s]};
        for (int j = 0; j < 9; ++j) *ring[j] = (int)geo[i++];
        if (g.sx[s] >= g.nstage || g.cx[s] >= g.nstage
            || g.wx[s] >= g.nstage)
            return false;
    }
    g.nprobe = (int)geo[i++];
    if (g.nprobe < 0 || g.nprobe > kMaxProbes) return false;
    for (int q = 0; q < g.nprobe; ++q) {
        g.probe_state[q] = (int)geo[i++];
        g.probe_z[q] = geo[i++];
        g.probe_y[q] = geo[i++];
    }
    for (int d = 0; d < 3; ++d) {
        g.dlo[d] = 0;
        g.dhi[d] = g.n[d];
    }
    if (kShard) {
        // geo tail: dlo[3] dhi[3]
        for (int d = 0; d < 3; ++d) g.dlo[d] = geo[i++];
        for (int d = 0; d < 3; ++d) g.dhi[d] = geo[i++];
        if (g.nprobe != 0) return false;
    }
    const int64_t blocks = (int64_t)g.nt[0] * g.nt[1] * g.nseg;
    return g.t[0] >= 1 && g.t[1] >= 1 && g.zlen >= 1 && blocks >= 1
           && blocks <= 0x7fffffff;
}

// T: the compute type (and of the shared-memory rings); S: the storage
// type of the planes in device memory (ld/st in on_device.cuh)
template <typename T, int NS, typename S = T>
struct PlaneParams {
    PlaneGeo g;
    const S* in[NS];        // state_0
    int64_t in_st[NS][3];
    S* out[NS];             // state_k; null: an invariant plane, not written
    int64_t out_st[NS][3];
    const S* cot[NS];       // cot_k (two-phase mode)
    int64_t cot_st[NS][3];
    S* out_cot[NS];         // cot_0 (two-phase mode)
    int64_t out_cot_st[NS][3];
    S* probe[kMaxProbes];             // (k, nx) records (forward mode)
    const S* probe_cot[kMaxProbes];   // (k, nx) cotangents (two-phase mode)
};

// The probe cotangents of record row s on state plane n at cell (z, y, x).
template <typename T, int NS, typename S>
__device__ __forceinline__ T probe_cot_at(const PlaneParams<T, NS, S>& p, int n,
                                          int s, int64_t z, int64_t y,
                                          int64_t x) {
    const PlaneGeo& g = p.g;
    T v = T(0);
    for (int q = 0; q < g.nprobe; ++q)
        if (n == g.probe_state[q] && z == g.probe_z[q] && y == g.probe_y[q]
            && x >= 0 && x < g.n[2])
            v += psat::ld<T>(p.probe_cot[q] + (int64_t)s * g.n[2] + x);
    return v;
}

// A coordinate normalised into [0, n) (periodic mode; once per cell) —
// the reads then wrap with one add or subtract, since no read reaches
// farther than an extent (the wrapper checks)
__device__ __forceinline__ int64_t wrap_once(int64_t c, int64_t n) {
    c %= n;
    return c < 0 ? c + n : c;
}

// A plane of device memory at the cell's coordinates (normalised in
// periodic mode) plus an offset: wrapped (periodic) or clamped (bounded).
template <bool PERIODIC>
__device__ __forceinline__ int64_t gcoord(int64_t c, int o, int64_t n) {
    c += o;
    if (PERIODIC) return c < 0 ? c + n : (c >= n ? c - n : c);
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

template <typename T, bool PERIODIC, typename S>
__device__ __forceinline__ T gread(const S* p, const int64_t* st,
                                   const PlaneGeo& g, int64_t z, int64_t y,
                                   int64_t x, int o0, int o1, int o2) {
    constexpr bool w0 = PERIODIC && wrap_dim(0), w1 = PERIODIC && wrap_dim(1),
                   w2 = PERIODIC && wrap_dim(2);
    return psat::ld<T>(p + gcoord<w0>(z, o0, g.n[0]) * st[0]
                       + gcoord<w1>(y, o1, g.n[1]) * st[1]
                       + gcoord<w2>(x, o2, g.n[2]) * st[2]);
}

__device__ __forceinline__ bool in_domain(const PlaneGeo& g, int64_t z,
                                          int64_t y, int64_t x) {
    if constexpr (kShard)
        return z >= g.dlo[0] && z < g.dhi[0] && y >= g.dlo[1]
               && y < g.dhi[1] && x >= g.dlo[2] && x < g.dhi[2];
    return z >= 0 && z < g.n[0] && y >= 0 && y < g.n[1] && x >= 0
           && x < g.n[2];
}

__device__ __forceinline__ bool in_window(const PlaneGeo& g, int64_t z,
                                          int64_t y, int64_t x) {
    return z >= g.wlo[0] && z < g.whi[0] && y >= g.wlo[1] && y < g.whi[1]
           && x >= g.wlo[2] && x < g.whi[2];
}

// A ring of `depth` planes of `planes` components over a lateral region of
// ry × rx cells whose local (0, 0) is global (y0, x0); plane z lives in
// slot z mod depth.
template <typename T>
struct Ring {
    T* base;
    int depth, planes, ry, rx;
    int64_t y0, x0;

    __device__ __forceinline__ int slot(int64_t z) const {
        int s = (int)(z % depth);
        return s < 0 ? s + depth : s;
    }
    // slot zs + o0 (|o0| < depth): no division per read
    __device__ __forceinline__ T* at(int zs, int o0, int n, int64_t y,
                                     int64_t x) const {
        int s = zs + o0;
        if (s >= depth) s -= depth;
        else if (s < 0) s += depth;
        return base + ((s * planes + n) * ry + (int)(y - y0)) * rx
               + (int)(x - x0);
    }
};

// The ring of the region of stage `x` (its lateral extents around the
// owned tile at (ty0, tx0)).
template <typename T>
__device__ __forceinline__ Ring<T> stage_ring(T* smem, const PlaneGeo& g,
                                              int x, int off, int depth,
                                              int planes, int64_t ty0,
                                              int64_t tx0) {
    Ring<T> r;
    r.base = smem + off;
    r.depth = depth;
    r.planes = planes;
    r.ry = g.t[0] + g.elo[x][1] + g.ehi[x][1];
    r.rx = g.t[1] + g.elo[x][2] + g.ehi[x][2];
    r.y0 = ty0 - g.elo[x][1];
    r.x0 = tx0 - g.elo[x][2];
    return r;
}

// The rings of state s, of cot_s and of the local form's w_s, each laid out
// over the region of the stage that writes it.
template <typename T>
__device__ __forceinline__ Ring<T> state_ring(T* smem, const PlaneGeo& g,
                                              int s, int planes, int64_t ty0,
                                              int64_t tx0) {
    return stage_ring(smem, g, g.sx[s], g.soff[s], g.sdep[s], planes, ty0,
                      tx0);
}
template <typename T>
__device__ __forceinline__ Ring<T> cot_ring(T* smem, const PlaneGeo& g, int s,
                                            int planes, int64_t ty0,
                                            int64_t tx0) {
    return stage_ring(smem, g, g.cx[s], g.coff[s], g.cdep[s], planes, ty0,
                      tx0);
}
template <typename T>
__device__ __forceinline__ Ring<T> w_ring(T* smem, const PlaneGeo& g, int s,
                                          int planes, int64_t ty0,
                                          int64_t tx0) {
    return stage_ring(smem, g, g.wx[s], g.woff[s], g.wdep[s], planes, ty0,
                      tx0);
}

// Reader of the forward body at one cell of stage s: state plane k of state
// s-1 at an offset — from device memory for s = 1 and for an invariant
// plane (PM::dyn(k) < 0), else from the ring — and hoisted value j.
template <typename T, int NS, bool PERIODIC, typename PM, typename S>
struct FwdReader {
    const PlaneParams<T, NS, S>* p;
    Ring<T> prev;
    bool glob;
    int zs;
    int64_t y, x;        // the cell (ring addressing)
    int64_t wz, wy, wx;  // the cell for device-memory reads
    const T* h;

    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        const int d = PM::dyn(k);
        if (glob || d < 0)
            return gread<T, PERIODIC>(p->in[k], p->in_st[k], p->g, wz, wy,
                                      wx, o0, o1, o2);
        return *prev.at(zs, o0, d, y + o1, x + o2);
    }
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        return rp(k, o0, o1, o2);
    }
    __device__ __forceinline__ T rh(int j) const { return h[j]; }
};

// PM (PsatPlaneMeta) also says whether the plan has probes (kProbes): a
// plan without builds none of their code.
//
// Reader of the backward body at one cell of reverse stage s: primals of
// state s (device memory for s = 0 and invariant planes, else the state
// ring), cotangents of state s+1 (device memory for s+1 = k, else the
// cotangent ring), summed over the carriers; MASKED: bounded mode at a
// cell whose backward stencil leaves the forward interior.
template <typename T, int NS, typename S>
struct BwdCell {
    const PlaneParams<T, NS, S>* p;
    Ring<T> st, ct;
    bool glob_prim, glob_cot;
    int zs_st, zs_ct;
    int64_t z, y, x;     // the cell (ring addressing, masks)
    int64_t wz, wy, wx;  // the cell for device-memory reads
};

template <typename T, int NS, bool PERIODIC, bool MASKED, typename PM,
          typename Meta, typename S>
struct BwdReader {
    BwdCell<T, NS, S> c;

    __device__ __forceinline__ T rp(int j, int o0, int o1, int o2) const {
        const int n = Meta::prim(j) < 0 ? 0 : Meta::prim(j);
        const int d = PM::dyn(n);
        const T v = (c.glob_prim || d < 0)
            ? gread<T, PERIODIC>(c.p->in[n], c.p->in_st[n], c.p->g, c.wz,
                                 c.wy, c.wx, o0, o1, o2)
            : *c.st.at(c.zs_st, o0, d, c.y + o1, c.x + o2);
        if (!MASKED) return v;
        return in_domain(c.p->g, c.z + o0, c.y + o1, c.x + o2) ? v : T(1);
    }
    __device__ __forceinline__ T cot(int n, int o0, int o1, int o2) const {
        if (c.glob_cot) {
            const T v = gread<T, PERIODIC>(c.p->cot[n], c.p->cot_st[n],
                                           c.p->g, c.wz, c.wy, c.wx, o0, o1,
                                           o2);
            if constexpr (!PM::kProbes) return v;
            else
                return v + probe_cot_at(*c.p, n, c.p->g.k - 1, c.z + o0,
                                        c.y + o1, c.x + o2);
        }
        return *c.ct.at(c.zs_ct, o0, n, c.y + o1, c.x + o2);
    }
    __device__ __forceinline__ T ra(int j, int o0, int o1, int o2) const {
        if (Meta::adj(j, 0) < 0) return T(0);
        T v = cot(Meta::adj(j, 0), o0, o1, o2);
#pragma unroll
        for (int q = 1; q < Meta::kMaxAdj; ++q) {
            const int n = Meta::adj(j, q);
            if (n >= 0) v += cot(n, o0, o1, o2);
        }
        if (!MASKED) return v;
        return in_window(c.p->g, c.z + o0, c.y + o1, c.x + o2) ? v : T(0);
    }
};

// Placeholders of the bodies a form does not run (the forward mode has
// no reverse body; each two-phase form has the other's empty).
struct NoBwd {
    template <typename T, typename C>
    __device__ __forceinline__ static void run(const C&, bool, T*) {}
};
struct NoBwdMeta {
    static constexpr int kMaxAdj = 1;
    __host__ __device__ static constexpr int prim(int) { return -1; }
    __host__ __device__ static constexpr int adj(int, int) { return -1; }
    __host__ __device__ static constexpr int grad(int) { return -1; }
    __host__ __device__ static constexpr int pass(int, int) { return -1; }
};
struct NoGather {
    template <typename T, typename C>
    __device__ __forceinline__ static void run(const C&, T*) {}
};
struct NoLocalMeta {
    static constexpr int kMaxCar = 1, kMaxPass = 1;
    static constexpr bool kHasPass = false;
    __host__ __device__ static constexpr int car(int, int) { return -1; }
    __host__ __device__ static constexpr int pass(int, int) { return -1; }
};

// Reader of the local-VJP body (PsatLocal) at one cell of L_s: input slot
// k < NS is state plane k of state s at a forward offset (device memory
// for s = 0 and for invariant planes, else the state ring); slot NS + j is
// the cotangent of forward output j at the cell, the sum of the
// cotangents of the state s+1 planes it is carried into (LM::car; device
// memory, probe cotangents added, for s+1 = k, else the cotangent ring).
// The body runs only where the cell is a forward write cell, so no read
// needs a mask.  cot(n) is also the pass-through read of G_s.  FUSED (an
// LG stage): the cotangents of state s+1 at the cell are `cv`, gathered
// in place.
template <typename T, int NS, bool PERIODIC, typename PM, typename LM,
          typename S, bool FUSED = false>
struct LocReader {
    const PlaneParams<T, NS, S>* p;
    Ring<T> st, ct;
    bool glob_prim, glob_cot;
    int zs_st, zs_ct;
    int64_t z, y, x;     // the cell (ring addressing, probe lines)
    int64_t wz, wy, wx;  // the cell for device-memory reads
    const T* cv;

    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        const int d = PM::dyn(k);
        if (glob_prim || d < 0)
            return gread<T, PERIODIC>(p->in[k], p->in_st[k], p->g, wz, wy, wx,
                                      o0, o1, o2);
        return *st.at(zs_st, o0, d, y + o1, x + o2);
    }
    __device__ __forceinline__ T cot(int n) const {
        if constexpr (FUSED) return cv[n];
        if (glob_cot) {
            const T v = gread<T, PERIODIC>(p->cot[n], p->cot_st[n], p->g, wz,
                                           wy, wx, 0, 0, 0);
            if constexpr (!PM::kProbes) return v;
            else return v + probe_cot_at(*p, n, p->g.k - 1, z, y, x);
        }
        return *ct.at(zs_ct, 0, n, y, x);
    }
    __device__ __forceinline__ T ra(int j, int, int, int) const {
        const int o = j - NS;
        if (LM::car(o, 0) < 0) return T(0);
        T v = cot(LM::car(o, 0));
#pragma unroll
        for (int q = 1; q < LM::kMaxCar; ++q) {
            const int n = LM::car(o, q);
            if (n >= 0) v += cot(n);
        }
        return v;
    }
};

// Reader of the gather body (PsatGather) at one cell of G_s: w plane a of
// the ring at an offset.
template <typename T>
struct GatherReader {
    Ring<T> w;
    int zs;
    int64_t y, x;

    __device__ __forceinline__ T w_at(int a, int o0, int o1, int o2) const {
        return *w.at(zs, o0, a, y + o1, x + o2);
    }
};

template <typename T, int NS, typename S>
__device__ __forceinline__ void store(S* const* dst, const int64_t (*st)[3],
                                      int n, int64_t z, int64_t y, int64_t x,
                                      T v) {
    psat::st(dst[n] + z * st[n][0] + y * st[n][1] + x * st[n][2], v);
}

// Forward stage s (1..k) on plane z over its region: the hoisted steps and
// the forward body at every cell, the ghost frame zeroed (bounded mode),
// then every carried plane of state s into ring s (s < k) or into state_k.
template <typename T, int NS, int NOUT, int NH, bool PERIODIC, typename Fwd,
          typename Hoist, typename PM, typename S>
__device__ __forceinline__ void forward_plane(
        const PlaneParams<T, NS, S>& p, T* smem, int s, int64_t z, int64_t ty0,
        int64_t tx0, int64_t za, int64_t zb) {
    const PlaneGeo& g = p.g;
    const int x = s - 1;  // F_s is stage s - 1
    const int ry = g.t[0] + g.elo[x][1] + g.ehi[x][1];
    const int rx = g.t[1] + g.elo[x][2] + g.ehi[x][2];
    const int64_t y0 = ty0 - g.elo[x][1], x0 = tx0 - g.elo[x][2];
    Ring<T> prev{}, cur{};
    if (s >= 2) prev = state_ring<T>(smem, g, s - 1, PM::kNDyn, ty0, tx0);
    if (s < g.k) cur = state_ring<T>(smem, g, s, PM::kNDyn, ty0, tx0);
    const int zs_prev = s >= 2 ? prev.slot(z) : 0;
    const int zs_cur = s < g.k ? cur.slot(z) : 0;
    const bool owned_z = z >= za && z < zb;
    const int64_t wz = (PERIODIC && wrap_dim(0)) ? wrap_once(z, g.n[0]) : z;
    for (int i = threadIdx.x; i < ry * rx; i += kThreads) {
        const int ly = i / rx;
        const int64_t gy = y0 + ly, gx = x0 + (i - ly * rx);
        // the owned cells record the probe lines (forward mode)
        const bool rec = PM::kProbes && owned_z && gy >= ty0
                         && gy < ty0 + g.t[0] && gx >= tx0
                         && gx < tx0 + g.t[1] && gx < g.n[2];
        T hv[NH > 0 ? NH : 1];
        FwdReader<T, NS, PERIODIC, PM, S> rd;
        rd.p = &p;
        rd.prev = prev;
        rd.glob = s == 1;
        rd.zs = zs_prev;
        rd.y = gy;
        rd.x = gx;
        rd.wz = wz;
        rd.wy = (PERIODIC && wrap_dim(1)) ? wrap_once(gy, g.n[1]) : gy;
        rd.wx = (PERIODIC && wrap_dim(2)) ? wrap_once(gx, g.n[2]) : gx;
        rd.h = hv;
        if constexpr (NH > 0) {
            FwdReader<T, NS, PERIODIC, PM, S> hr = rd;
            hr.glob = true;  // the hoisted steps read invariant planes
            Hoist::template run<T>(hr, hv);
        }
        T v[NOUT];
#pragma unroll
        for (int o = 0; o < NOUT; ++o) v[o] = T(0);
        Fwd::template run<T>(rd, true, v);
        if (!PERIODIC && !in_window(g, z, gy, gx)) {
#pragma unroll
            for (int o = 0; o < NOUT; ++o) v[o] = T(0);
        }
        const bool write_out = s == g.k && owned_z && gy < g.n[1]
                               && gx < g.n[2];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            const int d = PM::dyn(n);
            if (d < 0) continue;
            const int so = PM::src_out(n), si = PM::src_in(n);
            const T val = so >= 0 ? v[so < 0 ? 0 : so]
                                  : rd.rp(si < 0 ? 0 : si, 0, 0, 0);
            if (s < g.k) *cur.at(zs_cur, 0, d, gy, gx) = val;
            else if (write_out)
                store<T, NS, S>(p.out, p.out_st, n, z, gy, gx, val);
            if constexpr (PM::kProbes) {
                for (int q = 0; q < g.nprobe && rec; ++q)
                    if (p.probe[q] && n == g.probe_state[q]
                        && z == g.probe_z[q] && gy == g.probe_y[q])
                        psat::st(p.probe[q] + (int64_t)(s - 1) * g.n[2] + gx,
                                 val);
            }
        }
    }
}

// Reverse stage s (k-1..0) on plane z: the backward body at every cell of
// its region (unmasked where the cell's backward stencil stays inside the
// forward interior), each state plane's new cotangent into ring s (s > 0)
// or into cot_0.
template <typename T, int NS, int NOUTB, int MAXPASS, bool PERIODIC,
          bool MASKED, typename Bwd, typename Meta, typename PM, typename S>
__device__ __forceinline__ void reverse_cell(
        const BwdReader<T, NS, PERIODIC, MASKED, PM, Meta, S>& rd, T* vals) {
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
            if (n >= 0) val += rd.cot(n, 0, 0, 0);
        }
        vals[m] = val;
    }
}

template <typename T, int NS, int NOUTB, int MAXPASS, bool PERIODIC,
          typename Bwd, typename Meta, typename PM, typename S>
__device__ __forceinline__ void reverse_plane(
        const PlaneParams<T, NS, S>& p, T* smem, int s, int64_t z, int64_t ty0,
        int64_t tx0, int64_t za, int64_t zb) {
    const PlaneGeo& g = p.g;
    const int x = g.cx[s];  // stage index of R_s
    const int ry = g.t[0] + g.elo[x][1] + g.ehi[x][1];
    const int rx = g.t[1] + g.elo[x][2] + g.ehi[x][2];
    const int64_t y0 = ty0 - g.elo[x][1], x0 = tx0 - g.elo[x][2];
    Ring<T> st{}, ct{}, cur{};
    if (s >= 1) {
        st = state_ring<T>(smem, g, s, PM::kNDyn, ty0, tx0);
        cur = cot_ring<T>(smem, g, s, NS, ty0, tx0);
    }
    if (s + 1 < g.k) ct = cot_ring<T>(smem, g, s + 1, NS, ty0, tx0);
    BwdReader<T, NS, PERIODIC, false, PM, Meta, S> rd;
    rd.c.p = &p;
    rd.c.st = st;
    rd.c.ct = ct;
    rd.c.glob_prim = s == 0;
    rd.c.glob_cot = s + 1 == g.k;
    rd.c.zs_st = s >= 1 ? st.slot(z) : 0;
    rd.c.zs_ct = s + 1 < g.k ? ct.slot(z) : 0;
    rd.c.z = z;
    rd.c.wz = (PERIODIC && wrap_dim(0)) ? wrap_once(z, g.n[0]) : z;
    const int zs_cur = s >= 1 ? cur.slot(z) : 0;
    const bool zin = z - g.lb[0] >= g.wlo[0] && z + g.hb[0] < g.whi[0];
    const bool owned_z = z >= za && z < zb;
    for (int i = threadIdx.x; i < ry * rx; i += kThreads) {
        const int ly = i / rx;
        const int64_t gy = y0 + ly, gx = x0 + (i - ly * rx);
        rd.c.y = gy;
        rd.c.x = gx;
        rd.c.wy = (PERIODIC && wrap_dim(1)) ? wrap_once(gy, g.n[1]) : gy;
        rd.c.wx = (PERIODIC && wrap_dim(2)) ? wrap_once(gx, g.n[2]) : gx;
        T vals[NS];
        if (PERIODIC || (zin && gy - g.lb[1] >= g.wlo[1]
                         && gy + g.hb[1] < g.whi[1]
                         && gx - g.lb[2] >= g.wlo[2]
                         && gx + g.hb[2] < g.whi[2])) {
            reverse_cell<T, NS, NOUTB, MAXPASS, PERIODIC, false, Bwd, Meta,
                         PM, S>(rd, vals);
        } else {
            BwdReader<T, NS, PERIODIC, true, PM, Meta, S> mr;
            mr.c = rd.c;
            reverse_cell<T, NS, NOUTB, MAXPASS, PERIODIC, true, Bwd, Meta,
                         PM, S>(mr, vals);
        }
        if (s >= 1) {
#pragma unroll
            for (int m = 0; m < NS; ++m) {
                if constexpr (PM::kProbes)
                    vals[m] += probe_cot_at(p, m, s - 1, z, gy, gx);
                *cur.at(zs_cur, 0, m, gy, gx) = vals[m];
            }
        } else if (owned_z && gy < g.n[1] && gx < g.n[2]) {
#pragma unroll
            for (int m = 0; m < NS; ++m)
                store<T, NS, S>(p.out_cot, p.out_cot_st, m, z, gy, gx,
                                vals[m]);
        }
    }
}

// L_s on plane z (local form): the local VJP at every cell of its region
// into ring w_s — w_a at a forward write cell, 0 elsewhere (bounded mode:
// outside the forward interior no forward step wrote, so no cotangent
// flows back through it).  FUSED (LG_s): the cotangents of state s+1 are
// gathered from ring w_{s+1} at the cell (probe cotangents of record row
// s added), as G_{s+1} would have written them.
template <typename T, int NS, int NW, bool PERIODIC, bool FUSED, typename Loc,
          typename Gth, typename PM, typename LM, typename S>
__device__ __forceinline__ void local_plane(const PlaneParams<T, NS, S>& p,
                                            T* smem, int s, int64_t z,
                                            int64_t ty0, int64_t tx0) {
    const PlaneGeo& g = p.g;
    const int x = g.wx[s];  // stage index of L_s
    const int ry = g.t[0] + g.elo[x][1] + g.ehi[x][1];
    const int rx = g.t[1] + g.elo[x][2] + g.ehi[x][2];
    const int64_t y0 = ty0 - g.elo[x][1], x0 = tx0 - g.elo[x][2];
    const Ring<T> wr = w_ring<T>(smem, g, s, NW, ty0, tx0);
    LocReader<T, NS, PERIODIC, PM, LM, S, FUSED> rd{};
    rd.p = &p;
    if (s >= 1) rd.st = state_ring<T>(smem, g, s, PM::kNDyn, ty0, tx0);
    GatherReader<T> gr{};
    if constexpr (FUSED) {
        gr.w = w_ring<T>(smem, g, s + 1, NW, ty0, tx0);
        gr.zs = gr.w.slot(z);
    } else if (s + 1 < g.k) {
        rd.ct = cot_ring<T>(smem, g, s + 1, NS, ty0, tx0);
    }
    rd.glob_prim = s == 0;
    rd.glob_cot = s + 1 == g.k;
    rd.zs_st = s >= 1 ? rd.st.slot(z) : 0;
    rd.zs_ct = s + 1 < g.k ? rd.ct.slot(z) : 0;
    rd.z = z;
    rd.wz = (PERIODIC && wrap_dim(0)) ? wrap_once(z, g.n[0]) : z;
    const int zs_w = wr.slot(z);
    const bool zin = z >= g.wlo[0] && z < g.whi[0];
    for (int i = threadIdx.x; i < ry * rx; i += kThreads) {
        const int ly = i / rx;
        const int64_t gy = y0 + ly, gx = x0 + (i - ly * rx);
        T v[NW];
#pragma unroll
        for (int a = 0; a < NW; ++a) v[a] = T(0);
        if (PERIODIC || (zin && gy >= g.wlo[1] && gy < g.whi[1]
                         && gx >= g.wlo[2] && gx < g.whi[2])) {
            rd.y = gy;
            rd.x = gx;
            rd.wy = (PERIODIC && wrap_dim(1)) ? wrap_once(gy, g.n[1]) : gy;
            rd.wx = (PERIODIC && wrap_dim(2)) ? wrap_once(gx, g.n[2]) : gx;
            if constexpr (FUSED) {
                T cv[NS];
                gr.y = gy;
                gr.x = gx;
                Gth::template run<T>(gr, cv);
                if constexpr (PM::kProbes) {
#pragma unroll
                    for (int m = 0; m < NS; ++m)
                        cv[m] += probe_cot_at(p, m, s, z, gy, gx);
                }
                rd.cv = cv;
                Loc::template run<T>(rd, true, v);
            } else {
                Loc::template run<T>(rd, true, v);
            }
        }
#pragma unroll
        for (int a = 0; a < NW; ++a) *wr.at(zs_w, 0, a, gy, gx) = v[a];
    }
}

// G_s on plane z (local form): each state plane's cotangent gathered from
// the w planes at minus their read offsets, plus the cotangents carried
// through unchanged; into ring cot_s (s > 0, probe cotangents of record
// row s-1 added) or into cot_0 (the owned cells).
template <typename T, int NS, int NW, bool PERIODIC, typename Gth,
          typename PM, typename LM, typename S>
__device__ __forceinline__ void gather_plane(const PlaneParams<T, NS, S>& p,
                                             T* smem, int s, int64_t z,
                                             int64_t ty0, int64_t tx0,
                                             int64_t za, int64_t zb) {
    const PlaneGeo& g = p.g;
    const int x = g.cx[s];  // stage index of G_s
    const int ry = g.t[0] + g.elo[x][1] + g.ehi[x][1];
    const int rx = g.t[1] + g.elo[x][2] + g.ehi[x][2];
    const int64_t y0 = ty0 - g.elo[x][1], x0 = tx0 - g.elo[x][2];
    GatherReader<T> gr;
    gr.w = w_ring<T>(smem, g, s, NW, ty0, tx0);
    gr.zs = gr.w.slot(z);
    LocReader<T, NS, PERIODIC, PM, LM, S> pr{};  // pass-through reads
    pr.p = &p;
    if (s + 1 < g.k) pr.ct = cot_ring<T>(smem, g, s + 1, NS, ty0, tx0);
    pr.glob_cot = s + 1 == g.k;
    pr.zs_ct = s + 1 < g.k ? pr.ct.slot(z) : 0;
    pr.z = z;
    pr.wz = (PERIODIC && wrap_dim(0)) ? wrap_once(z, g.n[0]) : z;
    Ring<T> cur{};
    if (s >= 1) cur = cot_ring<T>(smem, g, s, NS, ty0, tx0);
    const int zs_cur = s >= 1 ? cur.slot(z) : 0;
    const bool owned_z = z >= za && z < zb;
    for (int i = threadIdx.x; i < ry * rx; i += kThreads) {
        const int ly = i / rx;
        const int64_t gy = y0 + ly, gx = x0 + (i - ly * rx);
        gr.y = gy;
        gr.x = gx;
        T v[NS];
        Gth::template run<T>(gr, v);
        if constexpr (LM::kHasPass) {
            pr.y = gy;
            pr.x = gx;
            pr.wy = (PERIODIC && wrap_dim(1)) ? wrap_once(gy, g.n[1]) : gy;
            pr.wx = (PERIODIC && wrap_dim(2)) ? wrap_once(gx, g.n[2]) : gx;
#pragma unroll
            for (int m = 0; m < NS; ++m) {
#pragma unroll
                for (int q = 0; q < LM::kMaxPass; ++q) {
                    const int n = LM::pass(m, q);
                    if (n >= 0) v[m] += pr.cot(n);
                }
            }
        }
        if (s >= 1) {
#pragma unroll
            for (int m = 0; m < NS; ++m) {
                if constexpr (PM::kProbes)
                    v[m] += probe_cot_at(p, m, s - 1, z, gy, gx);
                *cur.at(zs_cur, 0, m, gy, gx) = v[m];
            }
        } else if (owned_z && gy < g.n[1] && gx < g.n[2]) {
#pragma unroll
            for (int m = 0; m < NS; ++m)
                store<T, NS, S>(p.out_cot, p.out_cot_st, m, z, gy, gx, v[m]);
        }
    }
}

template <typename T, int NS, int NOUT, int NH, int NOUTB, int MAXPASS,
          int NW, int FORM, bool PERIODIC, typename Fwd, typename Hoist,
          typename Bwd, typename Meta, typename Loc, typename Gth,
          typename LM, typename PM, typename S = T>
__global__ void __launch_bounds__(kThreads, 1)
plane_chain(const __grid_constant__ PlaneParams<T, NS, S> p) {
    extern __shared__ unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const PlaneGeo& g = p.g;
    unsigned b = blockIdx.x;
    const unsigned tx = b % (unsigned)g.nt[1];
    b /= (unsigned)g.nt[1];
    const unsigned ty = b % (unsigned)g.nt[0];
    const unsigned seg = b / (unsigned)g.nt[0];
    const int64_t ty0 = (int64_t)ty * g.t[0], tx0 = (int64_t)tx * g.t[1];
    const int64_t za = (int64_t)seg * g.zlen;
    const int64_t zb = za + g.zlen < g.n[0] ? za + g.zlen : g.n[0];
    for (int64_t t = za + g.tlo; t < zb + g.thi; ++t) {
        for (int x = 0; x < g.nstage; ++x) {
            const int64_t z = t - g.lag[x];
            if (z < za - g.elo[x][0] || z >= zb + g.ehi[x][0]) continue;
            const int s = g.ss[x];
            switch (g.kind[x]) {
            case kF:
                forward_plane<T, NS, NOUT, NH, PERIODIC, Fwd, Hoist, PM, S>(
                    p, smem, s, z, ty0, tx0, za, zb);
                break;
            case kR:
                if constexpr (FORM == kGather)
                    reverse_plane<T, NS, NOUTB, MAXPASS, PERIODIC, Bwd, Meta,
                                  PM, S>(p, smem, s, z, ty0, tx0, za, zb);
                break;
            case kL:
                if constexpr (FORM == kLocal)
                    local_plane<T, NS, NW, PERIODIC, false, Loc, Gth, PM, LM,
                                S>(p, smem, s, z, ty0, tx0);
                break;
            case kLG:
                if constexpr (FORM == kLocal)
                    local_plane<T, NS, NW, PERIODIC, true, Loc, Gth, PM, LM,
                                S>(p, smem, s, z, ty0, tx0);
                break;
            case kG:
                if constexpr (FORM == kLocal)
                    gather_plane<T, NS, NW, PERIODIC, Gth, PM, LM, S>(
                        p, smem, s, z, ty0, tx0, za, zb);
                break;
            default:
                break;
            }
            __syncthreads();
        }
    }
}

}  // namespace psat_plane
