// One stencil step streamed through shared memory on a Hopper GPU: the
// hand-written CUDA port of pystencils_autodiff_tpu/ops/pallas_kernel.py::
// _run_row_tiled (tiles of the leading dim, tile + halo slabs DMA'd into
// two VMEM slots, compute on one slot while the other loads).
//
// What it computes is stencil_step.cuh's INTERIOR and FULL modes (scalar
// fields, 2 or 3 spatial dims), with the same emitted `PsatBody::run`; the
// reader `c` here reads a shared-memory ring instead of device memory.
//
// Bound: memory bandwidth — each input plane read once and each output
// plane written once, a few operations per read.  The per-cell kernel
// (stencil_step.cuh) reaches 0.80 of copy time in the f32 forward; what a
// first slab design of this kernel lost against it (1.4-3.9x, PERF.md) was
// the copy issue (a 4-byte cp.async per element, each with int64 clamps and
// mask tests), two __syncthreads per 1024-cell tile, a dim-0 halo re-read
// by every tile (slabs 1.27x the tile in 2D, 2.0x in 3D) and 4 of 8 blocks
// resident.  The design for Hopper:
//
// * A block owns a lateral tile (2D: t_x columns; 3D: t_y x t_x columns, a
//   thread per column) and a segment of the walk dim (dim 0 of the
//   program) and STREAMS through it in chunks of R rows.  The chunks land
//   in a ring of D = stages * R rows in shared memory, so every input row
//   is copied once per lateral tile: no walk-dim halo is re-read, and the
//   lateral halo is a few columns (2D 128+8 of 128).  Each thread walks
//   its column R rows at a time (R unrolled, outputs held in registers
//   until the rows are done), so a row's vertical neighbours are read from
//   the ring once and kept in registers by the compiler; offsets are int32
//   and no division is taken per cell.
// * Copies are 16 bytes (cp.async.cg) wherever the strides allow (the
//   host picks the copy width W from the base pointers and strides before
//   the launch: 16, 8 or 4 bytes, or per element where none fits); the
//   slab's x halo is rounded out to whole copy chunks, so every line starts
//   16-byte aligned.  A chunk of rows whose slab lies inside the domain
//   (and, for programs with adjoint inputs, inside [alo, ahi)) is copied
//   wide, with no clamp and no mask; a chunk that touches an edge (a few
//   percent of the chunks at 8192^2) takes the per-element path, which
//   applies the domain semantics: primal halo cells edge-clamped, adjoint
//   cells 0 outside the domain and outside [alo, ahi) (zero-fill by
//   cp.async's source size 0).  bf16 storage stays bf16 in the ring and is
//   widened to float at each read.
// * `stages` ring slots (host-picked, at most kMaxStages), each with a
//   `full` and an `empty` mbarrier: a
//   chunk's copies arrive on its full barrier (cp.async.mbarrier.arrive),
//   threads wait on it before computing and arrive on `empty` after, and
//   a slot is refilled only once every thread released it — no block-wide
//   barrier per chunk, so threads of a block drift and the copies of the
//   next chunk are in flight while this one is computed.
// * Outputs are stored from registers with the INTERIOR write window
//   (0 on the ghost frame; an accumulation output is prev everywhere and
//   prev + val inside, as in stencil_step.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"
#include "stencil_step.cuh"

namespace psat_rt {

constexpr int kMaxThreads = 256;  // lateral tile cells, one thread each
// ring slots: chunk c reads chunks c-1, c and c+1 (its rows and their
// walk-dim halo), so stages - 3 chunks are in flight beyond them
constexpr int kMaxStages = 16;
// rows a thread computes in one unrolled run (3D chunks are 2 planes)
template <int ND>
constexpr int kRun = ND == 3 ? 2 : 4;

// Every domain is (z, y, x): a 2D one is (1, n0, n1), with z strides 0.
// The walk dim is z in 3D and y in 2D; the lateral dims are the ones after
// it.  A ring row holds `lines` lateral lines (3D: e[1]; 2D: 1) of e[2]
// elements each.
template <typename S, int NIN, int NOUT>
struct SlabParams {
    const S* in[NIN];
    int64_t in_st[NIN][3];
    S* out[NOUT];
    int64_t out_st[NOUT][3];
    int64_t n[3];
    int64_t wlo[3], whi[3];  // INTERIOR write window [wlo, whi)
    int64_t alo[3], ahi[3];  // valid window of adjoint cells [alo, ahi)
    int64_t vlo[3], vhi[3];  // where a chunk's slab may be copied wide
    int lo[3];               // halo below (x: rounded up to the copy width)
    int t[3];                // lateral tile (walk dim: 1)
    int e[3];                // lateral slab extents (walk dim: 1)
    int nt[3];               // lateral tiles per dim (walk dim: 1)
    int rows;                // R: rows a chunk, >= the walk-dim reach
    int depth;               // D = stages * R ring rows, a power of two
    int zlen;                // walk-dim segment of a block
    int nseg;
    int lines, row;          // lateral lines a ring row; elements a ring row
};

__device__ __forceinline__ uint32_t umulhi(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}

// i / d for i, d < 2^16 through a multiplier m = ceil(2^32 / d), exact
// there (i * (m * d - 2^32) < 2^32).
struct Div {
    uint32_t d, m;
    __device__ __forceinline__ explicit Div(int dv)
        : d((uint32_t)dv), m(0xffffffffu / (uint32_t)dv + 1u) {}
    __device__ __forceinline__ int q(int i) const {
        return d == 1 ? i : (int)umulhi((uint32_t)i, m);
    }
};

// The emitted body's reader: offsets (o0, o1, o2) of dims (0, 1, 2) of the
// program; o0 along the walk dim (ring rows), then the lateral dims.
template <typename T, typename S, int ND>
struct RingCell {
    const S* s;  // plane 0, ring row 0, the cell's lateral position
    int q;       // the cell's ring row (before the mask)
    int mask, row, plane, pitch;

    __device__ __forceinline__ T at(int k, int o0, int o1, int o2) const {
        const int lat = ND == 3 ? o1 * pitch + o2 : o1;
        return psat::ld<T>(s + k * plane + ((q + o0) & mask) * row + lat);
    }
    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        return at(k, o0, o1, o2);
    }
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        return at(k, o0, o1, o2);
    }
};

// ---- shared-memory barriers and asynchronous copies --------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#if defined(__CUDA_ARCH__)
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#else
    return 0;
#endif
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
#if defined(__CUDA_ARCH__)
    asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
                 "r"(count)
                 : "memory");
#elif defined(PSAT_HOST_MOCK)
    psat_mock::mbar_init(b, count);
#endif
}

// arrive with release semantics: this thread's shared-memory stores (and
// reads) before it are ordered before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
#if defined(__CUDA_ARCH__)
    uint64_t state;
    asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
                 : "=l"(state)
                 : "r"(smem_addr(b))
                 : "memory");
    (void)state;
#elif defined(PSAT_HOST_MOCK)
    psat_mock::mbar_arrive(b);
#endif
}

// arrive once this thread's cp.async copies issued so far have landed
// (.noinc: the arrival counts against the barrier's expected count)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* b) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                     smem_addr(b))
                 : "memory");
#elif defined(PSAT_HOST_MOCK)
    psat_mock::mbar_arrive(b);
#endif
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
#if defined(__CUDA_ARCH__)
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(b)), "r"(parity)
            : "memory");
    } while (!done);
#elif defined(PSAT_HOST_MOCK)
    psat_mock::mbar_wait(b, parity);
#endif
}

// W-byte copy (W = 16: cp.async.cg, which bypasses L1; 8 or 4: .ca)
template <int W>
__device__ __forceinline__ void copy_wide(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    if constexpr (W == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src), "n"(W)
                     : "memory");
#else
    for (int i = 0; i < W; ++i)
        static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
#endif
}

// one element, zero-filled where !ok (source size 0); the source address
// is always inside the array
template <typename S>
__device__ __forceinline__ void copy_elem(S* dst, const S* src, bool ok) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(sizeof(S)), "r"(ok ? (int)sizeof(S) : 0)
                 : "memory");
#else
    *dst = ok ? *src : S{};
#endif
}

__device__ __forceinline__ int64_t clamp(int64_t c, int64_t n) {
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

// The copy loops' divisors (items dealt out to threads are decomposed by
// multiplication), computed once per block.
struct CopyPlan {
    Div chunks, elems, lines, rows;  // by copies a line, elements a line, ...
    int cpr;                         // copies of width W a slab line
};

// Issue the copies of load chunk lc (global walk rows g0 .. g0 + R) into
// its ring rows and arrive on `full`.  W: the copy width in bytes (0: per
// element with the domain semantics, the route where no width fits the
// strides); a chunk whose slab leaves [vlo, vhi) takes the per-element
// path on any route.  ADJ: bit k set when input plane k is an adjoint.
template <typename S, int WD, int NIN, int NOUT, unsigned ADJ, int W>
__device__ __forceinline__ void fill_chunk(const SlabParams<S, NIN, NOUT>& p,
                                           const CopyPlan& cp, S* ring,
                                           int lc, int64_t g0,
                                           const int64_t* org, bool lat_wide,
                                           uint64_t* full) {
    const int R = p.rows;
    const bool wide = W > 0 && lat_wide && g0 >= p.vlo[WD]
                      && g0 + R <= p.vhi[WD];
    const int q0 = lc * R;
    const int mask = p.depth - 1;
    bool plain = false;
    if (wide) {
        constexpr int V = W > 0 ? W / (int)sizeof(S) : 1;
        const int cpr = cp.cpr;  // p.e[2] / V
        const int total = NIN * R * p.lines * cpr;
        for (int i = threadIdx.x; i < total; i += blockDim.x) {
            const int a = cp.chunks.q(i), ch = i - a * cpr;
            const int b = cp.lines.q(a), line = a - b * p.lines;
            const int k = cp.rows.q(b), r = b - k * R;
            const S* src = p.in[k] + (g0 + r) * p.in_st[k][WD]
                           + (org[1] + line) * p.in_st[k][1]
                           + org[2] + ch * V;
            S* dst = ring + (size_t)k * p.depth * p.row
                     + ((q0 + r) & mask) * p.row + line * p.e[2] + ch * V;
            copy_wide<W>(dst, src);
        }
    } else {
        const int e2 = p.e[2];
        const int total = NIN * R * p.lines * e2;
        for (int i = threadIdx.x; i < total; i += blockDim.x) {
            const int a = cp.elems.q(i), sx = i - a * e2;
            const int b = cp.lines.q(a), line = a - b * p.lines;
            const int k = cp.rows.q(b), r = b - k * R;
            int64_t c[3];
            c[WD] = g0 + r;
            if (WD == 0) c[1] = org[1] + line;
            c[2] = org[2] + sx;
            if (WD == 1) c[0] = 0;
            const bool adj = (ADJ >> k) & 1u;
            bool ok = true;
            if (adj) {
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    ok = ok && c[d] >= p.alo[d] && c[d] < p.ahi[d];
            }
            const S* src = p.in[k] + clamp(c[0], p.n[0]) * p.in_st[k][0]
                           + clamp(c[1], p.n[1]) * p.in_st[k][1]
                           + clamp(c[2], p.n[2]) * p.in_st[k][2];
            S* dst = ring + (size_t)k * p.depth * p.row
                     + ((q0 + r) & mask) * p.row + line * e2 + sx;
            if constexpr (sizeof(S) >= 4) {
                copy_elem(dst, src, ok);
            } else {
                *dst = ok ? *src : S{};
                plain = true;
            }
        }
    }
    if constexpr (sizeof(S) >= 4) {
        mbar_arrive_copies(full);
    } else {
        // bf16: wide chunks land by cp.async, edge chunks by plain stores
        if (plain || !wide) mbar_arrive(full);
        else mbar_arrive_copies(full);
    }
}

// Persistent march of one block over its segment of the walk dim.
template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          unsigned ADJ, int W, typename Body>
__global__ void __launch_bounds__(kMaxThreads, 3)
row_tiled(const __grid_constant__ SlabParams<S, NIN, NOUT> p) {
    constexpr int WD = ND == 3 ? 0 : 1;  // the walk dim in (z, y, x)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ uint64_t bars[2 * kMaxStages];  // full[], empty[]
    uint64_t* const full = bars;
    uint64_t* const empty = bars + kMaxStages;
    S* ring = reinterpret_cast<S*>(smem_raw);

    // the block's lateral tile and segment (one division each, per block)
    int b = blockIdx.x;
    const int tx = b % p.nt[2];
    b /= p.nt[2];
    const int ty = ND == 3 ? b % p.nt[1] : 0;
    const int seg = ND == 3 ? b / p.nt[1] : b;
    const int64_t zs = (int64_t)seg * p.zlen;
    const int64_t ze = zs + p.zlen < p.n[WD] ? zs + p.zlen : p.n[WD];
    int64_t org[3];  // the slab's global origin in the lateral dims
    org[0] = 0;
    org[1] = ND == 3 ? (int64_t)ty * p.t[1] - p.lo[1] : 0;
    org[2] = (int64_t)tx * p.t[2] - p.lo[2];
    bool lat_wide = true;
#pragma unroll
    for (int d = WD + 1; d < 3; ++d)
        lat_wide = lat_wide && org[d] >= p.vlo[d]
                   && org[d] + p.e[d] <= p.vhi[d];

    // the thread's column
    const int lx = ND == 3 ? (int)threadIdx.x % p.t[2] : (int)threadIdx.x;
    const int ly = ND == 3 ? (int)threadIdx.x / p.t[2] : 0;
    int64_t gl[3];
    gl[0] = 0;
    gl[1] = ND == 3 ? (int64_t)ty * p.t[1] + ly : 0;
    gl[2] = (int64_t)tx * p.t[2] + lx;
    const bool lat_in = gl[2] < p.n[2] && (ND == 2 || gl[1] < p.n[1]);
    bool lat_inside = true;
#pragma unroll
    for (int d = WD + 1; d < 3; ++d)
        lat_inside = lat_inside && gl[d] >= p.wlo[d] && gl[d] < p.whi[d];
    int64_t out_lat[NOUT];
#pragma unroll
    for (int k = 0; k < NOUT; ++k)
        out_lat[k] = gl[1] * p.out_st[k][1] + gl[2] * p.out_st[k][2];
    const int lat_off = ND == 3 ? (ly + p.lo[1]) * p.e[2] + lx + p.lo[2]
                                : lx + p.lo[2];

    if (threadIdx.x == 0) {
        for (int s = 0; s < kMaxStages; ++s) {
            mbar_init(&full[s], blockDim.x);
            mbar_init(&empty[s], blockDim.x);
        }
    }
    __syncthreads();

    const int R = p.rows;
    const int ns = p.depth / R;  // ring slots, a power of two
    int lns = 0;
    while ((1 << lns) < ns) ++lns;
    constexpr int V = W > 0 ? W / (int)sizeof(S) : 1;
    const CopyPlan cp{Div(p.e[2] / V), Div(p.e[2]), Div(p.lines), Div(R),
                      p.e[2] / V};
    const int nchunk = (int)((ze - zs + R - 1) / R);
    const int nload = nchunk + 2;  // chunk -1 (rows below) .. nchunk
    // load chunk lc covers global rows zs + (lc - 1) R .. + R
    for (int lc = 0; lc < ns - 1 && lc < nload; ++lc)
        fill_chunk<S, WD, NIN, NOUT, ADJ, W>(p, cp, ring, lc,
                                             zs + (int64_t)(lc - 1) * R, org,
                                             lat_wide, &full[lc]);
    const RingCell<T, S, ND> base{ring + lat_off, 0, p.depth - 1, p.row,
                                  p.depth * p.row, p.e[2]};
    for (int c = 0; c < nchunk; ++c) {
        const int lf = c + ns - 1;
        if (lf < nload) {
            if (lf >= ns)  // its slot held chunk lf - ns
                mbar_wait(&empty[lf & (ns - 1)],
                          (uint32_t)(((lf >> lns) - 1) & 1));
            fill_chunk<S, WD, NIN, NOUT, ADJ, W>(
                p, cp, ring, lf, zs + (int64_t)(lf - 1) * R, org, lat_wide,
                &full[lf & (ns - 1)]);
        }
        // chunk c reads load chunks c (rows below), c + 1 and c + 2
        for (int j = c; j < c + 3 && j < nload; ++j)
            mbar_wait(&full[j & (ns - 1)], (uint32_t)((j >> lns) & 1));
        const int64_t g0 = zs + (int64_t)c * R;
        const int q0 = (c + 1) * R;
        int r = 0;
        constexpr int RUN = kRun<ND>;
        for (; r + RUN <= R; r += RUN) {
            T v[RUN][NOUT];
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
                RingCell<T, S, ND> cell = base;
                cell.q = q0 + r + j;
                const int64_t g = g0 + r + j;
                const bool inside = MODE != psat::INTERIOR
                                    || (lat_inside && g >= p.wlo[WD]
                                        && g < p.whi[WD]);
#pragma unroll
                for (int k = 0; k < NOUT; ++k) v[j][k] = T(0);
                Body::template run<T>(cell, inside, v[j]);
            }
#pragma unroll
            for (int j = 0; j < RUN; ++j) {
                const int64_t g = g0 + r + j;
                if (lat_in && g < ze) {
#pragma unroll
                    for (int k = 0; k < NOUT; ++k)
                        psat::st(p.out[k] + out_lat[k] + g * p.out_st[k][WD],
                                 v[j][k]);
                }
            }
        }
        for (; r < R; ++r) {
            RingCell<T, S, ND> cell = base;
            cell.q = q0 + r;
            const int64_t g = g0 + r;
            const bool inside = MODE != psat::INTERIOR
                                || (lat_inside && g >= p.wlo[WD]
                                    && g < p.whi[WD]);
            T v[NOUT];
#pragma unroll
            for (int k = 0; k < NOUT; ++k) v[k] = T(0);
            Body::template run<T>(cell, inside, v);
            if (lat_in && g < ze) {
#pragma unroll
                for (int k = 0; k < NOUT; ++k)
                    psat::st(p.out[k] + out_lat[k] + g * p.out_st[k][WD],
                             v[k]);
            }
        }
        // load chunk c is read for the last time
        mbar_arrive(&empty[c & (ns - 1)]);
    }
}

}  // namespace psat_rt
