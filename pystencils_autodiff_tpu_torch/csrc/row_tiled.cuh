// One stencil step over shared-memory slabs on a Hopper GPU: the
// hand-written CUDA port of pystencils_autodiff_tpu/ops/pallas_kernel.py::
// _run_row_tiled (tiles of the leading dim, tile + halo slabs DMA'd into
// two VMEM slots, compute on one slot while the other loads).
//
// What it computes is stencil_step.cuh's INTERIOR and FULL modes (scalar
// fields, 2 or 3 spatial dims), with the same emitted `PsatBody::run`; the
// reader `c` here reads a shared-memory slab instead of device memory.
//
// Design for Hopper (not the TPU's block structure):
//
// * Tiles are t0 rows of dim 0 by a lateral extent of the other dims (the
//   TPU's tile spans whole rows: one 8192-wide f32 row is 32 KB, a 384²
//   plane 576 KB).  The host picks the tile and the blocks per SM from the
//   shared-memory reckoning (ops/row_tiled.py::slab_tile).
// * Persistent blocks: a few per SM; block b walks tiles b, b + grid, ...
// * Two slab slots: while slot i%2 is computed, the next tile's slab is
//   copied into slot (i+1)%2 with cp.async (4- or 8-byte copies, which
//   zero-fill where the source size is 0).  bf16 storage is widened to
//   float on the way in, by plain loads (cp.async copies bytes as they
//   are), so that slot fills before it is needed but does not overlap.
// * Domain semantics are applied once, at load: a primal halo cell is the
//   edge-clamped cell; an adjoint cell is 0 outside the domain and outside
//   the forward interior [alo, ahi) (the fused exact-VJP mask, the same
//   semantics as stencil_step.cuh's `ra`, tested on the coordinates of the
//   cell read).  No load leaves the array.  The body then reads the slab
//   with plain int32 offsets: no clamp, mask or int64 index per read,
//   which is what holds the per-cell kernel's f32 single step at 25–71 %
//   of copy bandwidth (PERF.md).
// * Outputs are stored from registers with the INTERIOR write window
//   (0 on the ghost frame; an accumulation output is prev everywhere and
//   prev + val inside, as in stencil_step.cuh).
//
// Bound: memory bandwidth, as the per-cell kernel's — each input plane
// read once and each output plane written once; the slabs add the halo
// rows and columns (1.3× the tile in 2D at the default 8 × 128 tile) from
// L2.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"
#include "stencil_step.cuh"

namespace psat_rt {

constexpr int kThreads = 256;

// Every domain is (z, y, x): a 2D one is (1, n0, n1), with z strides 0.
template <typename S, int NIN, int NOUT>
struct SlabParams {
    const S* in[NIN];
    int64_t in_st[NIN][3];
    S* out[NOUT];
    int64_t out_st[NOUT][3];
    int64_t n[3];
    int64_t wlo[3], whi[3];  // INTERIOR write window [wlo, whi)
    int64_t alo[3], ahi[3];  // valid window of adjoint cells [alo, ahi)
    int lo[3];               // halo below the tile
    int t[3];                // tile extents
    int e[3];                // slab extents: t + lo + hi
    int64_t nt[3];           // tiles along each dim
    int64_t ntiles;
    int plane;               // e[0] * e[1] * e[2]
};

// The emitted body's reader: offsets (o0, o1, o2) of dims (0, 1, 2) of the
// program; in 2D o0 is y and o1 x.
template <typename T, int ND>
struct SlabCell {
    const T* s;  // the cell in plane 0 of the slot
    int plane, sz, sy;

    __device__ __forceinline__ T at(int k, int o0, int o1, int o2) const {
        const int off = ND == 3 ? o0 * sz + o1 * sy + o2 : o0 * sy + o1;
        return s[k * plane + off];
    }
    __device__ __forceinline__ T rp(int k, int o0, int o1, int o2) const {
        return at(k, o0, o1, o2);
    }
    __device__ __forceinline__ T ra(int k, int o0, int o1, int o2) const {
        return at(k, o0, o1, o2);
    }
};

// cp.async of one element, zero-filled where !ok (source size 0); the
// source address is always inside the array.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int size = ok ? (int)sizeof(T) : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(T)), "r"(size));
#else
    *dst = ok ? *src : T(0);
#endif
}

__device__ __forceinline__ void commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most the newest group of this thread is in flight
__device__ __forceinline__ void wait_all_but_newest() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

template <typename T, typename S>
constexpr bool kAsync = std::is_same_v<T, S> && (sizeof(S) == 4 || sizeof(S) == 8);

__device__ __forceinline__ int64_t clamp(int64_t c, int64_t n) {
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

template <int NIN, int NOUT, typename S>
__device__ __forceinline__ void tile_origin(const SlabParams<S, NIN, NOUT>& p,
                                            int64_t tile, int64_t* o) {
    const int64_t per_z = p.nt[1] * p.nt[2];
    const int64_t tz = tile / per_z;
    const int64_t r = tile - tz * per_z;
    const int64_t ty = r / p.nt[2];
    o[0] = tz * p.t[0];
    o[1] = ty * p.t[1];
    o[2] = (r - ty * p.nt[2]) * p.t[2];
}

// Issue the copies of one tile's slab (every input plane) into `slot`; a
// warp fills one slab row at a time, lanes along x.  ADJ: bit k set when
// input plane k is an adjoint.
template <typename T, typename S, int NIN, int NOUT, unsigned ADJ>
__device__ __forceinline__ void load_slab(const SlabParams<S, NIN, NOUT>& p,
                                          T* slot, int64_t tile) {
    int64_t o[3];
    tile_origin(p, tile, o);
    const int64_t z0 = o[0] - p.lo[0], y0 = o[1] - p.lo[1],
                  x0 = o[2] - p.lo[2];
    const int rows_per_plane = p.e[0] * p.e[1];
    const int rows = NIN * rows_per_plane;
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
        const int k = r / rows_per_plane;
        const int rr = r - k * rows_per_plane;
        const int sz = rr / p.e[1];
        const int sy = rr - sz * p.e[1];
        const int64_t gz = z0 + sz, gy = y0 + sy;
        const bool adj = (ADJ >> k) & 1u;
        const bool row_ok = !adj || (gz >= p.alo[0] && gz < p.ahi[0] &&
                                     gy >= p.alo[1] && gy < p.ahi[1]);
        const S* src = p.in[k] + clamp(gz, p.n[0]) * p.in_st[k][0] +
                       clamp(gy, p.n[1]) * p.in_st[k][1];
        T* dst = slot + k * p.plane + (sz * p.e[1] + sy) * p.e[2];
        for (int sx = lane; sx < p.e[2]; sx += 32) {
            const int64_t gx = x0 + sx;
            const bool ok = row_ok && (!adj || (gx >= p.alo[2] && gx < p.ahi[2]));
            const S* s = src + clamp(gx, p.n[2]) * p.in_st[k][2];
            if constexpr (kAsync<T, S>)
                copy_async(dst + sx, s, ok);
            else
                dst[sx] = ok ? psat::ld<T>(s) : T(0);
        }
    }
}

template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          typename Body>
__device__ __forceinline__ void compute_tile(const SlabParams<S, NIN, NOUT>& p,
                                             const T* slot, int64_t tile) {
    int64_t o[3];
    tile_origin(p, tile, o);
    const int txy = p.t[1] * p.t[2];
    const int cells = p.t[0] * txy;
    for (int i = threadIdx.x; i < cells; i += kThreads) {
        const int cz = i / txy;
        const int r = i - cz * txy;
        const int cy = r / p.t[2];
        const int cx = r - cy * p.t[2];
        const int64_t g[3] = {o[0] + cz, o[1] + cy, o[2] + cx};
        if (g[0] >= p.n[0] || g[1] >= p.n[1] || g[2] >= p.n[2]) continue;
        bool inside = true;
        if (MODE == psat::INTERIOR) {
#pragma unroll
            for (int d = 0; d < 3; ++d)
                inside = inside && g[d] >= p.wlo[d] && g[d] < p.whi[d];
        }
        const SlabCell<T, ND> c{
            slot + ((cz + p.lo[0]) * p.e[1] + cy + p.lo[1]) * p.e[2] + cx +
                p.lo[2],
            p.plane, p.e[1] * p.e[2], p.e[2]};
        T v[NOUT];
#pragma unroll
        for (int k = 0; k < NOUT; ++k) v[k] = T(0);
        Body::template run<T>(c, inside, v);
#pragma unroll
        for (int k = 0; k < NOUT; ++k)
            psat::st(p.out[k] + g[0] * p.out_st[k][0] + g[1] * p.out_st[k][1] +
                         g[2] * p.out_st[k][2],
                     v[k]);
    }
}

// Persistent blocks over the tiles, two slab slots (dynamic shared memory
// of 2 * NIN * plane elements of T).
template <typename T, typename S, int MODE, int ND, int NIN, int NOUT,
          unsigned ADJ, typename Body>
__global__ void __launch_bounds__(kThreads)
row_tiled(const __grid_constant__ SlabParams<S, NIN, NOUT> p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* slots = reinterpret_cast<T*>(smem_raw);
    const int64_t stride = gridDim.x;
    int64_t tile = blockIdx.x;
    if (tile >= p.ntiles) return;
    load_slab<T, S, NIN, NOUT, ADJ>(p, slots, tile);
    commit();
    for (int i = 0; tile < p.ntiles; ++i, tile += stride) {
        const T* cur = slots + (i & 1) * NIN * p.plane;
        T* nxt = slots + ((i + 1) & 1) * NIN * p.plane;
        if (tile + stride < p.ntiles)
            load_slab<T, S, NIN, NOUT, ADJ>(p, nxt, tile + stride);
        commit();                // (empty on the last tile)
        wait_all_but_newest();   // this thread's copies into `cur` landed
        __syncthreads();         // ... and every thread's
        compute_tile<T, S, MODE, ND, NIN, NOUT, Body>(p, cur, tile);
        __syncthreads();         // `cur` is refilled two tiles on
    }
}

}  // namespace psat_rt
