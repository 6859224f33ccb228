// The card's probes: what an operation costs inside a kernel, measured with
// the data held on chip.  The port of the JAX package's two TPU probe
// kernels (utils/probes.py wraps them; its plain versions are the
// reference):
//
// * fma_chain replaces benchmarks/round3_tpu.py::sec_vpu's kernel: each
//   thread loads E elements, chains `reps` fma(x, a, b) on each in
//   registers (E independent chains: the latency of one fma hides behind
//   the others and behind the other warps) and writes once.  Bound: the
//   card's fma rate (2 flops an fma); the bytes are one read and one write
//   of the array, negligible where reps is large.
// * ladder<RUNG> replaces benchmarks/round4_tpu.py::_ladder_kernel: a block
//   loads its tile once, runs acc = rung(acc, x, i) `reps` times on chip,
//   each rep depending on the last, and writes once.  Bound: the rung's
//   instructions (the fma baseline is subtracted by the caller).  A block
//   owns 32 columns (one lane each) by 8E rows (warp w holds rows w + 8j,
//   j < E, in registers).  The rungs:
//     FMA       acc = fma(acc, a, b)                       (the baseline)
//     SHUFFLE   acc = shfl(acc, lane - s) * a, s = 1 + i%2  (the TPU's lane
//               rotate: a roll inside each group of 32 columns; the warp
//               march's lateral read)
//     SMEM_ROW  acc = fma(acc, a, xs[r + 8(i%2)])          (the aligned
//               slice and the ×8 sublane rotate: a shared-memory read rows
//               over, 32-byte aligned in the column-major tile)
//     SMEM_ODD  acc = fma(acc, a, xs[r + 1 + i%7])         (the misaligned
//               slice: a read at an element offset of 1 … 7, odd for four
//               of the seven)
//     MASKED    acc = (col < cols-1 ? shfl(acc, lane - s) : 0) * a  (the
//               masked lane rotate: every window kernel's edge)
//     CONVERT   acc = float(double(acc) * a + b)  in float64 (one addend of
//               an accumulate="dd" float32 body: convert, mul, add, round)
//     DD        acc = ddadd(ddmul(a, acc), b)  on double-word pairs (one
//               addend of an accumulate="dd" float64 body: TwoProd and
//               TwoSums, csrc/dd.cuh)
//   The TPU's single-sublane rotate has no counterpart: moving a value to
//   another row a thread holds is a rename of registers, no instruction.
//   The tile sits in shared memory column-major with an odd pitch, so both
//   slice rungs read conflict-free (a TPU sublane slice off the (8, 128)
//   tiling costs a relayout).  The slice rungs read through a volatile
//   pointer: nothing writes the tile during the reps, so the compiler
//   would otherwise load each of the 16 distinct values once and keep them
//   in registers, and the rung would time no shared-memory read.  With it,
//   every rep issues one LDS a row, as the TPU rung reads its slice from
//   VMEM every rep (chip_smoke.py counts the LDS in each rung's SASS).
//
// Each rep's offsets (i%2, i%7) are constants: the reps run in blocks of 14
// unrolled, the last reps%14 as a loop.
#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"
#include "on_device.cuh"

namespace psat_probe {

constexpr int kThreads = 256;
constexpr int kFmaE = 4;     // elements a thread in fma_chain
constexpr int kE = 8;        // rows a thread in the ladder
constexpr int kRows = 8 * kE;          // a ladder block's rows
constexpr int kPad = 8;                // rows below the tile the slices read
constexpr int kPitch = kRows + kPad + 1;  // odd: conflict-free columns

enum Rung : int { FMA = 0, SHUFFLE = 1, SMEM_ROW = 2, SMEM_ODD = 3,
                  MASKED = 4, CONVERT = 5, DD = 6 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
fma_chain(const T* __restrict__ x, T* __restrict__ out, int64_t n, int reps,
          T a, T b) {
    const int64_t stride = int64_t(gridDim.x) * kThreads;
    const int64_t base = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    T v[kFmaE];
#pragma unroll
    for (int j = 0; j < kFmaE; ++j) {
        const int64_t i = base + j * stride;
        v[j] = i < n ? x[i] : T(0);
    }
#pragma unroll 8
    for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int j = 0; j < kFmaE; ++j) v[j] = fma(v[j], a, b);
    }
#pragma unroll
    for (int j = 0; j < kFmaE; ++j) {
        const int64_t i = base + j * stride;
        if (i < n) out[i] = v[j];
    }
}

// the accumulator a thread keeps per row: T, or a double-word pair (DD)
template <int RUNG, typename T>
struct Acc {
    using type = T;
};
template <>
struct Acc<DD, double> {
    using type = psat::dd2;
};

template <int RUNG, typename T>
__device__ __forceinline__ typename Acc<RUNG, T>::type start(T v) {
    if constexpr (RUNG == DD)
        return psat::dd2{v, 0.0};
    else
        return v;
}

template <int RUNG, typename T>
__device__ __forceinline__ T finish(typename Acc<RUNG, T>::type v) {
    if constexpr (RUNG == DD)
        return psat::ddto<double>(v);
    else
        return v;
}

// one rep on every row of the thread; i2 = i % 2, i7 = i % 7
template <int RUNG, typename T, typename A>
__device__ __forceinline__ void rep(A (&acc)[kE], const volatile T* col,
                                    int i2, int i7, int lane, bool edge) {
    const T a = T(1.0000001), b = T(1e-7);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
        if constexpr (RUNG == FMA) {
            acc[j] = fma(acc[j], a, b);
        } else if constexpr (RUNG == SHUFFLE || RUNG == MASKED) {
            const T r = __shfl_sync(0xffffffffu, acc[j], (lane - 1 - i2) & 31);
            acc[j] = (RUNG == MASKED && edge ? T(0) : r) * a;
        } else if constexpr (RUNG == SMEM_ROW) {
            acc[j] = fma(acc[j], a, col[8 * j + 8 * i2]);
        } else if constexpr (RUNG == SMEM_ODD) {
            acc[j] = fma(acc[j], a, col[8 * j + 1 + i7]);
        } else if constexpr (RUNG == CONVERT) {
            acc[j] = psat::ddto<float>(psat::ddadd(
                psat::ddmul(psat::ddv<float>(acc[j]), 1.0000001), 1e-7));
        } else {  // DD
            acc[j] = psat::ddadd(psat::ddmul(psat::ddk<double>(1.0000001),
                                             acc[j]),
                                 psat::ddk<double>(1e-7));
        }
    }
}

// x: (rows + kPad) × cols, out: rows × cols, both row-major
template <int RUNG, typename T>
__global__ void __launch_bounds__(kThreads)
ladder(const T* __restrict__ x, T* __restrict__ out, int64_t cols, int reps) {
    constexpr bool kSmem = RUNG == SMEM_ROW || RUNG == SMEM_ODD;
    __shared__ T xs[kSmem ? 32 * kPitch : 1];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t c = int64_t(blockIdx.x) * 32 + lane;
    const int64_t r0 = int64_t(blockIdx.y) * kRows;
    using A = typename Acc<RUNG, T>::type;
    A acc[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j)
        acc[j] = start<RUNG, T>(x[(r0 + w + 8 * j) * cols + c]);
    const volatile T* col = xs + lane * kPitch + w;
    if constexpr (kSmem) {
#pragma unroll
        for (int j = 0; j <= kE; ++j)
            xs[lane * kPitch + w + 8 * j] = x[(r0 + w + 8 * j) * cols + c];
        __syncthreads();
    }
    const bool edge = c >= cols - 1;
    int i = 0;
    for (; i + 14 <= reps; i += 14) {
#pragma unroll
        for (int k = 0; k < 14; ++k)
            rep<RUNG, T>(acc, col, k % 2, k % 7, lane, edge);
    }
    for (; i < reps; ++i) rep<RUNG, T>(acc, col, i % 2, i % 7, lane, edge);
#pragma unroll
    for (int j = 0; j < kE; ++j)
        out[(r0 + w + 8 * j) * cols + c] = finish<RUNG, T>(acc[j]);
}

template <typename T>
cudaError_t launch_ladder(int rung, const void* x, void* out, int64_t rows,
                          int64_t cols, int reps, cudaStream_t s) {
    if (rows % kRows || cols % 32 || rows / kRows > 65535)
        return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(cols / 32), (unsigned)(rows / kRows));
    const T* xi = static_cast<const T*>(x);
    T* o = static_cast<T*>(out);
    switch (rung) {
        case FMA: ladder<FMA, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps); break;
        case SHUFFLE: ladder<SHUFFLE, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps); break;
        case SMEM_ROW: ladder<SMEM_ROW, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps); break;
        case SMEM_ODD: ladder<SMEM_ODD, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps); break;
        case MASKED: ladder<MASKED, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps); break;
        case CONVERT:
            if constexpr (std::is_same_v<T, float>)
                ladder<CONVERT, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps);
            else
                return cudaErrorInvalidValue;
            break;
        case DD:
            if constexpr (std::is_same_v<T, double>)
                ladder<DD, T><<<grid, kThreads, 0, s>>>(xi, o, cols, reps);
            else
                return cudaErrorInvalidValue;
            break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* x, void* out, int64_t n, int reps,
                       cudaStream_t s) {
    const int64_t threads = (n + kFmaE - 1) / kFmaE;
    const int64_t blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if (blocks == 0) return cudaSuccess;
    fma_chain<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, reps, T(1.0000001),
        T(1e-7));
    return cudaGetLastError();
}

}  // namespace psat_probe

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The uniform entry (ops/launch.py::run): s = {probe (0: fma_chain,
// 1: ladder), dtype (0: float32, 1: float64), rung, rows, cols, reps},
// a = {input pointer block, output pointer block}.
extern "C" int psat_call(int device, const int64_t* s, const void* const* a,
                         void* stream) {
    const void* x = static_cast<const void* const*>(a[0])[0];
    void* out = static_cast<void* const*>(const_cast<void*>(a[1]))[0];
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int probe = (int)s[0], dtype = (int)s[1], rung = (int)s[2];
    const int64_t rows = s[3], cols = s[4];
    const int reps = (int)s[5];
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    return psat::on_device(device, [&]() -> cudaError_t {
        if (probe == 0)
            return dtype ? psat_probe::launch_fma<double>(x, out, rows * cols,
                                                          reps, st)
                         : psat_probe::launch_fma<float>(x, out, rows * cols,
                                                         reps, st);
        if (probe == 1)
            return dtype ? psat_probe::launch_ladder<double>(rung, x, out, rows,
                                                             cols, reps, st)
                         : psat_probe::launch_ladder<float>(rung, x, out, rows,
                                                            cols, reps, st);
        return cudaErrorInvalidValue;
    });
}
