// Shared by every kernel: the storage-type conversions of loads and stores,
// and, on the host side of every launcher, running a launch with the
// tensors' device current.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace psat {

// Storage type S (float, double or __nv_bfloat16) and compute type T: a
// kernel keeps S in device memory and computes (and tiles in shared
// memory) in T; bf16 storage computes in float.  Every global load goes
// through ld and every global store through st.
template <typename T, typename S>
__device__ __forceinline__ T ld(const S* p) {
    if constexpr (std::is_same_v<S, __nv_bfloat16>)
        return T(__bfloat162float(*p));
    else
        return T(*p);
}

template <typename S, typename T>
__device__ __forceinline__ void st(S* p, T v) {
    if constexpr (std::is_same_v<S, __nv_bfloat16>)
        *p = __float2bfloat16(float(v));
    else
        *p = S(v);
}

// `launch()` returns the launch's cudaError_t; so does on_device (0 on
// success), reporting a failed restore only when the launch succeeded.
template <typename F>
inline int on_device(int device, F launch) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err != cudaSuccess) return (int)err;
    if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
        return (int)err;
    err = launch();
    if (prev != device) {
        cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

}  // namespace psat
