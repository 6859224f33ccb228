// Host side of every launcher: run a launch with the tensors' device
// current, then give the caller's thread its current device back.
#pragma once

#include <cuda_runtime.h>

namespace psat {

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
