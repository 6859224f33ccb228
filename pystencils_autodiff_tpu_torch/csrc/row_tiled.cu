// Launcher stub of the slab single step (row_tiled.cuh), for one variant.
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py (form "slab"), which defines PSAT_ND, PSAT_NIN,
// PSAT_NOUT, `struct PsatBody`, PSAT_S, PSAT_T, PSAT_DTYPE, PSAT_MODE
// (INTERIOR or FULL) and PSAT_ADJ (bit k: input plane k is an adjoint).
// Exposes a plain C interface, loaded with ctypes:
//
//   int psat_slab_launch(int dtype, int mode, int device,
//                        const void* in_ptrs,  // void*[PSAT_NIN]
//                        const void* in_st,    // int64[PSAT_NIN * 3] (z, y, x)
//                        const void* out_ptrs, // void*[PSAT_NOUT]
//                        const void* out_st,   // int64[PSAT_NOUT * 3]
//                        const void* geo,      // int64[5 * 3]: n, wlo, whi, alo, ahi
//                        const void* slab,     // int64[10]: lo[3], hi[3], t[3], blocks per SM
//                        void* stream)
//
// Every per-dim array is (z, y, x), a 2D domain (1, n0, n1).  A dtype or
// mode the library was not built for returns cudaErrorInvalidValue.
// Launches on `device` and restores the thread's current device.  Returns
// the cudaGetLastError() of the launch (0 on success); it does not
// synchronise.

static cudaError_t psat_slab_launch_t(const void* const* in,
                                      const int64_t* in_st, void* const* out,
                                      const int64_t* out_st,
                                      const int64_t* geo, const int64_t* slab,
                                      int device, cudaStream_t stream) {
    using S = PSAT_S;
    using T = PSAT_T;
    psat_rt::SlabParams<S, PSAT_NIN, PSAT_NOUT> p;
    for (int k = 0; k < PSAT_NIN; ++k) {
        p.in[k] = static_cast<const S*>(in[k]);
        for (int d = 0; d < 3; ++d) p.in_st[k][d] = in_st[k * 3 + d];
    }
    for (int k = 0; k < PSAT_NOUT; ++k) {
        p.out[k] = static_cast<S*>(out[k]);
        for (int d = 0; d < 3; ++d) p.out_st[k][d] = out_st[k * 3 + d];
    }
    p.ntiles = 1;
    for (int d = 0; d < 3; ++d) {
        p.n[d] = geo[d];
        p.wlo[d] = geo[3 + d];
        p.whi[d] = geo[6 + d];
        p.alo[d] = geo[9 + d];
        p.ahi[d] = geo[12 + d];
        p.lo[d] = (int)slab[d];
        p.t[d] = (int)slab[6 + d];
        p.e[d] = (int)(slab[6 + d] + slab[d] + slab[3 + d]);
        if (p.t[d] < 1 || p.n[d] < 1) return cudaErrorInvalidValue;
        p.nt[d] = (p.n[d] + p.t[d] - 1) / p.t[d];
        p.ntiles *= p.nt[d];
    }
    p.plane = p.e[0] * p.e[1] * p.e[2];
    const size_t smem = 2 * (size_t)PSAT_NIN * p.plane * sizeof(T);
    auto kernel = psat_rt::row_tiled<T, S, PSAT_MODE, PSAT_ND, PSAT_NIN,
                                     PSAT_NOUT, PSAT_ADJ, PsatBody>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (int64_t)sms * slab[9];
    const unsigned grid = (unsigned)(p.ntiles < blocks ? p.ntiles : blocks);
    kernel<<<grid, psat_rt::kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

extern "C" int psat_slab_launch(int dtype, int mode, int device,
                                const void* in_ptrs, const void* in_st,
                                const void* out_ptrs, const void* out_st,
                                const void* geo, const void* slab,
                                void* stream) {
    if (dtype != PSAT_DTYPE || mode != PSAT_MODE)
        return (int)cudaErrorInvalidValue;
    const void* const* in = static_cast<const void* const*>(in_ptrs);
    void* const* out = static_cast<void* const*>(const_cast<void*>(out_ptrs));
    const int64_t* ist = static_cast<const int64_t*>(in_st);
    const int64_t* ost = static_cast<const int64_t*>(out_st);
    const int64_t* g = static_cast<const int64_t*>(geo);
    const int64_t* sl = static_cast<const int64_t*>(slab);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        return psat_slab_launch_t(in, ist, out, ost, g, sl, device, s);
    });
}

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
