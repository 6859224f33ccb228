// Launcher stub of the stencil step kernel (stencil_step.cuh).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py, which defines PSAT_ND, PSAT_NIN, PSAT_NOUT and
// `struct PsatBody`.  Exposes a plain C interface, loaded with ctypes:
//
//   int psat_launch(int dtype, int mode, int device,
//                   const void* in_ptrs,   // void*[PSAT_NIN]
//                   const void* in_st,     // int64[PSAT_NIN * PSAT_ND]
//                   const void* out_ptrs,  // void*[PSAT_NOUT]
//                   const void* out_st,    // int64[PSAT_NOUT * PSAT_ND]
//                   const void* geo,       // int64[5 * PSAT_ND]: n, wlo, whi, alo, ahi
//                   void* stream)
//
// dtype 0 = float, 1 = double; mode as psat::Mode.  Launches on `device` and
// restores the thread's current device.  Returns the cudaGetLastError() of
// the launch (0 on success); it does not synchronise.

template <typename T, int MODE>
static cudaError_t psat_launch_t(const void* const* in, const int64_t* in_st,
                                 void* const* out, const int64_t* out_st,
                                 const int64_t* geo, cudaStream_t stream) {
    psat::Params<T, PSAT_ND, PSAT_NIN, PSAT_NOUT> p;
    for (int k = 0; k < PSAT_NIN; ++k) {
        p.in[k] = static_cast<const T*>(in[k]);
        for (int d = 0; d < PSAT_ND; ++d) p.in_st[k][d] = in_st[k * PSAT_ND + d];
    }
    for (int k = 0; k < PSAT_NOUT; ++k) {
        p.out[k] = static_cast<T*>(out[k]);
        for (int d = 0; d < PSAT_ND; ++d) p.out_st[k][d] = out_st[k * PSAT_ND + d];
    }
    for (int d = 0; d < PSAT_ND; ++d) {
        p.n[d] = geo[d];
        p.wlo[d] = geo[PSAT_ND + d];
        p.whi[d] = geo[2 * PSAT_ND + d];
        p.alo[d] = geo[3 * PSAT_ND + d];
        p.ahi[d] = geo[4 * PSAT_ND + d];
    }
    // dims -2 and -3 get at most 65535 blocks each; above that the strided
    // kernel loops over the rest
    const int64_t cap = 65535;
    const int64_t n1 = p.n[PSAT_ND - 2];
    const int64_t n2 = PSAT_ND >= 3 ? p.n[PSAT_ND >= 3 ? PSAT_ND - 3 : 0] : 1;
    dim3 grid((unsigned)((p.n[PSAT_ND - 1] + psat::kBlock - 1) / psat::kBlock),
              (unsigned)(n1 < cap ? n1 : cap), (unsigned)(n2 < cap ? n2 : cap));
    if (n1 > cap || n2 > cap)
        psat::stencil_step<T, MODE, PSAT_ND, PSAT_NIN, PSAT_NOUT, PsatBody, true>
            <<<grid, psat::kBlock, 0, stream>>>(p);
    else
        psat::stencil_step<T, MODE, PSAT_ND, PSAT_NIN, PSAT_NOUT, PsatBody, false>
            <<<grid, psat::kBlock, 0, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t psat_launch_mode(int mode, const void* const* in,
                                    const int64_t* in_st, void* const* out,
                                    const int64_t* out_st, const int64_t* geo,
                                    cudaStream_t stream) {
    switch (mode) {
        case psat::INTERIOR:
            return psat_launch_t<T, psat::INTERIOR>(in, in_st, out, out_st, geo, stream);
        case psat::FULL:
            return psat_launch_t<T, psat::FULL>(in, in_st, out, out_st, geo, stream);
        case psat::PERIODIC:
            return psat_launch_t<T, psat::PERIODIC>(in, in_st, out, out_st, geo, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

extern "C" int psat_launch(int dtype, int mode, int device, const void* in_ptrs,
                           const void* in_st, const void* out_ptrs,
                           const void* out_st, const void* geo, void* stream) {
    const void* const* in = static_cast<const void* const*>(in_ptrs);
    void* const* out = static_cast<void* const*>(const_cast<void*>(out_ptrs));
    const int64_t* ist = static_cast<const int64_t*>(in_st);
    const int64_t* ost = static_cast<const int64_t*>(out_st);
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype == 0) return psat_launch_mode<float>(mode, in, ist, out, ost, g, s);
        if (dtype == 1) return psat_launch_mode<double>(mode, in, ist, out, ost, g, s);
        return cudaErrorInvalidValue;
    });
}

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
