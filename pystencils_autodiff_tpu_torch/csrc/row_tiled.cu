// Launcher stub of the streamed slab single step (row_tiled.cuh), for one
// variant.
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
//                        const void* geo,      // int64[6 * 3]: n, wlo, whi, alo, ahi, lo
//                        const void* slab,     // int64[9]: t[3], e[3], rows, depth, nseg
//                        int width,            // copy width in bytes: 16, 8, 4 or 0
//                        void* stream)
//
// Every per-dim array is (z, y, x), a 2D domain (1, n0, n1); t and e give
// the lateral tile and slab (1 along the walk dim).  The copy width is the
// route the host picked from the pointers and strides; every width's
// kernel is in the library.  A dtype, mode or width the library was not
// built for returns cudaErrorInvalidValue.  Launches on `device` and
// restores the thread's current device.  Returns the cudaGetLastError()
// of the launch (0 on success); it does not synchronise.

template <int W>
static cudaError_t psat_slab_launch_w(
        const psat_rt::SlabParams<PSAT_S, PSAT_NIN, PSAT_NOUT>& p,
        int threads, size_t smem, cudaStream_t stream) {
    auto kernel = psat_rt::row_tiled<PSAT_T, PSAT_S, PSAT_MODE, PSAT_ND,
                                     PSAT_NIN, PSAT_NOUT, PSAT_ADJ, W,
                                     PsatBody>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((int64_t)p.nt[1] * p.nt[2] * p.nseg);
    kernel<<<grid, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

static cudaError_t psat_slab_launch_t(const void* const* in,
                                      const int64_t* in_st, void* const* out,
                                      const int64_t* out_st,
                                      const int64_t* geo, const int64_t* slab,
                                      int width, cudaStream_t stream) {
    using S = PSAT_S;
    constexpr int WD = PSAT_ND == 3 ? 0 : 1;
    psat_rt::SlabParams<S, PSAT_NIN, PSAT_NOUT> p;
    for (int k = 0; k < PSAT_NIN; ++k) {
        p.in[k] = static_cast<const S*>(in[k]);
        for (int d = 0; d < 3; ++d) p.in_st[k][d] = in_st[k * 3 + d];
    }
    for (int k = 0; k < PSAT_NOUT; ++k) {
        p.out[k] = static_cast<S*>(out[k]);
        for (int d = 0; d < 3; ++d) p.out_st[k][d] = out_st[k * 3 + d];
    }
    for (int d = 0; d < 3; ++d) {
        p.n[d] = geo[d];
        p.wlo[d] = geo[3 + d];
        p.whi[d] = geo[6 + d];
        p.alo[d] = geo[9 + d];
        p.ahi[d] = geo[12 + d];
        p.lo[d] = (int)geo[15 + d];
        p.t[d] = (int)slab[d];
        p.e[d] = (int)slab[3 + d];
        if (p.n[d] < 1 || p.t[d] < 1 || p.e[d] < p.t[d])
            return cudaErrorInvalidValue;
        p.nt[d] = d > WD ? (int)((p.n[d] + p.t[d] - 1) / p.t[d]) : 1;
        // a chunk is copied wide where its slab is in the domain, and in
        // [alo, ahi) too when the program reads adjoints
        p.vlo[d] = PSAT_ADJ ? (p.alo[d] > 0 ? p.alo[d] : 0) : 0;
        p.vhi[d] = PSAT_ADJ ? (p.ahi[d] < p.n[d] ? p.ahi[d] : p.n[d])
                            : p.n[d];
    }
    p.rows = (int)slab[6];
    p.depth = (int)slab[7];
    p.nseg = (int)slab[8];
    if (p.rows < 1 || p.depth % p.rows != 0 || p.depth < 4 * p.rows
        || p.depth > psat_rt::kMaxStages * p.rows
        || (p.depth & (p.depth - 1)) != 0 || p.nseg < 1)
        return cudaErrorInvalidValue;
    p.zlen = (int)((p.n[WD] + p.nseg - 1) / p.nseg);
    p.lines = PSAT_ND == 3 ? p.e[1] : 1;
    p.row = p.lines * p.e[2];
    const int threads = PSAT_ND == 3 ? p.t[1] * p.t[2] : p.t[2];
    if (threads < 1 || threads > psat_rt::kMaxThreads)
        return cudaErrorInvalidValue;
    const size_t smem = (size_t)PSAT_NIN * p.depth * p.row * sizeof(S);
    switch (width) {
    case 16: return psat_slab_launch_w<16>(p, threads, smem, stream);
    case 8: return psat_slab_launch_w<8>(p, threads, smem, stream);
    case 4:
        if constexpr (sizeof(S) <= 4)
            return psat_slab_launch_w<4>(p, threads, smem, stream);
        return cudaErrorInvalidValue;
    case 0: return psat_slab_launch_w<0>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
    }
}

extern "C" int psat_slab_launch(int dtype, int mode, int device,
                                const void* in_ptrs, const void* in_st,
                                const void* out_ptrs, const void* out_st,
                                const void* geo, const void* slab, int width,
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
        return psat_slab_launch_t(in, ist, out, ost, g, sl, width, s);
    });
}

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The uniform entry of the leaf launch op (csrc/launch_op.cpp, and every
// eager launch: ops/launch.py): the launcher's leading integers in `s`,
// its pointer arguments in `a`.
extern "C" int psat_call(int device, const int64_t* s, const void* const* a,
                         void* stream) {
    return psat_slab_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4], a[5],
                            (int)s[2], stream);
}
