// Launcher stub of the stencil step kernel (stencil_step.cuh), for one
// variant.
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py, which defines PSAT_ND, PSAT_NIN, PSAT_NOUT,
// `struct PsatBody` and the variant: PSAT_S (storage type), PSAT_T
// (compute type), PSAT_DTYPE (its code: 0 float, 1 double, 2 bf16 storage
// with float arithmetic), PSAT_MODE (psat::Mode) and PSAT_STRIDED (1: the
// grid-strided kernel an extent above 65535 needs).  One variant a
// library: the D3Q19 backward body is 1,687 steps, and instantiating it in
// all 12 (float type, mode, form) variants took 598 s to build.  Exposes a
// plain C interface, loaded with ctypes:
//
//   int psat_launch(int dtype, int mode, int device,
//                   const void* in_ptrs,   // void*[PSAT_NIN]
//                   const void* in_st,     // int64[PSAT_NIN * PSAT_ND]
//                   const void* out_ptrs,  // void*[PSAT_NOUT]
//                   const void* out_st,    // int64[PSAT_NOUT * PSAT_ND]
//                   const void* geo,       // int64[5 * PSAT_ND]: n, wlo, whi, alo, ahi
//                                          // (+ the window form's
//                                          // int64[3 * PSAT_ND]:
//                                          // tiles per dim, smin, smax)
//                   void* stream)
//
// A dtype, mode or extent the library was not built for returns
// cudaErrorInvalidValue.  Launches on `device` and restores the thread's
// current device.  Returns the cudaGetLastError() of the launch (0 on
// success); it does not synchronise.

static void fill_params(psat::Params<PSAT_S, PSAT_ND, PSAT_NIN, PSAT_NOUT>& p,
                        const void* const* in, const int64_t* in_st,
                        void* const* out, const int64_t* out_st,
                        const int64_t* geo) {
    using S = PSAT_S;
    for (int k = 0; k < PSAT_NIN; ++k) {
        p.in[k] = static_cast<const S*>(in[k]);
        for (int d = 0; d < PSAT_ND; ++d) p.in_st[k][d] = in_st[k * PSAT_ND + d];
    }
    for (int k = 0; k < PSAT_NOUT; ++k) {
        p.out[k] = static_cast<S*>(out[k]);
        for (int d = 0; d < PSAT_ND; ++d) p.out_st[k][d] = out_st[k * PSAT_ND + d];
    }
    for (int d = 0; d < PSAT_ND; ++d) {
        p.n[d] = geo[d];
        p.wlo[d] = geo[PSAT_ND + d];
        p.whi[d] = geo[2 * PSAT_ND + d];
        p.alo[d] = geo[3 * PSAT_ND + d];
        p.ahi[d] = geo[4 * PSAT_ND + d];
    }
}

#if PSAT_WINDOW
// Whether a plane (base pointer, strides) takes V-wide vector accesses:
// contiguous last dim, base and every other stride a whole vector.
static bool vec_plane(const void* base, const int64_t* st) {
    constexpr int V = PsatWin::V;
    constexpr int64_t bytes = (int64_t)sizeof(PSAT_S) * V;
    if (V < 2 || bytes > 16 || st[PSAT_ND - 1] != 1) return false;
    if (reinterpret_cast<uintptr_t>(base) % bytes) return false;
    for (int d = 0; d < PSAT_ND - 1; ++d)
        if (st[d] % V) return false;
    return true;
}

static cudaError_t psat_launch_t(const void* const* in, const int64_t* in_st,
                                 void* const* out, const int64_t* out_st,
                                 const int64_t* geo, cudaStream_t stream) {
    using SH = psat::WinShape<PsatWin, PSAT_ND>;
    psat::WinParams<PSAT_S, PSAT_ND, PSAT_NIN, PSAT_NOUT> wp;
    psat::Params<PSAT_S, PSAT_ND, PSAT_NIN, PSAT_NOUT>& p = wp.p;
    fill_params(p, in, in_st, out, out_st, geo);
    // the tile reckoning (ops/cuda_kernel.py::window_geometry): tiles per
    // dim, then the interior tiles' origins [smin, smax] per dim
    const int64_t* wg = geo + 5 * PSAT_ND;
    int64_t tiles = 1;
    for (int d = 0; d < PSAT_ND; ++d) {
        wp.nt[d] = (int)wg[d];
        tiles *= wg[d];
        wp.smin[d] = wg[PSAT_ND + d];
        wp.smax[d] = wg[2 * PSAT_ND + d];
        if (wg[d] < 1 || tiles > 0x7fffffff) return cudaErrorInvalidValue;
    }
    wp.ntiles = (int)tiles;
    for (int k = 0; k < PSAT_NIN; ++k)
        wp.vec_in[k] = vec_plane(p.in[k], p.in_st[k]);
    for (int k = 0; k < PSAT_NOUT; ++k)
        wp.vec_out[k] = vec_plane(p.out[k], p.out_st[k]);
    // one block a tile (the kernel's grid-stride loop covers any grid)
    psat::stencil_window<PSAT_T, PSAT_S, PSAT_MODE, PSAT_ND, PSAT_NIN,
                         PSAT_NOUT, PsatBody, PsatWin>
        <<<(int)tiles, psat::kBlock, 0, stream>>>(wp);
    return cudaGetLastError();
}

// the registers a thread of the window kernel takes
extern "C" int psat_regs() {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(
            &attr, psat::stencil_window<PSAT_T, PSAT_S, PSAT_MODE, PSAT_ND,
                                        PSAT_NIN, PSAT_NOUT, PsatBody,
                                        PsatWin>) != cudaSuccess)
        return -1;
    return attr.numRegs;
}
#else
static cudaError_t psat_launch_t(const void* const* in, const int64_t* in_st,
                                 void* const* out, const int64_t* out_st,
                                 const int64_t* geo, cudaStream_t stream) {
    using S = PSAT_S;
    psat::Params<S, PSAT_ND, PSAT_NIN, PSAT_NOUT> p;
    fill_params(p, in, in_st, out, out_st, geo);
    // dims -2 and -3 get at most 65535 blocks each; above that the strided
    // kernel loops over the rest
    const int64_t cap = 65535;
    const int64_t n1 = p.n[PSAT_ND - 2];
    int64_t n2 = 1;  // the leading dims 0 … ND-3, merged into grid.z
    for (int d = 0; d < PSAT_ND - 2; ++d) n2 *= p.n[d];
    if ((n1 > cap || n2 > cap) != (PSAT_STRIDED != 0))
        return cudaErrorInvalidValue;
    dim3 grid((unsigned)((p.n[PSAT_ND - 1] + psat::kBlock - 1) / psat::kBlock),
              (unsigned)(n1 < cap ? n1 : cap), (unsigned)(n2 < cap ? n2 : cap));
    psat::stencil_step<PSAT_T, S, PSAT_MODE, PSAT_ND, PSAT_NIN, PSAT_NOUT,
                       PsatBody, PSAT_STRIDED != 0>
        <<<grid, psat::kBlock, 0, stream>>>(p);
    return cudaGetLastError();
}
#endif

extern "C" int psat_launch(int dtype, int mode, int device, const void* in_ptrs,
                           const void* in_st, const void* out_ptrs,
                           const void* out_st, const void* geo, void* stream) {
    if (dtype != PSAT_DTYPE || mode != PSAT_MODE)
        return (int)cudaErrorInvalidValue;
    const void* const* in = static_cast<const void* const*>(in_ptrs);
    void* const* out = static_cast<void* const*>(const_cast<void*>(out_ptrs));
    const int64_t* ist = static_cast<const int64_t*>(in_st);
    const int64_t* ost = static_cast<const int64_t*>(out_st);
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        return psat_launch_t(in, ist, out, ost, g, s);
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
    return psat_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4], stream);
}
