// Launcher stub of the warp-march chain kernel (warp_chain.cuh).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_warp_chain_source, which defines
// PSAT_NS (state planes), PSAT_NOUT (forward output planes), PSAT_NH
// (hoisted planes), `struct PsatFwd`, `struct PsatHoist`, `struct PsatWarp`
// (the march's tables), PSAT_S/PSAT_T/PSAT_DTYPE (storage type, compute
// type, their code) and PSAT_PERIODIC.  The kernel is instantiated for
// every V (columns a lane) of PSAT_VS: the host picks one from their
// registers.  Plain C interface, loaded with ctypes:
//
//   int psat_warp_launch(int dtype, int periodic, int device, int v,
//                        const void* in_ptrs,    // void*[PSAT_NS]
//                        const void* in_st,      // int64[PSAT_NS * 2]
//                        const void* out_ptrs,   // void*[PSAT_NS], null:
//                                                // not written
//                        const void* out_st,     // int64[PSAT_NS * 2]
//                        const void* probe_ptrs, // void*[nprobe], (k, n1)
//                        const void* geo,        // int64, see below
//                        void* stream)
//   int psat_warp_regs(int v, void* out)  // int[2]: registers a thread,
//                                         // local bytes (spills)
//
// geo: n0 n1 wlo0 wlo1 whi0 whi1 seg nstrip items owned halo steps
//      probe_row[PsatWarp::NP].
// Launches on `device` and restores the thread's current device; returns
// the launch's cudaError_t (0 on success) and does not synchronise.

template <int V>
static auto warp_kernel() {
    return psat_warp::warp_chain<PSAT_T, PSAT_S, V, PSAT_PERIODIC != 0,
                                 PsatWarp, PsatFwd, PsatHoist, PSAT_NS,
                                 PSAT_NOUT, PSAT_NH>;
}

template <int V>
static cudaError_t warp_launch_v(const void* const* in, const int64_t* in_st,
                                 void* const* out, const int64_t* out_st,
                                 void* const* probes, const int64_t* geo,
                                 cudaStream_t stream) {
    using S = PSAT_S;
    psat_warp::WarpParams<S, PSAT_NS> p;
    constexpr int64_t vbytes = (int64_t)sizeof(S) * V;
    for (int k = 0; k < PSAT_NS; ++k) {
        p.in[k] = static_cast<const S*>(in[k]);
        p.out[k] = static_cast<S*>(out[k]);
        for (int d = 0; d < 2; ++d) {
            p.in_st[k][d] = in_st[2 * k + d];
            p.out_st[k][d] = out_st[2 * k + d];
        }
        // 16-byte (or V-element) accesses: contiguous rows, whole vectors
        p.vec_in[k] = V > 1 && vbytes <= 16 && p.in_st[k][1] == 1
                      && p.in_st[k][0] % V == 0
                      && reinterpret_cast<uintptr_t>(p.in[k]) % vbytes == 0;
        p.vec_out[k] = V > 1 && vbytes <= 16 && p.out[k] != nullptr
                       && p.out_st[k][1] == 1 && p.out_st[k][0] % V == 0
                       && reinterpret_cast<uintptr_t>(p.out[k]) % vbytes == 0;
    }
    int i = 0;
    p.n0 = geo[i++];
    p.n1 = geo[i++];
    p.wlo[0] = geo[i++];
    p.wlo[1] = geo[i++];
    p.whi[0] = geo[i++];
    p.whi[1] = geo[i++];
    p.seg = geo[i++];
    p.nstrip = (int)geo[i++];
    p.items = (int)geo[i++];
    p.owned = (int)geo[i++];
    p.halo = (int)geo[i++];
    p.steps = (int)geo[i++];
    for (int q = 0; q < psat_warp::kMaxProbes; ++q) {
        p.probe[q] = q < PsatWarp::NP ? static_cast<S*>(probes[q]) : nullptr;
        p.probe_row[q] = q < PsatWarp::NP ? geo[i + q] : -1;
    }
    if (p.items < 1 || p.owned < 1 || p.owned % V || p.halo % V
        || p.steps % PsatWarp::P || p.owned + 2 * p.halo != 32 * V)
        return cudaErrorInvalidValue;
    const int blocks = (p.items + psat_warp::kWarps - 1) / psat_warp::kWarps;
    auto kernel = warp_kernel<V>();
    kernel<<<blocks, 32 * psat_warp::kWarps, 0, stream>>>(p);
    return cudaGetLastError();
}

extern "C" int psat_warp_launch(int dtype, int periodic, int device, int v,
                                const void* in_ptrs, const void* in_st,
                                const void* out_ptrs, const void* out_st,
                                const void* probe_ptrs, const void* geo,
                                void* stream) {
    const void* const* in = static_cast<const void* const*>(in_ptrs);
    void* const* out = static_cast<void* const*>(const_cast<void*>(out_ptrs));
    void* const* probes =
        static_cast<void* const*>(const_cast<void*>(probe_ptrs));
    const int64_t* ist = static_cast<const int64_t*>(in_st);
    const int64_t* ost = static_cast<const int64_t*>(out_st);
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
            return cudaErrorInvalidValue;
        switch (v) {
            case 1: return warp_launch_v<1>(in, ist, out, ost, probes, g, s);
            case 2: return warp_launch_v<2>(in, ist, out, ost, probes, g, s);
#if PSAT_VMAX >= 4
            case 4: return warp_launch_v<4>(in, ist, out, ost, probes, g, s);
#endif
            default: return cudaErrorInvalidValue;
        }
    });
}

template <int V>
static int warp_regs(int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, warp_kernel<V>());
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    return 0;
}

extern "C" int psat_warp_regs(int v, void* out) {
    int* o = static_cast<int*>(out);
    switch (v) {
        case 1: return warp_regs<1>(o);
        case 2: return warp_regs<2>(o);
#if PSAT_VMAX >= 4
        case 4: return warp_regs<4>(o);
#endif
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* psat_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The uniform entry of the leaf launch op (csrc/launch_op.cpp, and every
// eager launch: ops/launch.py): the launcher's leading integers in `s`,
// its pointer arguments in `a`.
extern "C" int psat_call(int device, const int64_t* s, const void* const* a,
                         void* stream) {
    return psat_warp_launch((int)s[0], (int)s[1], device, (int)s[2], a[0], a[1], a[2],
                            a[3], a[4], a[5], stream);
}
