// Launcher stub of the z-streaming chain kernel (plane_adjoint.cuh).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_plane_source, which defines PSAT_NS,
// PSAT_NOUT, PSAT_NH, `struct PsatFwd`, `PsatHoist`, `PsatPlaneMeta` and
// the specialisation: PSAT_S (storage type), PSAT_T (compute type),
// PSAT_DTYPE (their code: 0 float, 1 double, 2 bf16 storage computed in
// float), PSAT_PERIODIC, PSAT_TWO_PHASE and PSAT_FORM (0 forward mode, 1
// two-phase gather form, 2 two-phase local form); in the gather form also PSAT_NOUT_B,
// PSAT_MAXPASS, `struct PsatBwd` and `PsatBwdMeta`; in the local form
// PSAT_NW, `struct PsatLocal`, `PsatGather` and `PsatLocalMeta`.  One
// library is one (plan, mode, form, float type): the D3Q19 gather body is
// 1,687 steps, so each library compiles only the variant it runs.  Plain C
// interface, loaded with ctypes:
//
//   int psat_plane_launch(int dtype, int periodic, int device,
//                         const void* in_ptrs, const void* in_st,
//                         const void* out_ptrs, const void* out_st,
//                         const void* cot_ptrs, const void* cot_st,
//                         const void* out_cot_ptrs, const void* out_cot_st,
//                         const void* probe_ptrs,     // void*[nprobe], (k, nx) records
//                         const void* probe_cot_ptrs, // void*[nprobe], (k, nx) cotangents
//                         const void* geo,  // int64, see parse_geo
//                         void* stream)
//
// Pointer arrays hold PSAT_NS plane pointers (a null out pointer: not
// written; the cotangent arrays are ignored in forward mode, the probe
// records in two-phase mode and the probe cotangents in forward mode), stride arrays
// PSAT_NS * 3 int64 (z, y, x).  A dtype, boundary mode or stage of a form
// other than the library's is refused.  Launches on `device` and
// restores the thread's current device; returns the launch's cudaError_t
// (0 on success) and does not synchronise.

#if PSAT_FORM == 1
#define PSAT_BWD PsatBwd
#define PSAT_BWD_META PsatBwdMeta
#define PSAT_PLANE_NOUT_B PSAT_NOUT_B
#define PSAT_PLANE_MAXPASS PSAT_MAXPASS
#else
#define PSAT_BWD psat_plane::NoBwd
#define PSAT_BWD_META psat_plane::NoBwdMeta
#define PSAT_PLANE_NOUT_B 1
#define PSAT_PLANE_MAXPASS 1
#endif
#if PSAT_FORM == 2
#define PSAT_LOCAL PsatLocal
#define PSAT_GATHER PsatGather
#define PSAT_LOCAL_META PsatLocalMeta
#define PSAT_PLANE_NW PSAT_NW
#else
#define PSAT_LOCAL psat_plane::NoBwd
#define PSAT_GATHER psat_plane::NoGather
#define PSAT_LOCAL_META psat_plane::NoLocalMeta
#define PSAT_PLANE_NW 1
#endif

template <typename T>
static void psat_plane_planes(const void* ptrs, const void* st, T** dst,
                              int64_t (*dst_st)[3]) {
    const void* const* p = static_cast<const void* const*>(ptrs);
    const int64_t* s = static_cast<const int64_t*>(st);
    for (int k = 0; k < PSAT_NS; ++k) {
        dst[k] = p ? static_cast<T*>(const_cast<void*>(p[k])) : nullptr;
        for (int d = 0; d < 3; ++d) dst_st[k][d] = s ? s[3 * k + d] : 0;
    }
}

extern "C" int psat_plane_launch(int dtype, int periodic, int device,
                                 const void* in_ptrs, const void* in_st,
                                 const void* out_ptrs, const void* out_st,
                                 const void* cot_ptrs, const void* cot_st,
                                 const void* out_cot_ptrs,
                                 const void* out_cot_st,
                                 const void* probe_ptrs,
                                 const void* probe_cot_ptrs, const void* geo,
                                 void* stream) {
    using T = PSAT_T;
    using S = PSAT_S;
    if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
        return (int)cudaErrorInvalidValue;
    psat_plane::PlaneParams<T, PSAT_NS, S> p;
    if (!psat_plane::parse_geo(static_cast<const int64_t*>(geo), p.g))
        return (int)cudaErrorInvalidValue;
    for (int x = 0; x < p.g.nstage; ++x) {  // stages of the library's form
        const int kd = p.g.kind[x];
        if (kd != psat_plane::kF
            && (PSAT_FORM == 0 || (kd == psat_plane::kR) != (PSAT_FORM == 1)))
            return (int)cudaErrorInvalidValue;
    }
    S* tmp[PSAT_NS];
    psat_plane_planes<S>(in_ptrs, in_st, tmp, p.in_st);
    for (int k = 0; k < PSAT_NS; ++k) p.in[k] = tmp[k];
    psat_plane_planes<S>(out_ptrs, out_st, p.out, p.out_st);
    psat_plane_planes<S>(PSAT_TWO_PHASE ? cot_ptrs : nullptr, cot_st, tmp,
                         p.cot_st);
    for (int k = 0; k < PSAT_NS; ++k) p.cot[k] = tmp[k];
    psat_plane_planes<S>(PSAT_TWO_PHASE ? out_cot_ptrs : nullptr,
                         out_cot_st, p.out_cot, p.out_cot_st);
    void* const* pr = static_cast<void* const*>(const_cast<void*>(probe_ptrs));
    const void* const* pc = static_cast<const void* const*>(probe_cot_ptrs);
    for (int q = 0; q < psat_plane::kMaxProbes; ++q) {
        const bool used = q < p.g.nprobe;
        p.probe[q] = used && !PSAT_TWO_PHASE ? static_cast<S*>(pr[q]) : nullptr;
        p.probe_cot[q] = used && PSAT_TWO_PHASE ? static_cast<const S*>(pc[q])
                                                : nullptr;
    }
    const size_t smem = (size_t)p.g.smem * sizeof(T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        auto kernel = psat_plane::plane_chain<
            T, PSAT_NS, PSAT_NOUT, PSAT_NH, PSAT_PLANE_NOUT_B,
            PSAT_PLANE_MAXPASS, PSAT_PLANE_NW, PSAT_FORM, PSAT_PERIODIC != 0,
            PsatFwd, PsatHoist, PSAT_BWD, PSAT_BWD_META, PSAT_LOCAL,
            PSAT_GATHER, PSAT_LOCAL_META, PsatPlaneMeta, S>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        const unsigned blocks =
            (unsigned)p.g.nt[0] * (unsigned)p.g.nt[1] * (unsigned)p.g.nseg;
        kernel<<<blocks, psat_plane::kThreads, smem, s>>>(p);
        return cudaGetLastError();
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
    return psat_plane_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4],
                             a[5], a[6], a[7], a[8], a[9], a[10], stream);
}
