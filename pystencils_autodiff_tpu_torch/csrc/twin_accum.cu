// Launcher stub of the twin-with-accumulation adjoint kernel
// (twin_accum.cuh).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_twin_source, which defines PSAT_ND,
// PSAT_NS, PSAT_NOUT, PSAT_NH, PSAT_NC (cotangent planes), PSAT_NG
// (coefficient-gradient planes, possibly 0) and `struct PsatFwd`,
// `PsatHoist`, `PsatCot`, `PsatCotSlots`, `PsatGrad`, `PsatGradSlots`.
// Plain C interface, loaded with ctypes:
//
//   int psat_twin_launch(int dtype, int periodic, int device,
//                        const void* state_ptrs, const void* state_st,
//                        const void* out_state_ptrs,  // null: not stored
//                        const void* out_state_st,
//                        const void* cot_ptrs, const void* cot_st,
//                        const void* out_cot_ptrs, const void* out_cot_st,
//                        const void* gcot_ptrs, const void* gcot_st,
//                        const void* out_gcot_ptrs, const void* out_gcot_st,
//                        const void* geo,  // int64, see parse_geo
//                        void* stream)
//
// State arrays hold PSAT_NS planes, cotangent arrays PSAT_NC, coefficient
// arrays max(PSAT_NG, 1); each plane a pointer and three int64 strides
// ((z, y, x), z = 0 for a 2D domain).
// One library is one float type and boundary mode: PSAT_S (storage),
// PSAT_T (compute), PSAT_DTYPE (their code: 0 float, 1 double, 2 bf16
// computed in float) and PSAT_PERIODIC; another dtype or mode is refused.
// Launches on `device` and restores the thread's current device; returns
// the launch's cudaError_t (0 on success) and does not synchronise.

template <typename T, int N>
static void psat_twin_planes(const void* ptrs, const void* st, T** dst,
                             int64_t (*dst_st)[3]) {
    const void* const* p = static_cast<const void* const*>(ptrs);
    const int64_t* s = static_cast<const int64_t*>(st);
    for (int k = 0; k < N; ++k) {
        dst[k] = static_cast<T*>(const_cast<void*>(p[k]));
        for (int d = 0; d < 3; ++d) dst_st[k][d] = s[3 * k + d];
    }
}

constexpr int kPsatNG1 = PSAT_NG > 0 ? PSAT_NG : 1;

template <typename T, typename S, bool PERIODIC>
static cudaError_t psat_twin_launch_t(const void* const* a,
                                      const int64_t* geo,
                                      cudaStream_t stream) {
    psat_chain::TwinParams<T, PSAT_NS, PSAT_NOUT, PSAT_NC, PSAT_NG, S> p;
    if (!psat_chain::parse_geo(geo, p.f, PSAT_NS, PSAT_NOUT)
        || p.f.g.rows != psat_chain::kRowsAdj)
        return cudaErrorInvalidValue;
    S* tmp[PSAT_NS > PSAT_NC ? (PSAT_NS > kPsatNG1 ? PSAT_NS : kPsatNG1)
                             : (PSAT_NC > kPsatNG1 ? PSAT_NC : kPsatNG1)];
    psat_twin_planes<S, PSAT_NS>(a[0], a[1], tmp, p.f.in_st);
    for (int k = 0; k < PSAT_NS; ++k) p.f.in[k] = tmp[k];
    psat_twin_planes<S, PSAT_NS>(a[2], a[3], p.f.out, p.f.out_st);
    psat_twin_planes<S, PSAT_NC>(a[4], a[5], tmp, p.cot_st);
    for (int k = 0; k < PSAT_NC; ++k) p.cot[k] = tmp[k];
    psat_twin_planes<S, PSAT_NC>(a[6], a[7], p.out_cot, p.out_cot_st);
    psat_twin_planes<S, kPsatNG1>(a[8], a[9], tmp, p.gcot_st);
    for (int k = 0; k < kPsatNG1; ++k) p.gcot[k] = tmp[k];
    psat_twin_planes<S, kPsatNG1>(a[10], a[11], p.out_gcot, p.out_gcot_st);
    for (int q = 0; q < psat_chain::kMaxProbes; ++q) p.f.probe[q] = nullptr;
    return psat_chain::launch_tiles(
        psat_chain::twin_accum<T, PSAT_NS, PSAT_NOUT, PSAT_NH, PSAT_NC,
                               PSAT_NG, PSAT_ND, PERIODIC, PsatFwd, PsatHoist,
                               PsatCot, PsatCotSlots, PsatGrad,
                               PsatGradSlots, S>,
        p, p.f.g, sizeof(T), stream);
}

extern "C" int psat_twin_launch(int dtype, int periodic, int device,
                                const void* state_ptrs, const void* state_st,
                                const void* out_state_ptrs,
                                const void* out_state_st,
                                const void* cot_ptrs, const void* cot_st,
                                const void* out_cot_ptrs,
                                const void* out_cot_st,
                                const void* gcot_ptrs, const void* gcot_st,
                                const void* out_gcot_ptrs,
                                const void* out_gcot_st, const void* geo,
                                void* stream) {
    const void* a[12] = {state_ptrs, state_st, out_state_ptrs, out_state_st,
                         cot_ptrs,   cot_st,   out_cot_ptrs,   out_cot_st,
                         gcot_ptrs,  gcot_st,  out_gcot_ptrs,  out_gcot_st};
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
            return cudaErrorInvalidValue;
        return psat_twin_launch_t<PSAT_T, PSAT_S, PSAT_PERIODIC != 0>(a, g, s);
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
    return psat_twin_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4],
                            a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12],
                            stream);
}
