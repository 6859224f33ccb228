// Launcher stub of the fused stage-chain adjoint (stage_adjoint.cuh,
// kernel 13).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_stage_adjoint_source, which defines
// PSAT_ND, PSAT_NS, PSAT_NE, PSAT_MAXOUT, PSAT_NC (cotangent slots), the
// `PsatEv<i>` structs (with their backward bodies and tables) and
// `PsatEvents`.  Plain C interface, loaded with ctypes:
//
//   int psat_stage_adjoint_launch(int dtype, int periodic, int device,
//       const void* state_ptrs, const void* state_st,          // PSAT_NS
//       const void* out_state_ptrs, const void* out_state_st,  // PSAT_NS
//       const void* cot_ptrs, const void* cot_st,              // PSAT_NC
//       const void* out_cot_ptrs, const void* out_cot_st,      // PSAT_NC
//       const void* geo,  // int64, see stage_chain.cuh::parse_stage_geo
//       void* stream)
//
// A null out_state pointer is not written.  Strides are (z, y, x) per
// plane, z = 0 for a 2D domain.
// One library is one float type and boundary mode: PSAT_S (storage),
// PSAT_T (compute), PSAT_DTYPE (their code: 0 float, 1 double, 2 bf16
// computed in float) and PSAT_PERIODIC; another dtype or mode is refused.
// Launches on `device` and restores the thread's current device; returns
// the launch's cudaError_t (0 on success) and does not synchronise.

template <typename T, int N>
static void psat_stage_planes(const void* ptrs, const void* st, T** dst,
                              int64_t (*dst_st)[3]) {
    const void* const* p = static_cast<const void* const*>(ptrs);
    const int64_t* s = static_cast<const int64_t*>(st);
    for (int k = 0; k < N; ++k) {
        dst[k] = static_cast<T*>(const_cast<void*>(p[k]));
        for (int d = 0; d < 3; ++d) dst_st[k][d] = s[3 * k + d];
    }
}

template <typename T, typename S, bool PERIODIC>
static cudaError_t psat_stage_adjoint_launch_t(const void* const* a,
                                               const int64_t* geo,
                                               cudaStream_t stream) {
    using Fwd = psat_stage::StageParams<T, PSAT_NS, PSAT_NE, PSAT_MAXOUT, S>;
    psat_stage::StageAdjointParams<T, PSAT_NS, PSAT_NE, PSAT_MAXOUT, PSAT_NC,
                                   S>
        p;
    if (!psat_stage::parse_stage_geo<Fwd, PSAT_NS, PSAT_NE, PSAT_MAXOUT>(
            geo, p.f)
        || p.f.g.rows != psat_chain::kRowsAdj)
        return cudaErrorInvalidValue;
    S* tmp[PSAT_NS > PSAT_NC ? PSAT_NS : PSAT_NC];
    psat_stage_planes<S, PSAT_NS>(a[0], a[1], tmp, p.f.in_st);
    for (int k = 0; k < PSAT_NS; ++k) p.f.in[k] = tmp[k];
    psat_stage_planes<S, PSAT_NS>(a[2], a[3], p.f.out, p.f.out_st);
    psat_stage_planes<S, PSAT_NC>(a[4], a[5], tmp, p.cot_st);
    for (int k = 0; k < PSAT_NC; ++k) p.cot[k] = tmp[k];
    psat_stage_planes<S, PSAT_NC>(a[6], a[7], p.out_cot, p.out_cot_st);
    return psat_chain::launch_tiles(
        psat_stage::stage_adjoint<T, PSAT_NS, PSAT_NE, PSAT_MAXOUT, PSAT_NC,
                                  PSAT_ND, PERIODIC, PsatEvents, S>,
        p, p.f.g, sizeof(T), stream);
}

extern "C" int psat_stage_adjoint_launch(
        int dtype, int periodic, int device, const void* state_ptrs,
        const void* state_st, const void* out_state_ptrs,
        const void* out_state_st, const void* cot_ptrs, const void* cot_st,
        const void* out_cot_ptrs, const void* out_cot_st, const void* geo,
        void* stream) {
    const void* a[8] = {state_ptrs, state_st, out_state_ptrs, out_state_st,
                        cot_ptrs, cot_st, out_cot_ptrs, out_cot_st};
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
            return cudaErrorInvalidValue;
        return psat_stage_adjoint_launch_t<PSAT_T, PSAT_S, PSAT_PERIODIC != 0>(a, g, s);
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
    return psat_stage_adjoint_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2],
                                     a[3], a[4], a[5], a[6], a[7], a[8], stream);
}
