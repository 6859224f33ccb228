// Launcher stub of the stage chain kernel (stage_chain.cuh, kernel 12).
//
// Included at the end of a translation unit generated by
// codegen/cuda_printer.py::generate_stage_source, which defines PSAT_ND
// (spatial dims, 2 or 3), PSAT_NS (state planes), PSAT_NE (events of the k
// cycles), PSAT_MAXOUT (most outputs of one event), the `PsatEv<i>`
// structs and `PsatEvents`.  Plain C interface, loaded with ctypes:
//
//   int psat_stage_launch(int dtype, int periodic, int device,
//                         const void* in_ptrs,   // void*[PSAT_NS]
//                         const void* in_st,     // int64[PSAT_NS * 3]
//                         const void* out_ptrs,  // void*[PSAT_NS], null:
//                                                // not written
//                         const void* out_st,    // int64[PSAT_NS * 3]
//                         const void* geo,       // int64, see parse_stage_geo
//                         void* stream)
//
// Strides are (z, y, x) per plane, z = 0 for a 2D domain.
// One library is one float type and boundary mode: PSAT_S (storage),
// PSAT_T (compute), PSAT_DTYPE (their code: 0 float, 1 double, 2 bf16
// computed in float) and PSAT_PERIODIC; another dtype or mode is refused.
// Launches on `device` and restores the thread's current device; returns
// the launch's cudaError_t (0 on success) and does not synchronise.

template <typename T, typename S, bool PERIODIC>
static cudaError_t psat_stage_launch_t(const void* const* in,
                                       const int64_t* in_st,
                                       void* const* out,
                                       const int64_t* out_st,
                                       const int64_t* geo,
                                       cudaStream_t stream) {
    using Params =
        psat_stage::StageParams<T, PSAT_NS, PSAT_NE, PSAT_MAXOUT, S>;
    Params p;
    if (!psat_stage::parse_stage_geo<Params, PSAT_NS, PSAT_NE, PSAT_MAXOUT>(
            geo, p))
        return cudaErrorInvalidValue;
    for (int k = 0; k < PSAT_NS; ++k) {
        p.in[k] = static_cast<const S*>(in[k]);
        p.out[k] = static_cast<S*>(out[k]);
        for (int d = 0; d < 3; ++d) {
            p.in_st[k][d] = in_st[3 * k + d];
            p.out_st[k][d] = out_st[3 * k + d];
        }
    }
    // 2D chains run kRowsFwd-row blocks, 3D chains kRowsAdj-row ones
    constexpr int rows =
        PSAT_ND == 2 ? psat_chain::kRowsFwd : psat_chain::kRowsAdj;
    if (p.g.rows != rows) return cudaErrorInvalidValue;
    return psat_chain::launch_tiles(
        psat_stage::stage_chain<T, PSAT_NS, PSAT_NE, PSAT_MAXOUT, PSAT_ND,
                                PERIODIC, PsatEvents, rows, S>,
        p, p.g, sizeof(T), stream);
}

extern "C" int psat_stage_launch(int dtype, int periodic, int device,
                                 const void* in_ptrs, const void* in_st,
                                 const void* out_ptrs, const void* out_st,
                                 const void* geo, void* stream) {
    const void* const* in = static_cast<const void* const*>(in_ptrs);
    void* const* out = static_cast<void* const*>(const_cast<void*>(out_ptrs));
    const int64_t* ist = static_cast<const int64_t*>(in_st);
    const int64_t* ost = static_cast<const int64_t*>(out_st);
    const int64_t* g = static_cast<const int64_t*>(geo);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return psat::on_device(device, [&]() -> cudaError_t {
        if (dtype != PSAT_DTYPE || periodic != PSAT_PERIODIC)
            return cudaErrorInvalidValue;
        return psat_stage_launch_t<PSAT_T, PSAT_S, PSAT_PERIODIC != 0>(in, ist, out, ost, g, s);
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
    return psat_stage_launch((int)s[0], (int)s[1], device, a[0], a[1], a[2], a[3], a[4],
                             stream);
}
