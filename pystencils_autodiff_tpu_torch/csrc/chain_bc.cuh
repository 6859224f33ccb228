// Boundary-condition events inside the fused stage chains, on a shared-
// memory tile at global coordinates: the device side of
// ops/chain_bc.py, the counterpart of the Pallas helper
// pystencils_autodiff_tpu/ops/chain_bc.py::apply_bc_tile (forward) and of
// the BC transposes of pystencils_autodiff_tpu/ops/stage_adjoint.py
// (`apply_bc_T`).
//
// One template per kind, over `D`, the event's constants as constexpr
// tables emitted by codegen/cuda_printer.py (`PsatBcDesc<i>`: target
// planes and their cotangent slots, frame dims and ghost widths, mask /
// value / damping / wall-velocity planes or scalars, the lattice; every
// per-dim table in (z, y, x) order).  Kernel 12 and phase 1 of kernel 13
// run the same `fwd` (stage_chain.cuh::FwdEvent), so the recompute
// matches the forward chain bit for bit.
//
// fwd(r, v): the event's new value of each target component at one cell,
// from the reader r: r.rd(plane, dz, dy, dx) reads the state before the
// event at an offset, r.gc the cell's global coordinates, r.n the domain.
// Semantics are those of boundary.py (the plain version):
//   dirichlet        frame cells (dims `on`, the stage's ghost widths)
//                    take the value;
//   neumann          a frame cell takes the value of the first interior
//                    cell, i.e. the state at its coordinates clamped into
//                    the interior, dim by dim;
//   masked_dirichlet cells under the mask take the value (plane or scalar);
//   sponge           every cell is multiplied by the damping;
//   bounce_back      solid cells take f_opp(j) pulled from s + c_j (edge-
//                    clamped on a bounded domain, wrapped on a periodic
//                    one) plus 6 w_j ρ (c_j · u_wall(s)).
// Out-of-domain cells of a bounded tile read at unclamped offsets: their
// values only ever feed cells that are masked.
//
// bwd(r, v): the transpose at one cell, in gather form (each thread writes
// only its own cell): v holds the cotangent after the event, by cotangent
// slot, and leaves with the cotangent before it.  r.rc(slot, dz, dy, dx)
// reads the cotangent after the event; r.rd the state before it (kept by
// phase 1 where a transpose needs it: sponge's damping gradient).
// Bounded tiles leave out-of-domain cells alone (no later read takes
// them).  A parameter's cotangent (a Dirichlet value field, a damping
// field, a wall-velocity field) accumulates where its slot is >= 0.
#pragma once

#include <cstdint>

namespace psat_bc {

__device__ __forceinline__ bool in_frame(int64_t c, int64_t n, int lo,
                                         int hi) {
    return c < lo || c >= n - hi;
}

template <typename D>
__device__ __forceinline__ bool frame_cell(const int64_t* gc,
                                           const int64_t* n) {
    bool frame = false;
#pragma unroll
    for (int d = 0; d < 3; ++d)
        if (D::on(d) && (D::glo(d) || D::ghi(d))
            && in_frame(gc[d], n[d], D::glo(d), D::ghi(d)))
            frame = true;
    return frame;
}

template <typename D>
struct Dirichlet {
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void fwd(const R& r, T* v) {
        const bool frame = frame_cell<D>(r.gc, r.n);
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j)
            v[j] = frame ? T(D::value()) : r.rd(D::target(j), 0, 0, 0);
    }
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void bwd(const R& r, T* v) {
        if (!frame_cell<D>(r.gc, r.n)) return;
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) v[D::tcs(j)] = T(0);
    }
};

template <typename D>
struct Neumann {
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void fwd(const R& r, T* v) {
        int off[3] = {0, 0, 0};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            const int64_t c = r.gc[d];
            if (!D::on(d) || c < 0 || c >= r.n[d]) continue;
            int64_t t = c;
            if (D::glo(d) && t < D::glo(d)) t = D::glo(d);
            if (D::ghi(d) && t > r.n[d] - D::ghi(d) - 1)
                t = r.n[d] - D::ghi(d) - 1;
            off[d] = (int)(t - c);
        }
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j)
            v[j] = r.rd(D::target(j), off[0], off[1], off[2]);
    }
    // x̂(c) = Σ ŷ(c') over the in-domain c' whose clamp is c: per dim, none
    // for a frame cell, the cell and the frame beyond it for the first and
    // last interior cells, the cell alone otherwise
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void bwd(const R& r, T* v) {
        if (!r.in_domain()) return;
        int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
        bool empty = false;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            if (!D::on(d)) continue;
            const int64_t c = r.gc[d];
            if (in_frame(c, r.n[d], D::glo(d), D::ghi(d))) empty = true;
            if (D::glo(d) && c == D::glo(d)) lo[d] = -D::glo(d);
            if (D::ghi(d) && c == r.n[d] - D::ghi(d) - 1) hi[d] = D::ghi(d);
        }
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) {
            T acc = T(0);
            if (!empty)
                for (int dz = lo[0]; dz <= hi[0]; ++dz)
                    for (int dy = lo[1]; dy <= hi[1]; ++dy)
                        for (int dx = lo[2]; dx <= hi[2]; ++dx)
                            acc += r.rc(D::tcs(j), dz, dy, dx);
            v[D::tcs(j)] = acc;
        }
    }
};

template <typename D>
struct MaskedDirichlet {
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void fwd(const R& r, T* v) {
        const bool m = r.rd(D::mask(), 0, 0, 0) != T(0);
        const T val = D::vplane() >= 0 ? r.rd(D::vplane(), 0, 0, 0)
                                       : T(D::value());
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j)
            v[j] = m ? val : r.rd(D::target(j), 0, 0, 0);
    }
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void bwd(const R& r, T* v) {
        const bool m = r.rd(D::mask(), 0, 0, 0) != T(0);
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) {
            const T y = v[D::tcs(j)];
            if (D::vcs() >= 0 && m) v[D::vcs() < 0 ? 0 : D::vcs()] += y;
            v[D::tcs(j)] = m ? T(0) : y;
        }
    }
};

template <typename D>
struct Sponge {
    template <typename T, typename R>
    __device__ __forceinline__ static T damp(const R& r) {
        return D::vplane() >= 0 ? r.rd(D::vplane(), 0, 0, 0) : T(D::value());
    }
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void fwd(const R& r, T* v) {
        const T d = damp<T>(r);
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j)
            v[j] = r.rd(D::target(j), 0, 0, 0) * d;
    }
    // x̂ = damp·ŷ; a damping field's gradient takes Σ_j x_pre_j·ŷ_j
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void bwd(const R& r, T* v) {
        const T d = damp<T>(r);
        if (D::vcs() >= 0) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < D::kNComp; ++j)
                acc = acc + r.rd(D::target(j), 0, 0, 0) * v[D::tcs(j)];
            v[D::vcs() < 0 ? 0 : D::vcs()] += acc;
        }
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) v[D::tcs(j)] = v[D::tcs(j)] * d;
    }
};

template <typename D>
struct BounceBack {
    __host__ __device__ static constexpr int c(int j, int d) {
        return d == 0 ? D::cz(j) : (d == 1 ? D::cy(j) : D::cx(j));
    }
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void fwd(const R& r, T* v) {
        const bool solid = r.rd(D::mask(), 0, 0, 0) != T(0);
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) {
            if (!solid) {
                v[j] = r.rd(D::target(j), 0, 0, 0);
                continue;
            }
            int off[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                off[d] = c(j, d);
                const int64_t g = r.gc[d];
                if (!PERIODIC && off[d] && g >= 0 && g < r.n[d]) {
                    int64_t t = g + off[d];  // edge clamp
                    t = t < 0 ? 0 : (t >= r.n[d] ? r.n[d] - 1 : t);
                    off[d] = (int)(t - g);
                }
            }
            T ghost = r.rd(D::target(D::opp(j)), off[0], off[1], off[2]);
            if (D::has_uw() && (c(j, 0) || c(j, 1) || c(j, 2))) {
                T cu = T(0);
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    if (!c(j, d)) continue;
                    const T uw = D::uwp(d) >= 0 ? r.rd(D::uwp(d), 0, 0, 0)
                                                : T(D::uwv(d));
                    cu = cu + T(c(j, d)) * uw;
                }
                ghost = ghost + T(D::coef(j)) * cu;
            }
            v[j] = ghost;
        }
    }
    // f̂_m(c) = (1 − solid(c))·ŷ_m(c) + Σ_{j: opp(j) = m} Σ_s solid(s)·ŷ_j(s)
    // over the in-domain s whose (clamped) pull s + c_j lands on c: per dim
    // s = c − c_j, or s = c where c is the edge cell the clamp folds onto;
    // the wall velocity takes Σ_j 6 w_j ρ c_j·solid(c)·ŷ_j(c)
    template <typename T, bool PERIODIC, typename R>
    __device__ __forceinline__ static void bwd(const R& r, T* v) {
        if (!PERIODIC && !r.in_domain()) return;
        const T sf = r.rd(D::mask(), 0, 0, 0) != T(0) ? T(1) : T(0);
        T nf[D::kNComp];
#pragma unroll
        for (int m = 0; m < D::kNComp; ++m)
            nf[m] = (T(1) - sf) * r.rc(D::tcs(m), 0, 0, 0);
#pragma unroll
        for (int j = 0; j < D::kNComp; ++j) {
            T contrib = T(0);
            // option 0: s = c − c_j in that dim; option 1: the clamp fold
            for (int oz = 0; oz < 2; ++oz)
                for (int oy = 0; oy < 2; ++oy)
                    for (int ox = 0; ox < 2; ++ox) {
                        const int opt[3] = {oz, oy, ox};
                        int off[3];
                        bool ok = true;
#pragma unroll
                        for (int d = 0; d < 3; ++d) {
                            const int cd = c(j, d);
                            const int64_t g = r.gc[d];
                            if (opt[d] == 0) {
                                off[d] = -cd;
                                if (!PERIODIC && cd
                                    && (g - cd < 0 || g - cd >= r.n[d]))
                                    ok = false;
                            } else {
                                off[d] = 0;
                                if (PERIODIC || !cd
                                    || g != (cd > 0 ? r.n[d] - 1 : 0))
                                    ok = false;
                            }
                        }
                        if (!ok) continue;
                        const T s = r.rd(D::mask(), off[0], off[1], off[2])
                                            != T(0) ? T(1) : T(0);
                        contrib += s * r.rc(D::tcs(j), off[0], off[1],
                                            off[2]);
                    }
            nf[D::opp(j)] += contrib;
            if (D::has_uw()) {
                const T syc = r.rc(D::tcs(j), 0, 0, 0) * sf;
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const int slot = D::uwcs(d);
                    if (c(j, d) && slot >= 0)
                        v[slot] += T(D::coef(j) * c(j, d)) * syc;
                }
            }
        }
#pragma unroll
        for (int m = 0; m < D::kNComp; ++m) v[D::tcs(m)] = nf[m];
    }
};

}  // namespace psat_bc
