"""Twin-with-coefficient-accumulation fused adjoint chains: the port of
``pystencils_autodiff_tpu/ops/twin_adjoint.py``.

For ops LINEAR in their carried state whose only "nonlinearity" is a
differentiable CHAIN-INVARIANT coefficient field — the acoustic wave
equation with its velocity model ``c`` (BASELINE config #3), the
variable-κ diffusion with ∂/∂κ (config #2) — the k-step VJP splits
exactly:

* the STATE cotangents advance through the transposed linear op's own
  chain (a forward stencil over the cotangents, like
  ``adjoint_chain.transposed_linear_op``), and
* the COEFFICIENT gradient accumulates per stage,

      ĉ_coeff += (∂F_s/∂coeff)ᵀ · ĉ_{s+1},

  whose two factors — the stage-s primal state and the stage-(s+1)
  cotangent — are both live inside ONE kernel that runs the forward
  recompute (phase 1, keeping only the primal planes the coefficient
  gradient reads) and the transposed cotangent chain (phase 2),
  evaluating the accumulation on each tile's OWNED cells.

The state block needs a halo of ``k·max(reach_f, reach_c)`` and the
cotangent block ``k·reach_c`` — for these ops half the two-phase kernel's
``k·(reach_f + reach_b)`` — and the accumulation needs no margin at all.

``state_coeff_twin`` detects the structure (a copy of the JAX package's
function over the port's symbolic layer).  The kernel replaces the Pallas
kernels ``make_twin_accum_vjp_fn`` (2D periodic: row 10) and
``make_plane_twin_accum_vjp_fn`` (3D bounded or periodic; with no
coefficient the "bounded twin" of a pure-linear op: row 11): both run the
two-phase mode of the dim-0 march, ``csrc/stage_march.cuh``, over the
chain as a one-stage cycle (``adjoint_chain.make_chain_march_kernel``).
In a march the twin split buys nothing — the cotangent chain and the
coefficient gradient weigh what the backward program weighs — so the
march runs the backward program; the box design of ``twin_accum.cuh``
(kernel B in 2D, kernel C's first design in 3D) stays behind
``make_twin_accum_kernel(tp, "box")``.  On CPU tensors the
plain version runs: ``plain_twin_accum_vjp``, k plain forward steps then k
plain backward steps (full+mask or periodic) — the same oracle as
``adjoint_chain.plain_chain_vjp``.  ``LAUNCHES``/``LAUNCH_CALLS`` count
the kernels' launches (keyed ``(op, k, periodic, shape, itemsize,
design)``).
"""

from __future__ import annotations

from collections import Counter
from functools import partial
from typing import Dict, List

import sympy as sp

from ..adjoint_field import AdjointField
from ..codegen.cuda_printer import input_planes, output_planes
from ..field import Field
from .common import (field_components, forward_program, make_program,
                     storage_shape)
from .cuda_kernel import _DTYPES, _check_inputs, tile_itemsize
from .launch import empty, real, run
from .time_chain import (ChainPlan, _load_library, access_reach,
                         chain_geometry, check_state, plane_args3)

__all__ = ["state_coeff_twin", "TwinPlan", "plain_twin_accum_vjp",
           "make_twin_accum_kernel", "reset_launch_counts", "LAUNCHES",
           "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def _reachable_subexprs(subexprs, mains):
    """Subset of ``subexprs`` (in order) reachable from ``mains`` through
    lhs-symbol references."""
    needed = set()
    for a in mains:
        needed |= a.rhs.free_symbols
    keep: List = []
    for a in reversed(list(subexprs)):
        if a.lhs in needed:
            keep.append(a)
            needed |= a.rhs.free_symbols
    return list(reversed(keep))


def state_coeff_twin(op, carry_map: Dict[str, str],
                     allow_no_coeff: bool = False):
    """Detect the state-linear / invariant-differentiable-coefficient
    structure and build its pieces.

    ``allow_no_coeff=True`` also matches PURE linear ops (no
    differentiable coefficient at all): ``grad_prog`` is then ``None``
    and the kernel runs as a "bounded twin" — forward chain + masked
    transposed cotangent chain with separate (halved) halos — the
    bounded-domain analog of the periodic twin fast path.

    Returns ``None`` when the decomposition does not apply, else a dict:

    * ``cot_op``, ``cot_carry``, ``name_of``, ``plain_reads`` — the
      transposed state-cotangent advance (like ``transposed_linear_op``,
      but its coefficient reads may be DIFFERENTIABLE invariant fields).
    * ``coeff_names`` — invariant differentiable fields whose gradient
      accumulates per stage.
    * ``grad_prog`` — StencilProgram computing the per-stage coefficient
      contributions: reads cot fields (``cot_<m>``), primal state fields,
      and invariant fields; writes ``gsum_<coeff>``.
    * ``saved_names`` — primal STATE fields the grad program reads (the
      phase-1 per-stage saving set).
    """
    from ..assignment import (Assignment, AssignmentCollection,
                              StagedAssignmentCollection)
    from ..autodiff import AutoDiffOp
    from .hoist import invariant_fields

    coll = op.backward_assignments
    if isinstance(coll, StagedAssignmentCollection):
        return None
    in_names = [f.name for f in op.forward_input_fields]
    out_names = [f.name for f in op.forward_output_fields]
    inv = invariant_fields(in_names, out_names, carry_map)
    declared_const = {f.name for f in op.constant_fields}
    if declared_const & (set(carry_map) | set(carry_map.values())):
        return None
    fwd_in = {f.name: f for f in op.forward_input_fields}
    grad_targets = {a.lhs.field.corresponding_forward_field.name
                    for a in coll.main_assignments}
    coeff_names = sorted((inv & grad_targets) - declared_const)
    if not coeff_names and not allow_no_coeff:
        return None  # plain linear case: transposed_linear_op handles it
    # plain (non-adjoint) fields the cot advance may read
    allowed_plain = (inv | declared_const)

    next_src = {n: carry_map.get(n, n) for n in in_names}
    pass_to: Dict[str, list] = {m: [] for m in in_names}
    feeds_output: Dict[str, list] = {o: [] for o in out_names}
    for n, src in next_src.items():
        if src in feeds_output:
            feeds_output[src].append(n)
        else:
            pass_to[src].append(n)

    def _like(name, f):
        nf = Field(name, f.spatial_dimensions, index_shape=f.index_shape,
                   dtype=f.dtype, layout=f.layout)
        nf.index_major = getattr(f, "index_major", False)
        return nf

    cot_field = {m: _like(f"cot_{m}", f) for m, f in fwd_in.items()}
    # adjoint-MAPPED reads go through a distinct "masked cotangent" view:
    # on bounded domains each stage's output carries F = mask∘(A·state),
    # so (dF)ᵀĉ = Aᵀ(mask⊙ĉ) — the mask applies to reads standing for
    # ĥat{output}, NOT to pass-through cotangent terms (u_prev ← u_curr
    # carries the raw ĉ).  The kernel binds mcot_* to mask⊙cot (bounded)
    # or to the plain cot planes (periodic).
    mcot_field = {m: _like(f"mcot_{m}", f) for m, f in fwd_in.items()}
    cot_out_field = {m: _like(f"cot_{m}_out", f) for m, f in fwd_in.items()}
    gsum_field = {m: _like(f"gsum_{m}", fwd_in[m]) for m in coeff_names}

    def substituted(expr, allow_state_primals):
        mapping = {}
        for a in expr.atoms(Field.Access):
            if not isinstance(a.field, AdjointField):
                if a.field.name in allowed_plain:
                    continue
                if allow_state_primals and a.field.name in fwd_in:
                    continue  # grad program: stage-s primal read
                return None
            primal = a.field.corresponding_forward_field.name
            carriers = feeds_output.get(primal)
            if carriers is None:
                mapping[a] = sp.Integer(0)
            else:
                mapping[a] = sum(
                    (Field.Access(mcot_field[n], a.offsets, a.index)
                     for n in carriers), sp.Integer(0))
        return expr.subs(mapping, simultaneous=True)

    state_mains, coeff_mains = [], []
    for a in coll.main_assignments:
        m = a.lhs.field.corresponding_forward_field.name
        (coeff_mains if m in coeff_names else state_mains).append(a)

    # --- the transposed state-cotangent op ---------------------------------
    sub_state = _reachable_subexprs(coll.subexpressions, state_mains)
    subexprs = []
    for a in sub_state:
        rhs = substituted(a.rhs, allow_state_primals=False)
        if rhs is None:
            return None
        subexprs.append(Assignment(a.lhs, rhs))
    grads_rhs: Dict[tuple, sp.Expr] = {}
    for a in state_mains:
        m = a.lhs.field.corresponding_forward_field.name
        rhs = substituted(a.rhs, allow_state_primals=False)
        if rhs is None:
            return None
        grads_rhs[(m, a.lhs.index)] = rhs

    diff_names = [n for n in in_names
                  if n not in declared_const and n not in coeff_names]
    mains = []
    for m in diff_names:
        f = fwd_in[m]
        for idx in field_components(f):
            rhs = grads_rhs.get((m, idx), sp.Integer(0))
            for n in pass_to.get(m, ()):
                rhs = rhs + Field.Access(cot_field[n],
                                         (0,) * f.spatial_dimensions, idx)
            mains.append(Assignment(
                Field.Access(cot_out_field[m],
                             (0,) * f.spatial_dimensions, idx), rhs))
    new_coll = AssignmentCollection(mains, subexpressions=subexprs)
    read_names = {f.name for f in new_coll.fields_read}
    plain_reads = sorted(read_names & allowed_plain)
    nonplain = read_names - allowed_plain
    view_names = ({cot_field[m].name for m in diff_names}
                  | {mcot_field[m].name for m in diff_names})
    if not nonplain <= view_names:
        return None
    if {n.split("_", 1)[1] for n in nonplain} != set(diff_names):
        return None  # some cotangent never read: carry would be partial
    coeff_fields = [f for f in new_coll.fields_read
                    if f.name in plain_reads]
    cot_op = AutoDiffOp(new_coll, op_name=f"{op.op_name}_cotangent",
                        constant_fields=coeff_fields,
                        do_common_subexpression_elimination=False)
    cot_carry = {cot_field[m].name: cot_out_field[m].name
                 for m in diff_names}
    name_of = {m: cot_field[m].name for m in diff_names}
    # both cotangent views resolve to the primal they belong to; the
    # kernels bind mcot_* to mask⊙cot on bounded domains
    view_of = {cot_field[m].name: m for m in diff_names}
    view_of.update({mcot_field[m].name: m for m in diff_names})
    masked_views = {mcot_field[m].name for m in diff_names}

    # --- the per-stage coefficient-gradient program -------------------------
    if not coeff_names:
        return {"cot_op": cot_op, "cot_carry": cot_carry,
                "name_of": name_of, "plain_reads": plain_reads,
                "coeff_names": [], "grad_prog": None, "saved_names": [],
                "declared_const": sorted(declared_const),
                "view_of": view_of, "masked_views": masked_views}
    sub_coeff = _reachable_subexprs(coll.subexpressions, coeff_mains)
    gsubex, gmains = [], []
    for a in sub_coeff:
        rhs = substituted(a.rhs, allow_state_primals=True)
        if rhs is None:
            return None
        gsubex.append(Assignment(a.lhs, rhs))
    for a in coeff_mains:
        m = a.lhs.field.corresponding_forward_field.name
        rhs = substituted(a.rhs, allow_state_primals=True)
        if rhs is None:
            return None
        gmains.append(Assignment(
            Field.Access(gsum_field[m],
                         (0,) * fwd_in[m].spatial_dimensions,
                         a.lhs.index), rhs))
    gcoll = AssignmentCollection(gmains, subexpressions=gsubex)
    grad_prog = make_program(
        gcoll, input_fields=list(gcoll.fields_read),
        output_fields=[gsum_field[m] for m in coeff_names],
        name=f"{op.op_name}_coeff_grad")
    saved_names = sorted({f.name for f in gcoll.fields_read}
                         & (set(fwd_in) - inv - declared_const))
    return {"cot_op": cot_op, "cot_carry": cot_carry, "name_of": name_of,
            "plain_reads": plain_reads, "coeff_names": coeff_names,
            "grad_prog": grad_prog, "saved_names": saved_names,
            "declared_const": sorted(declared_const), "view_of": view_of,
            "masked_views": masked_views}


class TwinPlan:
    """The forward chain plan plus the twin decomposition's wiring onto the
    kernel's planes: the cotangent planes (one per output plane of the
    cotangent op, i.e. per state plane it carries), the coefficient planes
    (one per grad-program output), and, for each input slot of the
    cotangent body and the grad body, the state plane or cotangent plane
    it reads (masked or not)."""

    def __init__(self, plan: ChainPlan, pieces: dict):
        self.fwd = plan
        self.pieces = pieces
        nd = plan.program.ndim
        keys = plan.plane_keys
        self.cot_prog = forward_program(pieces["cot_op"])
        self.grad_prog = pieces["grad_prog"]
        view_of, masked = pieces["view_of"], pieces["masked_views"]
        out_of = {v: m for m, v in pieces["name_of"].items()}
        # cot_<m>_out planes, in the cotangent op's output order
        self.cot_keys = [(out_of[f.name[:-len("_out")]], idx)
                         for f, idx in output_planes(self.cot_prog)]
        self.coeff_keys = ([(f.name[len("gsum_"):], idx) for f, idx
                            in output_planes(self.grad_prog)]
                           if self.grad_prog is not None else [])

        def slots(prog):
            src, cot, mask = [], [], []
            for f, idx in input_planes(prog):
                if f.name in view_of:
                    src.append(-1)
                    cot.append(self.cot_keys.index((view_of[f.name], idx)))
                    mask.append(int(f.name in masked))
                else:
                    src.append(keys.index((f.name, idx)))
                    cot.append(-1)
                    mask.append(0)
            return src, cot, mask

        self.cot_slots = slots(self.cot_prog)
        self.grad_slots = (slots(self.grad_prog)
                           if self.grad_prog is not None else ([], [], []))
        self.saved_planes = tuple(n for n, (name, _) in enumerate(keys)
                                  if name in pieces["saved_names"])
        self.reach_c = access_reach(self.cot_prog.steps, nd)
        # the accumulation is evaluated on owned cells only; its reads
        # must stay inside the frames available there — cotangent reads
        # within the cotangent chain's per-step reach, primal reads within
        # the forward reach
        if self.grad_prog is not None:
            steps = self.grad_prog.steps
            glo_c, ghi_c = access_reach(steps, nd,
                                        lambda f: f.name in view_of)
            glo_p, ghi_p = access_reach(steps, nd, lambda f: f.name
                                        in pieces["saved_names"])
            (lo_f, hi_f), (lo_c, hi_c) = plan.reach, self.reach_c
            if any(a > b for a, b in zip(glo_c + ghi_c + glo_p + ghi_p,
                                         lo_c + hi_c + lo_f + hi_f)):
                raise ValueError("coefficient-gradient reach exceeds the "
                                 "chain reaches — the twin-accum "
                                 "decomposition does not apply")


# ---------------------------------------------------------------------------
# Plain version.

def plain_twin_accum_vjp(tp: TwinPlan):
    """``fn(state, cots) -> (state_k, cot_0)``: k plain forward steps, then
    k plain backward steps (full domain with the exact-VJP mask, or
    periodic) — the plain version of the two-phase kernel, which computes
    the same function."""
    from .adjoint_chain import AdjointPlan, plain_chain_vjp

    return plain_chain_vjp(AdjointPlan(tp.fwd))


# ---------------------------------------------------------------------------
# The CUDA kernel.

def twin_geometry(tp: TwinPlan, spatial, itemsize: int):
    """The geometry block of the twin kernel: a state halo of
    k·max(forward, cotangent reach), the cotangent reach as the second
    reach, the saved planes kept, two cotangent sets over the extended
    tile and the coefficient accumulators over the owned tile; like the
    two-phase kernel, one large tile per SM."""
    plan = tp.fwd
    (lof, hif), (loc, hic) = plan.reach, tp.reach_c
    return chain_geometry(
        plan, spatial, itemsize,
        halo_reach=([max(a, b) for a, b in zip(lof, loc)],
                    [max(a, b) for a, b in zip(hif, hic)]),
        second_reach=tp.reach_c, keep=tp.saved_planes,
        extra_planes=2 * len(tp.cot_keys), owned_planes=len(tp.coeff_keys),
        blocks_per_sm=1)


def make_twin_accum_kernel(tp: TwinPlan, design: str = "march"):
    """``fn(state, cots) -> (state_k, cot_0)`` through the CUDA
    twin-with-accumulation kernel; same semantics as
    ``plain_twin_accum_vjp``.  Invariant state planes come back as the
    tensors given (the kernel does not write them), declared-constant
    fields' cotangents pass through unchanged.  ``design``: "march" (the
    dim-0 march, ``adjoint_chain.make_chain_march_kernel``, 2D periodic
    and 3D; ``ValueError`` at a shape no march fits) or "box" (the box
    tiles of ``csrc/twin_accum.cuh``: kernel B in 2D, kept for the
    in-turns comparison of the designs)."""
    import sys

    from .adjoint_chain import make_chain_march_kernel

    if design not in ("march", "box"):
        raise ValueError(f"unknown design {design!r}; 'march' or 'box'")
    if design == "march":
        fn = make_chain_march_kernel(tp.fwd, sys.modules[__name__])
        fn.plan = tp
        return fn
    return make_box_twin_kernel(tp)


def make_box_twin_kernel(tp: TwinPlan):
    """The box-tile twin-with-accumulation kernel
    (``csrc/twin_accum.cuh``): kernel B in 2D, and the earlier design of
    kernel C in 3D."""
    from ..codegen.cuda_printer import generate_twin_source

    plan = tp.fwd
    nd = plan.program.ndim
    lib_state: dict = {}
    name = f"{plan.program.name}_twin_accum"
    fields = {f.name: f for f in plan.program.input_fields}
    cot_fields = {m for m, _ in tp.cot_keys}
    coeff_fields = {m for m, _ in tp.coeff_keys}

    def planes_of(keys):
        return [(fields[m], idx) for m, idx in keys]

    def fn(state, cots):
        global LAUNCHES
        a0, spatial = check_state(plan, state)
        _check_inputs(plan.program, cots)

        def out(m):
            return empty(storage_shape(fields[m], spatial), a0.dtype,
                         a0.device)

        new_state = {m: (state[m] if m in plan.invariant else out(m))
                     for m in fields}
        cot0 = {m: (out(m) if m in cot_fields | coeff_fields else cots[m])
                for m in fields}
        if any(n == 0 for n in spatial):
            return real(new_state), real(cot0)
        geo, _ = twin_geometry(tp, spatial, tile_itemsize(a0))
        lib = _load_library(lib_state, partial(generate_twin_source, tp),
                            name, a0.dtype)
        stored = {m: t for m, t in new_state.items()
                  if m not in plan.invariant}
        args = [*plane_args3(plan.planes, state, nd),
                *plane_args3(plan.planes, stored, nd),
                *plane_args3(planes_of(tp.cot_keys), cots, nd),
                *plane_args3(planes_of(tp.cot_keys), cot0, nd),
                *plane_args3(planes_of(tp.coeff_keys), cots, nd),
                *plane_args3(planes_of(tp.coeff_keys), cot0, nd), geo]
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)], args, a0,
               f"{name}: twin-accum launch"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic, spatial,
                          a0.element_size(), "box")] += 1
        return real(new_state), real(cot0)

    fn.plan = tp
    fn.design = "box"
    return fn
