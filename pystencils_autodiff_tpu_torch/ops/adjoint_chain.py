"""Fused adjoint chains: the value and gradient of k time steps in ONE
kernel — the port of ``pystencils_autodiff_tpu/ops/adjoint_chain.py``.

``fused_chain_vjp(op, k, carry_map)`` returns
``g(state, cot_state[, probe_cots]) -> (state_k, cot_0)``: it advances the
state k steps and pulls the cotangent of state_k (and of the per-stage
probe rows) back to the cotangent of the state before the k steps, ghost
cells included.  The route is chosen from the op alone, as the JAX
package's interpret path chooses it (``g.route``):

* ``"twin"`` — a linear op on a periodic domain without probes: the
  k-step VJP is (Aᵀ)ᵏ, so state and cotangent advance through two forward
  chains (``ops.time_chain``); ``transposed_linear_op`` builds Aᵀ
  symbolically.
* ``"twin_accum"`` — without probes, on a 2D periodic or any 3D domain, an
  op linear in its state whose differentiable nonlinearity is a
  chain-invariant coefficient (wave with a time-constant c, variable-κ
  diffusion with ∂/∂κ), or in 3D bounded a pure-linear op:
  ``ops.twin_adjoint`` (the dim-0 march, below).
* ``"two_phase"`` — 2D otherwise, bounded or periodic (the counterpart of
  the Pallas kernel ``fused_chain_vjp.build``): phase 1 recomputes the k
  stages keeping the primal planes the backward program reads; phase 2
  walks the stages back through the backward program, threading
  cotangents through the transposed carry map:

      ĉ_s[m] = Σ_{n: carry[n] is an output o} (∂F_o/∂m)ᵀ · ĉ_{s+1}[n]
             + Σ_{n: carry[n] == m (pass-through)} ĉ_{s+1}[n]

  An output carried into several state fields is read as the sum of
  their cotangents.

  On the card the 2D ``"two_phase"`` route and the ``"twin_accum"``
  route (2D periodic and 3D) run the two-phase mode of the dim-0 march
  (``ops.stage_march``, ``csrc/stage_march.cuh``) over the chain seen as
  a one-stage cycle repeated k times (``stage_march.chain_march_plans``;
  probe rows join the march); ``make_adjoint_kernel(ap, "box")`` and
  ``twin_adjoint.make_twin_accum_kernel(tp, "box")`` build the earlier box
  kernels (``csrc/adjoint_chain.cuh``, ``csrc/twin_accum.cuh``: kernel B
  in 2D), which no route picks.  ``make_chain_forward_march_kernel`` is
  the march's forward mode over the same one-stage cycle: row 7, the 3D
  forward chain of ``time_chain.make_chain_kernel``.
* ``"plane_two_phase"`` — 3D otherwise (a nonlinear op, or any op with
  probes), bounded or periodic in all three dims: the same two phases in
  the z-streaming kernel (``ops.plane_adjoint``, ``csrc/plane_adjoint.cuh``,
  the counterpart of the Pallas kernel ``plane_adjoint.py::
  make_plane_chain_vjp_fn``).  A 3D probe row names the line
  ``divmod(row, n1)`` along the last dim (``time_chain.probe_index``);
  3D periodic chains take no probes, as in the JAX package.

The two-phase routes and the 3D twin-accum route run as segments where no
kernel of depth k fits (``two_phase_segments``: the fewest segments, a
divisor of k, whose k/m-deep kernel fits — the march's reckoning
``stage_march.march_fits`` in 2D and for the 3D twin, the z-streaming
kernel's in 3D; a host reckoning of the plan, the shape and the itemsize,
made before any launch): the k/m-deep forward chain writes the m − 1
checkpoints, then each segment's kernel recomputes its own forward from
its checkpoint, in reverse; ``g.segments`` says how many the last call
ran.

On CUDA tensors the kernel runs (or raises); on CPU tensors the plain
version (``plain_chain_vjp``: k single forward steps, then k single
backward steps of ``ops.torch_ref`` in full+mask or periodic mode).
``LAUNCHES`` / ``LAUNCH_CALLS`` count the 2D two-phase kernel's launches
(keyed ``(op, k, periodic, shape, itemsize, design)``; ``ops.plane_adjoint``
counts the streaming kernel's).
"""

from __future__ import annotations

import sys
from collections import Counter
from functools import partial
from typing import Dict, List, Optional

import torch

from ..adjoint_field import AdjointField
from ..codegen.cuda_printer import output_planes
from ..field import Field
from .common import (assemble_planes, backward_program, check_ported,
                     derived, field_components, storage_shape,
                     storage_spatial)
from .cuda_kernel import (_DTYPES, _check_inputs, on_card, on_device,
                          tile_itemsize)
from .launch import Ptrs, empty, real, run
from .time_chain import (SMEM_BUDGET, ChainPlan, _load_library,
                         access_reach, chain_geometry, chain_plan,
                         chain_runner, check_state, plan_at_depth,
                         plane_args3, probe_index, sequential_chain_vjp)
from .torch_ref import make_torch_stencil
from ..utils.config import log_lowering_decision

__all__ = ["fused_chain_vjp", "transposed_linear_op", "plain_chain_vjp",
           "make_adjoint_kernel", "make_chain_march_kernel",
           "make_chain_forward_march_kernel", "AdjointPlan",
           "reset_launch_counts",
           "LAUNCHES", "LAUNCH_CALLS"]

LAUNCHES = 0
LAUNCH_CALLS: Counter = Counter()


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_CALLS.clear()


def transposed_linear_op(op, carry_map: Dict[str, str]):
    """For a *linear* op (backward program reads only adjoint fields and
    ``constant_fields`` coefficients) build the stencil op that advances
    the chain's **cotangents** one step as a plain forward stencil,
    together with its carry map (a copy of the JAX package's function,
    building the port's ``AutoDiffOp``).

    The k-step VJP of a linear chain ``state ← A·state`` is ``(Aᵀ)ᵏ``
    applied to the incoming cotangents.  Each adjoint field ``\\hat m`` is
    renamed to a plain field ``cot_<m>`` and the carry transposition is
    folded in:

        cot_m_out ← bwd_rhs[\\hat o ↦ Σ_{n: carry[n]=o} cot_n]
                    + Σ_{n: carry[n]=m} cot_n[center]

    Returns ``(cot_op, cot_carry, name_of, coeff_reads)`` or ``None`` when
    the op is not linear in state."""
    import sympy as sp

    from ..assignment import (Assignment, AssignmentCollection,
                              StagedAssignmentCollection)
    from ..autodiff import AutoDiffOp

    coll = op.backward_assignments
    if isinstance(coll, StagedAssignmentCollection):
        return None
    in_names = [f.name for f in op.forward_input_fields]
    out_names = [f.name for f in op.forward_output_fields]
    # constant_fields coefficients keep the op linear in state; their
    # arrays ride the cotangent chain unchanged.  time_constant_fields do
    # not qualify: their gradient accumulates primal⊗cotangent products.
    constant_names = {f.name for f in op.constant_fields}
    if constant_names & (set(carry_map) | set(carry_map.values())):
        return None  # a carried field cannot be chain-constant
    diff_names = [n for n in in_names if n not in constant_names]
    if any(not isinstance(a.field, AdjointField)
           and a.field.name not in constant_names for a in coll.accesses()):
        return None  # nonlinear: reads differentiable primal fields
    next_src = {n: carry_map.get(n, n) for n in in_names}
    pass_to: Dict[str, list] = {m: [] for m in in_names}
    feeds_output: Dict[str, list] = {o: [] for o in out_names}
    for n, src in next_src.items():
        if src in feeds_output:
            feeds_output[src].append(n)
        else:
            pass_to[src].append(n)

    fwd_in = {f.name: f for f in op.forward_input_fields}

    def _like(name, f):
        nf = Field(name, f.spatial_dimensions, index_shape=f.index_shape,
                   dtype=f.dtype, layout=f.layout)
        nf.index_major = getattr(f, "index_major", False)
        return nf

    cot_field = {m: _like(f"cot_{m}", f) for m, f in fwd_in.items()}
    cot_out_field = {m: _like(f"cot_{m}_out", f) for m, f in fwd_in.items()}

    def substituted(expr):
        mapping = {}
        for a in expr.atoms(Field.Access):
            if not isinstance(a.field, AdjointField):
                if a.field.name in constant_names:
                    continue  # coefficient read: stays as-is in the cot op
                return None
            primal = a.field.corresponding_forward_field.name
            carriers = feeds_output.get(primal)
            if carriers is None:
                # adjoint of an input (accumulator-prev): reads zero
                mapping[a] = sp.Integer(0)
            else:
                mapping[a] = sum(
                    (Field.Access(cot_field[n], a.offsets, a.index)
                     for n in carriers), sp.Integer(0))
        return expr.subs(mapping, simultaneous=True)

    subexprs = []
    for a in coll.subexpressions:
        rhs = substituted(a.rhs)
        if rhs is None:
            return None
        subexprs.append(Assignment(a.lhs, rhs))

    grads_rhs: Dict[tuple, sp.Expr] = {}
    for a in coll.main_assignments:
        m = a.lhs.field.corresponding_forward_field.name
        rhs = substituted(a.rhs)
        if rhs is None:
            return None
        grads_rhs[(m, a.lhs.index)] = rhs

    mains = []
    for m, f in fwd_in.items():
        if m in constant_names:
            continue  # no cotangent for declared-constant coefficients
        center = (0,) * f.spatial_dimensions
        for idx in field_components(f):
            rhs = grads_rhs.get((m, idx), sp.Integer(0))
            for n in pass_to.get(m, ()):
                rhs = rhs + Field.Access(cot_field[n], center, idx)
            mains.append(Assignment(Field.Access(cot_out_field[m], center,
                                                 idx), rhs))

    new_coll = AssignmentCollection(mains, subexpressions=subexprs)
    read_names = {f.name for f in new_coll.fields_read}
    if read_names - constant_names != {cot_field[m].name for m in diff_names}:
        return None  # some cotangent never read: carry would be partial
    coeff_reads = sorted(read_names & constant_names)
    coeff_fields = [f for f in new_coll.fields_read if f.name in coeff_reads]
    cot_op = AutoDiffOp(new_coll, op_name=f"{op.op_name}_cotangent",
                        constant_fields=coeff_fields,
                        do_common_subexpression_elimination=False)
    cot_carry = {cot_field[m].name: cot_out_field[m].name for m in diff_names}
    name_of = {m: cot_field[m].name for m in diff_names}
    return cot_op, cot_carry, name_of, coeff_reads


class AdjointPlan:
    """The forward chain plan plus the backward program's wiring onto the
    state planes: which state plane each backward input reads as a primal
    or as a cotangent, which backward output is each plane's gradient, and
    which cotangents pass through (the transposed carry map)."""

    def __init__(self, plan: ChainPlan):
        op = plan.op
        self.fwd = plan
        self.bwd = bwd = backward_program(op)
        check_ported(bwd)
        keys = plan.plane_keys
        feeds_output: Dict[str, list] = {
            f.name: [] for f in plan.program.output_fields}
        for name in plan.in_names:
            if plan.next_src[name] in feeds_output:
                feeds_output[plan.next_src[name]].append(name)
        self.feeds_output = feeds_output
        # state plane m ← cotangents of the planes carried from it unchanged
        self.pass_to: List[List[int]] = [[] for _ in keys]
        for n, (name, idx) in enumerate(keys):
            src = plan.next_src[name]
            if src not in feeds_output:
                self.pass_to[keys.index((src, idx))].append(n)
        # per backward input plane: the state plane it reads as a primal
        # (or -1), and the state planes whose cotangents it reads summed —
        # the carriers of its output (empty: it reads 0)
        self.prim: List[int] = []
        self.adj: List[List[int]] = []
        saved = set()
        for f in bwd.input_fields:
            for idx in field_components(f):
                if isinstance(f, AdjointField):
                    primal = f.corresponding_forward_field.name
                    self.adj.append([keys.index((n, idx))
                                     for n in feeds_output.get(primal, [])])
                    self.prim.append(-1)
                else:
                    if (f.name, idx) not in keys:
                        raise NotImplementedError(
                            f"{op.op_name}: the backward program reads "
                            f"{f.name!r}, which is not a state field")
                    n = keys.index((f.name, idx))
                    self.prim.append(n)
                    self.adj.append([])
                    if f.name not in plan.invariant:
                        saved.add(n)
        self.saved_planes = tuple(sorted(saved))
        grad_of = {f.name: f.corresponding_forward_field.name
                   for f in op.backward_output_fields}
        self.grad_slot = [-1] * len(keys)
        for slot, (f, idx) in enumerate(output_planes(bwd)):
            self.grad_slot[keys.index((grad_of[f.name], idx))] = slot
        self.reach = access_reach(bwd.steps, plan.program.ndim)


# ---------------------------------------------------------------------------
# Plain version.

FORMS = ("gather", "local")


def _gathered(w, offs, periodic):
    """``out(y) = w(y − o)``: ``w`` moved by the offsets ``offs``, wrapped
    (periodic) or filled with 0 (bounded; ``w`` is 0 wherever a cell moves
    out of the domain, outside the forward interior)."""
    if periodic:
        return torch.roll(w, tuple(offs), tuple(range(w.dim())))
    out = torch.zeros_like(w)
    dst = tuple(slice(max(o, 0), n + min(o, 0)) for o, n in zip(offs, w.shape))
    src = tuple(slice(max(-o, 0), n - max(o, 0)) for o, n in zip(offs,
                                                                    w.shape))
    out[dst] = w[src]
    return out


def plain_chain_vjp(ap: AdjointPlan, form: str = "gather"):
    """``fn(state, cots, probe_cots) -> (state_k, cot_0)`` from the plain
    single steps: phase 1 is the forward chain keeping every stage's
    state; phase 2 runs each reverse stage k times, injecting the probe
    cotangents and threading cotangents through the transposed carry map.
    ``form="gather"`` runs the backward program (full domain with the
    exact-VJP cotangent mask, or periodic); ``form="local"`` the local-VJP
    form (``ops.local_vjp``): the L program at every cell (its cotangent
    inputs masked to the forward interior, or periodic), then the gather
    of its w planes moved by their read offsets."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    plan = ap.fwd
    if plan.shard is not None:
        return _plain_shard_chain_vjp(ap)
    fwd = make_torch_stencil(plan.program, periodic=plan.periodic)
    if form == "local":
        from .local_vjp import local_vjp

        lv = local_vjp(ap)
        bwd = make_torch_stencil(lv.program, full_domain=True,
                                 periodic=plan.periodic,
                                 adjoint_mask_ghost=plan.program.ghost)
        cot_fields = lv.program.input_fields[len(plan.program.input_fields):]
    elif plan.periodic:
        bwd = make_torch_stencil(ap.bwd, full_domain=True, periodic=True)
    else:
        bwd = make_torch_stencil(ap.bwd, full_domain=True,
                                 adjoint_mask_ghost=plan.program.ghost)
    in_names = plan.in_names
    pass_names: Dict[str, List[str]] = {m: [] for m in in_names}
    for n in in_names:
        if plan.next_src[n] not in ap.feeds_output:
            pass_names[plan.next_src[n]].append(n)
    grad_of = {f.name: f.corresponding_forward_field.name
               for f in plan.op.backward_output_fields}
    grad_name = {m: g for g, m in grad_of.items()}

    def adjoint_inputs(fields, cot, st, spatial):
        """ŵ_o = Σ cotangents of the states output o feeds; the adjoint of
        an input (accumulator-prev) reads zero."""
        out = {}
        for f in fields:
            carriers = ap.feeds_output.get(
                f.corresponding_forward_field.name, [])
            out[f.name] = (sum(cot[n] for n in carriers) if carriers
                           else st.new_zeros(storage_shape(f, spatial)))
        return out

    def local_grads(state, cot, spatial):
        """Each state field's gradient gathered from the w planes (None
        where no read of it gets a slot)."""
        ins = {n: state[n] for n in in_names}
        ins.update(adjoint_inputs(cot_fields, cot, state[in_names[0]],
                                  spatial))
        w = bwd(ins)
        grads = {}
        for f in plan.program.input_fields:
            tables = [lv.gather[plan.plane_keys.index((f.name, idx))]
                      for idx in field_components(f)]
            if not any(tables):
                continue
            planes = []
            for table in tables:
                acc = state[f.name].new_zeros(spatial)
                for a, offs in table:
                    acc = acc + _gathered(w[f"w{a}"], offs, plan.periodic)
                planes.append(acc)
            grads[f.name] = assemble_planes(f, planes, spatial)
        return grads

    def fn(state, cots, probe_cots=()):
        st = {n: state[n] for n in in_names}
        f0 = plan.planes[0][0]
        spatial = storage_spatial(f0, st[f0.name])
        states = [st]
        for _ in range(plan.k):
            env = {**st, **fwd(st)}
            st = {n: env[plan.next_src[n]] for n in in_names}
            states.append(st)
        cot = {n: cots[n] for n in in_names}
        for s in range(plan.k - 1, -1, -1):
            for p, (pname, prow) in enumerate(plan.probes):
                c = cot[pname].clone()
                at = probe_index(prow, spatial)
                c[at] = c[at] + probe_cots[p][s]
                cot[pname] = c
            if form == "local":
                grads = local_grads(states[s], cot, spatial)
            else:
                ins = {f.name: states[s][f.name]
                       for f in ap.bwd.input_fields
                       if not isinstance(f, AdjointField)}
                ins.update(adjoint_inputs(
                    [f for f in ap.bwd.input_fields
                     if isinstance(f, AdjointField)], cot, st[f0.name],
                    spatial))
                out = bwd(ins)
                grads = {m: out[g] for m, g in grad_name.items()}
            new = {}
            for m in in_names:
                v = grads.get(m)
                for n in pass_names[m]:
                    v = cot[n] if v is None else v + cot[n]
                new[m] = v if v is not None else torch.zeros_like(st[m])
            cot = new
        return states[-1], cot

    return fn


def _plain_shard_chain_vjp(ap: AdjointPlan):
    """``plain_chain_vjp`` of a sharded plan: ``fn(state, cots,
    probe_cots=(), bases=None)``, autograd through the plain shard mode of
    the forward chain (``time_chain.plain_time_chain``) — the exact VJP
    both forms compute, at every cell of the block."""
    from .time_chain import plain_time_chain

    plan = ap.fwd
    fwd = plain_time_chain(plan)
    names = plan.in_names

    def fn(state, cots, probe_cots=(), bases=None):
        if probe_cots:
            raise NotImplementedError("sharded chains take no probes")
        with torch.enable_grad():
            ins = {n: state[n].detach().requires_grad_() for n in names}
            out, _ = fwd(ins, bases)
            used = [n for n in names if out[n].requires_grad]
            grads = torch.autograd.grad([out[n] for n in used],
                                        [ins[n] for n in names],
                                        [cots[n] for n in used],
                                        allow_unused=True)
        return ({n: out[n].detach() for n in names},
                {n: (g if g is not None else torch.zeros_like(state[n]))
                 for n, g in zip(names, grads)})

    return fn


# ---------------------------------------------------------------------------
# The CUDA two-phase kernel.

def two_phase_kw(ap: AdjointPlan) -> dict:
    """``chain_geometry``'s arguments for the 2D two-phase kernel: a halo
    of the forward plus the backward reach a stage, the saved primal
    planes and two cotangent sets, one block an SM."""
    (lof, hif), (lob, hib) = ap.fwd.reach, ap.reach
    return dict(halo_reach=([a + b for a, b in zip(lof, lob)],
                            [a + b for a, b in zip(hif, hib)]),
                second_reach=ap.reach, keep=ap.saved_planes,
                extra_planes=2 * len(ap.fwd.planes), blocks_per_sm=1)


def two_phase_fits(plan: ChainPlan, spatial, itemsize: int,
                   form: Optional[str] = None, twin: bool = False) -> bool:
    """Whether the value+gradient kernel of ``plan`` fits ``spatial`` at
    ``itemsize`` bytes an element: 2D, and the 3D twin-accum route
    (``twin``), the march (``stage_march.march_fits`` of the chain as a
    one-stage cycle); 3D two-phase, the z-streaming kernel, in ``form`` or
    either form where None."""
    if plan.program.ndim == 3 and not twin:
        from .plane_adjoint import stream_geometry
        return stream_geometry(plan, spatial, itemsize, AdjointPlan(plan),
                               form) is not None
    from .stage_march import chain_march_plans, march_fits
    sp, sap = chain_march_plans(plan)
    return march_fits(sp, spatial, itemsize, sap)


def fused_segments(plan: ChainPlan, spatial, itemsize: int,
                   form: Optional[str] = None,
                   twin: bool = False) -> Optional[int]:
    """How many segments the fused value+gradient of ``plan`` runs as on
    the card: the fewest m (a divisor of k) whose k/m-deep kernel fits
    (``two_phase_fits``; 3D: in ``form``, or either where None) — a pure
    host reckoning —, or None where none fits even at depth 1 (the
    ladder's last rung, the sequential-recompute backward, then runs).
    D3Q19 at 256³ float32: k=4 → 2 segments of depth 2."""
    for m in [d for d in range(1, plan.k + 1) if plan.k % d == 0]:
        if two_phase_fits(plan_at_depth(plan, plan.k // m), spatial,
                          itemsize, form, twin):
            return m
    return None


def two_phase_segments(plan: ChainPlan, spatial, itemsize: int,
                       form: Optional[str] = None, twin: bool = False) -> int:
    """``fused_segments``, raising ValueError where no kernel fits even at
    depth 1."""
    m = fused_segments(plan, spatial, itemsize, form, twin)
    if m is None:
        raise ValueError(
            f"{plan.op.op_name}: no two-phase kernel fits {SMEM_BUDGET} "
            f"bytes of shared memory even at depth 1 for {tuple(spatial)} "
            f"({itemsize}-byte elements)")
    return m


def check_probe_cots(plan: ChainPlan, probe_cots, a0, spatial):
    """The probe cotangents as the two-phase kernels take them: one
    contiguous ``(k, n_last)`` tensor a probe, ``a0``'s type and device."""
    if len(probe_cots) != len(plan.probes):
        raise ValueError(f"{len(plan.probes)} probe cotangents expected, "
                         f"got {len(probe_cots)}")
    pcs = []
    for pc in probe_cots:
        if (pc.device != a0.device or pc.dtype != a0.dtype
                or tuple(pc.shape) != (plan.k, spatial[-1])):
            raise ValueError(
                f"probe cotangent must be {(plan.k, spatial[-1])} "
                f"{a0.dtype} on {a0.device}; got {tuple(pc.shape)} "
                f"{pc.dtype} on {pc.device}")
        pcs.append(pc.contiguous())
    return pcs


def make_chain_march_kernel(plan: ChainPlan, counter, wanted=None):
    """``fn(state, cots, probe_cots=(), bases=None) -> (state_k, cot_0)``
    through the two-phase mode of the dim-0 march over the chain of
    ``plan`` as a one-stage cycle (``stage_march.chain_march_plans``):
    rows 8 (2D) and 11 (3D), and a sharded plan's (``plan.shard``: the
    march's shard mode on one halo-extended block, ``bases`` its base
    offsets; row 9s); same semantics as ``plain_chain_vjp``.
    Chain-invariant state fields come back as the tensors given; the
    cotangent of an invariant field with no gradient (a declared constant,
    or one ``wanted`` does not name) passes through as given.  Launches
    count on ``counter`` (this module, ``ops.twin_adjoint`` or, for a
    sharded plan, ``ops.stage_adjoint``), keyed as
    ``stage_march.make_march_kernel`` keys them."""
    from .stage_march import chain_march_plans, make_march_kernel

    sp, sap = chain_march_plans(plan, wanted)
    kern = make_march_kernel(sp, sap, counter=counter,
                             count_name=plan.op.op_name)

    def fn(state, cots, probe_cots=(), bases=None):
        a0, spatial = check_state(plan, state)
        _check_inputs(plan.program, cots)
        pcs = check_probe_cots(plan, probe_cots, a0, spatial)
        st, cot0 = kern({n: state[n] for n in sp.state_names},
                        {n: cots[n] for n in sap.cot_names}, pcs,
                        bases=bases)
        return st, {n: cot0.get(n, cots[n]) for n in plan.in_names}

    fn.design = "march"
    fn.kernel = kern
    fn.geometry = kern.geometry
    return fn


def make_chain_forward_march_kernel(plan: ChainPlan, counter):
    """``fn(state) -> (state, probe_list)`` through the forward mode of the
    dim-0 march over the chain of ``plan`` as a one-stage cycle
    (``stage_march.chain_stage_plan``): row 7, the 3D forward chain; same
    semantics as ``time_chain.plain_time_chain``, probe rows (2D) and
    lines (3D) included, each recorded after every stage.  Chain-invariant
    state fields come back as the tensors given; a probe of one raises
    (``stage_march.march_program``).  Launches count on ``counter``
    (``ops.time_chain``)."""
    from .stage_march import chain_stage_plan, make_march_kernel

    sp = chain_stage_plan(plan)
    kern = make_march_kernel(sp, counter=counter, count_name=plan.op.op_name)

    def fn(state, bases=None):
        a0, spatial = check_state(plan, state)
        recs = [empty((plan.k, spatial[-1]), a0.dtype, a0.device)
                for _ in plan.probes]
        out = kern({n: state[n] for n in sp.state_names}, records=recs,
                   bases=bases)
        return out, real(recs)

    fn.plan = plan
    fn.design = "march"
    fn.kernel = kern
    fn.geometry = kern.geometry
    return fn


def make_adjoint_kernel(ap: AdjointPlan, design: str = "march"):
    """``fn(state, cots, probe_cots) -> (state_k, cot_0)`` through the
    2D two-phase kernel; same semantics as ``plain_chain_vjp``.
    Chain-invariant state fields come back as the tensors given.
    ``design``: "march" (the dim-0 march, ``make_chain_march_kernel``;
    ``ValueError`` at a shape no march fits) or "box" (the box tiles of
    ``csrc/adjoint_chain.cuh``, kept for the in-turns comparison of the
    two designs)."""
    if design == "march":
        fn = make_chain_march_kernel(ap.fwd, sys.modules[__name__])
        fn.plan = ap
        return fn
    if design == "box":
        return make_box_adjoint_kernel(ap)
    raise ValueError(f"unknown design {design!r}; 'march' or 'box'")


def make_box_adjoint_kernel(ap: AdjointPlan):
    """``make_adjoint_kernel(ap, "box")``: the box-tile two-phase kernel
    (``csrc/adjoint_chain.cuh``)."""
    from ..codegen.cuda_printer import generate_adjoint_source

    plan = ap.fwd
    lib_state: dict = {}
    name = f"{plan.program.name}_adjoint_chain"

    def fn(state, cots, probe_cots=()):
        global LAUNCHES
        a0, spatial = check_state(plan, state)
        _check_inputs(plan.program, cots)
        pcs = check_probe_cots(plan, probe_cots, a0, spatial)
        fields = plan.program.input_fields
        new_state = {f.name: (state[f.name] if f.name in plan.invariant else
                              empty(storage_shape(f, spatial), a0.dtype,
                                    a0.device))
                     for f in fields}
        cot0 = {f.name: empty(storage_shape(f, spatial), a0.dtype,
                              a0.device)
                for f in fields}
        if any(n == 0 for n in spatial):
            return real(new_state), real(cot0)
        geo, _ = chain_geometry(plan, spatial, tile_itemsize(a0),
                                **two_phase_kw(ap))
        lib = _load_library(lib_state, partial(generate_adjoint_source, ap),
                            name, a0.dtype)
        stored = {n: t for n, t in new_state.items()
                  if n not in plan.invariant}
        args = [a for t in (state, cots, stored, cot0)
                for a in plane_args3(plan.planes, t, plan.program.ndim)]
        args += [Ptrs((p, 0) for p in pcs), geo]
        if run(lib, [_DTYPES[a0.dtype], int(plan.periodic)], args, a0,
               f"{name}: two-phase launch"):
            LAUNCHES += 1
            LAUNCH_CALLS[(plan.op.op_name, plan.k, plan.periodic, spatial,
                          a0.element_size(), "box")] += 1
        return real(new_state), real(cot0)

    fn.plan = ap
    fn.design = "box"
    return fn


# ---------------------------------------------------------------------------
# The user-facing function.

def _twin_chains(op, k, carry_map, twin):
    """(Aᵀ)ᵏ: the state and the cotangent advance through two periodic
    forward chains."""
    cot_op, cot_carry, name_of, coeff_reads = twin
    in_names = [f.name for f in op.forward_input_fields]
    fwd = chain_runner(chain_plan(op, k, carry_map, True))
    cot = chain_runner(chain_plan(cot_op, k, cot_carry, True))

    def g(state, cot_state, probe_cots=()):
        st, _ = fwd({n: state[n] for n in in_names})
        ct = {name_of[m]: cot_state[m] for m in name_of}
        for cn in coeff_reads:  # coefficients ride the cot chain unchanged
            ct[cn] = state[cn]
        ct, _ = cot(ct)
        # declared-constant coefficients: the chain returns them unchanged,
        # so their VJP keeps the identity pass-through term
        return st, {m: (ct[name_of[m]] if m in name_of
                        else cot_state.get(m, torch.zeros_like(state[m])))
                    for m in in_names}

    g.route = "twin"
    g.sequential = lambda state: False
    return g


def fused_chain_vjp(op, k: int, carry_map: Dict[str, str],
                    periodic: bool = True, probes=None,
                    segments: Optional[int] = None,
                    form: Optional[str] = None):
    """Build ``g(state, cot_state[, probe_cots]) -> (state_k, cot_0)`` for a
    2D or 3D op (see the module doc).  ``cot_state``/``cot_0`` are
    cotangent dicts keyed like the state; ``probe_cots`` holds one
    ``(k, cols)`` cotangent per probe, injected into the named field's
    cotangent at its row before each reverse stage.

    The two-phase routes run as segments where no k-deep tile fits
    (``two_phase_segments``, from the tile reckoning when a shape is
    first seen on the card; ``g.segments`` is the count of the last call):
    each segment recomputes its forward from a checkpoint the forward
    chain wrote.  ``segments`` forces the count (a divisor of k), on the
    CPU too.  Where no kernel fits even at depth 1 (``fused_segments`` is
    None; ``g.segments`` None), the route runs the ladder's last rung: the
    sequential-recompute backward (``time_chain.sequential_chain_vjp``,
    the ``fused_bwd=False`` path), as the JAX package does.

    3D two-phase route: the z-streaming kernel runs in the form its
    reckoning picks for the shape (``plane_adjoint.stream_geometry``),
    ``form`` ("gather" or "local") forces one, on the card and on the CPU
    (whose plain version runs the gather form where ``form`` is None);
    ``g.form`` is the form of the last call."""
    from .twin_adjoint import (TwinPlan, make_twin_accum_kernel,
                               plain_twin_accum_vjp, state_coeff_twin)

    plan = chain_plan(op, k, carry_map, periodic, probes)
    nd = plan.program.ndim
    if periodic and not plan.probes:
        twin = derived(op, ("transposed", tuple(sorted(carry_map.items()))),
                       lambda: transposed_linear_op(op, carry_map))
        if twin is not None:
            g = _twin_chains(op, k, carry_map, twin)
            g.input_names, g.k = plan.in_names, k
            return g
    pieces = None
    if not plan.probes and ((periodic and nd == 2) or nd == 3):
        allow = nd == 3 and not periodic
        pieces = derived(
            op, ("state_coeff", tuple(sorted(carry_map.items())), allow),
            lambda: state_coeff_twin(op, carry_map, allow_no_coeff=allow))
    if pieces is not None and nd == 2:  # row 10: the march's two-phase mode
        tp = TwinPlan(plan, pieces)
        run = on_device(make_twin_accum_kernel(tp),
                        plain_twin_accum_vjp(tp), plan.in_names[0])
        seq = sequential_chain_vjp(plan)
        fits: Dict[tuple, bool] = {}

        def sequential(state):
            """Whether ``g`` takes the ladder's last rung for ``state``: on
            the card, where no march fits the shape."""
            if not on_card(state[plan.in_names[0]]):
                return False
            a0, spatial = check_state(plan, state)
            key = (spatial, tile_itemsize(a0))
            if key not in fits:
                fits[key] = two_phase_fits(plan, *key, twin=True)
                log_lowering_decision(plan.program.name, route="twin_accum",
                                      k=k, spatial=spatial,
                                      itemsize=key[1], fits=fits[key])
            g.segments = 1 if fits[key] else None
            return not fits[key]

        def g(state, cot_state, probe_cots=()):
            """The march at depth k where it fits the shape, else the
            sequential-recompute backward (the ladder's last rung)."""
            if sequential(state):
                return seq(state, cot_state)
            return run(state, cot_state)

        g.sequential = sequential
        g.route = "twin_accum"
        g.input_names, g.k, g.plan = plan.in_names, k, tp
        return g
    twin3 = pieces is not None
    if segments is not None and (segments < 1 or k % segments):
        raise ValueError(f"segments={segments} must divide k={k}")
    if form is not None and (form not in FORMS or nd != 3 or twin3):
        raise ValueError(f"form={form!r}: the z-streaming kernel's forms "
                         f"{FORMS} take 3D two-phase chains")
    route = ("twin_accum" if twin3 else
             "plane_two_phase" if nd == 3 else "two_phase")
    ap_k = TwinPlan(plan, pieces) if twin3 else AdjointPlan(plan)
    parts: Dict[int, tuple] = {}

    def at_depth(d, f=form):
        """(value+gradient kernel, its plain version, forward runner) d
        steps deep, the z-streaming kernel in form ``f``."""
        if (d, f) not in parts:
            from .plane_adjoint import make_plane_adjoint_kernel

            p = plan if d == k else plan_at_depth(plan, d)
            if twin3:
                tp = ap_k if d == k else TwinPlan(p, pieces)
                kernel, plain = (make_twin_accum_kernel(tp),
                                 plain_twin_accum_vjp(tp))
            else:
                ap = ap_k if d == k else AdjointPlan(p)
                kernel = (make_plane_adjoint_kernel(ap, f) if nd == 3
                          else make_adjoint_kernel(ap))
                plain = plain_chain_vjp(ap, f or "gather")
            parts[d, f] = (kernel, plain, chain_runner(p))
        return parts[d, f]

    chosen: Dict[tuple, tuple] = {}
    seq = sequential_chain_vjp(plan)
    first = plan.program.input_fields[0]

    def pick(state):
        """(segments m — None for the ladder's last rung —, form) for
        ``state``'s shape: with ``form=None`` the 3D two-phase route takes
        the measured-best form where an autotune sweep recorded one
        (``utils.autotune.tuned_tile``: device, shape, type), else the
        reckoning's; on the card m is ``fused_segments``' pick."""
        t0 = state[plan.in_names[0]]
        card = on_card(t0)
        key = (card, tuple(t0.shape), t0.dtype, t0.device)
        if key not in chosen:
            f = form
            if f is None and nd == 3 and not twin3:
                from ..utils.autotune import tuned_tile
                f = tuned_tile("chain", "vjp", op.op_name,
                               storage_spatial(first, state[first.name]),
                               t0.dtype, periodic, k,
                               device=t0.device)
            if segments is not None:
                m = segments
            elif card:
                a0, spatial = check_state(plan, state)
                m = fused_segments(plan, spatial, tile_itemsize(a0), f,
                                   twin3)
                log_lowering_decision(plan.program.name, route=route, k=k,
                                      spatial=spatial, form=f, segments=m)
            else:
                m = 1
            chosen[key] = (m, f)
        return chosen[key]

    def g(state, cot_state, probe_cots=()):
        """The chain as m segments of k/m steps: the k/m-deep forward chain
        writes the m − 1 checkpoints, then the k/m-deep two-phase kernel
        runs each segment in reverse, its probe cotangents the segment's
        rows."""
        card = on_card(state[plan.in_names[0]])
        m, f = pick(state)
        g.segments = m
        if m is None:  # no kernel fits even at depth 1
            g.form = None
            return seq(state, cot_state, probe_cots)
        d = k // m
        kernel, plain, fwd = at_depth(d, f)
        bwd = kernel if card else plain
        cps = [state]
        for _ in range(m - 1):
            cps.append({**state, **fwd(cps[-1])[0]})
        ct, new_state = cot_state, None
        for j in range(m - 1, -1, -1):
            pcs = tuple(pc[j * d:(j + 1) * d] for pc in probe_cots)
            st_j, ct = bwd(cps[j], ct, *([pcs] if pcs else []))
            if new_state is None:
                new_state = st_j
        g.form = (getattr(kernel, "form", None) if card
                  else f or "gather") if nd == 3 and not twin3 else None
        return new_state, ct

    g.sequential = lambda state: (
        segments is None and on_card(state[plan.in_names[0]])
        and pick(state)[0] is None)
    g.route = route
    g.segments = segments
    g.form = form
    g.segments_for = lambda spatial, itemsize: two_phase_segments(
        plan, tuple(spatial), itemsize, form, twin3)
    g.input_names, g.k, g.plan = plan.in_names, k, ap_k
    return g
