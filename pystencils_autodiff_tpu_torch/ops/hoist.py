"""Chain-invariant subexpression hoisting: a copy of
``pystencils_autodiff_tpu/ops/hoist.py`` (pure SymPy; the JAX package's
``ops`` package cannot be imported without jax).

A fused k-step chain re-evaluates every program step k times; steps whose
inputs are *chain-invariant* (fields no carry or boundary event ever
rewrites — variable coefficients like the diffusion κ, wave speed c,
anisotropy tensors) recompute identical values every cycle.

``split_invariant_steps`` partitions a program's non-main steps into a
hoistable prefix (computed ONCE per tile, before the cycle loop, on a
maximal-extent window) and the per-cycle remainder; the chain kernels
(``csrc/time_chain.cuh``) keep the hoisted values in shared-memory planes
and read them per stage like state planes.  Numerically the transform is
exact: the same step expressions see the same values, only fewer times.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import sympy as sp

from ..field import Field

__all__ = ["invariant_fields", "split_invariant_steps",
           "hoist_invariant_subtrees", "plan_hoisting"]


def invariant_fields(in_names: Sequence[str], out_names: Sequence[str],
                     carries, bc_targets: Sequence[str] = ()) -> Set[str]:
    """State fields whose planes provably never change through a cycle:
    not carry-targeted (time_chain semantics: an unmapped name colliding
    with an output IS rewritten), and not written by a BC event."""
    inv = set()
    carry_list = carries if isinstance(carries, (list, tuple)) else [carries]
    for n in in_names:
        rewritten = n in set(bc_targets)
        for carry in carry_list:
            src = carry.get(n, n)
            if n in carry or src in set(out_names):
                rewritten = True
        if not rewritten:
            inv.add(n)
    return inv


def hoist_invariant_subtrees(steps, invariant: Set[str],
                             hoisted_syms: Set[object]):
    """Extract maximal invariant *subtrees* of the remaining steps' RHS as
    synthetic hoisted steps (inlined programs carry no CSE subexpressions,
    so whole-step splitting alone finds nothing to hoist — e.g. the
    variable-κ diffusion's ``dt·(κ_c+κ_n)/2`` face factors live inside one
    big main RHS).  Returns ``(extra_hoisted, rewritten_steps)``; identical
    subtrees across steps share one hoisted plane."""
    from .common import Step, _compile_rhs

    cache: Dict[sp.Expr, sp.Dummy] = {}
    extra: List[Step] = []

    def is_invariant(e) -> bool:
        if isinstance(e, Field.Access):
            return e.field.name in invariant
        if e.is_Number:
            return True
        if isinstance(e, sp.Symbol):
            return e in hoisted_syms
        return bool(e.args) and all(is_invariant(a) for a in e.args)

    def rewrite(e):
        if isinstance(e, (Field.Access, sp.Symbol)) or e.is_Number:
            return e
        if is_invariant(e) and e.atoms(Field.Access):
            d = cache.get(e)
            if d is None:
                d = sp.Dummy(f"hoist{len(cache)}")
                cache[e] = d
                accs = sorted(e.atoms(Field.Access),
                              key=sp.default_sort_key)
                syms = sorted((s for s in e.free_symbols
                               if not isinstance(s, Field.Access)
                               and s in hoisted_syms),
                              key=sp.default_sort_key)
                atoms = list(accs) + list(syms)
                extra.append(Step(target=d, atoms=atoms,
                                  fn=_compile_rhs(e, atoms), rhs=e))
            return d
        return e.func(*[rewrite(a) for a in e.args])

    rewritten: List[Step] = []
    for step in steps:
        new_rhs = rewrite(step.rhs)
        if new_rhs is step.rhs or new_rhs == step.rhs:
            rewritten.append(step)
            continue
        accs = sorted(new_rhs.atoms(Field.Access), key=sp.default_sort_key)
        syms = sorted((s for s in new_rhs.free_symbols
                       if not isinstance(s, Field.Access)),
                      key=sp.default_sort_key)
        atoms = list(accs) + list(syms)
        rewritten.append(Step(target=step.target, atoms=atoms,
                              fn=_compile_rhs(new_rhs, atoms),
                              rhs=new_rhs,
                              is_accumulation=step.is_accumulation))
    return extra, rewritten


def plan_hoisting(steps, invariant: Set[str]):
    """Full hoisting plan for one program: whole invariant steps first,
    then maximal invariant subtrees of what remains.  Returns
    ``(hoisted_steps, cycle_steps)``."""
    hoisted, rest, hs = split_invariant_steps(steps, invariant)
    extra, rest = hoist_invariant_subtrees(rest, invariant, hs)
    return hoisted + extra, rest


def split_invariant_steps(steps, invariant: Set[str]):
    """Partition non-main steps into (hoisted, remaining, hoisted_targets):
    a step hoists when every field access reads an invariant field and
    every symbol atom is itself hoisted."""
    hoisted, rest = [], []
    hs: Set[object] = set()
    for step in steps:
        if (not step.is_main
                and step.atoms  # constant steps are cheap; leave in place
                and all((a.field.name in invariant)
                        if isinstance(a, Field.Access) else (a in hs)
                        for a in step.atoms)):
            hoisted.append(step)
            hs.add(step.target)
        else:
            rest.append(step)
    return hoisted, rest, hs
