"""Ahead-of-time export for serving: the port of
``pystencils_autodiff_tpu/serving.py`` over ``torch.export``.

A stencil op (``export_op``) or a whole recorded program
(``export_program``: ``run(state, n_steps)`` from
``GraphDataHandling.compile``, any fuse mode, or a hand-built step) is
traced by ``torch.export.export`` into an ``ExportedProgram`` whose graph
holds the port's launches as custom ops (``ops/custom_ops.py``:
``psat::stencil``, ``psat::chain``, ``psat::stage_chain`` and their
backward ops), each call naming its registry entry by id.  With
``with_gradient`` a second program maps primals and cotangents to
gradients: ``torch.func.vjp`` inside an exported function is refused by
``torch.export`` (torch 2.11 and 2.13: its functional transform is not
registered with export's tracing mode), so the gradient program traces
``torch.autograd.grad`` instead, which records the forward op and the
backward op its ``register_autograd`` calls.

``save_exported`` writes ``torch.export.save`` files (``path``, and
``path + ".vjp"``) and a JSON sidecar (``path + ".meta"``): the step
contract (``steps_per_call``, ``dynamic``) and, for every entry id the
graphs name, the entry pickled — its recipe: the lowered stencil
programs, or the chain's plan with its ops' derived backward
assignments.  ``load_exported`` in a fresh process puts those entries
back in the registry under the same ids and then loads the programs; it
constructs no ``AutoDiffOp`` and derives no adjoint, but it does need the
port importable (SymPy included: the entries lower their programs again,
the CUDA sources and the plain versions, at their first call) — unlike
the JAX artifact, which needs jax alone.

The sidecar's pickles are read by ``_RecipeUnpickler``, which calls
nothing a recipe does not need: before anything is built, every string
in the pickle must be a name, a number or a sign (no parentheses,
spaces or quotes: SymPy's constructors parse strings as code, and the
names end up in generated CUDA sources), and the only globals it
resolves are the port's symbolic and plan classes, SymPy's expression
classes and ``numpy.dtype``.  An artifact naming anything else, a
function or a class of another package, raises ``pickle.UnpicklingError``.

Devices: ``export_op`` traces on the card unless ``device="cpu"``;
``export_program`` on its example state's device.  A loaded artifact runs
on its inputs' device, its recorded constants (a program's BC planes)
on theirs.  A ``fuse="stages"`` run bakes its geometry into the march's
source: its artifacts are fixed-shape (as the JAX package's Pallas tiles
are shape-specialised); ``export_op`` and replayed programs may be
shape-polymorphic (``torch.export.Dim``s).
"""

from __future__ import annotations

import base64
import io
import json
import os
import pickle
import re
from typing import Dict, Optional, Sequence

import sympy
import torch

from .ops import custom_ops
from .ops.stage_chain import StageEntry
from .ops.time_chain import ChainEntry
from .ops.vjp import StencilEntry
from .parallel.chain import ShardedChainEntry
from .parallel.halo import HaloEntry

__all__ = ["ExportedOp", "export_op", "export_program", "load_exported",
           "save_exported"]

class ExportedOp:
    """A pair of exported programs: the primal and (optionally) its VJP.

    ``dynamic`` marks a step-count artifact (``export_program(n_steps=
    None)``): the primal is one ``run.step`` and ``op(n_steps, *state)``
    runs ``n_steps // steps_per_call`` of them on the host — ``torch.export``
    has no dependable loop over custom ops.  ``n_steps`` counts physical
    steps and must be a multiple of ``steps_per_call`` (a ``fuse="stages"``
    step advances k cycles): anything else raises ValueError, for Python
    and numpy integers and 0-d tensors alike."""

    def __init__(self, primal, vjp=None, steps_per_call: int = 1,
                 dynamic: bool = False, entries=None):
        self.primal = primal
        self.vjp = vjp
        self.steps_per_call = steps_per_call
        self.dynamic = dynamic
        # the registry entries the graphs call (the registry holds them
        # weakly), by id
        self.entries = ({k: custom_ops.entry(k) for k in _entry_ids(
            [primal] + ([vjp] if vjp is not None else []))}
                        if entries is None else entries)
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            self._fn = self.primal.module()
        fn = self._fn
        if not self.dynamic:
            return fn(*args)
        n, state = _step_count(args[0]), tuple(args[1:])
        if n % self.steps_per_call:
            raise ValueError(
                f"n_steps={n} is not a multiple of this artifact's chain "
                f"depth (steps_per_call={self.steps_per_call}); the loop "
                f"would round down")
        for _ in range(n // self.steps_per_call):
            state = tuple(fn(*state))
        return state


def _step_count(n) -> int:
    if isinstance(n, torch.Tensor):
        if n.dim() or n.is_floating_point():
            raise ValueError(f"n_steps must be an integer scalar, got {n!r}")
        return int(n.item())
    if isinstance(n, bool) or not hasattr(n, "__index__"):
        raise ValueError(f"n_steps must be an integer, got {n!r}")
    return int(n)


class _Traced(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _dims(names, min_sizes):
    """One ``torch.export.Dim`` per distinct symbolic name (its minimum the
    largest asked of it, at least 2) and an example size for each."""
    lows: Dict[str, int] = {}
    for s, m in zip(names, min_sizes):
        if isinstance(s, str):
            if not s.isidentifier():
                raise ValueError(f"symbolic dimension {s!r} is not a name")
            lows[s] = max(lows.get(s, 2), int(m), 2)
    dims = {s: torch.export.Dim(s, min=m) for s, m in lows.items()}
    # distinct example sizes, so the trace relates no two dims by chance
    sizes = {s: max(m + 1, 8) + 2 * i for i, (s, m) in enumerate(
        sorted(lows.items()))}
    return dims, sizes


def _spatial_axes(f):
    sd, ni = f.spatial_dimensions, f.index_dimensions
    off = ni if getattr(f, "index_major", False) else 0
    return list(range(off, off + sd))


def _grad_program(fn, n_primals, grad_index):
    """Export ``(primals..., cotangents...) -> gradients`` of ``fn`` with
    respect to the primals at ``grad_index``, through
    ``torch.autograd.grad``."""
    def vjp_fn(*args):
        primals, cots = list(args[:n_primals]), args[n_primals:]
        with torch.enable_grad():
            for i in grad_index:
                primals[i] = primals[i].detach().requires_grad_()
            out = fn(*primals)
            outs = out if isinstance(out, tuple) else (out,)
            grads = torch.autograd.grad(outs, [primals[i] for i in grad_index],
                                        cots, allow_unused=True)
        return tuple(g if g is not None else torch.zeros_like(primals[i])
                     for i, g in zip(grad_index, grads))
    return vjp_fn


def export_op(op, spatial_shape: Sequence, dtype=torch.float32,
              with_gradient: bool = True, device=None, **kwargs):
    """Export ``op.torch_function(**kwargs)`` for the given shapes; returns
    an ``ExportedOp`` (save with ``save_exported``).

    ``spatial_shape`` entries may be symbolic dimension NAMES (strings,
    e.g. ``("n", "m")``): the artifact then serves any spatial size of
    matching rank, each name a ``torch.export.Dim`` at least as large as
    the stencil's ghost layers need (lo + hi + 1).  ``device``: where the
    trace's example tensors live, the card by default."""
    from .ops import forward_program

    device = torch.device("cuda" if device is None else device)
    f = op.torch_function(**kwargs)
    ghost = forward_program(op).ghost
    dims, sizes = _dims(spatial_shape, [lo + hi + 1 for lo, hi in ghost])
    example = tuple(sizes[s] if isinstance(s, str) else int(s)
                    for s in spatial_shape)
    from .ops.common import storage_shape

    args, dyn = [], []
    for fl in op.forward_input_fields:
        args.append(torch.zeros(storage_shape(fl, example), dtype=dtype,
                                device=device))
        dyn.append({a: dims[s] for a, s in zip(_spatial_axes(fl),
                                               spatial_shape)
                    if isinstance(s, str)} or None)
    # (the traced module takes *args: one varargs tuple)
    dynamic_shapes = (tuple(dyn),) if dims else None
    exp = torch.export.export(_Traced(f), tuple(args),
                              dynamic_shapes=dynamic_shapes)
    if not with_gradient:
        return ExportedOp(exp)
    cots, cdyn = [], []
    for fl in op.forward_output_fields:
        cots.append(torch.zeros(storage_shape(fl, example), dtype=dtype,
                                device=device))
        cdyn.append({a: dims[s] for a, s in zip(_spatial_axes(fl),
                                                spatial_shape)
                     if isinstance(s, str)} or None)
    n = len(args)
    exp_vjp = torch.export.export(
        _Traced(_grad_program(f, n, list(range(n)))),
        tuple(args + cots),
        dynamic_shapes=(tuple(dyn + cdyn),) if dims else None)
    return ExportedOp(exp, exp_vjp)


def _symbolic_mins(names, constraints, default: int = 4):
    """Each symbolic name's minimum: ``"n >= 6"`` constraints, else
    ``default``."""
    mins = {s: default for s in names if isinstance(s, str)}
    for c in constraints:
        m = re.fullmatch(r"\s*(\w+)\s*>=\s*(\d+)\s*", c)
        if not m or m.group(1) not in mins:
            raise ValueError(f"constraint {c!r}: expected '<name> >= <int>' "
                             f"over {sorted(mins)}")
        mins[m.group(1)] = int(m.group(2))
    return [mins.get(s, 0) for s in names]


def export_program(run, example_state: Dict[str, torch.Tensor],
                   n_steps: Optional[int] = None,
                   with_gradient: bool = True,
                   grad_field: Optional[str] = None,
                   step=None,
                   symbolic_spatial: Optional[Sequence[str]] = None,
                   spatial_rank: Optional[int] = None,
                   symbolic_constraints: Sequence[str] = ()) -> ExportedOp:
    """Export a whole recorded program — ``run(state, n_steps) -> state``
    from ``GraphDataHandling.compile`` (any fuse mode) or a hand-built
    timeloop — traced on ``example_state``'s device.  The artifact takes
    and returns the state fields in sorted name order.

    ``n_steps=None`` exports a step-count artifact: ONE call of ``step``
    (a ``state -> state`` function; default ``run.step``, which every
    ``GraphDataHandling.compile`` result carries), run ``n // k`` times on
    the host by ``ExportedOp(n, *state)`` (``k = run.steps_per_call``, or
    1 with an explicit ``step``); it is forward-only, and
    ``with_gradient=True`` raises.  ``symbolic_spatial`` (e.g. ``("n",
    "m")``) makes the leading ``spatial_rank`` dims of every state array
    symbolic (minimum 4, or as ``symbolic_constraints`` such as ``"n >=
    6"`` say) — one artifact then serves any grid of matching rank (a
    ``fuse="none"`` replay; the march's sources are fixed-shape).

    With ``with_gradient`` a VJP artifact is exported alongside: it takes
    the state fields plus one cotangent per state field and returns the
    gradients w.r.t. ``grad_field`` (default: every state field).  A run
    compiled with ``mesh=`` exports too: its halo exchanges and sharded
    chains are the ``psat::halo`` and ``psat::sharded_chain`` ops, its
    shards' steps ``psat::stencil`` ops, so the loaded artifact runs each
    shard on its mesh device (the mesh's devices are the artifact's, as
    a JAX export is for its device count) and counts its exchanges."""
    names = sorted(example_state)
    arrays = [example_state[n] for n in names]
    dynamic_shapes = None
    if symbolic_spatial is not None:
        rank = (spatial_rank if spatial_rank is not None
                else len(symbolic_spatial))
        dims, _ = _dims(symbolic_spatial, _symbolic_mins(
            symbolic_spatial, symbolic_constraints))
        # (the traced module takes *args: one varargs tuple)
        dynamic_shapes = (tuple(
            {a: dims[s] for a, s in enumerate(symbolic_spatial[:rank])
             if isinstance(s, str)} or None for _ in names),)

    if n_steps is None:
        explicit = step is not None
        step = step if explicit else getattr(run, "step", None)
        if step is None:
            raise ValueError(
                "n_steps=None (runtime step count) needs a per-step "
                "function: pass step=..., or a run from "
                "GraphDataHandling.compile (which carries run.step)")
        if with_gradient:
            raise ValueError(
                "runtime-step-count artifacts are forward-only (the steps "
                "run in a host loop outside the exported program); export "
                "the VJP from a baked n_steps=... artifact alongside, or "
                "pass with_gradient=False")
        spc = 1 if explicit else getattr(run, "steps_per_call", 1)

        def one_step(*arrs):
            out = step(dict(zip(names, arrs)))
            return tuple(out[n] for n in names)

        exp = torch.export.export(_Traced(one_step), tuple(arrays),
                                  dynamic_shapes=dynamic_shapes)
        return ExportedOp(exp, steps_per_call=spc, dynamic=True)

    def fn(*arrs):
        out = run(dict(zip(names, arrs)), n_steps)
        return tuple(out[n] for n in names)

    exp = torch.export.export(_Traced(fn), tuple(arrays),
                              dynamic_shapes=dynamic_shapes)
    if not with_gradient:
        return ExportedOp(exp)
    gidx = ([names.index(grad_field)] if grad_field
            else list(range(len(names))))
    # cotangent examples of their own: a tensor passed twice would make
    # the trace bind both arguments to one input
    exp_vjp = torch.export.export(
        _Traced(_grad_program(fn, len(names), gidx)),
        tuple(arrays + [torch.zeros_like(a) for a in arrays]),
        dynamic_shapes=((dynamic_shapes[0] + dynamic_shapes[0],)
                        if dynamic_shapes else None))
    return ExportedOp(exp, exp_vjp)


def _entry_ids(programs) -> list:
    """The registry ids the programs' graphs name, in first-seen order."""
    ops = {op._opoverload for op in custom_ops.OPS}
    keys = []
    for ep in programs:
        for gm in ep.graph_module.modules():
            if not isinstance(gm, torch.fx.GraphModule):
                continue
            for node in gm.graph.nodes:
                if (node.op == "call_function" and node.target in ops
                        and node.args[0] not in keys):
                    keys.append(node.args[0])
    return keys


# the entries a loaded artifact calls, kept for the process (the
# registry holds entries weakly)
_LOADED: Dict[str, object] = {}

# every string a recipe's pickle holds: names (fields, symbols, modules,
# ids), numbers (SymPy's Float travels as hex digits), numpy's byte-order
# marks and an adjoint field's LaTeX name
_SAFE_STR = re.compile(r"[A-Za-z0-9_.+\-]*|[<>|=]|\\hat\{[A-Za-z0-9_]*\}")
_STR_OPS = {"UNICODE", "SHORT_BINUNICODE", "BINUNICODE", "BINUNICODE8",
            "STRING", "BINSTRING", "SHORT_BINSTRING", "GLOBAL", "INST"}
# opcodes a recipe never needs: external references, raw buffers
_REFUSED_OPS = {"PERSID", "BINPERSID", "EXT1", "EXT2", "EXT4", "BINBYTES",
                "SHORT_BINBYTES", "BINBYTES8", "BYTEARRAY8", "NEXT_BUFFER",
                "READONLY_BUFFER"}
# the port's modules whose classes a recipe holds
_PORT_MODULES = {f"pystencils_autodiff_tpu_torch.{m}" for m in (
    "field", "adjoint_field", "assignment", "autodiff", "ops.common",
    "ops.chain_bc", "ops.flatten", "ops.stage_chain", "ops.time_chain",
    "ops.vjp", "parallel.mesh", "parallel.halo", "parallel.chain")}


class _RecipeUnpickler(pickle.Unpickler):
    """Unpickles a registry entry's recipe and nothing else (see the
    module doc)."""

    def find_class(self, module, name):
        if module in _PORT_MODULES or module.split(".")[0] == "sympy" or (
                module, name) == ("numpy", "dtype"):
            obj = super().find_class(module, name)
            if isinstance(obj, type) and (
                    module in _PORT_MODULES and obj.__module__ == module
                    or module == "numpy"
                    or issubclass(obj, sympy.Basic)):
                return obj
        raise pickle.UnpicklingError(
            f"an artifact's sidecar may not name {module}.{name}")

    @classmethod
    def loads(cls, blob: bytes):
        import pickletools

        for op, arg, _ in pickletools.genops(blob):
            if op.name in _REFUSED_OPS:
                raise pickle.UnpicklingError(
                    f"an artifact's sidecar may not hold {op.name}")
            if op.name in _STR_OPS:
                parts = (arg.split(" ") if op.name in ("GLOBAL", "INST")
                         else [arg])
                if not all(isinstance(p, str) and _SAFE_STR.fullmatch(p)
                           for p in parts):
                    raise pickle.UnpicklingError(
                        f"an artifact's sidecar holds the string {arg!r}")
        return cls(io.BytesIO(blob)).load()


def save_exported(exported: ExportedOp, path: str) -> None:
    """Write ``path`` (the primal), ``path + ".vjp"`` (with a gradient) and
    the sidecar ``path + ".meta"`` (JSON: the step contract and the
    pickled registry entries the graphs name)."""
    entries = {key: base64.b64encode(pickle.dumps(ent, protocol=4)).decode(
        "ascii") for key, ent in exported.entries.items()}
    # through file objects: torch.export.load takes a file by name only
    # where the name ends in ".pt2"
    with open(path, "wb") as fh:
        torch.export.save(exported.primal, fh)
    if exported.vjp is not None:
        with open(path + ".vjp", "wb") as fh:
            torch.export.save(exported.vjp, fh)
    with open(path + ".meta", "w") as fh:
        json.dump({"format": 1, "steps_per_call": exported.steps_per_call,
                   "dynamic": exported.dynamic, "entries": entries}, fh)


def load_exported(path: str):
    """Load a saved artifact; returns callables ``(fn, vjp_fn|None)``.

    The sidecar's entries go back into the registry first (under their
    ids; an id already present — the exporting process — is kept), so the
    programs' custom ops find their launches.  A step-count artifact
    comes back as an ``ExportedOp`` with its multiple-of-chain-depth check
    intact."""
    with open(path + ".meta") as fh:
        meta = json.load(fh)
    entries = {}
    for key, blob in meta["entries"].items():
        ent = custom_ops.REGISTRY.get(key)
        if ent is None:
            ent = _RecipeUnpickler.loads(base64.b64decode(blob))
            if not isinstance(ent, (StencilEntry, ChainEntry, StageEntry,
                                    HaloEntry, ShardedChainEntry)
                              ) or ent.key != key:
                raise pickle.UnpicklingError(
                    f"sidecar entry {key!r} is no registry entry of that id")
            custom_ops.REGISTRY[key] = ent
        entries[key] = _LOADED[key] = ent
    with open(path, "rb") as fh:
        exp = torch.export.load(fh)
    vjp = None
    if os.path.exists(path + ".vjp"):
        with open(path + ".vjp", "rb") as fh:
            vjp = torch.export.load(fh)
    if meta.get("dynamic"):
        return ExportedOp(exp, vjp, int(meta["steps_per_call"]), True,
                          entries), None
    return exp.module(), (vjp.module() if vjp is not None else None)
