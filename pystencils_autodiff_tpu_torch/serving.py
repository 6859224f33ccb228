"""Ahead-of-time export for serving: the port of
``pystencils_autodiff_tpu/serving.py`` over ``torch.export``.

A stencil op (``export_op``) or a whole recorded program
(``export_program``: ``run(state, n_steps)`` from
``GraphDataHandling.compile``, any fuse mode, a run compiled with
``mesh=``, or a hand-built step) is traced by ``torch.export.export`` into
an ``ExportedProgram``.  The trace goes through the launch families
(``ops/custom_ops.py``: ``through``) down to the kernels: the graph holds
one node of the leaf op ``psat_launch::launch`` (``ops/launch.py``,
``csrc/launch_op.cpp``) per kernel launch, naming its library by sha256,
and the aten glue around them (a sharded run's exchanges are ``narrow``,
a copy to the receiving shard's device and ``cat``).  CPU tensors trace
the plain versions, which are aten ops throughout.  With
``with_gradient`` a second program maps primals and cotangents to
gradients: ``torch.func.vjp`` inside an exported function is refused by
``torch.export`` (torch 2.11 and 2.13), so the gradient program traces
``torch.autograd.grad``, which records the forward launches and the
derived backward's launches that the eager gradient runs (the families'
autograd rules, not autograd through a launch).

``save_exported`` writes ``torch.export.save`` files (``path``, and
``path + ".vjp"``), copies the libraries beside them — the leaf op's
(built with g++ against the running PyTorch, with its CUDA kernel where
the CUDA toolkit is; every artifact carries it) and each kernel library
the graphs name (built for sm_90a), each with its source — and writes the
sidecar ``path + ".meta"``, plain JSON (format 2): the step contract
(``steps_per_call``, ``dynamic``), the PyTorch version and, per library,
its file name, sha256, arch, source file and the launch it serves (the
wrapper's description, as ``ops.launch.LAUNCHES`` counts eager launches).
Nothing is pickled.

The torch-only load, the counterpart of ``jax.export.deserialize``: a
process with PyTorch, ``json`` and the standard library alone — neither
the port, nor SymPy, nor a compiler — loads and runs an artifact:

1. read the sidecar; its ``format`` must be 2;
2. check every library: its file lies in the artifact's directory and
   its bytes have the sidecar's sha256 (else raise, before anything is
   loaded);
3. ``torch.ops.load_library`` the leaf op's library;
4. ``torch.ops.psat_launch.bind(sha256, path)`` each kernel library
   (a library that fails to load raises);
5. ``torch.export.load`` ``path`` (and ``path + ".vjp"``) and call
   ``.module()`` on the inputs; a step-count artifact (``dynamic``) is
   one step: the caller runs it ``n // steps_per_call`` times, ``n`` a
   multiple of ``steps_per_call``.

``load_exported`` is that sequence (its step-count artifacts come back as
``ExportedOp``s, which check the multiple).  On the card nothing is
lowered or compiled at load: every launch runs the hand-written kernel of
a carried library (a refused launch raises), never a plain version.

Devices: ``export_op`` traces on the card unless ``device="cpu"``;
``export_program`` on its example state's device.  A loaded artifact runs
on its inputs' device, its recorded constants (a program's BC planes) on
theirs.  A ``fuse="stages"`` run bakes its geometry into the march's
source: its artifacts are fixed-shape (as the JAX package's Pallas tiles
are shape-specialised); ``export_op`` and replayed programs may be
shape-polymorphic (``torch.export.Dim``s): the window kernel's geometry is
computed from the runtime shape, its R × V tile pinned to the one it
takes at shapes that fill the card (``cuda_kernel.FILL_EXTENT``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Dict, Optional, Sequence

import torch

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
                 dynamic: bool = False):
        self.primal = primal
        self.vjp = vjp
        self.steps_per_call = steps_per_call
        self.dynamic = dynamic
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            from .ops.launch import bind_traced

            bind_traced()
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
    the stencil's ghost layers and an interior of two cells need (lo + hi
    + 2: the traced glue's sizes may not be 1, which ``torch.export``
    specializes).  ``device``: where the
    trace's example tensors live, the card by default."""
    from .ops import forward_program

    device = torch.device("cuda" if device is None else device)
    f = op.torch_function(**kwargs)
    ghost = forward_program(op).ghost
    dims, sizes = _dims(spatial_shape, [lo + hi + 2 for lo, hi in ghost])
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


LAUNCH_OP = "psat_launch.launch.default"
FORMAT = 2


def _launch_keys(programs) -> list:
    """The kernel libraries (sha256) the programs' leaf launches name, in
    first-seen order; raises where a graph holds an op of the port's
    launch families (a load would need the port)."""
    keys = []
    for ep in programs:
        for gm in ep.graph_module.modules():
            if not isinstance(gm, torch.fx.GraphModule):
                continue
            for node in gm.graph.nodes:
                if node.op != "call_function":
                    continue
                target = str(node.target)
                if target == LAUNCH_OP:
                    if node.args[0] not in keys:
                        keys.append(node.args[0])
                elif target.startswith("psat."):
                    raise ValueError(
                        f"the exported graph holds {target}: an artifact "
                        f"holds leaf launches and aten ops only")
    return keys


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _place(src: str, dst: str) -> None:
    """Copy ``src`` to ``dst`` unless it holds the same bytes already;
    through a new file renamed into place, so that a process that has the
    old one loaded keeps its mapping."""
    if os.path.abspath(src) == os.path.abspath(dst) or (
            os.path.exists(dst) and _sha256(dst) == _sha256(src)):
        return
    tmp = f"{dst}.{os.getpid()}.tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _save_program(ep, path: str) -> None:
    """``torch.export.save`` of ``ep`` without its example inputs (full-size
    tensors a load does not need), through a file object:
    ``torch.export.load`` takes a file by name only where the name ends in
    ".pt2"."""
    kept, ep.example_inputs = ep.example_inputs, None
    try:
        with open(path, "wb") as fh:
            torch.export.save(ep, fh)
    finally:
        ep.example_inputs = kept


def save_exported(exported: ExportedOp, path: str) -> None:
    """Write ``path`` (the primal), ``path + ".vjp"`` (with a gradient),
    the libraries the artifact needs (the leaf op's and every kernel
    library the graphs launch, each with its source) into ``path``'s
    directory, and the sidecar ``path + ".meta"`` (see the module doc)."""
    from .codegen.nvcc import CSRC_DIR
    from .ops import launch

    programs = [exported.primal] + ([exported.vjp] if exported.vjp
                                    is not None else [])
    keys = _launch_keys(programs)
    here = os.path.dirname(os.path.abspath(path))
    traced = launch.traced_libraries()
    op_lib = str(launch.launch_op_library())
    sources = [(op_lib, str(CSRC_DIR / "launch_op.cpp"), "launch_op",
                launch.launch_op_arch(), None)]
    for key in keys:
        if key not in traced:
            raise ValueError(f"the exported graph launches library {key}, "
                             f"which this process did not trace")
        sources.append((traced[key]["path"], traced[key]["source"],
                        "kernel", launch.ARCH, traced[key]["launch"]))
    libraries = []
    for lib, src, role, arch, what in sources:
        stem = os.path.splitext(os.path.basename(lib))[0]
        files = {}
        for kind, f in (("file", lib), ("source", src)):
            name = stem + os.path.splitext(f)[1]
            _place(f, os.path.join(here, name))
            files[kind] = name
        libraries.append({"file": files["file"], "sha256": _sha256(
            os.path.join(here, files["file"])), "arch": arch,
            "source": files["source"], "role": role, "launch": what})
    for lib, key in zip(libraries[1:], keys):
        if lib["sha256"] != key:
            raise ValueError(f"library {lib['file']} changed since it was "
                             f"traced")
    _save_program(exported.primal, path)
    if exported.vjp is not None:
        _save_program(exported.vjp, path + ".vjp")
    with open(path + ".meta", "w") as fh:
        json.dump({"format": FORMAT,
                   "steps_per_call": exported.steps_per_call,
                   "dynamic": exported.dynamic,
                   "torch": torch.__version__,
                   "libraries": libraries}, fh, indent=1)


def read_sidecar(path: str) -> dict:
    """The sidecar of the artifact ``path``, its libraries checked: format
    2, every file inside the artifact's directory, every sha256 the
    sidecar's.  Raises ValueError otherwise, having loaded nothing."""
    with open(path + ".meta") as fh:
        meta = json.load(fh)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: sidecar format {meta.get('format')!r}; "
                         f"this loader reads format {FORMAT} (re-export "
                         f"the artifact)")
    here = os.path.realpath(os.path.dirname(os.path.abspath(path)))
    roles = [lib["role"] for lib in meta["libraries"]]
    if roles.count("launch_op") != 1:
        raise ValueError(f"{path}: the sidecar names {roles.count('launch_op')}"
                         f" launch-op libraries, not one")
    for lib in meta["libraries"]:
        full = os.path.realpath(os.path.join(here, lib["file"]))
        if os.path.dirname(full) != here:
            raise ValueError(f"{path}: library {lib['file']!r} lies outside "
                             f"the artifact's directory")
        lib["path"] = full
        if _sha256(full) != lib["sha256"]:
            raise ValueError(f"{path}: library {lib['file']!r} does not "
                             f"match its sha256 in the sidecar")
    return meta


def load_exported(path: str):
    """Load a saved artifact through the torch-only load (see the module
    doc); returns callables ``(fn, vjp_fn|None)`` — a step-count artifact
    as an ``ExportedOp`` (``fn(n_steps, *state)``) with its
    multiple-of-chain-depth check."""
    meta = read_sidecar(path)
    for lib in meta["libraries"]:
        if lib["role"] == "launch_op" and not hasattr(
                torch.ops.psat_launch, "launch"):
            torch.ops.load_library(lib["path"])
    for lib in meta["libraries"]:
        if lib["role"] == "kernel":
            torch.ops.psat_launch.bind(lib["sha256"], lib["path"])
    with open(path, "rb") as fh:
        exp = torch.export.load(fh)
    vjp = None
    if os.path.exists(path + ".vjp"):
        with open(path + ".vjp", "rb") as fh:
            vjp = torch.export.load(fh)
    if meta["dynamic"]:
        return ExportedOp(exp, vjp, int(meta["steps_per_call"]), True), None
    return exp.module(), (vjp.module() if vjp is not None else None)
