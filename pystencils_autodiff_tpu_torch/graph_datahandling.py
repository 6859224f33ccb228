"""Recorded call-graph datahandling: capture a simulation as a replayable
program — the port of ``pystencils_autodiff_tpu/graph_datahandling.py``.

Rebuild of the reference's ``graph_datahandling.py`` (SURVEY.md §2.1 #14):
there, a pystencils ``DataHandling`` proxy records every call — field
allocations, sweeps, ghost-layer communication, timeloops — so the whole
program can later be code-generated as a waLBerla C++ app.  Here the
recorded graph compiles into ONE differentiable run function; because the
graph is explicit, whole-program optimization is mechanical:

* ``compile(fuse="none")``     — replay nodes as-is (one single-step kernel
  per sweep, ``ops.stage_stepper``),
* ``compile(fuse="symbolic")`` — inline the sweep chain into a single
  symbolic op (``simulation.fuse_carry_chain``; one kernel per *step*),
* ``compile(fuse="stages", k=…)`` — run ``k`` whole timeloop cycles per
  call of ``ops.fused_stage_chain`` (kernel 12, and kernel 13 for its
  gradient with ``fused_bwd=True``) — the recorded graph is exactly the
  stage list the chain needs, recorded boundary nodes its BC events.

``describe()`` renders the recorded graph as indented text and
``to_dict()`` as a JSON-able spec — the inspectable "generated program"
artifact standing in for the reference's emitted C++ main().
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from functools import partial
from typing import Callable, Dict, List, Optional

import torch

from .boundary import BoundaryHandling
from .datahandling import DataHandling
from .timeloop import run_timeloop

__all__ = ["GraphDataHandling", "CallGraph",
           "AllocNode", "SweepNode", "BoundaryNode", "CommNode",
           "TimeloopNode"]

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

@dataclass
class AllocNode:
    name: str
    index_shape: tuple
    dtype: str
    init: float

    def describe(self) -> str:
        idx = f" x{list(self.index_shape)}" if self.index_shape else ""
        return f"alloc {self.name}{idx} : {self.dtype} = {self.init}"

    def spec(self):
        return {"kind": "alloc", "name": self.name,
                "index_shape": list(self.index_shape),
                "dtype": self.dtype, "init": self.init}


@dataclass
class SweepNode:
    op: object  # AutoDiffOp
    carry_map: Dict[str, str]

    def describe(self) -> str:
        reads = sorted(f.name for f in self.op.forward_input_fields)
        writes = sorted(f.name for f in self.op.forward_output_fields)
        carry = ", ".join(f"{d}<-{s}" for d, s in sorted(self.carry_map.items()))
        return (f"sweep {self.op.op_name}: reads {reads} writes {writes} "
                f"carry [{carry}]")

    def spec(self):
        from .ops import forward_program

        prog = forward_program(self.op)
        return {"kind": "sweep", "op": self.op.op_name,
                "reads": sorted(prog.input_names),
                "writes": sorted(prog.output_names),
                "ghost": [list(g) for g in prog.ghost],
                "carry": dict(self.carry_map)}


@dataclass
class BoundaryNode:
    handler: BoundaryHandling

    def describe(self) -> str:
        kinds = {n: "+".join(k for k, *_ in chain)
                 for n, chain in self.handler.specs.items()}
        return f"boundary {kinds}"

    def spec(self):
        return {"kind": "boundary",
                "fields": {n: [k for k, *_ in chain]
                           for n, chain in self.handler.specs.items()}}


@dataclass
class CommNode:
    """Ghost-layer communication point: where the reference's waLBerla
    scheme would exchange MPI halos.  The node records the *intent*; on one
    device it runs nothing."""
    fields: List[str]

    def describe(self) -> str:
        return f"communicate ghost layers: {self.fields}"

    def spec(self):
        return {"kind": "comm", "fields": list(self.fields)}


@dataclass
class TimeloopNode:
    body: List[object] = dc_field(default_factory=list)

    def describe(self) -> str:
        inner = "\n".join("  " + n.describe() for n in self.body)
        return f"timeloop:\n{inner}"

    def spec(self):
        return {"kind": "timeloop", "body": [n.spec() for n in self.body]}


@dataclass
class CallGraph:
    nodes: List[object] = dc_field(default_factory=list)

    def describe(self) -> str:
        return "\n".join(n.describe() for n in self.nodes)

    def to_dict(self):
        return {"nodes": [n.spec() for n in self.nodes]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


# ---------------------------------------------------------------------------
# Recording datahandling
# ---------------------------------------------------------------------------

class _SyntheticPlanes:
    """The array parameters of recorded BCs (masks, damping profiles, wall
    velocities) as chain state fields ``_bc_arr0``, ``_bc_arr1``, ...: one
    field per distinct array, by identity (a damping profile recorded on
    five fields is one plane the kernels read, not five), cast to the
    state's dtype and device on the first call and kept (``cast``)."""

    def __init__(self):
        self.arrays: Dict[str, object] = {}
        self._names: Dict[int, str] = {}
        self._cast: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def register(self, arr) -> str:
        name = self._names.get(id(arr))
        if name is None:
            name = self._names[id(arr)] = f"_bc_arr{len(self.arrays)}"
            self.arrays[name] = arr  # holds it: the id stays its own
        return name

    def cast(self, like) -> Dict[str, torch.Tensor]:
        like = like.blocks[0] if hasattr(like, "blocks") else like
        key = (like.dtype, like.device)
        if key not in self._cast:
            self._cast[key] = {
                n: torch.as_tensor(a, device=like.device).to(like.dtype)
                for n, a in self.arrays.items()}
        return self._cast[key]


class GraphDataHandling(DataHandling):
    """A ``DataHandling`` that records its call graph for whole-program
    compilation (reference ``graph_datahandling.py``, SURVEY.md §2.1 #14).

    Example::

        dh = GraphDataHandling((64, 64), ghost_layers=1)
        dh.add_field("u", init=0.0)
        with dh.timeloop() as loop:
            loop.boundary({"u": "neumann"})
            loop.sweep(heat_op, {"u": "u_next"})
        run = dh.compile()                       # or fuse="symbolic"/"stages"
        final = run(dh.state(), n_steps=100)
        print(dh.graph.describe())               # the recorded program
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.graph = CallGraph()
        self._loop: Optional[TimeloopNode] = None

    # -- recording wrappers ---------------------------------------------------

    def add_field(self, name, index_shape=(), dtype=None, init=0.0,
                  origin=None):
        f = super().add_field(name, index_shape, dtype=dtype, init=init,
                              origin=origin)
        # a scalar init is recorded as is; an array init as a shape
        # placeholder, so the artifact stays JSON-serialisable
        try:
            init_rec = float(init)
        except (TypeError, ValueError, RuntimeError):
            shape = getattr(init, "shape", None)
            init_rec = (f"array{tuple(shape)}" if shape is not None
                        else "array")
        self.graph.nodes.append(AllocNode(
            name, tuple(index_shape),
            str(self.arrays[name].dtype).replace("torch.", ""), init_rec))
        return f

    def _record(self, node):
        (self._loop.body if self._loop is not None
         else self.graph.nodes).append(node)
        return node

    def run_boundary(self, specs):
        self._record(BoundaryNode(BoundaryHandling(self.ghost, specs)))

    def run_sweep(self, op, carry_map: Dict[str, str]):
        self._record(SweepNode(op, dict(carry_map)))

    def communicate(self, *field_names: str):
        self._record(CommNode(list(field_names) or sorted(self.fields)))

    def timeloop(self):
        """Context manager recording a timeloop body."""
        dh = self

        class _Loop:
            def __enter__(self):
                dh._loop = TimeloopNode()
                dh.graph.nodes.append(dh._loop)
                return self

            def __exit__(self, *exc):
                dh._loop = None
                return False

            def boundary(self, specs):
                dh.run_boundary(specs)

            def sweep(self, op, carry_map):
                dh.run_sweep(op, carry_map)

            def communicate(self, *names):
                dh.communicate(*names)

        return _Loop()

    # -- whole-program compilation ---------------------------------------------

    def _timeloop_node(self) -> TimeloopNode:
        loops = [n for n in self.graph.nodes if isinstance(n, TimeloopNode)]
        if len(loops) != 1:
            raise ValueError(f"need exactly one recorded timeloop, "
                             f"have {len(loops)}")
        return loops[0]

    @staticmethod
    def _step_fn(body: List[object], periodic: bool, mesh=None,
                 dim_axes=None) -> Callable[[State], State]:
        from .ops.stage_chain import stage_stepper
        from .parallel.mesh import on_global

        parts = []
        for node in body:
            if isinstance(node, BoundaryNode):
                bh = node.handler

                def bc(state, _bh=bh):
                    return {**state, **{n: on_global(partial(_bh.apply, n),
                                                     state[n])
                                        for n in _bh.specs if n in state}}
                parts.append(bc)
            elif isinstance(node, SweepNode):
                if mesh is not None:
                    # a mesh-decomposed sweep: halo exchange and the op on
                    # every shard (the reference's generated-MPI-app run)
                    from .parallel.sharding import (ShardedStencil,
                                                    sharded_stepper)

                    parts.append(sharded_stepper(
                        node.op, node.carry_map,
                        ShardedStencil(node.op, mesh, dim_axes,
                                       periodic=periodic)))
                else:
                    parts.append(stage_stepper(node.op, node.carry_map,
                                               periodic=periodic))
            elif not isinstance(node, CommNode):  # comm: sweeps exchange
                raise ValueError(f"unsupported node in timeloop: {node}")

        def step(state: State) -> State:
            for p in parts:
                state = p(state)
            return state

        return step

    def compile(self, fuse: str = "none", k: int = 1,
                checkpoint: str = "none", periodic: bool = False,
                mesh=None, dim_axes=None, **kwargs):
        """Compile the recorded graph to ``run(state, n_steps) -> state``
        (``run.step`` advances one call, ``run.steps_per_call`` cycles;
        with fuse="stages" ``run.chain`` is the chain and ``run.bc_planes``
        its synthetic BC planes; ``run.mesh`` the mesh it runs on, or
        None).

        ``fuse="none"``: replay node-by-node (reference semantics).
        ``fuse="symbolic"``: compose the sweep chain into one op.
        ``fuse="stages"``: run the whole timeloop body as a heterogeneous
        fused chain, ``k`` cycles per call; recorded boundary nodes become
        the chain's BC events (frame BCs only on bounded domains).
        ``kwargs`` go to ``ops.fused_stage_chain`` (``fused_bwd``,
        ``dtype``, ``intermediates``); the other modes take none.
        ``checkpoint`` (none, step, sqrt) checkpoints the calls
        (``timeloop.run_timeloop``).

        ``mesh=``/``dim_axes=`` (default: the datahandling's mesh; dims
        default to ``{0: mesh.axis_names[0]}``): run the recorded graph
        mesh-decomposed — with ``fuse="none"`` every sweep runs as a
        ``parallel.ShardedStencil`` (a halo exchange each step), with
        ``fuse="stages"`` the whole body as a comm-avoiding
        ``parallel.ShardedChain`` (one k·reach-deep exchange per call);
        ``fuse="symbolic"`` with a mesh raises ``ValueError``."""
        if fuse not in ("none", "symbolic", "stages"):
            raise ValueError(f"unknown fuse mode {fuse!r}; "
                             f"have 'none', 'symbolic', 'stages'")
        if kwargs and fuse != "stages":
            raise TypeError(f"compile(fuse={fuse!r}) takes no keyword "
                            f"arguments {sorted(kwargs)}")
        if mesh is None and dim_axes is None:
            mesh, dim_axes = self.mesh, self.dim_axes or None
        if mesh is not None:
            if fuse == "symbolic":
                raise ValueError("mesh-decomposed execution supports "
                                 "fuse='none' and fuse='stages'")
            dim_axes = dict(dim_axes or {0: mesh.axis_names[0]})
        body = self._timeloop_node().body
        chain = planes = None
        if fuse == "stages":
            step, chain, planes = self._stage_chain_step(
                body, k, periodic, kwargs, mesh, dim_axes)
        else:
            if fuse == "symbolic":
                body = self._symbolic_body(body)
            step, k = self._step_fn(body, periodic, mesh, dim_axes), 1

        def run(state: State, n_steps: int) -> State:
            if n_steps % k:
                raise ValueError(f"n_steps={n_steps} not divisible by "
                                 f"chain depth k={k}")
            return run_timeloop(step, state, n_steps // k,
                                checkpoint=checkpoint)

        run.step = step
        run.steps_per_call = k
        run.chain, run.bc_planes = chain, planes
        run.mesh = mesh
        return run

    def _symbolic_body(self, body):
        """``body`` with its sweeps fused into one in place: the sweeps must
        be contiguous (a boundary or comm node between them would be
        reordered by fusion)."""
        from .simulation import fuse_carry_chain

        sweep_pos = [j for j, n in enumerate(body) if isinstance(n, SweepNode)]
        if sweep_pos and sweep_pos != list(
                range(sweep_pos[0], sweep_pos[0] + len(sweep_pos))):
            raise ValueError(
                "fuse='symbolic' needs the recorded sweeps to be "
                "contiguous; a boundary/comm node between sweeps would "
                "be reordered by fusion — use fuse='none'")
        fused = fuse_carry_chain([(n.op, n.carry_map) for n in body
                                  if isinstance(n, SweepNode)])
        new_body, placed = [], False
        for n in body:
            if isinstance(n, SweepNode):
                if not placed:
                    new_body.append(SweepNode(fused, fused._fused_carry))
                    placed = True
            elif isinstance(n, BoundaryNode):
                new_body.append(n)
        return new_body

    def _stage_chain_step(self, body, k, periodic, kwargs, mesh=None,
                          dim_axes=None):
        """(step, chain, synthetic planes): ``fused_stage_chain`` (on a
        mesh: ``parallel.ShardedChain``) over the recorded sweeps, the
        recorded BCs folded into it as per-stage events; inline arrays in
        the recorded specs ride as synthetic state fields."""
        from .ops.stage_chain import fused_stage_chain

        planes = _SyntheticPlanes()

        def arg(a):
            """An array parameter as its synthetic field, a number as is."""
            return planes.register(a) if getattr(a, "ndim", 0) > 0 else float(a)

        def as_chain_args(kind, args, kw):
            if kw and (kind != "bounce_back" or set(kw) != {"wrap"}):
                raise ValueError(
                    f"recorded BC {kind!r} keyword arguments {sorted(kw)} "
                    f"cannot fuse into a chain")
            if kind == "bounce_back" and "wrap" in kw \
                    and bool(kw["wrap"]) != bool(periodic):
                raise ValueError(
                    "recorded bounce_back(wrap=%r) conflicts with "
                    "compile(periodic=%r): fused chains wrap "
                    "out-of-domain pulls exactly when the chain domain "
                    "is periodic" % (kw["wrap"], periodic))
            if kind in ("dirichlet", "neumann"):
                return (kind, *args)
            if kind == "masked_dirichlet":
                return (kind, planes.register(args[0]),
                        *(arg(a) for a in args[1:]))
            if kind == "sponge":
                return (kind, arg(args[0]))
            if kind == "bounce_back":
                rest = list(args[1:])
                if rest and rest[0] is not None:
                    rest[0] = tuple(arg(u) for u in rest[0])
                return (kind, planes.register(args[0]), *rest)
            raise ValueError(
                f"recorded BC kind {kind!r} cannot fuse into a chain "
                f"(periodic domains: pass periodic=True instead)")

        sweeps: List[SweepNode] = []
        boundary: Dict[int, dict] = {}
        pending: List[tuple] = []
        for node in body:
            if isinstance(node, SweepNode):
                if pending:
                    stage_specs = boundary.setdefault(len(sweeps), {})
                    for fname, chain_list in pending:
                        stage_specs.setdefault(fname, []).extend(chain_list)
                    pending = []
                sweeps.append(node)
            elif isinstance(node, BoundaryNode):
                for fname, chain_list in node.handler.specs.items():
                    pending.append((fname, [as_chain_args(kind, bargs, bkw)
                                            for kind, bargs, bkw in chain_list]))
            elif not isinstance(node, CommNode):  # comm: the chain needs none
                raise ValueError(f"unsupported node in timeloop: {node}")
        if pending:
            raise ValueError(
                "fuse='stages': a recorded boundary node after the last "
                "sweep has no following stage to attach to — record "
                "boundaries before the sweep they prepare")
        if mesh is not None:
            from .parallel import ShardedChain

            chain = ShardedChain([(s.op, s.carry_map) for s in sweeps], k=k,
                                 mesh=mesh, dim_axes=dim_axes,
                                 periodic=periodic,
                                 boundary=boundary or None, **kwargs)
        else:
            chain = fused_stage_chain([(s.op, s.carry_map) for s in sweeps],
                                      k=k, periodic=periodic,
                                      boundary=boundary or None, **kwargs)
        chain_fields = [n for n in chain.input_names
                        if n not in planes.arrays]

        def step(state: State) -> State:
            # state fields no sweep reads pass through untouched, as in
            # fuse="none"; the synthetic planes never enter the state
            inner = {n: state[n] for n in chain_fields}
            out = chain({**inner, **planes.cast(inner[chain_fields[0]])})
            return {**state, **{n: out[n] for n in chain_fields}}

        return step, chain, planes
