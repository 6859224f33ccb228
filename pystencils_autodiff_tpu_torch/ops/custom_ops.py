"""The port's kernel launches as ``torch.library`` custom ops.

Three launch families are ops, each a forward op and a backward op:

    psat::stencil(str key, Tensor[] inputs) -> Tensor[]
    psat::stencil_bwd(str key, Tensor[] saved, Tensor[] cotangents)
        -> Tensor[]
    psat::chain(str key, Tensor[] state) -> Tensor[]
    psat::chain_bwd(str key, Tensor[] state, Tensor[] cotangents,
                    Tensor[] probe_cotangents) -> Tensor[]
    psat::stage_chain(str key, int[]? bases, Tensor[] state) -> Tensor[]
    psat::stage_chain_bwd(str key, int[]? bases, bool[] wanted,
                          Tensor[] state, Tensor[] cotangents) -> Tensor[]

and two families of ``parallel/`` (device-agnostic: one Python kernel for
every device, which runs each shard's kernels by the shard's device):

    psat::halo(str key, Tensor[] blocks) -> Tensor[]
    psat::halo_bwd(str key, Tensor[] cotangents) -> Tensor[]
    psat::sharded_chain(str key, int[] true_global, Tensor[] blocks)
        -> Tensor[]
    psat::sharded_chain_bwd(str key, int[] true_global, bool[] needs,
                            Tensor[] blocks, Tensor[] cotangents)
        -> Tensor[]

``halo`` is one halo exchange over every shard's block
(``parallel.halo.HaloEntry``; its backward the transposed exchange, and
that one's the exchange again), ``sharded_chain`` a ``ShardedChain`` call
over every field's blocks (``parallel.chain.ShardedChainEntry``).  Eager
calls go through their autograd Functions with the entries' same code;
``torch.compile`` traces these ops.

``stencil`` is the op's single step (``ops/vjp.py``: the forward program
in interior or periodic mode; its backward the full-domain masked step or
the staged TF_MAD stages), ``chain`` the fused k-step chain
(``ops/time_chain.py``; its backward the fused adjoint of
``ops/adjoint_chain.py``), ``stage_chain`` kernel 12 (``ops/stage_chain.py``;
its backward kernel 13, ``ops/stage_adjoint.py``; ``wanted`` marks the
state fields, in order, whose gradient is asked for).  Each op registers a
CUDA kernel (the hand-written kernel, which raises where it cannot
launch: a CUDA tensor never reaches a plain version), a CPU kernel (the
family's device-dispatching runner, which on CPU tensors runs the plain
version), ``register_fake`` (output shapes and dtypes, no launch) and, for
the forward ops, ``register_autograd``, whose backward calls the backward
op.  ``stencil_bwd`` registers autograd too (``vjp.StencilEntry``'s
second-order rule: the tangent-linear program's forward and backward,
launched through these same ops), so the stencil differentiates to any
order; ``chain_bwd`` and ``stage_chain_bwd`` register none, and a second
differentiation of a chain raises (the JAX package's fused chains are not
twice differentiable either: ROADMAP Queue 3 #17).  PyTorch's dispatcher
picks the kernel by device.

``torch.export`` traces through the families instead (``through``): an
exported program holds each launch as the leaf op ``psat_launch::launch``
(``ops/launch.py``) and the aten glue around it, and loads without the
port (``serving.py``).

Naming: one generic op per family, keyed by a registry id (``key``, a
string argument of every call), not one op per (program, mode, periodic,
strategy): the op set is fixed when this module is imported.  The id is
the entry's name and a random suffix (``uuid4``).  ``REGISTRY`` is
process-wide state on purpose: the dispatcher it serves is.  It holds its
entries weakly: an entry lives as long as a wrapper or an autograd graph
that calls it, so building functions over and over (a recompute built
per backward, a loop that calls ``torch_function`` every step) does not
grow it.

An entry (``vjp.StencilEntry``, ``time_chain.ChainEntry``,
``stage_chain.StageEntry``) holds its recipe — the lowered programs and
plans, and the flags of its builder — and builds its kernels and plain
versions at their first call.  It provides ``forward(card, extra,
tensors)``, ``fake_forward``,
``backward(card, extra, *lists)``, ``fake_backward``, ``to_save(tensors)``
and ``grads(saved, cotangents, needs, extra)`` (the autograd rule).

No output aliases an input or another output (a custom op may not return
an alias): ``fresh`` copies the rare one that does — a plain version
that passes a tensor through, as a one-step chain carrying ``u_prev ←
u_curr`` does.  Chain-invariant state planes are not outputs at all: the
chain wrappers pass the tensors given through.

The autograd rule is written once (``_save``, ``_pull``) and serves two
adapters: the ops' ``register_autograd`` (what a traced or loaded graph
differentiates) and ``OpFunction``, through which the user-facing
wrappers call the forward ops (``apply``); the stencil's backward op has
the same pair, its ``register_autograd`` and ``StencilBwdFunction``
(``bwd_apply``).  Where grad mode is off in a backward (the common
``backward()``), ``OpFunction.backward`` runs the backward op as before,
with the same launches; where it is on (``create_graph=True``, a
``torch.func`` transform) it records the backward for a further
differentiation.  The Function is needed
because ``torch.func`` transforms refuse the Function PyTorch generates
for a custom op's autograd (it has no ``setup_context``; torch
2.11–2.13), and it is the cheaper eager path: the generated Function
binds its arguments with ``inspect.signature`` on every call.
``torch.export`` and ``torch.compile`` see through it to the ops; a
loaded artifact's graph holds the ops themselves.
"""

import re
import threading
import uuid
import weakref
from typing import List, Optional

import torch

from .launch import exporting

__all__ = ["REGISTRY", "register", "entry", "fresh", "with_autograd",
           "OpFunction", "OpFunctionJvp", "apply", "StencilBwdFunction",
           "StencilBwdFunctionJvp", "bwd_apply",
           "OPS", "stencil", "stencil_bwd", "chain", "chain_bwd",
           "stage_chain", "stage_chain_bwd", "halo", "halo_bwd",
           "sharded_chain", "sharded_chain_bwd", "traced", "through",
           "once_only", "twice_error"]

REGISTRY: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def register(ent) -> str:
    """Add ``ent`` to the registry under a new id (set as ``ent.key``).
    The registry holds it weakly: whoever calls its launches keeps it (the
    wrapper, as ``.entry``; an autograd graph, in its ctx), and it leaves
    the registry with the last of them."""
    ent.key = f"{re.sub(r'[^A-Za-z0-9_]', '_', ent.name)}-{uuid.uuid4().hex}"
    REGISTRY[ent.key] = ent
    return ent.key


def entry(key: str):
    """The registered launch (a ``StencilEntry``, ``ChainEntry``, ...)
    under ``key``; raises KeyError naming it where none is."""
    try:
        return REGISTRY[key]
    except KeyError:
        raise KeyError(f"no launch registered under {key!r}") from None


def fresh(outs: List[torch.Tensor], ins) -> List[torch.Tensor]:
    """``outs`` with each tensor that shares storage with an input or an
    earlier output replaced by a copy (under ``torch.export``, whose
    tensors have no storage to compare, each that is one)."""
    if exporting():
        seen = {id(t) for t in ins}
        res = []
        for t in outs:
            res.append(t.clone() if id(t) in seen else t)
            seen.add(id(res[-1]))
        return res
    seen = {t.untyped_storage().data_ptr() for t in ins
            if isinstance(t, torch.Tensor) and t.numel()}
    res = []
    for t in outs:
        ptr = t.untyped_storage().data_ptr() if t.numel() else None
        if ptr is not None and ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        if ptr is not None:
            seen.add(ptr)
        res.append(t)
    return res


def with_autograd(fn, *args):
    """``fn(*args)`` run where autograd records, on a new thread.  An op's
    kernel runs below PyTorch's autograd dispatch key, so the ops it
    calls record no graph; the plain versions of the fused adjoints (the
    CPU kernels of ``chain_bwd`` and ``stage_chain_bwd``) are autograd
    through the plain forward.  A new thread starts from the default
    dispatch state, grad mode on; one thread a call, so a nested call
    cannot wait on its caller.  Under ``torch.export``, which follows no
    second thread, the families run at the autograd level (``through``):
    ``fn`` runs on the calling thread with grad mode on."""
    if exporting():
        with torch.enable_grad():
            return fn(*args)
    box = {}

    def target():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised in the calling thread
            box["err"] = e

    t = threading.Thread(target=target, name="psat-plain-vjp")
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


# ---------------------------------------------------------------------------
# The ops.

def _ops(name, card_fn, cpu_fn, fake_fn):
    """Register ``card_fn`` as the op's CUDA kernel, ``cpu_fn`` as its CPU
    kernel and ``fake_fn`` as its fake."""
    op = torch.library.custom_op(f"psat::{name}", mutates_args=(),
                                 device_types="cuda")(card_fn)
    op.register_kernel("cpu")(cpu_fn)
    op.register_fake(fake_fn)
    return op


def _stencil(key: str, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).forward(True, None, inputs)


stencil = _ops(
    "stencil", _stencil,
    lambda key, inputs: entry(key).forward(False, None, inputs),
    lambda key, inputs: entry(key).fake_forward(None, inputs))


def _stencil_bwd(key: str, saved: List[torch.Tensor],
                 cotangents: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).backward(True, None, saved, cotangents)


stencil_bwd = _ops(
    "stencil_bwd", _stencil_bwd,
    lambda key, saved, cots: entry(key).backward(False, None, saved, cots),
    lambda key, saved, cots: entry(key).fake_backward(None, saved, cots))


def _chain(key: str, state: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).forward(True, None, state)


chain = _ops(
    "chain", _chain,
    lambda key, state: entry(key).forward(False, None, state),
    lambda key, state: entry(key).fake_forward(None, state))


def _chain_bwd(key: str, state: List[torch.Tensor],
               cotangents: List[torch.Tensor],
               probe_cotangents: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).backward(True, None, state, cotangents,
                               probe_cotangents)


chain_bwd = _ops(
    "chain_bwd", _chain_bwd,
    lambda key, state, cots, pcots: entry(key).backward(
        False, None, state, cots, pcots),
    lambda key, state, cots, pcots: entry(key).fake_backward(
        None, state, cots, pcots))


def _stage_chain(key: str, bases: Optional[List[int]],
                 state: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).forward(True, bases, state)


stage_chain = _ops(
    "stage_chain", _stage_chain,
    lambda key, bases, state: entry(key).forward(False, bases, state),
    lambda key, bases, state: entry(key).fake_forward(bases, state))


def _stage_chain_bwd(key: str, bases: Optional[List[int]],
                     wanted: List[bool],
                     state: List[torch.Tensor],
                     cotangents: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).backward(True, (bases, wanted), state, cotangents)


stage_chain_bwd = _ops(
    "stage_chain_bwd", _stage_chain_bwd,
    lambda key, bases, wanted, state, cots: entry(key).backward(
        False, (bases, wanted), state, cots),
    lambda key, bases, wanted, state, cots: entry(key).fake_backward(
        (bases, wanted), state, cots))


def _any_device(name, fn, fake_fn):
    """An op of ``parallel/`` whose one kernel serves every device."""
    op = torch.library.custom_op(f"psat::{name}", mutates_args=())(fn)
    op.register_fake(fake_fn)
    return op


def _halo(key: str, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    return entry(key).forward(blocks)


def _halo_bwd(key: str, cotangents: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    return entry(key).backward(cotangents)


halo = _any_device("halo", _halo,
                   lambda key, blocks: entry(key).fake_forward(blocks))
halo_bwd = _any_device("halo_bwd", _halo_bwd,
                       lambda key, cots: entry(key).fake_backward(cots))


def _sharded_chain(key: str, true_global: List[int],
                   blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    # the blocks come back cropped from their halo-extended frames: views,
    # which an op returns as tensors of their own
    return fresh([t if t.untyped_storage().nbytes() == t.nbytes
                  and t.is_contiguous() else t.clone() for t in
                  entry(key).forward(tuple(true_global), blocks)], blocks)


def _sharded_chain_bwd(key: str, true_global: List[int], needs: List[bool],
                       blocks: List[torch.Tensor],
                       cotangents: List[torch.Tensor]) -> List[torch.Tensor]:
    # the sequential-recompute backward differentiates at the autograd
    # level, which an op's kernel runs below
    return fresh(with_autograd(entry(key).backward, tuple(true_global),
                               needs, blocks, cotangents),
                 list(blocks) + list(cotangents))


sharded_chain = _any_device(
    "sharded_chain", _sharded_chain,
    lambda key, tg, blocks: [b.new_empty(b.shape) for b in blocks])
sharded_chain_bwd = _any_device(
    "sharded_chain_bwd", _sharded_chain_bwd,
    lambda key, tg, needs, blocks, cots: [b.new_empty(b.shape)
                                          for b in blocks])


# ---------------------------------------------------------------------------
# The autograd rule, once: ``_save`` after the forward, ``_pull`` for the
# backward.  The ctx holds the entry itself, so a graph can be
# differentiated after its wrapper is gone.

def _save(ctx, ent, extra, tensors):
    ctx.entry, ctx.extra = ent, extra
    saved = ent.to_save(list(tensors))
    ctx.n_saved = len(saved)
    if ent.kind == "stencil" and ent.constant_requires_grad(tensors):
        # every input too: a second-order pass takes the forward's VJP in
        # the constant field (``StencilEntry.constant_grads``)
        saved = list(saved) + list(tensors)
    ctx.save_for_backward(*saved)


def _pull(ctx, saved, cots, needs):
    with torch.no_grad():
        return ctx.entry.grads(saved[:ctx.n_saved], list(cots), list(needs),
                               ctx.extra)


def _setup(ctx, inputs, output):
    _save(ctx, entry(inputs[0]), inputs[1] if len(inputs) == 3 else None,
          inputs[-1])


def _backward(ctx, grads):
    needs = list(ctx.needs_input_grad[-1])
    # read once: a checkpointed region's saved tensors unpack only once
    saved = list(ctx.saved_tensors)
    if not torch.is_grad_enabled():
        g = _pull(ctx, saved, grads, needs)
    elif ctx.entry.kind == "stencil":
        if len(saved) > ctx.n_saved:
            # the eager Functions carry the second-order pass's VJP in a
            # constant field (OpFunction.backward); this rule has none
            raise NotImplementedError(
                f"{ctx.entry.name}: a second differentiation through the "
                f"traced op with a constant field that requires grad is not "
                f"ported (ROADMAP Queue 3 #17); call torch_function eagerly "
                f"or detach the constant field")
        # recorded: the backward op's own autograd is the second order
        g = ctx.entry.grads(saved[:ctx.n_saved], list(grads), needs,
                            ctx.extra)
    else:
        g = _once(ctx, saved, grads, needs)
    return (None,) * (len(ctx.needs_input_grad) - 1) + (list(g),)


for _op in (stencil, chain, stage_chain):
    _op.register_autograd(_backward, setup_context=_setup)


# The stencil's backward op, differentiated (the traced path: what
# torch.compile and torch.export record; the raw ops, whose own autograd
# carries a third order).

def _raw_fwd(ent, tensors):
    return stencil(ent.key, list(tensors))


def _raw_bwd(ent, saved, cots):
    return stencil_bwd(ent.key, list(saved), list(cots))


def _bwd_setup(ctx, inputs, output):
    key, saved, cots = inputs
    ctx.entry, ctx.n_saved = entry(key), len(saved)
    ctx.save_for_backward(*saved, *cots)


def _bwd_backward(ctx, grads):
    ts = list(ctx.saved_tensors)
    saved, cots = ts[:ctx.n_saved], ts[ctx.n_saved:]
    _, needs_saved, needs_cots = ctx.needs_input_grad
    g_saved, g_cots = ctx.entry.second_vjp(
        saved, cots, list(grads), list(needs_saved), list(needs_cots),
        _raw_fwd, _raw_bwd)
    return None, g_saved, g_cots


stencil_bwd.register_autograd(_bwd_backward, setup_context=_bwd_setup)


def _key_setup(ctx, inputs, output):
    ctx.key = inputs[0]
    ctx.outs = [(o.shape, o.dtype, o.device) for o in output]


def _filled(ctx, grads):
    """The outputs' cotangents, zeros where autograd passes none."""
    return [g if g is not None else torch.zeros(s, dtype=d, device=dv)
            for g, (s, d, dv) in zip(grads, ctx.outs)]


# the exchange and its transpose are each other's backward (both linear)
halo.register_autograd(
    lambda ctx, grads: (None, halo_bwd(ctx.key, _filled(ctx, grads))),
    setup_context=_key_setup)
halo_bwd.register_autograd(
    lambda ctx, grads: (None, halo(ctx.key, _filled(ctx, grads))),
    setup_context=_key_setup)


def _chain_setup(ctx, inputs, output):
    ctx.key, ctx.true_global = inputs[0], inputs[1]
    ctx.save_for_backward(*inputs[2])


def _chain_backward(ctx, grads):
    blocks = list(ctx.saved_tensors)
    needs = list(ctx.needs_input_grad[2])
    g = sharded_chain_bwd(ctx.key, ctx.true_global, needs, blocks,
                          [x if x is not None else torch.zeros_like(b)
                           for x, b in zip(grads, blocks)])
    return None, None, [x if need else None for x, need in zip(g, needs)]


sharded_chain.register_autograd(_chain_backward, setup_context=_chain_setup)

OPS = (stencil, stencil_bwd, chain, chain_bwd, stage_chain, stage_chain_bwd,
       halo, halo_bwd, sharded_chain, sharded_chain_bwd)


def _card(tensors) -> bool:
    return tensors[0].device.type == "cuda"


# each op's kernel, called on the calling thread (``through``)
_THROUGH = {
    stencil: lambda e, ins: e.forward(_card(ins), None, ins),
    stencil_bwd: lambda e, saved, cots: e.backward(_card(cots), None, saved,
                                                   cots),
    chain: lambda e, st: e.forward(_card(st), None, st),
    chain_bwd: lambda e, st, cots, pcots: e.backward(_card(st), None, st,
                                                     cots, pcots),
    stage_chain: lambda e, bases, st: e.forward(_card(st), bases, st),
    stage_chain_bwd: lambda e, bases, wanted, st, cots: e.backward(
        _card(st), (bases, wanted), st, cots),
}


def through(op, ent, *args):
    """``op(ent.key, *args)``, one of the launch families' ops — or, where
    ``torch.export`` traces the caller, the entry's own code that the
    op's kernel for the tensors' device runs, on the calling thread: an
    exported program holds the launches (``ops/launch.py``) and the aten
    glue around them, not the families' ops, so that it loads without the
    port."""
    if exporting():
        return list(_THROUGH[op](ent, *args))
    return op(ent.key, *args)


def _forward_op(ent, extra, tensors):
    if ent.kind == "stage_chain":
        return through(stage_chain, ent, extra, tensors)
    return through(stencil if ent.kind == "stencil" else chain, ent,
                   tensors)


def twice_error(kind: str, name: str) -> str:
    """The error a second differentiation of a fused chain raises."""
    return (f"the fused {kind.replace('_', ' ')} {name!r} cannot be "
            f"differentiated twice: its backward is a fused adjoint kernel "
            f"with no derivative of its own, as in the JAX package, whose "
            f"fused chains' Pallas kernels have no JVP (ROADMAP Queue 3 "
            f"#17); differentiate single steps (torch_function) twice")


def once_only(grads, tensors, message: str):
    """``grads`` computed in a backward that cannot be differentiated
    again, where grad mode is on in it: each plus a zero that depends on
    ``tensors`` (the backward's inputs) through an error node, so a second
    differentiation reaches the node and raises ``message`` instead of
    finding no path back to the inputs (None, or a silent zero)."""
    live = [t for t in tensors if isinstance(t, torch.Tensor)
            and t.requires_grad and t.numel()]
    if not torch.is_grad_enabled() or not live:
        return list(grads)
    zero = sum(t.reshape(-1)[0] for t in live) * 0
    zero = torch._C._functions.DelayedError(message, 1)(zero)
    return [x if x is None else x + zero.to(x.dtype) for x in grads]


def _once(ctx, saved, cots, needs):
    """A chain entry's gradients with grad mode on in the backward."""
    return once_only(_pull(ctx, saved, cots, needs), list(cots) + saved,
                     twice_error(ctx.entry.kind, ctx.entry.name))


class OpFunction(torch.autograd.Function):
    """``apply(ent, extra, *tensors)``: the forward op of entry ``ent``
    (``extra``: a stage chain's shard bases, else None) with the entry's
    rule as its backward — in the ``setup_context`` form, the one
    ``torch.func`` transforms accept (the Function PyTorch generates for a
    custom op's autograd has none, and the transforms refuse it: torch
    2.11–2.13).  ``below``: the eager path's forward calls the op below
    the autograd dispatch key, skipping the op's own autograd kernel,
    which would only find grad mode off.

    A stencil entry's backward, with grad mode on, runs the backward op
    through ``StencilBwdFunction`` (differentiable again), and its
    ``jvp`` is the tangent-linear program; a chain's is once
    differentiable (``_once``) and has no ``jvp``."""

    @staticmethod
    def forward(ent, extra, below, *tensors):
        if below:
            with torch._C._AutoDispatchBelowAutograd():
                return tuple(_forward_op(ent, extra, list(tensors)))
        return tuple(_forward_op(ent, extra, list(tensors)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save(ctx, inputs[0], inputs[1], inputs[3:])
        if inputs[0].kind == "stencil":
            ctx.save_for_forward(*inputs[3:])

    @staticmethod
    def backward(ctx, *cots):
        needs = ctx.needs_input_grad[3:]
        ent, grad_mode = ctx.entry, torch.is_grad_enabled()
        # read once: a checkpointed region's saved tensors unpack only once
        saved = list(ctx.saved_tensors)
        kept = saved[ctx.n_saved:]
        if not grad_mode:
            g = _pull(ctx, saved, cots, needs)
        elif ent.kind == "stencil":
            g = ent.grads_graph(saved[:ctx.n_saved], list(cots),
                                list(needs), ctx.extra, ctx if kept else None)
        else:
            g = _once(ctx, saved, cots, needs)
        if getattr(ctx, "outer", False):
            # a second-order pass (StencilBwdFunction.backward set the
            # flag): the primal output's cotangent reaches the constant
            # fields too, as the JAX package's outer differentiation of
            # its custom_vjp's forward rule does
            g = ent.constant_grads(kept, list(cots), list(needs), g,
                                   grad_mode)
        return (None,) * 3 + tuple(g)


class OpFunctionJvp(OpFunction):
    """``OpFunction`` with forward mode: ``jvp`` is a stencil entry's
    tangent-linear program (a chain has none).  Dynamo refuses a Function
    with a ``jvp`` (torch 2.11–2.13), so ``torch.compile`` traces
    ``OpFunction`` itself; eager calls and ``torch.func`` transforms take
    this one."""

    @staticmethod
    def jvp(ctx, _ent, _extra, _below, *tangents):
        if ctx.entry.kind != "stencil":
            raise NotImplementedError(twice_error(ctx.entry.kind,
                                                  ctx.entry.name))
        return tuple(ctx.entry.forward_jvp(list(ctx.saved_tensors),
                                           list(tangents), _fwd_call))


class StencilBwdFunction(torch.autograd.Function):
    """``bwd_apply(ent, saved, cotangents)``: the stencil's backward op
    (``psat::stencil_bwd``) differentiable once more — reverse mode by
    ``StencilEntry.second_vjp`` (forward mode: ``StencilBwdFunctionJvp``),
    launching the tangent-linear program's kernels through ``apply`` and
    ``bwd_apply`` again, so a third order follows.  ``below`` as in
    ``OpFunction``."""

    @staticmethod
    def forward(ent, n_saved, below, link, *tensors):
        saved, cots = list(tensors[:n_saved]), list(tensors[n_saved:])
        if below:
            with torch._C._AutoDispatchBelowAutograd():
                return tuple(stencil_bwd(ent.key, saved, cots))
        return tuple(through(stencil_bwd, ent, saved, cots))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.entry, ctx.n_saved, ctx.link = inputs[0], inputs[1], inputs[3]
        ctx.save_for_backward(*inputs[4:])
        ctx.save_for_forward(*inputs[4:])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *w):
        link = ctx.link
        if link is not None:
            # the forward op's node (``link``) whose constant field
            # requires grad: in this pass its output's cotangent is a
            # second-order one, which reaches the constant field too;
            # cleared when the pass ends
            link.outer = True
            torch.autograd.Variable._execution_engine.queue_callback(
                lambda: setattr(link, "outer", False))
        ts = list(ctx.saved_tensors)
        n = ctx.n_saved
        needs = ctx.needs_input_grad[4:]
        g_saved, g_cots = ctx.entry.second_vjp(
            ts[:n], ts[n:], list(w), list(needs[:n]), list(needs[n:]),
            _fwd_call, bwd_apply)
        return (None,) * 4 + tuple(g_saved) + tuple(g_cots)


class StencilBwdFunctionJvp(StencilBwdFunction):
    """``StencilBwdFunction`` with forward mode (``backward_jvp``), as
    ``OpFunctionJvp`` is ``OpFunction``'s."""

    @staticmethod
    def jvp(ctx, _ent, _n, _below, _link, *tangents):
        ts = list(ctx.saved_tensors)
        n = ctx.n_saved
        return tuple(ctx.entry.backward_jvp(
            ts[:n], ts[n:], list(tangents[:n]), list(tangents[n:]),
            _fwd_call, bwd_apply))


# ``Function.apply`` binds a ``setup_context`` Function's arguments with
# ``inspect.signature`` on every call (about 30 µs of host time); the
# forward above has no defaults to bind, so the eager path calls the C++
# apply underneath directly.
_eager_apply = super(torch.autograd.Function, OpFunctionJvp).apply


_eager_bwd_apply = super(torch.autograd.Function,
                         StencilBwdFunctionJvp).apply


def traced() -> bool:
    """Whether a ``torch.func`` transform or ``torch.compile`` is tracing
    the caller (``parallel/`` then calls its ops, where eager code — and
    ``torch.export``, which traces through to the launches — calls their
    Functions)."""
    return (torch._C._are_functorch_transforms_active()
            or torch.compiler.is_compiling() and not exporting())


def apply(ent, extra, *tensors):
    """The forward op of entry ``ent`` on ``tensors``, differentiable: the
    user-facing wrappers' one call (the entry itself, not its id: traced
    code reads no weak registry).  Under ``torch.compile`` or
    ``torch.export`` through ``OpFunction.apply``, under a ``torch.func``
    transform through ``OpFunctionJvp.apply``; in eager mode through the
    C++ apply of ``OpFunctionJvp``, the op below autograd."""
    if torch.compiler.is_compiling():
        return OpFunction.apply(ent, extra, False, *tensors)
    if torch._C._are_functorch_transforms_active():
        return OpFunctionJvp.apply(ent, extra, False, *tensors)
    return _eager_apply(ent, extra, True, *tensors)


def _fwd_call(ent, tensors):
    return apply(ent, None, *tensors)


def bwd_apply(ent, saved, cotangents, link=None):
    """The stencil entry ``ent``'s backward op on ``saved`` and
    ``cotangents``, differentiable (``StencilBwdFunction``), dispatched as
    ``apply`` dispatches; ``link``: the forward op's autograd context where
    a constant field of it requires grad."""
    if torch.compiler.is_compiling():
        return StencilBwdFunction.apply(ent, len(saved), False, link,
                                        *saved, *cotangents)
    if torch._C._are_functorch_transforms_active():
        return StencilBwdFunctionJvp.apply(ent, len(saved), False, link,
                                           *saved, *cotangents)
    return _eager_bwd_apply(ent, len(saved), True, link, *saved,
                            *cotangents)
