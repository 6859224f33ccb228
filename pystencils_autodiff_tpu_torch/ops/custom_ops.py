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
op.  The backward ops register no autograd: the ops are once
differentiable.  PyTorch's dispatcher picks the kernel by device.

Naming: one generic op per family, keyed by a registry id (``key``, a
string argument of every call), not one op per (program, mode, periodic,
strategy).  The op set is then fixed when this module is imported, so a
fresh process that imports the port has every op an exported artifact
names; loading one (``serving.load_exported``) only fills the registry
again from the artifact's sidecar, under the ids the graph holds.  An op a
program would add a dispatcher entry per built function, each to be
created again, by name, before ``torch.export.load``.  The id is the
entry's name and a random suffix (``uuid4``), so ids minted in different
processes do not collide and artifacts from several processes load side
by side.  ``REGISTRY`` is process-wide state on purpose: the dispatcher
it serves is.  It holds its entries weakly: an entry lives as long as a
wrapper, an autograd graph or an artifact that calls it, so building
functions over and over (a recompute built per backward, a loop that
calls ``torch_function`` every step) does not grow it.

An entry (``vjp.StencilEntry``, ``time_chain.ChainEntry``,
``stage_chain.StageEntry``) pickles as its recipe — the lowered programs
and plans, and the flags of its builder — and builds its kernels and
plain versions again, at its first call, when it is unpickled.  It
provides ``forward(card, extra, tensors)``, ``fake_forward``,
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
wrappers call the forward ops (``apply``).  The Function is needed
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
from torch.autograd.function import once_differentiable

__all__ = ["REGISTRY", "register", "entry", "fresh", "with_autograd",
           "OpFunction", "apply",
           "OPS", "stencil", "stencil_bwd", "chain", "chain_bwd",
           "stage_chain", "stage_chain_bwd"]

REGISTRY: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def register(ent) -> str:
    """Add ``ent`` to the registry under a new id (set as ``ent.key``).
    The registry holds it weakly: whoever calls its launches keeps it (the
    wrapper, as ``.entry``; an autograd graph, in its ctx; an exported or
    loaded artifact), and it leaves the registry with the last of them."""
    ent.key = f"{re.sub(r'[^A-Za-z0-9_]', '_', ent.name)}-{uuid.uuid4().hex}"
    REGISTRY[ent.key] = ent
    return ent.key


def entry(key: str):
    try:
        return REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"no launch registered under {key!r}: an exported artifact's "
            f"entries come back with serving.load_exported") from None


def fresh(outs: List[torch.Tensor], ins) -> List[torch.Tensor]:
    """``outs`` with each tensor that shares storage with an input or an
    earlier output replaced by a copy."""
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
    cannot wait on its caller."""
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


# ---------------------------------------------------------------------------
# The autograd rule, once: ``_save`` after the forward, ``_pull`` for the
# backward.  The ctx holds the entry itself, so a graph can be
# differentiated after its wrapper is gone.

def _save(ctx, ent, extra, tensors):
    ctx.entry, ctx.extra = ent, extra
    ctx.save_for_backward(*ent.to_save(list(tensors)))


def _pull(ctx, cots, needs):
    with torch.no_grad():
        return ctx.entry.grads(list(ctx.saved_tensors), list(cots),
                               list(needs), ctx.extra)


def _setup(ctx, inputs, output):
    _save(ctx, entry(inputs[0]), inputs[1] if len(inputs) == 3 else None,
          inputs[-1])


def _backward(ctx, grads):
    g = _pull(ctx, grads, ctx.needs_input_grad[-1])
    return (None,) * (len(ctx.needs_input_grad) - 1) + (list(g),)


for _op in (stencil, chain, stage_chain):
    _op.register_autograd(_backward, setup_context=_setup)

OPS = (stencil, stencil_bwd, chain, chain_bwd, stage_chain, stage_chain_bwd)


def _forward_op(ent, extra, tensors):
    if ent.kind == "stage_chain":
        return stage_chain(ent.key, extra, tensors)
    return (stencil if ent.kind == "stencil" else chain)(ent.key, tensors)


class OpFunction(torch.autograd.Function):
    """``apply(ent, extra, *tensors)``: the forward op of entry ``ent``
    (``extra``: a stage chain's shard bases, else None) with the entry's
    rule as its backward, once differentiable — in the ``setup_context``
    form, the one ``torch.func`` transforms accept (the Function PyTorch
    generates for a custom op's autograd has none, and the transforms
    refuse it: torch 2.11–2.13).  ``below``: the eager path's forward
    calls the op below the autograd dispatch key, skipping the op's own
    autograd kernel, which would only find grad mode off."""

    @staticmethod
    def forward(ent, extra, below, *tensors):
        if below:
            with torch._C._AutoDispatchBelowAutograd():
                return tuple(_forward_op(ent, extra, list(tensors)))
        return tuple(_forward_op(ent, extra, list(tensors)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _save(ctx, inputs[0], inputs[1], inputs[3:])

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        return (None,) * 3 + tuple(_pull(ctx, cots,
                                         ctx.needs_input_grad[3:]))


# ``Function.apply`` binds a ``setup_context`` Function's arguments with
# ``inspect.signature`` on every call (about 30 µs of host time); the
# forward above has no defaults to bind, so the eager path calls the C++
# apply underneath directly.
_eager_apply = super(torch.autograd.Function, OpFunction).apply


def apply(ent, extra, *tensors):
    """The forward op of entry ``ent`` on ``tensors``, differentiable: the
    user-facing wrappers' one call (the entry itself, not its id: traced
    code reads no weak registry).  Under a ``torch.func`` transform,
    ``torch.compile`` or ``torch.export``, through ``OpFunction.apply``;
    in eager mode through the C++ apply, the op below autograd."""
    if (torch._C._are_functorch_transforms_active()
            or torch.compiler.is_compiling()):
        return OpFunction.apply(ent, extra, False, *tensors)
    return _eager_apply(ent, extra, True, *tensors)
