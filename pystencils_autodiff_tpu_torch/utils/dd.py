"""Double-word ("double-double") arithmetic on torch tensors: the port of
``pystencils_autodiff_tpu/utils/dd.py``.

A value is an unevaluated pair ``hi + lo`` of one floating type, built by
error-free transforms (Knuth's TwoSum, Dekker's TwoProd with Veltkamp's
split): about 48 bits in float32 pairs, 106 in float64 pairs.  The JAX
package needed it because its TPU has no float64; the port's float32 and
bfloat16 programs in ``accumulate="dd"`` mode sum in the card's native
float64 instead (``ops/common.py::_compile_dd_add``), and its float64
programs in that mode use these pairs, as the JAX package does.

Every function is elementwise tensor arithmetic (pairs are plain tensors
or Python floats), so autograd differentiates through it.  ``dd_sum`` and
``dd_dot`` fold sequentially along the axis, so every partial sum is
compensated (``torch.sum`` would re-associate).

An error-free transform has one exact answer, so ``two_sum`` and
``two_prod`` equal the JAX package's bit for bit wherever neither
overflows.  The composite functions round their low words the same way the
JAX package's do; they agree with it within 2 ulp of the working type in
``hi + lo`` (bit for bit where XLA does not contract a product and a sum
into an fma).

Contraction.  Veltkamp's split ``ca = split·a; ahi = ca − (ca − a)`` is
exact only if both uses of ``ca`` are the same rounded product, and
``two_sum(c, p)`` assumes ``p`` is a rounded product.  Eager PyTorch runs
every operator as a kernel of its own and never fuses a multiply and an
add into an fma; ``torch.compile`` may (Inductor emits fused code), which
is what ``_round_barrier`` guards against: a same-width ``view`` round
trip, value-exact, that a compiler cannot see through as arithmetic.

References: Dekker 1971; Knuth TAOCP v2; Hida, Li and Bailey's QD
library — public algorithms.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["two_sum", "two_prod", "dd", "dd_add", "dd_add_dd", "dd_mul",
           "dd_sum", "dd_to", "dd_dot"]

Value = Union[torch.Tensor, float]
Pair = Tuple[Value, Value]

_BARRIER_BITS = {torch.float32: torch.int32, torch.float64: torch.int64,
                 torch.bfloat16: torch.int16, torch.float16: torch.int16}


def two_sum(a: Value, b: Value) -> Pair:
    """Error-free sum: a + b = s + e exactly (Knuth; no branch)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def two_prod(a: Value, b: Value) -> Pair:
    """Error-free product: a·b = p + e exactly (Dekker/Veltkamp: exact in
    any IEEE round-to-nearest arithmetic, no fma needed).  ``p`` is pinned
    rounded (``_round_barrier``): a later ``two_sum(c, p)`` assumes it."""
    p = _round_barrier(a * b)
    return p, _dekker_prod_err(a, b, p)


def _round_barrier(x: Value) -> Value:
    """``x`` through a same-width ``view`` round trip: the same value, as
    a rounded result a fusing compiler cannot re-derive from the product
    that made it (see the module's note).  Python numbers and types
    without an integer of their width pass unchanged."""
    if not isinstance(x, torch.Tensor):
        return x
    bits = _BARRIER_BITS.get(x.dtype)
    if bits is None:
        return x
    return x.view(bits).view(x.dtype)


def _split(x: Value) -> float:
    """Veltkamp's splitting constant for ``x``'s type, as the JAX package
    picks it: 2^12 + 1 in float32, 2^27 + 1 otherwise (float64 and Python
    floats)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return 4097.0
    return 134217729.0


def _dekker_prod_err(a: Value, b: Value, p: Value) -> Value:
    """a·b − p for the rounded product ``p``, via Veltkamp's split: the
    halves multiply exactly, so the error is exact."""
    split = _split(a if isinstance(a, torch.Tensor) else b)
    ca = _round_barrier(split * a)
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _round_barrier(split * b)
    bhi = cb - (cb - b)
    blo = b - bhi
    return ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo


def dd(x) -> Pair:
    """A tensor as a dd pair (exact)."""
    x = torch.as_tensor(x)
    return x, torch.zeros_like(x)


def dd_to(p: Pair) -> Value:
    """Round a dd pair to working precision."""
    return p[0] + p[1]


def dd_add(p: Pair, x: Value) -> Pair:
    """dd += value (compensated: the rounding error joins the low word)."""
    s, e = two_sum(p[0], x)
    return s, p[1] + e


def dd_add_dd(p: Pair, q: Pair) -> Pair:
    s, e = two_sum(p[0], q[0])
    e = e + (p[1] + q[1])
    return two_sum(s, e)


def dd_mul(p: Pair, q: Pair) -> Pair:
    h = _round_barrier(p[0] * q[0])
    e = _dekker_prod_err(p[0], q[0], h)
    e = e + (p[0] * q[1] + p[1] * q[0])
    return two_sum(h, e)


def dd_sum(x, axis=None) -> Pair:
    """Reduce with a dd accumulator (about 2^-48 relative in float32): a
    sequential fold along ``axis`` (all elements where None)."""
    x = torch.as_tensor(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    x = torch.movedim(x, axis, 0)
    acc = (torch.zeros_like(x[0]), torch.zeros_like(x[0]))
    for xi in x:
        acc = dd_add(acc, xi)
    return acc


def dd_dot(a, b) -> Pair:
    """Compensated dot product: Σ a_i b_i with error-free products."""
    a = torch.as_tensor(a).reshape(-1)
    b = torch.as_tensor(b).reshape(-1)
    acc = (torch.zeros((), dtype=a.dtype), torch.zeros((), dtype=a.dtype))
    for ai, bi in zip(a, b):
        h = _round_barrier(ai * bi)
        e = _dekker_prod_err(ai, bi, h)
        c = dd_add(acc, h)
        acc = (c[0], c[1] + e)
    return acc
