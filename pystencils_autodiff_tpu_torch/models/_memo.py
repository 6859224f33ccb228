"""Memoization for model factories: a copy of
``pystencils_autodiff_tpu/models/_memo.py``.

Constructing an ``AutoDiffOp`` costs real symbolic work (sympy expression
building; the derived backward and the programs are cached lazily on the
instance), and callers routinely rebuild identical model ops — every
test, every case of a sweep, every reconstruction inside a training loop.
Ops are not mutated after construction, so factory results with hashable
arguments are shared: equal arguments give the same op.

Unhashable arguments (e.g. an explicit anisotropy matrix) fall back to a
fresh construction.
"""

from __future__ import annotations

import functools

__all__ = ["memoize_model"]


def memoize_model(fn):
    """Wrap a model factory so equal hashable arguments return the same op
    (``wrapper.cache_clear`` empties the cache)."""
    cache = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            key = (args, tuple(sorted(kwargs.items())))
            hash(key)
        except TypeError:
            return fn(*args, **kwargs)
        if key not in cache:
            cache[key] = fn(*args, **kwargs)
        return cache[key]

    wrapper.cache_clear = cache.clear
    return wrapper
