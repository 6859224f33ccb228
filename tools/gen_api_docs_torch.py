#!/usr/bin/env python
"""Generate the markdown API reference of the PyTorch port from its
docstrings.

Walks ``pystencils_autodiff_tpu_torch`` with ``inspect`` and writes one
markdown page per module under ``docs/torch_port/api/`` plus an index.  It
imports torch and the port only: never jax, and nothing of the JAX package.
Run from the repo root::

    python tools/gen_api_docs_torch.py            # into docs/torch_port/api
    python tools/gen_api_docs_torch.py --out DIR  # elsewhere

The output is deterministic: a default or a module constant whose repr
carries an object's address renders by its qualified name, and sets render
sorted, so two runs write the same bytes.  The script prints how many
public entries have no docstring.  The output is checked in.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import pkgutil
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "pystencils_autodiff_tpu_torch"
OUT = ROOT / "docs" / "torch_port" / "api"
_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


class _Named:
    """Stands in for a value whose repr would carry an address."""

    def __init__(self, text: str):
        self.text = text

    def __repr__(self) -> str:
        return self.text


def _qualname(obj) -> str:
    mod = getattr(obj, "__module__", None)
    name = getattr(obj, "__qualname__", None) or getattr(obj, "__name__", None)
    if name is None:
        return _ADDRESS.sub("", repr(obj))
    return f"{mod}.{name}" if mod else name


def _repr(obj) -> str:
    """``repr`` with sets sorted and addresses replaced by qualified names."""
    if isinstance(obj, (set, frozenset)):
        items = sorted(_repr(x) for x in obj)
        if not items:
            return f"{type(obj).__name__}()"
        body = "{" + ", ".join(items) + "}"
        return body if isinstance(obj, set) else f"frozenset({body})"
    if isinstance(obj, dict):
        return "{" + ", ".join(f"{_repr(k)}: {_repr(v)}"
                               for k, v in obj.items()) + "}"
    if isinstance(obj, (list, tuple)):
        body = ", ".join(_repr(x) for x in obj)
        if isinstance(obj, list):
            return f"[{body}]"
        return f"({body},)" if len(obj) == 1 else f"({body})"
    text = repr(obj)
    return _qualname(obj) if _ADDRESS.search(text) else text


def _sig(obj) -> str:
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return "(...)"
    params = []
    for p in sig.parameters.values():
        if p.default is not inspect.Parameter.empty:
            p = p.replace(default=_Named(_repr(p.default)))
        params.append(p)
    return str(sig.replace(parameters=params))


def _doc(obj) -> str:
    try:
        return inspect.getdoc(obj) or ""
    except Exception:  # noqa: BLE001
        return ""


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        mod_of = getattr(obj, "__module__", None)
        if mod_of is not None and not str(mod_of).startswith(PACKAGE):
            continue  # re-exported third-party symbol
        out.append((n, obj))
    return out


def _methods(cls):
    """Public methods defined by ``cls`` or a base class of the port
    (those a class inherits from torch, e.g. ``autograd.Function.apply``,
    belong to torch's reference)."""
    own = [b for b in cls.__mro__[:-1]
           if str(getattr(b, "__module__", "")).startswith(PACKAGE)]
    for mname, meth in inspect.getmembers(cls):
        if mname.startswith("_") or not callable(meth):
            continue
        if not any(mname in vars(b) for b in own):
            continue
        yield mname, meth


def render_module(modname: str, missing: list) -> str:
    """The markdown page of one module; appends the names of public
    entries without a docstring to ``missing``."""
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]

    def entry(title, obj, name):
        nonlocal lines
        lines += [title, ""]
        if _doc(obj):
            lines += [_doc(obj), ""]
        else:
            missing.append(f"{modname}::{name}")

    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            entry(f"## class `{name}{_sig(obj)}`", obj, name)
            for mname, meth in _methods(obj):
                entry(f"### `{name}.{mname}{_sig(meth)}`", meth,
                      f"{name}.{mname}")
        elif callable(obj):
            entry(f"## `{name}{_sig(obj)}`", obj, name)
        else:
            lines += [f"## `{name}`", "",
                      f"```python\n{name} = {_repr(obj)}\n```", ""]
    return "\n".join(lines) + "\n"


def module_names() -> list:
    pkg = importlib.import_module(PACKAGE)
    return sorted([PACKAGE] + [info.name for info in pkgutil.walk_packages(
        pkg.__path__, prefix=PACKAGE + ".")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory to write the pages to")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    args.out.mkdir(parents=True, exist_ok=True)
    modules = module_names()
    missing = []
    index = ["# API reference of the PyTorch port", "",
             "Generated from docstrings by `tools/gen_api_docs_torch.py` "
             "(regenerate after API changes).", ""]
    for m in modules:
        page = m.replace(".", "_") + ".md"
        (args.out / page).write_text(render_module(m, missing))
        index.append(f"- [`{m}`]({page})")
    (args.out / "index.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(modules)} pages to {args.out}")
    print(f"{len(missing)} public entries without a docstring")
    for name in missing:
        print(f"  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
