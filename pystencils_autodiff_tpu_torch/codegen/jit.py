"""g++ build of the generated C/C++ sources: the CPU kernels
(``c_printer.py``) and the framework extensions (``backends/astnodes.py``).

The port of ``pystencils_autodiff_tpu/codegen/jit.py``.  Libraries go
through the nvcc route's cache (``nvcc.cached_build``): under
``build/torch_kernels/`` at the repository root, keyed by a sha256 of the
source, the flags and ``g++ --version``, one lock per key, moved into place
with an atomic ``os.replace``; the first use of a source builds it.  A
failed build raises ``RuntimeError`` with the compiler's output.

The flags leave out ``-ffast-math`` (it would reorder the sums the printer
orders as the plain version does) and ``-march=native`` (a cached library
may be loaded on another host's CPU).
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

from .nvcc import cached_build, numbered

__all__ = ["DEFAULT_FLAGS", "compile_shared_library", "compile_and_load",
           "link", "find_compiler"]

DEFAULT_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17",
                 "-x", "c++")


def find_compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the generated C kernels and the "
                           "framework extensions are built with it")
    return found


@lru_cache(maxsize=None)
def _compiler_version(compiler: str) -> str:
    return subprocess.run([compiler, "--version"], capture_output=True,
                          text=True, check=True).stdout


def _run(cmd, what: str, source: Optional[str] = None) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        listing = (f"\n--- source ---\n{numbered(source)}" if source is not None
                   else "")
        raise RuntimeError(f"{what} failed:\n{' '.join(cmd)}\n{proc.stderr}"
                           f"{listing}")


def compile_shared_library(source: str, name_hint: str = "kernel",
                           extra_flags: Sequence[str] = (),
                           post_flags: Sequence[str] = ()) -> Path:
    """Compile C/C++ ``source`` with g++ into a cached shared library; its
    path.  ``extra_flags`` follow ``DEFAULT_FLAGS``; ``post_flags`` follow
    the source on the command line, where GNU ld wants ``-l`` flags (it
    resolves left to right: a library named before any object that uses
    it is dropped, and the failure shows only when the library is
    loaded)."""
    cc = find_compiler()
    flags = [*DEFAULT_FLAGS, *extra_flags]

    def build(td, out, final):
        src = td / f"{name_hint}.cpp"
        src.write_text(source)
        _run([cc, *flags, str(src), *post_flags, "-o", str(out)],
             f"g++ build of {name_hint}", source)

    _, path = cached_build(name_hint, (source, " ".join(flags),
                                       " ".join(post_flags),
                                       _compiler_version(cc)), build)
    return path


def link(object_files: Sequence[str], name_hint: str = "linked",
         extra_flags: Sequence[str] = ()) -> Path:
    """Link object files with g++ into a cached shared library (keyed by
    the objects' contents and the flags)."""
    cc = find_compiler()
    objs = [Path(o) for o in object_files]
    contents = [hashlib.sha256(o.read_bytes()).hexdigest() for o in objs]

    def build(td, out, final):
        _run([cc, "-shared", "-fPIC", *extra_flags, *map(str, objs), "-o",
              str(out)], f"linking {name_hint}")

    _, path = cached_build(name_hint, (*contents, " ".join(extra_flags),
                                       _compiler_version(cc)), build)
    return path


def compile_and_load(source: str, name_hint: str = "kernel",
                     extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``source`` (or fetch it from the cache) and load it."""
    return ctypes.CDLL(str(compile_shared_library(source, name_hint,
                                                  extra_flags)))
