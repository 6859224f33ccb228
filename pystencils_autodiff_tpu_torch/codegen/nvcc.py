"""Build step for the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The port of ``pystencils_autodiff_tpu/codegen/jit.py`` (g++ + ctypes) to the
GPU.  It deliberately does not use ``torch.utils.cpp_extension.load``: a
source that includes PyTorch's headers takes minutes to compile, a plain C
interface seconds.  Libraries are cached under ``build/torch_kernels/`` at
the repository root, keyed by a sha256 of the sources, the flags and
``nvcc --version``; the first use of a program builds it.  The compiler's
report (``-Xptxas=-v``: registers, spills per kernel) is kept beside each
library as ``<name>.log``, its source as ``<name>.cu`` (an exported
artifact carries both library and source: ``serving.py``).  ``cached_build`` is that cache; the g++ builds
of ``codegen/jit.py`` (the generated C kernels and the framework
extensions) share it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from functools import lru_cache
from pathlib import Path

__all__ = ["ARCH_FLAGS", "CSRC_DIR", "FLAGS_MARK", "build_dir", "find_nvcc",
           "cached_build", "source_flags", "compile_and_load"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
# a line of a source that starts with this names flags the source needs
FLAGS_MARK = "// nvcc-flags:"

_lock = threading.Lock()
_loaded: dict = {}
_building: dict = {}
_paths: dict = {}
# (name, seconds) of each library this process built (a cache miss)
BUILDS: list = []


def build_dir() -> Path:
    """``build/torch_kernels/`` beside the package (listed in .gitignore)."""
    d = CSRC_DIR.parent.parent / "build" / "torch_kernels"
    d.mkdir(parents=True, exist_ok=True)
    return d


def find_nvcc() -> str:
    """The path of ``nvcc``: under ``$CUDA_HOME``, ``/usr/local/cuda``, else
    on ``PATH``; raises RuntimeError where there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are compiled on first use, where the GPU is")
    return found


@lru_cache(maxsize=None)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True).stdout


def _template_sources() -> str:
    return "".join(p.read_text() for p in sorted(CSRC_DIR.glob("*.cu*")))


def cached_build(name_hint: str, key_parts, build) -> tuple:
    """``(key, path)`` of the shared library keyed by a sha256 of
    ``key_parts`` under ``build_dir()``.  The first time, ``build(td, out,
    final)`` writes it as ``out`` in the temporary directory ``td`` (raising
    on failure; ``final`` is where it will live) and it is moved into place
    with an atomic ``os.replace``, so concurrent builders of one key, in one
    process or several, never load half a file.  One lock per key within a
    process: different libraries build concurrently, one library once,
    whatever name its callers hint.  Each build is recorded in
    ``BUILDS``."""
    h = hashlib.sha256()
    for part in key_parts:
        h.update(part.encode())
    key = h.hexdigest()[:20]
    with _lock:
        key_lock = _building.setdefault(key, threading.Lock())
    with key_lock:
        # within a process the key alone names a library: a caller that
        # hints another name gets the one already built or loaded
        so_path = _paths.get(key)
        if so_path is None:
            so_path = build_dir() / f"{name_hint}_{key}.so"
            if not so_path.exists():
                t = time.perf_counter()
                with tempfile.TemporaryDirectory(dir=build_dir()) as td:
                    tmp = Path(td) / "out.so"
                    build(Path(td), tmp, so_path)
                    os.replace(tmp, so_path)
                BUILDS.append((name_hint, time.perf_counter() - t))
            _paths[key] = so_path
    return key, so_path


def numbered(source: str) -> str:
    """``source`` with line numbers, for a compiler's error report."""
    return "\n".join(f"{i + 1:4d} {line}"
                     for i, line in enumerate(source.splitlines()))


def source_flags(source: str) -> list:
    """The flags ``source`` asks for on lines of its own that start with
    ``FLAGS_MARK`` (the dd body's ``--fmad=false``)."""
    return [f for line in source.splitlines() if line.startswith(FLAGS_MARK)
            for f in line[len(FLAGS_MARK):].split()]


def compile_and_load(source: str, name_hint: str = "kernel") -> ctypes.CDLL:
    """Compile a generated translation unit (or fetch it from the cache) and
    load it, with the flags it asks for (``source_flags``).  Raises
    ``RuntimeError`` with the compiler's output on failure."""
    nvcc = find_nvcc()
    flags = [*ARCH_FLAGS, *BASE_FLAGS, "-I", str(CSRC_DIR),
             *source_flags(source)]

    def build(td, out, final):
        src = td / f"{name_hint}.cu"
        src.write_text(source)
        proc = subprocess.run([nvcc, *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name_hint}:\n"
                               f"{proc.stderr}\n--- source ---\n"
                               f"{numbered(source)}")
        final.with_suffix(".log").write_text(proc.stderr)
        final.with_suffix(".cu").write_text(source)

    key, so_path = cached_build(
        name_hint, (source, _template_sources(), " ".join(flags),
                    _nvcc_version(nvcc)), build)
    with _lock:
        lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(so_path))
        with _lock:
            lib = _loaded.setdefault(key, lib)
    return lib
