"""Build step for the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The port of ``pystencils_autodiff_tpu/codegen/jit.py`` (g++ + ctypes) to the
GPU.  It deliberately does not use ``torch.utils.cpp_extension.load``: a
source that includes PyTorch's headers takes minutes to compile, a plain C
interface seconds.  Libraries are cached under ``build/torch_kernels/`` at
the repository root, keyed by a sha256 of the sources, the flags and
``nvcc --version``; the first use of a program builds it.  The compiler's
report (``-Xptxas=-v``: registers, spills per kernel) is kept beside each
library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

__all__ = ["ARCH_FLAGS", "CSRC_DIR", "build_dir", "find_nvcc",
           "compile_and_load"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict = {}
_building: dict = {}


def build_dir() -> Path:
    """``build/torch_kernels/`` beside the package (listed in .gitignore)."""
    d = CSRC_DIR.parent.parent / "build" / "torch_kernels"
    d.mkdir(parents=True, exist_ok=True)
    return d


def find_nvcc() -> str:
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


def compile_and_load(source: str, name_hint: str = "kernel") -> ctypes.CDLL:
    """Compile a generated translation unit (or fetch it from the cache) and
    load it.  Raises ``RuntimeError`` with the compiler's output on failure."""
    nvcc = find_nvcc()
    flags = [*ARCH_FLAGS, *BASE_FLAGS, "-I", str(CSRC_DIR)]
    h = hashlib.sha256()
    for part in (source, _template_sources(), " ".join(flags),
                 _nvcc_version(nvcc)):
        h.update(part.encode())
    key = h.hexdigest()[:20]
    # one lock per library: different sources build concurrently (one nvcc
    # process each), the same source once
    with _lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        key_lock = _building.setdefault(key, threading.Lock())
    with key_lock:
        with _lock:
            lib = _loaded.get(key)
        if lib is not None:
            return lib
        so_path = build_dir() / f"{name_hint}_{key}.so"
        if not so_path.exists():
            with tempfile.TemporaryDirectory(dir=build_dir()) as td:
                src = Path(td) / f"{name_hint}.cu"
                src.write_text(source)
                tmp_so = Path(td) / "out.so"
                proc = subprocess.run([nvcc, *flags, "-o", str(tmp_so),
                                       str(src)], capture_output=True,
                                      text=True)
                if proc.returncode != 0:
                    numbered = "\n".join(f"{i + 1:4d} {line}" for i, line
                                         in enumerate(source.splitlines()))
                    raise RuntimeError(f"nvcc failed for {name_hint}:\n"
                                       f"{proc.stderr}\n--- source ---\n"
                                       f"{numbered}")
                so_path.with_suffix(".log").write_text(proc.stderr)
                os.replace(tmp_so, so_path)
        lib = ctypes.CDLL(str(so_path))
        with _lock:
            _loaded[key] = lib
        return lib
