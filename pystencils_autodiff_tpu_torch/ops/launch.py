"""One route for every kernel launch: ``run(lib, scalars, args, ref, what)``.

Every wrapper of a hand-written kernel reaches its library through
``run``.  ``lib`` is the library ``codegen.nvcc.compile_and_load`` built;
its uniform C entry ``psat_call(device, scalars, args, stream)`` (beside
each ``csrc/*.cu`` launcher) takes the launcher's leading integers as an
int64 block and the rest as a block of pointers, each pointing to one
argument array: device pointers (``Ptrs``: (tensor, element offset) pairs)
or int64 values (strides, the geometry).

* Eagerly, ``run`` builds those arrays with ``ctypes`` and calls the entry
  on the current stream of ``ref``'s card, raising where the launch is
  refused.
* Under ``torch.export`` (``exporting()``) the launch becomes one node of
  the leaf op ``psat_launch::launch`` (``csrc/launch_op.cpp``), which
  names the library by the sha256 of its bytes, its entry, the integers
  (``SymInt``s where a shape is symbolic) and the tensors; the outputs the
  wrapper allocated with ``empty`` (``Out`` placeholders there) become the
  op's results.  An exported program then holds aten glue and leaf
  launches, and a process that loads it needs PyTorch, the leaf op's
  library and the kernels' libraries (``serving.py``).

Under export a pointer's alignment is unknown: ``align`` rules (an
integer zeroed, or the launch refused, where a pointer is not a multiple
of some bytes) carry a wrapper's alignment test to the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

__all__ = ["ENTRY", "LAUNCHES", "reset_launch_counts", "Out", "Ptrs",
           "empty", "real", "run", "exporting",
           "library_info", "traced_libraries", "launch_op_library",
           "launch_op_arch", "load_launch_op", "bind", "bind_traced",
           "DTYPE_CODES"]

ENTRY = "psat_call"
# the dtype codes of every launcher (codegen/cuda_printer.py::STORAGE) and
# of the leaf op's outputs
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
ARCH = "sm_90a"
# eager launches by the launch's description (``run``'s ``what``), which a
# traced launch writes beside its library (``serving.py``'s sidecar)
LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def exporting() -> bool:
    """Whether ``torch.export`` traces the caller."""
    return torch.compiler.is_exporting()


class Out:
    """An output a launch allocates, while ``torch.export`` traces: shape,
    dtype, device and contiguous strides; ``tensor`` is the leaf op's
    result once ``run`` has traced the launch."""

    __slots__ = ("shape", "dtype", "device", "tensor")

    def __init__(self, shape, dtype, device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.tensor = None

    def stride(self, dim: int):
        s = 1
        for n in self.shape[dim % len(self.shape) + 1:]:
            s = s * n
        return s

    def element_size(self) -> int:
        return self.dtype.itemsize


def empty(shape, dtype, device):
    """``torch.empty``, or an ``Out`` under ``torch.export``: an output
    the kernel writes."""
    if exporting():
        return Out(shape, dtype, device)
    return torch.empty(shape, dtype=dtype, device=device)


def real(x):
    """``x`` (a tensor, an ``Out``, or a dict, list or tuple of them) with
    every ``Out`` replaced by its tensor (``torch.empty`` where no launch
    wrote it)."""
    if isinstance(x, Out):
        if x.tensor is None:
            x.tensor = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        return x.tensor
    if isinstance(x, dict):
        return {k: real(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(real(v) for v in x)
    return x


class Ptrs(list):
    """A block of device pointers: (tensor or ``Out`` or None, element
    offset) pairs."""


def _entry(lib):
    fn = getattr(lib, "_psat_call", None)
    if fn is None:
        fn = lib.psat_call
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.psat_error_string.argtypes = [ctypes.c_int]
        lib.psat_error_string.restype = ctypes.c_char_p
        lib._psat_call = fn
    return fn


def run(lib, scalars: Sequence, args: Sequence, ref: torch.Tensor,
        what: str, align: Sequence = ()) -> bool:
    """Launch ``lib``'s kernel: ``scalars`` (the launcher's leading
    integers, less the device), ``args`` (each a ``Ptrs``, a sequence of
    int64 values or None); ``ref`` gives the card.  ``align``: (arg index,
    element index, bytes) rules for an int64 arg whose value holds only
    where every pointer is a multiple of ``bytes`` — zeroed otherwise —,
    or (None, None, bytes) where the launch needs it.  Returns whether it
    launched (False: traced as a leaf op under ``torch.export``); raises
    where the launch is refused."""
    if exporting():
        _trace(lib, scalars, args, align, what)
        return False
    from .cuda_kernel import _device_stream

    fn = _entry(lib)
    arrays = []
    for a in args:
        if a is None or isinstance(a, ctypes.Array):
            arrays.append(a)
        elif isinstance(a, Ptrs):
            arrays.append((ctypes.c_void_p * max(1, len(a)))(*[
                None if t is None else t.data_ptr() + off * t.element_size()
                for t, off in a]))
        else:
            arrays.append((ctypes.c_int64 * max(1, len(a)))(*a))
    argv = (ctypes.c_void_p * max(1, len(arrays)))(*[
        None if a is None else ctypes.addressof(a) for a in arrays])
    sc = (ctypes.c_int64 * max(1, len(scalars)))(*scalars)
    device, stream = _device_stream(ref)
    rc = fn(device, sc, argv, stream)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{lib.psat_error_string(rc).decode()} "
                           f"(code {rc})")
    LAUNCHES[what] += 1
    return True


# ---------------------------------------------------------------------------
# The traced launch.

# library path -> {"key", "path", "source", "launch"}
_INFO: Dict[str, dict] = {}


def library_info(lib) -> dict:
    """``{"key": sha256 of the library's bytes, "path", "source"}`` of a
    loaded kernel library (``source``: the generated ``.cu`` beside it);
    ``"launch"``, the description of its first traced launch."""
    path = str(Path(lib._name).resolve())
    if path not in _INFO:
        key = hashlib.sha256(Path(path).read_bytes()).hexdigest()
        _INFO[path] = {"key": key, "path": path,
                       "source": str(Path(path).with_suffix(".cu"))}
    return _INFO[path]


def traced_libraries() -> Dict[str, dict]:
    """The libraries traced launches named, by key."""
    return {v["key"]: v for v in _INFO.values()}


def _trace(lib, scalars, args, align, what):
    info = library_info(lib)
    info.setdefault("launch", what)
    # (opened where the exported program first runs in this process:
    # ``bind_traced``; an op called here would join the graph)
    load_launch_op()
    tensors, outs, seen = [], [], {}
    for a in args:
        if isinstance(a, Ptrs):
            for t, _ in a:
                if t is not None and id(t) not in seen:
                    seen[id(t)] = t
                    (outs if isinstance(t, Out) else tensors).append(t)
    slot = {id(t): i for i, t in enumerate(tensors + outs)}
    ints, layout, starts = list(scalars), [len(scalars), len(args)], []
    for a in args:
        starts.append(len(ints))
        if a is None:
            layout += [0, 0]
        elif isinstance(a, Ptrs):
            layout += [2, len(a)]
            for t, off in a:
                ints += [-1, 0] if t is None else [slot[id(t)], off]
        else:
            layout += [1, len(a)]
            ints += list(a)
    layout.append(len(align))
    for arg, elem, nbytes in align:
        layout += [-1 if arg is None else starts[arg] + elem, nbytes]
    res = torch.ops.psat_launch.launch.default(
        info["key"], ENTRY, ints, layout, tensors,
        [n for o in outs for n in o.shape],
        [c for o in outs for c in (DTYPE_CODES[o.dtype], len(o.shape))])
    for o, r in zip(outs, res):
        o.tensor = r


# ---------------------------------------------------------------------------
# The leaf op's library.

_LAUNCH_OP: Optional[Path] = None
_BOUND: set = set()


def _cuda_home() -> Optional[Path]:
    from ..codegen.nvcc import find_nvcc

    try:
        return Path(find_nvcc()).resolve().parent.parent
    except RuntimeError:
        return None


def launch_op_library() -> Path:
    """The leaf op's library (``csrc/launch_op.cpp``), built with g++
    against the running PyTorch's headers into ``build/torch_kernels/``
    (cached); its CUDA kernel where the CUDA toolkit is."""
    global _LAUNCH_OP
    if _LAUNCH_OP is None:
        from ..backends.astnodes import torch_build_flags
        from ..codegen.jit import compile_shared_library
        from ..codegen.nvcc import CSRC_DIR

        flags, libs = torch_build_flags()
        flags = ["-std=c++20", *flags]
        cuda = _cuda_home()
        if cuda is not None:
            flags += ["-DPSAT_WITH_CUDA", f"-I{cuda / 'include'}"]
            libs = [*libs, "-lc10_cuda"]
        source = (CSRC_DIR / "launch_op.cpp").read_text()
        _LAUNCH_OP = compile_shared_library(source, "psat_launch_op", flags,
                                            libs)
    return _LAUNCH_OP


def launch_op_arch() -> str:
    """The leaf op library's target: the host's machine, with ``+cuda``
    where its CUDA kernel is compiled."""
    return platform.machine() + ("+cuda" if _cuda_home() else "")


def load_launch_op() -> None:
    """Build (once) and load the leaf op's library into this process."""
    if not hasattr(torch.ops.psat_launch, "launch"):
        torch.ops.load_library(str(launch_op_library()))


def bind(key: str, path: str) -> None:
    """Open the kernel library ``path`` under ``key`` in the leaf op."""
    if key not in _BOUND:
        load_launch_op()
        torch.ops.psat_launch.bind(key, path)
        _BOUND.add(key)


def bind_traced() -> None:
    """Open every library a traced launch of this process named, so that
    its exported programs run here too."""
    for key, info in traced_libraries().items():
        bind(key, info["path"])
