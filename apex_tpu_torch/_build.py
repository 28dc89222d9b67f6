"""Build the port's C++ sources and load them with ``ctypes``.

Each CUDA source ``csrc/<name>.cu`` exposes a plain C interface and
compiles on its own with ``nvcc`` into ``csrc/build/lib<name>.so`` on
first use (a few seconds; no PyTorch headers are involved).  The host
runtime ``csrc/<name>.cpp`` (:mod:`apex_tpu_torch.native`) compiles the
same way with the host compiler, ``g++ -O3 -shared -fPIC -pthread
-std=c++17``.  A library is rebuilt when its source, or any header
``csrc/*.cuh`` (a CUDA source may include one), is newer than it.
Nothing is compiled at import time, so the CPU tests can import every
module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]


#: the element-type codes every C entry point takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    """0 for fp32, 1 for bf16, 2 for fp16 (the kernels' ``dtype``
    argument); raises ``TypeError`` on any other type."""
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the kernels take fp32, bf16 or fp16, got "
                        f"{dtype}") from None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels are built from source")


#: the kernel wrappers whose ``launches`` counts their kernel's launches:
#: a wrapper adds one where it launches, and a captured graph
#: (:class:`apex_tpu_torch.cache.Captured`) adds, at every replay, the
#: launches it recorded
COUNTED: list = []


def counted(fn):
    """Register kernel wrapper ``fn``: its ``launches`` counter, set to
    0, is one of :data:`COUNTED`.  Returns ``fn``."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


class _Registry:
    """Loaded libraries of this process, one per source; a lock per
    source keeps two threads from building the same one at once, while
    different sources build concurrently."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.lock = threading.Lock()
        self.source_locks: Dict[str, threading.Lock] = {}
        #: ptxas report of the last build of each source (registers,
        #: shared memory, spills), for the on-card smoke run to print
        self.reports: Dict[str, str] = {}


_REGISTRY = _Registry()


def set_build_dir(path: str) -> None:
    """Build and look for the libraries in ``path`` from now on (the
    default is ``csrc/build/``); a library loaded already stays loaded."""
    global BUILD_DIR
    BUILD_DIR = path


def _host_cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH: the host runtime is built "
                       "from source")


def _source_mtime(src: str) -> float:
    """The newest modification time of ``src`` and the headers it may
    include: every ``csrc/*.cuh``."""
    heads = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
             if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src, *heads])


def build(name: str, host: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` with ``nvcc`` (``host``:
    ``csrc/<name>.cpp`` with the host compiler) into
    ``BUILD_DIR/lib<name>.so`` when the library is missing or older than
    the source or a ``csrc/*.cuh`` header; returns its path."""
    src = os.path.join(_CSRC, f"{name}.cpp" if host else f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= _source_mtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ([_host_cxx(), *HOST_FLAGS] if host else [_nvcc(), *NVCC_FLAGS])
    proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {src}:\n"
                           f"{proc.stderr}")
    _REGISTRY.reports[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str, host: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (``host``:
    ``csrc/<name>.cpp``), built on first use."""
    with _REGISTRY.lock:
        lock = _REGISTRY.source_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _REGISTRY.libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name, host))
            _REGISTRY.libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said when this process built ``name`` ('' when
    the library was already built)."""
    return _REGISTRY.reports.get(name, "")
