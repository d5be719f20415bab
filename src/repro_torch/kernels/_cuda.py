"""Build the hand-written CUDA kernels with ``nvcc`` and bind them by ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared
library with a plain C interface (one ``extern "C"`` launcher per kernel
that returns the launch's ``cudaGetLastError()``).  Libraries land in
``kernels/build/`` inside the package (ignored by git), named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is never served by a stale library.
:func:`build` compiles several sources in parallel, one ``nvcc`` process
each; nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("qvp_reduce", "zr_accum", "grid_map", "grid_update",
           "flash_attention", "flash_decode", "mamba2_scan", "mamba2_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(candidate):
            found = candidate
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built: named
    by a hash of the source, every header of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library of ``names``, all ``nvcc`` processes
    started together; returns ``{name: compiler log}`` (the ``-Xptxas -v``
    register and shared-memory report) for those built.  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        procs[name] = (path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failures = {}, []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def launcher(name: str, argtypes: Sequence,
             symbol: Optional[str] = None) -> object:
    """The C function ``symbol`` (default ``<name>_launch``) of
    ``csrc/<name>.cu``, building and loading its library on first use; it
    returns a ``cudaError_t``."""
    symbol = symbol or f"{name}_launch"
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build([name])
                lib = _libs[name] = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return fn


def check(name: str, err: int) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def add_launch(module: str, route: Optional[str] = None) -> None:
    """Count one launch on the kernel module ``module``'s ``launches`` (and
    on ``route_launches[route]``).  The counters are module globals that
    callers read and reset; the read-modify-write is under one lock, so
    launches made from several host threads at once (a federated product's
    fan-out) are all counted."""
    mod = sys.modules[module]
    with _count_lock:
        mod.launches += 1
        if route is not None:
            mod.route_launches[route] += 1
