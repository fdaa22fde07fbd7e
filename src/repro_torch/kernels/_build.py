"""Build and load the CUDA C++ kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), and
loaded with ``ctypes``.  All sources build in parallel — one ``nvcc`` per
source, all started together — at the first kernel call, into
``build/kernels/`` at the repository root (listed in ``.gitignore``).  The
library name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH / CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source not already built, all in parallel.
    Returns {name: shared library path}; raises with nvcc's output if any
    build fails.  ``nvcc -Xptxas -v``'s per-kernel report (registers,
    shared memory, spills) lands beside each library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: lib_path(n) for n in kernel_names()}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])   # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (building all kernels
    on first use)."""
    with _lock:
        if name not in _libs:
            path = build_all()[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def function(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """The C entry ``name`` of kernel library ``lib``, typed (every pointer
    and the stream as ``c_void_p``, every int as ``c_int``)."""
    fn = getattr(library(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_tensors(where: str, ref, *named):
    """Raise unless every (name, tensor, dtype) lies contiguous, of its
    dtype, on ``ref``'s CUDA device — what a kernel takes."""
    for name, t, dt in named:
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{where}: {name} must be on {ref.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous {dt}, "
                             f"got {t.dtype}")


def operand_suffix(where: str, t) -> str:
    """The C entry's suffix by the operands' dtype: ``"f32"``, or ``"bf16"``
    (the bf16 compute policy's instance); anything else raises."""
    import torch
    if t.dtype == torch.float32:
        return "f32"
    if t.dtype == torch.bfloat16:
        return "bf16"
    raise ValueError(f"{where}: no instance for {t.dtype} operands "
                     "(float32 or bfloat16)")


def count(counters: dict, name: str, dtype) -> None:
    """Add one launch to a kernel module's counter ``name`` (``counters``:
    its ``globals()`` or ``vars(module)``) or, for bf16 operands, to its
    ``bf16_`` twin."""
    import torch
    counters[("bf16_" + name) if dtype == torch.bfloat16 else name] += 1


def check(rc: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch "
                           "(cudaGetLastError)")
