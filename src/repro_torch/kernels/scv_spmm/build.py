"""Builds ``csrc/scv_spmm.cu`` at first use and loads it with ``ctypes``.

``nvcc`` compiles the source for ``sm_90a`` into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), under
``_build/`` next to this file, named by the source's hash: an edited
source rebuilds, an unchanged one loads the library already built.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).with_name("csrc") / "scv_spmm.cu"
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library: the bound C entry points and how it was built."""

    scv_spmm_runs: ctypes._CFuncPtr  # vector body over a chain (sparse and dense branches)
    scv_spmm_runs_scalar: ctypes._CFuncPtr  # scalar body over one segment
    scv_spmm_runs_occupancy: ctypes._CFuncPtr  # vector-body blocks an SM holds
    path: Path
    build_seconds: float  # 0.0 when an existing library was loaded
    build_log: str  # nvcc / ptxas output (registers, shared memory, spills)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(target: Path) -> tuple[float, str]:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    return seconds, proc.stdout + proc.stderr


def load_library() -> KernelLibrary:
    """The kernel library, built on the first call of the process."""
    global _loaded
    with _lock:
        if _loaded is None:
            digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
            target = BUILD_DIR / f"libscv_spmm_{digest}.so"
            seconds, log = (0.0, "") if target.exists() else _build(target)
            lib = ctypes.CDLL(str(target))
            vector, scalar = lib.scv_spmm_runs, lib.scv_spmm_runs_scalar
            occupancy = lib.scv_spmm_runs_occupancy
            # the segment count, the segment table (five pointer arrays and
            # the caps), the device pointers, the ints, then the stream
            vector.argtypes = ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 5
                               + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 9
                               + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            scalar.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            vector.restype = scalar.restype = occupancy.restype = ctypes.c_int
            _loaded = KernelLibrary(vector, scalar, occupancy, target, seconds, log)
        return _loaded
