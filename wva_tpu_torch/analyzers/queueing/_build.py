"""Build and load the sizing-bisection CUDA kernel.

``nvcc`` compiles ``csrc/sizing_bisection.cu`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, which is loaded with ``ctypes``.
The library goes to ``build/kernels/`` at the root of the checkout, named by
a hash of the source and the flags, and is built at first use. A failed
build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sizing_bisection.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# The compiler's report (ptxas registers, shared memory, spills) from the
# build this process ran, if any.
build_log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the "
                           "sizing-bisection kernel cannot be built")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"sizing_bisection-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless the current one exists; return
    its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_log = proc.stdout + proc.stderr
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.sizing_bisection_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.sizing_bisection_error_string.argtypes = [ctypes.c_int]
            lib.sizing_bisection_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return load().sizing_bisection_error_string(err).decode()
