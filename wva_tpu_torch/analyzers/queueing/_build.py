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
import re
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


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the "
                           "sizing-bisection kernel cannot be built")
    return str(Path(CUDA_HOME) / "bin" / name)


def library_path() -> Path:
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"sizing_bisection-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless the current one exists; return
    its path. The compiler's report goes beside it (:func:`build_log`)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current library's build."""
    return build().with_suffix(".log").read_text()


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_NV = re.compile(r"sizing_bisection_kernelILi(\d+)E")


def resources(log: str) -> list[dict]:
    """Per kernel instantiation in a ``-Xptxas -v`` report: its NV
    (``values_per_lane``), registers, stack frame, spill stores and loads,
    and static shared memory, in bytes."""
    found, cur = [], None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            nv = _NV.search(m.group(1))
            cur = dict(values_per_lane=int(nv.group(1)) if nv else None,
                       registers=None, stack=0, spill_stores=0,
                       spill_loads=0, smem=0)
            found.append(cur)
        elif cur is None:
            continue
        elif m := _FRAME.search(line):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif m := _USED.search(line):
            cur["registers"] = int(m.group(1))
            if m := _SMEM.search(line):
                cur["smem"] = int(m.group(1))
    return found


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.sizing_bisection_launch
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            wave = lib.sizing_bisection_rows_per_wave
            wave.argtypes = [ctypes.c_int, ctypes.c_int]
            wave.restype = ctypes.c_int
            lib.sizing_bisection_error_string.argtypes = [ctypes.c_int]
            lib.sizing_bisection_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    return load().sizing_bisection_error_string(err).decode()
