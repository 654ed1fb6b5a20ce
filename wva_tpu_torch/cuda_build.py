"""Build and load the port's CUDA kernels.

Each kernel source (a ``csrc/*.cu`` file with a plain C interface) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library, which is
loaded with ``ctypes``. A library goes to ``build/kernels/`` at the root of
the checkout, named by the source's stem and a hash of the source and its
flags, and is built at first use, never at import. A failed build raises;
nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the "
                           "port's CUDA kernels cannot be built")
    return str(Path(CUDA_HOME) / "bin" / name)


class Library:
    """One kernel source and the shared library built from it.

    ``bind`` sets the ``argtypes`` and ``restype`` of the library's C
    functions once it is loaded. The library must export
    ``<stem>_error_string(int)``, the CUDA error's text."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = NVCC_FLAGS) -> None:
        self.source = Path(source)
        self.flags = tuple(flags)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()
                                ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the library unless the current one exists; return its
        path. The compiler's report goes beside it (:meth:`build_log`)."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *self.flags, "-o", str(tmp),
               str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return out

    def build_log(self) -> str:
        """The ``-Xptxas -v`` report of the current library's build."""
        return self.build().with_suffix(".log").read_text()

    def load(self) -> ctypes.CDLL:
        """The loaded library (built at first use)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                err = getattr(lib, f"{self.source.stem}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def error_string(self, err: int) -> str:
        return getattr(self.load(),
                       f"{self.source.stem}_error_string")(err).decode()


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def resources(log: str) -> list[dict]:
    """Per kernel entry in a ``-Xptxas -v`` report: its mangled name
    (``entry``), registers, stack frame (local memory a thread uses), spill
    stores and loads, and static shared memory, in bytes."""
    found, cur = [], None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = dict(entry=m.group(1), registers=None, stack=0,
                       spill_stores=0, spill_loads=0, smem=0)
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
