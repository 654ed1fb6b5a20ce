"""Build and load the port's CUDA kernels.

Each kernel source (a ``csrc/*.cu`` file with a plain C interface) is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library, which is
loaded with ``ctypes``. A library is named by the source's stem and a hash
of the source, its headers and its flags, and is built at first use, never
at import, into :func:`build_dir`: ``build/kernels/`` at the root of a
checkout, or the user's cache where the package is installed. A failed
build raises; nothing falls back to a plain version.
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

import torch

PACKAGE_ROOT = Path(__file__).resolve().parent
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir(package_root: Path = PACKAGE_ROOT) -> Path:
    """The directory the kernel libraries are built into, created if
    missing. In a checkout (the package's parent holds the repository's
    ``pyproject.toml``) it is ``build/kernels/`` at the checkout's root;
    installed, ``wva_tpu_torch/kernels`` in the user's cache
    (``$XDG_CACHE_HOME``, else ``~/.cache``). Library names carry a hash
    of their sources and flags, so versions of the package share it
    without collisions. Raises ``RuntimeError`` naming the directory if it
    cannot be created or written."""
    root = Path(package_root).parent
    if (root / "pyproject.toml").is_file():
        out = root / "build" / "kernels"
    else:
        cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
        out = Path(cache) / "wva_tpu_torch" / "kernels"
    try:
        out.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create the kernel build directory "
                           f"{out}: {e}") from e
    if not os.access(out, os.W_OK | os.X_OK):
        raise RuntimeError(f"the kernel build directory {out} is not "
                           f"writable")
    return out


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
    ``<stem>_error_string(int)``, the CUDA error's text. ``depends`` are
    the headers the source includes: their text is hashed into the
    library's name beside the source's."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 flags: Sequence[str] = NVCC_FLAGS,
                 depends: Sequence[Path] = ()) -> None:
        self.source = Path(source)
        self.flags = tuple(flags)
        self.depends = tuple(Path(d) for d in depends)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def path(self) -> Path:
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in (self.source, *self.depends))
            + " ".join(self.flags).encode()).hexdigest()[:16]
        return build_dir() / f"{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the library unless the current one exists; return its
        path. The compiler's report goes beside it (:meth:`build_log`).
        Both are written under a name of this process and thread and moved
        into place, so processes or threads that build the same library at
        once leave one whole copy."""
        out = self.path()
        if out.exists():
            return out
        tag = f".{os.getpid()}-{threading.get_ident()}.tmp"
        tmp, log = out.with_suffix(".so" + tag), out.with_suffix(".log" + tag)
        cmd = [cuda_tool("nvcc"), *self.flags, "-o", str(tmp),
               str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(log, out.with_suffix(".log"))
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


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


# Published H100 SXM rates the kernels' bounds use: HBM bandwidth (NVIDIA
# data sheet) and the boost clock; a dependent float32 add, multiply,
# select or min/max issues ~4 cycles after the one it waits on.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
CYCLES_PER_DEPENDENT_OP = 4


def chain_bound_terms_ms(nbytes: int, chain_ops: int) -> dict[str, float]:
    """Least time on an H100 for each alone, in ms: ``nbytes`` at HBM
    bandwidth, and a serial chain of ``chain_ops`` dependent operations at
    one per ``CYCLES_PER_DEPENDENT_OP`` cycles (every lane's chain runs at
    once)."""
    return {"bytes": 1e3 * nbytes / HBM_BYTES_PER_S,
            "chain": 1e3 * chain_ops * CYCLES_PER_DEPENDENT_OP / CLOCK_HZ}


def binding(terms: dict[str, float]) -> tuple[float, str]:
    """(ms, term): the largest of a bound's terms, and its name."""
    term = max(terms, key=terms.get)
    return terms[term], term


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
