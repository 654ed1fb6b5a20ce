"""The sizing-bisection kernel's library: ``csrc/sizing_bisection.cu``, built
and loaded by :mod:`wva_tpu_torch.cuda_build` at first use."""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

from wva_tpu_torch import cuda_build

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sizing_bisection.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.sizing_bisection_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    wave = lib.sizing_bisection_rows_per_wave
    wave.argtypes = [ctypes.c_int, ctypes.c_int]
    wave.restype = ctypes.c_int


LIBRARY = cuda_build.Library(_SOURCE, _bind)

_NV = re.compile(r"sizing_bisection_kernelILi(\d+)E")


def resources(log: str) -> list[dict]:
    """Per kernel instantiation in a ``-Xptxas -v`` report: its NV
    (``values_per_lane``), registers, stack frame, spill stores and loads,
    and static shared memory, in bytes."""
    found = []
    for r in cuda_build.resources(log):
        nv = _NV.search(r.pop("entry"))
        found.append(dict(values_per_lane=int(nv.group(1)) if nv else None,
                          **r))
    return found
