"""The forecaster-fit CUDA kernel: its build, its launch and its bound.

``csrc/fit_grid.cu`` computes what the JAX package's jitted ``_fit_grid``
(``wva_tpu/forecast/forecasters.py:104``) computes: the four forecasts of
every model row, one thread per row walking the 160 columns in order.
:func:`wva_tpu_torch.forecast.forecasters.fit_grid` is the wrapper the fit
paths call: on CUDA tensors it runs :func:`launch` once, on CPU tensors the
plain version ``fit_grid_plain``.

The library is built with ``-fmad=false``: no multiply and add are
contracted, so each operation rounds once, in the plain version's order.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from wva_tpu_torch import cuda_build
from wva_tpu_torch.forecast import forecasters as fc

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fit_grid.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fit_grid_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = cuda_build.Library(_SOURCE, _bind,
                             cuda_build.NVCC_FLAGS + ("-fmad=false",))

# Kernel launches made by :func:`launch` since the last reset. Callers that
# want to show a run went through the kernel set it to 0 before the run and
# read it after.
launches = 0

# The weights the kernel reads, in its ``Weights`` order: each smoothing
# constant and its complement as the reference writes them (``1 - a`` in
# double, then float32), and the minimum valid count.
WEIGHTS = (fc.HOLT_ALPHA, 1 - fc.HOLT_ALPHA, fc.HOLT_BETA, 1 - fc.HOLT_BETA,
           fc.HW_ALPHA, 1 - fc.HW_ALPHA, fc.HW_BETA, 1 - fc.HW_BETA,
           fc.HW_GAMMA, 1 - fc.HW_GAMMA, float(fc.MIN_VALID))
_WEIGHTS_C = (ctypes.c_float * len(WEIGHTS))(*WEIGHTS)

# Published H100 SXM rates: HBM bandwidth (NVIDIA data sheet) and the boost
# clock; a dependent float32 add, multiply or select issues ~4 cycles after
# the one it waits on.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
CYCLES_PER_DEPENDENT_OP = 4
# The longest chain of dependent operations in one Holt-Winters step
# (csrc/fit_grid.cu): level + trend, * (1-a), + a*(x-s), - level, * b,
# + (1-b)*trend, and two selects.
CHAIN_OPS_PER_STEP = 8


class Work(NamedTuple):
    """What one fit over ``rows`` rows must do."""

    rows: int
    bytes: int  # each input read once, the output written once
    chain_ops: int  # dependent operations on one row's critical path

    def bound_terms_ms(self) -> dict[str, float]:
        """Least time on an H100 for each alone, in ms: the bytes at HBM
        bandwidth, and the serial chain at one dependent operation per
        ``CYCLES_PER_DEPENDENT_OP`` cycles (every row's chain runs at
        once)."""
        return {"bytes": 1e3 * self.bytes / HBM_BYTES_PER_S,
                "chain": 1e3 * self.chain_ops * CYCLES_PER_DEPENDENT_OP
                / CLOCK_HZ}

    def bound(self) -> tuple[float, str]:
        """(ms, term): the larger of :meth:`bound_terms_ms`, and its name."""
        terms = self.bound_terms_ms()
        term = max(terms, key=terms.get)
        return terms[term], term


def work(rows: int) -> Work:
    """Two ``[rows, 160]`` grids and five ``[rows]`` inputs read, ``[4,
    rows]`` written, and 160 Holt-Winters steps on each row's chain."""
    per_row = 4 * (2 * fc.N_GRID + 5 + len(fc.FORECASTERS))
    return Work(rows=rows, bytes=rows * per_row,
                chain_ops=fc.N_GRID * CHAIN_OPS_PER_STEP if rows else 0)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(fine: torch.Tensor, fine_valid: torch.Tensor,
           long_vals: torch.Tensor, long_valid: torch.Tensor,
           h_fine: torch.Tensor, h_long: torch.Tensor, season: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Run the kernel once on CUDA tensors: the ``[4, M]`` forecasts are
    written to ``out``, which is returned. Shapes as in ``fit_grid``;
    ``season`` is int32 in 1..160."""
    if fine.dim() != 2 or fine.shape[1] != fc.N_GRID:
        raise ValueError(f"fine must be [M, {fc.N_GRID}], got shape "
                         f"{tuple(fine.shape)}")
    if not fine.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors; fine is on "
                         f"{fine.device}")
    m = fine.shape[0]
    f32, dev = torch.float32, fine.device
    grid, row = (m, fc.N_GRID), (m,)
    arrays = (("fine", fine, f32, grid), ("fine_valid", fine_valid, f32, row),
              ("long", long_vals, f32, grid),
              ("long_valid", long_valid, f32, row),
              ("h_fine", h_fine, f32, row), ("h_long", h_long, f32, row),
              ("season", season, torch.int32, row),
              ("out", out, f32, (len(fc.FORECASTERS), m)))
    for name, t, dtype, want in arrays:
        _check(name, t, dtype, want, dev)
    if m == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        global launches
        launches += 1
        err = lib.fit_grid_launch(
            *(ctypes.c_void_p(t.data_ptr()) for _, t, _, _ in arrays),
            ctypes.c_int(m), ctypes.c_int(fc.N_GRID), _WEIGHTS_C,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fit_grid kernel launch failed: "
                           f"{LIBRARY.error_string(err)} (cudaError {err})")
    return out
