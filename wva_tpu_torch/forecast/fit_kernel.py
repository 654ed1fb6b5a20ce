"""The forecaster-fit CUDA kernel: its build, its launch and its bound.

``csrc/fit_grid.cu`` computes what the JAX package's jitted ``_fit_grid``
(``wva_tpu/forecast/forecasters.py:104``) computes: the four forecasts of
every model row. Three lanes take a row, one recurrence each (the linear
fit, Holt, Holt-Winters), walking the row's 160 columns in order from
shared memory. :func:`wva_tpu_torch.forecast.forecasters.fit_grid` is the
wrapper the fit paths call: on CUDA tensors it runs :func:`launch` once, on
CPU tensors the plain version ``fit_grid_plain``.

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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("fit_grid_smem_stride", "fit_grid_smem_ring_stride"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.fit_grid_smem_bytes.argtypes = [ctypes.c_int]
    lib.fit_grid_smem_bytes.restype = ctypes.c_int


LIBRARY = cuda_build.Library(_SOURCE, _bind,
                             cuda_build.NVCC_FLAGS + ("-fmad=false",))

# Kernel launches made by :func:`launch` since the last reset. Callers that
# want to show a run went through the kernel set it to 0 before the run and
# read it after.
launches = 0

# Rows a block of 96 threads (three role warps) holds: the launcher's
# instantiations, and the one the fit paths take.
ROWS_CHOICES = (4, 8, 16)
ROWS_PER_BLOCK = 8

# The weights the kernel reads, in its ``Weights`` order: each smoothing
# constant and its complement as the reference writes them (``1 - a`` in
# double, then float32), and the minimum valid count.
WEIGHTS = (fc.HOLT_ALPHA, 1 - fc.HOLT_ALPHA, fc.HOLT_BETA, 1 - fc.HOLT_BETA,
           fc.HW_ALPHA, 1 - fc.HW_ALPHA, fc.HW_BETA, 1 - fc.HW_BETA,
           fc.HW_GAMMA, 1 - fc.HW_GAMMA, float(fc.MIN_VALID))
_WEIGHTS_C = (ctypes.c_float * len(WEIGHTS))(*WEIGHTS)

# The longest chain of dependent operations in one column of the
# Holt-Winters lane (csrc/fit_grid.cu): the trend through level + trend,
# * (1-a), + a*(x-s), - level, * b, + (1-b)*trend. The walk starts at the
# first valid column, so no select lies on it.
CHAIN_OPS_PER_STEP = 6


class Work(NamedTuple):
    """What one fit over ``rows`` rows must do."""

    rows: int
    bytes: int  # each input read once, the output written once
    chain_ops: int  # dependent operations on one row's critical path

    def bound_terms_ms(self) -> dict[str, float]:
        """The bytes and chain terms (:func:`cuda_build.chain_bound_terms_ms`),
        in ms."""
        return cuda_build.chain_bound_terms_ms(self.bytes, self.chain_ops)

    def bound(self) -> tuple[float, str]:
        """(ms, term): the larger of :meth:`bound_terms_ms`, and its name."""
        return cuda_build.binding(self.bound_terms_ms())


def work(rows: int) -> Work:
    """Two ``[rows, 160]`` grids and five ``[rows]`` inputs read, ``[4,
    rows]`` written, and 160 columns' worth of Holt-Winters chain on each
    row: 159 walked after a full grid's first column, and the epilogue's
    level + trend * h + term and clamp."""
    per_row = 4 * (2 * fc.N_GRID + 5 + len(fc.FORECASTERS))
    return Work(rows=rows, bytes=rows * per_row,
                chain_ops=fc.N_GRID * CHAIN_OPS_PER_STEP if rows else 0)


def smem_layout() -> dict[str, int]:
    """A block's shared memory as the library lays it out: floats per
    padded grid row and seasonal row, and bytes at each rows-per-block
    choice."""
    lib = LIBRARY.load()
    return {"grid_row_floats": lib.fit_grid_smem_stride(),
            "seasonal_row_floats": lib.fit_grid_smem_ring_stride(),
            **{f"R={r} bytes": lib.fit_grid_smem_bytes(r)
               for r in ROWS_CHOICES}}


_NAMES = ("fine", "fine_valid", "long", "long_valid", "h_fine", "h_long",
          "season", "out")


def launch(fine: torch.Tensor, fine_valid: torch.Tensor,
           long_vals: torch.Tensor, long_valid: torch.Tensor,
           h_fine: torch.Tensor, h_long: torch.Tensor, season: torch.Tensor,
           out: torch.Tensor, *,
           rows_per_block: int = ROWS_PER_BLOCK) -> torch.Tensor:
    """Run the kernel once on CUDA tensors: the ``[4, M]`` forecasts are
    written to ``out``, which is returned. Shapes as in ``fit_grid``;
    ``season`` is int32 in 1..160. Every ``rows_per_block`` in
    ``ROWS_CHOICES`` gives the same bits."""
    if fine.dim() != 2 or fine.shape[1] != fc.N_GRID:
        raise ValueError(f"fine must be [M, {fc.N_GRID}], got shape "
                         f"{tuple(fine.shape)}")
    if not fine.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors; fine is on "
                         f"{fine.device}")
    if rows_per_block not in ROWS_CHOICES:
        raise ValueError(f"rows_per_block={rows_per_block} must be one of "
                         f"{ROWS_CHOICES}")
    m = fine.shape[0]
    f32, dev = torch.float32, fine.device
    grid, row = (m, fc.N_GRID), (m,)
    tensors = (fine, fine_valid, long_vals, long_valid, h_fine, h_long,
               season, out)
    wants = ((f32, grid), (f32, row), (f32, grid), (f32, row), (f32, row),
             (f32, row), (torch.int32, row), (f32, (len(fc.FORECASTERS), m)))
    # One pass of cheap tests; the named error comes from _check.
    for t, (dtype, shape) in zip(tensors, wants):
        if not (t.dtype is dtype and t.device == dev and t.shape == shape
                and t.is_contiguous()):
            for name, t2, (dtype2, shape2) in zip(_NAMES, tensors, wants):
                cuda_build.check_tensor(name, t2, dtype2, shape2, dev)
    if m == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    global launches
    launches += 1
    args = (*(t.data_ptr() for t in tensors), m, fc.N_GRID, rows_per_block,
            _WEIGHTS_C, stream)
    if dev.index == torch.cuda.current_device():
        err = lib.fit_grid_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.fit_grid_launch(*args)
    if err != 0:
        raise RuntimeError(f"fit_grid kernel launch failed: "
                           f"{LIBRARY.error_string(err)} (cudaError {err})")
    return out
