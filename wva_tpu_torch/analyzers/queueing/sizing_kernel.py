"""SLO sizing bisection: the CUDA kernel's wrapper and its plain version.

Counterpart of ``wva_tpu/analyzers/queueing/pallas_kernel.py``
(``sizing_bisection_pallas`` around ``_sizing_kernel``). For every
candidate, bisect the arrival rate whose predicted TTFT (lane 0) and ITL
(lane 1) meet their targets: 48 iterations over the precomputed cumulative
chain ``clm[n] = sum log mu(i)``
(:func:`wva_tpu_torch.analyzers.queueing.queue_model._cum_log_mu`), masked
past each candidate's occupancy bound k.

- :func:`sizing_bisection` is what the sizing path calls. On CUDA tensors
  :func:`launch` runs ``csrc/sizing_bisection.cu`` (built by :mod:`._build`)
  once, adding one to :data:`launches`; a build or launch failure raises.
  The kernel derives each row's coefficients from the candidate's fields
  itself, so the call's only other device work is the row order of a batch
  of more than one wave (:func:`launch_order`). On CPU tensors it runs
  :func:`sizing_bisection_plain`.
- :func:`sizing_bisection_plain` is the same arithmetic in PyTorch over
  ``[2, C, K]`` tensors: the CPU path, and the kernel's oracle on the card.
- :func:`launch_shape` is the kernel's launch geometry and :func:`work` the
  work a call must do, from which :meth:`Work.bound` gives the least time
  an H100 could take for it.

Both versions use the eight per-candidate coefficient rows that the Pallas
wrapper prepares (:func:`coefficients`), rounded alike. They differ in the
order of their reductions, and the kernel rounds ``n*log(mid) - clm`` and
the weighted sums as fused multiply-adds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wva_tpu_torch.analyzers.queueing.queue_model import (
    _BISECTION_ITERS,
    _NEG_INF,
    CandidateBatch,
    _token_factors,
)

# Kernel launches made by :func:`launch` since the last reset. Callers that
# want to show a run went through the kernel set it to 0 before the run and
# read it after.
launches = 0

# The kernel's launch: one warp per candidate row, lane l holding the chain
# values l + 32*i for i < NV, NV the smallest of _VALUES_PER_LANE covering
# k_cols; several rows (warps) per block.
_WARP = 32
_VALUES_PER_LANE = (8, 16, 32, 64)
K_COLS_MAX = _WARP * _VALUES_PER_LANE[-1]
# Rows per block on the sizing path: the fastest of those chip_smoke.py
# times (PERF.md). The kernel takes 1 to 8.
ROWS_PER_BLOCK = 8
_MAX_ROWS_PER_BLOCK = 8


class LaunchShape(NamedTuple):
    values_per_lane: int  # NV: chain values each lane holds in registers
    blocks: int
    threads: int  # per block: 32 x rows per block


def launch_shape(c: int, k_cols: int,
                 rows_per_block: int = ROWS_PER_BLOCK) -> LaunchShape:
    """The kernel's launch geometry for ``c`` rows of ``k_cols`` states;
    raises ValueError for a shape the kernel does not take."""
    if k_cols % _WARP or not 0 < k_cols <= K_COLS_MAX:
        raise ValueError(f"k_cols={k_cols} must be a multiple of {_WARP} and "
                         f"at most {K_COLS_MAX}")
    if not 1 <= rows_per_block <= _MAX_ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block={rows_per_block} must be 1 to "
                         f"{_MAX_ROWS_PER_BLOCK}")
    nv = next(n for n in _VALUES_PER_LANE if _WARP * n >= k_cols)
    return LaunchShape(nv, -(-c // rows_per_block), _WARP * rows_per_block)


# Published H100 SXM rates: HBM bandwidth and float32 outside the tensor
# cores (NVIDIA data sheet), and exps on the special-function units, 16 per
# SM per clock (CUDA C++ Programming Guide, throughput of exp2 at compute
# capability 9.0) on 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_EXPS_PER_S = 132 * 16 * 1.98e9
# Float32 operations per chain state per lane per bisection iteration:
# n*log(lam) - clm (2), the -1e30 clamp (1), the running max (1),
# logp - m (1), exp (1), sum w (1), sum n*w (2), sum min(n, B)*w (2).
OPS_PER_STATE_PASS = 11
_PASSES = 2 * _BISECTION_ITERS  # two lanes per iteration
# Per-row 4-byte values besides the chain: 8 candidate fields (clm_at_k,
# alpha, beta, gamma, the token averages, max_batch, k), and targets, lo0,
# hi0 and the output, two each.
_ROW_FLOATS = 8 + 2 + 2 + 2 + 2


class Work(NamedTuple):
    """What one bisection call must do, counted from its inputs."""

    states: int  # chain states the rows need: sum of min(k, k_cols)
    exps: int
    fp32_ops: int
    bytes: int  # each input read once, the output written once

    def bound_terms_ms(self) -> dict[str, float]:
        """Least time on an H100 for each resource alone, in ms."""
        return {"bytes": 1e3 * self.bytes / HBM_BYTES_PER_S,
                "fp32": 1e3 * self.fp32_ops / FP32_OPS_PER_S,
                "sfu": 1e3 * self.exps / SFU_EXPS_PER_S}

    def bound(self) -> tuple[float, str]:
        """(ms, term): the largest of :meth:`bound_terms_ms`, and its name."""
        terms = self.bound_terms_ms()
        term = max(terms, key=terms.get)
        return terms[term], term


def work(cand: CandidateBatch, k_cols: int) -> Work:
    """The work of one bisection call over ``cand`` at ``k_cols`` states:
    every state a row needs (up to its k, at most ``k_cols``) is read once
    and evaluated in 96 passes, one exp each."""
    states = int(torch.clamp(cand.k, max=k_cols).sum())
    c = int(cand.k.shape[0])
    return Work(states=states, exps=_PASSES * states,
                fp32_ops=_PASSES * OPS_PER_STATE_PASS * states,
                bytes=4 * (states + c * _ROW_FLOATS))


def coefficients(clm_at_k: torch.Tensor, cand: CandidateBatch) -> torch.Tensor:
    """The eight per-candidate rows ``[8, C]`` of ``pallas_kernel.py:154-168``:
    clm_at_k, k, max_batch, alpha, bc, prefill_extra, has_prompt,
    inv_avg_out. The prefill affine form is
    ``prefill(n_serv) = (alpha + n_serv*bc + prefill_extra) * has_prompt``
    with ``bc = beta*tc + gamma*tm`` and ``prefill_extra =
    (beta+gamma)*avg_in``."""
    avg_in = cand.avg_input_tokens.to(torch.float32)
    avg_out = cand.avg_output_tokens.to(torch.float32)
    tc, tm = _token_factors(cand)
    bc = cand.beta * tc + cand.gamma * tm
    prefill_extra = (cand.beta + cand.gamma) * avg_in
    return torch.stack([
        clm_at_k.to(torch.float32),
        cand.k.to(torch.float32),
        cand.max_batch.to(torch.float32),
        cand.alpha.to(torch.float32),
        bc,
        prefill_extra,
        (avg_in > 0).to(torch.float32),
        1.0 / torch.clamp(avg_out, min=1.0),
    ])


def _latencies(mid: torch.Tensor, clm: torch.Tensor, nf: torch.Tensor,
               minb: torch.Tensor, coef: torch.Tensor):
    """(ttft, itl) at arrival rates ``mid`` ``[2, C]`` — the body of
    ``_sizing_kernel.latencies`` (``pallas_kernel.py:73-97``) over
    ``[2, C, K]``."""
    clm_at_k, kf, _, alpha_eff, bc, prefill_extra, has_prompt, inv_avg_out = coef
    log_lam = torch.log(torch.clamp(mid, min=1e-30))  # [2, C]
    logp = torch.clamp(nf * log_lam[..., None] - clm, min=_NEG_INF)
    m = torch.clamp(torch.amax(logp, dim=-1), min=0.0)
    w = torch.exp(logp - m[..., None])
    z = torch.exp(-m) + torch.sum(w, dim=-1)
    n_sys = torch.sum(nf * w, dim=-1) / z
    n_serv = torch.sum(minb * w, dim=-1) / z
    logp_k = kf * log_lam - clm_at_k
    p_block = torch.exp(torch.clamp(logp_k, min=_NEG_INF) - m) / z
    x = torch.clamp(mid * (1.0 - p_block), min=1e-30)
    avg_resp = n_sys / x
    avg_serv = n_serv / x
    avg_wait = torch.clamp(avg_resp - avg_serv, min=0.0)
    prefill = (alpha_eff + n_serv * bc + prefill_extra) * has_prompt
    itl = (avg_serv - prefill) * inv_avg_out
    ttft = avg_wait + prefill + itl
    return ttft, itl


def sizing_bisection_plain(
    clm: torch.Tensor,        # [C, K] cumulative chain (masked past k)
    clm_at_k: torch.Tensor,   # [C]
    cand: CandidateBatch,
    targets: torch.Tensor,    # [2, C] (ttft_ms, itl_ms)
    lo0: torch.Tensor,        # [2, C]
    hi0: torch.Tensor,        # [2, C]
) -> torch.Tensor:
    """lam_star ``[2, C]``: the kernel's arithmetic in plain PyTorch, on any
    device."""
    coef = coefficients(clm_at_k, cand)
    nf = torch.arange(1, clm.shape[1] + 1, dtype=torch.float32,
                      device=clm.device)  # [K]
    minb = torch.minimum(nf, coef[2][:, None])  # [C, K]
    lo, hi = lo0.to(torch.float32), hi0.to(torch.float32)
    for _ in range(_BISECTION_ITERS):
        mid = 0.5 * (lo + hi)
        ttft, itl = _latencies(mid, clm, nf, minb, coef)
        y = torch.stack([ttft[0], itl[1]])
        go_right = y < targets  # metric below target -> rate can grow
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


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


def sizing_bisection(
    clm: torch.Tensor,
    clm_at_k: torch.Tensor,
    cand: CandidateBatch,
    targets: torch.Tensor,
    lo0: torch.Tensor,
    hi0: torch.Tensor,
) -> torch.Tensor:
    """lam_star ``[2, C]`` — drop-in for the bisection in
    ``_size_batch_core``. CUDA tensors launch the kernel (one launch for
    the whole batch); CPU tensors run :func:`sizing_bisection_plain`."""
    if not clm.is_cuda:
        return sizing_bisection_plain(clm, clm_at_k, cand, targets, lo0, hi0)
    c, k_cols = clm.shape
    out = torch.empty((2, c), dtype=torch.float32, device=clm.device)
    wave = rows_per_wave(clm.device, launch_shape(c, k_cols).values_per_lane)
    return launch(clm, clm_at_k, cand, targets, lo0, hi0, out,
                  order=launch_order(cand.k, k_cols, wave))


def launch_order(k: torch.Tensor, k_cols: int,
                 rows_per_wave: int) -> torch.Tensor | None:
    """The order in which the kernel's warps should take rows:
    :func:`rows_by_k` for a batch whose chain holds more states than one
    wave of rows at the widest ``k_cols`` (``C * k_cols > rows_per_wave *
    K_COLS_MAX``), else None (rows in place). Rows of unequal k load SMs
    unevenly, the more so the more waves and the wider the rows, while the
    sort costs the same. chip_smoke.py's order sweep times both sides of
    this rule at k_cols 512, 1024 and 2048 (PERF.md)."""
    if k.shape[0] * k_cols <= rows_per_wave * K_COLS_MAX:
        return None
    return rows_by_k(k)


def rows_by_k(k: torch.Tensor) -> torch.Tensor:
    """The rows by decreasing ``k`` in steps of 16 states (int64). The key
    fits in a byte (k <= 2048), so the sort is one radix pass. The order
    moves no row's bits."""
    return torch.argsort((k >> 4).to(torch.uint8), descending=True)


_waves: dict[tuple[int, int, int], int] = {}


def rows_per_wave(device: torch.device, values_per_lane: int,
                  rows_per_block: int = ROWS_PER_BLOCK) -> int:
    """The rows the card of ``device`` runs at once in the instantiation
    that holds ``values_per_lane`` chain values a lane: resident blocks per
    SM at its registers, times rows per block, times SMs (asked of the CUDA
    runtime once, then cached)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, values_per_lane, rows_per_block)
    if key not in _waves:
        from wva_tpu_torch.analyzers.queueing import _build

        lib = _build.LIBRARY.load()
        with torch.cuda.device(index):
            n = lib.sizing_bisection_rows_per_wave(values_per_lane,
                                                   rows_per_block)
        if n <= 0:
            raise RuntimeError(
                f"sizing_bisection occupancy query failed: "
                f"{_build.LIBRARY.error_string(-n)} (cudaError {-n})")
        _waves[key] = n
    return _waves[key]


def launch(clm: torch.Tensor, clm_at_k: torch.Tensor, cand: CandidateBatch,
           targets: torch.Tensor, lo0: torch.Tensor, hi0: torch.Tensor,
           out: torch.Tensor, *, order: torch.Tensor | None = None,
           rows_per_block: int = ROWS_PER_BLOCK,
           skip_past_k: bool = True) -> torch.Tensor:
    """Run the kernel once on CUDA tensors: lam_star written to ``out``
    ``[2, C]``, which is returned. ``order`` (int64 ``[C]``, a permutation
    of the rows) is the order in which warps take rows. Every ``order``,
    every ``rows_per_block`` and ``skip_past_k=False`` (compute the states
    past each row's k too) give the same bits; the last two exist so that
    chip_smoke.py can time and check them."""
    if clm.dim() != 2:
        raise ValueError(f"clm must be [C, K], got shape {tuple(clm.shape)}")
    if not clm.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors; clm is on "
                         f"{clm.device}")
    c, k_cols = clm.shape
    shape = launch_shape(c, k_cols, rows_per_block)
    f32, i32, dev = torch.float32, torch.int32, clm.device
    arrays = (("clm", clm, f32, (c, k_cols)), ("clm_at_k", clm_at_k, f32, (c,)),
              ("alpha", cand.alpha, f32, (c,)), ("beta", cand.beta, f32, (c,)),
              ("gamma", cand.gamma, f32, (c,)),
              ("avg_input_tokens", cand.avg_input_tokens, f32, (c,)),
              ("avg_output_tokens", cand.avg_output_tokens, f32, (c,)),
              ("max_batch", cand.max_batch, i32, (c,)),
              ("k", cand.k, i32, (c,)), ("targets", targets, f32, (2, c)),
              ("lo0", lo0, f32, (2, c)), ("hi0", hi0, f32, (2, c)),
              ("order", order, torch.int64, (c,)), ("out", out, f32, (2, c)))
    ptrs = []
    for name, t, dtype, want in arrays:
        if t is None:
            ptrs.append(ctypes.c_void_p(None))
            continue
        _check(name, t, dtype, want, dev)
        ptrs.append(ctypes.c_void_p(t.data_ptr()))
    if c == 0:
        return out

    from wva_tpu_torch.analyzers.queueing import _build

    lib = _build.LIBRARY.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        global launches
        launches += 1
        err = lib.sizing_bisection_launch(
            *ptrs, ctypes.c_int(c), ctypes.c_int(k_cols),
            ctypes.c_int(_BISECTION_ITERS),
            ctypes.c_int(shape.values_per_lane), ctypes.c_int(rows_per_block),
            ctypes.c_int(int(skip_past_k)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"sizing_bisection kernel launch failed: "
            f"{_build.LIBRARY.error_string(err)} (cudaError {err})")
    return out
