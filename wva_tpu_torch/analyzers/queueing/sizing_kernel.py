"""SLO sizing bisection: the CUDA kernel's wrapper and its plain version.

Counterpart of ``wva_tpu/analyzers/queueing/pallas_kernel.py``
(``sizing_bisection_pallas`` around ``_sizing_kernel``). For every
candidate, bisect the arrival rate whose predicted TTFT (lane 0) and ITL
(lane 1) meet their targets: 48 iterations over the precomputed cumulative
chain ``clm[n] = sum log mu(i)``
(:func:`wva_tpu_torch.analyzers.queueing.queue_model._cum_log_mu`).

- :func:`sizing_bisection` is what the sizing path calls. On CUDA tensors
  it launches ``csrc/sizing_bisection.cu`` (built by :mod:`._build`) and
  adds one to :data:`launches`; a build or launch failure raises. On CPU
  tensors it runs :func:`sizing_bisection_plain`.
- :func:`sizing_bisection_plain` is the same arithmetic in PyTorch over
  ``[2, C, K]`` tensors: the CPU path, and the kernel's oracle on the card.

Both take the eight per-candidate coefficient rows that the Pallas wrapper
prepares (:func:`coefficients`), so the kernel and its plain version differ
only in the order of their reductions.
"""

from __future__ import annotations

import ctypes

import torch

from wva_tpu_torch.analyzers.queueing.queue_model import (
    _BISECTION_ITERS,
    _NEG_INF,
    CandidateBatch,
    _token_factors,
)

# Kernel launches made by :func:`sizing_bisection` since the last reset.
# Callers that want to show a run went through the kernel set it to 0
# before the run and read it after.
launches = 0

# The kernel's state axis: one 256-thread block per candidate, each thread
# holding up to 8 chain values in registers (k_cols <= 2048).
_THREADS = 256
_MAX_VALUES_PER_THREAD = 8


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


def _check(name: str, t: torch.Tensor, shape: tuple[int, ...],
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
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
    if clm.dim() != 2:
        raise ValueError(f"clm must be [C, K], got shape {tuple(clm.shape)}")
    c, k_cols = clm.shape
    if k_cols % _THREADS or not 0 < k_cols <= _THREADS * _MAX_VALUES_PER_THREAD:
        raise ValueError(
            f"k_cols={k_cols} must be a multiple of {_THREADS} and at most "
            f"{_THREADS * _MAX_VALUES_PER_THREAD}")
    coef = coefficients(clm_at_k, cand).contiguous()
    out = torch.empty((2, c), dtype=torch.float32, device=clm.device)
    for name, t, shape in (("clm", clm, (c, k_cols)), ("coef", coef, (8, c)),
                           ("targets", targets, (2, c)), ("lo0", lo0, (2, c)),
                           ("hi0", hi0, (2, c))):
        _check(name, t, shape, clm.device)
    if c == 0:
        return out

    from wva_tpu_torch.analyzers.queueing import _build

    lib = _build.load()
    with torch.cuda.device(clm.device):
        stream = torch.cuda.current_stream(clm.device).cuda_stream
        global launches
        launches += 1
        err = lib.sizing_bisection_launch(
            ctypes.c_void_p(clm.data_ptr()), ctypes.c_void_p(coef.data_ptr()),
            ctypes.c_void_p(targets.data_ptr()), ctypes.c_void_p(lo0.data_ptr()),
            ctypes.c_void_p(hi0.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(c), ctypes.c_int(k_cols),
            ctypes.c_int(_BISECTION_ITERS), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sizing_bisection kernel launch failed: "
                           f"{_build.error_string(err)} (cudaError {err})")
    return out
