"""Batched M/M/1 state-dependent queueing solver in PyTorch.

Counterpart of ``wva_tpu/analyzers/queueing/queue_model.py``, function for
function:

- **Log-space chain.** The birth-death stationary distribution
  ``p[n+1] = p[n] * lambda / mu(n+1)`` is a cumulative sum of
  ``log(lambda) - log(mu)`` normalized with ``logsumexp``.
- **Batched candidates.** All (variant, accelerator, request-mix)
  candidates are evaluated together as ``[C, k_cols]`` tensors, with
  per-candidate occupancy masks.
- **Fixed-iteration bisection.** SLO sizing runs 48 bisection steps over
  the whole batch at once, with TTFT and ITL stacked on a leading lane axis
  of size 2. On a CUDA tensor the bisection is the hand-written kernel in
  :mod:`.sizing_kernel` (one launch for the whole batch); on a CPU tensor
  it is that kernel's plain PyTorch version.

All tensors are float32; internal rates are requests/ms to match the
reference's millisecond time unit, public rates are requests/s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from wva_tpu_torch.analyzers.queueing.params import (
    EPSILON,
    K_MAX,
    MAX_BATCH_BOUND,
    STABILITY_SAFETY_FRACTION,
    AnalysisMetrics,
    QueueConfig,
    RequestSize,
    TargetPerf,
    TargetRate,
)
from wva_tpu_torch.device import resolve_device

_BISECTION_ITERS = 48
_NEG_INF = -1e30


class CandidateBatch(NamedTuple):
    """Struct-of-tensors description of C queue candidates; every field has
    shape ``[C]`` and all fields live on one device."""

    alpha: torch.Tensor  # ms
    beta: torch.Tensor  # ms / compute token
    gamma: torch.Tensor  # ms / memory token
    avg_input_tokens: torch.Tensor
    avg_output_tokens: torch.Tensor
    max_batch: torch.Tensor  # int32, <= MAX_BATCH_BOUND
    k: torch.Tensor  # int32 occupancy bound (batch + queue), <= K_MAX


def candidate_batch(
    alphas, betas, gammas, avg_in, avg_out, max_batch, k, device=None,
) -> CandidateBatch:
    """Build a CandidateBatch from python/numpy sequences on ``device``
    (``None`` means the CUDA card)."""
    dev = resolve_device(device)
    f = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, dtype=np.float32), device=dev)
    i = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, dtype=np.int32), device=dev)
    return CandidateBatch(
        alpha=f(alphas),
        beta=f(betas),
        gamma=f(gammas),
        avg_input_tokens=f(avg_in),
        avg_output_tokens=f(avg_out),
        max_batch=torch.clamp(i(max_batch), 1, MAX_BATCH_BOUND),
        k=torch.clamp(i(k), 1, K_MAX),
    )


def _token_factors(cand: CandidateBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """computeTokens / memoryTokens per request (reference
    queueanalyzer.go:262-264)."""
    tokens_compute = (cand.avg_input_tokens + cand.avg_output_tokens) / (
        cand.avg_output_tokens + 1.0
    )
    tokens_memory = cand.avg_input_tokens + cand.avg_output_tokens / 2.0
    return tokens_compute, tokens_memory


def _iteration_time(cand: CandidateBatch, batch: torch.Tensor) -> torch.Tensor:
    """T(n) = alpha + n*(beta*tc + gamma*tm); ``batch`` broadcasts against the
    candidate axis (reference queueanalyzer.go:261-266)."""
    tc, tm = _token_factors(cand)
    return cand.alpha[..., None] + batch * (
        (cand.beta * tc)[..., None] + (cand.gamma * tm)[..., None]
    )


def _prefill_time(cand: CandidateBatch, batch: torch.Tensor) -> torch.Tensor:
    """Prefill latency at occupancy ``batch``; 0 when there is no prompt
    (reference queueanalyzer.go:269-274)."""
    t = _iteration_time(cand, batch) + (
        (cand.beta + cand.gamma) * cand.avg_input_tokens
    )[..., None]
    return torch.where(cand.avg_input_tokens[..., None] > 0, t,
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _decode_time(cand: CandidateBatch, batch: torch.Tensor) -> torch.Tensor:
    """Per-token decode latency at occupancy ``batch`` (reference
    queueanalyzer.go:277-280)."""
    return (
        _iteration_time(cand, batch)
        + cand.beta[..., None]
        + (cand.gamma * (cand.avg_input_tokens + cand.avg_output_tokens / 2.0))[
            ..., None
        ]
    )


def _service_rate(cand: CandidateBatch, occupancy: torch.Tensor) -> torch.Tensor:
    """State-dependent service rate mu(n) in req/ms: n requests finish every
    prefill(n) + O*decode(n) ms, saturating at max_batch (reference
    queueanalyzer.go:99-105 with the clamp from
    mm1modelstatedependent.go:80-84)."""
    eff = torch.minimum(occupancy, cand.max_batch[..., None]).to(torch.float32)
    per_req = _prefill_time(cand, eff) + cand.avg_output_tokens[..., None] * _decode_time(
        cand, eff
    )
    return eff / torch.clamp(per_req, min=1e-12)


def rate_bounds_per_ms(cand: CandidateBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Feasible arrival-rate range [lambda_min, lambda_max] in req/ms
    (reference queueanalyzer.go:107-110): epsilon*mu(1) to (1-eps)*mu(B)."""
    ones = torch.ones((cand.alpha.shape[0], 1), dtype=torch.int32,
                      device=cand.alpha.device)
    mu1 = _service_rate(cand, ones)[:, 0]
    mu_b = _service_rate(cand, cand.max_batch[:, None])[:, 0]
    return mu1 * EPSILON, mu_b * (1.0 - EPSILON)


def _masked_log_mu(cand: CandidateBatch, k_cols: int) -> torch.Tensor:
    """log service rate per state, ``[C, k_cols]``, with states beyond the
    per-candidate occupancy bound k marked unreachable (``-_NEG_INF`` =
    +1e30, so the chain ratio becomes ~-1e30)."""
    c = cand.alpha.shape[0]
    states = torch.arange(1, k_cols + 1, dtype=torch.int32,
                          device=cand.alpha.device)[None, :]  # [1, K]
    mu = _service_rate(cand, states.expand(c, k_cols))
    log_mu = torch.log(torch.clamp(mu, min=1e-30))
    return torch.where(states <= cand.k[:, None], log_mu,
                       torch.full((), -_NEG_INF, dtype=torch.float32,
                                  device=log_mu.device))


def _cum_log_mu(cand: CandidateBatch, k_cols: int) -> torch.Tensor:
    """Cumulative log service rate ``clm[n] = sum_{i<=n} log mu(i)``,
    ``[C, k_cols]``, masked beyond each candidate's k.

    The stationary chain satisfies ``logp[n] = n*log(lam) - clm[n]``, so with
    clm computed once every bisection iteration is an elementwise pass plus
    reductions, with no scan and no service-rate recomputation. The mask
    turned states > k into +1e30, so the cumulative tail grows as ~1e30*j:
    finite, and far below the -1e30 clamp once subtracted."""
    return torch.cumsum(_masked_log_mu(cand, k_cols), dim=1)


def _stats_from_clm(lam: torch.Tensor, clm: torch.Tensor, clm_at_k: torch.Tensor,
                    cand: CandidateBatch) -> dict[str, torch.Tensor]:
    """Chain statistics from the precomputed cumulative chain.

    ``lam`` has shape ``[..., C]`` (any number of leading lanes); ``clm`` is
    ``[C, K]``; ``clm_at_k`` is the pre-gathered ``clm[c, k_c - 1]``
    (``[C]``). Returns the same stats as :func:`_chain_stats` with shape
    ``[..., C]``; the blocking probability comes from ``clm_at_k``."""
    nf = torch.arange(1, clm.shape[1] + 1, dtype=torch.float32,
                      device=clm.device)  # [K]
    log_lam = torch.log(torch.clamp(lam, min=1e-30))[..., None]  # [..., C, 1]

    logp = torch.clamp(nf * log_lam - clm, min=_NEG_INF)  # [..., C, K]
    # Normalize against the max INCLUDING state 0 (logp[0] = 0).
    m = torch.clamp(torch.amax(logp, dim=-1), min=0.0)  # [..., C]
    w = torch.exp(logp - m[..., None])
    w0 = torch.exp(-m)
    z = w0 + torch.sum(w, dim=-1)

    max_batch_f = cand.max_batch.to(torch.float32)  # [C]
    n_in_system = torch.sum(nf * w, dim=-1) / z
    n_in_servers = torch.sum(
        torch.minimum(nf, max_batch_f[:, None]) * w, dim=-1) / z
    # logp at the occupancy bound, from the pre-gathered chain value.
    logp_k = cand.k.to(torch.float32) * log_lam[..., 0] - clm_at_k
    p_block = torch.exp(torch.clamp(logp_k, min=_NEG_INF) - m) / z
    p0 = w0 / z

    throughput = lam * (1.0 - p_block)  # req/ms
    safe_x = torch.clamp(throughput, min=1e-30)
    avg_resp = n_in_system / safe_x
    avg_serv = n_in_servers / safe_x
    avg_wait = torch.clamp(avg_resp - avg_serv, min=0.0)
    return {
        "p0": p0,
        "p_block": p_block,
        "throughput": throughput,
        "avg_num_in_system": n_in_system,
        "avg_num_in_servers": n_in_servers,
        "avg_resp_time": avg_resp,
        "avg_serv_time": avg_serv,
        "avg_wait_time": avg_wait,
        "rho_busy": 1.0 - p0,
    }


def _chain_stats(lam: torch.Tensor, cand: CandidateBatch,
                 log_mu: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Solve the stationary distribution for arrival rate ``lam`` (req/ms,
    shape [C]) and return queue statistics (reference
    mm1modelstatedependent.go:38-117, computed in log-space instead of with
    overflow rescaling). ``log_mu`` is the (masked) precomputed chain from
    :func:`_masked_log_mu`; pass it when evaluating many rates for the same
    candidates."""
    c = lam.shape[0]
    if log_mu is None:
        log_mu = _masked_log_mu(cand, K_MAX)
    k_cols = log_mu.shape[1]

    log_ratio = torch.log(torch.clamp(lam[:, None], min=1e-30)) - log_mu

    logp = torch.cat(
        [torch.zeros((c, 1), dtype=torch.float32, device=lam.device),
         torch.cumsum(log_ratio, dim=1)], dim=1
    )  # [C, k_cols+1], states 0..k_cols
    logp = torch.clamp(logp, min=_NEG_INF)
    logz = torch.logsumexp(logp, dim=1, keepdim=True)
    p = torch.exp(logp - logz)

    all_states = torch.arange(0, k_cols + 1, dtype=torch.float32,
                              device=lam.device)[None, :]
    n_in_system = torch.sum(all_states * p, dim=1)
    n_in_servers = torch.sum(
        torch.minimum(all_states, cand.max_batch[:, None].to(torch.float32)) * p,
        dim=1,
    )
    p_block = torch.gather(p, 1, cand.k[:, None].to(torch.int64))[:, 0]
    p0 = p[:, 0]

    throughput = lam * (1.0 - p_block)  # req/ms
    safe_x = torch.clamp(throughput, min=1e-30)
    avg_resp = n_in_system / safe_x
    avg_serv = n_in_servers / safe_x
    avg_wait = torch.clamp(avg_resp - avg_serv, min=0.0)
    return {
        "p0": p0,
        "p_block": p_block,
        "throughput": throughput,
        "avg_num_in_system": n_in_system,
        "avg_num_in_servers": n_in_servers,
        "avg_resp_time": avg_resp,
        "avg_serv_time": avg_serv,
        "avg_wait_time": avg_wait,
        "rho_busy": 1.0 - p0,
    }


def _derived_latencies(
    stats: dict[str, torch.Tensor], cand: CandidateBatch
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(prefill, itl, ttft) in ms from chain stats (reference
    queueanalyzer.go:145-150)."""
    n_serv = stats["avg_num_in_servers"]
    prefill = _prefill_time(cand, n_serv[:, None])[:, 0]
    itl = (stats["avg_serv_time"] - prefill) / torch.clamp(
        cand.avg_output_tokens, min=1.0
    )
    ttft = stats["avg_wait_time"] + prefill + itl
    return prefill, itl, ttft


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def analyze_batch(rate_per_s, cand: CandidateBatch,
                  k_cols: int = K_MAX) -> dict[str, torch.Tensor]:
    """Steady-state metrics for each candidate at its arrival rate (req/s).

    Vectorized equivalent of ``QueueAnalyzer.Analyze``
    (reference queueanalyzer.go:127-168). Rates outside [lam_min, lam_max]
    are clamped; ``valid`` is False for any clamped candidate, and
    ``analyzed_rate_per_s`` reports the rate actually analyzed so callers
    can detect the substitution. ``k_cols`` truncates the padded state
    axis — callers guarantee every candidate's k fits.
    """
    lam_min, lam_max = rate_bounds_per_ms(cand)
    lam_req = _f32(rate_per_s, cand.alpha) / 1000.0
    valid = (lam_req >= lam_min) & (lam_req <= lam_max)
    lam = torch.minimum(torch.maximum(lam_req, lam_min), lam_max)

    stats = _chain_stats(lam, cand, _masked_log_mu(cand, k_cols))
    prefill, itl, ttft = _derived_latencies(stats, cand)
    rho = torch.clamp(
        stats["avg_num_in_servers"] / cand.max_batch.to(torch.float32), 0.0, 1.0
    )
    return {
        "valid": valid,
        "throughput_per_s": stats["throughput"] * 1000.0,
        "avg_resp_time_ms": stats["avg_resp_time"],
        "avg_wait_time_ms": stats["avg_wait_time"],
        "avg_num_in_serv": stats["avg_num_in_servers"],
        "avg_prefill_time_ms": prefill,
        "avg_token_time_ms": itl,
        "avg_ttft_ms": ttft,
        "max_rate_per_s": lam_max * 1000.0,
        "analyzed_rate_per_s": lam * 1000.0,
        "rho": rho,
    }


# Candidate-axis chunk for the plain bisection: bounds its [2, C, K]
# temporaries (at K=2048 one [2, 2048, 2048] float32 temporary is 32 MiB).
# The kernel keeps each row in registers and sizes any C in one launch.
_SIZE_CHUNK = 2048


def size_batch(
    cand: CandidateBatch,
    target_ttft_ms,
    target_itl_ms,
    target_tps,
    k_cols: int = K_MAX,
    impl: str | None = None,
) -> dict[str, torch.Tensor]:
    """Chunked driver for :func:`_size_batch_core` — see its docstring.

    On a CUDA batch (``impl=None``) the kernel sizes the whole batch in one
    launch. The plain bisection (a CPU batch, or ``impl="plain"``) runs in
    chunks of ``_SIZE_CHUNK`` rows; rows are independent, so chunking does
    not change any row's arithmetic."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown solver impl {impl!r}; use None or 'plain'")
    ttft = _f32(target_ttft_ms, cand.alpha)
    itl = _f32(target_itl_ms, cand.alpha)
    tps = _f32(target_tps, cand.alpha)
    c = int(cand.alpha.shape[0])
    plain = impl == "plain" or not cand.alpha.is_cuda
    if not plain or c <= _SIZE_CHUNK:
        return _size_batch_core(cand, ttft, itl, tps, k_cols, impl)
    parts = []
    for lo in range(0, c, _SIZE_CHUNK):
        sl = slice(lo, lo + _SIZE_CHUNK)
        parts.append(_size_batch_core(
            CandidateBatch(*(f[sl] for f in cand)), ttft[sl], itl[sl], tps[sl],
            k_cols, impl))
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _size_batch_core(
    cand: CandidateBatch,
    target_ttft_ms: torch.Tensor,
    target_itl_ms: torch.Tensor,
    target_tps: torch.Tensor,
    k_cols: int = K_MAX,
    impl: str | None = None,
) -> dict[str, torch.Tensor]:
    """Max arrival rate per candidate meeting its TTFT/ITL/TPS targets.

    Vectorized equivalent of ``QueueAnalyzer.Size``
    (reference queueanalyzer.go:183-258): per-target bisection on the arrival
    rate (both TTFT and ITL are monotone increasing in lambda), TPS handled as
    a stability-margin cap on the max service rate (reference :236-239,
    StabilitySafetyFraction). Targets <= 0 are disabled and yield lambda_max.

    The two latency bisections ride a leading lane axis of size 2 (TTFT,
    ITL) over the precomputed cumulative chain ``clm``. The bisection is
    :func:`~.sizing_kernel.sizing_bisection` — the CUDA kernel for a CUDA
    batch, its plain version for a CPU batch — or, with ``impl="plain"``,
    the plain version on any device.
    """
    from wva_tpu_torch.analyzers.queueing import sizing_kernel

    lam_min, lam_max = rate_bounds_per_ms(cand)
    clm = _cum_log_mu(cand, k_cols)
    clm_at_k = torch.gather(
        clm, 1, (cand.k[:, None] - 1).to(torch.int64))[:, 0]

    targets = torch.stack([target_ttft_ms, target_itl_ms])  # [2, C]
    lo0 = torch.stack([lam_min, lam_min])
    hi0 = torch.stack([lam_max, lam_max])
    bisect = (sizing_kernel.sizing_bisection_plain if impl == "plain"
              else sizing_kernel.sizing_bisection)
    lam_star = bisect(clm, clm_at_k, cand, targets, lo0, hi0)

    rate_ttft = torch.where(targets[0] > 0, lam_star[0], lam_max)
    rate_itl = torch.where(targets[1] > 0, lam_star[1], lam_max)
    rate_tps = torch.where(
        target_tps > 0, lam_max * (1.0 - STABILITY_SAFETY_FRACTION), lam_max)
    lam_best = torch.minimum(torch.minimum(rate_ttft, rate_itl), rate_tps)

    stats = _chain_stats(lam_best, cand, _masked_log_mu(cand, k_cols))
    prefill, itl, ttft = _derived_latencies(stats, cand)
    return {
        "rate_target_ttft_per_s": rate_ttft * 1000.0,
        "rate_target_itl_per_s": rate_itl * 1000.0,
        "rate_target_tps_per_s": rate_tps * 1000.0,
        "max_rate_per_s": lam_best * 1000.0,
        "achieved_ttft_ms": ttft,
        "achieved_itl_ms": itl,
        "achieved_tps": stats["throughput"] * 1000.0 * cand.avg_output_tokens,
        "throughput_per_s": stats["throughput"] * 1000.0,
        "rho": torch.clamp(
            stats["avg_num_in_servers"] / cand.max_batch.to(torch.float32), 0.0, 1.0
        ),
    }


_K_COLS_MIN = 256


def k_cols_for(k_host) -> int:
    """THE state-axis trim rule: smallest power of two (>= 256, capped at
    K_MAX) covering the batch's largest occupancy bound."""
    ks = np.asarray(k_host)
    k_max = int(ks.max()) if ks.size else K_MAX
    k_cols = _K_COLS_MIN
    while k_cols < k_max:
        k_cols *= 2
    return min(k_cols, K_MAX)


def size_batch_bucketed(
    cand: CandidateBatch,
    target_ttft_ms,
    target_itl_ms,
    target_tps,
    k_host=None,
    impl: str | None = None,
) -> dict[str, torch.Tensor]:
    """:func:`size_batch` with automatic state-axis trimming.

    The state axis is sized to the smallest power of two (>= 256) covering
    the batch's largest occupancy bound k, instead of always padding to
    ``K_MAX=2048``. Numerics are identical to ``size_batch`` at full width
    because states above k were already masked. Only the k values are
    needed on the host (one small transfer, or none when the caller passes
    ``k_host`` — the analyzer already has them as Python ints).
    """
    k_cols = k_cols_for(cand.k.cpu().numpy() if k_host is None else k_host)
    return size_batch(cand, target_ttft_ms, target_itl_ms, target_tps,
                      k_cols=k_cols, impl=impl)


class QueueAnalyzer:
    """Scalar convenience facade over the batched solver — parity surface of
    the reference ``QueueAnalyzer`` (``pkg/analyzer/queueanalyzer.go:84-124``)
    for single-candidate use and tests. Production paths (SLO analyzer)
    call :func:`analyze_batch` / :func:`size_batch` directly."""

    def __init__(self, config: QueueConfig, request_size: RequestSize,
                 device=None) -> None:
        if not config.valid():
            raise ValueError(f"invalid queue configuration: {config}")
        if not request_size.valid():
            raise ValueError(f"invalid request size: {request_size}")
        self.config = config
        self.request_size = request_size
        self._cand = candidate_batch(
            [config.service_parms.alpha],
            [config.service_parms.beta],
            [config.service_parms.gamma],
            [request_size.avg_input_tokens],
            [request_size.avg_output_tokens],
            [config.max_batch_size],
            [config.max_batch_size + config.max_queue_size],
            device=device,
        )
        lam_min, lam_max = rate_bounds_per_ms(self._cand)
        self.min_rate_per_s = float(lam_min[0]) * 1000.0
        self.max_rate_per_s = float(lam_max[0]) * 1000.0

    def analyze(self, request_rate_per_s: float) -> AnalysisMetrics:
        if request_rate_per_s <= 0:
            raise ValueError(f"invalid request rate {request_rate_per_s}")
        if request_rate_per_s > self.max_rate_per_s:
            raise ValueError(
                f"rate={request_rate_per_s}, max allowed rate={self.max_rate_per_s}"
            )
        out = analyze_batch([request_rate_per_s], self._cand)
        return AnalysisMetrics(
            throughput=float(out["throughput_per_s"][0]),
            avg_resp_time_ms=float(out["avg_resp_time_ms"][0]),
            avg_wait_time_ms=float(out["avg_wait_time_ms"][0]),
            avg_num_in_serv=float(out["avg_num_in_serv"][0]),
            avg_prefill_time_ms=float(out["avg_prefill_time_ms"][0]),
            avg_token_time_ms=float(out["avg_token_time_ms"][0]),
            avg_ttft_ms=float(out["avg_ttft_ms"][0]),
            max_rate=float(out["max_rate_per_s"][0]),
            rho=float(out["rho"][0]),
        )

    def size(self, targets: TargetPerf) -> tuple[TargetRate, AnalysisMetrics, TargetPerf]:
        """Returns (max rates, metrics at the binding rate, achieved targets)
        — reference queueanalyzer.go:183-258."""
        if math.isnan(targets.target_ttft_ms) or math.isnan(targets.target_itl_ms):
            raise ValueError(f"invalid targets: {targets}")
        out = size_batch(
            self._cand,
            [targets.target_ttft_ms],
            [targets.target_itl_ms],
            [targets.target_tps],
        )
        rates = TargetRate(
            rate_target_ttft=float(out["rate_target_ttft_per_s"][0]),
            rate_target_itl=float(out["rate_target_itl_per_s"][0]),
            rate_target_tps=float(out["rate_target_tps_per_s"][0]),
        )
        metrics = self.analyze(
            min(max(out["max_rate_per_s"][0].item(), 1e-9), self.max_rate_per_s))
        achieved = TargetPerf(
            target_ttft_ms=float(out["achieved_ttft_ms"][0]),
            target_itl_ms=float(out["achieved_itl_ms"][0]),
            target_tps=float(out["achieved_tps"][0]),
        )
        return rates, metrics, achieved
